"""Port vs JAX package: the tools that build an index — ``mkrcidx``,
``mkdna6idx`` (their builds on the device they are given, here the CPU)
and ``repfind`` (the port's ``mkvtree`` and ``vmatch`` in-process).

Each package writes its own index files from the same FASTA input, and
the files must be equal byte for byte (the project file names its index,
so that name is replaced on both sides); stdout and stderr of every call
are equal, and so are the refusals.  ``repfind`` runs in a directory of
its own per package, as the reference's Perl script does (the match
header names the index by its path there), and reuses the index it
built there.
"""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from vstree_tpu.cli import mkdna6idx as jmkdna6idx
from vstree_tpu.cli import mkrcidx as jmkrcidx
from vstree_tpu.cli import repfind as jrepfind
from vstree_tpu_torch.cli import mkdna6idx as tmkdna6idx
from vstree_tpu_torch.cli import mkrcidx as tmkrcidx
from vstree_tpu_torch.cli import repfind as trepfind

RCM = ("tis", "suf", "lcp", "llv", "bwt", "ssp", "des", "sds", "al1",
       "prj")
SIXFR_BASE = ("tis", "ois", "des", "sds", "ssp", "al1", "prj")
SIXFR = ("tis", "ois", "suf", "lcp", "llv", "bwt", "ssp", "des", "sds",
         "al1", "prj")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch ops in loops: one thread per worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tauxb")
    rng = np.random.default_rng(43)
    seqs = []
    for n in (4000, 2500, 3500):
        s = rng.choice(list("acgt"), n)
        s[int(rng.integers(0, n - 30)):][:int(rng.integers(2, 20))] = "n"
        seqs.append("".join(s))
    # planted repeats and a palindrome for repfind
    seqs[1] = seqs[0][500:900] + seqs[1][400:]
    comp = str.maketrans("acgt", "tgca")
    seqs[2] = seqs[2][:1000] + seqs[0][2000:2300][::-1].translate(comp) \
        + seqs[2][1300:]
    fa = tmp / "db.fna"
    with open(fa, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">c{i} chromosome {i}\n")
            for j in range(0, len(s), 60):
                fh.write(s[j:j + 60] + "\n")
    fb = tmp / "db2.fna"
    fb.write_text(">x\n" + seqs[0][:700] + "\n")
    for pkg in ("jax", "torch"):
        (tmp / pkg).mkdir()
    return tmp, str(fa), str(fb)


def _call(run, argv):
    """(return code or exit message, stdout, stderr) of one call."""
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = run(argv)
    except SystemExit as e:
        rc = ("exit", e.code if isinstance(e.code, int) else str(e.code))
    return rc, out.getvalue(), err.getvalue()


def _files(base: str, exts, name: str) -> dict:
    got = {}
    for e in exts:
        raw = Path(f"{base}.{e}").read_bytes()
        got[e] = raw.replace(name.encode(), b"NAME")
    return got


RUNS = {"mkrcidx": (jmkrcidx.run, lambda a: tmkrcidx.run(a, "cpu")),
        "mkdna6idx": (jmkdna6idx.run, lambda a: tmkdna6idx.run(a, "cpu"))}


@pytest.mark.parametrize("extra", [[], ["-cpl"], ["-v", "-maxdepth", "5"]],
                         ids=["plain", "cpl", "v_maxdepth"])
@pytest.mark.parametrize("files", ["one", "two"])
def test_mkrcidx_same_files(data, extra, files):
    tmp, fa, fb = data
    db = [fa] if files == "one" else [fa, fb]
    results = []
    for pkg, run in zip(("jax", "torch"), RUNS["mkrcidx"]):
        name = str(tmp / pkg / f"rc_{files}_{'_'.join(extra)}")
        res = _call(run, ["-db", *db, "-indexname", name] + extra)
        results.append((res, _files(name + ".rcm", RCM, name)))
    assert results[1] == results[0]
    assert results[0][0][0] == 0
    tis = results[0][1]["tis"]
    assert len(tis) > 2 * 10_000 and len(results[0][1]["suf"]) == 8 * (
        len(tis) + 1)


@pytest.mark.parametrize("extra", [[], ["-transnum", "2"],
                                   ["-transnum", "11", "-v"]],
                         ids=["plain", "t2", "t11_v"])
def test_mkdna6idx_same_files(data, extra):
    tmp, fa, _ = data
    results = []
    for pkg, run in zip(("jax", "torch"), RUNS["mkdna6idx"]):
        name = str(tmp / pkg / f"six_{'_'.join(extra)}")
        res = _call(run, ["-db", fa, "-indexname", name] + extra)
        results.append((res, _files(name, SIXFR_BASE, name),
                        _files(name + ".6fr", SIXFR, name)))
    assert results[1] == results[0]
    assert results[0][0][0] == 0
    assert len(results[0][2]["tis"]) > 6000


@pytest.mark.parametrize("tool,argv", [
    ("mkrcidx", []),
    ("mkrcidx", ["-db", "A", "-zz"]),
    ("mkrcidx", ["-db", "A", "B"]),
    ("mkdna6idx", []),
    ("mkdna6idx", ["-db", "A", "-transnum", "7"]),
    ("mkdna6idx", ["-db", "A", "B"]),
    ("mkdna6idx", ["-db", "A", "-qq"]),
], ids=lambda x: x if isinstance(x, str) else "_".join(x))
def test_build_tool_refusals_alike(data, tool, argv):
    _, fa, fb = data
    argv = [{"A": fa, "B": fb}.get(a, a) for a in argv]
    want = _call(RUNS[tool][0], argv)
    got = _call(RUNS[tool][1], argv)
    assert got == want and want[0][0] == "exit"


REPFIND_MODES = [
    ["-f", "-l", "20"],
    ["-p", "-l", "20"],
    ["-f", "-p", "-l", "20", "-best", "10", "-nodistance"],
    ["-f", "-l", "20", "-s", "-lw", "40"],
    ["-f", "-l", "24", "-e", "1", "-allmax", "-noevalue"],
    ["-f", "-l", "30", "-h", "1"],
    ["-f", "-l", "30", "-e", "1"],
]


@pytest.mark.parametrize("opts", REPFIND_MODES, ids=lambda a: "_".join(a))
def test_repfind_same_output(data, opts, monkeypatch):
    tmp, fa, _ = data
    results = []
    for pkg, run in (("jax", jrepfind.run),
                     ("torch", lambda a: trepfind.run(a, "cpu"))):
        monkeypatch.chdir(tmp / pkg)
        monkeypatch.setenv("VSTREE_COMPILE_CACHE", "off")
        rc, out, err = _call(run, opts + [fa])
        # vmatch's header names the index by its absolute path
        results.append((rc, out.replace(f"{tmp / pkg}/", ""), err))
    assert results[1] == results[0]
    assert results[0][0] == 0
    rows = [ln for ln in results[0][1].splitlines()
            if ln and not ln.startswith("#")]
    assert rows


@pytest.mark.parametrize("argv", [
    [], ["-help"], ["-v"], ["-r", "F"], ["-mem", "F"], ["-zz", "F"],
    ["-l", "F"], ["-lw", "0", "-f", "F"], ["-f", "-l", "20", "-x"],
    ["F"], ["-f"], ["-f", "-i", "-l", "20", "F"],
    ["-f", "-l", "24", "-allmax", "F"],
], ids=lambda a: "_".join(a) or "none")
def test_repfind_refusals_and_help_alike(data, argv, monkeypatch):
    tmp, fa, _ = data
    argv = [fa if a == "F" else a for a in argv]
    results = []
    # the last two reach vmatch, which refuses their options
    for pkg, run in (("jax", jrepfind.run),
                     ("torch", lambda a: trepfind.run(a, "cpu"))):
        monkeypatch.chdir(tmp / pkg)
        results.append(_call(run, argv))
    assert results[1] == results[0]
    if argv in (["-help"], ["-v"]):
        assert results[0][0] == 0 and results[0][1]
    else:
        assert results[0][0] != 0


@pytest.mark.parametrize("tool", ["mkcfr", "mkrcidx", "mkdna6idx",
                                  "repfind"])
def test_device_tools_demand_cuda(data, tool, monkeypatch):
    """The entry points of the tools that do device work ask for the
    card and raise without one, before they read anything."""
    import importlib
    import sys

    mod = importlib.import_module(f"vstree_tpu_torch.cli.{tool}")
    _, fa, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["prog", "-db", fa])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mod.main()

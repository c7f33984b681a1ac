"""Port CLIs vs JAX CLIs: ``mkvtree -pl -allout`` index files and
``vmatch -complete -q`` stdout must be byte-identical, with either
package's index, and the port must run with jax blocked.

The port's ``run`` takes its device explicitly (CPU here); the entry
points themselves demand a CUDA device.
"""

import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from vstree_tpu.cli import mkvtree as jmkvtree
from vstree_tpu.cli import vmatch as jvmatch
from vstree_tpu_torch.cli import mkvtree as tmkvtree
from vstree_tpu_torch.cli import vmatch as tvmatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTS = ("tis", "ois", "suf", "lcp", "llv", "bwt", "bck", "sti1", "skp",
        "ssp", "des", "sds", "al1", "prj")


def _fasta(path, seqs, width=60):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">s{i} synthetic record {i}\n")
            for j in range(0, len(s), width):
                fh.write(s[j:j + width] + "\n")
    return str(path)


def _random_seq(rng, letters, n, wild="", nwild=0):
    s = list(rng.choice(list(letters), size=n))
    for p in rng.choice(n, size=nwild, replace=False):
        s[p] = wild
    return "".join(s)


def _revcomp(s):
    return s[::-1].translate(str.maketrans("acgtn", "tgcan"))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torchcli")
    rng = np.random.default_rng(41)
    dna = [_random_seq(rng, "acgt", n, "n", 6) for n in (2500, 1800, 3100)]
    dna[2] = dna[2][:1000] + dna[0][200:260] + dna[2][1060:]  # a repeat
    prot = [_random_seq(rng, "ACDEFGHIKLMNPQRSTVWY", n, "X", 3)
            for n in (700, 450)]
    def queries(num, lo, hi):
        qs = []
        for i in range(num):
            src = dna[i % 3]
            ln = int(rng.integers(lo, hi + 1))
            st = int(rng.integers(0, len(src) - ln))
            q = src[st:st + ln]
            if i % 4 == 1:
                q = _revcomp(q)
            elif i % 4 == 2:
                q = _random_seq(rng, "acgt", ln)
            qs.append(q)
        return qs

    # lengths 12-36 take the rank-count path (K1); 40-60 the packed-key
    # binary search, 80-100 the text interval search
    qs = queries(80, 12, 36)
    long_qs = queries(20, 40, 60) + queries(20, 80, 100)
    long_qs.append(dna[0][200:260])
    pq = [prot[0][100:130], prot[1][5:25], "ACDEFGHIKLMNPQRS"]
    return {
        "dir": tmp,
        "dna": _fasta(tmp / "x.fna", dna),
        "prot": _fasta(tmp / "p.fna", prot),
        "q": _fasta(tmp / "q.fna", qs),
        "qlong": _fasta(tmp / "qlong.fna", long_qs),
        "pq": _fasta(tmp / "pq.fna", pq),
    }


@pytest.fixture(scope="module")
def indexes(data):
    """The same inputs indexed by both CLIs: {kind: (jax, torch)}."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VSTREE_COMPILE_CACHE", "off")  # no XLA cache in HOME
        for kind, fasta, flag in (("dna", data["dna"], "-dna"),
                                  ("prot", data["prot"], "-protein")):
            names = []
            for pkg, run in (("jax", jmkvtree.run),
                             ("torch",
                              lambda a: tmkvtree.run(a, "cpu"))):
                name = str(data["dir"] / f"{pkg}_{kind}")
                assert run(["-db", fasta, flag, "-pl", "-allout",
                            "-indexname", name]) == 0
                names.append(name)
            out[kind] = tuple(names)
    return out


@pytest.mark.parametrize("kind", ["dna", "prot"])
def test_mkvtree_index_files_byte_identical(indexes, kind):
    jname, tname = indexes[kind]
    seen = 0
    for ext in EXTS:
        jp, tp = f"{jname}.{ext}", f"{tname}.{ext}"
        assert os.path.exists(jp) == os.path.exists(tp), ext
        if os.path.exists(jp):
            with open(jp, "rb") as a, open(tp, "rb") as b:
                assert a.read() == b.read(), ext
            seen += 1
    assert seen >= 13


def _vmatch(run, argv):
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VSTREE_COMPILE_CACHE", "off")
        assert run(argv, buf) == 0
    return buf.getvalue()


@pytest.mark.parametrize("extra", [
    [], ["-p"], ["-p", "-d"], ["-absolute"], ["-noevalue", "-noscore"],
    ["-nodist", "-noidentity"], ["-s"], ["-s", "30", "abbrev"],
], ids=lambda e: "_".join(e) or "plain")
@pytest.mark.parametrize("which", [0, 1], ids=["jax_index", "torch_index"])
def test_vmatch_complete_stdout_byte_identical(data, indexes, extra, which,
                                              monkeypatch):
    from vstree_tpu_torch.native import rankcount

    calls = []
    ref = rankcount.bucket_rank_lookup_ref
    monkeypatch.setattr(rankcount, "bucket_rank_lookup_ref",
                        lambda *a: calls.append(1) or ref(*a))
    index = indexes["dna"][which]
    argv = ["-complete"] + extra + ["-q", data["q"], index]
    want = _vmatch(lambda a, o: jvmatch.run(a, out=o), argv)
    got = _vmatch(lambda a, o: tvmatch.run(a, "cpu", out=o), argv)
    assert got == want
    assert len(got.splitlines()) > 10
    assert calls  # the rank-count path (K1's plain version on the CPU)


@pytest.mark.parametrize("extra", [[], ["-p", "-d"]],
                         ids=["plain", "-p_-d"])
def test_vmatch_complete_long_queries_byte_identical(data, indexes, extra):
    """Queries beyond the two-word coverage: the binary-search paths."""
    argv = ["-complete"] + extra + ["-q", data["qlong"], indexes["dna"][1]]
    want = _vmatch(lambda a, o: jvmatch.run(a, out=o), argv)
    got = _vmatch(lambda a, o: tvmatch.run(a, "cpu", out=o), argv)
    assert got == want
    assert len(got.splitlines()) > 10


def test_vmatch_complete_protein_byte_identical(data, indexes):
    argv = ["-complete", "-q", data["pq"], indexes["prot"][1]]
    want = _vmatch(lambda a, o: jvmatch.run(a, out=o), argv)
    got = _vmatch(lambda a, o: tvmatch.run(a, "cpu", out=o), argv)
    assert got == want
    assert len(got.splitlines()) >= 3


_BLOCKED = textwrap.dedent("""
    import io, pkgutil, sys, importlib
    sys.modules["jax"] = None          # any import of jax now fails
    import vstree_tpu_torch
    for m in pkgutil.walk_packages(vstree_tpu_torch.__path__,
                                   "vstree_tpu_torch."):
        importlib.import_module(m.name)
    from vstree_tpu_torch.cli import mkvtree, vmatch
    fasta, q, index = sys.argv[1:4]
    assert mkvtree.run(["-db", fasta, "-dna", "-pl", "-allout",
                        "-indexname", index], "cpu") == 0
    buf = io.StringIO()
    assert vmatch.run(["-complete", "-p", "-d", "-q", q, index], "cpu",
                      out=buf) == 0
    loaded = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
    assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
    sys.stdout.write(buf.getvalue())
""")


def test_port_runs_with_jax_blocked(data, indexes):
    """A subprocess (this process has jax loaded) blocks jax, imports
    every port module, and runs mkvtree and vmatch -complete."""
    index = str(data["dir"] / "blocked_dna")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKED, data["dna"], data["q"], index],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    jname = indexes["dna"][0]
    for ext in EXTS:
        if os.path.exists(f"{jname}.{ext}"):
            with open(f"{jname}.{ext}", "rb") as a, \
                    open(f"{index}.{ext}", "rb") as b:
                assert a.read() == b.read(), ext
    want = _vmatch(lambda a, o: jvmatch.run(a, out=o),
                   ["-complete", "-p", "-d", "-q", data["q"], index])
    assert r.stdout == want


def test_entry_points_demand_cuda(monkeypatch, data):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod, argv in ((tmkvtree, ["-db", data["dna"], "-dna"]),
                      (tvmatch, ["-complete", "-q", data["q"], "x"])):
        monkeypatch.setattr(sys, "argv", ["prog"] + argv)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            mod.main()


@pytest.mark.parametrize("argv,what", [
    (["-l", "20", "idx"], "option -l"),
    (["-complete", "-e", "1", "-q", "q.fna", "idx"], "option -e"),
    (["-complete", "-online", "-q", "q.fna", "idx"], "option -online"),
    (["-complete", "remred", "-q", "q.fna", "idx"],
     'argument "remred" of option -complete'),
    (["-complete", "-s", "xml", "-q", "q.fna", "idx"], "option -s xml"),
    (["-complete", "idx"], "option -complete without -q"),
])
def test_vmatch_refuses_what_is_not_ported(argv, what):
    with pytest.raises(SystemExit, match=f"vmatch: {what} is not yet "
                                         "ported to vstree_tpu_torch"):
        tvmatch.run(argv, "cpu")


def test_mkvtree_refuses_numproc(data):
    with pytest.raises(SystemExit, match="-numproc > 1 is not yet ported"):
        tmkvtree.run(["-db", data["dna"], "-dna", "-numproc", "2"], "cpu")

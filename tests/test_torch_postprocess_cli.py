"""Port CLI vs JAX CLI: the options of vmatch that are host work only.

One case per option: the constraints table (``core/optdesc.py``), the
filters (``-evalue``, ``-identity``, ``-leastscore``, the gap bounds of
``-l``), ``-best``/``-sort``, ``-showdesc``, ``-f``, ``-v``, ``-selfun``,
``-s xml``, the masking and no-match outputs, ``-dbcluster`` with
``-nonredundant``, ``-pp chain``, ``-pp matchcluster``, ``-complete remred``
and the vplugin takeover.  Stdout, and every file a run writes, must be
byte-identical to the JAX CLI's on an index built by either package; a
refusal must carry the same message.  Malformed numbers exit with one
``vmatch:`` line in the port (the JAX CLI shows a traceback, fault F4).
"""

import io
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from vstree_tpu.cli import mkvtree as jmkvtree
from vstree_tpu.cli import vmatch as jvmatch
from vstree_tpu_torch.cli import mkvtree as tmkvtree
from vstree_tpu_torch.cli import vmatch as tvmatch

REPO = Path(__file__).resolve().parents[1]

SELFUN = '''
import numpy as np

ARGS = []


def selectmatch_header(argv, args):
    ARGS[:] = args


def selectmatch_init(alpha, ms, query):
    ARGS.append(ms.numofsequences)


def selectmatch(mt):
    return mt.length1 >= int(ARGS[0])


def selectmatch_finaltable(mt):
    return mt.select(np.argsort(-mt.length1, kind="stable"))
'''


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's loops launch many small ops; a thread pool per test
    worker only makes the workers of one host wait for each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fasta(path, seqs, width=60):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">s{i} synthetic record {i} of the test\n")
            for j in range(0, len(s), width):
                fh.write(s[j:j + width] + "\n")
    return str(path)


def _mutate(rng, s, nsub):
    s = list(s)
    for p in rng.choice(len(s), nsub, replace=False):
        s[p] = "acgt"[(("acgt".index(s[p]) + 1) % 4)]
    return "".join(s)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A DNA database of 9 records sharing copies of three elements,
    with an exact duplicate and a near duplicate record; queries of
    windows of it, some mutated; the indexes of both packages."""
    tmp = tmp_path_factory.mktemp("postprocess")
    rng = np.random.default_rng(91)
    elems = ["".join(rng.choice(list("acgt"), n)) for n in (60, 90, 45)]
    recs = []
    for i in range(7):
        parts = []
        for j in range(4):
            parts.append("".join(rng.choice(list("acgt"),
                                            int(rng.integers(150, 400)))))
            e = elems[(i + j) % 3]
            parts.append(_mutate(rng, e, int(rng.integers(0, 3))))
        recs.append("".join(parts))
    recs.append(recs[2])                      # an exact duplicate
    recs.append(_mutate(rng, recs[4], 8))     # a near duplicate
    recs[1] = recs[1][:300] + "n" * 5 + recs[1][305:]
    qs = []
    for i in range(12):
        src = recs[i % 7]
        st = int(rng.integers(0, len(src) - 120))
        q = src[st:st + int(rng.integers(50, 120))]
        qs.append(_mutate(rng, q, i % 3) if i % 2 else q)
    qs.append(elems[0] + elems[1])
    files = {"db": _fasta(tmp / "x.fna", recs),
             "q": _fasta(tmp / "q.fna", qs),
             "selfun": str(tmp / "selfun.py"), "out": tmp / "out"}
    Path(files["selfun"]).write_text(SELFUN)
    names = []
    for pkg, run in (("jax", jmkvtree.run),
                     ("torch", lambda a: tmkvtree.run(a, "cpu"))):
        name = str(tmp / f"{pkg}_dna")
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("VSTREE_COMPILE_CACHE", "off")
            assert run(["-db", files["db"], "-dna", "-pl", "-allout",
                        "-indexname", name]) == 0
        names.append(name)
    files["index"] = tuple(names)
    return files


def _outcome(run, argv, outdir):
    """(stdout or the refusal's message, the files the run wrote)."""
    outdir.mkdir(exist_ok=True)
    for f in outdir.iterdir():
        f.unlink()
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VSTREE_COMPILE_CACHE", "off")
        try:
            assert run(argv, buf) == 0
            said = ("ok", buf.getvalue())
        except SystemExit as e:
            said = ("exit", str(e))
    files = {f.name: f.read_bytes() for f in sorted(outdir.iterdir())}
    return said, files


def _both(data, argv, which=1):
    out = data["out"]
    argv = [str(data.get(a, a)).replace("OUT", str(out)) for a in argv]
    argv.append(data["index"][which])
    want = _outcome(lambda a, o: jvmatch.run(a, out=o), argv, out)
    got = _outcome(lambda a, o: tvmatch.run(a, "cpu", out=o), argv, out)
    return want, got


def _rows(text):
    return [line for line in text.splitlines() if not line.startswith("#")]


@pytest.mark.parametrize("argv,rows", [
    # filters (module 4)
    (["-l", "20", "-evalue", "1e-10"], 3),
    (["-l", "20", "-identity", "95"], 3),
    (["-l", "30", "-e", "2", "-leastscore", "40"], 3),
    (["-l", "20", "-evalue", "1e-10", "-identity", "90"], 3),
    (["-l", "20", "10", "2000"], 1),
    (["-l", "20", "-10"], 1),
    # selection and show modes (module 5)
    (["-l", "20", "-best", "5"], 5),
    (["-l", "20", "-best", "50", "-sort", "ia"], 5),
    (["-l", "20", "-best", "50", "-sort", "la"], 5),
    (["-l", "20", "-best", "50", "-sort", "ld"], 5),
    (["-l", "20", "-best", "50", "-sort", "ea"], 5),
    (["-l", "20", "-showdesc", "12"], 3),
    (["-l", "20", "-showdesc", "(2,10)", "-f"], 3),
    (["-l", "20", "-showdesc", "0", "-absolute"], 3),
    (["-l", "20", "-v", "-noevalue"], 3),
    (["-l", "20", "-selfun", "selfun", "40"], 2),
    (["-l", "20", "-i", "-selfun", "selfun", "40"], 0),
    # XML (module 6)
    (["-l", "20", "-s", "xml"], 3),
    (["-l", "20", "-s", "xml", "-showdesc", "8", "-q", "q"], 3),
    (["-complete", "-s", "xml", "-q", "q"], 3),
    # masking and regions without a match (module 7)
    (["-l", "20", "-dbnomatch", "50"], 2),
    (["-l", "20", "-dbnomatch", "30", "keepleft"], 2),
    (["-l", "20", "-qnomatch", "20", "-q", "q"], 1),
    (["-l", "20", "-dbmaskmatch", "X"], 2),
    (["-l", "20", "-dbmaskmatch", "toupper", "keepright"], 2),
    (["-l", "20", "-qmaskmatch", "X", "-q", "q"], 2),
    (["-l", "20", "-qmaskmatch", "toupper", "-q", "q"], 2),
    # database clusters (module 8)
    (["-l", "40", "-dbcluster", "95", "95"], 1),
    (["-l", "40", "-dbcluster", "90", "90", "OUT/cl", "-nonredundant",
      "OUT/nr.fna"], 1),
    (["-l", "40", "-dbcluster", "20", "20", "OUT/cl", "(2,0)"], 1),
    # chains and match clusters (module 9)
    (["-l", "20", "-pp", "chain", "global"], 3),
    (["-l", "20", "-pp", "chain", "global", "gc"], 3),
    (["-l", "20", "-pp", "chain", "local"], 3),
    (["-l", "20", "-pp", "chain", "local", "3b", "outprefix", "OUT/ch"], 0),
    (["-l", "20", "-q", "q", "-pp", "chain", "global", "thread"], 3),
    (["-l", "20", "-pp", "matchcluster", "overlap", "50", "outprefix",
      "OUT/mc"], 1),
    (["-l", "20", "-pp", "matchcluster", "erate", "10", "outprefix",
      "OUT/mc"], 1),
    (["-l", "20", "-pp", "matchcluster", "gapsize", "30", "outprefix",
      "OUT/mc"], 1),
    # -complete remred (module 10)
    (["-complete", "remred", "-online", "-e", "1", "-q", "q"], 3),
    (["-complete", "remred", "-online", "-h", "1", "-q", "q"], 3),
], ids=lambda a: "_".join(a) if isinstance(a, list) else str(a))
def test_option_byte_identical(data, argv, rows):
    want, got = _both(data, argv)
    assert got == want
    assert want[0][0] == "ok"
    assert len(_rows(want[0][1])) >= rows or want[1]


@pytest.mark.parametrize("argv", [["-l", "20", "-best", "20", "-sort", "ia"],
                                  ["-l", "20", "-s", "xml"]],
                         ids=["best_sort", "xml"])
def test_jax_index_byte_identical(data, argv):
    want, got = _both(data, argv, which=0)
    assert got == want and want[0][0] == "ok"


@pytest.mark.parametrize("argv", [
    ["-complete", "remred", "-q", "q"],
    ["-complete", "remred", "-online", "-q", "q"],
    ["-complete", "bogusword", "-q", "q"],
    ["-l", "20", "-allmax", "-e", "1", "-best", "5"],
    ["-l", "20", "-allmax", "-e", "1", "-sort", "ia"],
    ["-l", "20", "-sort", "ia"],
    ["-l", "20", "-best", "5", "-sort", "xx"],
    ["-l", "20", "-nonredundant", "OUT/nr.fna"],
    ["-l", "20", "-qnomatch", "20"],
    ["-l", "20", "-dbmaskmatch", "XY"],
    ["-l", "20", "-dbmaskmatch", "tolower"],   # the text is lower case
    ["-l", "20", "-dbcluster", "101", "5"],
    ["-l", "20", "-dbcluster", "5", "5", "(1,2)"],
    ["-l", "20", "-dbcluster", "5", "5", "OUT/cl", "1,2"],
    ["-l", "20", "-pp", "sorting"],
    ["-l", "20", "-pp", "matchcluster", "overlap", "50"],
    ["-l", "20", "5", "3"],
    ["-l", "5", "-10"],
    ["-l", "20", "-showdesc", "x"],
    ["-l", "20", "-dbms"],
    ["-l", "20", "-regexp"],
    ["-l", "20", "-pssm"],
    ["-l", "20", "-vmotif"],
    ["-l", "20", "-selfun", "OUT/absent"],
], ids=lambda a: "_".join(a))
def test_refusal_same_message(data, argv):
    want, got = _both(data, argv)
    assert want[0][0] == "exit" and got == want


@pytest.mark.parametrize("argv,message", [
    (["-l", "20", "-identity", "x"],
     'argument "x" of option -identity must be an integer'),
    (["-l", "20", "-leastscore", "1.5"],
     'argument "1.5" of option -leastscore must be an integer'),
    (["-l", "20", "-evalue", "small"],
     'argument "small" of option -evalue must be a number'),
    (["-l", "20", "-dbnomatch", "many"],
     'argument "many" of option -dbnomatch must be an integer'),
    (["-l", "20", "-best", "-sort", "ia"],
     'argument "-sort" of option -best must be a non-negative integer'),
    (["-l", "20", "-best"],
     'argument "" of option -best must be a non-negative integer'),
    (["-l", "20", "-dbcluster", "x", "5"],
     'argument "x" of option -dbcluster must be an integer'),
])
def test_malformed_numbers_exit_with_one_line(data, argv, message):
    """Fault F4 of the JAX CLI is not copied: it shows a traceback for
    a malformed number, and takes ``-best`` without one as 0 (no row)."""
    with pytest.raises(SystemExit) as exc:
        tvmatch.run(argv + [data["index"][1]], "cpu", out=io.StringIO())
    assert str(exc.value) == f"vmatch: {message}"


def test_vplugin_demo_byte_identical(data, monkeypatch):
    """The demo vplugin of each package (the port's imports the port)
    takes ``-complete`` over; run from its own directory, so that both
    argument lines are the same."""
    index = data["index"][1]
    outs = []
    for pkg, run in (("vstree_tpu", lambda a, o: jvmatch.run(a, out=o)),
                     ("vstree_tpu_torch",
                      lambda a, o: tvmatch.run(a, "cpu", out=o))):
        monkeypatch.chdir(REPO / pkg / "plugins")
        for argv in (["-complete", "vmotif-demo.py", index],
                     ["-complete", "vmotif-demo.py", "-l", "6", index],
                     ["-complete", "vmotif-demo.py", "-q", data["q"],
                      "-best", "4", index]):
            buf = io.StringIO()
            assert run(argv, buf) == 0
            outs.append(buf.getvalue())
    assert outs[:3] == outs[3:]
    assert len(_rows(outs[0])) >= 3
    assert all(line.split()[0] == "6" for line in _rows(outs[0]))


def test_vplugin_missing_hook_refused_alike(data, tmp_path):
    plugin = tmp_path / "vmotif-broken.py"
    plugin.write_text("def vplugininit(data):\n    pass\n")
    argv = ["-complete", str(plugin), data["index"][1]]
    said = []
    for run in (lambda a: jvmatch.run(a, out=io.StringIO()),
                lambda a: tvmatch.run(a, "cpu", out=io.StringIO())):
        with pytest.raises(SystemExit) as exc:
            run(argv)
        said.append(str(exc.value))
    assert said[0] == said[1] and "mandatory hook" in said[0]

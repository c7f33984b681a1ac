"""Port vs JAX package: the match-file tools ``vmatchselect``,
``chain2dim`` and ``matchcluster`` (``postprocess/matchfile.py`` and
the three CLIs, all copies).

The match files are written by the JAX CLI on a 24 kbp DNA index with
planted repeats: self matches (``-l 20``, also ``-d -p`` and in the
``-absolute`` show mode) and ``-q`` matches.  Each tool of the port
prints the same stdout as the JAX package's (matchcluster: also the
same cluster files), and a malformed call fails with the same message.
"""

import contextlib
import io
import os

import numpy as np
import pytest

from vstree_tpu.cli import chain2dim as jchain2dim
from vstree_tpu.cli import matchcluster as jmatchcluster
from vstree_tpu.cli import mkvtree as jmkvtree
from vstree_tpu.cli import vmatch as jvmatch
from vstree_tpu.cli import vmatchselect as jvmatchselect
from vstree_tpu.postprocess import matchfile as jmatchfile
from vstree_tpu_torch.cli import chain2dim as tchain2dim
from vstree_tpu_torch.cli import matchcluster as tmatchcluster
from vstree_tpu_torch.cli import vmatchselect as tvmatchselect
from vstree_tpu_torch.engine.match import MatchTable
from vstree_tpu_torch.postprocess import matchfile as tmatchfile

MATCHES = {
    "self": ["-l", "20"],
    "dp": ["-l", "20", "-d", "-p"],
    "absolute": ["-l", "20", "-absolute"],
    "query": ["-l", "20", "-q", "QUERY"],
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mfile")
    rng = np.random.default_rng(23)
    letters = np.frombuffer(b"acgt", np.uint8)
    recs = [letters[rng.integers(0, 4, 6000)] for _ in range(4)]
    for _ in range(40):                 # planted copies, 1-2 % changed
        a, b = rng.integers(0, 4, 2)
        ln = int(rng.integers(30, 200))
        sa, sb = rng.integers(0, 6000 - ln, 2)
        piece = recs[a][sa:sa + ln].copy()
        at = rng.random(ln) < 0.015
        piece[at] = letters[rng.integers(0, 4, int(at.sum()))]
        if rng.random() < 0.3:          # a palindromic copy
            piece = piece[::-1].copy()
            piece = np.frombuffer(bytes(piece).translate(
                bytes.maketrans(b"acgt", b"tgca")), np.uint8)
        recs[b][sb:sb + ln] = piece
    recs[2][100:130] = ord("n")
    db = tmp / "db.fna"
    with open(db, "wb") as fh:
        for i, r in enumerate(recs):
            fh.write(b">db%d\n" % i + r.tobytes() + b"\n")
    qs = []
    for i in range(6):
        r = recs[i % 4]
        st = int(rng.integers(0, 5000))
        q = r[st:st + 600].copy()
        at = rng.random(q.size) < 0.02
        q[at] = letters[rng.integers(0, 4, int(at.sum()))]
        qs.append(letters[rng.integers(0, 4, 200)].tobytes() + q.tobytes())
    qf = tmp / "q.fna"
    with open(qf, "wb") as fh:
        for i, q in enumerate(qs):
            fh.write(b">q%d\n" % i + q + b"\n")
    index = str(tmp / "idx")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VSTREE_COMPILE_CACHE", "off")
        assert jmkvtree.run(["-db", str(db), "-dna", "-pl", "-allout",
                             "-indexname", index]) == 0
    files = {}
    for name, argv in MATCHES.items():
        argv = [str(qf) if a == "QUERY" else a for a in argv]
        path = tmp / f"{name}.match"
        with open(path, "w") as fh:
            assert jvmatch.run(argv + [index], out=fh) == 0
        files[name] = str(path)
        rows = [ln for ln in open(path) if not ln.startswith("#")]
        assert len(rows) > 20, name
    return tmp, files


def _run(run, argv):
    """(return code or exit message, stdout) of one in-process call."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = run(argv, out)
    except SystemExit as e:
        rc = ("exit", str(e.code))
    return rc, out.getvalue()


@pytest.mark.parametrize("name", list(MATCHES))
def test_read_match_file_same_table(data, name):
    _, files = data
    want = jmatchfile.read_match_file(files[name])
    got = tmatchfile.read_match_file(files[name])
    assert (got.args, got.argline, got.showmode, got.has_query) == (
        want.args, want.argline, want.showmode, want.has_query)
    assert got.table.length1.size == want.table.length1.size > 20
    for a in MatchTable.ARRAYS:
        np.testing.assert_array_equal(getattr(got.table, a),
                                      getattr(want.table, a), err_msg=a)
    assert (got.query is None) == (want.query is None)


SELECT_ARGS = [[], ["-sort", "la"], ["-sort", "ia", "-best", "5"],
               ["-sort", "ed"], ["-best", "10"], ["-sort", "idd"]]


@pytest.mark.parametrize("name", list(MATCHES))
@pytest.mark.parametrize("args", SELECT_ARGS,
                         ids=lambda a: "_".join(a) or "plain")
def test_vmatchselect_same_stdout(data, args, name):
    _, files = data
    argv = args + [files[name]]
    want = _run(jvmatchselect.run, argv)
    got = _run(tvmatchselect.run, argv)
    assert got == want and want[0] == 0
    assert len(want[1].splitlines()) > 5


CHAIN_ARGS = [
    ["-global"], ["-global", "gc"], ["-global", "ov"], ["-local"],
    ["-local", "100"], ["-local", "3b"], ["-local", "20p"],
    ["-maxgap", "1000", "-global"], ["-silent", "-local"],
    ["-silent", "-global", "gc"], ["-wf", "2.0", "-local"],
    ["-thread", "-global"],
    ["-thread", "minlen1", "10", "maxerror1", "2", "-local"],
]


@pytest.mark.parametrize("name", ["self", "query", "absolute"])
@pytest.mark.parametrize("args", CHAIN_ARGS, ids=lambda a: "_".join(a))
def test_chain2dim_same_stdout(data, args, name):
    _, files = data
    argv = args + [files[name]]
    want = _run(jchain2dim.run, argv)
    got = _run(tchain2dim.run, argv)
    assert got == want and want[0] == 0
    assert want[1]


MCL_ARGS = [["-gapsize", "100"], ["-gapsize", "0"], ["-overlap", "50"],
            ["-overlap", "90"], ["-erate", "10"]]


@pytest.mark.parametrize("name", ["self", "query"])
@pytest.mark.parametrize("args", MCL_ARGS, ids=lambda a: "_".join(a))
def test_matchcluster_same_stdout_and_files(data, args, name):
    tmp, files = data
    outs = {}
    for pkg, run in (("jax", jmatchcluster.run),
                     ("torch", tmatchcluster.run)):
        d = tmp / f"mcl_{pkg}_{name}_{'_'.join(args)}"
        d.mkdir()
        rc, text = _run(run, args + ["-outprefix", str(d / "cl"),
                                     files[name]])
        written = {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}
        outs[pkg] = (rc, text.replace(str(d), "D"), written)
    assert outs["torch"] == outs["jax"]
    assert outs["jax"][0] == 0 and outs["jax"][2]


@pytest.mark.parametrize("tool,argv", [
    ("vmatchselect", ["-sort", "xx", "FILE"]),
    ("vmatchselect", ["-sort", "la"]),
    ("vmatchselect", ["-zz", "FILE"]),
    ("chain2dim", ["FILE"]),
    ("chain2dim", ["-global"]),
    ("chain2dim", ["-thread", "minlen1", "0", "-global", "FILE"]),
    ("matchcluster", ["-gapsize", "5", "-overlap", "5", "-outprefix", "x",
                      "FILE"]),
    ("matchcluster", ["-erate", "101", "-outprefix", "x", "FILE"]),
    ("matchcluster", ["-gapsize", "5", "FILE"]),
    ("matchcluster", ["-gapsize", "5", "-outprefix", "x"]),
], ids=lambda x: x if isinstance(x, str) else "_".join(x))
def test_malformed_calls_fail_alike(data, tool, argv):
    _, files = data
    argv = [files["self"] if a == "FILE" else a for a in argv]
    mods = {"vmatchselect": (jvmatchselect, tvmatchselect),
            "chain2dim": (jchain2dim, tchain2dim),
            "matchcluster": (jmatchcluster, tmatchcluster)}[tool]
    want = _run(mods[0].run, argv)
    got = _run(mods[1].run, argv)
    assert got == want
    assert want[0][0] == "exit"

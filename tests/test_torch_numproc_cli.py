"""Port CLIs vs JAX CLIs with ``-numproc N``: ``mkvtree -numproc`` index
files, and ``vmatch -supermax`` / ``-complete -q`` stdout, must be
byte-identical to the JAX CLIs' under conftest's 8 virtual CPU devices
and to the port's own runs without ``-numproc``.  The port's ``run`` is
given eight CPU shards as the devices that ``-numproc`` may take; beyond
them it refuses with the JAX CLI's message.  Every other task takes the
mesh and runs as without it, as in the JAX CLI.
"""

import io
import os

import numpy as np
import pytest
import torch

from vstree_tpu.cli import mkvtree as jmkvtree
from vstree_tpu.cli import vmatch as jvmatch
from vstree_tpu_torch.cli import mkvtree as tmkvtree
from vstree_tpu_torch.cli import vmatch as tvmatch

CPUS = ["cpu"] * 8
EXTS = ("tis", "ois", "suf", "lcp", "llv", "bwt", "bck", "sti1", "skp",
        "ssp", "des", "sds", "al1", "prj")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fasta(path, seqs, width=60):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">s{i} synthetic record {i}\n")
            for j in range(0, len(s), width):
                fh.write(s[j:j + width] + "\n")
    return str(path)


def _records(rng, letters, sizes, wild):
    """Random records with copies of two elements, a poly-A run, a
    tandem array and a few wildcards."""
    letters = np.array(list(letters))
    elems = [letters[rng.integers(0, letters.size, ln)] for ln in (70, 130)]
    recs = []
    for n in sizes:
        s = letters[rng.integers(0, letters.size, n)]
        for elem in elems:
            st = int(rng.integers(0, n - elem.size))
            s[st:st + elem.size] = elem
        s[rng.choice(n, 3, replace=False)] = wild
        recs.append(s)
    recs[0][40:70] = letters[0]
    recs[-1][200:260] = np.tile(letters[rng.integers(0, letters.size, 6)], 10)
    return ["".join(r) for r in recs]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("numproc")
    rng = np.random.default_rng(61)
    dna = _records(rng, "acgt", (1700, 1300, 2100), "n")
    prot = _records(rng, "ACDEFGHIKLMNPQRSTVWY", (900, 700), "X")
    queries = []
    for i in range(40):
        src = dna[i % 3]
        ln = int(rng.integers(10, 30))
        st = int(rng.integers(0, len(src) - ln))
        q = src[st:st + ln]
        if i % 4 == 1:
            q = q[::-1].translate(str.maketrans("acgtn", "tgcan"))
        elif i % 4 == 2:
            q = "".join(rng.choice(list("acgt"), ln))
        queries.append(q)
    files = {"dna": _fasta(tmp / "x.fna", dna),
             "prot": _fasta(tmp / "p.fna", prot),
             "q": _fasta(tmp / "q.fna", queries)}
    index = str(tmp / "x")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VSTREE_COMPILE_CACHE", "off")  # no XLA cache in HOME
        assert jmkvtree.run(["-db", files["dna"], "-dna", "-pl", "-allout",
                             "-indexname", index]) == 0
    return tmp, files, index


def _vmatch(run, argv):
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VSTREE_COMPILE_CACHE", "off")
        assert run(argv, buf) == 0
    return buf.getvalue()


def _both(argv):
    """(port stdout with eight CPU shards, JAX stdout) of one call."""
    return (_vmatch(lambda a, o: tvmatch.run(a, "cpu", out=o,
                                             devices=CPUS), argv),
            _vmatch(lambda a, o: jvmatch.run(a, out=o), argv))


def _body(text):
    return [line for line in text.splitlines() if not line.startswith("#")]


@pytest.mark.parametrize("kind,numproc", [("dna", 2), ("dna", 4),
                                          ("prot", 3)])
def test_mkvtree_numproc_index_bytes(data, kind, numproc):
    """Every index file of ``-numproc N`` equals the JAX CLI's
    ``-numproc N`` and the port's monolithic build (the .prj names the
    index)."""
    tmp, files, _ = data
    args = ["-db", files[kind], "-dna" if kind == "dna" else "-protein",
            "-pl", "-allout"]
    names = {w: str(tmp / f"{w}_{kind}_{numproc}")
             for w in ("jax", "port", "mono")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VSTREE_COMPILE_CACHE", "off")
        assert jmkvtree.run(args + ["-numproc", str(numproc), "-indexname",
                                    names["jax"]]) == 0
    assert tmkvtree.run(args + ["-numproc", str(numproc), "-indexname",
                                names["port"]], "cpu", CPUS) == 0
    assert tmkvtree.run(args + ["-indexname", names["mono"]], "cpu") == 0
    seen = 0
    for ext in EXTS:
        if not os.path.exists(f"{names['jax']}.{ext}"):
            continue
        blobs = []
        for w, name in names.items():
            with open(f"{name}.{ext}", "rb") as fh:
                blobs.append(fh.read().replace(name.encode(), b""))
        assert blobs[0] == blobs[1] == blobs[2], ext
        seen += 1
    assert seen >= 12


@pytest.mark.parametrize("numproc", [2, 4, 8])
def test_vmatch_supermax_numproc(data, numproc):
    _, _, index = data
    got, want = _both(["-supermax", "-l", "12", "-numproc", str(numproc),
                       index])
    assert got == want
    mono = _vmatch(lambda a, o: tvmatch.run(a, "cpu", out=o),
                   ["-supermax", "-l", "12", index])
    assert _body(got) == _body(mono) and len(_body(got)) > 5


@pytest.mark.parametrize("extra", [[], ["-p", "-d"]], ids=["plain", "-p_-d"])
@pytest.mark.parametrize("numproc", [2, 8])
def test_vmatch_complete_numproc(data, numproc, extra):
    tmp, files, index = data
    argv = ["-complete"] + extra + ["-q", files["q"], "-numproc",
                                    str(numproc), index]
    got, want = _both(argv)
    assert got == want
    mono = _vmatch(lambda a, o: tvmatch.run(a, "cpu", out=o),
                   ["-complete"] + extra + ["-q", files["q"], index])
    assert _body(got) == _body(mono) and len(_body(got)) > 20


@pytest.mark.parametrize("task", [
    ["-l", "14"], ["-tandem", "-l", "8"], ["-complete", "-e", "1", "-q"],
    ["-complete", "-online", "-q"]], ids=lambda t: "_".join(t))
def test_vmatch_numproc_leaves_other_tasks_as_they_are(data, task):
    """The mesh is made for every task; only -supermax and exact
    -complete on the index use it."""
    _, files, index = data
    argv = task + ([files["q"]] if task[-1] == "-q" else []) + [
        "-numproc", "4", index]
    got, want = _both(argv)
    assert got == want and len(_body(got)) > 3


def test_vmatch_complete_dnavsprot_numproc(data):
    """-complete -dnavsprot on a protein index takes the mesh too."""
    tmp, files, _ = data
    pindex = str(tmp / "p")
    assert tmkvtree.run(["-db", files["prot"], "-protein", "-pl", "-allout",
                         "-indexname", pindex], "cpu") == 0
    got, want = _both(["-complete", "-dnavsprot", "1", "-q", files["q"],
                       "-numproc", "2", pindex])
    assert got == want


@pytest.mark.parametrize("tool", ["mkvtree", "vmatch"])
def test_numproc_beyond_the_devices_refused(data, tool):
    """-numproc 9 with eight devices: the JAX CLI's message (it has
    eight virtual devices here), from both port CLIs."""
    _, files, index = data
    if tool == "mkvtree":
        argv = ["-db", files["dna"], "-dna", "-numproc", "9",
                "-indexname", index + "_9"]
        jrun = jmkvtree.run
        trun = lambda a: tmkvtree.run(a, "cpu", CPUS)  # noqa: E731
    else:
        argv = ["-supermax", "-l", "12", "-numproc", "9", index]
        jrun = lambda a: jvmatch.run(a, out=io.StringIO())  # noqa: E731
        trun = lambda a: tvmatch.run(a, "cpu", out=io.StringIO(),  # noqa
                                     devices=CPUS)
    with pytest.raises(SystemExit) as want:
        jrun(argv)
    with pytest.raises(SystemExit) as got:
        trun(argv)
    assert str(got.value) == str(want.value) == (
        "vmatch: -numproc 9 exceeds the 8 available devices")

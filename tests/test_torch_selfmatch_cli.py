"""Port CLI vs JAX CLI: the self-match tasks (``-l``, ``-supermax``,
``-tandem``, ``-mum``, each also with ``-i``) and ``-complete -online``.
Stdout must be byte-identical on an index built by either package, in
the manner of ``tests/test_selfmatch_cli.py`` (which holds the JAX CLI
against the reference binary).
"""

import io

import numpy as np
import pytest
import torch

from vstree_tpu.cli import mkvtree as jmkvtree
from vstree_tpu.cli import vmatch as jvmatch
from vstree_tpu_torch.cli import mkvtree as tmkvtree
from vstree_tpu_torch.cli import vmatch as tvmatch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's loops issue thousands of small ops; a thread pool per
    test worker only makes the workers of one host wait for each other."""
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
    """Random records sharing diverged copies of two elements, one with
    a tandem array, each with a few wildcards."""
    letters = np.array(list(letters))
    elems = [letters[rng.integers(0, letters.size, ln)] for ln in (90, 150)]
    recs = []
    for n in sizes:
        s = letters[rng.integers(0, letters.size, n)]
        for elem in elems:
            for _ in range(2):
                copy = elem.copy()
                at = rng.choice(copy.size, 3, replace=False)
                copy[at] = letters[rng.integers(0, letters.size, 3)]
                st = int(rng.integers(0, n - copy.size))
                s[st:st + copy.size] = copy
        s[rng.choice(n, 4, replace=False)] = wild
        recs.append(s)
    unit = letters[rng.integers(0, letters.size, 11)]
    recs[0][100:166] = np.tile(unit, 6)
    return ["".join(r) for r in recs]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torchself")
    rng = np.random.default_rng(52)
    dna = _records(rng, "acgt", (2600, 1900, 3000), "n")
    prot = _records(rng, "ACDEFGHIKLMNPQRSTVWY", (1500, 1200), "X")
    extra = _records(rng, "acgt", (1400, 1000), "n")
    extra[0] = extra[0][:300] + dna[0][500:620] + extra[0][420:]
    extra[1] = extra[1][:200] + dna[2][900:1010] + extra[1][310:]
    queries = []
    for i in range(30):
        src = dna[i % 3]
        ln = int(rng.integers(14, 90))
        st = int(rng.integers(0, len(src) - ln))
        q = list(src[st:st + ln])
        if i % 3:
            q[ln // 2] = "acgt"[int(rng.integers(0, 4))]
        if i % 5 == 4:
            del q[ln // 3]
        q = "".join(q)
        if i % 2:   # found by the palindromic runs
            q = q[::-1].translate(str.maketrans("acgtn", "tgcan"))
        queries.append(q)
    files = {"dna": _fasta(tmp / "x.fna", dna),
             "prot": _fasta(tmp / "p.fna", prot),
             "extra": _fasta(tmp / "e.fna", extra),
             "q": _fasta(tmp / "q.fna", queries)}
    # the same inputs indexed by both CLIs: {kind: (jax, torch)}
    index = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VSTREE_COMPILE_CACHE", "off")  # no XLA cache in HOME
        for kind, args in (
                ("dna", ["-db", files["dna"], "-dna"]),
                ("prot", ["-db", files["prot"], "-protein"]),
                ("dbq", ["-db", files["dna"], "-q", files["extra"],
                         "-dna"])):
            names = []
            for pkg, run in (("jax", jmkvtree.run),
                             ("torch", lambda a: tmkvtree.run(a, "cpu"))):
                name = str(tmp / f"{pkg}_{kind}")
                assert run(args + ["-pl", "-allout", "-indexname",
                                   name]) == 0
                names.append(name)
            index[kind] = tuple(names)
    return files, index


def _both(argv):
    """(port stdout, JAX stdout) of one vmatch call."""
    outs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VSTREE_COMPILE_CACHE", "off")
        for run in (lambda a, o: tvmatch.run(a, "cpu", out=o),
                    lambda a, o: jvmatch.run(a, out=o)):
            buf = io.StringIO()
            assert run(argv, buf) == 0
            outs.append(buf.getvalue())
    return outs


SELF_TASKS = [
    ("dna", ["-l", "12"], 20),
    ("dna", ["-l", "12", "-absolute"], 20),
    ("dna", ["-l", "14", "-noevalue", "-noscore", "-nodist"], 10),
    ("dna", ["-l", "20", "-s"], 10),
    ("dna", ["-supermax", "-l", "10"], 10),
    ("dna", ["-supermax", "-l", "10", "-absolute", "-noidentity"], 10),
    ("dna", ["-tandem", "-l", "6"], 3),
    ("dna", ["-l", "12", "-i"], 5),
    ("dna", ["-supermax", "-l", "10", "-i"], 3),
    ("dna", ["-tandem", "-l", "6", "-i"], 2),
    ("prot", ["-l", "6"], 10),
    ("prot", ["-supermax", "-l", "5"], 5),
    ("prot", ["-tandem", "-l", "4"], 2),
    ("dbq", ["-mum", "-l", "10"], 3),
    ("dbq", ["-mum", "-l", "12", "-absolute"], 3),
    ("dbq", ["-mum", "-l", "10", "-i"], 2),
    ("dbq", ["-l", "12"], 3),          # the crossing filter
]


@pytest.mark.parametrize("which", [0, 1], ids=["jax_index", "torch_index"])
@pytest.mark.parametrize("kind,task,least", SELF_TASKS,
                         ids=[f"{k}{'_'.join(t)}" for k, t, _ in SELF_TASKS])
def test_selfmatch_stdout_byte_identical(data, kind, task, least, which):
    _, index = data
    got, want = _both(task + [index[kind][which]])
    assert got == want
    assert len(got.splitlines()) > least


@pytest.mark.parametrize("which", [0, 1], ids=["jax_index", "torch_index"])
@pytest.mark.parametrize("extra", [
    [], ["-h", "1"], ["-h", "2", "-p"], ["-e", "1"], ["-e", "2", "-p", "-d"],
    ["-e", "1", "-s", "abbrev"], ["-h", "1", "-i"],
], ids=lambda e: "_".join(e) or "exact")
def test_online_stdout_byte_identical(data, extra, which):
    files, index = data
    argv = ["-complete", "-online"] + extra + ["-q", files["q"],
                                               index["dna"][which]]
    got, want = _both(argv)
    assert got == want
    assert len(got.splitlines()) > 4


def test_dbq_index_files_byte_identical(data):
    """mkvtree -db -q through both CLIs: the tables and the project file
    (which carries the indexed-query counts) are the same bytes."""
    _, index = data
    jname, tname = index["dbq"]
    for ext in ("tis", "suf", "lcp", "bwt", "ssp", "prj"):
        with open(f"{jname}.{ext}", "rb") as a, \
                open(f"{tname}.{ext}", "rb") as b:
            ja, tb = a.read(), b.read()
        if ext == "prj":
            assert b"numofquerysequences=2" in ja
            ja, tb = ja.replace(b"jax_dbq", b"x"), tb.replace(b"torch_dbq",
                                                              b"x")
        assert ja == tb, ext


@pytest.mark.parametrize("kind,argv,message", [
    ("dna", ["-supermax"], "option -supermax requires option -l"),
    ("dna", ["-tandem"], "option -tandem requires option -l"),
    ("dbq", ["-mum"], "option -mum requires option -l"),
    ("dbq", ["-mum", "cand", "-l", "10"],
     "option -mum cand also requires option -q"),
    ("dbq", ["-supermax", "-l", "10"],
     "supermaximal repeat search does not allow query files in index"),
    ("dbq", ["-tandem", "-l", "10"],
     "tandem repeat search does not allow query files in index"),
    ("dna", ["-l", "12", "-i", "-absolute"],
     "option -i and option -absolute exclude each other"),
    ("dna", ["-complete", "-l", "12", "-q", "Q"],
     "option -l and option -complete exclude each other"),
])
def test_messages_of_both_clis(data, kind, argv, message):
    files, index = data
    argv = [files["q"] if a == "Q" else a for a in argv]
    for run, name in ((lambda a: tvmatch.run(a, "cpu", out=io.StringIO()),
                       index[kind][1]),
                      (lambda a: jvmatch.run(a, out=io.StringIO()),
                       index[kind][0])):
        with pytest.raises(SystemExit) as exc:
            run(argv + [name])
        assert str(exc.value) == f"vmatch: {message}"


def test_mum_without_indexed_queries_exits_with_a_message(data):
    """The JAX CLI lets the engine's ValueError escape as a traceback;
    the port exits with the same words in one line."""
    _, index = data
    with pytest.raises(SystemExit, match="vmatch: maximal unique matches "
                       "search requires at least one query file"):
        tvmatch.run(["-mum", "-l", "10", index["dna"][1]], "cpu",
                    out=io.StringIO())

"""Port CLI vs JAX CLI: query matching on the index (``vmatch -l L -q``,
``-mum [cand]``, ``-d``/``-p``, ``-qspeedup``, the seed extension with
``-q``, ``-online -q``), self-palindromic matches (``-l L -p`` without
``-q``) and the flags the reference ignores on the other self tasks.
Stdout must be byte-identical on an index built by either package.
"""

import io

import numpy as np
import pytest
import torch

from vstree_tpu.cli import mkvtree as jmkvtree
from vstree_tpu.cli import vmatch as jvmatch
from vstree_tpu_torch.cli import mkvtree as tmkvtree
from vstree_tpu_torch.cli import vmatch as tvmatch
from vstree_tpu_torch.engine import query as tquery


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's loops issue many small ops; a thread pool per test
    worker only makes the workers of one host wait for each other."""
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


_RC = str.maketrans("acgtn", "tgcan")


def _revcomp(s):
    return s[::-1].translate(_RC)


def _mutate(rng, s, every):
    s = list(s)
    for at in rng.choice(len(s), max(1, len(s) // every), replace=False):
        s[at] = "acgt"[int(rng.integers(0, 4))]
    return "".join(s)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A database of four records with planted copies and reverse
    complements of its own windows (self-palindromic rows), a duplicated
    record and N runs; a query file of mutated windows of the database,
    direct and reverse-complemented, in random filler, one record with a
    wildcard run; its first three records for ``-online``; a one-record
    query for ``-online -mum``.  Indexes: the database by both packages,
    and database + queries by the port (for ``-mum`` without ``-q``)."""
    tmp = tmp_path_factory.mktemp("torchquery")
    rng = np.random.default_rng(97)

    def rand(n):
        return "".join(rng.choice(list("acgt"), n))

    db = [rand(n) for n in (2600, 2100, 2900)]
    for k in range(6):
        a, b = rng.choice(3, 2, replace=False)
        ln = int(rng.integers(50, 160))
        src = int(rng.integers(0, len(db[a]) - ln))
        dst = int(rng.integers(0, len(db[b]) - ln))
        piece = db[a][src:src + ln]
        piece = _revcomp(piece) if k % 2 else _mutate(rng, piece, 50)
        db[b] = db[b][:dst] + piece + db[b][dst + ln:]
    db[2] = db[2][:700] + "n" * 9 + db[2][709:]
    db.append(db[1])
    queries = []
    for i in range(9):
        src = db[i % 3]
        ln = int(rng.integers(80, 400))
        st = int(rng.integers(0, len(src) - ln))
        w = _mutate(rng, src[st:st + ln], 40)
        if i % 3 == 1:
            w = _revcomp(w)
        queries.append(rand(int(rng.integers(10, 80))) + w
                       + rand(int(rng.integers(10, 80))))
    queries[4] = queries[4][:30] + "nnnn" + queries[4][34:]
    files = {"db": _fasta(tmp / "x.fna", db),
             "q": _fasta(tmp / "q.fna", queries),
             "q3": _fasta(tmp / "q3.fna", queries[:3]),
             "q1": _fasta(tmp / "q1.fna", [queries[0] + queries[1]])}
    index = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VSTREE_COMPILE_CACHE", "off")  # no XLA cache in HOME
        for pkg, run in (("jax", jmkvtree.run),
                         ("torch", lambda a: tmkvtree.run(a, "cpu"))):
            name = str(tmp / pkg)
            assert run(["-db", files["db"], "-dna", "-pl", "-allout",
                        "-indexname", name]) == 0
            index.append(name)
    dbq = str(tmp / "dbq")
    assert tmkvtree.run(["-db", files["db"], "-q", files["q"], "-dna", "-pl",
                         "-allout", "-indexname", dbq], "cpu") == 0
    index.append(dbq)
    return files, index


def _both(argv, env=None):
    """(port stdout, JAX stdout) of one vmatch call."""
    outs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VSTREE_COMPILE_CACHE", "off")
        for k, v in (env or {}).items():
            mp.setenv(k, v)
        for run in (lambda a, o: tvmatch.run(a, "cpu", out=o),
                    lambda a, o: jvmatch.run(a, out=o)):
            buf = io.StringIO()
            assert run(argv, buf) == 0
            outs.append(buf.getvalue())
    return outs


QUERY_TASKS = [
    (["-l", "15", "-q", "Q"], 10),
    (["-l", "15", "-absolute", "-q", "Q"], 10),
    (["-mum", "-l", "15", "-q", "Q"], 3),
    (["-mum", "cand", "-l", "15", "-q", "Q"], 5),
    (["-qspeedup", "0", "-l", "15", "-q", "Q"], 10),
    (["-qspeedup", "2", "-l", "15", "-q", "Q"], 10),
    (["-qspeedup", "5", "-l", "15", "-q", "Q"], 10),
    (["-d", "-p", "-l", "15", "-q", "Q"], 15),
    (["-p", "-l", "15", "-q", "Q"], 5),
    (["-p", "-mum", "cand", "-l", "15", "-s", "-q", "Q"], 5),
    (["-l", "15", "-i", "-q", "Q"], 3),
    (["-l", "30", "-e", "1", "-q", "Q"], 5),
    (["-l", "30", "-h", "1", "-q", "Q"], 5),
    (["-exdrop", "2", "-seedlength", "14", "-q", "Q"], 5),
    (["-l", "40", "-hxdrop", "2", "-seedlength", "16", "-p", "-d", "-q",
      "Q"], 5),
    (["-online", "-l", "15", "-q", "Q3"], 5),
    (["-online", "-mum", "cand", "-l", "15", "-p", "-d", "-q", "Q3"], 5),
    (["-online", "-mum", "-l", "15", "-q", "Q1"], 2),
]
SELF_TASKS = [
    (["-l", "15", "-p"], 3),
    (["-l", "15", "-p", "-d"], 10),
    (["-l", "15", "-p", "-d", "-qspeedup", "0", "-s", "abbrev"], 20),
    (["-l", "30", "-e", "1", "-p"], 3),
    (["-l", "30", "-h", "2", "-p", "-d"], 5),
    (["-l", "30", "-exdrop", "2", "-p"], 3),
]


def _argv(files, task, index):
    names = {"Q": files["q"], "Q1": files["q1"], "Q3": files["q3"]}
    return [names.get(a, a) for a in task] + [index]


@pytest.mark.parametrize("which", [0, 1], ids=["jax_index", "torch_index"])
@pytest.mark.parametrize("task,least", QUERY_TASKS,
                         ids=["_".join(t[:-2]) for t, _ in QUERY_TASKS])
def test_query_stdout_byte_identical(data, task, least, which):
    files, index = data
    got, want = _both(_argv(files, task, index[which]))
    assert got == want
    assert len(got.splitlines()) > least


@pytest.mark.parametrize("task,least", SELF_TASKS,
                         ids=["_".join(t) for t, _ in SELF_TASKS])
def test_self_palindromic_stdout_byte_identical(data, task, least):
    files, index = data
    got, want = _both(task + [index[1]])
    assert got == want
    assert len(got.splitlines()) > least
    rows = [line.split() for line in got.splitlines()[1:] if "P" in line]
    assert rows


def test_self_palindromic_takes_the_query_path(data, monkeypatch):
    """``-l 15 -p``: the palindromic part is find_query_matches of the
    database's reverse complement, flagged self-palindromic."""
    files, index = data
    calls = []
    real = tquery.find_query_matches
    monkeypatch.setattr(tvmatch, "find_query_matches",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    got, want = _both(["-l", "15", "-p", index[1]])
    assert got == want and [k["flags_extra"] for k in calls] == [6]


@pytest.mark.parametrize("task,which", [
    (["-supermax", "-l", "12", "-p"], 1), (["-tandem", "-l", "6", "-p"], 1),
    (["-mum", "-l", "12", "-p"], 2), (["-l", "15", "-online"], 1),
    (["-supermax", "-l", "12", "-online"], 1),
], ids=lambda t: "_".join(t) if isinstance(t, list) else str(t))
def test_flags_the_reference_ignores(data, task, which):
    """Repaired port fault P-F2: ``-p`` on -supermax/-tandem/-mum and
    ``-online`` on a self task were refused; both CLIs ignore them."""
    files, index = data
    got, want = _both(task + [index[which]])
    assert got == want and len(got.splitlines()) > 2
    plain, _ = _both([a for a in task if a not in ("-p", "-online")]
                     + [index[which]])
    assert got.splitlines()[1:] == plain.splitlines()[1:]


@pytest.mark.parametrize("value", ["0", "5"])
def test_queryspeedup_variable_overrides_the_option(data, value):
    files, index = data
    argv = _argv(files, ["-qspeedup", "2", "-l", "15", "-q", "Q"], index[1])
    got, want = _both(argv, {"QUERYSPEEDUP": value})
    assert got == want and len(got.splitlines()) > 10


@pytest.mark.parametrize("argv,env,message", [
    (["-qspeedup", "1"], None, "Algorithm 1 is no longer available, please "
     "use Algorithm 0, or 2; we recommend Algorithm 2"),
    (["-qspeedup", "3"], None, "Algorithm 3 is not supported (it crashes "
     "the reference implementation); please use Algorithm 0, 2 or 5"),
    (["-qspeedup", "4"], None, "Algorithm 4 is not supported: the "
     "reference's own reader rejects its mklsf output (size mismatch, "
     "readvirt.c:895), making it unusable there; please use Algorithm 0, 2 "
     "or 5"),
    (["-qspeedup", "7"], None, "illegal speedup value 7"),
    ([], "x2", 'incorrect value "x2" of environment variable QUERYSPEEDUP; '
     "must be non-negative integer"),
    ([], "-1", 'incorrect value "-1" of environment variable QUERYSPEEDUP; '
     "must be non-negative integer"),
    (["-qspeedup", "a"], None, "argument of option -qspeedup must be "
     "non-negative integer"),
    (["-online", "-mum", "-l", "15"], None, "options -mum, -q, and -online "
     "can only be combined if there is exactly one sequence in the query "
     "file"),
    (["-mum", "-q", "Q"], None, "task not implemented yet"),
])
def test_messages_of_both_clis(data, argv, env, message):
    files, index = data
    if "-q" not in argv:
        argv = argv + ["-l", "15", "-q", "Q"]
    for run, name in ((lambda a: tvmatch.run(a, "cpu", out=io.StringIO()),
                       index[1]),
                      (lambda a: jvmatch.run(a, out=io.StringIO()),
                       index[0])):
        with pytest.MonkeyPatch.context() as mp:
            if env is not None:
                mp.setenv("QUERYSPEEDUP", env)
            with pytest.raises(SystemExit) as exc:
                run(_argv(files, argv, name))
        assert str(exc.value) == f"vmatch: {message}"

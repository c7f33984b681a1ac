"""Port CLI vs JAX CLI: seed extension (``vmatch -l L`` with ``-e k``,
``-h k``, ``-exdrop x``, ``-hxdrop x``, ``-seedlength``, ``-allmax``,
``-s``).  Stdout must be byte-identical on an index built by either
package, plain or with indexed queries, in the manner of
``tests/test_extend_cli.py`` (which holds the JAX CLI against the
reference binary).
"""

import io

import numpy as np
import pytest
import torch

from vstree_tpu.cli import mkvtree as jmkvtree
from vstree_tpu.cli import vmatch as jvmatch
from vstree_tpu_torch.cli import mkvtree as tmkvtree
from vstree_tpu_torch.cli import vmatch as tvmatch
from vstree_tpu_torch.engine import gextend_dev as tgextend_dev


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's loops launch thousands of small ops; a thread pool per
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


def _edited(rng, elem, letters, nsub, nindel):
    copy = list(elem)
    for _ in range(nsub):
        copy[int(rng.integers(0, len(copy)))] = letters[
            int(rng.integers(0, len(letters)))]
    for _ in range(nindel):
        at = int(rng.integers(1, len(copy) - 1))
        if rng.integers(0, 2):
            del copy[at]
        else:
            copy.insert(at, letters[int(rng.integers(0, len(letters)))])
    return copy


def _records(rng, letters, sizes, wild, elems=None):
    """Random records that share copies of three elements, the copies
    differing by substitutions and indels; one tandem array with a
    mutated unit and a few wildcards per record.  Returns the records
    and the elements."""
    letters = list(letters)

    def rand(n):
        return [letters[i] for i in rng.integers(0, len(letters), n)]

    elems = elems or [rand(ln) for ln in (80, 120, 170)]
    recs = []
    for n in sizes:
        s = rand(n)
        at = 30
        for k in range(6):
            copy = _edited(rng, elems[k % 3], letters, k % 3, k % 2)
            at += int(rng.integers(30, 150))
            s[at:at + len(copy)] = copy
            at += len(copy)
        assert at < n - 150
        for p in rng.choice(n, 4, replace=False):
            s[p] = wild
        recs.append(s[:n])
    arr = rand(11) * 7
    arr[40] = letters[(letters.index(arr[40]) + 1) % len(letters)]
    recs[0][-130:-130 + len(arr)] = arr
    return ["".join(r) for r in recs], elems


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torchextend")
    rng = np.random.default_rng(83)
    dna, elems = _records(rng, "acgt", (2400, 1800, 2700), "n")
    extra, _ = _records(rng, "acgt", (1700, 1600), "n", elems)
    prot, _ = _records(rng, "ACDEFGHIKLMNPQRSTVWY", (1700, 1500), "X")
    files = {"dna": _fasta(tmp / "x.fna", dna),
             "extra": _fasta(tmp / "e.fna", extra),
             "prot": _fasta(tmp / "p.fna", prot)}
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
        mp.delenv("VSTREE_DEVICE_ENGINES", raising=False)
        for run in (lambda a, o: tvmatch.run(a, "cpu", out=o),
                    lambda a, o: jvmatch.run(a, out=o)):
            buf = io.StringIO()
            assert run(argv, buf) == 0
            outs.append(buf.getvalue())
    return outs


TASKS = [
    ("dna", ["-l", "24", "-e", "2"], 20),
    ("dna", ["-l", "24", "-e", "1", "-seedlength", "14"], 10),
    ("dna", ["-l", "24", "-e", "2", "-allmax"], 20),
    ("dna", ["-l", "30", "-e", "3", "-absolute"], 10),
    ("dna", ["-l", "24", "-e", "2", "-s"], 40),
    ("dna", ["-l", "24", "-e", "2", "-i"], 5),
    ("dna", ["-l", "24", "-h", "2"], 20),
    ("dna", ["-l", "24", "-h", "1", "-seedlength", "16"], 10),
    ("dna", ["-l", "24", "-h", "2", "-allmax", "-noevalue", "-noscore"], 20),
    ("dna", ["-l", "24", "-h", "1", "-s", "abbrev"], 20),
    ("dna", ["-l", "30", "-exdrop", "3"], 10),
    ("dna", ["-exdrop", "2", "-seedlength", "16"], 20),
    ("dna", ["-l", "30", "-exdrop", "4", "-seedlength", "14", "-s"], 40),
    ("dna", ["-l", "30", "-hxdrop", "3"], 5),
    ("dna", ["-l", "26", "-hxdrop", "2", "-seedlength", "14", "-nodist"], 10),
    ("dna", ["-l", "26", "-hxdrop", "3", "-seedlength", "14", "-s", "60"],
     20),
    ("prot", ["-l", "14", "-e", "1"], 10),
    ("prot", ["-l", "14", "-h", "1", "-allmax"], 10),
    ("prot", ["-l", "12", "-exdrop", "2", "-seedlength", "7"], 10),
    ("prot", ["-l", "12", "-hxdrop", "2", "-seedlength", "7"], 5),
    # an index with indexed queries: the two-step path and the crossing
    # filter on the seeds
    ("dbq", ["-l", "24", "-e", "2"], 5),
    ("dbq", ["-l", "24", "-e", "2", "-allmax"], 5),
    ("dbq", ["-l", "24", "-h", "2"], 5),
    ("dbq", ["-l", "24", "-exdrop", "3", "-seedlength", "14"], 5),
    ("dbq", ["-l", "24", "-hxdrop", "3", "-seedlength", "14", "-s"], 10),
]


@pytest.mark.parametrize("which", [0, 1], ids=["jax_index", "torch_index"])
@pytest.mark.parametrize("kind,task,least", TASKS,
                         ids=[f"{k}{'_'.join(t)}" for k, t, _ in TASKS])
def test_extension_stdout_byte_identical(data, kind, task, least, which):
    _, index = data
    got, want = _both(task + [index[kind][which]])
    assert got == want
    assert len(got.splitlines()) > least


def test_edit_rows_have_unequal_lengths_and_take_the_fused_path(
        data, monkeypatch):
    """``-e`` on a plain index goes through ``edit_extend_self_device``
    (at a small chunk here), on an index with indexed queries through
    the two-step path; some rows have length1 != length2."""
    from vstree_tpu_torch.engine import gextend as tgextend

    _, index = data
    calls = []
    for name in ("edit_extend_self_device", "edit_extend_seeds"):
        real = getattr(tgextend, name)
        monkeypatch.setattr(
            tvmatch, name,
            lambda *a, _n=name, _r=real, **k: calls.append(_n) or _r(*a, **k))
    monkeypatch.setattr(tgextend_dev, "_CHUNK_SEEDS", 41)
    got, want = _both(["-l", "24", "-e", "2", index["dna"][1]])
    assert got == want and calls == ["edit_extend_self_device"]
    rows = [line.split() for line in got.splitlines()[1:]]
    assert any(r[0] != r[4] for r in rows)
    assert all(0 <= int(r[7]) <= 2 for r in rows)
    del calls[:]
    got, want = _both(["-l", "24", "-e", "2", index["dbq"][1]])
    assert got == want and calls == ["edit_extend_seeds"]


def test_pathological_run_takes_the_two_step_path(data, monkeypatch):
    """When the seed enumeration's guard fires the CLI runs the seeds
    through the host table, as the JAX CLI does: the same rows."""
    from vstree_tpu_torch.engine import repeats_dev

    _, index = data
    argv = ["-l", "24", "-e", "2", index["dna"][1]]
    want = _both(argv)[1]
    monkeypatch.setattr(repeats_dev, "_PAIR_CHUNK", 2)
    buf = io.StringIO()
    assert tvmatch.run(argv, "cpu", out=buf) == 0
    assert buf.getvalue() == want


@pytest.mark.parametrize("option", ["-exdrop", "-hxdrop", "-seedlength",
                                    "-e", "-h"])
@pytest.mark.parametrize("arg", ["2b", "xp", "-3", ""])
def test_malformed_number_exits_with_one_line(option, arg):
    """A malformed number is a message, not a traceback (the JAX CLI
    raises ValueError from ``int`` or takes the word for the index)."""
    argv = ["-l", "30", option] + ([arg] if arg else []) + ["idx"]
    if not arg:
        argv = argv[:-1]            # the option comes last
    shown = arg if arg else ""
    with pytest.raises(SystemExit) as exc:
        tvmatch.run(argv, "cpu", out=io.StringIO())
    assert str(exc.value) == (f'vmatch: argument "{shown}" of option '
                              f"{option} must be a non-negative integer")


@pytest.mark.parametrize("kind,argv,message", [
    ("dna", ["-l", "24", "-allmax"],
     "option -allmax requires either option -h or -e"),
    ("dna", ["-l", "24", "-exdrop", "3", "-allmax"],
     "option -allmax requires either option -h or -e"),
])
def test_messages_of_both_clis(data, kind, argv, message):
    _, index = data
    for run, name in ((lambda a: tvmatch.run(a, "cpu", out=io.StringIO()),
                       index[kind][1]),
                      (lambda a: jvmatch.run(a, out=io.StringIO()),
                       index[kind][0])):
        with pytest.raises(SystemExit) as exc:
            run(argv + [name])
        assert str(exc.value) == f"vmatch: {message}"


def _said(run, argv):
    """The stdout of a vmatch call, or its exit message."""
    buf = io.StringIO()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("VSTREE_COMPILE_CACHE", "off")
            assert run(argv, buf) == 0
    except SystemExit as e:
        return "exit", str(e)
    return "ok", buf.getvalue()


@pytest.mark.parametrize("argv,said", [
    (["-l", "30", "-e", "2", "-d", "-p", "-leastscore", "20", "idx"], "ok"),
    (["-l", "30", "-e", "2", "-q", "q.fna", "-v", "idx"], "ok"),
    (["-l", "30", "3", "-e", "2", "idx"], "ok"),
    (["-e", "2", "idx"], "vmatch: task not implemented yet"),
    (["-h", "2", "-seedlength", "12", "idx"],
     "vmatch: task not implemented yet"),
    (["-l", "30", "-e", "2", "-best", "5", "idx"], "ok"),
], ids=lambda v: "_".join(v) if isinstance(v, list) else None)
def test_options_once_refused_as_the_jax_cli(data, argv, said):
    """What the port refused before it had the whole CLI: the same
    stdout as the JAX CLI, or the same message."""
    files, index = data
    argv = [{"q.fna": files["extra"], "idx": index["dna"][1]}.get(a, a)
            for a in argv]
    want = _said(lambda a, o: jvmatch.run(a, out=o), argv)
    got = _said(lambda a, o: tvmatch.run(a, "cpu", out=o), argv)
    assert got == want
    if said == "ok":
        assert want[0] == "ok" and len(want[1].splitlines()) > 3
    else:
        assert want == ("exit", said)


@pytest.mark.parametrize("argv,what", [
    (["-l", "30", "-e", "2", "-numproc", "4", "idx"],
     "-numproc 4 exceeds the 1 available devices"),
])
def test_what_is_still_refused(data, argv, what):
    """Only more shards than the devices ``run`` is given (here
    ``device`` alone), with the JAX CLI's message; with four devices the
    seed extension runs as without ``-numproc``."""
    import re

    files, index = data
    argv = [{"idx": index["dna"][1]}.get(a, a) for a in argv]
    with pytest.raises(SystemExit, match=re.escape(f"vmatch: {what}")):
        tvmatch.run(argv, "cpu")
    got = _said(lambda a, o: tvmatch.run(a, "cpu", out=o,
                                         devices=["cpu"] * 4), argv)
    assert got == _said(lambda a, o: jvmatch.run(a, out=o), argv)
    assert got[0] == "ok"

"""Port CLIs vs JAX CLIs: ``mkvtree -pl -allout`` index files and
``vmatch -complete -q`` stdout must be byte-identical, with either
package's index, and the port must run with jax and vstree_tpu blocked.

The port's ``run`` takes its device explicitly (CPU here); the entry
points themselves demand a CUDA device.
"""

import contextlib
import io
import os
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from vstree_tpu.cli import chain2dim as jchain2dim
from vstree_tpu.cli import chainqhits as jchainqhits
from vstree_tpu.cli import mkcfr as jmkcfr
from vstree_tpu.cli import mkrcidx as jmkrcidx
from vstree_tpu.cli import mkvtree as jmkvtree
from vstree_tpu.cli import repfind as jrepfind
from vstree_tpu.cli import vmatch as jvmatch
from vstree_tpu.cli import vmatchselect as jvmatchselect
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
    import contextlib, io, pkgutil, sys, importlib
    sys.modules["jax"] = None          # any import of jax now fails
    sys.modules["vstree_tpu"] = None   # and of the JAX package
    import vstree_tpu_torch
    for m in pkgutil.walk_packages(vstree_tpu_torch.__path__,
                                   "vstree_tpu_torch."):
        importlib.import_module(m.name)
    from vstree_tpu_torch.cli import chainqhits, mkvtree, vmatch
    fasta, q, index, pfasta, pindex, plugin, qlong = sys.argv[1:8]
    assert mkvtree.run(["-db", fasta, "-dna", "-pl", "-allout",
                        "-indexname", index], "cpu") == 0
    assert mkvtree.run(["-db", pfasta, "-protein", "-pl", "-allout",
                        "-indexname", pindex], "cpu") == 0
    buf = io.StringIO()
    for argv in (["-complete", "-p", "-d", "-q", q, index],
                 ["-complete", "-e", "1", "-q", q, index],
                 ["-complete", "-online", "-e", "1", "-q", q, index],
                 ["-l", "14", index], ["-l", "30", "-e", "2", index],
                 ["-l", "30", "-exdrop", "3", index],
                 ["-l", "20", "-q", q, index], ["-l", "20", "-p", index],
                 ["-l", "14", "-best", "5", "-sort", "ia", index],
                 ["-l", "20", "-s", "xml", index],
                 ["-complete", "-dnavsprot", "1", "-q", q, pindex],
                 ["-complete", plugin, index]):
        assert vmatch.run(argv, "cpu", out=buf) == 0
    # -numproc 2 on two CPU shards: the parallel package, jax blocked
    assert mkvtree.run(["-db", fasta, "-dna", "-pl", "-allout", "-numproc",
                        "2", "-indexname", index + "_np2"], "cpu",
                       ["cpu", "cpu"]) == 0
    assert vmatch.run(["-supermax", "-l", "12", "-numproc", "2", index],
                      "cpu", out=buf, devices=["cpu", "cpu"]) == 0
    with contextlib.redirect_stdout(buf):
        assert chainqhits.run(["12", "2", index, qlong, "nocheckleast"],
                              "cpu") == 0
    import os
    from vstree_tpu_torch.cli import (chain2dim, mkcfr, mkrcidx, repfind,
                                      vmatchselect)
    from vstree_tpu_torch.index.build import build_suf_out_of_core
    from vstree_tpu_torch.index.esa import ESA
    mfile = index + ".match"
    with open(mfile, "w") as fh:
        assert vmatch.run(["-l", "14", index], "cpu", out=fh) == 0
    assert vmatchselect.run(["-sort", "ia", mfile], buf) == 0
    assert chain2dim.run(["-global", mfile], buf) == 0
    assert mkvtree.run(["-db", fasta, "-dna", "-rev", "-pl", "-allout",
                        "-indexname", index], "cpu") == 0
    assert mkcfr.run([index], "cpu") == 0
    assert mkrcidx.run(["-db", fasta, "-indexname", index], "cpu") == 0
    os.chdir(os.path.dirname(index))
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        assert repfind.run(["-f", "-l", "20", fasta], "cpu") == 0
    esa = ESA.read(index, "cpu")
    suf, lcp = build_suf_out_of_core(esa.multiseq, esa.alpha, 3000,
                                     device="cpu")
    assert (suf == esa.suftab).all() and (lcp == esa.lcptab).all()
    # the entry point in its timing mode, traced by torch.profiler
    trace = os.path.join(os.path.dirname(index), "entry_trace")
    os.environ.update(VMATCHSHOWTIMESPACE="on", VSTREE_PROFILE=trace)
    timing = io.StringIO()
    try:
        with contextlib.redirect_stdout(timing):
            vmatch.entry(["-complete", "-e", "1", "-q", q, index],
                         lambda: "cpu", lambda: ["cpu"])
    except SystemExit as e:
        assert e.code == 0, e.code
    del os.environ["VMATCHSHOWTIMESPACE"], os.environ["VSTREE_PROFILE"]
    assert [line.split()[:3] for line in timing.getvalue().splitlines()
            ] == [["#", "TIME", "vmatch"], ["#", "SPACE", "vmatch"]]
    assert [f for f in os.listdir(trace) if f.endswith(".pt.trace.json")]
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "vstree_tpu"))
    assert loaded == ["jax", "vstree_tpu"], loaded
    assert sys.modules["jax"] is None is sys.modules["vstree_tpu"]
    sys.stdout.write(buf.getvalue())
""")


def test_port_runs_with_jax_blocked(data, indexes):
    """A subprocess (this process has jax loaded) blocks jax and
    vstree_tpu, imports every port module, and runs mkvtree, vmatch
    -complete, -complete -e 1, -complete -online -e 1, -l, -l -e 2,
    -l -exdrop 3, -l -q, -l -p, -l -best -sort, -l -s xml, -complete
    -dnavsprot 1 on a protein index, the port's vplugin demo (loaded by
    path), mkvtree -numproc 2 (index files equal the monolithic build's)
    and vmatch -supermax -numproc 2 on two CPU shards, and chainqhits;
    then vmatchselect and chain2dim on a match
    file, mkcfr on the index and its reverse, mkrcidx, repfind (in the
    index's directory), the out-of-core build (tables equal to the
    index's) and vmatch's entry point with VMATCHSHOWTIMESPACE=on and
    VSTREE_PROFILE set (the two timing lines, a trace file)."""
    index = str(data["dir"] / "blocked_dna")
    pindex = str(data["dir"] / "blocked_prot")
    plugin = os.path.join(REPO, "vstree_tpu_torch", "plugins",
                          "vmotif-demo.py")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKED, data["dna"], data["q"], index,
         data["prot"], pindex, plugin, data["qlong"]],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    for jname, tname in ((indexes["dna"][0], index),
                         (indexes["prot"][0], pindex)):
        for ext in EXTS:
            if os.path.exists(f"{jname}.{ext}"):
                with open(f"{jname}.{ext}", "rb") as a, \
                        open(f"{tname}.{ext}", "rb") as b:
                    if ext == "prj":  # names the index
                        assert a.read().replace(jname.encode(), b"") == \
                            b.read().replace(tname.encode(), b""), ext
                    else:
                        assert a.read() == b.read(), ext
    want = "".join(
        _vmatch(lambda a, o: jvmatch.run(a, out=o), task)
        for task in (["-complete", "-p", "-d", "-q", data["q"], index],
                     ["-complete", "-e", "1", "-q", data["q"], index],
                     ["-complete", "-online", "-e", "1", "-q", data["q"],
                      index],
                     ["-l", "14", index], ["-l", "30", "-e", "2", index],
                     ["-l", "30", "-exdrop", "3", index],
                     ["-l", "20", "-q", data["q"], index],
                     ["-l", "20", "-p", index],
                     ["-l", "14", "-best", "5", "-sort", "ia", index],
                     ["-l", "20", "-s", "xml", index],
                     ["-complete", "-dnavsprot", "1", "-q", data["q"],
                      pindex]))
    # the JAX CLI cannot load the port's plugin: the port in this process
    want += _vmatch(lambda a, o: tvmatch.run(a, "cpu", out=o),
                    ["-complete", plugin, index])
    want += _vmatch(lambda a, o: jvmatch.run(a, out=o),
                    ["-supermax", "-l", "12", "-numproc", "2", index])
    for ext in EXTS:
        if os.path.exists(f"{index}.{ext}"):
            with open(f"{index}.{ext}", "rb") as a, \
                    open(f"{index}_np2.{ext}", "rb") as b:
                assert a.read().replace(index.encode(), b"") == \
                    b.read().replace(index.encode() + b"_np2", b""), ext
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jchainqhits.run(["12", "2", index, data["qlong"],
                                "nocheckleast"]) == 0
    want += buf.getvalue()
    # the match-file tools on the port's match file, repfind in a
    # directory of its own (its header names the index by its path)
    mfile = index + ".match"
    for tool, argv in ((jvmatchselect, ["-sort", "ia", mfile]),
                       (jchain2dim, ["-global", mfile])):
        buf = io.StringIO()
        assert tool.run(argv, buf) == 0
        want += buf.getvalue()
    jdir = data["dir"] / "blocked_repfind"
    jdir.mkdir(exist_ok=True)
    cwd = os.getcwd()
    os.chdir(jdir)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            assert jrepfind.run(["-f", "-l", "20", data["dna"]]) == 0
    finally:
        os.chdir(cwd)
    want += buf.getvalue().replace(str(jdir), str(data["dir"]))
    assert r.stdout == want
    assert r.stdout.count("# args=") == 14
    # mkcfr and mkrcidx wrote what the JAX tools write from the same index
    jcopy = data["dir"] / "blocked_jax"
    jcopy.mkdir(exist_ok=True)
    for f in os.listdir(data["dir"]):
        if f.startswith("blocked_dna.") and ".rcm." not in f:
            shutil.copy(data["dir"] / f, jcopy / f)
    jindex = str(jcopy / "blocked_dna")
    assert jmkcfr.run([jindex]) == 0
    assert jmkrcidx.run(["-db", data["dna"], "-indexname", jindex]) == 0
    for ext in ("cfr", "rev.crf", "rcm.tis", "rcm.suf", "rcm.lcp",
                "rcm.bwt", "rcm.prj"):
        with open(f"{jindex}.{ext}", "rb") as a, \
                open(f"{index}.{ext}", "rb") as b:
            assert a.read().replace(jindex.encode(), b"") == \
                b.read().replace(index.encode(), b""), ext
    assert r.stdout.count("<?xml") == 1 and r.stdout.count("chain ") > 0


def test_entry_points_demand_cuda(monkeypatch, data):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod, argv in ((tmkvtree, ["-db", data["dna"], "-dna"]),
                      (tvmatch, ["-complete", "-q", data["q"], "x"])):
        monkeypatch.setattr(sys, "argv", ["prog"] + argv)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            mod.main()


def _outcome(run, argv):
    """The stdout of a vmatch call, or the type and message of its
    failure."""
    buf = io.StringIO()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("VSTREE_COMPILE_CACHE", "off")
            assert run(argv, buf) == 0
    except SystemExit as e:
        return "exit", str(e)
    except (ValueError, IndexError, KeyError) as e:
        return type(e).__name__, str(e)
    return "ok", buf.getvalue()


@pytest.mark.parametrize("argv,said", [
    (["-l", "20", "-q", "q.fna", "-dnavsprot", "1", "idx"], None),
    (["-l", "20", "5", "idx"], "ok"),
    (["-l", "20", "-evalue", "0.001", "-q", "q.fna", "idx"], "ok"),
    (["-p", "-l", "12", "-identity", "90", "idx"], "ok"),
    (["-l", "20", "-exdrop", "3", "-sort", "ia", "idx"],
     "vmatch: option -sort requires option -best"),
    (["-e", "1", "-q", "q.fna", "idx"], "vmatch: task not implemented yet"),
    (["-online", "-q", "q.fna", "idx"], "vmatch: task not implemented yet"),
    (["-best", "5", "-l", "20", "idx"], "ok"),
    (["idx"], "vmatch: task not implemented yet"),
    (["-complete", "remred", "-q", "q.fna", "idx"],
     'vmatch: argument "remred" of option -complete requires option '
     "-online"),
    (["-complete", "-s", "xml", "-q", "q.fna", "idx"], "ok"),
    (["-complete", "idx"], "vmatch: task not implemented yet"),
], ids=lambda v: "_".join(v) if isinstance(v, list) else None)
def test_options_once_refused_as_the_jax_cli(data, indexes, argv, said):
    """What the port refused before it had the whole CLI: the same
    stdout as the JAX CLI, or the same message.  ``-dnavsprot`` on a DNA
    index translates into the DNA alphabet; whatever that gives, both
    CLIs give it."""
    argv = [{"q.fna": data["q"], "idx": indexes["dna"][1]}.get(a, a)
            for a in argv]
    want = _outcome(lambda a, o: jvmatch.run(a, out=o), argv)
    got = _outcome(lambda a, o: tvmatch.run(a, "cpu", out=o), argv)
    assert got == want
    if said == "ok":
        assert want[0] == "ok" and len(want[1].splitlines()) > 2
    elif said is not None:
        assert want == ("exit", said)


@pytest.mark.parametrize("argv,what", [
    (["-numproc", "2", "-complete", "-q", "q.fna", "idx"],
     "-numproc 2 exceeds the 1 available devices"),
])
def test_vmatch_refuses_what_is_not_ported(data, indexes, argv, what):
    """Nothing is left unported; what the port still refuses is more
    shards than the devices it is given (here ``device`` alone), with
    the JAX CLI's message (tests/test_torch_numproc_cli.py holds
    ``-numproc`` against the JAX CLI)."""
    argv = [{"q.fna": data["q"], "idx": indexes["dna"][1]}.get(a, a)
            for a in argv]
    with pytest.raises(SystemExit, match=re.escape(f"vmatch: {what}")):
        tvmatch.run(argv, "cpu")


@pytest.mark.parametrize("argv", [["-numproc", "1"], ["-numproc", "0"]],
                         ids=["numproc1", "numproc0"])
def test_vmatch_numproc_of_one_card_as_the_jax_cli(data, indexes, argv):
    argv = argv + ["-complete", "-q", data["q"], indexes["dna"][1]]
    want = _outcome(lambda a, o: jvmatch.run(a, out=o), argv)
    assert want[0] == "ok"
    assert _outcome(lambda a, o: tvmatch.run(a, "cpu", out=o), argv) == want


def test_mkvtree_refuses_numproc(data):
    """More shards than the devices ``run`` is given (here ``device``
    alone): the JAX CLI's message."""
    with pytest.raises(SystemExit, match=re.escape(
            "vmatch: -numproc 2 exceeds the 1 available devices")):
        tmkvtree.run(["-db", data["dna"], "-dna", "-numproc", "2"], "cpu")

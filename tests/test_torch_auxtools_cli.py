"""Port vs JAX package: the tools that read an index — ``vseqinfo``,
``vseqselect``, ``vsubseqselect``, ``vendian``, ``vstree2tex``,
``mksti``, ``mkiso``, ``mklsf``, ``mkvcmp``, ``mkcld`` (host code,
copies) and ``mkcfr`` (its interval lookups on the device it is given,
here the CPU).

The indexes are written by the port's ``mkvtree``: a 20 kbp DNA index of
six records with wildcards, a 400 bp one for ``vstree2tex`` and a
protein index, each built forward and with ``-rev`` under one name.  A tool that
writes files next to its index runs on a copy of its own per package,
and the files must be equal byte for byte; stdout too.  Malformed calls
fail with the same message.
"""

import contextlib
import io
import shutil
from pathlib import Path

import numpy as np
import pytest

from vstree_tpu.cli import mkcfr as jmkcfr
from vstree_tpu.cli import mkcld as jmkcld
from vstree_tpu.cli import mkiso as jmkiso
from vstree_tpu.cli import mklsf as jmklsf
from vstree_tpu.cli import mksti as jmksti
from vstree_tpu.cli import mkvcmp as jmkvcmp
from vstree_tpu.cli import vendian as jvendian
from vstree_tpu.cli import vseqinfo as jvseqinfo
from vstree_tpu.cli import vseqselect as jvseqselect
from vstree_tpu.cli import vstree2tex as jvstree2tex
from vstree_tpu.cli import vsubseqselect as jvsubseqselect
from vstree_tpu_torch.cli import mkcfr as tmkcfr
from vstree_tpu_torch.cli import mkcld as tmkcld
from vstree_tpu_torch.cli import mkiso as tmkiso
from vstree_tpu_torch.cli import mklsf as tmklsf
from vstree_tpu_torch.cli import mksti as tmksti
from vstree_tpu_torch.cli import mkvcmp as tmkvcmp
from vstree_tpu_torch.cli import mkvtree as tmkvtree
from vstree_tpu_torch.cli import vendian as tvendian
from vstree_tpu_torch.cli import vseqinfo as tvseqinfo
from vstree_tpu_torch.cli import vseqselect as tvseqselect
from vstree_tpu_torch.cli import vstree2tex as tvstree2tex
from vstree_tpu_torch.cli import vsubseqselect as tvsubseqselect

HOST = {
    "vseqinfo": (jvseqinfo.run, tvseqinfo.run),
    "vseqselect": (jvseqselect.run, tvseqselect.run),
    "vsubseqselect": (jvsubseqselect.run, tvsubseqselect.run),
    "vstree2tex": (jvstree2tex.run, tvstree2tex.run),
    "mkvcmp": (jmkvcmp.run, tmkvcmp.run),
}
# tool -> (JAX run, port run, files it writes beside the index)
WRITERS = {
    "mksti": (jmksti.run, tmksti.run, ("sti",)),
    "mkiso": (jmkiso.run, tmkiso.run, ("iso",)),
    "mklsf": (jmklsf.run, tmklsf.run, ("lsf",)),
    "mkcld": (jmkcld.run, tmkcld.run, ("cld", "cld1")),
    "mkcfr": (jmkcfr.run, lambda a: tmkcfr.run(a, "cpu"),
              ("cfr", "rev.crf")),
}


def _fasta(path, seqs, prefix="s"):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">{prefix}{i} record {i}\n")
            for j in range(0, len(s), 70):
                fh.write(s[j:j + 70] + "\n")
    return str(path)


def _mkvtree(argv):
    assert tmkvtree.run(argv, "cpu") == 0


@pytest.fixture(scope="module")
def idx(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("taux")
    rng = np.random.default_rng(41)
    seqs = []
    for n in (5000, 3000, 1, 4200, 2800, 5000):
        s = rng.choice(list("acgt"), n)
        for _ in range(n // 900):
            st = int(rng.integers(0, max(n - 20, 1)))
            s[st:st + int(rng.integers(1, 15))] = "n"
        seqs.append("".join(s))
    seqs[5] = seqs[0][1000:3500] + seqs[5][2500:]    # a long repeat
    dna = _fasta(tmp / "dna.fna", seqs)
    for extra in ([], ["-rev"]):
        _mkvtree(["-db", dna, "-dna"] + extra
                 + ["-pl", "-allout", "-indexname", str(tmp / "dna")])
    tiny = _fasta(tmp / "tiny.fna", [seqs[0][:250], seqs[1][:150]])
    prot = _fasta(tmp / "prot.fna", [
        "".join(rng.choice(list("ARNDCQEGHILKMFPSTWYV"),
                           int(rng.integers(30, 300))))
        for _ in range(25)], prefix="p")
    for extra in ([], ["-rev"]):
        _mkvtree(["-db", tiny, "-dna"] + extra + [
            "-pl", "1", "-allout", "-indexname", str(tmp / "tiny")])
        _mkvtree(["-db", prot, "-protein"] + extra + [
            "-pl", "-allout", "-indexname", str(tmp / "prot")])
    nums = tmp / "nums.txt"
    nums.write_text("5\n2\n0\n")
    return tmp


def _run(run, argv, binary=False):
    """(return code or exit message, stdout) of one in-process call."""
    out = io.BytesIO() if binary else io.StringIO()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            rc = run(argv, out)
    except SystemExit as e:
        rc = ("exit", str(e.code))
    text = out.getvalue()
    return rc, text if binary else text + printed.getvalue()


def _subst(idx, argv):
    return [str(idx / a[1:]) if a.startswith("@") else a for a in argv]


@pytest.mark.parametrize("tool,argv", [
    ("vseqinfo", ["@dna"]),
    ("vseqinfo", ["@prot"]),
    ("vseqinfo", ["@tiny"]),
    ("vseqselect", ["-minlength", "2900", "-maxlength", "4500", "@dna"]),
    ("vseqselect", ["-seqnum", "@nums.txt", "@dna"]),
    ("vseqselect", ["-minlength", "100", "-maxlength", "150", "@prot"]),
    ("vseqselect", ["-seqnum", "@nums.txt", "@prot"]),
    ("vsubseqselect", ["-seq", "3", "40", "77", "@dna"]),
    ("vsubseqselect", ["-range", "4990", "5030", "@dna"]),
    ("vsubseqselect", ["-seq", "30", "5", "2490", "@dna"]),
    ("vsubseqselect", ["-seq", "7", "4", "20", "@prot"]),
    ("vstree2tex", ["-tis", "-suf", "-lcp", "-s", "@tiny"]),
    ("vstree2tex", ["-bck", "@tiny"]),
    ("vstree2tex", ["-ois", "-tis", "-suf", "-bckhz", "-s", "@tiny"]),
    ("vstree2tex", ["-suf", "-skp", "@tiny"]),
    ("vstree2tex", ["-suf", "-sti1", "-bwt", "@tiny"]),
    ("mkvcmp", ["@dna", "@dna"]),
    ("mkvcmp", ["@dna", "@tiny"]),
    ("mkvcmp", ["@dna", "@missing"]),
], ids=lambda x: x if isinstance(x, str) else "_".join(x).replace("@", ""))
def test_host_tool_same_stdout(idx, tool, argv):
    argv = _subst(idx, argv)
    want = _run(HOST[tool][0], argv)
    got = _run(HOST[tool][1], argv)
    assert got == want
    assert want[1] or want[0] != 0


def test_vseqselect_random_picks(idx):
    """The random selection is unseeded in both packages: the port picks
    the asked number of whole records."""
    rc, text = _run(tvseqselect.run, ["-randomnum", "3", str(idx / "prot")])
    assert rc == 0 and text.count(">") == 3
    _, every = _run(tvseqselect.run, ["-minlength", "1", str(idx / "prot")])
    for rec in text.split(">")[1:]:
        assert ">" + rec in every


def test_vsubseqselect_random_picks(idx):
    """``-snum`` picks unseeded random substrings in both packages: the
    port prints the asked number, each of a length within the bounds
    (every record of ``tiny`` is longer than the bound) and taken from
    the records."""
    rc, text = _run(tvsubseqselect.run, ["-snum", "4", "-minlength", "5",
                                         "-maxlength", "9",
                                         str(idx / "tiny")])
    recs = text.split(">")[1:]
    assert rc == 0 and len(recs) == 4
    _, every = _run(tvseqselect.run, ["-minlength", "1", str(idx / "tiny")])
    whole = ["".join(r.splitlines()[1:]) for r in every.split(">")[1:]]
    for rec in recs:
        body = "".join(rec.splitlines()[1:])
        assert 5 <= len(body) <= 9
        assert any(body in w for w in whole)


@pytest.mark.parametrize("nbytes", ["2", "4", "8"])
@pytest.mark.parametrize("table", ["suf", "lcp", "tis"])
def test_vendian_same_bytes(idx, nbytes, table):
    argv = [nbytes, str(idx / f"dna.{table}")]
    want = _run(jvendian.run, argv, binary=True)
    got = _run(tvendian.run, argv, binary=True)
    assert got == want and want[0] == 0 and len(want[1]) > 1000


def _copy_index(src: Path, dst: Path, name: str) -> str:
    dst.mkdir(exist_ok=True)
    for f in src.glob(f"{name}.*"):
        shutil.copy(f, dst / f.name)
    return str(dst / name)


@pytest.mark.parametrize("name", ["dna", "tiny", "prot"])
@pytest.mark.parametrize("tool", list(WRITERS))
def test_index_tool_same_files(idx, tool, name):
    jrun, trun, exts = WRITERS[tool]
    results = []
    for pkg, run in (("jax", jrun), ("torch", trun)):
        iname = _copy_index(idx, idx / f"{tool}_{name}_{pkg}", name)
        rc = run([iname])
        written = {e: Path(f"{iname}.{e}").read_bytes() for e in exts}
        results.append((rc, written))
    assert results[1] == results[0]
    assert results[0][0] == 0
    assert all(len(b) > 0 for b in results[0][1].values())


@pytest.mark.parametrize("tool", list(WRITERS))
@pytest.mark.parametrize("argv", [[], ["a", "b"]], ids=["none", "two"])
def test_index_tool_usage_alike(tool, argv):
    jrun, trun, _ = WRITERS[tool]
    msgs = []
    for run in (jrun, trun):
        with pytest.raises(SystemExit) as e:
            run(argv)
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1] and "Usage" in msgs[0]


@pytest.mark.parametrize("tool,argv", [
    ("vseqinfo", []),
    ("vseqselect", ["-zz", "@dna"]),
    ("vsubseqselect", ["-seq", "1", "2", "3", "-snum", "1", "@dna"]),
    ("vstree2tex", ["-tis"]),
    ("vstree2tex", ["-qq", "@tiny"]),
    ("mkvcmp", ["@dna"]),
], ids=lambda x: x if isinstance(x, str) else "_".join(x).replace("@", ""))
def test_host_tool_refusals_alike(idx, tool, argv):
    argv = _subst(idx, argv)
    want = _run(HOST[tool][0], argv)
    got = _run(HOST[tool][1], argv)
    assert got == want and want[0][0] == "exit"


@pytest.mark.parametrize("argv", [["1", "f"], ["x", "f"], ["-2", "f"],
                                  ["4", "/nonexistent/file"]])
def test_vendian_refusals_alike(argv):
    want = _run(jvendian.run, argv, binary=True)
    got = _run(tvendian.run, argv, binary=True)
    assert got == want and want[0][0] == "exit"

"""Port CLI vs JAX CLI: DNA queries on a protein index (``vmatch
-dnavsprot transnum [symbolmap]``).  The queries are translated in their
six frames, matched with ``-complete`` (exact, ``-e``, ``-h``,
``-online``) or ``-l L -q`` (with ``-mum``, ``-e``, ``-online``), and
the rows mapped back onto the DNA.  Stdout must be byte-identical on a
protein index built by either package; where the JAX CLI fails (a DNA
record too short for a codon, ``-p`` on the translated frames), the
port fails with the same message.
"""

import io

import numpy as np
import pytest
import torch

from vstree_tpu.cli import mkvtree as jmkvtree
from vstree_tpu.cli import vmatch as jvmatch
from vstree_tpu_torch.cli import mkvtree as tmkvtree
from vstree_tpu_torch.cli import vmatch as tvmatch

# UniProtKB/Swiss-Prot amino-acid composition, percent
COMPOSITION = {
    "A": 8.25, "R": 5.53, "N": 4.06, "D": 5.45, "C": 1.37, "Q": 3.93,
    "E": 6.75, "G": 7.07, "H": 2.27, "I": 5.96, "L": 9.66, "K": 5.84,
    "M": 2.42, "F": 3.86, "P": 4.70, "S": 6.56, "T": 5.34, "W": 1.08,
    "Y": 2.92, "V": 6.87}
STANDARD = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
CODONS: dict[str, list[str]] = {}
for _k, _aa in enumerate(STANDARD):
    CODONS.setdefault(_aa, []).append(
        "tcag"[_k // 16] + "tcag"[_k // 4 % 4] + "tcag"[_k % 4])


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
            fh.write(f">r{i} synthetic record {i}\n")
            for j in range(0, len(s), width):
                fh.write(s[j:j + width] + "\n")
    return str(path)


def _proteins(rng, total):
    """Records with log-normal lengths and the Swiss-Prot composition,
    a poly-Q run and a duplicated record."""
    aas = list(COMPOSITION)
    p = np.array(list(COMPOSITION.values()))
    recs, n = [], 0
    while n < total:
        ln = int(np.clip(rng.lognormal(np.log(375), 0.6), 40, 3000))
        recs.append("".join(rng.choice(aas, ln, p=p / p.sum())))
        n += ln
    recs[3] = recs[3][:100] + "Q" * 25 + recs[3][125:]
    recs.append(recs[5])
    return recs


def _backtranslate(rng, prot):
    return "".join(CODONS[a][int(rng.integers(len(CODONS[a])))]
                   for a in prot)


def _revcomp(s):
    return s[::-1].translate(str.maketrans("acgtn", "tgcan"))


def _queries(rng, prots, num, lo, hi):
    """DNA queries: back-translated windows of the proteins, every
    other one reverse-complemented, some with a changed codon, an N run
    or a random prefix of 1-2 nt (another frame), some random."""
    qs = []
    for i in range(num):
        src = prots[i % len(prots)]
        ln = int(rng.integers(lo, hi + 1))
        st = int(rng.integers(0, len(src) - ln))
        q = _backtranslate(rng, src[st:st + ln])
        if i % 5 == 1:
            at = 3 * int(rng.integers(1, ln - 1))
            q = q[:at] + "tgg" + q[at + 3:]
        elif i % 5 == 2:
            q = "".join(rng.choice(list("acgt"), int(rng.integers(1, 3)))) + q
        elif i % 5 == 3:
            q = q[:9] + "nnnnnn" + q[15:]
        elif i % 7 == 6:
            q = "".join(rng.choice(list("acgt"), len(q)))
        qs.append(_revcomp(q) if i % 2 else q)
    return qs


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dnavsprot")
    rng = np.random.default_rng(71)
    prots = _proteins(rng, 24_000)
    qs = _queries(rng, prots, 40, 12, 22)
    files = {
        "db": _fasta(tmp / "p.fna", prots),
        "q": _fasta(tmp / "q.fna", qs),
        "qsmall": _fasta(tmp / "qs.fna", qs[:4]),
        "qshort": _fasta(tmp / "qshort.fna", [qs[0], "ac"]),
        # a window of the duplicated record: two rows from one query
        "qone": _fasta(tmp / "q1.fna",
                       [_backtranslate(rng, prots[5][10:30])]),
        "qlong": _fasta(tmp / "ql.fna",
                        _queries(rng, prots, 12, 40, 120)),
    }
    smap = tmp / "dna.smap"
    smap.write_text("aA\ncC\ngG\ntTuU\nnsyrkvbdhwmNSYRKVBDHWM\n")
    files["smap"] = str(smap)
    names = []
    for pkg, run in (("jax", jmkvtree.run),
                     ("torch", lambda a: tmkvtree.run(a, "cpu"))):
        name = str(tmp / f"{pkg}_prot")
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("VSTREE_COMPILE_CACHE", "off")
            assert run(["-db", files["db"], "-protein", "-pl", "-allout",
                        "-indexname", name]) == 0
        names.append(name)
    files["index"] = tuple(names)
    return files


def _outcome(run, argv):
    """The stdout of a run, or the type and message of its failure."""
    buf = io.StringIO()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("VSTREE_COMPILE_CACHE", "off")
            assert run(argv, buf) == 0
    except SystemExit as e:
        return "exit", str(e)
    except (ValueError, IndexError) as e:
        return type(e).__name__, str(e)
    return "ok", buf.getvalue()


def _both(data, argv, which=1):
    argv = [data.get(a, a) for a in argv] + [data["index"][which]]
    want = _outcome(lambda a, o: jvmatch.run(a, out=o), argv)
    got = _outcome(lambda a, o: tvmatch.run(a, "cpu", out=o), argv)
    return want, got


def _rows(text):
    return [line for line in text.splitlines() if not line.startswith("#")]


@pytest.mark.parametrize("argv", [
    ["-complete", "-dnavsprot", "1", "-q", "q"],
    ["-dnavsprot", "1", "-l", "8", "-q", "q"],
], ids=["complete", "l8"])
@pytest.mark.parametrize("which", [0, 1], ids=["jax_index", "torch_index"])
def test_dnavsprot_stdout_byte_identical(data, argv, which):
    want, got = _both(data, argv, which)
    assert got == want
    assert want[0] == "ok" and len(_rows(want[1])) >= 15
    # rows on both strands of the DNA queries: "F" for a forward frame,
    # "G" for a reverse one (echomatch.c:912-942)
    assert {line.split()[3] for line in _rows(want[1])} == {"F", "G"}


@pytest.mark.parametrize("argv", [
    ["-complete", "-dnavsprot", "1", "-e", "1", "-q", "q"],
    ["-complete", "-dnavsprot", "1", "-h", "1", "-q", "q"],
    ["-complete", "-dnavsprot", "1", "-q", "qlong"],
    ["-complete", "-dnavsprot", "1", "-online", "-q", "qsmall"],
    ["-complete", "-dnavsprot", "1", "-online", "-e", "1", "-q", "qsmall"],
    ["-complete", "-dnavsprot", "2", "-absolute", "-q", "q"],
    ["-complete", "-dnavsprot", "1", "smap", "-q", "q"],
    ["-dnavsprot", "1", "-l", "8", "-mum", "-q", "q"],
    ["-dnavsprot", "11", "-l", "8", "-mum", "cand", "-q", "q"],
    ["-dnavsprot", "1", "-l", "20", "-e", "1", "-q", "q"],
    ["-dnavsprot", "4", "-l", "20", "-h", "1", "-q", "qlong"],
    ["-dnavsprot", "1", "-l", "10", "-s", "-q", "q"],
    # one query: the JAX CLI compiles its throwaway index per frame
    ["-dnavsprot", "1", "-online", "-l", "8", "-q", "qone"],
], ids=lambda a: "_".join(a))
def test_dnavsprot_tasks_byte_identical(data, argv):
    want, got = _both(data, argv)
    assert got == want
    assert want[0] == "ok" and len(_rows(want[1])) >= 2


@pytest.mark.parametrize("argv", [
    # -p reverse-complements the translated frames (vmatch.py:1192,
    # :1275 of the JAX CLI): protein codes through "3 - code"
    ["-complete", "-dnavsprot", "1", "-d", "-p", "-q", "q"],
    ["-dnavsprot", "1", "-l", "8", "-d", "-p", "-q", "q"],
    # a DNA record of 2 nt has empty frames: shorter than the prefix
    ["-complete", "-dnavsprot", "1", "-q", "qshort"],
    ["-complete", "-dnavsprot", "1", "-e", "1", "-q", "qshort"],
    ["-dnavsprot", "1", "-supermax", "-l", "8", "-q", "q"],
    ["-dnavsprot", "9", "-l", "8", "-q", "q"],
    ["-dnavsprot", "7", "-l", "8", "-q", "q"],
], ids=lambda a: "_".join(a))
def test_dnavsprot_edges_as_the_jax_cli(data, argv):
    """Both CLIs give the same stdout, or fail with the same message
    (the JAX CLI's ValueError of a threshold is the port's SystemExit,
    as on every ``-complete -e`` path since the port began)."""
    want, got = _both(data, argv)
    if want[0] == "ValueError" and got[0] == "exit":
        assert got[1] == f"vmatch: {want[1]}"
    else:
        assert got == want

"""Port CLI vs JAX CLI: ``vmatch -complete -e k`` / ``-h k`` stdout must
be byte-identical, direct and palindromic, with the show flags and
``-s``, on either package's index.

At this text size (7.4 kbp) queries of up to 11 chars take the rank
path at k = 1 and longer ones the region path; the long-query file
needs the multiword verification (patterns of more than 32 chars).
"""

import io

import numpy as np
import pytest

from vstree_tpu.cli import mkvtree as jmkvtree
from vstree_tpu.cli import vmatch as jvmatch
from vstree_tpu_torch.cli import mkvtree as tmkvtree
from vstree_tpu_torch.cli import vmatch as tvmatch


def _fasta(path, seqs, width=60):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">s{i} synthetic record {i}\n")
            for j in range(0, len(s), width):
                fh.write(s[j:j + width] + "\n")
    return str(path)


def _revcomp(s):
    return s[::-1].translate(str.maketrans("acgtn", "tgcan"))


def _mutated(rng, dna, num, lo, hi):
    """Windows of the records with 0-2 substitutions / indels; every
    fourth reverse-complemented, every seventh random."""
    qs = []
    for i in range(num):
        ln = int(rng.integers(lo, hi + 1))
        if i % 7 == 6:
            qs.append("".join(rng.choice(list("acgt"), ln)))
            continue
        src = dna[i % len(dna)]
        st = int(rng.integers(0, len(src) - ln - 2))
        q = list(src[st:st + ln + 2].replace("n", "a"))
        for _ in range(int(rng.integers(0, 3))):
            op, at = int(rng.integers(0, 3)), int(rng.integers(0, ln))
            if op == 0:
                q[at] = str(rng.choice(list("acgt")))
            elif op == 1:
                del q[at]
            else:
                q.insert(at, str(rng.choice(list("acgt"))))
        q = "".join(q[:ln])
        qs.append(_revcomp(q) if i % 4 == 1 else q)
    return qs


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torchcliapprox")
    rng = np.random.default_rng(43)
    dna = []
    for n in (2500, 1800, 3100):
        s = rng.choice(list("acgt"), n)
        s[rng.choice(n, 5, replace=False)] = "n"
        dna.append("".join(s))
    dna[2] = dna[2][:1000] + dna[0][200:260] + dna[2][1060:]  # a repeat
    out = {"q": _fasta(tmp / "q.fna", _mutated(rng, dna, 70, 8, 32)),
           "qlong": _fasta(tmp / "ql.fna", _mutated(rng, dna, 30, 30, 70)),
           "qn": _fasta(tmp / "qn.fna", ["acgtnacgtacg", dna[1][50:62]])}
    fasta = _fasta(tmp / "x.fna", dna)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VSTREE_COMPILE_CACHE", "off")  # no XLA cache in HOME
        for pkg, run in (("jax", jmkvtree.run),
                         ("torch", lambda a: tmkvtree.run(a, "cpu"))):
            out[pkg] = str(tmp / pkg)
            assert run(["-db", fasta, "-dna", "-pl", "-allout",
                        "-indexname", out[pkg]]) == 0
    return out


def _vmatch(run, argv):
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VSTREE_COMPILE_CACHE", "off")
        assert run(argv, buf) == 0
    return buf.getvalue()


def _both(argv):
    want = _vmatch(lambda a, o: jvmatch.run(a, out=o), argv)
    got = _vmatch(lambda a, o: tvmatch.run(a, "cpu", out=o), argv)
    assert got == want
    return got


@pytest.mark.parametrize("extra", [
    [], ["-p", "-d"], ["-s", "40"], ["-absolute", "-noevalue", "-noscore"],
], ids=lambda e: "_".join(e) or "plain")
@pytest.mark.parametrize("flag,k", [("-e", 1), ("-e", 2), ("-h", 1),
                                    ("-h", 2)])
def test_vmatch_approx_stdout_byte_identical(data, flag, k, extra):
    got = _both(["-complete", flag, str(k)] + extra
                + ["-q", data["q"], data["torch"]])
    rows = [ln.split() for ln in got.splitlines()
            if ln[:1].isdigit() or ln[:1] == " "]
    assert len(rows) > 20
    if not extra:
        dist = [int(r[7]) for r in rows]
        assert any(dist) and all(abs(d) <= k for d in dist) \
            and all((d >= 0) == (flag == "-e") or d == 0 for d in dist)


@pytest.mark.parametrize("argv", [
    ["-e", "1"], ["-h", "2"], ["-p", "-e", "2", "-nodist", "-noidentity"],
    ["-e", "0"], ["-h", "0", "-s", "leftseq"],
], ids=lambda a: "_".join(a))
def test_vmatch_approx_on_the_jax_index(data, argv):
    got = _both(["-complete"] + argv + ["-q", data["q"], data["jax"]])
    assert len(got.splitlines()) > 8


@pytest.mark.parametrize("argv", [["-e", "2"], ["-h", "3", "-p", "-d"],
                                  ["-e", "3", "-s"]],
                         ids=lambda a: "_".join(a))
def test_vmatch_approx_long_queries_byte_identical(data, argv):
    """Patterns of more than 32 chars: the multiword Myers path."""
    got = _both(["-complete"] + argv + ["-q", data["qlong"], data["torch"]])
    assert len(got.splitlines()) > 10


def test_vmatch_approx_wildcard_query(data):
    """A query with a wildcard takes the all-starts candidates."""
    for flag in ("-e", "-h"):
        got = _both(["-complete", flag, "1", "-q", data["qn"],
                     data["torch"]])
        assert len(got.splitlines()) >= 2


@pytest.mark.parametrize("argv,message", [
    (["-complete", "-e", "2b", "-q", "q.fna", "idx"],
     r'vmatch: argument "2b" of option -e must be a non-negative integer'),
    (["-complete", "-h", "-1", "-q", "q.fna", "idx"],
     r'vmatch: argument "-1" of option -h must be'),
    (["-complete", "-q", "q.fna", "-e"],
     r'vmatch: argument "" of option -e must be'),
])
def test_vmatch_malformed_threshold_is_one_line(argv, message):
    with pytest.raises(SystemExit, match=message) as e:
        tvmatch.run(argv, "cpu")
    assert "\n" not in str(e.value)


def test_vmatch_threshold_not_below_pattern_length(data):
    buf = io.StringIO()
    with pytest.raises(SystemExit, match="vmatch: edit threshold must be "
                                         "< pattern length"):
        tvmatch.run(["-complete", "-e", "12", "-q", data["qn"],
                     data["torch"]], "cpu", out=buf)
    assert buf.getvalue().startswith("# args=")

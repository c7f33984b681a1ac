"""The port's six-frame translation against the JAX package's:
``six_frame_translate`` and ``sixframe_convert_match`` give equal arrays
for every translation table, with and without descriptions, on DNA
records with runs of N, IUPAC wildcards (also in every third codon
position), records too short for a codon (empty frames), a single
record, no record, and batches of the benchmark's read shape; an
illegal char in a later record raises the same error in both.
"""

import numpy as np
import pytest

from vstree_tpu.core import alphabet as jalphabet
from vstree_tpu.core import codon as jcodon
from vstree_tpu.core import multiseq as jmultiseq
from vstree_tpu_torch.core import alphabet as talphabet
from vstree_tpu_torch.core import codon as tcodon
from vstree_tpu_torch.core import multiseq as tmultiseq

TRANSNUMS = sorted(tcodon.SCHEMES)
BASES = list("acgtACGT")
WILDCARDS = list("rykmswbdhvnRYKMSWBDHVN")


def _records(seed):
    """DNA records of 1-400 nt: random bases, a run of N, some IUPAC
    wildcards, and records of 1 and 2 nt (the reader refuses an empty
    one)."""
    rng = np.random.default_rng(seed)
    recs = []
    for n in (400, 1, 2, 3, 5, 97, 250):
        s = list(rng.choice(list("acgtACGT"), n))
        if n > 50:
            at = int(rng.integers(0, n - 12))
            s[at:at + 12] = "n" * 12
            for p in rng.choice(n, 4, replace=False):
                s[p] = str(rng.choice(list("rykmswbdhvN")))
        recs.append("".join(s))
    return recs


def _many(rng):
    """400 records of 1-60 nt, each of 1-5 nt among them, some with a
    run of N or a few wildcards."""
    lens = np.concatenate([np.arange(1, 6), rng.integers(1, 61, 395)])
    rng.shuffle(lens)
    recs = []
    for n in lens:
        s = list(rng.choice(BASES, n))
        if n > 10 and rng.random() < 0.3:
            at, k = int(rng.integers(0, n - 6)), int(rng.integers(2, 7))
            s[at:at + k] = "N" * k
        for p in rng.choice(n, min(n, int(rng.integers(0, 3))), replace=False):
            s[p] = str(rng.choice(WILDCARDS))
        recs.append("".join(s))
    return recs


def _wildcard_thirds(rng):
    """Records whose third base of every codon of one frame (forward or
    backward) is a wildcard, records of wildcards alone, runs of N."""
    recs = []
    for n in range(3, 61):
        s = list(rng.choice(BASES, n))
        frame = n % 6
        if frame < 3:     # the third bases of forward frame +frame
            thirds = range(frame + 2, n, 3)
        else:             # of backward frame -(frame - 3)
            thirds = range(n - 1 - (frame - 3) - 2, -1, -3)
        for p in thirds:
            s[p] = str(rng.choice(WILDCARDS))
        recs.append("".join(s))
    recs.append("".join(rng.choice(WILDCARDS, 40)))
    recs.append("acg" + "n" * 30 + "tga")
    return recs


CASES = {
    "many": _many,
    "wildcard-thirds": _wildcard_thirds,
    "single": lambda rng: ["".join(rng.choice(BASES, 59))],
    "all-short": lambda rng: ["".join(rng.choice(BASES, int(n)))
                              for n in rng.integers(1, 3, 50)],
    # the benchmark's reads: 36 or 51 nt, equally often
    "reads": lambda rng: ["".join(rng.choice(BASES, int(n)))
                          for n in rng.choice([36, 51], 2000)],
}


def _fasta(path, recs):
    with open(path, "w") as fh:
        for i, r in enumerate(recs):
            fh.write(f">d{i} record {i}\n{r}\n")
    return str(path)


def _read_both(path):
    return (jmultiseq.read_multiseq([path], jalphabet.dna_alphabet(),
                                    store_original=True),
            tmultiseq.read_multiseq([path], talphabet.dna_alphabet(),
                                    store_original=True))


@pytest.fixture(scope="module")
def dna(tmp_path_factory):
    return _read_both(_fasta(tmp_path_factory.mktemp("codon") / "d.fna",
                             _records(3)))


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("batches")
    return {name: _read_both(_fasta(tmp / f"{name}.fna",
                                    make(np.random.default_rng(i))))
            for i, (name, make) in enumerate(CASES.items())}


def _assert_same_frames(got, want):
    for name in ("sequence", "originalsequence", "markpos"):
        g, w = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype, name
    assert got.numofsequences == want.numofsequences
    assert got.totallength == want.totallength
    assert got.descriptions == want.descriptions


@pytest.mark.parametrize("transnum", TRANSNUMS)
@pytest.mark.parametrize("withdescription", [False, True])
def test_six_frame_translate_same_frames(dna, transnum, withdescription):
    jms, tms = dna
    want = jcodon.six_frame_translate(jms, jalphabet.protein_alphabet(),
                                      transnum, withdescription)
    got = tcodon.six_frame_translate(tms, talphabet.protein_alphabet(),
                                     transnum, withdescription)
    _assert_same_frames(got, want)
    assert got.numofsequences == 6 * 7
    # the records of 1-2 nt give empty frames; stop codons give "*", a
    # protein wildcard
    bounds = [got.seq_bounds(i) for i in range(got.numofsequences)]
    assert sum(b == a for a, b in bounds) >= 6 * 2
    assert b"*" in got.originalsequence.tobytes()
    assert (got.sequence[got.originalsequence == ord("*")] == 254).all()


@pytest.mark.parametrize("transnum", TRANSNUMS)
@pytest.mark.parametrize("case", list(CASES))
def test_six_frame_translate_same_batches(batches, case, transnum):
    """Every batch, every table, the descriptions included."""
    jms, tms = batches[case]
    want = jcodon.six_frame_translate(jms, jalphabet.protein_alphabet(),
                                      transnum, True)
    got = tcodon.six_frame_translate(tms, talphabet.protein_alphabet(),
                                     transnum, True)
    _assert_same_frames(got, want)
    assert got.numofsequences == 6 * tms.numofsequences
    assert got.descriptions[::6] == tms.descriptions
    if case == "all-short":
        assert got.totallength == 6 * tms.numofsequences - 1
    else:
        assert got.totallength > 6 * tms.numofsequences


def _built(cls, recs):
    """A Multiseq of the byte strings ``recs`` as given, unchecked."""
    orig = np.frombuffer(b"\xff".join(recs), np.uint8).copy()
    ms = cls(sequence=orig.copy(),
             markpos=np.flatnonzero(orig == 0xFF).astype(np.uint32))
    ms.originalsequence = orig
    ms.numofsequences = len(recs)
    ms.totallength = int(orig.size)
    ms.descriptions = [b"r%d" % i for i in range(len(recs))]
    return ms


def _outcome(mod, alpha, ms):
    try:
        out = mod.six_frame_translate(ms, alpha.protein_alphabet(), 1, True)
    except ValueError as e:
        return type(e), str(e)
    return (out.sequence.tobytes(), out.originalsequence.tobytes(),
            out.markpos.tolist(), out.numofsequences, out.totallength,
            out.descriptions)


@pytest.mark.parametrize("recs, error", [
    # a later record; the first of two records that meet one is named
    ([b"acgtacgtac", b"acgtxcgt", b"acgez"], "'x'"),
    # position 3 of a 4-nt record, which frames +1 and -0 alone reach,
    # before a later record whose every frame meets an 'e'
    ([b"acgtac", b"acgz", b"eeeeee"], "'z'"),
    # frame +0 meets the 'q' before -2 meets the 'z' alone
    ([b"acg", b"qcgzaa"], "'q'"),
    # a bad third base; a frame names its bad first bases before its
    # bad third bases
    ([b"acztgtaa"], "'z'"),
    ([b"aczxgt"], "'x'"),
    # records of 1-2 nt have no codon: their chars are never read
    ([b"x", b"acgt", b"zq"], None),
    ([], None),
])
def test_illegal_char_same_error(recs, error):
    want = _outcome(jcodon, jalphabet, _built(jmultiseq.Multiseq, recs))
    got = _outcome(tcodon, talphabet, _built(tmultiseq.Multiseq, recs))
    assert got == want
    if error is None:
        assert isinstance(got[0], bytes)
    else:
        assert got == (ValueError, f"illegal char {error} in DNA sequence")


@pytest.mark.parametrize("transnum", TRANSNUMS)
def test_sixframe_convert_match_same_coordinates(dna, transnum):
    """Matches in every frame of every record, at every position that
    leaves room for a length of 1-5 aa, mapped back onto the DNA."""
    jms, tms = dna
    frames = tcodon.six_frame_translate(tms, talphabet.protein_alphabet(),
                                        transnum)
    rng = np.random.default_rng(transnum)
    seqnum, relpos, length = [], [], []
    for s in range(frames.numofsequences):
        a, b = frames.seq_bounds(s)
        for _ in range(min(b - a, 6)):
            ln = int(rng.integers(1, min(b - a, 5) + 1))
            seqnum.append(s)
            relpos.append(int(rng.integers(0, b - a - ln + 1)))
            length.append(ln)
    args = [np.array(v, np.int64) for v in (seqnum, relpos, length)]
    assert args[0].size > 100
    want = jcodon.sixframe_convert_match(jms, *args)
    got = tcodon.sixframe_convert_match(tms, *args)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    # both strands, and every forward start lies inside its DNA record
    assert got[4].any() and not got[4].all()
    dseq, rel, _, dlen, _ = got
    lens = np.array([b - a for a, b in (tms.seq_bounds(int(s))
                                        for s in dseq)])
    assert ((rel >= 0) & (rel + dlen <= lens)).all()


@pytest.mark.parametrize("case", ["reads", "single"])
def test_sixframe_convert_match_first_and_last_record(batches, case):
    """Rows in all six frames of the first and the last record, and in
    random frames between: equal values and dtypes."""
    jms, tms = batches[case]
    frames = tcodon.six_frame_translate(tms, talphabet.protein_alphabet(), 1)
    last = frames.numofsequences - 6
    rng = np.random.default_rng(5)
    seqnum = np.concatenate([np.arange(6), np.arange(last, last + 6),
                             rng.integers(0, frames.numofsequences, 500)])
    lens = np.array([b - a for a, b in map(frames.seq_bounds, seqnum)])
    length = np.minimum(rng.integers(1, 6, seqnum.size), lens)
    relpos = (rng.random(seqnum.size) * (lens - length + 1)).astype(np.int64)
    want = jcodon.sixframe_convert_match(jms, seqnum, relpos, length)
    got = tcodon.sixframe_convert_match(tms, seqnum, relpos, length)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got[0][:6].tolist() == [0] * 6
    assert got[0][6:12].tolist() == [tms.numofsequences - 1] * 6


@pytest.mark.parametrize("transnum", [0, 7, 24])
def test_illegal_table_refused_alike(transnum):
    for mod in (jcodon, tcodon):
        with pytest.raises(ValueError, match="illegal translation table"):
            mod.check_transnum(transnum)

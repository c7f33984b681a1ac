"""The port's six-frame translation against the JAX package's:
``six_frame_translate`` and ``sixframe_convert_match`` give equal arrays
for the translation tables 1, 2, 4, 11 and 23, on DNA records with runs
of N, IUPAC wildcards, and records too short for a codon (empty frames).
"""

import numpy as np
import pytest

from vstree_tpu.core import alphabet as jalphabet
from vstree_tpu.core import codon as jcodon
from vstree_tpu.core import multiseq as jmultiseq
from vstree_tpu_torch.core import alphabet as talphabet
from vstree_tpu_torch.core import codon as tcodon
from vstree_tpu_torch.core import multiseq as tmultiseq

TRANSNUMS = (1, 2, 4, 11, 23)


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


def _fasta(path, recs):
    with open(path, "w") as fh:
        for i, r in enumerate(recs):
            fh.write(f">d{i} record {i}\n{r}\n")
    return str(path)


@pytest.fixture(scope="module")
def dna(tmp_path_factory):
    path = _fasta(tmp_path_factory.mktemp("codon") / "d.fna", _records(3))
    return (jmultiseq.read_multiseq([path], jalphabet.dna_alphabet(),
                                    store_original=True),
            tmultiseq.read_multiseq([path], talphabet.dna_alphabet(),
                                    store_original=True))


@pytest.mark.parametrize("transnum", TRANSNUMS)
@pytest.mark.parametrize("withdescription", [False, True])
def test_six_frame_translate_same_frames(dna, transnum, withdescription):
    jms, tms = dna
    want = jcodon.six_frame_translate(jms, jalphabet.protein_alphabet(),
                                      transnum, withdescription)
    got = tcodon.six_frame_translate(tms, talphabet.protein_alphabet(),
                                     transnum, withdescription)
    np.testing.assert_array_equal(got.sequence, want.sequence)
    np.testing.assert_array_equal(got.originalsequence,
                                  want.originalsequence)
    np.testing.assert_array_equal(got.markpos, want.markpos)
    assert got.numofsequences == want.numofsequences == 6 * 7
    assert got.totallength == want.totallength
    assert got.descriptions == want.descriptions
    # the records of 1-2 nt give empty frames; stop codons give "*", a
    # protein wildcard
    bounds = [got.seq_bounds(i) for i in range(got.numofsequences)]
    assert sum(b == a for a, b in bounds) >= 6 * 2
    assert b"*" in got.originalsequence.tobytes()
    assert (got.sequence[got.originalsequence == ord("*")] == 254).all()


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


@pytest.mark.parametrize("transnum", [0, 7, 24])
def test_illegal_table_refused_alike(transnum):
    for mod in (jcodon, tcodon):
        with pytest.raises(ValueError, match="illegal translation table"):
            mod.check_transnum(transnum)

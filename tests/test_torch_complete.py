"""Port vs JAX package: exact complete-match lookup
(vstree_tpu_torch/engine/complete.py vs vstree_tpu/engine/complete.py)
on all three lookup paths.

Inputs are made with numpy from a seed; rank intervals and match
tables must be equal (tolerance 0).
"""

import numpy as np
import pytest

from conftest import random_dna_text

from vstree_tpu.core.alphabet import dna_alphabet
from vstree_tpu.core.multiseq import Multiseq
from vstree_tpu.engine import complete as jcomplete
from vstree_tpu.index.build import build_esa
from vstree_tpu_torch.engine import complete as tcomplete
from vstree_tpu_torch.index.esa import ESA

FIELDS = ("length1", "position1", "length2", "position2", "distance",
          "flag", "seqnum1", "relpos1", "seqnum2", "relpos2", "evalue",
          "idnumber", "transnum")


@pytest.fixture(scope="module")
def index():
    """A JAX-built ESA over 8 kbp of DNA with a long repeat (so long
    patterns still hit), wildcards and separators, and the port's
    wrapper of it."""
    rng = np.random.default_rng(31)
    text = random_dna_text(rng, 8000, n_wild=12, n_sep=5)
    text[5000:5300] = text[1000:1300]
    text[1150] = 3  # keep the repeat free of specials
    text[5150] = 3
    ms = Multiseq(sequence=text, totallength=text.size)
    ms.markpos = np.flatnonzero(text == 255).astype(np.uint32)
    ms.numofsequences = ms.markpos.size + 1
    jesa = build_esa(ms, dna_alphabet(),
                     demand=("suf", "lcp", "bwt", "bck", "sti"))
    return text, jesa, ESA.from_shared(jesa, "cpu")


def _patterns(text, lo, hi, num=300, seed=5):
    """Substrings of the repeat region and of the text, random strings,
    and a few with a wildcard in the middle."""
    rng = np.random.default_rng(seed)
    pats = []
    for i in range(num):
        ln = int(rng.integers(lo, hi + 1))
        kind = i % 6
        if kind == 0:
            p = rng.integers(0, 4, ln).astype(np.uint8)
        elif kind == 1:
            s = int(rng.integers(1000, 1300 - ln)) if ln < 300 else 1000
            p = text[s:s + ln].copy()
        else:
            s = int(rng.integers(0, text.size - ln))
            p = text[s:s + ln].copy()
        if kind == 5:
            p[ln // 2] = 254
        pats.append(p)
    return pats


def _matrix(pats):
    plens = np.array([p.size for p in pats], np.int32)
    m = np.full((len(pats), plens.max()), -1, np.int32)
    for i, p in enumerate(pats):
        m[i, :p.size] = p
    return m, plens


@pytest.mark.parametrize("lo,hi,path", [
    (10, 36, "rank count (K1)"),
    (40, 60, "packed-key binary search"),
    (80, 140, "interval search"),
], ids=["rankcount", "exact_lookup", "interval_search"])
def test_exact_interval_lookup_equals_jax(index, lo, hi, path):
    text, jesa, tesa = index
    pats = _patterns(text, lo, hi)
    m, plens = _matrix(pats)
    plan = tcomplete.RankLookupPlan(tesa, int(plens.min()), m.shape[1])
    assert plan.ok == (path == "rank count (K1)")
    if not plan.ok:
        levels = -(-(m.shape[1] - 12) // 10)  # DNA: ppl 12, 10 chars/key
        assert (levels <= tcomplete.MAX_KEY_LEVELS) == (
            path == "packed-key binary search")
    got = tcomplete.exact_interval_lookup(tesa, m, plens)
    want = jcomplete.exact_interval_lookup(jesa, m, plens)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[1] > got[0]).sum() > 100


@pytest.mark.parametrize("lo,hi", [(10, 36), (40, 60), (80, 140)],
                         ids=["rankcount", "exact_lookup",
                              "interval_search"])
def test_exact_complete_matches_equal_jax(index, lo, hi):
    text, jesa, tesa = index
    pats = _patterns(text, lo, hi, num=120, seed=6)
    starts = np.arange(len(pats), dtype=np.int64) * 1000
    got = tcomplete.exact_complete_matches(tesa, pats, flags_extra=4,
                                           query_starts=starts)
    want = jcomplete.exact_complete_matches(jesa, pats, flags_extra=4,
                                            query_starts=starts)
    assert len(got) == len(want) > 0
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def test_wildcard_patterns_never_match(index):
    text, jesa, tesa = index
    s = int(np.flatnonzero(text == 254)[0])
    pats = [text[s - 10:s + 10].copy(), text[s - 20:s + 30].copy()]
    assert len(tcomplete.exact_complete_matches(tesa, pats)) == 0
    assert len(jcomplete.exact_complete_matches(jesa, pats)) == 0


def test_short_patterns_are_an_error(index):
    text, jesa, tesa = index
    pats = [text[:3].copy(), text[10:30].copy()]
    msg = f"must be >= {jesa.prefixlength}=prefixlen"
    for mod, esa in ((tcomplete, tesa), (jcomplete, jesa)):
        with pytest.raises(ValueError, match=msg):
            mod.exact_complete_matches(esa, pats)
    assert len(tcomplete.exact_complete_matches(tesa, [])) == 0

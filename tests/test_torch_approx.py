"""Port vs JAX package: approximate complete matching
(vstree_tpu_torch/engine/approx.py vs vstree_tpu/engine/approx.py),
``-complete -e k`` and ``-complete -h k``.

The same NumPy patterns and the same index tables go through both
packages; candidate sets, start positions and every ``MatchTable``
column must be equal, in order (tolerance 0).  At this text size
(8 kbp) ``_getoptsplit`` sends DNA patterns of <= 11 chars at k = 1 to
the rank path and longer ones to the region path; k = 2 takes the
region path with approximate pieces (threshold 1).
"""

import numpy as np
import pytest
import torch

from conftest import random_dna_text

from vstree_tpu.core.alphabet import dna_alphabet
from vstree_tpu.core.multiseq import Multiseq
from vstree_tpu.engine import approx as japprox
from vstree_tpu.index.build import build_esa
from vstree_tpu_torch.engine import approx as tapprox
from vstree_tpu_torch.index.esa import ESA

FIELDS = ("length1", "position1", "length2", "position2", "distance",
          "flag", "seqnum1", "relpos1", "seqnum2", "relpos2", "evalue",
          "idnumber", "transnum")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's loops issue thousands of small ops; a thread pool per
    test worker only makes the workers of one host wait for each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def index():
    """A JAX-built ESA over 8 kbp of DNA with a repeat, wildcards and
    separators, and the port's ESA made from it."""
    rng = np.random.default_rng(77)
    text = random_dna_text(rng, 8000, n_wild=10, n_sep=5)
    text[5000:5200] = text[1000:1200]
    text[5100] = (text[5100] + 1) % 4 if text[5100] < 4 else 1
    ms = Multiseq(sequence=text, totallength=text.size)
    ms.markpos = np.flatnonzero(text == 255).astype(np.uint32)
    ms.numofsequences = ms.markpos.size + 1
    jesa = build_esa(ms, dna_alphabet(),
                     demand=("suf", "lcp", "bwt", "bck", "sti"))
    return text, jesa, ESA.from_shared(jesa, "cpu")


def _patterns(text, lo, hi, num, seed, wild=False):
    """Substrings of the text with 0-2 substitutions / indels, a few
    exact, a few random; with ``wild`` some carry a wildcard."""
    rng = np.random.default_rng(seed)
    pats = []
    while len(pats) < num:
        i = len(pats)
        ln = int(rng.integers(lo, hi + 1))
        if i % 7 == 0:
            pats.append(rng.integers(0, 4, ln).astype(np.uint8))
            continue
        if i % 7 == 1 and ln < 190:
            s = int(rng.integers(1000, 1200 - ln))
        else:
            s = int(rng.integers(0, text.size - ln - 2))
        p = list(text[s:s + ln + 2])
        for _ in range(int(rng.integers(0, 3)) if i % 7 != 2 else 0):
            op, at = int(rng.integers(0, 3)), int(rng.integers(0, ln))
            if op == 0:
                p[at] = int(rng.integers(0, 4))
            elif op == 1:
                del p[at]
            else:
                p.insert(at, int(rng.integers(0, 4)))
        p = np.array(p[:ln], np.uint8)
        if (p == 255).any():
            continue
        if wild and i % 7 == 3:
            p[ln // 2] = 254
        elif not wild and (p >= 250).any():
            continue
        pats.append(p)
    return pats


def _assert_tables_equal(got, want):
    assert len(got) == len(want)
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("k,shifted", [(1, True), (1, False), (2, True),
                                       (3, False)])
def test_all_piece_candidates(index, k, shifted):
    text, jesa, tesa = index
    pats = _patterns(text, 9, 30, 60, 1, wild=True)
    got = tapprox._all_piece_candidates(tesa, pats, k, shifted)
    want = japprox._all_piece_candidates(jesa, pats, k, shifted)
    assert want[0].size > 8000   # the all-starts patterns and piece hits
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_esaapm_starts(index, k):
    text, jesa, tesa = index
    pats = _patterns(text, 9, 32, 70, 2 + k, wild=True)
    got = tapprox._esaapm_starts(tesa, pats, k)
    want = japprox._esaapm_starts(jesa, pats, k)
    assert want[0].size >= 15
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_hamming_starts(index, k):
    text, jesa, tesa = index
    pats = _patterns(text, 9, 40, 70, 5 + k, wild=True)
    got = tapprox._hamming_starts(tesa, pats, k)
    want = japprox._hamming_starts(jesa, pats, k)
    assert want[0].size >= 15
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_getoptsplit_equals_jax():
    for n in (8000, 10**6, 16 * 10**6):
        for plen in range(1, 80):
            for k in range(0, 5):
                for doedist in (True, False):
                    assert (tapprox._getoptsplit(4, n, plen, k, doedist)
                            == japprox._getoptsplit(4, n, plen, k, doedist))
    # the routes of 20-32-mers at k = 1 on a genome-sized text
    assert [tapprox._getoptsplit(4, 16 * 10**6, p, 1) for p in (22, 23)] \
        == [1, 2]
    assert [tapprox._getoptsplit(4, 16 * 10**6, p, 1, False)
            for p in (23, 24)] == [1, 2]


@pytest.mark.parametrize("lo,hi,wild", [
    (8, 11, False),     # rank path only (at k = 1)
    (12, 32, False),    # region path only
    (8, 32, False),     # both routes in one batch
    (8, 32, True),      # with wildcard patterns (all-starts candidates)
    (28, 70, False),    # w > 1: the multiword measurement
], ids=["rank", "region", "both", "wildcard", "multiword"])
@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("edit", [True, False], ids=["edit", "hamming"])
def test_approx_complete_matches(index, edit, k, lo, hi, wild):
    text, jesa, tesa = index
    pats = _patterns(text, lo, hi, 60, 11 * k + lo, wild=wild)
    starts = np.cumsum([0] + [p.size + 1 for p in pats[:-1]]).astype(np.int64)
    kw = dict(flags_extra=0, query_starts=starts)
    got = tapprox.approx_complete_matches(tesa, pats, k, edit, **kw)
    want = japprox.approx_complete_matches(jesa, pats, k, edit, **kw)
    assert len(want) >= 15
    _assert_tables_equal(got, want)
    if k:
        assert (want.distance != 0).any()


def test_approx_routes_are_both_taken(index, monkeypatch):
    """The "both" batch of test_approx_complete_matches does run the
    rank path and the region path."""
    text, _, tesa = index
    seen = []
    real_region, real_apm = tapprox._region_detect, tapprox._esaapm_starts
    monkeypatch.setattr(
        tapprox, "_region_detect",
        lambda *a, **kw: seen.append("region") or real_region(*a, **kw))
    monkeypatch.setattr(
        tapprox, "_esaapm_starts",
        lambda *a, **kw: seen.append("rank") or real_apm(*a, **kw))
    tapprox.approx_complete_matches(
        tesa, _patterns(text, 8, 32, 60, 19), 1, True)
    assert seen[0] == "rank" and "region" in seen


def test_approx_edge_cases(index):
    text, jesa, tesa = index
    assert len(tapprox.approx_complete_matches(tesa, [], 1, True)) == 0
    rnd = [np.random.default_rng(3).integers(0, 4, 30).astype(np.uint8)]
    assert len(tapprox.approx_complete_matches(tesa, rnd, 1, True)) == 0
    with pytest.raises(ValueError, match="edit threshold must be < pattern"):
        tapprox.approx_complete_matches(
            tesa, [np.array([0, 1], np.uint8)], 2, True)
    # palindromic flag and query numbers pass through
    from vstree_tpu_torch.engine.match import FLAGPALINDROMIC

    pats = _patterns(text, 10, 20, 12, 23)
    nums = np.arange(100, 112, dtype=np.int64)
    got = tapprox.approx_complete_matches(
        tesa, pats, 1, True, query_seqnums=nums,
        flags_extra=FLAGPALINDROMIC)
    want = japprox.approx_complete_matches(
        jesa, pats, 1, True, query_seqnums=nums,
        flags_extra=FLAGPALINDROMIC)
    _assert_tables_equal(got, want)
    assert (got.flag & FLAGPALINDROMIC).all() and got.seqnum2.min() >= 100


def test_merge_regions_equals_the_loop():
    """The array form of the region merge against the JAX module's
    per-query loop (overlapping, adjacent and nested regions)."""
    rng = np.random.default_rng(4)
    n = 500
    qi = rng.integers(0, 6, 300).astype(np.int64)
    u0 = rng.integers(0, n - 1, 300).astype(np.int64)
    u1 = np.minimum(n - 1, u0 + rng.integers(0, 12, 300))
    want = []
    for q in np.unique(qi):
        rs = sorted(zip(u0[qi == q].tolist(), u1[qi == q].tolist()))
        out = [list(rs[0])]
        for a, b in rs[1:]:
            if a <= out[-1][1] + 1:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        want += [(int(q), a, b) for a, b in out]
    got = tapprox._merge_regions(qi, u0, u1, n)
    assert list(zip(*(g.tolist() for g in got))) == want

"""Port vs JAX package: online complete matching
(vstree_tpu_torch/engine/online.py vs vstree_tpu/engine/online.py),
``-complete -online [-e k | -h k]``.

The same NumPy texts and patterns go through both packages; mismatch
counts, the ``<= k`` decisions of the Myers scan, the emissions of the
global cutoff scan and every ``MatchTable`` column must be equal
(tolerance 0).  The port cuts the reversed text into segments that
advance in lockstep; the tests force short segments, short warm-ups
(so that the state check must send rows through their segment again)
and small pattern chunks, so that borders fall inside matches.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import random_dna_text

from vstree_tpu.core.alphabet import dna_alphabet
from vstree_tpu.core.multiseq import Multiseq
from vstree_tpu.engine import online as jonline
from vstree_tpu.index.build import build_esa
from vstree_tpu_torch.engine import online as tonline
from vstree_tpu_torch.engine.approx import _eqs_matrix
from vstree_tpu_torch.index.esa import ESA

FIELDS = ("length1", "position1", "length2", "position2", "distance",
          "flag", "seqnum1", "relpos1", "seqnum2", "relpos2", "evalue",
          "idnumber", "transnum")
N = 2400


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's loops issue thousands of small ops; a thread pool per
    test worker only makes the workers of one host wait for each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _text(kind: str, seed: int = 5) -> np.ndarray:
    """2.4 kbp with wildcards, separators and a repeat: random DNA, or
    (adversarial for the cutoff scan) a period-7 text and a homopolymer,
    each with scattered substitutions."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        text = random_dna_text(rng, N, n_wild=0, n_sep=0)
    else:
        unit = rng.integers(0, 4, 7) if kind == "period" else np.zeros(1)
        text = np.tile(unit, N)[:N].astype(np.uint8)
        at = rng.choice(N, N // 35, replace=False)
        text[at] = rng.integers(0, 4, at.size)
    text[1500:1700] = text[300:500]
    text[[1555, 1640]] = (text[[1555, 1640]] + 1) % 4
    text[rng.choice(N, 6, replace=False)] = 254
    text[[700, 1900]] = 255
    return text


def _patterns(text, lo, hi, num, seed, wild=False):
    """Windows of the text, every third as it is and the others with 0-3
    substitutions / indels, every fifth random; with ``wild`` every
    fourth carries a wildcard."""
    rng = np.random.default_rng(seed)
    pats = []
    while len(pats) < num:
        i = len(pats)
        ln = int(rng.integers(lo, hi + 1))
        if i % 5 == 4:
            pats.append(rng.integers(0, 4, ln).astype(np.uint8))
            continue
        s = int(rng.integers(0, text.size - ln - 3))
        p = list(text[s:s + ln + 3])
        for _ in range(0 if i % 3 == 0 else int(rng.integers(0, 4))):
            op, at = int(rng.integers(0, 3)), int(rng.integers(0, ln))
            if op == 0:
                p[at] = int(rng.integers(0, 4))
            elif op == 1:
                del p[at]
            else:
                p.insert(at, int(rng.integers(0, 4)))
        p = np.array(p[:ln], np.uint8)
        if (p >= 250).any():
            continue
        if wild and i % 4 == 1:
            p[ln // 3] = 254
        pats.append(p)
    return pats


def _plens(pats):
    return np.array([p.size for p in pats], np.int32)


def _force_segments(monkeypatch, seg, rows, width):
    """Module constants under which ``rows`` patterns of state ``width``
    scan N columns in segments of ``seg`` columns (None: the defaults)."""
    if seg is not None:
        monkeypatch.setattr(tonline, "_SEG_WARMUPS", 0)
        monkeypatch.setattr(tonline, "_SCAN_ELEMS",
                            -(-N * rows * width // seg))
        assert abs(tonline._segment_length(N, rows, width, 1) - seg) <= 1


@pytest.mark.parametrize("special_mm", [True, False],
                         ids=["exact_rule", "byte_equality"])
def test_window_mismatches(special_mm):
    text = _text("random")
    pats = _patterns(text, 4, 40, 24, 1, wild=True)
    plens = _plens(pats)
    patmat = np.full((len(pats), plens.max()), -2, np.int32)
    for i, p in enumerate(pats):
        patmat[i, :p.size] = p
    want = jonline._window_mismatches(
        jnp.asarray(text), jnp.asarray(patmat), jnp.asarray(plens),
        int(plens.max()), N, special_mm)
    got = tonline._window_mismatches(
        torch.from_numpy(text), torch.from_numpy(patmat),
        torch.from_numpy(plens), int(plens.max()), N, special_mm)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.asarray(want[1]).any() and (np.asarray(want[0]) == 0).any()


@pytest.mark.parametrize("w,lo,hi", [(1, 6, 32), (2, 33, 64)],
                         ids=["one_word", "two_words"])
def test_semiglobal_myers_decisions(monkeypatch, w, lo, hi):
    """score <= k of the JAX scan over all n columns == the port's
    decisions from segments of 61 and 300 columns and of the default
    length, k = 0..2 (segment borders fall inside the repeat's
    matches)."""
    text = _text("random")
    pats = _patterns(text, lo, hi, 14, 2 + w, wild=True)
    plens = _plens(pats)
    eqs = _eqs_matrix([p[::-1] for p in pats], 32 * w)
    trev = text[::-1].copy()
    scores = np.asarray(jonline._semiglobal_myers(
        jnp.asarray(trev), jnp.asarray(eqs), jnp.asarray(plens),
        jnp.asarray((plens - 1) // 32),
        jnp.asarray(((plens - 1) % 32).astype(np.uint32)), w, N))
    for k in (0, 1, 2):
        want = (scores <= k).T
        assert want.sum() >= 3
        for seg in (61, 300, None):
            with monkeypatch.context() as patch:
                _force_segments(patch, seg, len(pats), 3 * w)
                got = tonline._semiglobal_myers(
                    torch.from_numpy(trev),
                    torch.from_numpy(eqs.view(np.int32)),
                    torch.from_numpy(plens), w, N, k)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"k={k} seg={seg}")


@pytest.mark.parametrize("kind", ["random", "period", "homopolymer"])
def test_cutoff_scan_global_emissions(monkeypatch, kind):
    """Emissions of the JAX global scan == the port's segmented scan,
    k = 0..3: at the default warm-up, and at a warm-up of 10 columns,
    which is too short, so that the state check must repair rows."""
    text = _text(kind)
    pats = _patterns(text, 65, 110, 6, 9)
    plens = _plens(pats)
    M = int(plens.max())
    patrev = np.full((len(pats), M + 2), -7, np.int32)
    for i, p in enumerate(pats):
        patrev[i, 1:p.size + 1] = p[::-1]
    trev = text[::-1].copy()
    steps = []
    step = tonline._cutoff_step
    monkeypatch.setattr(tonline, "_cutoff_step",
                        lambda *a: steps.append(0) or step(*a))
    repaired = 0
    for k in range(4):
        want = np.asarray(jonline._ukkonen_cutoff_scan(
            jnp.asarray(trev), jnp.asarray(patrev), jnp.asarray(plens),
            M, k)).T
        for seg, warm in ((None, None), (250, None), (97, 10)):
            with monkeypatch.context() as patch:
                _force_segments(patch, seg, len(pats), M + 2)
                if warm:
                    patch.setattr(tonline, "_cutoff_warmup",
                                  lambda M, k: warm)
                one_pass = tonline._cutoff_warmup(M, k) + \
                    tonline._segment_length(N, len(pats), M + 2,
                                            tonline._cutoff_warmup(M, k))
                del steps[:]
                got = tonline._ukkonen_cutoff_scan_global(
                    torch.from_numpy(trev), torch.from_numpy(patrev),
                    torch.from_numpy(plens), M, k, N)
            np.testing.assert_array_equal(
                got.numpy(), want, err_msg=f"k={k} seg={seg} warm={warm}")
            # columns stepped beyond one pass: rows the state check sent
            # through their segment again
            assert len(steps) >= one_pass
            if warm:
                repaired += len(steps) - one_pass
        assert want.sum() >= 1
    assert repaired > 0


@pytest.fixture(scope="module")
def index():
    text = _text("random", seed=8)
    ms = Multiseq(sequence=text, totallength=text.size)
    ms.markpos = np.flatnonzero(text == 255).astype(np.uint32)
    ms.numofsequences = ms.markpos.size + 1
    jesa = build_esa(ms, dna_alphabet(), demand=("suf", "lcp", "bwt"))
    return text, jesa, ESA.from_shared(jesa, "cpu")


def _assert_tables_equal(got, want):
    assert len(got) == len(want)
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("small", [False, True],
                         ids=["default_chunks", "small_chunks"])
@pytest.mark.parametrize("lo,hi", [(8, 32), (33, 64), (65, 100), (8, 100)],
                         ids=["le32", "33to64", "gt64", "mixed"])
@pytest.mark.parametrize("kind,k", [("exact", 0), ("hamming", 1),
                                    ("hamming", 2), ("edit", 0),
                                    ("edit", 1), ("edit", 2)])
def test_online_complete_matches(index, monkeypatch, kind, k, lo, hi, small):
    text, jesa, tesa = index
    if small:
        # 3 patterns a chunk; segments of 2 warm-ups
        monkeypatch.setattr(tonline, "_WINDOW_ELEMS", 3 * N)
        monkeypatch.setattr(tonline, "_SEG_WARMUPS", 2)
        monkeypatch.setattr(tonline, "_SCAN_ELEMS", 1 << 12)
    pats = _patterns(text, lo, hi, 10, 31 * k + lo, wild=True)
    starts = np.cumsum([0] + [p.size + 1 for p in pats[:-1]]).astype(np.int64)
    kw = dict(flags_extra=0, query_starts=starts)
    got = tonline.online_complete_matches(tesa, pats, k, kind, **kw)
    want = jonline.online_complete_matches(jesa, pats, k, kind, **kw)
    assert len(want) >= 2
    _assert_tables_equal(got, want)


def test_online_edge_cases(index):
    text, jesa, tesa = index
    assert len(tonline.online_complete_matches(tesa, [], 1, "edit")) == 0
    rnd = [np.random.default_rng(3).integers(0, 4, 40).astype(np.uint8)]
    for kind in ("exact", "hamming", "edit"):
        got = tonline.online_complete_matches(tesa, rnd, 1, kind)
        want = jonline.online_complete_matches(jesa, rnd, 1, kind)
        assert len(got) == len(want) == 0
    # a pattern that ends at the text end, and one across a separator
    from vstree_tpu_torch.engine.match import FLAGPALINDROMIC

    pats = [text[-20:].copy(), text[690:712].copy(), text[300:330].copy()]
    for kind in ("exact", "hamming", "edit"):
        got = tonline.online_complete_matches(
            tesa, pats, 1, kind, flags_extra=FLAGPALINDROMIC)
        want = jonline.online_complete_matches(
            jesa, pats, 1, kind, flags_extra=FLAGPALINDROMIC)
        _assert_tables_equal(got, want)
        assert (got.flag & FLAGPALINDROMIC).all()

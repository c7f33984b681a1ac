"""Kernel K2's plain version and the port's Myers / Hamming / Ukkonen
building blocks vs the JAX package.

``vstree_tpu_torch.native.myers`` (``verify_edit`` on CPU tensors runs
``verify_edit_ref``) is held against the Pallas kernel in interpret mode
(``verify_edit_pallas(..., interpret=True)``) and against
``_verify_edit_jnp``; the multiword path, the Hamming verifier and the
per-region Ukkonen scan against their JAX counterparts.  Inputs are
made with numpy from a seed; every comparison is exact (integers).
"""

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dna_text

from vstree_tpu.engine import approx as japprox
from vstree_tpu.engine.online import _ukkonen_cutoff_scan as j_ukkonen
from vstree_tpu.native.myers import verify_edit_pallas
from vstree_tpu_torch.engine import approx as tapprox
from vstree_tpu_torch.engine import online as tonline
from vstree_tpu_torch.native import myers as tmyers

NAMES = ("minsc", "bestlen", "bestsc")


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a.astype(dtype)))


def _torch_verify(text, cand, qidx, eqs, plens, L, n, fn=None, w=1):
    """The port's single-word wrapper (or ``fn`` for w words) on CPU
    tensors, as numpy."""
    e = torch.from_numpy(eqs.view(np.int32))
    args = (_t(text, np.uint8), _t(cand, np.int32), _t(qidx, np.int32))
    if fn is None:
        out = tmyers.verify_edit(*args, e[:, 0, :].contiguous(),
                                 _t(plens, np.int32), L, n)
    else:
        out = fn(*args, e, _t(plens, np.int32), w, L, n)
    return [o.numpy() for o in out]


def _jnp_verify(text, cand, qidx, eqs, plens, w, L, n):
    return [np.asarray(x) for x in japprox._verify_edit_jnp(
        jnp.asarray(text), jnp.asarray(cand), jnp.asarray(qidx),
        jnp.asarray(eqs), jnp.asarray(plens), w, L, n)]


def _pallas_verify(text, cand, qidx, eqs, plens, L, n):
    return [np.asarray(x) for x in verify_edit_pallas(
        jnp.asarray(text), jnp.asarray(cand), jnp.asarray(qidx),
        jnp.asarray(eqs[:, 0, :]), jnp.asarray(plens), L, n,
        interpret=True)]


@pytest.mark.parametrize("trial", range(3))
def test_plain_version_equals_pallas_interpret_and_jnp(trial):
    """The inputs of the JAX package's own kernel test
    (test_pallas_myers_verify_matches_jnp)."""
    rng = np.random.default_rng(100 + trial)
    n = 4000
    text = random_dna_text(rng, n, n_wild=5, n_sep=4)
    pats = [rng.integers(0, 4, int(rng.integers(6, 32))).astype(np.uint8)
            for _ in range(7)]
    plens = np.array([p.size for p in pats], np.int32)
    L = int(plens.max()) + 3
    eqs = japprox._eqs_matrix(pats, int(plens.max()))
    P = 900
    cand = rng.integers(0, n - 1, P).astype(np.int32)
    qidx = rng.integers(0, len(pats), P).astype(np.int32)
    got = _torch_verify(text, cand, qidx, eqs, plens, L, n)
    for want in (_pallas_verify(text, cand, qidx, eqs, plens, L, n),
                 _jnp_verify(text, cand, qidx, eqs, plens, 1, L, n)):
        for g, w_, name in zip(got, want, NAMES):
            np.testing.assert_array_equal(g, w_, err_msg=name)
    assert got[0].dtype == np.int32


def edge_case():
    """chip_smoke's edge set (what the card run holds K2 to): candidates
    in the last L positions, windows that cross a SEPARATOR and a
    WILDCARD, patterns of 1 and 32 chars."""
    text, pats, cand, qidx, L, n = chip_smoke.k2_edge_set()
    plens = np.array([p.size for p in pats], np.int32)
    return text, pats, plens, cand, qidx, L, n


@pytest.mark.parametrize("P", [None, 1, 129])
def test_plain_version_edge_set(P):
    """The edge set, whole and cut to P = 1 and to a P that is no
    multiple of the kernel's block."""
    text, pats, plens, cand, qidx, L, n = edge_case()
    cand, qidx = cand[:P], qidx[:P]
    eqs = japprox._eqs_matrix(pats, 32)
    got = _torch_verify(text, cand, qidx, eqs, plens, L, n)
    for want in (_pallas_verify(text, cand, qidx, eqs, plens, L, n),
                 _jnp_verify(text, cand, qidx, eqs, plens, 1, L, n)):
        for g, w_, name in zip(got, want, NAMES):
            np.testing.assert_array_equal(g, w_, err_msg=name)
    if P is None:
        # the set does hold exact hits and windows cut by a separator
        assert (got[2] == 0).any() and (got[1] == 0).any()


def test_plain_version_chunks_agree(monkeypatch):
    text, pats, plens, cand, qidx, L, n = edge_case()
    eqs = japprox._eqs_matrix(pats, 32)
    whole = _torch_verify(text, cand, qidx, eqs, plens, L, n)
    monkeypatch.setattr(tmyers, "_REF_ELEMS", 40 * L)
    parts = _torch_verify(text, cand, qidx, eqs, plens, L, n)
    for a, b in zip(whole, parts):
        np.testing.assert_array_equal(a, b)


def test_verify_edit_checks_its_arguments():
    text, pats, plens, cand, qidx, L, n = edge_case()
    e = torch.from_numpy(
        japprox._eqs_matrix(pats, 32).view(np.int32))[:, 0, :].contiguous()
    args = [_t(text, np.uint8), _t(cand, np.int32), _t(qidx, np.int32), e,
            _t(plens, np.int32)]
    for i, bad in ((1, args[1].to(torch.int64)), (2, args[2] + 5),
                   (1, args[1] - 10), (4, args[4] + 1), (3, e[:, :100])):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(ValueError, match="verify_edit"):
            tmyers.verify_edit(*wrong, L, n)
    out = tmyers.verify_edit(args[0], args[1][:0], args[2][:0], e, args[4],
                             L, n)
    assert all(o.numel() == 0 and o.dtype == torch.int32 for o in out)
    assert tmyers.verify_edit.launches == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("w", [2, 3])
def test_multiword_equals_jnp(w):
    rng = np.random.default_rng(20 + w)
    n = 3000
    text = random_dna_text(rng, n, n_wild=6, n_sep=5)
    lo, hi = 32 * (w - 1) - 8, 32 * w
    pats = []
    for i in range(9):
        ln = int(rng.integers(max(lo, 4), hi + 1))
        if i % 3 == 0:
            pats.append(rng.integers(0, 4, ln).astype(np.uint8))
        else:
            s = int(rng.integers(0, n - ln))
            p = text[s:s + ln].copy()
            for _ in range(int(rng.integers(0, 4))):
                p[int(rng.integers(0, ln))] = rng.integers(0, 4)
            pats.append(p)
    pats[-1] = np.concatenate(            # exactly 32*w chars
        [pats[-1], rng.integers(0, 4, hi).astype(np.uint8)])[:hi]
    plens = np.array([p.size for p in pats], np.int32)
    L = int(plens.max()) + 2
    eqs = japprox._eqs_matrix(pats, int(plens.max()))
    assert eqs.shape[1] == w
    P = 700
    cand = rng.integers(0, n, P).astype(np.int32)
    qidx = rng.integers(0, len(pats), P).astype(np.int32)
    got = _torch_verify(text, cand, qidx, eqs, plens, L, n,
                        fn=tapprox._verify_edit_multiword, w=w)
    want = _jnp_verify(text, cand, qidx, eqs, plens, w, L, n)
    for g, w_, name in zip(got, want, NAMES):
        np.testing.assert_array_equal(g, w_, err_msg=name)
    assert (got[0] < plens[qidx]).any()


def test_verify_edit_dispatches_on_word_count(monkeypatch):
    """w == 1 goes to native.myers.verify_edit and nowhere else; w > 1
    to the multiword path."""
    calls = []
    monkeypatch.setattr(tapprox, "verify_edit",
                        lambda *a: calls.append("k2") or "k2")
    monkeypatch.setattr(tapprox, "_verify_edit_multiword",
                        lambda *a: calls.append("mw") or "mw")
    eqs = torch.zeros((2, 2, 256), dtype=torch.int32)
    z = torch.zeros(0, dtype=torch.int32)
    assert tapprox._verify_edit(z, z, z, eqs[:, :1], z, 1, 5, 10) == "k2"
    assert tapprox._verify_edit(z, z, z, eqs, z, 2, 5, 10) == "mw"
    assert calls == ["k2", "mw"]


def test_eqs_matrix_equals_jax():
    rng = np.random.default_rng(5)
    pats = [rng.integers(0, 4, int(ln)).astype(np.uint8)
            for ln in (1, 7, 32, 33, 64, 70)]
    pats[1][3] = 254
    pats[4][40] = 254
    pats[5][0] = 255
    for maxlen in (70, 96):
        np.testing.assert_array_equal(tapprox._eqs_matrix(pats, maxlen),
                                      japprox._eqs_matrix(pats, maxlen))
    assert tapprox._eqs_matrix([], 5).shape == (0, 1, 256)


def test_verify_hamming_equals_jax(monkeypatch):
    rng = np.random.default_rng(6)
    n = 2500
    text = random_dna_text(rng, n, n_wild=8, n_sep=6)
    pats = [text[s:s + ln].copy() for s, ln in
            ((10, 12), (400, 30), (900, 21), (2470, 25))]
    pats.append(rng.integers(0, 4, 18).astype(np.uint8))
    pats[1][4] ^= 1
    plens = np.array([p.size for p in pats], np.int32)
    maxplen = int(plens.max())
    patmat = np.full((len(pats), maxplen), -2, np.int32)
    for i, p in enumerate(pats):
        patmat[i, :p.size] = p
    P = 1200
    cand = np.concatenate([rng.integers(0, n, P - 40),
                           np.arange(n - 40, n)]).astype(np.int32)
    qidx = rng.integers(0, len(pats), P).astype(np.int32)
    cand[:4] = [10, 400, 900, 2470]
    qidx[:4] = [0, 1, 2, 3]
    jok, jmm = japprox._verify_hamming(
        jnp.asarray(text), jnp.asarray(cand), jnp.asarray(qidx),
        jnp.asarray(patmat), jnp.asarray(plens), maxplen, n)
    for elems in (1 << 24, 100 * maxplen):
        monkeypatch.setattr(tapprox, "_HAMMING_ELEMS", elems)
        ok, mm = tapprox._verify_hamming(
            _t(text, np.uint8), _t(cand, np.int32), _t(qidx, np.int32),
            _t(patmat, np.int32), _t(plens, np.int64), maxplen, n)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(mm.numpy(), np.asarray(jmm))
    assert mm.numpy()[:3].tolist() == [0, 1, 0]


# ---------------------------------------------------------------------------
# per-region Ukkonen scan vs the JAX full-text scan
# ---------------------------------------------------------------------------


def _jax_region_emits(text, pats, plens, M, k, regions):
    """The JAX scan with (n, B) resets / inregion masks, emissions read
    back as _region_detect reads them: (region, position), region-major,
    positions descending."""
    n = text.size
    B = len(pats)
    resets = np.zeros((n, B), bool)
    inreg = np.zeros((n, B), bool)
    patrev = np.full((B, M + 2), -7, np.int32)
    for qi, p in enumerate(pats):
        patrev[qi, 1:p.size + 1] = p[::-1].astype(np.int32)
    for q, a, b in regions:
        resets[n - 1 - b, q] = True
        inreg[n - 1 - b:n - a, q] = True
    emits = np.asarray(j_ukkonen(
        jnp.asarray(text[::-1].copy()), jnp.asarray(patrev),
        jnp.asarray(plens), M, k, resets=jnp.asarray(resets),
        inregion=jnp.asarray(inreg)))
    reg, pos = [], []
    for r, (q, a, b) in enumerate(regions):
        rows = np.flatnonzero(emits[n - 1 - b:n - a, q])
        reg += [r] * rows.size
        pos += (b - rows).tolist()
    return np.array(reg, np.int64), np.array(pos, np.int64), patrev


@pytest.mark.parametrize("k", [1, 2, 3])
def test_region_scan_equals_jax_full_text_scan(k, monkeypatch):
    """Several regions per query, a SEPARATOR inside a region, adjacent
    regions, a region at each end of the text, and one much longer than
    the others; with one chunk and with many."""
    rng = np.random.default_rng(30 + k)
    n = 1500
    text = random_dna_text(rng, n, n_wild=3)
    text[[130, 420, 1000, 1345]] = 255   # 130, 1345: right of a match
    pats = []
    for s, ln in ((100, 24), (400, 30), (700, 40), (980, 33), (1300, 26)):
        p = text[s:s + ln].copy()
        for _ in range(k):
            p[int(rng.integers(0, ln))] = rng.integers(0, 4)
        pats.append(p)
    pats[1] = np.delete(pats[1], 7)        # an indel
    # an exact occurrence cut by a SEPARATOR put into it afterwards (no
    # match may span it), and one that starts right after a SEPARATOR
    # (the separator's own column must not emit)
    pats += [text[1200:1230].copy(), text[1401:1425].copy()]
    text[[1215, 1400]] = 255
    pats[1] = pats[1][pats[1] < 250]       # patterns hold no separator
    pats[3] = pats[3][pats[3] < 250]
    plens = np.array([p.size for p in pats], np.int32)
    M = int(plens.max())
    regions = [(0, 0, 40), (0, 90, 135), (0, 136, 170),   # adjacent pair,
               (1, 380, 450),                             # SEPARATOR at 130
               (1, 500, 520), (2, 600, 900),              # one long region
               (2, 1100, 1150), (3, 960, 1030),           # SEPARATOR at 1000
               (4, 1290, 1350), (4, 1460, n - 1), (4, 5, 9),
               (5, 1190, 1240), (6, 1390, 1430)]
    regions.sort()
    wreg, wpos, patrev = _jax_region_emits(text, pats, plens, M, k, regions)
    assert wreg.size >= 5
    rq, ra, rb = (torch.tensor([r[i] for r in regions]) for i in range(3))
    for elems in (1 << 24, 3 * (M + 2)):
        monkeypatch.setattr(tonline, "_SCAN_ELEMS", elems)
        reg, pos = tonline._ukkonen_cutoff_scan(
            _t(text, np.uint8), _t(patrev, np.int32), _t(plens, np.int32),
            M, k, rq, ra, rb)
        np.testing.assert_array_equal(reg.numpy(), wreg)
        np.testing.assert_array_equal(pos.numpy(), wpos)

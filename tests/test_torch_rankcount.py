"""K1, the rank-count kernel: the port's plain version against the
Pallas kernel (interpret mode) and its XLA twin, on inputs packed by
the JAX RankLookupPlan.  The CUDA kernel against its plain version is
in test_torch_gpu.py (it runs on the card, where JAX is absent).

Every comparison is exact (int32 rank bounds, tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dna_text

from vstree_tpu.core.alphabet import dna_alphabet
from vstree_tpu.core.multiseq import Multiseq
from vstree_tpu.engine import complete as jcomplete
from vstree_tpu.index.build import build_esa
from vstree_tpu.native import rankcount as jrank
from vstree_tpu_torch.engine import complete as tcomplete
from vstree_tpu_torch.index.esa import ESA
from vstree_tpu_torch.native import rankcount as trank


def _queries(text, rng, num, lo, hi):
    """Substrings of the text (some with wildcards) and random ones,
    lengths in [lo, hi]."""
    n = text.size
    plens = rng.integers(lo, hi + 1, num).astype(np.int32)
    pats = np.full((num, hi), -1, np.int32)
    for i, ln in enumerate(plens):
        if i % 5 == 4:
            pats[i, :ln] = rng.integers(0, 4, ln)
        else:
            s = int(rng.integers(0, n - ln))
            pats[i, :ln] = text[s:s + ln]
    return pats, plens


@pytest.fixture(scope="module", params=[(12, 36), (4, 30)],
                ids=["ppl10", "ppl4"])
def packed(request):
    """(JAX ESA, JAX plan, flat8) for 900 queries on a 20 kbp text;
    the short-query case gives ppl 4 and wide buckets (rowspan >= 2)."""
    lo, hi = request.param
    rng = np.random.default_rng(17)
    text = random_dna_text(rng, 20000, n_wild=10, n_sep=4)
    ms = Multiseq(sequence=text, totallength=text.size)
    esa = build_esa(ms, dna_alphabet(), demand=("suf", "lcp"))
    plan = jcomplete.RankLookupPlan(esa, lo, hi)
    assert plan.ok
    pats, plens = _queries(text, rng, 900, lo, hi)
    flat8, Bp = plan.pack(pats, plens)
    assert Bp == 1024
    return esa, plan, flat8


def _inputs(plan, flat8):
    """K1's arguments for the batch, from the port's packing code on
    the JAX plan's tables (numpy)."""
    args = tcomplete.rank_lookup_inputs(
        torch.from_numpy(flat8), torch.from_numpy(np.array(plan.bck)),
        plan.ppl, plan.cpw, plan.sigma, plan.shift)
    return [a.numpy() for a in args]


def test_plain_k1_equals_pallas_and_xla(packed):
    esa, plan, flat8 = packed
    args = _inputs(plan, flat8)
    t1, t2 = np.array(plan.t1), np.array(plan.t2)
    got = trank.bucket_rank_lookup_ref(
        *map(torch.from_numpy, args + [t1, t2]), plan.rowspan)
    pallas = jrank.bucket_rank_lookup(
        *map(jnp.asarray, args + [t1, t2]), plan.rowspan, interpret=True)
    xla = jrank.bucket_rank_lookup_xla(
        *map(jnp.asarray, args + [t1, t2]), plan.rowspan)
    for g, p, x in zip(got, pallas, xla):
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    assert (got[1].numpy() > got[0].numpy()).sum() > 500  # real hits


def test_device_rank_lookup_equals_jax(packed):
    """Bracket gather + key packing + K1 of the port against the JAX
    _device_rank_lookup on the same packed batch, and the port plan's
    tables against the JAX plan's."""
    esa, plan, flat8 = packed
    want = jcomplete._device_rank_lookup(
        jnp.asarray(flat8), plan.bck, plan.t1, plan.t2, plan.ppl,
        plan.cpw, plan.sigma, plan.rowspan, plan.shift, False)
    tesa = ESA.from_shared(esa, "cpu")
    tplan = tcomplete.RankLookupPlan(tesa, plan.ppl, plan.coverage)
    assert (tplan.ppl, tplan.rowspan, tplan.shift) == (
        plan.ppl, plan.rowspan, plan.shift)
    np.testing.assert_array_equal(tplan.bck.numpy(), np.asarray(plan.bck))
    np.testing.assert_array_equal(tplan.t1.numpy(), np.asarray(plan.t1))
    np.testing.assert_array_equal(tplan.t2.numpy(), np.asarray(plan.t2))
    got = tcomplete._device_rank_lookup(
        torch.from_numpy(flat8), tplan.bck, tplan.t1, tplan.t2, tplan.ppl,
        tplan.cpw, tplan.sigma, tplan.rowspan, tplan.shift)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _small_args(B=64, rows=12):
    rng = np.random.default_rng(2)
    left = rng.integers(0, 1000, B).astype(np.int32)
    width = rng.integers(0, 100, B).astype(np.int32)
    keys = [rng.integers(0, 50, B).astype(np.int32) for _ in range(4)]
    t1 = np.sort(rng.integers(0, 50, rows * 128)).astype(np.int32)
    t2 = rng.integers(0, 50, rows * 128).astype(np.int32)
    return [left, width] + keys + [t1.reshape(rows, 128),
                                   t2.reshape(rows, 128)]


def test_wrapper_takes_plain_version_on_cpu_and_checks_contract():
    args = [torch.from_numpy(a) for a in _small_args()]
    before = trank.bucket_rank_lookup.launches
    lo, hi = trank.bucket_rank_lookup(*args, 2)
    assert trank.bucket_rank_lookup.launches == before  # no kernel on CPU
    ref = trank.bucket_rank_lookup_ref(*args, 2)
    np.testing.assert_array_equal(lo.numpy(), ref[0].numpy())
    np.testing.assert_array_equal(hi.numpy(), ref[1].numpy())
    xla = jrank.bucket_rank_lookup_xla(*map(jnp.asarray, _small_args()), 2)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(xla[0]))
    with pytest.raises(ValueError, match="rowspan"):
        trank.bucket_rank_lookup(*args, 1)   # width 99 needs rowspan 2
    with pytest.raises(ValueError, match="int32"):
        trank.bucket_rank_lookup(args[0].long(), *args[1:], 2)
    with pytest.raises(ValueError, match="1-D"):
        trank.bucket_rank_lookup(args[0][:10], *args[1:], 2)
    with pytest.raises(ValueError, match="ROWS, 128"):
        trank.bucket_rank_lookup(*args[:6], args[6].reshape(-1, 64),
                                 args[7].reshape(-1, 64), 2)
    bad = args[0].clone()
    bad[0] = 12 * 128
    with pytest.raises(ValueError, match="outside"):
        trank.bucket_rank_lookup(bad, *args[1:], 2)


def test_bracket_unpack_at_the_top_bit():
    """``left | width << shift`` with shift + bitlen(width) = 31 uses
    bit 30; the port's ``>>`` (arithmetic in torch) must still unpack
    it exactly, as ``lax.shift_right_logical`` does."""
    sigma, ppl, cpw, shift = 4, 1, 13, 21
    left = np.array([0, 5, (1 << 21) - 1, 77], np.int64)
    width = np.array([1023, 0, 512, 1], np.int64)  # bitlen 10: 21+10 = 31
    bck = np.zeros((1, 128), np.int64)
    bck[0, :4] = left | (width << shift)
    assert bck.max() >= 1 << 30 and bck.max() < 1 << 31
    W = ppl + 2 * cpw
    flat = np.full((W + 1, 4), -1, np.int8)
    flat[0] = [0, 1, 2, 3]  # bucket codes 0..3
    flat[W] = 1             # pattern length 1: no key chars
    got = tcomplete.rank_lookup_inputs(
        torch.from_numpy(flat.reshape(-1)),
        torch.from_numpy(bck.astype(np.int32)), ppl, cpw, sigma, shift)
    np.testing.assert_array_equal(got[0].numpy(), left)
    np.testing.assert_array_equal(got[1].numpy(), width)

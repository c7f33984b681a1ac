"""K1, the rank-interval kernel: the port's plain version
(``rank_interval_lookup_ref``: packed queries + packed bucket table +
suf + text in, [lo, hi) out) against the JAX package's
``_device_rank_lookup`` (its XLA twin) and the Pallas kernel in
interpret mode, on inputs packed by the JAX RankLookupPlan.  The CUDA
kernel against its plain version is in test_torch_gpu.py (it runs on the
card, where JAX is absent).

Inputs are made with numpy from a seed.  Every comparison is exact
(int32 rank bounds and key words, tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dna_text

from vstree_tpu.core.alphabet import dna_alphabet, protein_alphabet
from vstree_tpu.core.multiseq import Multiseq
from vstree_tpu.engine import complete as jcomplete
from vstree_tpu.index.build import build_esa
from vstree_tpu.native import rankcount as jrank
from vstree_tpu_torch.engine import complete as tcomplete
from vstree_tpu_torch.index.esa import ESA
from vstree_tpu_torch.native import rankcount as trank


def _text(kind, rng, n):
    """Random text with wildcards and separators; a regular char just
    before the end, a separator run, and a repeat so that some patterns
    occur more than once."""
    if kind == "dna":
        text = random_dna_text(rng, n, n_wild=10, n_sep=4)
    else:
        text = rng.integers(0, 20, n).astype(np.uint8)
        text[rng.choice(n, 10, replace=False)] = 254
        text[rng.choice(n, 4, replace=False)] = 255
    text[n // 2:n // 2 + 60] = text[100:160]
    text[n - 40:] = text[n - 40:] % 4  # regular chars up to the text end
    return text


def _queries(text, sigma, rng, num, lo, hi, esa, ppl):
    """Substrings of the text (some holding wildcards), random strings,
    patterns that end just before a separator or a wildcard and at the
    text end, the prefix of the widest bucket alone and extended, and
    the extreme lengths."""
    n = text.size
    plens = rng.integers(lo, hi + 1, num).astype(np.int32)
    plens[:4] = (lo, hi, lo, hi)
    pats = np.full((num, hi), -1, np.int32)
    special = np.flatnonzero(text >= 254)
    special = special[special > hi]
    bck = esa.aux_bck(ppl).astype(np.int64)
    widest = int(np.argmax(bck[1::2] - bck[0::2]))
    wstart = int(esa.suftab[bck[2 * widest]])
    for i, ln in enumerate(plens):
        kind = i % 8
        if kind == 0:
            pats[i, :ln] = rng.integers(0, sigma, ln)
        elif kind == 1:   # ends just before a special char
            for k in range(special.size):  # a window free of specials
                s = int(special[(i + k) % special.size]) - ln
                if (text[s:s + ln] < sigma).all():
                    break
            pats[i, :ln] = text[s:s + ln]
        elif kind == 2:   # ends at the text end
            pats[i, :ln] = text[n - ln:]
        elif kind == 3:   # the widest bucket: its prefix, then longer
            ln = plens[i] = ppl if i % 16 == 3 else ln
            pats[i, :ln] = text[wstart:wstart + ln]
        elif kind == 4:   # a text substring with its last char changed
            s = int(rng.integers(0, n - ln))
            pats[i, :ln] = text[s:s + ln]
            pats[i, ln - 1] = (pats[i, ln - 1] + 1) % sigma
        else:
            s = int(rng.integers(0, n - ln))
            pats[i, :ln] = text[s:s + ln]
    return pats, plens


CASES = [("dna", 12, 36), ("dna", 4, 30), ("protein", 4, 18),
         ("protein", 2, 12)]


@pytest.fixture(scope="module", params=CASES,
                ids=["dna_ppl10", "dna_ppl4", "protein_ppl4",
                     "protein_ppl2"])
def packed(request):
    """(JAX ESA, JAX plan, flat8, patterns, lengths) for 900 queries on
    a 20 kbp text; the short-query cases give shallow, wide buckets."""
    kind, lo, hi = request.param
    rng = np.random.default_rng(17)
    text = _text(kind, rng, 20000)
    alpha = dna_alphabet() if kind == "dna" else protein_alphabet()
    ms = Multiseq(sequence=text, totallength=text.size)
    esa = build_esa(ms, alpha, demand=("suf", "lcp"))
    plan = jcomplete.RankLookupPlan(esa, lo, hi)
    assert plan.ok
    pats, plens = _queries(text, alpha.num_regular, rng, 900, lo, hi, esa,
                           plan.ppl)
    flat8, Bp = plan.pack(pats, plens)
    assert Bp == 1024
    return esa, plan, flat8, pats, plens


def _inputs(plan, flat8):
    """The TPU kernel's arguments for the batch, from the port's packing
    code on the JAX plan's tables (numpy)."""
    args = trank.rank_lookup_inputs(
        torch.from_numpy(flat8), torch.from_numpy(np.array(plan.bck)),
        plan.ppl, plan.cpw, plan.sigma, plan.shift)
    return [a.numpy() for a in args]


def _plain(esa, plan, flat8):
    """The port's plain version on the JAX plan's bucket table and the
    JAX ESA's suf and text."""
    lo, hi, err = trank.rank_interval_lookup_ref(
        torch.from_numpy(flat8), torch.from_numpy(np.array(plan.bck)),
        torch.from_numpy(esa.suftab.astype(np.int32)),
        torch.from_numpy(esa.text), esa.totallength, plan.ppl, plan.cpw,
        plan.sigma, plan.shift)
    assert int(err) == 0
    return lo.numpy(), hi.numpy()


def test_plain_k1_equals_pallas_and_xla(packed):
    """The windowed count (the TPU kernel's own contract) and the new
    plain version, both against the Pallas kernel in interpret mode and
    its XLA twin on the JAX plan's key-word tables."""
    esa, plan, flat8, _, _ = packed
    args = _inputs(plan, flat8)
    t1, t2 = np.array(plan.t1), np.array(plan.t2)
    got = trank.bucket_rank_lookup_ref(
        *map(torch.from_numpy, args + [t1, t2]), plan.rowspan)
    pallas = jrank.bucket_rank_lookup(
        *map(jnp.asarray, args + [t1, t2]), plan.rowspan, interpret=True)
    xla = jrank.bucket_rank_lookup_xla(
        *map(jnp.asarray, args + [t1, t2]), plan.rowspan)
    new = _plain(esa, plan, flat8)
    for g, p, x, w in zip(got, pallas, xla, new):
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        np.testing.assert_array_equal(w, np.asarray(p))
    assert (got[1].numpy() > got[0].numpy()).sum() > 500  # real hits


def test_device_rank_lookup_equals_jax(packed):
    """The port's whole lookup (its own plan: bucket table made by the
    device form, suf, text; then the wrapper, which takes the plain
    version on the CPU) against the JAX _device_rank_lookup on the same
    packed batch."""
    esa, plan, flat8, _, _ = packed
    want = jcomplete._device_rank_lookup(
        jnp.asarray(flat8), plan.bck, plan.t1, plan.t2, plan.ppl,
        plan.cpw, plan.sigma, plan.rowspan, plan.shift, False)
    tesa = ESA.from_shared(esa, "cpu")
    tplan = tcomplete.RankLookupPlan(tesa, plan.ppl, plan.coverage)
    assert tplan.ok
    assert (tplan.ppl, tplan.rowspan, tplan.shift, tplan.cpw) == (
        plan.ppl, plan.rowspan, plan.shift, plan.cpw)
    np.testing.assert_array_equal(tplan.bck.numpy(), np.asarray(plan.bck))
    assert tplan.suf.dtype == torch.int32
    assert not hasattr(tplan, "t1")  # no per-rank key table is built
    got = tplan.run(flat8)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_own_packing_and_odd_batch_sizes(packed):
    """The port's pack (no padding to the TPU tile) at batch sizes that
    are no multiple of 32, against the JAX lookup's first B results;
    zero-width and invalid queries return lo == hi == left."""
    esa, plan, flat8, pats, plens = packed
    want = jcomplete._device_rank_lookup(
        jnp.asarray(flat8), plan.bck, plan.t1, plan.t2, plan.ppl,
        plan.cpw, plan.sigma, plan.rowspan, plan.shift, False)
    tesa = ESA.from_shared(esa, "cpu")
    tplan = tcomplete.RankLookupPlan(tesa, plan.ppl, plan.coverage)
    for B in (1, 37, 899):
        got = tplan.run(tplan.pack(pats[:B], plens[:B]))
        assert got[0].numel() == B
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.asarray(want[0])[:B])
        np.testing.assert_array_equal(got[1].numpy(),
                                      np.asarray(want[1])[:B])
    lo, hi = np.asarray(want[0])[:900], np.asarray(want[1])[:900]
    assert (hi == lo).sum() > 50 and (hi - lo > 1).sum() > 50
    # the planted edge patterns do occur
    for kind in (1, 2, 3):
        assert (hi[kind::8] > lo[kind::8]).all(), kind


def test_intervals_equal_a_direct_count(packed):
    """Independent of both packages: the interval width equals the
    number of text positions where the whole pattern occurs."""
    esa, plan, flat8, pats, plens = packed
    lo, hi = _plain(esa, plan, flat8)
    text = esa.text
    for i in range(0, 900, 7):
        p = pats[i, :plens[i]]
        if (p >= plan.sigma).any():
            assert hi[i] == lo[i]
            continue
        win = np.lib.stride_tricks.sliding_window_view(text, p.size)
        count = int((win == p.astype(np.uint8)).all(1).sum())
        assert hi[i] - lo[i] == count, i


@pytest.mark.parametrize("kind,depths", [("dna", (1, 3, 10)),
                                         ("protein", (1, 2, 4))])
def test_key_words_on_the_fly_equal_rank_words_host(kind, depths):
    """The key words the plain version makes from suf and the text, for
    every rank of a small index, against the JAX package's table."""
    rng = np.random.default_rng(23)
    text = _text(kind, rng, 3000)
    text[-3:] = (254, 1, 255) if kind == "dna" else (255, 19, 254)
    alpha = dna_alphabet() if kind == "dna" else protein_alphabet()
    ms = Multiseq(sequence=text, totallength=text.size)
    esa = build_esa(ms, alpha, demand=("suf",))
    n = text.size
    suf = torch.from_numpy(esa.suftab.astype(np.int32))
    ranks = torch.arange(n + 1, dtype=torch.int32)
    for depth in depths:
        h1, h2 = esa.rank_words_host(depth)
        w1, w2 = trank.rank_key_words(
            suf, torch.from_numpy(text), ranks, n, depth,
            esa.chars_per_word(), alpha.num_regular)
        np.testing.assert_array_equal(w1.numpy(), h1[:n + 1])
        np.testing.assert_array_equal(w2.numpy(), h2[:n + 1])
    # a subset of ranks in any order, int64 indices
    pick = torch.from_numpy(rng.integers(0, n + 1, 500))
    w1, w2 = trank.rank_key_words(suf, torch.from_numpy(text), pick, n,
                                  depths[-1], esa.chars_per_word(),
                                  alpha.num_regular)
    np.testing.assert_array_equal(w1.numpy(), h1[pick.numpy()])
    np.testing.assert_array_equal(w2.numpy(), h2[pick.numpy()])


def _small_args(B=64, rows=12):
    rng = np.random.default_rng(2)
    left = rng.integers(0, 1000, B).astype(np.int32)
    width = rng.integers(0, 100, B).astype(np.int32)
    keys = [rng.integers(0, 50, B).astype(np.int32) for _ in range(4)]
    t1 = np.sort(rng.integers(0, 50, rows * 128)).astype(np.int32)
    t2 = rng.integers(0, 50, rows * 128).astype(np.int32)
    return [left, width] + keys + [t1.reshape(rows, 128),
                                   t2.reshape(rows, 128)]


def test_windowed_count_equals_xla_on_random_tables():
    """bucket_rank_lookup_ref, the link to the TPU kernel's contract, on
    random brackets and tables against the XLA twin."""
    args = [torch.from_numpy(a) for a in _small_args()]
    ref = trank.bucket_rank_lookup_ref(*args, 2)
    xla = jrank.bucket_rank_lookup_xla(*map(jnp.asarray, _small_args()), 2)
    np.testing.assert_array_equal(ref[0].numpy(), np.asarray(xla[0]))
    np.testing.assert_array_equal(ref[1].numpy(), np.asarray(xla[1]))


def _wrapper_args(packed):
    esa, plan, flat8, _, _ = packed
    return [torch.from_numpy(flat8), torch.from_numpy(np.array(plan.bck)),
            torch.from_numpy(esa.suftab.astype(np.int32)),
            torch.from_numpy(esa.text)], (
        esa.totallength, plan.ppl, plan.cpw, plan.sigma, plan.shift)


def test_wrapper_takes_plain_version_on_cpu_and_checks_contract(packed):
    args, scal = _wrapper_args(packed)
    before = trank.rank_interval_lookup.launches
    lo, hi = trank.rank_interval_lookup(*args, *scal)
    assert trank.rank_interval_lookup.launches == before  # no kernel on CPU
    ref = trank.rank_interval_lookup_ref(*args, *scal)
    np.testing.assert_array_equal(lo.numpy(), ref[0].numpy())
    np.testing.assert_array_equal(hi.numpy(), ref[1].numpy())
    flat8, bck, suf, text = args
    with pytest.raises(ValueError, match="int8"):
        trank.rank_interval_lookup(flat8.to(torch.int32), bck, suf, text,
                                   *scal)
    with pytest.raises(ValueError, match="int32"):
        trank.rank_interval_lookup(flat8, bck, suf.long(), text, *scal)
    with pytest.raises(ValueError, match="contiguous"):
        trank.rank_interval_lookup(flat8, bck, suf.repeat(2)[::2], text,
                                   *scal)
    with pytest.raises(ValueError, match="rows"):
        trank.rank_interval_lookup(flat8[:-1], bck, suf, text, *scal)
    with pytest.raises(ValueError, match="sentinel"):
        trank.rank_interval_lookup(flat8, bck.reshape(-1)[:scal[3] ** scal[1]],
                                   suf, text, *scal)
    with pytest.raises(ValueError, match=r"suf must be \[n\+1\]"):
        trank.rank_interval_lookup(flat8, bck, suf[:-1], text, *scal)
    with pytest.raises(ValueError, match="scalars"):
        trank.rank_interval_lookup(flat8, bck, suf, text, scal[0], scal[1],
                                   scal[2], scal[3], 31)


def test_wrapper_raises_on_the_error_word(packed):
    """What the kernel reports in its error word the plain version
    reports alike: a bracket outside the ranks, a query longer than the
    coverage."""
    args, scal = _wrapper_args(packed)
    flat8, bck, suf, text = args
    n, ppl, cpw, sigma, shift = scal
    B = flat8.numel() // (ppl + 2 * cpw + 1)
    # the bucket of query 0, moved so that it ends past rank n
    rows = flat8.reshape(-1, B).to(torch.int64)
    code0 = int(sum(int(rows[j, 0]) * sigma ** (ppl - 1 - j)
                    for j in range(ppl)))
    bad = bck.clone().reshape(-1)
    bad[code0] = (n - 1) | (3 << shift)
    with pytest.raises(ValueError, match="bracket"):
        trank.rank_interval_lookup(flat8, bad, suf, text, *scal)
    bad[code0] = -5  # negative packed entry: the logical shift is huge
    with pytest.raises(ValueError, match="bracket"):
        trank.rank_interval_lookup(flat8, bad, suf, text, *scal)
    assert int(trank.rank_interval_lookup_ref(
        flat8, bad, suf, text, *scal)[2]) == trank.ERR_BRACKET
    long = flat8.clone().reshape(-1, B)
    long[-1, 5] = ppl + 2 * cpw + 1
    with pytest.raises(ValueError, match="longer"):
        trank.rank_interval_lookup(long.reshape(-1), bck, suf, text, *scal)


def test_wrapper_refuses_other_devices(packed):
    """Only the CPU takes the plain version; a device that is neither
    the CPU nor CUDA raises."""
    args, scal = _wrapper_args(packed)
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="no kernel for device"):
        trank.rank_interval_lookup(*meta, *scal)
    with pytest.raises(ValueError, match="tensors on"):
        trank.rank_interval_lookup(args[0], meta[1], *args[2:], *scal)


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
    got = trank.rank_lookup_inputs(
        torch.from_numpy(flat.reshape(-1)),
        torch.from_numpy(bck.astype(np.int32)), ppl, cpw, sigma, shift)
    np.testing.assert_array_equal(got[0].numpy(), left)
    np.testing.assert_array_equal(got[1].numpy(), width)


def test_empty_batch_and_widest_buckets():
    """B = 0, and a depth-1 plan whose brackets are a quarter of the
    ranks (far beyond the TPU kernel's 8-row window): the plain version
    still equals a direct count."""
    rng = np.random.default_rng(29)
    text = _text("dna", rng, 4000)
    ms = Multiseq(sequence=text, totallength=text.size)
    esa = build_esa(ms, dna_alphabet(), demand=("suf",))
    tesa = ESA.from_shared(esa, "cpu")
    n, ppl, cpw, sigma = text.size, 1, 13, 4
    shift = 13
    raw = tesa.aux_bck_device(ppl)
    packed = raw[0::2] | ((raw[1::2] - raw[0::2]) << shift)
    bck = torch.zeros(128, dtype=torch.int32)
    bck[:4] = packed
    suf, txt = tesa.device_suf32(), tesa.device("text")
    W = ppl + 2 * cpw
    lo, hi = trank.rank_interval_lookup(
        torch.zeros(0, dtype=torch.int8), bck, suf, txt, n, ppl, cpw,
        sigma, shift)
    assert lo.numel() == 0 and hi.numel() == 0
    pats = [text[s:s + ln] for s, ln in
            ((10, 1), (50, 2), (200, 5), (n - 3, 3), (700, W))]
    flat = np.full((W + 1, len(pats)), -1, np.int8)
    for i, p in enumerate(pats):
        flat[:p.size, i] = np.where(p < 4, p, 120)
        flat[W, i] = p.size
    lo, hi = trank.rank_interval_lookup(
        torch.from_numpy(flat.reshape(-1)), bck, suf, txt, n, ppl, cpw,
        sigma, shift)
    for i, p in enumerate(pats):
        win = np.lib.stride_tricks.sliding_window_view(text, p.size)
        want = int((win == p).all(1).sum()) if (p < 4).all() else 0
        assert int(hi[i] - lo[i]) == want, i
        if want:
            assert (text[esa.suftab[int(lo[i])]:][:p.size] == p).all()

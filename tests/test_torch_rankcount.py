"""K1, the rank-interval kernel: the port's plain version
(``rank_interval_lookup_ref``: packed queries + bracket table + suf +
text in, [lo, hi) out) against the JAX package's
``_device_rank_lookup`` (its XLA twin) and the Pallas kernel in
interpret mode, on inputs packed by the JAX RankLookupPlan (whose
``left | width << shift`` bucket table the tests unpack into the port's
``(left, width)`` pairs).  The CUDA kernel against its plain version is
in test_torch_gpu.py (it runs on the card, where JAX is absent).

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


def _pairs(plan):
    """The JAX plan's packed bucket table (``left | width << shift``
    per code, then a zero sentinel) as the port's int32 ``(left,
    width)`` pairs."""
    v = np.asarray(plan.bck).reshape(-1)[:plan.sigma ** plan.ppl + 1]
    v = v.astype(np.int64) & 0xFFFFFFFF
    pairs = np.stack([v & ((1 << plan.shift) - 1), v >> plan.shift], 1)
    return torch.from_numpy(pairs.reshape(-1).astype(np.int32))


def _inputs(plan, flat8):
    """The TPU kernel's arguments for the batch, from the port's packing
    code on the JAX plan's tables (numpy)."""
    args = trank.rank_lookup_inputs(
        torch.from_numpy(flat8), _pairs(plan), plan.ppl, plan.cpw,
        plan.sigma)
    return [a.numpy() for a in args]


def _plain(esa, plan, flat8):
    """The port's plain version on the JAX plan's bucket table and the
    JAX ESA's suf and text."""
    lo, hi, err = trank.rank_interval_lookup_ref(
        torch.from_numpy(flat8), _pairs(plan),
        torch.from_numpy(esa.suftab.astype(np.int32)),
        torch.from_numpy(esa.text), esa.totallength, plan.ppl, plan.cpw,
        plan.sigma)
    assert int(err) == 0
    return lo.numpy(), hi.numpy()


def test_plain_k1_equals_pallas_and_xla(packed):
    """The plain version against the Pallas kernel in interpret mode and
    its XLA twin on the JAX plan's key-word tables."""
    esa, plan, flat8, _, _ = packed
    args = _inputs(plan, flat8)
    t1, t2 = np.array(plan.t1), np.array(plan.t2)
    pallas = jrank.bucket_rank_lookup(
        *map(jnp.asarray, args + [t1, t2]), plan.rowspan, interpret=True)
    xla = jrank.bucket_rank_lookup_xla(
        *map(jnp.asarray, args + [t1, t2]), plan.rowspan)
    new = _plain(esa, plan, flat8)
    for w, p, x in zip(new, pallas, xla):
        np.testing.assert_array_equal(w, np.asarray(p))
        np.testing.assert_array_equal(w, np.asarray(x))
    assert (new[1] > new[0]).sum() > 500  # real hits


def test_bracket_table_equals_the_jax_plans_brackets(packed):
    """bracket_table, which the port's plan calls, from the JAX ESA's
    NumPy bucket table and from the port's on the device: the JAX plan's
    packed brackets, unpacked, as int32 pairs."""
    esa, plan, _, _, _ = packed
    want = _pairs(plan)
    got = trank.bracket_table(esa.aux_bck(plan.ppl))
    assert got.dtype == torch.int32 and got.dim() == 1
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    tesa = ESA.from_shared(esa, "cpu")
    got = trank.bracket_table(tesa.aux_bck_device(plan.ppl))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got[-2:].tolist() == [0, 0]  # the sentinel entry


def test_device_rank_lookup_equals_jax(packed):
    """The port's whole lookup (its own plan: bracket table made by the
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
    assert (tplan.ppl, tplan.coverage, tplan.cpw, tplan.sigma) == (
        plan.ppl, plan.coverage, plan.cpw, plan.sigma)
    # the same brackets, unpacked: no window and no packing shift
    np.testing.assert_array_equal(tplan.bck.numpy(), _pairs(plan).numpy())
    assert tplan.bck.dtype == torch.int32 and tplan.bck.dim() == 1
    assert tplan.suf.dtype == torch.int32
    for tpu_only in ("t1", "rowspan", "shift"):  # no per-rank key table
        assert not hasattr(tplan, tpu_only)
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


def _wrapper_args(packed):
    esa, plan, flat8, _, _ = packed
    return [torch.from_numpy(flat8), _pairs(plan),
            torch.from_numpy(esa.suftab.astype(np.int32)),
            torch.from_numpy(esa.text)], (
        esa.totallength, plan.ppl, plan.cpw, plan.sigma)


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
        trank.rank_interval_lookup(
            flat8, bck[:2 * scal[3] ** scal[1]].clone(), suf, text, *scal)
    with pytest.raises(ValueError, match="1-D"):
        trank.rank_interval_lookup(flat8, bck.reshape(-1, 2), suf, text,
                                   *scal)
    with pytest.raises(ValueError, match=r"suf must be \[n\+1\]"):
        trank.rank_interval_lookup(flat8, bck, suf[:-1], text, *scal)
    with pytest.raises(ValueError, match="scalars"):
        trank.rank_interval_lookup(flat8, bck, suf, text, 1 << 30, scal[1],
                                   scal[2], scal[3])


def test_wrapper_raises_on_the_error_word(packed):
    """What the kernel reports in its error word the plain version
    reports alike: a bracket outside the ranks, a query longer than the
    coverage."""
    args, scal = _wrapper_args(packed)
    flat8, bck, suf, text = args
    n, ppl, cpw, sigma = scal
    B = flat8.numel() // (ppl + 2 * cpw + 1)
    # the bucket of query 0, moved so that it ends past rank n + 1
    rows = flat8.reshape(-1, B).to(torch.int64)
    code0 = int(sum(int(rows[j, 0]) * sigma ** (ppl - 1 - j)
                    for j in range(ppl)))
    for left, width in ((n - 1, 3), (2, -5), (-1, 1)):
        bad = bck.clone()
        bad[2 * code0:2 * code0 + 2] = torch.tensor([left, width])
        with pytest.raises(ValueError, match="bracket"):
            trank.rank_interval_lookup(flat8, bad, suf, text, *scal)
        assert int(trank.rank_interval_lookup_ref(
            flat8, bad, suf, text, *scal)[2]) == trank.ERR_BRACKET
    bad[2 * code0:2 * code0 + 2] = torch.tensor([n - 1, 2])  # to n + 1
    trank.rank_interval_lookup(flat8, bad, suf, text, *scal)
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
    """Brackets up to bit 29 of left and width, where the TPU's
    ``left | width << shift`` had no room (shift 21 + bitlen(width) >
    31): the port's pairs are read as they are, and an invalid query
    takes the sentinel entry."""
    sigma, ppl, cpw = 4, 1, 13
    left = np.array([0, 5, (1 << 21) - 1, (1 << 29) - 7], np.int64)
    width = np.array([(1 << 29) + 3, 0, 1 << 11, 7], np.int64)
    assert (21 + np.array([int(w).bit_length() for w in width]) > 31).any()
    bck = trank.bracket_table(np.stack([left, left + width], 1).reshape(-1))
    W = ppl + 2 * cpw
    flat = np.full((W + 1, 5), -1, np.int8)
    flat[0] = [0, 1, 2, 3, 120]  # bucket codes 0..3, a wildcard
    flat[W] = 1                  # pattern length 1: no key chars
    got = trank.rank_lookup_inputs(
        torch.from_numpy(flat.reshape(-1)), bck, ppl, cpw, sigma)
    np.testing.assert_array_equal(got[0].numpy(), np.append(left, 0))
    np.testing.assert_array_equal(got[1].numpy(), np.append(width, 0))


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
    bck = trank.bracket_table(tesa.aux_bck_device(ppl))
    suf, txt = tesa.device_suf32(), tesa.device("text")
    W = ppl + 2 * cpw
    lo, hi = trank.rank_interval_lookup(
        torch.zeros(0, dtype=torch.int8), bck, suf, txt, n, ppl, cpw,
        sigma)
    assert lo.numel() == 0 and hi.numel() == 0
    pats = [text[s:s + ln] for s, ln in
            ((10, 1), (50, 2), (200, 5), (n - 3, 3), (700, W))]
    flat = np.full((W + 1, len(pats)), -1, np.int8)
    for i, p in enumerate(pats):
        flat[:p.size, i] = np.where(p < 4, p, 120)
        flat[W, i] = p.size
    lo, hi = trank.rank_interval_lookup(
        torch.from_numpy(flat.reshape(-1)), bck, suf, txt, n, ppl, cpw,
        sigma)
    for i, p in enumerate(pats):
        win = np.lib.stride_tricks.sliding_window_view(text, p.size)
        want = int((win == p).all(1).sum()) if (p < 4).all() else 0
        assert int(hi[i] - lo[i]) == want, i
        if want:
            assert (text[esa.suftab[int(lo[i])]:][:p.size] == p).all()

"""Port vs JAX package: the two-text LCE (``index/sort.py::
device_lce_pairs`` with ``tables_b``/``nb``/``init_l``/``active0``,
``ops/lce.py::lce_two_texts`` and the sweeps of ``engine/gextend.py::
Seqs``).

The same NumPy texts and index arrays go through both packages and a
char-by-char count; every result must be equal (integers, tolerance 0).
The torch ladder runs on CPU tensors here.
"""

import numpy as np
import pytest
import torch

from vstree_tpu.engine import gextend as jgextend
from vstree_tpu.index import sort as jsort
from vstree_tpu.ops import lce as jlce
from vstree_tpu_torch.engine import gextend as tgextend
from vstree_tpu_torch.index import sort as tsort
from vstree_tpu_torch.ops import lce as tlce

WILDCARD, SEPARATOR = 254, 255


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's loops launch thousands of small ops; a thread pool per
    test worker only makes the workers of one host wait for each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _texts(sigma: int, seed: int):
    """Two texts that share long and short pieces (some of them at the
    very ends of either text), with wildcards and separators, one of
    them right beside a shared piece."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, sigma, 900).astype(np.uint8)
    b = rng.integers(0, sigma, 700).astype(np.uint8)
    for ln, sa, sb in ((200, 100, 50), (40, 400, 300), (9, 600, 500),
                       (60, 0, 640), (70, 830, 0), (33, 500, 0)):
        b[sb:sb + ln] = a[sa:sa + ln]
    a[[150, 460]] = WILDCARD
    b[[90, 310]] = WILDCARD
    a[[99, 700]] = SEPARATOR         # 99: just left of a shared piece
    b[[340, 600]] = SEPARATOR        # 340: just right of one
    return a, b


def _naive(ta, a, tb, b):
    out = []
    for i, j in zip(a.tolist(), b.tolist()):
        d = 0
        while (i + d < ta.size and j + d < tb.size
               and ta[i + d] == tb[j + d] and ta[i + d] < WILDCARD):
            d += 1
        out.append(d)
    return np.array(out, np.int64)


def _pairs(rng, a, b, n):
    """Index pairs of which many start inside a shared piece, plus both
    ends of both texts."""
    ia = rng.integers(0, a.size + 1, n)
    ib = rng.integers(0, b.size + 1, n)
    for k, (sa, sb, ln) in enumerate(((100, 50, 200), (400, 300, 40),
                                      (0, 640, 60), (830, 0, 70))):
        off = rng.integers(0, ln, n // 8)
        ia[k * (n // 8):(k + 1) * (n // 8)] = sa + off
        ib[k * (n // 8):(k + 1) * (n // 8)] = sb + off
    ia[-4:] = [0, a.size, a.size - 1, a.size]
    ib[-4:] = [b.size, 0, b.size - 1, b.size]
    return ia, ib


@pytest.mark.parametrize("sigma", [4, 20], ids=["dna", "protein"])
def test_lce_two_texts_equals_the_original_and_a_direct_count(sigma):
    a, b = _texts(sigma, 31)
    ia, ib = _pairs(np.random.default_rng(32), a, b, 400)
    got = tlce.lce_two_texts(a, ia, b, ib)
    want = jlce.lce_two_texts(a, ia, b, ib)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _naive(a, ia, b, ib))
    assert got.max() >= 100 and (got == 0).sum() > 20
    assert tlce.lce_two_texts(a, ia[:0], b, ib[:0]).size == 0


def _tables(mod, text, sigma, to_dev):
    bits, D = mod.lce_pack_params(sigma)
    return mod._lce_tables(to_dev(text), int(text.size), bits, D)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "active0"])
@pytest.mark.parametrize("seeded", [False, True], ids=["zero", "init_l"])
@pytest.mark.parametrize("sigma", [4, 20], ids=["dna", "protein"])
def test_device_lce_pairs_two_texts(sigma, seeded, masked):
    """tables_b / nb / init_l / active0 as the JAX ladder takes them: a
    lane that is not active keeps its init_l."""
    import jax.numpy as jnp

    a, b = _texts(sigma, 33)
    rng = np.random.default_rng(34)
    ia, ib = _pairs(rng, a, b, 400)
    exact = _naive(a, ia, b, ib)
    # a start value may be anything up to the true extension
    init = (exact * rng.integers(0, 2, exact.size)) // 2 if seeded else None
    active = rng.random(exact.size) < 0.7 if masked else None

    want = np.asarray(jsort.device_lce_pairs(
        None, int(a.size), sigma, jnp.asarray(ia, jnp.int32),
        jnp.asarray(ib, jnp.int32), ia.size,
        tables=_tables(jsort, a, sigma, jnp.asarray),
        tables_b=_tables(jsort, b, sigma, jnp.asarray), nb=int(b.size),
        init_l=None if init is None else jnp.asarray(init, jnp.int32),
        active0=None if active is None else jnp.asarray(active)))
    got = tsort.device_lce_pairs(
        None, int(a.size), sigma, torch.from_numpy(ia), torch.from_numpy(ib),
        ia.size, tables=_tables(tsort, a, sigma, torch.from_numpy),
        tables_b=_tables(tsort, b, sigma, torch.from_numpy), nb=int(b.size),
        init_l=None if init is None else torch.from_numpy(init),
        active0=None if active is None else torch.from_numpy(active))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    live = np.ones(exact.size, bool) if active is None else active
    np.testing.assert_array_equal(got.numpy()[live], exact[live])
    if active is not None:
        start = np.zeros(exact.size, np.int64) if init is None else init
        np.testing.assert_array_equal(got.numpy()[~live], start[~live])
        assert (exact[~live] > start[~live]).any()


def test_device_lce_pairs_one_text_is_unchanged():
    """Without the new arguments the ladder is the one-text form that
    the build runs, and nothing active is nothing to do."""
    a, _ = _texts(4, 35)
    rng = np.random.default_rng(36)
    ia = rng.integers(0, a.size, 300)
    ib = rng.integers(0, a.size, 300)
    ta = torch.from_numpy(a)
    got = tsort.device_lce_pairs(ta, int(a.size), 4, torch.from_numpy(ia),
                                 torch.from_numpy(ib), 300)
    np.testing.assert_array_equal(got.numpy(), _naive(a, ia, a, ib))
    none = tsort.device_lce_pairs(
        ta, int(a.size), 4, torch.from_numpy(ia), torch.from_numpy(ib), 300,
        init_l=torch.full((300,), 7), active0=torch.zeros(300, dtype=bool))
    assert none.tolist() == [7] * 300


@pytest.mark.parametrize("same", [True, False], ids=["self", "two_texts"])
@pytest.mark.parametrize("sigma", [4, 20], ids=["dna", "protein"])
def test_seqs_sweeps_equal_the_original(sigma, same):
    """``Seqs.lce_fwd`` / ``lce_bwd`` (the ladder over the texts and their
    flipped copies) against the JAX package's host sweeps: starts at both
    ends of both texts, at -1 and at n, beside a separator."""
    a, b = _texts(sigma, 37)
    if same:
        b = a
    jsq = jgextend.Seqs(a, b)
    tsq = tgextend.Seqs(a, b, "cpu")
    assert (tsq.s2 is tsq.s1) == same == (tsq.d_r2 is tsq.d_r1)
    assert tsq.d_s1.device.type == "cpu" and tsq.d_r1.dtype == torch.uint8
    np.testing.assert_array_equal(tsq.d_r1.numpy(), a[::-1])
    rng = np.random.default_rng(38)
    ia, ib = _pairs(rng, a, b, 400)
    if same:    # pairs of one text: starts inside its two tandem copies
        a[300:360] = a[200:260]
        jsq, tsq = jgextend.Seqs(a, a), tgextend.Seqs(a, a, "cpu")
        ia = rng.integers(0, a.size + 1, 400)
        ib = np.where(rng.random(400) < 0.5, ia + 100, ib) % (a.size + 1)
    got = tsq.lce_fwd(ia, ib)
    want = jsq.lce_fwd(ia, ib)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _naive(a, ia, tsq.s2, ib))
    # leftward, from inclusive start points; -1 gives 0
    la = np.concatenate([ia - 1, [-1, 0, a.size - 1, 98, 100]])
    lb = np.concatenate([ib - 1, [5, -1, tsq.n2 - 1, 48, 50]])
    got = tsq.lce_bwd(la, lb)
    np.testing.assert_array_equal(got, jsq.lce_bwd(la, lb))
    rev = _naive(a[::-1], a.size - 1 - np.maximum(la, -1), tsq.s2[::-1],
                 tsq.n2 - 1 - np.maximum(lb, -1))
    np.testing.assert_array_equal(got, np.where((la < 0) | (lb < 0), 0, rev))
    assert got.max() >= 30
    assert tsq.lce(ia[:0], ib[:0], True).size == 0


def test_seqs_tables_follow_the_alphabet():
    """The packed words take their width from the largest regular code
    of the texts (protein: fewer chars a word than DNA)."""
    from vstree_tpu_torch.engine.gextend_dev import _dev_tables

    for sigma, want in ((4, tsort.lce_pack_params(4)),
                        (20, tsort.lce_pack_params(20))):
        a, b = _texts(sigma, 39)
        a[0], b[0] = sigma - 1, 0
        sq = tgextend.Seqs(a, b, "cpu")
        tabs = _dev_tables(sq)
        assert tabs is _dev_tables(sq)          # made once
        assert tabs["sigma"] == sigma
        assert tsort.lce_pack_params(tabs["sigma"]) == want
        jtabs = __import__("vstree_tpu.engine.gextend_dev", fromlist=["x"]
                           )._dev_tables(jgextend.Seqs(a, b))
        for name in ("p1", "x1", "p2", "x2", "Pf1", "Pb1", "Pf2", "Pb2"):
            np.testing.assert_array_equal(tabs[name].numpy(),
                                          np.asarray(jtabs[name]), name)
    assert tsort.lce_pack_params(4)[1] > tsort.lce_pack_params(20)[1]

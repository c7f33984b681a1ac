"""Port vs JAX package: suffix sort, LCP ladder and their translation
hazards (vstree_tpu_torch/index/sort.py vs vstree_tpu/index/sort.py).

Inputs are made with numpy from a seed and handed to both packages;
every comparison is exact (integer tables, tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from conftest import random_dna_text
from oracle.naive import naive_lcp, naive_lcp_table, naive_suffix_array

from vstree_tpu.index import sort as jsort
from vstree_tpu_torch.index import sort as tsort

CASES = [
    ("plain", dict(n=200, n_wild=0, n_sep=0)),
    ("wildcards", dict(n=300, n_wild=12, n_sep=0)),
    ("separators", dict(n=300, n_wild=6, n_sep=5)),
    ("tiny", dict(n=3, n_wild=0, n_sep=0)),
    ("single", dict(n=1, n_wild=0, n_sep=0)),
    ("allsame", None),
    ("bigger", dict(n=5000, n_wild=20, n_sep=10)),
    ("protein", None),
]


def _text(name, spec, seed=7):
    rng = np.random.default_rng(seed)
    if name == "allsame":
        return np.zeros(64, np.uint8)
    if name == "protein":
        t = rng.integers(0, 20, size=700).astype(np.uint8)
        t[rng.choice(700, size=9, replace=False)] = 254
        t[rng.choice(700, size=4, replace=False)] = 255
        return t
    return random_dna_text(rng, **spec)


def _sigma(name):
    return 20 if name == "protein" else 4


@pytest.mark.parametrize("name,spec", CASES, ids=[c[0] for c in CASES])
def test_suffix_sort_and_lcp_equal_jax(name, spec):
    text = _text(name, spec)
    sigma = _sigma(name)
    suf, sti = tsort.suffix_sort_host(text, sigma, device="cpu")
    jsuf, jsti = jsort.suffix_sort_host(text, sigma)
    np.testing.assert_array_equal(suf, jsuf)
    np.testing.assert_array_equal(sti, jsti)
    np.testing.assert_array_equal(suf, naive_suffix_array(text))
    suf2, lcp = tsort.suf_lcp_host(text, sigma, device="cpu")
    jsuf2, jlcp = jsort.suf_lcp_host(text, sigma)
    np.testing.assert_array_equal(suf2, jsuf2)
    np.testing.assert_array_equal(lcp, jlcp)
    np.testing.assert_array_equal(lcp, naive_lcp_table(text, suf2))


@pytest.mark.parametrize("name,spec", CASES, ids=[c[0] for c in CASES])
def test_lce_pairs_equal_jax(name, spec):
    text = _text(name, spec, seed=8)
    rng = np.random.default_rng(9)
    n = text.size
    a = rng.integers(0, n, size=300).astype(np.int32)
    b = rng.integers(0, n, size=300).astype(np.int32)
    b[:20] = a[:20]  # identical suffixes: lce runs to a special or the end
    got = tsort.lce_pairs_host(text, a, b, _sigma(name), device="cpu")
    np.testing.assert_array_equal(
        got, jsort.lce_pairs_host(text, a, b, _sigma(name)))
    np.testing.assert_array_equal(
        got, [naive_lcp(text, int(x), int(y)) for x, y in zip(a, b)])


def test_deep_repeats_walk_many_lce_rounds():
    """A periodic text keeps lanes alive for many ladder rounds and
    compactions; a few specials cut the repeats."""
    text = np.tile(np.array([0, 1, 2, 1], np.uint8), 600)
    text[[500, 1700]] = 254
    suf, lcp = tsort.suf_lcp_host(text, 4, device="cpu")
    jsuf, jlcp = jsort.suf_lcp_host(text, 4)
    np.testing.assert_array_equal(suf, jsuf)
    np.testing.assert_array_equal(lcp, jlcp)


def test_msb_matches_popcount_of_smear():
    """torch has no popcount: msb() replaces
    population_count(smear(x)) - 1 exactly, at 0 and at 2^k - 1, 2^k
    and 2^k + 1 for every k."""
    xs = [0]
    for k in range(31):
        xs += [(1 << k) - 1, 1 << k, (1 << k) + 1]
    xs = np.array([x for x in xs if x < 2**31], np.int64).astype(np.int32)
    got = tsort.msb(torch.from_numpy(xs)).numpy()
    want = np.asarray(lax.population_count(jsort._smear(jnp.asarray(xs)))
                      - 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, [int(x).bit_length() - 1 for x in xs])


@pytest.mark.parametrize("name", ["ties_on_key2", "allsame", "protein"])
def test_initial_phase_ranks_equal_jax(name):
    """One combined int64 key replaces the two-key unstable lax.sort.
    Tie order inside a group may differ, but the group-start ranks and
    the active slots must not."""
    if name == "ties_on_key2":
        # many equal regular prefixes that end at a special: key1 ties,
        # key2 (the special's position) decides
        text = np.tile(np.array([1, 2, 254], np.uint8), 50)
        sigma = 4
    elif name == "allsame":
        text = np.full(97, 3, np.uint8)
        sigma = 4
    else:
        text = _text("protein", None)
        sigma = 20
    n = text.size
    bits, D = jsort.sort_pack_params(sigma)
    sa, rank, rbs, act = tsort._initial_phase(torch.from_numpy(text), n,
                                              sigma, bits, D)
    jsa, jrank, jrbs, jact = jsort._initial_phase(jnp.asarray(text), n,
                                                  sigma, bits, D)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    np.testing.assert_array_equal(rbs.numpy(), np.asarray(jrbs))
    np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
    # the suffixes of each group may come in another order, but not
    # across groups
    np.testing.assert_array_equal(np.asarray(jrank)[sa.numpy()],
                                  np.asarray(jrbs))


@pytest.mark.parametrize("k", [10, 2**31 - 5])
def test_doubling_round_equals_jax(k):
    """One doubling round from the initial phase; k near 2^31 checks
    the int32 wrap guard (pk >= p in JAX, int64 offsets in the port)."""
    text = random_dna_text(np.random.default_rng(3), 400, n_wild=4)
    n = text.size
    bits, D = jsort.sort_pack_params(4)
    jsa, jrank, jrbs, _ = jsort._initial_phase(jnp.asarray(text), n, 4,
                                               bits, D)
    slots = np.arange(n, dtype=np.int32)
    jout = jsort._doubling_round(jrank + 0, jnp.asarray(slots), jsa, jrbs,
                                 jnp.int32(k), n, n)
    tout = tsort._doubling_round(
        torch.from_numpy(np.array(jrank)), torch.from_numpy(slots),
        torch.from_numpy(np.array(jsa)), torch.from_numpy(np.array(jrbs)),
        k, n)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    assert tout[4] == int(jout[4])


def test_lce_tables_equal_jax():
    text = random_dna_text(np.random.default_rng(4), 257, n_wild=9,
                           n_sep=3)
    for sigma in (4, 20):
        bits, D = jsort.lce_pack_params(sigma)
        got = tsort._lce_tables(torch.from_numpy(text), text.size, bits, D)
        want = jsort._lce_tables(jnp.asarray(text), text.size, bits, D)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

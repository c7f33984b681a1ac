"""Port vs JAX package: ESA build, derived tables, skip table and the
ESA wrapper (vstree_tpu_torch/index/{build,esa}.py).

Inputs are made with numpy from a seed; every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dna_text

from vstree_tpu.core.alphabet import dna_alphabet, protein_alphabet
from vstree_tpu.core.multiseq import read_multiseq
from vstree_tpu.index import build as jbuild
from vstree_tpu_torch.index import build as tbuild
from vstree_tpu_torch.index.esa import ESA

TABLES = ("suftab", "lcptab", "bwttab", "bcktab", "stitab", "skptab")
DEMAND = ("suf", "lcp", "bwt", "bck", "sti", "skp")


def write_fasta(path, rng, letters, nseq, length, wild=b"N", nwild=0):
    recs = []
    for i in range(nseq):
        alphabet = np.frombuffer(letters, np.uint8)
        s = bytearray(alphabet[rng.integers(0, alphabet.size, length)])
        for p in rng.choice(length, size=nwild, replace=False):
            s[p] = wild[0]
        lines = [bytes(s[j:j + 60]) for j in range(0, len(s), 60)]
        recs.append(b">seq%d some description\n" % i + b"\n".join(lines))
    path.write_bytes(b"\n".join(recs) + b"\n")
    return str(path)


@pytest.mark.parametrize("kind", ["dna", "protein"])
def test_build_esa_equals_jax(tmp_path, kind):
    rng = np.random.default_rng(21)
    if kind == "dna":
        alpha = dna_alphabet()
        fa = write_fasta(tmp_path / "x.fna", rng, b"acgt", 5, 900,
                         nwild=7)
    else:
        alpha = protein_alphabet()
        fa = write_fasta(tmp_path / "x.fna", rng,
                         b"ACDEFGHIKLMNPQRSTVWY", 4, 500, wild=b"X",
                         nwild=5)
    ms = read_multiseq([fa], alpha)
    got = tbuild.build_esa(ms, alpha, demand=DEMAND, device="cpu")
    want = jbuild.build_esa(ms, alpha, demand=DEMAND)
    assert isinstance(got, ESA)
    for name in TABLES:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for attr in ("prefixlength", "longest", "maxbranchdepth",
                 "largelcpvalues"):
        assert getattr(got, attr) == getattr(want, attr), attr


def test_build_esa_demand_subsets_equal_jax():
    text = random_dna_text(np.random.default_rng(5), 600, n_wild=5,
                           n_sep=3)
    from vstree_tpu.core.multiseq import Multiseq

    ms = Multiseq(sequence=text, totallength=text.size)
    alpha = dna_alphabet()
    for demand in (("suf",), ("suf", "skp"), ("suf", "bwt", "bck")):
        got = tbuild.build_esa(ms, alpha, demand=demand, device="cpu")
        want = jbuild.build_esa(ms, alpha, demand=demand)
        for name in TABLES:
            g, w = getattr(got, name), getattr(want, name)
            assert (g is None) == (w is None), (demand, name)
            if g is not None:
                np.testing.assert_array_equal(g, w, err_msg=name)
        assert got.maxbranchdepth == want.maxbranchdepth


def _skip_brute(lcp):
    n = lcp.size
    want = np.empty(n, np.int64)
    for i in range(n):
        j = i + 1
        while j < n and lcp[j] >= lcp[i]:
            j += 1
        want[i] = j - 1 if j < n else n - 1
    return want


def _adversarial_lcps():
    cases = [
        np.concatenate([[0], np.full(5000, 7, np.int32), [0]]),
        np.concatenate([[0], np.arange(1, 3000, dtype=np.int32), [0]]),
        np.zeros(777, np.int32),
    ]
    st = np.tile(np.array([3, 3, 3, 3, 2, 5, 5, 5, 1], np.int32), 400)
    st[0] = 0
    st[-1] = 0
    cases.append(st)
    return [c.astype(np.int32) for c in cases]


@pytest.mark.parametrize("case", range(4))
def test_skip_table_adversarial(case):
    """The adversarial cases of test_device_engines (where the JAX
    skip_table meets them), against brute force."""
    lcp = _adversarial_lcps()[case]
    got = tbuild.skip_table(lcp, device="cpu")
    np.testing.assert_array_equal(got, _skip_brute(lcp))


def test_skip_table_tiny():
    for lcp in (np.zeros(1, np.int32), np.array([0, 2], np.int32)):
        np.testing.assert_array_equal(tbuild.skip_table(lcp, device="cpu"),
                                      jbuild.skip_table(lcp))


def test_lcp_round_equals_jax():
    text = random_dna_text(np.random.default_rng(6), 500, n_wild=6)
    rng = np.random.default_rng(7)
    a = rng.integers(0, 500, 64).astype(np.int32)
    b = rng.integers(0, 500, 64).astype(np.int32)
    b[:8] = a[:8]
    lcp0 = np.zeros(64, np.int32)
    act0 = np.ones(64, bool)
    jl, ja = jbuild._lcp_round(jnp.asarray(text), jnp.asarray(a),
                               jnp.asarray(b), jnp.asarray(lcp0),
                               jnp.asarray(act0), 32, 500)
    tl, ta = tbuild._lcp_round(torch.from_numpy(text), torch.from_numpy(a),
                               torch.from_numpy(b), torch.from_numpy(lcp0),
                               torch.from_numpy(act0), 32, 500)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_numpy_tables_and_lcp_table_equal_jax():
    text = random_dna_text(np.random.default_rng(8), 800, n_wild=15,
                           n_sep=6)
    suf, _ = tbuild.suffix_sort(text, 4, device="cpu")
    np.testing.assert_array_equal(
        tbuild.lcp_table(text, suf, device="cpu"),
        jbuild.lcp_table(text, suf))
    np.testing.assert_array_equal(tbuild.bwt_table(text, suf),
                                  jbuild.bwt_table(text, suf))
    for pl in (1, 3, 5):
        np.testing.assert_array_equal(tbuild.bck_table(text, 4, pl),
                                      jbuild.bck_table(text, 4, pl))
    for f in (tbuild.recommended_prefixlength,
              tbuild.maximal_prefixlength):
        jf = getattr(jbuild, f.__name__)
        for nc, tl in ((4, 10), (4, 10**6), (20, 5000), (4, 16 * 10**6)):
            assert f(nc, tl) == jf(nc, tl)


def test_from_shared_keeps_caches_apart():
    """ESA.from_shared wraps a JAX-built ESA: the same NumPy tables,
    torch device views in the port's own cache, and the shared
    _device_cache left alone."""
    text = random_dna_text(np.random.default_rng(9), 3000, n_wild=8,
                           n_sep=4)
    from vstree_tpu.core.multiseq import Multiseq

    ms = Multiseq(sequence=text, totallength=text.size)
    jesa = jbuild.build_esa(ms, dna_alphabet(), demand=DEMAND)
    esa = ESA.from_shared(jesa, "cpu")
    assert esa.suftab is jesa.suftab and esa.dev == torch.device("cpu")
    for depth in (3, 6):
        th1, th2 = esa.rank_words_host(depth)
        jh1, jh2 = jesa.rank_words_host(depth)
        np.testing.assert_array_equal(th1, jh1)
        np.testing.assert_array_equal(th2, jh2)
        t1, t2 = esa.rank_words(depth)
        assert t1.shape == (th1.size // 128, 128)
        np.testing.assert_array_equal(t1.numpy().reshape(-1), jh1)
        np.testing.assert_array_equal(
            esa.rank_keys(depth, 2).numpy(),
            np.asarray(jesa.rank_keys(depth, 2)))
        np.testing.assert_array_equal(esa.aux_bck(depth),
                                      jesa.aux_bck(depth))
        assert esa.aux_bck_maxwidth(depth) == jesa.aux_bck_maxwidth(depth)
        np.testing.assert_array_equal(esa.aux_bck_device(depth).numpy(),
                                      np.asarray(jesa.aux_bck_device(depth)))
    for name in ("text", "suftab", "lcptab"):
        assert isinstance(esa.device(name), torch.Tensor)
        np.testing.assert_array_equal(esa.device(name).numpy(),
                                      getattr(jesa, name))
    assert all(not isinstance(v, torch.Tensor)
               for v in jesa._device_cache.values())
    assert esa._device_cache == {}
    with pytest.raises(ValueError, match="no device"):
        ESA(multiseq=ms, alpha=jesa.alpha, suftab=jesa.suftab).device("text")

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


def _special_text(kind, n, seed):
    """Random text with wildcards and separators, among them runs, a
    special at both ends and one just before the end."""
    rng = np.random.default_rng(seed)
    sigma = 4 if kind == "dna" else 20
    text = rng.integers(0, sigma, n).astype(np.uint8)
    if n >= 40:
        text[rng.choice(n, n // 40, replace=False)] = 254
        text[rng.choice(n, n // 80, replace=False)] = 255
        text[n // 2:n // 2 + 3] = 255
        text[0] = 254
        text[-2] = 255
    return text, sigma


@pytest.mark.parametrize("kind,pl", [("dna", d) for d in range(1, 11)]
                         + [("protein", d) for d in range(1, 5)])
def test_device_bucket_table_equals_jax(kind, pl):
    """bucket_codes_device / bck_table_device (run on the CPU device)
    against the JAX package's NumPy functions and the port's own NumPy
    twins; exact."""
    text, sigma = _special_text(kind, 3000, 40 + pl)
    tt = torch.from_numpy(text)
    code, depth = tbuild.bucket_codes_device(tt, sigma, pl)
    jcode, jdepth = jbuild.bucket_codes(text, sigma, pl)
    assert code.dtype == torch.int32
    np.testing.assert_array_equal(code.numpy(), jcode)
    np.testing.assert_array_equal(depth.numpy(), jdepth)
    got = tbuild.bck_table_device(tt, sigma, pl)
    assert got.dtype == torch.int64 and got.shape == (2 * sigma ** pl,)
    want = jbuild.bck_table(text, sigma, pl)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(tbuild.bck_table(text, sigma, pl), want)


@pytest.mark.parametrize("n", [0, 1, 2, 9])
def test_device_bucket_table_tiny_texts(n):
    """The empty text and texts shorter than the prefix length."""
    for kind in ("dna", "protein"):
        text, sigma = _special_text(kind, n, n)
        if n == 9:
            text[4] = 255
        for pl in (1, 3, 4):
            code, depth = tbuild.bucket_codes_device(
                torch.from_numpy(text), sigma, pl)
            jcode, jdepth = jbuild.bucket_codes(text, sigma, pl)
            np.testing.assert_array_equal(code.numpy(), jcode)
            np.testing.assert_array_equal(depth.numpy(), jdepth)
            np.testing.assert_array_equal(
                tbuild.bck_table_device(torch.from_numpy(text), sigma,
                                        pl).numpy().astype(np.uint32),
                jbuild.bck_table(text, sigma, pl))
    with pytest.raises(ValueError, match="int32"):
        tbuild.bucket_codes_device(torch.from_numpy(text), 20, 8)


def test_from_shared_keeps_caches_apart():
    """ESA.from_shared takes over a JAX-built ESA by field name: the
    same NumPy tables, torch device views in the port's only cache
    (_torch_cache), the JAX object's _device_cache left alone, and no
    class of the JAX package among the port's bases."""
    text = random_dna_text(np.random.default_rng(9), 3000, n_wild=8,
                           n_sep=4)
    from vstree_tpu.core.multiseq import Multiseq

    ms = Multiseq(sequence=text, totallength=text.size)
    jesa = jbuild.build_esa(ms, dna_alphabet(), demand=DEMAND)
    esa = ESA.from_shared(jesa, "cpu")
    assert esa.suftab is jesa.suftab and esa.dev == torch.device("cpu")
    for depth in (3, 6):
        np.testing.assert_array_equal(
            esa.rank_keys(depth, 2).numpy(),
            np.asarray(jesa.rank_keys(depth, 2)))
        np.testing.assert_array_equal(esa.aux_bck(depth),
                                      jesa.aux_bck(depth))
        assert esa.aux_bck_maxwidth(depth) == jesa.aux_bck_maxwidth(depth)
        np.testing.assert_array_equal(esa.aux_bck_device(depth).numpy(),
                                      np.asarray(jesa.aux_bck_device(depth)))
    assert not hasattr(esa, "rank_words")  # no per-rank key-word table
    assert esa.aux_bck(3).dtype == np.uint32
    assert esa.device_suf32() is esa.device("suftab")
    wide = ESA.from_shared(jesa, "cpu")
    wide.suftab = jesa.suftab.astype(np.int64)  # as read from disk
    assert wide.device_suf32().dtype == torch.int32
    np.testing.assert_array_equal(wide.device_suf32().numpy(), jesa.suftab)
    for name in ("text", "suftab", "lcptab"):
        assert isinstance(esa.device(name), torch.Tensor)
        np.testing.assert_array_equal(esa.device(name).numpy(),
                                      getattr(jesa, name))
    assert all(not isinstance(v, torch.Tensor)
               for v in jesa._device_cache.values())
    assert not hasattr(esa, "_device_cache")
    assert all(c.__module__.startswith("vstree_tpu_torch.") or c is object
               for c in type(esa).__mro__)
    with pytest.raises(ValueError, match="no device"):
        ESA(multiseq=ms, alpha=jesa.alpha, suftab=jesa.suftab).device("text")

"""Port vs JAX package: the out-of-core index build.

``core/encseq.py`` (a copy) packs and decodes like the original;
``index/merge.py`` merges separately sorted parts with its cross counts
on torch tensors (here CPU tensors) and gives the JAX merge's suffix
table and text; ``build_suf_out_of_core`` gives the JAX function's and
the monolithic build's tables.  Every comparison is exact.  The texts
hold wildcard runs at part ends and repeated records whose suffixes
reach a special at the same offset, so the LCE ladder's stop at a
special and the tie of two specials (the earlier part first) decide
many probes.
"""

import numpy as np
import pytest
import torch

from vstree_tpu.core.alphabet import dna_alphabet as j_dna_alphabet
from vstree_tpu.core.encseq import Encodedsequence as JEncodedsequence
from vstree_tpu.core.multiseq import Multiseq as JMultiseq
from vstree_tpu.index import build as jbuild
from vstree_tpu.index import merge as jmerge
from vstree_tpu_torch.core.alphabet import dna_alphabet
from vstree_tpu_torch.core.encseq import Encodedsequence
from vstree_tpu_torch.core.multiseq import Multiseq
from vstree_tpu_torch.index import build as tbuild
from vstree_tpu_torch.index import merge as tmerge

WILD, SEP = 254, 255


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The merge loops over small torch ops: one thread per worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("n", [0, 1, 5, 63, 64, 1000])
def test_encodedsequence_same_as_jax(n):
    rng = np.random.default_rng(5 + n)
    t = rng.integers(0, 4, n).astype(np.uint8)
    if n > 10:
        t[rng.choice(n, max(1, n // 37), replace=False)] = \
            rng.choice([WILD, SEP], max(1, n // 37))
    want, got = JEncodedsequence(t), Encodedsequence(t)
    assert got.n == want.n and got.nbytes == want.nbytes
    for f in ("packed", "raw", "spec_pos", "spec_code"):
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_array_equal(got.decode(), t)
    for a, b in ((0, 5), (3, 9), (1, n), (max(n - 7, 0), n), (2, 2)):
        np.testing.assert_array_equal(got.decode(a, b), want.decode(a, b))


def test_encodedsequence_protein_is_stored_direct():
    prot = np.random.default_rng(1).integers(0, 20, 100).astype(np.uint8)
    want, got = JEncodedsequence(prot), Encodedsequence(prot)
    assert got.packed is None is want.packed
    np.testing.assert_array_equal(got.decode(10, 40), want.decode(10, 40))


def _texts(kind: str, k: int, rng) -> list[np.ndarray]:
    """Part texts of one kind: ``random`` (wildcards sprinkled, N runs
    at both ends of each part), ``repeated`` (one record and its copies
    with N runs at the same offsets), ``tiny`` (a part of one symbol
    among long ones), ``allwild`` (a part that is all wildcards)."""
    base = rng.integers(0, 4, 700).astype(np.uint8)
    base[[100, 350, 351, 600]] = WILD
    out = []
    for i in range(k):
        if kind == "repeated":
            t = base.copy()
            t[rng.integers(0, 700, 3)] = rng.integers(0, 4, 3)
        else:
            n = int(rng.integers(200, 1500))
            t = rng.integers(0, 4, n).astype(np.uint8)
            t[rng.choice(n, max(1, n // 150), replace=False)] = WILD
            t[:int(rng.integers(0, 4))] = WILD
            t[n - int(rng.integers(1, 6)):] = WILD
        out.append(t)
    if kind == "tiny":
        out[1] = np.array([2], np.uint8)
    elif kind == "allwild":
        out[k // 2] = np.full(40, WILD, np.uint8)
    return out


def _part(ms_cls, t, build):
    ms = ms_cls(sequence=t, markpos=np.zeros(0, np.int64))
    ms.totallength = int(t.size)
    return build(ms)


def _monolithic(texts):
    cat = []
    for i, t in enumerate(texts):
        cat.append(t)
        if i < len(texts) - 1:
            cat.append(np.full(1, SEP, np.uint8))
    gtext = np.concatenate(cat)
    suf, _ = tbuild.suffix_sort(gtext, sigma=4, device="cpu")
    return np.asarray(suf, np.int64), gtext


@pytest.mark.parametrize("kind", ["random", "repeated", "tiny", "allwild"])
@pytest.mark.parametrize("k", [2, 3, 5])
def test_merge_same_as_jax(kind, k):
    texts = _texts(kind, k, np.random.default_rng(k * 10 + len(kind)))
    want = jmerge.merge_indexes([
        _part(JMultiseq, t, lambda ms: jbuild.build_esa(
            ms, j_dna_alphabet(), demand=("suf",))) for t in texts])
    got = tmerge.merge_indexes([
        _part(Multiseq, t, lambda ms: tbuild.build_esa(
            ms, dna_alphabet(), demand=("suf",), device="cpu"))
        for t in texts], device="cpu")
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    suf, gtext = _monolithic(texts)
    np.testing.assert_array_equal(got[0], suf)
    np.testing.assert_array_equal(got[1], gtext)


@pytest.mark.parametrize("a_first", [True, False])
@pytest.mark.parametrize("kind", ["random", "repeated"])
def test_cross_counts_same_as_numpy(kind, a_first):
    """The departure itself: the counts of one ordered pair of parts on
    torch tensors equal the JAX module's NumPy windows."""
    ta, tb = _texts(kind, 2, np.random.default_rng(3))
    sa = tbuild.suffix_sort(ta, sigma=4, device="cpu")[0][:-1]
    sb = tbuild.suffix_sort(tb, sigma=4, device="cpu")[0][:-1]
    reg = sa[ta[sa] < WILD].astype(np.int64)
    want = jmerge._cross_counts(ta, reg, tb, sb, a_first)
    got = tmerge._cross_counts(ta, reg, tb, sb, a_first, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert 0 < got.max() <= sb.size


def _records(rng, nrec: int, wild_ends: bool) -> list[np.ndarray]:
    recs = []
    for i in range(nrec):
        n = int(rng.integers(50, 700))
        r = rng.integers(0, 4, n).astype(np.uint8)
        r[rng.choice(n, max(1, n // 120), replace=False)] = WILD
        if wild_ends and i % 3 == 0:
            r[-int(rng.integers(1, 8)):] = WILD
        if i % 7 == 3 and i > 0:          # a repeat of an earlier record
            src = recs[i - 1]
            r = src.copy()
        recs.append(r)
    return recs


def _multiseq(cls, recs):
    seq = np.concatenate(sum(([r, np.full(1, SEP, np.uint8)]
                              for r in recs), [])[:-1])
    ms = cls(sequence=seq, totallength=int(seq.size))
    ms.markpos = np.flatnonzero(seq == SEP).astype(np.int64)
    ms.numofsequences = len(recs)
    ms.descriptions = [f"r{i}".encode() for i in range(len(recs))]
    return ms


@pytest.mark.parametrize("want_lcp", [True, False])
@pytest.mark.parametrize("max_shard_bp", [1500, 4000])
def test_out_of_core_same_as_jax_and_monolithic(max_shard_bp, want_lcp):
    recs = _records(np.random.default_rng(max_shard_bp), 30, True)
    suf, lcp = tbuild.build_suf_out_of_core(
        _multiseq(Multiseq, recs), dna_alphabet(), max_shard_bp, want_lcp,
        device="cpu")
    jsuf, jlcp = jbuild.build_suf_out_of_core(
        _multiseq(JMultiseq, recs), j_dna_alphabet(), max_shard_bp,
        want_lcp)
    np.testing.assert_array_equal(suf, jsuf)
    assert suf.dtype == jsuf.dtype
    mono = tbuild.build_esa(_multiseq(Multiseq, recs), dna_alphabet(),
                            demand=("suf", "lcp"), device="cpu")
    np.testing.assert_array_equal(suf, mono.suftab)
    if want_lcp:
        np.testing.assert_array_equal(lcp, jlcp)
        np.testing.assert_array_equal(lcp, mono.lcptab)
        assert lcp.dtype == jlcp.dtype
    else:
        assert lcp is None is jlcp


@pytest.mark.parametrize("want_lcp", [True, False])
def test_out_of_core_single_sequence(want_lcp):
    rec = _records(np.random.default_rng(9), 1, True)
    suf, lcp = tbuild.build_suf_out_of_core(
        _multiseq(Multiseq, rec), dna_alphabet(), 100, want_lcp,
        device="cpu")
    jsuf, jlcp = jbuild.build_suf_out_of_core(
        _multiseq(JMultiseq, rec), j_dna_alphabet(), 100, want_lcp)
    np.testing.assert_array_equal(suf, jsuf)
    if want_lcp:
        np.testing.assert_array_equal(lcp, jlcp)
    else:
        assert lcp is None is jlcp


def test_out_of_core_refuses_a_changed_join(monkeypatch):
    """The text-identity check: a merge that does not give the input
    text back fails loudly."""
    recs = _records(np.random.default_rng(2), 6, False)
    real = tmerge.merge_indexes

    def broken(parts, *, device):
        suf, gtext = real(parts, device=device)
        gtext = gtext.copy()
        gtext[0] ^= 1
        return suf, gtext

    monkeypatch.setattr(tmerge, "merge_indexes", broken)
    with pytest.raises(AssertionError, match="does not reproduce"):
        tbuild.build_suf_out_of_core(_multiseq(Multiseq, recs),
                                     dna_alphabet(), 1000, device="cpu")


def test_lcp_pass_chunks_agree():
    """The lcp pass in chunks of 7 pairs equals one run over all pairs."""
    recs = _records(np.random.default_rng(4), 5, True)
    ms = _multiseq(Multiseq, recs)
    suf, _ = tbuild.suffix_sort(ms.sequence, sigma=4, device="cpu")
    n = ms.sequence.size
    a, b = suf[:n - 1], suf[1:n]
    whole = tbuild._lcp_pairs_device_chunked(ms.sequence, a, b, 4,
                                             device="cpu")
    small = tbuild._lcp_pairs_device_chunked(ms.sequence, a, b, 4,
                                             device="cpu", chunk=7)
    np.testing.assert_array_equal(small, whole)
    np.testing.assert_array_equal(
        whole, jbuild._lcp_pairs_host_chunked(ms.sequence, a, b))

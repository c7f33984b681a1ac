"""Port vs JAX package: the self-match engines
(vstree_tpu_torch/engine/{repeats,repeats_dev,supermax,tandem,mumself}.py
vs their originals), ``vmatch -l``, ``-supermax``, ``-tandem``, ``-mum``.

The same NumPy tables go through both packages; rank pairs, depths and
every ``MatchTable`` column must be equal, in order (tolerance 0).  The
torch program of ``repeats_dev`` runs on CPU tensors here; the JAX one
runs as ``tests/test_device_engines.py`` runs it.
"""

import numpy as np
import pytest
import torch

from vstree_tpu.core.alphabet import dna_alphabet, protein_alphabet
from vstree_tpu.core.multiseq import Multiseq
from vstree_tpu.engine import mumself as jmumself
from vstree_tpu.engine import repeats as jrepeats
from vstree_tpu.engine import repeats_dev as jrepeats_dev
from vstree_tpu.engine import supermax as jsupermax
from vstree_tpu.engine import tandem as jtandem
from vstree_tpu.index.build import build_esa
from vstree_tpu_torch.engine import mumself as tmumself
from vstree_tpu_torch.engine import repeats as trepeats
from vstree_tpu_torch.engine import repeats_dev as trepeats_dev
from vstree_tpu_torch.engine import supermax as tsupermax
from vstree_tpu_torch.engine import tandem as ttandem
from vstree_tpu_torch.index.esa import ESA

FIELDS = ("length1", "position1", "length2", "position2", "distance",
          "flag", "seqnum1", "relpos1", "seqnum2", "relpos2", "evalue",
          "idnumber", "transnum")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's loops issue thousands of small ops; a thread pool per
    test worker only makes the workers of one host wait for each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _text(sigma: int, n: int, seed: int) -> np.ndarray:
    """Random text with two diverged repeat families, a tandem array,
    wildcards and separators."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, sigma, n).astype(np.uint8)
    for _ in range(2):
        ln = int(rng.integers(60, 140))
        elem = rng.integers(0, sigma, ln).astype(np.uint8)
        for _ in range(6):
            copy = elem.copy()
            at = rng.choice(ln, 3, replace=False)
            copy[at] = rng.integers(0, sigma, 3)
            st = int(rng.integers(0, n - ln))
            text[st:st + ln] = copy
    unit = rng.integers(0, sigma, 9).astype(np.uint8)
    st = int(rng.integers(0, n - 80))
    text[st:st + 72] = np.tile(unit, 8)
    text[rng.choice(n, 8, replace=False)] = 254
    text[rng.choice(n, 3, replace=False)] = 255
    return text


def _index(text, alpha, nquery: int = 0):
    ms = Multiseq(sequence=text, totallength=text.size)
    ms.markpos = np.flatnonzero(text == 255).astype(np.uint32)
    ms.numofsequences = ms.markpos.size + 1
    if nquery:
        ms.numofquerysequences = nquery
        qstart = int(ms.markpos[ms.numofsequences - nquery - 1]) + 1
        ms.totalquerylength = text.size - qstart
    jesa = build_esa(ms, alpha, demand=("suf", "lcp", "bwt", "bck", "sti"))
    return jesa, ESA.from_shared(jesa, "cpu")


@pytest.fixture(scope="module")
def dna():
    return _index(_text(4, 4000, 21), dna_alphabet())


@pytest.fixture(scope="module")
def protein():
    return _index(_text(20, 3000, 22), protein_alphabet())


def _assert_tables_equal(got, want):
    assert len(got) == len(want)
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("L", [3, 5, 8])
@pytest.mark.parametrize("kind", ["dna", "protein"])
def test_maximal_pairs_device_reference_order(kind, L, request):
    jesa, tesa = request.getfixturevalue(kind)
    L = L if kind == "dna" else L - 1
    want = jrepeats_dev.maximal_pairs_device(jesa, L, ref_order=True)
    got = trepeats_dev.maximal_pairs_device(tesa, L, ref_order=True)
    assert want[0].size >= 50
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    sim = jrepeats.find_maximal_pairs_ref_sim(jesa, L)
    _assert_tables_equal(trepeats.find_maximal_pairs_ref(tesa, L), sim)
    _assert_tables_equal(trepeats.find_maximal_pairs_ref_sim(tesa, L), sim)


@pytest.mark.parametrize("kind", ["dna", "protein"])
def test_maximal_pairs_device_unordered(kind, request):
    jesa, tesa = request.getfixturevalue(kind)
    want = jrepeats_dev.maximal_pairs_device(jesa, 4, ref_order=False)
    got = trepeats_dev.maximal_pairs_device(tesa, 4, ref_order=False)
    for g, w in zip(got, want):     # both enumerate run-major, (i, j)
        np.testing.assert_array_equal(g, w)
    ordered = trepeats_dev.maximal_pairs_device(tesa, 4, ref_order=True)
    assert sorted(zip(*map(list, got))) == sorted(zip(*map(list, ordered)))
    assert not np.array_equal(got[1], ordered[1])


def _largest_run_pairs(esa, L):
    left, right = trepeats._l_runs(esa.lcptab, L)
    m = right - left + 1
    return int(((m * (m - 1)) // 2).max())


@pytest.mark.parametrize("L", [2, 4])
def test_results_do_not_depend_on_the_pair_chunk(dna, monkeypatch, L):
    """A chunk as small as the largest run allows: many chunks, borders
    on run boundaries, one transfer of the counts."""
    _, tesa = dna
    want = trepeats_dev.maximal_pairs_device(tesa, L)
    calls = []
    real = trepeats_dev._pairs_phase1
    monkeypatch.setattr(trepeats_dev, "_pairs_phase1",
                        lambda *a: calls.append(a[3]) or real(*a))
    monkeypatch.setattr(trepeats_dev, "_PAIR_CHUNK",
                        _largest_run_pairs(tesa, L))
    got = trepeats_dev.maximal_pairs_device(tesa, L)
    assert len(calls) > 10 and max(calls) <= 2 * trepeats_dev._PAIR_CHUNK
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    parts = trepeats_dev.maximal_pairs_device(tesa, L, device_out=True)
    assert len(parts[0]) > 5
    np.testing.assert_array_equal(torch.cat(parts[0]).numpy(), want[0])


def test_chunk_bounds_equal_the_walk_over_the_runs(monkeypatch):
    """``_chunk_bounds`` finds the borders that ``_iter_pair_chunks``
    of both packages walks to."""
    rng = np.random.default_rng(6)
    for chunk in (1, 7, 60, 500, 10**6):
        monkeypatch.setattr(trepeats_dev, "_PAIR_CHUNK", chunk)
        monkeypatch.setattr(jrepeats, "_PAIR_CHUNK", chunk)
        for _ in range(20):
            m = rng.integers(2, 14, int(rng.integers(1, 60)))
            left = np.cumsum(m + 1) - m
            bounds = trepeats_dev._chunk_bounds((m * (m - 1)) // 2)
            sizes = [lch.size for lch, _ in
                     jrepeats._iter_pair_chunks(left, m)]
            assert np.diff(bounds).tolist() == sizes


def test_pathological_run_guard(dna, monkeypatch):
    """A run of more pairs than ``_PAIR_CHUNK`` goes to the NumPy path
    (the reference's rule), and the device-output variants say so."""
    jesa, tesa = dna
    calls = []
    real = trepeats.maximal_pairs_ref_order_vec
    monkeypatch.setattr(trepeats, "maximal_pairs_ref_order_vec",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(trepeats_dev, "_PAIR_CHUNK",
                        _largest_run_pairs(tesa, 4) - 1)
    got = trepeats_dev.maximal_pairs_device(tesa, 4)
    assert calls == [1]
    for g, w in zip(got, jrepeats.maximal_pairs_ref_order_vec(jesa, 4)):
        np.testing.assert_array_equal(g, w)
    assert trepeats_dev.maximal_pairs_device(tesa, 4, device_out=True) is None
    assert trepeats_dev.maximal_pairs_device_seeds(tesa, 4) is None
    assert trepeats_dev.maximal_pairs_device_positions(tesa, 4) is None


def test_device_positions_and_seeds(dna):
    jesa, tesa = dna
    (jlo, jhi, jd), jcount = jrepeats_dev.maximal_pairs_device_positions(
        jesa, 5)
    (lo, hi, d), count = trepeats_dev.maximal_pairs_device_positions(tesa, 5)
    assert count == jcount > 50
    for g, w in ((lo, jlo), (hi, jhi), (d, jd)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    (slo, shi, sd, ri, rj), scount = trepeats_dev.maximal_pairs_device_seeds(
        tesa, 5)
    assert scount == count
    assert sorted(zip(slo.tolist(), shi.tolist(), sd.tolist())) \
        == sorted(zip(lo.tolist(), hi.tolist(), d.tolist()))
    # the emission order of a subset is the subset of the emission order
    lcp = tesa.device_lcp32()
    left, right = trepeats._l_runs(tesa.lcptab, 5)
    steps = trepeats_dev._rmq_levels(int((right - left + 1).max()))
    rmq = trepeats_dev._rmq_build(lcp, steps)
    keep = torch.arange(0, scount, 3)
    order = trepeats_dev._emission_order(
        rmq, tesa.device("bwttab"), ri[keep], rj[keep], sd[keep], steps, 4)
    sub = list(zip(slo[keep][order].tolist(), shi[keep][order].tolist()))
    full = list(zip(lo.tolist(), hi.tolist()))
    assert sub == [p for p in full if p in set(sub)]
    empty, zero = trepeats_dev.maximal_pairs_device_seeds(tesa, 3000)
    assert zero == 0 and all(t.numel() == 0 for t in empty)


def test_sparse_table_holds_only_the_levels_of_the_widest_run(
        dna, monkeypatch):
    """The reference builds floor(log2 n1) + 1 levels and lets
    ``_emission_order`` descend through all of them, which overflows
    int32 at n1 > 2^30; the port builds, and descends through, the
    levels of the widest run only."""
    _, tesa = dna
    seen = {}
    real_build, real_times = (trepeats_dev._rmq_build,
                              trepeats_dev._event_times)

    def build(lcp, levels):
        seen["levels"] = levels
        return real_build(lcp, levels)

    def times(rmq, rj, d, steps):
        seen["steps"] = steps
        t = real_times(rmq, rj, d, steps)
        seen["reach"] = max(seen.get("reach", 0), int((t - rj).max()))
        return t

    monkeypatch.setattr(trepeats_dev, "_rmq_build", build)
    monkeypatch.setattr(trepeats_dev, "_event_times", times)
    L = 6
    trepeats_dev.maximal_pairs_device(tesa, L)
    left, right = trepeats._l_runs(tesa.lcptab, L)
    maxw = int((right - left + 1).max())
    n1 = tesa.lcptab.size
    assert seen["levels"] == seen["steps"] == maxw.bit_length() + 1
    assert seen["levels"] < int(np.floor(np.log2(n1))) + 1
    assert seen["reach"] < maxw and (1 << seen["steps"]) <= 4 * maxw


def test_rmq_query_equals_a_direct_minimum():
    rng = np.random.default_rng(3)
    lcp = torch.from_numpy(rng.integers(0, 50, 700).astype(np.int32))
    table = trepeats_dev._rmq_build(lcp, 6)
    assert table.shape == (6, 700) and table.dtype == torch.int32
    lo = torch.from_numpy(rng.integers(0, 690, 2000))
    hi = torch.minimum(lo + torch.from_numpy(rng.integers(0, 32, 2000)),
                       torch.tensor(699))
    got = trepeats_dev._rmq_query(table, lo, hi)
    want = [int(lcp[a:b + 1].min()) for a, b in zip(lo.tolist(), hi.tolist())]
    assert got.tolist() == want
    # windows past the end count what is there
    assert int(table[5, 690]) == int(lcp[690:].min())


def test_lexsort_equals_numpy_with_ties():
    rng = np.random.default_rng(4)
    keys = [rng.integers(0, r, 3000) for r in (3, 2, 5, 4, 3, 2)]
    got = trepeats_dev._lexsort([torch.from_numpy(k) for k in keys])
    np.testing.assert_array_equal(got.numpy(), np.lexsort(keys))


def test_triangular_decode_is_exact():
    """Every pair of runs of 2..40 ranks, and the first and last pairs
    of each row of a run of 2,897 ranks (4,194,856 pairs: one rank
    wider than the widest run the guard lets through)."""
    kk, pidx, want = [], [], []
    for k in list(range(2, 41)):
        pairs = [(s, t) for s in range(k) for t in range(s + 1, k)]
        kk += [k] * len(pairs)
        pidx += list(range(len(pairs)))
        want += pairs
    k = 2897
    chunk = trepeats_dev._PAIR_CHUNK
    assert (k - 1) * (k - 2) // 2 <= chunk < k * (k - 1) // 2
    for s in range(k - 1):
        first = s * (2 * k - s - 1) // 2
        kk += [k, k]
        pidx += [first, first + (k - s - 2)]
        want += [(s, s + 1), (s, k - 1)]
    s, t = trepeats_dev._triangular_decode(torch.tensor(pidx),
                                           torch.tensor(kk))
    assert list(zip(s.tolist(), t.tolist())) == want


@pytest.mark.parametrize("L", [4, 9])
@pytest.mark.parametrize("kind", ["dna", "protein"])
def test_supermax_and_tandems(kind, L, request):
    jesa, tesa = request.getfixturevalue(kind)
    for g, w in zip(tsupermax.supermax_intervals(tesa, L),
                    jsupermax.supermax_intervals(jesa, L)):
        np.testing.assert_array_equal(g, w)
    want = jsupermax.find_supermax(jesa, L)
    assert len(want) >= 3
    _assert_tables_equal(tsupermax.find_supermax(tesa, L), want)
    want = jtandem.find_tandems_ref(jesa, min(L, 5))
    assert len(want) >= 3
    _assert_tables_equal(ttandem.find_tandems_ref(tesa, min(L, 5)), want)
    _assert_tables_equal(trepeats.find_tandems(tesa, L),
                         jrepeats.find_tandems(jesa, L))
    _assert_tables_equal(trepeats.find_maximal_pairs(tesa, L),
                         jrepeats.find_maximal_pairs(jesa, L))


def test_mum_self():
    text = _text(4, 3000, 23)
    text[text == 255] = 0
    text[[1100, 2100, 2600]] = 255          # db: 2 records, queries: 2
    text[2200:2290] = text[300:390]
    text[2700:2760] = text[1500:1560]
    text[2730] = (text[2730] + 1) % 4
    jesa, tesa = _index(text, dna_alphabet(), nquery=2)
    assert tesa.multiseq.numofquerysequences == 2
    assert tesa.multiseq.database_length == 2100
    for L in (8, 20):
        want = jmumself.find_mum_self(jesa, L)
        assert len(want) >= 2
        _assert_tables_equal(tmumself.find_mum_self(tesa, L), want)
    plain = ESA.from_shared(_index(text, dna_alphabet())[0], "cpu")
    with pytest.raises(ValueError, match="requires at least one query file"):
        tmumself.find_mum_self(plain, 8)


def test_tables_read_wide_go_to_the_device_narrow(dna):
    """An index read from disk holds lcptab as int64; the program reads
    an int32 copy and gives the same pairs."""
    jesa, tesa = dna
    wide = ESA.from_shared(jesa, "cpu")
    wide.lcptab = jesa.lcptab.astype(np.int64)
    wide.suftab = jesa.suftab.astype(np.int64)
    assert wide.device_lcp32().dtype == torch.int32
    assert wide.device_lcp32() is wide.device_lcp32()
    for g, w in zip(trepeats_dev.maximal_pairs_device(wide, 5),
                    trepeats_dev.maximal_pairs_device(tesa, 5)):
        np.testing.assert_array_equal(g, w)

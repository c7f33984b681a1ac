"""The port's snapshot sort, snapshot LCE and matching statistics
(``vstree_tpu_torch/index/sort.py``, ``engine/mstats.py``) against the
JAX package, exact, on the CPU.

Where the JAX package's fault F1 bites (``lce_with_snapshots`` with a
capped snapshot list returns an lce that ends inside the next packed
word short), the port is held to ``tests/oracle/naive.py`` instead.
"""

import numpy as np
import pytest
import torch

from conftest import random_dna_text
from oracle.naive import naive_lcp

from vstree_tpu.core.alphabet import dna_alphabet as j_dna
from vstree_tpu.core.alphabet import protein_alphabet as j_protein
from vstree_tpu.core.multiseq import Multiseq as JMultiseq
from vstree_tpu.engine import mstats as jmstats
from vstree_tpu.index import sort as jsort
from vstree_tpu.index.build import build_esa as j_build_esa
from vstree_tpu_torch.device import PhaseTimes, record_phases
from vstree_tpu_torch.engine import mstats as tmstats
from vstree_tpu_torch.index import sort as tsort
from vstree_tpu_torch.index.esa import ESA

import jax.numpy as jnp


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's loops issue many small ops; a thread pool per test
    worker only makes the workers of one host wait for each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _multiseq(text):
    ms = JMultiseq(sequence=text, totallength=int(text.size))
    ms.markpos = np.flatnonzero(text == 255).astype(np.uint32)
    ms.numofsequences = ms.markpos.size + 1
    ms.descriptions = [b"s%d" % i for i in range(ms.numofsequences)]
    return ms


def _esas(text, alpha):
    jesa = j_build_esa(_multiseq(text), alpha,
                       demand=("suf", "lcp", "bwt", "bck", "sti"))
    return jesa, ESA.from_shared(jesa, "cpu")


def _repeat_text(rng, n, sigma=4, copies=((300, 170),), wild=6, sep=2):
    """Random text with planted copies (source, length) of one block,
    a few wildcards and separators away from the copies."""
    t = rng.integers(0, sigma, n).astype(np.uint8)
    dst = n // 2
    for src, ln in copies:
        t[dst:dst + ln] = t[src:src + ln]
        dst += ln + 50
    t[rng.choice(np.arange(5, 90), wild, replace=False)] = 254
    t[rng.choice(np.arange(n - 200, n - 5), sep, replace=False)] = 255
    return t


def _snaps(text, sigma, cap, monkeypatch):
    monkeypatch.setattr(tsort, "SNAPSHOT_CAP", cap)
    n = int(text.size)
    sa, snaps = tsort.device_suffix_sort(torch.from_numpy(text), n, sigma,
                                         collect_snapshots=True)
    return sa, snaps


@pytest.mark.parametrize("sigma", [4, 20])
def test_snapshots_equal_the_jax_package(sigma, monkeypatch):
    """collect_snapshots: the same suffix array and, level by level, the
    same certified depths and rank arrays; without it the sort is as
    before."""
    rng = np.random.default_rng(7 + sigma)
    text = _repeat_text(rng, 3000, sigma, copies=((100, 400), (900, 250)))
    sa, snaps = _snaps(text, sigma, None, monkeypatch)
    jsa, jsnaps = jsort.device_suffix_sort(jnp.asarray(text), text.size,
                                           sigma, collect_snapshots=True)
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
    assert [k for k, _ in snaps] == [k for k, _ in jsnaps]
    assert len(snaps) >= 5
    for (_, r), (_, jr) in zip(snaps, jsnaps):
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    plain = tsort.device_suffix_sort(torch.from_numpy(text), text.size,
                                     sigma)
    np.testing.assert_array_equal(plain.numpy(), sa.numpy())


def test_snapshot_cap_comes_from_the_module_constant_or_memory(monkeypatch):
    cpu = torch.device("cpu")
    assert tsort.snapshot_cap(10**6, cpu) == int(2e9 // (4 * 10**6))
    assert tsort.snapshot_cap(10**9, cpu) == 4
    monkeypatch.setattr(tsort, "SNAPSHOT_CAP", 2)
    assert tsort.snapshot_cap(10**6, cpu) == 2
    rng = np.random.default_rng(3)
    text = _repeat_text(rng, 2000)
    times = PhaseTimes(cpu)
    with record_phases(times):
        _, snaps = tsort.device_suffix_sort(torch.from_numpy(text), 2000, 4,
                                            collect_snapshots=True)
    assert len(snaps) == 2 and times.counts["snapshot cap"] == 2


def test_capped_snapshot_lce_is_exact_fault_f1(monkeypatch):
    """Fault F1 (vstree_tpu/index/sort.py:334): with the snapshot list
    capped at ks = [10, 20, 40, 80] the descent reaches 150 + 13 chars,
    and an lce of 164-175 ends inside the next packed word.  The JAX
    package returns 163 there; the port finishes such pairs with the
    ladder and equals naive_lcp on every pair."""
    rng = np.random.default_rng(11)
    lens = list(range(164, 176))
    t = rng.integers(0, 4, 12000).astype(np.uint8)
    pairs = []
    for i, ln in enumerate(lens):
        src, dst = 200 + 450 * i, 6200 + 450 * i
        t[dst:dst + ln] = t[src:src + ln]
        t[dst + ln] = (t[src + ln] + 1) % 4         # the lce ends here
        pairs.append((src, dst))
    sa, snaps = _snaps(t, 4, 4, monkeypatch)
    assert [k for k, _ in snaps] == [10, 20, 40, 80]
    a = np.array([p[0] for p in pairs] + list(sa[:-1].numpy()), np.int32)
    b = np.array([p[1] for p in pairs] + list(sa[1:].numpy()), np.int32)
    bits, D = tsort.lce_pack_params(4)
    P = tsort._lce_tables(torch.from_numpy(t), t.size, bits, D)
    got = tsort.lce_with_snapshots(snaps, P, torch.from_numpy(a),
                                   torch.from_numpy(b), t.size, 4).numpy()
    want = np.array([naive_lcp(t, int(x), int(y)) for x, y in zip(a, b)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:len(lens)], lens)
    # the JAX package's capped descent: the same four levels
    _, jsnaps = jsort.device_suffix_sort(jnp.asarray(t), t.size, 4,
                                         collect_snapshots=True)
    jP = jsort._lce_tables(jnp.asarray(t), t.size, bits, D)
    jgot = np.asarray(jsort.lce_with_snapshots(
        jsnaps[:4], jP, jnp.asarray(a[:len(lens)]),
        jnp.asarray(b[:len(lens)]), t.size, 4))
    assert (jgot == 163).all()


@pytest.mark.parametrize("cap", [None, 4])
def test_lce_with_snapshots_equals_naive(cap, monkeypatch):
    """Adjacent suffix pairs of a text with deep repeats, wildcards and
    separators: the descent (with and without a cap) gives the lcp."""
    rng = np.random.default_rng(23)
    t = _repeat_text(rng, 4000, copies=((100, 900), (1200, 333)))
    sa, snaps = _snaps(t, 4, cap, monkeypatch)
    bits, D = tsort.lce_pack_params(4)
    P = tsort._lce_tables(torch.from_numpy(t), t.size, bits, D)
    got = tsort.lce_with_snapshots(snaps, P, sa[:-1], sa[1:], t.size,
                                   4).numpy()
    s = sa.numpy()
    want = np.array([naive_lcp(t, int(x), int(y))
                     for x, y in zip(s[:-1], s[1:])])
    np.testing.assert_array_equal(got, want)
    assert want.max() >= 900


def test_ms_scans_equal_a_loop():
    """The segmented scans (cummax over keyed values, flipped for the
    backward pass) against the JAX module's ``_ms_scans`` and a loop
    over the merged order."""
    rng = np.random.default_rng(5)
    for n_db, nq in ((40, 30), (7, 60), (90, 3)):
        n_m = n_db + 1 + nq
        sa = rng.permutation(n_m).astype(np.int32)
        mlcp = rng.integers(0, 12, n_m).astype(np.int32)
        mlcp[0] = 0
        ms, wit = tmstats._ms_scans(torch.from_numpy(sa),
                                    torch.from_numpy(mlcp), n_db, nq)
        jms, jwit = jmstats._ms_scans(jnp.asarray(sa), jnp.asarray(mlcp),
                                      n_m, n_db, nq)
        np.testing.assert_array_equal(ms.numpy(), np.asarray(jms))
        np.testing.assert_array_equal(wit.numpy(), np.asarray(jwit))
        db_rank = np.cumsum(sa < n_db) - 1
        for r in np.flatnonzero(sa > n_db):
            best, w = -1, 0
            for q in range(r - 1, -1, -1):            # previous db
                if sa[q] < n_db:
                    best, w = int(mlcp[q + 1:r + 1].min()), db_rank[q]
                    break
            for q in range(r + 1, n_m):               # next db
                if sa[q] < n_db:
                    v = int(mlcp[r + 1:q + 1].min())
                    if v > best:
                        best, w = v, db_rank[q]
                    break
            assert ms[sa[r] - n_db - 1] == max(best, 0)
            assert wit[sa[r] - n_db - 1] == w


def _query(rng, text, sigma):
    """A mutated copy of a part of the text with its own specials."""
    q = text[int(rng.integers(0, text.size // 3)):].copy()
    mut = rng.choice(q.size, q.size // 40, replace=False)
    q[mut] = rng.integers(0, sigma, mut.size)
    q[rng.choice(q.size, 3, replace=False)] = 254
    q[rng.choice(q.size, 2, replace=False)] = 255
    return q


@pytest.mark.parametrize("kind", ["dna", "protein", "separators"])
@pytest.mark.parametrize("cap", [None, 4])
def test_matching_statistics_equal_the_jax_package(kind, cap, monkeypatch):
    """The merged sort's (ms, witness) per query position, in order."""
    rng = np.random.default_rng({"dna": 1, "protein": 2,
                                 "separators": 3}[kind])
    sigma, alpha = (20, j_protein()) if kind == "protein" else (4, j_dna())
    if kind == "separators":
        text = random_dna_text(rng, 3000, n_wild=20, n_sep=12)
    else:
        text = _repeat_text(rng, 5000, sigma, copies=((200, 700),))
    jesa, tesa = _esas(text, alpha)
    monkeypatch.setattr(tsort, "SNAPSHOT_CAP", cap)
    for q in (_query(rng, text, sigma), text[:1500].copy()):
        times = PhaseTimes("cpu")
        with record_phases(times):
            ms, wit = tmstats.matching_statistics(tesa, q)
        jms, jwit = jmstats.matching_statistics(jesa, q)
        np.testing.assert_array_equal(ms, jms)
        np.testing.assert_array_equal(wit, jwit)
        assert ms.dtype == wit.dtype == np.int64
        assert times.counts["merged sorts"] == 1
        assert times.counts["snapshots"] == (cap or times.counts["snapshots"])


def test_identical_text_takes_the_fast_path():
    rng = np.random.default_rng(9)
    text = random_dna_text(rng, 2500, n_wild=9, n_sep=4)
    jesa, tesa = _esas(text, j_dna())
    times = PhaseTimes("cpu")
    with record_phases(times):
        ms, wit = tmstats.matching_statistics(tesa, text.copy())
    jms, jwit = jmstats.matching_statistics(jesa, text.copy())
    np.testing.assert_array_equal(ms, jms)
    np.testing.assert_array_equal(wit, jwit)
    assert "merged sorts" not in times.counts

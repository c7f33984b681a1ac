"""Port vs JAX package: the packed rank keys of the ``-complete`` key
search (``vstree_tpu_torch/index/esa.py::ESA.rank_keys``, torch ops on
the ESA's device, vs ``vstree_tpu/index/esa.py::ESA.rank_keys``, NumPy),
the exact lookup that reads them for patterns beyond K1's coverage
(``engine/complete.py::exact_interval_lookup``), and, on an index with a
poly-A tract, K1's path where the JAX plan refuses the index for its
widest bucket and takes the key search (exact and ``-e 1``).

Inputs are made with numpy from a seed; keys, rank intervals, step
counts and match tables must be equal (tolerance 0).
"""

import dataclasses

import numpy as np
import pytest
import torch

from vstree_tpu.core.alphabet import dna_alphabet, protein_alphabet
from vstree_tpu.core.multiseq import Multiseq
from vstree_tpu.engine import approx as japprox
from vstree_tpu.engine import complete as jcomplete
from vstree_tpu.index.build import build_esa
from vstree_tpu_torch.device import PhaseTimes, record_phases
from vstree_tpu_torch.engine import approx as tapprox
from vstree_tpu_torch.engine import complete as tcomplete
from vstree_tpu_torch.index import esa as tesa_mod
from vstree_tpu_torch.index.esa import ESA

CHUNK = 997  # ranks per packing step here: the last chunk is short


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The packing issues a few small ops per char offset; a thread pool
    per test worker only makes the workers of one host wait."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _multiseq(text):
    ms = Multiseq(sequence=text, totallength=text.size)
    ms.markpos = np.flatnonzero(text == 255).astype(np.uint32)
    ms.numofsequences = ms.markpos.size + 1
    return ms


def _text(kind, rng):
    """DNA or protein codes with wildcards, separators and two runs of
    one letter longer than MAX_KEY_LEVELS keys cover (60 DNA chars, 36
    protein chars), one of them at the text's end."""
    sigma = 4 if kind == "dna" else 20
    t = rng.integers(0, sigma, 3000).astype(np.uint8)
    t[rng.choice(3000, 12, replace=False)] = 254
    t[rng.choice(3000, 5, replace=False)] = 255
    t[400:600] = 0
    t[2900:] = sigma - 1
    return t


@pytest.fixture(scope="module", params=["dna", "protein"])
def jax_index(request):
    kind = request.param
    text = _text(kind, np.random.default_rng(41))
    alpha = dna_alphabet() if kind == "dna" else protein_alphabet()
    return kind, build_esa(_multiseq(text), alpha, demand=("suf",))


@pytest.mark.parametrize("suf_dtype", [np.int32, np.int64],
                         ids=["suf32", "suf64"])
@pytest.mark.parametrize("levels", range(1, tcomplete.MAX_KEY_LEVELS + 1))
@pytest.mark.parametrize("depth", ["0", "1", "bucket", "n-3"])
def test_rank_keys_equal_jax(jax_index, depth, levels, suf_dtype,
                             monkeypatch):
    """The keys of every rank, bit for bit, in chunks of CHUNK ranks
    (a short last chunk), with ``suftab`` as built (int32) and as read
    from disk (int64); the saturation of a special or of the text's end
    carries from one level into the next."""
    kind, jesa = jax_index
    monkeypatch.setattr(tesa_mod, "_KEY_CHUNK", CHUNK)
    n = jesa.totallength
    assert (n + 1) % CHUNK != 0
    d = {"0": 0, "1": 1, "n-3": n - 3,
         "bucket": 12 if kind == "dna" else 5}[depth]  # the key search's ppl
    esa = dataclasses.replace(ESA.from_shared(jesa, "cpu"),
                              suftab=jesa.suftab.astype(suf_dtype))
    suf = esa.suftab.copy()
    got = esa.rank_keys(d, levels)
    assert got.dtype == torch.int32 and got.shape == (levels, n + 1)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jesa.rank_keys(d, levels)))
    np.testing.assert_array_equal(esa.suftab, suf)  # left as it was
    assert esa.rank_keys(d, levels) is got          # cached
    if levels > 1 and depth != "n-3":
        full = (1 << (30 // esa.key_bits() * esa.key_bits())) - 1
        k = got.numpy()
        assert ((k[:-1] != full) & (k[:-1] != 0) & (k[1:] == full)).any()


def test_rank_keys_of_an_empty_text_raise_as_jax():
    text = np.zeros(0, np.uint8)
    jesa = build_esa(Multiseq(sequence=text, totallength=0), dna_alphabet(),
                     demand=("suf",))
    with pytest.raises(IndexError):
        jesa.rank_keys(0, 1)
    with pytest.raises(IndexError):
        ESA.from_shared(jesa, "cpu").rank_keys(0, 1)


@pytest.fixture(scope="module")
def tract_index():
    """30 kbp of DNA with wildcards, separators and a poly-A tract of
    1,200: its all-a bucket at K1's depth is wider than the JAX plan
    takes (its TPU window), so the JAX plan refuses the index as it
    refuses a genome's; the port's plan takes it."""
    rng = np.random.default_rng(43)
    text = rng.integers(0, 4, 30_000).astype(np.uint8)
    text[rng.choice(30_000, 20, replace=False)] = 254
    text[rng.choice(30_000, 6, replace=False)] = 255
    text[10_000:11_200] = 0
    jesa = build_esa(_multiseq(text), dna_alphabet(),
                     demand=("suf", "lcp", "bwt", "bck", "sti"))
    return text, jesa


def _queries(text, num, tract, seed, lens=(24, 36)):
    """``num`` patterns of ``lens`` chars: windows of the text clear of
    the tract and of specials, every tenth random, and with ``tract``
    some of a's."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lens[0], lens[1] + 1, num)
    m = np.full((num, int(lens.max())), -1, np.int32)
    for i, ln in enumerate(lens):
        if tract and i % 50 == 0:
            p = np.zeros(ln, np.uint8)
        elif i % 10 == 9:
            p = rng.integers(0, 4, ln).astype(np.uint8)
        else:
            while True:
                s = int(rng.integers(0, text.size - ln))
                p = text[s:s + ln]
                if (p < 4).all() and not 9_990 <= s < 11_200:
                    break
        m[i, :ln] = p
    return m, lens.astype(np.int32)


@pytest.mark.parametrize("tract", [False, True],
                         ids=["tract_not_queried", "tract_queried"])
def test_key_search_equals_jax_when_k1_refuses(tract_index, tract,
                                               monkeypatch):
    """B >= 4096 patterns of 37-48, beyond the two-word coverage of
    both plans (36 for DNA): the packed-key search takes as many steps
    as the JAX package's (the widest bucket queried, read on the device
    here and on the host there) and finds the same rank intervals."""
    text, jesa = tract_index
    tesa = ESA.from_shared(jesa, "cpu")
    m, plens = _queries(text, 4200, tract, seed=44, lens=(37, 48))
    assert not tcomplete.RankLookupPlan(tesa, 37, 48).ok
    assert not jcomplete.RankLookupPlan(jesa, 37, 48).ok
    steps = {}
    for name, mod in (("port", tcomplete), ("jax", jcomplete)):
        def spy(*args, _orig=mod._device_exact_lookup, _name=name):
            steps[_name] = args[8]   # nsteps
            return _orig(*args)
        monkeypatch.setattr(mod, "_device_exact_lookup", spy)
    got = tcomplete.exact_interval_lookup(tesa, m, plens)
    want = jcomplete.exact_interval_lookup(jesa, m, plens)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert steps["port"] == steps["jax"]
    widest = 12 if tract else 3  # log2 of 1,189 a-suffixes, + 1; or 3
    assert steps["port"] == widest
    assert (got[1] > got[0]).sum() > 3000
    assert 12 not in tesa._aux_bck      # no host copy of the table


def _phases(fn):
    """``fn()`` and the port's phases it ran."""
    times = PhaseTimes("cpu")
    with record_phases(times):
        out = fn()
    return out, set(times.seconds)


@pytest.mark.parametrize("tract", [False, True],
                         ids=["tract_not_queried", "tract_queried"])
def test_k1_takes_the_index_the_jax_plan_refuses(tract_index, tract):
    """Patterns of 24-36 on the tract index: the JAX plan refuses it for
    its widest bucket (wider than the TPU window) and takes the
    packed-key search; the port's plan takes it, and K1's plain version
    (the phases "rank words", "pack", "rank lookup") finds the same rank
    intervals, on queries that hit the tract and on queries that do
    not."""
    text, jesa = tract_index
    tesa = ESA.from_shared(jesa, "cpu")
    m, plens = _queries(text, 3000, tract, seed=45)
    jplan = jcomplete.RankLookupPlan(jesa, 24, 36)
    assert not jplan.ok and jplan.ppl == 10
    plan = tcomplete.RankLookupPlan(tesa, 24, 36)
    assert plan.ok and plan.ppl == 10
    widths = plan.bck[1::2]
    assert int(widths.max()) > 8 * 128 - 254   # the TPU window's widest
    assert int(widths[0]) == int(widths.max())  # the all-a bucket
    (got_lo, got_hi), seen = _phases(
        lambda: tcomplete.exact_interval_lookup(tesa, m, plens))
    assert seen == {"rank words", "pack", "rank lookup"}
    want = jcomplete.exact_interval_lookup(jesa, m, plens)
    np.testing.assert_array_equal(got_lo, want[0])
    np.testing.assert_array_equal(got_hi, want[1])
    assert (got_hi > got_lo).sum() > 2000
    polya = (m[:, :24] == 0).all(1)
    assert polya.any() == tract
    if tract:  # every a-run query: the tract's suffixes long enough
        assert (got_hi - got_lo)[polya].min() > 1000


def test_approx_e1_on_the_tract_index_equals_jax(tract_index):
    """``-complete -e 1`` on the tract index: the pieces (10-16 chars)
    take K1 in the port and the key search in the JAX package; match
    tables equal field for field."""
    text, jesa = tract_index
    tesa = ESA.from_shared(jesa, "cpu")
    m, plens = _queries(text, 240, True, seed=46, lens=(20, 32))
    pats = [m[i, :plens[i]].astype(np.uint8) for i in range(len(plens))]
    rng = np.random.default_rng(47)
    for i in range(0, len(pats), 3):  # one substitution in every third
        at = int(rng.integers(0, pats[i].size))
        pats[i][at] = (pats[i][at] + 1) % 4
    starts = np.cumsum([0] + [p.size + 1 for p in pats[:-1]]).astype(
        np.int64)
    kw = dict(flags_extra=0, query_starts=starts)
    got, seen = _phases(
        lambda: tapprox.approx_complete_matches(tesa, pats, 1, True, **kw))
    want = japprox.approx_complete_matches(jesa, pats, 1, True, **kw)
    assert "rank lookup" in seen and "key search" not in seen
    assert len(want) > 200 and (want.distance != 0).any()
    assert (want.length1 > 500).sum() == 0  # rows are query-sized
    for f in ("length1", "position1", "length2", "position2", "distance",
              "flag", "seqnum1", "relpos1", "seqnum2", "relpos2",
              "evalue", "idnumber", "transnum"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


class _StandIn:
    """An index of n = 2^30 that builds nothing: every table access
    fails the test."""

    totallength = 1 << 30
    alpha = dna_alphabet()

    @staticmethod
    def chars_per_word():
        return 13

    def __getattr__(self, name):
        raise AssertionError(f"the plan built {name}")


def test_plan_refuses_a_text_beyond_the_kernel_before_building():
    """n >= 2^30 is K1's own limit: the plan refuses it before it makes
    a table (a JAX-ok index of that size would reach the wrapper's
    checks and raise)."""
    plan = tcomplete.RankLookupPlan(_StandIn(), 24, 36)
    assert not plan.ok and plan.coverage == 36
    small = _StandIn()
    small.__dict__["totallength"] = 0
    assert not tcomplete.RankLookupPlan(small, 24, 36).ok

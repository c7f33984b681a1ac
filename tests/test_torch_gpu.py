"""The port on the card: kernel K1 against its plain version, and the
build and lookup on a CUDA device against the same code on the CPU.

Every test here needs a CUDA card (marker ``gpu``) and skips without
one.  The module imports no jax, so it also runs where JAX is absent;
there, skip the repo's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

Comparisons are exact (integer tables and rank bounds).
"""

import numpy as np
import pytest
import torch

from vstree_tpu.core.alphabet import dna_alphabet
from vstree_tpu.core.multiseq import Multiseq
from vstree_tpu_torch.engine import complete
from vstree_tpu_torch.index.build import build_esa
from vstree_tpu_torch.native import rankcount

pytestmark = pytest.mark.gpu

DEMAND = ("suf", "lcp", "bwt", "bck", "sti", "skp")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _text(n, seed, n_wild=0, n_sep=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, n).astype(np.uint8)
    t[rng.choice(n, n_wild, replace=False)] = 254
    t[rng.choice(n, n_sep, replace=False)] = 255
    return t


def _multiseq(text):
    ms = Multiseq(sequence=text, totallength=text.size)
    ms.markpos = np.flatnonzero(text == 255).astype(np.uint32)
    ms.numofsequences = ms.markpos.size + 1
    return ms


def _patterns(text, lo, hi, num, seed):
    rng = np.random.default_rng(seed)
    pats = []
    for i in range(num):
        ln = int(rng.integers(lo, hi + 1))
        if i % 5 == 4:
            pats.append(rng.integers(0, 4, ln).astype(np.uint8))
        else:
            s = int(rng.integers(0, text.size - ln))
            pats.append(text[s:s + ln].copy())
    return pats


def _matrix(pats):
    plens = np.array([p.size for p in pats], np.int32)
    m = np.full((len(pats), plens.max()), -1, np.int32)
    for i, p in enumerate(pats):
        m[i, :p.size] = p
    return m, plens


@pytest.mark.parametrize("lo,hi", [(24, 36), (5, 30)], ids=["ppl10", "ppl5"])
def test_kernel_equals_plain_version(cuda, lo, hi):
    text = _text(200_000, 1, n_wild=20, n_sep=8)
    esa = build_esa(_multiseq(text), dna_alphabet(), demand=("suf",),
                    device=cuda)
    m, plens = _matrix(_patterns(text, lo, hi, 5001, 2))
    plan = complete.RankLookupPlan(esa, int(plens.min()), m.shape[1])
    assert plan.ok
    flat8 = torch.from_numpy(plan.pack(m, plens)).to(cuda)
    args = complete.rank_lookup_inputs(flat8, plan.bck, plan.ppl, plan.cpw,
                                       plan.sigma, plan.shift)
    before = rankcount.bucket_rank_lookup.launches
    got = rankcount.bucket_rank_lookup(*args, plan.t1, plan.t2,
                                       plan.rowspan)
    torch.cuda.synchronize()
    assert rankcount.bucket_rank_lookup.launches == before + 1
    want = rankcount.bucket_rank_lookup_ref(*args, plan.t1, plan.t2,
                                            plan.rowspan)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((got[1] > got[0]).sum()) > 3000


def test_kernel_edge_shapes(cuda):
    """Zero-width brackets, a query count that is no multiple of the
    block's 8 warps, and an empty batch."""
    rng = np.random.default_rng(3)
    rows = 20
    t1 = torch.from_numpy(np.sort(rng.integers(0, 99, rows * 128))
                          .astype(np.int32).reshape(rows, 128)).to(cuda)
    t2 = torch.from_numpy(rng.integers(0, 99, (rows, 128))
                          .astype(np.int32)).to(cuda)
    for B in (0, 1, 13, 1027):
        left = rng.integers(0, 2000, B).astype(np.int32)
        width = rng.integers(0, 300, B).astype(np.int32)
        width[::3] = 0
        keys = [rng.integers(0, 99, B).astype(np.int32) for _ in range(4)]
        args = [torch.from_numpy(a).to(cuda) for a in [left, width] + keys]
        got = rankcount.bucket_rank_lookup(*args, t1, t2, 4)
        want = rankcount.bucket_rank_lookup_ref(*args, t1, t2, 4)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_build_on_card_equals_cpu(cuda):
    text = _text(60_000, 4, n_wild=30, n_sep=12)
    text[10_000:12_000][text[10_000:12_000] >= 254] = 1
    text[40_000:42_000] = text[10_000:12_000]  # deep lcp lanes
    ms = _multiseq(text)
    got = build_esa(ms, dna_alphabet(), demand=DEMAND, device=cuda)
    want = build_esa(ms, dna_alphabet(), demand=DEMAND, device="cpu")
    for name in ("suftab", "lcptab", "bwttab", "bcktab", "stitab",
                 "skptab"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.maxbranchdepth == want.maxbranchdepth >= 2000


@pytest.mark.parametrize("lo,hi", [(10, 36), (40, 60), (80, 140)],
                         ids=["rankcount", "exact_lookup",
                              "interval_search"])
def test_complete_matches_on_card_equal_cpu(cuda, lo, hi):
    text = _text(30_000, 5, n_wild=10, n_sep=4)
    text[20_000:20_400] = text[3_000:3_400]
    ms = _multiseq(text)
    gesa = build_esa(ms, dna_alphabet(), demand=("suf", "bck"), device=cuda)
    cesa = build_esa(ms, dna_alphabet(), demand=("suf", "bck"),
                     device="cpu")
    pats = _patterns(text, lo, hi, 400, 6)
    got = complete.exact_complete_matches(gesa, pats)
    want = complete.exact_complete_matches(cesa, pats)
    assert len(got) == len(want) > 0
    for f in ("position1", "seqnum1", "relpos1", "seqnum2", "length1"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))

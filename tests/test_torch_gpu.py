"""The port on the card: kernels K1 and K2 against their plain
versions, and the build, the exact lookup and approximate matching on a
CUDA device against the same code on the CPU; so are the out-of-core
build's merge and the index tools that reach the device.  The vmatch
entry point, run as a process of its own under VSTREE_PROFILE, must
trace the card's kernels.

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

from vstree_tpu_torch.core.alphabet import dna_alphabet
from vstree_tpu_torch.core.multiseq import Multiseq
from vstree_tpu_torch.engine import approx, complete, online, repeats
from vstree_tpu_torch.engine import gextend, gextend_dev, repeats_dev, xdrop
from vstree_tpu_torch.index.build import build_esa
from vstree_tpu_torch.native import myers, rankcount
from vstree_tpu_torch.stats.evalues import Evalues

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


def _k1_equals_plain(args, scal):
    """The wrapper (kernel) on CUDA tensors equals the plain version on
    the same tensors; returns the kernel's (lo, hi) on the host."""
    before = rankcount.rank_interval_lookup.launches
    got = rankcount.rank_interval_lookup(*args, *scal)
    assert rankcount.rank_interval_lookup.launches == before + 1
    want = rankcount.rank_interval_lookup_ref(*args, *scal)
    assert int(want[2]) == 0
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.device.type == "cpu"
        assert torch.equal(g, w.cpu())
    return got


@pytest.mark.parametrize("lo,hi", [(24, 36), (5, 30)], ids=["ppl10", "ppl5"])
def test_kernel_equals_plain_version(cuda, lo, hi):
    text = _text(200_000, 1, n_wild=20, n_sep=8)
    esa = build_esa(_multiseq(text), dna_alphabet(), demand=("suf",),
                    device=cuda)
    m, plens = _matrix(_patterns(text, lo, hi, 5001, 2))
    plan = complete.RankLookupPlan(esa, int(plens.min()), m.shape[1])
    assert plan.ok
    flat8 = torch.from_numpy(plan.pack(m, plens)).to(cuda)
    got = _k1_equals_plain(
        [flat8, plan.bck, plan.suf, plan.text],
        (text.size, plan.ppl, plan.cpw, plan.sigma, plan.shift))
    assert int((got[1] > got[0]).sum()) > 3000


@pytest.mark.parametrize("kind", ["dna", "protein", "other"])
def test_kernel_edge_shapes(cuda, kind):
    """chip_smoke's edge set: patterns that end just before a special
    and at the text end, the last rank, wildcards in text and queries,
    the widest bucket, every length from ppl to the coverage, misses and
    padding rows; on a DNA, a protein and a 7-letter alphabet (the
    kernel's generic chars-per-word path), at batch sizes that are no
    multiple of the block, one query, and an empty batch."""
    import chip_smoke

    edge = chip_smoke.k1_edge_set(kind)
    tensors = [torch.from_numpy(a).to(cuda) for a in edge["tensors"]]
    B = edge["B"]
    rows = tensors[0].reshape(-1, B)
    for cut in (B, 1, 129, 0):
        args = [rows[:, :cut].contiguous().reshape(-1)] + tensors[1:]
        if cut == 0:
            lo, hi = rankcount.rank_interval_lookup(*args, *edge["scalars"])
            assert lo.numel() == 0 and hi.numel() == 0
            continue
        got = _k1_equals_plain(args, edge["scalars"])
        if cut == B:
            width = (got[1] - got[0]).numpy()
            np.testing.assert_array_equal(width, edge["counts"])


def test_kernel_error_word_raises(cuda):
    """A planted bad bracket and a query longer than the coverage come
    back in the kernel's error word, and the wrapper raises."""
    import chip_smoke

    edge = chip_smoke.k1_edge_set("dna")
    flat8, bck, suf, text = (torch.from_numpy(a).to(cuda)
                             for a in edge["tensors"])
    n, ppl, cpw, sigma, shift = edge["scalars"]
    B = edge["B"]
    rows = flat8.reshape(-1, B).to(torch.int64)
    code0 = int(sum(int(rows[j, 0]) * sigma ** (ppl - 1 - j)
                    for j in range(ppl)))
    bad = bck.clone().reshape(-1)
    bad[code0] = (n - 1) | (3 << shift)
    with pytest.raises(ValueError, match="bracket"):
        rankcount.rank_interval_lookup(flat8, bad, suf, text,
                                       *edge["scalars"])
    bad[code0] = -5
    with pytest.raises(ValueError, match="bracket"):
        rankcount.rank_interval_lookup(flat8, bad, suf, text,
                                       *edge["scalars"])
    long = flat8.clone().reshape(-1, B)
    long[-1, 3] = ppl + 2 * cpw + 1
    with pytest.raises(ValueError, match="longer"):
        rankcount.rank_interval_lookup(long.reshape(-1), bck, suf, text,
                                       *edge["scalars"])
    with pytest.raises(ValueError, match="int32"):
        rankcount.rank_interval_lookup(flat8, bck, suf.long(), text,
                                       *edge["scalars"])
    with pytest.raises(ValueError, match="tensors on"):
        rankcount.rank_interval_lookup(flat8, bck.cpu(), suf, text,
                                       *edge["scalars"])
    # and the unharmed inputs still pass
    rankcount.rank_interval_lookup(flat8, bck, suf, text, *edge["scalars"])


@pytest.mark.parametrize("kind,pl", [("dna", 1), ("dna", 10),
                                     ("protein", 4)])
def test_device_bucket_table_on_card_equals_numpy(cuda, kind, pl):
    from vstree_tpu_torch.index import build

    sigma = 4 if kind == "dna" else 20
    rng = np.random.default_rng(pl)
    text = rng.integers(0, sigma, 300_000).astype(np.uint8)
    text[rng.choice(text.size, 400, replace=False)] = 254
    text[rng.choice(text.size, 40, replace=False)] = 255
    text[-1] = 255
    got = build.bck_table_device(torch.from_numpy(text).to(cuda), sigma, pl)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy().astype(np.uint32),
                                  build.bck_table(text, sigma, pl))


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


# ---------------------------------------------------------------------------
# K2 (Myers verification) and the approximate path
# ---------------------------------------------------------------------------


def _k2_args(text, pats, cand, qidx, dev):
    plens = np.array([p.size for p in pats], np.int32)
    eqs = approx._eqs_matrix(pats, 32).view(np.int32)[:, 0, :]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
            (text, cand.astype(np.int32), qidx.astype(np.int32), eqs,
             plens)]


def _assert_k2_equals_plain(args, L, n):
    before = myers.verify_edit.launches
    got = myers.verify_edit(*args, L, n)
    torch.cuda.synchronize()
    assert myers.verify_edit.launches == before + 1
    want = myers.verify_edit_ref(*args, L, n)
    for g, w, name in zip(got, want, ("minsc", "bestlen", "bestsc")):
        assert g.dtype == torch.int32 and torch.equal(g, w), name
    return got


@pytest.mark.parametrize("P,nq", [(5_000, 40), (1_000_003, 3000)],
                         ids=["small", "large"])
def test_myers_kernel_equals_plain_version(cuda, P, nq):
    rng = np.random.default_rng(P)
    n = 300_000
    text = _text(n, 11, n_wild=30, n_sep=12)
    pats, src = [], []
    for i in range(nq):
        ln = int(rng.integers(1, 33)) if i % 9 == 0 else int(
            rng.integers(18, 33))
        s = int(rng.integers(3, n - ln))
        src.append(s)
        p = text[s:s + ln].copy()
        p[p == 255] = 0
        if i % 3:
            p[int(rng.integers(0, ln))] = rng.integers(0, 4)
        pats.append(p)
    qidx = rng.integers(0, nq, P)
    cand = rng.integers(0, n, P)
    # half the candidates sit on or beside their pattern's origin
    near = rng.random(P) < 0.5
    cand = np.where(near, np.array(src)[qidx] + cand % 7 - 3, cand)
    got = _assert_k2_equals_plain(_k2_args(text, pats, cand, qidx, cuda),
                                  35, n)
    assert int((got[0] <= 4).sum()) > P // 3


def test_myers_kernel_edge_set(cuda):
    """chip_smoke's edge set (candidates in the last L positions,
    windows crossing a SEPARATOR and a WILDCARD, patterns of 1 and 32
    chars), at P = 1, a P that is no multiple of the block, and an empty
    batch."""
    import chip_smoke

    text, pats, cand, qidx, L, n = chip_smoke.k2_edge_set()
    for P in (cand.size, 1, 129, 0):
        args = _k2_args(text, pats, cand[:P], qidx[:P], cuda)
        if P == 0:
            out = myers.verify_edit(*args, L, n)
            assert all(o.numel() == 0 for o in out)
            continue
        got = _assert_k2_equals_plain(args, L, n)
        if P == cand.size:
            assert (got[2] == 0).any() and (got[1] == 0).any()
    # the kernel's error word: each planted fault raises, alone and in
    # one candidate of many
    args = _k2_args(text, pats, cand, qidx, cuda)
    for i, bad, what in ((2, args[2] + 9, "out of range"),
                         (1, args[1] - 700, "out of range"),
                         (4, args[4] + 1, "1..32")):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(ValueError, match=what):
            myers.verify_edit(*wrong, L, n)
        assert myers.value_errors(wrong[1], wrong[2], wrong[4]) != 0
    one = args[2].clone()
    one[77] = -1
    with pytest.raises(ValueError, match="out of range"):
        myers.verify_edit(args[0], args[1], one, args[3], args[4], L, n)
    assert myers.value_errors(args[1], args[2], args[4]) == 0
    _assert_k2_equals_plain(args, L, n)   # and the unharmed inputs pass


@pytest.mark.parametrize("edit", [True, False], ids=["edit", "hamming"])
@pytest.mark.parametrize("lo,hi,k", [(8, 32, 1), (10, 32, 2), (28, 70, 2)],
                         ids=["k1", "k2", "multiword"])
def test_approx_matches_on_card_equal_cpu(cuda, edit, lo, hi, k):
    text = _text(20_000, 13, n_wild=10, n_sep=4)
    text[15_000:15_300] = text[2_000:2_300]
    ms = _multiseq(text)
    demand = ("suf", "bck", "sti")
    gesa = build_esa(ms, dna_alphabet(), demand=demand, device=cuda)
    cesa = build_esa(ms, dna_alphabet(), demand=demand, device="cpu")
    rng = np.random.default_rng(lo + k)
    pats = []
    for p in _patterns(text, lo, hi, 300, 14):
        p = p[p < 250]
        if p.size > k + 1 and rng.random() < 0.6:
            p[int(rng.integers(0, p.size))] = rng.integers(0, 4)
        if p.size > k:
            pats.append(p)
    before = myers.verify_edit.launches
    got = approx.approx_complete_matches(gesa, pats, k, edit)
    want = approx.approx_complete_matches(cesa, pats, k, edit)
    assert len(got) == len(want) > 50
    for f in ("position1", "length1", "distance", "seqnum1", "relpos1",
              "seqnum2", "length2"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    if edit and hi <= 32:
        assert myers.verify_edit.launches > before


# ---------------------------------------------------------------------------
# the self-match program and the online scans
# ---------------------------------------------------------------------------


def _repeat_text(n, seed):
    rng = np.random.default_rng(seed)
    text = _text(n, seed, n_wild=12, n_sep=4)
    elem = rng.integers(0, 4, 300).astype(np.uint8)
    for _ in range(40):
        copy = elem.copy()
        at = rng.choice(300, 25, replace=False)
        copy[at] = rng.integers(0, 4, 25)
        st = int(rng.integers(0, n - 300))
        text[st:st + 300] = copy
    text[5000:5400] = np.tile(rng.integers(0, 4, 8).astype(np.uint8), 50)
    return text


@pytest.mark.parametrize("L", [8, 14])
def test_maximal_pairs_on_card_equal_cpu_and_numpy(cuda, L, monkeypatch):
    text = _repeat_text(60_000, 31)
    ms = _multiseq(text)
    demand = ("suf", "lcp", "bwt")
    gesa = build_esa(ms, dna_alphabet(), demand=demand, device=cuda)
    cesa = build_esa(ms, dna_alphabet(), demand=demand, device="cpu")
    want = repeats.maximal_pairs_ref_order_vec(cesa, L)
    assert want[0].size > 3000
    for chunk in (repeats_dev._PAIR_CHUNK, 20_000):
        monkeypatch.setattr(repeats_dev, "_PAIR_CHUNK", chunk)
        got = repeats_dev.maximal_pairs_device(gesa, L)
        cpu = repeats_dev.maximal_pairs_device(cesa, L)
        for g, c, w in zip(got, cpu, want):
            np.testing.assert_array_equal(g, c)
            np.testing.assert_array_equal(g, w)
    (lo, hi, d), count = repeats_dev.maximal_pairs_device_positions(gesa, L)
    assert lo.device.type == "cuda" and count == want[0].size
    table = repeats.find_maximal_pairs_ref(gesa, L)
    np.testing.assert_array_equal(table.position1, lo.cpu().numpy())
    np.testing.assert_array_equal(table.length1, want[0])


TABLE_FIELDS = ("length1", "position1", "length2", "position2", "distance",
                "flag", "seqnum1", "relpos1", "seqnum2", "relpos2", "evalue",
                "idnumber", "transnum")


def _extension_inputs(cuda, L):
    """A repeat text with two records and wildcards, its index on the
    card and on the CPU, the Seqs of either and the seeds (maximal pairs
    of length >= L)."""
    text = _repeat_text(40_000, 41)
    rng = np.random.default_rng(42)
    text[rng.choice(text.size, 12, replace=False)] = 254
    text[[9_000, 26_000]] = 255
    ms = _multiseq(text)
    demand = ("suf", "lcp", "bwt")
    gesa = build_esa(ms, dna_alphabet(), demand=demand, device=cuda)
    cesa = build_esa(ms, dna_alphabet(), demand=demand, device="cpu")
    seeds = repeats.find_maximal_pairs_ref(cesa, L)
    return (gesa, cesa, gextend.Seqs(text, text, cuda),
            gextend.Seqs(text, text, "cpu"), seeds)


def _assert_tables_equal(got, want, least):
    assert len(got) == len(want) > least
    for f in TABLE_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("maxdist", [1, 3])
def test_edit_fronts_and_viability_on_card_equal_cpu(cuda, maxdist,
                                                     monkeypatch):
    """Fronts and ``h`` of every seed (leastlength 0), then the viable
    set: one chunk sized from the card's memory, and a forced small
    chunk; seeds as host arrays and as tensors on the card."""
    L = 10
    _, _, gsq, csq, seeds = _extension_inputs(cuda, L)
    pos = [getattr(seeds, f).astype(np.int64)
           for f in ("position1", "position2", "length1")]
    assert pos[0].size > 2000
    assert gextend_dev._dev_tables(gsq)["Pf1"].device.type == cuda.type
    for least in (0, 28):
        want = gextend_dev.edit_fronts_viable(csq, *pos, maxdist, least, L)
        assert (want[0].size == pos[0].size) == (least == 0)
        for chunk in (None, 700):
            monkeypatch.setattr(gextend_dev, "_CHUNK_SEEDS", chunk)
            for args in (pos, [torch.from_numpy(a).to(cuda) for a in pos]):
                got = gextend_dev.edit_fronts_viable(gsq, *args, maxdist,
                                                     least, L)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)
        monkeypatch.setattr(gextend_dev, "_CHUNK_SEEDS", None)
    assert 1 << 16 <= gextend_dev._chunk_seeds(cuda, maxdist) <= 1 << 23


@pytest.mark.parametrize("allmax", [False, True], ids=["best", "allmax"])
def test_extend_seeds_on_card_equal_cpu(cuda, allmax):
    """The three ``*_extend_seeds`` and the fused self path: every column
    of the card's table equals the CPU's."""
    L = 10
    gesa, cesa, gsq, csq, seeds = _extension_inputs(cuda, L)
    ev = Evalues(0.25)
    # the -allmax containers are quadratic in their matches: fewer there
    least = 40 if allmax else 26
    for k in (1,) if allmax else (1, 2):
        _assert_tables_equal(
            gextend.hamming_extend_seeds(gsq, ev, seeds, k, least, L, False,
                                         allmax),
            gextend.hamming_extend_seeds(csq, ev, seeds, k, least, L, False,
                                         allmax), 50)
        want = gextend.edit_extend_seeds(csq, ev, seeds, k, least, L, False,
                                         True, allmax)
        _assert_tables_equal(
            gextend.edit_extend_seeds(gsq, ev, seeds, k, least, L, False,
                                      True, allmax), want, 50)
        fused = gextend.edit_extend_self_device(gesa, gsq, ev, k, least, L,
                                                allmax)
        _assert_tables_equal(fused, want, 50)
        _assert_tables_equal(
            fused, gextend.edit_extend_self_device(cesa, csq, ev, k, least,
                                                   L, allmax), 50)
    if not allmax:
        for x in (3, -3):
            _assert_tables_equal(
                xdrop.xdrop_extend_seeds(gsq, seeds, x, L, False),
                xdrop.xdrop_extend_seeds(csq, seeds, x, L, False), 50)


def test_online_scans_on_card_equal_cpu(cuda, monkeypatch):
    n = 30_000
    text = _repeat_text(n, 33)
    trev = torch.from_numpy(text[::-1].copy())
    pats = _patterns(text, 20, 64, 24, 34) + _patterns(text, 70, 110, 6, 35)
    for p in pats[::3]:
        p[p.size // 2] = (p[p.size // 2] + 1) % 4
    plens = np.array([p.size for p in pats], np.int32)
    m, _ = _matrix(pats)
    for special in (True, False):
        outs = [online._window_mismatches(
            torch.from_numpy(text).to(dev), torch.from_numpy(m).to(dev),
            torch.from_numpy(plens).to(dev), m.shape[1], n, special)
            for dev in (cuda, "cpu")]
        for g, c in zip(*outs):
            assert torch.equal(g.cpu(), c)
    for w, sel in ((1, plens <= 32), (2, (plens > 32) & (plens <= 64))):
        sub = [p for p, s in zip(pats, sel) if s]
        eqs = torch.from_numpy(approx._eqs_matrix(
            [p[::-1] for p in sub], 32 * w).view(np.int32))
        pl = torch.from_numpy(plens[sel])
        for k in (0, 2):
            got = online._semiglobal_myers(trev.to(cuda), eqs.to(cuda),
                                           pl.to(cuda), w, n, k)
            with monkeypatch.context() as patch:
                patch.setattr(online, "_SEG_WARMUPS", n)  # one segment
                want = online._semiglobal_myers(trev, eqs, pl, w, n, k)
            assert torch.equal(got.cpu(), want) and int(want.sum()) > 2
    sub = [p for p in pats if p.size > 64]
    M = max(p.size for p in sub)
    patrev = np.full((len(sub), M + 2), -7, np.int32)
    for i, p in enumerate(sub):
        patrev[i, 1:p.size + 1] = p[::-1]
    pl = torch.from_numpy(np.array([p.size for p in sub], np.int32))
    patrev = torch.from_numpy(patrev)
    for k, warm in ((1, None), (3, 12)):
        with monkeypatch.context() as patch:
            if warm:
                patch.setattr(online, "_cutoff_warmup", lambda M, k: warm)
            got = online._ukkonen_cutoff_scan_global(
                trev.to(cuda), patrev.to(cuda), pl.to(cuda), M, k, n)
        with monkeypatch.context() as patch:
            patch.setattr(online, "_SEG_WARMUPS", n)      # one segment
            want = online._ukkonen_cutoff_scan_global(trev, patrev, pl, M,
                                                      k, n)
        assert torch.equal(got.cpu(), want) and int(want.sum()) > 2


@pytest.mark.parametrize("kind,k", [("exact", 0), ("hamming", 2),
                                    ("edit", 1)])
def test_online_matches_on_card_equal_cpu(cuda, kind, k):
    text = _repeat_text(30_000, 36)
    ms = _multiseq(text)
    gesa = build_esa(ms, dna_alphabet(), demand=("suf",), device=cuda)
    cesa = build_esa(ms, dna_alphabet(), demand=("suf",), device="cpu")
    pats = [p[p < 250] for p in _patterns(text, 18, 32, 40, 37)]
    for p in pats[::2]:
        p[p.size // 2] = (p[p.size // 2] + 1) % 4
    before = myers.verify_edit.launches
    got = online.online_complete_matches(gesa, pats, k, kind)
    want = online.online_complete_matches(cesa, pats, k, kind)
    assert len(got) == len(want) > 15
    for f in ("position1", "length1", "distance", "seqnum1", "relpos1",
              "seqnum2", "length2"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    # -online -e measures every start with K2
    assert (myers.verify_edit.launches > before) == (kind == "edit")


def _query_inputs(cuda, seed):
    """A repeat text of several records with wildcards, a duplicated
    record and reverse complements of its own windows, its index on the
    card and on the CPU (the same ESA), and a query text of mutated
    windows of it."""
    from vstree_tpu_torch.index.esa import ESA

    text = _repeat_text(40_000, seed)
    rng = np.random.default_rng(seed + 1)
    text[rng.choice(text.size, 12, replace=False)] = 254
    text[[9_000, 26_000]] = 255
    text[30_000:34_000] = text[10_000:14_000]
    text[29_999] = text[34_000] = 255
    for k in range(4):          # reverse complements: palindromic rows
        text[35_000 + 1_000 * k:35_300 + 1_000 * k] = \
            3 - text[2_000 + 700 * k:2_300 + 700 * k][::-1] % 4
    cesa = build_esa(_multiseq(text), dna_alphabet(),
                     demand=("suf", "lcp", "bwt", "bck", "sti"),
                     device="cpu")
    gesa = ESA.from_shared(cesa, cuda)
    q = text[5_000:25_000].copy()
    mut = rng.choice(q.size, q.size // 50, replace=False)
    q[mut] = rng.integers(0, 4, mut.size)
    return gesa, cesa, text, q


@pytest.mark.parametrize("mode,qsp", [("mem", 2), ("mem", 0), ("mem", 5),
                                      ("mumcand", 2), ("mum", 2)])
def test_query_matches_on_card_equal_cpu(cuda, mode, qsp):
    """find_query_matches (the maximal-prefix replay, the scans and the
    MEM expansion on the card): every column equals the CPU's, in
    order."""
    from vstree_tpu_torch.engine import query

    gesa, cesa, _, q = _query_inputs(cuda, 51)
    got, want = (query.find_query_matches(e, _multiseq(q), 14, mode,
                                          qspeedup=qsp)
                 for e in (gesa, cesa))
    _assert_tables_equal(got, want, 10)


def test_self_pipeline_and_merged_sort_on_card_equal_cpu(cuda, monkeypatch):
    """db == query (the db-vs-itself pipeline) and the reverse
    complement of the db (the merged sort of matching statistics, with
    and without a forced snapshot cap): the card's tables equal the
    CPU's."""
    from vstree_tpu_torch.core.multiseq import reverse_complement_inplace
    from vstree_tpu_torch.device import PhaseTimes, record_phases
    from vstree_tpu_torch.engine import mstats, query
    from vstree_tpu_torch.index import sort

    gesa, cesa, text, _ = _query_inputs(cuda, 53)
    times = PhaseTimes(cuda)
    with record_phases(times):
        got = query.find_query_matches(gesa, gesa.multiseq, 20, "mem")
    _assert_tables_equal(
        got, query.find_query_matches(cesa, cesa.multiseq, 20, "mem"), 50)
    assert times.counts["self pipeline replays"] > 0
    assert "self pipeline fallbacks" not in times.counts
    rc = reverse_complement_inplace(cesa.multiseq)
    for cap in (None, 4):
        monkeypatch.setattr(sort, "SNAPSHOT_CAP", cap)
        ms_g, wit_g = mstats.matching_statistics(gesa, rc.sequence)
        ms_c, wit_c = mstats.matching_statistics(cesa, rc.sequence)
        np.testing.assert_array_equal(ms_g, ms_c)
        np.testing.assert_array_equal(wit_g, wit_c)
    times = PhaseTimes(cuda)
    with record_phases(times):
        got = query.find_query_matches(gesa, rc, 14, "mem", flags_extra=6)
    assert times.counts["merged sorts"] == 1
    _assert_tables_equal(
        got, query.find_query_matches(cesa, rc, 14, "mem", flags_extra=6), 5)


def test_findmaxpref_and_mem_expand_on_card_equal_cpu(cuda):
    from vstree_tpu_torch.core.multiseq import Multiseq
    from vstree_tpu_torch.engine import query, querydev

    gesa, cesa, _, q = _query_inputs(cuda, 57)
    qms = _multiseq(q)
    assert isinstance(qms, Multiseq)
    pos = query._query_positions(qms, 14)
    proceed, maxlen, wit = query._ref_witness_state(cesa, qms, 14, *pos, 2)
    assert proceed.sum() > 100
    sel = np.flatnonzero(proceed)
    lanes = (np.zeros(sel.size, np.int64),
             np.full(sel.size, cesa.suftab.size - 2, np.int64),
             np.zeros(sel.size, np.int64), pos[0][sel], pos[3][sel])
    for g, c in zip(querydev.findmaxpref_device(gesa, q, *lanes),
                    querydev.findmaxpref_device(cesa, q, *lanes)):
        np.testing.assert_array_equal(g, c)
    args = (wit[sel], maxlen[sel], pos[0][sel], pos[2][sel], 14)
    for g, c in zip(querydev.mem_expand_device(gesa, q, *args),
                    querydev.mem_expand_device(cesa, q, *args)):
        np.testing.assert_array_equal(g, c)


# ---------------------------------------------------------------------------
# sigma = 20: the six frames of DNA queries on a protein index (-dnavsprot)
# ---------------------------------------------------------------------------


def _protein_text(n, seed):
    """Residue codes 0-19 with a poly-L run (code 0), wildcards and
    separators."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 20, n).astype(np.uint8)
    t[5_000:5_030] = 0
    t[rng.choice(n, 20, replace=False)] = 254
    t[rng.choice(n, 10, replace=False)] = 255
    return t


def _frames(text, num, seed, aa=(6, 18)):
    """The six frames of back-translated windows of ``aa`` residues of
    ``text`` (every other one reverse-complemented, so that a reverse
    frame holds it), as ``vmatch -dnavsprot 1`` translates them."""
    import chip_smoke

    from vstree_tpu_torch.core.alphabet import protein_alphabet
    from vstree_tpu_torch.core.codon import six_frame_translate

    rng = np.random.default_rng(seed)
    reg = np.flatnonzero(text < 20)
    letters = np.frombuffer(bytes(protein_alphabet().characters), np.uint8)
    dna = []
    for i in range(num):
        m = int(rng.integers(aa[0], aa[1] + 1))
        s = int(reg[rng.integers(0, reg.size)])
        win = text[s:s + m]
        win = letters[np.where(win < 20, win, 0)]
        d = chip_smoke.back_translate(rng, win)
        dna.append(chip_smoke.reverse_complement(d) if i % 2 else d)
    ms = Multiseq(sequence=np.frombuffer(b"\xff".join(dna), np.uint8).copy())
    ms.originalsequence = ms.sequence.copy()
    ms.totallength = ms.sequence.size
    ms.markpos = np.flatnonzero(ms.sequence == 255).astype(np.uint32)
    ms.numofsequences = len(dna)
    frames = six_frame_translate(ms, protein_alphabet(), 1)
    return [frames.sequence[slice(*frames.seq_bounds(i))]
            for i in range(frames.numofsequences)]


def test_kernel_on_protein_frames_equals_plain_version(cuda):
    """K1 at sigma = 20 (7 chars per word, bucket depth 4, coverage 18)
    on the frames of DNA queries of 18-54 nt: stop codons are wildcards
    in the patterns."""
    from vstree_tpu_torch.core.alphabet import protein_alphabet

    text = _protein_text(300_000, 31)
    esa = build_esa(_multiseq(text), protein_alphabet(), demand=("suf",),
                    device=cuda)
    pats = _frames(text, 3000, 32)
    m, plens = _matrix(pats)
    plan = complete.RankLookupPlan(esa, int(plens.min()), m.shape[1])
    assert plan.ok and plan.sigma == 20 and plan.cpw == 7
    flat8 = torch.from_numpy(plan.pack(m, plens)).to(cuda)
    got = _k1_equals_plain(
        [flat8, plan.bck, plan.suf, plan.text],
        (text.size, plan.ppl, plan.cpw, plan.sigma, plan.shift))
    assert int((got[1] > got[0]).sum()) >= 1000
    assert (m >= 20).any()  # stop codons


def test_myers_kernel_on_protein_frames(cuda):
    """K2 with patterns of 10-30 residues from the frames, candidates on
    and beside their origins and anywhere."""
    text = _protein_text(200_000, 33)
    pats = [p for p in _frames(text, 800, 34, (10, 30)) if p.size >= 2]
    rng = np.random.default_rng(35)
    P = 200_003
    qidx = rng.integers(0, len(pats), P)
    cand = rng.integers(0, text.size - 40, P)
    got = _assert_k2_equals_plain(_k2_args(text, pats, cand, qidx, cuda),
                                  33, text.size)
    assert int((got[0] <= 2).sum()) > 0


@pytest.mark.parametrize("extra", [[], ["-e", "1"], ["-h", "1"]],
                         ids=["exact", "e1", "h1"])
def test_dnavsprot_complete_on_card_equals_cpu(cuda, tmp_path, extra):
    """``vmatch -complete -dnavsprot 1`` on the card prints what it
    prints on the CPU; K2 launches for ``-e``."""
    import io

    import chip_smoke

    from vstree_tpu_torch.cli import mkvtree, vmatch

    rng = np.random.default_rng(36)
    prot = [chip_smoke.AMINO[rng.integers(0, 20, n)] for n in
            (40_000, 25_000, 30_000)]
    db = tmp_path / "p.faa"
    chip_smoke.write_fasta(db, ["a", "b", "c"], [p.tobytes() for p in prot])
    queries, _ = chip_smoke.dnavsprot_queries(rng, prot, 300, (45, 90),
                                              bool(extra))
    qf = tmp_path / "q.fna"
    chip_smoke.write_fasta(qf, [f"q{i}" for i in range(300)], queries)
    index = str(tmp_path / "p")
    assert mkvtree.run(["-db", str(db), "-protein", "-pl", "-allout",
                        "-indexname", index], cuda) == 0
    outs = []
    before = myers.verify_edit.launches
    for dev in (cuda, "cpu"):
        buf = io.StringIO()
        assert vmatch.run(["-complete", "-dnavsprot", "1"] + extra
                          + ["-q", str(qf), index], dev, out=buf) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].count("\n") > 300
    if extra[:1] == ["-e"]:
        assert myers.verify_edit.launches > before


def _records_with_wild_ends(seed, nrec):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(nrec):
        r = rng.integers(0, 4, int(rng.integers(200, 6000))).astype(np.uint8)
        r[rng.choice(r.size, r.size // 200 + 1, replace=False)] = 254
        if i % 3 == 0:
            r[-int(rng.integers(1, 9)):] = 254
        if i % 5 == 4:
            r = recs[-1].copy()
        recs.append(r)
    return recs


def test_merge_cross_counts_on_card_equal_cpu(cuda):
    """The merge's cross counts (binary search + two-text ladder) on CUDA
    tensors equal those on CPU tensors, for both part orders."""
    from vstree_tpu_torch.index import build, merge

    ta, tb = _records_with_wild_ends(71, 2)
    sa = build.suffix_sort(ta, sigma=4, device=cuda)[0][:-1]
    sb = build.suffix_sort(tb, sigma=4, device=cuda)[0][:-1]
    reg = sa[ta[sa] < 254].astype(np.int64)
    for a_first in (True, False):
        got = merge._cross_counts(ta, reg, tb, sb, a_first, device=cuda)
        want = merge._cross_counts(ta, reg, tb, sb, a_first, device="cpu")
        np.testing.assert_array_equal(got, want)
        assert got.max() > 0


@pytest.mark.parametrize("want_lcp", [True, False])
def test_out_of_core_build_on_card_equals_monolithic(cuda, want_lcp):
    """``build_suf_out_of_core`` on the card: shards of at most 20 kbp,
    merged, equal the monolithic build's suffix and lcp tables."""
    from vstree_tpu_torch.index.build import build_suf_out_of_core

    recs = _records_with_wild_ends(72, 40)
    seq = np.concatenate(sum(([r, np.full(1, 255, np.uint8)]
                              for r in recs), [])[:-1])
    ms = _multiseq(seq)
    suf, lcp = build_suf_out_of_core(ms, dna_alphabet(), 20_000, want_lcp,
                                     device=cuda)
    mono = build_esa(ms, dna_alphabet(), demand=("suf", "lcp"), device=cuda)
    np.testing.assert_array_equal(suf, mono.suftab)
    if want_lcp:
        np.testing.assert_array_equal(lcp, mono.lcptab)
    else:
        assert lcp is None


@pytest.mark.parametrize("tool", ["mkcfr", "mkrcidx", "mkdna6idx"])
def test_index_tools_on_card_write_the_cpu_files(cuda, tmp_path, tool):
    """``mkcfr``, ``mkrcidx`` and ``mkdna6idx`` write the same files on
    the card as on the CPU."""
    import chip_smoke

    from vstree_tpu_torch.cli import mkcfr, mkdna6idx, mkrcidx, mkvtree

    rng = np.random.default_rng(73)
    db = tmp_path / "db.fna"
    recs = chip_smoke.make_records(rng, 60_000, 4)
    chip_smoke.write_fasta(db, [f"r{i}" for i in range(4)], recs)
    files = {}
    for dev in (cuda, "cpu"):
        d = tmp_path / str(dev).replace(":", "")
        d.mkdir()
        name = str(d / "idx")
        if tool == "mkcfr":
            for extra in ([], ["-rev"]):
                assert mkvtree.run(["-db", str(db), "-dna"] + extra
                                   + ["-pl", "-allout", "-indexname",
                                      name], cuda) == 0
            assert mkcfr.run([name], dev) == 0
            exts = ("cfr", "rev.crf")
        elif tool == "mkrcidx":
            assert mkrcidx.run(["-db", str(db), "-indexname", name],
                               dev) == 0
            exts = ("rcm.tis", "rcm.suf", "rcm.lcp", "rcm.bwt")
        else:
            assert mkdna6idx.run(["-db", str(db), "-indexname", name],
                                 dev) == 0
            exts = ("6fr.tis", "6fr.suf", "6fr.lcp", "6fr.bwt")
        files[str(dev)] = [open(f"{name}.{e}", "rb").read() for e in exts]
    got, want = files.values()
    assert got == want and all(len(b) > 0 for b in want[:3])


# ---------------------------------------------------------------------------
# the multi-device layer (parallel/)
# ---------------------------------------------------------------------------


def _mesh_text(n, seed):
    t = _text(n, seed, n_wild=9, n_sep=3)
    t[4000:4040] = 0                                  # a poly-A run
    t[9000:9060] = np.tile(t[100:106], 10)            # a tandem array
    t[15000:15500] = t[2000:2500]                     # a copy
    return t


def test_sharded_functions_on_one_card_repeated_equal_cpu(cuda):
    """Four shards on one card (the device list names it four times)
    against four CPU shards and the monolith: the sharded sort, the lcp
    table, build_esa(mesh=), supermax and the interval lookup."""
    from vstree_tpu_torch.engine.supermax import supermax_intervals
    from vstree_tpu_torch.index.build import lcp_table
    from vstree_tpu_torch.parallel.mesh import make_mesh
    from vstree_tpu_torch.parallel.shardesa import (
        exact_interval_lookup_sharded, suffix_sort_sharded,
        supermax_intervals_sharded)

    text = _mesh_text(20_001, 71)
    card, cpu = make_mesh([cuda] * 4), make_mesh(["cpu"] * 4)
    assert card.shape == {"dp": 2, "sp": 2}
    mono = build_esa(_multiseq(text), dna_alphabet(), demand=DEMAND,
                     device="cpu")
    for mesh in (card, cpu):
        suf, sti = suffix_sort_sharded(text, mesh)
        assert (suf == mono.suftab).all() and (sti == mono.stitab).all()
        lcp = lcp_table(text, suf, mesh=mesh, device=cuda)
        assert (lcp == mono.lcptab).all()
        esa = build_esa(_multiseq(text), dna_alphabet(), demand=DEMAND,
                        mesh=mesh, device=cuda)
        for name in ("suftab", "lcptab", "bwttab", "bcktab", "skptab"):
            assert (getattr(esa, name) == getattr(mono, name)).all(), name
    pats, plens = _matrix(_patterns(text, 8, 30, 301, 72))
    want = [supermax_intervals(mono, 6),
            exact_interval_lookup_sharded(mono, pats, plens, cpu)]
    got = [supermax_intervals_sharded(mono, 6, card),
           exact_interval_lookup_sharded(mono, pats, plens, card)]
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            assert np.array_equal(a, b)
    assert want[0][0].size > 10


_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from vstree_tpu_torch.core.alphabet import dna_alphabet
from vstree_tpu_torch.core.multiseq import Multiseq
from vstree_tpu_torch.index.build import build_esa
from vstree_tpu_torch.parallel.distributed import global_mesh, init_multihost
from vstree_tpu_torch.parallel.shardesa import (
    exact_interval_lookup_sharded, supermax_intervals_sharded)
address, world, rank, device, backend, data, out = sys.argv[1:8]
dev = torch.device(device)
assert init_multihost(address, int(world), int(rank), device=dev,
                      backend=backend)
assert dist.get_backend() == backend
mesh = global_mesh(dev)
d = np.load(data)
text = d["text"]
ms = Multiseq(sequence=text, totallength=text.size)
ms.markpos = np.flatnonzero(text == 255).astype(np.uint32)
ms.numofsequences = ms.markpos.size + 1
esa = build_esa(ms, dna_alphabet(), demand=("suf", "lcp", "bwt"),
                mesh=mesh, device=dev)
left, right, depth = supermax_intervals_sharded(esa, 6, mesh)
lo, hi = exact_interval_lookup_sharded(esa, d["pats"], d["plens"], mesh)
if dist.get_rank() == 0:
    np.savez(out, suftab=esa.suftab, lcptab=esa.lcptab, left=left,
             right=right, depth=depth, lo=lo, hi=hi)
dist.destroy_process_group()
"""


def _ranks(tmp_path, devices, backend):
    """Run one rank a device in subprocesses; rank 0's results."""
    import os
    import socket
    import subprocess
    import sys

    text = _mesh_text(20_001, 73)
    pats, plens = _matrix(_patterns(text, 8, 30, 301, 74))
    np.savez(tmp_path / "in.npz", text=text, pats=pats, plens=plens)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, address, str(len(devices)), str(r),
         str(d), backend, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        env=dict(os.environ, PYTHONPATH=repo), cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r, d in enumerate(devices)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    got = np.load(tmp_path / "out.npz")
    from vstree_tpu_torch.engine.supermax import supermax_intervals

    mono = build_esa(_multiseq(text), dna_alphabet(), demand=DEMAND,
                     device="cpu")
    assert (got["suftab"] == mono.suftab).all()
    assert (got["lcptab"] == mono.lcptab).all()
    for key, want in zip(("left", "right", "depth"),
                         supermax_intervals(mono, 6)):
        assert np.array_equal(got[key], want), key
    lo, hi = complete.exact_interval_lookup(mono, pats.copy(), plens.copy())
    hit = np.asarray(hi) > np.asarray(lo)
    assert np.array_equal(got["hi"] - got["lo"],
                          np.where(hit, np.asarray(hi) - lo, 0))
    assert np.array_equal(got["lo"][hit], np.asarray(lo)[hit])


def test_gloo_ranks_share_one_card(cuda, tmp_path):
    """Two gloo ranks with their shards on one card: every collective
    stages through host memory (NCCL refuses two ranks on one device)."""
    _ranks(tmp_path, [cuda, cuda], "gloo")


def test_nccl_ranks_on_two_cards(cuda, tmp_path):
    """One NCCL rank a card on two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    _ranks(tmp_path, [torch.device("cuda", 0), torch.device("cuda", 1)],
           "nccl")


def test_entry_point_trace_holds_both_kernels(cuda, tmp_path, monkeypatch):
    """``python -m vstree_tpu_torch.cli.vmatch -complete -e 1 -q`` under
    VSTREE_PROFILE: the run prints what ``run`` prints in this process,
    and its torch.profiler trace holds as many K1 and K2 events as that
    run launched (CUPTI sees the kernels that the ctypes libraries
    launch)."""
    import io
    import subprocess

    import chip_smoke

    from vstree_tpu_torch.cli import mkvtree, vmatch

    rng = np.random.default_rng(77)
    recs = chip_smoke.make_records(rng, 400_000, 4)
    db, qf = tmp_path / "x.fna", tmp_path / "q.fna"
    chip_smoke.write_fasta(db, [f"r{i}" for i in range(4)], recs)
    # lengths from 14 at 400 kbp: the short queries take the rank path
    monkeypatch.setattr(chip_smoke, "APPROX_MINLEN", 14)
    queries, _ = chip_smoke.make_approx_queries(rng, recs, 2000)
    chip_smoke.write_fasta(qf, [f"q{i}" for i in range(2000)], queries)
    index = str(tmp_path / "x")
    assert mkvtree.run(["-db", str(db), "-dna", "-pl", "-allout",
                        "-indexname", index], cuda) == 0
    argv = ["-complete", "-e", "1", "-q", str(qf), index]
    buf = io.StringIO()
    k1_before = rankcount.rank_interval_lookup.launches
    k2_before = myers.verify_edit.launches
    assert vmatch.run(argv, cuda, out=buf) == 0
    launches = (rankcount.rank_interval_lookup.launches - k1_before,
                myers.verify_edit.launches - k2_before)
    assert min(launches) > 0
    cmd, env = chip_smoke.entry_command(
        "vmatch", argv, {"VSTREE_PROFILE": str(tmp_path / "trace")})
    proc = subprocess.run(cmd, cwd=chip_smoke.ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == buf.getvalue() and buf.getvalue().count("\n") > 100
    summary = chip_smoke.trace_summary(tmp_path / "trace")
    events = tuple(len(summary["kernels"][k])
                   for k in chip_smoke.KERNEL_EVENTS)
    assert events == launches, summary["top"]
    assert 0 < summary["share"] < 1

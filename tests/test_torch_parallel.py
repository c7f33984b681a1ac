"""Port vs JAX package: the multi-device layer
(vstree_tpu_torch/parallel vs vstree_tpu/parallel) on the 8 virtual CPU
devices that conftest gives JAX and 1-8 CPU shards of the port.

The sharded sort, lcp table, supermax scan, interval lookup, match
records and ``build_esa(mesh=)`` must equal the JAX package's and the
port's monolithic results (tolerance 0: equal arrays), with shard counts
that do not divide n, wildcards in patterns and text, and the edge
texts of length 0 and 1 and all wildcards.  The process-group path runs
2 and 4 gloo ranks in subprocesses on CPU tensors.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_dna_text

from vstree_tpu.core.alphabet import dna_alphabet as j_dna_alphabet
from vstree_tpu.core.alphabet import protein_alphabet as j_protein_alphabet
from vstree_tpu.core.multiseq import Multiseq as JMultiseq
from vstree_tpu.engine.supermax import supermax_intervals as j_supermax
from vstree_tpu.index import build as jbuild
from vstree_tpu.parallel import mesh as jmesh
from vstree_tpu.parallel import shardesa as jshard
from vstree_tpu_torch.core.alphabet import dna_alphabet
from vstree_tpu_torch.core.multiseq import Multiseq
from vstree_tpu_torch.engine import complete as tcomplete
from vstree_tpu_torch.engine.supermax import find_supermax
from vstree_tpu_torch.engine.supermax import supermax_intervals
from vstree_tpu_torch.index import build as tbuild
from vstree_tpu_torch.index.esa import ESA
from vstree_tpu_torch.parallel import mesh as tmesh
from vstree_tpu_torch.parallel import shardesa as tshard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = (1, 2, 3, 4, 8)
TABLES = ("suftab", "stitab", "lcptab", "bwttab", "bcktab", "skptab")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The shard programs are many small ops: one thread a worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meshes(ndev):
    return (jmesh.make_mesh(jax.devices()[:ndev]),
            tmesh.make_mesh(["cpu"] * ndev))


def repeat_text(rng, n, sigma=4):
    """Random text of ``sigma`` letters with poly-A runs, tandem arrays,
    copied blocks, N runs and separators."""
    t = rng.integers(0, sigma, n).astype(np.uint8)
    for _ in range(3):                       # poly-A runs
        s = int(rng.integers(0, n - 40))
        t[s:s + int(rng.integers(10, 40))] = 0
    for _ in range(3):                       # tandem arrays
        unit = rng.integers(0, sigma, int(rng.integers(2, 7)))
        arr = np.tile(unit, int(rng.integers(4, 10))).astype(np.uint8)
        s = int(rng.integers(0, n - arr.size))
        t[s:s + arr.size] = arr
    for _ in range(4):                       # copied blocks
        ln = int(rng.integers(20, 60))
        a, b = rng.integers(0, n - ln, 2)
        t[b:b + ln] = t[a:a + ln]
    for _ in range(3):                       # N runs
        s = int(rng.integers(0, n - 8))
        t[s:s + int(rng.integers(1, 8))] = 254
    t[rng.choice(n, 2, replace=False)] = 255
    return t


def _esas(text, protein=False):
    ms = JMultiseq(sequence=text, totallength=text.size)
    ms.markpos = np.flatnonzero(text == 255).astype(np.uint32)
    ms.numofsequences = ms.markpos.size + 1
    alpha = j_protein_alphabet() if protein else j_dna_alphabet()
    jesa = jbuild.build_esa(ms, alpha, demand=("suf", "lcp", "bwt", "bck",
                                               "sti"))
    return jesa, ESA.from_shared(jesa, "cpu")


@pytest.fixture(scope="module")
def dna():
    return _esas(repeat_text(np.random.default_rng(91), 3001))


@pytest.fixture(scope="module")
def protein():
    return _esas(repeat_text(np.random.default_rng(92), 2003, sigma=20),
                 protein=True)


def _patterns(rng, text, B, lo, hi):
    """Substrings of the text (some with its wildcards), random strings
    and substrings with a wildcard put in, -1 padded."""
    plens = rng.integers(lo, hi + 1, B).astype(np.int32)
    pats = np.full((B, hi), -1, np.int32)
    for i in range(B):
        if i % 5 == 4:
            p = rng.integers(0, 4, plens[i])
        else:
            s = int(rng.integers(0, text.size - plens[i]))
            p = text[s:s + plens[i]].astype(np.int32)
            if i % 5 == 3:
                p[plens[i] // 2] = 254
        pats[i, :plens[i]] = p
    return pats, plens


# ---------------------------------------------------------------------------
# rank-sharded lookup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndev", SHARDS)
def test_sharded_exact_match(dna, ndev):
    """counts and first ranks equal the JAX program's, wildcards in the
    text and in the patterns."""
    jesa, _ = dna
    text = jesa.multiseq.sequence
    n = text.size
    jm, tm = _meshes(ndev)
    sp, dp = tm.shape["sp"], tm.shape["dp"]
    R = ((n + 1 + sp - 1) // sp) * sp
    suf = np.full(R, n, np.int32)
    suf[:n + 1] = jesa.suftab
    pats, plens = _patterns(np.random.default_rng(ndev), text, 12 * dp, 3,
                            12)
    want = jmesh.sharded_exact_match(jm, jnp.asarray(text), jnp.asarray(suf),
                                     jnp.asarray(pats), jnp.asarray(plens))
    got = tmesh.sharded_exact_match(tm, text, suf, pats, plens)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert (np.asarray(want[0]) > 0).sum() >= 6 * dp


@pytest.mark.parametrize("ndev", SHARDS)
def test_exact_interval_lookup_sharded(dna, ndev):
    """[lo, hi) equal the JAX sharded lookup's, and the port's
    monolithic lookup's where a pattern occurs (an absent one is [0, 0)
    on the mesh, its insertion rank in the monolith); a pattern count
    that does not divide over dp."""
    jesa, tesa = dna
    text = jesa.multiseq.sequence
    pats, plens = _patterns(np.random.default_rng(10 + ndev), text, 37, 4,
                            16)
    jm, tm = _meshes(ndev)
    want = jshard.exact_interval_lookup_sharded(jesa, pats, plens, jm)
    lo, hi = tshard.exact_interval_lookup_sharded(tesa, pats, plens, tm)
    assert np.array_equal(want[0], lo) and np.array_equal(want[1], hi)
    mlo, mhi = (np.asarray(x, np.int64) for x in
                tcomplete.exact_interval_lookup(tesa, pats.copy(),
                                                plens.copy()))
    hit = mhi > mlo
    assert np.array_equal(hi - lo, np.where(hit, mhi - mlo, 0))
    assert np.array_equal(lo[hit], mlo[hit]) and 10 < hit.sum() < 37


@pytest.mark.parametrize("cap", [512, 3], ids=["cap512", "overflow"])
def test_sharded_exact_match_records(dna, cap):
    """Records [S, B, cap] equal the JAX program's, also where a shard
    holds more occurrences than ``cap``."""
    jesa, _ = dna
    text = jesa.multiseq.sequence
    n = text.size
    jm, tm = _meshes(4)
    R = ((n + 1 + 1) // 2) * 2
    suf = np.full(R, n, np.int32)
    suf[:n + 1] = jesa.suftab
    pats, plens = _patterns(np.random.default_rng(cap), text, 16, 3, 8)
    want = jshard.sharded_exact_match_records(
        jm, jnp.asarray(text), jnp.asarray(suf), jnp.asarray(pats),
        jnp.asarray(plens), cap)
    got = tshard.sharded_exact_match_records(tm, text, suf, pats, plens,
                                             cap)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert bool((got[3] > cap).any()) == (cap == 3)


# ---------------------------------------------------------------------------
# sharded build
# ---------------------------------------------------------------------------


def _sort_text(kind):
    rng = np.random.default_rng(7)
    return {"empty": np.zeros(0, np.uint8),
            "one": np.array([2], np.uint8),
            "wild": np.full(53, 254, np.uint8),
            "odd": random_dna_text(rng, 1001, n_wild=9, n_sep=4),
            "repeats": repeat_text(rng, 1999)}[kind]


@pytest.mark.parametrize("kind", ["empty", "one", "wild", "odd",
                                  "repeats"])
@pytest.mark.parametrize("ndev", [2, 3, 8])
def test_suffix_sort_sharded(kind, ndev):
    """suftab and stitab equal the JAX sharded sort's and the port's
    monolith's; n = 0, 1, all wildcards, n no multiple of the shards."""
    text = _sort_text(kind)
    jm, tm = _meshes(ndev)
    want = jshard.suffix_sort_sharded(text, jm)
    got = tshard.suffix_sort_sharded(text, tm)
    mono = tbuild.suffix_sort(text, device="cpu")
    for w, g, m in zip(want, got, mono):
        assert np.array_equal(w, g) and np.array_equal(m, g)


@pytest.mark.parametrize("kind", ["empty", "one", "wild", "odd",
                                  "repeats", "polya"])
@pytest.mark.parametrize("ndev", [1, 3, 8])
def test_lcp_table_mesh(kind, ndev):
    """lcp_table(mesh=) equals the JAX mesh path and the port's ladder;
    a poly-A text keeps most pairs active (the widening rounds), the
    repeats leave a few deep stragglers (the compacted rounds)."""
    text = (np.zeros(2500, np.uint8) if kind == "polya"
            else _sort_text(kind))
    if kind == "polya":
        text[[700, 1800]] = 254
    suf, _ = tbuild.suffix_sort(text, device="cpu")
    jm, tm = _meshes(ndev)
    want = jbuild.lcp_table(text, suf, mesh=jm)
    got = tbuild.lcp_table(text, suf, mesh=tm, device="cpu")
    assert np.array_equal(want, got)
    assert np.array_equal(tbuild.lcp_table(text, suf, device="cpu"), got)


@pytest.mark.parametrize("kind", ["repeats", "polya"])
def test_lcp_table_mesh_in_chunks(monkeypatch, kind):
    """The mesh rounds split a shard's pairs into chunks of at most
    ``_LCP_WINDOW_ELEMS`` window elements; forced small, the table is
    the same."""
    text = (np.zeros(2500, np.uint8) if kind == "polya"
            else _sort_text(kind))
    suf, _ = tbuild.suffix_sort(text, device="cpu")
    monkeypatch.setattr(tbuild, "_LCP_WINDOW_ELEMS", 1 << 12)
    got = tbuild.lcp_table(text, suf, mesh=tmesh.make_mesh(["cpu"] * 3),
                           device="cpu")
    assert np.array_equal(tbuild.lcp_table(text, suf, device="cpu"), got)


@pytest.mark.parametrize("ndev", [2, 3, 8])
def test_build_esa_mesh(ndev):
    """build_esa(mesh=) gives the JAX package's tables (built with its
    mesh) and the port's monolithic ones."""
    text = repeat_text(np.random.default_rng(40 + ndev), 2501)
    jms = JMultiseq(sequence=text, totallength=text.size)
    tms = Multiseq(sequence=text, totallength=text.size)
    for ms in (jms, tms):
        ms.markpos = np.flatnonzero(text == 255).astype(np.uint32)
        ms.numofsequences = ms.markpos.size + 1
    demand = ("suf", "lcp", "bwt", "bck", "sti", "skp")
    jm, tm = _meshes(ndev)
    want = jbuild.build_esa(jms, j_dna_alphabet(), demand=demand, mesh=jm)
    got = tbuild.build_esa(tms, dna_alphabet(), demand=demand, mesh=tm,
                           device="cpu")
    mono = tbuild.build_esa(tms, dna_alphabet(), demand=demand,
                            device="cpu")
    for name in TABLES:
        w, g, m = (getattr(e, name) for e in (want, got, mono))
        assert np.array_equal(w, g) and np.array_equal(m, g), name
    assert got.maxbranchdepth == want.maxbranchdepth > 0


def test_doubling_round_and_full_step():
    """One sharded doubling round (new ranks and the sort order) and the
    full step equal the JAX package's."""
    rng = np.random.default_rng(3)
    n = 1024
    text = random_dna_text(rng, n)
    rank = text.astype(np.int32)
    suf, _ = tbuild.suffix_sort(text, device="cpu")
    pats, plens = _patterns(rng, text, 16, 3, 10)
    jm, tm = _meshes(8)
    for k in (1, 4):
        w_rank, w_si = jmesh.doubling_round_sharded(jm, jnp.asarray(rank), k)
        g_rank, g_si = tmesh.doubling_round_sharded(tm, rank, k)
        assert np.array_equal(np.asarray(w_rank), g_rank.numpy())
        assert np.array_equal(np.asarray(w_si), g_si.numpy())
        rank = g_rank.numpy().astype(np.int32)
    want = jmesh.full_step(jm, jnp.asarray(text), jnp.asarray(suf[:n]),
                           jnp.asarray(rank), jnp.asarray(pats),
                           jnp.asarray(plens), 8)
    got = tmesh.full_step(tm, text, suf[:n], rank, pats, plens, 8)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


# ---------------------------------------------------------------------------
# sharded supermax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alphabet", ["dna", "protein"])
@pytest.mark.parametrize("ndev", [None, 2, 4, 8])
def test_supermax_intervals_sharded(request, alphabet, ndev):
    """(left, right, depth) equal the JAX program's (monolithic scan for
    mesh=None) and the port's NumPy enumeration, at several lengths."""
    jesa, tesa = request.getfixturevalue(alphabet)
    jm, tm = _meshes(ndev) if ndev else (None, None)
    seen = 0
    for L in (2, 4, 9):
        want = jshard.supermax_intervals_sharded(jesa, L, jm)
        got = tshard.supermax_intervals_sharded(tesa, L, tm)
        mono = supermax_intervals(tesa, L)
        for w, g, m in zip(want, got, mono):
            assert np.array_equal(w, g) and np.array_equal(m, g)
        seen += got[0].size
    assert seen > 20


def test_find_supermax_mesh(dna):
    """find_supermax(mesh=) gives the monolith's match table."""
    _, tesa = dna
    a = find_supermax(tesa, 5)
    b = find_supermax(tesa, 5, mesh=tmesh.make_mesh(["cpu"] * 4))
    assert len(a) > 10
    for f in ("length1", "position1", "position2", "seqnum1", "relpos2"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_supermax_collectives_move_o_of_s_sigma():
    """The elements the scan program's collectives move do not grow with
    n: two texts 16x apart move the same count, at most a few per shard
    and character per scan."""
    moved = []
    for n in (1000, 16000):
        _, tesa = _esas(repeat_text(np.random.default_rng(n), n))
        tm = tmesh.make_mesh(["cpu"] * 8)
        before = tm.comm.moved
        tshard.supermax_intervals_sharded(tesa, 3, tm)
        moved.append(tm.comm.moved - before)
    S, sigma = 8, 4
    assert moved[0] == moved[1]
    assert 0 < moved[0] <= 4 * S * (S - 1) * (sigma + 8)


def _split(x, S):
    return list(torch.from_numpy(x).reshape(S, -1))


@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_scan_collectives_at_shard_borders(S):
    """The global scans of the sharded program against NumPy over the
    whole array, with one and several elements a shard: the segmented
    cumsum (cumsum less its value at the last reset), the reverse
    cummax (torch.flip), the halos, and the forward fill whose key -1
    reads back as 1 under floor % (jnp's %, not torch.fmod)."""
    rng = np.random.default_rng(S)
    fm = tshard._flat_mesh(tmesh.make_mesh(["cpu"] * S))
    for per in (1, 5):
        n = S * per
        x = rng.integers(-3, 4, n).astype(np.int32)
        r = rng.random(n) < 0.3
        cat = np.concatenate

        def run(f, *a):
            return cat([t.numpy() for t in f(fm, *(_split(v, S) for v in a))])

        want = np.empty(n, np.int32)
        acc = 0
        for j in range(n):
            acc = x[j] if r[j] else acc + x[j]
            want[j] = acc
        assert np.array_equal(run(tshard._seg_cumsum_g, x, r), want)
        assert np.array_equal(run(tshard._cumsum_g, x), np.cumsum(x))
        assert np.array_equal(run(tshard._cummax_g, x),
                              np.maximum.accumulate(x))
        assert np.array_equal(run(tshard._rcummax_g, x),
                              np.maximum.accumulate(x[::-1])[::-1])
        assert np.array_equal(
            cat([t.numpy() for t in tshard._shift_right(fm, _split(x, S),
                                                         7)]),
            cat([[7], x[:-1]]))
        assert np.array_equal(
            cat([t.numpy() for t in tshard._shift_left(fm, _split(x, S),
                                                       -9)]),
            cat([x[1:], [-9]]))
        marks = r.copy()
        marks[0] = False                     # no mark before some ranks
        bits = rng.random(n) < 0.5
        idx = np.arange(n, dtype=np.int32)
        keys = np.maximum.accumulate(np.where(marks, idx * 2 + bits, -1))
        got = run(tshard._fill_bit_fwd, marks, bits, idx)
        assert np.array_equal(got, keys % 2 == 1)
        assert keys[0] == -1 and got[0]


def test_supermax_refuses_what_the_int32_pack_cannot_hold():
    """2 * n1p >= 2^31: the JAX message, before any work."""
    fm = tshard._flat_mesh(tmesh.make_mesh(["cpu"] * 2))
    with pytest.raises(ValueError) as got:
        tshard._supermax_flags_sharded(fm, [], [], 2 ** 30, 5, 4)
    jfm = jshard._flat_mesh(jmesh.make_mesh(jax.devices()[:2]))
    with pytest.raises(ValueError) as want:
        jshard._supermax_flags_sharded_fn(2 ** 30, 5, 4, jfm)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("numproc,shape", [(1, (1, 1)), (2, (1, 2)),
                                           (3, (1, 3)), (4, (2, 2)),
                                           (6, (2, 3)), (8, (2, 4))])
def test_numproc_mesh_shapes(numproc, shape):
    """The split rule of the JAX package: dp = 2 when n is even and at
    least 4; repeated devices allowed."""
    jm = jshard.numproc_mesh(numproc)
    tm = tshard.numproc_mesh(numproc, ["cpu"] * 8)
    assert tuple(tm.shape.values()) == tuple(jm.shape.values()) == shape
    assert tm.axis_names == ("dp", "sp") == tuple(jm.axis_names)
    assert int(np.prod(list(tm.shape.values()))) == numproc


def test_numproc_mesh_refusal_is_the_jax_message():
    with pytest.raises(SystemExit) as want:
        jshard.numproc_mesh(9)
    with pytest.raises(SystemExit) as got:
        tshard.numproc_mesh(9, ["cpu"] * 8)
    assert str(got.value) == str(want.value) == (
        "vmatch: -numproc 9 exceeds the 8 available devices")


def test_init_multihost_without_a_run_is_a_no_op(monkeypatch):
    """Neither arguments nor torchrun's variables: no process group."""
    from vstree_tpu_torch.parallel.distributed import init_multihost

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_multihost(device="cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_multihost("tcp://127.0.0.1:1", rank=0,
                          device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_make_mesh_without_devices_needs_cuda(monkeypatch):
    """No default device list falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tmesh.make_mesh()


# ---------------------------------------------------------------------------
# the process-group path: gloo ranks on CPU tensors
# ---------------------------------------------------------------------------


_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from vstree_tpu_torch.core.alphabet import dna_alphabet
    from vstree_tpu_torch.core.multiseq import Multiseq
    from vstree_tpu_torch.index.build import build_esa
    from vstree_tpu_torch.parallel.distributed import (global_mesh,
                                                       init_multihost)
    from vstree_tpu_torch.parallel.shardesa import (
        exact_interval_lookup_sharded, suffix_sort_sharded,
        supermax_intervals_sharded)
    torch.set_num_threads(1)
    data, out = sys.argv[1:3]
    assert init_multihost(device="cpu")      # torchrun's variables
    assert dist.get_backend() == "gloo"
    mesh = global_mesh("cpu")
    d = np.load(data)
    text = d["text"]
    ms = Multiseq(sequence=text, totallength=text.size)
    ms.markpos = np.flatnonzero(text == 255).astype(np.uint32)
    ms.numofsequences = ms.markpos.size + 1
    esa = build_esa(ms, dna_alphabet(), demand=("suf", "lcp", "bwt"),
                    mesh=mesh, device="cpu")
    suf, sti = suffix_sort_sharded(text, mesh)
    left, right, depth = supermax_intervals_sharded(esa, 4, mesh)
    lo, hi = exact_interval_lookup_sharded(esa, d["pats"], d["plens"], mesh)
    if dist.get_rank() == 0:
        np.savez(out, suftab=esa.suftab, lcptab=esa.lcptab, suf=suf,
                 sti=sti, left=left, right=right, depth=depth, lo=lo, hi=hi,
                 shape=np.array(list(mesh.shape.values())))
    dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [2, 4])
def test_process_group_ranks_equal_the_mesh_and_the_monolith(tmp_path,
                                                             world):
    """``world`` gloo ranks, one shard each, built from torchrun's
    environment variables: build_esa(mesh=), the sharded sort, supermax
    and lookup equal the single-process mesh of as many shards and the
    monolith."""
    rng = np.random.default_rng(world)
    text = repeat_text(rng, 1501)
    pats, plens = _patterns(rng, text, 21, 4, 12)
    np.savez(tmp_path / "in.npz", text=text, pats=pats, plens=plens)
    port = str(_free_port())
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, WORLD_SIZE=str(world), RANK=str(rank),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK, str(tmp_path / "in.npz"),
             str(tmp_path / "out.npz")], env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    got = np.load(tmp_path / "out.npz")
    assert tuple(got["shape"]) == ((2, 2) if world == 4 else (1, 2))

    ms = Multiseq(sequence=text, totallength=text.size)
    ms.markpos = np.flatnonzero(text == 255).astype(np.uint32)
    ms.numofsequences = ms.markpos.size + 1
    mono = tbuild.build_esa(ms, dna_alphabet(),
                            demand=("suf", "lcp", "bwt", "sti"), device="cpu")
    tm = tmesh.make_mesh(["cpu"] * world)
    one = {"suf": tshard.suffix_sort_sharded(text, tm)[0]}
    one["left"], one["right"], one["depth"] = \
        tshard.supermax_intervals_sharded(mono, 4, tm)
    one["lo"], one["hi"] = tshard.exact_interval_lookup_sharded(
        mono, pats, plens, tm)
    assert np.array_equal(got["suftab"], mono.suftab)
    assert np.array_equal(got["suf"], mono.suftab)
    assert np.array_equal(got["sti"], mono.stitab)
    assert np.array_equal(got["lcptab"], mono.lcptab)
    for key, want in zip(("left", "right", "depth"),
                         supermax_intervals(mono, 4)):
        assert np.array_equal(got[key], want), key
    for key in ("suf", "left", "right", "depth", "lo", "hi"):
        assert np.array_equal(got[key], one[key]), key
    mlo, mhi = (np.asarray(x, np.int64) for x in
                tcomplete.exact_interval_lookup(mono, pats.copy(),
                                                plens.copy()))
    hit = mhi > mlo
    assert np.array_equal(got["hi"] - got["lo"], np.where(hit, mhi - mlo, 0))
    assert np.array_equal(got["lo"][hit], mlo[hit])
    assert got["left"].size > 5 and hit.sum() > 10

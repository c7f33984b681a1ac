#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vstree_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout
    python3 chip_smoke.py --profile   # also: device time of the
                                      # approximate runs (torch.profiler)

1. Prints the card (name, power limit) and the torch / CUDA / nvcc
   versions; exits non-zero, printing no result, without a CUDA device
   or outside a checkout.
2. Builds the kernels from ``vstree_tpu_torch/native/csrc``.
3. Drives the main path at genome scale through the CLIs' ``run``:
   ``mkvtree -dna -pl -allout`` over 16 Mbp of seeded synthetic DNA in
   8 FASTA records (with short N runs), then ``vmatch -complete -q``
   with 100,000 queries of length 24-36 (90 % sampled from the text,
   10 % random).  Prints the seconds of every build and query phase
   and the query rate; fails if kernel K1 was not launched.  The phase
   "rank words" is the lookup plan: the bucket table at the lookup
   depth, made on the card, and the uploads of ``suf`` and the text.
4. Checks the output independently: the reported positions of 1,000
   queries against a ``bytes.find`` scan of the records, and suffix
   order and LCP values at 10,000 random ranks by direct comparison.
5. Drives the approximate path on the same index: ``vmatch -complete
   -e 1 -q`` and ``vmatch -complete -h 1 -q`` with 50,000 queries of
   length 20-32 (70 % sampled with 0-2 injected substitutions / indels,
   20 % sampled exactly, 10 % random); at this text size lengths up to
   22 (-h: 23) take the rank path and longer ones the region path.
   Fails if kernel K2 was not launched, or K1 in either run.  A NumPy
   DP confirms the
   (position, length, distance) of sampled rows, and queries with
   planted errors <= 1 must report their origin.
6. Holds K1 and K2 against their plain PyTorch versions on the card, on
   the inputs the main path gave them (K1: all 100,000 queries) and on
   an edge set each (exact equality; K1's also against a direct scan),
   times them (with the L2 flushed in front of each launch, as the
   main path's single launch finds it, and in a loop), and computes
   each kernel's bound (the least time the card could take) from this
   run's inputs: for K1 from the ranks whose keys any search must
   compare to know the answers.

The line before last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
SEED = 20261016
TEXT_BP = 16_000_000
RECORDS = 8
NQUERIES = 100_000
MINLEN, MAXLEN = 24, 36
RANDOM_SHARE = 0.1
NAIVE_QUERIES = 1_000
SPOT_RANKS = 10_000
APPROX_QUERIES = 50_000
APPROX_MINLEN, APPROX_MAXLEN = 20, 32
APPROX_K = 1
DP_ROWS = 2_000
PLANTED_QUERIES = 2_000
LETTERS = np.frombuffer(b"acgt", np.uint8)
# published peaks of one H100 SXM: device memory rate, and 32-bit integer
# operations outside the tensor cores (132 SMs x 64 INT32 lanes x
# 1.98 GHz: half the FP32 lanes behind the 67 TFLOP/s float32 rate)
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 16.75e12
K2_OPS_PER_COLUMN = 25  # integer instructions of one Myers column


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_records(rng, total: int, nrec: int) -> list[bytes]:
    """``nrec`` records of random acgt with 2-4 short runs of n each."""
    recs = []
    for _ in range(nrec):
        seq = LETTERS[rng.integers(0, 4, total // nrec)]
        for _ in range(int(rng.integers(2, 5))):
            st = int(rng.integers(0, seq.size - 64))
            seq[st:st + int(rng.integers(3, 40))] = ord("n")
        recs.append(seq.tobytes())
    return recs


def write_fasta(path: Path, names: list[str], seqs: list[bytes],
                width: int = 80) -> None:
    with open(path, "wb") as fh:
        for name, s in zip(names, seqs):
            fh.write(b">" + name.encode() + b"\n")
            for j in range(0, len(s), width):
                fh.write(s[j:j + width] + b"\n")


def make_queries(rng, recs: list[bytes], nq: int):
    """The bench.py workload: lengths 24-36; 90 % substrings of the
    records (n-free windows), 10 % random.  Returns the queries and
    which of them were taken from the records."""
    lens = rng.integers(MINLEN, MAXLEN + 1, nq)
    sampled = rng.random(nq) >= RANDOM_SHARE
    out = []
    for ln, take in zip(lens, sampled):
        if not take:
            out.append(LETTERS[rng.integers(0, 4, ln)].tobytes())
            continue
        while True:
            r = recs[int(rng.integers(0, len(recs)))]
            st = int(rng.integers(0, len(r) - ln))
            q = r[st:st + ln]
            if b"n" not in q:
                out.append(q)
                break
    return out, sampled


# ---------------------------------------------------------------------------
# independent checks
# ---------------------------------------------------------------------------


def parse_rows(path: Path) -> dict[int, set]:
    """query number -> {(record, relpos)} from vmatch's default rows
    (length1 seqnum1 relpos1 D length2 seqnum2 relpos2 ...)."""
    hits: dict[int, set] = {}
    with open(path) as fh:
        header = fh.readline()
        if not header.startswith("# args="):
            raise AssertionError(f"vmatch output header: {header!r}")
        for line in fh:
            f = line.split()
            if f[3] != "D" or f[0] != f[4]:
                raise AssertionError(f"unexpected row: {line!r}")
            hits.setdefault(int(f[5]), set()).add((int(f[1]), int(f[2])))
    return hits


def naive_check(rng, recs, queries, hits) -> int:
    """Reported positions of NAIVE_QUERIES sampled queries equal a
    bytes.find scan of every record."""
    count = min(NAIVE_QUERIES, len(queries))
    for qi in rng.choice(len(queries), count, replace=False):
        q = queries[qi]
        want = set()
        for ri, r in enumerate(recs):
            p = r.find(q)
            while p >= 0:
                want.add((ri, p))
                p = r.find(q, p + 1)
        got = hits.get(int(qi), set())
        if got != want:
            raise AssertionError(
                f"query {qi}: vmatch reports {sorted(got)[:5]}, "
                f"a scan finds {sorted(want)[:5]}")
    return count


def spot_check_index(rng, index: Path) -> int:
    """Suffix order and LCP at SPOT_RANKS random ranks, compared on the
    encoded text directly (specials >= 254 beat regular chars and order
    by position; the sentinel is last; specials never match)."""
    t = np.fromfile(f"{index}.tis", np.uint8).tobytes()
    suf = np.fromfile(f"{index}.suf", "<u8").astype(np.int64)
    lcp = np.fromfile(f"{index}.lcp", np.uint8).astype(np.int64)
    llv = np.fromfile(f"{index}.llv", "<u8").reshape(-1, 2).astype(np.int64)
    lcp[llv[:, 0]] = llv[:, 1]
    n = len(t)
    if suf.size != n + 1 or not np.array_equal(np.sort(suf),
                                               np.arange(n + 1)):
        raise AssertionError("suftab is not a permutation of 0..n")
    for r in rng.integers(1, n + 1, SPOT_RANKS):
        a, b = int(suf[r - 1]), int(suf[r])
        d = 0
        while (a + d < n and b + d < n and t[a + d] == t[b + d]
               and t[a + d] < 254):
            d += 1
        if d != lcp[r]:
            raise AssertionError(f"lcp[{r}] = {lcp[r]}, direct {d}")
        if a + d >= n:
            less = False                  # a is the sentinel
        elif b + d >= n:
            less = True
        elif t[a + d] >= 254 and t[b + d] >= 254:
            less = a < b
        elif t[a + d] >= 254 or t[b + d] >= 254:
            less = t[b + d] >= 254
        else:
            less = t[a + d] < t[b + d]
        if not less:
            raise AssertionError(f"ranks {r - 1}, {r} out of order")
    return SPOT_RANKS


# ---------------------------------------------------------------------------
# the approximate path: queries and independent checks
# ---------------------------------------------------------------------------


def make_approx_queries(rng, recs: list[bytes], nq: int):
    """Queries of length 20-32: 70 % windows of the records with 0-2
    injected substitutions / indels, 20 % exact windows, 10 % random.
    Returns the queries and, per query, its origin ``(record, relpos,
    errors, substitutions only)`` or None for a random one."""
    lens = rng.integers(APPROX_MINLEN, APPROX_MAXLEN + 1, nq)
    kinds = rng.random(nq)
    queries, origins = [], []
    for ln, kind in zip(lens, kinds):
        ln = int(ln)
        if kind < 0.1:
            queries.append(LETTERS[rng.integers(0, 4, ln)].tobytes())
            origins.append(None)
            continue
        while True:
            ri = int(rng.integers(0, len(recs)))
            st = int(rng.integers(0, len(recs[ri]) - ln - 2))
            window = recs[ri][st:st + ln + 2]
            if b"n" not in window:
                break
        q = bytearray(window)
        nerr = 0 if kind < 0.3 else int(rng.integers(0, 3))
        subs_only = True
        for _ in range(nerr):
            op, at = int(rng.integers(0, 3)), int(rng.integers(0, ln))
            letter = int(LETTERS[rng.integers(0, 4)])
            if op == 0:
                q[at] = letter
            elif op == 1:
                del q[at]
                subs_only = False
            else:
                q.insert(at, letter)
                subs_only = False
        queries.append(bytes(q[:ln]))
        origins.append((ri, st, nerr, subs_only))
    return queries, origins


def parse_approx_rows(path: Path) -> list[tuple]:
    """(query, record, relpos, length1, distance) per row of vmatch's
    default rows (length1 seqnum1 relpos1 D length2 seqnum2 relpos2
    distance evalue score identity)."""
    rows = []
    with open(path) as fh:
        header = fh.readline()
        if not header.startswith("# args="):
            raise AssertionError(f"vmatch output header: {header!r}")
        for line in fh:
            f = line.split()
            if f[3] != "D" or len(f) != 11:
                raise AssertionError(f"unexpected row: {line!r}")
            rows.append((int(f[5]), int(f[1]), int(f[2]), int(f[0]),
                         int(f[7])))
    return rows


def longest_match(pattern: bytes, window: bytes, maxlen: int):
    """(length, distance) as the reference's longest-match rule gives
    them (longestmatch.c:6-11): over the window's prefixes of 1..maxlen
    chars, the unit-cost edit distance to the whole pattern, keeping
    the longest prefix whose distance is <= the best so far.  Plain
    dynamic programming, one column per window char."""
    m = len(pattern)
    col = list(range(m + 1))
    bestlen, best = 0, m
    for j, c in enumerate(window[:maxlen], 1):
        prev, col[0] = col[0], j
        for i in range(1, m + 1):
            cur = min(col[i] + 1, col[i - 1] + 1,
                      prev + (pattern[i - 1] != c))
            prev, col[i] = col[i], cur
        if best >= col[m]:
            bestlen, best = j, col[m]
    return bestlen, best


def approx_checks(rng, recs, queries, origins, rows, edit: bool) -> dict:
    """Every row's distance is within the threshold's sign convention;
    DP_ROWS sampled rows carry the (length, distance) a direct
    computation on the record gives; PLANTED_QUERIES queries with <= k
    planted errors report their origin."""
    k = APPROX_K
    by_query: dict[int, set] = {}
    for q, ri, rel, _, _ in rows:
        by_query.setdefault(q, set()).add((ri, rel))
    for i in rng.choice(len(rows), min(DP_ROWS, len(rows)), replace=False):
        q, ri, rel, length, dist = rows[i]
        pat = queries[q]
        if edit:
            want = longest_match(pat, recs[ri][rel:rel + len(pat) + k],
                                 len(pat) + k)
        else:
            win = recs[ri][rel:rel + len(pat)]
            want = (len(pat), -sum(a != b for a, b in zip(pat, win))
                    if len(win) == len(pat) else None)
        if (length, dist) != want:
            raise AssertionError(
                f"row {rows[i]}: a direct computation gives (length, "
                f"distance) = {want}")
    over = sum(1 for r in rows if abs(r[4]) > k)
    if not edit and over:
        raise AssertionError(f"{over} Hamming rows exceed {k} mismatches")
    # planted origins: Hamming matches substitutions only, at the exact
    # place; an edit match with <= k errors starts at the origin too
    planted = [i for i, o in enumerate(origins)
               if o is not None and o[2] <= k and (edit or o[3])]
    picked = rng.choice(planted, min(PLANTED_QUERIES, len(planted)),
                        replace=False)
    from vstree_tpu_torch.engine.approx import _getoptsplit

    n = sum(len(r) for r in recs) + len(recs) - 1
    missed_rank, missed_region, nregion = [], [], 0
    for i in picked:
        ri, st = origins[i][:2]
        found = (ri, st) in by_query.get(int(i), ())
        onrank = _getoptsplit(4, n, len(queries[i]), k, edit) == 1
        nregion += not onrank
        if not found:
            (missed_rank if onrank else missed_region).append(int(i))
    # the rank path and both Hamming routes are exact.  The edit region
    # path replays the reference's Ukkonen-cutoff scan, whose
    # column-extension shortcut may miss a true start: allow 1 %
    if missed_rank or (missed_region and not edit) \
            or len(missed_region) > 0.01 * max(nregion, 1):
        raise AssertionError(
            f"planted origins not reported: rank path {missed_rank[:5]}, "
            f"region path {len(missed_region)} of {nregion} "
            f"{missed_region[:5]}")
    return {"dp_rows": min(DP_ROWS, len(rows)), "planted": len(picked),
            "planted_region_missed": len(missed_region),
            "rows_over_k": over}


def device_time_report(prof, wall: float) -> None:
    """Log the device time a profiled run spent (kernels and copies),
    its share of the wall time, and the five largest items."""
    import torch

    # device-side events only: a host op's entry repeats the time of
    # the kernels it launched
    items = sorted(((e.self_device_time_total, e.key)
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA),
                   reverse=True)
    total = sum(t for t, _ in items) / 1e6
    log(f"  device time {total:.4f} s of {wall:.3f} s wall "
        f"({100 * total / wall:.2f} %), profiler on")
    for t, key in items[:5]:
        log(f"    {t / 1e3:10.3f} ms  {key[:70]}")


def approx_phase(rng, recs, index: Path, dev, profile: bool) -> dict:
    """``vmatch -complete -e 1`` and ``-h 1`` on the card, with phase
    timings, K2's launch count over both runs, and the checks.  With
    ``profile`` each run is traced by torch.profiler (its times then
    include the tracing)."""
    import contextlib

    import torch

    from vstree_tpu_torch.cli import vmatch
    from vstree_tpu_torch.device import PhaseTimes, record_phases
    from vstree_tpu_torch.native.myers import verify_edit
    from vstree_tpu_torch.native.rankcount import rank_interval_lookup

    nq = APPROX_QUERIES
    queries, origins = make_approx_queries(rng, recs, nq)
    qf = WORK / "approx_q.fna"
    write_fasta(qf, [f"a{i}" for i in range(nq)], queries)
    verify_edit.launches = 0
    rank_interval_lookup.launches = 0
    result = {"queries": queries}
    for flag, edit in (("-e", True), ("-h", False)):
        out = WORK / f"vmatch{flag}.out"
        times = PhaseTimes(dev)
        before = verify_edit.launches
        before_k1 = rank_interval_lookup.launches
        tracer = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
            if profile else contextlib.nullcontext())
        t0 = time.perf_counter()
        with tracer, record_phases(times), open(out, "w") as fh:
            vmatch.run(["-complete", flag, str(APPROX_K), "-q", str(qf),
                        str(index)], dev, out=fh)
        wall = time.perf_counter() - t0
        log(f"vmatch -complete {flag} {APPROX_K}: {wall:.3f} s wall, "
            f"{nq / wall:.0f} queries/s end to end; K2 launches: "
            f"{verify_edit.launches - before}; K1 launches: "
            f"{rank_interval_lookup.launches - before_k1}")
        if rank_interval_lookup.launches == before_k1:
            raise AssertionError(
                f"vmatch -complete {flag} never launched K1")
        for name, sec in times.seconds.items():
            log(f"  {name:16s} {sec:9.3f} s")
        log(f"  {'(other)':16s} {wall - sum(times.seconds.values()):9.3f} s")
        if profile:
            device_time_report(tracer, wall)
        rows = parse_approx_rows(out)
        hit = len({r[0] for r in rows})
        log(f"  rows: {len(rows)}; queries with a match: {hit}")
        checks = approx_checks(rng, recs, queries, origins, rows, edit)
        log(f"  checks: {checks}")
        result[flag] = rows
    result["launches"] = verify_edit.launches
    log(f"approximate path: K2 launches {verify_edit.launches}, K1 "
        f"launches {rank_interval_lookup.launches}")
    return result


# ---------------------------------------------------------------------------
# K1 and K2 against their plain versions
# ---------------------------------------------------------------------------


def encode(queries: list[bytes]) -> list[np.ndarray]:
    code = np.full(256, 254, np.uint8)
    code[list(b"acgt")] = np.arange(4)
    return [code[np.frombuffer(q, np.uint8)] for q in queries]


def k1_inputs(esa, queries: list[bytes]):
    """The arguments the main path gave K1: the same plan and packing
    as exact_complete_matches, on the queries' encoded form.  Returns
    (flat8, bck, suf, text) on the card and the scalars
    (n, ppl, cpw, sigma, shift)."""
    import torch

    from vstree_tpu_torch.engine.complete import RankLookupPlan

    plens = np.array([len(q) for q in queries], np.int32)
    pats = np.full((len(queries), plens.max()), -1, np.int32)
    for i, p in enumerate(encode(queries)):
        pats[i, :p.size] = p
    plan = RankLookupPlan(esa, int(plens.min()), pats.shape[1])
    if not plan.ok:
        raise AssertionError("the rank-lookup plan refused the workload")
    flat8 = torch.from_numpy(plan.pack(pats, plens)).to(esa.dev)
    return ([flat8, plan.bck, plan.suf, plan.text],
            (esa.totallength, plan.ppl, plan.cpw, plan.sigma, plan.shift))


def time_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_flushed_ms(fn, reps: int) -> list[float]:
    """Sorted times of ``reps`` single calls, each with the 50 MB L2
    flushed in front of it.  The main path launches a kernel once, after
    other work, and finds none of its inputs in the L2, as a loop of
    equal launches does: so this is the time a kernel is reported with,
    and the loop's time is printed beside it."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)


def _suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of a small text by direct comparison: a special char
    (>= 254) beats every regular one and orders by its position; the
    sentinel suffix n comes last."""
    n = text.size
    keys = [tuple(int(c) if c < 254 else 1000 + i + j
                  for j, c in enumerate(text[i:])) + (1000 + n,)
            for i in range(n + 1)]
    return np.array(sorted(range(n + 1), key=keys.__getitem__), np.int32)


def k1_edge_set(kind: str) -> dict:
    """K1's edge set as NumPy arrays, made without the code under test
    but for the NumPy bucket table: a 1,500-char text with wildcards,
    separators and a run of the last letter (the last bucket), its
    suffix array by direct comparison, and queries of every length from
    ppl to the coverage that end at the text end and just before each
    special, prefixes of every 40th suffix, the widest bucket's prefix,
    misses, queries with a wildcard and padding rows.  ``kind``: "dna"
    (sigma 4, 13 chars per word), "protein" (20, 7) or "other" (7, 10:
    the kernel's generic path).  ``counts`` holds each query's number of
    occurrences by a direct scan."""
    from vstree_tpu_torch.index.build import bck_table

    sigma, cpw, ppl = {"dna": (4, 13, 2), "protein": (20, 7, 1),
                       "other": (7, 10, 2)}[kind]
    rng = np.random.default_rng(SEED + 3 + sigma)
    n, cov = 1500, ppl + 2 * cpw
    text = rng.integers(0, sigma, n).astype(np.uint8)
    text[[90, 400, 401, 800, n - 60]] = 255
    text[[200, 640, 1100]] = 254
    text[1200:1230] = sigma - 1
    text[n - cov:] = rng.integers(0, sigma, cov)  # regular to the end
    text[700:700 + cov] = text[n - cov:]          # ... and seen before
    suf = _suffix_array(text)
    pats = []
    special = np.flatnonzero(text >= 254)
    for ln in range(ppl, cov + 1):
        pats.append(text[n - ln:])
        pats += [text[s - ln:s] for s in special if s >= ln]
        pats.append(rng.integers(0, sigma, ln).astype(np.uint8))
    for s in range(0, n - cov, 40):
        pats.append(text[s:s + int(rng.integers(ppl, cov + 1))])
    pats.append(text[1200:1200 + ppl])
    pats.append(text[1200:1200 + cov])
    pats.append(np.zeros(0, np.uint8))  # a padding row
    B = len(pats)
    flat = np.full((cov + 1, B), -1, np.int8)
    counts = np.zeros(B, np.int32)
    for i, p in enumerate(pats):
        flat[:p.size, i] = np.where(p < sigma, p, 120)
        flat[cov, i] = p.size
        if p.size and (p < sigma).all():
            win = np.lib.stride_tricks.sliding_window_view(text, p.size)
            counts[i] = (win == p).all(1).sum()
    raw = bck_table(text, sigma, ppl).astype(np.int64)
    shift = 11
    packed = raw[0::2] | ((raw[1::2] - raw[0::2]) << shift)
    bck = np.zeros((packed.size // 128 + 1) * 128, np.int32)
    bck[:packed.size] = packed
    return {"tensors": [flat.reshape(-1), bck, suf, text], "B": B,
            "scalars": (n, ppl, cpw, sigma, shift), "counts": counts}


def k1_needed(flat8, bck, lo, hi, ppl, cpw, sigma, shift) -> dict:
    """What the function needs on these inputs however it searches: the
    answer (lo, hi) of a bracket [left, end) is known only when the keys
    of the ranks on both sides of each border have been compared, those
    of lo - 1, lo, hi - 1 and hi that lie inside the bracket.  Counts
    the distinct such ranks over all queries (a compare reads at least
    one suf entry and one text char) and the buckets hit.  ``lo`` and
    ``hi`` are the plain version's."""
    import torch

    from vstree_tpu_torch.native.rankcount import rank_lookup_inputs

    left, width = rank_lookup_inputs(flat8, bck, ppl, cpw, sigma, shift)[:2]
    left, end = left[:, None], (left + width)[:, None]
    lo, hi = lo.to(left.device)[:, None], hi.to(left.device)[:, None]
    sides = torch.cat([lo - 1, lo, hi - 1, hi], 1)
    inside = (sides >= left) & (sides < end)
    return {"ranks": int(torch.unique(sides[inside]).numel()),
            "buckets": int(torch.unique(left[width[:, None] > 0]).numel()),
            "window_ranks": int(width.sum())}


def compare_k1(esa, queries, nrows: int) -> dict:
    import torch

    from vstree_tpu_torch.native import rankcount

    # the edge sets, whole and cut to one query and to a ragged block
    for kind in ("dna", "protein", "other"):
        edge = k1_edge_set(kind)
        tensors = [torch.from_numpy(a).to(esa.dev) for a in edge["tensors"]]
        rows = tensors[0].reshape(-1, edge["B"])
        for cut in (edge["B"], 1, 129):
            args = [rows[:, :cut].contiguous().reshape(-1)] + tensors[1:]
            lo, hi = rankcount.rank_interval_lookup(*args, *edge["scalars"])
            rlo, rhi, rerr = rankcount.rank_interval_lookup_ref(
                *args, *edge["scalars"])
            if int(rerr) or not (torch.equal(lo, rlo.cpu())
                                 and torch.equal(hi, rhi.cpu())):
                raise AssertionError(f"K1 differs from its plain version "
                                     f"on the {kind} edge set at B={cut}")
            if not np.array_equal((hi - lo).numpy(), edge["counts"][:cut]):
                raise AssertionError(f"K1's interval widths on the {kind} "
                                     "edge set differ from a direct scan")

    # the main path's batch: all queries of the run
    args, scal = k1_inputs(esa, queries)
    lo, hi = rankcount.rank_interval_lookup(*args, *scal)
    rlo, rhi, rerr = rankcount.rank_interval_lookup_ref(*args, *scal)
    torch.cuda.synchronize()
    err = max(int((lo - rlo.cpu()).abs().max()),
              int((hi - rhi.cpu()).abs().max()), int(rerr))
    if err != 0:
        raise AssertionError(f"K1 differs from its plain version by {err}")
    if int((hi - lo).sum()) != nrows:
        raise AssertionError("K1's intervals do not sum to the rows "
                             "vmatch printed")
    # alternate: plain, kernel, kernel, plain
    B = lo.numel()
    out = torch.empty(2 * B + 1, dtype=torch.int32, device=esa.dev)
    plain = [time_ms(lambda: rankcount.rank_interval_lookup_ref(
        *args, *scal), 5)]
    warm = [time_ms(lambda: rankcount.launch(*args, out, *scal), 100)
            for _ in range(2)]
    wrapper = time_ms(lambda: rankcount.rank_interval_lookup(*args, *scal),
                      50)
    plain.append(time_ms(lambda: rankcount.rank_interval_lookup_ref(
        *args, *scal), 5))
    cold = time_flushed_ms(lambda: rankcount.launch(*args, out, *scal), 20)
    # bound, from this run's data and no property of the kernel.  Bytes,
    # each once: the packed queries, one bracket per bucket hit, a suf
    # entry and a text char per rank that must be compared, the outputs;
    # operations: one per packed query char and one per such rank.
    need = k1_needed(args[0], args[1], rlo, rhi, *scal[1:])
    nbytes = (args[0].numel() + 4 * need["buckets"] + 5 * need["ranks"]
              + 8 * B + 4)
    ops = args[0].numel() + need["ranks"]
    bound = bound_ms(nbytes, ops)
    # the same at the memory system's 32-byte sector grain (a sector of
    # suf and one of text per rank), and with the text resident in L2
    fixed = args[0].numel() + 32 * need["buckets"] + 8 * B
    sect_cold = fixed + 64 * need["ranks"]
    sect_warm = fixed + 32 * need["ranks"]
    log(f"K1 rank_interval_lookup: B={B} needed={need} "
        f"ranks/query={need['ranks'] / B:.2f} max_abs_err=0 "
        f"kernel_ms_l2_flushed(min,median,max)=[{cold[0]:.4f}, "
        f"{cold[len(cold) // 2]:.4f}, {cold[-1]:.4f}] "
        f"kernel_ms_repeated={warm} wrapper_ms={wrapper:.4f} "
        f"plain_ms={plain} bound: {nbytes} bytes, {ops} int ops -> "
        f"{bound}; sectors: {sect_cold} bytes -> "
        f"{sect_cold / PEAK_BYTES_PER_S * 1e3:.5f} ms, text in L2: "
        f"{sect_warm} bytes -> "
        f"{sect_warm / PEAK_BYTES_PER_S * 1e3:.5f} ms")
    return {"max_abs_err": err, "ms": cold[len(cold) // 2],
            "repeated_ms": min(warm), "plain_ms": min(plain), **bound,
            "library_ms": None}


def bound_ms(nbytes: int, int_ops: int) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the integer operations over their peak rate."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = int_ops / PEAK_INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def k2_inputs(esa, queries: list[bytes]):
    """The arguments the main path gave K2's verification launch of
    ``-complete -e``: the rank-path queries, their pigeonhole
    candidates and masks, as ``_esaapm_starts`` makes them.  Returns
    (tensors, L, the rank-path query numbers)."""
    import torch

    from vstree_tpu_torch.engine import approx

    k, n, dev = APPROX_K, esa.totallength, esa.dev
    numofchars = esa.alpha.mapsize - 1
    rank_q = [i for i, q in enumerate(queries)
              if approx._getoptsplit(numofchars, n, len(q), k) == 1]
    sub = encode([queries[i] for i in rank_q])
    plens = np.array([p.size for p in sub], np.int32)
    qidx, pos = approx._all_piece_candidates(esa, sub, k, shifted=True)
    ok = pos <= n - (plens[qidx].astype(np.int64) - k)
    qidx, pos = qidx[ok], pos[ok]
    maxlen = int(plens.max())
    eqs = approx._eqs_matrix(sub, maxlen).view(np.int32)[:, 0, :]
    tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
               (pos.astype(np.int32), qidx.astype(np.int32), eqs, plens)]
    return [esa.device("text")] + tensors, maxlen + k, rank_q


def k2_edge_set():
    """K2's edge set as NumPy arrays (text, patterns, cand, qidx, L,
    n): candidates in the last L positions, windows crossing a
    SEPARATOR and a WILDCARD, patterns of 1 and 32 chars (one holding a
    wildcard of its own)."""
    rng = np.random.default_rng(SEED + 2)
    n, L = 600, 35
    text = rng.integers(0, 4, n).astype(np.uint8)
    text[[100, 300, 301, 595]] = 255
    text[[50, 120, 310]] = 254
    pats = [np.array([2], np.uint8), text[200:232].copy(),
            rng.integers(0, 4, 32).astype(np.uint8), text[40:60].copy(),
            text[104:117].copy()]
    base = np.concatenate([
        np.arange(n - L - 2, n), np.arange(60, 130), np.arange(180, 240),
        np.arange(270, 320), [0, 1, 40, 104]])
    cand = np.tile(base, len(pats)).astype(np.int32)
    qidx = np.repeat(np.arange(len(pats)), base.size).astype(np.int32)
    order = rng.permutation(cand.size)  # so that any prefix is a mix
    return text, pats, cand[order], qidx[order], L, n


def k2_edge_inputs(dev):
    """The edge set as the tensors ``verify_edit`` takes, on ``dev``."""
    import torch

    from vstree_tpu_torch.engine import approx

    text, pats, cand, qidx, L, n = k2_edge_set()
    eqs = approx._eqs_matrix(pats, 32).view(np.int32)[:, 0, :]
    plens = np.array([p.size for p in pats], np.int32)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for a in (text, cand, qidx, eqs, plens)]
    return t, L, n


def compare_k2(esa, queries, edit_rows) -> dict:
    import torch

    from vstree_tpu_torch.native import myers

    def differ(args, L, n) -> int:
        got = myers.verify_edit(*args, L, n)
        want = myers.verify_edit_ref(*args, L, n)
        torch.cuda.synchronize()
        return max(int((g - w).abs().max()) for g, w in zip(got, want))

    # the edge set, whole, one candidate, and no multiple of the block
    edge, eL, en = k2_edge_inputs(esa.dev)
    for P in (edge[1].numel(), 1, 129):
        cut = [edge[0], edge[1][:P].contiguous(), edge[2][:P].contiguous(),
               edge[3], edge[4]]
        if differ(cut, eL, en) != 0:
            raise AssertionError(f"K2 differs from its plain version on "
                                 f"the edge set at P={P}")
    # the main path's verification launch
    args, L, rank_q = k2_inputs(esa, queries)
    n = esa.totallength
    err = differ(args, L, n)
    if err != 0:
        raise AssertionError(f"K2 differs from its plain version by {err}")
    minsc = myers.verify_edit(*args, L, n)[0]
    onrank = set(rank_q)
    printed = sum(1 for r in edit_rows if r[0] in onrank)
    if int((minsc <= APPROX_K).sum()) != printed:
        raise AssertionError(
            f"K2 accepts {int((minsc <= APPROX_K).sum())} candidates, "
            f"vmatch printed {printed} rank-path rows")
    text, cand, qidx, eqs0, plens = args
    P = cand.numel()
    outs = tuple(torch.empty_like(cand) for _ in range(3))
    # alternate: plain, kernel, kernel, plain
    plain = [time_ms(lambda: myers.verify_edit_ref(*args, L, n), 3)]
    kern = [time_ms(lambda: myers.launch(*args, outs, L, n), 50)
            for _ in range(2)]
    wrapper = time_ms(lambda: myers.verify_edit(*args, L, n), 50)
    plain.append(time_ms(lambda: myers.verify_edit_ref(*args, L, n), 3))
    cold = time_flushed_ms(lambda: myers.launch(*args, outs, L, n), 20)
    # bound, from this run's data: the columns each candidate runs (to
    # the first SEPARATOR, the text end or L) at K2_OPS_PER_COLUMN
    # integer operations; bytes: candidates and outputs, the Eq rows and
    # lengths, and the text bytes under the windows, each once
    stops = torch.nonzero(text[:n] == 255)[:, 0]
    stops = torch.cat([stops, torch.tensor([n], device=stops.device)])
    c64 = cand.to(torch.int64)
    nxt = stops[torch.searchsorted(stops, c64)]
    cols = int((nxt - c64).clamp(max=L).sum())
    covered = int(torch.unique((c64[:, None] + torch.arange(
        L, device=c64.device)[None, :]).clamp(max=n - 1)).numel())
    nbytes = 20 * P + eqs0.numel() * 4 + plens.numel() * 4 + covered
    ops = K2_OPS_PER_COLUMN * cols
    bound = bound_ms(nbytes, ops)
    log(f"K2 verify_edit: P={P} L={L} queries={plens.numel()} "
        f"candidates/query={P / plens.numel():.1f} columns run={cols} "
        f"max_abs_err=0 kernel_ms_l2_flushed(min,median,max)="
        f"[{cold[0]:.4f}, {cold[len(cold) // 2]:.4f}, {cold[-1]:.4f}] "
        f"kernel_ms_repeated={kern} wrapper_ms={wrapper:.4f} "
        f"plain_ms={plain} bound: {nbytes} bytes, {ops} int ops -> {bound}")
    return {"max_abs_err": err, "ms": cold[len(cold) // 2],
            "repeated_ms": min(kern), "plain_ms": min(plain), **bound,
            "library_ms": None}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def smoke(dev, text_bp: int = TEXT_BP, nq: int = NQUERIES) -> dict:
    """Make the data, drive mkvtree and vmatch -complete on ``dev``
    with phase timings, and check the output.  Returns K1's launch
    count in that run, the index path, the records, the queries and the
    row count."""
    from vstree_tpu_torch.cli import mkvtree, vmatch
    from vstree_tpu_torch.device import PhaseTimes, record_phases
    from vstree_tpu_torch.native.rankcount import rank_interval_lookup

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    recs = make_records(rng, text_bp, RECORDS)
    queries, sampled = make_queries(rng, recs, nq)
    db, qf, index = WORK / "genome.fna", WORK / "q.fna", WORK / "genome"
    write_fasta(db, [f"chr{i} synthetic" for i in range(RECORDS)], recs)
    write_fasta(qf, [f"q{i}" for i in range(nq)], queries)
    log(f"data: {text_bp} bp in {RECORDS} records, {nq} queries "
        f"({time.perf_counter() - t0:.2f} s, not timed below)")

    # the main path; K1's launch count covers this run only
    rank_interval_lookup.launches = 0
    build_times, query_times = PhaseTimes(dev), PhaseTimes(dev)
    t0 = time.perf_counter()
    with record_phases(build_times):
        mkvtree.run(["-db", str(db), "-dna", "-pl", "-allout",
                     "-indexname", str(index)], dev)
    build_s = time.perf_counter() - t0
    out = WORK / "vmatch.out"
    t0 = time.perf_counter()
    with record_phases(query_times), open(out, "w") as fh:
        vmatch.run(["-complete", "-q", str(qf), str(index)], dev, out=fh)
    query_s = time.perf_counter() - t0
    launches = rank_interval_lookup.launches
    for title, total, times in (("mkvtree", build_s, build_times),
                                ("vmatch -complete", query_s, query_times)):
        log(f"{title}: {total:.3f} s wall")
        for name, sec in times.seconds.items():
            log(f"  {name:16s} {sec:9.3f} s")
        log(f"  {'(other)':16s} {total - sum(times.seconds.values()):9.3f} s")
    lookup_s = sum(query_times.seconds.get(k, 0.0)
                   for k in ("pack", "rank lookup", "expansion"))
    log(f"query rate: {nq / query_s:.0f} queries/s end to end; "
        f"{nq / lookup_s:.0f} queries/s over pack + rank lookup + "
        f"expansion; K1 launches in the main path: {launches}")

    hits = parse_rows(out)
    nrows = sum(len(v) for v in hits.values())
    log(f"vmatch rows: {nrows}; queries with a hit: {len(hits)}")
    missed = [i for i in np.flatnonzero(sampled) if i not in hits]
    if missed:
        raise AssertionError(f"{len(missed)} queries taken from the text "
                             f"were not found, e.g. query {missed[0]}")
    checked = naive_check(rng, recs, queries, hits)
    log(f"naive check: {checked} queries agree with a bytes.find scan")
    spots = spot_check_index(rng, index)
    log(f"index check: suffix order and lcp agree at {spots} random ranks")
    return {"launches": launches, "index": index, "queries": queries,
            "nrows": nrows, "recs": recs}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    try:
        import vstree_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 1
    from vstree_tpu_torch.native import build

    dev = torch.device("cuda", 0)
    card = card_line()
    nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    log(card)
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"nvcc {nvcc[-1] if nvcc else 'missing'}  "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    log(f"CUDA context: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    build.load_kernels()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for line in build.build_log().splitlines():
        if "ptxas info" in line:
            log("  " + line.strip())

    run = smoke(dev)
    if run["launches"] == 0:
        raise AssertionError("the main path never launched K1")
    from vstree_tpu_torch.index.esa import ESA

    approx = approx_phase(np.random.default_rng(SEED + 1), run["recs"],
                          run["index"], dev, "--profile" in sys.argv[1:])
    if approx["launches"] == 0:
        raise AssertionError("the approximate path never launched K2")
    esa = ESA.read(str(run["index"]), dev)
    k1 = compare_k1(esa, run["queries"], run["nrows"])
    k2 = compare_k2(esa, approx["queries"], approx["-e"])
    shutil.rmtree(WORK, ignore_errors=True)
    kernels = [{
        "name": "rank_interval_lookup",
        "route": "cuda",
        "source": "vstree_tpu_torch/native/csrc/rankcount.cu",
        "replaces": "vstree_tpu/native/rankcount.py:95",
        "launches": run["launches"],
        **k1,
    }, {
        "name": "verify_edit",
        "route": "cuda",
        "source": "vstree_tpu_torch/native/csrc/myers.cu",
        "replaces": "vstree_tpu/native/myers.py:82",
        "launches": approx["launches"],
        **k2,
    }]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

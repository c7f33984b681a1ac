#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vstree_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout

1. Prints the card (name, power limit) and the torch / CUDA / nvcc
   versions; exits non-zero, printing no result, without a CUDA device
   or outside a checkout.
2. Builds the kernels from ``vstree_tpu_torch/native/csrc``.
3. Drives the main path at genome scale through the CLIs' ``run``:
   ``mkvtree -dna -pl -allout`` over 16 Mbp of seeded synthetic DNA in
   8 FASTA records (with short N runs), then ``vmatch -complete -q``
   with 100,000 queries of length 24-36 (90 % sampled from the text,
   10 % random).  Prints the seconds of every build and query phase
   and the query rate; fails if kernel K1 was not launched.
4. Checks the output independently: the reported positions of 1,000
   queries against a ``bytes.find`` scan of the records, and suffix
   order and LCP values at 10,000 random ranks by direct comparison.
5. Holds K1 against its plain PyTorch version on the card, on the
   inputs the main path gave it (exact equality), and times both.

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
LETTERS = np.frombuffer(b"acgt", np.uint8)


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
# K1 against its plain version
# ---------------------------------------------------------------------------


def k1_inputs(index: Path, queries: list[bytes], dev):
    """The arguments the main path gave K1: the same plan and packing
    as exact_complete_matches, on the queries' encoded form."""
    import torch

    from vstree_tpu_torch.engine.complete import (
        RankLookupPlan,
        rank_lookup_inputs,
    )
    from vstree_tpu_torch.index.esa import ESA

    esa = ESA.read(str(index), dev)
    code = np.full(256, -1, np.int32)
    code[list(b"acgt")] = np.arange(4)
    plens = np.array([len(q) for q in queries], np.int32)
    pats = np.full((len(queries), plens.max()), -1, np.int32)
    for i, q in enumerate(queries):
        pats[i, :len(q)] = code[np.frombuffer(q, np.uint8)]
    plan = RankLookupPlan(esa, int(plens.min()), pats.shape[1])
    if not plan.ok:
        raise AssertionError("the rank-count plan refused the workload")
    flat8 = torch.from_numpy(plan.pack(pats, plens)).to(dev)
    args = rank_lookup_inputs(flat8, plan.bck, plan.ppl, plan.cpw,
                              plan.sigma, plan.shift)
    return args + (plan.t1, plan.t2), plan.rowspan


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


def compare_k1(index, queries, dev, nrows: int) -> dict:
    import torch

    from vstree_tpu_torch.native.rankcount import (
        bucket_rank_lookup,
        bucket_rank_lookup_ref,
    )

    args, rowspan = k1_inputs(index, queries, dev)
    lo, hi = bucket_rank_lookup(*args, rowspan)
    rlo, rhi = bucket_rank_lookup_ref(*args, rowspan)
    torch.cuda.synchronize()
    err = max(int((lo - rlo).abs().max()), int((hi - rhi).abs().max()))
    if err != 0:
        raise AssertionError(f"K1 differs from its plain version by {err}")
    if int((hi - lo).sum()) != nrows:
        raise AssertionError("K1's intervals do not sum to the rows "
                             "vmatch printed")
    # alternate: plain, kernel, kernel, plain
    plain = [time_ms(lambda: bucket_rank_lookup_ref(*args, rowspan), 10)]
    kern = [time_ms(lambda: bucket_rank_lookup(*args, rowspan), 50)
            for _ in range(2)]
    plain.append(time_ms(lambda: bucket_rank_lookup_ref(*args, rowspan), 10))
    log(f"K1 bucket_rank_lookup: B={lo.numel()} rowspan={rowspan} "
        f"max_abs_err=0 kernel_ms={kern} plain_ms={plain}")
    return {"max_abs_err": err, "ms": min(kern), "plain_ms": min(plain)}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def smoke(dev, text_bp: int = TEXT_BP, nq: int = NQUERIES) -> dict:
    """Make the data, drive mkvtree and vmatch -complete on ``dev``
    with phase timings, and check the output.  Returns K1's launch
    count in that run, the index path, the queries and the row count."""
    from vstree_tpu_torch.cli import mkvtree, vmatch
    from vstree_tpu_torch.device import PhaseTimes, record_phases
    from vstree_tpu_torch.native.rankcount import bucket_rank_lookup

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
    bucket_rank_lookup.launches = 0
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
    launches = bucket_rank_lookup.launches
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
            "nrows": nrows}


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
    build.load_kernels()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for line in build.build_log().splitlines():
        if "ptxas info" in line:
            log("  " + line.strip())

    run = smoke(dev)
    if run["launches"] == 0:
        raise AssertionError("the main path never launched K1")
    k1 = compare_k1(run["index"], run["queries"], dev, run["nrows"])
    shutil.rmtree(WORK, ignore_errors=True)
    kernels = [{
        "name": "bucket_rank_lookup",
        "route": "cuda",
        "source": "vstree_tpu_torch/native/csrc/rankcount.cu",
        "replaces": "vstree_tpu/native/rankcount.py:95",
        "launches": run["launches"],
        **k1,
    }]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

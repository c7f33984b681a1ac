#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vstree_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout
    python3 chip_smoke.py --profile   # also: device time of the
                                      # approximate runs and of -l 20
                                      # (torch.profiler)
    python3 chip_smoke.py --segments  # also: the online edit scans at
                                      # other least segment lengths
    python3 chip_smoke.py --seedlengths   # also: -l 30 -e 2 at other
                                          # seed lengths
    python3 chip_smoke.py --extend-only   # the repeat text's phases
                                          # alone (7 and 8 below); no
                                          # kernels line, no result line
    python3 chip_smoke.py --query-only    # phase 10 alone (likewise)
    python3 chip_smoke.py --protein-only  # phase 11 alone (likewise)
    python3 chip_smoke.py --tools-only    # phase 12 alone (likewise)
    python3 chip_smoke.py --numproc-only  # phase 13 alone, with the
                                          # indexes it reuses (likewise)
    python3 chip_smoke.py --entry-only    # phase 14 alone, with the
                                          # inputs it reuses (likewise)

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
6. Drives ``vmatch -complete -online`` on the same index: exact and
   ``-h 1`` with 256 queries of 24-36 (rows equal to the indexed runs of
   the same queries, and to direct scans of the records: ``bytes.find``
   for every exact query, a NumPy mismatch count over every window for
   8 Hamming queries), ``-e 1`` with 64 queries of 20-32 (a NumPy DP
   confirms sampled rows, planted origins must be found; fails if K2 was
   not launched), and ``-e 2`` with 4 queries of 80-100 (the segmented
   Ukkonen-cutoff scan, exact by its state check; rows checked by the
   DP, the places the queries were taken from must be among them).
7. Drives the self-match tasks at genome scale: a second seeded text of
   16 Mbp with planted repeat families (diverged copies of elements of
   1-3 kb), tandem arrays and short N runs, an index of its own, then
   ``vmatch -l 20``, ``-supermax -l 20`` and ``-tandem -l 20`` with
   phase timings.  ``-l 20`` must report between 10^5 and 10^6 pairs,
   among them every maximal match that a direct comparison of sampled
   planted copy pairs finds; sampled rows are compared byte by byte
   (equal, maximal on both sides); on an index of the first 1 Mbp the
   torch program's pairs equal the NumPy enumeration's, in order.
   ``-mum -l 20`` runs on an index built with ``-db`` and ``-q`` (1 Mbp
   + 0.2 Mbp) against a direct computation of the planted unique
   matches.  Prints the peak device memory of every path.
8. Drives the seed extension on that repeat text, which also holds
   3,000 planted twins (pairs of 60-120 bp that differ by 1 or 2 known
   edits, half of them with an indel): first the device part of ``-l 30
   -e 2`` at its default seed length of 10 (~10^8 seeds through the
   chunked fronts and the viability filter), then ``vmatch -l 30 -e 2
   -seedlength 16`` (the fused path; fails if the run left it), ``-l 30
   -h 2 -seedlength 16``, ``-l 40 -exdrop 3``, ``-l 40 -hxdrop 3``, and
   ``-l 30 -e 2 -allmax`` on the 1 Mbp prefix index, each with its
   phases, seeds, survivors and peak device memory.  Every twin that has
   an exact run of the seed length (for the mismatch tasks: and no
   indel) must be covered by a row; every row must keep the rules of its
   task (lengths, record borders, sign and bound of the distance);
   sampled rows are held to a NumPy DP (edit distance <= distance) or to
   a mismatch count (== distance); the ``-e`` runs must have rows with
   length1 != length2.  On the prefix index each run's ``MatchTable``
   from the card must equal, column by column, the same code's on CPU
   tensors.
9. Holds K1 and K2 against their plain PyTorch versions on the card, on
   the inputs the main path gave them (K1: all 100,000 queries) and on
   an edge set each (exact equality; K1's also against a direct scan;
   K2 also on the detected starts of the ``-online -e 1`` run, where its
   lengths and distances must be the printed ones),
   times them (with the L2 flushed in front of each launch, as the
   main path's single launch finds it, and in a loop), and computes
   each kernel's bound (the least time the card could take) from this
   run's inputs: for K1 from the ranks whose keys any search must
   compare to know the answers.

10. Phase 10: ``-q`` on the index (``query_phase``).
11. Phase 11, DNA queries on a protein index at proteome scale
   (``protein_phase``): a proteome P of 20,000 records (~11 M aa) with the
   Swiss-Prot composition, low-complexity runs, paralog families and
   duplicates; ``mkvtree -protein``; ``vmatch -complete -dnavsprot 1``
   with 20,000 back-translated queries of 30-54 nt (each must report its
   window on its strand), ``-e 1`` with 5,000 of 45-90 nt with a changed
   codon (origins found; sampled rows held to a NumPy DP on this
   script's own translation), ``-l 15 -dnavsprot 1 -q`` on 0.5 Mbp of DNA
   with planted windows (every exact run of >= 15 aa found) and ``-l 40
   -dbcluster 95 95 -nonredundant`` (each exact duplicate in its
   original's cluster); each ``-complete`` run logs the lookup path it
   took.  Then the card's stdout against the CPU's on a 1 M aa prefix of
   P and on the repeat text's 1 Mbp prefix for the host-only options,
   the demo vplugin, a ``-selfun`` module and ``chainqhits``.  K1 is held
   against its plain version on the frames (on a uniform index of the
   same size where the plan refuses P), K2 at the ``-e 1`` run's shapes;
   K2 must have launched.
12. Phase 12, the out-of-core build and the tools (``tools_phase``): (a)
   ``build_suf_out_of_core`` over 64 Mbp in 32 records of seeded DNA
   with short N runs, shards of at most 16 Mbp, against the monolithic
   ``build_suf_lcp`` of the same text (equal tables, sampled order and
   lcp by direct comparison, stage seconds; fails unless its peak
   device memory is below the monolithic build's); (b) ``mkrcidx`` and
   ``mkdna6idx`` on its first 16 Mbp (index texts against this script's
   reverse complements and translation, sampled order and lcp); (c) on
   a 1 Mbp index of four record prefixes built with ``-allout`` and
   ``-rev``: ``mkcfr`` (sampled entries by direct comparison; its
   lookup path and K1's launches go into the kernels line), ``mksti``,
   ``mkcld``, ``mkiso``, ``mklsf``, ``mkvcmp``, ``vseqinfo``,
   ``vseqselect``, ``vsubseqselect``, ``vendian``, and ``vstree2tex``
   on a 2 kbp index; (d) on the repeat text's 1 Mbp prefix ``vmatch -l
   20`` writes a match file for ``vmatchselect -sort ia``, ``chain2dim``
   and ``matchcluster`` (rows and counts against the file's own), and
   ``repfind -f -p -l 20`` against ``vmatch -l 20 -d -p``; then
   ``repfind``, ``mkcfr``, ``mkrcidx`` and ``mkdna6idx`` on the card
   against the CPU.
13. Phase 13, ``-numproc`` on one card (``numproc_phase``): the CLIs'
   ``run`` is given the card eight times as the devices ``-numproc`` may
   take.  (a) ``mkvtree -dna -pl -allout -numproc 4`` over phase 3's text
   (mesh dp=2, sp=2: the sharded sort and lcp pass) must write phase 3's
   table files byte for byte; (b) ``vmatch -complete -q -numproc 4`` and
   ``-numproc 8`` (dp=2, sp=4) with phase 3's queries must print phase
   3's rows and launch K1 0 times (the sharded lookup is a binary
   search in torch ops); (c) ``vmatch -supermax -l 20 -numproc 4`` on
   the repeat text's index must print phase 7's rows; (d) two gloo ranks
   in processes of their own share the card (their collectives staged
   through host memory) over phase 12's 1 Mbp index: the sharded sort,
   supermax intervals and lookup must equal the monolith's; (e) both
   CLIs' ``main()`` refuse one more shard than there are cards with the
   JAX CLI's message.  Each stage logs its seconds against the
   monolithic run and its peak device memory.
14. Phase 14, the main path through the entry points (``entry_phase``):
   every run a ``python -m vstree_tpu_torch.cli.<tool>`` process of its
   own from the checkout root.  (a) ``mkvtree -dna -pl -allout`` over
   phase 3's text must write phase 3's table files byte for byte; (b)
   ``vmatch -complete -q`` with phase 3's queries, (c) ``-complete -e 1
   -q`` with phase 5's and (d) ``-l 20`` on phase 7's repeat index, each
   with VSTREE_PROFILE set, must print the in-process runs' stdout byte
   for byte, and their torch.profiler traces must hold 1 / 2 / 0 K1 and
   0 / 2 / 0 K2 kernel events; each logs its wall (the process start
   included) beside the in-process run's, the device busy share of its
   trace (kernel, memcpy and memset intervals over the traced window)
   and the five largest device items; (e) (b) with
   VMATCHSHOWTIMESPACE=on prints the ``# TIME`` and ``# SPACE`` lines
   alone; (f) malformed QUERYSPEEDUP, VMATCHSHOWTIMESPACE and
   VSTREE_DEBUG_NANS exit with 1 and the JAX CLI's messages.

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
ONLINE_QUERIES = 256          # -complete -online exact and -h 1, 24-36
ONLINE_EDIT_QUERIES = 64      # -complete -online -e 1, 20-32
ONLINE_LONG_QUERIES = 4       # -complete -online -e 2, 80-100
ONLINE_LONG_K = 2
HAMMING_QUERIES = 8           # -online -h 1 queries recounted over all windows
SELF_LENGTH = 20              # vmatch -l / -supermax / -tandem / -mum
REPEAT_FAMILIES = 5
REPEAT_COPIES = (100, 250)    # copies per family
REPEAT_ELEMENT = (1000, 3000) # element length
REPEAT_DIVERGENCE = 0.10      # substitutions per base and copy
TANDEM_ARRAYS = 40
SLOT = 4096                   # one planted copy or array per slot
COPY_PAIRS_CHECKED = 20_000
SELF_ROWS_CHECKED = 2_000
PREFIX_BP = 1_000_000         # the NumPy recount's index
TWINS = 3_000                 # planted pairs that differ by 1-2 known edits
TWIN_LENGTH = (60, 120)
SUBSLOT = 512                 # one twin pair per sub-slot of a SLOT
EXTEND_ROWS_CHECKED = 2_000   # rows of a seed-extension run held to a DP
# the seed-extension runs on the repeat text: (name, options, kind)
EXTEND_RUNS = (
    # at the default seed length (10) the run takes 34-42 s, most of it
    # combining and rendering 10^6 rows on the host: --seedlengths runs it
    ("e2", ["-l", "30", "-e", "2", "-seedlength", "16"], "edit"),
    ("h2", ["-l", "30", "-h", "2", "-seedlength", "16"], "hamming"),
    ("exdrop", ["-l", "40", "-exdrop", "3"], "exdrop"),
    ("hxdrop", ["-l", "40", "-hxdrop", "3"], "hxdrop"),
)
EXTEND_ALLMAX = ("e2allmax", ["-l", "30", "-e", "2", "-allmax"], "edit")
MUM_DB_BP, MUM_QUERY_BP = 1_000_000, 200_000
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
    """Suffix order and LCP at SPOT_RANKS random ranks of an index's
    files (:func:`spot_check_tables`)."""
    t = np.fromfile(f"{index}.tis", np.uint8).tobytes()
    suf = np.fromfile(f"{index}.suf", "<u8").astype(np.int64)
    lcp = np.fromfile(f"{index}.lcp", np.uint8).astype(np.int64)
    llv = np.fromfile(f"{index}.llv", "<u8").reshape(-1, 2).astype(np.int64)
    lcp[llv[:, 0]] = llv[:, 1]
    n = len(t)
    if suf.size != n + 1 or not np.array_equal(np.sort(suf),
                                               np.arange(n + 1)):
        raise AssertionError("suftab is not a permutation of 0..n")
    return spot_check_tables(rng, t, suf, lcp)


def spot_check_tables(rng, t: bytes, suf: np.ndarray, lcp: np.ndarray,
                      nranks: int = SPOT_RANKS) -> int:
    """Suffix order and LCP at ``nranks`` random ranks, compared on the
    encoded text directly (specials >= 254 beat regular chars and order
    by position; the sentinel is last; specials never match)."""
    n = len(t)
    for r in rng.integers(1, n + 1, nranks):
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
    return nranks


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


def approx_checks(rng, recs, queries, origins, rows, edit: bool,
                  online: bool = False) -> dict:
    """Every row's distance is within the threshold's sign convention;
    DP_ROWS sampled rows carry the (length, distance) a direct
    computation on the record gives; PLANTED_QUERIES queries with <= k
    planted errors report their origin.  ``online``: the rows come from
    ``-complete -online``, whose scan of patterns <= 64 is exact."""
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
        onrank = online or _getoptsplit(4, n, len(queries[i]), k, edit) == 1
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
        before = verify_edit.launches
        before_k1 = rank_interval_lookup.launches
        wall, _ = timed_vmatch(["-complete", flag, str(APPROX_K), "-q",
                                str(qf), str(index)], dev, out, profile)
        log(f"  {nq / wall:.0f} queries/s end to end; K2 launches: "
            f"{verify_edit.launches - before}; K1 launches: "
            f"{rank_interval_lookup.launches - before_k1}")
        if rank_interval_lookup.launches == before_k1:
            raise AssertionError(
                f"vmatch -complete {flag} never launched K1")
        rows = parse_approx_rows(out)
        hit = len({r[0] for r in rows})
        log(f"  rows: {len(rows)}; queries with a match: {hit}")
        checks = approx_checks(rng, recs, queries, origins, rows, edit)
        log(f"  checks: {checks}")
        result[flag] = rows
        result[f"{flag}_s"] = wall
    result["launches"] = verify_edit.launches
    log(f"approximate path: K2 launches {verify_edit.launches}, K1 "
        f"launches {rank_interval_lookup.launches}")
    return result


# ---------------------------------------------------------------------------
# shared by the phases below
# ---------------------------------------------------------------------------


class peak_memory:
    """Logs the peak device memory allocated inside the block."""

    def __init__(self, dev, name: str):
        self.dev, self.name = dev, name

    def __enter__(self):
        import torch

        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)

    def __exit__(self, *exc):
        import torch

        if self.dev.type == "cuda" and exc[0] is None:
            log(f"peak device memory, {self.name}: "
                f"{torch.cuda.max_memory_allocated(self.dev) / 2**20:.0f} "
                "MiB")


def timed_vmatch(argv: list[str], dev, out: Path, profile: bool = False):
    """One ``vmatch.run`` into ``out`` with its phases recorded and
    logged; returns (wall seconds, PhaseTimes)."""
    import contextlib

    import torch

    from vstree_tpu_torch.cli import vmatch
    from vstree_tpu_torch.device import PhaseTimes, record_phases

    times = PhaseTimes(dev)
    tracer = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
        if profile else contextlib.nullcontext())
    t0 = time.perf_counter()
    with tracer, record_phases(times), open(out, "w") as fh:
        vmatch.run(argv, dev, out=fh)
    wall = time.perf_counter() - t0
    log(f"vmatch {' '.join(argv[:-1])}: {wall:.3f} s wall")
    for name, sec in times.seconds.items():
        log(f"  {name:16s} {sec:9.3f} s")
    log(f"  {'(other)':16s} {wall - sum(times.seconds.values()):9.3f} s")
    for name, n in times.counts.items():
        log(f"  {name:16s} {n:9d}")
    if profile:
        device_time_report(tracer, wall)
    return wall, times


def body_lines(path: Path) -> list[str]:
    with open(path) as fh:
        return [line for line in fh if not line.startswith("#")]


# ---------------------------------------------------------------------------
# -complete -online
# ---------------------------------------------------------------------------


def hamming_check(rng, recs, queries, rows) -> str:
    """Every row's window differs from its query in the stated number of
    chars, at most APPROX_K; for HAMMING_QUERIES sampled queries the rows
    are all the windows a NumPy count over every record finds."""
    k = APPROX_K
    by_query: dict[int, set] = {}
    for q, ri, rel, length, dist in rows:
        win = recs[ri][rel:rel + length]
        mm = sum(a != b for a, b in zip(queries[q], win))
        if length != len(queries[q]) or len(win) != length or \
                dist != -mm or mm > k:
            raise AssertionError(f"Hamming row {(q, ri, rel, length, dist)}:"
                                 f" a direct count gives {mm} mismatches")
        by_query.setdefault(q, set()).add((ri, rel))
    arrs = [np.frombuffer(r, np.uint8) for r in recs]
    picked = rng.choice(len(queries), min(HAMMING_QUERIES, len(queries)),
                        replace=False)
    for qi in picked:
        q = np.frombuffer(queries[qi], np.uint8)
        want = set()
        for ri, a in enumerate(arrs):
            nwin = a.size - q.size + 1
            if nwin <= 0:
                continue
            mm = np.zeros(nwin, np.uint8)
            for o in range(q.size):
                mm += a[o:o + nwin] != q[o]
            want |= {(ri, int(p)) for p in np.flatnonzero(mm <= k)}
        if by_query.get(int(qi), set()) != want:
            raise AssertionError(
                f"query {qi}: -online -h reports "
                f"{sorted(by_query.get(int(qi), ()))[:5]}, a direct count "
                f"finds {sorted(want)[:5]}")
    return (f"{len(rows)} rows recounted, {len(picked)} queries agree with "
            "a NumPy count over every window")


def online_phase(rng, recs, index: Path, dev, nq: int = ONLINE_QUERIES,
                 nq_edit: int = ONLINE_EDIT_QUERIES,
                 nq_long: int = ONLINE_LONG_QUERIES) -> dict:
    """``vmatch -complete -online`` on the main path's index: exact and
    ``-h 1`` against the indexed runs of the same queries, ``-e 1``
    against the NumPy DP, and ``-e 2`` with patterns of 80-100 chars
    (the segmented cutoff scan).  Returns K2's launches in the ``-e 1``
    run, and that run's queries and rows."""
    from vstree_tpu_torch.native.myers import verify_edit

    n = sum(len(r) for r in recs) + len(recs) - 1
    check_rng = np.random.default_rng(SEED + 7)
    queries, _ = make_queries(rng, recs, nq)
    qf = WORK / "online_q.fna"
    write_fasta(qf, [f"o{i}" for i in range(nq)], queries)
    for extra in ([], ["-h", str(APPROX_K)]):
        outs = []
        for mode in (["-online"], []):
            out = WORK / f"online{len(outs)}.out"
            timed_vmatch(["-complete"] + mode + extra
                         + ["-q", str(qf), str(index)], dev, out)
            outs.append(sorted(body_lines(out)))
        if outs[0] != outs[1] or len(outs[0]) < nq // 2:
            raise AssertionError(
                f"-complete -online {' '.join(extra)}: {len(outs[0])} rows, "
                f"the indexed run has {len(outs[1])}, or they differ")
        # and, since both runs share the code behind the scan, a direct
        # scan of the records
        online_out = WORK / "online0.out"
        if extra:
            direct = hamming_check(check_rng, recs, queries,
                                   parse_approx_rows(online_out))
        else:
            direct = naive_check(check_rng, recs, queries,
                                 parse_rows(online_out))
            direct = f"{direct} queries agree with a bytes.find scan"
        log(f"  {len(outs[0])} rows of {nq} queries of {MINLEN}-{MAXLEN} "
            f"on {n} bp equal the indexed run's; {direct}")

    queries, origins = make_approx_queries(rng, recs, nq_edit)
    write_fasta(qf, [f"e{i}" for i in range(nq_edit)], queries)
    out = WORK / "online_e.out"
    verify_edit.launches = 0
    timed_vmatch(["-complete", "-online", "-e", str(APPROX_K), "-q", str(qf),
                  str(index)], dev, out)
    launches = verify_edit.launches
    rows = parse_approx_rows(out)
    checks = approx_checks(rng, recs, queries, origins, rows, True,
                           online=True)
    log(f"  {len(rows)} rows of {nq_edit} queries of {APPROX_MINLEN}-"
        f"{APPROX_MAXLEN}; K2 launches: {launches}; checks: {checks}")
    edit_run = {"launches": launches, "queries": queries, "rows": rows}
    if launches == 0 and dev.type == "cuda":
        raise AssertionError("-complete -online -e never launched K2")

    # patterns > 64: the Ukkonen-cutoff scan in segments, at full size
    k = ONLINE_LONG_K
    longq, planted = [], []
    while len(longq) < nq_long:
        ri = int(rng.integers(0, len(recs)))
        r = recs[ri]
        ln = int(rng.integers(80, 101))
        st = int(rng.integers(0, len(r) - ln))
        q = bytearray(r[st:st + ln])
        if b"n" in q:
            continue
        for at in rng.choice(ln, len(longq) % (k + 1), replace=False):
            q[at] = int(LETTERS[(LETTERS.tolist().index(q[at]) + 1) % 4])
        longq.append(bytes(q))
        planted.append((ri, st))
    write_fasta(qf, [f"l{i}" for i in range(nq_long)], longq)
    out = WORK / "online_long.out"
    _, times = timed_vmatch(["-complete", "-online", "-e", str(k), "-q",
                             str(qf), str(index)], dev, out)
    rows = parse_approx_rows(out)
    for q, ri, rel, length, dist in rows:
        want = longest_match(longq[q], recs[ri][rel:rel + len(longq[q]) + k],
                             len(longq[q]) + k)
        if (length, dist) != want:
            raise AssertionError(f"online row {(q, ri, rel, length, dist)}: "
                                 f"a direct computation gives {want}")
    found = {(q, ri, rel) for q, ri, rel, _, _ in rows}
    missed = [i for i, o in enumerate(planted) if (i, *o) not in found]
    if missed:
        raise AssertionError(
            f"long patterns {missed} with <= {k} substitutions: -complete "
            f"-online -e does not report the place they were taken from")
    log(f"  {len(rows)} rows of {nq_long} queries of 80-100 at k={k} on "
        f"{n} bp (full size: the segmented cutoff scan is exact by its "
        f"state check), every row's (length, distance) as a direct "
        f"computation gives them, all {nq_long} planted origins among the "
        f"rows; cutoff scan "
        f"{times.seconds.get('cutoff scan', 0.0) / nq_long / (n / 1e6):.5f}"
        " s per pattern and Mbp")
    edit_run["long_queries"] = longq
    return edit_run


# ---------------------------------------------------------------------------
# the self-match tasks
# ---------------------------------------------------------------------------


def make_twin(rng):
    """Two sequences of TWIN_LENGTH chars that differ by 1 or 2 edits in
    their middle third, at least 2 chars apart: every second pair by
    substitutions only, the others with one indel.  Returns (x, y,
    indels, longest exact run known from the edit places)."""
    ln = int(rng.integers(TWIN_LENGTH[0], TWIN_LENGTH[1] + 1))
    x = rng.integers(0, 4, ln)
    nedit = int(rng.integers(1, 3))
    indel = bool(rng.integers(0, 2))
    at = np.sort(rng.choice(np.arange(ln // 3, 2 * ln // 3, 2), nedit,
                            replace=False))
    y = x.tolist()
    for i, pos in enumerate(at[::-1].tolist()):
        if indel and i == 0:
            if rng.integers(0, 2):
                del y[pos]
            else:
                y.insert(pos, int(rng.integers(0, 4)))
        else:
            y[pos] = int((x[pos] + rng.integers(1, 4)) % 4)
    return (x, np.asarray(y), int(indel),
            int(max(at[0], ln - at[-1] - 1)))


def make_repeat_records(rng, total: int, nrec: int, families: int,
                        copies: tuple, tandems: int, twins: int = 0):
    """``nrec`` records of random acgt with planted repeat families
    (per family one element of REPEAT_ELEMENT chars and a number of
    copies in ``copies``, each with REPEAT_DIVERGENCE substitutions per
    base), ``tandems`` tandem arrays, ``twins`` pairs of :func:`make_twin`
    and 2-4 short runs of n per record.  A copy or array has a SLOT of
    its own, a twin pair a SUBSLOT.  Returns the records (uint8 arrays),
    per family its copies as (record, start, length), and the twins that
    no run of n hit as (record, start1, length1, start2, length2, indels,
    longest exact run)."""
    reclen = total // nrec
    recs = [LETTERS[rng.integers(0, 4, reclen)] for _ in range(nrec)]
    per_rec = reclen // SLOT
    slots = iter(rng.permutation(nrec * per_rec).tolist())

    def place(seq):
        r, off = divmod(next(slots), per_rec)
        st = off * SLOT + int(rng.integers(0, SLOT - seq.size))
        recs[r][st:st + seq.size] = LETTERS[seq]
        return r, st, int(seq.size)

    planted = []
    for _ in range(families):
        elem = rng.integers(0, 4, int(rng.integers(
            REPEAT_ELEMENT[0], REPEAT_ELEMENT[1] + 1)))
        fam = []
        for _ in range(int(rng.integers(copies[0], copies[1] + 1))):
            copy = elem.copy()
            mut = rng.random(elem.size) < REPEAT_DIVERGENCE
            copy[mut] = (copy[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
            fam.append(place(copy))
        planted.append(fam)
    for _ in range(tandems):
        unit = rng.integers(0, 4, int(rng.integers(7, 41)))
        arr = np.tile(unit, int(rng.integers(10, 40)))[:SLOT - 200]
        mut = rng.random(arr.size) < 0.01
        arr[mut] = (arr[mut] + 1) % 4
        place(arr)
    pairs = []
    sub = SLOT                  # offset in the current slot: none yet
    for _ in range(twins):
        if sub + SUBSLOT > SLOT:
            r, off = divmod(next(slots), per_rec)
            base, sub = off * SLOT, 0
        x, y, indels, run = make_twin(rng)
        s1 = base + sub + int(rng.integers(0, 100))
        s2 = base + sub + SUBSLOT // 2 + int(rng.integers(0, 100))
        recs[r][s1:s1 + x.size] = LETTERS[x]
        recs[r][s2:s2 + y.size] = LETTERS[y]
        pairs.append((r, s1, int(x.size), s2, int(y.size), indels, run))
        sub += SUBSLOT
    for seq in recs:
        for _ in range(int(rng.integers(2, 5))):
            st = int(rng.integers(0, seq.size - 64))
            seq[st:st + int(rng.integers(3, 40))] = ord("n")
    pairs = [t for t in pairs
             if ord("n") not in recs[t[0]][t[1]:t[3] + t[4]]]
    return recs, planted, pairs


def aligned_matches(recs, a, b, least: int, ext: int = 40):
    """Maximal exact matches of at least ``least`` chars between two
    planted copies ``(record, start, length)`` at equal offsets, by
    direct comparison of the records ``ext`` chars beyond the copies:
    [(length, record1, pos1, record2, pos2)] with (record1, pos1) the
    earlier place.  A match that touches the window's border is left
    out (its ends are not seen)."""
    if (a[0], a[1]) > (b[0], b[1]):
        a, b = b, a
    (r1, s1, ln), (r2, s2, _) = a, b
    lo = min(ext, s1, s2)
    hi = min(ext, recs[r1].size - s1 - ln, recs[r2].size - s2 - ln)
    x = recs[r1][s1 - lo:s1 + ln + hi]
    y = recs[r2][s2 - lo:s2 + ln + hi]
    eq = (x == y) & (x != ord("n"))
    edge = np.diff(np.concatenate([[0], eq.view(np.int8), [0]]))
    starts, ends = np.flatnonzero(edge == 1), np.flatnonzero(edge == -1)
    keep = (ends - starts >= least) & (starts > 0) & (ends < x.size)
    return [(int(e - s), r1, int(s1 - lo + s), r2, int(s2 - lo + s))
            for s, e in zip(starts[keep], ends[keep])]


def self_rows(path: Path) -> np.ndarray:
    """int64 [rows, 5]: (length, record1, pos1, record2, pos2) of the
    default rows of a self-match task (length1 seqnum1 relpos1 D length2
    seqnum2 relpos2 ...), which must be direct and of equal lengths."""
    raw = np.loadtxt(path, comments="#", usecols=(0, 1, 2, 4, 5, 6),
                     dtype=np.int64, ndmin=2)
    if raw.size and not (raw[:, 0] == raw[:, 3]).all():
        raise AssertionError(f"{path.name}: rows of unequal lengths")
    return raw[:, [0, 1, 2, 4, 5]]


def check_sampled_rows(rng, recs, rows: np.ndarray, least: int,
                       tandem: bool = False) -> int:
    """SELF_ROWS_CHECKED sampled rows, byte by byte: the two places hold
    the same ``length`` regular chars, at least ``least``, and differ
    (or end, or hold an n) just before and just after; a tandem row's
    second place starts where the first ends."""
    count = min(SELF_ROWS_CHECKED, len(rows))
    for d, r1, p1, r2, p2 in rows[rng.choice(len(rows), count,
                                             replace=False)].tolist():
        x, y = recs[r1], recs[r2]
        same = (d >= least and np.array_equal(x[p1:p1 + d], y[p2:p2 + d])
                and ord("n") not in x[p1:p1 + d])
        right = (p1 + d == x.size or p2 + d == y.size
                 or x[p1 + d] != y[p2 + d] or x[p1 + d] == ord("n"))
        left = (p1 == 0 or p2 == 0 or x[p1 - 1] != y[p2 - 1]
                or x[p1 - 1] == ord("n"))
        if tandem:      # branching: only the right side must differ
            left = r1 == r2 and p2 == p1 + d
        if not (same and left and right):
            raise AssertionError(
                f"row {(d, r1, p1, r2, p2)} is no maximal exact match "
                f"(equal {same}, left {left}, right {right})")
    return count


def mkvtree_run(dev, db: Path, index: Path) -> None:
    """``mkvtree -db db -dna -pl -allout -indexname index``."""
    from vstree_tpu_torch.cli import mkvtree

    mkvtree.run(["-db", str(db), "-dna", "-pl", "-allout", "-indexname",
                 str(index)], dev)


def repeat_index(rng, dev, text_bp: int, families: int, copies: tuple,
                 tandems: int, twins: int):
    """The repeat text (:func:`make_repeat_records`) as a FASTA file and
    an index of its own; returns (records, families, twins, index,
    record names)."""
    t0 = time.perf_counter()
    recs, planted, pairs = make_repeat_records(
        rng, text_bp, RECORDS, families, copies, tandems, twins)
    db, index = WORK / "repeats.fna", WORK / "repeats"
    names = [f"rep{i} synthetic" for i in range(RECORDS)]
    write_fasta(db, names, [r.tobytes() for r in recs])
    log(f"self-match data: {text_bp} bp in {RECORDS} records, families of "
        f"{[len(f) for f in planted]} copies of {[f[0][2] for f in planted]}"
        f" bp at divergence {REPEAT_DIVERGENCE}, {tandems} tandem arrays, "
        f"{len(pairs)} twins of {TWIN_LENGTH} bp with 1-2 edits "
        f"({sum(t[5] for t in pairs)} with an indel) "
        f"({time.perf_counter() - t0:.2f} s, not timed below)")
    t0 = time.perf_counter()
    mkvtree_run(dev, db, index)
    log(f"mkvtree (repeat text): {time.perf_counter() - t0:.3f} s wall")
    return recs, planted, pairs, index, names


def selfmatch_phase(dev, profile: bool, text_bp: int = TEXT_BP,
                    families: int = REPEAT_FAMILIES,
                    copies: tuple = REPEAT_COPIES,
                    tandems: int = TANDEM_ARRAYS,
                    prefix_bp: int = PREFIX_BP, twins: int = TWINS) -> dict:
    """mkvtree over the repeat text, then ``vmatch -l``, ``-supermax -l``
    and ``-tandem -l`` with their checks, and the recount on the prefix
    index.  The result also carries what :func:`extend_phase` goes on
    with: the records, the twins and both indexes."""
    from vstree_tpu_torch.cli import mkvtree
    from vstree_tpu_torch.engine import repeats
    from vstree_tpu_torch.index.esa import ESA

    rng = np.random.default_rng(SEED + 4)
    recs, planted, pairs, index, names = repeat_index(
        rng, dev, text_bp, families, copies, tandems, twins)
    L = str(SELF_LENGTH)
    result = {"recs": recs, "twins": pairs, "index": index,
              "db": WORK / "repeats.fna", "prefix_index": WORK / "prefix",
              "prefix_db": WORK / "prefix.fna",
              "prefix_bp": min(prefix_bp, recs[0].size)}
    with peak_memory(dev, f"vmatch -l {L}"):
        wall, _ = timed_vmatch(["-l", L, str(index)], dev, WORK / "l.out",
                               profile)
    rows = self_rows(WORK / "l.out")
    result["pairs"] = len(rows)
    result["l_s"] = wall
    log(f"  maximal pairs: {len(rows)} ({len(rows) / wall:.0f} pairs/s end "
        "to end)")
    if text_bp == TEXT_BP and not 10**5 <= len(rows) <= 10**6:
        raise AssertionError(f"-l {L} reports {len(rows)} pairs, outside "
                             "10^5..10^6")
    reported = set(map(tuple, rows.tolist()))
    if len(reported) != len(rows):
        raise AssertionError(f"-l {L} reports a pair twice")
    # every maximal match between sampled planted copy pairs is reported
    pairs = [(fam[i], fam[j]) for fam in planted
             for i in range(len(fam)) for j in range(i + 1, len(fam))]
    picked = rng.choice(len(pairs), min(COPY_PAIRS_CHECKED, len(pairs)),
                        replace=False)
    want = [m for i in picked
            for m in aligned_matches(recs, *pairs[i], SELF_LENGTH)]
    missing = [m for m in want if m not in reported]
    if missing or not want:
        raise AssertionError(
            f"{len(missing)} of {len(want)} maximal matches between "
            f"planted copies are not reported, e.g. {missing[:3]}")
    checked = check_sampled_rows(rng, recs, rows, SELF_LENGTH)
    log(f"  checks: {len(want)} matches of {len(picked)} planted copy "
        f"pairs are all reported; {checked} sampled rows are maximal "
        "exact matches by direct comparison")

    with peak_memory(dev, f"vmatch -supermax -l {L}"):
        result["supermax_s"], _ = timed_vmatch(
            ["-supermax", "-l", L, str(index)], dev, WORK / "supermax.out")
    srows = self_rows(WORK / "supermax.out")
    stray = [r for r in map(tuple, srows.tolist()) if r not in reported]
    if stray or len(srows) == 0:
        raise AssertionError(f"{len(stray)} of {len(srows)} supermaximal "
                             f"pairs are no maximal pairs: {stray[:3]}")
    checked = check_sampled_rows(rng, recs, srows, SELF_LENGTH)
    log(f"  supermaximal pairs: {len(srows)}, all among the maximal "
        f"pairs; {checked} sampled rows checked")
    result["supermax"] = len(srows)

    with peak_memory(dev, f"vmatch -tandem -l {L}"):
        timed_vmatch(["-tandem", "-l", L, str(index)], dev,
                     WORK / "tandem.out")
    trows = self_rows(WORK / "tandem.out")
    if len(trows) == 0:
        raise AssertionError("-tandem reports nothing on planted arrays")
    checked = check_sampled_rows(rng, recs, trows, SELF_LENGTH, tandem=True)
    log(f"  branching tandem repeats: {len(trows)}; {checked} sampled "
        "rows checked")
    result["tandem"] = len(trows)

    # the recount: the first prefix_bp of record 0, the torch program
    # against the NumPy enumeration, in order
    pdb, pindex = WORK / "prefix.fna", result["prefix_index"]
    write_fasta(pdb, names[:1], [recs[0][:prefix_bp].tobytes()])
    mkvtree.run(["-db", str(pdb), "-dna", "-pl", "-allout", "-indexname",
                 str(pindex)], dev)
    timed_vmatch(["-l", L, str(pindex)], dev, WORK / "prefix.out")
    esa = ESA.read(str(pindex), dev)
    got = repeats.find_maximal_pairs_ref(esa, SELF_LENGTH)
    d, ri, rj = repeats.maximal_pairs_ref_order_vec(esa, SELF_LENGTH)
    p1, p2 = esa.suftab[ri], esa.suftab[rj]
    prows = self_rows(WORK / "prefix.out")
    if not (np.array_equal(got.length1, d)
            and np.array_equal(got.position1, np.minimum(p1, p2))
            and np.array_equal(got.position2, np.maximum(p1, p2))
            and np.array_equal(prows[:, [0, 2, 4]], np.stack(
                [d, np.minimum(p1, p2), np.maximum(p1, p2)], 1))
            and len(d) > 0):
        raise AssertionError(
            f"prefix index: the torch program gives {len(got)} pairs, the "
            f"CLI {len(prows)} rows, NumPy {len(d)}, or their order differs")
    log(f"  recount on the first {min(prefix_bp, recs[0].size)} bp: "
        f"{len(d)} pairs, the torch program, the CLI's rows and the NumPy "
        "enumeration equal in order")
    return result


def mum_phase(dev, db_bp: int = MUM_DB_BP, query_bp: int = MUM_QUERY_BP):
    """``vmatch -mum -l`` on an index built with ``-db`` and ``-q``: the
    query record is made of windows of the database with substitutions,
    so the maximal unique matches between the two are known."""
    from vstree_tpu_torch.cli import mkvtree

    rng = np.random.default_rng(SEED + 5)
    dbseq = LETTERS[rng.integers(0, 4, db_bp)]
    qseq = LETTERS[rng.integers(0, 4, query_bp)]
    planted = []
    for st in range(100, query_bp - 700, 1000):
        ln = int(rng.integers(200, 600))
        src = int(rng.integers(100, db_bp - ln - 100))
        piece = dbseq[src:src + ln].copy()
        at = rng.choice(ln, ln // 50, replace=False)
        piece[at] = LETTERS[(np.searchsorted(LETTERS, piece[at]) + 1) % 4]
        qseq[st:st + ln] = piece
        planted.append(((0, src, ln), (1, st, ln)))
    db, qf, index = WORK / "mumdb.fna", WORK / "mumq.fna", WORK / "mum"
    write_fasta(db, ["db synthetic"], [dbseq.tobytes()])
    write_fasta(qf, ["query synthetic"], [qseq.tobytes()])
    mkvtree.run(["-db", str(db), "-q", str(qf), "-dna", "-pl", "-allout",
                 "-indexname", str(index)], dev)
    with peak_memory(dev, f"vmatch -mum -l {SELF_LENGTH}"):
        timed_vmatch(["-mum", "-l", str(SELF_LENGTH), str(index)], dev,
                     WORK / "mum.out")
    rows = self_rows(WORK / "mum.out")
    rows[:, 3] += 1     # vmatch numbers the indexed queries from 0
    recs = [dbseq, qseq]
    want = {m for a, b in planted
            for m in aligned_matches(recs, a, b, SELF_LENGTH)}
    both = dbseq.tobytes() + b"#" + qseq.tobytes()
    unique = {m for m in want
              if both.count(recs[0][m[2]:m[2] + m[0]].tobytes()) == 2}
    got = set(map(tuple, rows.tolist()))
    # a row outside the planted windows is a chance match: check it
    # directly as well
    for d, r1, p1, r2, p2 in got - unique:
        word = recs[r1][p1:p1 + d].tobytes()
        if not (r1 == 0 and r2 == 1 and d >= SELF_LENGTH
                and word == recs[r2][p2:p2 + d].tobytes()
                and both.count(word) == 2):
            raise AssertionError(f"-mum row {(d, r1, p1, r2, p2)} is no "
                                 "unique match of database and query")
    if unique - got or not unique:
        raise AssertionError(
            f"{len(unique - got)} of {len(unique)} planted unique matches "
            f"are not reported: {sorted(unique - got)[:3]}")
    check_sampled_rows(rng, recs, rows, SELF_LENGTH)
    log(f"  -mum on {db_bp} + {query_bp} bp: {len(rows)} rows; all "
        f"{len(unique)} planted unique matches reported ({len(want)} "
        "planted matches in all), every row unique by a direct count")
    return {"mums": len(rows)}


# ---------------------------------------------------------------------------
# seed extension
# ---------------------------------------------------------------------------

TABLE_FIELDS = ("length1", "position1", "length2", "position2", "distance",
                "flag", "seqnum1", "relpos1", "seqnum2", "relpos2", "evalue",
                "idnumber", "transnum")


def edit_distance(x: np.ndarray, y: np.ndarray) -> int:
    """Unit-cost edit distance of two byte arrays in which an n matches
    nothing, not even an n: plain dynamic programming, one row per char
    of ``x`` (the deletions of a row by a running minimum)."""
    j = np.arange(y.size + 1)
    row = j.copy()
    for c in x.tolist():
        diag = row[:-1] + ((y != c) | (c == ord("n")))
        tmp = np.concatenate([[row[0] + 1], np.minimum(row[1:] + 1, diag)])
        row = np.minimum.accumulate(tmp - j) + j
    return int(row[-1])


def extension_rows(path: Path) -> np.ndarray:
    """int64 [rows, 7]: (length1, record1, pos1, length2, record2, pos2,
    distance) of the default rows of a self comparison."""
    return np.loadtxt(path, comments="#", usecols=(0, 1, 2, 4, 5, 6, 7),
                      dtype=np.int64, ndmin=2)


def check_extension_rows(rng, recs, rows: np.ndarray, kind: str,
                         least: int, k: int | None) -> int:
    """Every row: both lengths at least ``least``, both places inside
    their records (no SEPARATOR inside a match), the first place before
    the second, the distance of the task's sign and within ``k``.
    EXTEND_ROWS_CHECKED sampled rows, directly on the records: the
    mismatch count of the two equal-length substrings is the distance
    (``hamming``, ``hxdrop``); the unit edit distance a NumPy DP finds is
    at most the distance (``edit``, ``exdrop``: the extension's own
    alignment has that many edits)."""
    l1, r1, p1, l2, r2, p2, dist = rows.T
    size = np.array([r.size for r in recs])
    inside = (p1 >= 0) & (p2 >= 0) & (p1 + l1 <= size[r1]) \
        & (p2 + l2 <= size[r2])
    mismatches = kind in ("hamming", "hxdrop")
    signed = (dist <= 0) if mismatches else (dist >= 0)
    bounded = np.abs(dist) <= (k if k is not None else 1 << 40)
    ordered = (r1 < r2) | ((r1 == r2) & (p1 < p2))
    ok = (inside & signed & bounded & ordered & (l1 >= least)
          & (l2 >= least) & ((l1 == l2) | (not mismatches)))
    if not ok.all():
        bad = rows[np.flatnonzero(~ok)[:3]].tolist()
        raise AssertionError(f"{int((~ok).sum())} rows of the {kind} run "
                             f"break a rule of its rows, e.g. {bad}")
    count = min(EXTEND_ROWS_CHECKED, len(rows))
    for a, ra, pa, b, rb, pb, d in rows[rng.choice(
            len(rows), count, replace=False)].tolist():
        x, y = recs[ra][pa:pa + a], recs[rb][pb:pb + b]
        if mismatches:
            direct = int(((x != y) | (x == ord("n"))).sum())
            good = direct == -d
        else:
            direct = edit_distance(x, y)
            good = direct <= d
        if not good:
            raise AssertionError(
                f"row {(a, ra, pa, b, rb, pb, d)} of the {kind} run: a "
                f"direct computation gives {direct}")
    return count


def twins_covered(rows: np.ndarray, twins: list) -> int:
    """Every twin has a row whose first place covers its first sequence
    and whose second place covers its second; returns their number."""
    key = rows[:, 1] * (1 << 32) + rows[:, 2]
    order = np.argsort(key, kind="stable")
    key = key[order]
    missing = []
    for t in twins:
        r, s1, n1, s2, n2 = t[:5]
        lo = np.searchsorted(key, r * (1 << 32) + max(s1 - SLOT, 0))
        hi = np.searchsorted(key, r * (1 << 32) + s1, side="right")
        l1, _, p1, l2, r2, p2, _ = rows[order[lo:hi]].T
        if not ((p1 + l1 >= s1 + n1) & (r2 == r) & (p2 <= s2)
                & (p2 + l2 >= s2 + n2)).any():
            missing.append(t)
    if missing or not twins:
        raise AssertionError(f"{len(missing)} of {len(twins)} planted twins "
                             f"are covered by no row, e.g. {missing[:3]}")
    return len(twins)


def eligible_twins(twins: list, argv: list[str], kind: str) -> list:
    """The twins that the run must find: those with an exact run of the
    seed length, and for the mismatch tasks those without an indel."""
    from vstree_tpu_torch.cli import vmatch

    opts = vmatch.parse_args(argv + ["index"])
    if kind in ("exdrop", "hxdrop"):
        seed = opts["seedlength"] or 30
    else:
        k = opts["e"] if opts["e"] is not None else opts["h"]
        seed = max(opts["seedlength"] or 0, opts["l"] // (k + 1))
    return [t for t in twins if t[6] >= seed
            and not (t[5] and kind in ("hamming", "hxdrop"))]


def card_equals_cpu(index: Path, argv: list[str], dev) -> int:
    """The task's ``MatchTable`` (before the funnel) from the card and
    from the same code on CPU tensors, column by column (``argv`` may
    name a query file)."""
    import torch

    from vstree_tpu_torch.cli import vmatch
    from vstree_tpu_torch.index.esa import ESA

    tables = []
    for d in (dev, torch.device("cpu")):
        opts = vmatch.parse_args(argv + [str(index)])
        tables.append(vmatch.matches(ESA.read(str(index), d), opts,
                                     vmatch._query_speedup(opts))[0])
    got, want = tables
    for f in TABLE_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"vmatch {' '.join(argv)}: column {f} of "
                                 "the card's table differs from the CPU's")
    return len(got)


def seedlength_sweep(dev, ctx: dict) -> None:
    """``-l 30 -e 2`` on the repeat text at the default seed length (10)
    and at others than the 16 of EXTEND_RUNS: walls, phases, seeds and
    rows."""
    for seedlength in ("10", "12", "14", "20"):
        argv = ["-l", "30", "-e", "2", "-seedlength", seedlength]
        out = WORK / f"extend_e2_s{seedlength}.out"
        with peak_memory(dev, f"vmatch {' '.join(argv)}"):
            timed_vmatch(argv + [str(ctx["index"])], dev, out)
        rows = extension_rows(out)
        log(f"  rows: {len(rows)}; "
            f"{twins_covered(rows, eligible_twins(ctx['twins'], argv, 'edit'))}"
            " eligible twins covered")


def default_seedlength_fronts(dev, ctx: dict) -> dict:
    """The device part of ``-l 30 -e 2`` at its default seed length of
    10, where the repeat text has ~10^8 seeds: the enumeration and the
    chunked fronts with their viability filter, timed; fails if the
    seeds went through the card in one chunk."""
    import torch

    from vstree_tpu_torch.device import PhaseTimes, record_phases
    from vstree_tpu_torch.engine import gextend, gextend_dev, repeats_dev
    from vstree_tpu_torch.index.esa import ESA

    esa = ESA.read(str(ctx["index"]), dev)
    text = esa.multiseq.sequence
    sq = gextend.Seqs(text, text, dev)
    chunks = []
    real = gextend_dev._fronts_direction

    def counted(*args, **kw):
        chunks.append(int(args[2].numel()))
        return real(*args, **kw)

    times = PhaseTimes(dev)
    t0 = time.perf_counter()
    gextend_dev._fronts_direction = counted
    try:
        with peak_memory(dev, "fronts of -l 30 -e 2 at seed length 10"), \
                record_phases(times):
            (p1, p2, d, _, _), total = repeats_dev.maximal_pairs_device_seeds(
                esa, 10)
            vidx, lf, hl, rf, hr = gextend_dev.edit_fronts_viable(
                sq, p1, p2, d, 2, 30, 10)
    finally:
        gextend_dev._fronts_direction = real
    wall = time.perf_counter() - t0
    log(f"fronts of -l 30 -e 2 at the default seed length 10: {wall:.3f} s")
    for name, sec in times.seconds.items():
        log(f"  {name:16s} {sec:9.3f} s")
    log(f"  {total} seeds in {len(chunks) // 2} chunks of at most "
        f"{max(chunks)}, {vidx.size} viable; fronts {lf.shape}")
    one_chunk = dev.type == "cuda" and len(chunks) < 4
    if one_chunk or sum(chunks) != 2 * total or vidx.size == 0:
        raise AssertionError(
            f"{total} seeds went through {len(chunks) // 2} chunk(s), "
            f"{vidx.size} viable: the chunked path was not driven")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"seeds": total, "viable": int(vidx.size)}


class ladder_clock:
    """Counts and times the ladder runs that the host loops of the
    Hamming and x-drop extensions ask of the card (``Seqs.lce``: upload,
    ladder, download) inside the block."""

    def __enter__(self):
        from vstree_tpu_torch.engine import gextend

        self.real = real = gextend.Seqs.lce
        self.runs = self.lanes = 0
        self.seconds = 0.0

        def clocked(sq, a, b, forward):
            t0 = time.perf_counter()
            try:
                return real(sq, a, b, forward)
            finally:
                self.runs += 1
                self.lanes += int(np.size(a))
                self.seconds += time.perf_counter() - t0

        gextend.Seqs.lce = clocked
        return self

    def __exit__(self, *exc):
        from vstree_tpu_torch.engine import gextend

        gextend.Seqs.lce = self.real


def extend_phase(dev, ctx: dict, profile: bool = False) -> dict:
    """The seed-extension runs on the repeat text of
    :func:`selfmatch_phase` (``ctx`` is its result): EXTEND_RUNS on the
    whole index, EXTEND_ALLMAX on the prefix index, each with its phases,
    seeds, survivors and peak memory, the checks of its rows and the
    planted twins; then all five on the prefix index, the card's table
    against the CPU's."""
    rng = np.random.default_rng(SEED + 7)
    recs, twins = ctx["recs"], ctx["twins"]
    result = {"fronts10": default_seedlength_fronts(dev, ctx)}
    for name, argv, kind in EXTEND_RUNS + (EXTEND_ALLMAX,):
        prefix = name == EXTEND_ALLMAX[0]
        index = ctx["prefix_index"] if prefix else ctx["index"]
        out = WORK / f"extend_{name}.out"
        with peak_memory(dev, f"vmatch {' '.join(argv)}"), \
                ladder_clock() as ladder:
            wall, times = timed_vmatch(argv + [str(index)], dev, out,
                                       profile and name == "e2")
        if ladder.runs:
            log(f"  the extension's host loop asked for {ladder.runs} ladder "
                f"runs of {ladder.lanes} lanes in all: {ladder.seconds:.3f} s "
                "with their transfers")
        if kind == "edit" and "survivor order" not in times.seconds:
            raise AssertionError(
                f"vmatch {' '.join(argv)} left the fused path (the "
                "pathological-run guard of the seed enumeration fired)")
        rows = extension_rows(out)
        least = int(argv[1])
        k = int(argv[3]) if kind in ("edit", "hamming") else None
        checked = check_extension_rows(
            rng, [r[:ctx["prefix_bp"]] for r in recs[:1]] if prefix
            else recs, rows, kind, least, k)
        mine = eligible_twins(
            [t for t in twins if not prefix
             or (t[0] == 0 and t[3] + t[4] <= ctx["prefix_bp"])], argv, kind)
        covered = twins_covered(rows, mine)
        unequal = int((rows[:, 0] != rows[:, 3]).sum())
        log(f"  rows: {len(rows)} ({len(rows) / wall:.0f} rows/s end to "
            f"end), {unequal} with length1 != length2; all {covered} "
            f"eligible twins covered; {checked} sampled rows agree with a "
            "direct computation")
        if kind == "edit" and unequal == 0:
            raise AssertionError(f"vmatch {' '.join(argv)}: no row with "
                                 "length1 != length2")
        result[name] = {"rows": len(rows), "wall": wall,
                        "counts": dict(times.counts)}
    for name, argv, _ in EXTEND_RUNS + (EXTEND_ALLMAX,):
        t0 = time.perf_counter()
        n = card_equals_cpu(ctx["prefix_index"], argv, dev)
        log(f"  prefix index, vmatch {' '.join(argv)}: {n} matches, every "
            f"column of the card's table equals the CPU's "
            f"({time.perf_counter() - t0:.2f} s for both)")
    return result


# ---------------------------------------------------------------------------
# -q query matching on the index (phase 10)
# ---------------------------------------------------------------------------

QUERY_RECORDS = 200           # ~2 Mbp of queries in 200 records
QUERY_BP = 2_000_000
QUERY_WINDOWS = 400           # windows of text (a) planted in the queries
QUERY_WINDOW = (300, 3000)
QUERY_SUBST = 0.01            # substitutions per base of a window
QUERY_LENGTH = 20
QUERY_SUBSET = 20             # records of the -qspeedup comparison (0.2 Mbp)
SELFQ_LENGTH = 30             # -l 30 -q on text (b): the db-vs-itself pipeline
ONLINE_QUERY_RECORDS = 2      # -online -l 20 -q (each scans all of text a)
QUERY_ROWS_CHECKED = 1_000
QUERY_UNIQUE_CHECKED = 100    # of them also counted over all of text (a)
QUERY_DP_ROWS = 500           # rows of -l 30 -e 2 -q held to a NumPy DP
# the -q runs on text (a): (name, options before -q)
QUERY_RUNS = (
    ("l20", ["-l", "20"]),
    ("mum", ["-mum", "-l", "20"]),
    ("mumcand", ["-mum", "cand", "-l", "20"]),
    ("dp", ["-d", "-p", "-l", "20"]),
    ("e2", ["-l", "30", "-e", "2"]),
)
_COMPLEMENT = bytes.maketrans(b"acgtn", b"tgcan")


def make_query_records(rng, recs: list, nrec: int, windows: int,
                       total: int):
    """``nrec`` query records of random acgt, ``total`` bp in all, that
    hold ``windows`` n-free windows of the database records ``recs``
    (QUERY_WINDOW long, QUERY_SUBST substitutions each at known places;
    every fourth window reverse-complemented).  Returns the records
    (bytes) and per direct window (query record, query position, db
    record, db position, length, substituted offsets)."""
    per, w_per = total // nrec, max(1, windows // nrec)
    slot = per // w_per
    out, planted = [], []
    for r in range(nrec):
        seq = LETTERS[rng.integers(0, 4, per)]
        for k in range(w_per):
            ln = int(rng.integers(QUERY_WINDOW[0],
                                  min(QUERY_WINDOW[1], slot - 100) + 1))
            while True:
                ri = int(rng.integers(0, len(recs)))
                st = int(rng.integers(0, len(recs[ri]) - ln))
                win = np.frombuffer(bytes(recs[ri][st:st + ln]),
                                    np.uint8).copy()
                if ord("n") not in win:
                    break
            at = np.sort(rng.choice(ln, max(1, round(ln * QUERY_SUBST)),
                                    replace=False))
            win[at] = LETTERS[(np.searchsorted(LETTERS, win[at])
                               + rng.integers(1, 4, at.size)) % 4]
            qp = k * slot + int(rng.integers(0, slot - ln))
            if (r * w_per + k) % 4 == 3:
                seq[qp:qp + ln] = np.frombuffer(
                    win.tobytes()[::-1].translate(_COMPLEMENT), np.uint8)
                continue
            seq[qp:qp + ln] = win
            planted.append((r, qp, ri, st, ln, at))
        out.append(seq.tobytes())
    return out, planted


def query_rows(path: Path) -> list[tuple]:
    """(length1, record1, pos1, kind, length2, record2, pos2, distance)
    of vmatch's default rows."""
    rows = []
    with open(path) as fh:
        for line in fh:
            if not line.startswith("#"):
                f = line.split()
                rows.append((int(f[0]), int(f[1]), int(f[2]), f[3],
                             int(f[4]), int(f[5]), int(f[6]), int(f[7])))
    return rows


def check_query_rows(rng, db: list, qs: list, rows: list, least: int,
                     unique_db: bool = False,
                     unique_query: bool = False) -> int:
    """QUERY_ROWS_CHECKED sampled rows of an exact -q run, byte by byte:
    the database place holds the query place (its reverse complement for
    a palindromic row), at least ``least`` chars, no n, maximal on both
    sides; with ``unique_db``/``unique_query`` the word of the first
    QUERY_UNIQUE_CHECKED of them occurs once in the database / in the
    queries."""
    count = min(QUERY_ROWS_CHECKED, len(rows))
    for k, i in enumerate(rng.choice(len(rows), count, replace=False)):
        l1, r1, p1, kind, l2, r2, p2, _ = rows[i]
        x, y = bytes(db[r1]), bytes(qs[r2])
        word = x[p1:p1 + l1]
        if kind == "P":     # the query side of the reverse complement
            y = y[::-1].translate(_COMPLEMENT)
            p2 = len(y) - p2 - l2
        same = (l1 == l2 >= least and word == y[p2:p2 + l2]
                and b"n" not in word)
        right = (p1 + l1 == len(x) or p2 + l2 == len(y)
                 or x[p1 + l1] != y[p2 + l2] or x[p1 + l1] == ord("n"))
        left = (p1 == 0 or p2 == 0 or x[p1 - 1] != y[p2 - 1]
                or x[p1 - 1] == ord("n"))
        counted = k < QUERY_UNIQUE_CHECKED
        unique = ((not (unique_db and counted)
                   or sum(bytes(r).count(word) for r in db) == 1)
                  and (not (unique_query and counted)
                       or sum(q.count(word) for q in qs) == 1))
        if not (same and left and right and unique):
            raise AssertionError(
                f"row {rows[i]} is no maximal exact match (equal {same}, "
                f"left {left}, right {right}, unique {unique})")
    return count


def planted_runs(planted: list, least: int) -> set:
    """The exact runs of at least ``least`` chars between two planted
    substitutions of a window, as the rows that must report them:
    (length, db record, db pos, D, length, query record, query pos)."""
    runs = set()
    for r, qp, ri, st, _, at in planted:
        for a, b in zip(at[:-1].tolist(), at[1:].tolist()):
            if b - a - 1 >= least:
                runs.add((b - a - 1, ri, st + a + 1, "D", b - a - 1, r,
                          qp + a + 1))
    return runs


def query_phase(dev, a_recs: list, a_index: Path, ctx: dict,
                nrec: int = QUERY_RECORDS, total: int = QUERY_BP,
                windows: int = QUERY_WINDOWS,
                subset: int = QUERY_SUBSET) -> dict:
    """Phase 10, the port's -q paths: (a) a query file of about 2 Mbp
    against text (a)'s index (QUERY_RUNS; every planted exact run >= 20
    reported, sampled rows held byte by byte, MUMs unique; a 0.2 Mbp
    subset at -qspeedup 0, 2 and 5 gives equal rows); (b) text (b)
    queried against its own index (the db-vs-itself pipeline must run);
    (c) ``-l 20 -p`` on text (b) (the merged sort of matching statistics
    must run); (d) ``-online -l 20 -q`` with a few records, the same rows
    as the indexed run; then every run on the 1 Mbp prefix indexes, the
    card's table against the CPU's."""
    from vstree_tpu_torch.native import myers, rankcount

    rng = np.random.default_rng(SEED + 8)
    k1, k2 = (rankcount.rank_interval_lookup.launches,
              myers.verify_edit.launches)
    t0 = time.perf_counter()
    qs, planted = make_query_records(rng, a_recs, nrec, windows, total)
    qf = WORK / "queries.fna"
    write_fasta(qf, [f"q{i} synthetic" for i in range(nrec)], qs)
    runs = planted_runs(planted, QUERY_LENGTH)
    log(f"query data: {sum(map(len, qs))} bp in {nrec} records, "
        f"{windows} windows of {QUERY_WINDOW} bp from text (a) "
        f"({windows - len(planted)} reverse-complemented) at "
        f"{QUERY_SUBST} substitutions per base, {len(runs)} exact runs >= "
        f"{QUERY_LENGTH} between planted substitutions "
        f"({time.perf_counter() - t0:.2f} s, not timed below)")
    start = clock = time.perf_counter()

    def lap(what: str) -> None:
        nonlocal clock
        now = time.perf_counter()
        log(f"  phase 10, {what}: {now - clock:.1f} s with its checks")
        clock = now

    result = {}
    rows = {}
    for name, argv in QUERY_RUNS:
        out = WORK / f"query_{name}.out"
        with peak_memory(dev, f"vmatch {' '.join(argv)} -q"):
            wall, _ = timed_vmatch(argv + ["-q", str(qf), str(a_index)], dev,
                                   out)
        rows[name] = query_rows(out)
        result[name] = {"rows": len(rows[name]), "wall": wall}
        log(f"  rows: {len(rows[name])}")
    got = {r[:7] for r in rows["l20"]}
    missing = runs - got
    if missing or not runs:
        raise AssertionError(f"{len(missing)} of {len(runs)} planted exact "
                             f"runs are not reported: {sorted(missing)[:3]}")
    checked = check_query_rows(rng, a_recs, qs, rows["l20"], QUERY_LENGTH)
    log(f"  -l {QUERY_LENGTH} -q: all {len(runs)} planted runs reported; "
        f"{checked} sampled rows are maximal exact matches")
    checked = check_query_rows(rng, a_recs, qs, rows["mum"], QUERY_LENGTH,
                               unique_db=True, unique_query=True)
    checked += check_query_rows(rng, a_recs, qs, rows["mumcand"],
                                QUERY_LENGTH, unique_db=True)
    if not {r[:7] for r in rows["mum"]} <= {r[:7] for r in rows["mumcand"]}:
        raise AssertionError("a MUM is no MUM candidate")
    log(f"  -mum, -mum cand: {checked} sampled rows maximal, "
        f"{2 * QUERY_UNIQUE_CHECKED} of them unique by a direct count; every "
        "MUM is a candidate")
    direct = [r for r in rows["dp"] if r[3] == "D"]
    pal = [r for r in rows["dp"] if r[3] == "P"]
    if {r[:7] for r in direct} != got or not pal:
        raise AssertionError(f"-d -p: {len(direct)} direct rows differ from "
                             f"-l {QUERY_LENGTH}'s, or no palindromic row")
    checked = check_query_rows(rng, a_recs, qs, pal, QUERY_LENGTH)
    log(f"  -d -p: direct rows equal -l {QUERY_LENGTH}'s; {checked} of "
        f"{len(pal)} palindromic rows checked on the reverse complement")
    check_query_extension(rng, a_recs, qs, planted, rows["e2"])
    result["windows"] = len(planted)
    lap("(a) the runs on 2 Mbp of queries")

    # the -qspeedup comparison on a subset of the records
    sub = WORK / "queries_subset.fna"
    write_fasta(sub, [f"q{i} synthetic" for i in range(subset)],
                qs[:subset])
    bodies = []
    for qsp in ("0", "2", "5"):
        out = WORK / f"query_qsp{qsp}.out"
        timed_vmatch(["-qspeedup", qsp, "-l", str(QUERY_LENGTH), "-q",
                      str(sub), str(a_index)], dev, out)
        bodies.append(body_lines(out))
    if not bodies[0] == bodies[1] == bodies[2] or not bodies[0]:
        raise AssertionError("-qspeedup 0, 2 and 5 give different rows")
    log(f"  -qspeedup 0, 2, 5 on {sum(map(len, qs[:subset]))} bp: the same "
        f"{len(bodies[0])} rows")
    lap("(a) -qspeedup 0, 2, 5")

    # (b) text (b) against its own index
    argv = ["-l", str(SELFQ_LENGTH), "-q", str(ctx["db"])]
    out = WORK / "query_self.out"
    with peak_memory(dev, f"vmatch {' '.join(argv[:-1])} (text b)"):
        wall, times = timed_vmatch(argv + [str(ctx["index"])], dev, out)
    if "self pipeline" not in times.seconds or \
            "self pipeline fallbacks" in times.counts:
        raise AssertionError("-q on the database itself did not take the "
                             "db-vs-itself pipeline")
    srows = query_rows(out)
    b_recs = ctx["recs"]
    checked = check_query_rows(rng, b_recs, [r.tobytes() for r in b_recs],
                               srows, SELFQ_LENGTH)
    log(f"  db-vs-itself: {len(srows)} rows ({len(srows) / wall:.0f} rows/s "
        f"end to end); {checked} sampled rows checked")
    result["self"] = {"rows": len(srows), "wall": wall}
    lap("(b) the database against itself")

    # (c) self-palindromic -l 20 -p on text (b)
    argv = ["-l", str(QUERY_LENGTH), "-p"]
    out = WORK / "query_selfpal.out"
    with peak_memory(dev, f"vmatch {' '.join(argv)} (text b)"):
        wall, times = timed_vmatch(argv + [str(ctx["index"])], dev, out)
    if times.counts.get("merged sorts", 0) < 1:
        raise AssertionError("-l -p on text (b) did not take the merged sort")
    prows = query_rows(out)
    # at 16 Mbp ~10^2 chance palindromes of >= 20 are expected
    full = sum(r.size for r in b_recs) == TEXT_BP
    if any(r[3] != "P" for r in prows) or (full and not prows):
        raise AssertionError("-l -p gives a direct row, or none")
    checked = check_query_rows(rng, b_recs, [r.tobytes() for r in b_recs],
                               prows, QUERY_LENGTH)
    log(f"  -l {QUERY_LENGTH} -p: {len(prows)} rows, {checked} checked on "
        f"the reverse complement; {times.counts['snapshots']} snapshots "
        f"kept (cap {times.counts['snapshot cap']})")
    result["selfpal"] = {"rows": len(prows), "wall": wall,
                         "snapshots": times.counts["snapshots"]}
    lap("(c) -p on the database")

    # (d) -online -q against the indexed run of the same records
    on = WORK / "queries_online.fna"
    write_fasta(on, [f"q{i} synthetic" for i in range(ONLINE_QUERY_RECORDS)],
                qs[:ONLINE_QUERY_RECORDS])
    sets = []
    for extra in (["-online"], []):
        argv = extra + ["-l", str(QUERY_LENGTH), "-q", str(on)]
        out = WORK / f"query_online{len(extra)}.out"
        with peak_memory(dev, f"vmatch {' '.join(argv[:-1])}"):
            timed_vmatch(argv + [str(a_index)], dev, out)
        sets.append(set(body_lines(out)))
    if sets[0] != sets[1] or not sets[0]:
        raise AssertionError(f"-online -q: {len(sets[0])} rows, the indexed "
                             f"run {len(sets[1])}: not the same set")
    log(f"  -online -l {QUERY_LENGTH} -q, {ONLINE_QUERY_RECORDS} records: "
        f"the same {len(sets[0])} rows as the indexed run")
    lap("(d) -online -q")

    # every run on the prefix indexes: the card's table is the CPU's
    pdb, pindex, pq = WORK / "prefix_a.fna", WORK / "prefix_a", \
        WORK / "prefix_q.fna"
    prefix = a_recs[0][:ctx["prefix_bp"]]
    write_fasta(pdb, ["chr0 prefix"], [prefix])
    pqs, _ = make_query_records(rng, [prefix], 20, 40, 100_000)
    write_fasta(pq, [f"p{i}" for i in range(20)], pqs)
    pq1 = WORK / "prefix_q1.fna"
    write_fasta(pq1, ["p0"], pqs[:1])
    mkvtree_run(dev, pdb, pindex)
    for index, argv in (
            [(pindex, a + ["-q", str(pq)]) for _, a in QUERY_RUNS]
            + [(pindex, ["-qspeedup", s, "-l", "20", "-q", str(pq)])
               for s in ("0", "5")]
            + [(pindex, ["-online", "-l", "20", "-q", str(pq1)]),
               (ctx["prefix_index"], ["-l", str(SELFQ_LENGTH), "-q",
                                      str(ctx["prefix_db"])]),
               (ctx["prefix_index"], ["-l", "14", "-p"])]):
        t0 = time.perf_counter()
        n = card_equals_cpu(index, argv, dev)
        log(f"  prefix index, vmatch {' '.join(argv)}: {n} matches, every "
            f"column of the card's table equals the CPU's "
            f"({time.perf_counter() - t0:.2f} s for both)")
    lap("the card against the CPU on the prefix indexes")
    log(f"phase 10: {time.perf_counter() - start:.1f} s")
    k1, k2 = (rankcount.rank_interval_lookup.launches - k1,
              myers.verify_edit.launches - k2)
    log(f"  K1 and K2 launches on the -q paths: {k1}, {k2}")
    if k1 or k2:
        raise AssertionError("the -q paths launched K1 or K2")
    return result


def check_query_extension(rng, db: list, qs: list, planted: list,
                          rows: list) -> None:
    """``-l 30 -e 2 -q`` rows: lengths >= 30, distance 0..2, inside
    their records; sampled rows hold a NumPy DP's edit distance at most
    their distance; every planted window is covered by a row."""
    bad = [r for r in rows if not (r[0] >= 30 and r[4] >= 30
                                   and 0 <= r[7] <= 2 and r[3] == "D"
                                   and r[2] + r[0] <= len(db[r[1]])
                                   and r[6] + r[4] <= len(qs[r[5]]))]
    if bad or not rows:
        raise AssertionError(f"{len(bad)} -e 2 rows break its rules: "
                             f"{bad[:3]}")
    count = min(QUERY_DP_ROWS, len(rows))
    for i in rng.choice(len(rows), count, replace=False):
        l1, r1, p1, _, l2, r2, p2, d = rows[i]
        x = np.frombuffer(bytes(db[r1][p1:p1 + l1]), np.uint8)
        y = np.frombuffer(qs[r2][p2:p2 + l2], np.uint8)
        if edit_distance(x, y) > d:
            raise AssertionError(f"-e 2 row {rows[i]}: a DP gives "
                                 f"{edit_distance(x, y)}")
    by_query: dict = {}
    for r in rows:
        by_query.setdefault(r[5], []).append(r)
    missing = [w for w in planted
               if not any(r[1] == w[2] and r[2] < w[3] + w[4]
                          and r[2] + r[0] > w[3] and r[6] < w[1] + w[4]
                          and r[6] + r[4] > w[1]
                          for r in by_query.get(w[0], ()))]
    if missing:
        raise AssertionError(f"{len(missing)} of {len(planted)} planted "
                             "windows are covered by no -e 2 row")
    log(f"  -l 30 -e 2 -q: {len(rows)} rows; {count} sampled rows agree "
        f"with a DP; all {len(planted)} planted windows covered")


# ---------------------------------------------------------------------------
# phase 11: DNA queries on a protein index at proteome scale (-dnavsprot),
# and the options of vmatch that are host work only
# ---------------------------------------------------------------------------

PROTEIN_RECORDS = 20_000      # the size of the human reference proteome
PROTEIN_MEDIAN = 375          # aa; log-normal lengths (UP000005640)
PROTEIN_SPREAD = 0.85         # sigma of the lengths' logarithm
AMINO = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
# UniProtKB/Swiss-Prot amino-acid composition, percent, in AMINO's order
COMPOSITION = np.array([8.25, 5.53, 4.06, 5.45, 1.37, 3.93, 6.75, 7.07,
                        2.27, 5.96, 9.66, 5.84, 2.42, 3.86, 4.70, 6.56,
                        5.34, 1.08, 2.92, 6.87])
LOW_COMPLEXITY_SHARE = 0.02   # records with a poly-Q/S/E/P run of 10-40
PARALOG_FAMILIES = 300        # of 3-20 copies at 10-40 % substitutions
EXACT_DUPLICATES = 200
NEAR_DUPLICATES = 200         # at 98-99 % identity
DNAVSPROT_QUERIES = 20_000    # -complete -dnavsprot 1, 30-54 nt
DNAVSPROT_EDIT_QUERIES = 5_000  # -complete -e 1 -dnavsprot 1, 45-90 nt
DNAVSPROT_DNA = (500, 500_000)  # -l 15 -dnavsprot 1 -q: records, bp
DNAVSPROT_WINDOWS = 1_000     # back-translated windows of 30-200 aa in it
DNAVSPROT_SUBST = 0.05        # amino-acid substitutions per window residue
DNAVSPROT_LENGTH = 15
PROTEIN_PREFIX = 1_000_000    # aa of the card-against-CPU index
DNAVSPROT_ROWS_CHECKED = 2_000
# the standard genetic code (NCBI table 1), index 16 b1 + 4 b2 + b3 over
# t, c, a, g
STANDARD_CODE = b"FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
SELFUN_MODULE = '''
import numpy as np

ARGS = []


def selectmatch_header(argv, args):
    ARGS[:] = args


def selectmatch(mt):
    return mt.length1 >= int(ARGS[0])


def selectmatch_finaltable(mt):
    return mt.select(np.argsort(-mt.length1, kind="stable"))
'''


def codon_tables():
    """(codons [21, 6, 3] as bytes of acgt, number of codons per amino
    acid [21], index of each amino acid in AMINO or 20 for '*'): the
    back-translation of table 1, made from STANDARD_CODE alone."""
    bases = b"tcag"
    codons = np.zeros((21, 6, 3), np.uint8)
    count = np.zeros(21, np.int64)
    for k, aa in enumerate(STANDARD_CODE):
        a = 20 if aa == ord("*") else int(np.flatnonzero(AMINO == aa)[0])
        codons[a, count[a]] = [bases[k // 16], bases[k // 4 % 4],
                               bases[k % 4]]
        count[a] += 1
    return codons, count


CODONS, NCODONS = codon_tables()
_AA_INDEX = np.full(256, 20, np.int64)
_AA_INDEX[AMINO] = np.arange(20)
_TRANSLATE = {bytes(CODONS[a, j]): (AMINO[a] if a < 20 else ord("*"))
              for a in range(21) for j in range(NCODONS[a])}


def back_translate(rng, prot: np.ndarray) -> bytes:
    """DNA of a protein, one codon of table 1 drawn at random for each
    amino acid."""
    a = _AA_INDEX[prot]
    pick = (rng.random(a.size) * NCODONS[a]).astype(np.int64)
    return CODONS[a, pick].reshape(-1).tobytes()


def translate(dna: bytes) -> bytes:
    """Table-1 translation of acgt text from its first base."""
    return bytes(_TRANSLATE[dna[i:i + 3]] for i in range(0, len(dna) - 2, 3))


def reverse_complement(dna: bytes) -> bytes:
    return dna[::-1].translate(_COMPLEMENT)


def mutate_protein(rng, prot: np.ndarray, rate: float) -> np.ndarray:
    """Substitutions at ``rate`` per residue, drawn with the
    composition (a draw may give the residue back)."""
    out = prot.copy()
    at = np.flatnonzero(rng.random(out.size) < rate)
    out[at] = AMINO[rng.choice(20, at.size,
                               p=COMPOSITION / COMPOSITION.sum())]
    return out


def make_proteome(rng, nrec: int = PROTEIN_RECORDS) -> dict:
    """The protein database P: log-normal lengths, the Swiss-Prot
    composition, poly-Q/S/E/P runs in LOW_COMPLEXITY_SHARE of the
    records, PARALOG_FAMILIES families of diverged copies, and exact and
    near duplicates of other records.  Returns the records (uint8
    letters) and the (duplicate, original) record pairs."""
    p = COMPOSITION / COMPOSITION.sum()
    lens = np.clip(np.round(rng.lognormal(np.log(PROTEIN_MEDIAN),
                                          PROTEIN_SPREAD, nrec)),
                   30, 35_000).astype(np.int64)
    letters = AMINO[rng.choice(20, int(lens.sum()), p=p)]
    cut = np.concatenate([[0], np.cumsum(lens)])
    recs = [letters[cut[i]:cut[i + 1]].copy() for i in range(nrec)]
    for r in rng.choice(nrec, int(LOW_COMPLEXITY_SHARE * nrec),
                        replace=False):
        ln = min(int(rng.integers(10, 41)), recs[r].size)
        st = int(rng.integers(0, recs[r].size - ln + 1))
        recs[r][st:st + ln] = ord(rng.choice(list("QSEP")))
    order = iter(rng.permutation(nrec).tolist())
    share = nrec / PROTEIN_RECORDS   # below full size: as many per record
    families = []
    for _ in range(max(1, round(PARALOG_FAMILIES * share))):
        anc = next(order)
        copies = [anc]
        for _ in range(int(rng.integers(3, 21)) - 1):
            c = next(order)
            recs[c] = mutate_protein(rng, recs[anc], rng.uniform(0.10, 0.40))
            copies.append(c)
        families.append(copies)
    dups = []
    for _ in range(max(1, round(EXACT_DUPLICATES * share))):
        src, dst = next(order), next(order)
        recs[dst] = recs[src].copy()
        dups.append((dst, src))
    for _ in range(max(1, round(NEAR_DUPLICATES * share))):
        src, dst = next(order), next(order)
        recs[dst] = mutate_protein(rng, recs[src], rng.uniform(0.01, 0.02))
    return {"recs": recs, "dups": dups, "families": families}


def dnavsprot_queries(rng, recs, nq: int, nt: tuple, change: bool):
    """``nq`` DNA queries of ``nt`` (lo, hi) bases, each a back-translated
    window of a record, every other one reverse-complemented; with
    ``change`` one codon is replaced by one of another amino acid.
    Returns the queries and their (record, start, aa) origins."""
    lens = np.array([r.size for r in recs])
    out, origins = [], []
    for i in range(nq):
        m = int(rng.integers(nt[0], nt[1] + 1)) // 3
        while True:
            r = int(rng.integers(0, len(recs)))
            if lens[r] >= m:
                break
        st = int(rng.integers(0, lens[r] - m + 1))
        win = recs[r][st:st + m].copy()
        if change:
            j = int(rng.integers(0, m))
            others = AMINO[AMINO != win[j]]
            win[j] = others[int(rng.integers(0, others.size))]
        dna = back_translate(rng, win)
        out.append(reverse_complement(dna) if i % 2 else dna)
        origins.append((r, st, m))
    return out, origins


def dnavsprot_dna(rng, recs, nrec: int, total: int, windows: int):
    """DNA records of random filler holding ``windows`` back-translated
    windows of 30-200 aa of the proteins at DNAVSPROT_SUBST
    substitutions, every other one reverse-complemented.  Returns the
    records and the planted (record, dna offset, protein record, start,
    aa length, reverse, the window as planted)."""
    per = total // nrec
    planted = []
    out = []
    slots = np.sort(rng.choice(nrec, windows, replace=True))
    for i in range(nrec):
        parts, at = [], 0
        for _ in range(int((slots == i).sum())):
            r = int(rng.integers(0, len(recs)))
            m = min(int(rng.integers(30, 201)), recs[r].size)
            st = int(rng.integers(0, recs[r].size - m + 1))
            win = mutate_protein(rng, recs[r][st:st + m], DNAVSPROT_SUBST)
            filler = LETTERS[rng.integers(0, 4, int(rng.integers(0, 60)))]
            dna = back_translate(rng, win)
            rev = len(planted) % 2 == 1
            if rev:
                dna = reverse_complement(dna)
            parts += [filler.tobytes(), dna]
            at += filler.size
            planted.append((i, at, r, st, m, rev, win))
            at += len(dna)
        rest = max(0, per - at)
        parts.append(LETTERS[rng.integers(0, 4, rest)].tobytes())
        out.append(b"".join(parts))
    return out, planted


def protein_rows(text: str) -> np.ndarray:
    """int64 [rows, 8]: (length1, record1, pos1, reverse, length2,
    record2, pos2, distance) of default rows; reverse is 1 for a match
    in a reverse frame (mode G)."""
    rows = []
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        f = line.split()
        rows.append((int(f[0]), int(f[1]), int(f[2]), int(f[3] == "G"),
                     int(f[4]), int(f[5]), int(f[6]), int(f[7])))
    return np.array(rows, np.int64).reshape(-1, 8)


def lookup_paths(times) -> str:
    """The paths the exact lookups of a run took, by their phases."""
    said = []
    for name, what in (("rank lookup", "rank path K1"),
                       ("key search", "packed-key search"),
                       ("text search", "text search")):
        if name in times.seconds:
            said.append(what)
    extra = "".join(f", {k} {times.seconds[k]:.3f} s"
                    for k in ("rank words", "rank keys")
                    if k in times.seconds)
    return ("/".join(said) or "none") + extra


def vmatch_text(argv: list[str], dev) -> str:
    """The stdout of one port vmatch run."""
    import io

    from vstree_tpu_torch.cli import vmatch

    buf = io.StringIO()
    vmatch.run(argv, dev, out=buf)
    return buf.getvalue()


def chainqhits_text(argv: list[str], dev) -> str:
    import contextlib
    import io

    from vstree_tpu_torch.cli import chainqhits

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if chainqhits.run(argv, dev) != 0:
            raise AssertionError(f"chainqhits {' '.join(argv)} failed")
    return buf.getvalue()


def check_complete_origins(rows: np.ndarray, origins: list, k: int) -> int:
    """Every query reports its source window: the row of its record and
    start, on the strand it was taken from (odd queries reversed), the
    whole query long, at distance <= k."""
    have = set(map(tuple, rows[:, [5, 1, 2, 3]].tolist()))
    missed = [i for i, (r, st, m) in enumerate(origins)
              if (i, r, st, i % 2) not in have]
    if missed:
        i = missed[0]
        raise AssertionError(f"{len(missed)} -dnavsprot queries do not "
                             f"report their source window, e.g. query {i} "
                             f"from {origins[i]}")
    full = rows[:, 4] % 3 == 0
    if not full.all() or (np.abs(rows[:, 7]) > k).any():
        raise AssertionError("-complete -dnavsprot rows of a length that "
                             "is no codon multiple, or above the threshold")
    return len(origins)


def check_edit_rows(rng, prots, queries, rows: np.ndarray) -> int:
    """Sampled rows of ``-complete -e 1 -dnavsprot 1``: the DNA span of
    the row, translated on its strand by this script's own table, is the
    pattern; its edit distance to the protein window is the row's."""
    idx = rng.choice(rows.shape[0], min(DNAVSPROT_ROWS_CHECKED,
                                        rows.shape[0]), replace=False)
    for l1, r1, p1, rev, l2, q, p2, dist in rows[idx].tolist():
        dna = queries[q][p2:p2 + l2]
        pat = translate(reverse_complement(dna) if rev else dna)
        win = prots[r1][p1:p1 + l1]
        got = edit_distance(np.frombuffer(pat, np.uint8), win)
        if got != abs(dist):
            raise AssertionError(f"row {(l1, r1, p1, rev, l2, q, p2, dist)}"
                                 f": edit distance {got} by a NumPy DP")
    return idx.size


def check_planted_runs(prots, planted: list, rows: np.ndarray, least: int):
    """Every exact run of at least ``least`` aa of a planted window (the
    residues the substitutions left alone) lies inside a row's protein
    span and DNA span.  Returns (runs, runs found)."""
    by_q: dict[int, np.ndarray] = {}
    for q in np.unique(rows[:, 5]).tolist():
        by_q[q] = rows[rows[:, 5] == q]
    runs = found = 0
    for rec, at, prot, st, m, rev, win in planted:
        same = np.concatenate([[False], win == prots[prot][st:st + m],
                               [False]])
        edges = np.flatnonzero(np.diff(same.astype(np.int8)))
        for a, b in zip(edges[0::2], edges[1::2]):
            if b - a < least:
                continue
            runs += 1
            lo = at + 3 * (m - b) if rev else at + 3 * a
            hit = by_q.get(rec)
            if hit is None:
                continue
            ok = ((hit[:, 1] == prot) & (hit[:, 2] <= st + a)
                  & (hit[:, 2] + hit[:, 0] >= st + b)
                  & (hit[:, 6] <= lo) & (hit[:, 6] + hit[:, 4] >= lo + 3 * (b - a))
                  & (hit[:, 3] == int(rev)))
            found += bool(ok.any())
    return runs, found


def dbcluster_groups(text: str) -> list[set]:
    """The clusters of ``-dbcluster`` output: a line "k:" and a line
    "  m: description" per member (with -nonredundant), or one line
    "k:  m1 m2 ..."."""
    groups = []
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        head, _, rest = line.partition(":")
        if not head.strip().isdigit():
            continue
        if line.startswith(" "):
            groups[-1].add(int(head))
        else:
            groups.append({int(x) for x in rest.split()})
    return groups


def protein_phase(dev, ctx: dict, nrec: int = PROTEIN_RECORDS,
                  nq: int = DNAVSPROT_QUERIES,
                  nq_edit: int = DNAVSPROT_EDIT_QUERIES,
                  dna: tuple = DNAVSPROT_DNA,
                  windows: int = DNAVSPROT_WINDOWS,
                  prefix_aa: int = PROTEIN_PREFIX) -> dict:
    """Phase 11: ``mkvtree -protein`` over a proteome-scale database P,
    ``vmatch -complete -dnavsprot 1`` (exact, ``-e 1``), ``-l 15
    -dnavsprot 1 -q`` and ``-l 40 -dbcluster 95 95 -nonredundant`` on it,
    each checked independently; then the card's stdout against the CPU's
    for the ``-dnavsprot`` runs on a prefix of P and for the host-only
    options on ``ctx``'s prefix index (the repeat text's).  Returns K1's
    and K2's launches in the ``-dnavsprot`` runs, their lookup paths and
    what the kernel comparisons need."""
    from vstree_tpu_torch.cli import mkvtree
    from vstree_tpu_torch.native.myers import verify_edit
    from vstree_tpu_torch.native.rankcount import rank_interval_lookup

    rng = np.random.default_rng(SEED + 11)
    t0 = start = time.perf_counter()
    prot = make_proteome(rng, nrec)
    recs = prot["recs"]
    db, index = WORK / "proteome.faa", WORK / "proteome"
    write_fasta(db, [f"p{i} synthetic protein" for i in range(nrec)],
                [r.tobytes() for r in recs])
    total = sum(r.size for r in recs)
    queries, origins = dnavsprot_queries(rng, recs, nq, (30, 54), False)
    eq, eorigins = dnavsprot_queries(rng, recs, nq_edit, (45, 90), True)
    drecs, planted = dnavsprot_dna(rng, recs, dna[0], dna[1], windows)
    files = {}
    for name, seqs in (("q", queries), ("qe", eq), ("dna", drecs)):
        files[name] = WORK / f"dnavsprot_{name}.fna"
        write_fasta(files[name], [f"{name}{i}" for i in range(len(seqs))],
                    seqs)
    log(f"phase 11 data: {nrec} proteins, {total} aa (median "
        f"{int(np.median([r.size for r in recs]))}), {len(prot['families'])}"
        f" paralog families, {len(prot['dups'])} exact duplicates; {nq} "
        f"DNA queries of 30-54 nt, {nq_edit} of 45-90 nt with a changed "
        f"codon, {dna[1]} bp in {dna[0]} records with {len(planted)} "
        f"windows ({time.perf_counter() - t0:.2f} s, not timed below)")
    t0 = time.perf_counter()
    with peak_memory(dev, "mkvtree -protein"):
        mkvtree.run(["-db", str(db), "-protein", "-pl", "-allout",
                     "-indexname", str(index)], dev)
    log(f"mkvtree -protein: {time.perf_counter() - t0:.3f} s wall")

    walls, paths = {}, {}
    verify_edit.launches = 0
    rank_interval_lookup.launches = 0
    launches = {}
    runs = (("complete", ["-complete", "-dnavsprot", "1", "-q",
                          str(files["q"])]),
            ("complete_e1", ["-complete", "-e", "1", "-dnavsprot", "1",
                             "-q", str(files["qe"])]),
            ("l15", ["-l", str(DNAVSPROT_LENGTH), "-dnavsprot", "1", "-q",
                     str(files["dna"])]))
    outs = {}
    for name, argv in runs:
        out = WORK / f"dnavsprot_{name}.out"
        k1, k2 = rank_interval_lookup.launches, verify_edit.launches
        with peak_memory(dev, f"vmatch {' '.join(argv[:-2])}"):
            walls[name], times = timed_vmatch(argv + [str(index)], dev, out)
        launches[name] = (rank_interval_lookup.launches - k1,
                          verify_edit.launches - k2)
        if argv[0] == "-complete":
            paths[name] = lookup_paths(times)
            log(f"  lookup path: {paths[name]}; K1 launches "
                f"{launches[name][0]}, K2 launches {launches[name][1]}")
        outs[name] = protein_rows(out.read_text())
        log(f"  rows: {outs[name].shape[0]}")
    n = check_complete_origins(outs["complete"], origins, 0)
    log(f"  -complete -dnavsprot: all {n} queries report their source "
        "window on their strand")
    n = check_complete_origins(outs["complete_e1"], eorigins, 1)
    checked = check_edit_rows(rng, recs, eq, outs["complete_e1"])
    log(f"  -complete -e 1 -dnavsprot: all {n} queries report their "
        f"origin; {checked} sampled rows agree with a NumPy DP on their "
        "own translation")
    runs_n, found = check_planted_runs(recs, planted, outs["l15"],
                                       DNAVSPROT_LENGTH)
    if found != runs_n or runs_n == 0:
        raise AssertionError(f"-l {DNAVSPROT_LENGTH} -dnavsprot found "
                             f"{found} of {runs_n} planted exact runs")
    log(f"  -l {DNAVSPROT_LENGTH} -dnavsprot: all {runs_n} planted exact "
        f"runs of >= {DNAVSPROT_LENGTH} aa found")

    # -l 40 -dbcluster 95 95 -nonredundant
    out, nr = WORK / "dbcluster.out", WORK / "nr.faa"
    with peak_memory(dev, "vmatch -l 40 -dbcluster"):
        walls["dbcluster"], _ = timed_vmatch(
            ["-l", "40", "-dbcluster", "95", "95", "-nonredundant", str(nr),
             str(index)], dev, out)
    groups = dbcluster_groups(out.read_text())
    where = {m: g for g in map(frozenset, groups) for m in g}
    # a record shorter than 40 aa holds no match of -l 40
    dups = [d for d in prot["dups"] if recs[d[0]].size >= 40]
    apart = [d for d in dups if where.get(d[0]) is None
             or d[1] not in where[d[0]]]
    if apart:
        raise AssertionError(f"{len(apart)} exact duplicates are not in "
                             f"the cluster of their original, e.g. {apart[0]}")
    kept = nr.read_bytes().count(b">")
    log(f"  -dbcluster: {len(groups)} clusters of "
        f"{sum(len(g) for g in groups)} records; each of the {len(dups)} "
        f"exact duplicates of >= 40 aa shares its original's cluster "
        f"({len(prot['dups']) - len(dups)} shorter); -nonredundant keeps "
        f"{kept} of {nrec} records")
    if not nrec - sum(len(g) - 1 for g in groups) == kept:
        raise AssertionError("-nonredundant does not keep one record per "
                             "cluster and every singlet")

    t0 = time.perf_counter()
    card_vs_cpu(dev, rng, recs, ctx, prefix_aa)
    log(f"phase 11 with its checks: {time.perf_counter() - start:.1f} s "
        f"(the card against the CPU {time.perf_counter() - t0:.1f} s)")
    if sum(k for _, k in launches.values()) == 0:
        raise AssertionError("the -dnavsprot runs never launched K2")
    return {"launches": launches, "paths": paths, "index": index,
            "queries": queries, "origins": origins, "recs": recs, "eq": eq,
            "rows_e1": outs["complete_e1"], "total": total}


def card_vs_cpu(dev, rng, recs, ctx: dict, prefix_aa: int) -> None:
    """The port's stdout on the card equals its stdout on the CPU: the
    ``-dnavsprot`` runs on an index of the first ``prefix_aa`` of P, the
    host-only options on ``ctx``'s prefix index."""
    import torch

    from vstree_tpu_torch.cli import mkvtree

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    keep = np.cumsum([r.size for r in recs]) <= prefix_aa
    prefix = [r for r, k in zip(recs, keep) if k]
    pdb, pidx = WORK / "proteome_prefix.faa", WORK / "proteome_prefix"
    write_fasta(pdb, [f"p{i}" for i in range(len(prefix))],
                [r.tobytes() for r in prefix])
    mkvtree.run(["-db", str(pdb), "-protein", "-pl", "-allout",
                 "-indexname", str(pidx)], dev)
    files = {}
    for name, (nq, nt, change) in (("q", (2000, (30, 54), False)),
                                   ("qe", (300, (45, 90), True))):
        qs, _ = dnavsprot_queries(rng, prefix, nq, nt, change)
        files[name] = WORK / f"prefix_{name}.fna"
        write_fasta(files[name], [f"{name}{i}" for i in range(nq)], qs)
    drecs, _ = dnavsprot_dna(rng, prefix, 50, 50_000, 100)
    files["dna"] = WORK / "prefix_dna.fna"
    write_fasta(files["dna"], [f"d{i}" for i in range(50)], drecs)
    # DNA queries of the repeat text's prefix
    text = ctx["recs"][0][:ctx["prefix_bp"]]
    dq = []
    for i in range(200):
        ln = int(rng.integers(24, 37))
        st = int(rng.integers(0, text.size - ln))
        dq.append(text[st:st + ln].tobytes())
    files["dq"] = WORK / "prefix_dq.fna"
    write_fasta(files["dq"], [f"x{i}" for i in range(len(dq))], dq)
    files["donline"] = WORK / "prefix_donline.fna"
    write_fasta(files["donline"], [f"y{i}" for i in range(16)], dq[:16])
    # chainqhits chains hits that a substitution splits
    cq = []
    for i in range(50):
        ln = int(rng.integers(150, 301))
        st = int(rng.integers(0, text.size - ln))
        w = text[st:st + ln].copy()
        at = rng.choice(ln, ln // 30, replace=False)
        w[at] = LETTERS[(np.searchsorted(LETTERS, w[at]) + 1) % 4]
        cq.append(w.tobytes())
    files["cq"] = WORK / "prefix_cq.fna"
    write_fasta(files["cq"], [f"c{i}" for i in range(len(cq))], cq)
    selfun, noop = WORK / "selfun.py", WORK / "noop.py"
    selfun.write_text(SELFUN_MODULE)
    noop.write_text("")   # no hooks: it carries the plugin's arguments
    plugin = ROOT / "vstree_tpu_torch" / "plugins" / "vmotif-demo.py"
    dindex = str(ctx["prefix_index"])
    cases = [
        (["-complete", "-dnavsprot", "1", "-q", str(files["q"])], str(pidx)),
        (["-complete", "-e", "1", "-dnavsprot", "1", "-q",
          str(files["qe"])], str(pidx)),
        (["-l", "15", "-dnavsprot", "1", "-q", str(files["dna"])],
         str(pidx)),
        (["-l", "20", "-best", "50", "-sort", "ia"], dindex),
        (["-l", "20", "-evalue", "1e-10", "-identity", "90"], dindex),
        (["-l", "30", "-e", "2", "-leastscore", "40"], dindex),
        (["-l", "20", "-s", "xml"], dindex),
        (["-l", "20", "-dbnomatch", "50"], dindex),
        (["-l", "20", "-qmaskmatch", "X", "-q", str(files["dq"])], dindex),
        (["-l", "20", "-pp", "chain", "global"], dindex),
        (["-l", "20", "-pp", "matchcluster", "overlap", "50", "outprefix",
          str(WORK / "mcl")], dindex),
        (["-complete", "remred", "-online", "-e", "1", "-q",
          str(files["donline"])], dindex),
        # a motif of 8 (the prefix index's prefix length is 7)
        (["-complete", str(plugin), "-selfun", str(noop), "RGATCYNN"],
         dindex),
        (["-l", "20", "-selfun", str(selfun), "30"], dindex),
    ]
    log(f"card against CPU: a {sum(r.size for r in prefix)} aa prefix of "
        f"P ({len(prefix)} records) and the {ctx['prefix_bp']} bp prefix "
        f"index ({time.perf_counter() - t0:.2f} s to make)")
    for argv, idx in cases:
        t0 = time.perf_counter()
        got = vmatch_text(argv + [idx], dev)
        t1 = time.perf_counter()
        want = vmatch_text(argv + [idx], cpu)
        t2 = time.perf_counter()
        if got != want:
            raise AssertionError(f"vmatch {' '.join(argv)}: the card's "
                                 "stdout differs from the CPU's")
        lines = got.count("\n")
        if lines < 2:
            raise AssertionError(f"vmatch {' '.join(argv)}: no output")
        log(f"  vmatch {' '.join(a if len(a) < 40 else Path(a).name for a in argv)}: "
            f"{lines} lines equal; card {t1 - t0:.3f} s, CPU {t2 - t1:.3f} s")
    for mode in ("nocheckleast", "checkqhit"):
        argv = ["12", "2", dindex, str(files["cq"]), mode]
        t0 = time.perf_counter()
        got = chainqhits_text(argv, dev)
        t1 = time.perf_counter()
        want = chainqhits_text(argv, cpu)
        t2 = time.perf_counter()
        if got != want or not got:
            raise AssertionError(f"chainqhits {mode}: the card's stdout "
                                 "differs from the CPU's")
        log(f"  chainqhits 12 2 {mode}: {got.count(chr(10))} lines equal; "
            f"card {t1 - t0:.3f} s, CPU {t2 - t1:.3f} s")


def translated_patterns(alpha, path: Path) -> list[np.ndarray]:
    """The six frames of every DNA query of ``path`` in ``alpha``, as
    ``vmatch -dnavsprot 1`` matches them."""
    from vstree_tpu_torch.core.alphabet import dna_alphabet
    from vstree_tpu_torch.core.codon import six_frame_translate
    from vstree_tpu_torch.core.multiseq import read_multiseq

    dna = read_multiseq([str(path)], dna_alphabet(), store_original=True)
    frames = six_frame_translate(dna, alpha, 1)
    return [frames.sequence[slice(*frames.seq_bounds(i))]
            for i in range(frames.numofsequences)]


def frame_matrix(alpha, path: Path):
    """The frames of :func:`translated_patterns` as K1's pattern matrix
    (-1 padded) and their lengths."""
    pats = translated_patterns(alpha, path)
    plens = np.array([p.size for p in pats], np.int32)
    mat = np.full((len(pats), plens.max()), -1, np.int32)
    for i, p in enumerate(pats):
        mat[i, :p.size] = p
    return mat, plens


def compare_k1_protein(dev, phase: dict) -> dict:
    """K1 against its plain version on the packed frames of the
    ``-complete -dnavsprot`` run.  Where the rank-lookup plan refuses P
    (the packed bucket table's guard, shift + bits of the widest bucket
    > 31), on an index of the same size with a uniform composition and
    as many queries of the same lengths, back-translated from it."""
    import torch

    from vstree_tpu_torch.cli import mkvtree
    from vstree_tpu_torch.engine.complete import RankLookupPlan
    from vstree_tpu_torch.index.esa import ESA
    from vstree_tpu_torch.native import rankcount

    esa = ESA.read(str(phase["index"]), dev)
    mat, plens = frame_matrix(esa.alpha, WORK / "dnavsprot_q.fna")
    plan = RankLookupPlan(esa, int(plens.min()), mat.shape[1])
    where = "P"
    if not plan.ok:
        maxw = esa.aux_bck_maxwidth(plan.ppl)
        log(f"K1 at sigma 20: the plan refuses P (ppl {plan.ppl}, coverage "
            f"{plan.coverage}, shift {plan.shift}, widest bucket {maxw}: "
            f"{plan.shift} + {max(1, maxw).bit_length()} bits > 31); "
            "comparing on a uniform-composition index of the same size")
        rng = np.random.default_rng(SEED + 12)
        total, nrec = phase["total"], 20
        recs = [AMINO[rng.integers(0, 20, total // nrec)]
                for _ in range(nrec)]
        db, index = WORK / "uniform.faa", WORK / "uniform"
        write_fasta(db, [f"u{i}" for i in range(nrec)],
                    [r.tobytes() for r in recs])
        mkvtree.run(["-db", str(db), "-protein", "-pl", "-allout",
                     "-indexname", str(index)], dev)
        qs, _ = dnavsprot_queries(rng, recs, len(phase["queries"]),
                                  (30, 54), False)
        qf = WORK / "uniform_q.fna"
        write_fasta(qf, [f"u{i}" for i in range(len(qs))], qs)
        esa = ESA.read(str(index), dev)
        mat, plens = frame_matrix(esa.alpha, qf)
        plan = RankLookupPlan(esa, int(plens.min()), mat.shape[1])
        where = "a uniform index"
        if not plan.ok:
            raise AssertionError(
                "the rank-lookup plan refuses the uniform protein index too "
                f"(widest bucket {esa.aux_bck_maxwidth(plan.ppl)})")
    flat8 = torch.from_numpy(plan.pack(mat, plens)).to(dev)
    args = [flat8, plan.bck, plan.suf, plan.text]
    scal = (esa.totallength, plan.ppl, plan.cpw, plan.sigma, plan.shift)
    lo, hi = rankcount.rank_interval_lookup(*args, *scal)
    rlo, rhi, rerr = rankcount.rank_interval_lookup_ref(*args, *scal)
    torch.cuda.synchronize()
    err = max(int((lo - rlo.cpu()).abs().max()),
              int((hi - rhi.cpu()).abs().max()), int(rerr))
    if err:
        raise AssertionError(f"K1 differs from its plain version by {err} "
                             "on the protein frames")
    if int((hi - lo).sum()) < len(phase["queries"]):
        raise AssertionError("K1 finds fewer hits than queries, each of "
                             "which has a frame in the text")
    B = lo.numel()
    out = torch.empty(2 * B + 1, dtype=torch.int32, device=dev)
    cold = time_flushed_ms(lambda: rankcount.launch(*args, out, *scal), 20)
    plain = time_ms(lambda: rankcount.rank_interval_lookup_ref(*args,
                                                               *scal), 3)
    need = k1_needed(args[0], args[1], rlo, rhi, *scal[1:])
    nbytes = (args[0].numel() + 4 * need["buckets"] + 5 * need["ranks"]
              + 8 * B + 4)
    bound = bound_ms(nbytes, args[0].numel() + need["ranks"])
    log(f"K1 rank_interval_lookup on the frames of the -dnavsprot queries "
        f"({where}): B={B} sigma={plan.sigma} ppl={plan.ppl} "
        f"cpw={plan.cpw} coverage={plan.coverage} hits={int((hi - lo).sum())}"
        f" max_abs_err=0 kernel_ms_l2_flushed(median)="
        f"{cold[len(cold) // 2]:.4f} plain_ms={plain:.4f} bound {bound}")
    return {"max_abs_err_dnavsprot": err, "k1_index_dnavsprot": where}


def compare_k2_protein(dev, phase: dict) -> dict:
    """K2 against its plain version at the shapes ``-complete -e 1
    -dnavsprot 1`` gave its measuring launch: every printed row is a
    detected start (its record and position on P, its frame of its DNA
    query), all the translated frames as patterns, L = the longest frame
    + 1.  ``bestlen`` and ``bestsc`` must be the printed length and
    distance."""
    import torch

    from vstree_tpu_torch.engine import approx
    from vstree_tpu_torch.index.esa import ESA
    from vstree_tpu_torch.native import myers

    esa = ESA.read(str(phase["index"]), dev)
    n, k = esa.totallength, 1
    pats = translated_patterns(esa.alpha, WORK / "dnavsprot_qe.fna")
    plens = np.array([p.size for p in pats], np.int32)
    rows = phase["rows_e1"]
    lens = np.array([len(q) for q in phase["eq"]], np.int64)
    l1, r1, p1, rev, l2, q, p2, dist = rows.T
    frame = np.where(rev == 1, 3 + (lens[q] - l2 - p2), p2 % 3)
    qidx = (6 * q + frame).astype(np.int32)
    starts = np.asarray(esa.multiseq.markpos, np.int64) + 1
    starts = np.concatenate([[0], starts])
    pos = (starts[r1] + p1).astype(np.int32)
    maxlen = int(plens.max())
    eqs = approx._eqs_matrix(pats, maxlen).view(np.int32)[:, 0, :]
    args = [esa.device("text")] + [
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (pos, qidx, eqs, plens)]
    L = maxlen + k
    got = myers.verify_edit(*args, L, n)
    want = myers.verify_edit_ref(*args, L, n)
    torch.cuda.synchronize()
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    if err:
        raise AssertionError(f"K2 differs from its plain version by {err} "
                             "at the shapes of -complete -e 1 -dnavsprot")
    measured = torch.stack(got[1:], 1).cpu().numpy()
    if not np.array_equal(measured, np.stack([l1, dist], 1)):
        raise AssertionError("K2's (bestlen, bestsc) on the detected starts "
                             "are not the printed -dnavsprot rows")
    P = pos.size
    out = torch.empty(3 * P + 1, dtype=torch.int32, device=dev)
    cold = time_flushed_ms(lambda: myers.launch(*args, out, L, n), 20)
    plain = time_ms(lambda: myers.verify_edit_ref(*args, L, n), 3)
    text = args[0]
    stops = torch.nonzero(text[:n] == 255)[:, 0]
    stops = torch.cat([stops, torch.tensor([n], device=stops.device)])
    c64 = args[1].to(torch.int64)
    cols = int((stops[torch.searchsorted(stops, c64)] - c64).clamp(
        max=L).sum())
    covered = int(torch.unique((c64[:, None] + torch.arange(
        L, device=c64.device)[None, :]).clamp(max=n - 1)).numel())
    # the Eq rows of the patterns some candidate verifies (most frames
    # have none), the candidates' text bytes, lengths and outputs
    used = int(np.unique(qidx).size)
    nbytes = 20 * P + used * 256 * 4 + plens.size * 4 + covered
    bound = bound_ms(nbytes, K2_OPS_PER_COLUMN * cols)
    log(f"K2 verify_edit at the shapes of -complete -e 1 -dnavsprot 1: "
        f"P={P} L={L} patterns={plens.size} max_abs_err=0 on minsc, "
        f"bestlen and bestsc; bestlen and bestsc equal the printed rows; "
        f"kernel_ms_l2_flushed(median)={cold[len(cold) // 2]:.4f} "
        f"plain_ms={plain:.4f} bound {bound}")
    return {"max_abs_err_dnavsprot": err}


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
    # the kernel's error word: a query number out of range must raise
    try:
        myers.verify_edit(edge[0], edge[1], edge[2] + 9, edge[3], edge[4],
                          eL, en)
    except ValueError:
        pass
    else:
        raise AssertionError("K2 accepted a query number out of range")
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
    out = torch.empty(3 * P + 1, dtype=torch.int32, device=cand.device)
    # alternate: plain, kernel, kernel, plain
    plain = [time_ms(lambda: myers.verify_edit_ref(*args, L, n), 3)]
    kern = [time_ms(lambda: myers.launch(*args, out, L, n), 50)
            for _ in range(2)]
    wrapper = time_ms(lambda: myers.verify_edit(*args, L, n), 50)
    # the checks the wrapper ran in front of the launch before the
    # kernel took them over: reductions over the inputs and a transfer
    check = time_ms(lambda: myers.value_errors(cand, qidx, plens), 50)
    plain.append(time_ms(lambda: myers.verify_edit_ref(*args, L, n), 3))
    cold = time_flushed_ms(lambda: myers.launch(*args, out, L, n), 20)
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
        f"(the value checks as torch reductions in front of it would add "
        f"{check:.4f}) plain_ms={plain} bound: {nbytes} bytes, {ops} int "
        f"ops -> {bound}")
    return {"max_abs_err": err, "ms": cold[len(cold) // 2],
            "repeated_ms": min(kern), "plain_ms": min(plain), **bound,
            "library_ms": None}


def compare_k2_online(esa, recs, queries: list[bytes], rows) -> dict:
    """K2 against its plain version at the shapes ``-complete -online
    -e`` gives it: the run's detected starts (every printed row is one)
    as candidates, all the run's queries, L = the longest query + k.
    All three outputs must be equal, and ``bestlen`` / ``bestsc`` must
    be the (length, distance) the run printed."""
    import torch

    from vstree_tpu_torch.engine import approx
    from vstree_tpu_torch.native import myers

    dev, n, k = esa.dev, esa.totallength, APPROX_K
    offsets = np.concatenate([[0], np.cumsum([len(r) + 1 for r in recs])])
    pats = encode(queries)
    plens = np.array([p.size for p in pats], np.int32)
    maxlen = int(plens.max())
    qidx = np.array([r[0] for r in rows], np.int32)
    pos = np.array([offsets[r[1]] + r[2] for r in rows], np.int32)
    eqs = approx._eqs_matrix(pats, maxlen).view(np.int32)[:, 0, :]
    args = [esa.device("text")] + [
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (pos, qidx, eqs, plens)]
    L = maxlen + k
    before = myers.verify_edit.launches
    got = myers.verify_edit(*args, L, n)
    if myers.verify_edit.launches != before + 1:
        raise AssertionError("verify_edit did not launch K2")
    want = myers.verify_edit_ref(*args, L, n)
    torch.cuda.synchronize()
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    if err != 0:
        raise AssertionError(f"K2 differs from its plain version by {err} "
                             f"at the shapes of -complete -online -e")
    printed = np.array([[r[3], r[4]] for r in rows], np.int32)
    measured = torch.stack(got[1:], 1).cpu().numpy()
    if not np.array_equal(measured, printed):
        raise AssertionError("K2's (bestlen, bestsc) on the detected starts "
                             "are not the rows -complete -online -e printed")
    log(f"K2 verify_edit at the shapes of -complete -online -e {k}: "
        f"P={pos.size} L={L} queries={plens.size} max_abs_err=0 on minsc, "
        f"bestlen and bestsc against the plain version; bestlen and bestsc "
        f"equal the printed rows; minsc <= {k} at "
        f"{int((got[0] <= k).sum())} of {pos.size} starts")
    return {"max_abs_err_online_e": err}


def segment_sweep(esa, queries: list[bytes], long_queries: list[bytes]):
    """``--segments``: the two online edit scans of this run's queries at
    other least segment lengths (``online._SEG_WARMUPS`` warm-ups), so
    that the constant's value rests on times from the card.  The hits
    must not depend on it."""
    import torch

    from vstree_tpu_torch.engine import online

    default = online._SEG_WARMUPS
    for name, qs, k in (("edit scan", queries, APPROX_K),
                        ("cutoff scan", long_queries, ONLINE_LONG_K)):
        pats = encode(qs)
        plens = np.array([p.size for p in pats], np.int32)
        first, times = None, {}
        for warmups in (default, 1, 2, 4, 8, 16, 32, 64, 128, default):
            online._SEG_WARMUPS = warmups
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hits = online._edit_hits(esa, pats, plens, k)
            torch.cuda.synchronize()
            times.setdefault(warmups, []).append(
                round(time.perf_counter() - t0, 4))
            order = np.lexsort(hits[::-1])
            hits = tuple(h[order] for h in hits)
            first = first or hits
            if not all(np.array_equal(a, b) for a, b in zip(first, hits)):
                raise AssertionError(f"{name}: the hits at segments of "
                                     f"{warmups} warm-ups differ")
        online._SEG_WARMUPS = default
        log(f"segment sweep, {name}, {len(qs)} queries at k={k}, "
            f"{first[0].size} hits, seconds by least segment length in "
            f"warm-ups (default {default}, run first and last): {times}")


# ---------------------------------------------------------------------------
# phase 12: the out-of-core build, the index tools, the match-file tools
# ---------------------------------------------------------------------------

OOC_RECORDS = 32              # 32 records of 2 Mbp: 64 Mbp
OOC_BP = 1 << 26              # 67,108,864 bp
OOC_SHARD_BP = 1 << 24        # symbols per shard of the out-of-core build
TOOLS_BUILD_RECORDS = 8       # mkrcidx / mkdna6idx on (a)'s first 16 Mbp
TOOLS_PREFIX = (4, 250_000)   # the index tools' 1 Mbp: 4 record prefixes
TEX_BP = 2_000                # vstree2tex's index
TOOLS_CPU_BP = 250_000        # the build tools, card against CPU
CFR_CHECKED = 2_000           # .cfr entries checked by direct comparison
MF_LENGTH = 20                # vmatch -l / repfind -l on text (b)'s prefix

_DNA_CODE = np.full(256, 255, np.uint8)
_DNA_CODE[np.frombuffer(b"acgt", np.uint8)] = np.arange(4, dtype=np.uint8)
_DNA_CODE[ord("n")] = 254


def encode_records(recs: list) -> np.ndarray:
    """The encoded text of DNA records joined by separators (255)."""
    out = []
    for i, r in enumerate(recs):
        if i:
            out.append(np.full(1, 255, np.uint8))
        out.append(_DNA_CODE[np.frombuffer(bytes(r), np.uint8)])
    return np.concatenate(out)


def translate_np(dna: bytes) -> np.ndarray:
    """:func:`translate` of a long acgt(n) text in bulk: amino-acid
    bytes, and whether each codon is free of n."""
    a = np.frombuffer(dna, np.uint8)
    count = a.size // 3
    idx = _DNA_CODE[a[:3 * count]].reshape(count, 3).astype(np.int64)
    ok = (idx < 4).all(axis=1)
    code = np.where(ok, idx[:, 0] * 16 + idx[:, 1] * 4 + idx[:, 2], 0)
    return _CODON64[code], ok


_CODON64 = np.array([_TRANSLATE[bytes([x, y, z])] for x in b"acgt"
                     for y in b"acgt" for z in b"acgt"], np.uint8)


def peak_mib(dev, fn):
    """(fn's result, the peak device memory in MiB while it ran; None
    on the CPU)."""
    import torch

    if dev.type != "cuda":
        return fn(), None
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    return out, torch.cuda.max_memory_allocated(dev) / 2**20


def ooc_phase(dev, recs: list, shard_bp: int = OOC_SHARD_BP) -> dict:
    """(a) ``build_suf_out_of_core`` on the records against the
    monolithic ``build_suf_lcp`` of the same text, with stage seconds
    and the peak device memory of each."""
    from vstree_tpu_torch.core.alphabet import dna_alphabet
    from vstree_tpu_torch.core.multiseq import Multiseq
    from vstree_tpu_torch.device import PhaseTimes, record_phases
    from vstree_tpu_torch.index.build import (
        build_suf_lcp,
        build_suf_out_of_core,
    )

    seq = encode_records(recs)
    ms = Multiseq(sequence=seq, totallength=int(seq.size),
                  markpos=np.flatnonzero(seq == 255).astype(np.int64),
                  numofsequences=len(recs))
    times = PhaseTimes(dev)
    t0 = time.perf_counter()
    with record_phases(times):
        (suf, lcp), ooc_peak = peak_mib(dev, lambda: build_suf_out_of_core(
            ms, dna_alphabet(), shard_bp, device=dev))
    ooc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (msuf, mlcp), mono_peak = peak_mib(dev, lambda: build_suf_lcp(
        seq, sigma=4, device=dev))
    mono_s = time.perf_counter() - t0
    sec = times.seconds
    stages = {
        "shard sorts": sum(sec.get(k, 0.0) for k in (
            "shard sorts", "initial sort", "doubling rounds")),
        "cross counts": sec.get("cross counts", 0.0),
        "special tail": sec.get("special tail", 0.0),
        "lcp pass": sec.get("lcp pass", 0.0)}
    log(f"phase 12 (a), out-of-core build of {seq.size} symbols in "
        f"{len(recs)} records: {times.counts.get('shards', 0)} shards of at "
        f"most {shard_bp} symbols, {ooc_s:.3f} s wall; monolithic "
        f"build_suf_lcp {mono_s:.3f} s")
    for name, s in stages.items():
        log(f"  {name:16s} {s:9.3f} s")
    log(f"  {'(other)':16s} {ooc_s - sum(stages.values()):9.3f} s")
    log(f"  peak device memory: out-of-core {ooc_peak} MiB, monolithic "
        f"{mono_peak} MiB")
    if not (np.array_equal(suf, msuf) and np.array_equal(lcp, mlcp)):
        bad = int(np.flatnonzero((suf != msuf) | (lcp != mlcp))[0])
        raise AssertionError(f"out-of-core tables differ from the "
                             f"monolithic build's from rank {bad}")
    if ooc_peak is not None and not ooc_peak < mono_peak:
        raise AssertionError(f"out-of-core peak {ooc_peak:.0f} MiB is not "
                             f"below the monolithic {mono_peak:.0f} MiB")
    spots = spot_check_tables(np.random.default_rng(SEED + 12),
                              seq.tobytes(), suf, lcp)
    log(f"  suftab and lcptab equal the monolithic build's; suffix order "
        f"and lcp agree with direct comparison at {spots} random ranks")
    return {"seconds": ooc_s, "mono_seconds": mono_s, "stages": stages,
            "shards": times.counts.get("shards", 0),
            "peak_mib": ooc_peak, "mono_peak_mib": mono_peak}


def tool_run(name: str, fn, dev=None):
    """Run one tool with its phases recorded; logs and returns its
    seconds and the PhaseTimes."""
    from vstree_tpu_torch.device import PhaseTimes, record_phases

    times = PhaseTimes(dev if dev is not None else "cpu")
    t0 = time.perf_counter()
    with record_phases(times):
        rc = fn()
    wall = time.perf_counter() - t0
    if rc not in (0, None):
        raise AssertionError(f"{name} returned {rc}")
    log(f"{name}: {wall:.3f} s wall")
    return wall, times


def captured(fn) -> str:
    """The stdout of ``fn(out)``."""
    import io

    buf = io.StringIO()
    if fn(buf) not in (0, None):
        raise AssertionError("a tool failed")
    return buf.getvalue()


def fasta_records(text: str) -> list:
    """(description, sequence) of every record of FASTA text."""
    out = []
    for chunk in text.split(">")[1:]:
        lines = chunk.splitlines()
        out.append((lines[0], "".join(lines[1:]).encode()))
    return out


def check_six_frames(recs: list, tis: np.ndarray, alpha) -> int:
    """The six-frame index text: per record the frames +0, +1, +2 and
    -0, -1, -2, separator-joined, each equal at its n-free codons to this
    script's table-1 translation of the record or its reverse
    complement.  Returns the codons compared."""
    frames = np.split(tis, np.flatnonzero(tis == 255))
    frames = [frames[0]] + [f[1:] for f in frames[1:]]
    if len(frames) != 6 * len(recs):
        raise AssertionError(f"{len(frames)} frames for {len(recs)} "
                             "records")
    compared = 0
    for i, r in enumerate(recs):
        rc = reverse_complement(r)
        for k, (src, off) in enumerate(((r, 0), (r, 1), (r, 2),
                                        (rc, 0), (rc, 1), (rc, 2))):
            letters, ok = translate_np(src[off:])
            got = frames[6 * i + k]
            if got.size != letters.size or not np.array_equal(
                    got[ok], alpha.transform(letters[ok])):
                raise AssertionError(f"record {i}, frame {k}: the index "
                                     "text is not the translation")
            compared += int(ok.sum())
    return compared


def build_tools_phase(dev, rng, recs: list) -> dict:
    """(b) ``mkrcidx`` and ``mkdna6idx`` on 16 Mbp through their ``run``:
    the index texts against this script's reverse complements and
    translations, suffix order and lcp at sampled ranks."""
    from vstree_tpu_torch.cli import mkdna6idx, mkrcidx
    from vstree_tpu_torch.core.alphabet import protein_alphabet

    sample = recs[0][:30_000].replace(b"n", b"a")
    if translate_np(sample)[0].tobytes() != translate(sample):
        raise AssertionError("translate_np disagrees with translate")
    db = WORK / "tools16.fna"
    write_fasta(db, [f"chr{i} tools" for i in range(len(recs))], recs)
    out = {}
    rc = WORK / "rc"
    with peak_memory(dev, "mkrcidx"):
        out["mkrcidx"], _ = tool_run(
            f"phase 12 (b), mkrcidx on {sum(map(len, recs))} bp",
            lambda: mkrcidx.run(["-db", str(db), "-indexname", str(rc)],
                                dev), dev)
    want = encode_records([x for r in recs
                           for x in (r, reverse_complement(r))])
    if not np.array_equal(np.fromfile(f"{rc}.rcm.tis", np.uint8), want):
        raise AssertionError("the .rcm text is not each record followed "
                             "by its reverse complement")
    spots = spot_check_index(rng, Path(f"{rc}.rcm"))
    log(f"  .rcm text ({want.size} symbols) equals this script's records "
        f"and reverse complements; order and lcp agree at {spots} ranks")
    six = WORK / "six"
    with peak_memory(dev, "mkdna6idx"):
        out["mkdna6idx"], _ = tool_run(
            f"phase 12 (b), mkdna6idx on {sum(map(len, recs))} bp",
            lambda: mkdna6idx.run(["-db", str(db), "-indexname", str(six)],
                                  dev), dev)
    tis6 = np.fromfile(f"{six}.6fr.tis", np.uint8)
    codons = check_six_frames(recs, tis6, protein_alphabet())
    spots = spot_check_index(rng, Path(f"{six}.6fr"))
    log(f"  .6fr text ({tis6.size} symbols) equals this script's "
        f"translation at {codons} n-free codons; order and lcp agree at "
        f"{spots} ranks")
    return out


def cfr_homes(lcp: np.ndarray) -> tuple:
    """Depth and left border of the last lcp-interval (depth > 0) that
    the reference's bottom-up walk completes with its home at each rank
    (home: the right border, or the left one when its lcp is at least
    the lcp behind the right border); depth 0 where none."""
    n = lcp.size - 1
    depth = np.zeros(n + 1, np.int64)
    left = np.zeros(n + 1, np.int64)
    stack = [(0, 0)]
    lv = lcp.tolist()
    for i in range(1, n + 2):
        v = lv[i] if i <= n else -1
        lb = i - 1
        while stack and v < stack[-1][0]:
            d, lo = stack.pop()
            hi = i - 1
            if d > 0:
                after = lv[hi + 1] if hi + 1 <= n else 0
                home = hi if lo == 0 or lv[lo] < after else lo
                depth[home], left[home] = d, lo
            lb = lo
        if i <= n and (not stack or v > stack[-1][0]):
            stack.append((v, lb))
    return depth, left


def check_cfr(rng, index: Path, n_checked: int) -> int:
    """Sampled ``.cfr`` entries: at the home rank of an interval of depth
    d, the first rank of the reverse index whose suffix starts with the
    reversed d-prefix (checked on both texts directly); 0 elsewhere."""
    t = np.fromfile(f"{index}.tis", np.uint8).tobytes()
    suf = np.fromfile(f"{index}.suf", "<u8").astype(np.int64)
    lcp = np.fromfile(f"{index}.lcp", np.uint8).astype(np.int64)
    llv = np.fromfile(f"{index}.llv", "<u8").reshape(-1, 2).astype(np.int64)
    lcp[llv[:, 0]] = llv[:, 1]
    rt = np.fromfile(f"{index}.rev.tis", np.uint8).tobytes()
    rsuf = np.fromfile(f"{index}.rev.suf", "<u8").astype(np.int64)
    cfr = np.fromfile(f"{index}.cfr", "<u8").astype(np.int64)
    depth, _ = cfr_homes(lcp)
    n = len(t)
    if cfr.size != n:
        raise AssertionError(f".cfr holds {cfr.size} entries for n = {n}")
    homes = np.flatnonzero(depth[:n] > 0)
    picked = rng.choice(homes, min(n_checked, homes.size), replace=False)
    for h in picked:
        d, p, v = int(depth[h]), int(suf[h]), int(cfr[h])
        pat = t[p:p + d][::-1]
        if rt[rsuf[v]:rsuf[v] + d] != pat or (
                v > 0 and rt[rsuf[v - 1]:rsuf[v - 1] + d] == pat):
            raise AssertionError(f".cfr[{h}] = {v} is not the first rank "
                                 f"of the reversed {d}-prefix")
    empty = np.flatnonzero(depth[:n] == 0)
    if (cfr[empty] != 0).any():
        raise AssertionError(".cfr has entries at ranks that home no "
                             "interval")
    return int(picked.size)


def index_tools_phase(dev, rng, recs: list) -> dict:
    """(c) The index tools on a 1 Mbp index of (a)'s record prefixes,
    built with ``-allout`` and with ``-rev``: ``mkcfr`` (its lookup path
    and K1's launches recorded), ``mkcld``, ``mkiso``, ``mklsf``,
    ``mksti``, ``mkvcmp``, ``vseqinfo``, ``vseqselect``,
    ``vsubseqselect``, ``vendian``, and ``vstree2tex`` on a 2 kbp
    index, each checked against this script's own bytes."""
    from vstree_tpu_torch.cli import (
        mkcfr, mkcld, mkiso, mklsf, mksti, mkvcmp, mkvtree, vendian,
        vseqinfo, vseqselect, vstree2tex, vsubseqselect)
    from vstree_tpu_torch.native.rankcount import rank_interval_lookup

    db, index = WORK / "tools1m.fna", WORK / "tools1m"
    names = [f"pre{i} prefix of chr{i}" for i in range(len(recs))]
    write_fasta(db, names, recs)
    for extra in ([], ["-rev"]):
        mkvtree.run(["-db", str(db), "-dna"] + extra + [
            "-pl", "-allout", "-indexname", str(index)], dev)
    n = sum(map(len, recs)) + len(recs) - 1
    secs = {}
    rank_interval_lookup.launches = 0
    secs["mkcfr"], times = tool_run("phase 12 (c), mkcfr",
                                    lambda: mkcfr.run([str(index)], dev),
                                    dev)
    launches = rank_interval_lookup.launches
    path = lookup_paths(times)
    checked = check_cfr(rng, index, CFR_CHECKED)
    log(f"  lookup path: {path}; K1 launches {launches}; {checked} .cfr "
        "entries checked by direct comparison")
    secs["mksti"], _ = tool_run("mksti", lambda: mksti.run([str(index)]))
    suf = np.fromfile(f"{index}.suf", "<u8").astype(np.int64)
    sti = np.fromfile(f"{index}.sti", "<u8").astype(np.int64)
    if not np.array_equal(sti[suf], np.arange(n + 1)):
        raise AssertionError(".sti is not the inverse of .suf")
    secs["mkcld"], _ = tool_run("mkcld", lambda: mkcld.run([str(index)]))
    cld = np.fromfile(f"{index}.cld", np.uint8).reshape(-1, 3)
    lcp = np.fromfile(f"{index}.lcp", np.uint8).astype(np.int64)
    llv = np.fromfile(f"{index}.llv", "<u8").reshape(-1, 2).astype(np.int64)
    lcp[llv[:, 0]] = llv[:, 1]
    nxt = cld[:, 2].astype(np.int64)
    for i in rng.choice(np.flatnonzero((nxt > 0) & (nxt < 255)), 2000):
        j = i + nxt[i]
        if lcp[j] != lcp[i] or (j > i + 1 and lcp[i + 1:j].min() <= lcp[i]):
            raise AssertionError(f".cld nextlIndex at {i} is wrong")
    secs["mkiso"], _ = tool_run("mkiso", lambda: mkiso.run([str(index)]))
    secs["mklsf"], _ = tool_run("mklsf", lambda: mklsf.run([str(index)]))
    for ext, size in (("cld", 3 * (n + 1)), ("cld1", n + 1), ("iso", n),
                      ("lsf", 2 * (n + 1))):
        got = Path(f"{index}.{ext}").stat().st_size
        if got != size:
            raise AssertionError(f".{ext} has {got} bytes, not {size}")
    text = captured(lambda o: mkvcmp.run([str(index), str(index)], o))
    if text != "# comparevirtualtrees: okay\n":
        raise AssertionError(f"mkvcmp: {text!r}")
    text = captured(lambda o: vseqinfo.run([str(index)], o))
    want = "".join(f"{i} {len(r)} {nm}\n"
                   for i, (r, nm) in enumerate(zip(recs, names)))
    if text != want:
        raise AssertionError(f"vseqinfo: {text[:200]!r}")
    nums = WORK / "nums.txt"
    nums.write_text("2\n0\n")
    got = fasta_records(captured(lambda o: vseqselect.run(
        ["-seqnum", str(nums), str(index)], o)))
    if sorted(got) != sorted([(names[2], recs[2]), (names[0], recs[0])]):
        raise AssertionError("vseqselect -seqnum: other records")
    got = fasta_records(captured(lambda o: vsubseqselect.run(
        ["-seq", "100", "1", "5000", str(index)], o)))
    if [s for _, s in got] != [recs[1][5000:5100]]:
        raise AssertionError("vsubseqselect -seq: another substring")
    start = len(recs[0]) + 1 + 9        # inside record 1
    got = fasta_records(captured(lambda o: vsubseqselect.run(
        ["-range", str(start), str(start + 40), str(index)], o)))
    if [s for _, s in got] != [recs[1][9:50]]:
        raise AssertionError("vsubseqselect -range: another substring")
    import io

    buf = io.BytesIO()
    vendian.run(["8", f"{index}.suf"], buf)
    if buf.getvalue() != suf.astype(">u8").tobytes():
        raise AssertionError("vendian 8 did not swap the .suf words")
    tdb, tindex = WORK / "tex.fna", WORK / "tex"
    write_fasta(tdb, ["tex"], [recs[0][:TEX_BP]])
    mkvtree.run(["-db", str(tdb), "-dna", "-pl", "1", "-allout",
                 "-indexname", str(tindex)], dev)
    text = captured(lambda o: vstree2tex.run(
        ["-tis", "-suf", "-lcp", "-s", str(tindex)], o))
    rows = [ln.split("&") for ln in text.splitlines()
            if ln[:1] == " " and ln.split("&")[0].strip().isdigit()]
    tsuf = np.fromfile(f"{tindex}.suf", "<u8").astype(np.int64)
    if [int(r[2]) for r in rows] != tsuf.tolist():
        raise AssertionError("vstree2tex: not one line per suffix")
    log(f"  mksti {secs['mksti']:.3f} s, mkcld {secs['mkcld']:.3f} s, "
        f"mkiso {secs['mkiso']:.3f} s, mklsf {secs['mklsf']:.3f} s at "
        f"n = {n}; mkvcmp, vseqinfo, vseqselect, vsubseqselect, vendian "
        f"and vstree2tex ({len(rows)} suffix lines) agree with this "
        "script's bytes")
    return {"seconds": secs, "launches": launches, "path": path,
            "index": index}


def body_rows(text: str) -> list:
    return [tuple(ln.split()) for ln in text.splitlines()
            if ln and not ln.startswith("#")]


def in_rows(rows: list, pool: list, what: str) -> None:
    """Every row of ``rows`` is one of ``pool`` (with multiplicity)."""
    from collections import Counter

    left = Counter(pool)
    left.subtract(Counter(rows))
    if min(left.values(), default=0) < 0:
        raise AssertionError(f"{what}: rows that the match file lacks")


def repfind_rows(dev, db: Path, where: Path) -> str:
    """``repfind -f -p -l 20`` on ``db`` run in ``where``; its stdout
    with the index path taken out of the header."""
    import contextlib
    import io
    import os

    from vstree_tpu_torch.cli import repfind

    where.mkdir(exist_ok=True)
    cwd = os.getcwd()
    buf = io.StringIO()
    os.chdir(where)
    try:
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            if repfind.run(["-f", "-p", "-l", str(MF_LENGTH), str(db)],
                           dev) != 0:
                raise AssertionError("repfind failed")
    finally:
        os.chdir(cwd)
    return buf.getvalue().replace(f"{where}/", "")


def matchfile_tools_phase(dev, ctx: dict) -> dict:
    """(d) ``vmatch -l 20`` on text (b)'s 1 Mbp prefix writes a match
    file; ``vmatchselect -sort ia``, ``chain2dim`` (global, local) and
    ``matchcluster`` read it, each count checked against the file's own
    rows; ``repfind -f -p -l 20`` (which asks for the 50 best) gives rows
    of ``vmatch -l 20 -d -p``, the 50 longest."""
    import os

    from vstree_tpu_torch.cli import chain2dim, matchcluster, vmatchselect

    index = str(ctx["prefix_index"])
    mfile = WORK / "prefix.match"
    secs = {}
    t0 = time.perf_counter()
    mfile.write_text(vmatch_text(["-l", str(MF_LENGTH), index], dev))
    secs["vmatch"] = time.perf_counter() - t0
    rows = body_rows(mfile.read_text())
    t0 = time.perf_counter()
    sel = body_rows(captured(lambda o: vmatchselect.run(
        ["-sort", "ia", str(mfile)], o)))
    secs["vmatchselect"] = time.perf_counter() - t0
    in_rows(sel, rows, "vmatchselect")
    pos = [(int(r[1]), int(r[2])) for r in sel]
    if not sel or pos != sorted(pos):
        raise AssertionError("vmatchselect -sort ia: not by position")
    chains = {}
    for mode in (["-global"], ["-local"]):
        t0 = time.perf_counter()
        text = captured(lambda o: chain2dim.run(mode + [str(mfile)], o))
        secs["chain2dim " + mode[0]] = time.perf_counter() - t0
        lines = text.splitlines()
        heads = [i for i, ln in enumerate(lines) if ln.startswith("# chain")]
        for k, i in enumerate(heads):
            end = heads[k + 1] if k + 1 < len(heads) else len(lines)
            body = [tuple(ln.split()) for ln in lines[i + 1:end]]
            if int(lines[i].split()[4]) != len(body):
                raise AssertionError(f"chain2dim {mode[0]}: {lines[i]!r} "
                                     f"heads {len(body)} rows")
            in_rows(body, rows, f"chain2dim {mode[0]}")
        if not heads or (mode == ["-global"] and len(heads) != 1):
            raise AssertionError(f"chain2dim {mode[0]}: {len(heads)} chains")
        chains[mode[0]] = len(heads)
    cdir = WORK / "mcl"
    cdir.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    captured(lambda o: matchcluster.run(
        ["-gapsize", "100", "-outprefix", str(cdir / "cl"), str(mfile)], o))
    secs["matchcluster"] = time.perf_counter() - t0
    clustered = 0
    for f in sorted(os.listdir(cdir)):
        size = int(f.split(".")[1])
        body = body_rows((cdir / f).read_text())
        if len(body) != size:
            raise AssertionError(f"matchcluster: {f} holds {len(body)} rows")
        in_rows(body, rows, "matchcluster")
        clustered += size
    if clustered == 0 or clustered > len(rows):
        raise AssertionError(f"matchcluster clustered {clustered} of "
                             f"{len(rows)} matches")
    t0 = time.perf_counter()
    rep = repfind_rows(dev, ctx["prefix_db"], WORK / "repfind_card")
    secs["repfind"] = time.perf_counter() - t0
    full = vmatch_text(["-l", str(MF_LENGTH), "-d", "-p", "-absolute",
                        index], dev)
    cols = [(r[0], r[1], r[2], r[3], r[4]) for r in body_rows(full)]
    got = [r[:5] for r in body_rows(rep)]
    in_rows(got, cols, "repfind")
    longest = sorted((int(r[0]) for r in cols), reverse=True)[:50]
    if sorted((int(r[0]) for r in got), reverse=True) != longest:
        raise AssertionError(f"repfind: {len(got)} rows, not the 50 "
                             f"longest of {len(cols)}")
    log(f"phase 12 (d), text (b)'s prefix: {len(rows)} matches of -l "
        f"{MF_LENGTH}; vmatchselect -sort ia {len(sel)} rows; chain2dim "
        f"{chains['-global']} global and {chains['-local']} local chains; "
        f"matchcluster {clustered} matches in "
        f"{len(os.listdir(cdir))} clusters; repfind {len(got)} rows of "
        f"vmatch -d -p's {len(cols)}; seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    return {"seconds": secs, "repfind": rep}


def tools_card_vs_cpu(dev, recs: list, ctx: dict, index: Path,
                      repfind_out: str) -> None:
    """The tools that reach the device give on the card what they give
    on the CPU: ``repfind``'s stdout, ``mkcfr``'s tables on the 1 Mbp
    index, ``mkrcidx``'s and ``mkdna6idx``'s index files on 250 kbp."""
    import torch

    from vstree_tpu_torch.cli import mkcfr, mkdna6idx, mkrcidx

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    if repfind_rows(cpu, ctx["prefix_db"], WORK / "repfind_cpu") != \
            repfind_out:
        raise AssertionError("repfind: the CPU's stdout differs")
    cdir = WORK / "cfr_cpu"
    cdir.mkdir(exist_ok=True)
    for f in WORK.glob(f"{index.name}.*"):
        if f.suffix not in (".cfr", ".crf"):
            shutil.copy(f, cdir / f.name)
    mkcfr.run([str(cdir / index.name)], cpu)
    for ext in ("cfr", "rev.crf"):
        if Path(f"{index}.{ext}").read_bytes() != \
                (cdir / f"{index.name}.{ext}").read_bytes():
            raise AssertionError(f"mkcfr: the CPU's .{ext} differs")
    db = WORK / "tools_small.fna"
    write_fasta(db, ["small"], [recs[0][:TOOLS_CPU_BP]])
    for tool, ext in ((mkrcidx, "rcm"), (mkdna6idx, "6fr")):
        names = []
        for d in (dev, cpu):
            name = WORK / f"small_{ext}_{d.type}"
            tool.run(["-db", str(db), "-indexname", str(name)], d)
            names.append(name)
        for part in ("tis", "suf", "lcp", "bwt"):
            a = Path(f"{names[0]}.{ext}.{part}").read_bytes()
            if a != Path(f"{names[1]}.{ext}.{part}").read_bytes():
                raise AssertionError(f"{tool.__name__}: the CPU's "
                                     f".{ext}.{part} differs")
    log(f"phase 12, card against CPU: repfind stdout, mkcfr .cfr/.rev.crf "
        f"of the prefix index, mkrcidx and mkdna6idx files ({TOOLS_CPU_BP} "
        f"bp) equal ({time.perf_counter() - t0:.1f} s)")


def tools_phase(dev, ctx: dict, ooc_bp: int = OOC_BP,
                ooc_records: int = OOC_RECORDS,
                shard_bp: int = OOC_SHARD_BP,
                build_records: int = TOOLS_BUILD_RECORDS,
                prefix: tuple = TOOLS_PREFIX) -> dict:
    """Phase 12: (a) the out-of-core build at 64 Mbp, (b) the index
    index builds on 16 Mbp of it, (c) the index tools on a 1 Mbp index, (d)
    the match-file tools and repfind on text (b)'s 1 Mbp prefix, then the
    device tools on the card against the CPU."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 12)
    recs = make_records(rng, ooc_bp, ooc_records)
    log(f"phase 12 data: {ooc_bp} bp in {ooc_records} records "
        f"({time.perf_counter() - t0:.2f} s, not timed below)")
    ooc = ooc_phase(dev, recs, shard_bp)
    builds = build_tools_phase(dev, rng, recs[:build_records])
    pre = [r[:prefix[1]] for r in recs[:prefix[0]]]
    del recs
    tools = index_tools_phase(dev, rng, pre)
    mf = matchfile_tools_phase(dev, ctx)
    tools_card_vs_cpu(dev, pre, ctx, tools["index"], mf["repfind"])
    log(f"phase 12 with its checks: {time.perf_counter() - t0:.1f} s")
    return {"ooc": ooc, "builds": builds, "launches": tools["launches"],
            "index": tools["index"],
            "path": tools["path"]}


# ---------------------------------------------------------------------------
# -numproc on one card: the multi-device layer (phase 13)
# ---------------------------------------------------------------------------

NUMPROC = 4                   # shards of (a)-(c): dp=2, sp=2, the card 4x
NUMPROC_WIDE = 8              # -complete -numproc 8: dp=2, sp=4
NUMPROC_RANKS = 2             # (d): gloo ranks that share the card
NUMPROC_PATTERNS = 2_000      # (d): lookup patterns of 20-30 from the text
NUMPROC_SUPERMAX = 12         # (d): -supermax length on the random 1 Mbp
# the index files that tests/test_parallel.py compares, and skp
NUMPROC_TABLES = ("suf", "lcp", "llv", "bwt", "bck", "tis", "sti1", "skp")


def rank_worker(address: str, world: str, rank: str, device: str,
                index: str, data: str, out: str) -> None:
    """One rank of phase 13 (d), in a process of its own: a gloo group
    with this rank's shard on ``device``, the sharded sort, supermax and
    lookup over the index; rank 0 saves the results, seconds and peak."""
    import torch
    import torch.distributed as dist

    from vstree_tpu_torch.index.esa import ESA
    from vstree_tpu_torch.parallel.distributed import (global_mesh,
                                                       init_multihost)
    from vstree_tpu_torch.parallel.shardesa import (
        exact_interval_lookup_sharded, suffix_sort_sharded,
        supermax_intervals_sharded)

    dev = torch.device(device)
    if not init_multihost(address, int(world), int(rank), device=dev,
                          backend="gloo"):
        raise AssertionError("no process group")
    mesh = global_mesh(dev)
    esa = ESA.read(index, dev)
    d = np.load(data)
    res, secs, peaks = {}, [], []
    for name, fn in (
            ("sort", lambda: suffix_sort_sharded(esa.multiseq.sequence,
                                                 mesh)),
            ("supermax", lambda: supermax_intervals_sharded(
                esa, NUMPROC_SUPERMAX, mesh)),
            ("lookup", lambda: exact_interval_lookup_sharded(
                esa, d["pats"], d["plens"], mesh))):
        dist.barrier()
        t0 = time.perf_counter()
        res[name], peak = peak_mib(dev, fn)
        secs.append(time.perf_counter() - t0)
        peaks.append(np.nan if peak is None else peak)
    if dist.get_rank() == 0:
        np.savez(out, suf=res["sort"][0], sti=res["sort"][1],
                 left=res["supermax"][0], right=res["supermax"][1],
                 depth=res["supermax"][2], lo=res["lookup"][0],
                 hi=res["lookup"][1], seconds=np.array(secs),
                 peak=max(peaks),
                 backend=dist.get_backend(),
                 shape=np.array(list(mesh.shape.values())))
    dist.destroy_process_group()


def numproc_ranks(dev, index: Path, world: int = NUMPROC_RANKS) -> None:
    """(d) ``world`` gloo ranks in processes of their own share the card
    over the 1 Mbp index; their sort, supermax intervals and lookup must
    equal the monolith's (the lookup's where a pattern occurs; an absent
    one is [0, 0) on a mesh)."""
    import socket

    from vstree_tpu_torch.engine.complete import exact_interval_lookup
    from vstree_tpu_torch.engine.supermax import supermax_intervals
    from vstree_tpu_torch.index.esa import ESA

    mono = ESA.read(str(index), "cpu")
    text = mono.multiseq.sequence
    rng = np.random.default_rng(SEED + 13)
    plens = rng.integers(20, 31, NUMPROC_PATTERNS).astype(np.int32)
    pats = np.full((NUMPROC_PATTERNS, 30), -1, np.int32)
    for i, ln in enumerate(plens):
        st = int(rng.integers(0, text.size - ln))
        pats[i, :ln] = text[st:st + ln]
    pats[::10, 5] = rng.integers(0, 4, len(pats[::10]))
    data, out = WORK / "ranks_in.npz", WORK / "ranks_out.npz"
    np.savez(data, pats=pats, plens=plens)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        address = f"tcp://127.0.0.1:{sk.getsockname()[1]}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys, chip_smoke; chip_smoke.rank_worker(*sys.argv[1:])",
         address, str(world), str(r), str(dev), str(index), str(data),
         str(out)],
        cwd=ROOT) for r in range(world)]
    try:
        for p in procs:
            if p.wait(timeout=300) != 0:
                raise AssertionError(f"a rank of (d) exited with "
                                     f"{p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    got = np.load(out)
    t1 = time.perf_counter()
    want = supermax_intervals(mono, NUMPROC_SUPERMAX)
    lo, hi = (np.asarray(x, np.int64) for x in
              exact_interval_lookup(mono, pats.copy(), plens.copy()))
    hit = hi > lo
    checks = {
        "sort": (np.array_equal(got["suf"], mono.suftab)
                 and np.array_equal(got["sti"][mono.suftab],
                                    np.arange(text.size + 1))),
        "supermax": all(np.array_equal(got[k], w) for k, w in
                        zip(("left", "right", "depth"), want)),
        "lookup": (np.array_equal(got["hi"] - got["lo"],
                                  np.where(hit, hi - lo, 0))
                   and np.array_equal(got["lo"][hit], lo[hit])),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad or not want[0].size or not hit.any():
        raise AssertionError(f"phase 13 (d): {bad} differ from the "
                             "monolith's (or found nothing)")
    secs = dict(zip(("sort", "supermax", "lookup"), got["seconds"]))
    log(f"phase 13 (d): {world} {got['backend']} ranks, mesh "
        f"{'x'.join(str(int(x)) for x in got['shape'])}, on one card "
        f"over {text.size} bp: "
        f"{wall:.1f} s wall with the processes' start; sort "
        f"{secs['sort']:.3f} s, supermax {secs['supermax']:.3f} s, lookup "
        f"of {NUMPROC_PATTERNS} {secs['lookup']:.3f} s (rank 0); "
        f"{peak_text(float(got['peak']))} (rank 0, the largest stage); "
        "suffix order, "
        f"{want[0].size} supermaximal intervals and {int(hit.sum())} "
        f"intervals equal the monolith's (checked in "
        f"{time.perf_counter() - t1:.1f} s)")


def index_differs(other: Path) -> list[str]:
    """The files of phase 3's index ``WORK/genome`` that the index
    ``other`` lacks (of ``NUMPROC_TABLES``) or holds with other bytes;
    the project file may differ in the index name it holds."""
    bad = [e for e in NUMPROC_TABLES
           if not other.with_name(f"{other.name}.{e}").exists()]
    for f in sorted(WORK.glob("genome.*")):
        twin = other.with_name(other.name + f.suffix)
        if f.suffix == ".fna" or not twin.exists():
            continue
        got = twin.read_bytes()
        if f.suffix == ".prj":
            got = got.replace(other.name.encode(), b"genome")
        if got != f.read_bytes():
            bad.append(f.suffix[1:])
    return bad


def peak_text(mib) -> str:
    return ("no device peak (CPU)" if mib is None or mib != mib
            else f"peak {mib:.0f} MiB")


def numproc_phase(dev, run: dict, repeats: dict, tools_index: Path) -> dict:
    """Phase 13: ``-numproc`` on one card, whose device list names it
    ``NUMPROC`` times.  (a) ``mkvtree -numproc 4`` over phase 3's text
    writes phase 3's index files; (b) ``vmatch -complete -q -numproc 4``
    and ``8`` print phase 3's rows and launch K1 0 times; (c) ``vmatch
    -supermax -l 20 -numproc 4`` prints phase 7's rows; (d) gloo ranks
    (:func:`numproc_ranks`); (e) ``main()`` refuses more shards than
    cards with the JAX CLI's message.  Returns K1's launches in (b)."""
    import torch

    from vstree_tpu_torch.cli import mkvtree, vmatch
    from vstree_tpu_torch.device import PhaseTimes, record_phases
    from vstree_tpu_torch.native.rankcount import rank_interval_lookup

    t_phase = time.perf_counter()
    devices = [dev] * NUMPROC_WIDE
    np_ = str(NUMPROC)
    # (a)
    index = WORK / "genome_np4"
    times = PhaseTimes(dev)
    t0 = time.perf_counter()
    with record_phases(times):
        _, peak = peak_mib(dev, lambda: mkvtree.run(
            ["-db", str(run["db"]), "-dna", "-pl", "-allout", "-numproc",
             np_, "-indexname", str(index)], dev, devices))
    wall = time.perf_counter() - t0
    phases = ", ".join(f"{k} {v:.3f}" for k, v in times.seconds.items())
    log(f"phase 13 (a): mkvtree -numproc {np_} over {TEXT_BP} bp: "
        f"{wall:.3f} s wall against {run['build_s']:.3f} s monolithic; "
        f"{peak_text(peak)}; {phases}")
    bad = index_differs(index)
    if bad:
        raise AssertionError(f"phase 13 (a): files {bad} missing or differ")
    log(f"  every table file equals phase 3's ({', '.join(NUMPROC_TABLES)} "
        "and the rest; the project file but for the index name it holds)")
    # (b)
    want = body_lines(WORK / "vmatch.out")
    rank_interval_lookup.launches = 0
    for n in (NUMPROC, NUMPROC_WIDE):
        out = WORK / f"np{n}.out"
        t0 = time.perf_counter()
        with record_phases(PhaseTimes(dev)) as times, open(out, "w") as fh:
            _, peak = peak_mib(dev, lambda: vmatch.run(
                ["-complete", "-q", str(run["qf"]), "-numproc", str(n),
                 str(run["index"])], dev, out=fh, devices=devices))
        wall = time.perf_counter() - t0
        if body_lines(out) != want:
            raise AssertionError(f"phase 13 (b): -complete -numproc {n} "
                                 "rows differ from phase 3's")
        log(f"phase 13 (b): vmatch -complete -q -numproc {n}: {wall:.3f} "
            f"s wall against {run['query_s']:.3f} s monolithic (sharded "
            f"lookup {times.seconds.get('sharded lookup', 0.0):.3f} s); "
            f"{peak_text(peak)}; {len(want)} rows equal phase 3's")
    launches = rank_interval_lookup.launches
    if launches:
        raise AssertionError(f"phase 13 (b): K1 launched {launches} times")
    log(f"  K1 launches under -complete -numproc: {launches}")
    # (c)
    out = WORK / "supermax_np4.out"
    t0 = time.perf_counter()
    with record_phases(PhaseTimes(dev)), open(out, "w") as fh:
        _, peak = peak_mib(dev, lambda: vmatch.run(
            ["-supermax", "-l", str(SELF_LENGTH), "-numproc", np_,
             str(repeats["index"])], dev, out=fh, devices=devices))
    wall = time.perf_counter() - t0
    want = body_lines(WORK / "supermax.out")
    if body_lines(out) != want or not want:
        raise AssertionError("phase 13 (c): -supermax -numproc rows "
                             "differ from phase 7's")
    log(f"phase 13 (c): vmatch -supermax -l {SELF_LENGTH} -numproc {np_}: "
        f"{wall:.3f} s wall against {repeats['supermax_s']:.3f} s "
        f"monolithic; {peak_text(peak)}; {len(want)} rows equal phase "
        "7's")
    # (d)
    numproc_ranks(dev, tools_index)
    # (e)
    cards = torch.cuda.device_count()
    for tool, argv in ((vmatch, ["-supermax", "-l", "20", "-numproc",
                                 str(cards + 1), str(tools_index)]),
                       (mkvtree, ["-db", f"{tools_index}.fna", "-dna",
                                  "-numproc", str(cards + 1),
                                  "-indexname", str(WORK / "refused")])):
        saved = sys.argv
        sys.argv = ["prog"] + argv
        try:
            tool.main()
        except SystemExit as e:
            said = str(e)
        else:
            said = "no refusal"
        finally:
            sys.argv = saved
        expect = (f"vmatch: -numproc {cards + 1} exceeds the {cards} "
                  "available devices")
        if said != expect:
            raise AssertionError(f"phase 13 (e): {tool.__name__} said "
                                 f"{said!r}, not {expect!r}")
    log(f"phase 13 (e): -numproc {cards + 1} refused by both CLIs' main() "
        f"with one card: {expect!r}")
    log(f"phase 13 with its checks: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


def numproc_inputs(dev) -> tuple:
    """What phase 13 reuses, made afresh for ``--numproc-only``: phase
    3's index and rows, phase 7's repeat index and ``-supermax`` rows,
    and a 1 Mbp index of four 250 kbp record prefixes (phase 12's)."""
    run = smoke(dev)
    rng = np.random.default_rng(SEED + 4)
    _, _, _, index, _ = repeat_index(
        rng, dev, TEXT_BP, REPEAT_FAMILIES, REPEAT_COPIES, TANDEM_ARRAYS,
        TWINS)
    wall, _ = timed_vmatch(["-supermax", "-l", str(SELF_LENGTH),
                            str(index)], dev, WORK / "supermax.out")
    recs = make_records(np.random.default_rng(SEED + 12),
                        TOOLS_PREFIX[0] * TOOLS_PREFIX[1], TOOLS_PREFIX[0])
    db, tools = WORK / "tools1m.fna", WORK / "tools1m"
    write_fasta(db, [f"pre{i}" for i in range(len(recs))], recs)
    mkvtree_run(dev, db, tools)
    return run, {"index": index, "supermax_s": wall}, tools


# ---------------------------------------------------------------------------
# the entry points in processes of their own (phase 14)
# ---------------------------------------------------------------------------

# the variables the entry point reads; a run gets only those it names
ENTRY_VARIABLES = ("QUERYSPEEDUP", "VMATCHSHOWTIMESPACE", "VSTREE_PROFILE",
                   "VSTREE_DEBUG_NANS")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
KERNEL_EVENTS = ("rankcount_kernel", "myers_kernel")   # K1, K2
# (f): the JAX CLI's messages (vstree_tpu/cli/vmatch.py main), as literals
FRONT_CHECKS = (
    ({"QUERYSPEEDUP": "x2"}, "vmatch: incorrect value of environment "
     "variable QUERYSPEEDUP; must be non-negative integer"),
    ({"QUERYSPEEDUP": "-1"}, "vmatch: illegal speedup value -1"),
    ({"VMATCHSHOWTIMESPACE": "1"}, "environment variable "
     'VMATCHSHOWTIMESPACE must set "on" or "off"'),
    ({"VSTREE_DEBUG_NANS": "yes"}, "environment variable "
     'VSTREE_DEBUG_NANS must set "on" or "off"'),
)
TIMING_LINES = (r"^# TIME vmatch \d+\.\d\d$", r"^# SPACE vmatch \d+\.\d\d$")


def entry_command(tool: str, argv: list[str], env: dict | None = None):
    """``python -m vstree_tpu_torch.cli.<tool> argv`` from the checkout
    root: (argument list, environment without the entry variables but
    ``env``)."""
    import os

    full = {k: v for k, v in os.environ.items() if k not in ENTRY_VARIABLES}
    full.update(env or {})
    return [sys.executable, "-m", f"vstree_tpu_torch.cli.{tool}", *argv], full


def entry_run(tool: str, argv: list[str], env: dict | None = None):
    """One entry-point process to its end: (CompletedProcess with bytes,
    wall seconds with the interpreter's start, the torch import, the
    CUDA context and loading the kernels from ``build/kernels/``)."""
    cmd, full = entry_command(tool, argv, env)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=full, capture_output=True,
                          timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(
            f"phase 14: {tool} {' '.join(argv)} exited with "
            f"{proc.returncode}: {proc.stderr.decode()[-2000:]}")
    return proc, wall


def trace_summary(trace_dir: Path) -> dict:
    """The one ``vmatch.*.pt.trace.json`` of a traced run: the kernel
    events of K1 and K2 (their µs each), the device busy share (the
    union of the kernel, memcpy and memset intervals over the window of
    all traced events) and the five device items of most summed time."""
    files = sorted(trace_dir.glob("vmatch.*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"phase 14: {len(files)} traces in {trace_dir}")
    events = [e for e in json.loads(files[0].read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    start = min(e["ts"] for e in events)
    window = max(e["ts"] + e["dur"] for e in events) - start
    busy, lo, hi = 0.0, None, None
    for e in sorted(device, key=lambda e: e["ts"]):
        a, b = e["ts"], e["ts"] + e["dur"]
        if hi is None or a > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += 0.0 if hi is None else hi - lo
    items: dict[str, list] = {}
    for e in device:
        item = items.setdefault(e["name"], [0.0, 0])
        item[0] += e["dur"]
        item[1] += 1
    return {
        "kernels": {k: [e["dur"] for e in device if e["cat"] == "kernel"
                        and k in e["name"]] for k in KERNEL_EVENTS},
        "busy_us": busy, "window_us": window, "share": busy / window,
        "events": len(device), "top": sorted(
            items.items(), key=lambda kv: -kv[1][0])[:5]}


def entry_phase(run: dict, approx: dict, repeats: dict) -> dict:
    """Phase 14: the main path through the entry points, each run a
    ``python -m`` process of its own from the checkout root.  (a)
    ``mkvtree`` writes phase 3's table files; (b) ``vmatch -complete -q``,
    (c) ``-complete -e 1 -q`` and (d) ``-l 20``, each traced with
    VSTREE_PROFILE, print phase 3's, 5's and 7's rows, and their traces
    hold K1 and K2 events as often as PERF.md's table says; (e) (b) with
    VMATCHSHOWTIMESPACE=on prints the two timing lines alone; (f) the
    front checks print the JAX CLI's messages.  Returns K1's and K2's
    events in the traces and their µs each."""
    import re

    t_phase = time.perf_counter()
    # (a)
    index = WORK / "genome_entry"
    _, wall = entry_run("mkvtree", ["-db", str(run["db"]), "-dna", "-pl",
                                    "-allout", "-indexname", str(index)])
    bad = index_differs(index)
    if bad:
        raise AssertionError(f"phase 14 (a): files {bad} missing or differ")
    log(f"phase 14 (a): python -m vstree_tpu_torch.cli.mkvtree over "
        f"{TEXT_BP} bp: {wall:.3f} s wall in its own process against "
        f"{run['build_s']:.3f} s in process; every table file equals "
        "phase 3's")
    # (b)-(d)
    complete = ["-complete", "-q", str(run["qf"]), str(run["index"])]
    result = {k: {} for k in KERNEL_EVENTS}
    for part, task, argv, want, inproc, events in (
            ("b", "-complete -q", complete, "vmatch.out", run["query_s"],
             (1, 0)),
            ("c", f"-complete -e {APPROX_K} -q",
             ["-complete", "-e", str(APPROX_K), "-q",
              str(WORK / "approx_q.fna"), str(run["index"])],
             "vmatch-e.out", approx["-e_s"], (2, 2)),
            ("d", f"-l {SELF_LENGTH}",
             ["-l", str(SELF_LENGTH), str(repeats["index"])], "l.out",
             repeats["l_s"], (0, 0))):
        trace = WORK / f"trace_{part}"
        proc, wall = entry_run("vmatch", argv,
                               {"VSTREE_PROFILE": str(trace)})
        if proc.stdout != (WORK / want).read_bytes():
            raise AssertionError(f"phase 14 ({part}): the rows differ from "
                                 f"the in-process run's {want}")
        summary = trace_summary(trace)
        durations = [summary["kernels"][k] for k in KERNEL_EVENTS]
        got = tuple(len(d) for d in durations)
        if got != events:
            raise AssertionError(f"phase 14 ({part}): K1, K2 events {got} "
                                 f"in the trace, not {events}")
        for k, d in zip(KERNEL_EVENTS, durations):
            result[k][task] = d
        us = [", ".join(f"{x:.1f}" for x in d) or "-" for d in durations]
        nlines = proc.stdout.count(b"\n")
        log(f"phase 14 ({part}): python -m vstree_tpu_torch.cli.vmatch "
            f"{task}: {wall:.3f} s wall in its own process, traced "
            f"(in process, untraced: {inproc:.3f} s); its "
            f"{nlines} lines equal {want}'s; trace: K1 "
            f"events {got[0]} ({us[0]} µs), K2 events {got[1]} ({us[1]} "
            f"µs); device busy {summary['busy_us'] / 1e3:.3f} ms of a "
            f"{summary['window_us'] / 1e6:.3f} s window "
            f"({100 * summary['share']:.3f} %, {summary['events']} device "
            "events)")
        for name, (total, n) in summary["top"]:
            log(f"    {total / 1e3:10.3f} ms  {n:6d}x  {name[:70]}")
    # (e)
    proc, wall = entry_run("vmatch", complete, {"VMATCHSHOWTIMESPACE": "on"})
    lines = proc.stdout.decode().splitlines()
    if len(lines) != 2 or not all(
            re.match(rx, line) for rx, line in zip(TIMING_LINES, lines)):
        raise AssertionError(f"phase 14 (e): the timing mode printed "
                             f"{lines[:4]}")
    log(f"phase 14 (e): VMATCHSHOWTIMESPACE=on vmatch -complete -q: "
        f"{wall:.3f} s wall in its own process, untraced; {lines}")
    # (f) the front checks: no card asked for, all four side by side
    t0 = time.perf_counter()
    procs = []
    try:
        for env, _ in FRONT_CHECKS:
            cmd, full = entry_command("vmatch", complete, env)
            procs.append(subprocess.Popen(
                cmd, cwd=ROOT, env=full, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        said = [p.communicate(timeout=120) + (p.returncode,) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (env, message), (out, err, rc) in zip(FRONT_CHECKS, said):
        if rc != 1 or out or err.strip() != message:
            raise AssertionError(f"phase 14 (f): {env} gave rc {rc}, "
                                 f"stdout {out[:200]!r}, stderr "
                                 f"{err[-500:]!r}, not {message!r}")
    log(f"phase 14 (f): {len(FRONT_CHECKS)} front checks print the JAX "
        f"CLI's messages, rc 1 ({time.perf_counter() - t0:.1f} s, side by "
        "side)")
    log(f"phase 14 with its checks: {time.perf_counter() - t_phase:.1f} s")
    return result


def entry_inputs(dev) -> tuple:
    """What phase 14 reuses, made afresh for ``--entry-only``: phase 3's
    index and rows, phase 5's ``-e 1`` queries and rows, phase 7's
    repeat index and ``-l 20`` rows."""
    run = smoke(dev)
    approx = approx_phase(np.random.default_rng(SEED + 1), run["recs"],
                          run["index"], dev, False)
    _, _, _, index, _ = repeat_index(
        np.random.default_rng(SEED + 4), dev, TEXT_BP, REPEAT_FAMILIES,
        REPEAT_COPIES, TANDEM_ARRAYS, TWINS)
    wall, _ = timed_vmatch(["-l", str(SELF_LENGTH), str(index)], dev,
                           WORK / "l.out")
    return run, approx, {"index": index, "l_s": wall}


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
    with peak_memory(dev, "mkvtree"), record_phases(build_times):
        mkvtree.run(["-db", str(db), "-dna", "-pl", "-allout",
                     "-indexname", str(index)], dev)
    build_s = time.perf_counter() - t0
    out = WORK / "vmatch.out"
    t0 = time.perf_counter()
    with peak_memory(dev, "vmatch -complete"), record_phases(query_times), \
            open(out, "w") as fh:
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
            "nrows": nrows, "recs": recs, "db": db, "qf": qf,
            "build_s": build_s, "query_s": query_s}


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

    profile = "--profile" in sys.argv[1:]
    if "--query-only" in sys.argv[1:]:
        run = smoke(dev)
        rng = np.random.default_rng(SEED + 4)
        recs, _, _, index, names = repeat_index(
            rng, dev, TEXT_BP, REPEAT_FAMILIES, REPEAT_COPIES, TANDEM_ARRAYS,
            TWINS)
        pdb, pindex = WORK / "prefix.fna", WORK / "prefix"
        write_fasta(pdb, names[:1], [recs[0][:PREFIX_BP].tobytes()])
        mkvtree_run(dev, pdb, pindex)
        query_phase(dev, run["recs"], run["index"], {
            "recs": recs, "index": index, "db": WORK / "repeats.fna",
            "prefix_index": pindex, "prefix_db": pdb,
            "prefix_bp": min(PREFIX_BP, recs[0].size)})
        shutil.rmtree(WORK, ignore_errors=True)
        log("the -q phase only: no kernels line, no result")
        return 0
    if "--protein-only" in sys.argv[1:]:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir(parents=True)
        rng = np.random.default_rng(SEED + 4)
        recs, _, _, index, names = repeat_index(
            rng, dev, TEXT_BP, REPEAT_FAMILIES, REPEAT_COPIES, TANDEM_ARRAYS,
            TWINS)
        pdb, pindex = WORK / "prefix.fna", WORK / "prefix"
        write_fasta(pdb, names[:1], [recs[0][:PREFIX_BP].tobytes()])
        mkvtree_run(dev, pdb, pindex)
        protein = protein_phase(dev, {
            "recs": recs, "prefix_index": pindex,
            "prefix_bp": min(PREFIX_BP, recs[0].size)})
        compare_k1_protein(dev, protein)
        compare_k2_protein(dev, protein)
        shutil.rmtree(WORK, ignore_errors=True)
        log("phase 11 only: no kernels line, no result")
        return 0
    if "--tools-only" in sys.argv[1:]:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir(parents=True)
        rng = np.random.default_rng(SEED + 4)
        recs, _, _, index, names = repeat_index(
            rng, dev, TEXT_BP, REPEAT_FAMILIES, REPEAT_COPIES, TANDEM_ARRAYS,
            TWINS)
        pdb, pindex = WORK / "prefix.fna", WORK / "prefix"
        write_fasta(pdb, names[:1], [recs[0][:PREFIX_BP].tobytes()])
        mkvtree_run(dev, pdb, pindex)
        tools_phase(dev, {"prefix_index": pindex, "prefix_db": pdb})
        shutil.rmtree(WORK, ignore_errors=True)
        log("phase 12 only: no kernels line, no result")
        return 0
    if "--numproc-only" in sys.argv[1:]:
        run, repeats, tools = numproc_inputs(dev)
        numproc_phase(dev, run, repeats, tools)
        shutil.rmtree(WORK, ignore_errors=True)
        log("phase 13 only: no kernels line, no result")
        return 0
    if "--entry-only" in sys.argv[1:]:
        entry_phase(*entry_inputs(dev))
        shutil.rmtree(WORK, ignore_errors=True)
        log("phase 14 only: no kernels line, no result")
        return 0
    if "--extend-only" in sys.argv[1:]:
        shutil.rmtree(WORK, ignore_errors=True)
        WORK.mkdir(parents=True)
        repeats = selfmatch_phase(dev, profile)
        extend_phase(dev, repeats, profile)
        if "--seedlengths" in sys.argv[1:]:
            seedlength_sweep(dev, repeats)
        shutil.rmtree(WORK, ignore_errors=True)
        log("the repeat text's phases only: no kernels line, no result")
        return 0

    run = smoke(dev)
    if run["launches"] == 0:
        raise AssertionError("the main path never launched K1")
    from vstree_tpu_torch.index.esa import ESA

    with peak_memory(dev, "vmatch -complete -e 1 and -h 1"):
        approx = approx_phase(np.random.default_rng(SEED + 1), run["recs"],
                              run["index"], dev, profile)
    if approx["launches"] == 0:
        raise AssertionError("the approximate path never launched K2")
    with peak_memory(dev, "vmatch -complete -online"):
        online = online_phase(np.random.default_rng(SEED + 6), run["recs"],
                              run["index"], dev)
    repeats = selfmatch_phase(dev, profile)
    extend_phase(dev, repeats, profile)
    if "--seedlengths" in sys.argv[1:]:
        seedlength_sweep(dev, repeats)
    mum_phase(dev)
    query_phase(dev, run["recs"], run["index"], repeats)
    protein = protein_phase(dev, repeats)
    tools = tools_phase(dev, repeats)
    numproc = numproc_phase(dev, run, repeats, tools["index"])
    entry = entry_phase(run, approx, repeats)
    esa = ESA.read(str(run["index"]), dev)
    k1 = compare_k1(esa, run["queries"], run["nrows"])
    k1.update(compare_k1_protein(dev, protein))
    k2 = compare_k2(esa, approx["queries"], approx["-e"])
    k2.update(compare_k2_online(esa, run["recs"], online["queries"],
                                online["rows"]))
    k2.update(compare_k2_protein(dev, protein))
    if "--segments" in sys.argv[1:]:
        segment_sweep(esa, online["queries"], online["long_queries"])
    shutil.rmtree(WORK, ignore_errors=True)
    kernels = [{
        "name": "rank_interval_lookup",
        "route": "cuda",
        "source": "vstree_tpu_torch/native/csrc/rankcount.cu",
        "replaces": "vstree_tpu/native/rankcount.py:95",
        "launches": run["launches"],
        "launches_dnavsprot": sum(
            k for k, _ in protein["launches"].values()),
        "lookup_path_dnavsprot": protein["paths"],
        "launches_mkcfr": tools["launches"],
        "lookup_path_mkcfr": tools["path"],
        "launches_numproc": numproc["launches"],
        "launches_entry": {task: len(d) for task, d in
                           entry["rankcount_kernel"].items()},
        "trace_us_entry": entry["rankcount_kernel"],
        **k1,
    }, {
        "name": "verify_edit",
        "route": "cuda",
        "source": "vstree_tpu_torch/native/csrc/myers.cu",
        "replaces": "vstree_tpu/native/myers.py:82",
        "launches": approx["launches"],
        "launches_online_e": online["launches"],
        "launches_dnavsprot": sum(
            k for _, k in protein["launches"].values()),
        "lookup_path_dnavsprot": protein["paths"],
        "launches_entry": {task: len(d) for task, d in
                           entry["myers_kernel"].items()},
        "trace_us_entry": entry["myers_kernel"],
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

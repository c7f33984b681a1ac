"""Esastream analog: sequential, bounded-memory consumption of a
persistent index.

The reference can run every bottom-up ESA algorithm without holding
any table in RAM by streaming suf/lcp/llv/bwt/tis from disk
(src/include/esastream.h:34-45, kurtz-basic/handleesastream.c:40, and
the ESASTREAMACCESS compile of the traversal template,
include/vdfstrav.c:4-6).  This module is the same capability for this
framework:

- :class:`ESAStream` opens a reference-format index and yields
  rank-order BLOCKS of (suf, lcp, bwt) with O(blocksize) memory —
  the 1-byte lcp file is merged with its >=255 exception pairs (llv)
  on the fly, mirroring the reference's DECLAREREADFUNCTION machinery
  (esastream.h:47-69);
- block-streamed consumers with an O(sigma) carry across block
  boundaries: lcp>=L run detection (the seed structure of every
  repeat engine) and supermaximal-repeat intervals (the streamed
  vmatfind-strm / fsuper.c analog), each verified block-size-
  independent and equal to the in-RAM engines
  (tests/test_stream.py).

Nothing below allocates more than a few blocks, so an index FAR
larger than device or host memory can be analyzed.
"""

from __future__ import annotations

import os

import numpy as np

_U64 = np.dtype("<u8")


class ESAStream:
    """Sequential block reader over suf/lcp(+llv)/bwt index files.

    Reads ranks [0, n] (sentinel included) in blocks of ``blocksize``
    ranks; lcp exceptions are consumed in step (the llv file is sorted
    by rank).  Memory: O(blocksize), independent of the index size.
    """

    def __init__(self, indexname: str, blocksize: int = 1 << 20,
                 tables=("suf", "lcp", "bwt")):
        self.indexname = indexname
        self.blocksize = int(blocksize)
        self._fsuf = (open(indexname + ".suf", "rb")
                      if "suf" in tables else None)
        self._flcp = (open(indexname + ".lcp", "rb")
                      if "lcp" in tables else None)
        self._fbwt = (open(indexname + ".bwt", "rb")
                      if "bwt" in tables
                      and os.path.exists(indexname + ".bwt") else None)
        self._fllv = (open(indexname + ".llv", "rb")
                      if self._flcp is not None
                      and os.path.exists(indexname + ".llv") else None)
        self._pending_llv = None
        self._rank = 0

    def close(self):
        for fh in (self._fsuf, self._flcp, self._fbwt, self._fllv):
            if fh is not None:
                fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _next_llv(self):
        if self._fllv is None:
            return None
        raw = self._fllv.read(16)
        if len(raw) < 16:
            return None
        pair = np.frombuffer(raw, _U64)
        return int(pair[0]), int(pair[1])

    def blocks(self):
        """Yield (rank0, suf, lcp, bwt) blocks in rank order; absent
        tables yield None."""
        if self._fllv is not None and self._pending_llv is None:
            self._pending_llv = self._next_llv()
        while True:
            suf = lcp = bwt = None
            m = 0
            if self._fsuf is not None:
                raw = self._fsuf.read(8 * self.blocksize)
                if raw:
                    suf = np.frombuffer(raw, _U64).astype(np.int64)
                    m = suf.size
            if self._flcp is not None:
                raw = self._flcp.read(self.blocksize)
                if raw:
                    lcp = np.frombuffer(raw, np.uint8).astype(np.int64)
                    m = max(m, lcp.size)
                    while self._pending_llv is not None and \
                            self._pending_llv[0] < self._rank + lcp.size:
                        r, v = self._pending_llv
                        lcp[r - self._rank] = v
                        self._pending_llv = self._next_llv()
            if self._fbwt is not None:
                raw = self._fbwt.read(self.blocksize)
                if raw:
                    bwt = np.frombuffer(raw, np.uint8)
                    m = max(m, bwt.size)
            if m == 0:
                return
            yield self._rank, suf, lcp, bwt
            self._rank += m


# ---------------------------------------------------------------------------
# streamed consumers
# ---------------------------------------------------------------------------


def stream_l_runs(stream: ESAStream, L: int):
    """Maximal runs of lcp >= L over the streamed lcp table; yields
    the same (left, right) rank intervals as engine.repeats._l_runs
    (run over lcp indices [s..e] covers ranks [s-1..e])."""
    in_run = False
    start = 0
    last = -1
    for rank0, _suf, lcp, _bwt in stream.blocks():
        if lcp is None:
            continue
        ge = lcp >= L
        flips = np.flatnonzero(ge[1:] != ge[:-1]) + 1
        bounds = np.concatenate([[0], flips, [lcp.size]])
        for bi in range(len(bounds) - 1):
            lo = int(bounds[bi])
            seg_ge = bool(ge[lo])
            if seg_ge and not in_run:
                in_run = True
                start = rank0 + lo
            elif not seg_ge and in_run:
                yield start - 1, rank0 + lo - 1
                in_run = False
        last = rank0 + lcp.size - 1
    if in_run:
        yield start - 1, last


class _SupermaxCarry:
    """O(sigma) state for the run crossing a block boundary."""

    __slots__ = ("pv", "cv", "cs", "seen", "dup", "prev_bwt")

    def __init__(self, sigma: int):
        self.pv = -1          # value of the run before the current one
        self.cv = None        # current (unfinished) run's lcp value
        self.cs = 0           # its first lcp index
        self.seen = np.zeros(sigma, bool)
        self.dup = False
        self.prev_bwt = None  # bwt char of the rank before the run


def _seen_update(carry: _SupermaxCarry, chars: np.ndarray, sigma: int):
    """Fold a segment's regular bwt chars into the carry's
    distinctness state."""
    reg = chars[chars < sigma]
    if reg.size:
        cnt = np.bincount(reg, minlength=sigma)
        if (cnt > 1).any() or (carry.seen & (cnt > 0)).any():
            carry.dup = True
        carry.seen |= cnt > 0


def stream_supermax_intervals(stream: ESAStream, searchlength: int,
                              sigma: int):
    """(left, right, depth) of supermaximal intervals from streamed
    lcp+bwt — identical to engine.supermax.supermax_intervals, in the
    same (right-boundary) order.

    A supermax interval is an equal-value lcp run [s..e] that is a
    strict local maximum with s > 0, value >= L, and pairwise-distinct
    regular bwt chars over ranks [s-1..e] (fsuper.c:61-165).  Runs
    fully inside a block are checked vectorized; at most one run per
    boundary carries an O(sigma) summary."""
    L = max(searchlength, 1)
    carry = _SupermaxCarry(sigma)
    out_pending = None   # closed candidate run awaiting its next value

    def close_current(next_val, end_idx):
        """Current carry run closed at lcp index end_idx (inclusive);
        returns an interval to emit or None."""
        res = None
        if (carry.cv is not None and carry.cv > carry.pv
                and carry.cv > next_val and carry.cs > 0
                and carry.cv >= L and not carry.dup):
            res = (carry.cs - 1, end_idx, carry.cv)
        carry.pv = carry.cv if carry.cv is not None else -1
        return res

    for rank0, _suf, lcp, bwt in stream.blocks():
        if lcp is None:
            return
        m = lcp.size
        if bwt is None:
            bwt = np.full(m, 255, np.uint8)
        flips = np.flatnonzero(lcp[1:] != lcp[:-1]) + 1
        bounds = np.concatenate([[0], flips, [m]]).astype(np.int64)
        nseg = len(bounds) - 1

        def start_run(lo):
            carry.cv = int(lcp[lo])
            carry.cs = rank0 + lo
            carry.seen[:] = False
            carry.dup = False
            pb = int(bwt[lo - 1]) if lo > 0 else carry.prev_bwt
            if carry.cs > 0 and pb is not None:
                _seen_update(carry, np.array([pb]), sigma)

        # first segment: continues or closes the carried run (scalar)
        lo, hi = 0, int(bounds[1])
        v = int(lcp[0])
        if carry.cv is None:
            start_run(0)
        elif v != carry.cv:
            res = close_current(v, rank0 - 1)
            if res is not None:
                yield res
            start_run(0)
        _seen_update(carry, bwt[lo:hi], sigma)

        if nseg >= 2:
            # interior segments (complete runs with both neighbors in
            # the block): vectorized node detection, distinctness only
            # for the few candidates
            starts = bounds[1:-1]
            ends = np.concatenate([bounds[2:-1], bounds[-1:]]) - 1
            vals = lcp[starts]
            prevv = np.empty(starts.size, np.int64)
            prevv[0] = carry.cv
            prevv[1:] = vals[:-1]
            nxt = np.empty(starts.size, np.int64)
            nxt[:-1] = vals[1:]
            nxt[-1] = -2  # last segment carries; placeholder unused
            interior = np.ones(starts.size, bool)
            interior[-1] = False  # last segment becomes the carry
            cand = interior & (vals > prevv) & (vals > nxt) \
                & (vals >= L) & ((rank0 + starts) > 0)
            # close the carried run against the second segment's value
            res = close_current(int(vals[0]), rank0 + int(starts[0]) - 1)
            if res is not None:
                yield res
            for si in np.flatnonzero(cand):
                s, e = int(starts[si]), int(ends[si])
                mem = bwt[max(s - 1, 0):e + 1]
                if s == 0 and carry.prev_bwt is not None:
                    mem = np.concatenate(
                        [[carry.prev_bwt], mem]).astype(np.uint8)
                reg = mem[mem < sigma]
                if reg.size == 0 or np.bincount(
                        reg, minlength=sigma).max() <= 1:
                    yield (rank0 + s - 1, rank0 + e, int(vals[si]))
            # maintain the prev-value chain for the carry
            if starts.size >= 2:
                carry.pv = int(vals[-2])
            # starts.size == 1: pv was set by close_current above
            # last segment becomes the new carried run
            start_run(int(starts[-1]))
            _seen_update(carry, bwt[int(starts[-1]):m], sigma)
        carry.prev_bwt = int(bwt[m - 1]) if m else carry.prev_bwt
    # end of stream: the final run has no successor; the in-RAM code
    # compares against next_val = -1
    res = close_current(-1, stream._rank - 1)
    if res is not None:
        yield res

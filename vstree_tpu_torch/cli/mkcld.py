"""mkcld: build the child table (.cld raw + .cld1 compressed).

Reference kurtz/mkcld.c + Mkvtree/mkcld.mn.c: the Abouelhoda child
table (up/down/nextlIndex, one byte each relative with
LARGECHILDVALUE saturation) built there with three stack sweeps over
the lcp table.  The stack recurrences reduce to closed forms over
next/previous-smaller-or-equal positions and first-minimum range
queries (derived from the pop cascades of mkcld.c:40-207):

  nextlIndex[i] = E - i       if lcp[E] == lcp[i], where E = first
                              j > i with lcp[j] <= lcp[i]
  down[i]       = q - i       if E > i + 1, where q = FIRST position
                              of min lcp over (i, E)  (equal-depth
                              stack chains pop bottom-up, so the
                              first occurrence is the last popped)
  up[i]         = i - q       if lcp[i-1] > lcp[i], where q = FIRST
                              position of min lcp over (p, i), p =
                              last j < i with lcp[j] <= lcp[i]

The .cld1 compression replays compresscldtab (mkcld.c:227-285)
byte-for-byte, including its byte-decoded comparisons.
"""

from __future__ import annotations

import sys

import numpy as np

from ..engine.repeats import LcpRmq
from ..index.io import read_index

LARGE = 255
UNDEF = 0


def _next_leq(lcp: np.ndarray) -> np.ndarray:
    """E[i] = first j > i with lcp[j] <= lcp[i]; n1 when none (cannot
    happen for i < n since lcp[n] == 0)."""
    n1 = lcp.size
    out = np.full(n1, n1, np.int64)
    stack: list[int] = []
    for i in range(n1):
        v = lcp[i]
        while stack and lcp[stack[-1]] >= v:
            out[stack.pop()] = i
        stack.append(i)
    return out


def _prev_leq(lcp: np.ndarray) -> np.ndarray:
    """p[i] = last j < i with lcp[j] <= lcp[i]; -1 when none."""
    n1 = lcp.size
    out = np.full(n1, -1, np.int64)
    stack: list[int] = []
    for i in range(n1):
        v = lcp[i]
        while stack and lcp[stack[-1]] > v:
            stack.pop()
        if stack:
            out[i] = stack[-1]
        stack.append(i)
    return out


def _first_min_pos(rmq: LcpRmq, lcp: np.ndarray, lo: np.ndarray,
                   hi: np.ndarray) -> np.ndarray:
    """Leftmost argmin of lcp over [lo, hi] (vectorized binary
    search on the range-minimum)."""
    m = rmq.query(lo, hi)
    a = lo.copy()
    b = hi.copy()
    while True:
        open_ = a < b
        if not open_.any():
            return a
        ia = np.flatnonzero(open_)
        mid = (a[ia] + b[ia]) // 2
        left_has = rmq.query(a[ia], mid) == m[ia]
        b[ia] = np.where(left_has, mid, b[ia])
        a[ia] = np.where(left_has, a[ia], mid + 1)


def build_cld(lcp: np.ndarray):
    """(up, down, nextl) byte arrays of length n+1."""
    n1 = int(lcp.size)
    n = n1 - 1
    lcp = lcp.astype(np.int64)
    up_b = np.zeros(n1, np.uint8)
    down_b = np.zeros(n1, np.uint8)
    nextl_b = np.zeros(n1, np.uint8)
    if n1 <= 1:
        return up_b, down_b, nextl_b
    rmq = LcpRmq(lcp.astype(np.int32))
    E = _next_leq(lcp)
    P = _prev_leq(lcp)

    idx = np.arange(n1, dtype=np.int64)
    has_e = E < n1
    eq = has_e & (lcp[np.minimum(E, n1 - 1)] == lcp)
    v = np.minimum(E - idx, LARGE)
    nextl_b[eq] = v[eq].astype(np.uint8)

    dn = has_e & (E > idx + 1)
    di = np.flatnonzero(dn)
    if di.size:
        q = _first_min_pos(rmq, lcp, di + 1, E[di] - 1)
        down_b[di] = np.minimum(q - di, LARGE).astype(np.uint8)

    upm = np.zeros(n1, bool)
    upm[1:] = lcp[:-1] > lcp[1:]
    ui = np.flatnonzero(upm)
    if ui.size:
        q = _first_min_pos(rmq, lcp, P[ui] + 1, ui - 1)
        up_b[ui] = np.minimum(ui - q, LARGE).astype(np.uint8)
    return up_b, down_b, nextl_b


def compress_cld(lcp: np.ndarray, up_b, down_b, nextl_b) -> np.ndarray:
    """compresscldtab (mkcld.c:227-285) replayed with its byte-decoded
    comparisons; unwritten entries stay zero (fresh allocation)."""
    n1 = int(lcp.size)
    n = n1 - 1
    cld1 = np.zeros(n1, np.uint8)
    i = np.arange(n, dtype=np.int64)            # loops go to n-1
    nextl_dec = i + nextl_b[:n]
    sel = nextl_dec > i
    cld1[:n][sel] = nextl_b[:n][sel]
    down_dec = i + down_b[:n]
    sel = ((nextl_dec == i) & (down_dec > i)) | (nextl_dec == n)
    cld1[:n][sel] = down_b[:n][sel]
    if n >= 2:
        j = np.arange(n - 1, dtype=np.int64)    # writes cld1[i], i+1 up
        lcp64 = lcp.astype(np.int64)
        cond = lcp64[j] > lcp64[j + 1]
        up_dec = (j + 1) - up_b[j + 1]
        dd = (j + 1) + down_b[j + 1]
        sel = cond & (up_dec != dd)
        cld1[:n - 1][sel] = up_b[1:n][sel]
    return cld1


def run(argv: list[str]) -> int:
    if len(argv) != 1:
        raise SystemExit("Usage: mkcld <indexname>")
    indexname = argv[0]
    esa = read_index(indexname, demand=("suf", "lcp"))
    up_b, down_b, nextl_b = build_cld(esa.lcptab)
    cld = np.empty((up_b.size, 3), np.uint8)
    cld[:, 0] = up_b
    cld[:, 1] = down_b
    cld[:, 2] = nextl_b
    cld.reshape(-1).tofile(indexname + ".cld")
    compress_cld(esa.lcptab, up_b, down_b, nextl_b).tofile(
        indexname + ".cld1")
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:]))
    except BrokenPipeError:
        sys.exit(0)


if __name__ == "__main__":
    main()

"""mkcfr: build the affix-array reverse tables (.cfr / .crf).

Reference Mkvtree/mkcfr.c: for every lcp-interval I of the forward
index, the REVERSED interval prefix is located in the reverse index
(mmsearchvstree) and the target's left border is stored at I's home
rank (gethome = the boundary with the deeper neighboring lcp); .crf
is the symmetric table on the reverse index.  These feed the affix
(bidirectional) search structure.

Interval prefixes are special-free (they are common prefixes of >= 2
suffixes, and specials never match), so ALL interval patterns batch
through the exact interval lookup (engine/complete.py) against the
other direction's ESA, on the device given to :func:`run` — one batched
search per table instead of per-interval binary searches.  Home
collisions overwrite in bottom-up completion order, exactly like the
reference's pop order.

A copy of :mod:`vstree_tpu.cli.mkcfr` but for the device: ``run`` reads
both indexes with device tables on the device it is given, ``main`` asks
for the CUDA card.
"""

from __future__ import annotations

import sys

import numpy as np

from ..device import cuda_device
from ..engine.complete import exact_interval_lookup
from ..index.esa import ESA
from .mkiso import _enum_intervals

_U64 = np.dtype("<u8")


def _home(lcp: np.ndarray, l: int, r: int) -> int:
    if l == 0:
        return r
    return l if lcp[l] >= lcp[r + 1] else r


def build_revtab(src, dst, seed=None) -> np.ndarray:
    """revtab over ``src``'s intervals, resolved against ``dst``.

    ``seed`` pre-fills the table: the reference reuses ONE buffer for
    both passes without clearing (mkcfr.c:418-434), so .crf entries
    its rev-tree intervals never write still carry the .cfr values —
    reproduced bug-for-bug."""
    n = int(src.suftab.size) - 1
    lcp = src.lcptab.astype(np.int64)
    revtab = seed.copy() if seed is not None else np.zeros(n, _U64)
    iv = [(d, l, r) for d, l, r in _enum_intervals(lcp) if d > 0]
    if not iv:
        return revtab
    text = src.text
    maxd = max(d for d, _, _ in iv)
    pats = np.full((len(iv), maxd), -1, np.int32)
    plens = np.empty(len(iv), np.int32)
    homes = np.empty(len(iv), np.int64)
    for k, (d, l, r) in enumerate(iv):
        s = int(src.suftab[l])
        pats[k, :d] = text[s:s + d][::-1].astype(np.int32)
        plens[k] = d
        homes[k] = _home(lcp, l, r)
    lo, hi = exact_interval_lookup(dst, pats, plens)
    if (hi <= lo).any():
        bad = int(np.flatnonzero(hi <= lo)[0])
        raise SystemExit(
            "mkcfr: string not found while constructing REVTAB "
            f"(interval {iv[bad]})")
    # completion-order overwrites (same as the reference's pop order)
    revtab[homes] = lo.astype(_U64)
    return revtab


def run(argv: list[str], device) -> int:
    if len(argv) != 1:
        raise SystemExit("Usage: mkcfr <indexname>")
    indexname = argv[0]
    fwd = ESA.read(indexname, device, demand=("suf", "lcp", "tis", "bck"))
    rev = ESA.read(indexname + ".rev", device,
                   demand=("suf", "lcp", "tis", "bck"))
    cfr = build_revtab(fwd, rev)
    cfr.tofile(indexname + ".cfr")
    build_revtab(rev, fwd, seed=cfr).tofile(indexname + ".rev.crf")
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:], cuda_device()))
    except BrokenPipeError:
        sys.exit(0)


if __name__ == "__main__":
    main()

"""Online (index-free) complete matching: vmatch -online -complete.
Port of :mod:`vstree_tpu.engine.online`, same names.

Reference algorithms, all O(n) scans over the raw text:
- exact: Boyer-Moore-Horspool with ISSPECIAL-aware compare
  (src/Vmengine/exactcompl.c:277-325, src/kurtz/bmhfun.c),
- Hamming: right-to-left sliding window mismatch count with byte
  equality and SEPARATOR window skipping
  (src/Vmengine/hamcompl.c:8-55),
- edit: right-to-left Ukkonen cutoff column DP emitting one match per
  start position via the longest-match rescan
  (src/Vmengine/edistcompl.c:82-172, approxcompl.c:13-65).

Design, in torch ops on the device of the text:
- exact/Hamming: a [B, n] mismatch-count matrix built in maxplen
  shift-compare-add steps (:func:`_window_mismatches`).
- edit, patterns of <= 64 chars: the semi-global multiword Myers
  bit-vector scan over the REVERSED text (free text start <=> per-end
  score in the reversed domain = per-START minimal distance in the
  original).  The JAX package runs it as one compiled loop of n steps;
  step by step in torch that would be n rounds of launches.  Here the
  reversed text is cut into segments that all advance in lockstep, each
  from the initial state ``m + k`` columns early
  (:func:`_semiglobal_myers`): a start whose score is <= k is reached by
  at most m + k text chars, so the decisions ``<= k`` are those of the
  one long scan (the scores above k need not be).
- edit, longer patterns: the reference's Ukkonen-cutoff scan, whose
  column is deliberately approximate, so no warm-up length is known to
  reproduce it.  :func:`_ukkonen_cutoff_scan_global` runs the segments
  speculatively from a warm-up and then checks every segment's state
  after its warm-up against its predecessor's state at the same text
  position; segments that disagree are run again from the right state
  until none is left, so the emissions are those of the sequential
  scan by construction.
- :func:`_ukkonen_cutoff_scan` is the same column update over the merged
  regions of ``-complete -e`` (``engine/approx.py::_region_detect``),
  each region a row of its own.

Surviving starts are measured with the longest-match verification of the
index path (``engine/approx.py``: kernel K2 for patterns of one word).
Match records and emission order mirror the reference: exact emits in
ascending text position (BMH scans left to right), Hamming and edit in
descending position (their scans run right to left).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.chardef import SEPARATOR, WILDCARD
from ..device import phase
from ..index.esa import ESA
from .match import FLAGCOMPLETEMATCH, FLAGQUERY, MatchTable

_I32 = torch.int32
_I64 = torch.int64
_MASK = 0xFFFFFFFF
_SCAN_ELEMS = 1 << 24    # elements of the state tensors of a lockstep scan
_WINDOW_ELEMS = 1 << 28  # elements of the [patterns, n] tensors of a chunk
# a segment is at least this many warm-ups long.  Every column of a
# lockstep scan costs about the same whatever the rows, so short
# segments are few columns of many rows, and the warm-up is their waste.
# On an H100 at 16 Mbp both scans stay within a quarter of their best
# time for values from 1 to 16 and double with every doubling beyond
# (``chip_smoke.py --segments``)
_SEG_WARMUPS = 8


# ---------------------------------------------------------------------------
# exact and Hamming: mismatch counts of every window
# ---------------------------------------------------------------------------


def _window_mismatches(text, patmat, plens, maxplen: int, n: int,
                       special_mm: bool):
    """[B, n] int32 mismatch counts of every pattern against every
    window start, plus [B, n] separator-in-window flags.

    special_mm=True applies the exact-match rule (ISSPECIAL text chars
    never match, exactcompl.c:308); False is raw byte equality
    (hamcompl.c:32).  ``text`` uint8 [>= n]; ``patmat`` int32
    [B, >= maxplen]; ``plens`` [B].  Past the text end reads as
    SEPARATOR."""
    dev = text.device
    B = patmat.shape[0]
    padded = torch.cat([text[:n].to(_I32), torch.full(
        (maxplen,), SEPARATOR, dtype=_I32, device=dev)])
    plens = plens.to(_I64)
    # two passes a step: the text's specials become a char that no
    # pattern holds, and the steps past a pattern's end, where its
    # padding differs from every char, are taken off at the end
    chars = torch.where(padded >= WILDCARD, -1, padded) if special_mm \
        else padded
    pats = torch.where(
        torch.arange(maxplen, device=dev)[None, :] < plens[:, None],
        patmat[:, :maxplen], -2)
    mm = torch.zeros((B, n), dtype=_I32, device=dev)
    for o in range(maxplen):
        mm += chars[None, o:o + n] != pats[:, o, None]
    mm -= (maxplen - plens).to(_I32)[:, None]
    # a SEPARATOR lies in the window iff the next one at or after the
    # start is closer than the pattern is long
    pos = torch.arange(n + maxplen, dtype=_I64, device=dev)
    at = torch.where(padded == SEPARATOR, pos, n + maxplen)
    nextsep = torch.flip(torch.cummin(torch.flip(at, [0]), 0).values, [0])
    sep = (nextsep[:n] - pos[:n])[None, :] < plens[:, None]
    return mm, sep


# ---------------------------------------------------------------------------
# segments of the reversed text
# ---------------------------------------------------------------------------


def _segment_length(n: int, rows: int, width: int, warm: int) -> int:
    """Columns per segment when ``rows`` patterns of state ``width``
    scan n columns: long enough that the lockstep state stays within
    ``_SCAN_ELEMS`` elements and the warm-up is a small share."""
    by_state = -(-n * rows * width // _SCAN_ELEMS)
    return max(1, min(n, max(_SEG_WARMUPS * warm, by_state)))


def _segment_windows(text_rev, n: int, seg: int, warm: int):
    """int64 [G, warm + seg] view of the reversed text: row g holds
    columns ``g*seg - warm .. (g+1)*seg - 1``, SEPARATOR outside the
    text (a SEPARATOR column leaves the initial state behind)."""
    G = -(-n // seg)
    pad = torch.full((warm,), SEPARATOR, dtype=_I64, device=text_rev.device)
    tail = torch.full((G * seg - n,), SEPARATOR, dtype=_I64,
                      device=text_rev.device)
    padded = torch.cat([pad, text_rev[:n].to(_I64), tail])
    return padded.unfold(0, warm + seg, seg)


# ---------------------------------------------------------------------------
# edit, patterns <= 64: semi-global Myers
# ---------------------------------------------------------------------------


def _semiglobal_myers(text_rev, eqs_rev, plens, w: int, n: int, k: int):
    """bool [B, n]: ``hit[b, j]`` iff the reference's online Myers scan
    (edistmyersbitvectorAPM4/8, edistcompl.c:261-385) has a score <= k
    for pattern b at column j of the reversed text: reversed pattern
    masks over the right-to-left text scan, free text start (Ph << 1
    without carry), SEPARATOR column reset.  For patterns <= 64 chars
    (``w`` = 1 or 2 words).

    ``text_rev`` uint8 [n]; ``eqs_rev`` [B, w, 256] Eq masks of the
    reversed patterns, any integer dtype (the low 32 bits count);
    ``plens`` [B].  Words are held in int64 masked to 32 bits, so the
    carry of the unsigned add is bit 32 and every ``>>`` is the logical
    one."""
    dev = text_rev.device
    B = plens.numel()
    plen = plens.to(_I64)[:, None]
    warm = min(n, int(plens.max()) + k)
    seg = _segment_length(n, B, 3 * w, warm)
    win = _segment_windows(text_rev, n, seg, warm)
    G = win.shape[0]
    eqs = eqs_rev.to(_I64) & _MASK
    top_word = (plen - 1) // 32
    top_shift = (plen - 1) % 32
    Pv = [torch.full((B, G), _MASK, dtype=_I64, device=dev)
          for _ in range(w)]
    Mv = [torch.zeros((B, G), dtype=_I64, device=dev) for _ in range(w)]
    score = plen.expand(B, G)
    hits = torch.empty((seg, B, G), dtype=torch.bool, device=dev)
    for c in range(warm + seg):
        ch = win[:, c]
        is_sep = (ch == SEPARATOR)[None, :]
        Eq = [eqs[:, j, :][:, ch] for j in range(w)]
        carry = 0
        Xh = []
        for j in range(w):
            s = (Eq[j] & Pv[j]) + Pv[j] + carry
            carry = s >> 32
            Xh.append(((s & _MASK) ^ Pv[j]) | Eq[j])
        Xv = [Eq[j] | Mv[j] for j in range(w)]
        Ph = [Mv[j] | (~(Xh[j] | Pv[j]) & _MASK) for j in range(w)]
        Mh = [Pv[j] & Xh[j] for j in range(w)]
        ph_top, mh_top = Ph[0], Mh[0]
        for j in range(1, w):
            sel = top_word == j
            ph_top = torch.where(sel, Ph[j], ph_top)
            mh_top = torch.where(sel, Mh[j], mh_top)
        nsc = (score + ((ph_top >> top_shift) & 1)
               - ((mh_top >> top_shift) & 1))
        ph_c, mh_c = 0, 0            # free text start: no carry-in
        for j in range(w):
            Ph_s = ((Ph[j] << 1) | ph_c) & _MASK
            Mh_s = ((Mh[j] << 1) | mh_c) & _MASK
            ph_c, mh_c = Ph[j] >> 31, Mh[j] >> 31
            Pv[j] = torch.where(is_sep, _MASK,
                                Mh_s | (~(Xv[j] | Ph_s) & _MASK))
            Mv[j] = torch.where(is_sep, 0, Ph_s & Xv[j])
        score = torch.where(is_sep, plen, nsc)
        if c >= warm:
            hits[c - warm] = (nsc <= k) & ~is_sep
    return hits.permute(1, 2, 0).reshape(B, G * seg)[:, :n]


# ---------------------------------------------------------------------------
# edit, long patterns and regions: the Ukkonen-cutoff column
# ---------------------------------------------------------------------------


def _cutoff_step(patrev, plen, idx, M: int, k: int, dcol, end, ch):
    """One column of the reference's Ukkonen-cutoff scan for every row:
    state ``(dcol [R, M+2], end [R])`` and the chars ``ch`` [R] give the
    next state and whether the full column is <= k (before the
    SEPARATOR and region masks).

    The reference maintains a column dcol[0..end) of cells <= threshold
    and EXTENDS the column by writing the literal value ``threshold``
    into the next cell (edistcompl.c:144-149), an upper-bound shortcut
    that makes the scan slightly approximate; it is replicated for
    output parity.  The sequential in-column min-chain
    new[i] = min(old[i]+1, old[i-1]+delta, new[i-1]+1) is vectorized
    with the prefix-min identity new[i] = min_{j<=i}(t[j]-j)+i."""
    is_sep = ch == SEPARATOR
    delta = (patrev != ch[:, None]).to(_I32)
    old = dcol
    diag = torch.cat([torch.zeros_like(old[:, :1]), old[:, :-1]], 1)
    t = torch.minimum(old + 1, diag + delta)
    t[:, 0] = 0  # t is a fresh tensor
    new = torch.cummin(t - idx, dim=1).values + idx
    upd = (idx >= 1) & (idx <= end[:, None] - 1)
    dcol2 = torch.where(upd, new, old)
    # extension (edistcompl.c:144-149): pattern char for cell ``end``
    # matches, or the last cell is strictly < threshold
    endm1 = dcol2.gather(1, (end - 1).clamp(min=0)[:, None].to(_I64))[:, 0]
    ext_ch = patrev.gather(1, end.clamp(max=M + 1)[:, None].to(_I64))[:, 0]
    can_ext = (end <= plen) & ((ext_ch == ch) | (k > endm1))
    dcol3 = torch.where(can_ext[:, None] & (idx == end[:, None]), k, dcol2)
    # trim (edistcompl.c:151-155): last cell <= threshold
    ok = (dcol3 <= k) & (idx <= end[:, None] - 1)
    last = torch.where(ok, idx, -1).max(dim=1).values
    nend = torch.where(can_ext, end + 1, last + 1)
    full = nend == plen + 1
    # SEPARATOR: reset column (edistcompl.c:105-113)
    end = torch.where(is_sep, k + 1, nend)
    dcol = torch.where(is_sep[:, None], idx, dcol3)
    return dcol, end, full & ~is_sep


def _cutoff_warmup(M: int, k: int) -> int:
    """Columns a segment of the global cutoff scan starts early.  A
    guess that only costs time when it is wrong: the state check of
    :func:`_ukkonen_cutoff_scan_global` makes any value exact."""
    return M + k


def _ukkonen_cutoff_scan_global(text_rev, patrev, plens, M: int, k: int,
                                n: int):
    """bool [B, n] emission flags of the reference's right-to-left
    Ukkonen-cutoff detection scan (edistcompl.c:82-172) over the whole
    reversed text, one global scan per pattern (the ``-online``
    behaviour): True where the full column is <= k at this start.

    ``text_rev`` uint8 [n]; ``patrev`` int32 [B, M+2] reversed patterns
    at columns 1..plen, padded with a value no text char equals;
    ``plens`` int32 [B].

    Every (pattern, segment) is a row, and all rows advance in lockstep
    from the initial state :func:`_cutoff_warmup` columns before their
    segment.  The scan's column is approximate, so the state
    after a warm-up need not be the sequential scan's: every row's state
    at its segment's start is therefore compared with its predecessor's
    state at its end (the cells below ``end``, and ``end``), and the
    rows that differ are run again from that state, until none differs.
    Segment 0 starts from the true initial state, so by induction every
    row then replays the sequential scan."""
    dev = text_rev.device
    B = plens.numel()
    warm = min(n, _cutoff_warmup(M, k))
    seg = _segment_length(n, B, M + 2, warm)
    win = _segment_windows(text_rev, n, seg, warm)
    G = win.shape[0]
    idx = torch.arange(M + 2, dtype=_I32, device=dev)[None, :]
    plen = plens.to(_I32)

    def run(rows, dcol, end, c0):
        """Rows ``rows`` (b * G + g) from state (dcol, end) at column
        ``c0`` of their window to its end: the state at the segment's
        start, the final state, and [seg, rows] emissions."""
        b = torch.div(rows, G, rounding_mode="floor")
        g = rows - b * G
        pr, pl = patrev[b], plen[b]
        emits = torch.empty((seg, rows.numel()), dtype=torch.bool,
                            device=dev)
        start = (dcol, end)
        for c in range(c0, warm + seg):
            if c == warm:
                start = (dcol, end)
            dcol, end, emit = _cutoff_step(pr, pl, idx, M, k, dcol, end,
                                           win[g, c].to(_I32))
            if c >= warm:
                emits[c - warm] = emit
        return start, (dcol, end), emits

    def same(a, b):
        """Equal scan states: equal ``end`` and equal cells below it."""
        return (a[1] == b[1]) & ((a[0] == b[0])
                                 | (idx >= a[1][:, None])).all(1)

    R = B * G
    rows = torch.arange(R, dtype=_I64, device=dev)
    (sd, se), (fd, fe), emits = run(
        rows, idx.expand(R, M + 2).contiguous(),
        torch.full((R,), k + 1, dtype=_I32, device=dev), 0)
    # row r follows row r - 1 unless it is a pattern's first segment
    follows = rows[(rows % G) != 0]
    while follows.numel():
        bad = follows[~same((sd[follows], se[follows]),
                            (fd[follows - 1], fe[follows - 1]))]
        if bad.numel() == 0:
            break
        sd[bad], se[bad] = fd[bad - 1], fe[bad - 1]
        _, (nd, ne), nemits = run(bad, sd[bad], se[bad], warm)
        fd[bad], fe[bad], emits[:, bad] = nd, ne, nemits
        # only the successors of the rows run again can differ now
        nxt = bad + 1
        follows = nxt[(nxt % G != 0) & (nxt < R)]
    return emits.reshape(seg, B, G).permute(1, 2, 0).reshape(
        B, G * seg)[:, :n]


def _ukkonen_cutoff_scan(text, patrev, plens, M: int, k: int,
                         reg_q, reg_a, reg_b):
    """Replay of the reference's right-to-left Ukkonen-cutoff detection
    scan (splitesaapm.c:43-122 ``verifyedistlongmatch``) over the
    regions ``[reg_a[r], reg_b[r]]`` of the text, each scanned from its
    right end with pattern ``reg_q[r]`` (the column update:
    :func:`_cutoff_step`).

    The JAX function scans all n text positions with dense reset /
    in-region masks; its state is reset at every region's right end and
    emissions outside regions are masked, so the regions of one query
    are independent.  Here every region is a row of its own: its
    reversed text window is gathered into a ``[R, maxwidth]`` tensor and
    all regions advance in lockstep for ``maxwidth`` columns.  Emissions
    are equal.

    ``text``: uint8 [n] tensor; ``patrev``: int32 [B, M+2] reversed
    patterns at columns 1..plen, padded with a value no text char
    equals; ``plens``: int32 [B]; ``reg_q``/``reg_a``/``reg_b``: int64
    [R] tensors on the text's device, ``0 <= a <= b < n``.

    Returns (region, position) int64 tensors of the emitted start
    positions, region-major and descending by position inside a region
    (the reference scan direction)."""
    dev = text.device
    R = reg_q.numel()
    widths = reg_b - reg_a + 1
    # regions of similar width share a chunk, so one long region does
    # not set the column count of all the others
    by_width = torch.argsort(widths, stable=True)
    regs, poss = [], []
    rows = max(1, _SCAN_ELEMS // (M + 2))
    c0 = 0
    while c0 < R:
        sel = by_width[c0:c0 + rows]
        wmax = int(widths[sel[-1]])
        if sel.numel() * wmax > _SCAN_ELEMS:
            sel = sel[:max(1, _SCAN_ELEMS // wmax)]
        c0 += sel.numel()
        emits = _scan_regions(text, patrev[reg_q[sel]], plens[reg_q[sel]],
                              M, k, reg_b[sel], widths[sel])
        r, c = torch.nonzero(emits, as_tuple=True)
        regs.append(sel[r])
        poss.append(reg_b[sel][r] - c)
    if not regs:
        z = torch.zeros(0, dtype=_I64, device=dev)
        return z, z.clone()
    reg = torch.cat(regs)
    pos = torch.cat(poss)
    # region-major, positions descending: one sort of a combined key
    order = torch.argsort(reg * (int(text.numel()) + 1) - pos, stable=True)
    return reg[order], pos[order]


def _scan_regions(text, patrev, plens, M: int, k: int, right, widths):
    """[R, maxwidth] bool emission flags of one chunk of regions:
    column c of row r is text position ``right[r] - c``."""
    dev = text.device
    R = right.numel()
    maxwidth = int(widths.max())
    cols = torch.arange(maxwidth, dtype=_I64, device=dev)
    # uint8 text values become int32 chars (never used as indices)
    win = text[(right[:, None] - cols[None, :]).clamp(min=0)].to(_I32)
    inregion = cols[None, :] < widths[:, None]
    idx = torch.arange(M + 2, dtype=_I32, device=dev)[None, :]
    plen = plens.to(_I32)
    dcol = idx.expand(R, M + 2).contiguous()
    end = torch.full((R,), k + 1, dtype=_I32, device=dev)
    emits = torch.zeros((R, maxwidth), dtype=torch.bool, device=dev)
    for c in range(maxwidth):
        dcol, end, emit = _cutoff_step(patrev, plen, idx, M, k, dcol, end,
                                       win[:, c])
        emits[:, c] = emit & inregion[:, c]
    return emits


# ---------------------------------------------------------------------------
# the whole task
# ---------------------------------------------------------------------------


def _pattern_chunks(idx: np.ndarray, n: int):
    """Chunks of the pattern numbers ``idx`` whose [patterns, n] tensors
    stay within ``_WINDOW_ELEMS`` elements."""
    step = max(1, _WINDOW_ELEMS // max(n, 1))
    return [idx[c:c + step] for c in range(0, idx.size, step)]


def _window_hits(esa: ESA, query, plens_np, k: int, exact: bool):
    """(qidx, pos, dist) of every window with no more than k mismatches
    (exact: none, specials never matching), query-major, ascending."""
    from .approx import _pattern_matrix

    n = esa.totallength
    dev = esa.dev
    text = esa.device("text")
    posn = torch.arange(n, dtype=_I64, device=dev)[None, :]
    parts = []
    for grp in _pattern_chunks(np.arange(len(query)), n):
        patmat, _ = _pattern_matrix([query[i] for i in grp], -2)
        pl = torch.from_numpy(plens_np[grp]).to(dev)
        mm, sep = _window_mismatches(
            text, torch.from_numpy(patmat).to(dev), pl, patmat.shape[1], n,
            exact)
        hit = (posn <= n - pl.to(_I64)[:, None]) & (mm <= (0 if exact else k))
        if not exact:
            hit &= ~sep
        gq, gp = torch.nonzero(hit, as_tuple=True)
        parts.append((gq + int(grp[0]), gp, mm[gq, gp].to(_I64)))
    qidx, pos, mm = (torch.cat(col).cpu().numpy() for col in zip(*parts))
    return qidx, pos, (np.zeros_like(mm) if exact else -mm)


def _edit_hits(esa: ESA, query, plens_np, k: int):
    """(qidx, pos) of every start the reference's online edit scans
    detect: by pattern-length class (ISLARGEPATTERN8, dpbitvec48.h),
    <= 64 the exact bit-vector scan, > 64 the approximate Ukkonen
    cutoff (edistcompl.c:458-514)."""
    from .approx import _eqs_matrix

    n = esa.totallength
    dev = esa.dev
    text_rev = torch.flip(esa.device("text")[:n], [0])
    hit_q, hit_p = [], []

    def collect(grp, hits):
        b, jrev = torch.nonzero(hits, as_tuple=True)
        hit_q.append(torch.from_numpy(grp).to(dev)[b])
        hit_p.append(n - 1 - jrev)

    words = (plens_np + 31) // 32
    with phase("edit scan"):
        for w in (1, 2):
            for grp in _pattern_chunks(np.flatnonzero(words == w), n):
                # GETEQSREV: masks of the reversed pattern, a pattern
                # wildcard sets no bit
                eqs = _eqs_matrix([query[i][::-1] for i in grp], 32 * w)
                collect(grp, _semiglobal_myers(
                    text_rev, torch.from_numpy(eqs.view(np.int32)).to(dev),
                    torch.from_numpy(plens_np[grp]).to(dev), w, n, k))
    with phase("cutoff scan"):
        for grp in _pattern_chunks(np.flatnonzero(words > 2), n):
            M = int(plens_np[grp].max())
            patrev = np.full((grp.size, M + 2), -7, np.int32)
            for bi, qi in enumerate(grp):
                patrev[bi, 1:plens_np[qi] + 1] = query[qi][::-1]
            collect(grp, _ukkonen_cutoff_scan_global(
                text_rev, torch.from_numpy(patrev).to(dev),
                torch.from_numpy(plens_np[grp]).to(dev), M, k, n))
    if not hit_q:
        z = np.zeros(0, np.int64)
        return z, z
    return (torch.cat(hit_q).cpu().numpy().astype(np.int64),
            torch.cat(hit_p).cpu().numpy())


def online_complete_matches(
    esa: ESA,
    query: "list[np.ndarray]",
    k: int,
    kind: str,                       # "exact" | "hamming" | "edit"
    flags_extra: int = 0,
    query_starts: np.ndarray | None = None,
) -> MatchTable:
    """-online -complete [-h k | -e k] over a batch of patterns."""
    from .approx import _run_verify_edit

    B = len(query)
    n = esa.totallength
    if B == 0 or n == 0:
        return MatchTable()
    if query_starts is None:
        query_starts = np.zeros(B, np.int64)
    plens_np = np.array([p.size for p in query], np.int32)

    if kind in ("exact", "hamming"):
        with phase("window scan"):
            qidx, pos, dist = _window_hits(esa, query, plens_np, k,
                                           kind == "exact")
        lens = plens_np[qidx].astype(np.int64)
        if kind == "exact":
            order = np.lexsort((pos, qidx))      # ascending (BMH)
        else:
            order = np.lexsort((-pos, qidx))     # right-to-left scan
    else:
        qidx, pos = _edit_hits(esa, query, plens_np, k)
        if pos.size == 0:
            return MatchTable()
        # measure each start with the shared longest-match verification
        # (edistprocessstartpos, approxcompl.c:13-65); a pattern
        # WILDCARD never matches anything (GETEQS skip rule,
        # kurtz-basic/getEqs.gen; longestmatch.c:50 for long patterns).
        # The reference emits every detected start, even when the
        # measured distance exceeds k (no DEBUG assert in release)
        with phase("measure"):
            _, bestlen, bestsc = _run_verify_edit(
                esa, pos, qidx, query, plens_np, int(plens_np.max()), k)
        lens = bestlen.astype(np.int64)
        dist = bestsc.astype(np.int64)
        order = np.lexsort((-pos, qidx))         # right-to-left scan

    with phase("expansion"):
        qidx, pos, lens, dist = (qidx[order], pos[order], lens[order],
                                 dist[order])
        tot = pos.size
        seq1, rel1 = esa.multiseq.pos_to_pair(pos)
        return MatchTable(
            length1=lens,
            position1=pos,
            length2=plens_np[qidx].astype(np.int64),
            position2=query_starts[qidx].astype(np.int64),
            distance=dist,
            flag=np.full(tot, FLAGQUERY | FLAGCOMPLETEMATCH | flags_extra,
                         np.int64),
            seqnum1=seq1,
            relpos1=rel1,
            seqnum2=qidx.copy(),
            relpos2=np.zeros(tot, np.int64),
            evalue=np.zeros(tot, np.float64),
            idnumber=np.zeros(tot, np.int64),
            transnum=np.full(tot, -1, np.int64),
        )

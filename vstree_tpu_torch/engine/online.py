"""The Ukkonen-cutoff detection scan of :mod:`vstree_tpu.engine.online`,
per region.

Only :func:`_ukkonen_cutoff_scan` is ported, in the form the region
pipeline of ``-complete -e`` needs (``engine/approx.py::
_region_detect``).  The JAX function scans all n text positions with
dense ``(n, B)`` reset / in-region masks; its state is reset at every
region's right end and emissions outside regions are masked, so the
regions of one query are independent.  Here every region is a row of
its own: its reversed text window is gathered into a ``[R, maxwidth]``
tensor and all regions advance in lockstep for ``maxwidth`` columns
with the same column update.  Emissions are equal.

Not ported yet: the global scan (no regions) and the rest of
``-complete -online``.
"""

from __future__ import annotations

import torch

from ..core.chardef import SEPARATOR

_I32 = torch.int32
_I64 = torch.int64
_SCAN_ELEMS = 1 << 24  # elements of the [R, width] / [R, M+2] tensors


def _ukkonen_cutoff_scan(text, patrev, plens, M: int, k: int,
                         reg_q, reg_a, reg_b):
    """Replay of the reference's right-to-left Ukkonen-cutoff detection
    scan (splitesaapm.c:43-122 ``verifyedistlongmatch``) over the
    regions ``[reg_a[r], reg_b[r]]`` of the text, each scanned from its
    right end with pattern ``reg_q[r]``.

    The reference maintains a column dcol[0..end) of cells <= threshold
    and EXTENDS the column by writing the literal value ``threshold``
    into the next cell (edistcompl.c:144-149), an upper-bound shortcut
    that makes the scan slightly approximate; it is replicated for
    output parity.  The sequential in-column min-chain
    new[i] = min(old[i]+1, old[i-1]+delta, new[i-1]+1) is vectorized
    with the prefix-min identity new[i] = min_{j<=i}(t[j]-j)+i.

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
        ch = win[:, c]
        is_sep = ch == SEPARATOR
        delta = (patrev != ch[:, None]).to(_I32)
        old = dcol
        diag = torch.cat(
            [torch.zeros((R, 1), dtype=_I32, device=dev), old[:, :-1]], 1)
        t = torch.minimum(old + 1, diag + delta)
        t[:, 0] = 0  # t is a fresh tensor
        new = torch.cummin(t - idx, dim=1).values + idx
        upd = (idx >= 1) & (idx <= end[:, None] - 1)
        dcol2 = torch.where(upd, new, old)
        # extension (edistcompl.c:144-149): pattern char for cell
        # ``end`` matches, or the last cell is strictly < threshold
        endm1 = dcol2.gather(
            1, (end - 1).clamp(min=0)[:, None].to(_I64))[:, 0]
        ext_ch = patrev.gather(
            1, end.clamp(max=M + 1)[:, None].to(_I64))[:, 0]
        can_ext = (end <= plen) & ((ext_ch == ch) | (k > endm1))
        dcol3 = torch.where(
            can_ext[:, None] & (idx == end[:, None]), k, dcol2)
        # trim (edistcompl.c:151-155): last cell <= threshold
        ok = (dcol3 <= k) & (idx <= end[:, None] - 1)
        last = torch.where(ok, idx, -1).max(dim=1).values
        nend = torch.where(can_ext, end + 1, last + 1)
        full = nend == plen + 1
        # SEPARATOR: reset column (edistcompl.c:105-113)
        end = torch.where(is_sep, k + 1, nend)
        dcol = torch.where(is_sep[:, None], idx, dcol3)
        emits[:, c] = full & ~is_sep & inregion[:, c]
    return emits

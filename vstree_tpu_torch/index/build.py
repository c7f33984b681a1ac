"""Enhanced-suffix-array construction on one device (port of
:mod:`vstree_tpu.index.build`, single-device path).

The sort and LCP core is :mod:`vstree_tpu_torch.index.sort`; this
module holds the build orchestration (mkvprocess.c:875-1089): the
derived tables bwt, bck and skp, and the ESA assembly.  ``bwt_table``,
``bucket_codes`` and ``bck_table`` are NumPy, copied here because the
JAX module imports jax at its top.

Not ported yet: the mesh paths and ``build_suf_out_of_core``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vstree_tpu.core.alphabet import Alphabet
from vstree_tpu.core.chardef import UNDEFBWTCHAR, WILDCARD
from vstree_tpu.core.multiseq import Multiseq

from ..device import phase
from .esa import ESA

SIZEOFBCKENTRY = 16  # two 8-byte Uint words per bucket (virtualdef.h:104)


def recommended_prefixlength(numofchars: int, totallength: int) -> int:
    """vm_recommendedprefixlength (kurtz/detpfxlen.c:53-62)."""
    value = totallength / SIZEOFBCKENTRY
    if value <= numofchars:
        return 1
    return max(1, int(math.floor(math.log(value) / math.log(numofchars))))


def maximal_prefixlength(numofchars: int, totallength: int) -> int:
    """vm_whatisthemaximalprefixlength with prefixlenbits=0
    (detpfxlen.c:64-89): bcktab may use up to 4n bytes."""
    value = totallength / (SIZEOFBCKENTRY / 4)
    if value <= numofchars:
        return 1
    return max(1, int(math.floor(math.log(value) / math.log(numofchars))))


# ---------------------------------------------------------------------------
# suffix sorting and LCP
# ---------------------------------------------------------------------------


def suffix_sort(text_np: np.ndarray, sigma: int | None = None, *,
                device) -> tuple[np.ndarray, np.ndarray]:
    """(suftab, stitab), int32 [n+1]: ``suftab[r]`` = start of the
    rank-r suffix (``suftab[n] = n``, the sentinel) and its inverse."""
    from .sort import suffix_sort_host

    return suffix_sort_host(text_np, sigma=sigma, device=device)


def build_suf_lcp(text_np: np.ndarray, sigma: int | None = None, *,
                  device):
    """Suffix sort + adjacent-pair LCP on ``device``; returns
    (suftab[n+1], lcptab[n+1]) with the usual sentinel conventions."""
    from .sort import suf_lcp_host

    return suf_lcp_host(text_np, sigma=sigma, device=device)


def _lcp_round(text, a, b, lcp, active, w: int, n: int):
    """Advance lcp for the active pairs by comparing the next ``w``
    characters (bytes equal and regular: specials never match).  The
    JAX package reaches this only from the mesh path of
    ``lcp_from_pairs``."""
    offs = torch.arange(w, dtype=torch.int64, device=text.device)[None, :]
    ia = a[:, None].to(torch.int64) + lcp[:, None] + offs
    ib = b[:, None].to(torch.int64) + lcp[:, None] + offs
    ca = text[ia.clamp(max=n - 1)]
    cb = text[ib.clamp(max=n - 1)]
    match = (ia < n) & (ib < n) & (ca == cb) & (ca < WILDCARD)
    run = torch.cumprod(match.to(torch.int32), dim=1).sum(
        1, dtype=torch.int32)
    lcp = torch.where(active, lcp + run, lcp)
    return lcp, active & (run == w)


def lcp_from_pairs(text_np: np.ndarray, a_np: np.ndarray,
                   b_np: np.ndarray, *, device) -> np.ndarray:
    """Longest common prefix of suffix pairs (a[i], b[i]) by the
    packed-word ladder on ``device``."""
    if int(a_np.size) == 0:
        return np.zeros(0, np.int32)
    from .sort import lce_pairs_host

    return lce_pairs_host(text_np, a_np, b_np, device=device)


def lcp_table(text_np: np.ndarray, suftab: np.ndarray, *,
              device) -> np.ndarray:
    """lcp[r] = lcp(suffix at rank r-1, suffix at rank r); lcp[0] = 0;
    int32 [n+1]."""
    n = int(text_np.size)
    lcp = np.zeros(n + 1, np.int32)
    if n >= 1:
        lcp[1:] = lcp_from_pairs(text_np, suftab[:-1], suftab[1:],
                                 device=device)
    return lcp


# ---------------------------------------------------------------------------
# derived tables (NumPy)
# ---------------------------------------------------------------------------


def bwt_table(text_np: np.ndarray, suftab: np.ndarray) -> np.ndarray:
    """Burrows-Wheeler transform (kurtz/bwtcode.c:293-311)."""
    if text_np.size == 0:
        return np.full(suftab.size, UNDEFBWTCHAR, np.uint8)
    prev = suftab.astype(np.int64) - 1
    return np.where(
        suftab > 0, text_np[np.maximum(prev, 0)], np.uint8(UNDEFBWTCHAR)
    ).astype(np.uint8)


def bucket_codes(text_np: np.ndarray, numofchars: int,
                 prefixlength: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-suffix bucket code and regular-prefix depth (ppsort.c:83-314
    rolling-code semantics): from the first special char or the
    sentinel onward every digit is ``numofchars-1``.  Returns int64
    codes for suffixes 0..n and the depth of the first special."""
    n = int(text_np.size)
    pl = prefixlength
    if n == 0:
        return (np.full(1, numofchars ** pl - 1, np.int64),
                np.zeros(1, np.int64))
    t = text_np.astype(np.int64)
    code = np.zeros(n + 1, np.int64)
    valid_depth = np.full(n + 1, pl, np.int64)
    pos = np.arange(n + 1)
    seen_special = np.zeros(n + 1, bool)
    for j in range(pl):
        idx = pos + j
        inb = idx < n
        cj = np.where(inb, t[np.minimum(idx, n - 1)], numofchars - 1)
        sp = ~inb | (cj >= WILDCARD)
        newly = sp & ~seen_special
        valid_depth = np.where(newly, j, valid_depth)
        seen_special |= sp
        cj = np.where(seen_special, numofchars - 1, cj)
        code = code * numofchars + cj
    return code, valid_depth


def bck_table(text_np: np.ndarray, numofchars: int,
              prefixlength: int) -> np.ndarray:
    """Bucket table: ``bck[2c] = left``, ``bck[2c+1] = mid``; ranks
    [left, mid) hold the suffixes whose full pl-prefix is regular and
    spells c (makebcktab, mkvprocess.c:251-312)."""
    numofcodes = numofchars ** prefixlength
    code, valid_depth = bucket_codes(text_np, numofchars, prefixlength)
    hist_all = np.bincount(code, minlength=numofcodes)
    hist_full = np.bincount(code[valid_depth == prefixlength],
                            minlength=numofcodes)
    left = np.concatenate([[0], np.cumsum(hist_all)[:-1]])
    bck = np.empty(2 * numofcodes, np.uint32)
    bck[0::2] = left
    bck[1::2] = left + hist_full
    return bck


# ---------------------------------------------------------------------------
# skip table
# ---------------------------------------------------------------------------


_SKP_BLOCK = 64


def skip_table(lcptab: np.ndarray, *, device) -> np.ndarray:
    """skp[i] = (smallest j > i with lcp[j] < lcp[i]) - 1, totallength
    if none (kurtz/mkskip.c:62-83).  Next-smaller-value in O(n) memory:
    a shifted-window scan resolves everything within two blocks;
    escapees descend a sparse table over block minima and finish with
    one in-block scan."""
    n1 = int(lcptab.size)
    if n1 <= 1:
        return np.full(n1, n1 - 1, np.int64)
    B = _SKP_BLOCK
    nb = (n1 + B - 1) // B
    blevels = max(1, int(np.floor(np.log2(max(nb, 2)))) + 1)
    lcp_dev = torch.from_numpy(lcptab.astype(np.int32)).to(device)
    ans, esc = _skp_phase12(lcp_dev, n1, nb, blevels)
    ans_h = ans.cpu().numpy().astype(np.int64)
    ei = np.flatnonzero(esc.cpu().numpy())
    if ei.size:
        fine = _skp_inblock(
            lcp_dev, torch.from_numpy(ans_h[ei].astype(np.int32)).to(device),
            torch.from_numpy(lcptab[ei].astype(np.int32)).to(device))
        ans_h[ei] = fine.cpu().numpy()
    return np.minimum(ans_h, n1) - 1


def _skp_phase12(lcp, n1: int, nb: int, blevels: int):
    """Phases 1+2: near answers (exact positions) and, for escapees,
    the start of the first far block whose minimum dips below lcp[i]."""
    B = _SKP_BLOCK
    BIG = 2**30
    idx = torch.arange(n1, dtype=torch.int32, device=lcp.device)
    INF = n1

    # phase 1: shifted-window scan to the end of the next block
    limit = (idx // B + 2) * B - 1
    ans = torch.full_like(idx, INF)
    for k in range(1, 2 * B + 1):
        sh = torch.cat([lcp[k:], lcp.new_full((min(k, n1),), BIG)])
        hit = (sh < lcp) & (idx + k <= limit)
        ans = torch.where((ans == INF) & hit, idx + k, ans)

    # phase 2: first block b >= block(i)+2 with min < lcp[i], by an
    # aligned-window descent on a sparse table over block minima
    pad = nb * B - n1
    lcp_pad = (torch.cat([lcp, lcp.new_full((pad,), BIG)]) if pad
               else lcp)
    btabs = [lcp_pad.reshape(nb, B).amin(1)]
    for e in range(1, blevels):
        prev = btabs[-1]
        half = 1 << (e - 1)
        shifted = torch.cat([prev[half:], prev.new_full((min(half, nb),),
                                                        BIG)])
        btabs.append(torch.minimum(prev, shifted))
    btab = torch.stack(btabs)

    v = lcp
    t = idx // B + 1
    for e in range(blevels - 1, -1, -1):
        mn = btab[e][(t + 1).clamp(0, nb - 1)]
        ok = (t + (1 << e) <= nb) & (mn >= v)
        t = torch.where(ok, t + (1 << e), t)
    bstar = t + 1  # first block >= block(i)+2 with bmin < v (>= nb: none)
    found_blk = (bstar < nb) & (btab[0][bstar.clamp(0, nb - 1)] < v)
    esc = (ans == INF) & found_blk
    ans = torch.where(esc, bstar.clamp(0, nb - 1) * B, ans)
    return ans, esc


def _skp_inblock(lcp, base, v):
    """Phase 3: exact first j in [base, base+B) with lcp[j] < v."""
    B = _SKP_BLOCK
    n1 = lcp.shape[0]
    off = torch.full_like(base, B)
    for k in range(B - 1, -1, -1):
        cand = base + k
        ok = (cand < n1) & (lcp[cand.clamp(max=n1 - 1)] < v)
        off = torch.where(ok, k, off)
    return base + off


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


def build_esa(
    multiseq: Multiseq,
    alpha: Alphabet,
    prefixlength: int | None = None,
    demand: tuple[str, ...] = ("suf", "lcp", "bwt", "bck", "sti"),
    indexname: str = "",
    *,
    device,
) -> ESA:
    """Build the enhanced suffix array of a Multiseq on ``device``
    (mkvtreeprocess, mkvprocess.c:875-1089, minus file output)."""
    device = torch.device(device)
    text = multiseq.sequence
    n = int(text.size)
    numofchars = alpha.num_regular
    if prefixlength is None:
        prefixlength = recommended_prefixlength(numofchars, max(n, 1))

    lcptab = None
    if "lcp" in demand or "skp" in demand:
        suftab, lcptab = build_suf_lcp(text, sigma=numofchars,
                                       device=device)
        stitab = np.empty(n + 1, np.int32)
        stitab[suftab] = np.arange(n + 1, dtype=np.int32)
    else:
        suftab, stitab = suffix_sort(text, sigma=numofchars, device=device)
    esa = ESA(
        multiseq=multiseq,
        alpha=alpha,
        suftab=suftab,
        stitab=stitab if "sti" in demand else None,
        prefixlength=prefixlength,
        longest=int(stitab[0]) if n > 0 else 0,
        indexname=indexname,
        dev=device,
    )
    if lcptab is not None:
        esa.lcptab = lcptab
        if "lcp" in demand:
            esa.maxbranchdepth = int(lcptab.max()) if n > 0 else 0
            esa.largelcpvalues = int((lcptab >= 255).sum())
    if "bwt" in demand:
        with phase("bwt"):
            esa.bwttab = bwt_table(text, suftab)
    if "bck" in demand and prefixlength > 0:
        with phase("bck"):
            esa.bcktab = bck_table(text, numofchars, prefixlength)
    if "skp" in demand:
        with phase("skip table"):
            esa.skptab = skip_table(esa.lcptab, device=device)
    from ..core.debug import check_suftab, debug_level

    lvl = debug_level()
    if lvl >= 1:
        # DEBUGLEVEL-style embedded verifiers (bese.c:355-533)
        check_suftab(text, suftab, esa.lcptab, lvl)
    return esa

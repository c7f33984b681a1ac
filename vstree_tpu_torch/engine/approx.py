"""Approximate complete matching: Hamming (-h k) and edit (-e k).
Port of :mod:`vstree_tpu.engine.approx`, same names.

Reference algorithms (all emit start positions in suffix-rank order):
- Hamming: esahamming linear suftab scan with mismatch stack
  (src/Vmengine/esahamming.c:86-163),
- edit: esaapm suftab scan with Myers bit-vector column stack
  (src/Vmengine/esaapm.c:296-383); large k / long patterns:
  splitesaapm pattern partitioning (src/Vmengine/splitesaapm.c:465);
  per emitted start, (length, distance) from the longest-match scan
  (src/Vmengine/longestmatch.c, approxcompl.c:13-65).

The partition filter is the batch-friendly formulation, so it is used
for every k (result set identical to the scanning algorithms), batched
over ALL query patterns at once:

1. split every pattern into k+1 pieces; any occurrence with <= k
   errors contains one piece exactly (pigeonhole),
2. locate all pieces of all patterns with ONE batched interval lookup
   (engine/complete.py, kernel K1),
3. expand piece hits to (query, start) candidates (edit: +-k shifts),
   dedupe,
4. verify all candidates in parallel on ``esa.dev``: mismatch count
   over gathered windows (Hamming) or the Myers bit-vector DP (edit):
   kernel K2 (:mod:`vstree_tpu_torch.native.myers`) for patterns of
   <= 32 chars, torch ops for longer ones,
5. emit survivors in (query, suffix-rank-of-start) order to mirror
   the reference's per-query rank-order scan.

Semantics preserved exactly: byte-equality compare (a wildcard in the
pattern matches the same wildcard byte in the text), a SEPARATOR stops
the scan — no window crossing one counts (esaapm.c:266-269),
maxlength = plen + k.

Host bookkeeping is NumPy as in the JAX module; where that module walks
piece hits and regions in Python loops, this one does the same
arithmetic on whole arrays (equal results, held by the tests).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.chardef import SEPARATOR, WILDCARD
from ..device import phase
from ..index.esa import ESA
from ..native.myers import myers_verify_torch, verify_edit
from .complete import exact_interval_lookup
from .match import FLAGCOMPLETEMATCH, FLAGQUERY, MatchTable
from .online import _ukkonen_cutoff_scan

_I64 = torch.int64
_HAMMING_ELEMS = 1 << 24  # window elements per Hamming chunk


def _expand_intervals(lo: np.ndarray, hi: np.ndarray):
    """Rank intervals [lo, hi) -> (interval index, rank) of every rank,
    intervals in order and ranks ascending inside each."""
    counts = np.maximum(hi.astype(np.int64) - lo, 0)
    total = int(counts.sum())
    idx = np.repeat(np.arange(counts.size), counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ranks = (np.arange(total) - starts[idx]) + lo[idx]
    return idx, ranks


def _pattern_matrix(patterns: list[np.ndarray], fill: int):
    """(int32 [B, maxlen] matrix padded with ``fill``, int32 lengths)."""
    plens = np.array([p.size for p in patterns], np.int32)
    mat = np.full((len(patterns), int(plens.max(initial=0))), fill,
                  np.int32)
    for i, p in enumerate(patterns):
        mat[i, :p.size] = p.astype(np.int32)
    return mat, plens


def _to_dev(a: np.ndarray, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.astype(dtype))).to(dev)


def _all_piece_candidates(
    esa: ESA, patterns: list[np.ndarray], k: int, shifted: bool
) -> tuple[np.ndarray, np.ndarray]:
    """(qidx, start) candidates for every pattern, deduped.

    Pattern partitioning (splitesaapm.c:388-464): k+1 pieces per
    pattern, one batched exact lookup for all pieces of all patterns.
    Patterns containing special chars fall back to all-starts
    (the reference's byte-equality scan can match them; the index
    piece search cannot).
    """
    n = esa.totallength
    piece_rows = []   # (qi, off, len)
    brute_q = []
    for qi, pat in enumerate(patterns):
        plen = pat.size
        if (pat >= 250).any() and plen <= 64:
            # short special-containing patterns: the esaapm scan is
            # byte-permissive, emulate with all-starts verification;
            # long ones go through splitesaapm's exact piece search
            # where special pieces simply never match
            # (splitesaapm.c:388-464)
            brute_q.append(qi)
            continue
        parts = k + 1
        base = plen // parts
        rem = plen % parts
        off = 0
        for i in range(parts):
            ln = base + (1 if i < rem else 0)
            if ln > 0:
                piece_rows.append((qi, off, ln))
            off += ln
    cands = []
    if piece_rows:
        pats, plens = _pattern_matrix(
            [patterns[qi][off:off + ln] for qi, off, ln in piece_rows], -1)
        lo, hi = exact_interval_lookup(esa, pats, plens)
        with phase("piece hits"):
            pidx, ranks = _expand_intervals(lo, hi)
            if ranks.size:
                occ = esa.suftab[ranks].astype(np.int64)
                offs = np.array([o for _, o, _ in piece_rows], np.int64)
                qis = np.array([q for q, _, _ in piece_rows], np.int64)
                pos = occ - offs[pidx]
                qi_arr = qis[pidx]
                if shifted:
                    sh = np.arange(-k, k + 1, dtype=np.int64)
                    pos = (pos[:, None] + sh[None, :]).ravel()
                    qi_arr = np.repeat(qi_arr, sh.size)
                keep = (pos >= 0) & (pos < n)
                cands.append((qi_arr[keep], pos[keep]))
    for qi in brute_q:
        allpos = np.arange(max(n, 0), dtype=np.int64)
        cands.append((np.full(allpos.size, qi, np.int64), allpos))
    if not cands:
        z = np.zeros(0, np.int64)
        return z, z
    with phase("piece hits"):
        qi_all = np.concatenate([c[0] for c in cands])
        pos_all = np.concatenate([c[1] for c in cands])
        key = qi_all * (n + 1) + pos_all
        uniq = np.unique(key)
        return uniq // (n + 1), uniq % (n + 1)


# ---------------------------------------------------------------------------
# Hamming verification (esahamming.c semantics)
# ---------------------------------------------------------------------------


def _verify_hamming(text, cand, qidx, patmat, plens, maxplen: int, n: int):
    """Per candidate: (no SEPARATOR inside the window, mismatch count
    over the pattern's length).  ``cand``/``qidx`` integer [P] tensors,
    ``patmat`` int32 [Q, maxplen], ``plens`` [Q]; past the text end
    reads as SEPARATOR.  Chunked over the candidates."""
    dev = cand.device
    offs = torch.arange(maxplen, dtype=_I64, device=dev)[None, :]
    step = max(1, _HAMMING_ELEMS // max(maxplen, 1))
    oks, mms = [], []
    for c in range(0, cand.numel(), step):
        q = qidx[c:c + step].to(_I64)
        idx = cand[c:c + step].to(_I64)[:, None] + offs
        inb = idx < n
        ch = torch.where(inb, text[idx.clamp(max=n - 1)].to(torch.int32),
                         SEPARATOR)
        active = offs < plens[q][:, None]
        oks.append(~(active & (ch == SEPARATOR)).any(1))
        mms.append((active & (ch != patmat[q])).sum(1, dtype=torch.int32))
    if not oks:
        return (torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    return torch.cat(oks), torch.cat(mms)


# ---------------------------------------------------------------------------
# edit verification: batched Myers (Myers 1999 / Hyyro)
# ---------------------------------------------------------------------------


def _verify_edit(text, cand, qidx, eqs, plens, w: int, maxlen: int,
                 n: int):
    """Myers bit-vector verification dispatcher: patterns of one 32-bit
    word run kernel K2 (:func:`vstree_tpu_torch.native.myers.
    verify_edit`: the kernel for CUDA tensors, its plain version for CPU
    tensors); multiword patterns use the torch carry-chain path.
    ``eqs``: int32 [Q, w, 256], the bit patterns of the uint32 masks."""
    if w == 1:
        return verify_edit(text, cand, qidx, eqs[:, 0, :].contiguous(),
                           plens, maxlen, n)
    return _verify_edit_multiword(text, cand, qidx, eqs, plens, w, maxlen, n)


def _verify_edit_multiword(text, cand, qidx, eqs, plens, w: int,
                           maxlen: int, n: int):
    """Per candidate: (minscore over lengths, bestlen, bestscore), for
    patterns of any number ``w`` of 32-bit words.

    Tracks the reference longest-match rule (update when score <=
    stored, stop updates at the first SEPARATOR — longestmatch.c:6-11,
    40-45) and the existence score min over all lengths (esaapm success
    test)."""
    return myers_verify_torch(text, cand, qidx, eqs, plens, w, maxlen, n)


def _run_verify_edit(esa: ESA, pos, qidx, patterns, plens, maxlen: int,
                     k: int):
    """Upload candidates and masks and verify them on ``esa.dev``;
    returns host (minsc, bestlen, bestsc)."""
    dev = esa.dev
    w = (maxlen + 31) // 32
    eqs = _eqs_matrix(patterns, maxlen)
    out = _verify_edit(
        esa.device("text"), _to_dev(pos, np.int32, dev),
        _to_dev(qidx, np.int32, dev),
        torch.from_numpy(eqs.view(np.int32)).to(dev),
        _to_dev(plens, np.int32, dev), w, maxlen + k, esa.totallength)
    return tuple(t.cpu().numpy() for t in out)


def _run_verify_hamming(esa: ESA, pos, qidx, patterns, plens):
    """Upload candidates and patterns and count mismatches on
    ``esa.dev``; returns host (ok, mm)."""
    dev = esa.dev
    patmat, _ = _pattern_matrix(patterns, -2)
    okh, mm = _verify_hamming(
        esa.device("text"), _to_dev(pos, np.int32, dev),
        _to_dev(qidx, np.int32, dev), torch.from_numpy(patmat).to(dev),
        _to_dev(plens, np.int64, dev), patmat.shape[1], esa.totallength)
    return okh.cpu().numpy(), mm.cpu().numpy()


# ---------------------------------------------------------------------------
# splitesaapm replication for long edit patterns (splitesaapm.c)
# ---------------------------------------------------------------------------


def _getoptsplit(numofchars: int, textlen: int, plen: int, k: int,
                 doedist: bool = True,
                 spliterrorbound: int = 10) -> int:
    """getoptsplit (splitesaapm.c:316-352): the cost-model split size
    deciding between the direct esaapm/esahamming rank scan
    (splitsize == 1) and the piece-search region pipeline."""
    if k * spliterrorbound >= plen:
        optsplit = k
    else:
        ratio = math.log(textlen) / math.log(max(numofchars, 2))
        optsplit = int(((plen + k) if doedist else plen) / ratio)
        if optsplit > k + 1:
            optsplit = k + 1
    while plen > 32 * optsplit:
        optsplit += 1
    return optsplit


def _eqs_matrix(patterns: list[np.ndarray], maxlen: int) -> np.ndarray:
    """GETEQS-rule masks (pattern WILDCARD bits dropped,
    kurtz-basic/getEqs.gen): uint32 [Q, w, 256]."""
    w = (maxlen + 31) // 32
    eqs = np.zeros((len(patterns), w, 256), np.uint32)
    if not patterns:
        return eqs
    plens = np.array([p.size for p in patterns], np.int64)
    qi = np.repeat(np.arange(len(patterns)), plens)
    i = np.arange(qi.size) - np.repeat(np.cumsum(plens) - plens, plens)
    c = np.concatenate(patterns).astype(np.int64)
    keep = c < WILDCARD
    qi, i, c = qi[keep], i[keep], c[keep]
    np.bitwise_or.at(eqs, (qi, i // 32, c),
                     (np.uint32(1) << (i % 32).astype(np.uint32)))
    return eqs


def _esaapm_starts(esa: ESA, patterns: list[np.ndarray], k: int):
    """Start positions with Eq-adjusted min edit distance <= k
    (exact esaapm semantics, for patterns <= 32 chars): pigeonhole
    candidates + batched Myers verification.  Returns (qidx, pos)."""
    n = esa.totallength
    plens = np.array([p.size for p in patterns], np.int32)
    if k == 0:
        z = np.zeros(0, np.int64)
        valid = np.array([qi for qi, p in enumerate(patterns)
                          if not (p >= 250).any()], np.int64)
        if valid.size == 0:
            return z, z
        pats, pl = _pattern_matrix([patterns[qi] for qi in valid], -1)
        lo, hi = exact_interval_lookup(esa, pats, pl)
        with phase("piece hits"):
            idx, ranks = _expand_intervals(lo, hi)
            return valid[idx], esa.suftab[ranks].astype(np.int64)
    qidx, pos = _all_piece_candidates(esa, patterns, k, shifted=True)
    ok = pos <= n - (plens[qidx].astype(np.int64) - k)
    qidx, pos = qidx[ok], pos[ok]
    if pos.size == 0:
        return qidx, pos
    with phase("verify"):
        minsc, _, _ = _run_verify_edit(esa, pos, qidx, patterns, plens,
                                       int(plens.max()), k)
    okv = minsc <= k
    return qidx[okv], pos[okv]


def _hamming_starts(esa: ESA, patterns: list[np.ndarray], k: int):
    """Start positions with <= k mismatches over the whole pattern
    (exact esahamming result set).  Pigeonhole candidates + batched
    verification.  Returns (qidx, pos, mm), unordered."""
    n = esa.totallength
    plens = np.array([p.size for p in patterns], np.int32)
    qidx, pos = _all_piece_candidates(esa, patterns, k, shifted=False)
    ok_pre = pos + plens[qidx] <= n
    qidx, pos = qidx[ok_pre], pos[ok_pre]
    z = np.zeros(0, np.int64)
    if pos.size == 0:
        return z, z, z
    with phase("verify"):
        okh, mm = _run_verify_hamming(esa, pos, qidx, patterns, plens)
    okv = okh & (mm <= k)
    return qidx[okv], pos[okv], mm[okv].astype(np.int64)


def _merge_regions(qi: np.ndarray, u0: np.ndarray, u1: np.ndarray, n: int):
    """Merge overlapping / adjacent regions per query
    (kurtz/regionsmerger.c; the checker asserts prev.end + 1 <
    next.start for merged output).  Returns (query, a, b) ordered by
    query, then start."""
    order = np.lexsort((u1, u0, qi))
    qi, u0, u1 = qi[order], u0[order], u1[order]
    # a per-query offset keeps one running maximum from leaking into
    # the next query's regions
    off = qi * (n + 2)
    reach = np.maximum.accumulate(u1 + off)
    first = np.ones(qi.size, bool)
    first[1:] = (u0 + off)[1:] > reach[:-1] + 1
    at = np.flatnonzero(first)
    last = np.concatenate([at[1:], [qi.size]]) - 1
    return qi[at], u0[at], (reach - off)[last]


def _region_detect(
    esa: ESA, patterns: list[np.ndarray], k: int, doedist: bool
) -> tuple[np.ndarray, np.ndarray]:
    """splitesaapm replay (splitesaapm.c:380-560, splitsize > 1):
    cost-model piece split, approximate piece search, region collect
    + merge (kurtz/regionsmerger.c), and per-region verification.

    Emission order matches the reference exactly: per query, regions
    ascending by start (the red-black in-order walk,
    redblacktreewalkwithstop), and inside a region start positions
    DESCENDING (the verify functions scan each region from its end,
    splitesaapm.c:42-240).  Returns (qidx, pos)."""
    n = esa.totallength
    dev = esa.dev
    plens = np.array([p.size for p in patterns], np.int32)
    numofchars = esa.alpha.mapsize - 1

    # 1. piece search -> candidate regions per query
    piece_pats: list[np.ndarray] = []
    piece_meta: list[tuple[int, int, int]] = []   # (qi, poffset, thr)
    for qi, p in enumerate(patterns):
        plen = int(plens[qi])
        splitsize = _getoptsplit(numofchars, n, plen, k, doedist)
        splitlen = plen // splitsize
        splitthr = k // splitsize
        poffset = 0
        while poffset < plen - splitlen + 1:
            piece_pats.append(p[poffset:poffset + splitlen])
            piece_meta.append((qi, poffset, splitthr))
            poffset += splitlen
    meta = np.array(piece_meta, np.int64).reshape(-1, 3)
    by_thr: dict[int, list[int]] = {}
    for i, (_, _, t) in enumerate(piece_meta):
        by_thr.setdefault(t, []).append(i)
    reg_q, reg_u0, reg_u1 = [], [], []
    for t, idxs in by_thr.items():
        sub = [piece_pats[i] for i in idxs]
        if doedist:
            pq, h = _esaapm_starts(esa, sub, t)
        else:
            pq, h, _ = _hamming_starts(esa, sub, t)
        with phase("regions"):
            piece = np.asarray(idxs, np.int64)[pq]
            qi, poffset = meta[piece, 0], meta[piece, 1]
            plen = plens[qi].astype(np.int64)
            # storeapmposition (splitesaapm.c:270-296): edit regions
            # widen by the threshold, hamming regions do not
            # (realsplitesaapm, splitesaapm.c:384-392)
            wid = k if doedist else 0
            reg_q.append(qi)
            reg_u0.append(np.maximum(0, h - (wid + poffset)))
            reg_u1.append(np.minimum(n - 1, h + plen + wid - poffset - 1))

    # 2. merge overlapping/adjacent regions
    z = np.zeros(0, np.int64)
    with phase("regions"):
        rq = np.concatenate(reg_q) if reg_q else z
        if rq.size == 0:
            return z, z
        rq, ra, rb = _merge_regions(rq, np.concatenate(reg_u0),
                                    np.concatenate(reg_u1), n)

    if doedist:
        # 3a. per-region reversed cutoff verification: every merged
        # region is one row of the lockstep scan
        with phase("region scan"):
            M = int(plens.max())
            patrev = np.full((len(patterns), M + 2), -7, np.int32)
            for qi, p in enumerate(patterns):
                patrev[qi, 1:plens[qi] + 1] = p[::-1].astype(np.int32)
            reg, pos = _ukkonen_cutoff_scan(
                esa.device("text"), torch.from_numpy(patrev).to(dev),
                _to_dev(plens, np.int32, dev), M, k,
                _to_dev(rq, np.int64, dev), _to_dev(ra, np.int64, dev),
                _to_dev(rb, np.int64, dev))
            return rq[reg.cpu().numpy()], pos.cpu().numpy()
    # 3b. hamming region verification: all window starts inside
    # each region, verified in one batch, emitted descending
    with phase("verify"):
        hi = rb - plens[rq] + 1
        counts = np.maximum(hi - ra + 1, 0)
        if int(counts.sum()) == 0:
            return z, z
        ridx, within = _expand_intervals(np.zeros_like(counts), counts)
        qidx = rq[ridx]
        pos = hi[ridx] - within
        okh, mm = _run_verify_hamming(esa, pos, qidx, patterns, plens)
        okv = okh & (mm <= k)
        return qidx[okv], pos[okv]


# ---------------------------------------------------------------------------
# top level (hammingprocessstartpos / edistprocessstartpos,
# approxcompl.c:13-80)
# ---------------------------------------------------------------------------


def approx_complete_matches(
    esa: ESA,
    query: "list[np.ndarray]",
    k: int,
    edit: bool,
    query_seqnums: np.ndarray | None = None,
    flags_extra: int = 0,
    query_starts: np.ndarray | None = None,
) -> MatchTable:
    """-complete -h/-e k over a batch of query patterns; emission in
    (query, rank-of-start) order."""
    B = len(query)
    n = esa.totallength
    if B == 0 or n == 0:
        return MatchTable()
    if query_seqnums is None:
        query_seqnums = np.arange(B, dtype=np.int64)
    if query_starts is None:
        query_starts = np.zeros(B, np.int64)

    plens_np = np.array([p.size for p in query], np.int32)
    if edit and (plens_np <= k).any():
        raise ValueError("edit threshold must be < pattern length")
    maxplen = int(plens_np.max())

    # routing per query (findapproxcompletematchesindex ->
    # splitesaapm, splitesaapm.c:500-560): splitsize == 1 runs the
    # direct esaapm/esahamming rank-order scan, splitsize > 1 the
    # piece-search region pipeline whose emission order is
    # region-major (see _region_detect)
    numofchars = esa.alpha.mapsize - 1
    rank_q: list[int] = []
    region_q: list[int] = []
    for qi in range(B):
        # threshold 0 falls back to the exact interval emission
        # (findapproxcompletematchesindex, approxcompl.c:165-175)
        ssz = 1 if k == 0 else _getoptsplit(
            numofchars, n, int(plens_np[qi]), k, doedist=edit)
        (rank_q if ssz == 1 else region_q).append(qi)

    qp: list[np.ndarray] = []
    pp: list[np.ndarray] = []
    if rank_q:
        sub = [query[qi] for qi in rank_q]
        if edit:
            sq, sp = _esaapm_starts(esa, sub, k)
        else:
            sq, sp, _ = _hamming_starts(esa, sub, k)
        # rank-order emission (esaapm.c:296-383 / esahamming.c:86-163)
        if sp.size:
            order = np.lexsort((esa.stitab[sp], sq))
            sq, sp = sq[order], sp[order]
        qp.append(np.asarray(rank_q, np.int64)[sq])
        pp.append(sp.astype(np.int64))
    if region_q:
        sub = [query[qi] for qi in region_q]
        lq, lp = _region_detect(esa, sub, k, doedist=edit)
        qp.append(np.asarray(region_q, np.int64)[lq])
        pp.append(lp.astype(np.int64))
    qidx = np.concatenate(qp) if qp else np.zeros(0, np.int64)
    pos = np.concatenate(pp) if pp else np.zeros(0, np.int64)
    if pos.size == 0:
        return MatchTable()
    # stable per-query interleave of the two groups' emissions
    order = np.argsort(qidx, kind="stable")
    qidx, pos = qidx[order], pos[order]

    with phase("measure"):
        if edit:
            # measurement (edistprocessstartpos -> longestmatch.c) with
            # the GETEQS rule: pattern WILDCARDs never match
            _, bestlen, bestsc = _run_verify_edit(
                esa, pos, qidx, query, plens_np, maxplen, k)
            lens = bestlen.astype(np.int64)
            dist = bestsc.astype(np.int64)
        else:
            _, mm = _run_verify_hamming(esa, pos, qidx, query, plens_np)
            lens = plens_np[qidx].astype(np.int64)
            dist = -mm.astype(np.int64)

    with phase("expansion"):
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
            seqnum2=query_seqnums[qidx].astype(np.int64),
            relpos2=np.zeros(tot, np.int64),
            evalue=np.zeros(tot, np.float64),
            idnumber=np.zeros(tot, np.int64),
            transnum=np.full(tot, -1, np.int64),
        )

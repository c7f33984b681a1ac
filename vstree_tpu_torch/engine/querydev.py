"""The reference's maximal-prefix interval search, the MEM expansion and
the db-vs-itself MEM pipeline as torch programs on the index's device
(port of :mod:`vstree_tpu.engine.querydev`, same names).

``findmaxpref_device`` runs the binary search of reference
kurtz/maxpref.c (``findmaxprefixlen``/``maxprefixmatchbinstep``,
maxpref.c:78-252) for many (interval, query-suffix) probes at once: every
lane carries the search state (lo/hi/floors/witness) and an in-flight
suffix comparison, and each trip advances every live comparison by one
packed word (13 chars for DNA, index/sort.py ``lce_pack_params``) and
does the binary-search bookkeeping of the lanes whose comparison just
resolved.  Finished lanes drop out between rounds of trips.

Departures from the JAX module, none of which changes a result:

- lane state is one int32 ``[15, M]`` tensor at its true width (no
  ``_nice_size`` padding, no pad lanes, no ``idx >= 0`` masks);
  compaction is a boolean index;
- positions are formed in int64; ``>>`` acts on the packed words only,
  which are non-negative;
- the db-vs-itself pipeline is a plain sequence of torch programs with
  three host reads: the XLA module's two-rung ``(H, R)`` ladder, its
  replay budget ``R``/``R2`` and singleton budget ``SE`` exist for static
  shapes and are gone (replay lanes and singletons are compacted to
  their counts).  The one budget kept is ``H``, the hard lanes of the
  interval scans, which are compacted without a host read; when it
  overflows the pipeline returns None at once (the JAX module retries
  with the same ``H``, which overflows again: fault F3), and so does it
  when a chain step saturates the sti1 byte or a replay does not finish;
- ``_LSTART`` and the truncated descents ``_scan_left_in``/
  ``_scan_right_in`` (nothing calls them) are not ported; the two gallop
  stages of ``_scan_sparse`` are one gallop run to its end, the same
  answers;
- the record-slot group ids of the expansions come from a
  ``scatter_reduce("amax")`` and ``torch.cummax``; range minima use the
  sparse table of ``repeats_dev`` (only the levels an lcp >= prefix-length
  run needs, see :func:`vstree_tpu_torch.engine.query._dev_lcp_rmq`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.chardef import SEPARATOR, WILDCARD
from ..device import count, phase
from ..index.sort import _lce_tables, _word_rem, lce_pack_params
from .repeats_dev import _rmq_query

_DONE = 3
_I32 = torch.int32
_I64 = torch.int64
_BIG = 1 << 30
# rows of the lane state of the binary-search replay
(_PHASE, _LO, _HI, _LPREF, _RPREF, _CUR, _WIT0, _WIT1, _TGT, _CSTART, _L,
 _OFF0, _QPOS, _QLEN, _IDX) = range(15)


def _db_tables(esa):
    """Cached device tensors for the db side: raw text, packed LCE word
    table, int32 suftab."""
    cache = esa._torch_cache
    if "qdev" not in cache:
        sigma = esa.alpha.num_regular
        bits, D = lce_pack_params(sigma)
        n = esa.totallength
        text_dev = esa.device("text")
        P = _lce_tables(text_dev, n, bits, D)
        cache["qdev"] = (text_dev, P, esa.device_suf32(), bits, D, n)
    return cache["qdev"]


def query_tables(esa, qtext: np.ndarray):
    """(qtext_dev, Pq, nq) for a query text, on ``esa.dev``."""
    bits, D = lce_pack_params(esa.alpha.num_regular)
    nq = int(qtext.size)
    qdev = torch.from_numpy(np.ascontiguousarray(qtext)).to(esa.dev)
    return qdev, _lce_tables(qdev, nq, bits, D), nq


def _fmp_trip(text, P, suftab, qtext, Pq, st, n: int, nq: int, bits: int,
              D: int, W: int = 1):
    """One trip over the lane state ``st`` ([15, M] int32): advance every
    live comparison by up to W packed words, then the binary-search
    bookkeeping of the lanes whose comparison just resolved.  A finished
    lane (phase _DONE) is a fixed point."""
    (phase_, lo, hi, lpref, rpref, cur, wit0, wit1, tgt, cstart, l, off0,
     qpos, qlen, idx) = st.unbind(0)
    active = phase_ < _DONE
    # ---- packed-word comparison steps (maxpref.c COMPARE) ----
    adv = torch.zeros_like(l)
    cdone = torch.zeros(l.shape, dtype=torch.bool, device=l.device)
    for _ in range(W):
        rem = _word_rem(P, Pq, cstart.to(_I64) + (l + adv),
                        qpos.to(_I64) + (l + adv), n, nq, bits, D)
        # the query side never matches past qlen (the caller guarantees
        # a special/end at qpos+qlen); capped defensively
        rem = torch.minimum(rem, (qlen - (l + adv)).clamp(min=0))
        adv = adv + torch.where(cdone, 0, rem)
        cdone = cdone | (rem < D)
    l = l + torch.where(active, adv, 0)
    stopped = active & cdone
    # classification of the stopped comparison (host _compare_batch
    # where-chain: q_over > s_over > neq > both-special)
    ia2 = cstart.to(_I64) + l
    qc = qtext[(qpos.to(_I64) + l).clamp(max=nq - 1)].to(_I32)
    sc = text[ia2.clamp(max=n - 1)].to(_I32)
    ret = torch.where(
        l >= qlen, 0,
        torch.where(ia2 >= n, -1,
                    torch.where(qc != sc, torch.sign(qc - sc), -1)))

    # ---- binary-search bookkeeping for stopped lanes ----
    p0 = stopped & (phase_ == 0)      # compared vs suftab[left]
    p1 = stopped & (phase_ == 1)      # compared vs suftab[right]
    p2 = stopped & (phase_ == 2)      # compared vs suftab[mid]

    # phase 0: wit := (l, left); lpref := l; ret>0 -> compare right
    lpref = torch.where(p0, l, lpref)
    wit0 = torch.where(p0, l, wit0)
    wit1 = torch.where(p0, lo, wit1)
    go1 = p0 & (ret > 0)

    # phase 1: maybe take the right witness; rpref/cur; enter the search
    upd1 = p1 & (lpref < l)
    wit0 = torch.where(upd1, l, wit0)
    wit1 = torch.where(upd1, tgt, wit1)
    rpref = torch.where(p1, l, rpref)
    cur = torch.where(p1, torch.minimum(lpref, l), cur)
    go2 = p1 & (ret < 0) & (wit0 < qlen) & (hi > lo + 1)

    # phase 2: witness/floor updates, halve the interval
    upd2 = p2 & (wit0 < l)
    wit0 = torch.where(upd2, l, wit0)
    wit1 = torch.where(upd2, tgt, wit1)
    neg = p2 & (ret < 0)
    pos = p2 & (ret > 0)
    rpref = torch.where(neg, l, rpref)
    hi = torch.where(neg, tgt, hi)
    lpref = torch.where(pos, l, lpref)
    lo = torch.where(pos, tgt, lo)
    cur = torch.where(neg, torch.minimum(lpref, l),
                      torch.where(pos, torch.minimum(rpref, l), cur))
    cont2 = p2 & (ret != 0) & (hi > lo + 1)

    # ---- phase transitions + next comparison setup ----
    mid = (lo + hi) // 2
    go23 = go2 | cont2
    new_tgt = torch.where(go1, hi, torch.where(go23, mid, tgt))
    start_cmp = go1 | go23
    cstart = torch.where(start_cmp, suftab[new_tgt.to(_I64).clamp(0, n)],
                         cstart)
    l = torch.where(go1, off0, torch.where(go23, cur, l))
    phase_ = torch.where(go1, 1, torch.where(
        go23, 2, torch.where(stopped, _DONE, phase_))).to(_I32)
    return torch.stack([phase_, lo, hi, lpref, rpref, cur, wit0, wit1,
                        new_tgt, cstart, l, off0, qpos, qlen, idx])


def _fmp_round(text, P, suftab, qtext, Pq, state, T: int, n: int, nq: int,
               bits: int, D: int):
    """T trips over the lanes; returns the state and the live count
    (one host read)."""
    for _ in range(T):
        state = _fmp_trip(text, P, suftab, qtext, Pq, state, n, nq, bits, D)
    return state, int((state[_PHASE] < _DONE).sum())


def _fmp_compact(state, res0, res1):
    """Harvest the finished lanes into (res0, res1) by original index and
    keep the live ones."""
    done = state[_PHASE] >= _DONE
    idx = state[_IDX, done].to(_I64)
    res0[idx] = state[_WIT0, done]
    res1[idx] = state[_WIT1, done]
    return state[:, ~done], res0, res1


def _lanes(suftab, n: int, lo, hi, off0, qpos, qlen, idx):
    """Initial lane state: compare the query suffix at qpos against
    suftab[lo] from the certified depth off0."""
    lo = lo.to(_I32)
    z = torch.zeros_like(lo)
    off0 = off0.to(_I32)
    return torch.stack([z, lo, hi.to(_I32), z, z, off0, z, lo, lo,
                        suftab[lo.to(_I64).clamp(0, n)].to(_I32), off0,
                        off0, qpos.to(_I32), qlen.to(_I32), idx.to(_I32)])


def findmaxpref_device(esa, qtext, rl, rr, off0, qpos, qlen, qtabs=None):
    """(maxprefixlen, witness_rank) per lane, host int64 arrays.

    rl/rr: inclusive rank interval per lane; off0: certified common
    prefix depth of the whole interval with the query suffix; qpos:
    query-text position; qlen: remaining sequence length from qpos.
    ``qtabs`` may pass a precomputed :func:`query_tables` result."""
    m = int(rl.size)
    if m == 0:
        z = np.zeros(0, np.int64)
        return z, z
    with phase("findmaxpref"):
        text, P, suftab, bits, D, n = _db_tables(esa)
        if qtabs is None:
            qtabs = query_tables(esa, qtext)
        qdev, Pq, nq = qtabs
        cols = torch.from_numpy(np.stack(
            [rl, rr, off0, qpos, qlen, np.arange(m)]).astype(np.int32)).to(
            P.device)
        state = _lanes(suftab, n, *cols)
        res0 = torch.zeros(m, dtype=_I32, device=P.device)
        res1 = torch.zeros_like(res0)
        M = m
        T = 16
        rounds = trips = 0
        while True:
            state, cnt = _fmp_round(text, P, suftab, qdev, Pq, state, T, n,
                                    nq, bits, D)
            rounds += 1
            trips += T
            if cnt == 0:
                _fmp_compact(state, res0, res1)
                break
            if cnt <= M - M // 4:
                state, res0, res1 = _fmp_compact(state, res0, res1)
                M = cnt
            if T < 256:
                T *= 2
        count("findmaxpref lanes", m)
        count("findmaxpref rounds", rounds)
        count("findmaxpref trips", trips)
        out = torch.stack([res0, res1]).cpu().numpy().astype(np.int64)
    return out[0], out[1]


# ---------------------------------------------------------------------------
# the db-vs-itself MEM pipeline (the -q db-vs-self workload):
# classification -> replay -> witness assembly -> emission.  Mirrors the
# host _ref_witness_state speedup-2 state machine statement for statement.
# ---------------------------------------------------------------------------


def _scan_budget(nq: int) -> int:
    """Hard interval-scan lanes of the pipeline, compacted without a host
    read (the pipeline returns None beyond it)."""
    return max(4096, nq // 2)


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, [0]), 0).values, [0])


def _gallop(table, idx, dep, levels: int, n1: int, right: bool):
    """Left: max s <= idx with lcp[s] < dep; right: (min s > idx with
    lcp[s] < dep) - 1 (dep >= 1 for live lanes).  Gallop the window a
    level up until it holds a qualifying element (or crosses the end of
    the table), then the aligned top-down descent from that level;
    ~2 log2(result width) gathers per lane."""
    tflat = table.reshape(-1)
    m = torch.zeros_like(idx)          # 0 gallop, 1 descend, 2 done
    e = torch.zeros_like(idx)
    t = idx
    for i in range(2 * levels + 4):
        if i % 4 == 0 and not bool((m < 2).any()):
            break
        w = 1 << e
        if right:
            mn = tflat[e * n1 + (t + 1).clamp(0, n1 - 1)]
            found = (t + w > n1 - 1) | (mn < dep)
        else:
            mn = tflat[e * n1 + (t - w + 1).clamp(0, n1 - 1)]
            found = (t - w + 1 < 0) | (mn < dep)
        g = m == 0
        d = m == 1
        m_g = torch.where(found, torch.where(e == 0, 2, 1), 0)
        e_g = torch.where(found, e - 1, e + 1)
        t_d = torch.where(found, t, t + w if right else t - w)
        m_d = torch.where(e == 0, 2, 1)
        m = torch.where(g, m_g, torch.where(d, m_d, m))
        e = torch.where(g, e_g, torch.where(d, e - 1, e)).clamp(0, levels - 1)
        t = torch.where(d, t_d, t)
    return t


def _scan_sparse(table, idx, dep, levels: int, n1: int, H: int,
                 right: bool):
    """Interval-boundary scan with a singleton fast path: lanes whose
    bounding lcp already breaks the threshold answer at once (one
    gather); the others are compacted to H slots without a host read,
    galloped to their end and scattered back.  Returns (answer, a 0-d
    flag that more than H lanes were hard: their answers are wrong)."""
    nq = idx.shape[0]
    dev = idx.device
    col = (idx + 1).clamp(0, n1 - 1) if right else idx.clamp(0, n1 - 1)
    lcp0 = table[0, col]
    if right:
        singleton = (idx + 1 > n1 - 1) | (lcp0 < dep)
    else:
        singleton = lcp0 < dep
    hard = ~singleton
    n_hard = hard.sum()
    dst = torch.cumsum(hard.to(_I64), 0) - 1
    dst = torch.where(hard & (dst < H), dst, H)       # slot H: overflow
    idxh = torch.zeros(H + 1, dtype=_I64, device=dev).scatter_(0, dst, idx)
    deph = torch.full((H + 1,), _BIG, dtype=_I64, device=dev).scatter_(
        0, dst, dep)
    posh = torch.full((H + 1,), nq, dtype=_I64, device=dev).scatter_(
        0, dst, torch.arange(nq, dtype=_I64, device=dev))
    idxh[H], deph[H], posh[H] = 0, _BIG, nq
    th = _gallop(table, idxh, deph, levels, n1, right)
    ans = torch.cat([idx, idx.new_zeros(1)]).scatter_(0, posh, th)[:nq]
    return ans, n_hard > H


def _qself_classify(qtext, suftab, stitab, s1, bck, table, L: int, nq: int,
                    n: int, n1: int, pl: int, sigma: int, levels: int,
                    H: int):
    """Lane setup + fast-path matching statistics + canonical scans +
    fresh/shortcut/iso classification (db == query identical text).

    The central shortcut: a lane whose query suffix has no special
    before its sequence end AND whose depth-maxlen interval is a
    singleton is SAFE: the reference's binary search can only have
    returned the rank of the suffix itself (stitab[qpos]).  Safe lanes
    need no replay, anchor isomorphic chains directly and (when their
    L-run is a singleton too) emit analytically.  Only the unsafe residue
    pays for the replay.  Returns a dict of tensors."""
    dev = qtext.device
    pos = torch.arange(nq, dtype=_I64, device=dev)
    qt = qtext.to(_I64)
    sep = qt == SEPARATOR
    special = qt >= WILDCARD
    nxt_sep = _rev_cummin(torch.where(sep, pos, nq))
    rem = nxt_sep - pos
    lane = rem >= L
    prev_sep = torch.cat([sep.new_ones(1), sep[:-1]])
    seq_start = lane & prev_sep
    ms = _rev_cummin(torch.where(special, pos, nq)) - pos

    # rolling bucket code at depth pl (host bucket_codes semantics:
    # digits from the first special onward are sigma-1)
    padded = torch.cat([qt, qt.new_full((max(pl, 1),), SEPARATOR)])
    fs = torch.full((nq,), pl, dtype=_I64, device=dev)
    code = torch.zeros(nq, dtype=_I64, device=dev)
    for j in range(pl):
        cj = padded[j:j + nq]
        fs = torch.where((cj >= WILDCARD) & (fs > j), j, fs)
        code = code * sigma + torch.where(fs > j, cj, sigma - 1)
    valid = fs >= pl
    bl = bck[2 * code]
    br = bck[2 * code + 1]
    nonempty = lane & valid & (br > bl)
    maxlen = torch.where(nonempty, torch.minimum(ms, rem), 0)
    member = torch.where(nonempty, stitab[:nq].to(_I64), 0)

    dep = torch.where(nonempty, maxlen.clamp(min=1), _BIG)
    ileft, bad0 = _scan_sparse(table, member, dep, levels, n1, H,
                               right=False)
    iright, bad1 = _scan_sparse(table, member, dep, levels, n1, H,
                                right=True)
    # unique at maxlen => the replay is predetermined (see above)
    safe = nonempty & (ileft == iright)

    def shift1(a, fill=0):
        return torch.cat([a.new_full((1,), fill), a[:-1]])

    prev_off = torch.where(seq_start, 0, shift1(maxlen))
    prev_left = shift1(ileft)
    prev_right = shift1(iright)
    prev_ne = shift1(nonempty, False) & ~seq_start
    nxtr = (suftab[torch.where(prev_ne, prev_right, 0)].to(_I64) + 1
            ).clamp(max=n)
    capped = s1[nxtr] == 255
    fresh = nonempty & ((prev_off <= pl) | capped | seq_start)
    shortcut = nonempty & ~fresh
    # the reference's shortcut re-scan reduces to the lane's own
    # maxlen-interval: rankl == ileft, rankr == iright (the JAX module
    # gives the argument, querydev.py:446-459)
    iso = shortcut & (iright - ileft == prev_right - prev_left)
    noniso = shortcut & ~iso
    # a non-iso replay starts at offset maxlen over [ileft, iright] and
    # can never improve on its first probe: its witness is ileft
    replay = fresh & ~safe
    wit0 = torch.where(noniso & ~safe, ileft, member)
    proceed = nonempty & (maxlen >= L)

    # ---- L-run bounds of the member (== witness) rank + the
    # singleton/non-singleton emission split ----
    lcp0 = table[0]
    idxs = torch.arange(n1, dtype=_I64, device=dev)
    small = lcp0 < L
    runleft = torch.cummax(torch.where(small, idxs, -1), 0).values
    nxt = _rev_cummin(torch.where(small, idxs, n1))
    nxt_sh = torch.cat([nxt[1:], nxt.new_full((1,), n1)])
    w = member.clamp(0, n1 - 1)
    A = runleft[w]
    B = (nxt_sh[w] - 1).clamp(max=n1 - 1)
    pp = proceed & (B > A)
    cnt = torch.where(pp, B - A + 1, 0)
    offs = torch.cumsum(cnt, 0) - cnt
    # singleton-run lanes: witness rank == member rank == stitab[qpos],
    # so the single record is (qpos, maxlen, qpos) and the left-
    # maximality filter reduces to "previous query char missing or
    # special"
    prevq = shift1(qt, SEPARATOR)
    s_emit = proceed & (B == A) & (prevq >= WILDCARD)
    return dict(maxlen=maxlen, wit0=wit0, iso=iso, nonempty=nonempty,
                safe=safe, bl=bl, br=br, A=A, B=B, offs=offs, pp=pp,
                s_emit=s_emit, replay=replay, rem=rem, pos=pos,
                total=offs[-1] + cnt[-1], badscan=bad0 | bad1)


def _fmp_stage1(text, P, suftab, state, wacc, T: int, W: int, n: int,
                nq: int, bits: int, D: int):
    """T trips, then harvest the resolved lanes' witnesses into the
    full-width accumulator and keep the live lanes (db-vs-self replay:
    the query side is the db side)."""
    for _ in range(T):
        state = _fmp_trip(text, P, suftab, text, P, state, n, nq, bits, D,
                          W)
    done = state[_PHASE] >= _DONE
    wacc[state[_IDX, done].to(_I64)] = state[_WIT1, done].to(wacc.dtype)
    return state[:, ~done], wacc


def _fmp_finish(text, P, suftab, state, wacc, T: int, W: int, n: int,
                nq: int, bits: int, D: int):
    """Run the survivors to completion, at most T trips, and harvest;
    returns the accumulator and the count left unresolved."""
    for i in range(T):
        if i % 16 == 0 and not bool((state[_PHASE] < _DONE).any()):
            break
        state = _fmp_trip(text, P, suftab, text, P, state, n, nq, bits, D,
                          W)
    done = state[_PHASE] >= _DONE
    wacc[state[_IDX, done].to(_I64)] = state[_WIT1, done].to(wacc.dtype)
    return wacc, int((~done).sum())


def _qself_witness(wacc, iso, nonempty, safe, bl, suftab, stitab, nq: int,
                   n: int):
    """Isomorphic-chain closed form over the harvested witnesses
    (w_{a+k} = inv[suftab[w_a] + k]) + the saturation-failure count.
    Safe lanes keep their predetermined witness and anchor chains."""
    pos = torch.arange(nq, dtype=_I64, device=wacc.device)
    anchor_ok = (safe | ~iso) & nonempty
    last_anchor = torch.cummax(torch.where(anchor_ok, pos, -1), 0).values
    a = last_anchor.clamp(min=0)
    raw = stitab[(suftab[wacc[a]].to(_I64) + (pos - a)).clamp(max=n)].to(
        _I64)
    use = iso & ~safe
    return torch.where(use, raw, wacc), use & (raw - bl >= 255)


def _qself_expand(text, suftab, qtext, table, A, offs, witness, maxlen, pp,
                  E: int, nq: int, n: int, n1: int):
    """The E records of the NON-SINGLETON runs (``pp``; singleton lanes
    emit analytically) in the reference rotation, the left-maximality
    prefilter before the range minima so that only surviving records
    pay for them.  Returns (dbpos, length, lane) of the survivors."""
    dev = offs.device
    lanes = torch.arange(nq, dtype=_I64, device=dev)
    gseed = torch.zeros(E + 1, dtype=_I64, device=dev).scatter_reduce_(
        0, torch.where(pp, offs.clamp(max=E), E), lanes, "amax")
    g = torch.cummax(gseed[:E], 0).values
    step = torch.arange(E, dtype=_I64, device=dev) - offs[g]
    wk = witness[g].clamp(0, n1 - 1)
    Ak = A[g]
    ranks = torch.where(step < wk - Ak + 1, wk - step, Ak + step).clamp(
        0, n1 - 1)
    # left-maximality prefilter.  qoff == 0 (host leftq = 255) implies
    # qtext[g-1] is a separator or g == 0: the same emit outcome
    sufstart = suftab[ranks].to(_I64)
    leftq = torch.where(g == 0, 255,
                        qtext[(g - 1).clamp(0, nq - 1)].to(_I64))
    prevc = text[(sufstart - 1).clamp(0, n - 1)].to(_I64)
    emit = (sufstart == 0) | (leftq >= WILDCARD) | (prevc != leftq)
    c_rank, c_pos, c_g = ranks[emit], sufstart[emit], g[emit]
    # RMQ lengths only for the survivors
    wk2 = witness[c_g].clamp(0, n1 - 1)
    lo_r = torch.minimum(c_rank, wk2)
    hi_r = torch.maximum(c_rank, wk2)
    q_lo = (lo_r + 1).clamp(max=n1 - 1)
    mn = _rmq_query(table, q_lo, torch.maximum(hi_r, q_lo))
    c_len = torch.where(lo_r == hi_r, maxlen[c_g],
                        torch.minimum(maxlen[c_g], mn))
    return c_pos, c_len, c_g


def _sti1_dev(esa):
    """The sti1 byte table (rank within the bucket, saturating at 255)
    on ``esa.dev``, cached."""
    cache = esa._torch_cache
    if "s1" not in cache:
        s1 = getattr(esa, "_sti1_cache", None)
        if s1 is None:
            from ..index.io import sti1_table

            s1 = sti1_table(esa.suftab, esa.lcptab, esa.prefixlength)
            esa._sti1_cache = s1
        cache["s1"] = torch.from_numpy(s1).to(esa.dev)
    return cache["s1"]


def _qself_presync(qtext, suftab, stitab, s1, bck, table, P, L: int,
                   nq: int, n: int, n1: int, pl: int, sigma: int,
                   levels: int, H: int):
    """Classify + replay + witness: everything the emission needs, or
    None when the pipeline cannot answer (the hard scan lanes overflow
    H, a chain step saturates the sti1 byte, a replay does not finish).
    Returns (the classification, the witnesses, the record count)."""
    bits, D = lce_pack_params(sigma)
    c = _qself_classify(qtext, suftab, stitab, s1, bck, table, L, nq, n, n1,
                        pl, sigma, levels, H)
    # host read 1: the scan budget and the record count
    badscan, total = torch.stack([c["badscan"].to(_I64),
                                  c["total"]]).tolist()
    if badscan:
        return None
    # the replay of the fresh, unsafe lanes from their bucket
    ridx = torch.nonzero(c["replay"])[:, 0]
    count("self pipeline replays", int(ridx.numel()))
    state = _lanes(suftab, n, c["bl"][ridx], c["br"][ridx] - 1,
                   torch.full_like(ridx, pl), c["pos"][ridx], c["rem"][ridx],
                   ridx)
    state, wacc = _fmp_stage1(qtext, P, suftab, state, c["wit0"].clone(),
                              12, 1, n, nq, bits, D)
    wacc, nunf = _fmp_finish(qtext, P, suftab, state, wacc, 4096, 4, n, nq,
                             bits, D)
    witness, capfail = _qself_witness(wacc, c["iso"], c["nonempty"],
                                      c["safe"], c["bl"], suftab, stitab,
                                      nq, n)
    if nunf or bool(capfail.any()):
        return None
    return c, witness, total


def find_query_mems_self_device(esa, query, L: int):
    """db-vs-itself -q MEM matching (qspeedup 2) as torch programs;
    returns (dbpos, length, qpos) host arrays in reference emission
    order, or None (the caller takes the general path) when the hard
    scan lanes overflow their budget, a chain step saturates the sti1
    byte or a replay does not finish."""
    from .query import _dev_lcp_rmq

    qtext = query.sequence
    nq = int(qtext.size)
    n = esa.totallength
    table, levels, n1 = _dev_lcp_rmq(esa)
    text_dev, P, suftab, _, _, _ = _db_tables(esa)
    stitab = esa._device32("stitab")
    s1 = _sti1_dev(esa)
    cache = esa._torch_cache
    if "bck" not in cache:
        cache["bck"] = torch.from_numpy(esa.bcktab.astype(np.int64)).to(
            esa.dev)
    with phase("self pipeline"):
        count("self pipeline lanes", nq)
        got = _qself_presync(text_dev, suftab, stitab, s1, cache["bck"],
                             table, P, L, nq, n, n1, esa.prefixlength,
                             esa.alpha.num_regular, levels,
                             _scan_budget(nq))
        if got is None:
            count("self pipeline fallbacks", 1)
            return None
        c, witness, total = got
        if total:
            ns_pos, ns_len, ns_g = _qself_expand(
                text_dev, suftab, text_dev, table, c["A"], c["offs"],
                witness, c["maxlen"], c["pp"], total, nq, n, n1)
        else:
            ns_pos = ns_len = ns_g = c["pos"][:0]
        s = c["s_emit"]
        sp = c["pos"][s]
        host = torch.cat([ns_pos, ns_len, ns_g, sp, c["maxlen"][s]]).cpu(
            ).numpy()
    k, m = ns_pos.numel(), sp.numel()
    ns_pos, ns_len, ns_g = host[:k], host[k:2 * k], host[2 * k:3 * k]
    sp, sl = host[3 * k:3 * k + m], host[3 * k + m:]
    if m == 0:
        return ns_pos, ns_len, ns_g
    # merge the two streams by query position (stable: a lane is
    # singleton XOR non-singleton, per-lane record order is the device
    # order)
    g_all = np.concatenate([ns_g, sp])
    order = np.argsort(g_all, kind="stable")
    return (np.concatenate([ns_pos, sp])[order],
            np.concatenate([ns_len, sl])[order], g_all[order])


# ---------------------------------------------------------------------------
# MEM expansion
# ---------------------------------------------------------------------------


def _mem_bounds(table, w, L: int, levels: int, n1: int):
    """Run bounds [A, B] of the lcp>=L run containing each witness
    (scanleft/scanright descents over the sparse table) + exclusive
    record offsets and the total."""
    t = w
    for e in range(levels - 1, -1, -1):
        lo = t - (1 << e) + 1
        mn = table[e, lo.clamp(0, n1 - 1)]
        t = torch.where((lo >= 0) & (mn >= L), t - (1 << e), t)
    A = t
    t = w
    nmax = n1 - 1
    for e in range(levels - 1, -1, -1):
        mn = table[e, (t + 1).clamp(0, n1 - 1)]
        t = torch.where((t + (1 << e) <= nmax) & (mn >= L), t + (1 << e), t)
    B = t
    cnt = B - A + 1
    offs = torch.cumsum(cnt, 0) - cnt
    return A, B, offs, offs[-1] + cnt[-1]


def _mem_expand(text, suftab, qtext, table, A, offs, w, maxlcp, qp, qo,
                E: int, K: int, n: int, nq: int, n1: int):
    """Expand K witness runs into E (rank, dbpos, length) records in the
    reference emission rotation (witness..A descending, then
    witness+1..B), RMQ lengths, left-maximality filtered (PROCESSSUFFIX
    fquery.c:53-81).  Returns (dbpos, length, lane) of the survivors."""
    dev = w.device
    # group id per record slot via boundary scatter + running max
    gseed = torch.zeros(E + 1, dtype=_I64, device=dev).scatter_reduce_(
        0, offs.clamp(max=E), torch.arange(K, dtype=_I64, device=dev),
        "amax")
    g = torch.cummax(gseed[:E], 0).values
    step = torch.arange(E, dtype=_I64, device=dev) - offs[g]
    wk = w[g]
    Ak = A[g]
    ranks = torch.where(step < wk - Ak + 1, wk - step, Ak + step).clamp(
        0, n1 - 1)
    # match length = min(maxlcp, min lcp over (min(r,w), max(r,w)])
    lo_r = torch.minimum(ranks, wk)
    hi_r = torch.maximum(ranks, wk)
    q_lo = (lo_r + 1).clamp(max=n1 - 1)
    mn = _rmq_query(table, q_lo, torch.maximum(hi_r, q_lo))
    mlen = torch.where(lo_r == hi_r, maxlcp[g], torch.minimum(maxlcp[g], mn))
    # left-maximality
    sufstart = suftab[ranks].to(_I64)
    qpg = qp[g]
    leftq = torch.where(qo[g] > 0, qtext[(qpg - 1).clamp(0, nq - 1)].to(
        _I64), 255)
    prevc = text[(sufstart - 1).clamp(0, n - 1)].to(_I64)
    emit = (sufstart == 0) | (leftq >= WILDCARD) | (prevc != leftq)
    return sufstart[emit], mlen[emit], g[emit]


def mem_expand_device(esa, qtext, witness, maxlcp, qpos, qoff, L: int):
    """Reference-order MEM record expansion on the index's device;
    returns host (dbpos, length, lane_index) arrays, left-maximality
    filtered."""
    from .query import _dev_lcp_rmq

    K = int(witness.size)
    if K == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    with phase("mem expand"):
        table, levels, n1 = _dev_lcp_rmq(esa)
        text, _, suftab, _, _, n = _db_tables(esa)
        qdev = torch.from_numpy(np.ascontiguousarray(qtext)).to(esa.dev)
        w, mx, qp, qo = torch.from_numpy(np.stack(
            [witness, maxlcp, qpos, qoff]).astype(np.int64)).to(esa.dev)
        A, _, offs, total = _mem_bounds(table, w, L, levels, n1)
        E = int(total)
        count("mem records", E)
        out = _mem_expand(text, suftab, qdev, table, A, offs, w, mx, qp, qo,
                          E, K, n, int(qtext.size), n1)
        k = out[0].numel()
        host = torch.cat(out).cpu().numpy()
    return host[:k], host[k:2 * k], host[2 * k:]

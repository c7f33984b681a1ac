"""Query substring matching: MEMs and MUM candidates vs an indexed DB
(vmatch -q, reference src/Vmengine/fquery.c + src/kurtz/matchsub.c), on
the index's device.  Port of :mod:`vstree_tpu.engine.query`, whose
docstring gives the reformulation.

The host state machine (``_ref_witness_state``, the reference's speedup
0/2/5 witness rules with the sti1 byte-saturation fix-up) stays NumPy,
statement for statement; what it asks of the device runs as torch
programs on ``esa.dev``:

- the maximal-prefix searches (engine/querydev.py ``findmaxpref_device``)
  or the merged-sort matching statistics (engine/mstats.py), chosen by
  the same sampled cost model and constants as the JAX module;
- the scanleft/scanright descents over a sparse range-min table of the
  lcp array that holds only the levels an lcp >= prefixlength run needs:
  every descent here runs at a depth >= prefixlength, so it never leaves
  such a run (repeats_dev ``_rmq_build``);
- the MEM expansion (``mem_expand_device``) and the db-vs-itself
  pipeline (``find_query_mems_self_device``).

The JAX module's ``VSTREE_HOST_QUERY`` switch and its host MEM expansion
have no counterpart: the torch programs always run, and the JAX host path
is the tests' oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.chardef import WILDCARD
from ..core.multiseq import Multiseq
from ..device import phase
from ..index.build import bucket_codes
from ..index.esa import ESA
from .match import FLAGQUERY, MatchTable

_SPECIAL = 1 << 20


def _query_positions(query: Multiseq, searchlength: int):
    """Flattened (qpos, qseq, qoff, rem) for every query offset with
    remaining length >= searchlength (matchsub.c loop bounds)."""
    pos_l, seq_l, off_l, rem_l = [], [], [], []
    for s in range(query.numofsequences):
        a, b = query.seq_bounds(s)
        ln = b - a
        if ln < searchlength:
            continue
        m = ln - searchlength + 1
        pos_l.append(np.arange(a, a + m, dtype=np.int64))
        seq_l.append(np.full(m, s, np.int64))
        off_l.append(np.arange(m, dtype=np.int64))
        rem_l.append(ln - np.arange(m, dtype=np.int64))
    if not pos_l:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    return (np.concatenate(pos_l), np.concatenate(seq_l),
            np.concatenate(off_l), np.concatenate(rem_l))


def _compare_batch(text, n, sstart, qtext, qpos, querylen, lcplen0):
    """COMPARE (maxpref.c:30-66) vectorized over probes: compare
    query suffixes (qpos, length querylen) against db suffixes
    (sstart) starting at common-prefix length lcplen0; returns
    (sign, final lcplen).  Equal specials and running past the
    sentinel compare as -1; exhausting the query as 0."""
    m = sstart.size
    ret = np.zeros(m, np.int64)
    lcp = lcplen0.astype(np.int64).copy()
    done = np.zeros(m, bool)
    qn = qtext.size
    w = 32
    while not done.all():
        act = np.flatnonzero(~done)
        offs = np.arange(w)
        qi = qpos[act, None] + lcp[act, None] + offs[None, :]
        si = sstart[act, None] + lcp[act, None] + offs[None, :]
        q_over = (qi - qpos[act, None]) >= querylen[act, None]
        s_over = si >= n
        qc = qtext[np.minimum(qi, qn - 1)].astype(np.int64)
        sc = text[np.minimum(si, n - 1)].astype(np.int64)
        both_sp = (qc >= WILDCARD) & (sc >= WILDCARD)
        neq = qc != sc
        stop = q_over | s_over | neq | both_sp
        val = np.where(
            q_over, 0,
            np.where(s_over, -1,
                     np.where(neq, np.sign(qc - sc), -1)))
        first = np.argmax(stop, axis=1)
        any_stop = stop.any(axis=1)
        adv = np.where(any_stop, first, w)
        lcp[act] += adv
        hitv = np.take_along_axis(val, first[:, None], 1)[:, 0]
        fin = act[any_stop]
        ret[fin] = hitv[any_stop]
        done[fin] = True
        if w < 1024:
            w *= 2
    return ret, lcp


def _dev_lcp_rmq(esa):
    """Sparse range-min table over the db lcp array on ``esa.dev``
    (cached): (table, levels, n1).  The levels are those the widest run
    of lcp >= prefixlength needs, which bounds every descent and range of
    this module (all run at a depth >= prefixlength)."""
    cache = esa._torch_cache
    if "lcp_rmq" not in cache:
        from .repeats_dev import _rmq_build, _rmq_levels, _runs

        lcp = esa.device_lcp32()
        left, right = _runs(lcp, esa.prefixlength)
        widest = int((right - left + 1).max()) if left.numel() else 1
        levels = _rmq_levels(widest)
        cache["lcp_rmq"] = (_rmq_build(lcp, levels), levels,
                            int(lcp.numel()))
    return cache["lcp_rmq"]


def _scan_left_dev(table, idx, depth, levels: int, n1: int):
    """scanleft (matchsub.c:59-72): max s in (0, idx] with
    lcp[s] < depth, else 0; aligned-window descent, one gather per
    level (lcp[0] == 0 < depth bounds the walk)."""
    t = idx
    for e in range(levels - 1, -1, -1):
        lo = t - (1 << e) + 1
        mn = table[e, lo.clamp(0, n1 - 1)]
        t = torch.where((lo >= 0) & (mn >= depth), t - (1 << e), t)
    return t


def _scan_right_dev(table, idx, depth, levels: int, n1: int):
    """scanright (matchsub.c:89-102): (min s > idx with lcp[s] < depth)
    - 1; aligned-window descent (lcp[n] == 0 bounds the walk)."""
    t = idx
    nmax = n1 - 1
    for e in range(levels - 1, -1, -1):
        mn = table[e, (t + 1).clamp(0, n1 - 1)]
        t = torch.where((t + (1 << e) <= nmax) & (mn >= depth),
                        t + (1 << e), t)
    return t


def _scan_batch(esa, idx, depth, scan):
    if idx.size == 0:
        return np.zeros(0, np.int64)
    with phase("interval scans"):
        table, levels, n1 = _dev_lcp_rmq(esa)
        i, d = torch.from_numpy(np.stack([idx, depth]).astype(
            np.int64)).to(esa.dev)
        return scan(table, i, d, levels, n1).cpu().numpy()


def _scan_left_batch(esa, idx, depth):
    return _scan_batch(esa, idx, depth, _scan_left_dev)


def _scan_right_batch(esa, idx, depth):
    return _scan_batch(esa, idx, depth, _scan_right_dev)


def _ref_witness_state(esa: ESA, query: Multiseq, searchlength: int,
                       qpos, qseq, qoff, rem, qspeedup: int):
    """The reference's per-query-position state machine
    (matchquerysubstring2, matchsub.c:353-539 / speedup 0
    matchsub.c:165-236): for every scan position compute the maximal
    match length, the canonical lcp-interval and the exact witness
    rank the reference's emission rotates around.

    All interval/length values are canonical (checkvnode,
    matchsub.c:132-160 asserts this in the reference's DEBUG build),
    so they vectorize position-independently; only the witness is
    history-dependent.  Its isomorphic-shortcut chains have the
    closed form w_{a+k} = inv[suftab[w_a] + k] (the rank-successor
    map psi applied k times), breaking only at the sti1 byte
    saturation, which is handled by a sequential fixup."""
    text = esa.text
    n = esa.totallength
    suftab = esa.suftab.astype(np.int64)
    lcp = esa.lcptab
    pl = esa.prefixlength
    numofchars = esa.alpha.num_regular
    qtext = query.sequence
    m = qpos.size

    qcodes, qvalid = bucket_codes(qtext, numofchars, pl)
    valid = qvalid[qpos] == pl
    codes = np.where(valid, qcodes[qpos], 0)
    bck = esa.bcktab if esa.bcktab is not None else esa.aux_bck(pl)
    bl = bck[2 * codes].astype(np.int64)
    br = bck[2 * codes + 1].astype(np.int64)
    nonempty = valid & (br > bl)

    # canonical maxlen + a witness member.  Identical-text db-vs-self
    # queries short-circuit in matching_statistics; otherwise the
    # bucket-accelerated device binary search (engine/querydev.py —
    # the reference's own findmaxprefixlen, fused over all positions)
    # reuses the PREBUILT index, total work Theta(sum ms / chars-per-
    # word).  Self-similar db/query pairs where that sum explodes
    # (detected by a sampled probe) fall back to the merged-ordering
    # matching statistics (engine/mstats.py, Theta((n+q) log)).
    from .querydev import findmaxpref_device, query_tables

    k_idx = np.flatnonzero(nonempty)
    maxlen = np.zeros(m, np.int64)
    member = np.zeros(m, np.int64)
    member_is_search_witness = False
    qtabs = None
    if k_idx.size:
        if qtext is esa.text or (qtext.size == esa.totallength
                                 and np.array_equal(qtext, esa.text)):
            from .mstats import matching_statistics
            from .querydev import _db_tables

            ms_all, wit_all = matching_statistics(esa, qtext)
            maxlen[k_idx] = np.minimum(ms_all[qpos[k_idx]],
                                       rem[k_idx])
            member[k_idx] = wit_all[qpos[k_idx]]
            # the query text IS the db text: replays reuse the db's
            # packed-word tables instead of building query-side ones
            text_dev, P, _suf, _b, _D, n_db = _db_tables(esa)
            qtabs = (text_dev, P, n_db)
        else:
            qtabs = query_tables(esa, qtext)
            use_merged = False
            SAMPLE = 2048
            if k_idx.size > 8 * SAMPLE:
                stride = k_idx.size // SAMPLE
                sel = k_idx[::stride]
                s0, _ = findmaxpref_device(
                    esa, qtext, bl[sel], br[sel] - 1,
                    np.full(sel.size, pl, np.int64), qpos[sel],
                    rem[sel], qtabs=qtabs)
                # cost model in gather units: insertion search pays
                # ~8 gathers per word step per lane; the merged sort
                # pays ~60 per merged-text element (lax.sort rounds)
                from ..index.sort import lce_pack_params

                _, D = lce_pack_params(esa.alpha.num_regular)
                ins = 8.0 * k_idx.size * (float(s0.mean()) / D + 20)
                merged = 60.0 * (esa.totallength + qtext.size)
                use_merged = ins > merged
            if use_merged:
                from .mstats import matching_statistics

                ms_all, wit_all = matching_statistics(esa, qtext)
                maxlen[k_idx] = np.minimum(ms_all[qpos[k_idx]],
                                           rem[k_idx])
                member[k_idx] = wit_all[qpos[k_idx]]
            else:
                d0, d1 = findmaxpref_device(
                    esa, qtext, bl[k_idx], br[k_idx] - 1,
                    np.full(k_idx.size, pl, np.int64), qpos[k_idx],
                    rem[k_idx], qtabs=qtabs)
                maxlen[k_idx] = d0
                member[k_idx] = d1
                # d1 IS the reference's search witness for a fresh
                # (bucket, offset=pl) replay — the exact call the
                # speedup-0/fresh paths below would repeat
                member_is_search_witness = True
    offset = np.where(nonempty, maxlen, 0)

    ileft = np.zeros(m, np.int64)
    iright = np.zeros(m, np.int64)
    if k_idx.size:
        dep = np.maximum(maxlen[k_idx], 1)
        ileft[k_idx] = _scan_left_batch(esa, member[k_idx], dep)
        iright[k_idx] = _scan_right_batch(esa, member[k_idx], dep)

    proceed = nonempty & (maxlen >= searchlength)
    witness = member.copy()
    if qspeedup in (0, 5):
        # speedup 0 (matchsub.c:165-236): a fresh findmaxprefixlen
        # replay from the bucket at every position; speedup 5
        # (matchsub.c:963-1036) replays the same walk over the WHOLE
        # suffix array (its table demand is empty, mapdemand.c:8-39)
        fi = np.flatnonzero(proceed)
        if fi.size:
            if qspeedup == 0 and member_is_search_witness:
                # the canonical member came from the identical
                # (bucket, offset=pl) device search — no replay needed
                witness[fi] = member[fi]
            else:
                if qspeedup == 5:
                    # matchsub.c:992-1005: vnode = [0, totallength-1]
                    # (sentinel rank excluded), offset 0
                    rl = np.zeros(fi.size, np.int64)
                    rr = np.full(fi.size, int(suftab.size) - 2,
                                 np.int64)
                    off0 = np.zeros(fi.size, np.int64)
                else:
                    rl = bl[fi]
                    rr = br[fi] - 1
                    off0 = np.full(fi.size, pl, np.int64)
                w0, w1 = findmaxpref_device(
                    esa, qtext, rl, rr, off0, qpos[fi], rem[fi],
                    qtabs=qtabs)
                witness[fi] = w1
    else:
        # sti1 byte table (saturating rank-within-bucket) + inverse
        s1 = getattr(esa, "_sti1_cache", None)
        if s1 is None:
            from ..index.io import sti1_table

            s1 = sti1_table(esa.suftab, lcp, pl)
            esa._sti1_cache = s1
        inv = esa.stitab
        if inv is None:
            inv = np.empty(suftab.size, np.int64)
            inv[suftab] = np.arange(suftab.size, dtype=np.int64)
            esa.stitab = inv
        inv = inv.astype(np.int64)

        seq_start = np.empty(m, bool)
        seq_start[0] = True
        if m > 1:
            seq_start[1:] = qseq[1:] != qseq[:-1]
        prev_off = np.roll(offset, 1)
        prev_off[seq_start] = 0
        prev_right = np.roll(iright, 1)
        prev_left = np.roll(ileft, 1)
        prev_ne = np.roll(nonempty, 1)
        prev_ne[seq_start] = False
        nxt = np.minimum(suftab[np.where(prev_ne, prev_right, 0)] + 1,
                         suftab.size - 1)
        capped = s1[nxt] == 255
        fresh = nonempty & ((prev_off <= pl) | capped | seq_start)
        shortcut = nonempty & ~fresh
        iso = np.zeros(m, bool)
        rankl = np.zeros(m, np.int64)
        rankr = np.zeros(m, np.int64)
        si = np.flatnonzero(shortcut)
        if si.size:
            d1 = prev_off[si] - 1
            startl = np.minimum(
                bl[si] + s1[np.minimum(suftab[prev_left[si]] + 1,
                                       suftab.size - 1)],
                lcp.size - 1)
            startr = np.minimum(
                bl[si] + s1[np.minimum(suftab[prev_right[si]] + 1,
                                       suftab.size - 1)],
                lcp.size - 1)
            rankl[si] = _scan_left_batch(esa, startl, d1)
            rankr[si] = _scan_right_batch(esa, startr, d1)
            iso[si] = (rankr[si] - rankl[si]
                       == prev_right[si] - prev_left[si])

        noniso = shortcut & ~iso
        # witnesses: replay for fresh and non-isomorphic shortcuts —
        # ALL of them, not just emitting ones: any non-isomorphic
        # position with a bucket can anchor a later isomorphic chain
        if member_is_search_witness:
            # fresh replays are the identical (bucket, offset=pl)
            # search the member already came from
            witness[fresh] = member[fresh]
            rep_idx, rep_l, rep_r, rep_o = [], [], [], []
        else:
            fi = np.flatnonzero(fresh)
            rep_idx = [fi]
            rep_l = [bl[fi]]
            rep_r = [br[fi] - 1]
            rep_o = [np.full(fi.size, pl, np.int64)]
        ni = np.flatnonzero(noniso)
        rep_idx.append(ni)
        rep_l.append(rankl[ni])
        rep_r.append(rankr[ni])
        rep_o.append(prev_off[ni] - 1)
        ridx = np.concatenate(rep_idx)
        if ridx.size:
            w0, w1 = findmaxpref_device(
                esa, qtext, np.concatenate(rep_l),
                np.concatenate(rep_r), np.concatenate(rep_o),
                qpos[ridx], rem[ridx], qtabs=qtabs)
            witness[ridx] = w1
        # isomorphic chains: witness = inv[suftab[w_anchor] + k]
        ii = np.flatnonzero(iso)
        if ii.size:
            anchor_ok = ~iso & nonempty
            pidx = np.arange(m, dtype=np.int64)
            last_anchor = np.maximum.accumulate(
                np.where(anchor_ok, pidx, -1))
            a = last_anchor[ii]
            dist = ii - a
            wsrc = witness[a]
            raw = inv[np.minimum(suftab[wsrc] + dist,
                                 suftab.size - 1)]
            witness[ii] = raw
            # byte saturation fixup: a chain step whose
            # rank-within-bucket reaches 255 diverges from the closed
            # form (matchsub.c RANKOFNEXTLEAF1 is the saturated byte)
            capfail = (raw - bl[ii]) >= 255
            if capfail.any():
                bad = set()
                first_bad = {}
                for j in ii[capfail]:
                    aj = int(last_anchor[j])
                    if aj not in first_bad or j < first_bad[aj]:
                        first_bad[aj] = int(j)
                for aj, j0 in first_bad.items():
                    w = int(witness[j0 - 1]) if j0 - 1 != aj else \
                        int(witness[aj])
                    p = j0
                    while p < m and iso[p] and last_anchor[p] == aj:
                        nx = min(int(suftab[w]) + 1,
                                 int(suftab.size) - 1)
                        w = int(bl[p]) + int(s1[nx])
                        w = min(w, lcp.size - 1)
                        witness[p] = w
                        p += 1

    return proceed, maxlen, witness


def find_query_matches(
    esa: ESA,
    query: Multiseq,
    searchlength: int,
    mode: str = "mem",          # "mem" | "mumcand" | "mum"
    flags_extra: int = 0,
    qspeedup: int = 2,
) -> MatchTable:
    """All maximal substring matches (or MUM candidates) of every
    query sequence vs the index, length >= searchlength."""
    n = esa.totallength
    numofchars = esa.alpha.num_regular
    text = esa.text
    qtext = query.sequence
    nq = int(qtext.size)
    if searchlength < esa.prefixlength:
        raise ValueError(
            f"searchlength={searchlength} must be >= prefixlength="
            f"{esa.prefixlength}"
        )

    if (mode == "mem" and qspeedup == 2
            and esa.bcktab is not None and esa.stitab is not None
            and esa.lcptab is not None and nq == n
            and (qtext is esa.text
                 or np.array_equal(qtext, esa.text))):
        # db-vs-itself MEM scan: the device pipeline of
        # engine/querydev.py (three host reads)
        from .querydev import find_query_mems_self_device

        recs = find_query_mems_self_device(esa, query, searchlength)
        if recs is not None:
            pos_d, len_d, qp_d = recs
            with phase("emit"):
                qs_d, qo_d = query.pos_to_pair(qp_d)
                return _emit_prefiltered(esa, pos_d, len_d, qs_d, qo_d,
                                         qp_d, flags_extra)

    with phase("query positions"):
        qpos, qseq, qoff, rem = _query_positions(query, searchlength)
    if qpos.size == 0:
        return MatchTable()

    # reference state machine: canonical intervals + the exact
    # emission witness (speedup 2 by default, matchsub.c:353-539);
    # its phase is the host part, the device calls time themselves
    with phase("witness state"):
        proceed, maxlen, wit_all = _ref_witness_state(
            esa, query, searchlength, qpos, qseq, qoff, rem, qspeedup)
    hit = proceed
    if not hit.any():
        return MatchTable()
    witness = wit_all[hit]
    maxlcp = maxlen[hit]
    qpos_h = qpos[hit]
    qseq_h = qseq[hit]
    qoff_h = qoff[hit]

    lcp = esa.lcptab
    if mode in ("mumcand", "mum"):
        # uniqueness of the witness at depth maxlcp
        # (leftrightmaximaluniquematch, fquery.c:297-360)
        left_ok = lcp[witness] < maxlcp
        n1 = lcp.size
        right_lcp = np.where(witness + 1 < n1, lcp[np.minimum(witness + 1, n1 - 1)], 0)
        right_ok = right_lcp < maxlcp
        uniq = left_ok & right_ok
        ranks = witness[uniq]
        mlens = maxlcp[uniq]
        qp = qpos_h[uniq]
        qs = qseq_h[uniq]
        qo = qoff_h[uniq]
        order = None
        with phase("emit"):
            mt = _emit(esa, query, ranks, mlens, qp, qs, qo, flags_extra)
        if mode == "mum":
            mt = _unique_in_query(mt, query)
        return mt

    # --- MEM emission: scan range = lcp>=L run containing witness ---
    from .querydev import mem_expand_device

    pos_d, len_d, g_d = mem_expand_device(
        esa, qtext, witness, maxlcp, qpos_h, qoff_h, searchlength)
    with phase("emit"):
        return _emit_prefiltered(
            esa, pos_d, len_d, qseq_h[g_d], qoff_h[g_d], qpos_h[g_d],
            flags_extra)


def _emit_prefiltered(esa, sufstart, mlens, qs, qo, qp, flags_extra):
    """MatchTable build from already-left-maximality-filtered device
    records (the device twin of :func:`_emit`'s tail)."""
    tot = sufstart.size
    if tot == 0:
        return MatchTable()
    sufstart = sufstart.astype(np.int64)
    mlens = mlens.astype(np.int64)
    seq1, rel1 = esa.multiseq.pos_to_pair(sufstart)
    return MatchTable(
        length1=mlens,
        position1=sufstart,
        length2=mlens.copy(),
        position2=qp.astype(np.int64),
        distance=np.zeros(tot, np.int64),
        flag=np.full(tot, FLAGQUERY | flags_extra, np.int64),
        seqnum1=seq1,
        relpos1=rel1,
        seqnum2=qs.astype(np.int64),
        relpos2=qo.astype(np.int64),
        evalue=np.zeros(tot, np.float64),
        idnumber=np.zeros(tot, np.int64),
        transnum=np.full(tot, -1, np.int64),
    )


def _emit(esa, query, ranks, mlens, qp, qs, qo, flags_extra):
    """Left-maximality filter + MatchTable build
    (PROCESSSUFFIX fquery.c:53-81 + processexactquerymatch
    procexqu.c:17-62)."""
    if ranks.size == 0:
        return MatchTable()
    text = esa.text
    qtext = query.sequence
    sufstart = esa.suftab[ranks].astype(np.int64)
    leftq = np.where(qo > 0, qtext[np.maximum(qp - 1, 0)], 255)
    emit = (
        (sufstart == 0)
        | (leftq >= WILDCARD)
        | (text[np.maximum(sufstart - 1, 0)] != leftq)
    )
    sufstart = sufstart[emit]
    mlens = mlens[emit].astype(np.int64)
    qs = qs[emit].astype(np.int64)
    qo = qo[emit].astype(np.int64)
    qp = qp[emit].astype(np.int64)
    tot = sufstart.size
    ms = esa.multiseq
    seq1, rel1 = ms.pos_to_pair(sufstart)
    return MatchTable(
        length1=mlens,
        position1=sufstart,
        length2=mlens.copy(),
        position2=qp,
        distance=np.zeros(tot, np.int64),
        flag=np.full(tot, FLAGQUERY | flags_extra, np.int64),
        seqnum1=seq1,
        relpos1=rel1,
        seqnum2=qs,
        relpos2=qo,
        evalue=np.zeros(tot, np.float64),
        idnumber=np.zeros(tot, np.int64),
        transnum=np.full(tot, -1, np.int64),
    )


def _unique_in_query(mt: MatchTable, query: Multiseq) -> MatchTable:
    """mumuniqueinquery (reference kurtz/cleanMUMcand.c:57-115):
    candidates sorted by (dbstart asc, length desc); a running maximal
    db-interval right end drops contained candidates; equal right ends
    with equal dbstart drop both copies.  Survivors are emitted in the
    sorted order (the reference's global post-pass after all query
    sequences, fquery.c:480-489)."""
    if len(mt) == 0:
        return mt
    order = np.lexsort((-mt.length1, mt.position1))
    s = mt.select(order)
    pos = s.position1
    ln = s.length1
    # the running dbright equals the prefix max of right ends (dropped
    # candidates never exceed it), so the loop vectorizes: keep iff
    # strictly past the prefix max; an equal right end additionally
    # drops an immediately preceding kept copy at the same dbstart
    right = pos + ln - 1
    prefmax = np.concatenate(
        [[0], np.maximum.accumulate(right)[:-1]])
    keep = right > prefmax
    eq = right == prefmax
    drop_prev = np.zeros(len(s), bool)
    if len(s) > 1:
        drop_prev[:-1] = eq[1:] & (pos[:-1] == pos[1:]) & keep[:-1]
    keep &= ~drop_prev
    return s.select(keep)

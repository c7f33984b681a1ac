"""Enhanced-suffix-array construction on one device (port of
:mod:`vstree_tpu.index.build`, single-device path).

The sort and LCP core is :mod:`vstree_tpu_torch.index.sort`; this
module holds the build orchestration (mkvprocess.c:875-1089): the
derived tables bwt, bck and skp, and the ESA assembly.  The bucket
table is made on the device (:func:`bck_table_device`, torch ops);
``bwt_table``, ``bucket_codes`` and ``bck_table`` are NumPy, the port's
own copies of the JAX module's (which imports jax at its top), and the
latter two are the plain twins the tests hold the device form against.

``build_suf_out_of_core`` sorts shards on the device and merges them
there (:mod:`vstree_tpu_torch.index.merge`); its lcp pass is the
packed-word ladder on the device in chunks of pairs, where the JAX
module compares windows on the host.

With a ``mesh`` (:mod:`vstree_tpu_torch.parallel`) of more than one
shard, ``build_esa`` sorts with ``suffix_sort_sharded`` and takes the
lcp table from the mesh path of ``lcp_from_pairs``: the pairs split
over the shards, windowed rounds of ``_lcp_round`` there, the compacted
straggler rounds on the first local shard's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.alphabet import Alphabet
from ..core.chardef import UNDEFBWTCHAR, WILDCARD
from ..core.multiseq import Multiseq

from ..device import count, phase
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
                mesh=None, device) -> tuple[np.ndarray, np.ndarray]:
    """(suftab, stitab), int32 [n+1]: ``suftab[r]`` = start of the
    rank-r suffix (``suftab[n] = n``, the sentinel) and its inverse.
    With ``mesh`` (more than one shard) every O(n) array is split over
    its shards (parallel/shardesa.py)."""
    if mesh is not None and np.prod(list(mesh.shape.values())) > 1:
        from ..parallel.shardesa import suffix_sort_sharded

        return suffix_sort_sharded(text_np, mesh)
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
    characters (bytes equal and regular: specials never match): the
    rounds of the mesh path of ``lcp_from_pairs``."""
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


_LCP_WINDOW_ELEMS = 1 << 25  # pair x window elements a mesh round holds


def lcp_from_pairs(text_np: np.ndarray, a_np: np.ndarray,
                   b_np: np.ndarray, mesh=None, *, device) -> np.ndarray:
    """Longest common prefix of suffix pairs (a[i], b[i]).

    Without ``mesh``: the packed-word ladder on ``device``.  With
    ``mesh`` the pairs are split over its shards (embarrassingly
    pair-parallel windowed compare, in chunks of at most
    ``_LCP_WINDOW_ELEMS`` window elements), and the few deep stragglers
    finish in compacted rounds on the first local shard's device."""
    n = int(text_np.size)
    m = int(a_np.size)
    if m == 0:
        return np.zeros(0, np.int32)
    if mesh is None:
        from .sort import lce_pairs_host

        return lce_pairs_host(text_np, a_np, b_np, device=device)
    from ..parallel.mesh import collect, psum
    from ..parallel.shardesa import _flat_mesh, flat_spec

    fm = _flat_mesh(mesh)
    mpad = ((m + fm.size - 1) // fm.size) * fm.size
    if mpad != m:
        # pad pairs with (0, n): the out-of-range side makes the pair
        # mismatch immediately (lcp 0, inactive after round 1)
        a_np = np.concatenate([a_np, np.zeros(mpad - m, a_np.dtype)])
        b_np = np.concatenate([b_np, np.full(mpad - m, n, b_np.dtype)])
    # the windows read text[min(idx, n - 1)]: an empty text, one byte
    texts = fm.replicate(text_np if n else np.full(1, WILDCARD, np.uint8))
    spec = flat_spec(fm, mpad)
    a = [torch.from_numpy(a_np[s].astype(np.int32)).to(t.device)
         for s, t in zip(spec, texts)]
    b = [torch.from_numpy(b_np[s].astype(np.int32)).to(t.device)
         for s, t in zip(spec, texts)]
    lcp = [torch.zeros_like(x) for x in a]
    active = [torch.ones_like(x, dtype=torch.bool) for x in a]
    w = 32
    # device rounds while a meaningful fraction of pairs is active
    for _ in range(8):
        step = max(1, _LCP_WINDOW_ELEMS // w)
        for j, t in enumerate(texts):
            for c in range(0, a[j].numel(), step):
                at = slice(c, c + step)
                lcp[j][at], active[j][at] = _lcp_round(
                    t, a[j][at], b[j][at], lcp[j][at], active[j][at], w, n)
        n_active = int(psum(fm, [x.sum().reshape(1) for x in active],
                            "x")[0])
        if n_active == 0:
            return collect(fm, lcp)[:m]
        if n_active < max(1024, m // 256):
            break
        if w < 256:
            w *= 2
    # finish the deep stragglers with compacted rounds: gather the
    # still-active pairs into a small array and keep widening the
    # comparison window
    lcp_h = collect(fm, lcp)
    act_idx = np.flatnonzero(collect(fm, active))
    text = texts[0]
    dev = text.device
    while act_idx.size:
        sub_lcp = torch.from_numpy(lcp_h[act_idx]).to(dev)
        sub_a = torch.from_numpy(a_np[act_idx].astype(np.int32)).to(dev)
        sub_b = torch.from_numpy(b_np[act_idx].astype(np.int32)).to(dev)
        w2 = min(4096, max(w, 256))
        sub_lcp, sub_active = _lcp_round(
            text, sub_a, sub_b, sub_lcp,
            torch.ones(act_idx.size, dtype=torch.bool, device=dev), w2, n)
        lcp_h[act_idx] = sub_lcp.cpu().numpy()
        act_idx = act_idx[sub_active.cpu().numpy()]
        w = w2 * 2
    return lcp_h[:m]


def lcp_table(text_np: np.ndarray, suftab: np.ndarray, mesh=None, *,
              device) -> np.ndarray:
    """lcp[r] = lcp(suffix at rank r-1, suffix at rank r); lcp[0] = 0;
    int32 [n+1]."""
    n = int(text_np.size)
    lcp = np.zeros(n + 1, np.int32)
    if n >= 1:
        lcp[1:] = lcp_from_pairs(text_np, suftab[:-1], suftab[1:],
                                 mesh=mesh, device=device)
    return lcp


# ---------------------------------------------------------------------------
# derived tables
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


def bucket_codes_device(text: torch.Tensor, numofchars: int,
                        prefixlength: int):
    """:func:`bucket_codes` in torch ops on the device of ``text``
    (uint8 [n]): int32 codes of the suffixes 0..n and the depth of the
    first special, equal to the NumPy twin's in every element.  One
    pass per prefix char over shifted views of the padded text; codes
    stay int32 (``numofchars**prefixlength`` must fit)."""
    pl = prefixlength
    if numofchars ** pl >= 1 << 31:
        raise ValueError(f"bucket codes of {numofchars}^{pl} do not fit "
                         "int32")
    n = int(text.numel())
    # the sentinel and everything behind it count as special
    padded = torch.cat([text, text.new_full((pl,), WILDCARD)])
    depth = torch.full((n + 1,), pl, dtype=torch.int32, device=text.device)
    for j in range(pl - 1, -1, -1):  # the smallest j with a special wins
        depth = torch.where(padded[j:j + n + 1] >= WILDCARD, j, depth)
    code = torch.zeros(n + 1, dtype=torch.int32, device=text.device)
    for j in range(pl):
        code *= numofchars
        code += torch.where(depth > j, padded[j:j + n + 1].to(torch.int32),
                            numofchars - 1)
    return code, depth


def bck_table_device(text: torch.Tensor, numofchars: int,
                     prefixlength: int) -> torch.Tensor:
    """:func:`bck_table` on the device of ``text`` (uint8 [n]): int64
    [2 * numofcodes], ``bck[2c] = left``, ``bck[2c+1] = mid``, equal to
    the NumPy twin's (there uint32) in every element."""
    numofcodes = numofchars ** prefixlength
    code, depth = bucket_codes_device(text, numofchars, prefixlength)
    hist_all = torch.bincount(code, minlength=numofcodes)
    # suffixes with a special inside the prefix count in an extra bin
    code = torch.where(depth == prefixlength, code, numofcodes)
    hist_full = torch.bincount(code, minlength=numofcodes + 1)[:numofcodes]
    left = torch.cumsum(hist_all, 0) - hist_all
    return torch.stack([left, left + hist_full], dim=1).reshape(-1)


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


_LCP_CHUNK = 1 << 24  # adjacent pairs per ladder run of the lcp pass


def _lcp_pairs_device_chunked(text: np.ndarray, a: np.ndarray,
                              b: np.ndarray, sigma: int, *, device,
                              chunk: int = _LCP_CHUNK) -> np.ndarray:
    """lcp of suffix pairs (a[i], b[i]) by the packed-word ladder on
    ``device``, ``chunk`` pairs per run: the out-of-core build's lcp
    pass.  The device holds the text, its packed word table (4 bytes a
    symbol) and one chunk's lanes."""
    from .sort import _lce_tables, _to_device, device_lce_pairs, \
        lce_pack_params

    n = int(text.size)
    out = np.empty(a.size, np.int64)
    if a.size == 0:
        return out
    text_dev = _to_device(text, device)
    bits, D = lce_pack_params(sigma)
    tables = _lce_tables(text_dev, n, bits, D)
    for lo in range(0, a.size, chunk):
        aa = _to_device(a[lo:lo + chunk].astype(np.int32), device)
        bb = _to_device(b[lo:lo + chunk].astype(np.int32), device)
        out[lo:lo + chunk] = device_lce_pairs(
            text_dev, n, sigma, aa, bb, int(aa.numel()),
            tables=tables).cpu().numpy()
    return out


def build_suf_out_of_core(
    multiseq: Multiseq,
    alpha: Alphabet,
    max_shard_bp: int,
    want_lcp: bool = True,
    *,
    device,
):
    """Suffix (and lcp) table of a multi-sequence database built with
    DEVICE memory bounded by ``max_shard_bp`` symbols per shard.

    The database is partitioned at sequence boundaries, each shard is
    sorted on ``device`` independently, and the shard orders merge by
    rank arithmetic there (index/merge.py — the reference's mergeesa
    seam, kurtz-basic/mergeesa.c:124).  The merged order is EXACTLY the
    monolithic index's (sequences are SEPARATOR-joined either way).
    The lcp pass runs the ladder over the whole text in chunks of
    pairs.

    Returns (suftab[n+1], lcptab[n+1] or None).
    """
    from .merge import merge_indexes

    nseq = multiseq.numofsequences
    if nseq <= 1:
        # single sequence: no boundary to split at
        if want_lcp:
            return build_suf_lcp(multiseq.sequence,
                                 sigma=alpha.num_regular, device=device)
        return (suffix_sort(multiseq.sequence,
                            sigma=alpha.num_regular, device=device)[0],
                None)

    groups: list[list[int]] = [[]]
    acc = 0
    for s in range(nseq):
        a, b = multiseq.seq_bounds(s)
        ln = b - a
        if groups[-1] and acc + ln + 1 > max_shard_bp:
            groups.append([])
            acc = 0
        groups[-1].append(s)
        acc += ln + 1
    count("shards", len(groups))

    # hold the full text 2-bit packed while the shards build (the
    # Encodedsequence storage concern, core/encseq.py) — shard byte
    # views materialize one at a time
    from ..core.encseq import Encodedsequence

    enc = Encodedsequence(multiseq.sequence)
    parts = []
    with phase("shard sorts"):
        for g in groups:
            lo = multiseq.seq_bounds(g[0])[0]
            hi = multiseq.seq_bounds(g[-1])[1]
            sub = Multiseq(sequence=enc.decode(lo, hi),
                           markpos=np.zeros(0, np.int64))
            sub.totallength = int(hi - lo)
            parts.append(build_esa(sub, alpha, demand=("suf",),
                                   device=device))
    suf, gtext = merge_indexes(parts, device=device)
    if not np.array_equal(gtext, multiseq.sequence):
        raise AssertionError(
            "out-of-core shard join does not reproduce the input "
            "concatenation")
    n = int(gtext.size)
    suftab = suf.astype(np.int64)   # merge includes the sentinel rank
    assert suftab.size == n + 1 and suftab[-1] == n
    lcptab = None
    if want_lcp:
        with phase("lcp pass"):
            lcptab = np.zeros(n + 1, np.int64)
            lcptab[1:n] = _lcp_pairs_device_chunked(
                gtext, suftab[:n - 1], suftab[1:n], alpha.num_regular,
                device=device)
    return suftab, lcptab


def build_esa(
    multiseq: Multiseq,
    alpha: Alphabet,
    prefixlength: int | None = None,
    demand: tuple[str, ...] = ("suf", "lcp", "bwt", "bck", "sti"),
    indexname: str = "",
    mesh=None,
    *,
    device,
) -> ESA:
    """Build the enhanced suffix array of a Multiseq on ``device``
    (mkvtreeprocess, mkvprocess.c:875-1089, minus file output).
    ``mesh`` splits the sort and lcp passes over its shards
    (parallel/shardesa.py); the derived tables are made on ``device``."""
    device = torch.device(device)
    text = multiseq.sequence
    n = int(text.size)
    numofchars = alpha.num_regular
    if prefixlength is None:
        prefixlength = recommended_prefixlength(numofchars, max(n, 1))

    lcptab = None
    if mesh is not None and np.prod(list(mesh.shape.values())) > 1:
        with phase("sharded sort"):
            suftab, stitab = suffix_sort(text, mesh=mesh, device=device)
        if "lcp" in demand or "skp" in demand:
            with phase("sharded lcp"):
                lcptab = lcp_table(text, suftab, mesh=mesh, device=device)
    elif "lcp" in demand or "skp" in demand:
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
            esa.bcktab = bck_table_device(
                esa.device("text"), numofchars, prefixlength,
            ).cpu().numpy().astype(np.uint32)
    if "skp" in demand:
        with phase("skip table"):
            esa.skptab = skip_table(esa.lcptab, device=device)
    from ..core.debug import check_suftab, debug_level

    lvl = debug_level()
    if lvl >= 1:
        # DEBUGLEVEL-style embedded verifiers (bese.c:355-533)
        check_suftab(text, suftab, esa.lcptab, lvl)
    return esa

"""Exact complete-match search on device tensors (port of
:mod:`vstree_tpu.engine.complete`, whose docstring gives the design;
reference exactcompl.c:64-230).

Three lookup paths, chosen as in the JAX module:

- the rank-count path (:class:`RankLookupPlan`): bucket bracket plus
  two base-(σ+1) key words per rank, counted by kernel K1
  (:mod:`vstree_tpu_torch.native.rankcount`);
- :func:`_device_exact_lookup`: packed-key batched binary search, for
  patterns longer than the two-word coverage;
- :func:`_interval_search`: direct text comparison, beyond
  ``MAX_KEY_LEVELS`` key levels.

The device is the ESA's (``esa.dev``); K1 runs its kernel on a CUDA
device and its plain version on the CPU.  Not ported yet: the mesh path
of :func:`exact_complete_matches`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vstree_tpu.core.chardef import WILDCARD
from vstree_tpu.engine.match import FLAGCOMPLETEMATCH, FLAGQUERY, MatchTable

from ..device import phase
from ..index.esa import ESA

# compare key of special suffix chars and the past-end sentinel: above
# every regular char, ordered by text position
_SPECIAL = 1 << 20

_I32 = torch.int32
_I64 = torch.int64


def _interval_search(text, suftab, patterns, plens, lo0, hi0,
                     maxplen: int, n: int, nsteps: int | None = None,
                     start_depth: int = 0):
    """Rank interval [lo, hi) of the suffixes whose prefix equals each
    pattern (int32 [B, maxplen], -1 padded), by batched binary search
    inside the brackets [lo0, hi0).  ``start_depth`` chars are known
    equal inside every bracket and skipped."""
    dev = text.device
    offs = torch.arange(start_depth, maxplen, dtype=_I64, device=dev)
    pkey = patterns[:, start_depth:].to(_I64)  # -1 padding: pattern ended
    active = offs[None, :] < plens[:, None]

    def rel(mid):
        """Sign of (suffix prefix at rank mid) - pattern."""
        s = suftab[mid.clamp(max=suftab.numel() - 1)].to(_I64)
        idx = s[:, None] + offs[None, :]
        ch = text[idx.clamp(max=n - 1)].to(_I64)
        # past-end is the sentinel: above every regular symbol and
        # ordered by position, like the other specials
        skey = torch.where((idx < n) & (ch < WILDCARD), ch, _SPECIAL + idx)
        diff = torch.where(active, skey - pkey, 0)
        nz = diff != 0
        first = nz.to(_I32).argmax(1)
        d = diff.gather(1, first[:, None].to(_I64))[:, 0]
        return torch.where(nz.any(1), torch.sign(d), 0)

    if nsteps is None:
        nsteps = max(1, int(np.ceil(np.log2(max(n + 1, 2)))) + 1)

    lo, hi = lo0.clone(), hi0.clone()
    for _ in range(nsteps):  # lower bound: first rank >= pattern
        open_ = lo < hi
        mid = (lo + hi) // 2
        r = rel(mid)
        lo = torch.where(open_ & (r < 0), mid + 1, lo)
        hi = torch.where(open_ & (r >= 0), mid, hi)
    lo2, hi2 = lo0.clone(), hi0.clone()
    for _ in range(nsteps):  # upper bound: first rank > pattern
        open_ = lo2 < hi2
        mid = (lo2 + hi2) // 2
        r = rel(mid)
        lo2 = torch.where(open_ & (r <= 0), mid + 1, lo2)
        hi2 = torch.where(open_ & (r > 0), mid, hi2)
    return lo, lo2


def _device_exact_lookup(keys, bck, patterns, plens, ppl: int,
                         levels: int, bits: int, numofchars: int,
                         nsteps: int, maxplen: int):
    """Bucket code, bracket, query-key packing and the packed-key
    binary searches.  ``keys``: int32 [levels, R] (``ESA.rank_keys``);
    ``bck``: int64 bucket table; ``patterns``: [B, maxplen], -1 padded,
    any integer dtype."""
    patterns = patterns.to(_I32)
    B = patterns.shape[0]
    dev = patterns.device
    code = torch.zeros(B, dtype=_I64, device=dev)
    okc = torch.ones(B, dtype=torch.bool, device=dev)
    for j in range(ppl):
        c = patterns[:, j]
        okc = okc & (c >= 0) & (c < numofchars)
        code = code * numofchars + c.clamp(min=0)
    code = torch.where(okc, code, 0)
    lo0 = torch.where(okc, bck[2 * code], 0).to(_I32)
    hi0 = torch.where(okc, bck[2 * code + 1], 0).to(_I32)

    cpk = 30 // bits
    maxcode = (1 << bits) - 1
    W = levels * cpk
    offs = ppl + torch.arange(W, dtype=_I64, device=dev)
    ch = patterns[:, offs.clamp(max=maxplen - 1)]
    active = offs[None, :] < plens[:, None]
    regular = (ch >= 0) & (ch < WILDCARD)
    ok = ~(active & ~regular).any(1)
    lo0 = torch.where(ok, lo0, 0)
    hi0 = torch.where(ok, hi0, 0)
    cl = torch.where(active, ch + 1, 0)
    chi = torch.where(active, ch + 1, maxcode)
    qlow, qhigh = [], []
    for lv in range(levels):
        kl = torch.zeros(B, dtype=_I32, device=dev)
        kh = torch.zeros(B, dtype=_I32, device=dev)
        for j in range(cpk):
            kl = (kl << bits) | cl[:, lv * cpk + j]
            kh = (kh << bits) | chi[:, lv * cpk + j]
        qlow.append(kl)
        qhigh.append(kh)
    R = keys.shape[1]

    def ge(mid, Q, strict):
        gt = torch.zeros(B, dtype=torch.bool, device=dev)
        eq = torch.ones(B, dtype=torch.bool, device=dev)
        m = mid.clamp(max=R - 1)
        for lv in range(levels):
            k = keys[lv][m]
            gt = gt | (eq & (k > Q[lv]))
            eq = eq & (k == Q[lv])
        return gt if strict else (gt | eq)

    def search(Q, strict):
        lo, hi = lo0, hi0
        for _ in range(nsteps):
            open_ = lo < hi
            mid = (lo + hi) // 2
            g = ge(mid, Q, strict)
            lo = torch.where(open_ & ~g, mid + 1, lo)
            hi = torch.where(open_ & g, mid, hi)
        return lo

    return search(qlow, False), search(qhigh, True)


def pattern_codes(patterns: np.ndarray, plens: np.ndarray,
                  numofchars: int, pl: int) -> np.ndarray:
    """Prefix code of each pattern's first ``pl`` chars (qgram2code);
    -1 if the prefix holds a wildcard or padding."""
    B = patterns.shape[0]
    code = np.zeros(B, np.int64)
    ok = plens >= pl
    for j in range(pl):
        c = patterns[:, j]
        ok &= (c >= 0) & (c < numofchars)
        code = code * numofchars + np.maximum(c, 0)
    return np.where(ok, code, -1)


MAX_KEY_LEVELS = 6

# marker of wildcard pattern chars in the int8 upload format (any value
# >= sigma flags the position; patterns with wildcards never match)
_WILDMARK = 120


def rank_lookup_inputs(flat8, bck, ppl: int, cpw: int, sigma: int,
                       shift: int):
    """The arguments K1 takes for a packed query batch: bucket code,
    bracket gather and base-(σ+1) key packing.

    ``flat8``: int8 [(ppl + 2*cpw + 1) * B], char-major (row j holds
    char j of every query, the last row the lengths); ``bck``: int32
    (BR, 128), ``left | width << shift`` per bucket code plus a
    zero-width sentinel entry at code σ^ppl.  Returns int32 [B] tensors
    (left, width, q1l, q2l, q1h, q2h)."""
    W = ppl + 2 * cpw
    p = flat8.reshape(W + 1, -1).to(_I32)
    B = p.shape[1]
    dev = p.device
    plen = p[W]
    base = sigma + 1
    code = torch.zeros(B, dtype=_I32, device=dev)
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    for j in range(ppl):
        c = p[j]
        valid &= (c >= 0) & (c < sigma)
        code = code * sigma + c.clamp(min=0)
    q1l = torch.zeros(B, dtype=_I32, device=dev)
    q2l = torch.zeros_like(q1l)
    q1h = torch.zeros_like(q1l)
    q2h = torch.zeros_like(q1l)
    for j in range(2 * cpw):
        c = p[ppl + j]
        act = (ppl + j) < plen
        valid &= ~(act & ((c < 0) | (c >= sigma)))
        cc = c.clamp(0, sigma - 1)
        dl = torch.where(act, cc, 0)
        dh = torch.where(act, cc, sigma)
        if j < cpw:
            q1l = q1l * base + dl
            q1h = q1h * base + dh
        else:
            q2l = q2l * base + dl
            q2h = q2h * base + dh
    # invalid queries (wildcards, padding) hit the zero-width sentinel
    code = torch.where(valid, code, sigma ** ppl)
    v = bck.reshape(-1)[code]
    # v >= 0: the plan keeps shift + bitlen(width) <= 31
    left = (v & ((1 << shift) - 1)).contiguous()
    width = (v >> shift).contiguous()
    return left, width, q1l, q2l, q1h, q2h


def _device_rank_lookup(flat8, bck, t1, t2, ppl: int, cpw: int,
                        sigma: int, rowspan: int, shift: int):
    """Whole exact-match interval lookup of a packed batch on device:
    :func:`rank_lookup_inputs`, then K1."""
    from ..native.rankcount import bucket_rank_lookup

    args = rank_lookup_inputs(flat8, bck, ppl, cpw, sigma, shift)
    return bucket_rank_lookup(*args, t1, t2, rowspan)


# The JAX package sizes the bucket depth so that the packed bucket
# table fits TPU VMEM beside the key tables; kept so that both packages
# take the same plans (ppl = 10 for DNA).  To be revisited on H100
# numbers, with the rowspan <= 8 guard below.
_BCK_VMEM_BUDGET = 4 << 20


class RankLookupPlan:
    """Static parameters and device tables of the rank-count path on one
    ESA (on ``esa.dev``).  Build once, run many batches."""

    def __init__(self, esa: ESA, min_plen: int, max_plen: int):
        self.esa = esa
        sigma = esa.alpha.num_regular
        self.sigma = sigma
        self.cpw = esa.chars_per_word()
        n = esa.totallength
        deep = int(math.log(_BCK_VMEM_BUDGET / 4) / math.log(sigma))
        self.ppl = max(1, min(deep, int(min_plen)))
        self.coverage = self.ppl + 2 * self.cpw
        self.shift = max(1, int(np.ceil(np.log2(max(n + 2, 4)))))
        self.ok = (max_plen <= self.coverage and sigma < _WILDMARK
                   and n >= 1)
        if not self.ok:
            return
        maxw = esa.aux_bck_maxwidth(self.ppl)
        self.rowspan = max(1, (maxw + 254) // 128)
        if (self.rowspan > 8
                or self.shift + max(1, maxw).bit_length() > 31):
            self.ok = False
            return
        self.bck = self._packed_bck()
        self.t1, self.t2 = esa.rank_words(self.ppl)

    def _packed_bck(self) -> torch.Tensor:
        """One int32 per bucket code, ``left | width << shift``, plus
        the zero-width sentinel entry; cached on the ESA."""
        key = ("packed_bck", self.ppl, self.shift)
        cache = self.esa._torch_cache
        if key not in cache:
            raw = self.esa.aux_bck(self.ppl)
            left = raw[0::2].astype(np.int64)
            mid = raw[1::2].astype(np.int64)
            packed = left | ((mid - left) << self.shift)
            rows = (packed.size + 1 + 127) // 128
            buf = np.zeros(rows * 128, np.int64)
            buf[:packed.size] = packed
            cache[key] = torch.from_numpy(
                buf.astype(np.int32).reshape(rows, 128)).to(self.esa.dev)
        return cache[key]

    def pack(self, patterns: np.ndarray, plens: np.ndarray) -> np.ndarray:
        """Host packing into one flat int8 upload buffer, char-major:
        (coverage+1, B) — row j holds char j of every query (-1 pad,
        wildcards -> _WILDMARK), the last row the lengths."""
        if plens.max(initial=0) > 127:
            raise ValueError("fast path requires plen <= 127")
        B, maxplen = patterns.shape
        out = np.full((self.coverage + 1, B), -1, np.int8)
        w = min(maxplen, self.coverage)
        src = patterns[:, :w]
        narrow = np.where((src >= 0) & (src < self.sigma), src,
                          -1).astype(np.int8)
        narrow = np.where(src >= self.sigma, np.int8(_WILDMARK), narrow)
        out[:w] = narrow.T
        out[self.coverage] = plens.astype(np.int8)
        return out.reshape(-1)

    def run(self, flat8: np.ndarray):
        """Upload a packed batch and look it up; returns device (lo, hi)."""
        return _device_rank_lookup(
            torch.from_numpy(flat8).to(self.esa.dev), self.bck, self.t1,
            self.t2, self.ppl, self.cpw, self.sigma, self.rowspan,
            self.shift)


def exact_interval_lookup(esa: ESA, patterns: np.ndarray,
                          plens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rank interval [lo, hi) of every whole pattern (int32 [B, maxplen],
    -1 padded), as host arrays.

    Rank-count path when the patterns fit the two-word coverage, else
    the packed-key binary search, else direct text comparison."""
    B, maxplen = patterns.shape
    if B > 0 and esa.totallength > 0 and plens.max(initial=0) <= 127:
        with phase("rank words"):
            plan = RankLookupPlan(esa, int(plens.min()), maxplen)
        if plan.ok:
            with phase("pack"):
                flat8 = plan.pack(patterns, plens)
            with phase("rank lookup"):
                lo, hi = plan.run(flat8)
                return lo.cpu().numpy(), hi.cpu().numpy()
    n = esa.totallength
    numofchars = esa.alpha.num_regular

    # deepest affordable bucket depth: buckets of ~1 suffix kill almost
    # the whole binary search
    deep = int(math.log(1 << 24) / math.log(numofchars))
    ppl = max(1, min(deep, int(plens.min())))
    bck = esa.aux_bck(ppl)
    maxbucket = esa.aux_bck_maxwidth(ppl)
    nsteps = max(2, int(np.ceil(np.log2(max(maxbucket, 2)))) + 1)
    nsteps = min(nsteps, max(1, int(np.ceil(np.log2(max(n + 1, 2)))) + 1))

    bits = esa.key_bits()
    cpk = 30 // bits
    levels = max(1, int(np.ceil((maxplen - ppl) / cpk)))
    dev = esa.dev
    if levels <= MAX_KEY_LEVELS:
        padto = ppl + levels * cpk
        if maxplen < padto:
            pad = np.full((B, padto - maxplen), -1, patterns.dtype)
            patterns = np.concatenate([patterns, pad], axis=1)
            maxplen = padto
        if B >= 4096 and nsteps > 6:
            # the widest bucket actually queried bounds the steps
            codes = pattern_codes(patterns.astype(np.int32), plens,
                                  numofchars, ppl)
            vc = np.maximum(codes, 0)
            wid = np.where(codes >= 0,
                           bck[2 * vc + 1].astype(np.int64)
                           - bck[2 * vc].astype(np.int64), 0)
            maxw = int(wid.max()) if wid.size else 2
            bsteps = max(2, int(np.ceil(np.log2(max(maxw, 2)))) + 1)
            nsteps = min(nsteps, bsteps + (-bsteps) % 3)
        lo, hi = _device_exact_lookup(
            esa.rank_keys(ppl, levels), esa.aux_bck_device(ppl),
            torch.from_numpy(np.ascontiguousarray(patterns)).to(dev),
            torch.from_numpy(plens.astype(np.int32)).to(dev),
            ppl, levels, bits, numofchars, nsteps, maxplen)
    else:
        codes = pattern_codes(patterns, plens, numofchars, ppl)
        lo0 = np.zeros(B, np.int32)
        hi0 = np.zeros(B, np.int32)
        valid = codes >= 0
        vcodes = np.maximum(codes, 0)
        lo0[valid] = bck[2 * vcodes[valid]].astype(np.int32)
        hi0[valid] = bck[2 * vcodes[valid] + 1].astype(np.int32)
        lo, hi = _interval_search(
            esa.device("text"), esa.device("suftab"),
            torch.from_numpy(patterns).to(dev),
            torch.from_numpy(plens.astype(np.int64)).to(dev),
            torch.from_numpy(lo0).to(dev), torch.from_numpy(hi0).to(dev),
            maxplen, n, nsteps, ppl)
    return lo.cpu().numpy(), hi.cpu().numpy()


def exact_complete_matches(
    esa: ESA,
    query: "np.ndarray | list[np.ndarray]",
    query_seqnums: np.ndarray | None = None,
    flags_extra: int = 0,
    query_starts: np.ndarray | None = None,
) -> MatchTable:
    """All exact whole-pattern occurrences of a batch of encoded
    patterns, ordered (query, rank) as the reference emits them
    (exactcompl.c:156-164)."""
    pats = query if isinstance(query, list) else [query]
    B = len(pats)
    if B == 0:
        return MatchTable()
    pl = esa.prefixlength
    plens = np.array([p.size for p in pats], np.int32)
    if (plens < pl).any():
        raise ValueError(
            f"patternlength={int(plens.min())} must be >= {pl}=prefixlen")
    maxplen = int(plens.max())
    patterns = np.full((B, maxplen), -1, np.int32)
    for i, p in enumerate(pats):
        # wildcards keep their code (>= WILDCARD): they never match
        patterns[i, :p.size] = p.astype(np.int32)

    lo, hi = exact_interval_lookup(esa, patterns, plens)
    with phase("expansion"):
        counts = np.maximum(hi.astype(np.int64) - lo, 0)
        total = int(counts.sum())
        if total == 0:
            return MatchTable()
        # intervals -> (query i, rank r) pairs, rank ascending
        qidx = np.repeat(np.arange(B), counts)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        ranks = (np.arange(total) - starts[qidx]) + lo[qidx]
        positions = esa.suftab[ranks].astype(np.int64)
        seq1, rel1 = esa.multiseq.pos_to_pair(positions)
        lens = plens[qidx].astype(np.int64)
        if query_seqnums is None:
            query_seqnums = np.arange(B, dtype=np.int64)
        if query_starts is None:
            query_starts = np.zeros(B, np.int64)
        return MatchTable(
            length1=lens,
            position1=positions,
            length2=lens,
            position2=query_starts[qidx].astype(np.int64),
            distance=np.zeros(total, np.int64),
            flag=np.full(total,
                         FLAGQUERY | FLAGCOMPLETEMATCH | flags_extra,
                         np.int64),
            seqnum1=seq1,
            relpos1=rel1,
            seqnum2=query_seqnums[qidx].astype(np.int64),
            relpos2=np.zeros(total, np.int64),
            evalue=np.zeros(total, np.float64),
            idnumber=np.zeros(total, np.int64),
            transnum=np.full(total, -1, np.int64),
        )

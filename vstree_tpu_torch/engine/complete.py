"""Exact complete-match search on device tensors (port of
:mod:`vstree_tpu.engine.complete`, whose docstring gives the design;
reference exactcompl.c:64-230).

Three lookup paths, chosen as in the JAX module:

- the rank path (:class:`RankLookupPlan`): kernel K1
  (:mod:`vstree_tpu_torch.native.rankcount`) takes the packed queries,
  the bracket table, ``suf`` and the text, and searches each bucket
  bracket with two base-(σ+1) key words per probed rank;
- :func:`_device_exact_lookup`: packed-key batched binary search, for
  patterns longer than the two-word coverage;
- :func:`_interval_search`: direct text comparison, beyond
  ``MAX_KEY_LEVELS`` key levels.

The device is the ESA's (``esa.dev``); K1 runs its kernel on a CUDA
device and its plain version on the CPU.  With a ``mesh``,
:func:`exact_complete_matches` takes the rank-sharded binary search of
:mod:`vstree_tpu_torch.parallel.shardesa` instead (no kernel, as in the
JAX package).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.chardef import WILDCARD
from .match import FLAGCOMPLETEMATCH, FLAGQUERY, MatchTable

from ..device import phase
from ..index.esa import ESA
from ..native.rankcount import MAX_N, bracket_table, rank_interval_lookup

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


# The JAX package sizes the bucket depth so that its packed bucket
# table fits TPU VMEM beside the key tables; kept, with the two-word
# coverage, so that every index the JAX plan takes gets the same ppl
# here (ppl = 10 for DNA).
_BCK_VMEM_BUDGET = 4 << 20


class RankLookupPlan:
    """Static parameters and device tables of the rank path on one ESA
    (on ``esa.dev``): the bracket table at depth ``ppl``, ``suf`` and
    the text.  Build once, run many batches.

    Departs from the JAX plan, which also refuses an index whose widest
    bucket exceeds its kernel's window (``rowspan > 8``) or its 31-bit
    packing of a bracket (``shift + bitlen(width) > 31``): K1 searches
    unpacked brackets, so a genome's poly(dA:dT) buckets and a
    proteome's are taken.  Where the JAX plan is ok both agree."""

    def __init__(self, esa: ESA, min_plen: int, max_plen: int):
        self.esa = esa
        sigma = esa.alpha.num_regular
        self.sigma = sigma
        self.cpw = esa.chars_per_word()
        n = esa.totallength
        deep = int(math.log(_BCK_VMEM_BUDGET / 4) / math.log(sigma))
        self.ppl = max(1, min(deep, int(min_plen)))
        self.coverage = self.ppl + 2 * self.cpw
        self.ok = (max_plen <= self.coverage and sigma < _WILDMARK
                   and 1 <= n < MAX_N)
        if not self.ok:
            return
        self.bck = self._bracket_table()
        self.suf = esa.device_suf32()
        self.text = esa.device("text")

    def _bracket_table(self) -> torch.Tensor:
        """int32 [2*(σ^ppl + 1)]: ``(left, width)`` of every bucket
        code, then the zero-width sentinel entry; made on the device
        from the depth-ppl bucket table, cached on the ESA."""
        key = ("bracket_table", self.ppl)
        cache = self.esa._torch_cache
        if key not in cache:
            cache[key] = bracket_table(self.esa.aux_bck_device(self.ppl))
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
        """Upload a packed batch and look it up with K1; returns
        (lo, hi) as int32 tensors on the host."""
        return rank_interval_lookup(
            torch.from_numpy(flat8).to(self.esa.dev), self.bck, self.suf,
            self.text, self.esa.totallength, self.ppl, self.cpw,
            self.sigma)


def exact_interval_lookup(esa: ESA, patterns: np.ndarray,
                          plens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rank interval [lo, hi) of every whole pattern (int32 [B, maxplen],
    -1 padded), as host arrays.

    Rank path (K1) when the patterns fit the two-word coverage, else
    the packed-key binary search, else direct text comparison.  The
    phase "rank words" times the plan: the bracket table at depth ppl,
    made on the device, and the uploads of ``suf`` and the text; the
    phases "rank lookup", "key search" (after "rank keys", the packed
    keys of every rank) and "text search" name the path taken."""
    B, maxplen = patterns.shape
    if B > 0 and esa.totallength > 0 and plens.max(initial=0) <= 127:
        with phase("rank words"):
            plan = RankLookupPlan(esa, int(plens.min()), maxplen)
        if plan.ok:
            with phase("pack"):
                flat8 = plan.pack(patterns, plens)
            with phase("rank lookup"):
                lo, hi = plan.run(flat8)
                return lo.numpy(), hi.numpy()
    n = esa.totallength
    numofchars = esa.alpha.num_regular

    # deepest affordable bucket depth: buckets of ~1 suffix kill almost
    # the whole binary search
    deep = int(math.log(1 << 24) / math.log(numofchars))
    ppl = max(1, min(deep, int(plens.min())))
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
            codes = torch.from_numpy(pattern_codes(
                patterns.astype(np.int32), plens, numofchars, ppl)).to(dev)
            bck = esa.aux_bck_device(ppl)
            vc = codes.clamp(min=0)
            wid = torch.where(codes >= 0, bck[2 * vc + 1] - bck[2 * vc], 0)
            maxw = int(wid.max())
            bsteps = max(2, int(np.ceil(np.log2(max(maxw, 2)))) + 1)
            nsteps = min(nsteps, bsteps + (-bsteps) % 3)
        with phase("rank keys"):
            keys = esa.rank_keys(ppl, levels)
        with phase("key search"):
            lo, hi = _device_exact_lookup(
                keys, esa.aux_bck_device(ppl),
                torch.from_numpy(np.ascontiguousarray(patterns)).to(dev),
                torch.from_numpy(plens.astype(np.int32)).to(dev),
                ppl, levels, bits, numofchars, nsteps, maxplen)
    else:
        bck = esa.aux_bck(ppl)
        codes = pattern_codes(patterns, plens, numofchars, ppl)
        lo0 = np.zeros(B, np.int32)
        hi0 = np.zeros(B, np.int32)
        valid = codes >= 0
        vcodes = np.maximum(codes, 0)
        lo0[valid] = bck[2 * vcodes[valid]].astype(np.int32)
        hi0[valid] = bck[2 * vcodes[valid] + 1].astype(np.int32)
        with phase("text search"):
            lo, hi = _interval_search(
                esa.device("text"), esa.device("suftab"),
                torch.from_numpy(patterns).to(dev),
                torch.from_numpy(plens.astype(np.int64)).to(dev),
                torch.from_numpy(lo0).to(dev),
                torch.from_numpy(hi0).to(dev), maxplen, n, nsteps, ppl)
    return lo.cpu().numpy(), hi.cpu().numpy()


def exact_complete_matches(
    esa: ESA,
    query: "np.ndarray | list[np.ndarray]",
    query_seqnums: np.ndarray | None = None,
    flags_extra: int = 0,
    query_starts: np.ndarray | None = None,
    mesh=None,
) -> MatchTable:
    """All exact whole-pattern occurrences of a batch of encoded
    patterns, ordered (query, rank) as the reference emits them
    (exactcompl.c:156-164).  ``mesh`` looks the intervals up over its
    rank shards."""
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

    if mesh is not None:
        from ..parallel.shardesa import exact_interval_lookup_sharded

        with phase("sharded lookup"):
            lo, hi = exact_interval_lookup_sharded(esa, patterns, plens,
                                                   mesh)
    else:
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

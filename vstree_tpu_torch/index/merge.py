"""Multi-index merge (reference kurtz-basic/mergeesa.c:124-288
``stepdeleteandinsertothersuffixes`` + trie, tested by
bin/Checkmergeesa.sh): k separately built indexes merge into the index
of their concatenation WITHOUT re-sorting.

The merged rank of a suffix is its local rank plus, for every other
index, the count of that index's suffixes ordering below it — a batched
binary search per index pair (the reference's k-way trie walk becomes
k*(k-1) vectorized searches).  Comparison semantics of the concatenated
text (SURVEY Appendix A.1): regular chars by code, any
special/past-the-end beats regular, special vs special by GLOBAL
position — since every special of an earlier part precedes every
special of a later part, a tie resolves to the earlier part.

A copy of :mod:`vstree_tpu.index.merge` but for the cross counts, which
run on the device given to :func:`merge_indexes` as torch ops: each
probe of the binary search takes the longest common regular prefix of
the a-suffix and the b-suffix with the packed-word two-text LCE ladder
(:func:`vstree_tpu_torch.index.sort.device_lce_pairs`, which stops at
the first special or end of either side) and decides on the characters
at that offset (:func:`_cross_rel`).  The ladder starts each probe from
the smaller of the lane's LCEs with the b-suffixes that bound its
search range, which every suffix between them shares.  Only the two
texts, packed word tables and suffix lists of one pair of parts are on
the device at a time; the special-suffix tail stays host code.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.chardef import WILDCARD
from ..device import phase
from .sort import _lce_tables, device_lce_pairs, lce_pack_params


def _cross_rel(ta: torch.Tensor, pa: torch.Tensor, tb: torch.Tensor,
               pb: torch.Tensor, lce: torch.Tensor,
               a_first: bool) -> torch.Tensor:
    """sign(suffix_a - suffix_b) under concatenated-text semantics, for
    pairs whose longest common regular prefix is ``lce`` (int8 tensor);
    ``a_first`` = text a precedes text b in the concatenation (ties on
    simultaneous special/exhaustion resolve to the earlier part)."""
    na, nb = ta.numel(), tb.numel()
    ia = pa.to(torch.int64) + lce
    ib = pb.to(torch.int64) + lce
    ca = ta[ia.clamp(max=na - 1)].to(torch.int32)
    cb = tb[ib.clamp(max=nb - 1)].to(torch.int32)
    sa = (ia >= na) | (ca >= WILDCARD)
    sb = (ib >= nb) | (cb >= WILDCARD)
    # both special -> tie by part order; one special -> special greater;
    # else by code (they differ: the lce stops there)
    return torch.where(
        sa & sb, -1 if a_first else 1,
        torch.where(sa, 1, torch.where(sb, -1, torch.sign(ca - cb))),
    ).to(torch.int8)


def _sigma(text: torch.Tensor) -> int:
    """Regular codes 0..sigma-1 of a text (1 when it has none)."""
    return int(torch.where(text < WILDCARD, text, 0).max()) + 1


def _cross_counts(ta, suf_a, tb, suf_b, a_first: bool, *,
                  device) -> np.ndarray:
    """For every suffix of a (by rank), the number of b-suffixes that
    order before it: batched binary search over b's rank order, every
    lane in lockstep for the bit length of b's suffix count."""
    ma = int(suf_a.size)
    mb = int(suf_b.size)
    if ma == 0 or mb == 0:
        return np.zeros(ma, np.int64)
    ta_d = torch.from_numpy(np.ascontiguousarray(ta)).to(device)
    tb_d = torch.from_numpy(np.ascontiguousarray(tb)).to(device)
    na, nb = ta_d.numel(), tb_d.numel()
    sigma = max(_sigma(ta_d), _sigma(tb_d))
    bits, D = lce_pack_params(sigma)
    Pa = _lce_tables(ta_d, na, bits, D)
    Pb = _lce_tables(tb_d, nb, bits, D)
    pa = torch.from_numpy(suf_a.astype(np.int32)).to(device)
    sufb = torch.from_numpy(suf_b.astype(np.int32)).to(device)
    lo = torch.zeros(ma, dtype=torch.int32, device=device)
    hi = torch.full((ma,), mb, dtype=torch.int32, device=device)
    # lce with the b-suffix below the range (rank lo-1) and above it
    # (rank hi); 0 where there is none
    llo = torch.zeros(ma, dtype=torch.int32, device=device)
    lhi = torch.zeros(ma, dtype=torch.int32, device=device)
    for _ in range(mb.bit_length()):
        open_ = lo < hi
        mid = ((lo + hi) // 2).clamp(max=mb - 1)
        pb = sufb[mid]
        lce = device_lce_pairs(None, na, sigma, pa, pb, ma, tables=Pa,
                               tables_b=Pb, nb=nb,
                               init_l=torch.minimum(llo, lhi))
        # b-suffix < a-suffix  <=>  rel > 0
        lt = _cross_rel(ta_d, pa, tb_d, pb, lce, a_first) > 0
        up = open_ & lt
        down = open_ & ~lt
        lo = torch.where(up, mid + 1, lo)
        llo = torch.where(up, lce, llo)
        hi = torch.where(down, mid, hi)
        lhi = torch.where(down, lce, lhi)
    return lo.cpu().numpy().astype(np.int64)


def merge_indexes(parts: list, *, device) -> tuple[np.ndarray, np.ndarray]:
    """Merge k ESAs (each over one part text, in concatenation order)
    into (global_suftab, global_text) of the SEPARATOR-joined
    concatenation.  Rank arithmetic only — no re-sort; the cross counts
    on ``device``."""
    k = len(parts)
    offsets = []
    texts = []
    off = 0
    for i, esa in enumerate(parts):
        offsets.append(off)
        texts.append(esa.multiseq.sequence)
        off += esa.multiseq.totallength + 1   # + separator
    total = off - 1
    gtext = np.full(total, 255, np.uint8)
    for i, t in enumerate(texts):
        gtext[offsets[i]:offsets[i] + t.size] = t

    # regular suffixes: global rank = local regular rank + cross
    # counts; special-starting suffixes (wildcards, the joining
    # separators, the sentinel) form the tail block ordered by GLOBAL
    # position (the monolithic index's special rule)
    granks = []
    regs = []
    special_pos = []
    with phase("cross counts"):
        for i, esa in enumerate(parts):
            suf_i = esa.suftab[:-1].astype(np.int64)  # minus the sentinel
            is_reg = texts[i][suf_i] < WILDCARD
            nreg_i = int(is_reg.sum())
            # the local order puts all special-starting suffixes last
            suf_reg = suf_i[:nreg_i]
            regs.append(suf_reg)
            special_pos.append(suf_i[nreg_i:] + offsets[i])
            rank = np.arange(nreg_i, dtype=np.int64)
            for j, other in enumerate(parts):
                if i == j:
                    continue
                suf_j = other.suftab[:-1]
                rank = rank + _cross_counts(
                    texts[i], suf_reg, texts[j], suf_j, a_first=(i < j),
                    device=device)
            granks.append(rank)

    with phase("special tail"):
        nreg = sum(r.size for r in regs)
        seppos = np.array(
            [offsets[i] + parts[i].multiseq.totallength
             for i in range(k - 1)] + [total], np.int64)
        tail = np.sort(np.concatenate(special_pos + [seppos]))
        suftab = np.empty(nreg + tail.size, np.int64)
        for i in range(k):
            suftab[granks[i]] = regs[i] + offsets[i]
        suftab[nreg:] = tail
    return suftab, gtext

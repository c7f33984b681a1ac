"""Suffix sorting and LCP on device tensors (port of
:mod:`vstree_tpu.index.sort`).

The same three stages as the JAX module, whose docstring gives the
design and the sort-order contract (remainsort.c:73-127):

1. one packed-key sort resolves every suffix to depth D;
2. compacted prefix doubling re-sorts only members of non-singleton
   rank groups;
3. the packed-word LCP ladder advances each adjacent pair by up to D
   characters per gather.

What differs from the XLA version, with results unchanged:

- two-key unstable ``lax.sort`` becomes one ``torch.sort`` on a
  combined int64 key ``(key1 << 31) | key2`` (key1 < 2^30,
  key2 <= n + 1 < 2^31).  Ties may come out in another order; the
  final suffix array is read from the bijective rank, so it is equal;
- live lists are compacted to their exact size (no ``_nice_size`` /
  power-of-two padding, which served XLA's compile cache), so no pad
  entries exist and ``mode="drop"`` scatters become plain ones;
- ``lax.population_count(_smear(x)) - 1`` becomes :func:`msb`, an exact
  integer bit search;
- offsets that may pass 2^31 are formed in int64.

Host syncs stay where the JAX module has them: one ``int`` of the live
count per doubling round and per LCE round.

The snapshot descent (:func:`lce_with_snapshots`, the merged sort of
matching statistics) differs in one place on purpose: a lane whose
capped descent stops inside the next packed word is finished by the
ladder too (fault F1 of the JAX module returns it short), and the
number of snapshots kept comes from the card's free memory
(:func:`snapshot_cap`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.chardef import WILDCARD

from ..device import count, phase

INT32_INF = 2**31 - 1
MAX_N = 2**31 - 64
# rank snapshots that device_suffix_sort(collect_snapshots=True) keeps at
# most; None takes the count from free memory (snapshot_cap)
SNAPSHOT_CAP: int | None = None
_SNAPSHOT_SHARE = 0.25     # of the card's free memory
_SNAPSHOT_BYTES_HOST = 2e9  # the JAX module's budget, for CPU tensors

_I32 = torch.int32
_I64 = torch.int64


def _bits_for(values: int) -> int:
    """Bits needed to hold digit values 0..values-1."""
    return max(1, int(math.ceil(math.log2(max(values, 2)))))


def sort_pack_params(sigma: int) -> tuple[int, int]:
    """(bits, D) for the ordering key: digits 0..sigma-1 regular plus
    the special marker sigma; D digits packed into 30 bits."""
    bits = _bits_for(sigma + 1)
    return bits, max(1, 30 // bits)


def lce_pack_params(sigma: int) -> tuple[int, int]:
    """(bits, D) for the equality key of the LCP ladder: D regular
    digits plus the first-special offset (0..D) in one int32 word."""
    bits = _bits_for(sigma)
    D = max(1, 30 // bits)
    while D > 1 and D * bits + D.bit_length() > 31:
        D -= 1
    return bits, D


def msb(x: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of each 0 <= x < 2^31, -1 for 0
    (``population_count(smear(x)) - 1``), by a five-step binary search
    on integers."""
    out = (x > 0).to(x.dtype) - 1
    y = x
    for s in (16, 8, 4, 2, 1):
        hit = y >= (1 << s)
        out = out + hit.to(x.dtype) * s
        y = torch.where(hit, y >> s, y)
    return out


def _first_special(text: torch.Tensor, n: int, D: int) -> torch.Tensor:
    """fs[i] = first special position in [i, i+D), counting the
    sentinel at n; INT32_INF when there is none."""
    pos = torch.arange(n, dtype=_I32, device=text.device)
    sp = torch.where(text >= WILDCARD, pos, INT32_INF)
    padded = torch.cat([
        sp, sp.new_full((1,), n), sp.new_full((max(D - 1, 1),), INT32_INF)])
    fs = sp.new_full((n,), INT32_INF)
    for j in range(D):
        fs = torch.minimum(fs, padded[j:j + n])
    return fs


# ---------------------------------------------------------------------------
# initial phase and doubling rounds
# ---------------------------------------------------------------------------


def _initial_phase(text: torch.Tensor, n: int, sigma: int, bits: int,
                   D: int):
    """One sort resolving suffix order to depth D.

    Returns (sa, rank, rank_by_slot, active_slot) as in the JAX
    ``_initial_phase``: rank is the group-start slot of each suffix,
    active_slot marks slots whose group has >= 2 members."""
    dev = text.device
    pos = torch.arange(n, dtype=_I32, device=dev)
    fs = _first_special(text, n, D)
    off = (fs - pos).to(_I64)
    padded = torch.cat([text.to(_I64), torch.zeros(D, dtype=_I64,
                                                    device=dev)])
    # regular chars by value; the first special is the marker digit
    # sigma; everything after it is 0, so equal prefixes tie on key1 and
    # break on the special's position (key2)
    key1 = torch.zeros(n, dtype=_I64, device=dev)
    for j in range(D):
        digit = torch.where(off > j, padded[j:j + n],
                            (off == j).to(_I64) * sigma)
        key1 = (key1 << bits) | digit
    key2 = torch.where(fs < INT32_INF, fs.to(_I64) + 1, 0)
    ks, order = torch.sort((key1 << 31) | key2, stable=True)
    sa = order.to(_I32)
    ng = torch.ones(n, dtype=torch.bool, device=dev)
    ng[1:] = ks[1:] != ks[:-1]
    rank_by_slot = torch.cummax(torch.where(ng, pos, 0), 0).values
    rank = torch.empty(n, dtype=_I32, device=dev)
    rank[order] = rank_by_slot
    ng_next = torch.ones_like(ng)
    ng_next[:-1] = ng[1:]
    return sa, rank, rank_by_slot, ~(ng & ng_next)


def _doubling_round(rank, slots, p, r1, k: int, n: int):
    """One doubling round at certified depth ``k`` over the live list
    (group members plus singleton ghosts, which sort back onto their own
    slot).  Updates ``rank`` in place; returns (rank, p, r1, live,
    live count)."""
    pk = p.to(_I64) + k
    r2 = torch.where(pk < n, rank[pk.clamp(max=n - 1)], n)
    ks, order = torch.sort((r1.to(_I64) << 31) | r2.to(_I64), stable=True)
    ps = p[order]
    ng = torch.ones(ps.numel(), dtype=torch.bool, device=p.device)
    ng[1:] = ks[1:] != ks[:-1]
    new_r1 = torch.cummax(torch.where(ng, slots, 0), 0).values
    ng_next = torch.ones_like(ng)
    ng_next[:-1] = ng[1:]
    live = ~(ng & ng_next)
    rank[ps] = new_r1
    return rank, ps, new_r1, live, int(live.sum())


def _compact_live(slots, p, r1, live):
    """Drop ghosts: keep the live entries, in ascending slot order."""
    return slots[live], p[live], r1[live]


def _sa_from_rank(rank, n: int):
    """Final suffix array from the (bijective) rank map."""
    sa = torch.empty(n, dtype=_I32, device=rank.device)
    sa[rank] = torch.arange(n, dtype=_I32, device=rank.device)
    return sa


def snapshot_cap(n: int, device: torch.device) -> int:
    """Rank snapshots a sort of n suffixes may keep: each pins an int32
    [n] array.  :data:`SNAPSHOT_CAP` when set; on the card a quarter of
    the free memory, on the CPU the JAX module's 2e9 bytes; at least 4."""
    if SNAPSHOT_CAP is not None:
        return SNAPSHOT_CAP
    if device.type == "cuda":
        budget = torch.cuda.mem_get_info(device)[0] * _SNAPSHOT_SHARE
    else:
        budget = _SNAPSHOT_BYTES_HOST
    return max(4, int(budget // (4 * max(n, 1))))


def device_suffix_sort(text_dev: torch.Tensor, n: int, sigma: int,
                       collect_snapshots: bool = False):
    """Suffix sort of the encoded text (uint8 tensor of length n);
    returns sa (int32 [n], sa[r] = start of the rank-r suffix, sentinel
    excluded) on the text's device.

    With ``collect_snapshots`` also returns the list of (certified
    depth k, rank) snapshots taken after every round, at most
    :func:`snapshot_cap` of them: ``rank[a] == rank[b]`` iff
    ``lce(a, b) >= k``, the certificate of :func:`lce_with_snapshots`."""
    bits, D = sort_pack_params(sigma)
    snaps = []
    with phase("initial sort"):
        sa0, rank, r1, active = _initial_phase(text_dev, n, sigma, bits, D)
        cnt = int(active.sum())
    if collect_snapshots:
        cap = snapshot_cap(n, text_dev.device)
        count("snapshot cap", cap)
        snaps.append((D, rank.clone()))
    if cnt == 0:
        return (sa0, snaps) if collect_snapshots else sa0
    with phase("doubling rounds"):
        # full width with identity slots first; ghosts ride along
        # until the live count halves
        M = n
        slots = torch.arange(n, dtype=_I32, device=text_dev.device)
        p = sa0
        k = D
        while True:
            rank, p, r1, live, cnt = _doubling_round(rank, slots, p, r1,
                                                     k, n)
            k *= 2
            if collect_snapshots and cnt > 0 and len(snaps) < cap:
                snaps.append((k, rank.clone()))   # rank changes in place
            if cnt == 0:
                sa = _sa_from_rank(rank, n)
                return (sa, snaps) if collect_snapshots else sa
            if k > 4 * n:  # pragma: no cover - invariant safety net
                raise AssertionError("suffix sort failed to converge")
            if cnt <= M // 2:
                slots, p, r1 = _compact_live(slots, p, r1, live)
                M = cnt


# ---------------------------------------------------------------------------
# LCP ladder
# ---------------------------------------------------------------------------


def _lce_tables(text: torch.Tensor, n: int, bits: int, D: int):
    """P[i] = K | (off << D*bits): the D regular digits of window
    [i, i+D) (specials contribute 0) plus off = min(D, offset of the
    first special in the window, counting the sentinel at n)."""
    dev = text.device
    pos = torch.arange(n, dtype=_I32, device=dev)
    special = text >= WILDCARD
    dg = torch.where(special, 0, text.to(_I32))
    padded = torch.cat([dg, torch.zeros(D, dtype=_I32, device=dev)])
    K = torch.zeros(n, dtype=_I32, device=dev)
    for j in range(D):
        K = (K << bits) | padded[j:j + n]
    fs = _first_special(text, n, D)
    off = (fs - pos).clamp(0, D)
    return K | (off << (D * bits))


def _word_rem(Pa, Pb, ia, ib, na: int, nb: int, bits: int, D: int):
    """Matching chars (0..D) of the packed words at positions ia of A
    and ib of B: the first differing digit or the first special, a
    position at or past the end being the sentinel (off 0).  Words are
    non-negative, so ``>>`` is the logical shift."""
    pa = Pa[ia.clamp(max=na - 1)]
    pb = Pb[ib.clamp(max=nb - 1)]
    sh = D * bits
    offa = torch.where(ia < na, pa >> sh, 0)
    offb = torch.where(ib < nb, pb >> sh, 0)
    x = (pa ^ pb) & ((1 << sh) - 1)
    fd = torch.where(x == 0, D, D - 1 - msb(x) // bits)
    return torch.minimum(fd, torch.minimum(offa, offb))


def _lce_round(Pa, Pb, a, b, l, na: int, nb: int, bits: int, D: int,
               W: int = 1):
    """Advance the lcp of every pair by up to W*D chars: one gather
    per side per word; a word counts only while every earlier word
    fully matched.  A stopped pair's l is a fixed point.  Returns
    (l, active, active count)."""
    adv = torch.zeros_like(l)
    done = torch.zeros(l.shape, dtype=torch.bool, device=l.device)
    for w in range(W):
        rem = _word_rem(Pa, Pb, a.to(_I64) + l + w * D,
                        b.to(_I64) + l + w * D, na, nb, bits, D)
        adv = adv + torch.where(done, 0, rem)
        done = done | (rem < D)
    active = ~done
    return l + adv, active, int(active.sum())


def _lce_compact(a, b, l, idx, active, res):
    """Harvest the finished lanes into ``res`` and keep the active ones."""
    done = ~active
    res[idx[done]] = l[done]
    return a[active], b[active], l[active], idx[active], res


def _lce_harvest(l, idx, res):
    res[idx] = l
    return res


def device_lce_pairs(text_dev, n: int, sigma: int, a_dev, b_dev,
                     npairs: int, tables=None, tables_b=None,
                     nb: int | None = None, init_l=None, active0=None):
    """lce(suffix a[i] of text A, suffix b[i] of text B) for npairs
    pairs, on the tables' device; int32 [npairs].

    ``tables`` may carry the packed word table of :func:`_lce_tables` to
    share across calls; ``tables_b``/``nb`` select a second text
    (default: the same text).  ``init_l`` seeds the extension lengths,
    and a lane whose ``active0`` is false does not advance at all: it
    keeps its ``init_l``."""
    bits, D = lce_pack_params(sigma)
    P = _lce_tables(text_dev, n, bits, D) if tables is None else tables
    Pb = P if tables_b is None else tables_b
    nb = n if nb is None else nb
    if npairs == 0:
        return torch.zeros(0, dtype=_I32, device=P.device)
    a = a_dev.to(_I32)
    b = b_dev.to(_I32)
    idx = torch.arange(npairs, dtype=_I64, device=P.device)
    l = (torch.zeros(npairs, dtype=_I32, device=P.device) if init_l is None
         else init_l.to(_I32))
    res = l.clone()
    if active0 is not None:
        a, b, l, idx = a[active0], b[active0], l[active0], idx[active0]
    M = int(idx.numel())
    if M == 0:
        return res
    prev_cnt = None
    slow_decay = False
    while True:
        # a wider word window once the live set is small, or when the
        # live count decays slowly (self-similar texts)
        if M > (1 << 22):
            W = 2 if slow_decay else 1
        elif M > (1 << 19):
            W = 4
        else:
            W = 16
        l, active, cnt = _lce_round(P, Pb, a, b, l, n, nb, bits, D, W)
        slow_decay = prev_cnt is not None and cnt * 5 > prev_cnt * 4
        prev_cnt = cnt
        if cnt == 0:
            return _lce_harvest(l, idx, res)
        if cnt <= M - M // 4:
            a, b, l, idx, res = _lce_compact(a, b, l, idx, active, res)
            M = cnt
        # else: keep the lanes; a finished lane's l is a fixed point


# ---------------------------------------------------------------------------
# depth-independent LCE by snapshot descent
# ---------------------------------------------------------------------------


def _lce_descent(ranks, P, a, b, n: int, bits: int, D: int, ks: tuple):
    """lce(a, b) from the doubling certificates: descend the snapshot
    levels from the deepest (``rank_k[x] == rank_k[y]`` iff ``lce(x, y)
    >= k``), each accepted at most once, then the remainder below
    ``ks[0]`` from packed words.  int64, O(#levels) gathers per pair
    whatever the depth."""
    a = a.to(_I64)
    b = b.to(_I64)
    l = torch.zeros_like(a)
    for k, r in zip(ks[::-1], ranks[::-1]):
        ia = a + l
        ib = b + l
        eq = ((ia < n) & (ib < n)
              & (r[ia.clamp(max=n - 1)] == r[ib.clamp(max=n - 1)]))
        l = torch.where(eq, l + k, l)
    done = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    for _ in range(max(1, -(-(ks[0] - 1) // D))):
        rem = _word_rem(P, P, a + l, b + l, n, n, bits, D)
        l = l + torch.where(done, 0, rem)
        done = done | (rem < D)
    return l


def lce_with_snapshots(snaps, P, a_dev, b_dev, n: int, sigma: int):
    """lce of the suffix pairs (a, b) of the sorted text (int32 [m]):
    the snapshot descent, then the ladder for every pair whose next char
    still matches (a descent capped by :func:`snapshot_cap` can stop
    short of the lce).  The JAX module marks a pair unfinished only when
    the whole next word matches, so an lce that ends inside that word
    comes back short there (fault F1); here ``rem > 0`` is the test."""
    bits, D = lce_pack_params(sigma)
    ks = tuple(k for k, _ in snaps)
    l = _lce_descent([r for _, r in snaps], P, a_dev, b_dev, n, bits, D, ks)
    unresolved = _word_rem(P, P, a_dev.to(_I64) + l, b_dev.to(_I64) + l,
                           n, n, bits, D) > 0
    return device_lce_pairs(None, n, sigma, a_dev, b_dev,
                            int(a_dev.numel()), tables=P, init_l=l,
                            active0=unresolved)


def device_suf_lcp(text_dev, n: int, sigma: int):
    """Suffix sort + adjacent-pair LCP on the text's device.

    Returns (sa [n], lcp [n] with lcp[0] = 0), int32 (sentinel rank n
    excluded)."""
    sa = device_suffix_sort(text_dev, n, sigma)
    with phase("lce ladder"):
        bits, D = lce_pack_params(sigma)
        tables = _lce_tables(text_dev, n, bits, D)
        lcp_rest = device_lce_pairs(text_dev, n, sigma, sa[:-1], sa[1:],
                                    n - 1, tables=tables)
        lcp = torch.cat([lcp_rest.new_zeros(1), lcp_rest])
    return sa, lcp


# ---------------------------------------------------------------------------
# host wrappers
# ---------------------------------------------------------------------------


def _text_sigma(text_np: np.ndarray, sigma: int | None) -> int:
    if sigma is not None:
        return int(sigma)
    regular = text_np[text_np < WILDCARD]
    return int(regular.max()) + 1 if regular.size else 1


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def suffix_sort_host(text_np: np.ndarray, sigma: int | None = None, *,
                     device):
    """(suftab[n+1], stitab[n+1]) as host int32 arrays (sentinel
    included), sorted on ``device``."""
    n = int(text_np.size)
    if n > MAX_N:
        raise ValueError(
            f"input of {n} symbols exceeds the int32 rank limit "
            f"({MAX_N}); split the input")
    if n == 0:
        return np.array([0], np.int32), np.array([0], np.int32)
    sa = device_suffix_sort(_to_device(text_np, device), n,
                            _text_sigma(text_np, sigma))
    suftab = np.empty(n + 1, np.int32)
    suftab[:n] = sa.cpu().numpy()
    suftab[n] = n
    stitab = np.empty(n + 1, np.int32)
    stitab[suftab] = np.arange(n + 1, dtype=np.int32)
    return suftab, stitab


def suf_lcp_host(text_np: np.ndarray, sigma: int | None = None, *,
                 device):
    """(suftab[n+1], lcptab[n+1]) as host int32 arrays, built on
    ``device``."""
    n = int(text_np.size)
    if n > MAX_N:
        raise ValueError(
            f"input of {n} symbols exceeds the int32 rank limit "
            f"({MAX_N}); split the input")
    if n == 0:
        return np.array([0], np.int32), np.zeros(1, np.int32)
    sa, lcp = device_suf_lcp(_to_device(text_np, device), n,
                             _text_sigma(text_np, sigma))
    with phase("suf/lcp to host"):
        suftab = np.empty(n + 1, np.int32)
        suftab[:n] = sa.cpu().numpy()
        suftab[n] = n
        lcptab = np.zeros(n + 1, np.int32)
        lcptab[1:n] = lcp.cpu().numpy()[1:]
    return suftab, lcptab


def lce_pairs_host(text_np: np.ndarray, a_np, b_np,
                   sigma: int | None = None, *, device) -> np.ndarray:
    """Vectorized lce over arbitrary suffix pairs (host in/out)."""
    n = int(text_np.size)
    m = int(np.asarray(a_np).size)
    if m == 0 or n == 0:
        return np.zeros(m, np.int32)
    out = device_lce_pairs(
        _to_device(text_np, device), n, _text_sigma(text_np, sigma),
        _to_device(np.asarray(a_np, np.int32), device),
        _to_device(np.asarray(b_np, np.int32), device), m)
    return out.cpu().numpy()

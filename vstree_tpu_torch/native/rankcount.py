"""K1: exact complete-match rank interval of a packed query batch.

Counterpart of the Pallas TPU kernel :func:`vstree_tpu.native.rankcount.
bucket_rank_lookup` together with the XLA code that feeds it
(``vstree_tpu.engine.complete._device_rank_lookup``): for every query
the whole-pattern rank interval ``[lo, hi)``, equal to the JAX package's
in every element.  The TPU cannot gather inside a kernel, so there the
host packs two base-(σ+1) key words for every suffix rank and XLA
gathers brackets and packs query keys in front of the kernel.  On Hopper
a thread gathers for itself: the CUDA kernel ``csrc/rankcount.cu`` takes
the packed queries, the bracket table (one int32 pair ``(left, width)``
per bucket code, where the TPU packs ``left | width << shift`` into one
int32), ``suf`` and the text, and binary-searches each bracket with the
key of a probed rank computed on the spot (its header says what bounds
it).  No per-rank table exists, and no bracket is too wide.

:func:`rank_interval_lookup` is the checked wrapper: the plain version
for CPU tensors only, the kernel (or an exception) for CUDA tensors.
:func:`rank_interval_lookup_ref` is the plain PyTorch version of the same
function, built from :func:`rank_lookup_inputs` (bracket and query
keys) and :func:`rank_key_words` (the key words of probed ranks, on the
fly); the tests hold it to the Pallas kernel.  :func:`bracket_table`
makes the bracket table from a depth-ppl bucket table.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_kernels

_KEY_CHUNK = 1 << 20  # ranks per on-the-fly key-word step

MAX_N = 1 << 30   # texts the kernel takes: n < MAX_N (int32 rank sums)

# bits of the error word (kernel and plain version alike)
ERR_BRACKET = 1   # a bucket bracket reaches outside ranks [0, n+1]
ERR_LENGTH = 2    # a query is longer than the two-word coverage

_I32 = torch.int32
_I64 = torch.int64


@functools.cache
def _kernel():
    fn = load_kernels()["rankcount"].vstree_rankcount
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(flat8, bck, suf, text, n: int, ppl: int, cpw: int,
           sigma: int) -> int:
    """Device, dtype, shape and contiguity, and the scalars; returns the
    batch size.  What depends on the values (brackets, lengths) the
    kernel checks itself and reports in its error word."""
    dev = flat8.device
    for name, t, dt in (("flat8", flat8, torch.int8), ("bck", bck, _I32),
                        ("suf", suf, _I32), ("text", text, torch.uint8)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"rank_interval_lookup: {name} must be a "
                             f"contiguous {dt} tensor, got {t.dtype}")
        if t.device != dev:
            raise ValueError("rank_interval_lookup: tensors on "
                             f"{t.device} and {dev}")
    if not (ppl >= 1 and cpw >= 1 and 1 <= sigma < 127
            and 0 <= n < MAX_N):
        raise ValueError(
            f"rank_interval_lookup: bad scalars n={n} ppl={ppl} cpw={cpw} "
            f"sigma={sigma}")
    if sigma ** ppl >= (1 << 31) or (sigma + 1) ** cpw >= (1 << 31):
        raise ValueError("rank_interval_lookup: bucket codes or key words "
                         "do not fit 31 bits")
    rows = ppl + 2 * cpw + 1
    if flat8.dim() != 1 or flat8.numel() % rows != 0:
        raise ValueError("rank_interval_lookup: flat8 must be 1-D of "
                         f"(ppl + 2*cpw + 1) = {rows} rows")
    if bck.dim() != 1 or bck.numel() != 2 * (sigma ** ppl + 1):
        raise ValueError("rank_interval_lookup: the bucket table must be "
                         "1-D, (left, width) for each of sigma**ppl codes "
                         "and the sentinel entry")
    if suf.dim() != 1 or suf.numel() != n + 1 or text.dim() != 1 \
            or text.numel() < n:
        raise ValueError("rank_interval_lookup: suf must be [n+1] and text "
                         "[>= n]")
    return flat8.numel() // rows


def rank_interval_lookup(flat8, bck, suf, text, n: int, ppl: int, cpw: int,
                         sigma: int):
    """Whole-pattern rank intervals ``[lo, hi)`` of a packed batch, as
    two int32 [B] tensors **on the CPU** (the caller expands them on the
    host; one copy brings both and the error word).

    ``flat8``: int8 [(ppl + 2*cpw + 1) * B], char-major (row j holds
    char j of every query, -1 padding, any value >= sigma a wildcard;
    the last row the lengths); ``bck``: int32 [2*(sigma**ppl + 1)], the
    bracket ``(left, width)`` of each bucket code of the first ``ppl``
    chars, plus a zero-width entry at code sigma**ppl; ``suf``: int32
    [n+1]; ``text``: uint8 [n].

    Raises ValueError if a bracket lies outside the ranks or a query is
    longer than ppl + 2*cpw chars."""
    B = _check(flat8, bck, suf, text, n, ppl, cpw, sigma)
    if flat8.device.type == "cpu":
        lo, hi, err = rank_interval_lookup_ref(flat8, bck, suf, text, n,
                                               ppl, cpw, sigma)
        err = int(err)
    elif flat8.device.type == "cuda":
        out = torch.empty(2 * B + 1, dtype=_I32, device=flat8.device)
        launch(flat8, bck, suf, text, out, n, ppl, cpw, sigma)
        host = out.cpu()
        lo, hi, err = host[:B], host[B:2 * B], int(host[2 * B])
    else:
        raise ValueError(
            f"rank_interval_lookup: no kernel for device {flat8.device}")
    if err & ERR_BRACKET:
        raise ValueError("rank_interval_lookup: a bucket bracket lies "
                         "outside the ranks [0, n+1]")
    if err & ERR_LENGTH:
        raise ValueError("rank_interval_lookup: a query is longer than "
                         f"ppl + 2*cpw = {ppl + 2 * cpw} chars")
    return lo, hi


def launch(flat8, bck, suf, text, out, n: int, ppl: int, cpw: int,
           sigma: int) -> None:
    """Launch the kernel on checked CUDA tensors into the preallocated
    int32 [2*B + 1] ``out`` (lo, then hi, then the error word, which the
    launch clears first).  What :func:`rank_interval_lookup` does after
    its checks; a timing loop calls it directly.  Counts the launch."""
    B = (out.numel() - 1) // 2
    if text.data_ptr() % 4:
        raise ValueError("rank_interval_lookup: the text must start at a "
                         "4-byte aligned address")
    if bck.data_ptr() % 8:
        raise ValueError("rank_interval_lookup: the bucket table must "
                         "start at an 8-byte aligned address")
    fn = _kernel()
    with torch.cuda.device(flat8.device):
        stream = torch.cuda.current_stream(flat8.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (flat8, bck, suf, text, out)),
                 B, int(n), int(ppl), int(cpw), int(sigma), sigma ** ppl,
                 stream)
    if err != 0:
        raise RuntimeError(
            f"rankcount kernel launch failed: cudaError {err}")
    rank_interval_lookup.launches += 1


rank_interval_lookup.launches = 0


def bracket_table(raw):
    """K1's bracket table from a bucket table ``raw`` (``[2*σ^ppl]``
    start and end rank of each bucket code, any integer dtype): int32
    ``[2*(σ^ppl + 1)]``, ``(left, width)`` per code, then the zero-width
    sentinel entry; on ``raw``'s device."""
    raw = torch.as_tensor(raw).to(_I64)
    out = torch.zeros(raw.numel() + 2, dtype=_I32, device=raw.device)
    out[0:-2:2] = raw[0::2]
    out[1:-2:2] = raw[1::2] - raw[0::2]
    return out


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def rank_lookup_inputs(flat8, bck, ppl: int, cpw: int, sigma: int):
    """Bucket code, bracket gather and base-(σ+1) key packing of a
    packed query batch (the XLA code in front of the TPU kernel).

    ``flat8``: int8 [(ppl + 2*cpw + 1) * B], char-major (row j holds
    char j of every query, the last row the lengths); ``bck``: int32
    ``(left, width)`` pairs, one per bucket code plus a zero-width
    sentinel entry at code σ^ppl.  Returns int32 [B] tensors
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
    pairs = bck.reshape(-1, 2)
    left = pairs[code, 0]
    width = pairs[code, 1]
    return left, width, q1l, q2l, q1h, q2h


def rank_key_words(suf, text, ranks, n: int, depth: int, cpw: int,
                   sigma: int):
    """The two base-(σ+1) key words of the suffixes at ``ranks``
    (int32/int64 [R] in [0, n]), int32 [R] each: word 1 is the Horner
    packing of chars ``text[suf[r] + depth + j]`` for j in [0, cpw),
    word 2 for j in [cpw, 2*cpw).  Digits: a regular char c -> c; from
    the first special char or the text end onwards every digit is σ.
    Keys are monotone over the ranks of one depth-``depth`` bucket
    (specials order by position, which within equal words is the rank
    order itself)."""
    base = sigma + 1
    dev = ranks.device
    offs = depth + torch.arange(2 * cpw, dtype=_I64, device=dev)
    out1, out2 = [], []
    for c0 in range(0, ranks.numel(), _KEY_CHUNK):
        st = suf[ranks[c0:c0 + _KEY_CHUNK].to(_I64)].to(_I64)
        idx = st[:, None] + offs[None, :]
        if n > 0:
            # uint8 text values index as int64 (a uint8 index is a mask)
            ch = text[idx.clamp(max=n - 1)].to(_I64)
            special = (idx >= n) | (ch >= sigma)
        else:
            ch = torch.zeros_like(idx)
            special = torch.ones_like(idx, dtype=torch.bool)
        sat = torch.cumsum(special, 1, dtype=_I32) > 0
        dig = torch.where(sat, sigma, ch)
        w1 = torch.zeros_like(st)
        w2 = torch.zeros_like(st)
        for j in range(cpw):
            w1 = w1 * base + dig[:, j]
            w2 = w2 * base + dig[:, cpw + j]
        out1.append(w1.to(_I32))
        out2.append(w2.to(_I32))
    if not out1:
        z = torch.zeros(0, dtype=_I32, device=dev)
        return z, z.clone()
    return torch.cat(out1), torch.cat(out2)


def rank_interval_lookup_ref(flat8, bck, suf, text, n: int, ppl: int,
                             cpw: int, sigma: int):
    """Plain PyTorch version of :func:`rank_interval_lookup`, on any
    device: (lo, hi, error word), int32 [B], [B] and a 0-d tensor.

    The kernel's function by the kernel's rule: per query a binary
    search of its bracket for ``lo``, then of ``[lo, end)`` for ``hi``,
    all queries in lockstep, the key words of each probed rank made by
    :func:`rank_key_words`; B·log2(widest bracket) probes, so shallow
    bucket depths (brackets of n/σ^ppl ranks) cost no more than a log."""
    left, width, q1l, q2l, q1h, q2h = rank_lookup_inputs(
        flat8, bck, ppl, cpw, sigma)
    plen = flat8.reshape(ppl + 2 * cpw + 1, -1)[-1]
    outside = (left < 0) | (width < 0) | (left.to(_I64) + width > n + 1)
    err = (outside.any().to(_I32) * ERR_BRACKET
           | (plen > ppl + 2 * cpw).any().to(_I32) * ERR_LENGTH)
    left = left.to(_I64)
    end = left + torch.where(outside, 0, width).to(_I64)
    lo = _first_rank(suf, text, n, ppl, cpw, sigma, left, end, q1l, q2l,
                     above=False)
    hi = _first_rank(suf, text, n, ppl, cpw, sigma, lo, end, q1h, q2h,
                     above=True)
    return lo.to(_I32), hi.to(_I32), err


def _first_rank(suf, text, n: int, depth: int, cpw: int, sigma: int, a, b,
                k1, k2, above: bool):
    """Per query, the first rank of ``[a, b)`` whose key is > (``above``)
    or >= the key ``(k1, k2)``, ``b`` where none is: keys are monotone
    over the ranks of a bucket.  Binary searches in lockstep over the
    queries still open."""
    a, b = a.clone(), b.clone()
    act = torch.nonzero(a < b)[:, 0]
    while act.numel():
        mid = (a[act] + b[act]) // 2
        w1, w2 = rank_key_words(suf, text, mid, n, depth, cpw, sigma)
        q1, q2 = k1[act], k2[act]
        before = (w1 < q1) | ((w1 == q1) & (w2 < q2))
        if above:
            before |= (w1 == q1) & (w2 == q2)
        a[act] = torch.where(before, mid + 1, a[act])
        b[act] = torch.where(before, b[act], mid)
        act = act[a[act] < b[act]]
    return a

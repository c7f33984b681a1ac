"""K1: exact complete-match rank interval of a packed query batch.

Counterpart of the Pallas TPU kernel :func:`vstree_tpu.native.rankcount.
bucket_rank_lookup` together with the XLA code that feeds it
(``vstree_tpu.engine.complete._device_rank_lookup``): for every query
the whole-pattern rank interval ``[lo, hi)``, equal to the JAX package's
in every element.  The TPU cannot gather inside a kernel, so there the
host packs two base-(σ+1) key words for every suffix rank and XLA
gathers brackets and packs query keys in front of the kernel.  On Hopper
a thread gathers for itself: the CUDA kernel ``csrc/rankcount.cu`` takes
the packed queries, the packed bucket table, ``suf`` and the text, and
binary-searches each bracket with the key of a probed rank computed on
the spot (its header says what bounds it).  No per-rank table exists.

:func:`rank_interval_lookup` is the checked wrapper: the plain version
for CPU tensors only, the kernel (or an exception) for CUDA tensors.
:func:`rank_interval_lookup_ref` is the plain PyTorch version of the same
function, built from :func:`rank_lookup_inputs` (bracket and query
keys), :func:`rank_key_words` (the key words of the bracket's ranks, on
the fly) and :func:`bucket_rank_lookup_ref` (the windowed count, the
twin of the JAX package's ``bucket_rank_lookup_xla``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_kernels

_REF_CHUNK = 1 << 14  # queries per windowed gather of the plain version
_KEY_CHUNK = 1 << 20  # ranks per on-the-fly key-word step

# bits of the error word (kernel and plain version alike)
ERR_BRACKET = 1   # a bucket bracket reaches outside ranks [0, n+1]
ERR_LENGTH = 2    # a query is longer than the two-word coverage

_I32 = torch.int32
_I64 = torch.int64


@functools.cache
def _kernel():
    fn = load_kernels()["rankcount"].vstree_rankcount
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(flat8, bck, suf, text, n: int, ppl: int, cpw: int, sigma: int,
           shift: int) -> int:
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
            and 1 <= shift <= 30 and 0 <= n < (1 << 30)):
        raise ValueError(
            f"rank_interval_lookup: bad scalars n={n} ppl={ppl} cpw={cpw} "
            f"sigma={sigma} shift={shift}")
    if sigma ** ppl >= (1 << 31) or (sigma + 1) ** cpw >= (1 << 31):
        raise ValueError("rank_interval_lookup: bucket codes or key words "
                         "do not fit 31 bits")
    rows = ppl + 2 * cpw + 1
    if flat8.dim() != 1 or flat8.numel() % rows != 0:
        raise ValueError("rank_interval_lookup: flat8 must be 1-D of "
                         f"(ppl + 2*cpw + 1) = {rows} rows")
    if bck.numel() <= sigma ** ppl:
        raise ValueError("rank_interval_lookup: the bucket table lacks its "
                         "sentinel entry at code sigma**ppl")
    if suf.dim() != 1 or suf.numel() != n + 1 or text.dim() != 1 \
            or text.numel() < n:
        raise ValueError("rank_interval_lookup: suf must be [n+1] and text "
                         "[>= n]")
    return flat8.numel() // rows


def rank_interval_lookup(flat8, bck, suf, text, n: int, ppl: int, cpw: int,
                         sigma: int, shift: int):
    """Whole-pattern rank intervals ``[lo, hi)`` of a packed batch, as
    two int32 [B] tensors **on the CPU** (the caller expands them on the
    host; one copy brings both and the error word).

    ``flat8``: int8 [(ppl + 2*cpw + 1) * B], char-major (row j holds
    char j of every query, -1 padding, any value >= sigma a wildcard;
    the last row the lengths); ``bck``: int32, ``left | width << shift``
    per bucket code of the first ``ppl`` chars, plus a zero-width entry
    at code sigma**ppl; ``suf``: int32 [n+1]; ``text``: uint8 [n].

    Raises ValueError if a bracket lies outside the ranks or a query is
    longer than ppl + 2*cpw chars."""
    B = _check(flat8, bck, suf, text, n, ppl, cpw, sigma, shift)
    if flat8.device.type == "cpu":
        lo, hi, err = rank_interval_lookup_ref(flat8, bck, suf, text, n,
                                               ppl, cpw, sigma, shift)
        err = int(err)
    elif flat8.device.type == "cuda":
        out = torch.empty(2 * B + 1, dtype=_I32, device=flat8.device)
        launch(flat8, bck, suf, text, out, n, ppl, cpw, sigma, shift)
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
           sigma: int, shift: int) -> None:
    """Launch the kernel on checked CUDA tensors into the preallocated
    int32 [2*B + 1] ``out`` (lo, then hi, then the error word, which the
    launch clears first).  What :func:`rank_interval_lookup` does after
    its checks; a timing loop calls it directly.  Counts the launch."""
    B = (out.numel() - 1) // 2
    if text.data_ptr() % 4:
        raise ValueError("rank_interval_lookup: the text must start at a "
                         "4-byte aligned address")
    fn = _kernel()
    with torch.cuda.device(flat8.device):
        stream = torch.cuda.current_stream(flat8.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (flat8, bck, suf, text, out)),
                 B, int(n), int(ppl), int(cpw), int(sigma), int(shift),
                 sigma ** ppl, stream)
    if err != 0:
        raise RuntimeError(
            f"rankcount kernel launch failed: cudaError {err}")
    rank_interval_lookup.launches += 1


rank_interval_lookup.launches = 0


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def rank_lookup_inputs(flat8, bck, ppl: int, cpw: int, sigma: int,
                       shift: int):
    """Bucket code, bracket gather and base-(σ+1) key packing of a
    packed query batch (the XLA code in front of the TPU kernel).

    ``flat8``: int8 [(ppl + 2*cpw + 1) * B], char-major (row j holds
    char j of every query, the last row the lengths); ``bck``: int32,
    ``left | width << shift`` per bucket code plus a zero-width sentinel
    entry at code σ^ppl.  Returns int32 [B] tensors
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
                             cpw: int, sigma: int, shift: int):
    """Plain PyTorch version of :func:`rank_interval_lookup`, on any
    device: (lo, hi, error word), int32 [B], [B] and a 0-d tensor.

    Per chunk of queries the ranks of all brackets are laid end to end
    in a small key-word table made on the fly, and counted by
    :func:`bucket_rank_lookup_ref` with the brackets moved there."""
    left, width, q1l, q2l, q1h, q2h = rank_lookup_inputs(
        flat8, bck, ppl, cpw, sigma, shift)
    dev = left.device
    plen = flat8.reshape(ppl + 2 * cpw + 1, -1)[-1]
    # the logical shift of a negative packed entry gives a huge width
    outside = (width < 0) | (left.to(_I64) + width > n + 1)
    err = (outside.any().to(_I32) * ERR_BRACKET
           | (plen > ppl + 2 * cpw).any().to(_I32) * ERR_LENGTH)
    width = torch.where(outside, 0, width)
    los, his = [], []
    B = left.numel()
    maxw = int(width.max()) if B else 0
    rowspan = max(1, (maxw + 254) // 128)
    step = max(1, _REF_CHUNK // rowspan)
    for c in range(0, B, step):
        sl = slice(c, c + step)
        lft, wid = left[sl], width[sl]
        end = torch.cumsum(wid, 0, dtype=_I32)
        off = end - wid
        total = int(end[-1])
        # slot s of the local table holds rank lft[q] + (s - off[q])
        owner = torch.repeat_interleave(
            torch.arange(wid.numel(), device=dev), wid.to(_I64),
            output_size=total)
        ranks = (lft[owner] + torch.arange(total, dtype=_I32, device=dev)
                 - off[owner])
        w1, w2 = rank_key_words(suf, text, ranks, n, ppl, cpw, sigma)
        rows = (total + 127) // 128 + rowspan
        t1 = torch.full((rows * 128,), torch.iinfo(_I32).max, dtype=_I32,
                        device=dev)
        t2 = t1.clone()
        t1[:total] = w1
        t2[:total] = w2
        l, h = bucket_rank_lookup_ref(
            off, wid, q1l[sl], q2l[sl], q1h[sl], q2h[sl],
            t1.reshape(rows, 128), t2.reshape(rows, 128), rowspan)
        los.append(lft + (l - off))
        his.append(lft + (h - off))
    if not los:
        return left.clone(), left.clone(), err
    return torch.cat(los), torch.cat(his), err


def bucket_rank_lookup_ref(left, width, q1l, q2l, q1h, q2h, t1, t2,
                           rowspan: int):
    """[lo, hi) rank interval of the ranks whose keys lie in
    [qlow, qhigh] within each bracket ``[left, left + width)`` of the
    (ROWS, 128) int32 key-word tables ``t1``/``t2``, by windowed gathers
    of ``rowspan`` aligned rows per query (``width`` must be below
    ``rowspan*128 - 127``); int32 [B] each, on any device."""
    W = rowspan * 128
    t1f = t1.reshape(-1)
    t2f = t2.reshape(-1)
    offs = torch.arange(W, dtype=_I32, device=left.device)
    los, his = [], []
    for c in range(0, left.numel(), _REF_CHUNK):
        sl = slice(c, c + _REF_CHUNK)
        lft = left[sl][:, None]
        hiv = lft + width[sl][:, None]
        # left >= 0, so the arithmetic shift is the logical one
        j = (lft >> 7) * 128 + offs[None, :]
        jc = j.clamp(max=t1f.numel() - 1)
        w1 = t1f[jc]
        w2 = t2f[jc]
        inwin = (j >= lft) & (j < hiv)
        a1, a2 = q1l[sl][:, None], q2l[sl][:, None]
        b1, b2 = q1h[sl][:, None], q2h[sl][:, None]
        wless = (w1 < a1) | ((w1 == a1) & (w2 < a2))
        wleq = (w1 < b1) | ((w1 == b1) & (w2 <= b2))
        los.append(left[sl] + (inwin & wless).sum(1, dtype=torch.int32))
        his.append(left[sl] + (inwin & wleq).sum(1, dtype=torch.int32))
    if not los:
        return left.clone(), left.clone()
    return torch.cat(los), torch.cat(his)

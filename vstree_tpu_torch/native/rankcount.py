"""K1: exact complete-match interval lookup (windowed rank count).

Port of the Pallas TPU kernel :func:`vstree_tpu.native.rankcount.
bucket_rank_lookup` (see that module for the key encoding).  The CUDA
kernel is ``csrc/rankcount.cu`` (one warp per query, ballot counts; its
header says what bounds it on Hopper); :func:`bucket_rank_lookup_ref` is
its plain PyTorch version, the twin of ``bucket_rank_lookup_xla``.

:func:`bucket_rank_lookup` takes the plain version for CPU tensors only;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_kernels

_REF_CHUNK = 1 << 14  # queries per windowed gather of the plain version


@functools.cache
def _kernel():
    fn = load_kernels()["rankcount"].vstree_rankcount
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(left, width, q1l, q2l, q1h, q2h, t1, t2, rowspan: int) -> None:
    """Device, dtype, shape, contiguity and the window contract: every
    bracket lies inside the tables and spans < rowspan*128 - 127 ranks
    (then the aligned rowspan-row window covers it whole)."""
    vecs = (left, width, q1l, q2l, q1h, q2h)
    dev = left.device
    for t in vecs + (t1, t2):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("bucket_rank_lookup takes contiguous int32 "
                             f"tensors, got {t.dtype}")
        if t.device != dev:
            raise ValueError("bucket_rank_lookup: tensors on "
                             f"{t.device} and {dev}")
    if any(v.dim() != 1 or v.shape != left.shape for v in vecs):
        raise ValueError("bucket_rank_lookup: left/width/keys must be "
                         "1-D of one length")
    if t1.dim() != 2 or t1.shape[1] != 128 or t2.shape != t1.shape:
        raise ValueError("bucket_rank_lookup: t1/t2 must be (ROWS, 128)")
    if rowspan < 1:
        raise ValueError(f"bucket_rank_lookup: rowspan {rowspan} < 1")
    if left.numel() == 0:
        return
    wmax, wmin, lmin, end = torch.stack([
        width.max(), width.min(), left.min(), (left + width).max(),
    ]).tolist()
    if wmin < 0 or lmin < 0 or end > t1.numel():
        raise ValueError("bucket_rank_lookup: a bracket lies outside "
                         "the key tables")
    if wmax >= rowspan * 128 - 127:
        raise ValueError(
            f"bucket_rank_lookup: bucket width {wmax} needs "
            f"< rowspan*128 - 127 = {rowspan * 128 - 127}")


def bucket_rank_lookup(left, width, q1l, q2l, q1h, q2h, t1, t2,
                       rowspan: int):
    """[lo, hi) rank interval of the suffixes whose keys lie in
    [qlow, qhigh] within each pre-gathered bracket
    ``[left, left + width)``; int32 [B] each.  ``t1``/``t2`` are the
    (ROWS, 128) int32 key-word tables of ``ESA.rank_words``."""
    _check(left, width, q1l, q2l, q1h, q2h, t1, t2, rowspan)
    if left.device.type == "cpu":
        return bucket_rank_lookup_ref(left, width, q1l, q2l, q1h, q2h,
                                      t1, t2, rowspan)
    if left.device.type != "cuda":
        raise ValueError(
            f"bucket_rank_lookup: no kernel for device {left.device}")
    lo = torch.empty_like(left)
    hi = torch.empty_like(left)
    if left.numel() > 0:
        launch(left, width, q1l, q2l, q1h, q2h, t1, t2, lo, hi)
    return lo, hi


def launch(left, width, q1l, q2l, q1h, q2h, t1, t2, lo, hi) -> None:
    """Launch the kernel on checked CUDA tensors into the preallocated
    int32 [B] outputs (what :func:`bucket_rank_lookup` does after its
    checks; a timing loop calls it directly).  Counts the launch."""
    fn = _kernel()
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream(left.device).cuda_stream
        err = fn(*(t.data_ptr() for t in
                   (left, width, q1l, q2l, q1h, q2h, t1, t2, lo, hi)),
                 int(left.numel()), stream)
    if err != 0:
        raise RuntimeError(
            f"rankcount kernel launch failed: cudaError {err}")
    bucket_rank_lookup.launches += 1


bucket_rank_lookup.launches = 0


def bucket_rank_lookup_ref(left, width, q1l, q2l, q1h, q2h, t1, t2,
                           rowspan: int):
    """Plain PyTorch version of :func:`bucket_rank_lookup` (windowed
    gathers of ``rowspan`` aligned rows per query), on any device."""
    W = rowspan * 128
    t1f = t1.reshape(-1)
    t2f = t2.reshape(-1)
    offs = torch.arange(W, dtype=torch.int32, device=left.device)
    los, his = [], []
    for c in range(0, left.numel(), _REF_CHUNK):
        sl = slice(c, c + _REF_CHUNK)
        lft = left[sl][:, None]
        hiv = lft + width[sl][:, None]
        # left >= 0 (checked), so the arithmetic shift is the logical one
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

"""K2: Myers bit-vector edit-distance verification of candidate windows.

Port of the Pallas TPU kernel :func:`vstree_tpu.native.myers.
myers_verify32` and of its wrapper ``verify_edit_pallas`` (see that
module for the role of the three outputs in ``-complete -e``).  The CUDA
kernel is ``csrc/myers.cu`` (one thread per candidate, state in
registers; its header says what bounds it on Hopper).
:func:`myers_verify_torch` is the same recurrence in plain PyTorch for
patterns of any number of 32-bit words (the twin of the JAX package's
``_verify_edit_jnp``); :func:`verify_edit_ref` is its single-word case,
the kernel's plain version.

:func:`verify_edit` takes the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises.  The checks that depend
on the tensors' values are made by the kernel (its error word).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.chardef import SEPARATOR
from .build import load_kernels

_REF_ELEMS = 1 << 24  # window elements (candidates x columns) per chunk
_MASK = 0xFFFFFFFF
_I64 = torch.int64


# bits of the error word (kernel and plain check alike)
ERR_CANDIDATE = 1  # a candidate position below 0
ERR_QUERY = 2      # a query number outside [0, Q)
ERR_LENGTH = 4     # a pattern length outside 1..32


@functools.cache
def _kernel():
    fn = load_kernels()["myers"].vstree_myers
    fn.argtypes = ([ctypes.c_void_p] * 6
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(text, cand, qidx, eqs0, plens, L: int, n: int) -> None:
    """Device, dtype, shape and contiguity, and the scalars.  What
    depends on the values (candidates, query numbers, pattern lengths)
    the kernel checks itself and reports in its error word; for CPU
    tensors :func:`value_errors` computes the same word."""
    dev = text.device
    for name, t, dt, dim in (("text", text, torch.uint8, 1),
                             ("cand", cand, torch.int32, 1),
                             ("qidx", qidx, torch.int32, 1),
                             ("eqs0", eqs0, torch.int32, 2),
                             ("plens", plens, torch.int32, 1)):
        if t.dtype != dt or t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"verify_edit: {name} must be a contiguous "
                             f"{dim}-D {dt} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"verify_edit: tensors on {t.device} and {dev}")
    if cand.shape != qidx.shape:
        raise ValueError("verify_edit: cand and qidx differ in length")
    if eqs0.shape != (plens.numel(), 256):
        raise ValueError("verify_edit: eqs0 must be [Q, 256] for plens [Q]")
    if not 0 <= n <= text.numel() or L < 0:
        raise ValueError(f"verify_edit: n={n} L={L} outside the text")


def value_errors(cand, qidx, plens) -> int:
    """The kernel's error word in plain PyTorch: which candidates, query
    numbers or pattern lengths of the candidates' queries are outside
    what the kernel indexes with."""
    if cand.numel() == 0:
        return 0
    bad_q = (qidx < 0) | (qidx >= plens.numel())
    pl = plens[qidx.to(_I64).clamp(0, plens.numel() - 1)]
    flags = torch.stack([(cand < 0).any(), bad_q.any(),
                         (~bad_q & ((pl < 1) | (pl > 32))).any()]).tolist()
    return sum(bit for bit, on in zip(
        (ERR_CANDIDATE, ERR_QUERY, ERR_LENGTH), flags) if on)


def _raise_for(err: int) -> None:
    if err & (ERR_CANDIDATE | ERR_QUERY):
        raise ValueError("verify_edit: a candidate or query index is out "
                         "of range")
    if err & ERR_LENGTH:
        raise ValueError("verify_edit: pattern lengths must be 1..32")


def verify_edit(text, cand, qidx, eqs0, plens, L: int, n: int):
    """(minsc, bestlen, bestsc), int32 [P] each, of the single-word
    Myers DP of pattern ``qidx[i]`` over the ``L`` text columns from
    ``cand[i]``, stopped at the first SEPARATOR (past the text end
    counts as one).

    ``text`` uint8 [>= n]; ``cand``, ``qidx`` int32 [P]; ``eqs0`` int32
    [Q, 256], the bit patterns of the uint32 Eq masks; ``plens`` int32
    [Q], 1..32.  Raises ValueError for a candidate below 0, a query
    number outside [0, Q) or a pattern length outside 1..32 (on the card
    the kernel finds them, and the wrapper waits for its error word)."""
    _check(text, cand, qidx, eqs0, plens, L, n)
    P = cand.numel()
    if text.device.type == "cpu":
        _raise_for(value_errors(cand, qidx, plens))
        return verify_edit_ref(text, cand, qidx, eqs0, plens, L, n)
    if text.device.type != "cuda":
        raise ValueError(f"verify_edit: no kernel for device {text.device}")
    out = torch.empty(3 * P + 1, dtype=torch.int32, device=text.device)
    if P > 0:
        launch(text, cand, qidx, eqs0, plens, out, L, n)
        _raise_for(int(out[3 * P]))
    return out[:P], out[P:2 * P], out[2 * P:3 * P]


def launch(text, cand, qidx, eqs0, plens, out, L: int, n: int) -> None:
    """Launch the kernel on checked CUDA tensors into the preallocated
    int32 [3*P + 1] ``out`` (minsc, bestlen, bestsc, then the error
    word, which the launch clears first).  What :func:`verify_edit` does
    after its checks; a timing loop calls it directly.  Counts the
    launch."""
    fn = _kernel()
    with torch.cuda.device(text.device):
        stream = torch.cuda.current_stream(text.device).cuda_stream
        err = fn(*(t.data_ptr() for t in
                   (text, cand, qidx, eqs0, plens, out)),
                 int(cand.numel()), int(plens.numel()), int(L), int(n),
                 stream)
    if err != 0:
        raise RuntimeError(f"myers kernel launch failed: cudaError {err}")
    verify_edit.launches += 1


verify_edit.launches = 0


def verify_edit_ref(text, cand, qidx, eqs0, plens, L: int, n: int):
    """Plain PyTorch version of :func:`verify_edit`, on any device."""
    return myers_verify_torch(text, cand, qidx, eqs0[:, None, :], plens, 1,
                              L, n)


def myers_verify_torch(text, cand, qidx, eqs, plens, w: int, L: int,
                       n: int):
    """Multiword Myers (1999) / Hyyro verification in torch ops, chunked
    over the candidates.  ``eqs``: [Q, w, 256] Eq masks, any integer
    dtype (only the low 32 bits of a word count).  Per candidate:
    (min score over lengths, bestlen, bestscore), int32 [P]; the
    longest-match rule updates when score <= stored and stops at the
    first SEPARATOR (longestmatch.c:6-11,40-45).

    Words are held in int64 masked to 32 bits, so the carry of the
    unsigned add is bit 32 and every ``>>`` is the logical one."""
    P = cand.numel()
    if P == 0:
        z = torch.zeros(0, dtype=torch.int32, device=cand.device)
        return z, z.clone(), z.clone()
    step = max(1, _REF_ELEMS // max(L, 1))
    pl_all = plens.to(_I64)
    outs = [_myers_chunk(text, cand[c:c + step], qidx[c:c + step], eqs,
                         pl_all, w, L, n) for c in range(0, P, step)]
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


def _myers_chunk(text, cand, qidx, eqs, plens, w: int, L: int, n: int):
    dev = cand.device
    P = cand.numel()
    q = qidx.to(_I64)
    idx = cand.to(_I64)[:, None] + torch.arange(L, dtype=_I64, device=dev)
    inb = (idx >= 0) & (idx < n)
    # uint8 text values index as int64 (a uint8 index tensor is a mask)
    if n > 0:
        window = torch.where(inb, text[idx.clamp(0, n - 1)].to(_I64),
                             SEPARATOR)
    else:
        window = torch.full_like(idx, SEPARATOR)
    pl = plens[q]
    top_word = (pl - 1) // 32
    top_shift = (pl - 1) % 32
    Pv = [torch.full((P,), _MASK, dtype=_I64, device=dev) for _ in range(w)]
    Mv = [torch.zeros(P, dtype=_I64, device=dev) for _ in range(w)]
    score = pl.clone()
    minsc = pl.clone()
    bestlen = torch.zeros(P, dtype=_I64, device=dev)
    bestsc = pl.clone()
    sepseen = torch.zeros(P, dtype=torch.bool, device=dev)
    for l in range(L):
        ch = window[:, l]
        Eq = [eqs[q, j, ch].to(_I64) & _MASK for j in range(w)]
        carry = 0
        Xh = []
        for j in range(w):
            s = (Eq[j] & Pv[j]) + Pv[j] + carry
            carry = s >> 32
            Xh.append(((s & _MASK) ^ Pv[j]) | Eq[j])
        Xv = [Eq[j] | Mv[j] for j in range(w)]
        Ph = [Mv[j] | (~(Xh[j] | Pv[j]) & _MASK) for j in range(w)]
        Mh = [Pv[j] & Xh[j] for j in range(w)]
        # top-row bit of the per-candidate top word
        ph_top, mh_top = Ph[0], Mh[0]
        for j in range(1, w):
            sel = top_word == j
            ph_top = torch.where(sel, Ph[j], ph_top)
            mh_top = torch.where(sel, Mh[j], mh_top)
        score = (score + ((ph_top >> top_shift) & 1)
                 - ((mh_top >> top_shift) & 1))
        ph_c, mh_c = 1, 0
        for j in range(w):
            Ph_s = ((Ph[j] << 1) | ph_c) & _MASK
            Mh_s = ((Mh[j] << 1) | mh_c) & _MASK
            ph_c, mh_c = Ph[j] >> 31, Mh[j] >> 31
            Pv[j] = Mh_s | (~(Xv[j] | Ph_s) & _MASK)
            Mv[j] = Ph_s & Xv[j]
        # the reference scan STOPS at a SEPARATOR (esaapm.c:266-269):
        # windows crossing one never count, for existence or length
        sepseen = sepseen | (ch == SEPARATOR)
        minsc = torch.where(sepseen, minsc, torch.minimum(minsc, score))
        upd = ~sepseen & (bestsc >= score)
        bestlen = torch.where(upd, l + 1, bestlen)
        bestsc = torch.where(upd, score, bestsc)
    return tuple(t.to(torch.int32) for t in (minsc, bestlen, bestsc))

"""Batched longest-common-extension between two encoded texts, in NumPy.

Copy of :func:`vstree_tpu.ops.lce.lce_two_texts`, the plain twin of the
packed-word ladder on the device (``index/sort.py::device_lce_pairs``,
which :class:`vstree_tpu_torch.engine.gextend.Seqs` runs): the tests hold
the two against each other.  Match rule everywhere: bytes equal AND
regular.  Special characters (wildcards, separators) and positions at or
past the end match nothing, not even themselves (chardef semantics;
reference kurtz/maxpref.c CHECKRETURN)."""

from __future__ import annotations

import numpy as np

from ..core.chardef import WILDCARD


def lce_two_texts(
    ta_np: np.ndarray,
    a_np: np.ndarray,
    tb_np: np.ndarray,
    b_np: np.ndarray,
    ta_dev=None,
    tb_dev=None,
) -> np.ndarray:
    """lce[i] = longest common extension of ta[a[i]..] vs tb[b[i]..].

    Host-windowed numpy compares: RAM gathers beat device random
    gathers by orders of magnitude for this access pattern (TPU
    gathers are row-oriented); the texts stay host-resident anyway.
    ``ta_dev``/``tb_dev`` are accepted for API compatibility.
    """
    na, nb = int(ta_np.size), int(tb_np.size)
    m = int(a_np.size)
    if m == 0:
        return np.zeros(0, np.int32)
    a = np.asarray(a_np, dtype=np.int64)
    b = np.asarray(b_np, dtype=np.int64)
    lce = np.zeros(m, np.int64)
    act = np.arange(m)
    w = 8          # most extensions stop within a few chars
    off = 0
    while act.size:
        offs = np.arange(w)
        ia = a[act][:, None] + off + offs[None, :]
        ib = b[act][:, None] + off + offs[None, :]
        va = ia < na
        vb = ib < nb
        ca = ta_np[np.minimum(ia, na - 1)]
        cb = tb_np[np.minimum(ib, nb - 1)]
        nomatch = ~(va & vb & (ca == cb) & (ca < WILDCARD))
        # leading run of matches = first mismatch index (w if none);
        # bool argmax beats the former int cumprod by ~10x
        full = ~nomatch.any(axis=1)
        run = np.where(full, w, np.argmax(nomatch, axis=1))
        lce[act] += run
        act = act[full]
        off += w
        if w < 1024:
            w *= 4
    return lce.astype(np.int32)

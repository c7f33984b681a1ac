"""Debug levels (``VSTREEDEBUGLEVEL``) and the embedded index verifier.

Reference analog: the DEBUGLEVEL environment variable (0-6,
include/debugdef.h:40-67) gating verifiers compiled into DEBUG builds
(checksuftab/checklcpsubtab bese.c:355/454).  ``debug_level`` is the
JAX package's minus its level-3 ``jax_debug_nans`` switch, which has no
use in the port's integer code; ``check_suftab`` is its NumPy verifier,
copied.

- level >= 1: sampled suffix-order and lcp verification after every
  index build (a vectorized checksuftab/checklcpsubtab),
- level >= 2: full-table verification.
"""

from __future__ import annotations

import os

import numpy as np

from .chardef import WILDCARD


def debug_level() -> int:
    v = os.environ.get("VSTREEDEBUGLEVEL")
    if v is None:
        return 0
    try:
        return int(v)
    except ValueError:
        raise SystemExit(
            f'illegal value "{v}" of environment variable '
            "VSTREEDEBUGLEVEL: must be integer in range [0,6]")


def _suffix_less(text: np.ndarray, a: int, b: int) -> bool:
    """Reference suffix order: regular by code, special > regular,
    specials by position, sentinel largest."""
    n = text.size
    while True:
        if a >= n:
            return False          # a is the sentinel: largest
        if b >= n:
            return True
        ca, cb = int(text[a]), int(text[b])
        sa, sb = ca >= WILDCARD, cb >= WILDCARD
        if sa or sb:
            if sa and sb:
                return a < b
            return sb             # special beats regular
        if ca != cb:
            return ca < cb
        a += 1
        b += 1


def check_suftab(text: np.ndarray, suftab: np.ndarray,
                 lcptab: np.ndarray | None, level: int) -> None:
    """checksuftab + checklcpsubtab (bese.c:355-533 semantics): the
    suffix order is strictly increasing and lcp values are the true
    common prefix lengths."""
    n = int(text.size)
    if n < 2:
        return
    if level >= 2:
        idx = np.arange(n - 1)
    else:
        rng = np.random.default_rng(0)
        idx = rng.integers(0, n - 1, size=min(512, n - 1))
    for i in idx:
        a, b = int(suftab[i]), int(suftab[i + 1])
        if not _suffix_less(text, a, b):
            raise AssertionError(
                f"checksuftab: suffixes at ranks {i},{i + 1} "
                f"(positions {a},{b}) out of order")
        if lcptab is not None:
            d = 0
            while (a + d < n and b + d < n
                   and text[a + d] == text[b + d]
                   and text[a + d] < WILDCARD):
                d += 1
            if int(lcptab[i + 1]) != d:
                raise AssertionError(
                    f"checklcpsubtab: lcp[{i + 1}] = "
                    f"{int(lcptab[i + 1])} != {d}")

"""Debug levels (``VSTREEDEBUGLEVEL``) without jax.

``debug_level`` mirrors :func:`vstree_tpu.core.debug.debug_level`
minus its level-3 ``jax_debug_nans`` switch, which has no use in the
port's integer code.  The verifier ``check_suftab`` is NumPy and is
shared.
"""

from __future__ import annotations

import os

from vstree_tpu.core.debug import check_suftab  # noqa: F401  (re-export)


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

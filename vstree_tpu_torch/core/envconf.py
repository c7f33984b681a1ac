"""Environment-variable configuration layer (reference
doc/virtman.tex:4629ff): checkenvvaronoff semantics (kurtz-basic/
checkonoff.c: value must be "on" or "off"), read for VMATCHSHOWTIMESPACE
(vmatch.mn.c:44-52,91-96) and VSTREE_DEBUG_NANS, and the MKVTREESMAPDIR
symbol-map search path (mkvprocess.c:523 scanpathsforfile)."""

from __future__ import annotations

import os


def check_env_on_off(varname: str) -> bool:
    """checkenvvaronoff (checkonoff.c:20-39)."""
    v = os.environ.get(varname)
    if v is None:
        return False
    if v == "on":
        return True
    if v == "off":
        return False
    raise SystemExit(
        f'environment variable {varname} must set "on" or "off"')


def scan_paths_for_file(envvar: str, filename: str) -> str:
    """scanpathsforfile: the file itself, else each :-separated
    directory of the environment variable."""
    if os.path.exists(filename):
        return filename
    for p in os.environ.get(envvar, "").split(":"):
        if p:
            cand = os.path.join(p, filename)
            if os.path.exists(cand):
                return cand
    raise SystemExit(
        f'cannot find file "{filename}" (also searched ${envvar})')

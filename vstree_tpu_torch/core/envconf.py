"""Environment-variable configuration layer: the MKVTREESMAPDIR
symbol-map search path (reference mkvprocess.c:523 scanpathsforfile)."""

from __future__ import annotations

import os


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

"""vmatchselect-compatible CLI: sort / select matches from a match
file offline (reference src/Vmatch/vmatsel.mn.c: parse file ->
removecontained -> optional sort -> header -> best-k -> re-emit).

Usage: python -m vstree_tpu_torch.cli.vmatchselect [-sort mode] [-best k] file
"""

from __future__ import annotations

import sys

from ..output.render import (
    assign_query_digits,
    assign_virtual_digits,
    render_matches,
)
from ..postprocess.matchfile import read_match_file
from ..postprocess.select import SORTMODES, remove_contained, sort_matches


def run(argv: list[str], out=None) -> int:
    out = out or sys.stdout
    sortmode = None
    best = None
    mfile = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-sort":
            i += 1
            sortmode = argv[i]
            if sortmode not in SORTMODES:
                raise SystemExit(
                    f"vmatchselect: illegal sort mode {sortmode!r}"
                )
        elif a == "-best":
            i += 1
            best = int(argv[i])
        elif a == "-v":
            pass
        elif not a.startswith("-"):
            mfile = a
        else:
            raise SystemExit(f"vmatchselect: illegal option {a}")
        i += 1
    if mfile is None:
        raise SystemExit(
            "vmatchselect: the last argument must be the match file"
        )

    mf = read_match_file(mfile)
    mt, _removed = remove_contained(mf.table)
    if sortmode is not None:
        mt = sort_matches(mt, sortmode)
    print(mf.argline, file=out)
    if best is not None:
        mt = mt.select(slice(0, best))
    digits = assign_virtual_digits(mf.esa.multiseq)
    if mf.query is not None:
        assign_query_digits(digits, mf.query)
    for line in render_matches(mt, mf.esa.multiseq, digits,
                               mf.showmode, mf.query):
        print(line, file=out)
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:]))
    except BrokenPipeError:  # e.g. piped into head
        sys.exit(0)


if __name__ == "__main__":
    main()

"""Alignment display for ``-s`` output — byte parity with vmatch.

Reimplements, with identical output bytes, the reference's alignment
rendering stack:

- greedy front-based unit edit-distance alignment with direction-bit
  backtrace (reference src/kurtz/front.gen:44-210 evalentryforward/
  evalfrontforward, src/kurtz/galign.c:322-430 greedyedistalign,
  galign.c:216-320 backtracefront),
- Hamming alignment (galign.c:160-215) and the equal-strings case
  (galign.c:136-158),
- the two-line alignment construction (src/kurtz/showalign.c:664-860
  fillthelines) and block formatter with position columns and the
  ``!``-marker edit-operation line (showalign.c:1582-2062
  formatseqwithgaps/showeditopline/formatalignment),
- the per-match orchestration of src/Vmatch/echomatch.c:692-875
  echostringoutput (left/right sequence extraction lrseq.c:75-141,
  reverse-complement modes, Hamming-vs-edit dispatch) and the abbrev
  modes (echohammingmatch echomatch.c:272-398, vmechoexactmatch
  echomatch.c:231-252).

Edit operations use the reference encoding (include/alignment.h:43-46):
value <= 16383 is a run of that many identical chars, 1<<14 deletion,
1<<15 insertion, 3<<14 mismatch; the array is stored backtrace-order
(alignment end first) and consumed back-to-front.
"""

from __future__ import annotations

import numpy as np

from ..core.chardef import WILDCARD
from ..engine.match import (
    FLAGPALINDROMIC,
    FLAGPPLEFTREVERSE,
    FLAGPPRIGHTREVERSE,
    FLAGQUERY,
    FLAGSCOREMATCH,
    FLAGSELFPALINDROMIC,
    FLAGXDROP,
)

MAXIDENTICALLENGTH = (1 << 14) - 1
DELETIONEOP = 1 << 14
INSERTIONEOP = 1 << 15
MISMATCHEOP = 3 << 14

ABSTRACTGAP = 252          # SEPARATOR-3 (alignment.h:154)
CONCRETEGAP = ord("-")
NUMWIDTH = 12              # showalign.c:600

# showstring mode bits (reference include/outinfo.h); the low bits hold
# the line width (MAXLINEWIDTH mask)
MAXLINEWIDTH = (1 << 10) - 1
SHOWALIGNABBREV = 1 << 10
SHOWALIGNABBREVIUB = 1 << 11
SHOWVMATCHXML = 1 << 12
SHOWPURELEFTSEQ = 1 << 13
SHOWPURERIGHTSEQ = 1 << 14
DEFAULTLINEWIDTH = 60

_MINUS_INF_SENTINEL = None  # computed per alignment

# direction bits (frontdef.h)
_REPLACE, _INSERT, _DELETE = 1, 2, 4


def _lcp(u: np.ndarray, i: int, v: np.ndarray, j: int) -> int:
    """Length of the common extension from (i, j); wildcards never
    match (COMPARESYMBOLS, galign.c:27-31)."""
    c = 0
    ul, vl = len(u), len(v)
    while i < ul and j < vl and u[i] == v[j] and u[i] < WILDCARD:
        i += 1
        j += 1
        c += 1
    return c


def _add_identical(eops: list[int], lenid: int) -> None:
    """ADDIDENTICAL (galign.c:79-90), reproduced verbatim including
    its chunking behavior."""
    while True:
        eops.append(lenid & MAXIDENTICALLENGTH)
        if lenid <= MAXIDENTICALLENGTH:
            break
        lenid -= MAXIDENTICALLENGTH


def align_equal_strings(length: int) -> list[int]:
    """alignequalstrings (galign.c:136-158)."""
    eops: list[int] = []
    _add_identical(eops, length)
    return eops


def hamming_alignment(useq: np.ndarray, vseq: np.ndarray) -> list[int]:
    """hammingalignment (galign.c:160-215): eops right-to-left."""
    eops: list[int] = []
    lenid = 0
    inequal = False
    for i in range(len(useq) - 1, -1, -1):
        a, b = useq[i], vseq[i]
        if a != b or a >= WILDCARD:
            if inequal:
                _add_identical(eops, lenid)
                inequal = False
            eops.append(MISMATCHEOP)
        else:
            if inequal:
                lenid += 1
            else:
                lenid = 1
                inequal = True
    if inequal:
        _add_identical(eops, lenid)
    return eops


def greedy_edist_align(
    useq: np.ndarray, vseq: np.ndarray, maxdist: int
) -> tuple[int, list[int]]:
    """greedyedistalign + backtracefront (galign.c:322-430,216-320):
    threshold-sensitive greedy fronts with direction bits, then the
    direction-bit backtrace.  Returns (distance, eops)."""
    u = useq.astype(np.int64)
    v = vseq.astype(np.int64)
    ulen, vlen = len(u), len(v)
    minus_inf = -max(ulen, vlen, 1)

    # fronts[p] = (left, rows list, dirs list); rows[k - left]
    fronts: list[tuple[int, list[int], list[int]]] = []
    t0 = 0
    if ulen and vlen:
        t0 = _lcp(u, 0, v, 0)
    fronts.append((0, [t0], [0]))

    def access(p: int, k: int) -> int:
        left, rows, _ = fronts[p]
        if left <= k < left + len(rows):
            return rows[k - left]
        return minus_inf

    real = -1
    if ulen == vlen and t0 == vlen:
        real = 0
    else:
        mn = min(ulen, vlen)
        for p in range(1, maxdist + 1):
            r = p - mn
            if r <= 0:
                left = -p
                width = 2 * p + 1
            else:
                left = max(-ulen, -p)
                width = min(vlen, p) - left + 1
            rows: list[int] = []
            dirs: list[int] = []
            for k in range(left, left + width):
                if not (r <= 0 or k <= -r or k >= r):
                    rows.append(minus_inf)
                    dirs.append(0)
                    continue
                # evalentryforward (front.gen:77-143)
                t = access(p - 1, k) + 1
                d = _REPLACE
                val = access(p - 1, k - 1)
                if t < val:
                    t = val
                    d = _INSERT
                val = access(p - 1, k + 1) + 1
                if t < val:
                    t = val
                    d = _DELETE
                dirs.append(d)
                if t < 0 or t + k < 0:
                    rows.append(minus_inf)
                    continue
                if ulen != 0 and vlen != 0:
                    t += _lcp(u, t, v, t + k)
                if t > ulen or t + k > vlen:
                    rows.append(minus_inf)
                else:
                    rows.append(t)
            fronts.append((left, rows, dirs))
            if access(p, vlen - ulen) == ulen:
                real = p
                break
        if real < 0:
            raise ValueError(
                f"cannot compute edit distance alignment for "
                f"distance > {maxdist}"
            )

    # backtracefront (galign.c:216-320)
    eops: list[int] = []
    if not (ulen == vlen and vlen == 0):
        d = vlen - ulen
        i, j = ulen - 1, vlen - 1
        for p in range(real, 0, -1):
            left, rows, dirs = fronts[p]
            db = dirs[d - left]
            starti = i
            while i >= 0 and j >= 0:
                if u[i] != v[j] or u[i] >= WILDCARD:
                    break
                i -= 1
                j -= 1
            if i < starti:
                _add_identical(eops, starti - i)
            if db & _REPLACE:
                eops.append(MISMATCHEOP)
                i -= 1
                j -= 1
            elif db & _DELETE:
                eops.append(DELETIONEOP)
                i -= 1
                d += 1
            elif db & _INSERT:
                eops.append(INSERTIONEOP)
                j -= 1
                d -= 1
        if i >= 0:
            _add_identical(eops, i + 1)
    return real, eops


def fill_two_lines(
    eops: list[int],
    useq: np.ndarray,
    vseq: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """fillthelines (showalign.c:664-860), intron handling excluded
    (vmatch passes showintronmaxlen == 0).  Returns the two alignment
    line buffers (elements: sequence values or ABSTRACTGAP)."""
    first: list[int] = []
    second: list[int] = []
    i = 0
    for eop in reversed(eops):
        if eop == MISMATCHEOP or eop == DELETIONEOP:
            first.append(int(useq[i]))
            i += 1
        elif eop == INSERTIONEOP:
            first.append(ABSTRACTGAP)
        else:
            for _ in range(eop & MAXIDENTICALLENGTH):
                first.append(int(useq[i]))
                i += 1
    j = 0
    for eop in reversed(eops):
        if eop == MISMATCHEOP or eop == INSERTIONEOP:
            second.append(int(vseq[j]))
            j += 1
        elif eop == DELETIONEOP:
            second.append(ABSTRACTGAP)
        else:
            for _ in range(eop & MAXIDENTICALLENGTH):
                second.append(int(vseq[j]))
                j += 1
    return np.array(first, np.int64), np.array(second, np.int64)


def _seq_with_gaps(orig_line: np.ndarray) -> str:
    """formatseqwithgaps (showalign.c:1582-1638) for vmatch's flag set
    (no tenner blocks / case forcing / implosion)."""
    out = []
    for c in orig_line:
        if c == ABSTRACTGAP:
            out.append("-")
        else:
            out.append(chr(int(c)))
    return "".join(out)


def _editop_line(
    fc: np.ndarray, sc: np.ndarray, fo: np.ndarray, so: np.ndarray
) -> str | None:
    """showeditopline (showalign.c:1706-1812), SHOWALIGNMENTEQUAL off:
    '!' under mismatch/indel columns, '=' where only the original
    characters differ (case etc.); None when the line would be all
    blanks."""
    needed = False
    for i in range(len(fc)):
        a, b = fc[i], sc[i]
        if a != b or a == ABSTRACTGAP or a == WILDCARD:
            needed = True
            break
        ao, bo = chr(int(fo[i])), chr(int(so[i]))
        if ao != bo:
            if ao.islower():
                eq = ao == bo.lower()
            else:
                eq = ao == bo.upper()
            if not eq:
                needed = True
                break
    if not needed:
        return None
    out = []
    for i in range(len(fc)):
        a, b = fc[i], sc[i]
        if a != b or a == ABSTRACTGAP or a == WILDCARD:
            out.append("!")
        else:
            ao, bo = chr(int(fo[i])), chr(int(so[i]))
            if ao == bo:
                out.append(" ")
            else:
                if ao.islower():
                    eq = ao == bo.lower()
                else:
                    eq = ao == bo.upper()
                out.append(" " if eq else "=")
    return "".join(out)


def format_alignment(
    firstc: np.ndarray,
    secondc: np.ndarray,
    firsto: np.ndarray,
    secondo: np.ndarray,
    linewidth: int,
    startfirst: int,
    startsecond: int,
    selfcomparison: bool,
) -> str:
    """formatalignment (showalign.c:1886-2060) for vmatch's flag set.
    Returns the full alignment block text (ending with the function's
    final newline)."""
    numofcols = len(firstc)
    out: list[str] = []
    i = 0
    first_ins = 0
    second_ins = 0
    while True:
        ln = min(numofcols - i, linewidth)
        seq1 = _seq_with_gaps(firsto[i:i + ln])
        first_ins += int(np.sum(firsto[i:i + ln] == ABSTRACTGAP))
        num1 = i + startfirst + ln - first_ins
        out.append(
            "Sbjct: " + seq1
            + f"{num1:>{NUMWIDTH + linewidth - ln}}" + "\n"
        )
        marker = _editop_line(
            firstc[i:i + ln], secondc[i:i + ln],
            firsto[i:i + ln], secondo[i:i + ln],
        )
        if marker is not None:
            out.append("       " + marker + "\n")
        seq2 = _seq_with_gaps(secondo[i:i + ln])
        second_ins += int(np.sum(secondo[i:i + ln] == ABSTRACTGAP))
        num2 = i + startsecond + ln - second_ins
        pre2 = "Sbjct: " if selfcomparison else "Query: "
        out.append(
            pre2 + seq2
            + f"{num2:>{NUMWIDTH + linewidth - ln}}" + "\n"
        )
        i += ln
        if i >= numofcols:
            break
        out.append("\n")
    out.append("\n")
    return "".join(out)


def _revcomp_codes(seq: np.ndarray) -> np.ndarray:
    """makereversecomplement on encoded DNA: code c < 4 -> 3 - c,
    specials unchanged; reversed."""
    r = seq[::-1].copy()
    reg = r < 4
    r[reg] = 3 - r[reg]
    return r


_RCMAP = bytes.maketrans(b"AaCcGgTt", b"TtGgCcAa")


def _revcomp_orig(seq: np.ndarray) -> np.ndarray:
    """makereversecomplementorig: original chars complemented via the
    ASSIGNRC table (echomatch.c:259-270), reversed."""
    b = bytes(int(c) for c in seq[::-1]).translate(_RCMAP)
    return np.frombuffer(b, np.uint8).astype(np.int64)


def _echo_exact(orig: np.ndarray, linewidth: int) -> str:
    """vmechoexactmatch (echomatch.c:231-252)."""
    out = []
    linestart = 0
    length = len(orig)
    while True:
        ln = min(length - linestart, linewidth)
        out.append("".join(chr(int(c)) for c in orig[linestart:linestart + ln]))
        linestart += ln
        if linestart >= length:
            break
        out.append("\n")
    out.append("\n")
    return "".join(out)


# IUB code for a mismatched base pair (IUBSYMBOL/IUBSTRING,
# include/iubdef.h:27-28; indexed 4*a + b)
_IUBSTRING = "-MRWM-SYRS-KWYK-"


def _echo_hamming_abbrev(
    uc, uo, vc, vo, rightrc: bool, showiub: bool, specialsymbols: bool,
    linewidth: int,
) -> str:
    """echohammingmatch (echomatch.c:272-398): abbreviated hamming
    display with [ab] / {ab} / IUB forms; every emitted char counts
    toward the PUTONE line wrap (echomatch.c:43-49)."""
    out: list[str] = []
    state = [0]

    def put(c: str) -> None:
        out.append(c)
        state[0] += 1
        if state[0] >= linewidth:
            out.append("\n")
            state[0] = 0

    n = len(uc)
    for i in range(n):
        a, ao = int(uc[i]), chr(int(uo[i]))
        if rightrc:
            b = int(vc[n - 1 - i])
            bo = chr(int(vo[n - 1 - i]))
            if b != WILDCARD and b <= 3:
                b = 3 - b
                bo = bo.translate(str.maketrans("AaCcGgTt", "TtGgCcAa"))
        else:
            b, bo = int(vc[i]), chr(int(vo[i]))
        if specialsymbols and (a == WILDCARD or b == WILDCARD):
            put("[")
            put(ao)
            put(bo)
            put("]")
        elif a != b:
            if showiub and specialsymbols and a < 4 and b < 4:
                put(_IUBSTRING[4 * a + b])
            else:
                put("[")
                put(ao)
                put(bo)
                put("]")
        else:
            if ao != bo:
                put("{")
                put(ao)
                put(bo)
                put("}")
            else:
                put(ao)
    out.append("\n")
    return "".join(out)


def alignment_eops(row: dict, virtual_ms, query_ms) -> list[int]:
    """The edit-operation list of a match's display alignment — the
    same dispatch as echo_string_output (equal / hamming / greedy
    edist / x-drop), used by the XML output's <DNA_eops> block
    (echomatch.c:1039 + showeditopinxml)."""
    flag = row["flag"]
    leftrc = bool(flag & FLAGPPLEFTREVERSE)
    if flag & (FLAGPALINDROMIC | FLAGSELFPALINDROMIC):
        rightrc = True
    else:
        rightrc = bool(
            not (flag & FLAGQUERY) and (flag & FLAGPPRIGHTREVERSE)
        )
    p1, l1 = row["position1"], row["length1"]
    lc = virtual_ms.sequence[p1:p1 + l1].astype(np.int64)
    p2, l2 = row["position2"], row["length2"]
    if flag & FLAGQUERY:
        src = virtual_ms if flag & FLAGSELFPALINDROMIC else query_ms
        start = p2
    else:
        src = virtual_ms
        if virtual_ms.numofquerysequences > 0:
            start = virtual_ms.database_length + 1 + p2
        else:
            start = p2
    rc = src.sequence[start:start + l2].astype(np.int64)
    distance = row["distance"]
    hamming = distance < 0
    if hamming:
        distance = -distance
    if leftrc:
        lc = _revcomp_codes(lc)
    if rightrc:
        rc = _revcomp_codes(rc)
    if flag & FLAGXDROP:
        from .xdropalign import xdrop_alignment

        _, eops = xdrop_alignment(lc, rc, row["xdropscore"])
    elif distance == 0:
        eops = align_equal_strings(l1)
    elif hamming:
        eops = hamming_alignment(lc, rc)
    else:
        _, eops = greedy_edist_align(lc, rc, distance)
    return eops


def echo_string_output(
    row: dict,
    virtual_ms,
    query_ms,
    showstring: int,
    specialsymbols: bool = True,
) -> str:
    """echostringoutput (echomatch.c:692-875) for one match.

    ``row``: dict with position1/length1/position2/length2/distance/
    flag/relpos1/relpos2 (python ints).  Returns the alignment text
    that follows the match row (caller adds the separating newlines per
    echomatch2file, echomatch.c:1050-1086).
    """
    flag = row["flag"]
    linewidth = showstring & MAXLINEWIDTH
    if linewidth == 0:
        linewidth = DEFAULTLINEWIDTH
    leftrc = bool(flag & FLAGPPLEFTREVERSE)
    if flag & (FLAGPALINDROMIC | FLAGSELFPALINDROMIC):
        rightrc = True
    else:
        rightrc = bool(
            not (flag & FLAGQUERY) and (flag & FLAGPPRIGHTREVERSE)
        )

    # left sequence (lrseq.c:75-85)
    p1, l1 = row["position1"], row["length1"]
    lc = virtual_ms.sequence[p1:p1 + l1].astype(np.int64)
    lo_ = virtual_ms.originalsequence[p1:p1 + l1].astype(np.int64)

    if flag & FLAGSCOREMATCH:
        return ""

    distance = row["distance"]
    if distance == 0 and (
        showstring & (SHOWALIGNABBREV | SHOWALIGNABBREVIUB)
    ):
        return _echo_exact(lo_, linewidth)

    # right sequence (lrseq.c:87-141)
    p2, l2 = row["position2"], row["length2"]
    if flag & FLAGQUERY:
        src = virtual_ms if flag & FLAGSELFPALINDROMIC else query_ms
        start = p2
    else:
        src = virtual_ms
        if virtual_ms.numofquerysequences > 0:
            start = virtual_ms.database_length + 1 + p2
        else:
            start = p2
    rc = src.sequence[start:start + l2].astype(np.int64)
    ro = src.originalsequence[start:start + l2].astype(np.int64)

    if showstring & (SHOWPURELEFTSEQ | SHOWPURERIGHTSEQ):
        out = ""
        if showstring & SHOWPURELEFTSEQ:
            out += _echo_exact(lo_, linewidth)
        if showstring & SHOWPURERIGHTSEQ:
            out += "\n" + _echo_exact(ro, linewidth)
        return out

    if distance < 0 and (
        showstring & (SHOWALIGNABBREV | SHOWALIGNABBREVIUB)
    ):
        return _echo_hamming_abbrev(
            lc, lo_, rc, ro, rightrc,
            bool(showstring & SHOWALIGNABBREVIUB), specialsymbols,
            linewidth,
        )

    hamming = False
    if distance < 0:
        hamming = True
        distance = -distance

    selfcomparison = not (flag & FLAGQUERY) or bool(
        flag & FLAGSELFPALINDROMIC
    )
    if leftrc:
        lc, lo_ = _revcomp_codes(lc), _revcomp_orig(lo_)
    if rightrc:
        rc, ro = _revcomp_codes(rc), _revcomp_orig(ro)

    if flag & FLAGXDROP:
        from .xdropalign import xdrop_alignment

        _, eops = xdrop_alignment(lc, rc, row["xdropscore"])
    elif distance == 0:
        eops = align_equal_strings(l1)
    elif hamming:
        eops = hamming_alignment(lc, rc)
    else:
        _, eops = greedy_edist_align(lc, rc, distance)

    f1, f2 = fill_two_lines(eops, lo_, ro)
    c1, c2 = fill_two_lines(eops, lc, rc)
    return format_alignment(
        c1, c2, f1, f2, linewidth,
        row["relpos1"], row["relpos2"], selfcomparison,
    )

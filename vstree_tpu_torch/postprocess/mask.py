"""Match masking and inverse ("nomatch") output.

Reference: vmatch options -dbmaskmatch/-qmaskmatch [tolower|toupper|
<char>] [keepflags] and -dbnomatch/-qnomatch N [keepflags]
(src/Vmatch/markmat.c, nomatch.c, showmasked.c, keepflags.c,
initpost.c:25-269).  Matches are marked in a position bit-table over
the multiseq being masked; masking rewrites the FASTA with matched
symbols replaced, nomatch emits the maximal unmarked regions.

TPU-native framework note: this is cold host-side output plumbing —
interval marking is a vectorized difference-array pass, region
enumeration a run-length scan; no device work.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..core.multiseq import Multiseq
from ..engine.match import MatchTable

# maskchar sentinels (reference include/inputsymbol.h MASKTOUPPER /
# MASKTOLOWER)
MASKTOUPPER = "toupper"
MASKTOLOWER = "tolower"

DEFAULTLINEWIDTH = 60


@dataclass
class Markfields:
    """reference Vmatch/markinfo.h Markfields + DEFAULTMARKFIELDS
    (parsevm.c:83-87)."""

    markdb: bool = True
    markleft: bool = True
    markright: bool = True
    markleftifdifferentsequence: bool = True
    markrightifdifferentsequence: bool = True

    def parse_keepflag(self, arg: str, opt: str) -> None:
        """parsekeepflags (keepflags.c:7-45)."""
        if arg == "keepleft":
            self.markleft = False
        elif arg == "keepright":
            self.markright = False
        elif arg == "keepleftifsamesequence":
            self.markleftifdifferentsequence = False
        elif arg == "keeprightifsamesequence":
            self.markrightifdifferentsequence = False
        else:
            raise SystemExit(
                f'vmatch: incorrect optional argument "{arg}" to '
                f"option {opt}; must be one of the following "
                "keywords: keepleft, keepright, "
                "keepleftifsamesequence, keeprightifsamesequence"
            )


def init_marktable(ms: Multiseq) -> np.ndarray:
    """Bit table over ms positions with separator positions pre-marked
    (markmat.c:16-29)."""
    bits = np.zeros(ms.totallength, bool)
    if ms.numofsequences > 1:
        bits[np.asarray(ms.markpos[: ms.numofsequences - 1], np.int64)] = True
    return bits


def _mark_intervals(bits: np.ndarray, starts, lengths) -> None:
    """Set bits[s:s+l] for every interval — difference-array pass."""
    starts = np.asarray(starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    keep = lengths > 0
    starts, lengths = starts[keep], lengths[keep]
    if starts.size == 0:
        return
    n = bits.size
    diff = np.zeros(n + 1, np.int64)
    np.add.at(diff, np.clip(starts, 0, n), 1)
    np.add.at(diff, np.clip(starts + lengths, 0, n), -1)
    bits |= np.cumsum(diff[:-1]) > 0


def mark_matches(
    bits: np.ndarray,
    mt: MatchTable,
    mf: Markfields,
    has_no_query_files: bool,
    vms_has_indexed_queries: bool,
    database_length: int,
) -> None:
    """markmatches (markmat.c:42-118), vectorized over the batch."""
    if len(mt) == 0:
        return
    diffseq = mt.seqnum1 != mt.seqnum2
    if mf.markleft and mf.markdb:
        sel = diffseq | mf.markleftifdifferentsequence
        _mark_intervals(bits, mt.position1[sel], mt.length1[sel])
    if not mf.markdb or has_no_query_files:
        if (not mf.markdb or mf.markright):
            sel = diffseq | mf.markrightifdifferentsequence
            offset = (
                0
                if (mf.markdb or not vms_has_indexed_queries)
                else database_length + 1
            )
            _mark_intervals(
                bits, offset + mt.position2[sel], mt.length2[sel]
            )


def nomatch_regions(
    bits: np.ndarray,
    markpos: np.ndarray,
    posoffset: int,
    length: int,
    nomatchlength: int,
):
    """Maximal unmarked runs in bits[posoffset : posoffset+length] of
    length >= nomatchlength, as (absstart, seqnum, relpos, runlen)
    arrays (nomatchsubstringsout, nomatch.c:179-280)."""
    win = bits[posoffset: posoffset + length]
    if win.size == 0:
        return (np.zeros(0, np.int64),) * 4
    unm = ~win
    # run boundaries of the unmarked mask
    d = np.diff(unm.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if unm[0]:
        starts = np.concatenate([[0], starts])
    if unm[-1]:
        ends = np.concatenate([ends, [unm.size]])
    runlen = ends - starts
    keep = runlen >= max(nomatchlength, 1)
    starts, runlen = starts[keep], runlen[keep]
    absstart = starts + posoffset
    # sequence numbering restarts at the window (nomatch.c:194-200,
    # 248-259: seqnum counts separators crossed inside the scan)
    rel_marks = np.asarray(markpos, np.int64)
    rel_marks = rel_marks[(rel_marks >= posoffset)
                          & (rel_marks < posoffset + length)]
    seqnum = np.searchsorted(rel_marks, absstart, side="right")
    if rel_marks.size == 0:
        seqstart = np.zeros(absstart.size, np.int64)
    else:
        seqstart = np.where(
            seqnum > 0,
            rel_marks[np.maximum(seqnum - 1, 0)] + 1 - posoffset,
            0,
        )
    relpos = absstart - posoffset - seqstart
    return absstart, seqnum.astype(np.int64), relpos, runlen


def show_nomatch(
    bits: np.ndarray,
    ms: Multiseq,
    posoffset: int,
    length: int,
    nomatchlength: int,
    absolute: bool = False,
    out=None,
) -> None:
    """Emit '>seqnum relpos len' (or '>absstart len' with -absolute)
    per region (shownomatch, nomatch.c:32-131)."""
    out = out or sys.stdout
    absstart, seqnum, relpos, runlen = nomatch_regions(
        bits, ms.markpos, posoffset, length, nomatchlength
    )
    for i in range(absstart.size):
        if absolute:
            print(f">{absstart[i] - posoffset} {runlen[i]}", file=out)
        else:
            print(f">{seqnum[i]} {relpos[i]} {runlen[i]}", file=out)


def show_masked_seq(
    ms: Multiseq,
    bits: np.ndarray,
    maskchar: str,
    linewidth: int = DEFAULTLINEWIDTH,
    characters: bytes | None = None,
    out=None,
    err=None,
) -> None:
    """Rewrite the multiseq as FASTA with marked symbols masked
    (showmaskedseq, showmasked.c:39-144).

    ``characters`` maps alphabet codes to printable chars when the
    multiseq has no stored original sequence (transform=True path,
    initpost.c:241-247).
    """
    out = out or sys.stdout
    err = err or sys.stderr
    if ms.totallength == 0:
        raise SystemExit("vmatch: cannot format empty sequence")
    if getattr(ms, "originalsequence", None) is not None \
            and ms.originalsequence is not None \
            and ms.originalsequence.size == ms.totallength:
        orig = ms.originalsequence.copy()
    else:
        lut = np.frombuffer(characters, np.uint8).copy() if characters \
            else np.arange(256, np.uint8)
        table = np.zeros(256, np.uint8)
        table[: lut.size] = lut
        table[255] = 255  # SEPARATOR survives the transform
        orig = table[ms.sequence]
        sep_positions = (
            np.asarray(ms.markpos[: ms.numofsequences - 1], np.int64)
            if ms.numofsequences > 1 else np.zeros(0, np.int64)
        )
        orig[sep_positions] = 255
    is_sep = orig == 255
    masked = bits & ~is_sep
    nmask = int(masked.sum())

    low = (orig >= ord("a")) & (orig <= ord("z"))
    upp = (orig >= ord("A")) & (orig <= ord("Z"))
    # the reference streams character-by-character and errors at the
    # first masked char it cannot case-convert (SHOWSTARSYMBOL,
    # showmasked.c:30-38), leaving partial output behind — emulate
    # that by truncating at the first bad position
    bad0 = None
    if maskchar == MASKTOUPPER:
        bad = masked & ~low & (orig != ord("*"))
        if bad.any():
            bad0 = int(np.flatnonzero(bad)[0])
        conv = np.where(masked & low, orig - 32, orig)
        errmsg = "upper"
    elif maskchar == MASKTOLOWER:
        bad = masked & ~upp & (orig != ord("*"))
        if bad.any():
            bad0 = int(np.flatnonzero(bad)[0])
        conv = np.where(masked & upp, orig + 32, orig)
        errmsg = "lower"
    else:
        conv = np.where(masked, np.uint8(ord(maskchar[0])), orig)
        errmsg = None

    lw = linewidth or DEFAULTLINEWIDTH
    for seqnum in range(ms.numofsequences):
        s, e = ms.seq_bounds(seqnum)
        if bad0 is not None and s > bad0:
            break
        desc = ms.description(seqnum) if ms.descriptions else b""
        print(">" + desc.decode("latin-1"), file=out)
        stop = e if bad0 is None or bad0 >= e else bad0
        body = conv[s:stop].tobytes()
        if stop < e:
            # partial record: emit full lines + the partial line
            # without its newline, then fail like the reference
            for off in range(0, len(body) - len(body) % lw, lw):
                print(body[off: off + lw].decode("latin-1"), file=out)
            rem = body[len(body) - len(body) % lw:]
            if rem:
                out.write(rem.decode("latin-1"))
                out.flush()
            c = chr(int(orig[bad0]))
            raise SystemExit(
                f"vmatch: cannot convert character {c} to "
                f"{errmsg} case"
            )
        for off in range(0, len(body), lw):
            print(body[off: off + lw].decode("latin-1"), file=out)
    total_wo_sep = ms.totallength - (ms.numofsequences - 1)
    pct = 100.0 * nmask / total_wo_sep
    print(
        f"# sequence length: {total_wo_sep}, number of masked "
        f"symbols: {nmask} ({pct:.2f} percent of the sequences)",
        file=err,
    )

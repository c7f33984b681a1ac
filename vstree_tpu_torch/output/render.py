"""Match output rendering — byte-compatible with vmatch.

Reproduces the reference's row format exactly (stdout is compared
byte by byte with the reference vmatch's):

- row layout:    echomatch.c:878-979 (vmatchnormaloutmatch,
  echomatchpart1/2, echopospair)
- column widths: Vmatch/assigndig.c (length digits by DATABASELENGTH
  thresholds; position/seqnum digits = 1+floor(log10(...)))
- score/identity algebra: include/match.h:78-140
- header line:   Vmatch/procargs.c:32-83 (`# args=...` with
  absolutized index path unless VMATCHRELATIVEINDEXPATH)

:func:`render_matches` renders row by row on the host (the small
tables of the postprocessing tools); :func:`render_rows` gives the same
text from torch ops over a byte matrix on a device (vmatch's rows).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..core.multiseq import Multiseq
from ..engine.match import FLAGQUERY, MatchTable

# showmode bits (reference include/outinfo.h / select.h)
SHOWABSOLUTE = 1 << 0
SHOWNODIST = 1 << 1
SHOWNOEVALUE = 1 << 2
SHOWNOSCORE = 1 << 3
SHOWNOIDENTITY = 1 << 4
SHOWFILE = 1 << 5


@dataclass
class Digits:
    """Column widths (reference outinfo.h Digits / assigndig.c)."""

    length: int = 2
    position1: int = 1
    seqnum1: int = 1
    position2: int = 1
    seqnum2: int = 1


def assign_virtual_digits(ms: Multiseq) -> Digits:
    """assignvirtualdigits (assigndig.c:5-37)."""
    dblen = max(ms.database_length, 1)
    d = Digits()
    if dblen < 1000:
        d.length = 2
    elif dblen < 10000:
        d.length = 3
    elif dblen < 100000:
        d.length = 4
    else:
        d.length = 5
    d.position1 = 1 + int(math.log10(dblen))
    d.seqnum1 = 1 + int(math.log10(max(ms.num_db_sequences, 1)))
    d.position2 = d.position1
    d.seqnum2 = d.seqnum1
    return d


def assign_query_digits(d: Digits, query: Multiseq) -> None:
    """assignquerydigits (assigndig.c:39-45)."""
    d.position2 = 1 + int(math.log10(max(query.totallength, 1)))
    d.seqnum2 = 1 + int(math.log10(max(query.numofsequences, 1)))


def argument_header(
    args: list[str], index_path: str, out=None
) -> str:
    """`# args=` line (procargs.c savethearguments + showargumentline).
    ``args`` excludes the trailing index name."""
    pieces = "".join(a + " " for a in args)
    if not os.environ.get("VMATCHRELATIVEINDEXPATH"):
        if not index_path.startswith("/"):
            index_path = os.path.join(os.getcwd(), index_path)
    return "# args=" + pieces + index_path


_BASIC_SKIP = (
    "-s", "-sort", "-selfun", "-best", "-dbcluster", "-qspeedup",
    "-pp", "-nonredundant",
)


def basic_args(args: list[str]) -> list[str]:
    """Strip display/postprocessing options and their operands from an
    argument vector (SKIPSOMEARGS, procargs.c:14-29) — used for the
    `# args=` header of derived match files."""
    out: list[str] = []
    i = 0
    while i < len(args):
        if args[i] in _BASIC_SKIP:
            i += 1
            while i < len(args) and not args[i].startswith("-"):
                i += 1
            continue
        out.append(args[i])
        i += 1
    return out


def format_evalue(v: float) -> str:
    """`%.2e` with the extra-space quirk (echomatch.c:955-960):
    values >= 1e-99 or == 0 get a leading space (their exponent
    prints with 2 digits instead of 3)."""
    s = f"{v:.2e}"
    if v >= 1.0e-99 or v == 0.0:
        return " " + "   " + s
    return "   " + s


def format_description(ms: Multiseq, seqnum: int, sd: dict) -> str:
    """echothedescription (multiseq-adv.c:1462-1501): skipprefix /
    maxlength window, blanks replaced by underscores or truncating."""
    desc = ms.description(seqnum)
    if desc is None or not ms.descriptions:
        return f"sequence{seqnum}"
    ln = len(desc)
    if sd["maxlength"] > 0 and sd["maxlength"] + sd["skipprefix"] < ln:
        ln = sd["maxlength"] + sd["skipprefix"]
    out = []
    for ch in desc[sd["skipprefix"]:ln]:
        c = chr(ch)
        if c.isspace():
            if sd["untilfirstblank"]:
                break
            out.append("_" if sd["replaceblanks"] else c)
        else:
            out.append(c)
    return "".join(out)


def render_matches(
    mt: MatchTable,
    ms: Multiseq,
    digits: Digits,
    showmode: int = 0,
    query: Multiseq | None = None,
    showdesc: dict | None = None,
) -> list[str]:
    """Render match rows (vmatchnormaloutmatch)."""
    lines = []
    modes = mt.mode_chars()
    scores = mt.score
    idents = mt.identity
    for i in range(len(mt)):
        parts = []
        # part 1: length1 + (seqnum1, relpos1) or absolute position1
        parts.append(f"{mt.length1[i]:>{digits.length}}")
        if showmode & SHOWFILE:
            fnum = _filenum(ms, int(mt.position1[i]))
            parts.append(f" {ms.filenames[fnum]}")
        if showmode & SHOWABSOLUTE:
            parts.append(f" {mt.position1[i]:>{digits.position1}}")
        elif showdesc is not None:
            # echopospair (echomatch.c:86-111): "   " + description
            # (unpadded) + " %*lu" relpos
            parts.append(
                "   " + format_description(ms, int(mt.seqnum1[i]),
                                           showdesc)
                + f" {mt.relpos1[i]:>{digits.position1}}"
            )
        else:
            parts.append(
                f"    {mt.seqnum1[i]:>{digits.seqnum1}}"
                f" {mt.relpos1[i]:>{digits.position1}}"
            )
        parts.append(f"   {modes[i]} ")
        # part 2
        parts.append(f"{mt.length2[i]:>{digits.length}}")
        is_query = bool(mt.flag[i] & FLAGQUERY)
        ms2 = query if (is_query and query is not None) else ms
        if showmode & SHOWFILE:
            offset = 0
            if not is_query and ms.numofquerysequences > 0:
                offset = ms.database_length + 1
            fnum = _filenum(ms2, offset + int(mt.position2[i]))
            parts.append(f" {ms2.filenames[fnum]}")
        if showmode & SHOWABSOLUTE:
            parts.append(f" {mt.position2[i]:>{digits.position2}}")
        elif showdesc is not None:
            # descindex rebase for self matches on indexed queries
            # (echomatch.c:206-216)
            if is_query and query is not None:
                dms, didx = query, int(mt.seqnum2[i])
            elif ms.numofquerysequences > 0:
                dms = ms
                didx = int(mt.seqnum2[i]) + ms.num_db_sequences
            else:
                dms, didx = ms, int(mt.seqnum2[i])
            parts.append(
                "   " + format_description(dms, didx, showdesc)
                + f" {mt.relpos2[i]:>{digits.position2}}"
            )
        else:
            parts.append(
                f"    {mt.seqnum2[i]:>{digits.seqnum2}}"
                f" {mt.relpos2[i]:>{digits.position2}}"
            )
        if not (showmode & SHOWNODIST):
            parts.append(f" {mt.distance[i]:>3}")
        if not (showmode & SHOWNOEVALUE):
            parts.append(format_evalue(float(mt.evalue[i])))
        if not (showmode & SHOWNOSCORE):
            parts.append(f" {scores[i]:>{digits.length + 1}}")
        if not (showmode & SHOWNOIDENTITY):
            ident = idents[i]
            prefix = " " if ident < 100.0 else ""
            parts.append(f"{prefix}   {ident:.2f}")
        lines.append("".join(parts))
    return lines


def _filenum(ms: Multiseq, position: int) -> int:
    """getfilenum: which input file covers the absolute position."""
    total = 0
    for i in range(len(ms.filenames)):
        sep = ms.filesep[i]
        if sep == 0xFFFFFFFF or position <= sep:
            return i
    return len(ms.filenames) - 1


# rows rendered per chunk: one upload of their columns and one download
# of their text
_RENDER_ROWS = 1 << 18
# the filler byte of the row matrix, dropped from the text: no byte of
# UTF-8 is 0xFF
_FILL = 0xFF
# bytes of rows of the row matrix compacted at a time
_COMPACT = 1 << 21
_POW10 = 10 ** np.arange(19, dtype=np.int64)


def render_rows(
    mt: MatchTable,
    ms: Multiseq,
    digits: Digits,
    showmode: int,
    query: Multiseq | None,
    showdesc: dict | None,
    device: torch.device | str,
) -> str:
    """The rows of :func:`render_matches`, each followed by a newline,
    made by torch ops on ``device`` (:func:`render_row_chunks`)."""
    return "".join(render_row_chunks(mt, ms, digits, showmode, query,
                                     showdesc, device))


def render_row_chunks(
    mt: MatchTable,
    ms: Multiseq,
    digits: Digits,
    showmode: int,
    query: Multiseq | None,
    showdesc: dict | None,
    device: torch.device | str,
):
    """:func:`render_rows` as one string per chunk of ``_RENDER_ROWS``
    rows.  A chunk's columns go to ``device``, and every field of the
    row becomes a ``[rows, width]`` byte block there: an integer
    right-aligned to its width by digit extraction (wider values widen
    the field, as ``>{w}`` does), a text column (mode char, file name,
    description, E-value, identity) gathered per row from a table of
    its distinct values, each formatted once on the host as
    :func:`render_matches` formats it.  Bytes a row does not use hold
    ``_FILL``; the blocks side by side are the row matrix, whose text
    without the filler is downloaded once."""
    dev = torch.device(device)
    modes = mt.mode_chars().view(np.uint32)
    idents = mt.identity
    for lo in range(0, len(mt), _RENDER_ROWS):
        yield _render_chunk(mt, slice(lo, lo + _RENDER_ROWS), modes, idents,
                            ms, digits, showmode, query, showdesc, dev)


def _render_chunk(mt, rows, modes, idents, ms, digits, showmode, query,
                  showdesc, dev) -> str:
    """The text of rows ``rows`` of ``mt`` (see :func:`render_row_chunks`);
    the fields in :func:`render_matches`' order."""

    def col(values, dtype=np.int64):
        return torch.from_numpy(np.ascontiguousarray(values[rows], dtype)
                                ).to(dev)

    is_query = (col(mt.flag) & FLAGQUERY) != 0
    from_query = is_query if query is not None else torch.zeros_like(
        is_query)
    length1, length2 = col(mt.length1), col(mt.length2)
    fields = [(length1, digits.length)]
    if showmode & SHOWFILE:
        fields += [" ", _column(_filenums(ms, col(mt.position1)),
                                lambda k: [ms.filenames[i] for i in k])]
    if showmode & SHOWABSOLUTE:
        fields += [" ", (col(mt.position1), digits.position1)]
    elif showdesc is not None:
        fields += ["   ", _column(col(mt.seqnum1), lambda k: [
            format_description(ms, int(i), showdesc) for i in k]),
            " ", (col(mt.relpos1), digits.position1)]
    else:
        fields += ["    ", (col(mt.seqnum1), digits.seqnum1),
                   " ", (col(mt.relpos1), digits.position1)]
    fields += ["   ", _column(col(modes), lambda k: [chr(c) for c in k]),
               " ", (length2, digits.length)]
    # part 2: the query's tables for query rows (key bit 0), else ms's
    both = (ms, query)
    if showmode & SHOWFILE:
        position2 = col(mt.position2)
        offset = (ms.database_length + 1 if ms.numofquerysequences > 0
                  else 0)
        fnum = _filenums(ms, position2 + torch.where(is_query, 0, offset))
        if query is not None:
            fnum = torch.where(from_query, _filenums(query, position2),
                               fnum)
        fields += [" ", _column(2 * fnum + from_query, lambda k: [
            both[i & 1].filenames[i >> 1] for i in k])]
    if showmode & SHOWABSOLUTE:
        fields += [" ", (col(mt.position2), digits.position2)]
    elif showdesc is not None:
        # descindex rebase for self matches on indexed queries
        didx = col(mt.seqnum2)
        if ms.numofquerysequences > 0:
            didx = torch.where(from_query, didx, didx + ms.num_db_sequences)
        fields += ["   ", _column(2 * didx + from_query, lambda k: [
            format_description(both[i & 1], int(i) >> 1, showdesc)
            for i in k]),
            " ", (col(mt.relpos2), digits.position2)]
    else:
        fields += ["    ", (col(mt.seqnum2), digits.seqnum2),
                   " ", (col(mt.relpos2), digits.position2)]
    distance = col(mt.distance)
    if not (showmode & SHOWNODIST):
        fields += [" ", (distance, 3)]
    if not (showmode & SHOWNOEVALUE):
        evalue = col(mt.evalue, np.float64).view(torch.int64)
        fields.append(_column(evalue, lambda k: [
            format_evalue(float(v)) for v in k.view(np.float64)]))
    if not (showmode & SHOWNOSCORE):
        # EVALDISTANCE2SCORE, as MatchTable.score
        s = length1 + length2
        score = torch.where(distance >= 0, s - 3 * distance,
                            -(s + 3 * distance))
        fields += [" ", (score, digits.length + 1)]
    if not (showmode & SHOWNOIDENTITY):
        ident = col(idents, np.float64).view(torch.int64)
        fields.append(_column(ident, lambda k: [
            (" " if v < 100.0 else "") + f"   {v:.2f}"
            for v in k.view(np.float64)]))
    fields.append("\n")
    return _row_text(fields, len(is_query), dev)


def _filenums(ms: Multiseq, position: torch.Tensor) -> torch.Tensor:
    """:func:`_filenum` of every position: the first file whose
    separator (ascending; 0xFFFFFFFF: the last file's) is at or after
    it, else the last file."""
    n = len(ms.filenames)
    sep = np.array(ms.filesep[:n], np.int64)
    sep[sep == 0xFFFFFFFF] = np.iinfo(np.int64).max
    return torch.searchsorted(torch.from_numpy(sep).to(position.device),
                              position).clamp_(max=n - 1)


def _column(keys: torch.Tensor, texts) -> torch.Tensor:
    """A text field: ``[rows, width]`` bytes of ``texts(distinct)[i]``
    for each row's key, ``texts`` called once with the distinct keys (a
    NumPy array) and giving one string for each."""
    distinct, inverse = torch.unique(keys, return_inverse=True)
    enc = [t.encode("utf-8", "surrogatepass")
           for t in texts(distinct.cpu().numpy())]
    lens = np.array([len(b) for b in enc], np.int64)
    table = np.full((len(enc), max(int(lens.max(initial=0)), 1)), _FILL,
                    np.uint8)
    starts = np.repeat(np.cumsum(lens) - lens, lens)
    table[np.repeat(np.arange(len(enc)), lens),
          np.arange(int(lens.sum())) - starts] = np.frombuffer(
              b"".join(enc), np.uint8)
    return torch.from_numpy(table).to(keys.device)[inverse]


def _row_text(fields: list, nrows: int, dev: torch.device) -> str:
    """The text of a chunk's rows from their fields in order: literal
    strings, byte blocks and ``(values, width)`` integer fields, written
    side by side into the ``[rows, width]`` row matrix; one host read
    for all the integer fields' widths."""
    pow10 = torch.from_numpy(_POW10).to(dev)
    parts = []
    for f in fields:
        if isinstance(f, str) and parts and isinstance(parts[-1], str):
            parts[-1] += f
        elif isinstance(f, tuple):
            values, width = f
            ndig = torch.bucketize(values.abs(), pow10[1:], right=True) + 1
            used = (ndig + (values < 0)).clamp(min=width)
            parts.append((values, ndig.to(torch.int8), used.to(torch.int16)))
        else:
            parts.append(f)
    most = iter(torch.stack([p[2].max() for p in parts
                             if isinstance(p, tuple)]).tolist())
    widths = [len(p) if isinstance(p, str) else next(most)
              if isinstance(p, tuple) else p.shape[1] for p in parts]
    mat = torch.empty((nrows, sum(widths)), dtype=torch.uint8, device=dev)
    at = 0
    for p, w in zip(parts, widths):
        block = mat[:, at:at + w]
        if isinstance(p, str):
            block.copy_(torch.tensor(list(p.encode()), dtype=torch.uint8,
                                     device=dev))
        elif isinstance(p, tuple):
            _integers(block, *p, pow10)
        else:
            block.copy_(p)
        at += w
    return _text(mat)


def _integers(block: torch.Tensor, values, ndig, used,
              pow10: torch.Tensor) -> None:
    """Writes into ``block`` (``[rows, width]`` bytes) each value
    right-aligned to its row's ``used`` width (digits, the minus sign,
    blanks), ``_FILL`` to the left of it."""
    place = torch.arange(block.shape[1] - 1, -1, -1, device=values.device)
    digits = torch.div(values.abs()[:, None], pow10[place.clamp(max=18)],
                       rounding_mode="floor")
    block.copy_(digits.remainder_(10).add_(ord("0")))
    block.masked_fill_(place >= ndig[:, None], ord(" "))
    block.masked_fill_((place == ndig[:, None]) & (values < 0)[:, None],
                       ord("-"))
    block.masked_fill_(place >= used[:, None], _FILL)


def _text(mat: torch.Tensor) -> str:
    """The bytes of the row matrix ``mat`` but the filler, downloaded
    once and decoded.  Compacted ``_COMPACT`` bytes of rows at a time: a
    compaction's index takes eight bytes for each byte it keeps."""
    step = max(_COMPACT // max(mat.shape[1], 1), 1)
    parts = [mat[lo:lo + step].reshape(-1)
             for lo in range(0, mat.shape[0], step)]
    sizes = torch.stack([(p != _FILL).sum() for p in parts]).tolist()
    text = torch.empty(sum(sizes), dtype=torch.uint8, device=mat.device)
    for p, into in zip(parts, text.split(sizes)):
        into.copy_(p[p != _FILL])
    return str(text.cpu().numpy(), "utf-8", "surrogatepass")

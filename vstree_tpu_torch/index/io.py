"""Reference-format index file I/O.

Writes/reads the vstree index file family so indexes interoperate with
the reference binaries (strongest parity check: reference ``vmatch.x``
can consume our index and vice versa).  File formats, as produced by a
64-bit little-endian reference build (spec:
reference src/doc/virtman.tex:4366-4629; writers in
src/Mkvtree/mkvprocess.c, readers in src/kurtz-basic/readvirt.c):

========  =====================================================
``tis``   uint8[n]      encoded text (transformed input sequence)
``ois``   uint8[n]      original input characters
``suf``   uint64[n+1]   suffix array
``lcp``   uint8[n+1]    lcp values clamped at 255
``llv``   uint64[2k]    (rank, value) pairs for lcp >= 255
``bwt``   uint8[n+1]    Burrows-Wheeler transform
``bck``   uint64[2c]    (left, mid) bucket boundaries
``sti1``  uint8[n+1]    saturating rank-within-bucket counter
                        (mkvprocess.c:583-642)
``skp``   uint64[n+1]   skip table (NSV - 1; kurtz/mkskip.c)
``ssp``   uint64[m-1]   separator positions (markpos)
``des``   bytes         descriptions joined by newline
``sds``   uint64[m]     start offset of each description in des
``al1``   text          alphabet definition (symbol map lines)
``prj``   text          project metadata (key=value lines)
========  =====================================================
"""

from __future__ import annotations

import os

import numpy as np

from ..core.alphabet import Alphabet, parse_symbolmap
from ..core.chardef import WILDCARD
from ..core.multiseq import Multiseq
from .esa import ESA

INTEGERSIZE = 64
_U64 = np.dtype("<u8")


def special_stats(text: np.ndarray) -> tuple[int, int, int, int]:
    """(specialcharacters, specialranges, lengthofspecialprefix,
    lengthofspecialsuffix) as recorded in .prj (mkvprocess.c)."""
    sp = text >= WILDCARD
    n = int(text.size)
    count = int(sp.sum())
    if n == 0:
        return 0, 0, 0, 0
    starts = int(sp[0]) + int((sp[1:] & ~sp[:-1]).sum())
    pre = 0
    while pre < n and sp[pre]:
        pre += 1
    suf = 0
    while suf < n and sp[n - 1 - suf]:
        suf += 1
    return count, starts, pre if pre < n else n, suf if suf < n else n


def sti1_table(suftab: np.ndarray, lcptab: np.ndarray, prefixlength: int) -> np.ndarray:
    """Reduced 1-byte inverse suffix table (mkvprocess.c:583-642):
    counter resets at bucket boundaries (lcp < prefixlength) and
    saturates at 255; indexed by *position*."""
    n1 = suftab.size
    lcp = lcptab
    # vectorized: distance to previous rank with lcp < pl, clamped 255
    boundary = lcp < prefixlength
    boundary = np.asarray(boundary)
    idx = np.arange(n1, dtype=np.int64)
    last_boundary = np.maximum.accumulate(np.where(boundary, idx, 0))
    counter = np.minimum(idx - last_boundary, 255).astype(np.uint8)
    counter[0] = 0
    out = np.zeros(n1, np.uint8)
    out[suftab] = counter
    return out


def write_index(esa: ESA, indexname: str,
                tables: "set[str] | None" = None,
                prj_extra: tuple = (),
                prj_dbfile: bool = True,
                prj_special_zero: bool = False) -> None:
    """Write all built tables of ``esa`` in reference format.

    ``tables`` restricts the file set (used by the derived-index
    tools mkrcidx/mkdna6idx, which write specific subsets);
    ``prj_extra`` appends lines to the .prj (e.g. specialindex=N);
    ``prj_special_zero`` reproduces the reference's derived-index
    quirk of writing zeroed special-character statistics."""
    ms = esa.multiseq
    n = ms.totallength

    def has(name: str) -> bool:
        return tables is None or name in tables

    def w(ext: str, arr: np.ndarray) -> None:
        arr.tofile(indexname + "." + ext)

    if has("tis"):
        w("tis", ms.sequence)
    if ms.originalsequence is not None and has("ois"):
        w("ois", ms.originalsequence)
    if esa.suftab is not None and has("suf"):
        w("suf", esa.suftab.astype(_U64))
    if esa.lcptab is not None and has("lcp"):
        lcp = esa.lcptab
        big = np.flatnonzero(lcp >= 255)
        w("lcp", np.minimum(lcp, 255).astype(np.uint8))
        llv = np.empty((big.size, 2), _U64)
        llv[:, 0] = big
        llv[:, 1] = lcp[big]
        w("llv", llv)
    if esa.bwttab is not None and has("bwt"):
        w("bwt", esa.bwttab)
    if esa.bcktab is not None and has("bck"):
        w("bck", esa.bcktab.astype(_U64))
    if esa.lcptab is not None and esa.suftab is not None \
            and has("sti1"):
        w("sti1", sti1_table(esa.suftab, esa.lcptab, esa.prefixlength))
    if esa.skptab is not None and has("skp"):
        w("skp", esa.skptab.astype(_U64))
    if ms.numofsequences > 1 and has("ssp"):
        w("ssp", ms.markpos.astype(_U64))
    # descriptions: reference stores them newline-terminated, sds holds
    # the start offset of each description (m entries + total length?
    # reference writes numofsequences+1 offsets incl. end sentinel)
    des = bytearray()
    sds = np.zeros(ms.numofsequences + 1, _U64)
    for i in range(ms.numofsequences):
        sds[i] = len(des)
        d = ms.descriptions[i] if i < len(ms.descriptions) else b""
        if not d.endswith(b"\n"):
            d = d + b"\n"
        des += d
    sds[ms.numofsequences] = len(des)
    with open(indexname + ".des", "wb") as fh:
        fh.write(bytes(des))
    sds.tofile(indexname + ".sds")
    with open(indexname + ".al1", "w") as fh:
        fh.write(esa.alpha.al1_text)
    write_prj(esa, indexname, extra=prj_extra, dbfile=prj_dbfile,
              special_zero=prj_special_zero)


def write_prj(esa: ESA, indexname: str, extra: tuple = (),
              dbfile: bool = True, special_zero: bool = False) -> None:
    ms = esa.multiseq
    if special_zero:
        sc = sr = lsp = lss = 0
    else:
        sc, sr, lsp, lss = special_stats(ms.sequence)
    lines = []
    if dbfile:
        for fname, flen, contrib in zip(
            ms.filenames, ms.filelengths, _file_contribs(ms)
        ):
            lines.append(f"dbfile={fname} {flen} {contrib}")
    lines += [
        f"totallength={ms.totallength}",
        f"specialcharacters={sc}",
        f"specialranges={sr}",
        f"lengthofspecialprefix={lsp}",
        f"lengthofspecialsuffix={lss}",
        f"numofsequences={ms.numofsequences}",
        f"numofdbsequences={ms.num_db_sequences}",
        f"numofquerysequences={ms.numofquerysequences}",
    ]
    if esa.suftab is not None:
        lines.append(f"longest={esa.longest}")
    lines += [
        f"prefixlength={esa.prefixlength}",
        f"largelcpvalues={esa.largelcpvalues}",
        f"maxbranchdepth={esa.maxbranchdepth}",
        f"integersize={INTEGERSIZE}",
        "littleendian=1",
    ]
    lines += list(extra)
    with open(indexname + ".prj", "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _file_contribs(ms: Multiseq) -> list[int]:
    """Per-file number of encoded symbols (incl. separators inside the
    file's span, excl. the separator between files)."""
    # approximate: reference records the parsed symbol count per file.
    contribs = []
    total = 0
    for i in range(len(ms.filenames)):
        if i == len(ms.filenames) - 1:
            contribs.append(ms.totallength - total)
        else:
            end = ms.filesep[i]
            contribs.append(end - total)
            total = end + 1
    return contribs


def read_prj(indexname: str) -> dict:
    meta: dict = {"dbfiles": []}
    with open(indexname + ".prj") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            key, _, value = line.partition("=")
            if key == "dbfile":
                parts = value.rsplit(" ", 2)
                meta["dbfiles"].append(
                    (parts[0], int(parts[1]), int(parts[2]))
                )
            else:
                try:
                    meta[key] = int(value)
                except ValueError:
                    meta[key] = value
    return meta


def read_index(
    indexname: str,
    demand: tuple[str, ...] = ("suf", "lcp", "bwt", "bck", "sti", "skp"),
) -> ESA:
    """Map a reference-format index from disk
    (analog of mapvirtualtreeifyoucan, readvirt.c:776)."""
    meta = read_prj(indexname)
    n = meta["totallength"]
    if meta.get("integersize", 64) != 64:
        raise ValueError("only 64-bit indexes supported")
    if meta.get("littleendian", 1) != 1:
        raise ValueError("big-endian index: run vendian first")

    text = np.fromfile(indexname + ".tis", np.uint8)
    assert text.size == n, (text.size, n)

    ms = Multiseq(sequence=text, totallength=n)
    ms.numofsequences = meta["numofsequences"]
    ms.numofquerysequences = meta.get("numofquerysequences", 0)
    # restore file bookkeeping from the dbfile= lines (SHOWFILE output
    # and query partitioning need filenames + separator positions)
    total = 0
    for i, (fname, flen, contrib) in enumerate(meta["dbfiles"]):
        ms.filenames.append(fname)
        ms.filelengths.append(flen)
        if i == len(meta["dbfiles"]) - 1:
            ms.filesep.append(0xFFFFFFFF)
        else:
            total += contrib
            ms.filesep.append(total)
            total += 1
    if os.path.exists(indexname + ".ssp") and ms.numofsequences > 1:
        ms.markpos = np.fromfile(indexname + ".ssp", _U64).astype(np.uint32)
    if ms.numofquerysequences > 0:
        # DATABASELENGTH needs totalquerylength (multidef.h:88-92):
        # the query region starts right after the separator that ends
        # the last database sequence
        qstart = int(ms.markpos[ms.num_db_sequences - 1]) + 1
        ms.totalquerylength = ms.totallength - qstart
    if os.path.exists(indexname + ".des"):
        with open(indexname + ".des", "rb") as fh:
            des = fh.read()
        sds = np.fromfile(indexname + ".sds", _U64)
        ms.descriptions = [
            des[int(sds[i]):int(sds[i + 1])].rstrip(b"\n")
            for i in range(ms.numofsequences)
        ]
    if os.path.exists(indexname + ".ois"):
        ms.originalsequence = np.fromfile(indexname + ".ois", np.uint8)

    alpha = _read_alpha(indexname)

    esa = ESA(
        multiseq=ms,
        alpha=alpha,
        suftab=None,
        prefixlength=meta.get("prefixlength", 0),
        longest=meta.get("longest", 0),
        maxbranchdepth=meta.get("maxbranchdepth", 0),
        largelcpvalues=meta.get("largelcpvalues", 0),
        indexname=indexname,
    )
    if "suf" in demand:
        esa.suftab = np.fromfile(indexname + ".suf", _U64).astype(np.int64)
    if "lcp" in demand:
        lcp8 = np.fromfile(indexname + ".lcp", np.uint8)
        lcp = lcp8.astype(np.int64)
        if os.path.exists(indexname + ".llv"):
            llv = np.fromfile(indexname + ".llv", _U64).reshape(-1, 2)
            lcp[llv[:, 0].astype(np.int64)] = llv[:, 1].astype(np.int64)
        esa.lcptab = lcp
    if "bwt" in demand and os.path.exists(indexname + ".bwt"):
        esa.bwttab = np.fromfile(indexname + ".bwt", np.uint8)
    if "bck" in demand and os.path.exists(indexname + ".bck"):
        esa.bcktab = np.fromfile(indexname + ".bck", _U64).astype(np.int64)
    if "sti" in demand and esa.suftab is not None:
        sti = np.zeros(esa.suftab.size, np.int64)
        sti[esa.suftab] = np.arange(esa.suftab.size, dtype=np.int64)
        esa.stitab = sti
    if "skp" in demand and os.path.exists(indexname + ".skp"):
        esa.skptab = np.fromfile(indexname + ".skp", _U64).astype(np.int64)
    return esa


def _read_alpha(indexname: str) -> Alphabet:
    """Reconstruct the alphabet from the .al1 file."""
    with open(indexname + ".al1") as fh:
        return parse_symbolmap(fh.read())

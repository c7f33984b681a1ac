"""Genetic-code translation (DNA -> protein, six reading frames).

Re-derivation of reference kurtz/codon.c (translation schemes are the
public NCBI genetic-code tables, codon.c:120-228) and
kurtz/sixframe.c: ``translate_forward``/``translate_backward`` mirror
translateDNAforward/backward (codon.c:939-1010) including the wildcard
rules — a wildcard first/second base resolves to its smallest encoded
base (T<C<A<G order, uncomplemented even on the reverse strand,
codon.c:smallestbase), a wildcard third base resolves to a unique
amino acid when all encoded bases agree (equivalentbits,
codon.c:605-667) and otherwise to the smallest base.

``six_frame_translate`` is multisixframetranslateDNA (sixframe.c:166):
per DNA sequence the frames +0,+1,+2 then -0,-1,-2 become six
SEPARATOR-delimited protein sequences; ``sixframe_convert_match``
is sixframeconvertmatch (sixframe.c:232) mapping translated-space
match coordinates back onto the DNA.
"""

from __future__ import annotations

import numpy as np

from .alphabet import Alphabet
from .chardef import SEPARATOR
from .multiseq import Multiseq

CODONLENGTH = 3
MAXFRAMES = 6

# (identity, name, aminos, startcodons) — codon.c:120-228; index =
# 16*base1 + 4*base2 + base3 with T=0, C=1, A=2, G=3
_SCHEMES = [
    (1, "Standard",
     "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "---M---------------M---------------M----------------------------"),
    (2, "Vertebrate Mitochondrial",
     "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSS**VVVVAAAADDEEGGGG",
     "--------------------------------MMMM---------------M------------"),
    (3, "Yeast Mitochondrial",
     "FFLLSSSSYY**CCWWTTTTPPPPHHQQRRRRIIMMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "-----------------------------------M----------------------------"),
    (4, "Mold Mitochondrial; Protozoan Mitochondrial; Coelenterate "
        "Mitochondrial; Mycoplasma; Spiroplasma",
     "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "--MM---------------M------------MMMM---------------M------------"),
    (5, "Invertebrate Mitochondrial",
     "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSSSVVVVAAAADDEEGGGG",
     "---M----------------------------MMMM---------------M------------"),
    (6, "Ciliate Nuclear; Dasycladacean Nuclear; Hexamita Nuclear",
     "FFLLSSSSYYQQCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "-----------------------------------M----------------------------"),
    (9, "Echinoderm Mitochondrial",
     "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
     "-----------------------------------M----------------------------"),
    (10, "Euplotid Nuclear",
     "FFLLSSSSYY**CCCWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "-----------------------------------M----------------------------"),
    (11, "Bacterial",
     "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "---M---------------M------------MMMM---------------M------------"),
    (12, "Alternative Yeast Nuclear",
     "FFLLSSSSYY**CC*WLLLSPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "-------------------M---------------M----------------------------"),
    (13, "Ascidian Mitochondrial",
     "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSGGVVVVAAAADDEEGGGG",
     "-----------------------------------M----------------------------"),
    (14, "Flatworm Mitochondrial",
     "FFLLSSSSYYY*CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
     "-----------------------------------M----------------------------"),
    (15, "Blepharisma Macronuclear",
     "FFLLSSSSYY*QCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "-----------------------------------M----------------------------"),
    (16, "Chlorophycean Mitochondrial",
     "FFLLSSSSYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "-----------------------------------M----------------------------"),
    (21, "Trematode Mitochondrial",
     "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
     "-----------------------------------M----------------------------"),
    (22, "Scenedesmus Obliquus Mitochondrial",
     "FFLLSS*SYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "-----------------------------------M----------------------------"),
    (23, "Thraustochytrium Mitochondrial",
     "FF*LSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
     "--------------------------------M--M---------------M------------"),
]

SCHEMES = {ident: (name, aminos, starts)
           for ident, name, aminos, starts in _SCHEMES}

TBIT, CBIT, ABIT, GBIT = 8, 4, 2, 1
_WBITS_BY_CHAR = {
    "r": ABIT | GBIT, "y": CBIT | TBIT, "m": ABIT | CBIT,
    "k": GBIT | TBIT, "s": CBIT | GBIT, "w": ABIT | CBIT,
    "h": ABIT | CBIT | TBIT, "b": CBIT | GBIT | TBIT,
    "v": ABIT | CBIT | GBIT, "d": ABIT | GBIT | TBIT,
    "n": ABIT | CBIT | GBIT | TBIT,
}
# NOTE codon.c's wbitsvector sets 'w'/'W' to ABIT|CBIT (a bug vs the
# IUPAC [at]; reproduced verbatim for parity, codon.c:561/645)

_BASE_OF_BIT = [(TBIT, 0), (CBIT, 1), (ABIT, 2), (GBIT, 3)]


def check_transnum(transnum: int) -> None:
    if transnum not in SCHEMES:
        raise ValueError(
            f"illegal translation table number {transnum}: must be "
            "number in the range [1,23] except for 7, 8, 17, 18, 19 "
            "and 20")


def transnum2name(transnum: int) -> str:
    check_transnum(transnum)
    return SCHEMES[transnum][0]


def _smallest_base(bits: int) -> int:
    for b, code in _BASE_OF_BIT:
        if bits & b:
            return code
    raise ValueError("empty wildcard bits")


def _build_tables():
    """Per-char base-code tables: fwd[256], bwd[256] (codon2amino's
    c0/c1 switch), wbits[256] for the third-base rule; -1 = illegal."""
    fwd = np.full(256, -1, np.int32)
    bwd = np.full(256, -1, np.int32)
    wbits = np.zeros(256, np.int32)
    pairs = {"t": 0, "c": 1, "a": 2, "g": 3, "u": 0}
    comp = {0: 2, 1: 3, 2: 1, 3: 0}
    # NOTE the reference complements as T<->A, C<->G via its explicit
    # switch: forward a->A(2), backward a->T(0); c->G(3); g->C(1);
    # t/u->A(2)
    bwd_map = {"a": 0, "c": 3, "g": 1, "t": 2, "u": 2}
    del comp
    for ch, code in pairs.items():
        for c in (ch, ch.upper()):
            fwd[ord(c)] = code
    for ch, code in bwd_map.items():
        for c in (ch, ch.upper()):
            bwd[ord(c)] = code
    for ch, bits in _WBITS_BY_CHAR.items():
        for c in (ch, ch.upper()):
            sb = _smallest_base(bits)
            fwd[ord(c)] = sb
            bwd[ord(c)] = sb  # uncomplemented (smallestbase quirk)
            wbits[ord(c)] = bits
    return fwd, bwd, wbits


_FWD, _BWD, _WBITS = _build_tables()


def _third_base_aa(aminos: str, codeof2: np.ndarray,
                   wchar: np.ndarray) -> np.ndarray:
    """equivalentbits (codon.c:605-667) vectorized: amino acid if all
    bases encoded by the wildcard agree, else the smallest base's
    amino acid; returns amino char codes."""
    am = np.frombuffer(aminos.encode(), np.uint8)
    bits = _WBITS[wchar]
    out = np.zeros(codeof2.size, np.uint8)
    agreed = np.ones(codeof2.size, bool)
    seen = np.zeros(codeof2.size, bool)
    for b, code in _BASE_OF_BIT:
        has = (bits & b) != 0
        aa = am[codeof2 + code]
        newly = has & ~seen
        out = np.where(newly, aa, out)
        agreed &= ~has | ~seen | (aa == out)
        seen |= has
    # smallest base per element
    small = np.zeros(codeof2.size, np.int32)
    rem = np.ones(codeof2.size, bool)
    for b, code in _BASE_OF_BIT:
        has = rem & ((bits & b) != 0)
        small = np.where(has, code, small)
        rem &= ~has
    fallback = am[codeof2 + small]
    return np.where(agreed, out, fallback)


def translate_forward(orig: np.ndarray, transnum: int,
                      frame: int) -> np.ndarray:
    """translateDNAforward (codon.c:939-974) on original characters;
    returns amino-acid char codes (uint8)."""
    aminos = SCHEMES[transnum][1]
    am = np.frombuffer(aminos.encode(), np.uint8)
    L = orig.size
    count = max(0, (L - frame) // 3)
    if count == 0:
        return np.zeros(0, np.uint8)
    c0 = orig[frame:frame + 3 * count:3]
    c1 = orig[frame + 1:frame + 1 + 3 * count:3]
    c2 = orig[frame + 2:frame + 2 + 3 * count:3]
    f0, f1, f2 = _FWD[c0], _FWD[c1], _FWD[c2]
    if (f0 < 0).any() or (f1 < 0).any() or (f2 < 0).any():
        bad = np.concatenate([c0[f0 < 0], c1[f1 < 0], c2[f2 < 0]])
        raise ValueError(
            f"illegal char {chr(int(bad[0]))!r} in DNA sequence")
    codeof2 = (f0 << 4) + (f1 << 2)
    plain = am[codeof2 + f2]
    wild2 = _WBITS[c2] != 0
    if wild2.any():
        plain = plain.copy()
        plain[wild2] = _third_base_aa(
            aminos, codeof2[wild2], c2[wild2])
    return plain


def translate_backward(orig: np.ndarray, transnum: int,
                       frame: int) -> np.ndarray:
    """translateDNAbackward (codon.c:976-1010): frame 0, -1, -2."""
    aminos = SCHEMES[transnum][1]
    am = np.frombuffer(aminos.encode(), np.uint8)
    L = orig.size
    count = max(0, (L + frame) // 3)
    if count == 0:
        return np.zeros(0, np.uint8)
    top = L - 1 + frame
    idx = top - 3 * np.arange(count)
    c0 = orig[idx]
    c1 = orig[idx - 1]
    c2 = orig[idx - 2]
    f0, f1, f2 = _BWD[c0], _BWD[c1], _BWD[c2]
    if (f0 < 0).any() or (f1 < 0).any() or (f2 < 0).any():
        bad = np.concatenate([c0[f0 < 0], c1[f1 < 0], c2[f2 < 0]])
        raise ValueError(
            f"illegal char {chr(int(bad[0]))!r} in DNA sequence")
    codeof2 = (f0 << 4) + (f1 << 2)
    plain = am[codeof2 + f2]
    wild2 = _WBITS[c2] != 0
    if wild2.any():
        plain = plain.copy()
        plain[wild2] = _third_base_aa(
            aminos, codeof2[wild2], c2[wild2])
    return plain


# the six frames of a record in their order
_FRAMES = (0, 1, 2, 0, -1, -2)
# each frame's offset: codons = (length - shift) // 3
_SHIFT = np.array([0, 1, 2, 0, 1, 2], np.int64)


def _record_bounds(ms: Multiseq) -> tuple[np.ndarray, np.ndarray]:
    """``seq_bounds`` of every record: int64 starts and ends."""
    nseq = ms.numofsequences
    mp = np.asarray(ms.markpos, np.int64)[:max(nseq - 1, 0)]
    starts = np.concatenate([np.zeros(1, np.int64), mp + 1])
    ends = np.concatenate([mp, np.array([ms.totallength], np.int64)])
    return starts[:nseq], ends[:nseq]


def six_frame_translate(
    dna_ms: Multiseq, protein_alpha: Alphabet, transnum: int,
    withdescription: bool = False,
) -> Multiseq:
    """multisixframetranslateDNA (sixframe.c:166-231): each DNA
    sequence becomes six protein sequences (+0,+1,+2 then -0,-1,-2),
    SEPARATOR-delimited, encoded with the protein symbol map.

    Frame by frame over all records at once: one gather of the frame's
    codons from every record, their amino acids scattered to the
    frames' offsets.  An illegal char raises the error of
    ``translate_forward``/``translate_backward`` on the first record and
    frame, in their order, that meets one."""
    check_transnum(transnum)
    if dna_ms.originalsequence is None:
        raise ValueError("six-frame translation needs the original "
                         "sequence characters")
    orig = dna_ms.originalsequence
    nseq = dna_ms.numofsequences
    starts, ends = _record_bounds(dna_ms)
    # [nseq, 6] codons a frame; a frame is followed by a SEPARATOR but
    # the last frame of the last record
    count = np.maximum((ends - starts)[:, None] - _SHIFT, 0) // CODONLENGTH
    seglen = count.ravel() + 1
    seglen[-1:] -= 1
    segstart = np.cumsum(seglen) - seglen
    markpos = (segstart + count.ravel())[:-1]
    aminos = SCHEMES[transnum][1]
    am = np.frombuffer(aminos.encode(), np.uint8)
    origcat = np.full(int(seglen.sum()), SEPARATOR, np.uint8)
    illegal = []   # (record, frame index) of a frame's first bad codon
    for j, frame in enumerate(_FRAMES):
        n = count[:, j]
        before = np.cumsum(n) - n   # the frame's codons in earlier records
        i = np.arange(n.sum())
        # codon k = i - before[s] of record s has its first base 3k past
        # the frame's first codon, forward or backward
        if j < 3:
            step, table = 1, _FWD
            pos = np.repeat(starts + frame - 3 * before, n) + 3 * i
        else:
            step, table = -1, _BWD
            pos = np.repeat(ends - 1 + frame + 3 * before, n) - 3 * i
        c0, c1, c2 = orig[pos], orig[pos + step], orig[pos + 2 * step]
        f0, f1, f2 = table[c0], table[c1], table[c2]
        bad = (f0 < 0) | (f1 < 0) | (f2 < 0)
        if bad.any():
            s = np.searchsorted(before + n, bad.argmax(), "right")
            illegal.append((int(s), j))
            continue
        codeof2 = (f0 << 4) + (f1 << 2)
        aa = am[codeof2 + f2]
        wild2 = _WBITS[c2] != 0
        if wild2.any():
            aa[wild2] = _third_base_aa(aminos, codeof2[wild2], c2[wild2])
        origcat[np.repeat(segstart[j::MAXFRAMES] - before, n) + i] = aa
    if illegal:
        s, j = min(illegal)
        translate = translate_forward if j < 3 else translate_backward
        translate(orig[starts[s]:ends[s]], transnum, _FRAMES[j])
    # transformstringlocal (sixframe.c:145-164): SEPARATOR passes
    # through, everything else via the protein symbol map
    enc = np.full(origcat.size, SEPARATOR, np.uint8)
    nonsep = origcat != SEPARATOR
    enc[nonsep] = protein_alpha.transform(origcat[nonsep])
    out = Multiseq(sequence=enc, markpos=markpos)
    out.originalsequence = origcat
    out.numofsequences = nseq * MAXFRAMES
    out.totallength = int(enc.size)
    if withdescription:
        # singlesixframetranslateDNA (sixframe.c:74-95): frame 0
        # carries the DNA description, frames 1-5 empty lines
        given = list(dna_ms.descriptions[:nseq])
        descs = [b""] * (nseq * MAXFRAMES)
        descs[:MAXFRAMES * len(given):MAXFRAMES] = given
        out.descriptions = descs
    return out


def sixframe_convert_match(dna_ms: Multiseq, seqnum2: np.ndarray,
                           relpos2: np.ndarray, length2: np.ndarray):
    """sixframeconvertmatch (sixframe.c:232-276), vectorized.

    Returns (dna_seqnum, dna_relpos, dna_abspos, dna_length,
    reverse_flag)."""
    dseq = seqnum2 // MAXFRAMES
    frame = seqnum2 % MAXFRAMES
    first, last = _record_bounds(dna_ms)
    starts = first[dseq]
    lens = last[dseq] - starts
    fwd = frame <= 2
    rel_f = relpos2 * CODONLENGTH + frame
    fr3 = frame % 3
    rel_b = lens - (relpos2 + length2) * CODONLENGTH - fr3
    rel = np.where(fwd, rel_f, rel_b)
    return (dseq, rel, starts + rel, length2 * CODONLENGTH, ~fwd)

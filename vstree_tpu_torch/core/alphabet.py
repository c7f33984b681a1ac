"""Alphabets and symbol maps.

Re-implements the behavioral contract of the reference alphabet model
(reference: src/kurtz-basic/alphabet.c, src/include/alphadef.h:29-39):

- an alphabet maps input bytes to dense codes ``0..mapsize-2`` plus a
  wildcard class; when used for index building, wildcard characters are
  mapped to the ``WILDCARD`` code (254) so each wildcard occurrence is
  position-unique in the suffix sort,
- built-in DNA (a,c,g,t + wildcards ``nsywrkvbdhmNSYWRKVBDHM``) and
  protein (20 amino acids + ``XUBZJO*-``) alphabets,
- user-defined symbol map files: one line per character class, the last
  line is the wildcard class; an optional display character follows the
  first blank (reference alphabet.c:195-280).

The implementation is NumPy-vectorized (translation tables) rather than
per-character loops; the alphabet itself is host-side metadata.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .chardef import SEPARATOR, UNDEFCHAR, WILDCARD

DNABASES = "acgtACGT"
DNAWILDCARDS = "nsywrkvbdhmNSYWRKVBDHM"
MAPSIZEDNA = 5
DNAALPHABETDOMAIN = "acgtACGT" + DNAWILDCARDS
PROTEINUPPERAMINOACIDS = "LVIFKREDAGSTNQYWPHMC"
MAPSIZEPROTEIN = 21
PROTEINWILDCARDS = "XUBZJO*-"

# Text written to the .al1 file for built-in alphabets (reference
# mkvprocess.c makealptab writes DNAALPHABET / PROTEINALPHABET).
DNA_AL1_TEXT = "aA\ncC\ngG\ntTuU\nnsywrkvbdhmNSYWRKVBDHM\n"
PROTEIN_AL1_TEXT = (
    "L\nV\nI\nF\nK\nR\nE\nD\nA\nG\nS\nT\nN\nQ\nY\nW\nP\nH\nM\nC\nXUBZ*-\n"
)


@dataclass
class Alphabet:
    """Dense-code alphabet with wildcard class.

    Attributes mirror the reference ``Alphabet`` struct
    (src/include/alphadef.h:29-39).
    """

    symbolmap: np.ndarray = field(
        default_factory=lambda: np.full(256, UNDEFCHAR, dtype=np.uint32)
    )
    characters: np.ndarray = field(
        default_factory=lambda: np.zeros(256, dtype=np.uint8)
    )
    mapdomain: bytes = b""
    mapsize: int = 0          # number of character classes incl. wildcard class
    domainsize: int = 0
    mappedwildcards: int = 0
    undefsymbol: int = UNDEFCHAR
    al1_text: str = ""        # text content for the .al1 index file

    @property
    def num_regular(self) -> int:
        """Number of regular (non-wildcard) codes: 0..mapsize-2."""
        return self.mapsize - 1

    def transform(self, data: bytes | np.ndarray) -> np.ndarray:
        """Map raw input bytes to codes; raise on undefined characters.

        Vectorized equivalent of reference ``transformstring``
        (alphabet.c:70-94).
        """
        arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else data
        out = self.symbolmap[arr]
        bad = out == self.undefsymbol
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(
                f"illegal character {chr(int(arr[i]))!r} at offset {i}: "
                "not in alphabet"
            )
        return out.astype(np.uint8)

    def decode(self, codes: np.ndarray) -> bytes:
        """Map codes back to display characters (for output rendering)."""
        return self.characters[codes].tobytes()

    def is_dna(self) -> bool:
        """Heuristic parity with reference vm_isdnaalphabet: 4 regular
        symbols whose display characters are acgt (case-insensitive)."""
        if self.num_regular != 4:
            return False
        disp = bytes(self.characters[:4]).lower()
        return disp == b"acgt"

    def is_protein(self) -> bool:
        return self.num_regular == 20


def dna_alphabet(map_wildcards: bool = True) -> Alphabet:
    """The built-in DNA alphabet (reference assignDNAalphabet,
    alphabet.c:369-382)."""
    a = Alphabet()
    for i, ch in enumerate("aA"):
        a.symbolmap[ord(ch)] = 0
    for ch in "cC":
        a.symbolmap[ord(ch)] = 1
    for ch in "gG":
        a.symbolmap[ord(ch)] = 2
    for ch in "tTuU":
        a.symbolmap[ord(ch)] = 3
    wc = WILDCARD if map_wildcards else 4
    for ch in DNAWILDCARDS:
        a.symbolmap[ord(ch)] = wc
    a.mapsize = MAPSIZEDNA
    a.domainsize = len(DNAALPHABETDOMAIN)
    a.mapdomain = DNAALPHABETDOMAIN.encode()
    a.mappedwildcards = len(DNAWILDCARDS)
    chars = np.zeros(256, dtype=np.uint8)
    chars[0:4] = np.frombuffer(b"acgt", dtype=np.uint8)
    chars[WILDCARD] = ord(DNAWILDCARDS[0])
    chars[MAPSIZEDNA - 1] = ord(DNAWILDCARDS[0])
    a.characters = chars
    a.al1_text = DNA_AL1_TEXT
    return a


def protein_alphabet(map_wildcards: bool = True) -> Alphabet:
    """The built-in protein alphabet (reference assignProteinalphabet,
    alphabet.c:434-446)."""
    a = Alphabet()
    for i, ch in enumerate(PROTEINUPPERAMINOACIDS):
        a.symbolmap[ord(ch)] = i
        a.symbolmap[ord(ch.lower())] = i
    wc = WILDCARD if map_wildcards else MAPSIZEPROTEIN - 1
    for ch in PROTEINWILDCARDS:
        a.symbolmap[ord(ch)] = wc
    a.mapsize = MAPSIZEPROTEIN
    domain = PROTEINUPPERAMINOACIDS + PROTEINWILDCARDS
    a.domainsize = len(domain)
    a.mapdomain = domain.encode()
    a.mappedwildcards = len(PROTEINWILDCARDS)
    chars = np.zeros(256, dtype=np.uint8)
    chars[0:MAPSIZEPROTEIN - 1] = np.frombuffer(
        PROTEINUPPERAMINOACIDS.encode(), dtype=np.uint8
    )
    chars[WILDCARD] = ord(PROTEINWILDCARDS[0])
    chars[MAPSIZEPROTEIN - 1] = ord(PROTEINWILDCARDS[0])
    a.characters = chars
    a.al1_text = PROTEIN_AL1_TEXT
    return a


def parse_symbolmap(text: str, map_wildcards: bool = True) -> Alphabet:
    """Parse a symbol-map file (reference readsymbolmapviafp,
    alphabet.c:195-280).

    Each non-comment line defines one character class; characters before
    the first blank are equivalent; the char after the blank (if any) is
    the display character.  The last line is the wildcard class.
    """
    a = Alphabet()
    mapdomain = bytearray()
    preamble = True
    for line in text.splitlines():
        if not line:
            continue
        if preamble and line.startswith("#"):
            continue
        preamble = False
        display = None
        i = 0
        for i, cc in enumerate(line):
            if cc == " ":
                rest = line[i + 1:]
                if not rest or rest[0].isspace():
                    raise ValueError(f"illegal character at end of line {line!r}")
                display = rest[0]
                break
            if not (cc.isalnum() or _ispunct(cc)):
                raise ValueError(f"illegal character {cc!r} in symbol map line")
            if a.symbolmap[ord(cc)] != a.undefsymbol:
                raise ValueError(
                    f"cannot map symbol {cc!r} to {a.mapsize}: already mapped"
                )
            a.symbolmap[ord(cc)] = a.mapsize
            mapdomain.append(ord(cc))
        if display is None:
            display = line[0]
        a.characters[a.mapsize] = ord(display)
        a.mapsize += 1
    if a.mapsize == 0:
        raise ValueError("empty symbol map")
    # Last class = wildcards
    wc_class = a.mapsize - 1
    wc_mask = a.symbolmap == wc_class
    a.mappedwildcards = int(wc_mask.sum())
    if map_wildcards:
        a.symbolmap[wc_mask] = WILDCARD
        a.characters[WILDCARD] = a.characters[wc_class]
    a.domainsize = len(mapdomain)
    a.mapdomain = bytes(mapdomain)
    a.al1_text = text if text.endswith("\n") else text + "\n"
    return a


def read_symbolmap(path: str, map_wildcards: bool = True) -> Alphabet:
    """Read a symbol map file, searching ``MKVTREESMAPDIR`` like the
    reference (scanpathsforfile, mkvprocess.c:523)."""
    candidates = [path]
    smapdir = os.environ.get("MKVTREESMAPDIR")
    if smapdir and not os.path.isabs(path):
        candidates += [os.path.join(d, path) for d in smapdir.split(":")]
    for cand in candidates:
        if os.path.exists(cand):
            with open(cand, "r") as fh:
                return parse_symbolmap(fh.read(), map_wildcards)
    raise FileNotFoundError(f"symbol map file {path!r} not found")


def _ispunct(c: str) -> bool:
    return c.isprintable() and not c.isalnum() and not c.isspace()


def guess_if_protein(data: bytes, max_scan: int = 1000) -> bool:
    """Guess whether FASTA content is protein (reference guessprot.c):
    scan the first sequence characters; if a character outside
    ``acgtunswACGTUNSW`` (DNA + common wildcards) appears, call it
    protein."""
    dna_chars = set(b"acgtunswrykmbdhvACGTUNSWRYKMBDHV")
    count = 0
    indesc = False
    for b in data:
        if count >= max_scan:
            break
        c = chr(b)
        if indesc:
            if c == "\n":
                indesc = False
            continue
        if c == ">":
            indesc = True
            continue
        if c.isspace():
            continue
        if b not in dna_chars:
            return True
        count += 1
    return False

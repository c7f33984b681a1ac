"""Special character values used in encoded multiple sequences.

Mirrors the behavioral contract of the reference's character model
(reference: src/include/chardef.h): encoded sequences are arrays of
uint8 codes where values below ``UNDEFCHAR`` are regular alphabet codes
and the top three values are reserved:

- ``SEPARATOR`` (255): separates concatenated sequences in a Multiseq.
- ``WILDCARD`` (254): wildcard class characters.  Two wildcards never
  match each other, even if they came from the same input letter.
- ``UNDEFCHAR`` (253): "undefined" marker used by symbol maps and the
  Burrows-Wheeler transform (``UNDEFBWTCHAR``).

A character is *special* iff its code is >= ``WILDCARD``.  Special
characters have position-dependent ordering in the suffix sort: a
special beats any regular character, and two specials compare by their
absolute text position (earlier = smaller).  See
reference src/Mkvtree/remainsort.c:73-127.
"""

SEPARATOR: int = 255
WILDCARD: int = 254
UNDEFCHAR: int = 253
UNDEFBWTCHAR: int = UNDEFCHAR

DNAALPHASIZE: int = 4


def is_special(code: int) -> bool:
    """True iff code is WILDCARD or SEPARATOR (reference ISSPECIAL)."""
    return code >= WILDCARD


def is_bwt_special(code: int) -> bool:
    """True iff code is special or UNDEFBWTCHAR (reference ISBWTSPECIAL)."""
    return code >= UNDEFBWTCHAR

"""Encodedsequence analog: 2-bit packed sequence storage.

The reference auto-chooses among direct / bit-packed / special-table
representations for its in-memory sequence
(src/kurtz-basic/encodedseq.c:39-70 ``determinesizeofrepresentation``,
``Viadirectaccess``/``Viabitaccess``/``Via*tables``).  In this
framework the DEVICE-side equivalent is structural: every hot kernel
gathers packed derived tables, not raw bytes — the LCE/LCP word tables
carry 13 chars + the first-special offset per int32
(index/sort.py lce_pack_params, ~2.3 bits/char) and the rank lookup
uses base-(sigma+1) key words (index/esa.py rank_words) — so raw text
gathers never sit on the critical path.

What remains is the reference's STORAGE concern: holding a large
sequence set in host RAM while shards build (index/build.py
build_suf_out_of_core) or while an index is consumed out of core.
This module is that piece: 4 chars/byte for the regular symbols plus a
sorted (position, code) exception list for specials — the same layout
idea as the reference's bit-access + special-position tables.
"""

from __future__ import annotations

import numpy as np

from .chardef import WILDCARD


class Encodedsequence:
    """2-bit packed sequence with a special-position side table.

    Supports alphabets with < 4 regular symbols per 2 bits only for
    DNA-sized alphabets (sigma <= 4); larger alphabets fall back to
    byte storage (``packed is None``), mirroring the reference's
    representation choice (encodedseq.c:39-70).
    """

    __slots__ = ("n", "packed", "raw", "spec_pos", "spec_code")

    def __init__(self, text: np.ndarray):
        self.n = int(text.size)
        regular = text < WILDCARD
        if self.n and regular.any() and int(text[regular].max()) > 3:
            # not 2-bit packable: direct access representation
            self.packed = None
            self.raw = text.copy()
            self.spec_pos = None
            self.spec_code = None
            return
        self.raw = None
        self.spec_pos = np.flatnonzero(~regular).astype(np.int64)
        self.spec_code = text[self.spec_pos].copy()
        t = np.where(regular, text, 0).astype(np.uint8)
        pad = (-self.n) % 4
        if pad:
            t = np.concatenate([t, np.zeros(pad, np.uint8)])
        t = t.reshape(-1, 4)
        self.packed = (t[:, 0] | (t[:, 1] << 2) | (t[:, 2] << 4)
                       | (t[:, 3] << 6)).astype(np.uint8)

    @property
    def nbytes(self) -> int:
        if self.packed is None:
            return int(self.raw.nbytes)
        return int(self.packed.nbytes + self.spec_pos.nbytes
                   + self.spec_code.nbytes)

    def decode(self, start: int = 0, stop: int | None = None
               ) -> np.ndarray:
        """Materialize text[start:stop] as uint8 (the byte encoding
        every engine consumes)."""
        stop = self.n if stop is None else min(stop, self.n)
        if start >= stop:
            return np.zeros(0, np.uint8)
        if self.packed is None:
            return self.raw[start:stop].copy()
        b0 = start // 4
        b1 = (stop + 3) // 4
        blk = self.packed[b0:b1]
        out = np.empty((blk.size, 4), np.uint8)
        out[:, 0] = blk & 3
        out[:, 1] = (blk >> 2) & 3
        out[:, 2] = (blk >> 4) & 3
        out[:, 3] = (blk >> 6) & 3
        flat = out.reshape(-1)[start - b0 * 4:
                               start - b0 * 4 + (stop - start)]
        flat = flat.copy()
        lo = np.searchsorted(self.spec_pos, start)
        hi = np.searchsorted(self.spec_pos, stop)
        if hi > lo:
            flat[self.spec_pos[lo:hi] - start] = self.spec_code[lo:hi]
        return flat

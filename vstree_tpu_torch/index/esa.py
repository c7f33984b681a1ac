"""Enhanced suffix array (ESA) container of the port.

Analog of the reference ``Virtualtree`` struct (reference:
src/include/virtualdef.h:186-219) and counterpart of
``vstree_tpu/index/esa.py``: the same fields and host methods, with
device tables as torch tensors on ``esa.dev``.  Differences from the
reference by design:

- tables are flat arrays (int32 ranks, uint8 text) rather than
  memory-mapped byte files; the 1-byte lcp + exception-pair encoding of
  the reference (virtualdef.h:121-136) exists only in the on-disk
  serialization (:mod:`vstree_tpu_torch.index.io`), in memory lcp is
  plain int32,
- the suffix array covers ranks ``0..n`` where rank ``n`` holds the
  sentinel suffix at position ``n`` (the sentinel orders *after* every
  other suffix, matching the reference's "$ is greater than every
  symbol" convention, remainsort.c:73-127),
- ``bwttab[r] = text[suftab[r]-1]`` with ``UNDEFBWTCHAR`` at the rank
  of suffix 0 (reference kurtz/bwtcode.c:293-311).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..core.alphabet import Alphabet
from ..core.multiseq import Multiseq

# suffix ranks per packing step of ESA.rank_keys: at most 15 MiB of
# temporaries a step (an int64 suftab's upload the most), beside the
# text's codes (n + W bytes)
_KEY_CHUNK = 1 << 20

# the public fields an ESA-like object hands over in ESA.from_shared
_SHARED_FIELDS = ("multiseq", "alpha", "suftab", "lcptab", "bwttab",
                  "bcktab", "stitab", "skptab", "prefixlength", "longest",
                  "maxbranchdepth", "largelcpvalues", "indexname")


@dataclass
class ESA:
    """Enhanced suffix array over an encoded Multiseq.

    All big tables are NumPy arrays host-side; the device views
    (:meth:`device`, :meth:`device_suf32`, :meth:`rank_keys`,
    :meth:`aux_bck_device`) are torch tensors on ``dev``, moved once
    and held in ``_torch_cache``.
    """

    multiseq: Multiseq
    alpha: Alphabet
    suftab: np.ndarray          # int32[n+1], suffix start positions by rank
    lcptab: np.ndarray | None = None   # int32[n+1], lcp with previous rank
    bwttab: np.ndarray | None = None   # uint8[n+1]
    bcktab: np.ndarray | None = None   # uint32[2*numofcodes] (left, mid)
    stitab: np.ndarray | None = None   # int32[n+1], inverse of suftab
    skptab: np.ndarray | None = None   # int32[n+1]
    prefixlength: int = 0
    longest: int = 0            # rank of suffix 0
    maxbranchdepth: int = 0
    largelcpvalues: int = 0     # count of lcp values >= 255 (for .prj)
    indexname: str = ""
    dev: torch.device | None = None
    _aux_bck: dict[Any, Any] = field(default_factory=dict, repr=False)
    _torch_cache: dict[Any, Any] = field(default_factory=dict, repr=False)

    @classmethod
    def from_shared(cls, esa, device) -> "ESA":
        """An ESA of the port from any object that carries the public
        fields by name (an ESA of the JAX package, as its ``read_index``
        or ``build_esa`` return it): the NumPy tables are shared, the
        caches start empty."""
        kw = {name: getattr(esa, name) for name in _SHARED_FIELDS}
        return cls(**kw, dev=torch.device(device))

    @classmethod
    def read(cls, indexname: str, device, **kw) -> "ESA":
        """Map a reference-format index from disk
        (:func:`vstree_tpu_torch.index.io.read_index`, which takes the
        keywords ``kw``) with device tables on ``device``."""
        from .io import read_index

        esa = read_index(indexname, **kw)
        esa.dev = torch.device(device)
        return esa

    @property
    def totallength(self) -> int:
        return self.multiseq.totallength

    @property
    def numofcodes(self) -> int:
        return (self.alpha.num_regular ** self.prefixlength
                if self.prefixlength > 0 else 0)

    @property
    def text(self) -> np.ndarray:
        return self.multiseq.sequence

    def key_bits(self) -> int:
        """Bits per char in packed rank keys: regular codes 1..σ,
        saturation code (1<<bits)-1 strictly above them."""
        import math

        return max(3, math.ceil(math.log2(self.alpha.num_regular + 2)))

    def chars_per_word(self) -> int:
        """Chars per base-(sigma+1) packed key word: the largest e with
        (sigma+1)**e < 2**31 (13 for DNA, 7 for protein)."""
        base = self.alpha.num_regular + 1
        e = 1
        while base ** (e + 1) < (1 << 31):
            e += 1
        return e

    def _dev(self) -> torch.device:
        if self.dev is None:
            raise ValueError("ESA has no device: build it with a device "
                             "or wrap it with ESA.from_shared")
        return self.dev

    def device(self, name: str) -> torch.Tensor:
        """Table ``name`` as a tensor on ``self.dev``, cached."""
        key = ("table", name)
        if key not in self._torch_cache:
            host = {
                "text": self.text,
                "suftab": self.suftab,
                "lcptab": self.lcptab,
                "bwttab": self.bwttab,
                "stitab": self.stitab,
                "skptab": self.skptab,
            }[name]
            if host is None:
                raise ValueError(f"table {name} not built")
            self._torch_cache[key] = torch.from_numpy(
                np.ascontiguousarray(host)).to(self._dev())
        return self._torch_cache[key]

    def rank_keys(self, depth: int, levels: int) -> torch.Tensor:
        """Packed comparison keys per suffix rank, int32
        [levels, n+1] on ``self.dev``, cached: ``keys[lv][r]`` packs
        chars ``text[suftab[r]+depth+lv*cpk : +cpk]`` at ``key_bits``
        bits each (regular char c -> c+1; specials and past-the-end
        saturate to the max code from their first occurrence onward,
        which keeps keys monotone over ranks).  One int32 gather then
        replaces a cpk-char window gather in batched searches.

        Made on ``self.dev`` in chunks of ``_KEY_CHUNK`` ranks: per char
        offset one gather from the text's codes (char + 1, 0 for a
        special, ``W`` zeros past the end), the saturation flag and a
        shift-or into the level's row (``cpk * bits <= 30``)."""
        key = ("keys", depth, levels)
        if key in self._torch_cache:
            return self._torch_cache[key]
        n = self.totallength
        if n == 0:
            # as the JAX package's NumPy packing, which reads text[0]
            raise IndexError("index 0 is out of bounds for axis 0 with "
                             "size 0")
        dev = self._dev()
        bits = self.key_bits()
        cpk = 30 // bits
        W = levels * cpk
        maxcode = (1 << bits) - 1
        text = self.device("text")
        codes = torch.zeros(n + W, dtype=torch.uint8, device=dev)
        torch.add(text, 1, out=codes[:n]).masked_fill_(text >= 250, 0)
        R = self.suftab.size
        out = torch.empty((levels, R), dtype=torch.int32, device=dev)
        d = min(depth, n)  # min(suf + d, n) == min(suf + depth, n)
        for c0 in range(0, R, _KEY_CHUNK):
            c1 = min(c0 + _KEY_CHUNK, R)
            # a copy: on the CPU from_numpy shares suftab's memory
            base = torch.from_numpy(self.suftab[c0:c1]).to(dev).to(
                torch.int32, copy=True).clamp_(max=n - d).add_(d)
            sat = torch.zeros(c1 - c0, dtype=torch.bool, device=dev)
            for lv in range(levels):
                k = out[lv, c0:c1].zero_()
                for j in range(lv * cpk, (lv + 1) * cpk):
                    ch = codes[j:].index_select(0, base)
                    sat |= ch == 0
                    k.bitwise_left_shift_(bits).bitwise_or_(
                        ch.masked_fill_(sat, maxcode))
        self._torch_cache[key] = out
        return out

    def device_suf32(self) -> torch.Tensor:
        """``suftab`` as an int32 tensor on ``self.dev`` (what kernel K1
        reads), cached; an index read from disk holds it as int64 on the
        host, and only the narrow copy goes to the device."""
        return self._device32("suftab")

    def device_lcp32(self) -> torch.Tensor:
        """``lcptab`` as an int32 tensor on ``self.dev`` (what the
        self-match programs read), cached as :meth:`device_suf32` is."""
        return self._device32("lcptab")

    def _device32(self, name: str) -> torch.Tensor:
        host = getattr(self, name)
        if host is None or host.dtype == np.int32:
            return self.device(name)
        key = ("table", name + "32")
        if key not in self._torch_cache:
            self._torch_cache[key] = torch.from_numpy(
                host.astype(np.int32)).to(self._dev())
        return self._torch_cache[key]

    def aux_bck_device(self, depth: int) -> torch.Tensor:
        """Bucket table at an arbitrary prefix depth (never serialized)
        as an int64 tensor on ``self.dev`` (torch has few uint32 ops),
        made there by ``bck_table_device``; cached."""
        key = ("aux_bck", depth)
        if key not in self._torch_cache:
            from .build import bck_table_device

            self._torch_cache[key] = bck_table_device(
                self.device("text"), self.alpha.num_regular, depth)
        return self._torch_cache[key]

    def aux_bck(self, depth: int) -> np.ndarray:
        """:meth:`aux_bck_device` as a uint32 host array, cached."""
        if depth not in self._aux_bck:
            self._aux_bck[depth] = self.aux_bck_device(
                depth).cpu().numpy().astype(np.uint32)
        return self._aux_bck[depth]

    def aux_bck_maxwidth(self, depth: int) -> int:
        """Maximal bucket width of the depth-d bucket table (bounds
        the binary-search step count); cached."""
        k = ("maxw", depth)
        if k not in self._aux_bck:
            bck = self.aux_bck_device(depth)
            self._aux_bck[k] = (int((bck[1::2] - bck[0::2]).max())
                                if bck.numel() else 0)
        return self._aux_bck[k]

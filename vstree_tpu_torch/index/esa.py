"""The port's enhanced suffix array: the shared :class:`vstree_tpu.
index.esa.ESA` (NumPy tables) with torch device views.

The shared class's ``device``, ``rank_keys``, ``rank_words`` and
``aux_bck_device`` return jax arrays and ``aux_bck`` reaches the JAX
build module.  This subclass overrides all five: they return torch
tensors on ``esa.dev``, held in a cache of its own (``_torch_cache``,
never the shared ``_device_cache``), and ``aux_bck`` uses the port's
``bck_table``.  The host packing of the key words is the shared
class's, copied because there it sits inside the jax-returning methods.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from vstree_tpu.index.esa import ESA as SharedESA

_HOST_CHUNK = 1 << 21  # suffix ranks per host packing step


@dataclass
class ESA(SharedESA):
    """Enhanced suffix array whose device tables live on ``dev``."""

    dev: torch.device | None = None
    _torch_cache: dict[Any, Any] = field(default_factory=dict, repr=False)

    @classmethod
    def from_shared(cls, esa: SharedESA, device) -> "ESA":
        """Wrap an ESA of the shared class (as ``index.io.read_index``
        or the JAX ``build_esa`` return it); the NumPy tables are
        shared, the caches start empty."""
        kw = {f.name: getattr(esa, f.name)
              for f in dataclasses.fields(SharedESA)
              if not f.name.startswith("_")}
        return cls(**kw, dev=torch.device(device))

    @classmethod
    def read(cls, indexname: str, device) -> "ESA":
        """Map a reference-format index from disk (the shared
        ``index.io.read_index``) with device tables on ``device``."""
        from vstree_tpu.index.io import read_index

        return cls.from_shared(read_index(indexname), device)

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
        [levels, n+1] (see the shared class for the encoding)."""
        key = ("keys", depth, levels)
        if key not in self._torch_cache:
            bits = self.key_bits()
            cpk = 30 // bits
            W = levels * cpk
            n = self.totallength
            text = self.text
            starts = self.suftab.astype(np.int64)
            R = starts.size
            out = np.zeros((levels, R), np.int32)
            maxcode = (1 << bits) - 1
            for c0 in range(0, R, _HOST_CHUNK):
                st = starts[c0:c0 + _HOST_CHUNK, None]
                idx = st + depth + np.arange(W)[None, :]
                inb = idx < n
                ch = text[np.minimum(idx, max(n - 1, 0))].astype(np.int32)
                special = (~inb) | (ch >= 250)
                sat = np.maximum.accumulate(special, axis=1)
                code = np.where(sat, maxcode, ch + 1)
                for lv in range(levels):
                    k = np.zeros(st.size, np.int64)
                    for j in range(cpk):
                        k = (k << bits) | code[:, lv * cpk + j]
                    out[lv, c0:c0 + _HOST_CHUNK] = k.astype(np.int32)
            self._torch_cache[key] = torch.from_numpy(out).to(self._dev())
        return self._torch_cache[key]

    def rank_words_host(self, depth: int):
        """(t1, t2): flat int32 host tables, (ROWS*128,), of the two
        base-(σ+1) key words per rank (see the shared ``rank_words``);
        rows past rank n hold INT32_MAX.  Cached."""
        key = ("host words", depth)
        if key not in self._torch_cache:
            sigma = self.alpha.num_regular
            base = sigma + 1
            cpw = self.chars_per_word()
            W = 2 * cpw
            n = self.totallength
            text = self.text
            starts = self.suftab.astype(np.int64)
            R = starts.size
            rows = (R + 127) // 128 + 8
            out1 = np.full(rows * 128, np.iinfo(np.int32).max, np.int32)
            out2 = np.full(rows * 128, np.iinfo(np.int32).max, np.int32)
            for c0 in range(0, R, _HOST_CHUNK):
                st = starts[c0:c0 + _HOST_CHUNK, None]
                idx = st + depth + np.arange(W)[None, :]
                inb = idx < n
                ch = text[np.minimum(idx, max(n - 1, 0))].astype(np.int64)
                special = (~inb) | (ch >= sigma)
                sat = np.maximum.accumulate(special, axis=1)
                dig = np.where(sat, sigma, ch)
                w1 = np.zeros(st.size, np.int64)
                w2 = np.zeros(st.size, np.int64)
                for j in range(cpw):
                    w1 = w1 * base + dig[:, j]
                    w2 = w2 * base + dig[:, cpw + j]
                out1[c0:c0 + st.shape[0]] = w1.astype(np.int32)
                out2[c0:c0 + st.shape[0]] = w2.astype(np.int32)
            self._torch_cache[key] = (out1, out2)
        return self._torch_cache[key]

    def rank_words(self, depth: int):
        """(t1, t2): the key-word tables as int32 (ROWS, 128) tensors on
        ``self.dev`` for the rank-count kernel.  Cached."""
        key = ("words", depth)
        if key not in self._torch_cache:
            h1, h2 = self.rank_words_host(depth)
            self._torch_cache[key] = tuple(
                torch.from_numpy(h.reshape(-1, 128)).to(self._dev())
                for h in (h1, h2))
        return self._torch_cache[key]

    def aux_bck(self, depth: int) -> np.ndarray:
        """Bucket table at an arbitrary prefix depth (never
        serialized), from the port's ``bck_table``."""
        if depth not in self._aux_bck:
            from .build import bck_table

            self._aux_bck[depth] = bck_table(
                self.text, self.alpha.num_regular, depth)
        return self._aux_bck[depth]

    def aux_bck_device(self, depth: int) -> torch.Tensor:
        """:meth:`aux_bck` as an int64 tensor on ``self.dev`` (torch has
        few uint32 ops)."""
        key = ("aux_bck", depth)
        if key not in self._torch_cache:
            self._torch_cache[key] = torch.from_numpy(
                self.aux_bck(depth).astype(np.int64)).to(self._dev())
        return self._torch_cache[key]

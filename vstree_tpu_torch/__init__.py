"""vstree_tpu_torch — the vstree engine on PyTorch and CUDA (NVIDIA Hopper).

A second package beside :mod:`vstree_tpu`, which stays the reference.
It imports ``torch``, never ``jax`` and nothing of :mod:`vstree_tpu`:
what it needs of that package's NumPy modules (alphabets,
multi-sequences, index file I/O, match tables, the funnel, rendering,
alignments, E-values) it keeps as its own copy under the same relative
path and names.

Ported so far: ``mkvtree -dna -pl -allout`` followed by ``vmatch
-complete -q``, exact or approximate (``-e k`` / ``-h k``):

- :mod:`vstree_tpu_torch.core`, ``stats``, ``output`` — the copied host
  modules
- :mod:`vstree_tpu_torch.index`   — suffix sort, LCP ladder, skip table,
  derived tables, the ESA container (torch ops on device tensors) and
  the index files
- :mod:`vstree_tpu_torch.engine`  — exact and approximate
  complete-match search, match tables, the funnel
- :mod:`vstree_tpu_torch.native`  — hand-written CUDA kernels (sm_90a),
  each with its plain PyTorch version, and the kernel build
- :mod:`vstree_tpu_torch.cli`     — the mkvtree / vmatch entry points

The device is always explicit: functions take tensors or a
``torch.device``.  CPU tensors run every kernel's plain version; a CUDA
tensor launches the kernel or raises.
"""

__version__ = "0.1.0"

"""vstree_tpu_torch — the vstree engine on PyTorch and CUDA (NVIDIA Hopper).

A second package beside :mod:`vstree_tpu`, which stays the reference.
It imports ``torch`` and never ``jax``.  Modules of :mod:`vstree_tpu`
that never import jax (alphabets, multi-sequences, index file I/O,
match tables, the funnel, rendering, E-values) are shared, not copied.

Ported so far: the main path ``mkvtree -dna -pl -allout`` followed by
``vmatch -complete -q``:

- :mod:`vstree_tpu_torch.index`   — suffix sort, LCP ladder, skip table,
  derived tables and the ESA container (torch ops on device tensors)
- :mod:`vstree_tpu_torch.engine`  — exact complete-match lookup
- :mod:`vstree_tpu_torch.native`  — hand-written CUDA kernels (sm_90a),
  each with its plain PyTorch version, and the kernel build
- :mod:`vstree_tpu_torch.cli`     — the mkvtree / vmatch entry points

The device is always explicit: functions take tensors or a
``torch.device``.  CPU tensors run every kernel's plain version; a CUDA
tensor launches the kernel or raises.
"""

__version__ = "0.1.0"

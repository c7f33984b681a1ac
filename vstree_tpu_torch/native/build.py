"""Builds the port's CUDA kernels from ``native/csrc`` at first use.

``nvcc`` compiles every ``.cu`` file of ``csrc/`` for ``sm_90a`` into
one shared library with a plain C interface, which the wrappers load
through ``ctypes`` (pointers from ``Tensor.data_ptr()``, the stream
from ``torch.cuda.current_stream().cuda_stream``).  No source includes
PyTorch's headers, so a build takes seconds where
``torch.utils.cpp_extension.load`` takes minutes, and it needs no
``ninja``.

The library lands in ``<repo>/build/kernels/`` under a name hashed
from the sources and flags, so an edited source builds anew and an
unchanged one is reused.  A failed build raises with the compiler's
output; nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ("-std=c++17", "-O3", ARCH, "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one
    on ``PATH``, else the toolkit's default location."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvstree_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build (when not yet built) and load the kernel library."""
    lib = library_path()
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            os.unlink(tmp)
            raise RuntimeError(f"kernel build: no CUDA compiler ({e})")
        log = lib.with_suffix(".log")
        log.write_text(" ".join(cmd) + "\n" + r.stdout + r.stderr)
        if r.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"kernel build failed (exit {r.returncode}):\n"
                f"{r.stdout}{r.stderr}")
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


def build_log() -> str:
    """The compiler's output of the last build (``-Xptxas=-v``: the
    registers and shared memory of each kernel)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""

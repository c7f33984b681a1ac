"""Builds the port's CUDA kernels from ``native/csrc`` at first use.

``nvcc`` compiles every ``.cu`` file of ``csrc/`` for ``sm_90a`` into a
shared library of its own with a plain C interface, all compilers
started together, and the wrappers load them through ``ctypes``
(pointers from ``Tensor.data_ptr()``, the stream from
``torch.cuda.current_stream().cuda_stream``).  No source includes
PyTorch's headers, so a build takes seconds where
``torch.utils.cpp_extension.load`` takes minutes, and it needs no
``ninja``.

The libraries land in ``<repo>/build/kernels/`` under names hashed
from the source and the flags, so an edited source builds anew and an
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


def library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvstree_{src.stem}_{h.hexdigest()[:16]}.so"


@functools.cache
def load_kernels() -> dict[str, ctypes.CDLL]:
    """Build (when not yet built) and load the kernel libraries: source
    stem (``rankcount``, ``myers``) -> library.  The compilers of all
    sources that need a build run side by side."""
    running = []
    for src in _sources():
        lib = library_path(src)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except FileNotFoundError as e:  # the first source: none runs yet
            os.unlink(tmp)
            raise RuntimeError(f"kernel build: no CUDA compiler ({e})")
        running.append((src, lib, tmp, cmd, proc))
    failed = []
    for src, lib, tmp, cmd, proc in running:
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{src.name} (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {src.stem: ctypes.CDLL(str(library_path(src)))
            for src in _sources()}


def build_log() -> str:
    """The compilers' output of the last builds (``-Xptxas=-v``: the
    registers and shared memory of each kernel)."""
    logs = (library_path(src).with_suffix(".log") for src in _sources())
    return "".join(log.read_text() for log in logs if log.exists())

"""Device selection and phase timing.

There is no "CUDA if present, else CPU" helper: the entry points ask for
the card with :func:`cuda_device`, which raises without one, and the
library functions take the device they run on as an argument.  The CPU
runs the port only where a caller passes CPU tensors or ``"cpu"``
explicitly (the tests).
"""

from __future__ import annotations

import contextlib
import contextvars
import time

import torch


def cuda_device() -> torch.device:
    """The current CUDA card; raises when PyTorch sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "vstree_tpu_torch needs a CUDA device, and "
            "torch.cuda.is_available() is false")
    return torch.device("cuda", torch.cuda.current_device())


class PhaseTimes:
    """Seconds per named phase of a run.  A phase ends with a device
    synchronise, so its time includes the device work it queued."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.seconds: dict[str, float] = {}

    def add(self, name: str, seconds: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds


_RECORDER: contextvars.ContextVar[PhaseTimes | None] = (
    contextvars.ContextVar("vstree_tpu_torch_phase_times", default=None))


@contextlib.contextmanager
def record_phases(times: PhaseTimes):
    """Record every :func:`phase` entered inside the block into
    ``times``; outside such a block phases cost one context lookup."""
    token = _RECORDER.set(times)
    try:
        yield times
    finally:
        _RECORDER.reset(token)


@contextlib.contextmanager
def phase(name: str):
    """Mark a phase of the build or query path for :func:`record_phases`."""
    times = _RECORDER.get()
    if times is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if times.device.type == "cuda":
            torch.cuda.synchronize(times.device)
        times.add(name, time.perf_counter() - t0)

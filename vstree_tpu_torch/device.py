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


def cuda_devices() -> list[torch.device]:
    """Every CUDA card, the devices that ``-numproc`` may take; raises
    when PyTorch sees none."""
    cuda_device()
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class PhaseTimes:
    """Seconds per named phase of a run, and the counts the phases
    report (:func:`count`).  A phase ends with a device synchronise, so
    its time includes the device work it queued."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        # per open phase, the seconds of the phases nested in it
        self.nested: list[float] = []

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
    """Mark a phase of the build or query path for :func:`record_phases`.
    A phase inside another counts for itself only: the outer one's
    seconds leave out the inner ones', so the phases of a run never add
    up to more than its wall time."""
    times = _RECORDER.get()
    if times is None:
        yield
        return
    t0 = time.perf_counter()
    times.nested.append(0.0)
    try:
        yield
    finally:
        if times.device.type == "cuda":
            torch.cuda.synchronize(times.device)
        dt = time.perf_counter() - t0
        times.add(name, dt - times.nested.pop())
        if times.nested:
            times.nested[-1] += dt


def count(name: str, n: int) -> None:
    """Add ``n`` to the named count of the run that :func:`record_phases`
    records (seeds, survivors); nothing outside such a block."""
    times = _RECORDER.get()
    if times is not None:
        times.counts[name] = times.counts.get(name, 0) + n

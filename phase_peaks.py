"""Where a benchmark cell reaches its device memory peak: one run of
each named cell of ``BENCHMARK.json`` on the card, and per phase, in
the order the phases ended, its seconds, the device memory allocated
at its end and the peak since the run began at its start and at its
end (MiB); and for every launch of kernel K2 in the warm-up run, its
candidates P, window L, the columns its candidates run and its bound
(``chip_smoke.k2_work``, ``chip_smoke.bound_ms``: the least time the
card could take for that work).

    python3 phase_peaks.py complete-exact-100k-yeast complete-e1-50k-yeast

From the root of a checkout.  Inputs and indexes are made as
``python3 -m bench_torch`` makes them (default seed, under
``build/bench_torch/``); each cell runs once untimed, then once
recorded, as a timed run of the benchmark (peak statistics reset just
before it).  The peak is cumulative: the run reached it inside the
first phase whose end reads it and whose start does not, or before
the first phase whose start reads it (in its parent phase, or outside
every phase).  Prints one
JSON line per cell.  Exits 1 without a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch


def main(cells: list[str]) -> int:
    if not torch.cuda.is_available():
        print("phase_peaks: torch.cuda.is_available() is false; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from bench_torch.cells import HOST_THREADS, Bench
    from vstree_tpu_torch.device import PhaseTimes, record_phases
    from vstree_tpu_torch.native import build, myers

    def peak_mib() -> float:
        return torch.cuda.max_memory_allocated(dev) / 2**20

    class Starts(list):
        """``PhaseTimes.nested``, which ``phase`` appends to as a phase
        starts: notes the peak there."""

        def __init__(self, at_start: list):
            super().__init__()
            self.at_start = at_start

        def append(self, x) -> None:
            self.at_start.append(peak_mib())
            super().append(x)

    class PeakTimes(PhaseTimes):
        """Phase times that also note, per phase, the peak so far at its
        start and at its end and the memory allocated at its end."""

        def __init__(self, device):
            super().__init__(device)
            self.at_start: list[float] = []
            self.nested = Starts(self.at_start)
            self.events: list[tuple[str, float, float, float, float]] = []

        def add(self, name: str, seconds: float) -> None:
            super().add(name, seconds)
            self.events.append((
                name, seconds, torch.cuda.memory_allocated(dev) / 2**20,
                self.at_start.pop(), peak_mib()))

    def k2_bounds(cell: str, launches: list) -> None:
        for args in launches:
            cols, nbytes, ops = chip_smoke.k2_work(*args)
            print(f"{cell}: K2 launch P={args[1].numel()} L={args[5]} "
                  f"queries={args[4].numel()} columns run={cols} {nbytes} "
                  f"bytes, {ops} int ops -> "
                  f"{chip_smoke.bound_ms(nbytes, ops)}", flush=True)

    dev = torch.device("cuda", 0)
    torch.set_num_threads(HOST_THREADS)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    build.load_kernels()
    bench = Bench(dev, log=lambda *a: print(*a, flush=True))
    for cell in cells:
        spec = bench.spec(cell)
        k2_args, launch = [], myers.launch

        def noting(*args):
            k2_args.append(args[:5] + args[6:])     # all but ``out``
            launch(*args)

        myers.launch = noting
        try:
            bench.call(spec)                        # warm-up, untimed
        finally:
            myers.launch = launch
        k2_bounds(cell, k2_args)
        k2_args.clear()     # none of them held through the recorded run
        times = PeakTimes(dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with record_phases(times):
            bench.call(spec)
        torch.cuda.synchronize(dev)
        peak = peak_mib()
        held = "(after the last phase)"
        for name, _, _, start, end in times.events:
            if start == peak:   # in its parent phase, or outside them all
                held = f"(before {name} began)"
                break
            if end == peak:
                held = name
                break
        for name, sec, alloc, start, end in times.events:
            print(f"{cell}: {name:18s} {sec:8.3f} s  allocated at its end "
                  f"{alloc:9.1f} MiB  peak so far at its start {start:9.1f}"
                  f" MiB, at its end {end:9.1f} MiB", flush=True)
        print(json.dumps({"cell": cell, "peak_mib": peak,
                          "peak_reached_in": held,
                          "events": times.events}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

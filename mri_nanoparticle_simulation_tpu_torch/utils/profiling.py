"""Timing and throughput utilities.

Counterpart of the reference's ``utils/profiling.py``: a
reference-compatible Timer (``timer.cpuStart()/cpuStop()`` around the
sprint loop, cuda_sim.cu:908, 970, 1027), walker-steps/s accounting, and
a profiler trace of a block (``torch.profiler`` in place of
``jax.profiler``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch

#: the file ``device_trace`` writes into its directory
TRACE_FILE = "trace.json"


class Timer:
    """Reference-compatible start/stop walltime (milliseconds)."""

    def __init__(self):
        self._t0: Optional[float] = None

    def cpu_start(self) -> None:
        self._t0 = time.perf_counter()

    def cpu_stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("cpu_start() was not called")
        ms = (time.perf_counter() - self._t0) * 1e3
        self._t0 = None
        return ms

    def __enter__(self):
        self.cpu_start()
        return self

    def __exit__(self, *exc):
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        self._t0 = None


def walker_steps_per_sec(num_water: int, steps: int, wall_s: float) -> float:
    """The primary throughput metric (BASELINE.md)."""
    return num_water * steps / wall_s if wall_s > 0 else 0.0


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], device):
    """``torch.profiler`` trace around a block, exported as a Chrome
    trace (``log_dir/trace.json``, viewable in chrome://tracing or
    Perfetto); a no-op when ``log_dir`` is None.  The host's activity is
    always traced, the card's too when ``device`` is a CUDA device (it
    has no default, so no caller on the card leaves the card out of its
    trace by omission): a
    trace of such a block that holds no kernel on the card (a card whose
    profiler, CUPTI, is unavailable) raises after writing it, rather
    than pass for a trace of the device."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if on_card:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    if on_card and not trace_kernels(path):
        raise RuntimeError(
            f"the profiler recorded no kernel on the card (is CUPTI "
            f"available?); {path} shows the host alone")


def trace_kernels(path: str) -> list:
    """The names of the device kernels in the Chrome trace at ``path``
    (events of category "kernel")."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return [e["name"] for e in events if e.get("cat") == "kernel"]

"""The traced window: a torch.profiler trace of the card and the host,
read into the numbers the per-layer metrics and the breakdown take.

Device time is the union of the device operations' intervals (kernels,
memsets, copies) inside the window, so operations that overlap count
once; the window is the span ``port_bench.traced_window`` that the
driver opens around the traced calls, each of which ends in a device
sync.  An idle gap is named after the innermost host event (an aten
operation, a CUDA runtime call or a span of the harness) running at the
gap's middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import NamedTuple

import numpy as np
import torch

WINDOW = "port_bench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: longest gaps named one by one; shorter ones are summed unnamed
NAMED_GAPS = 2000


class TraceSummary(NamedTuple):
    window_s: float
    busy_s: float            # union of device operations in the window
    kernel_s: float          # summed kernel durations (overlaps twice)
    kernels: int             # kernel launches in the window
    device_ops: list         # [[name, seconds]], most time first
    idle_gaps: list          # [[host activity, seconds]], most first


class Tracer:
    """``with tracer.window(): ...`` traces the block when enabled; the
    summary is ``tracer.summary`` afterwards (None when disabled)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        try:
            with record_function(WINDOW):
                yield
            torch.cuda.synchronize()
        finally:
            prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            self.summary = summarize(path)
        finally:
            os.remove(path)


def _union(iv):
    """Merged [start, end] intervals of ``iv`` (n x 2, sorted by start)."""
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(path: str, top: int = 10) -> TraceSummary:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation" and "dur" in e]
    if not win:
        raise RuntimeError("the trace holds no traced window")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
           and w0 <= float(e["ts"]) < w1]
    by_name, kernel_us, kernels = {}, 0.0, 0
    iv = []
    for e in dev:
        s, d = float(e["ts"]), float(e["dur"])
        iv.append((s, min(s + d, w1)))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + d
        if e["cat"] == "kernel":
            kernel_us += d
            kernels += 1
    iv.sort()
    merged = _union(iv)
    busy_us = sum(e - s for s, e in merged)
    gaps, prev = [], w0
    for s, e in merged:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((w1 - prev, prev, w1))
    gaps.sort(reverse=True)
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e
            and e.get("name") != WINDOW]
    hs = np.array([float(e["ts"]) for e in host])
    he = hs + np.array([float(e["dur"]) for e in host])
    names = {}
    for length, s, e in gaps[:NAMED_GAPS]:
        mid = 0.5 * (s + e)
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        name = ("host between calls" if inside.size == 0 else
                host[inside[np.argmin(he[inside] - hs[inside])]]["name"])
        names[name] = names.get(name, 0.0) + length
    rest = sum(g[0] for g in gaps[NAMED_GAPS:])
    if rest:
        names["(shorter gaps)"] = rest
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(names.items(), key=lambda kv: -kv[1])[:top]
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
        kernel_s=kernel_us * 1e-6, kernels=kernels,
        device_ops=[[n[:120], v * 1e-6] for n, v in ops],
        idle_gaps=[[n[:120], v * 1e-6] for n, v in idle])

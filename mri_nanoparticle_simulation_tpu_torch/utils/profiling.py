"""Spans inside the port, and a profiler trace of a block.

``span(name)`` (or ``@spanned(name)`` on a whole function) marks a stage
of the port, named ``<layer>.<stage>``.  With no torch profiler running
it is one shared no-op context: it calls no ``record_function``, reads
no clock and allocates nothing.  Under a profiler (``device_trace``, or
any ``torch.profiler.profile``) it enters
``torch.profiler.record_function(name)``, so the span sits in the
Chrome trace on the profiler's clock, beside the kernels, and adds to a
tally kept in memory per name: the calls, the host seconds
(perf_counter) and the self seconds (the host seconds less those of the
spans opened inside it).  Given a CUDA ``device``, it also records a
CUDA event pair on that device's current stream; the pairs are resolved
into device seconds only when the tally is read, so no span syncs.
``span_summary()`` reads the tally, ``reset_spans()`` clears it.

``device_trace`` is the counterpart of the reference's ``jax.profiler``
trace of a block: a ``torch.profiler`` trace written as a Chrome trace,
with the spans' tally beside it.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

#: the files ``device_trace`` writes into its directory
TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"

_OFF = contextlib.nullcontext()
#: name -> _Tally, filled while a profiler runs
_TALLY: dict = {}


class _Open(threading.local):
    """``stack``: the spans open in this thread, innermost last."""

    def __init__(self):
        self.stack = []


_OPEN = _Open()


class _Tally:
    __slots__ = ("calls", "host_s", "self_s", "events", "device_s")

    def __init__(self):
        self.calls, self.host_s, self.self_s = 0, 0.0, 0.0
        self.events, self.device_s = [], None


class _Span:
    __slots__ = ("name", "stream", "rf", "start", "t0", "child_s")

    def __init__(self, name: str, stream):
        self.name, self.stream, self.child_s = name, stream, 0.0

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        _OPEN.stack.append(self)
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host = time.perf_counter() - self.t0
        tally = _TALLY.get(self.name)
        if tally is None:
            tally = _TALLY[self.name] = _Tally()
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            tally.events.append((self.start, end))
        stack = _OPEN.stack
        stack.pop()
        if stack:
            stack[-1].child_s += host
        tally.calls += 1
        tally.host_s += host
        tally.self_s += host - self.child_s
        self.rf.__exit__(*exc)
        return False


def span(name: str, device=None):
    """A span named ``name`` around a block (``with span(...)``); a
    shared no-op context when no profiler runs.  ``device``: a CUDA
    device whose current stream the span also times (events, resolved
    when read); None or a CPU device times the host alone."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    stream = None
    if device is not None and torch.device(device).type == "cuda":
        stream = torch.cuda.current_stream(device)
    return _Span(name, stream)


def spanned(name: str):
    """Decorator: ``span(name)`` around every call of the function."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned_fn(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name, None):
                return fn(*args, **kwargs)
        return spanned_fn
    return wrap


def span_summary() -> dict:
    """``{name: {calls, host_s, self_s, device_s}}`` of the spans closed
    under a profiler since the last ``reset_spans()``; ``device_s`` is
    None for a span that timed no device.  Waits for the device events
    still pending."""
    out = {}
    for name, t in _TALLY.items():
        if t.events:
            for _, end in t.events:
                end.synchronize()
            t.device_s = (t.device_s or 0.0) + sum(
                a.elapsed_time(b) for a, b in t.events) / 1e3
            t.events = []
        out[name] = {"calls": t.calls, "host_s": t.host_s,
                     "self_s": t.self_s, "device_s": t.device_s}
    return out


def reset_spans() -> None:
    _TALLY.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], device):
    """``torch.profiler`` trace around a block, exported as a Chrome
    trace (``log_dir/trace.json``, viewable in chrome://tracing or
    Perfetto), with the block's ``span_summary()`` in
    ``log_dir/spans.json``; a no-op when ``log_dir`` is None.  The
    host's activity is always traced, the card's too when ``device`` is
    a CUDA device (it has no default, so no caller on the card leaves
    the card out of its trace by omission): a trace of such a block that
    holds no kernel on the card (a card whose profiler, CUPTI, is
    unavailable) raises after writing it, rather than pass for a trace
    of the device."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    os.makedirs(log_dir, exist_ok=True)
    reset_spans()
    with profile(activities=acts) as prof:
        yield
        if on_card:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with open(os.path.join(log_dir, SPANS_FILE), "w") as f:
        json.dump(span_summary(), f, indent=1, sort_keys=True)
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

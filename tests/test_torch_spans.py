"""Spans inside the port (``utils/profiling``) and the benchmark metrics
that read them.

* With no profiler running, ``span`` is one shared no-op: it never
  calls ``record_function`` and a whole run records nothing.
* Under ``torch.profiler.profile``, a small CPU ``SimulationRunner.run``
  over two drains puts each ``runner.*``, ``sprint_loop.sprint`` and
  ``chunk_kernel.run_chunk`` span in the Chrome trace as a
  ``user_annotation`` inside its parent's interval, and the tally
  counts exactly: one span a sprint, a chunk, a drain; self seconds are
  a parent's host seconds less its children's.
* ``run_plane_on_device`` gives one set-up, copy and assembly and one
  fold a sprint; the large-scene path one model span a chunk, with no
  device seconds on the CPU.
* Each of ``port_bench``'s five span metrics reads a finite value on a
  context built from such a traced run, and None without a trace.
"""

import json
import math
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mri_nanoparticle_simulation_tpu_torch.engine import (convert,
                                                          cuda_engine,
                                                          decompose, sim)
from mri_nanoparticle_simulation_tpu_torch.engine.reference_engine import \
    init_state
from mri_nanoparticle_simulation_tpu_torch.fields import expansion
from mri_nanoparticle_simulation_tpu_torch.params import small_test_params
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox
from mri_nanoparticle_simulation_tpu_torch.utils import profiling
from port_bench import catalog
from port_bench.trace import WINDOW, summarize

torch.set_num_threads(1)

#: 2000 steps: 4 sprints of 5 chunks, drained 2 at a time
P = small_test_params(sprint_steps=500)
SPRINTS = P.t // P.sprint_steps
CHUNKS = P.t // P.chunk_steps
DEPTH = 2
RUNNER = ("runner.state_in", "runner.fetch", "runner.csv_append",
          "runner.state_out", "sprint_loop.sprint")


def _runner():
    return sim.SimulationRunner(P, scene_seed=3, seed=2, device="cpu",
                                rng_impl="threefry")


def _traced(fn, path):
    """(span_summary(), the Chrome trace's events, its port_bench
    summary) of ``fn()`` under a CPU profiler, in port_bench's window."""
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            fn()
    prof.export_chrome_trace(str(path))
    spans = profiling.span_summary()
    profiling.reset_spans()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return spans, events, summarize(str(path))


@pytest.fixture(scope="module")
def runner_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    runner = _runner()
    return _traced(lambda: runner.run(csv_path=str(d / "t2.csv"),
                                      progress=False, drain_depth=DEPTH),
                   d / "trace.json")


@pytest.fixture(scope="module")
def plane_run(tmp_path_factory):
    sc = BacteriaBox(P, seed=3).populate()
    return _traced(lambda: decompose.run_plane_on_device(
        sc, P, [1.0, 2.0], [0.0005, 0.001], seed=5, device="cpu",
        rng_impl="threefry"), tmp_path_factory.mktemp("plane") / "t.json")


@pytest.fixture(scope="module")
def large_run(tmp_path_factory):
    p = P.replace(far_table_order=2)    # a far table built in ~1 s
    sc = BacteriaBox(p, seed=3).populate()
    tbl = convert.mnp_table(sc.mnps, torch.float32, "cpu")
    cache = expansion.build_cache(tbl.pos, tbl.m, p)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_engine, "REBUILD_MAX_MNPS", 0)
        sprint = cuda_engine.make_sprint_fn(p, p.num_water, "cpu")
        ss = cuda_engine.to_soa(init_state(sc.waters, p, "cpu"), p)

        def two_sprints():
            s = ss
            for _ in range(2):
                s, _ = sprint(tbl, (0, 1), s, cache=cache)
        return _traced(two_sprints,
                       tmp_path_factory.mktemp("large") / "t.json")


def test_span_is_a_shared_no_op_without_a_profiler(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("a") is profiling.span("b", device="cpu")
    profiling.reset_spans()
    _runner().run(csv_path=str(tmp_path / "t2.csv"), progress=False,
                  drain_depth=DEPTH)
    assert profiling.span_summary() == {}


def test_profiler_sets_the_flag_span_reads():
    """``torch.profiler.profile`` (as port_bench's tracer starts it) sets
    the flag ``span`` reads, and stopping it clears the flag."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert torch.autograd.profiler._is_profiler_enabled
        assert profiling.span("a") is not profiling.span("b")
    finally:
        prof.stop()
    assert not torch.autograd.profiler._is_profiler_enabled


def _intervals(events, name):
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("name") == name
            and e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("child,parent", [
    *((s, "runner.run") for s in RUNNER),
    ("chunk_kernel.run_chunk", "sprint_loop.sprint")])
def test_spans_nest_in_the_trace(runner_run, child, parent):
    _, events, _ = runner_run
    kids, outer = _intervals(events, child), _intervals(events, parent)
    assert kids and outer
    for s, e in kids:
        assert any(a <= s and e <= b for a, b in outer), (child, s, e)


@pytest.mark.parametrize("name,calls", [
    ("runner.run", 1), ("runner.state_in", 1), ("runner.state_out", 1),
    ("runner.fetch", SPRINTS // DEPTH),
    ("runner.csv_append", SPRINTS // DEPTH),
    ("sprint_loop.sprint", SPRINTS), ("chunk_kernel.run_chunk", CHUNKS)])
def test_runner_span_counts(runner_run, name, calls):
    spans, _, _ = runner_run
    assert spans[name]["calls"] == calls
    assert 0.0 <= spans[name]["self_s"] <= spans[name]["host_s"]
    assert spans[name]["device_s"] is None


@pytest.mark.parametrize("parent,children", [
    ("runner.run", RUNNER),
    ("sprint_loop.sprint", ("chunk_kernel.run_chunk",))])
def test_self_time_is_host_time_less_the_children(runner_run, parent,
                                                  children):
    spans, _, _ = runner_run
    below = sum(spans[c]["host_s"] for c in children)
    assert spans[parent]["self_s"] == pytest.approx(
        spans[parent]["host_s"] - below, rel=1e-9, abs=1e-9)


def test_runner_run_opens_only_its_spans(runner_run):
    spans, _, _ = runner_run
    assert set(spans) == {"runner.run", *RUNNER, "chunk_kernel.run_chunk"}


def test_plane_span_counts(plane_run):
    spans, _, _ = plane_run
    n = P.t // P.sprint_steps
    for name, calls in (("plane.run", 1), ("plane.setup", 1),
                        ("plane.copy", 1), ("plane.assemble", 1),
                        ("plane.fold", n), ("sprint_loop.sprint", n),
                        ("chunk_kernel.run_chunk", CHUNKS)):
        assert spans[name]["calls"] == calls, name
    below = sum(spans[s]["host_s"] for s in (
        "plane.setup", "plane.fold", "sprint_loop.sprint", "plane.copy",
        "plane.assemble"))
    assert spans["plane.run"]["self_s"] == pytest.approx(
        spans["plane.run"]["host_s"] - below, rel=1e-9, abs=1e-9)


def test_large_path_model_span(large_run):
    spans, _, _ = large_run
    chunks = 2 * P.sprint_steps // P.chunk_steps
    assert spans["sprint_loop.model"]["calls"] == chunks
    assert spans["sprint_loop.model"]["device_s"] is None      # no card
    assert spans["chunk_kernel.run_chunk_near"]["calls"] == chunks
    assert spans["chunk_kernel.run_cand_model"]["calls"] == chunks
    assert "chunk_kernel.run_chunk" not in spans


def _ctx(run, sprints, trace=True):
    _, _, summary = run
    return SimpleNamespace(
        trace=summary if trace else None,
        window={"traced": {"sprints": sprints,
                           "chunks": sprints * P.sprint_steps
                           // P.chunk_steps}})


@pytest.mark.parametrize("name,run,sprints", [
    ("runner.host_pct", "runner_run", SPRINTS),
    ("plane.host_pct", "plane_run", SPRINTS),
    ("sprint_loop.host_us_per_chunk", "runner_run", SPRINTS),
    ("sprint_loop.model_ms_per_chunk", "large_run", 2),
    ("chunk_kernel.host_us_per_launch", "runner_run", SPRINTS),
    ("chunk_kernel.host_us_per_launch", "large_run", 2)])
def test_span_metrics_read_a_traced_run(name, run, sprints, request,
                                        monkeypatch):
    traced = request.getfixturevalue(run)
    spans = traced[0]
    if name == "sprint_loop.model_ms_per_chunk":
        # the CPU times no device: the metric reads nothing, and reads
        # the model's device seconds where a card recorded them
        monkeypatch.setattr(profiling, "span_summary", lambda: spans)
        assert catalog.metrics()[name].read(_ctx(traced, sprints)) is None
        spans = {**spans, "sprint_loop.model": {
            **spans["sprint_loop.model"], "device_s": 0.5}}
    monkeypatch.setattr(profiling, "span_summary", lambda: spans)
    mod = catalog.metrics()[name]
    value = mod.read(_ctx(traced, sprints))
    assert value is not None and math.isfinite(value) and value > 0
    if mod.UNIT == "%":
        assert value < 100
    assert mod.read(_ctx(traced, sprints, trace=False)) is None


@pytest.mark.parametrize("name", [
    "runner.host_pct", "plane.host_pct", "sprint_loop.host_us_per_chunk",
    "sprint_loop.model_ms_per_chunk", "chunk_kernel.host_us_per_launch"])
def test_span_metrics_read_nothing_without_their_spans(runner_run, name,
                                                       monkeypatch):
    """A program without ``span_summary`` (an older checkout) and a cell
    without a metric's spans: the metric reads None and does not
    raise."""
    monkeypatch.delattr(profiling, "span_summary")
    assert catalog.metrics()[name].read(_ctx(runner_run, SPRINTS)) is None

"""The benchmark's ``scaleup-exact`` configuration (README 4a at
far-table order 0) and its cell ``scaleup-order0``, on the CPU:

* the configuration is the CLI's parse of README 4a's command with
  ``--far-table-order 0``;
* the exact reference (``port_bench/reference/exact.py``) against the
  port's plain twins on a seeded small scene forced onto the large
  path: the cube selection, reach counts and near slots exactly, the
  far sums within float32 rounding of a float64 sum, and three chunks'
  steps bit for bit;
* the exact cells' correctness check reads ``correct`` on a sound run, and
  not under the bfloat16 control, nor with a far table in place of the
  exact sums, nor with far sums that leave the near dipoles in or the
  periodic images out;
* the new spans (``expansion.select``, ``chunk_kernel.far_sums``) are
  the shared no-op with no profiler, and under one count a call a chunk;
  the three metrics read them, and read nothing where they are missing.
"""

import ast
import copy
import dataclasses
import json
import math
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mri_nanoparticle_simulation_tpu_torch.engine import (chunk_kernel,
                                                          convert,
                                                          cuda_engine, sim)
from mri_nanoparticle_simulation_tpu_torch.engine.reference_engine import \
    init_state
from mri_nanoparticle_simulation_tpu_torch.fields import expansion
from mri_nanoparticle_simulation_tpu_torch.fields.dipole import \
    bz_taylor_parts
from mri_nanoparticle_simulation_tpu_torch.params import Params
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox
from mri_nanoparticle_simulation_tpu_torch.utils import profiling
from port_bench import catalog, run
from port_bench.drivers import exact as exact_driver
from port_bench.reference import exact as exact_ref
from port_bench.tests import tiny
from port_bench.trace import WINDOW

torch.set_num_threads(1)

SEED = 3_000_000_123
REF_SEED = 2**40 + 4242
CFG = catalog.load_config("scaleup-exact")
#: README 4a's command (README.md:313-316) and the CLI's order-0 switch
README_4A = ["--num-water", "100000", "--num-cells", "2000", "--near-k",
             "10", "--chunk-steps", "4000", "--cube-candidates", "32",
             "--max-neighbors", "40", "--tau", "5e-7", "--totaltime", "4"]
ORDER0 = ["--far-table-order", "0"]
#: the far-table order of the planted table fault here, whose table one
#: CPU core builds in ~2.5 s at this size (order 3 ~37 s); at the cell's
#: size on the card the fault is the configuration's own order 5
TABLE_ORDER = 1


def test_configuration_is_the_cli_run_it_names():
    ap = sim.build_parser()
    p = sim.params_from_args(ap, ap.parse_args(README_4A + ORDER0))
    want = dataclasses.asdict(p)
    want["b0_gradient"] = list(want["b0_gradient"])
    assert CFG["keys"] == want
    assert CFG["keys"]["far_table_order"] == 0
    assert CFG["scene_seed"] == 0 and CFG["reduced"] == ["totaltime"]
    # the scale-up's every other key
    assert CFG["keys"] == catalog.load_config("scaleup")["keys"] | {
        "far_table_order": 0}


@pytest.mark.parametrize("path", [Path(exact_ref.__file__),
                                  Path(exact_driver.__file__)],
                         ids=["reference", "driver"])
def test_no_jax_and_a_reference_free_of_the_port(path):
    """The reference imports nothing but torch and its own package; the
    cells' run (``drivers/exact.py``) imports no JAX."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax",
                               "mri_nanoparticle_simulation_tpu"), n
            if path.name == "exact.py" and path.parent.name == "reference":
                assert top in ("__future__", "torch"), n


def _small():
    return Params(chunk_steps=1000, near_k=10, num_water=64,
                  totaltime=0.004, sprint_steps=1000, taucp=0.002,
                  cube_candidates=32, cube_hash_dim=8,
                  far_table_order=0).validate()


def _far_sums_f64(anchor, tbl, idx):
    """The far sums in float64 of the float32 table: the closed forms
    over every entry, the ``idx`` [K, W] left out."""
    a, t = anchor.double(), tbl.double()
    parts = torch.stack(bz_taylor_parts(a[0][None] - t[0][:, None],
                                        a[1][None] - t[1][:, None],
                                        a[2][None] - t[2][:, None],
                                        t[3][:, None]))     # [10, N, W]
    col = torch.arange(tbl.shape[1])[:, None]
    keep = (idx[:, None, :] != col).all(0)
    return (parts * keep).sum(1)


@pytest.mark.parametrize("gen", ["fast", "threefry"])
def test_exact_reference_matches_the_port_twins(gen, monkeypatch):
    import port_bench.reference as ref_pkg
    monkeypatch.setattr(ref_pkg, "REBUILD_MAX", 0)
    p = _small()
    sc = BacteriaBox(p, seed=42).populate()
    tbl = convert.mnp_table(sc.mnps, torch.float32, "cpu")
    cache = expansion.build_cache(tbl.pos, tbl.m, p)
    assert cache.far_coeffs is None
    reach2 = expansion.coverage_reach2(p)
    phys = cuda_engine.chunk_physics(
        p, "hardware" if gen == "fast" else "threefry")
    args = dict(key=convert.key_words(REF_SEED), lane_offset=0,
                num_water=64, tcp=p.tcp,
                cell_r2=cuda_engine.cell_r2_f32(p.cell_r), dstd=1.0,
                phys=phys)
    ref = exact_ref.ExactReference(dataclasses.asdict(p), gen,
                                   {"waters": sc.waters, "mnps": sc.mnps},
                                   REF_SEED, "cpu")
    assert torch.equal(cache.cand_table, ref.cand)
    assert torch.equal(cache.payload[..., 4].long(), ref.ids)
    planes = cuda_engine.to_soa(init_state(sc.waters, p, "cpu"), p).planes
    ins, outs = [], []
    for c in range(3):
        ins.append(planes)
        wp = torch.cat([cuda_engine._wrap(planes[:3], p.bound), planes[3:]])
        nf = expansion.build(wp[:3].T, tbl.pos, tbl.m, p, cache=cache,
                             reach2=reach2, tbl=tbl.tbl)
        near, taylor, n_reach = exact_driver.near_layout(nf)
        o = cuda_engine.chunk_near_reference(wp, near, taylor,
                                             step0=1000 * c, **args)
        outs.append((o, near, taylor, n_reach, wp))
        planes = o[0]
    got = ref.chunks(ins, [0, 1000, 2000])
    for (o, near, taylor, n_reach, wp), r in zip(outs, got):
        assert torch.equal(near, r.near)            # selection and slots
        assert torch.equal(n_reach.double(), r.n_reach.double())
        rows, _ = expansion.cube_select(wp[:3].T, cache.payload, p)
        ids = rows[..., 4].long().T
        want = _far_sums_f64(wp[:3], tbl.tbl, ids)
        scale = want.abs().amax(1, keepdim=True)
        # float32 sums of ~700 terms with cancellation, in table order:
        # within 1e-5 of each row's largest value of the float64 sum (the
        # far-sums kernel's own tolerance against its twin); the plain
        # twin and the reference add alike, bit for bit
        assert ((r.taylor.double() - want).abs() / scale).max() < 1e-5
        assert torch.equal(taylor, r.taylor)
        for a, b in zip(o[:4], (r.out, r.esc, r.cov, r.wins)):
            assert torch.equal(a, b)


# -- the correctness check of the exact-far-field cells ---------------------

def _context(monkeypatch, cell_keys=None):
    """The cell at the tiny size of ``port_bench.tests.tiny``, on the
    large path."""
    cell = copy.deepcopy(catalog.load_cell("scaleup-order0"))
    cfg = copy.deepcopy(CFG)
    cfg["keys"].update(tiny.SMALL)
    cfg["keys"].update(tiny.SMALL_SCALEUP, far_table_order=0)
    tiny.force_large(monkeypatch)
    cell["slice_sprints"] = 1
    cell["keys"] = dict(cell_keys or {})
    return run.context("scaleup-order0", SEED, "cpu", cell, cfg)


def plant(monkeypatch, fault: str, ctx):
    """Plant ``fault`` in the program for the run of ``ctx``:
    ``near_in`` far sums that leave the K near dipoles in (each id
    pointed at a zero-moment entry appended to the table), ``no_images``
    far sums over the base dipoles without their periodic images (the
    images' moments zeroed), ``table`` the configuration's far table at
    ``ctx.cell["keys"]["far_table_order"]`` in place of the exact sums
    (set by the context)."""
    orig = chunk_kernel.run_far_sums
    n_base = ctx.config["keys"]["num_cells"]

    def near_in(anchor, tbl, idx):
        pad = torch.zeros((4, 16), dtype=tbl.dtype, device=tbl.device)
        pad[:3] = 1e6
        ids = torch.arange(tbl.shape[1], tbl.shape[1] + idx.shape[0],
                           dtype=idx.dtype, device=idx.device)
        return orig(anchor, torch.cat([tbl, pad], 1),
                    ids[:, None].expand_as(idx).contiguous())

    def no_images(anchor, tbl, idx):
        t = tbl.clone()
        t[3, n_base:] = 0.0
        return orig(anchor, t, idx)

    if fault == "table":
        assert ctx.cell["keys"].get("far_table_order", 0) > 0
        return
    monkeypatch.setattr(chunk_kernel, "run_far_sums",
                        {"near_in": near_in, "no_images": no_images}[fault])


def test_sound_run_is_correct_and_the_control_is_not(monkeypatch):
    res = run.run_cell(_context(monkeypatch), 0.5, False,
                       time.perf_counter(), control_dtype=torch.bfloat16)
    assert res["correct"], res["checks"]
    assert res["checks"]["model_gap"]["value"] == 0.0
    assert res["notes"]["chunks_checked"] >= 2
    assert res["metrics"]["walker_steps_per_s"]["value"] > 0
    limits = res["checks"]
    ctl = res["notes"]["control"]
    assert [k for k in ctl if ctl[k] > limits[k]["limit"]], ctl


@pytest.mark.parametrize("fault", ["table", "near_in", "no_images"])
def test_a_broken_program_is_not_correct(fault, monkeypatch):
    ctx = _context(monkeypatch, {"far_table_order": TABLE_ORDER}
                   if fault == "table" else None)
    plant(monkeypatch, fault, ctx)
    res = run.run_cell(ctx, 0.5, False, time.perf_counter())
    failed = [k for k, c in res["checks"].items()
              if c["value"] > c["limit"]]
    assert not res["correct"] and "model_gap" in failed, res["checks"]


# -- spans and metrics -----------------------------------------------------

def _sprints(n):
    """``n`` sprints of the small scene's order-0 large path."""
    p = _small()
    sc = BacteriaBox(p, seed=42).populate()
    tbl = convert.mnp_table(sc.mnps, torch.float32, "cpu")
    cache = expansion.build_cache(tbl.pos, tbl.m, p)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_engine, "REBUILD_MAX_MNPS", 0)
        sprint = cuda_engine.make_sprint_fn(p, p.num_water, "cpu")
        s = cuda_engine.to_soa(init_state(sc.waters, p, "cpu"), p)
        for _ in range(n):
            s, _ = sprint(tbl, (0, 1), s, cache=cache)
    return n * p.sprint_steps // p.chunk_steps


def test_new_spans_are_the_shared_no_op_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    off = profiling.span("any")
    for name in (expansion.SELECT_SPAN, chunk_kernel.FAR_SUMS_SPAN):
        assert profiling.span(name, device="cpu") is off
    profiling.reset_spans()
    assert _sprints(1) > 0
    assert profiling.span_summary() == {}


@pytest.fixture(scope="module")
def traced_sprints():
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with record_function(WINDOW):
            chunks = _sprints(2)
    spans = profiling.span_summary()
    profiling.reset_spans()
    return spans, chunks


@pytest.mark.parametrize("name", ["expansion.select",
                                  "chunk_kernel.far_sums",
                                  "sprint_loop.model"])
def test_spans_count_one_call_a_chunk(traced_sprints, name):
    spans, chunks = traced_sprints
    assert spans[name]["calls"] == chunks
    assert spans[name]["host_s"] > 0
    assert spans[name]["device_s"] is None                 # no card
    assert "chunk_kernel.run_cand_model" not in spans


def _metric_ctx(trace=True):
    cfg = copy.deepcopy(CFG)
    return SimpleNamespace(trace=object() if trace else None,
                           window={"traced": {"chunks": 4}},
                           config=cfg, cell={}, n_mnp=5250)


@pytest.mark.parametrize("name,span,want", [
    ("model.select_ms_per_chunk", "expansion.select", 0.9),
    ("far_sums.ms_per_chunk", "chunk_kernel.far_sums", 0.9),
    ("far_sums.roofline_pct", "chunk_kernel.far_sums", None)])
def test_new_metrics_read_their_spans(name, span, want, traced_sprints,
                                      monkeypatch):
    spans, _ = traced_sprints
    spans = {**spans, span: {**spans[span], "calls": 4,
                             "device_s": 4 * 0.9e-3}}
    monkeypatch.setattr(profiling, "span_summary", lambda: spans)
    mod = catalog.metrics()[name]
    value = mod.read(_metric_ctx())
    assert value is not None and math.isfinite(value)
    if want is not None:
        assert value == pytest.approx(want)
    else:
        # 100000 walkers x 5256 entries x 65 operations at 67 TFLOP/s
        bound_ms = 1e3 * (65 * 100000 * 5256 / (2 * 128 * 132 * 1.98e9)
                          + 10 * 100000 / (128 * 132 * 1.98e9))
        assert value == pytest.approx(100 * bound_ms / 0.9, rel=1e-9)
        assert 0 < value < 100
    assert mod.read(_metric_ctx(trace=False)) is None
    # a run whose card timed nothing, a program without the span (the
    # parent's), and one without ``span_summary`` read nothing
    monkeypatch.setattr(profiling, "span_summary", lambda: {
        **spans, span: {**spans[span], "device_s": None}})
    assert mod.read(_metric_ctx()) is None
    monkeypatch.setattr(profiling, "span_summary", lambda: {
        k: v for k, v in spans.items() if k != span})
    assert mod.read(_metric_ctx()) is None
    monkeypatch.delattr(profiling, "span_summary")
    assert mod.read(_metric_ctx()) is None


def test_new_metrics_are_declared_for_the_new_cell_only():
    bench = json.loads((Path(catalog.ROOT).parent
                        / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in ("model.select_ms_per_chunk", "far_sums.ms_per_chunk",
                 "far_sums.roofline_pct"):
        assert per_layer[name]["workloads"] == ["scaleup-order0"]
        assert per_layer[name]["layer"] == catalog.metrics()[name].LAYER
    cell = {w["name"]: w for w in bench["workloads"]}["scaleup-order0"]
    assert cell["config"] == "scaleup-exact" and cell["chips"] == 1
    assert catalog.load_cell("scaleup-order0")["slice_sprints"] == 20

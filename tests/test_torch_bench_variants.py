"""The benchmark's ``variants`` configuration and its cell
``variants-fast``, and the record cell ``headline-record``, on the CPU:

* the variant reference (``port_bench/reference/variants.py``) is bit
  for bit the port's plain twins at 64 walkers and K 10, on both
  generators, plain and decompose, at the configuration's reflect
  probabilities and at 0.5 (where a crossing goes through half the
  time), and the configuration's pair is ``Params().with_permeability()``;
* both cells read ``correct`` on a sound run at a size a test holds, and
  not under the bfloat16 control, nor with the program's reflection
  off, its kick as written, or a reconstruction that drops the flip
  parity;
* ``decompose.record_products``, the CLI's record tail, writes the bytes
  the CLI's own loop wrote;
* the new spans (``chunk_kernel.variants``, ``record.*``) are the shared
  no-op with no profiler, and under one count a launch, a sprint, a
  reconstruction and a write; their metrics read them.
"""

import dataclasses
import math
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mri_nanoparticle_simulation_tpu_torch import analysis
from mri_nanoparticle_simulation_tpu_torch.engine import (chunk_kernel,
                                                          convert,
                                                          cuda_engine,
                                                          decompose, sim)
from mri_nanoparticle_simulation_tpu_torch.engine.reference_engine import \
    init_state
from mri_nanoparticle_simulation_tpu_torch.io import writer as writer_mod
from mri_nanoparticle_simulation_tpu_torch.params import Params
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox
from mri_nanoparticle_simulation_tpu_torch.utils import profiling
from port_bench import catalog, run
from port_bench.reference import record as record_ref
from port_bench.reference.variants import VariantReference
from port_bench.tests import tiny
from port_bench.trace import WINDOW, summarize

torch.set_num_threads(1)

SEED = 3_000_000_123
REF_SEED = 2**40 + 777
CFG = catalog.load_config("variants")


def _params(reflect):
    kv = {k: tuple(v) if isinstance(v, list) else v
          for k, v in CFG["keys"].items()}
    p = Params(**kv).replace(num_water=64, chunk_steps=1000,
                             sprint_steps=1000, totaltime=0.004, taucp=0.002)
    if reflect == "half":
        p = p.replace(reflect_io=0.5, reflect_oi=0.5)
    return p.validate()


def test_configuration_is_the_cli_run_it_names():
    """The keys are what the CLI builds for ``--kick-mode intended
    --permeable``; the reflect pair is ``with_permeability``'s."""
    ap = sim.build_parser()
    p = sim.params_from_args(ap, ap.parse_args(
        ["--kick-mode", "intended", "--permeable"]))
    want = dataclasses.asdict(p)
    want["b0_gradient"] = list(want["b0_gradient"])
    assert CFG["keys"] == want
    rio, roi = Params().with_permeability().reflect_pair()
    assert (CFG["keys"]["reflect_io"], CFG["keys"]["reflect_oi"]) == (
        rio, roi)
    assert CFG["scene_seed"] == 0 and CFG["reduced"] == []
    assert not any(CFG["keys"]["b0_gradient"])


def _on_membranes(planes, mnps, cell_r):
    """The 64 walkers put 5 nm inside and outside the membranes of cells
    that lie well inside the box, so that most steps try a crossing."""
    inner = mnps[np.all((mnps[:, :3] > 2) & (mnps[:, :3] < 28), 1)]
    planes = planes.clone()
    for i in range(64):
        pos = inner[i % len(inner), :3].copy()
        pos[0] += cell_r + (0.005 if i % 2 else -0.005)
        planes[:3, i] = torch.as_tensor(pos, dtype=torch.float32)
    return planes


def _turned_back(p, gen, scene, planes, want):
    """Walkers of a chunk whose walk changes when the membranes let
    every crossing through (the same words drawn)."""
    free = VariantReference(
        dataclasses.asdict(p.replace(reflect_io=1e-30, reflect_oi=1e-30)),
        gen, scene, REF_SEED, "cpu")
    got = free.chunks([planes], [0])[0].out
    return int((got[:3] != want[:3]).any(0).sum())


@pytest.mark.parametrize("reflect", ["own", "half"])
@pytest.mark.parametrize("decompose_", [False, True], ids=["plain", "dec"])
@pytest.mark.parametrize("gen", ["fast", "threefry"])
def test_variant_reference_matches_the_port_twins(gen, decompose_, reflect):
    """Three 1000-step chunks of the port's plain twin, one after the
    other, against the reference's, side by side: state, escapes,
    coverage and windows bitwise."""
    p = _params(reflect)
    sc = BacteriaBox(p, seed=CFG["scene_seed"]).populate()
    phys = cuda_engine.chunk_physics(
        p, "hardware" if gen == "fast" else "threefry")
    assert phys.reflect and phys.intended
    tbl = convert.mnp_table(sc.mnps, torch.float32, "cpu")
    planes = _on_membranes(
        cuda_engine.to_soa(init_state(sc.waters, p, "cpu",
                                      decompose=decompose_), p).planes,
        sc.mnps, p.cell_r)
    args = dict(key=convert.key_words(REF_SEED), lane_offset=0,
                num_water=64, tcp=p.tcp,
                cell_r2=cuda_engine.cell_r2_f32(p.cell_r), dstd=1.0,
                phys=phys, decompose=decompose_)
    scene = {"waters": sc.waters, "mnps": sc.mnps}
    ref = VariantReference(dataclasses.asdict(p), gen, scene, REF_SEED,
                           "cpu")
    ins, outs = [], []
    for c in range(3):
        ins.append(planes)
        o = cuda_engine.chunk_reference(planes, tbl.tbl, step0=1000 * c,
                                        **args)
        outs.append(o)
        planes = o[0]
    got = ref.chunks(ins, [0, 1000, 2000], decompose=decompose_)
    for o, r in zip(outs, got):
        assert torch.equal(o[0], r.out)
        assert torch.equal(o[1], r.esc)
        assert torch.equal(o[2], r.cov)
        assert torch.equal(o[3], r.wins)
    if not decompose_:
        # the membranes turned walkers back
        assert _turned_back(p, gen, scene, ins[0], got[0].out) >= 16


def _run(ctx, control=None):
    return run.run_cell(ctx, 0.5, False, time.perf_counter(),
                        control_dtype=control)


def _context(cell, monkeypatch):
    ctx = tiny.context(cell, SEED, monkeypatch)
    if cell == "variants-fast":
        # cells of radius 1.5 um (14% of the box) and 256 walkers thrown
        # into them too: the tiny walk meets membranes, and its in-cell
        # steps are enough for the largest of the intended kicks' sqrt
        # tails to show above the phase limit
        ctx.config["keys"].update(cell_r=1.5, num_water=256,
                                  avoid_intracellular_throw=False)
    if cell == "headline-record":
        # echo spacings whose flips fall inside the tiny run's 4 windows
        ctx.cell["echo_taucps"] = [0.001, 0.002]
    return ctx


@pytest.mark.parametrize("cell", ["variants-fast", "headline-record"])
def test_sound_run_is_correct_and_the_control_is_not(cell, monkeypatch):
    res = _run(_context(cell, monkeypatch), torch.bfloat16)
    assert res["correct"], res["checks"]
    assert res["metrics"]["walker_steps_per_s"]["value"] > 0
    limits = res["checks"]
    ctl = res["notes"]["control"]
    assert [k for k in ctl if ctl[k] > limits[k]["limit"]], ctl


def _no_reflection(phys):
    return phys._replace(reflect=False)


def _as_written(phys):
    return phys._replace(intended=False, kick_sd=0.0)


def _physics_fault(monkeypatch, change):
    orig = chunk_kernel.run_chunk

    def call(state, *a, **kw):
        return orig(state, *a, **{**kw, "phys": change(kw["phys"])})
    monkeypatch.setattr(chunk_kernel, "run_chunk", call)


def _parity_fault(monkeypatch):
    monkeypatch.setattr(decompose, "_flip_parity",
                        lambda n, tcp, pfreq: np.ones(n))


@pytest.mark.parametrize("cell,fault", [
    ("variants-fast", "no_reflection"), ("variants-fast", "as_written"),
    ("headline-record", "no_parity")])
def test_a_broken_program_is_not_correct(cell, fault, monkeypatch):
    ctx = _context(cell, monkeypatch)
    if fault == "no_parity":
        _parity_fault(monkeypatch)
    else:
        _physics_fault(monkeypatch, {"no_reflection": _no_reflection,
                                     "as_written": _as_written}[fault])
    res = _run(ctx)
    failed = [k for k, c in res["checks"].items()
              if c["value"] > c["limit"]]
    assert not res["correct"] and failed, res["checks"]


def _old_cli_tail(res, params, scales, taucps, csv_path, fit_r2,
                  quadrature):
    """The CLI's record tail as it was written out in ``sim.py`` before
    ``decompose.record_products``: the curves, a CSV a point, the
    dispersion table."""
    curves = decompose.curves_at_plane(res.A, res.B, scales, taucps, params,
                                       quadrature=True)
    stem, ext = os.path.splitext(csv_path)
    for si, s in enumerate(scales):
        for ti, t_cp in enumerate(taucps):
            pv = params.replace(mmoment=params.mmoment * s,
                                taucp=t_cp).validate()
            path = f"{stem}_mscale={s:g}_taucp={t_cp:g}" + (ext or ".csv")
            with writer_mod.T2CsvWriter(path, pv,
                                        quadrature=quadrature) as w:
                w.append_windows(0, curves[si, ti] * params.num_water)
    with open(fit_r2, "w") as f:
        f.write("mscale,taucp_ms,r2_per_ms,t2_ms,r_squared,n_echoes,"
                "t2_stderr_ms\n")
        for si, s in enumerate(scales):
            for ti, t_cp in enumerate(taucps):
                curve = curves[si, ti, :, 0] * params.num_water
                try:
                    te, me = analysis.sample_at_echoes(res.times_ms, curve,
                                                       t_cp)
                    fit = analysis.fit_t2(te, me)
                    f.write(f"{s:g},{t_cp:g},{1.0 / fit.t2_ms},"
                            f"{fit.t2_ms},{fit.r_squared},{fit.n_used},"
                            f"{fit.t2_stderr_ms}\n")
                except ValueError:
                    f.write(f"{s:g},{t_cp:g},nan,nan,nan,0,nan\n")


def _files(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("quadrature", [False, True], ids=["cos", "quad"])
def test_cli_record_tail_writes_what_it_wrote(tmp_path, quadrature):
    """README 5c's CLI at a tiny size: its CSVs and dispersion table are
    byte for byte the written-out tail's from its own dumped record."""
    new, old = tmp_path / "new", tmp_path / "old"
    new.mkdir()
    old.mkdir()
    argv = ["--num-water", "64", "--totaltime", "0.012", "--chunk-steps",
            "1000", "--sprint-steps", "2000", "--taucp", "0.002",
            "--near-k", "10", "--moment-scales", "0.5,1,2",
            "--echo-taucps", "0.001,0.002", "--device", "cpu",
            "--dump-record", str(tmp_path / "rec.npz"),
            "--fit-r2", str(new / "r2.csv"), "--out", str(new / "p.csv")]
    if quadrature:
        argv.append("--quadrature")
    assert sim.main(argv) == 0
    rec = np.load(tmp_path / "rec.npz")
    ap = sim.build_parser()
    p = sim.params_from_args(ap, ap.parse_args(argv))
    res = decompose.DecompositionResult(rec["times_ms"], rec["A"], rec["B"],
                                        {})
    _old_cli_tail(res, p, [0.5, 1.0, 2.0], [0.001, 0.002],
                  str(old / "p.csv"), str(old / "r2.csv"), quadrature)
    got, want = _files(new), _files(old)
    assert len(want) == 7 and got == want
    r2 = (new / "r2.csv").read_text().splitlines()
    assert any("nan" not in line for line in r2[1:])


def test_record_products_returns_the_reference_curves(tmp_path):
    """The curves ``record_products`` returns agree with the plain
    reconstruction of the benchmark to float64 rounding."""
    p = Params(num_water=64, totaltime=0.008, sprint_steps=2000,
               chunk_steps=1000, taucp=0.002, near_k=10)
    g = np.random.default_rng(5)
    n = p.t // p.pfreq
    res = decompose.DecompositionResult(
        (np.arange(1, n + 1) * p.pfreq) * p.tau,
        g.normal(size=(n, 64)).astype(np.float32),
        g.normal(size=(n, 64)).astype(np.float32), {})
    curves = decompose.record_products(res, p, [0.5, 2.0], [0.001, 0.004],
                                       str(tmp_path / "c.csv"))
    want = record_ref.curves(res.A, res.B, [0.5, 2.0], [0.001, 0.004],
                             tau=p.tau, pfreq=p.pfreq, tcp=p.tcp)
    assert np.abs(curves - want).max() < 1e-12
    assert len(os.listdir(tmp_path)) == 4


# -- spans -------------------------------------------------------------

class _FakeLib:
    def __getattr__(self, name):
        return lambda *a: 0


@pytest.fixture
def fake_card(monkeypatch):
    """``_run_chunk_kernel`` on CPU tensors, its library and layout
    faked: it goes through its launch path and launches nothing."""
    lay = SimpleNamespace(kind="flat", waves=1, blocks=1, blocks_per_sm=1)
    monkeypatch.setattr(chunk_kernel, "_cuda_only", lambda *a: None)
    monkeypatch.setattr(chunk_kernel, "load_library", _FakeLib)
    monkeypatch.setattr(chunk_kernel, "launch_layout",
                        lambda *a, **k: lay)
    monkeypatch.setattr(chunk_kernel, "_stream", lambda t: (0, 0))
    monkeypatch.setattr(chunk_kernel, "LAUNCHES",
                        dict(chunk_kernel.LAUNCHES))
    monkeypatch.setattr(chunk_kernel, "LAYOUTS", {})
    p = _params("own")
    state = torch.zeros((6, 128))
    args = dict(step0=0, key=(0, 1), lane_offset=0, num_water=64,
                tcp=p.tcp, cell_r2=0.3, dstd=1.0)

    def launch(variants):
        phys = cuda_engine.chunk_physics(
            p if variants else p.replace(kick_mode="as_written",
                                         reflect_io=0.0, reflect_oi=0.0),
            "hardware")
        assert phys.variants is variants
        chunk_kernel._run_chunk_kernel(
            "chunk_kernel", state, [torch.zeros((4, 8))],
            dict(args, phys=phys), False, 8)
    return launch


def _profiled(fn):
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with record_function(WINDOW):
            fn()
    spans = profiling.span_summary()
    profiling.reset_spans()
    return spans


def test_new_spans_are_the_shared_no_op_without_a_profiler(fake_card,
                                                           tmp_path):
    assert not torch.autograd.profiler._is_profiler_enabled
    off = profiling.span("any")
    for name in (chunk_kernel.VARIANTS_SPAN, "record.commit",
                 "record.reconstruct", "record.write"):
        assert profiling.span(name, device="cpu") is off
    profiling.reset_spans()
    fake_card(True)
    fake_card(False)
    p = Params(num_water=32, totaltime=0.004, sprint_steps=2000,
               chunk_steps=1000, taucp=0.002, near_k=10)
    sc = BacteriaBox(p, seed=3).populate()
    res = decompose.run_decomposition(sc, p, seed=1, device="cpu")
    decompose.record_products(res, p, [1.0], [0.002],
                              str(tmp_path / "c.csv"))
    assert profiling.span_summary() == {}


def test_variant_span_counts_variant_launches_only(fake_card):
    spans = _profiled(lambda: [fake_card(v) for v in
                               (True, False, True, True, False)])
    assert set(spans) == {chunk_kernel.VARIANTS_SPAN}
    assert spans[chunk_kernel.VARIANTS_SPAN]["calls"] == 3
    assert spans[chunk_kernel.VARIANTS_SPAN]["device_s"] is None   # no card


@pytest.fixture(scope="module")
def record_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("record")
    p = Params(num_water=32, totaltime=0.002, sprint_steps=1000,
               chunk_steps=1000, taucp=0.002, near_k=10)
    sc = BacteriaBox(p, seed=3).populate()

    def call():
        res = decompose.run_decomposition(sc, p, seed=1, device="cpu")
        decompose.record_products(res, p, [1.0, 2.0], [0.001, 0.002],
                                  str(d / "c.csv"), fit_r2=str(d / "r2"))
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            call()
    prof.export_chrome_trace(str(d / "t.json"))
    spans = profiling.span_summary()
    profiling.reset_spans()
    return spans, summarize(str(d / "t.json")), p.t // p.sprint_steps


def test_record_span_counts(record_run):
    spans, _, sprints = record_run
    assert spans["record.commit"]["calls"] == sprints
    assert spans["record.reconstruct"]["calls"] == 1
    assert spans["record.write"]["calls"] == 1
    for name in ("record.commit", "record.reconstruct", "record.write"):
        assert 0.0 < spans[name]["host_s"]
        assert spans[name]["device_s"] is None


@pytest.mark.parametrize("name", ["record.host_pct",
                                  "chunk_kernel.variants_ms_per_chunk"])
def test_new_metrics_read_their_spans(name, record_run, monkeypatch):
    spans, summary, _ = record_run
    if name == "chunk_kernel.variants_ms_per_chunk":
        spans = {**spans, chunk_kernel.VARIANTS_SPAN: {
            "calls": 4, "host_s": 1e-4, "self_s": 1e-4, "device_s": 0.004}}
    monkeypatch.setattr(profiling, "span_summary", lambda: spans)
    mod = catalog.metrics()[name]
    ctx = SimpleNamespace(trace=summary, window={"traced": {}})
    value = mod.read(ctx)
    assert value is not None and math.isfinite(value) and value > 0
    if mod.UNIT == "%":
        assert value < 100
    else:
        assert value == pytest.approx(1.0)
    assert mod.read(SimpleNamespace(trace=None, window={})) is None
    monkeypatch.delattr(profiling, "span_summary")
    assert mod.read(ctx) is None

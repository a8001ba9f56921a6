"""The port's scan engine against the JAX package's, on the CPU.

``reference_engine.make_sprint_fn`` and ``run_simulation`` of both
packages on the same scene, key and state, with the tolerances of
tests/test_pallas.py:34-36 (positions within 5e-6, window sums within
1e-3; escapes, coverage and residency equal):

* both orders (window-major: chunk_steps < pfreq; chunk-major), the
  decompose record, a float64 phase;
* each field mode: the expansion (bf16 selection on both sides: the
  near sets agree up to tie swaps, which these scenes do not meet), the
  exact masked sum (no selection at all: the sharp check, its record
  within 2e-6) and the grid; the large path (the cube cache, forced);
* every physics variant and kick mode, each launch-scalar override and
  the reference's ``guarded`` raises;
* the runner, the CLI (``--engine --field-mode --grid-n``), the
  decomposition and the ensembles with ``engine="scan"``, and a scan
  checkpoint crossing the packages both ways.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu import params as P
from mri_nanoparticle_simulation_tpu import rng as jrng
from mri_nanoparticle_simulation_tpu.engine import decompose as jdec
from mri_nanoparticle_simulation_tpu.engine import reference_engine as jre
from mri_nanoparticle_simulation_tpu.engine import sim as jsim
from mri_nanoparticle_simulation_tpu.fields import expansion as jexp
from mri_nanoparticle_simulation_tpu.fields import grid as jgrid
from mri_nanoparticle_simulation_tpu.io import checkpoint as jck
from mri_nanoparticle_simulation_tpu.parallel import ensemble as jens
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
from mri_nanoparticle_simulation_tpu_torch.engine import convert
from mri_nanoparticle_simulation_tpu_torch.engine import decompose as tdec
from mri_nanoparticle_simulation_tpu_torch.engine import \
    reference_engine as tre
from mri_nanoparticle_simulation_tpu_torch.engine import sim
from mri_nanoparticle_simulation_tpu_torch.fields import expansion as texp
from mri_nanoparticle_simulation_tpu_torch.fields import grid as tgrid
from mri_nanoparticle_simulation_tpu_torch.io import writer
from mri_nanoparticle_simulation_tpu_torch.parallel import ensemble as tens
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox as TBox

torch.set_num_threads(1)

POS_TOL = 5e-6
WIN_TOL = 1e-3
#: 64 walkers, 800 steps in two sprints, 100-step windows, flips every
#: 500 steps; a moment 100x the default so the field shapes the phase
BASE = dict(mmoment=3.5e-15, chunk_steps=200, totaltime=0.0008,
            sprint_steps=400)


def _tp(p):
    """The port's Params of the JAX Params ``p``."""
    return convert.params_from_fields(dataclasses.asdict(p))


def _run_both(p, seed=3, key_seed=1, decompose=False, f64=False,
              overrides=None):
    """Both sprints over every sprint of ``p`` from the same start:
    ((JAX state, JAX windows), (port state, port windows)) as NumPy."""
    overrides = overrides or {}
    sc = BacteriaBox(p, seed=seed).populate()
    mp = jnp.asarray(sc.mnps[:, :3], jnp.float32)
    mM = jnp.asarray(sc.mnps[:, 4], jnp.float32)
    jfg = tfg = None
    tp = _tp(p)
    tmp = torch.as_tensor(sc.mnps[:, :3]).float()
    tmM = torch.as_tensor(sc.mnps[:, 4]).float()
    if p.field_mode == P.FIELD_GRID:
        jfg = jgrid.build_grid(mp, mM, p, grid_n=p.grid_n,
                               max_residents=p.grid_max_residents)
        tfg = tgrid.build_grid(tmp, tmM, tp, grid_n=p.grid_n,
                               max_residents=p.grid_max_residents)
    jpd, tpd = (jnp.float64, torch.float64) if f64 else (None, None)
    jsp = jre.make_sprint_fn(p, field_grid=jfg, phase_dtype=jpd,
                             decompose=decompose)
    tsp = tre.make_sprint_fn(tp, "cpu", field_grid=tfg, phase_dtype=tpd,
                             decompose=decompose)
    k = jrng.key_from_seed(key_seed)
    karr = jnp.asarray([np.uint32(k[0]), np.uint32(k[1])])
    jst = jre.init_state(sc.waters, p, phase_dtype=jpd, decompose=decompose)
    tst = tre.init_state(sc.waters, tp, "cpu", phase_dtype=tpd,
                         decompose=decompose)
    jw, tw = [], []
    for _ in range(p.t // p.sprint_steps):
        jst, w = jsp(mp, mM, karr, jst, 0, **overrides)
        jw.append(np.asarray(w))
        tst, w = tsp(tmp, tmM, k, tst, 0, **overrides)
        tw.append(w.numpy())
    return (jst, np.concatenate(jw)), (tst, np.concatenate(tw))


def _assert_close(j, t, win_tol=WIN_TOL, pos_tol=POS_TOL):
    (jst, jw), (tst, tw) = j, t
    assert tw.shape == jw.shape
    np.testing.assert_allclose(tst.pos.numpy(), np.asarray(jst.pos),
                               atol=pos_tol)
    np.testing.assert_allclose(tw, jw, atol=win_tol)
    np.testing.assert_array_equal(tst.in_cell.numpy(),
                                  np.asarray(jst.in_cell))
    assert tst.step == int(jst.step)
    assert int(tst.escapes) == int(jst.escapes)
    assert int(tst.coverage) == int(jst.coverage)
    assert tst.phase.dtype == {np.dtype(np.float32): torch.float32,
                               np.dtype(np.float64): torch.float64}[
        np.asarray(jst.phase).dtype]
    np.testing.assert_allclose(tst.phase.numpy(), np.asarray(jst.phase),
                               atol=pos_tol)


#: name -> JAX Params; every order, field mode and physics variant
CASES = {
    "chunk_major": lambda: P.small_test_params(**BASE),
    "window_major": lambda: P.small_test_params(**{**BASE,
                                                   "chunk_steps": 50}),
    "chunk_equals_pfreq": lambda: P.small_test_params(**{**BASE,
                                                         "chunk_steps": 100}),
    "exact": lambda: P.small_test_params(**BASE, field_mode="exact"),
    "exact_window_major": lambda: P.small_test_params(
        **{**BASE, "chunk_steps": 50}, field_mode="exact"),
    "grid": lambda: P.small_test_params(**BASE, field_mode="grid",
                                        grid_n=16),
    "intended_kick": lambda: P.small_test_params(**BASE,
                                                 kick_mode="intended"),
    "constant_kick": lambda: P.small_test_params(**BASE,
                                                 kick_mode="constant"),
    "no_kick": lambda: P.small_test_params(**BASE, kick_mode="none"),
    "sphere_directions": lambda: P.small_test_params(
        **BASE, direction_mode="sphere"),
    "permeable": lambda: P.small_test_params(**BASE).with_permeability(),
    "gradient": lambda: P.small_test_params(**BASE,
                                            b0_gradient=(1e-5, 0.0, 2e-5)),
    "every_variant": lambda: P.small_test_params(
        **BASE, kick_mode="intended", direction_mode="sphere",
        b0_gradient=(0.0, -1e-5, 2e-5)).with_permeability(),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sprint_matches_jax(name):
    _assert_close(*_run_both(CASES[name]()))


def test_exact_mode_is_sharp():
    """No selection in exact mode: the per-walker record agrees to the
    f32 rounding of the sums, far inside the expansion's tolerance."""
    (jst, jw), (tst, tw) = _run_both(
        P.small_test_params(**BASE, field_mode="exact"), decompose=True)
    np.testing.assert_allclose(tw, jw, atol=2e-6)
    np.testing.assert_allclose(tst.pos.numpy(), np.asarray(jst.pos),
                               atol=2e-6)


@pytest.mark.parametrize("order", ["chunk_major", "window_major"])
def test_decompose_record_matches_jax(order):
    p = CASES[order]()
    j, t = _run_both(p, decompose=True)
    assert t[1].shape == (p.t // p.pfreq, p.num_water, 2)
    _assert_close(j, t, win_tol=POS_TOL)


def test_float64_phase_matches_jax(f64):
    p = P.small_test_params(**BASE)
    j, t = _run_both(p, f64=True)
    assert np.asarray(j[0].phase).dtype == np.float64
    _assert_close(j, t)


def test_large_path_matches_jax(monkeypatch):
    """The cube-candidate cache built in each sprint (without far table)
    and the far sums in blocks, as above 2^24 walker-dipole pairs."""
    monkeypatch.setattr(jexp, "uses_large_path", lambda w, n: True)
    monkeypatch.setattr(texp, "uses_large_path", lambda w, n: True)
    _assert_close(*_run_both(P.small_test_params(**BASE)))


OVERRIDES = {
    "tcp": dict(tcp=300),
    "cell_r": dict(cell_r=0.6),
    "d_scale": dict(d_scale=0.5),
    "reflect": dict(reflect=(0.3, 0.05)),
    "all": dict(tcp=200, cell_r=0.5, d_scale=0.7, reflect=(0.9, 0.1)),
}


@pytest.mark.parametrize("name", sorted(OVERRIDES))
def test_launch_scalar_overrides_match_jax(name):
    p = P.small_test_params(**BASE).with_permeability()
    _assert_close(*_run_both(p, overrides=OVERRIDES[name]))


GUARDS = {
    "grid_cell_r": (dict(field_mode="grid", grid_n=8), dict(cell_r=0.5),
                    "cell_r runtime overrides"),
    "reflect_off": ({}, dict(reflect=(0.1, 0.1)),
                    "reflect overrides need reflection"),
    "tcp_zero": ({}, dict(tcp=0), "tcp override must be > 0"),
    "d_scale_negative": ({}, dict(d_scale=-1.0),
                         "d_scale override must be > 0"),
    "reflect_outside": ("permeable", dict(reflect=(1.5, 0.1)),
                        "reflect_io override must be in"),
}


@pytest.mark.parametrize("name", sorted(GUARDS))
def test_guarded_raises_as_jax(name):
    extra, over, msg = GUARDS[name]
    p = P.small_test_params(**BASE)
    p = p.with_permeability() if extra == "permeable" \
        else p.replace(**extra).validate()
    sc = BacteriaBox(p, seed=3).populate()
    mp = jnp.asarray(sc.mnps[:, :3], jnp.float32)
    mM = jnp.asarray(sc.mnps[:, 4], jnp.float32)
    jfg = jgrid.build_grid(mp, mM, p, grid_n=8) \
        if p.field_mode == "grid" else None
    tmp, tmM = torch.as_tensor(sc.mnps[:, :3]).float(), \
        torch.as_tensor(sc.mnps[:, 4]).float()
    tfg = tgrid.build_grid(tmp, tmM, _tp(p), grid_n=8) \
        if p.field_mode == "grid" else None
    k = jrng.key_from_seed(1)
    with pytest.raises(ValueError, match=msg) as je:
        jre.make_sprint_fn(p, field_grid=jfg)(
            mp, mM, jnp.asarray(k, jnp.uint32),
            jre.init_state(sc.waters, p), 0, **over)
    with pytest.raises(ValueError) as te:
        tre.make_sprint_fn(_tp(p), "cpu", field_grid=tfg)(
            tmp, tmM, k, tre.init_state(sc.waters, _tp(p), "cpu"), 0,
            **over)
    assert str(te.value) == str(je.value)


def test_grid_mode_without_grid_and_bad_order_raise():
    p = _tp(P.small_test_params(**BASE, field_mode="grid"))
    with pytest.raises(ValueError, match="requires a prebuilt"):
        tre.make_sprint_fn(p, "cpu")
    with pytest.raises(ValueError, match="divide or be a multiple"):
        tre.make_sprint_fn(dataclasses.replace(
            _tp(P.small_test_params(**BASE)), chunk_steps=150), "cpu")


def test_sprint_refuses_a_state_on_another_device():
    p = _tp(P.small_test_params(**BASE))
    sc = TBox(p, seed=3).populate()
    sprint = tre.make_sprint_fn(p, "cuda")
    with pytest.raises(ValueError, match="state is on cpu"):
        sprint(torch.as_tensor(sc.mnps[:, :3]).float(),
               torch.as_tensor(sc.mnps[:, 4]).float(), (0, 1),
               tre.init_state(sc.waters, p, "cpu"))


@pytest.mark.parametrize("mode", ["expansion", "exact"])
def test_run_simulation_matches_jax(mode):
    p = P.small_test_params(**BASE, field_mode=mode)
    sc = BacteriaBox(p, seed=5).populate()
    jt, jc, js, jst = jre.run_simulation(sc, p, seed=2, max_steps=400)
    tt, tc, ts, tst = tre.run_simulation(TBox(_tp(p), seed=5).populate(),
                                         _tp(p), seed=2, device="cpu",
                                         max_steps=400)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tc, jc, atol=WIN_TOL)
    np.testing.assert_allclose(ts, js, atol=WIN_TOL)
    np.testing.assert_allclose(tst.pos.numpy(), np.asarray(jst.pos),
                               atol=POS_TOL)
    assert tst.step == int(jst.step) == 400


# -- the runner, the CLI, decomposition, ensembles, checkpoints ---------------

RUNNER = dict(totaltime=0.001, sprint_steps=500, mmoment=3.5e-15)


@pytest.mark.parametrize("mode", ["expansion", "grid"])
def test_runner_matches_jax_runner(mode, tmp_path):
    p = P.small_test_params(**RUNNER, chunk_steps=50, field_mode=mode,
                            grid_n=16)
    j = jsim.SimulationRunner(p, scene_seed=3, seed=2, engine="scan").run(
        csv_path=str(tmp_path / "j.csv"), progress=False)
    r = sim.SimulationRunner(_tp(p), scene_seed=3, seed=2, engine="scan",
                             rng_impl="hardware", device="cpu")
    assert r.rng_impl == "threefry"       # the scan engine's only one
    t = r.run(csv_path=str(tmp_path / "t.csv"), progress=False)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_allclose(t[1], j[1], atol=WIN_TOL)
    for k in ("escapes", "coverage_violations", "steps"):
        assert t[3][k] == j[3][k]
    jrows = writer.read_t2_csv(str(tmp_path / "j.csv"))
    trows = writer.read_t2_csv(str(tmp_path / "t.csv"))
    np.testing.assert_array_equal(trows[0], jrows[0])


def test_runner_rejects_grid_on_pallas_as_jax():
    p = P.small_test_params(**RUNNER, field_mode="grid")
    with pytest.raises(ValueError) as je:
        jsim.SimulationRunner(p, engine="pallas")
    with pytest.raises(ValueError) as te:
        sim.SimulationRunner(_tp(p), engine="pallas", device="cpu")
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="unknown engine"):
        sim.SimulationRunner(_tp(p), engine="eager", device="cpu")


def _scan_checkpoint_pair(tmp_path):
    p = P.small_test_params(**RUNNER)
    jr = jsim.SimulationRunner(p, scene_seed=3, seed=2, engine="scan")
    jr.run(checkpoint_path=str(tmp_path / "j.npz"), max_steps=500,
           progress=False)
    tr = sim.SimulationRunner(_tp(p), scene_seed=3, seed=2, engine="scan",
                              device="cpu")
    tr.run(checkpoint_path=str(tmp_path / "t.npz"), max_steps=500,
           progress=False)
    return p


def test_scan_checkpoint_crosses_the_packages(tmp_path):
    """A scan checkpoint of either package resumes in the other and ends
    where the uninterrupted run ends; a scan checkpoint is refused by a
    pallas runner and the other way round."""
    p = _scan_checkpoint_pair(tmp_path)
    full = jsim.SimulationRunner(p, scene_seed=3, seed=2,
                                 engine="scan").run(progress=False)
    t = sim.SimulationRunner(_tp(p), scene_seed=3, seed=2, engine="scan",
                             device="cpu")
    t.resume(str(tmp_path / "j.npz"))
    assert t.state.step == 500
    tc = t.run(progress=False)
    np.testing.assert_allclose(tc[1], full[1][5:], atol=WIN_TOL)
    j = jsim.SimulationRunner(p, scene_seed=3, seed=2, engine="scan")
    j.resume(str(tmp_path / "t.npz"))
    jc = j.run(progress=False)
    np.testing.assert_allclose(jc[1], full[1][5:], atol=WIN_TOL)
    np.testing.assert_allclose(t.state.pos.numpy(), np.asarray(j.state.pos),
                               atol=POS_TOL)
    with pytest.raises(ValueError, match="engine='scan'"):
        sim.SimulationRunner(_tp(p), scene_seed=3, seed=2,
                             engine="pallas", rng_impl="threefry",
                             device="cpu").resume(str(tmp_path / "t.npz"))
    _, _, _, tags = _tags(tmp_path / "t.npz")
    assert tags == ("scan", "threefry")


def _tags(path):
    with np.load(path) as z:
        return None, None, None, (str(z["engine"]), str(z["rng_impl"]))


def test_scan_decompose_checkpoint_keeps_the_scan_layout(tmp_path):
    """A scan decompose state is stored as (A, B) / (comp_A, comp_B), as
    the JAX scan engine stores it, both ways."""
    p = P.small_test_params(**RUNNER)
    sc = BacteriaBox(p, seed=3).populate()
    rng = np.random.default_rng(0)
    st = jre.init_state(sc.waters, p, decompose=True)
    st = st._replace(phase=rng.normal(size=st.phase.shape).astype(
        np.float32), step=np.uint32(500))
    jck.save_checkpoint(str(tmp_path / "j.npz"), st, p, 2, 3,
                        engine="scan", rng_impl="threefry")
    from mri_nanoparticle_simulation_tpu_torch.io import checkpoint as tck
    got, _, _ = tck.load_checkpoint(str(tmp_path / "j.npz"), _tp(p), "cpu",
                                    engine="scan", rng_impl="threefry")
    np.testing.assert_array_equal(got.phase.numpy(), st.phase)
    tck.save_checkpoint(str(tmp_path / "t.npz"), got, _tp(p), 2, 3,
                        engine="scan", rng_impl="threefry")
    back, _, _ = jck.load_checkpoint(str(tmp_path / "t.npz"), p,
                                     engine="scan", rng_impl="threefry")
    np.testing.assert_array_equal(np.asarray(back.phase), st.phase)


CLI = ["--num-water", "32", "--totaltime", "0.002", "--taucp", "0.001",
       "--chunk-steps", "1000", "--sprint-steps", "1000", "--near-k", "10",
       "--scene-seed", "1", "--seed", "2", "--mmoment", "1e-15",
       "--engine", "scan"]


@pytest.mark.parametrize("flags", [[], ["--field-mode", "exact"],
                                   ["--field-mode", "grid", "--grid-n",
                                    "24"]])
def test_cli_engine_scan_matches_jax_cli(flags, tmp_path, monkeypatch):
    from mri_nanoparticle_simulation_tpu.utils import cache as jcache
    monkeypatch.setattr(jcache, "enable_compile_cache", lambda *a: None)
    for tag, mod, extra in (("j", jsim, []), ("t", sim, ["--device",
                                                         "cpu"])):
        assert mod.main(CLI + flags + extra + [
            "--quadrature", "--out", str(tmp_path / f"{tag}.csv")]) == 0
    j = writer.read_t2_csv(str(tmp_path / "j.csv"))
    t = writer.read_t2_csv(str(tmp_path / "t.csv"))
    np.testing.assert_array_equal(t[0], j[0])
    for a, b in zip(t[1:], j[1:]):
        np.testing.assert_allclose(a, b, atol=WIN_TOL)


class _Built(Exception):
    pass


def test_cli_builds_the_jax_clis_runner(monkeypatch, tmp_path):
    """--engine/--field-mode/--grid-n and the generator default: the
    runner's Params, engine and generator as the JAX CLI's."""
    got = {}
    for tag, mod, extra in (("j", jsim, []), ("t", sim,
                                              ["--device", "cpu"])):
        def capture(params, *a, tag=tag, **kw):
            got[tag] = (params, kw.get("engine"), kw.get("rng_impl"))
            raise _Built()
        monkeypatch.setattr(mod, "SimulationRunner", capture)
        if hasattr(mod, "enable_compile_cache"):
            monkeypatch.setattr(mod, "enable_compile_cache", lambda: None)
        with pytest.raises(_Built):
            mod.main(CLI + ["--field-mode", "grid", "--grid-n", "24",
                            "--out", str(tmp_path / "x.csv")] + extra)
    (jp, je, jr), (tp, te, tr) = got["j"], got["t"]
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert (te, tr) == (je, jr) == ("scan", "threefry")


def test_run_decomposition_scan_matches_jax():
    p = P.small_test_params(**RUNNER)
    sc = BacteriaBox(p, seed=3).populate()
    j = jdec.run_decomposition(sc, p, seed=5, engine="scan")
    t = tdec.run_decomposition(TBox(_tp(p), seed=3).populate(), _tp(p),
                               seed=5, engine="scan", device="cpu")
    assert t.A.shape == j.A.shape == (p.t // p.pfreq, p.num_water)
    np.testing.assert_allclose(t.A, j.A, atol=POS_TOL)
    np.testing.assert_allclose(t.B, j.B, atol=POS_TOL)
    for k in ("steps", "escapes", "coverage_violations"):
        assert t.stats[k] == j.stats[k]


@pytest.mark.parametrize("fn", ["run_decomposition_durable",
                                "run_streaming_durable",
                                "run_plane_on_device"])
def test_durable_and_plane_writers_raise_for_scan(fn, tmp_path):
    """The durable writers and the on-device plane run the scan engine
    (they raised for it before it was ported): each gives the record of
    ``run_decomposition(engine="scan")``, bitwise, or its plane; an
    unknown engine still raises."""
    p = _tp(P.small_test_params(**RUNNER))
    sc = TBox(p, seed=3).populate()
    ref = tdec.run_decomposition(sc, p, seed=0, engine="scan", device="cpu")
    plane = tdec.StreamingPlane(p, p.t // p.pfreq, [1.0], None,
                                quadrature=True)
    args = {"run_decomposition_durable": (str(tmp_path / "r"),),
            "run_streaming_durable": (plane, str(tmp_path / "s.npz")),
            "run_plane_on_device": ([1.0],)}[fn]
    with pytest.raises(ValueError, match="unknown engine"):
        getattr(tdec, fn)(sc, p, *args, engine="eager", device="cpu")
    out = getattr(tdec, fn)(sc, p, *args, engine="scan", device="cpu")
    if fn == "run_decomposition_durable":
        np.testing.assert_array_equal(np.asarray(out.A), ref.A)
        np.testing.assert_array_equal(np.asarray(out.B), ref.B)
        return
    want = tdec.curves_at_plane(ref.A, ref.B, [1.0], [p.taucp], p,
                                quadrature=True)
    got = plane.result() if fn == "run_streaming_durable" else out[1]
    np.testing.assert_allclose(got, want, atol=1e-5)
    stats = out if fn == "run_streaming_durable" else out[2]
    assert stats["steps"] == ref.stats["steps"]


def test_ensemble_scan_matches_jax():
    p = P.small_test_params(**RUNNER).with_permeability()
    kw = dict(base_seed=3, run_seed=7, d_scales=[0.5, 1.0],
              taucps=[0.0003, 0.0005], permeabilities=[1.0, 20.0])
    jt, jc, js, jst = jens.run_ensemble(p, 2, engine="scan", **kw)
    tt, tc, ts, tst = tens.run_ensemble(_tp(p), 2, engine="scan",
                                        device="cpu", **kw)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tc, jc, atol=WIN_TOL)
    np.testing.assert_allclose(ts, js, atol=WIN_TOL)
    np.testing.assert_allclose(tst.pos.numpy(), np.asarray(jst.pos),
                               atol=POS_TOL)


def test_scan_sweep_trials_are_their_standalone_runs():
    """A scan sweep's trial is the scan engine's own run of that trial."""
    p = _tp(P.small_test_params(**RUNNER))
    _, curves = tens.run_parameter_sweep(p, "D", [0.5], engine="scan",
                                         base_seed=3, run_seed=7,
                                         device="cpu")
    sc = TBox(p, seed=3).populate()
    sprint = tre.make_sprint_fn(p, "cpu")
    st = tre.init_state(sc.waters, p, "cpu")
    outs = []
    for _ in range(p.t // p.sprint_steps):
        st, w = sprint(torch.as_tensor(sc.mnps[:, :3]).float(),
                       torch.as_tensor(sc.mnps[:, 4]).float(),
                       convert.key_words(7), st, d_scale=0.5, tcp=p.tcp,
                       cell_r=p.cell_r)
        outs.append(w.numpy()[:, 0])
    np.testing.assert_array_equal(curves[0, 0], np.concatenate(outs))

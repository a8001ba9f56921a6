"""The port's ensembles and sweeps against the JAX package, on the CPU.

The JAX side runs its Pallas engine in interpret mode on Threefry on a
one-device trial mesh (every JAX call below gets ``mesh=ONE``, or its
sweep's trial mesh is that mesh): its trials are scanned through one
chunk kernel, as the port runs them one after another through one
sprint function.  Tolerances of tests/test_pallas.py:34-36: positions
within 5e-6, window sums within 1e-3, escapes and coverage equal.

* ``build_trial_scenes``: the padded arrays bitwise JAX's, each distinct
  scene built once;
* ``grid_per_trial`` and ``sweep_params_for``: equal outputs;
* ``run_ensemble`` for plain trials and with each per-trial knob, every
  trial bitwise the port's own standalone sprints (its own, unpadded
  dipole table, the same launch scalars), and for taucp and run cell_r
  bitwise the static-parameter run;
* a trial above 2048 dipoles (the near entry and the far sums' plain
  version);
* ``run_parameter_sweep`` and ``run_parameter_grid``;
* every ValueError of the reference's ``run_ensemble``, raised the same
  way, and the port's own raises for what it does not run;
* the CLI's ``--sweep``, ``--sweep-grid`` and ``--ensemble`` against the
  JAX CLI (``--engine scan``; scan-engine tolerances), the sweep
  outputs' bytes, and ``--trace``.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mri_nanoparticle_simulation_tpu import params as JP
from mri_nanoparticle_simulation_tpu.engine import sim as jsim
from mri_nanoparticle_simulation_tpu.parallel import ensemble as jens
from mri_nanoparticle_simulation_tpu_torch.engine import (convert,
                                                          cuda_engine, sim)
from mri_nanoparticle_simulation_tpu_torch.engine.reference_engine import \
    init_state
from mri_nanoparticle_simulation_tpu_torch.io import writer
from mri_nanoparticle_simulation_tpu_torch.parallel import ensemble as tens
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox as TBox
from mri_nanoparticle_simulation_tpu_torch.utils import profiling

torch.set_num_threads(1)

POS_TOL = 5e-6
WIN_TOL = 1e-3
ONE = Mesh(np.asarray(jax.devices("cpu")[:1]), (jens.TRIAL_AXIS,))
BASE, RUN = 7, 99
#: 2 trials x 32 walkers x 500 steps (5 chunks of 100), 100-step windows
SMALL = dict(num_water=32, totaltime=0.0005, sprint_steps=500,
             mmoment=3.5e-15)
#: above the rebuild entry's 2048 dipoles: 2427 and 2408 (seeds 0, 1)
LARGE = dict(num_water=32, totaltime=0.0005, sprint_steps=500, bound=12.0,
             water_start_bound=10.0, num_cells=400, hash_dim=20,
             max_neighbors=24, border=5.0, near_k=8)


def _tp(p):
    """The port's Params of the JAX Params ``p``."""
    return convert.params_from_fields(dataclasses.asdict(p))


def _one_mesh(n, mesh):
    """The reference's trial-mesh choice, held to one device."""
    return ONE, n


@pytest.fixture(scope="module")
def one_device_sweeps():
    """The JAX sweeps pick their own trial mesh: hold it to one device."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jens, "_trial_mesh", _one_mesh)
    yield
    mp.undo()


# -- helpers that carry over as they are --------------------------------------

SCENES = {
    "plain": dict(n=3),
    "mmoments": dict(n=2, mmoments=[3.5e-15, 7e-15]),
    "cell_rs": dict(n=2, cell_rs=[0.5, 0.6]),
    "paired": dict(n=4, scene_seeds=[0, 1, 0, 1]),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_trial_scenes_bitwise_jax(name):
    kw = dict(SCENES[name])
    n = kw.pop("n")
    p = JP.small_test_params(**SMALL)
    got = tens.build_trial_scenes(_tp(p), n, 3, **kw)
    ref = jens.build_trial_scenes(p, n, 3, **kw)
    for a, b in zip(got[:3], ref[:3]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert (got[0][:, :, 0] == 1e6).any()        # padding present
    if name == "paired":
        scenes = got[3]
        assert scenes[0] is scenes[2] and scenes[1] is scenes[3]
        assert scenes[0] is not scenes[1]


GRIDS = [({"D": [0.5, 1.0], "taucp": [1.0, 2.0, 5.5]}, 2, False),
         ({"mmoment": [1e-17, 2e-17], "P": [1e-3]}, 3, True),
         ({"cell_r": [0.5]}, 1, True)]


@pytest.mark.parametrize("axes,n_each,paired", GRIDS)
def test_grid_per_trial_matches_jax(axes, n_each, paired):
    assert tens.grid_per_trial(axes, n_each, paired, 5, 50) == \
        jens.grid_per_trial(axes, n_each, paired, 5, 50)


@pytest.mark.parametrize("axes", [{"num_water": [8, 16]}, {}])
def test_grid_per_trial_rejects_as_jax(axes):
    with pytest.raises(ValueError) as j:
        jens.grid_per_trial(axes, 1, False, 0, 0)
    with pytest.raises(ValueError) as t:
        tens.grid_per_trial(axes, 1, False, 0, 0)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("name,value", [("D", 0.5), ("P", 5.0),
                                        ("Gz", 3e-5), ("cell_r", 0.6),
                                        ("num_cells", 20)])
def test_sweep_params_for_matches_jax(name, value):
    p = JP.small_test_params()
    assert dataclasses.asdict(tens.sweep_params_for(_tp(p), name, value)) \
        == dataclasses.asdict(jens.sweep_params_for(p, name, value))
    assert tens.SCALAR_AXES == jens.SCALAR_AXES
    assert tens._AXIS_KWARG == jens._AXIS_KWARG


def test_window_times_match_jax():
    p = JP.small_test_params()
    np.testing.assert_array_equal(tens.window_times(_tp(p), 7),
                                  jens.window_times(p, 7))


# -- run_ensemble against the reference ---------------------------------------

KNOBS = {
    "plain": dict(),
    "mmoments": dict(mmoments=[3.5e-15, 7e-15]),
    "taucps": dict(taucps=[0.0001, 0.0002]),
    "cell_rs": dict(cell_rs=[0.5, 0.6]),
    "run_cell_rs": dict(run_cell_rs=[0.5, 0.6]),
    "d_scales": dict(d_scales=[0.5, 1.5]),
    "permeabilities": dict(permeabilities=[1e-3, 5.0]),
    "scene_seeds": dict(scene_seeds=[3, 3]),
    "run_seeds": dict(run_seeds=[5, 5]),
    "large": dict(),
}


def _knob_params(name):
    if name == "large":
        return JP.small_test_params(**LARGE)
    p = JP.small_test_params(**SMALL)
    return p.with_permeability() if name == "permeabilities" else p


def _standalone(tp, i, kw, static=False):
    """Trial ``i`` of an ensemble with per-trial knobs ``kw``, run alone
    through the port's sprints: its scene built alone (moment rescaled
    as the ensemble does), its own dipole table, the trial's launch
    scalars; ``static`` sets tcp and cell_r in the Params instead."""
    seeds = kw.get("scene_seeds")
    scene_p = tp if "cell_rs" not in kw \
        else tp.replace(cell_r=kw["cell_rs"][i])
    sc = TBox(scene_p,
              seed=BASE + i if seeds is None else seeds[i]).populate()
    mnps = sc.mnps.copy()
    if "mmoments" in kw:
        mnps[:, 4] *= kw["mmoments"][i] / tp.mmoment
    over = dict(tcp=None, cell_r=None, d_scale=None, reflect=None)
    if "taucps" in kw:
        over["tcp"] = int(round(kw["taucps"][i] / tp.tau))
    crs = kw.get("run_cell_rs", kw.get("cell_rs"))
    if crs is not None:
        over["cell_r"] = crs[i]
    if "d_scales" in kw:
        over["d_scale"] = kw["d_scales"][i]
    if "permeabilities" in kw:
        over["reflect"] = tp.reflect_pair(kw["permeabilities"][i])
    rp = tp
    if static:
        if "taucps" in kw:
            rp = rp.replace(taucp=kw["taucps"][i])
        if "run_cell_rs" in kw:
            rp = rp.replace(cell_r=kw["run_cell_rs"][i])
        rp = rp.validate()
        over.update(tcp=None, cell_r=None)
    sprint = cuda_engine.make_sprint_fn(rp, tp.num_water, "cpu")
    tbl = convert.mnp_table(mnps, torch.float32, "cpu")
    runs = kw.get("run_seeds")
    key = convert.key_words(RUN + i if runs is None else runs[i])
    ss = cuda_engine.to_soa(init_state(sc.waters, tp, "cpu"), tp)
    outs = []
    for _ in range(tp.t // tp.sprint_steps):
        ss, wins = sprint(tbl, key, ss, 0, **over)
        outs.append(wins)
    return torch.cat(outs).numpy(), cuda_engine.from_soa(ss, tp.num_water)


@pytest.fixture(scope="module", params=sorted(KNOBS))
def runs(request):
    name = request.param
    kw = KNOBS[name]
    p = _knob_params(name)
    base = 0 if name == "large" else BASE
    ref = jens.run_ensemble(p, 2, mesh=ONE, base_seed=base, run_seed=RUN,
                            engine="pallas", interpret=True,
                            rng_impl="threefry", **kw)
    got = tens.run_ensemble(_tp(p), 2, base_seed=base, run_seed=RUN,
                            device="cpu", **kw)
    return name, p, kw, ref, got


def test_run_ensemble_matches_jax(runs):
    _, p, _, (t1, c1, s1, st1), (t2, c2, s2, st2) = runs
    np.testing.assert_array_equal(t2, t1)
    assert c2.shape == np.asarray(c1).shape == (2, p.t // p.pfreq)
    np.testing.assert_allclose(st2.pos.numpy(), np.asarray(st1.pos),
                               atol=POS_TOL)
    np.testing.assert_allclose(c2, c1, atol=WIN_TOL)
    np.testing.assert_allclose(s2, s1, atol=WIN_TOL)
    np.testing.assert_array_equal(st2.escapes.numpy(),
                                  np.asarray(st1.escapes))
    np.testing.assert_array_equal(st2.coverage.numpy(),
                                  np.asarray(st1.coverage))
    assert st2.step == p.t
    np.testing.assert_array_equal(np.asarray(st1.step), p.t)
    np.testing.assert_array_equal(st2.in_cell.numpy(),
                                  np.asarray(st1.in_cell))


def test_trials_bitwise_their_standalone_runs(runs):
    name, p, kw, _, (_, cos, sin, st) = runs
    tp = _tp(p)
    for i in range(2):
        if name == "large":
            kw = dict(scene_seeds=[0, 1])
        wins, alone = _standalone(tp, i, kw)
        np.testing.assert_array_equal(cos[i], wins[:, 0])
        np.testing.assert_array_equal(sin[i], wins[:, 1])
        for f in ("pos", "in_cell", "phase", "phase_comp"):
            assert torch.equal(getattr(st, f)[i], getattr(alone, f)), f
        assert int(st.escapes[i]) == int(alone.escapes)
        assert int(st.coverage[i]) == int(alone.coverage)
        if name in ("taucps", "run_cell_rs"):
            # the launch scalar is the static value's float32 twin
            swins, salone = _standalone(tp, i, kw, static=True)
            np.testing.assert_array_equal(cos[i], swins[:, 0])
            assert torch.equal(st.pos[i], salone.pos)


def test_knobs_change_the_trials(runs):
    """The two trials differ: each has its own scene, stream or knob."""
    _, _, _, _, (_, cos, _, st) = runs
    assert not np.array_equal(cos[0], cos[1])
    assert not torch.equal(st.pos[0], st.pos[1])


def test_large_trial_takes_the_near_entry():
    p = _tp(JP.small_test_params(**LARGE))
    pos, _, _, scenes = tens.build_trial_scenes(p, 2, 0)
    counts = [len(s.mnps) for s in scenes]
    assert counts == [2427, 2408] and pos.shape[1] == 2427
    tbl = tens.trial_table(pos[1], np.zeros(pos.shape[1]), torch.float32,
                           "cpu")
    assert tbl.n_mnp == 2427 > cuda_engine.REBUILD_MAX_MNPS
    assert tbl.tbl.shape == (4, 2432)


def test_paired_scene_is_not_rescaled_in_place():
    """Two trials on one scene object with other moments: each table
    takes its own moment, the scene keeps its own."""
    p = _tp(JP.small_test_params(**SMALL))
    pos, mom, _, scenes = tens.build_trial_scenes(
        p, 2, 0, mmoments=[p.mmoment, 2 * p.mmoment], scene_seeds=[4, 4])
    assert scenes[0] is scenes[1]
    n = len(scenes[0].mnps)
    np.testing.assert_array_equal(mom[0, :n], scenes[0].mnps[:, 4])
    np.testing.assert_array_equal(mom[1, :n], 2 * scenes[0].mnps[:, 4])


# -- sweeps and grids ---------------------------------------------------------

SWEEPS = {
    "taucp": ("taucp", [0.0001, 0.0002], 2, False, True),
    "D_paired": ("D", [0.5, 1.0], 2, True, False),
    "num_cells": ("num_cells", [10, 12], 1, False, True),
    "Gz_paired": ("Gz", [0.0, 3e-5], 1, True, False),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_run_parameter_sweep_matches_jax(name, one_device_sweeps):
    knob, values, n_each, paired, quad = SWEEPS[name]
    p = JP.small_test_params(**SMALL)
    kw = dict(n_trials_each=n_each, base_seed=BASE, run_seed=RUN,
              paired=paired, quadrature=quad)
    t1, c1 = jens.run_parameter_sweep(p, knob, values, engine="pallas",
                                      rng_impl="threefry", interpret=True,
                                      **kw)
    t2, c2 = tens.run_parameter_sweep(_tp(p), knob, values, device="cpu",
                                      **kw)
    np.testing.assert_array_equal(t2, t1)
    assert c2.shape == c1.shape == (len(values), n_each, 5) + \
        ((2,) if quad else ())
    np.testing.assert_allclose(c2, c1, atol=WIN_TOL)
    if paired:        # common random numbers: trial k shares its stream
        assert not np.array_equal(c2[0], c2[1])


def test_run_parameter_grid_matches_jax():
    p = JP.small_test_params(**SMALL)
    axes = {"D": [0.5, 1.0], "taucp": [0.0001, 0.0002, 0.0005]}
    t1, c1 = jens.run_parameter_grid(p, axes, n_trials_each=1,
                                     base_seed=BASE, run_seed=RUN,
                                     engine="pallas", rng_impl="threefry",
                                     interpret=True, paired=True, mesh=ONE,
                                     quadrature=True)
    t2, c2 = tens.run_parameter_grid(_tp(p), axes, n_trials_each=1,
                                     base_seed=BASE, run_seed=RUN,
                                     paired=True, quadrature=True,
                                     device="cpu")
    np.testing.assert_array_equal(t2, t1)
    assert c2.shape == c1.shape == (2, 3, 1, 5, 2)
    np.testing.assert_allclose(c2, c1, atol=WIN_TOL)
    # row-major: the point (D=1.0, taucp=0.0002) is trial 1 * 3 + 1
    _, cos, _, _ = tens.run_ensemble(_tp(p), 1, base_seed=BASE,
                                     run_seed=RUN, d_scales=[1.0],
                                     taucps=[0.0002], device="cpu")
    np.testing.assert_array_equal(c2[1, 1, 0, :, 0], cos[0])


# -- errors -------------------------------------------------------------------

ERRORS = {
    "scene_seeds_length": dict(scene_seeds=[1]),
    "run_seeds_length": dict(run_seeds=[1, 2, 3]),
    "taucp_misaligned": dict(taucps=[0.0001, 0.00013]),
    "cell_rs_and_run_cell_rs": dict(cell_rs=[0.5, 0.5],
                                    run_cell_rs=[0.5, 0.5]),
    "cell_rs_outside_box": dict(cell_rs=[0.5, 9.0]),
    "run_cell_rs_length": dict(run_cell_rs=[0.5]),
    "run_cell_rs_negative": dict(run_cell_rs=[0.5, -1.0]),
    "d_scales_not_positive": dict(d_scales=[1.0, -1.0]),
    "permeability_without_reflection": dict(permeabilities=[1.0, 2.0]),
    "permeability_outside_formulas": dict(params="permeable",
                                          permeabilities=[1.0, 1e6]),
    "field_mode_exact": dict(params="exact"),
    "near_k_below_the_scene": dict(params="near_k_1"),
    "near_k_below_the_scaled_reach": dict(d_scales=[1.0, 400.0]),
}


def _error_params(which):
    p = JP.small_test_params(**SMALL)
    return {None: p, "permeable": p.with_permeability(),
            "exact": p.replace(field_mode=JP.FIELD_EXACT),
            "near_k_1": p.replace(near_k=1)}[which]


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_run_ensemble_errors_match_jax(name):
    kw = dict(ERRORS[name])
    p = _error_params(kw.pop("params", None))
    with pytest.raises(ValueError) as j:
        jens.run_ensemble(p, 2, mesh=ONE, base_seed=BASE, run_seed=RUN,
                          engine="pallas", interpret=True, **kw)
    with pytest.raises(ValueError) as t:
        tens.run_ensemble(_tp(p), 2, base_seed=BASE, run_seed=RUN,
                          device="cpu", **kw)
    assert str(t.value) == str(j.value)


#: options the port ran on no mesh before ROADMAP item 11 and raised
#: for; now they raise only where the reference does (the ids are kept)
UNRUNNABLE = [
    pytest.param(dict(engine="scan", walker_shards=2),
                 r"must divide the device count \(1\)", id="kw0-item 11"),
    pytest.param(dict(walker_shards=2), r"must divide the device count "
                 r"\(1\)", id="kw1-item 11"),
    pytest.param(dict(mesh=ONE), "must be a TrialMesh", id="kw2-item 11"),
    pytest.param(dict(engine="eager"), "unknown", id="kw3-unknown"),
]


@pytest.mark.parametrize("kw,item", UNRUNNABLE)
def test_unported_options_raise(kw, item):
    """Two walker shards on the one CPU device: the reference's rule
    (walker_shards must divide the device count); a JAX mesh is not a
    port mesh; an unknown engine."""
    p = _tp(JP.small_test_params(**SMALL))
    with pytest.raises(ValueError, match=item):
        tens.run_ensemble(p, 2, device="cpu", **kw)


def test_sweeps_raise_for_the_scan_engine():
    """The sweeps carry walker_shards to run_ensemble: two shards on the
    one CPU device raise as the reference's rule says, on both engines
    (tests/test_torch_sharding.py runs them on a mesh)."""
    p = _tp(JP.small_test_params(**SMALL))
    with pytest.raises(ValueError, match="must divide the device count"):
        tens.run_parameter_sweep(p, "num_cells", [10], engine="scan",
                                 walker_shards=2, device="cpu")
    with pytest.raises(ValueError, match="must divide the device count"):
        tens.run_parameter_grid(p, {"D": [1.0]}, walker_shards=2,
                                device="cpu")


# -- the CLI ------------------------------------------------------------------

def test_emit_sweep_outputs_bytewise_jax(tmp_path):
    """One grid of synthetic decays (3 points x 3 trials, with sin)
    through both packages' writers: the same files, byte for byte."""
    rng = np.random.default_rng(3)
    times = np.arange(1, 41) * 0.25
    t2s = np.array([8.0, 12.0, 20.0])
    decay = np.exp(-times[None, None] / t2s[:, None, None]) * 4032
    cos = decay * (1 + 0.01 * rng.standard_normal((3, 3, 40)))
    flat = np.stack([cos, 0.1 * cos], -1).astype(np.float32)
    names, combos = ["D"], [(0.5,), (1.0,), (2.0,)]
    p = JP.DEFAULT.replace(totaltime=10.0, taucp=0.5)
    for tag, mod, pp in (("j", jsim, p), ("t", sim, _tp(p))):
        d = tmp_path / tag
        d.mkdir()
        mod._emit_sweep_outputs(str(d / "t2.csv"), times, names, combos,
                                flat, lambda c: pp.scale_D(c[0]),
                                str(d / "fit.csv"), quadrature=True)
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "t")) == sorted(
        ["fit.csv", "t2_D=0.5.csv", "t2_D=1.csv", "t2_D=2.csv"])
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f
    rows = (tmp_path / "t" / "fit.csv").read_text().splitlines()
    assert rows[0] == "D,r2_per_ms,t2_ms,r_squared,n_echoes,t2_stderr_ms"
    assert all(np.isfinite(float(r.split(",")[2])) for r in rows[1:])


CLI = ["--num-water", "32", "--totaltime", "0.002", "--taucp", "0.001",
       "--chunk-steps", "1000", "--sprint-steps", "1000", "--near-k", "10",
       "--scene-seed", "1", "--seed", "2", "--mmoment", "1e-15",
       "--rng", "threefry"]
BRANCHES = {
    "sweep": ["--sweep", "D", "--sweep-values", "0.5,1",
              "--trials-per-value", "2", "--fit-t2", "FIT"],
    "grid": ["--sweep-grid", "D=0.5,1;mmoment=1e-15,2e-15", "--paired",
             "--quadrature"],
    "ensemble": ["--ensemble", "2"],
}


@pytest.fixture(scope="module", params=sorted(BRANCHES))
def cli_branch(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    base = tmp_path_factory.mktemp(request.param)
    try:
        from mri_nanoparticle_simulation_tpu.utils import cache as jcache
        mp.setattr(jcache, "enable_compile_cache", lambda *a: None)
        for tag, mod, extra in (("jax", jsim, ["--engine", "scan"]),
                                ("port", sim, ["--device", "cpu"])):
            d = base / tag
            d.mkdir()
            argv = [str(d / "fit.csv") if a == "FIT" else a
                    for a in BRANCHES[request.param]]
            assert mod.main(CLI + argv + extra
                            + ["--out", str(d / "t2.csv")]) == 0
    finally:
        mp.undo()
    return request.param, base / "jax", base / "port"


def test_cli_branches_write_the_jax_clis_files(cli_branch):
    name, j, t = cli_branch
    files = sorted(os.listdir(j))
    assert files == sorted(os.listdir(t))
    want = {"sweep": ["fit.csv", "t2_D=0.5.csv", "t2_D=1.csv"],
            "grid": [f"t2_D={d}_mmoment={m}.csv" for d in ("0.5", "1")
                     for m in ("1e-15", "2e-15")],
            "ensemble": ["t2.csv"]}[name]
    assert files == sorted(want)
    for f in files:
        if f == "fit.csv":
            jl = (j / f).read_text().splitlines()
            tl = (t / f).read_text().splitlines()
            assert tl[0] == jl[0] and len(tl) == len(jl) == 3
            assert [r.split(",")[0] for r in tl] == \
                [r.split(",")[0] for r in jl]
            continue
        jr, tr = writer.read_t2_csv(str(j / f)), writer.read_t2_csv(
            str(t / f))
        assert len(tr) == len(jr) == (3 if name == "grid" else 2)
        np.testing.assert_array_equal(tr[0], jr[0])
        for a, b in zip(tr[1:], jr[1:]):
            np.testing.assert_allclose(a / 32, b / 32, atol=5e-5)


@pytest.mark.parametrize("cli_branch", ["ensemble"], indirect=True)
def test_cli_ensemble_csv_is_the_in_process_mean(cli_branch, tmp_path):
    _, _, t = cli_branch
    ap = sim.build_parser()
    args = ap.parse_args(CLI + ["--device", "cpu"])
    p = sim.params_from_args(ap, args)
    _, cos, sin, _ = tens.run_ensemble(p, 2, base_seed=1, run_seed=1002,
                                       rng_impl="threefry", device="cpu")
    with writer.T2CsvWriter(str(tmp_path / "m.csv"), p) as w:
        w.append_windows(0, np.stack([cos.mean(0), sin.mean(0)], -1))
    assert (tmp_path / "m.csv").read_bytes() == (t / "t2.csv").read_bytes()


@pytest.mark.parametrize("branch", [[], ["--ensemble", "2"]])
def test_cli_trace_writes_a_trace(branch, tmp_path):
    trace = tmp_path / "trace"
    assert sim.main(CLI + branch + ["--device", "cpu", "--trace",
                                    str(trace), "--out",
                                    str(tmp_path / "t2.csv")]) == 0
    with open(trace / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert events and profiling.trace_kernels(
        str(trace / profiling.TRACE_FILE)) == []      # no card here
    with open(trace / profiling.SPANS_FILE) as f:
        spans = json.load(f)
    assert spans["sprint_loop.sprint"]["calls"] > 0
    if not branch:
        assert spans["runner.run"]["calls"] == 1


def test_device_trace_off_is_a_no_op(tmp_path):
    with profiling.device_trace(None, "cpu"):
        x = torch.ones(3).sum()
    assert float(x) == 3.0


def test_cli_p_axis_grid_writes_csvs_where_jax_raises(tmp_path,
                                                      monkeypatch):
    """A P (permeability) axis in --sweep-grid: the reference CLI builds
    each point's Params with ``pv.replace(P=...)`` (its sim.py:1084-1089)
    and ``Params`` has no field P, so it raises TypeError after the run;
    the port maps the axis through ``sweep_params_for`` and writes one
    CSV per point, each with that point's permeability."""
    from mri_nanoparticle_simulation_tpu.utils import cache as jcache
    monkeypatch.setattr(jcache, "enable_compile_cache", lambda *a: None)
    argv = CLI + ["--sweep-grid", "P=1,10"]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    assert sim.main(argv + ["--device", "cpu", "--out",
                            str(tmp_path / "port" / "t2.csv")]) == 0
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == ["t2_P=1.csv", "t2_P=10.csv"]
    curves = [writer.read_t2_csv(str(tmp_path / "port" / f))[1]
              for f in files]
    assert all(len(c) == 2 and np.all(np.isfinite(c)) for c in curves)
    assert not np.array_equal(curves[0], curves[1])
    with pytest.raises(TypeError, match="P"):
        jsim.main(argv + ["--engine", "scan", "--out",
                          str(tmp_path / "jax" / "t2.csv")])
    assert not os.listdir(tmp_path / "jax")

"""The port's walker sharding (``parallel/sharding.py``) on the CPU.

A mesh here names torch's one CPU device several times (8, 4 or 2
shards), which runs the same per-shard code one shard after another.

* The sharded sprint of both engines against the port's unsharded run:
  positions, phases, residency, escapes and coverage bitwise (global
  lanes), window sums within 1e-3 (tests/test_parallel.py:36); on both
  generators (the fast one is keyed by the global lane too), and at
  shard widths that are not a multiple of 32 (8 and 24 walkers).
* The same runs against the JAX package's single-device engines
  (``reference_engine`` and ``pallas_engine`` in interpret mode; their
  own tests hold them equal to their sharded runs) within
  tests/test_pallas.py:34-36, and against JAX's scan-engine
  ``run_simulation_sharded`` on its 8 virtual CPU devices (no Pallas
  under ``shard_map``, which is unsteady on the CPU).
* The large-scene path sharded (tests/test_parallel.py
  TestShardedBigScene's shape: 256 walkers, cube_hash_dim 8,
  far_table_order 3, and 0 for the far sums; REBUILD_MAX_MNPS -> 0).
* The uneven-shard error; the runner on a mesh (both engines, a
  checkpoint saved under one mesh resumed under another, the grid
  mode's refusal); the CLI's ``--shard-walkers``.
* Ensembles: a (trials x walkers) mesh with every trial bitwise its
  standalone run, a trial mesh over several slots, the sweeps carrying
  ``walker_shards`` and ``mesh``, and ``_trial_mesh`` / ``_trial_mesh_2d``
  (right-sizing, warnings, errors) against the JAX package's on the
  same counts.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mri_nanoparticle_simulation_tpu import params as P
from mri_nanoparticle_simulation_tpu import rng as jrng
from mri_nanoparticle_simulation_tpu.engine import pallas_engine as pe
from mri_nanoparticle_simulation_tpu.engine import reference_engine as jre
from mri_nanoparticle_simulation_tpu.fields import expansion as jexp
from mri_nanoparticle_simulation_tpu.parallel import ensemble as jens
from mri_nanoparticle_simulation_tpu.parallel import sharding as jsh
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
from mri_nanoparticle_simulation_tpu_torch.engine import (
    convert, cuda_engine, sim)
from mri_nanoparticle_simulation_tpu_torch.engine import \
    reference_engine as tre
from mri_nanoparticle_simulation_tpu_torch.io import writer
from mri_nanoparticle_simulation_tpu_torch.parallel import ensemble as tens
from mri_nanoparticle_simulation_tpu_torch.parallel import sharding as tsh
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox as TBox

torch.set_num_threads(1)

POS_TOL = 5e-6
WIN_TOL = 1e-3
#: tests/test_parallel.py's ``small`` fixture
SMALL = dict(num_water=64, totaltime=0.001, sprint_steps=500)


def _tp(p):
    return convert.params_from_fields(dataclasses.asdict(p))


def _mesh(n):
    return tsh.make_walker_mesh(["cpu"] * n)


@pytest.fixture(scope="module")
def small():
    p = P.small_test_params(**SMALL)
    return p, BacteriaBox(p, seed=5).populate(), _tp(p), \
        TBox(_tp(p), seed=5).populate()


@pytest.fixture(scope="module")
def unsharded(small):
    """The port's and JAX's single-device runs of the fixture."""
    p, sc, tp, tsc = small
    return {
        "threefry": cuda_engine.run_simulation(tsc, tp, seed=3,
                                               device="cpu"),
        "hardware": cuda_engine.run_simulation(tsc, tp, seed=3,
                                               device="cpu",
                                               rng_impl="hardware"),
        "scan": tre.run_simulation(tsc, tp, seed=3, device="cpu"),
        "jax_pallas": pe.run_simulation(sc, p, seed=3, dtype=jnp.float32,
                                        interpret=True),
        "jax_scan": jre.run_simulation(sc, p, seed=3, dtype=jnp.float32),
    }


def _assert_same_walkers(st, ref):
    for f in ("pos", "in_cell", "phase", "phase_comp"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      getattr(ref, f).numpy(), err_msg=f)
    assert st.step == ref.step
    assert int(st.escapes) == int(ref.escapes)
    assert int(st.coverage) == int(ref.coverage)


def _assert_near_jax(got, ref):
    _, c, s, st = got
    _, jc, js, jst = ref
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(jst.pos),
                               atol=POS_TOL)
    np.testing.assert_array_equal(st.in_cell.numpy(),
                                  np.asarray(jst.in_cell))
    np.testing.assert_allclose(c, jc, atol=WIN_TOL)
    np.testing.assert_allclose(s, js, atol=WIN_TOL)
    assert int(st.escapes) == int(jst.escapes)


@pytest.mark.parametrize("rng_impl", ["threefry", "hardware"])
@pytest.mark.parametrize("n", [8, 4, 2])
def test_sharded_kernels_equal_unsharded(small, unsharded, n, rng_impl):
    _, _, tp, tsc = small
    got = tsh.run_simulation_sharded_pallas(tsc, tp, _mesh(n), seed=3,
                                            rng_impl=rng_impl)
    ref = unsharded[rng_impl]
    _assert_same_walkers(got[3], ref[3])
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], atol=WIN_TOL)
    np.testing.assert_allclose(got[2], ref[2], atol=WIN_TOL)


@pytest.mark.parametrize("n", [8, 4, 2])
def test_sharded_scan_equals_unsharded(small, unsharded, n):
    _, _, tp, tsc = small
    got = tsh.run_simulation_sharded(tsc, tp, _mesh(n), seed=3)
    _assert_same_walkers(got[3], unsharded["scan"][3])
    np.testing.assert_allclose(got[1], unsharded["scan"][1], atol=WIN_TOL)


@pytest.mark.parametrize("n", [8, 4, 2])
def test_sharded_runs_match_jax_single_device(small, unsharded, n):
    _, _, tp, tsc = small
    _assert_near_jax(tsh.run_simulation_sharded_pallas(tsc, tp, _mesh(n),
                                                       seed=3),
                     unsharded["jax_pallas"])
    _assert_near_jax(tsh.run_simulation_sharded(tsc, tp, _mesh(n), seed=3),
                     unsharded["jax_scan"])


def test_sharded_scan_matches_jax_sharded_scan(small):
    """JAX's scan engine under shard_map on its 8 virtual CPU devices
    against the port's 8 shards."""
    p, sc, tp, tsc = small
    mesh = jsh.make_walker_mesh(jax.devices("cpu"))
    assert mesh.shape[jsh.WALKER_AXIS] == 8
    _assert_near_jax(tsh.run_simulation_sharded(tsc, tp, _mesh(8), seed=3),
                     jsh.run_simulation_sharded(sc, p, mesh=mesh, seed=3))


@pytest.mark.parametrize("rng_impl", ["threefry", "hardware"])
def test_shard_width_not_a_multiple_of_32(rng_impl):
    """96 walkers over 4 shards: each shard pads its 24 walkers to the
    kernels' width on its own."""
    tp = _tp(P.small_test_params(num_water=96, totaltime=0.0005,
                                 sprint_steps=500))
    sc = TBox(tp, seed=2).populate()
    got = tsh.run_simulation_sharded_pallas(sc, tp, _mesh(4), seed=1,
                                            rng_impl=rng_impl)
    ref = cuda_engine.run_simulation(sc, tp, seed=1, device="cpu",
                                     rng_impl=rng_impl)
    _assert_same_walkers(got[3], ref[3])
    np.testing.assert_allclose(got[1], ref[1], atol=WIN_TOL)


def test_to_and_from_planes_sharded_round_trip(small):
    _, _, tp, tsc = small
    for dec in (False, True):
        st = tre.init_state(tsc.waters, tp, "cpu", decompose=dec)
        st = st._replace(phase=torch.rand(st.phase.shape),
                         in_cell=torch.rand(64) < 0.5)
        ss = tsh.to_planes_sharded(st, tp, _mesh(8))
        assert [s.planes.shape for s in ss.shards] == \
            [(8 if dec else 6, cuda_engine.pad_count(8))] * 8
        _assert_same_walkers(tsh.from_planes_sharded(ss, 64, _mesh(8)), st)
        _assert_same_walkers(tsh.gather_walkers(
            tsh.shard_walkers(st, _mesh(4)), _mesh(4)), st)


def test_uneven_shards_rejected(small):
    _, _, tp, tsc = small
    mesh = _mesh(3)
    with pytest.raises(ValueError, match="divide evenly"):
        tsh.make_sharded_sprint_fn(tp, mesh)
    with pytest.raises(ValueError, match="divide evenly"):
        tsh.make_sharded_pallas_sprint_fn(tp, 64, mesh)
    with pytest.raises(ValueError, match="divide evenly"):
        tsh.to_planes_sharded(tre.init_state(tsc.waters, tp, "cpu"), tp,
                              mesh)
    # the JAX package's words for it
    with pytest.raises(ValueError) as j:
        jsh.make_sharded_sprint_fn(P.small_test_params(**SMALL),
                                   jsh.make_walker_mesh(
                                       jax.devices("cpu")[:3]))
    with pytest.raises(ValueError) as t:
        tsh.make_sharded_sprint_fn(tp, mesh)
    assert str(t.value) == str(j.value)


def test_mesh_names_only_devices_the_machine_has():
    assert tsh.make_walker_mesh(["cpu"]).shape == {tsh.WALKER_AXIS: 1}
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA device"):
            tsh.make_walker_mesh(["cuda:0"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsh.make_walker_mesh()
    with pytest.raises(ValueError, match="at least one device"):
        tsh.make_walker_mesh([])


# -- the large-scene path, sharded ---------------------------------------------

@pytest.mark.parametrize("order", [3, 0])
def test_sharded_large_scene(order, monkeypatch):
    """tests/test_parallel.py TestShardedBigScene: every shard selects
    through the scene cache (its far table at order 3, the far sums at
    order 0) for its own walkers; walkers bitwise the unsharded run's.
    At order 3 also against JAX's single-device Pallas sprint with the
    same cache."""
    p = P.small_test_params(num_water=256, totaltime=0.0005,
                            sprint_steps=500, mmoment=3.5e-15,
                            cube_hash_dim=8, far_table_order=order)
    tp = _tp(p)
    sc = BacteriaBox(p, seed=3).populate()
    monkeypatch.setattr(cuda_engine, "REBUILD_MAX_MNPS", 0)
    monkeypatch.setattr(pe, "REBUILD_MAX_MNPS", 0)
    cache = None
    if order:
        mp = jnp.asarray(sc.mnps[:, :3], jnp.float32)
        mM = jnp.asarray(sc.mnps[:, 4], jnp.float32)
        jcache = jexp.build_cache(mp, mM, p)
        cache = convert.scene_cache_from_numpy(
            np.asarray(jcache.payload), np.asarray(jcache.far_coeffs), "cpu")
    got = tsh.run_simulation_sharded_pallas(sc, tp, _mesh(8), seed=3,
                                            cache=cache)
    tbl = convert.mnp_table(sc.mnps, torch.float32, "cpu")
    sprint = cuda_engine.make_sprint_fn(tp, 256, "cpu")
    ss = cuda_engine.to_soa(tre.init_state(sc.waters, tp, "cpu"), tp)
    outs = []
    for _ in range(tp.t // tp.sprint_steps):
        ss, wins = sprint(tbl, convert.key_words(3), ss, cache=cache)
        outs.append(wins.numpy())
    ref = cuda_engine.from_soa(ss, 256)
    _assert_same_walkers(got[3], ref)
    np.testing.assert_allclose(got[1], np.concatenate(outs)[:, 0],
                               atol=WIN_TOL)
    if not order:
        return
    jsprint = pe.make_sprint_fn(p, 256, interpret=True)
    kk = jrng.key_from_seed(3)
    key_arr = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
    ps = pe.to_planes(jre.init_state(sc.waters, p), p)
    jw = []
    for _ in range(p.t // p.sprint_steps):
        ps, wins = jsprint(mp, mM, key_arr, ps, 0, jcache)
        jw.append(np.asarray(wins))
    jst = pe.from_planes(ps, 256)
    np.testing.assert_allclose(got[3].pos.numpy(), np.asarray(jst.pos),
                               atol=POS_TOL)
    np.testing.assert_allclose(got[1], np.concatenate(jw)[:, 0],
                               atol=WIN_TOL)


# -- the runner and the CLI -----------------------------------------------------

RUNNER = dict(num_water=64, totaltime=0.002, sprint_steps=500,
              mmoment=3.5e-15)


@pytest.mark.parametrize("engine,rng_impl", [("pallas", "threefry"),
                                             ("pallas", "hardware"),
                                             ("scan", "threefry")])
def test_runner_on_a_mesh_resumes_under_another(engine, rng_impl,
                                                tmp_path):
    """A run on 4 shards checkpointed after two sprints, resumed on 2
    shards, ends with the walkers of an uninterrupted unsharded run and
    its curve within 1e-3; the checkpoint is the gathered state."""
    tp = _tp(P.small_test_params(**RUNNER))
    kw = dict(scene_seed=3, seed=7, engine=engine, rng_impl=rng_impl)
    ref = sim.SimulationRunner(tp, device="cpu", **kw)
    _, rc, _, _ = ref.run(progress=False)
    ck = str(tmp_path / "ck.npz")
    a = sim.SimulationRunner(tp, mesh=_mesh(4), **kw)
    assert a.device == torch.device("cpu")
    _, c1, _, _ = a.run(checkpoint_path=ck, max_steps=1000, progress=False)
    assert a.state.pos.shape == (64, 3) and a.state.step == 1000
    b = sim.SimulationRunner(tp, mesh=_mesh(2), **kw)
    b.resume(ck)
    _, c2, _, stats = b.run(progress=False)
    _assert_same_walkers(b.state, ref.state)
    np.testing.assert_allclose(np.concatenate([c1, c2]), rc, atol=WIN_TOL)
    assert stats["steps"] == tp.t
    # and back to no mesh from a sharded checkpoint
    c = sim.SimulationRunner(tp, device="cpu", **kw)
    c.resume(ck)
    c.run(progress=False)
    _assert_same_walkers(c.state, ref.state)


def test_run_resilient_rebuilds_the_runner_on_its_mesh(tmp_path):
    """Elastic recovery on a mesh: faults at sprints 1 and 3, a
    checkpoint every sprint; each rebuilt runner shards over the same
    mesh and the run ends with the unsharded run's walkers and curve."""
    from mri_nanoparticle_simulation_tpu_torch.engine import resilience
    tp = _tp(P.small_test_params(**RUNNER))
    kw = dict(scene_seed=3, seed=7, rng_impl="threefry")
    ref = sim.SimulationRunner(tp, device="cpu", **kw)
    _, rc, _, _ = ref.run(progress=False)
    built = []

    def make_runner():
        built.append(sim.SimulationRunner(tp, mesh=_mesh(4), **kw))
        return built[-1]

    _, c, _, stats = resilience.run_resilient(
        make_runner, csv_path=str(tmp_path / "t2.csv"),
        checkpoint_path=str(tmp_path / "ck.npz"),
        checkpoint_every_sprints=1, drain_depth=1, max_retries=2,
        fault_hook=resilience.FaultInjector({1: 1, 3: 1}), progress=False)
    assert stats["recovery_attempts"] == 2 and len(built) == 3
    _assert_same_walkers(built[-1].state, ref.state)
    np.testing.assert_allclose(c, rc, atol=WIN_TOL)


def test_runner_refuses_sharded_grid_mode():
    tp = _tp(P.small_test_params(**RUNNER)).replace(field_mode="grid",
                                                    grid_n=8)
    with pytest.raises(ValueError, match="sharded grid-mode runs are not "
                                         "wired up"):
        sim.SimulationRunner(tp, engine="scan", mesh=_mesh(2),
                             check_coverage=False)
    with pytest.raises(ValueError, match="needs a device"):
        sim.SimulationRunner(tp, engine="scan")


CLI = ["--num-water", "64", "--totaltime", "0.002", "--chunk-steps", "1000",
       "--sprint-steps", "1000", "--device", "cpu", "--rng", "threefry"]


def test_cli_shard_walkers(tmp_path, capsys):
    """``--shard-walkers`` on the CPU: one shard (one device), the line
    the reference CLI prints, and the CSV of the unsharded run."""
    a, b = tmp_path / "a.csv", tmp_path / "b.csv"
    assert sim.main(CLI + ["--shard-walkers", "--out", str(a)]) == 0
    assert "Sharding walkers over 1 device(s)" in capsys.readouterr().err
    assert sim.main(CLI + ["--out", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()
    t, c = writer.read_t2_csv(str(a))
    assert len(t) == 2 and np.all(np.isfinite(c))


def test_cli_walker_shards_on_one_device(tmp_path):
    """``--ensemble 2 --walker-shards 2`` with one device: the
    reference's rule, raised before any run."""
    with pytest.raises(ValueError, match=r"walker_shards \(2\) must divide "
                                         r"the device count \(1\)"):
        sim.main(CLI + ["--ensemble", "2", "--walker-shards", "2",
                        "--out", str(tmp_path / "t.csv")])


# -- ensembles over a mesh ------------------------------------------------------

ENS = dict(num_water=32, totaltime=0.0005, sprint_steps=500)


@pytest.mark.parametrize("engine", ["pallas", "scan"])
def test_2d_ensemble_trials_are_their_standalone_runs(engine):
    """4 trials on a 2 x 2 (trials x walkers) mesh: each trial's walkers
    bitwise its trial in the one-device ensemble, its curve within 1e-3
    (tests/test_parallel.py TestEnsemble2D); on the chunk kernels also
    bitwise its standalone run (scene seed base + i, key run_seed + i;
    the scan engine's sums over the padded dipole table group their
    zeros otherwise)."""
    tp = _tp(P.small_test_params(**ENS))
    mesh = tens.make_trial_mesh(["cpu"] * 4, 2)
    assert mesh.shape == {tens.TRIAL_AXIS: 2, tsh.WALKER_AXIS: 2}
    kw = dict(base_seed=0, run_seed=50, engine=engine, device="cpu")
    _, cos, sin, st = tens.run_ensemble(tp, 4, mesh=mesh, walker_shards=2,
                                        **kw)
    _, rcos, rsin, rst = tens.run_ensemble(tp, 4, **kw)
    for f in ("pos", "in_cell", "phase", "phase_comp", "escapes",
              "coverage"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      getattr(rst, f).numpy(), err_msg=f)
    np.testing.assert_allclose(cos, rcos, atol=WIN_TOL)
    np.testing.assert_allclose(sin, rsin, atol=WIN_TOL)
    if engine == "scan":
        return
    for i in range(4):
        _, c, _, alone = cuda_engine.run_simulation(
            TBox(tp, seed=i).populate(), tp, seed=50 + i, device="cpu")
        for f in ("pos", "in_cell", "phase", "phase_comp"):
            np.testing.assert_array_equal(getattr(st, f)[i].numpy(),
                                          getattr(alone, f).numpy())
        np.testing.assert_allclose(cos[i], c, atol=WIN_TOL)


def test_trial_mesh_over_slots_equals_one_device():
    """3 trials over a 2-slot mesh (one padding trial, with the warning)
    are bitwise the trials of the one-device ensemble."""
    tp = _tp(P.small_test_params(**ENS))
    kw = dict(base_seed=0, run_seed=50, d_scales=[1.0, 0.25, 0.5],
              device="cpu")
    ref = tens.run_ensemble(tp, 3, **kw)
    with pytest.warns(UserWarning, match="1 extra padding"):
        got = tens.run_ensemble(tp, 3, mesh=tens.make_trial_mesh(
            ["cpu", "cpu"]), **kw)
    for a, b in zip(got[1:3], ref[1:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[3].pos.numpy(), ref[3].pos.numpy())


def test_sweeps_carry_walker_shards_and_mesh():
    tp = _tp(P.small_test_params(**ENS))
    mesh = tens.make_trial_mesh(["cpu"] * 2, 2)
    kw = dict(n_trials_each=2, base_seed=0, run_seed=50, device="cpu")
    _, ref = tens.run_parameter_sweep(tp, "D", [0.5, 1.0], **kw)
    _, got = tens.run_parameter_sweep(tp, "D", [0.5, 1.0], walker_shards=2,
                                      mesh=mesh, **kw)
    np.testing.assert_allclose(got, ref, atol=WIN_TOL)
    axes = {"D": [0.5, 1.0], "taucp": [0.0002, 0.0005]}
    _, ref = tens.run_parameter_grid(tp, axes, **kw)
    _, got = tens.run_parameter_grid(tp, axes, walker_shards=2, mesh=mesh,
                                     **kw)
    np.testing.assert_allclose(got, ref, atol=WIN_TOL)


def test_walker_shards_must_divide_the_walkers():
    tp = _tp(P.small_test_params(num_water=30, totaltime=0.0002,
                                 sprint_steps=200))
    with pytest.raises(ValueError, match="divide evenly"):
        tens.run_ensemble(tp, 2, walker_shards=4, device="cpu",
                          mesh=tens.make_trial_mesh(["cpu"] * 4, 4))


def _outcome(fn, *args):
    """(trial slots, walker shards or None, padded count, warnings) or
    the error's message."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        try:
            mesh, padded = fn(*args)
        except ValueError as e:
            return str(e)
    return (mesh.shape[jens.TRIAL_AXIS],
            dict(mesh.shape).get(jsh.WALKER_AXIS), padded,
            [str(x.message) for x in w])


@pytest.mark.parametrize("n_trials", range(1, 13))
def test_trial_mesh_right_sizing_matches_jax(n_trials):
    assert len(jax.devices()) == 8
    cpus = [torch.device("cpu")] * 8
    assert _outcome(tens._trial_mesh, n_trials, None, cpus) == \
        _outcome(jens._trial_mesh, n_trials, None)
    jmesh = Mesh(np.asarray(jax.devices()[:3]), (jens.TRIAL_AXIS,))
    assert _outcome(tens._trial_mesh, n_trials,
                    tens.make_trial_mesh(cpus[:3]), cpus) == \
        _outcome(jens._trial_mesh, n_trials, jmesh)


@pytest.mark.parametrize("walker_shards", [2, 3, 4, 8])
def test_trial_mesh_2d_matches_jax(walker_shards, monkeypatch):
    """``_trial_mesh_2d`` on 8 devices, then the two refusals of a
    caller's mesh, against the JAX package's (which reads its 8 virtual
    devices; the port is handed 8 CPU entries)."""
    cpus = [torch.device("cpu")] * 8
    for n in (1, 3, 5, 8):
        assert _outcome(tens._trial_mesh_2d, n, walker_shards, None,
                        cpus) == \
            _outcome(jens._trial_mesh_2d, n, walker_shards, None)
    if 8 % walker_shards:
        return
    jdevs = np.asarray(jax.devices()[:8])
    j2 = Mesh(jdevs.reshape(-1, walker_shards),
              (jens.TRIAL_AXIS, jsh.WALKER_AXIS))
    t2 = tens.make_trial_mesh(cpus, walker_shards)
    assert _outcome(tens._trial_mesh_2d, 3, walker_shards, t2, cpus) == \
        _outcome(jens._trial_mesh_2d, 3, walker_shards, j2)
    other = 2 if walker_shards != 2 else 4
    assert _outcome(tens._trial_mesh_2d, 3, other, t2, cpus) == \
        _outcome(jens._trial_mesh_2d, 3, other, j2)
    j1 = Mesh(jdevs, (jens.TRIAL_AXIS,))
    assert _outcome(tens._trial_mesh_2d, 3, walker_shards,
                    tens.make_trial_mesh(cpus), cpus) == \
        _outcome(jens._trial_mesh_2d, 3, walker_shards, j1)

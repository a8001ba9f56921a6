"""The port's checkpoints (``io/checkpoint.py`` and
``SimulationRunner.resume``) against the JAX package's.

* The file: the same ``.npz`` keys, dtypes and shapes as the JAX
  package's ``save_checkpoint`` writes, atomic, with the identity tags
  ``engine="pallas"`` and ``rng_impl`` "threefry" / "philox4x32".
* Across the packages, on Threefry: a JAX Pallas-engine (interpret mode)
  checkpoint resumes in the port and a port checkpoint in JAX's
  ``SimulationRunner``; the finished run within the tolerances of
  tests/test_pallas.py:34-36 (positions 5e-6, window sums 1e-3) of the
  other package's uninterrupted run, and the CSV times byte for byte.
* Refusals, each a ValueError naming what differs: each package refuses
  the other's fast-generator checkpoint (the port's Philox4x32 is not
  the TPU hardware stream) and a scan-engine one; other params, seeds
  or scenes.
* Decompose states: a Pallas checkpoint stores (A, comp_A) / (B,
  comp_B); the port reads and writes that layout (``convert``'s
  ``state_from_planes`` is the witness).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu import params as JP
from mri_nanoparticle_simulation_tpu.engine import pallas_engine as pe
from mri_nanoparticle_simulation_tpu.engine import reference_engine as jre
from mri_nanoparticle_simulation_tpu.engine import sim as jsim
from mri_nanoparticle_simulation_tpu.io import checkpoint as jck
from mri_nanoparticle_simulation_tpu_torch.engine import convert, sim
from mri_nanoparticle_simulation_tpu_torch.engine.reference_engine import \
    WalkerState, init_state
from mri_nanoparticle_simulation_tpu_torch.io import checkpoint as ck
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox as TBox

torch.set_num_threads(1)

POS_TOL = 5e-6     # tests/test_pallas.py:34-36
WIN_TOL = 1e-3


def _tp(p):
    return convert.params_from_fields(dataclasses.asdict(p))


def _jp():
    # 2000 steps in 4 sprints; the checkpoint after the second
    return JP.small_test_params(sprint_steps=500)


def _port_runner(p, rng_impl="threefry", **kw):
    return sim.SimulationRunner(_tp(p), scene_seed=3, seed=2, device="cpu",
                                rng_impl=rng_impl, **kw)


def _jax_runner(p, rng_impl="threefry", engine="pallas"):
    return jsim.SimulationRunner(p, scene_seed=3, seed=2, engine=engine,
                                 rng_impl=rng_impl,
                                 interpret=engine == "pallas")


def _rows(path):
    return np.array([ln.split(",") for ln in
                     open(path).read().splitlines()], float)


def _assert_runs_close(path, state, ref_path, ref_pos):
    got, ref = _rows(path), _rows(ref_path)
    assert got.shape == ref.shape
    assert [ln.split(",")[0] for ln in open(path).read().splitlines()] == \
        [ln.split(",")[0] for ln in open(ref_path).read().splitlines()]
    np.testing.assert_allclose(got[:, 1:], ref[:, 1:], rtol=0, atol=WIN_TOL)
    np.testing.assert_allclose(state.pos.numpy(), np.asarray(ref_pos),
                               rtol=0, atol=POS_TOL)


@pytest.fixture(scope="module")
def jax_full(tmp_path_factory):
    """JAX's uninterrupted Pallas run (interpret mode) and its CSV."""
    d = tmp_path_factory.mktemp("jax_full")
    r = _jax_runner(_jp())
    r.run(csv_path=str(d / "full.csv"), progress=False)
    return str(d / "full.csv"), np.asarray(r.state.pos)


def test_file_matches_the_jax_format(tmp_path):
    """Key by key: the same names, dtypes and shapes as the JAX
    package's file of the same state; no temp file is left."""
    p = _jp()
    sc = TBox(_tp(p), seed=3).populate()
    tstate = init_state(sc.waters, _tp(p), "cpu")
    jstate = jre.init_state(sc.waters, p)
    ck.save_checkpoint(str(tmp_path / "t.npz"), tstate, _tp(p), 2, 3,
                       engine=ck.ENGINE_TAG, rng_impl=ck.rng_tag("hardware"),
                       scene_fp=ck.scene_fingerprint(sc), extra={"r": 4})
    jck.save_checkpoint(str(tmp_path / "j.npz"), jstate, p, 2, 3,
                        engine="pallas", rng_impl="hardware",
                        scene_fp=jck.scene_fingerprint(sc), extra={"r": 4})
    with np.load(tmp_path / "t.npz") as zt, np.load(tmp_path / "j.npz") as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            if k == "rng_impl":          # a string of another length
                assert zt[k].dtype.kind == zj[k].dtype.kind == "U"
                continue
            assert zt[k].dtype == zj[k].dtype and \
                zt[k].shape == zj[k].shape, k
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
        assert str(zt["rng_impl"]) == "philox4x32"
        assert str(zt["engine"]) == "pallas"
    assert ck.load_extra(str(tmp_path / "t.npz")) == \
        jck.load_extra(str(tmp_path / "j.npz"))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_jax_threefry_checkpoint_resumes_in_the_port(tmp_path, jax_full):
    full_csv, full_pos = jax_full
    p = _jp()
    csv, ckpt = str(tmp_path / "t2.csv"), str(tmp_path / "ck.npz")
    _jax_runner(p).run(csv_path=csv, checkpoint_path=ckpt,
                       checkpoint_every_sprints=1, max_steps=p.t // 2,
                       progress=False)
    with np.load(ckpt) as z:
        assert int(z["step"]) == p.t // 2 and str(z["engine"]) == "pallas"
    r = _port_runner(p)
    r.resume(ckpt)
    assert r.state.step == p.t // 2
    r.run(csv_path=csv, progress=False)
    _assert_runs_close(csv, r.state, full_csv, full_pos)


def test_port_threefry_checkpoint_resumes_in_jax(tmp_path):
    p = _jp()
    full = _port_runner(p)
    full.run(csv_path=str(tmp_path / "full.csv"), progress=False)
    csv, ckpt = str(tmp_path / "t2.csv"), str(tmp_path / "ck.npz")
    _port_runner(p).run(csv_path=csv, checkpoint_path=ckpt,
                        checkpoint_every_sprints=1, max_steps=p.t // 2,
                        progress=False)
    j = _jax_runner(p)
    j.resume(ckpt)
    assert int(np.asarray(j.state.step)) == p.t // 2
    j.run(csv_path=csv, progress=False)
    state = WalkerState(torch.tensor(np.array(j.state.pos)), *[None] * 6)
    _assert_runs_close(csv, state, str(tmp_path / "full.csv"),
                       full.state.pos.numpy())


def test_port_resume_is_bitwise(tmp_path):
    """Port to port: a run checkpointed, resumed in a new runner and
    finished equals the uninterrupted run, bytes and state."""
    p = _jp()
    full = _port_runner(p)
    full.run(csv_path=str(tmp_path / "full.csv"), progress=False)
    csv, ckpt = str(tmp_path / "t2.csv"), str(tmp_path / "ck.npz")
    _port_runner(p).run(csv_path=csv, checkpoint_path=ckpt,
                        checkpoint_every_sprints=1, max_steps=p.t // 2,
                        progress=False)
    r = _port_runner(p)
    r.resume(ckpt)
    r.run(csv_path=csv, checkpoint_path=ckpt, progress=False)
    assert open(csv).read() == open(tmp_path / "full.csv").read()
    for a, b in zip(r.state, full.state):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    with np.load(ckpt) as z:          # the end state is saved too
        assert int(z["step"]) == p.t


def _save_jax(path, p, rng_impl, engine="pallas"):
    sc = TBox(_tp(p), seed=3).populate()
    jck.save_checkpoint(path, jre.init_state(sc.waters, p), p, 2, 3,
                        engine=engine, rng_impl=rng_impl,
                        scene_fp=jck.scene_fingerprint(sc))


@pytest.mark.parametrize("rng_impl", ["threefry", "hardware"])
def test_port_refuses_jax_fast_generator_checkpoint(tmp_path, rng_impl):
    p = _jp()
    path = str(tmp_path / "j.npz")
    _save_jax(path, p, "hardware")
    with pytest.raises(ValueError, match="rng_impl='hardware'.*"
                       "rng_impl='(threefry|philox4x32)'"):
        _port_runner(p, rng_impl).resume(path)


@pytest.mark.parametrize("rng_impl", ["threefry", "hardware"])
def test_jax_refuses_port_fast_generator_checkpoint(tmp_path, rng_impl):
    p = _jp()
    path = str(tmp_path / "t.npz")
    _port_runner(p, "hardware").run(checkpoint_path=path,
                                    max_steps=p.sprint_steps,
                                    progress=False)
    with pytest.raises(ValueError, match="rng_impl='philox4x32'"):
        _jax_runner(p, rng_impl).resume(path)


def test_scan_checkpoints_refused_both_ways(tmp_path):
    p = _jp()
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    _save_jax(jpath, p, "threefry", engine="scan")
    with pytest.raises(ValueError, match="engine='scan'"):
        _port_runner(p).resume(jpath)
    _port_runner(p).run(checkpoint_path=tpath, max_steps=p.sprint_steps,
                        progress=False)
    with pytest.raises(ValueError, match="engine='pallas'"):
        _jax_runner(p, engine="scan").resume(tpath)


def test_port_refuses_other_params_seeds_and_scenes(tmp_path):
    p = _jp()
    path = str(tmp_path / "t.npz")
    _port_runner(p).run(checkpoint_path=path, max_steps=p.sprint_steps,
                        progress=False)
    with pytest.raises(ValueError, match="different parameters"):
        _port_runner(p.replace(taucp=0.001)).resume(path)
    r = sim.SimulationRunner(_tp(p), scene_seed=3, seed=5, device="cpu",
                             rng_impl="threefry")
    with pytest.raises(ValueError, match="checkpoint seeds"):
        r.resume(path)
    other = TBox(_tp(p), seed=4).populate()
    with pytest.raises(ValueError, match="different scene"):
        _port_runner(p, scene=other).resume(path)


def test_decompose_state_in_the_pallas_layout(tmp_path):
    """A decompose state's columns: the file holds (A, comp_A) / (B,
    comp_B) as the Pallas engine's, both ways."""
    p = _jp()
    rng = np.random.default_rng(0)
    w = p.num_water
    cols = rng.normal(size=(4, w)).astype(np.float32)   # A, cA, B, cB
    wp = pe.pad_count(w)
    pad = np.zeros((4, wp), np.float32)
    pad[:, :w] = cols
    r = wp // pe.LANES
    pos = rng.uniform(0, 8, size=(3, wp)).astype(np.float32)
    ps = pe.PlaneState(
        px=pos[0].reshape(r, -1), py=pos[1].reshape(r, -1),
        pz=pos[2].reshape(r, -1), in_cell=np.zeros((r, pe.LANES),
                                                   np.float32),
        phase=pad[:2].reshape(2, r, -1), phase_comp=pad[2:].reshape(2, r, -1),
        step=np.uint32(1000), escapes=np.int32(0), coverage=np.int32(0))
    jstate = pe.from_planes(ps, w)
    jpath = str(tmp_path / "j.npz")
    jck.save_checkpoint(jpath, jstate, p, 2, 3, engine="pallas",
                        rng_impl="threefry")
    got, _, _ = ck.load_checkpoint(jpath, _tp(p), "cpu", engine="pallas",
                                   rng_impl="threefry")
    want = convert.state_from_planes(ps, w, "cpu")
    assert torch.equal(got.phase, want.phase)
    assert torch.equal(got.phase_comp, want.phase_comp)
    np.testing.assert_array_equal(got.phase.numpy(), cols[[0, 2]].T)
    tpath = str(tmp_path / "t.npz")
    ck.save_checkpoint(tpath, got, _tp(p), 2, 3, engine="pallas",
                       rng_impl="threefry")
    back, _, _ = jck.load_checkpoint(tpath, p, engine="pallas",
                                     rng_impl="threefry")
    np.testing.assert_array_equal(np.asarray(back.phase),
                                  np.asarray(jstate.phase))
    np.testing.assert_array_equal(np.asarray(back.phase_comp),
                                  np.asarray(jstate.phase_comp))
    # a scan checkpoint keeps its (A, B) layout when the check is skipped
    spath = str(tmp_path / "s.npz")
    jck.save_checkpoint(spath, jstate, p, 2, 3, engine="scan",
                        rng_impl="threefry")
    scan, _, _ = ck.load_checkpoint(spath, _tp(p), "cpu")
    np.testing.assert_array_equal(scan.phase.numpy(),
                                  np.asarray(jstate.phase))

"""The port's durable decomposition writers
(``decompose.run_decomposition_durable``: a record store on disk with
checkpoint/resume; ``decompose.run_streaming_durable``: a streaming
plane snapshotted with its walkers) and their CLI (``--record-dir``,
``--stream-plane --checkpoint``).

* Port against port, bitwise: each durable case of
  tests/test_record_store.py (its sharded cases wait for the port's
  sharding): the durable run equals ``run_decomposition``, a crash and a
  re-run end with the same record (or plane) as an uninterrupted run,
  a complete store returns without a sprint, a mismatched identity or
  a checkpoint ahead of its store is refused; the CLI's files.
* Across the packages: a record store started by the JAX package
  (Pallas engine in interpret mode, Threefry) and killed by a
  ``FaultInjector`` is finished by the port, and a JAX stream-plane
  snapshot resumes in the port.  The finished record holds A within
  1e-5 and B within rtol 2e-6, atol 1e-7 of JAX's uninterrupted record
  (the bounds of tests/test_torch_decompose.py, which says why A's is
  wider: XLA contracts FMAs, the port does not); the plane's curves
  within 1e-5 (cos and sin of s*A + B move by at most s*|dA| + |dB|,
  s <= 1 here).  Each package refuses the other's fast-generator store.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu import params as JP
from mri_nanoparticle_simulation_tpu.engine import decompose as jdec
from mri_nanoparticle_simulation_tpu.engine.resilience import \
    FaultInjector as JFaultInjector
from mri_nanoparticle_simulation_tpu.io import checkpoint as jck
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox as JBox
from mri_nanoparticle_simulation_tpu_torch.engine import convert, sim
from mri_nanoparticle_simulation_tpu_torch.engine import decompose as dec
from mri_nanoparticle_simulation_tpu_torch.engine.resilience import \
    FaultInjector
from mri_nanoparticle_simulation_tpu_torch.io import record as record_mod
from mri_nanoparticle_simulation_tpu_torch.params import (
    params_fingerprint, small_test_params)
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox

torch.set_num_threads(1)

A_TOL = 1e-5
B_TOL = dict(rtol=2e-6, atol=1e-7)
CURVE_TOL = 1e-5
COUNTERS = ("steps", "escapes", "coverage_violations")


def _counters(stats):
    return {k: stats[k] for k in COUNTERS}


@pytest.fixture(scope="module")
def setup():
    # 6 sprints x 5 windows: sprint boundaries for mid-run faults,
    # checkpoints and record overhangs; the strong moment dephases the
    # curves within the short run (tests/test_record_store.py's fixture)
    p = small_test_params(num_water=64, mmoment=3.5e-13,
                          avoid_intracellular_throw=False,
                          sprint_steps=500, totaltime=0.003)
    return p, BacteriaBox(p, seed=3).populate()


def durable(sc, p, d, **kw):
    kw.setdefault("seed", 5)
    return dec.run_decomposition_durable(sc, p, d, device="cpu", **kw)


def plain(sc, p, **kw):
    return dec.run_decomposition(sc, p, seed=5, device="cpu", **kw)


class TestDurableRun:
    @pytest.mark.parametrize("rng_impl", ["threefry", "hardware"])
    def test_matches_plain_run(self, setup, tmp_path, rng_impl):
        p, sc = setup
        ref = plain(sc, p, rng_impl=rng_impl)
        res = durable(sc, p, str(tmp_path / "rec"), rng_impl=rng_impl,
                      checkpoint_path=str(tmp_path / "ck.npz"))
        np.testing.assert_array_equal(np.asarray(res.A), ref.A)
        np.testing.assert_array_equal(np.asarray(res.B), ref.B)
        assert _counters(res.stats) == _counters(ref.stats)
        np.testing.assert_allclose(res.times_ms, ref.times_ms)

    def test_complete_rerun_is_idempotent(self, setup, tmp_path):
        p, sc = setup
        d = str(tmp_path / "rec")
        r1 = durable(sc, p, d)
        r2 = durable(sc, p, d)
        np.testing.assert_array_equal(np.asarray(r1.A), np.asarray(r2.A))
        assert r2.stats == _counters(r1.stats)     # no sprint ran

    @pytest.mark.parametrize("rng_impl", ["threefry", "hardware"])
    def test_crash_resume_bitwise(self, setup, tmp_path, rng_impl):
        """Fault before sprint 4 with checkpoints every 2 sprints: the
        one-deep drain has committed sprints 0-2 but the last checkpoint
        covers sprints 0-1 (saved with sprint 1's rows), leaving one
        committed sprint of record overhang; the re-run trims it and
        ends bitwise equal to an uninterrupted run."""
        p, sc = setup
        ref = plain(sc, p, rng_impl=rng_impl)
        d, ckpt = str(tmp_path / "rec"), str(tmp_path / "ck.npz")
        hook = FaultInjector({4: 1})
        with pytest.raises(RuntimeError, match="injected fault"):
            durable(sc, p, d, rng_impl=rng_impl, checkpoint_path=ckpt,
                    checkpoint_every_sprints=2, fault_hook=hook)
        assert hook.faults_fired == 1
        st = record_mod.RecordStore.open(d)
        assert not st.complete
        wps = p.sprint_steps // p.pfreq
        assert st.rows == 3 * wps          # sprints 0-2 committed
        with np.load(ckpt) as z:
            assert int(z["step"]) == 2 * p.sprint_steps
        res = durable(sc, p, d, rng_impl=rng_impl, checkpoint_path=ckpt,
                      checkpoint_every_sprints=2)
        assert record_mod.RecordStore.open(d).complete
        np.testing.assert_array_equal(np.asarray(res.A), ref.A)
        np.testing.assert_array_equal(np.asarray(res.B), ref.B)
        assert _counters(res.stats) == _counters(ref.stats)
        assert res.stats["sprints"] == 4   # the resumed sprints only

    def test_restart_without_checkpoint(self, setup, tmp_path):
        """No checkpoint: a partial store restarts from scratch (rows
        truncated to 0) and still completes correctly."""
        p, sc = setup
        ref = plain(sc, p)
        d = str(tmp_path / "rec")
        with pytest.raises(RuntimeError):
            durable(sc, p, d, fault_hook=FaultInjector({2: 1}))
        res = durable(sc, p, d)
        np.testing.assert_array_equal(np.asarray(res.A), ref.A)

    def test_identity_mismatch_refused(self, setup, tmp_path):
        p, sc = setup
        d = str(tmp_path / "rec")
        with pytest.raises(RuntimeError):
            durable(sc, p, d, fault_hook=FaultInjector({2: 1}))
        with pytest.raises(ValueError, match="seed"):
            durable(sc, p, d, seed=6)
        with pytest.raises(ValueError, match="rng_impl"):
            durable(sc, p, d, rng_impl="hardware")
        with pytest.raises(ValueError, match="scene_fp"):
            durable(BacteriaBox(p, seed=4).populate(), p, d)

    def test_checkpoint_ahead_of_store_refused(self, setup, tmp_path):
        p, sc = setup
        d, ckpt = str(tmp_path / "rec"), str(tmp_path / "ck.npz")
        durable(sc, p, d, checkpoint_path=ckpt)
        st = record_mod.RecordStore.open(d, writable=True)
        st.truncate(2)
        with pytest.raises(ValueError, match="AHEAD"):
            durable(sc, p, d, checkpoint_path=ckpt)

    def test_incomplete_store_refused_by_readers(self, setup, tmp_path):
        p, sc = setup
        d = str(tmp_path / "rec")
        with pytest.raises(RuntimeError):
            durable(sc, p, d, fault_hook=FaultInjector({2: 1}))
        with pytest.raises(ValueError, match="incomplete"):
            dec.open_record(d)

    def test_store_feeds_the_record_readers(self, setup, tmp_path):
        """The store and the same record as a --dump-record .npz read the
        same way."""
        p, sc = setup
        d = str(tmp_path / "store")
        res = durable(sc, p, d)
        npz = str(tmp_path / "basis.npz")
        np.savez_compressed(npz, times_ms=res.times_ms,
                            A=np.asarray(res.A), B=np.asarray(res.B),
                            params_fp=params_fingerprint(p),
                            mmoment=p.mmoment, seed=5, taucp=p.taucp,
                            tau=p.tau, pfreq=p.pfreq)
        a1, b1, m1 = dec.open_record(d)
        a2, b2, m2 = dec.open_record(npz)
        np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
        np.testing.assert_array_equal(np.asarray(b1), np.asarray(b2))
        c1 = dec.reconstruct_record(d, [0.5, 2.0], taucps=[p.taucp])
        c2 = dec.reconstruct_record(npz, [0.5, 2.0], taucps=[p.taucp])
        np.testing.assert_array_equal(c1, c2)
        rp1, rp2 = dec.record_params(d), dec.record_params(npz)
        assert rp1.tcp == rp2.tcp == p.tcp and rp1.pfreq == p.pfreq
        b1 = dec.bootstrap_t2_record(d, n_boot=16, seed=1)
        b2 = dec.bootstrap_t2_record(npz, n_boot=16, seed=1)
        np.testing.assert_array_equal(b1.t2_samples, b2.t2_samples)


class TestStreamingDurable:
    def _plane(self, p, scales=(0.5, 1.0), taucps=None, echoes=()):
        return dec.StreamingPlane(p, p.t // p.pfreq, list(scales), taucps,
                                  quadrature=True, echo_pairs=echoes)

    def test_matches_consumer_run(self, setup, tmp_path):
        p, sc = setup
        ref = self._plane(p, echoes=[(1.0, p.taucp)])
        plain(sc, p, consumer=ref)
        plane = self._plane(p, echoes=[(1.0, p.taucp)])
        stats = dec.run_streaming_durable(
            sc, p, plane, str(tmp_path / "snap.npz"), seed=5, device="cpu")
        np.testing.assert_array_equal(plane.result(), ref.result())
        np.testing.assert_array_equal(plane.echo_matrix()[1],
                                      ref.echo_matrix()[1])
        assert stats["steps"] == p.t

    @pytest.mark.parametrize("rng_impl", ["threefry", "hardware"])
    def test_crash_resume_bitwise(self, setup, tmp_path, rng_impl):
        p, sc = setup
        ref = self._plane(p, echoes=[(1.0, p.taucp)])
        plain(sc, p, consumer=ref, rng_impl=rng_impl)
        snap = str(tmp_path / "snap.npz")
        plane = self._plane(p, echoes=[(1.0, p.taucp)])
        hook = FaultInjector({4: 1})
        with pytest.raises(RuntimeError, match="injected fault"):
            dec.run_streaming_durable(sc, p, plane, snap, seed=5,
                                      device="cpu", rng_impl=rng_impl,
                                      snapshot_every_sprints=2,
                                      fault_hook=hook)
        # a FRESH plane: the crashed one's state died with its process
        plane2 = self._plane(p, echoes=[(1.0, p.taucp)])
        dec.run_streaming_durable(sc, p, plane2, snap, seed=5,
                                  device="cpu", rng_impl=rng_impl,
                                  snapshot_every_sprints=2)
        np.testing.assert_array_equal(plane2.result(), ref.result())
        np.testing.assert_array_equal(plane2.echo_matrix()[1],
                                      ref.echo_matrix()[1])

    def test_config_mismatch_refused(self, setup, tmp_path):
        p, sc = setup
        snap = str(tmp_path / "snap.npz")
        with pytest.raises(RuntimeError):
            dec.run_streaming_durable(sc, p, self._plane(p), snap, seed=5,
                                      device="cpu",
                                      fault_hook=FaultInjector({3: 1}))
        other = self._plane(p, scales=(0.5, 2.0))   # another config
        with pytest.raises(ValueError, match="configuration"):
            dec.run_streaming_durable(sc, p, other, snap, seed=5,
                                      device="cpu")
        stale = self._plane(p)
        stale.update(np.zeros((1, 64), np.float32),
                     np.zeros((1, 64), np.float32))
        os.unlink(snap)
        with pytest.raises(ValueError, match="fresh"):
            dec.run_streaming_durable(sc, p, stale,
                                      str(tmp_path / "none.npz"), seed=5,
                                      device="cpu")

    def test_complete_rerun_noop(self, setup, tmp_path):
        p, sc = setup
        snap = str(tmp_path / "snap.npz")
        plane = self._plane(p)
        dec.run_streaming_durable(sc, p, plane, snap, seed=5, device="cpu")
        plane2 = self._plane(p)
        stats = dec.run_streaming_durable(sc, p, plane2, snap, seed=5,
                                          device="cpu")
        np.testing.assert_array_equal(plane2.result(), plane.result())
        assert stats["steps"] == p.t and stats["sprints"] == 0


# -- the CLI -------------------------------------------------------------------

CLI = ["--num-water", "32", "--num-cells", "8", "--totaltime", "0.002",
       "--sprint-steps", "1000", "--chunk-steps", "100", "--near-k", "6",
       "--taucp", "0.001", "--hash-dim", "8", "--mmoment", "3.5e-13",
       "--rng", "threefry", "--scene-seed", "3", "--seed", "5",
       "--moment-scales", "1,2", "--device", "cpu"]


def _read(path):
    with open(path) as f:
        return f.read()


class TestCli:
    def test_record_dir_roundtrip(self, tmp_path):
        """--record-dir writes the CSVs of --dump-record, and a second
        invocation (complete store) writes them again without a run."""
        assert sim.main(CLI + ["--out", str(tmp_path / "dump.csv"),
                               "--dump-record",
                               str(tmp_path / "basis.npz")]) == 0
        d, ckpt = str(tmp_path / "store"), str(tmp_path / "ck.npz")
        dur = ["--record-dir", d, "--checkpoint", ckpt,
               "--checkpoint-every", "1"]
        assert sim.main(CLI + dur + ["--out", str(tmp_path / "dur.csv")]) \
            == 0
        for s in ("1", "2"):
            assert _read(tmp_path / f"dump_mscale={s}.csv") == \
                _read(tmp_path / f"dur_mscale={s}.csv")
        with np.load(tmp_path / "basis.npz") as z:
            a, b = record_mod.RecordStore.open(d).arrays()
            np.testing.assert_array_equal(a, z["A"])
            np.testing.assert_array_equal(b, z["B"])
        assert sim.main(CLI + dur + ["--out", str(tmp_path / "dur2.csv")]) \
            == 0
        assert _read(tmp_path / "dur_mscale=2.csv") == \
            _read(tmp_path / "dur2_mscale=2.csv")

    def test_record_dir_rerun_after_a_death_finishes_the_store(self,
                                                               tmp_path):
        """A store left by a run that died after its first sprint (the
        CLI's own configuration through the API and a fault) is finished
        by the same CLI command, bitwise."""
        assert sim.main(CLI + ["--out", str(tmp_path / "dump.csv"),
                               "--dump-record",
                               str(tmp_path / "basis.npz")]) == 0
        ap = sim.build_parser()
        p = sim.params_from_args(ap, ap.parse_args(CLI))
        d, ckpt = str(tmp_path / "store"), str(tmp_path / "ck.npz")
        with pytest.raises(RuntimeError):
            durable(BacteriaBox(p, seed=3).populate(), p, d, scene_seed=3,
                    rng_impl="threefry", checkpoint_path=ckpt,
                    fault_hook=FaultInjector({1: 1}))
        assert record_mod.RecordStore.open(d).rows == 0
        assert not os.path.exists(ckpt)     # it died before one
        assert sim.main(CLI + ["--record-dir", d, "--checkpoint", ckpt,
                               "--out", str(tmp_path / "dur.csv")]) == 0
        for s in ("1", "2"):
            assert _read(tmp_path / f"dump_mscale={s}.csv") == \
                _read(tmp_path / f"dur_mscale={s}.csv")

    @pytest.mark.parametrize("bad", [
        ["--record-dir", "D"],                          # needs decomp mode
        ["--moment-scales", "1", "--record-dir", "D", "--dump-record",
         "x.npz"],
        ["--moment-scales", "1", "--record-dir", "D", "--stream-plane"],
        ["--moment-scales", "1", "--record-dir", "D", "--checkpoint-every",
         "2"]])                                         # needs --checkpoint
    def test_record_dir_arg_validation(self, tmp_path, bad, monkeypatch):
        monkeypatch.chdir(tmp_path)
        with pytest.raises(SystemExit):
            sim.main(bad + ["--device", "cpu"])

    def test_cli_stream_checkpoint(self, tmp_path):
        """--stream-plane --checkpoint: the CSVs of the plain
        --stream-plane run, and a re-run (complete snapshot) writes them
        again without a sprint."""
        base = CLI + ["--stream-plane"]
        assert sim.main(base + ["--out", str(tmp_path / "a.csv")]) == 0
        ckpt = str(tmp_path / "snap.npz")
        assert sim.main(base + ["--out", str(tmp_path / "b.csv"),
                                "--checkpoint", ckpt,
                                "--checkpoint-every", "1"]) == 0
        assert sim.main(base + ["--out", str(tmp_path / "c.csv"),
                                "--checkpoint", ckpt]) == 0
        for s in ("1", "2"):
            a = _read(tmp_path / f"a_mscale={s}.csv")
            assert a == _read(tmp_path / f"b_mscale={s}.csv") == \
                _read(tmp_path / f"c_mscale={s}.csv")


# -- across the packages -------------------------------------------------------

def _cross():
    # tests/test_torch_decompose.py's fixture (its A bound holds there):
    # walkers start in cells, a moment 570x the default; 4 sprints
    jp = JP.small_test_params(num_water=64, mmoment=2e-14,
                              avoid_intracellular_throw=False,
                              sprint_steps=500)
    return jp, convert.params_from_fields(dataclasses.asdict(jp)), \
        JBox(jp, seed=3).populate()


@pytest.fixture(scope="module")
def jax_record():
    jp, _, sc = _cross()
    return jdec.run_decomposition(sc, jp, seed=5, engine="pallas",
                                  interpret=True)


def test_jax_started_store_is_finished_by_the_port(tmp_path, jax_record):
    jp, tp, sc = _cross()
    d, ckpt = str(tmp_path / "rec"), str(tmp_path / "ck.npz")
    hook = JFaultInjector({3: 1})
    with pytest.raises(RuntimeError, match="injected fault"):
        jdec.run_decomposition_durable(
            sc, jp, d, seed=5, scene_seed=3, engine="pallas",
            interpret=True, checkpoint_path=ckpt, fault_hook=hook)
    wps = jp.sprint_steps // jp.pfreq
    assert record_mod.RecordStore.open(d).rows == 2 * wps
    with np.load(ckpt) as z:         # saved with sprint 1's rows
        assert int(z["step"]) == 2 * jp.sprint_steps
    res = dec.run_decomposition_durable(
        sc, tp, d, seed=5, scene_seed=3, device="cpu", rng_impl="threefry",
        checkpoint_path=ckpt)
    assert record_mod.RecordStore.open(d).complete
    A, B = np.asarray(res.A), np.asarray(res.B)
    assert A.shape == jax_record.A.shape
    np.testing.assert_allclose(A, jax_record.A, rtol=0, atol=A_TOL)
    np.testing.assert_allclose(B, jax_record.B, **B_TOL)
    # the rows JAX committed before the fault are the store's own
    port = dec.run_decomposition(sc, tp, seed=5, device="cpu")
    np.testing.assert_allclose(A, port.A, rtol=0, atol=A_TOL)
    for k in COUNTERS:
        assert res.stats[k] == jax_record.stats[k], k
    # and the JAX package reads the finished store as its own
    ja, jb, meta = jdec.open_record(d)
    np.testing.assert_array_equal(np.asarray(ja), A)
    assert meta["pfreq"] == jp.pfreq


def test_jax_stream_snapshot_resumes_in_the_port(tmp_path):
    jp, tp, sc = _cross()
    scales, echoes = [0.5, 1.0], [(1.0, jp.taucp)]

    def jplane():
        return jdec.StreamingPlane(jp, jp.t // jp.pfreq, scales,
                                   quadrature=True, echo_pairs=echoes)

    ref = jplane()
    jdec.run_decomposition(sc, jp, seed=5, engine="pallas", interpret=True,
                           consumer=ref)
    snap = str(tmp_path / "snap.npz")
    with pytest.raises(RuntimeError, match="injected fault"):
        jdec.run_streaming_durable(sc, jp, jplane(), snap, seed=5,
                                   scene_seed=3, engine="pallas",
                                   interpret=True,
                                   fault_hook=JFaultInjector({2: 1}))
    plane = dec.StreamingPlane(tp, tp.t // tp.pfreq, scales,
                               quadrature=True, echo_pairs=echoes)
    stats = dec.run_streaming_durable(sc, tp, plane, snap, seed=5,
                                      scene_seed=3, device="cpu")
    assert stats["sprints"] == 3     # sprint 0's snapshot, then 1-3
    np.testing.assert_allclose(plane.result(), ref.result(), rtol=0,
                               atol=CURVE_TOL)
    np.testing.assert_allclose(plane.echo_matrix()[1], ref.echo_matrix()[1],
                               rtol=0, atol=CURVE_TOL)


def test_fast_generator_stores_refused_both_ways(tmp_path):
    """A store's ``rng_impl``: the port's fast generator is
    "philox4x32", which the JAX package's "hardware" store is not."""
    jp, tp, sc = _cross()
    d = str(tmp_path / "port")
    with pytest.raises(RuntimeError):
        dec.run_decomposition_durable(sc, tp, d, seed=5, device="cpu",
                                      rng_impl="hardware",
                                      fault_hook=FaultInjector({1: 1}))
    assert record_mod.RecordStore.open(d).meta["rng_impl"] == "philox4x32"
    with pytest.raises(ValueError, match="rng_impl='philox4x32'"):
        jdec.run_decomposition_durable(sc, jp, d, seed=5, engine="pallas",
                                       rng_impl="hardware", interpret=True)
    # a JAX "hardware" store: the identity JAX's durable run writes
    dj = str(tmp_path / "jax")
    record_mod.RecordStore.create(dj, jp.t // jp.pfreq, jp.num_water, {
        "params_fp": jck.params_fingerprint(jp), "seed": 5,
        "scene_seed": 0, "engine": "pallas", "rng_impl": "hardware",
        "scene_fp": jck.scene_fingerprint(sc), "taucp": jp.taucp,
        "tau": jp.tau, "pfreq": jp.pfreq, "mmoment": jp.mmoment})
    with pytest.raises(ValueError, match="rng_impl='hardware'"):
        dec.run_decomposition_durable(sc, tp, dj, seed=5, device="cpu",
                                      rng_impl="hardware")


# -- over a walker mesh ----------------------------------------------------------

def _mesh(n):
    from mri_nanoparticle_simulation_tpu_torch.parallel import sharding
    return sharding.make_walker_mesh(["cpu"] * n)


class TestShardedDurable:
    """``run_decomposition_durable(mesh=...)`` (tests/test_record_store.py's
    sharded cases): 64 walkers over 4 shards of 16 (each shard padded on
    its own), the record bitwise the unsharded run's on both engines and
    both generators; the checkpoint holds the gathered state, so a run
    killed under one mesh resumes under another or under none."""

    @pytest.mark.parametrize("engine,rng_impl", [("pallas", "threefry"),
                                                 ("pallas", "hardware"),
                                                 ("scan", "threefry")])
    def test_sharded_record_bitwise(self, setup, tmp_path, engine,
                                    rng_impl):
        p, sc = setup
        ref = plain(sc, p, engine=engine, rng_impl=rng_impl)
        res = durable(sc, p, str(tmp_path / "rec"), engine=engine,
                      rng_impl=rng_impl, mesh=_mesh(4))
        np.testing.assert_array_equal(np.asarray(res.A), ref.A)
        np.testing.assert_array_equal(np.asarray(res.B), ref.B)
        assert _counters(res.stats) == _counters(ref.stats)

    @pytest.mark.parametrize("engine", ["pallas", "scan"])
    def test_killed_under_one_mesh_resumed_under_another(self, setup,
                                                         tmp_path, engine):
        p, sc = setup
        ref = plain(sc, p, engine=engine)
        d, ckpt = str(tmp_path / "rec"), str(tmp_path / "ck.npz")
        with pytest.raises(RuntimeError, match="injected fault"):
            durable(sc, p, d, engine=engine, checkpoint_path=ckpt,
                    fault_hook=FaultInjector({3: 1}), mesh=_mesh(4))
        with np.load(ckpt) as z:
            assert z["pos"].shape == (64, 3)          # the gathered state
        with pytest.raises(RuntimeError, match="injected fault"):
            durable(sc, p, d, engine=engine, checkpoint_path=ckpt,
                    fault_hook=FaultInjector({5: 1}), mesh=_mesh(2))
        res = durable(sc, p, d, engine=engine, checkpoint_path=ckpt)
        np.testing.assert_array_equal(np.asarray(res.A), ref.A)
        np.testing.assert_array_equal(np.asarray(res.B), ref.B)
        assert _counters(res.stats) == _counters(ref.stats)

    def test_mesh_refusals(self, setup, tmp_path):
        from mri_nanoparticle_simulation_tpu_torch.parallel import sharding
        p, sc = setup
        with pytest.raises(ValueError, match="must divide evenly over 3 "
                                             "walker shards"):
            durable(sc, p, str(tmp_path / "a"), mesh=_mesh(3))
        two = sharding.WalkerMesh((torch.device("cpu"),), rank=0,
                                  world_size=2)
        with pytest.raises(ValueError, match="run_decomposition_multihost"):
            durable(sc, p, str(tmp_path / "b"), mesh=two)


# -- the scan engine's writers across the packages -------------------------------

@pytest.fixture(scope="module")
def jax_scan_record():
    jp, _, sc = _cross()
    return jdec.run_decomposition(sc, jp, seed=5, engine="scan")


def test_scan_durable_matches_jax_scan_durable(tmp_path, jax_scan_record):
    """The store of ``engine="scan"`` against JAX's scan writer's: the
    same identity ("scan", Threefry), A and B within the decompose
    bounds, the same counters."""
    jp, tp, sc = _cross()
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jdec.run_decomposition_durable(sc, jp, jd, seed=5, scene_seed=3,
                                   engine="scan")
    res = dec.run_decomposition_durable(sc, tp, td, seed=5, scene_seed=3,
                                        engine="scan", device="cpu")
    jm = record_mod.RecordStore.open(jd).meta
    tm = record_mod.RecordStore.open(td).meta
    for k in ("params_fp", "engine", "rng_impl", "scene_fp", "seed"):
        assert tm[k] == jm[k], k
    np.testing.assert_allclose(np.asarray(res.A), jax_scan_record.A,
                               rtol=0, atol=A_TOL)
    np.testing.assert_allclose(np.asarray(res.B), jax_scan_record.B,
                               **B_TOL)
    for k in COUNTERS:
        assert res.stats[k] == jax_scan_record.stats[k], k


@pytest.mark.parametrize("first", ["jax", "port"])
def test_scan_store_crosses_the_packages(tmp_path, jax_scan_record, first):
    """A scan store (and its "scan" checkpoint, the [W, 2] layout) killed
    in one package is finished by the other."""
    jp, tp, sc = _cross()
    d, ckpt = str(tmp_path / "rec"), str(tmp_path / "ck.npz")
    with pytest.raises(RuntimeError, match="injected fault"):
        if first == "jax":
            jdec.run_decomposition_durable(
                sc, jp, d, seed=5, scene_seed=3, engine="scan",
                checkpoint_path=ckpt, fault_hook=JFaultInjector({3: 1}))
        else:
            dec.run_decomposition_durable(
                sc, tp, d, seed=5, scene_seed=3, engine="scan",
                device="cpu", checkpoint_path=ckpt,
                fault_hook=FaultInjector({3: 1}))
    with np.load(ckpt) as z:
        assert str(z["engine"]) == "scan" and z["phase"].shape == (64, 2)
    if first == "jax":
        res = dec.run_decomposition_durable(
            sc, tp, d, seed=5, scene_seed=3, engine="scan", device="cpu",
            checkpoint_path=ckpt)
    else:
        res = jdec.run_decomposition_durable(
            sc, jp, d, seed=5, scene_seed=3, engine="scan",
            checkpoint_path=ckpt)
    assert record_mod.RecordStore.open(d).complete
    np.testing.assert_allclose(np.asarray(res.A), jax_scan_record.A,
                               rtol=0, atol=A_TOL)
    np.testing.assert_allclose(np.asarray(res.B), jax_scan_record.B,
                               **B_TOL)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_scan_stream_snapshot_crosses_the_packages(tmp_path, first):
    jp, tp, sc = _cross()
    scales, echoes = [0.5, 1.0], [(1.0, jp.taucp)]

    def plane(mod, p):
        return mod.StreamingPlane(p, p.t // p.pfreq, scales,
                                  quadrature=True, echo_pairs=echoes)

    ref = plane(jdec, jp)
    jdec.run_decomposition(sc, jp, seed=5, engine="scan", consumer=ref)
    snap = str(tmp_path / "snap.npz")
    with pytest.raises(RuntimeError, match="injected fault"):
        if first == "jax":
            jdec.run_streaming_durable(sc, jp, plane(jdec, jp), snap,
                                       seed=5, scene_seed=3, engine="scan",
                                       fault_hook=JFaultInjector({2: 1}))
        else:
            dec.run_streaming_durable(sc, tp, plane(dec, tp), snap, seed=5,
                                      scene_seed=3, engine="scan",
                                      device="cpu",
                                      fault_hook=FaultInjector({2: 1}))
    if first == "jax":
        got = plane(dec, tp)
        dec.run_streaming_durable(sc, tp, got, snap, seed=5, scene_seed=3,
                                  engine="scan", device="cpu")
    else:
        got = plane(jdec, jp)
        jdec.run_streaming_durable(sc, jp, got, snap, seed=5, scene_seed=3,
                                   engine="scan")
    np.testing.assert_allclose(got.result(), ref.result(), rtol=0,
                               atol=CURVE_TOL)
    np.testing.assert_allclose(got.echo_matrix()[1], ref.echo_matrix()[1],
                               rtol=0, atol=CURVE_TOL)


def test_scan_crash_resume_bitwise(setup, tmp_path):
    """The port's scan store and snapshot, killed and run again: bitwise
    the uninterrupted run (as TestDurableRun / TestStreamingDurable for
    the kernels)."""
    p, sc = setup
    ref = plain(sc, p, engine="scan")
    d, ckpt = str(tmp_path / "rec"), str(tmp_path / "ck.npz")
    with pytest.raises(RuntimeError, match="injected fault"):
        durable(sc, p, d, engine="scan", checkpoint_path=ckpt,
                checkpoint_every_sprints=2, fault_hook=FaultInjector({4: 1}))
    res = durable(sc, p, d, engine="scan", checkpoint_path=ckpt,
                  checkpoint_every_sprints=2)
    np.testing.assert_array_equal(np.asarray(res.A), ref.A)
    np.testing.assert_array_equal(np.asarray(res.B), ref.B)
    snap = str(tmp_path / "snap.npz")
    planes = [dec.StreamingPlane(p, p.t // p.pfreq, [0.5, 1.0], None,
                                 quadrature=True) for _ in range(3)]
    plain(sc, p, engine="scan", consumer=planes[0])
    with pytest.raises(RuntimeError, match="injected fault"):
        dec.run_streaming_durable(sc, p, planes[1], snap, seed=5,
                                  device="cpu", engine="scan",
                                  fault_hook=FaultInjector({3: 1}))
    dec.run_streaming_durable(sc, p, planes[2], snap, seed=5, device="cpu",
                              engine="scan")
    np.testing.assert_array_equal(planes[2].result(), planes[0].result())

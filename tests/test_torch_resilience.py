"""The port's failure detection and elastic recovery
(``engine/resilience.py``), each case of tests/test_resilience.py on the
port's runner (on the CPU: the plain chunks), port against port.

The contract: a run that dies mid-flight (injected faults, hung drains,
a process killed between two invocations) and recovers through its
checkpoints writes a CSV bitwise equal to an uninterrupted run's.  Both
generators are counter-based (Threefry by step and lane, the fast one,
Philox4x32, by absolute step and lane), so the recovered bytes are equal
on either.
"""

import os
import time

import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu_torch import params as P
from mri_nanoparticle_simulation_tpu_torch.engine import resilience, sim
from mri_nanoparticle_simulation_tpu_torch.engine.reference_engine import \
    WalkerState
from mri_nanoparticle_simulation_tpu_torch.engine.sim import \
    SimulationRunner
from mri_nanoparticle_simulation_tpu_torch.io import checkpoint as ck
from mri_nanoparticle_simulation_tpu_torch.io import writer as writer_mod

torch.set_num_threads(1)


def tiny_params(**kw):
    # 2000 steps at sprint_steps=200 -> 10 sprints, pfreq=100 windows
    base = dict(sprint_steps=200)
    base.update(kw)
    return P.small_test_params(**base)


def runner(p, rng_impl="threefry"):
    return SimulationRunner(p, scene_seed=3, seed=4, device="cpu",
                            rng_impl=rng_impl)


def make_factory(p, rng_impl="threefry"):
    def make_runner():
        return runner(p, rng_impl)
    return make_runner


def read_lines(path):
    with open(path) as f:
        return f.readlines()


def base_csv(tmp_path, p, rng_impl="threefry", quadrature=False):
    path = str(tmp_path / "base.csv")
    runner(p, rng_impl).run(csv_path=path, quadrature=quadrature,
                            progress=False)
    return path


class TestWatchdog:
    def test_passes_result_through(self):
        assert resilience.watchdog_call(lambda: 41 + 1, 5.0) == 42

    def test_times_out(self):
        with pytest.raises(resilience.WatchdogTimeout, match="deadline"):
            resilience.watchdog_call(lambda: time.sleep(2.0), 0.1)

    def test_propagates_exceptions(self):
        def boom():
            raise ValueError("inner")
        with pytest.raises(ValueError, match="inner"):
            resilience.watchdog_call(boom, 5.0)


class TestFaultInjector:
    def test_fires_then_clears(self):
        inj = resilience.FaultInjector({2: 1})
        inj(0)
        inj(1)
        with pytest.raises(RuntimeError, match="sprint 2"):
            inj(2)
        inj(2)  # budget spent: the transient fault does not recur
        assert inj.faults_fired == 1


class TestTruncateRows:
    def test_trims_overhang(self, tmp_path):
        path = str(tmp_path / "t.csv")
        with open(path, "w") as f:
            f.writelines(f"{i},{i}\n" for i in range(10))
        assert writer_mod.truncate_rows(path, 7) == 3
        assert len(read_lines(path)) == 7

    def test_noop_when_short_or_missing(self, tmp_path):
        path = str(tmp_path / "t.csv")
        assert writer_mod.truncate_rows(path, 5) == 0
        with open(path, "w") as f:
            f.write("a\nb\n")
        assert writer_mod.truncate_rows(path, 5) == 0
        assert len(read_lines(path)) == 2


class TestElasticRecovery:
    @pytest.mark.parametrize("rng_impl", ["threefry", "hardware"])
    def test_recovered_csv_bitwise_equals_uninterrupted(self, tmp_path,
                                                        rng_impl):
        p = tiny_params()
        base = base_csv(tmp_path, p, rng_impl)
        rec_csv = str(tmp_path / "rec.csv")
        inj = resilience.FaultInjector({3: 1, 7: 1})
        _, cos, _, stats = resilience.run_resilient(
            make_factory(p, rng_impl), csv_path=rec_csv,
            checkpoint_path=str(tmp_path / "ck.npz"),
            checkpoint_every_sprints=2, drain_depth=1,
            max_retries=3, fault_hook=inj, progress=False)
        assert inj.faults_fired == 2
        assert stats["recovery_attempts"] == 2
        assert read_lines(rec_csv) == read_lines(base)
        # the re-read curve matches the file
        t, c = writer_mod.read_t2_csv(rec_csv)
        np.testing.assert_array_equal(cos, c)

    def test_csv_overhang_past_checkpoint_is_not_duplicated(self, tmp_path):
        # drain_depth=1 flushes every sprint but checkpoints only every
        # 4: the fault at sprint 6 leaves 6 sprints of rows on disk with
        # a checkpoint at sprint 4; the 2-sprint overhang must be
        # re-produced, not appended twice
        p = tiny_params()
        base = base_csv(tmp_path, p)
        rec_csv = str(tmp_path / "rec.csv")
        _, _, _, stats = resilience.run_resilient(
            make_factory(p), csv_path=rec_csv,
            checkpoint_path=str(tmp_path / "ck.npz"),
            checkpoint_every_sprints=4, drain_depth=1,
            max_retries=1, fault_hook=resilience.FaultInjector({6: 1}),
            progress=False)
        assert stats["recovery_attempts"] == 1
        lines = read_lines(rec_csv)
        assert lines == read_lines(base)
        times = np.array([float(ln.split(",")[0]) for ln in lines])
        assert np.all(np.diff(times) > 0)   # no duplicated windows

    def test_first_attempt_resume_returns_full_curve(self, tmp_path):
        """Process-death shape: run_resilient called FRESH with a
        checkpoint already on disk.  The returned arrays cover the whole
        run, not just the resumed tail."""
        p = tiny_params()
        base = base_csv(tmp_path, p)
        rec_csv = str(tmp_path / "rec.csv")
        ckpt = str(tmp_path / "ck.npz")
        resilience.run_resilient(
            make_factory(p), csv_path=rec_csv, checkpoint_path=ckpt,
            checkpoint_every_sprints=1, drain_depth=1, max_retries=1,
            progress=False, max_steps=p.t // 2)      # "process dies" here
        times, cos, _, stats = resilience.run_resilient(
            make_factory(p), csv_path=rec_csv, checkpoint_path=ckpt,
            checkpoint_every_sprints=1, drain_depth=1, max_retries=1,
            progress=False)
        assert stats["recovery_attempts"] == 0
        assert read_lines(rec_csv) == read_lines(base)
        t_base, c_base = writer_mod.read_t2_csv(base)
        np.testing.assert_array_equal(times, t_base)   # FULL axis
        np.testing.assert_array_equal(cos, c_base)

    def test_failure_before_any_checkpoint_restarts_clean(self, tmp_path):
        p = tiny_params()
        base = base_csv(tmp_path, p)
        rec_csv = str(tmp_path / "rec.csv")
        _, _, _, stats = resilience.run_resilient(
            make_factory(p), csv_path=rec_csv,
            checkpoint_path=str(tmp_path / "ck.npz"),
            checkpoint_every_sprints=2, drain_depth=1,
            max_retries=1, fault_hook=resilience.FaultInjector({0: 1}),
            progress=False)
        assert stats["recovery_attempts"] == 1
        assert read_lines(rec_csv) == read_lines(base)

    def test_gives_up_after_retries_without_progress(self, tmp_path):
        p = tiny_params()
        calls = []

        def counting_factory():
            calls.append(1)
            return runner(p)

        with pytest.raises(RuntimeError, match="injected fault"):
            resilience.run_resilient(
                counting_factory, csv_path=str(tmp_path / "r.csv"),
                checkpoint_path=str(tmp_path / "ck.npz"),
                checkpoint_every_sprints=1, max_retries=2,
                fault_hook=resilience.FaultInjector({0: 99}),
                progress=False)
        # initial attempt + max_retries retries, then give up
        assert len(calls) == 3

    def test_progress_refills_retry_budget(self, tmp_path):
        # three transient faults with progress between them survive a
        # max_retries=1 budget because each recovery advanced the
        # checkpoint
        p = tiny_params()
        _, _, _, stats = resilience.run_resilient(
            make_factory(p), csv_path=str(tmp_path / "r.csv"),
            checkpoint_path=str(tmp_path / "ck.npz"),
            checkpoint_every_sprints=1, drain_depth=1, max_retries=1,
            fault_hook=resilience.FaultInjector({2: 1, 4: 1, 6: 1}),
            progress=False)
        assert stats["recovery_attempts"] == 3
        assert stats["steps"] == p.t

    def test_requires_checkpointing(self):
        with pytest.raises(ValueError, match="csv_path"):
            resilience.run_resilient(lambda: None, None,
                                     checkpoint_path="x")
        with pytest.raises(ValueError, match="checkpoint_path"):
            resilience.run_resilient(lambda: None, "out.csv",
                                     max_retries=1)
        with pytest.raises(ValueError, match="checkpoint_every"):
            resilience.run_resilient(lambda: None, "out.csv",
                                     checkpoint_path="x",
                                     checkpoint_every_sprints=0)

    def test_torn_checkpoint_restarts_clean(self, tmp_path):
        """A corrupt checkpoint file is skipped with a warning: the
        attempt restarts from scratch instead of wedging recovery."""
        p = tiny_params()
        base = base_csv(tmp_path, p)
        ckpt = str(tmp_path / "ck.npz")
        with open(ckpt, "wb") as f:
            f.write(b"PK\x03\x04 definitely not a checkpoint")
        rec_csv = str(tmp_path / "rec.csv")
        _, _, _, stats = resilience.run_resilient(
            make_factory(p), csv_path=rec_csv, checkpoint_path=ckpt,
            checkpoint_every_sprints=2, drain_depth=1, max_retries=0,
            progress=False)
        assert stats["recovery_attempts"] == 0
        assert read_lines(rec_csv) == read_lines(base)
        # the run overwrote the torn file with a real checkpoint
        assert int(np.load(ckpt)["step"]) == p.t

    def test_failure_during_rebuild_consumes_budget(self, tmp_path):
        """Failures while building the fresh runner sit inside the
        recovery boundary."""
        p = tiny_params()
        state = {"built": 0}

        def flaky_factory():
            state["built"] += 1
            if state["built"] == 2:     # second build (first retry) dies
                raise RuntimeError("runtime still recovering")
            return runner(p)

        _, _, _, stats = resilience.run_resilient(
            flaky_factory, csv_path=str(tmp_path / "r.csv"),
            checkpoint_path=str(tmp_path / "ck.npz"),
            checkpoint_every_sprints=2, drain_depth=1, max_retries=2,
            fault_hook=resilience.FaultInjector({3: 1}),
            progress=False)
        assert state["built"] == 3
        assert stats["recovery_attempts"] == 2
        assert stats["steps"] == p.t

    def test_recovered_sin_is_nan_without_quadrature(self, tmp_path):
        """quadrature=False CSVs carry no sum-sin; after a recovery the
        returned sin is loudly absent (NaN), never silent zeros."""
        p = tiny_params()
        _, _, sin, stats = resilience.run_resilient(
            make_factory(p), csv_path=str(tmp_path / "r.csv"),
            checkpoint_path=str(tmp_path / "ck.npz"),
            checkpoint_every_sprints=2, drain_depth=1, max_retries=1,
            fault_hook=resilience.FaultInjector({5: 1}),
            progress=False)
        assert stats["recovery_attempts"] == 1
        assert np.all(np.isnan(sin))

    def test_quadrature_sin_survives_recovery(self, tmp_path):
        p = tiny_params()
        base = base_csv(tmp_path, p, quadrature=True)
        rec_csv = str(tmp_path / "rec.csv")
        _, _, sin, stats = resilience.run_resilient(
            make_factory(p), csv_path=rec_csv, quadrature=True,
            checkpoint_path=str(tmp_path / "ck.npz"),
            checkpoint_every_sprints=2, drain_depth=1, max_retries=1,
            fault_hook=resilience.FaultInjector({5: 1}),
            progress=False)
        assert stats["recovery_attempts"] == 1
        assert read_lines(rec_csv) == read_lines(base)
        assert np.all(np.isfinite(sin))

    def test_config_errors_are_fatal_not_retried(self, tmp_path):
        """A params-fingerprint mismatch (ValueError) does not burn the
        retry budget pretending to be a transient fault."""
        p = tiny_params()
        ckpt = str(tmp_path / "ck.npz")
        runner(tiny_params(num_water=128)).run(checkpoint_path=ckpt,
                                               progress=False)
        calls = []

        def factory():
            calls.append(1)
            return runner(p)

        with pytest.raises(ValueError, match="different parameters"):
            resilience.run_resilient(
                factory, csv_path=str(tmp_path / "r.csv"),
                checkpoint_path=ckpt, checkpoint_every_sprints=1,
                max_retries=5, progress=False)
        assert len(calls) == 1          # no retry loop on config errors

    def test_hung_drain_detected_and_recovered(self, tmp_path):
        # the first attempt's runner hangs on its first drain; the
        # watchdog turns the hang into a failure and the rebuilt runner
        # finishes
        p = tiny_params()
        base = base_csv(tmp_path, p)
        built = []

        def factory():
            r = runner(p)
            if not built:
                orig = r._fetch_pending
                r._fetch_pending = \
                    lambda pending: (time.sleep(3.0), orig(pending))[1]
            built.append(r)
            return r

        rec_csv = str(tmp_path / "rec.csv")
        _, _, _, stats = resilience.run_resilient(
            factory, csv_path=rec_csv,
            checkpoint_path=str(tmp_path / "ck.npz"),
            checkpoint_every_sprints=2, drain_depth=1, max_retries=1,
            drain_timeout_s=0.5, progress=False)
        assert stats["recovery_attempts"] == 1
        assert len(built) == 2
        assert read_lines(rec_csv) == read_lines(base)


CLI = ["--num-water", "64", "--num-cells", "8", "--totaltime", "0.002",
       "--taucp", "0.001", "--sprint-steps", "1000", "--chunk-steps",
       "100", "--rng", "threefry", "--device", "cpu"]


class TestCliValidation:
    def test_max_retries_requires_checkpoint(self):
        with pytest.raises(SystemExit):
            sim.main(["--max-retries", "2", "--num-water", "64",
                      "--device", "cpu"])

    def test_cli_resume_trims_overhang(self, tmp_path):
        """--resume after a crash trims rows written past the checkpoint
        before appending (the contract of run_resilient)."""
        csv = str(tmp_path / "t2.csv")
        ckpt = str(tmp_path / "ck.npz")
        args = CLI + ["--out", csv]
        assert sim.main(args + ["--checkpoint", ckpt,
                                "--checkpoint-every", "1"]) == 0
        lines = read_lines(csv)
        assert len(lines) == 2          # 2000 steps / pfreq 1000
        with open(csv, "a") as f:       # fake a crash-overhang row
            f.write("9.9,123\n")
        assert sim.main(args + ["--resume", ckpt]) == 0
        assert read_lines(csv) == lines  # overhang trimmed, none doubled

    def test_resume_requires_out(self):
        with pytest.raises(SystemExit):
            sim.main(["--resume", "ck.npz", "--num-water", "64",
                      "--device", "cpu"])

    def test_max_retries_requires_out(self):
        with pytest.raises(SystemExit):
            sim.main(["--max-retries", "2", "--checkpoint", "c.npz",
                      "--checkpoint-every", "1", "--num-water", "64",
                      "--device", "cpu"])

    def test_cli_max_retries_reruns_to_the_same_bytes(self, tmp_path):
        """The process-death contract of the CLI: a run stopped after
        its first checkpoint (here: the checkpoint and the rows it left)
        and run again with the same command ends with the bytes of an
        uninterrupted run."""
        base = str(tmp_path / "base.csv")
        assert sim.main(CLI + ["--out", base]) == 0
        csv = str(tmp_path / "t2.csv")
        ckpt = str(tmp_path / "ck.npz")
        args = CLI + ["--out", csv, "--checkpoint", ckpt,
                      "--checkpoint-every", "1", "--max-retries", "2",
                      "--drain-depth", "1"]
        r = SimulationRunner(_cli_params(CLI), device="cpu",
                             rng_impl="threefry")
        r.run(csv_path=csv, checkpoint_path=ckpt,
              checkpoint_every_sprints=1, max_steps=1000, progress=False)
        with open(csv, "a") as f:       # a row past the checkpoint
            f.write("0.002,1\n")
        assert sim.main(args) == 0
        assert read_lines(csv) == read_lines(base)


def _cli_params(argv):
    """The Params the CLI builds from ``argv``."""
    ap = sim.build_parser()
    return sim.params_from_args(ap, ap.parse_args(argv))


class TestAtomicCheckpoint:
    def test_no_temp_leftovers_and_roundtrip(self, tmp_path):
        p = tiny_params()
        st = WalkerState(pos=torch.zeros((4, 3)),
                         in_cell=torch.zeros(4, dtype=torch.bool),
                         phase=torch.zeros(4), phase_comp=torch.zeros(4),
                         step=7, escapes=torch.tensor(0),
                         coverage=torch.tensor(0))
        path = str(tmp_path / "c.npz")
        ck.save_checkpoint(path, st, p, 1, 2, engine="pallas",
                           rng_impl="threefry")
        st2, seed, ss = ck.load_checkpoint(path, p, "cpu", engine="pallas",
                                           rng_impl="threefry")
        assert st2.step == 7 and (seed, ss) == (1, 2)
        leftovers = [f for f in os.listdir(tmp_path)
                     if f.endswith(".tmp")]
        assert leftovers == []

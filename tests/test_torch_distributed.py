"""The port's runs over several processes (``parallel/distributed.py``)
on the CPU: two gloo processes, each driving two walker shards on the
CPU device (four global shards), against the one-process runs.

The ranks are this file run as a script (``__main__`` below), started
side by side with a rendezvous file in the test's temporary directory
(no TCP port to collide with other xdist workers) and a timeout, so a
hung rank fails its test instead of stalling the suite.  Each rank runs
every multi-process entry point once and saves what it returned:

* ``run_simulation_multihost`` on the chunk kernels (both generators)
  and the scan engine: the gathered walker state bitwise the
  one-process run's, the window sums within 1e-3
  (tests/test_pallas.py:34-36), escapes and coverage equal;
* ``run_decomposition_multihost`` (both engines): the record bitwise;
* ``run_plane_multihost``: curves within 1e-6 of the one-process plane,
  the echo matrices bitwise;
* ``run_ensemble_multihost`` (3 trials over 2 processes: an uneven
  split) and ``run_parameter_grid_multihost`` (2 x 2): the curves of
  ``run_ensemble`` / ``run_parameter_grid``, bitwise;

and both ranks return the same result.  Also: ``initialize`` is a no-op
in one process, a group asked for NCCL on a machine without it raises
(no fallback to gloo), the default devices raise without a card (no
fallback to the CPU), and unequal shard counts across processes are
refused.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mri_nanoparticle_simulation_tpu_torch.engine import (  # noqa: E402
    cuda_engine, reference_engine)
from mri_nanoparticle_simulation_tpu_torch.engine import \
    decompose as dec  # noqa: E402
from mri_nanoparticle_simulation_tpu_torch.params import \
    small_test_params  # noqa: E402
from mri_nanoparticle_simulation_tpu_torch.parallel import (  # noqa: E402
    distributed, ensemble, sharding)
from mri_nanoparticle_simulation_tpu_torch.scene import \
    BacteriaBox  # noqa: E402

torch.set_num_threads(1)

WIN_TOL = 1e-3
CURVE_TOL = 1e-6
TIMEOUT = 120
#: 64 walkers, 1000 steps in two sprints, flips every 200 steps (so the
#: plane has spin echoes), a moment 100x the default
PARAMS = dict(num_water=64, totaltime=0.001, sprint_steps=500,
              chunk_steps=100, taucp=0.0002, mmoment=3.5e-15)
SCALES = [0.5, 1.0]
TAUCPS = [0.0002, 0.0004]
ECHOES = [(1.0, 0.0002), (0.5, 0.0004)]
GRID = {"D": [0.5, 1.0], "taucp": [0.0002, 0.0004]}


def _setup():
    p = small_test_params(**PARAMS)
    return p, BacteriaBox(p, seed=5).populate()


def _results(mesh):
    """Every multi-process entry point once, on ``mesh``: a flat dict of
    arrays (the same keys from the one-process references below)."""
    p, sc = _setup()
    out = {}
    for name, kw in (("pallas", {}), ("fast", dict(rng_impl="hardware")),
                     ("scan", dict(engine="scan"))):
        _, c, s, st = distributed.run_simulation_multihost(
            sc, p, mesh, seed=3, **kw)
        out.update({f"sim_{name}_cos": c, f"sim_{name}_sin": s,
                    f"sim_{name}_pos": st.pos.numpy(),
                    f"sim_{name}_phase": st.phase.numpy(),
                    f"sim_{name}_counts": np.array(
                        [int(st.escapes), int(st.coverage)])})
    for engine in ("pallas", "scan"):
        r = distributed.run_decomposition_multihost(sc, p, mesh, seed=3,
                                                    engine=engine)
        out[f"dec_{engine}_A"], out[f"dec_{engine}_B"] = r.A, r.B
    _, curves, stats, echoes = distributed.run_plane_multihost(
        sc, p, SCALES, TAUCPS, mesh, seed=3, echo_pairs=ECHOES)
    out["plane"] = curves
    for i, e in enumerate(echoes):
        out[f"echo{i}"] = e.cos
    _, c, s = distributed.run_ensemble_multihost(p, 3, base_seed=0,
                                                 run_seed=50,
                                                 devices=["cpu"])
    out["ens_cos"], out["ens_sin"] = c, s
    _, g = distributed.run_parameter_grid_multihost(
        p, GRID, n_trials_each=1, base_seed=0, run_seed=50,
        quadrature=True, devices=["cpu"])
    out["grid"] = g
    return out


def _reference():
    """The one-process results of the same calls."""
    p, sc = _setup()
    out = {}
    for name, kw in (("pallas", {}), ("fast", dict(rng_impl="hardware"))):
        _, c, s, st = cuda_engine.run_simulation(sc, p, seed=3,
                                                 device="cpu", **kw)
        out[f"sim_{name}"] = (c, s, st)
    _, c, s, st = reference_engine.run_simulation(sc, p, seed=3,
                                                  device="cpu")
    out["sim_scan"] = (c, s, st)
    for engine in ("pallas", "scan"):
        out[f"dec_{engine}"] = dec.run_decomposition(
            sc, p, seed=3, engine=engine, device="cpu")
    out["plane"] = dec.run_plane_on_device(sc, p, SCALES, TAUCPS, seed=3,
                                           device="cpu", echo_pairs=ECHOES)
    out["ens"] = ensemble.run_ensemble(p, 3, base_seed=0, run_seed=50,
                                       device="cpu")
    out["grid"] = ensemble.run_parameter_grid(p, GRID, n_trials_each=1,
                                              base_seed=0, run_seed=50,
                                              quadrature=True, device="cpu")
    return out


def _start(args, tmp, tag):
    return subprocess.Popen(
        [sys.executable, __file__, *map(str, args)],
        stdout=open(tmp / f"{tag}.out", "w"), stderr=subprocess.STDOUT,
        cwd=REPO)


def _finish(procs, tmp, tags):
    """Wait for every rank (each within TIMEOUT), killing the rest when
    one fails or hangs; returns their exit codes and logs."""
    codes = []
    try:
        for pr in procs:
            codes.append(pr.wait(timeout=TIMEOUT))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    logs = [(tmp / f"{t}.out").read_text() for t in tags]
    return codes, logs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' saved results."""
    tmp = tmp_path_factory.mktemp("ranks")
    rdzv = tmp / "rdzv"
    procs = [_start(["run", r, 2, rdzv, tmp / f"rank{r}.npz"], tmp,
                    f"rank{r}") for r in range(2)]
    codes, logs = _finish(procs, tmp, ["rank0", "rank1"])
    assert codes == [0, 0], logs
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def reference():
    return _reference()


def test_ranks_return_the_same_result(ranks):
    assert sorted(ranks[0]) == sorted(ranks[1])
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


@pytest.mark.parametrize("name", ["pallas", "fast", "scan"])
def test_simulation_multihost_equals_one_process(ranks, reference, name):
    got = ranks[0]
    c, s, st = reference[f"sim_{name}"]
    np.testing.assert_array_equal(got[f"sim_{name}_pos"], st.pos.numpy())
    np.testing.assert_array_equal(got[f"sim_{name}_phase"],
                                  st.phase.numpy())
    np.testing.assert_allclose(got[f"sim_{name}_cos"], c, atol=WIN_TOL)
    np.testing.assert_allclose(got[f"sim_{name}_sin"], s, atol=WIN_TOL)
    assert got[f"sim_{name}_counts"].tolist() == [int(st.escapes),
                                                  int(st.coverage)]


@pytest.mark.parametrize("engine", ["pallas", "scan"])
def test_decomposition_multihost_record_bitwise(ranks, reference, engine):
    ref = reference[f"dec_{engine}"]
    np.testing.assert_array_equal(ranks[0][f"dec_{engine}_A"], ref.A)
    np.testing.assert_array_equal(ranks[0][f"dec_{engine}_B"], ref.B)


def test_plane_multihost_equals_one_process(ranks, reference):
    _, curves, _, echoes = reference["plane"]
    np.testing.assert_allclose(ranks[0]["plane"], curves, atol=CURVE_TOL)
    for i, e in enumerate(echoes):
        np.testing.assert_array_equal(ranks[0][f"echo{i}"], e.cos)


def test_ensemble_multihost_equals_one_process(ranks, reference):
    _, c, s, _ = reference["ens"]
    np.testing.assert_array_equal(ranks[0]["ens_cos"], c)
    np.testing.assert_array_equal(ranks[0]["ens_sin"], s)


def test_grid_multihost_equals_one_process(ranks, reference):
    np.testing.assert_array_equal(ranks[0]["grid"], reference["grid"][1])


def test_initialize_alone_is_a_no_op(monkeypatch):
    import torch.distributed as dist
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    distributed.initialize()
    distributed.initialize(num_processes=1)
    assert not dist.is_initialized()
    mesh = distributed.global_walker_mesh(["cpu", "cpu"])
    assert (mesh.world_size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.shape[sharding.WALKER_AXIS] == 2


def test_default_devices_raise_without_a_card(monkeypatch):
    """No fallback to the CPU: with no card visible, the default devices
    of the walker mesh and of the trial mesh raise
    (``utils.device.require_cuda``), while named CPU devices still make
    a mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for default in (distributed.global_walker_mesh,
                    lambda: distributed.local_trial_mesh(2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default()
    mesh = distributed.global_walker_mesh(["cpu"])
    assert [d.type for d in mesh.devices] == ["cpu"]
    assert mesh.shape[sharding.WALKER_AXIS] == 1
    trials = distributed.local_trial_mesh(2, devices=["cpu"])
    assert {d.type for row in trials.devices for d in row} == {"cpu"}


def test_nccl_without_it_raises(tmp_path):
    """Asked for NCCL where it cannot form, the group raises: nothing
    switches to gloo behind the caller's back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal needs none")
    pr = _start(["nccl", 0, 1, tmp_path / "rdzv", ""], tmp_path, "nccl")
    codes, logs = _finish([pr], tmp_path, ["nccl"])
    assert codes == [3], logs


def test_unequal_shard_counts_refused(tmp_path):
    procs = [_start(["unequal", r, 2, tmp_path / "rdzv", ""], tmp_path,
                    f"u{r}") for r in range(2)]
    codes, logs = _finish(procs, tmp_path, ["u0", "u1"])
    assert codes == [4, 4], logs


def _rank_main(case, rank, world, rdzv, out):
    """One rank of a test above: ``run`` saves every entry point's
    result; ``nccl`` exits 3 when the NCCL group refuses to form;
    ``unequal`` exits 4 when the mesh refuses rank 0's two shards beside
    rank 1's one.  A rank that joined the group meets the others at a
    barrier and leaves it before it exits, so no rank tears down a
    connection another still reads."""
    import torch.distributed as dist
    backend = "nccl" if case == "nccl" else "gloo"
    try:
        distributed.initialize(f"file://{rdzv}", world, rank,
                               backend=backend)
    except Exception as e:    # the refusal this case expects
        print(f"refused: {type(e).__name__}: {e}")
        return 3 if case == "nccl" else 1
    try:
        if case == "unequal":
            try:
                distributed.global_walker_mesh(["cpu"] * (2 - rank))
            except ValueError as e:
                print(e)
                return 4
            return 1
        mesh = distributed.global_walker_mesh(["cpu", "cpu"])
        assert mesh.shape[sharding.WALKER_AXIS] == 2 * world
        np.savez(out, **_results(mesh))
        return 0
    finally:
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                        sys.argv[4], sys.argv[5]))

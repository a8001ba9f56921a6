"""Runs over several processes, joined by ``torch.distributed``.

Counterpart of the reference's ``parallel/distributed.py`` (its dry runs
are not ported).  The processes form one process group; a walker mesh
(``global_walker_mesh``) numbers every process's shards globally, shard
``rank * local_shards + i`` on the process's ``i``-th device, and the
sharded sprints of ``sharding.py`` run unchanged on it: the per-window
sums and the counts cross the processes once a sprint, one all-reduce
of a few KB.  Trials (``run_ensemble_multihost``) split into contiguous
blocks, one a process, whose curves cross once at the end.

Under NCCL (one card a process) the sums stay on the cards; under gloo
(the CPU, or processes that share a card: NCCL refuses two ranks on
one card) they cross through host copies.  The backend is the group's
and never changes: a group that cannot form raises.

Every ``run_*_multihost`` returns the same complete result in every
process.  Usage, one process a card, the same program in each (e.g.
``torchrun --nproc-per-node N prog.py``, which sets ``RANK``,
``WORLD_SIZE`` and ``MASTER_ADDR``)::

    from mri_nanoparticle_simulation_tpu_torch.parallel import distributed
    distributed.initialize()              # from torchrun's environment
    mesh = distributed.global_walker_mesh()
    runner = SimulationRunner(params, mesh=mesh)
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import ensemble, sharding
from .sharding import WalkerMesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join this process to the group (idempotent).

    ``coordinator_address`` is ``host:port`` (``tcp://`` is prefixed) or
    a full ``init_method`` URL such as ``file:///path``; with none, the
    group forms from torch's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets them).  One
    process (no coordinator, ``num_processes`` None, 0 or 1 and no
    ``WORLD_SIZE`` above 1) is a no-op, so the same program runs alone.
    ``backend``: "nccl" (one card a process) or "gloo" (the CPU, or
    processes sharing a card); by default "nccl" when this process sees
    a card, else "gloo".  A group that cannot form raises."""
    if dist.is_initialized():
        return
    from_env = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if coordinator_address is None and num_processes in (None, 0, 1) \
            and not from_env:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    if coordinator_address is None:
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, **kw)


def _local_devices() -> list:
    """This process's devices by default: its card under NCCL (local
    rank), else every local card; raises without a card
    (``utils.device.require_cuda``).  The CPU is never a default: a CPU
    run names its devices."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        n = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % n))
        return [torch.device("cuda", local)]
    return sharding.local_devices("cuda")


def _world() -> WalkerMesh:
    """One shard a process on the collectives' device: the mesh the
    end-of-run gathers use."""
    if not dist.is_initialized():
        return WalkerMesh((torch.device("cpu"),))
    dev = _local_devices()[0] if dist.get_backend() == "nccl" \
        else torch.device("cpu")
    return WalkerMesh((dev,), dist.group.WORLD, dist.get_rank(),
                      dist.get_world_size())


def global_walker_mesh(devices=None) -> WalkerMesh:
    """The walker mesh over every process of the group: this process's
    ``devices`` (default ``_local_devices``) hold global shards ``rank *
    len(devices) ...``.  Every process must drive as many shards as the
    others.  Without a group, a one-process mesh."""
    local = [sharding.resolve_device(d) for d in
             (_local_devices() if devices is None else devices)]
    if not dist.is_initialized():
        return sharding.make_walker_mesh(local)
    if dist.get_backend() == "nccl":
        torch.cuda.set_device(local[0])
    mesh = WalkerMesh(tuple(local), dist.group.WORLD, dist.get_rank(),
                      dist.get_world_size())
    dev = local[0] if dist.get_backend() == "nccl" else torch.device("cpu")
    counts = sharding.gather_over_processes(
        torch.tensor([len(local)], device=dev), mesh)
    if int(counts.min()) != int(counts.max()):
        raise ValueError(f"every process must drive as many walker shards "
                         f"as the others; got {counts.tolist()}")
    return mesh


def _gather_host(arr: np.ndarray, world: WalkerMesh) -> np.ndarray:
    """The processes' ``arr`` (equal shapes) stacked on a new axis 0."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(world.devices[0])
    out = sharding.gather_over_processes(t[None], world)
    return out.cpu().numpy()


def run_simulation_multihost(scene, params, mesh: Optional[WalkerMesh] = None,
                             seed: int = 0, dtype=torch.float32,
                             max_steps: Optional[int] = None,
                             engine: str = "pallas",
                             rng_impl: str = "threefry", cache=None):
    """A walker-sharded run over the global mesh (default
    :func:`global_walker_mesh`): ``sharding.run_simulation_sharded_pallas``
    (the chunk kernels, the port's default engine) or
    ``run_simulation_sharded`` (``engine="scan"``).  Global lanes make
    every walker bitwise the one-process run's; the window sums are
    summed over the processes each sprint.  Every process returns the
    same (times_ms, sum_cos, sum_sin, gathered WalkerState)."""
    mesh = mesh or global_walker_mesh()
    if engine == "scan":
        return sharding.run_simulation_sharded(scene, params, mesh, seed,
                                               dtype, max_steps)
    if engine != "pallas":
        raise ValueError(f"unknown engine {engine!r}")
    return sharding.run_simulation_sharded_pallas(
        scene, params, mesh, seed, dtype, rng_impl, max_steps, cache)


def run_decomposition_multihost(scene, params,
                                mesh: Optional[WalkerMesh] = None,
                                seed: int = 0,
                                max_steps: Optional[int] = None,
                                engine: str = "pallas",
                                rng_impl: str = "threefry", cache=None):
    """A walker-sharded phase-decomposition run over the global mesh:
    each process drains its own shards' record blocks to its host, one
    sprint deep, and the whole record is assembled by ONE all-gather at
    the end.  Every walker's (A, B) series is bitwise the one-process
    ``decompose.run_decomposition`` record of the same engine.  Every
    process returns the same complete ``DecompositionResult``."""
    from ..engine import decompose as dec
    p = params.validate()
    mesh = mesh or global_walker_mesh()
    num_water = scene.waters.shape[0]
    sp = dec._decompose_sprints(scene, p, seed, None, rng_impl, cache,
                                engine, mesh)
    total = p.t if max_steps is None else min(p.t, max_steps)
    n_sprints = total // p.sprint_steps
    parts = []
    split = {"device_s": 0.0, "copy_s": 0.0, "host_s": 0.0}

    def commit(a_blk, b_blk, ss_i, i):
        parts.append(np.stack([a_blk, b_blk], -1))   # [n_win, local, 2]

    t0 = time.perf_counter()
    ss = dec._one_deep(sp, sp.state, range(n_sprints), commit, split)
    local_cols = num_water // mesh.world_size
    local = np.concatenate(parts) if parts \
        else np.zeros((0, local_cols, 2), np.float32)
    world = _world()
    if world.group is not None:
        # [P, n_win, local, 2] -> walker columns in rank order
        g = _gather_host(local, world)
        full = np.concatenate(list(g), axis=1)
    else:
        full = local
    wall = time.perf_counter() - t0
    n_windows = full.shape[0]
    times = (np.arange(1, n_windows + 1) * p.pfreq) * p.tau
    stats = {"steps": int(ss.step), "escapes": int(ss.escapes),
             "coverage_violations": int(ss.coverage), "wall_s": wall,
             **split}
    return dec.DecompositionResult(times_ms=times, A=full[..., 0],
                                   B=full[..., 1], stats=stats)


def run_plane_multihost(scene, params, scales, taucps=None,
                        mesh: Optional[WalkerMesh] = None, seed: int = 0,
                        engine: str = "pallas", rng_impl: str = "threefry",
                        echo_pairs=(), max_steps: Optional[int] = None,
                        cache=None):
    """The on-device (moment x taucp) plane over the global mesh:
    ``decompose.run_plane_on_device(mesh=...)``, whose sharded plane
    step sums the walker means over the processes each sprint; each
    process fills its own walkers' columns of the echo matrices, and ONE
    all-reduce at the end sums them (disjoint columns, so exactly).
    Every process returns what ``run_plane_on_device`` returns."""
    from ..engine import decompose as dec
    mesh = mesh or global_walker_mesh()
    times, curves, stats, echoes = dec.run_plane_on_device(
        scene, params, scales, taucps, seed=seed, engine=engine,
        rng_impl=rng_impl, max_steps=max_steps, echo_pairs=echo_pairs,
        cache=cache, mesh=mesh)
    world = _world()
    if world.group is not None and echoes:
        rows = np.cumsum([len(e.cos) for e in echoes])[:-1]
        mats = _gather_host(np.concatenate([e.cos for e in echoes]),
                            world).sum(axis=0)
        echoes = [e._replace(cos=m)
                  for e, m in zip(echoes, np.split(mats, rows))]
    return times, curves, stats, echoes


def local_trial_mesh(n_trials: int, walker_shards: int = 1, devices=None):
    """A right-sized trial mesh over THIS process's devices (default
    ``_local_devices``): a trial's whole run stays on one process, and
    only its curves cross processes.  ``walker_shards`` > 1 gives the
    (trials x walkers) mesh, the same right-sizing on the trial axis."""
    devs = [sharding.resolve_device(d) for d in
            (_local_devices() if devices is None else devices)]
    if walker_shards > 1:
        if len(devs) % walker_shards != 0 or walker_shards > len(devs):
            raise ValueError(
                f"walker_shards ({walker_shards}) must divide this "
                f"process's local device count ({len(devs)})")
        d, _ = ensemble.right_sized(n_trials, len(devs) // walker_shards)
        return ensemble.make_trial_mesh(devs[:d * walker_shards],
                                        walker_shards)
    d, _ = ensemble.right_sized(n_trials, len(devs))
    return ensemble.make_trial_mesh(devs[:d])


def run_ensemble_multihost(params, n_trials: int, base_seed: int = 0,
                           run_seed: int = 1000, engine: str = "pallas",
                           rng_impl: str = "threefry", dtype=torch.float32,
                           max_steps: Optional[int] = None, mmoments=None,
                           taucps=None, cell_rs=None, run_cell_rs=None,
                           d_scales=None, permeabilities=None,
                           scene_seeds=None, run_seeds=None,
                           walker_shards: int = 1, devices=None):
    """An ensemble split over the processes: trials [0, n_trials) in
    contiguous blocks, one a process, each block a
    ``ensemble.run_ensemble`` on the process's own devices (trial i keeps
    scene seed ``base_seed + i`` and run seed ``run_seed + i``, and its
    slice of every per-trial axis, so the split changes no trial), then
    ONE all-gather of the [T, n_windows] curves.  Every process returns
    the same (times_ms, sum_cos [n_trials, n], sum_sin [n_trials, n])."""
    axes = {"mmoments": mmoments, "taucps": taucps, "cell_rs": cell_rs,
            "run_cell_rs": run_cell_rs, "d_scales": d_scales,
            "permeabilities": permeabilities, "scene_seeds": scene_seeds,
            "run_seeds": run_seeds}
    for name, vals in axes.items():
        if vals is not None and len(vals) != n_trials:
            raise ValueError(f"{name} must have one value per trial "
                             f"([{n_trials}]), got {len(vals)}")
    world = _world()
    pid, n_proc = world.rank, world.world_size
    counts = [n_trials // n_proc + (i < n_trials % n_proc)
              for i in range(n_proc)]
    lo = sum(counts[:pid])
    mine = counts[pid]
    total = params.t if max_steps is None else min(params.t, max_steps)
    n_windows = (total // params.sprint_steps) * \
        (params.sprint_steps // params.pfreq)
    local = np.zeros((max(counts), n_windows, 2), np.float32)
    if mine:
        devs = _local_devices() if devices is None else list(devices)
        mesh = local_trial_mesh(mine, walker_shards, devs)
        _, cos, sin, _ = ensemble.run_ensemble(
            params, mine, mesh=mesh, base_seed=base_seed + lo,
            run_seed=run_seed + lo, engine=engine, rng_impl=rng_impl,
            dtype=dtype, max_steps=max_steps,
            walker_shards=walker_shards, device=mesh.devices[0][0],
            **{k: None if v is None else list(v[lo:lo + mine])
               for k, v in axes.items()})
        local[:mine, :, 0] = cos
        local[:mine, :, 1] = sin
    # every process (a trial-less one too) derives the same axis
    times = ensemble.window_times(params, n_windows)
    if world.group is not None:
        g = _gather_host(local, world)       # [P, max_count, n, 2]
        allw = np.concatenate([g[i, :counts[i]] for i in range(n_proc)])
    else:
        allw = local[:mine]
    return times, allw[..., 0], allw[..., 1]


def run_parameter_grid_multihost(params, axes: dict, n_trials_each: int = 1,
                                 base_seed: int = 0, run_seed: int = 1000,
                                 engine: str = "pallas",
                                 rng_impl: str = "threefry",
                                 dtype=torch.float32,
                                 max_steps: Optional[int] = None,
                                 paired: bool = False,
                                 quadrature: bool = False,
                                 walker_shards: int = 1, devices=None):
    """``ensemble.run_parameter_grid`` split over the processes: the grid
    points' trials in contiguous blocks (:func:`run_ensemble_multihost`),
    seeds by GLOBAL trial index, so every process returns the surface a
    one-process run gives, curves shaped [n1, ..., n_trials_each,
    n_windows] (``quadrature``: a trailing (cos, sin) axis)."""
    value_lists, combos, per_trial = ensemble.grid_per_trial(
        axes, n_trials_each, paired, base_seed, run_seed)
    if "P" in axes and not (params.reflect_io > 0 or params.reflect_oi > 0):
        # the reflect launch scalars need reflection compiled in
        params = params.with_permeability()
    times, cos, sin = run_ensemble_multihost(
        params, len(combos) * n_trials_each, base_seed=base_seed,
        run_seed=run_seed, engine=engine, rng_impl=rng_impl, dtype=dtype,
        max_steps=max_steps, walker_shards=walker_shards, devices=devices,
        **per_trial)
    flat = np.stack([cos, sin], -1) if quadrature else cos
    shape = [len(v) for v in value_lists] + [n_trials_each, -1] + \
        ([2] if quadrature else [])
    return times, flat.reshape(shape)

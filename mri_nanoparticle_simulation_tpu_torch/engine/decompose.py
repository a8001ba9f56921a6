"""Phase-decomposition runs: the whole (moment x echo-spacing) plane
from ONE simulation, on the card.

Walker trajectories never depend on the dipole moment: diffusion,
membrane reflection and cell residency are functions of the random
stream and the scene geometry alone.  The moment enters only through the
per-step field kick, linearly, and Carr-Purcell flips are sign changes.
So every walker's phase is exactly linear in a global moment scale s:

    phase_i(t; s) = s * A_i(t) + B_i(t)

with A the accumulated dipole-field phase at the base moments and B the
accumulated intracellular (and gradient) kick phase.  One run that
records per-walker (A, B) at each output window gives the T2 curve at
any moment scale, ``m(t; s) = mean_i cos(s * A_i(t) + B_i(t))``, where
the reference reran (about 14 minutes on its K40) per value.  The echo
axis falls out of the same record: a flip only multiplies the
accumulated phase by -1 at a window boundary, so the raw per-window
increments are recoverable (``window_increments``) and any taucp aligned
to the output interval is one cumulative sum away
(``reconstruct_curves``, ``curves_at_plane``, ``StreamingPlane``).

Counterpart of the reference's ``engine/decompose.py`` on its record
and on-device plane paths: ``run_decomposition`` drives the chunk
kernels in decompose mode (``cuda_engine.make_sprint_fn(...,
decompose=True)``), or the scan engine's decompose sprint
(``engine="scan"``), and drains the per-walker record to the host;
``run_plane_on_device`` runs the same sprints and folds each record into
the plane on the device (``make_plane_step``: a kernel on the card,
plain torch on the CPU), so only the curves and the spin-echo captures
(``EchoCapture``) come back.
``run_decomposition_durable`` (a record store on disk) and
``run_streaming_durable`` (a streaming plane) checkpoint as they go and,
run again after a crash, resume to the same bits.  The
reconstruction functions, the record readers (``open_record``,
``record_params``, ``reconstruct_record``) and the walker bootstrap are
the reference's float64 NumPy code carried over as it is, and
``curves_at_scales`` runs in torch float32 on the record's device.
"""

from __future__ import annotations

import os
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import analysis
from ..io import writer as writer_mod
from ..params import Params
from ..utils import profiling
from ..utils.device import require_cuda
from . import chunk_kernel, reference_engine
from .convert import key_words, mnp_table
from .cuda_engine import from_soa, make_sprint_fn, to_soa
from .reference_engine import ENGINES, init_state


class DecompositionResult(NamedTuple):
    times_ms: np.ndarray   #: [n] window end times, ms
    A: np.ndarray          #: [n, W] dipole-field phase at the base moments
    B: np.ndarray          #: [n, W] kick phase (moment-independent)
    stats: dict            #: escapes / coverage_violations / steps, and
    #: the run's time split (see run_decomposition)


def _unpack_wins(wins: np.ndarray, num_water: int):
    """One sprint's record ``[n_win, 2, W_pad]`` -> ([n_win, W] A,
    [n_win, W] B) with the padding walkers stripped."""
    return wins[:, 0, :num_water], wins[:, 1, :num_water]


def _unpack_wins_sharded(wins, local_w: int):
    """:func:`_unpack_wins` of a sharded sprint's records, one a shard
    (``[n_win, 2, W']``, each padded on its own): each stripped to its
    ``local_w`` walkers, then laid side by side in shard order.  A plain
    reshape of the shards' concatenation would put padding walkers
    among the walker columns."""
    return (np.concatenate([w[:, 0, :local_w] for w in wins], 1),
            np.concatenate([w[:, 1, :local_w] for w in wins], 1))


class _Sprints(NamedTuple):
    """The sprint plumbing of a decomposition run
    (:func:`_decompose_sprints`)."""
    dev: torch.device     #: the run's device (a mesh's first)
    step: object          #: ss -> (ss', record), see _decompose_sprints
    state: object         #: the initial decompose state in the sprint's form
    to_device: object     #: WalkerState -> the sprint's form
    to_walker: object     #: the sprint's form -> WalkerState
    unpack: object        #: host records -> ([n_win, W] A, [n_win, W] B)


def _decompose_sprints(scene, p: Params, seed: int, device, rng_impl: str,
                       cache=None, engine: str = "pallas",
                       mesh=None) -> _Sprints:
    """The sprint plumbing of a decomposition run on ``device``, or over
    the walker ``mesh`` (``parallel/sharding.py``; ``device`` then
    unused).  ``step(ss)`` returns the record ``[n_win, 2, W']`` on both
    engines, over a mesh the tuple of each shard's, which stays on its
    device; ``unpack`` takes the records copied to the host.  ``engine``
    "pallas" runs the chunk kernels (``ss`` their planes; ``cache``, the
    scene cache of a scene above ``REBUILD_MAX_MNPS`` dipoles, handed to
    each sprint), "scan" the scan engine (``ss`` a WalkerState; Threefry
    only, as the reference's).  On a card the kernels' library is built
    and loaded first, so the build is set-up and not part of the run; a
    CUDA device without a card raises."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    devs = [torch.device(device)] if mesh is None else list(mesh.devices)
    if any(d.type == "cuda" for d in devs):
        require_cuda()
        if engine == "pallas":
            chunk_kernel.load_library()
    dev = devs[0]
    num_water = scene.waters.shape[0]
    tbl = mnp_table(scene.mnps, torch.float32, dev)
    key = key_words(seed)
    if mesh is not None:
        return _sharded_sprints(scene, p, tbl, key, rng_impl, cache,
                                engine, mesh)
    if engine == "scan":
        sprint = reference_engine.make_sprint_fn(p, dev, decompose=True)

        def step(ss):
            ss, wins = sprint(tbl.pos, tbl.m, key, ss)
            return ss, wins.permute(0, 2, 1).contiguous()

        def to_device(state):
            return state

        to_walker = to_device
    else:
        sprint = make_sprint_fn(p, num_water, dev, rng_impl=rng_impl,
                                decompose=True)

        def step(ss):
            return sprint(tbl, key, ss, cache=cache)

        def to_device(state):
            return to_soa(state, p)

        def to_walker(ss):
            return from_soa(ss, num_water)

    def unpack(hosts):
        return _unpack_wins(hosts[0], num_water)

    return _Sprints(dev, step,
                    to_device(init_state(scene.waters, p, dev,
                                         decompose=True)),
                    to_device, to_walker, unpack)


def _sharded_sprints(scene, p: Params, tbl, key, rng_impl: str, cache,
                     engine: str, mesh) -> _Sprints:
    """:func:`_decompose_sprints` over a walker mesh: each shard's
    record stays with its shard; the state converts through the mesh's
    sharding, so a checkpoint holds the gathered walker state."""
    from ..parallel import sharding
    num_water = scene.waters.shape[0]
    local_w = sharding.even_split(num_water, mesh)
    tables = sharding.replicate(tbl, mesh.devices)
    if engine == "scan":
        sprint = sharding.make_sharded_decomp_sprint_fn(p, mesh)

        def step(ss):
            ss, recs = sprint(tables, key, ss)
            return ss, tuple(r.permute(0, 2, 1).contiguous() for r in recs)

        def to_device(state):
            return sharding.shard_walkers(state, mesh)

        def to_walker(ss):
            return sharding.gather_walkers(ss, mesh)
    else:
        sprint = sharding.make_sharded_pallas_sprint_fn(
            p, num_water, mesh, rng_impl=rng_impl, cache=cache,
            decompose=True)

        def step(ss):
            return sprint(tables, key, ss)

        def to_device(state):
            return sharding.to_planes_sharded(state, p, mesh)

        def to_walker(ss):
            return sharding.from_planes_sharded(ss, num_water, mesh)

    def unpack(hosts):
        return _unpack_wins_sharded(hosts, local_w)

    return _Sprints(mesh.devices[0], step,
                    to_device(init_state(scene.waters, p, mesh.devices[0],
                                         decompose=True)),
                    to_device, to_walker, unpack)


def _one_deep(sp: _Sprints, ss, sprints, commit, split, fault_hook=None):
    """Run the sprints of the absolute indices ``sprints`` from state
    ``ss`` with a drain one sprint deep: sprint i+1 is queued before
    sprint i's record is read.  On a card each record is copied to
    pinned host memory on a second stream of its device, so the copy
    and the host's work on sprint i overlap the device's work on sprint
    i+1.  ``commit(a_blk, b_blk, ss_i, i)`` gets, in sprint order,
    sprint i's record blocks ``[n_win, W]`` and the state after it.
    ``fault_hook(i)`` is called before sprint i is queued.  ``split``
    accumulates ``device_s`` (CUDA events on the run's device; on the
    CPU the sprint calls), ``copy_s`` and ``host_s`` (the unpacking and
    ``commit``).  Returns the final state."""
    on_card = sp.dev.type == "cuda"
    copy_streams = {}

    def launch(ss):
        """Queue one sprint and the copies of its records; returns the
        new state and the pending (host records, copy events, timing)."""
        if not on_card:
            t0 = time.perf_counter()
            ss, wins = sp.step(ss)
            split["device_s"] += time.perf_counter() - t0
            return ss, (wins if isinstance(wins, tuple) else (wins,),
                        None, None)
        dev0 = torch.cuda.Event(enable_timing=True)
        dev1 = torch.cuda.Event(enable_timing=True)
        dev0.record()
        ss, wins = sp.step(ss)
        dev1.record()
        hosts, copies = [], []
        for w in wins if isinstance(wins, tuple) else (wins,):
            # the stream the record was written on, taken before the
            # copy stream becomes the current one
            src = torch.cuda.current_stream(w.device)
            cs = copy_streams.get(w.device)
            if cs is None:
                cs = copy_streams[w.device] = torch.cuda.Stream(w.device)
            host = torch.empty(w.shape, dtype=w.dtype, pin_memory=True)
            cp0 = torch.cuda.Event(enable_timing=True)
            cp1 = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(cs):
                cs.wait_stream(src)
                w.record_stream(cs)
                cp0.record(cs)
                host.copy_(w, non_blocking=True)
                cp1.record(cs)
            hosts.append(host)
            copies.append((cp0, cp1))
        return ss, (hosts, copies, (dev0, dev1))

    def emit(item, ss_i, i):
        hosts, copies, timing = item
        if on_card:
            for _, cp1 in copies:
                cp1.synchronize()
            dev0, dev1 = timing
            split["device_s"] += dev0.elapsed_time(dev1) / 1e3
            split["copy_s"] += sum(a.elapsed_time(b)
                                   for a, b in copies) / 1e3
        t0 = time.perf_counter()
        commit(*sp.unpack([h.numpy() for h in hosts]), ss_i, i)
        split["host_s"] += time.perf_counter() - t0

    pending = None
    for i in sprints:
        if fault_hook is not None:
            fault_hook(i)
        ss, item = launch(ss)
        if pending is not None:
            emit(*pending)
        pending = (item, ss, i)
    if pending is not None:
        emit(*pending)
    if on_card:
        for d in {sp.dev, *copy_streams}:
            torch.cuda.synchronize(d)
    return ss


#: the stats a record store keeps (the reference's)
_COUNTERS = ("steps", "escapes", "coverage_violations")


def _run_stats(final, n_sprints: int, p: Params, num_water: int,
               wall: float, split: dict) -> dict:
    """A run's stats: the counters of its ``final`` state, its wall and
    rate over the ``n_sprints`` sprints it ran, and the split."""
    return {
        "steps": int(final.step),
        "escapes": int(final.escapes),
        "coverage_violations": int(final.coverage),
        "wall_s": wall,
        "walker_steps_per_s": n_sprints * p.sprint_steps * num_water / wall
        if wall > 0 else 0.0,
        "sprints": n_sprints,
        **split,
    }


def run_decomposition(scene, params: Params, seed: int = 0, *,
                      device="cuda", engine: str = "pallas",
                      rng_impl: str = "threefry",
                      max_steps: Optional[int] = None, consumer=None,
                      cache=None) -> DecompositionResult:
    """One forward simulation recording per-walker (A, B) per window.

    Runs on ``device`` ("cuda" unless the caller asks for "cpu"; a CUDA
    device without a card raises).  ``engine`` "pallas" runs the chunk
    kernels, "scan" the scan engine (Threefry; ``rng_impl`` and
    ``cache`` unused); both draw the same Threefry streams, so their
    records agree to f32 rounding.  ``rng_impl`` "threefry" reproduces
    the reference engines' streams; "hardware" is the fast generator.
    ``cache`` (``expansion.SceneCache``) is handed to every sprint, as
    the runner does for scenes above ``REBUILD_MAX_MNPS`` dipoles.

    ``consumer``: optionally a :class:`StreamingPlane` (or anything with
    ``update(a_block, b_block)``) fed each sprint's [n_win, W] record
    blocks in window order INSTEAD of materializing the record — the
    returned result then carries empty (0-window) A/B arrays and the
    reconstruction lives in the consumer.

    The drain is one sprint deep, as in the reference (``_one_deep``).
    ``stats`` holds, besides the counters, ``wall_s``, the
    ``walker_steps_per_s`` of the whole run, and the split summed over
    sprints: ``device_s`` (the sprints' kernels, CUDA events; on the CPU
    the sprint calls), ``copy_s`` (device -> host copies of the record)
    and ``host_s`` (unpacking and the consumer's update, or keeping the
    blocks).
    """
    p = params.validate()
    num_water = scene.waters.shape[0]
    sp = _decompose_sprints(scene, p, seed, device, rng_impl, cache, engine)
    total = p.t if max_steps is None else min(p.t, max_steps)
    n_sprints = total // p.sprint_steps
    a_parts, b_parts = [], []
    split = {"device_s": 0.0, "copy_s": 0.0, "host_s": 0.0}

    def commit(a_blk, b_blk, ss_i, i):
        with profiling.span("record.commit"):
            if consumer is not None:
                consumer.update(a_blk, b_blk)
            else:
                a_parts.append(a_blk.copy())
                b_parts.append(b_blk.copy())

    t_start = time.perf_counter()
    ss = _one_deep(sp, sp.state, range(n_sprints), commit, split)
    wall = time.perf_counter() - t_start
    final = sp.to_walker(ss)

    A = np.concatenate(a_parts) if a_parts else np.zeros((0, num_water))
    B = np.concatenate(b_parts) if b_parts else np.zeros((0, num_water))
    n_emitted = n_sprints * (p.sprint_steps // p.pfreq)
    times = (np.arange(1, n_emitted + 1) * p.pfreq) * p.tau
    return DecompositionResult(
        times_ms=times, A=A, B=B,
        stats=_run_stats(final, n_sprints, p, num_water, wall, split))


def _tags(engine: str, rng_impl: str):
    """The (engine, rng_impl) tags of a durable run's identity and
    checkpoints: the kernels' as ``io/checkpoint.py`` says, and the scan
    engine's "scan" with its one generator, Threefry."""
    from ..io import checkpoint as ckpt_mod
    if engine == "scan":
        return "scan", ckpt_mod.rng_tag("threefry")
    return ckpt_mod.ENGINE_TAG, ckpt_mod.rng_tag(rng_impl)


def _resume_state(path: str, p: Params, dev, seed: int, scene_seed: int,
                  tags, scene_fp: str, what: str):
    """The walker state of a durable run's checkpoint ``path`` (or
    snapshot, ``what``) on ``dev``, its identity checked against this
    run's (``tags`` of :func:`_tags`); raises unless it sits on a sprint
    boundary."""
    from ..io import checkpoint as ckpt_mod
    state, ck_seed, ck_scene_seed = ckpt_mod.load_checkpoint(
        path, p, dev, engine=tags[0], rng_impl=tags[1], scene_fp=scene_fp)
    if (ck_seed, ck_scene_seed) != (int(seed), int(scene_seed)):
        raise ValueError(
            f"{what} seeds (run={ck_seed}, scene={ck_scene_seed}) "
            f"do not match this run's ({seed}, {scene_seed}); "
            f"refusing to resume")
    if state.step % p.sprint_steps != 0:
        raise ValueError(
            f"{what} step {state.step} is not a sprint boundary "
            f"(sprint_steps={p.sprint_steps})"
            + ("; it was not written by a durable decomposition run"
               if what == "checkpoint" else ""))
    return state


def _save_state(path: str, state, p: Params, seed: int, scene_seed: int,
                tags, scene_fp: str, extra=None) -> None:
    from ..io import checkpoint as ckpt_mod
    ckpt_mod.save_checkpoint(
        path, state, p, seed, scene_seed, engine=tags[0], rng_impl=tags[1],
        scene_fp=scene_fp, extra=extra)


def run_decomposition_durable(scene, params: Params, record_path: str,
                              seed: int = 0, scene_seed: int = 0, *,
                              device="cuda", engine: str = "pallas",
                              rng_impl: str = "threefry",
                              max_steps: Optional[int] = None,
                              checkpoint_path: Optional[str] = None,
                              checkpoint_every_sprints: int = 1,
                              fault_hook=None, progress: bool = False,
                              cache=None, mesh=None) -> DecompositionResult:
    """:func:`run_decomposition` with a DISK-backed record and
    checkpoint/resume: the long-record production form (the reference's
    decompose.py:287-496).

    The per-sprint (A, B) blocks stream into an ``io.record.RecordStore``
    directory instead of host RAM (a scale-up record is 32 GB; host
    memory here stays one sprint block), and the walker state
    checkpoints every ``checkpoint_every_sprints`` through
    ``io.checkpoint``, record before checkpoint: sprint j's checkpoint is
    saved only after sprint j's rows are committed, so on any crash
    ``store.rows >= checkpoint-step rows`` and a resume trims the record
    overhang.  Re-running the SAME call after a process death resumes
    from the checkpoint and ends with a record bitwise equal to an
    uninterrupted run's (counter-based generators).  A re-run on a
    COMPLETE store returns its result without touching the device.

    The drain stays one sprint deep (``_one_deep``); the state
    checkpointed with sprint i's rows is the held state after sprint i,
    not the one in flight.  The store's identity (its ``meta``) holds
    the params fingerprint, the seeds, ``engine`` and ``rng_impl`` tags
    (``io.checkpoint``: a store either package started under Threefry
    resumes in the other), the scene's hash and the knobs offline
    reconstruction needs.  ``cache`` is handed to every sprint.
    ``fault_hook(sprint_index)`` is the seam of
    ``resilience.FaultInjector``, called before each sprint is queued.
    ``engine`` "scan" runs the scan engine and tags the store and its
    checkpoints "scan", with the walker state in its own ``[W, 2]`` (A,
    B) layout; such a store crosses to and from the reference's
    ``engine="scan"`` writer.

    ``mesh``: an optional one-process walker mesh
    (``parallel.sharding``, the CLI's ``--shard-walkers``; ``device`` is
    then unused): each shard's record block is stripped of its padding
    and laid in its walker columns, and the checkpoint holds the
    gathered walker state, so a run saved under one mesh resumes under
    another, or under none (global lanes: the partition changes no
    walker).

    Returns a :class:`DecompositionResult` whose A/B are READ-ONLY disk
    memmaps and whose ``stats`` are the counters and, when sprints ran,
    the split of this call's sprints (as :func:`run_decomposition`'s).
    """
    from ..io import checkpoint as ckpt_mod
    from ..io import record as record_mod

    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    p = params.validate()
    num_water = scene.waters.shape[0]
    if mesh is not None:
        from ..parallel import sharding
        n_shards = mesh.shape[sharding.WALKER_AXIS]
        if mesh.world_size > 1:
            raise ValueError(
                "run_decomposition_durable writes its record and "
                "checkpoint from one process; over several processes use "
                "distributed.run_decomposition_multihost")
        if num_water % n_shards != 0:
            raise ValueError(
                f"num_water ({num_water}) must divide evenly over "
                f"{n_shards} walker shards")
    wps = p.sprint_steps // p.pfreq            # record rows per sprint
    total = p.t if max_steps is None else min(p.t, max_steps)
    n_sprints = total // p.sprint_steps
    n_windows = n_sprints * wps
    if n_windows == 0:
        raise ValueError("durable decomposition needs at least one full "
                         "sprint of windows")
    if checkpoint_path is not None and checkpoint_every_sprints < 1:
        raise ValueError("checkpoint_every_sprints must be >= 1")
    scene_fp = ckpt_mod.scene_fingerprint(scene)
    tags = _tags(engine, rng_impl)
    identity = {
        "params_fp": ckpt_mod.params_fingerprint(p), "seed": int(seed),
        "scene_seed": int(scene_seed), "engine": tags[0],
        "rng_impl": tags[1], "scene_fp": scene_fp,
        # the knobs offline reconstruction needs (record_params)
        "taucp": p.taucp, "tau": p.tau, "pfreq": p.pfreq,
        "mmoment": p.mmoment,
    }

    def result_from(store, stats):
        a, b = store.arrays()
        return DecompositionResult(times_ms=store.times_ms(), A=a, B=b,
                                   stats=stats)

    if record_mod.is_record_dir(record_path):
        store = record_mod.RecordStore.open(record_path, writable=True)
        if (store.n_windows, store.num_water) != (n_windows, num_water):
            raise ValueError(
                f"record store at {record_path} holds a "
                f"[{store.n_windows}, {store.num_water}] record; this "
                f"run produces [{n_windows}, {num_water}] — refusing to "
                f"mix records")
        for k, v in identity.items():
            theirs = store.meta.get(k)
            if theirs != v:
                raise ValueError(
                    f"record store at {record_path} was written under "
                    f"{k}={theirs!r}, this run uses {k}={v!r}; the "
                    f"resumed record would silently mix random sequences "
                    f"— use a fresh --record-dir or the original config")
        if store.complete:
            return result_from(store, dict(store.meta.get("stats", {})))
    else:
        store = record_mod.RecordStore.create(record_path, n_windows,
                                              num_water, identity)

    sp = _decompose_sprints(scene, p, seed, device, rng_impl, cache,
                            engine, mesh)
    ss = sp.state
    # resume point: the checkpoint pins the walker state; the store is
    # trimmed to exactly the checkpointed sprint
    start_sprint = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state = _resume_state(checkpoint_path, p, sp.dev, seed, scene_seed,
                              tags, scene_fp, "checkpoint")
        start_sprint = state.step // p.sprint_steps
        need = start_sprint * wps
        if store.rows < need:
            raise ValueError(
                f"checkpoint is AHEAD of the record store ({need} rows "
                f"needed, {store.rows} committed) — the store was "
                f"truncated or replaced; delete the checkpoint to "
                f"restart, or restore the matching store")
        dropped = store.truncate(need)
        if dropped and progress:
            print(f"  resume: trimmed {dropped} record row(s) past the "
                  f"checkpoint (sprint {start_sprint})", file=sys.stderr)
        ss = sp.to_device(state)
    else:
        store.truncate(0)   # no checkpoint: any partial rows restart

    def save(ss_i):
        _save_state(checkpoint_path, sp.to_walker(ss_i), p, seed,
                    scene_seed, tags, scene_fp)

    def commit(a_blk, b_blk, ss_i, i):
        """Sprint ``i``'s record rows, then (the order matters) its
        checkpoint when one is due."""
        store.append(a_blk, b_blk)
        if checkpoint_path is not None and \
                (i + 1) % checkpoint_every_sprints == 0:
            save(ss_i)
        if progress:
            print(f"  sprint {i + 1}/{n_sprints}", file=sys.stderr)

    split = {"device_s": 0.0, "copy_s": 0.0, "host_s": 0.0}
    t_start = time.perf_counter()
    ss = _one_deep(sp, ss, range(start_sprint, n_sprints), commit, split,
                   fault_hook)
    wall = time.perf_counter() - t_start
    final = sp.to_walker(ss)
    stats = _run_stats(final, n_sprints - start_sprint, p, num_water, wall,
                       split)
    if checkpoint_path is not None:
        _save_state(checkpoint_path, final, p, seed, scene_seed, tags,
                    scene_fp)
    store.finalize({"stats": {k: stats[k] for k in _COUNTERS}})
    return result_from(store, stats)


def run_streaming_durable(scene, params: Params, plane: "StreamingPlane",
                          snapshot_path: str, seed: int = 0,
                          scene_seed: int = 0, *, device="cuda",
                          engine: str = "pallas",
                          rng_impl: str = "threefry",
                          max_steps: Optional[int] = None,
                          snapshot_every_sprints: int = 1,
                          fault_hook=None, progress: bool = False,
                          cache=None) -> dict:
    """Crash-safe ``--stream-plane`` runs (the reference's
    decompose.py:498-615): no record in RAM, none on disk, and durable.

    Feeds ``plane`` (a :class:`StreamingPlane`) as
    ``run_decomposition(consumer=plane)`` does, but every
    ``snapshot_every_sprints`` sprints the walker state AND the plane's
    state go into ONE atomic npz
    (``io.checkpoint.save_checkpoint(extra=plane.state_dict())``), so
    their consistency is structural.  A killed run re-invoked with the
    same arguments resumes from the snapshot and produces curves and
    echo matrices bitwise equal to an uninterrupted run's (the same
    per-sprint blocks, so the same float64 summation order).  A snapshot
    of the reference package's (Threefry) resumes here too.

    The plane must be fresh (or match the snapshot's configuration
    digest).  ``cache`` is handed to every sprint.  ``engine`` "scan"
    runs the scan engine, its snapshots tagged "scan" with the walker
    state in its ``[W, 2]`` layout, as the reference's.  Returns the stats
    (counters, and the split of this call's sprints); read the results
    from ``plane.result()`` / ``plane.echo_matrix()``.
    """
    from ..io import checkpoint as ckpt_mod

    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    p = params.validate()
    wps = p.sprint_steps // p.pfreq
    total = p.t if max_steps is None else min(p.t, max_steps)
    n_sprints = total // p.sprint_steps
    if n_sprints * wps != plane._n:
        raise ValueError(
            f"plane was declared with {plane._n} windows but this run "
            f"produces {n_sprints * wps}; construct the StreamingPlane "
            f"with n_windows = total_steps // pfreq")
    if snapshot_every_sprints < 1:
        raise ValueError("snapshot_every_sprints must be >= 1")
    scene_fp = ckpt_mod.scene_fingerprint(scene)
    num_water = scene.waters.shape[0]
    tags = _tags(engine, rng_impl)
    sp = _decompose_sprints(scene, p, seed, device, rng_impl, cache, engine)
    ss = sp.state

    start_sprint = 0
    if os.path.exists(snapshot_path):
        state = _resume_state(snapshot_path, p, sp.dev, seed, scene_seed,
                              tags, scene_fp, "snapshot")
        start_sprint = state.step // p.sprint_steps
        plane.load_state(ckpt_mod.load_extra(snapshot_path))
        if plane._r != start_sprint * wps:
            raise ValueError(
                f"snapshot is internally inconsistent: plane consumed "
                f"{plane._r} windows but the walker state sits at "
                f"sprint {start_sprint} ({start_sprint * wps} windows)")
        if progress:
            print(f"  resume: sprint {start_sprint}/{n_sprints} "
                  f"({plane._r} windows already streamed)",
                  file=sys.stderr)
        ss = sp.to_device(state)
    elif plane._r != 0:
        raise ValueError("no snapshot exists but the plane has already "
                         "consumed rows; pass a fresh StreamingPlane")

    def commit(a_blk, b_blk, ss_i, i):
        plane.update(a_blk, b_blk)
        if (i + 1) % snapshot_every_sprints == 0:
            _save_state(snapshot_path, sp.to_walker(ss_i), p, seed,
                        scene_seed, tags, scene_fp,
                        extra=plane.state_dict())
        if progress:
            print(f"  sprint {i + 1}/{n_sprints}", file=sys.stderr)

    split = {"device_s": 0.0, "copy_s": 0.0, "host_s": 0.0}
    t_start = time.perf_counter()
    ss = _one_deep(sp, ss, range(start_sprint, n_sprints), commit, split,
                   fault_hook)
    wall = time.perf_counter() - t_start
    # the final snapshot marks completion (a resume of a finished run
    # runs no sprint; the plane state is the whole stream)
    final = sp.to_walker(ss)
    _save_state(snapshot_path, final, p, seed, scene_seed, tags, scene_fp,
                extra=plane.state_dict())
    return _run_stats(final, n_sprints - start_sprint, p, num_water, wall,
                      split)


def make_plane_step(params: Params, num_water: int, scales, n_taucps: int,
                    echo_specs=(), *, device="cuda"):
    """The on-device plane update of :func:`run_plane_on_device`, on the
    record's device (``device``, where the scales live): on a card one
    launch of ``chunk_kernel.run_plane_fold`` (csrc/plane_fold_kernel.cu)
    a sprint, whose carry is bitwise, and curve block and echo rows
    within float32 rounding, what the plain torch body, ``step.twin``,
    gives on the CPU; a CPU record takes the twin (which runs on either
    device when called itself).

    ``step(wins, carry, u_prev, g_blk, echo_rows)`` consumes one sprint's
    RAW record ``wins [n_win, 2, W_pad]`` (the sprint's output, never
    leaving the device), carries per-taucp signed Kahan sums, and returns
    ``(carry', block)`` with ``block [n_scales, n_taucps, wps, 2]`` the
    walker means (``mean cos``, ``g * mean sin``), and with
    ``echo_specs`` also ``[n_specs, E_max, W]`` per-walker cos rows.

    Math (the device form of :class:`StreamingPlane`): with the raw
    per-window increments ``d_r`` recovered by undoing the base run's
    flips, window j's phase at echo spacing t and moment scale s is
    ``g_{j-1}(s * SA_j + SB_j)`` where ``SA_j = sum_{k<=j} g_{k-1} dA_k``
    — a cumsum per sprint plus a carried (SA, SB).  The carry is f32 +
    Kahan compensation, the engine's own phase-accumulation discipline;
    the float64 :class:`StreamingPlane` is the oracle it is tested
    against.

    ``u_prev`` [wps]: the sign undoing the base flip before each row (row
    0's entry pairs with the carried previous row).  ``g_blk`` [n_taucps,
    wps]: the reconstruction parities g_{j-1}.  ``carry`` = (SA, cA, SB,
    cB [T, W], prev_A, prev_B [W]).  ``echo_specs``: ((scale, taucp
    index), ...); ``echo_rows`` [n_specs, E_max] the local spin-echo rows
    of each spec (padded; the caller keeps only the real ones).

    The plain body issues a fixed number of torch operations, few of
    them per lane (about 47 launches a sprint at the headline, which is
    why the card runs the kernel).  The prefix sums of all lanes are one
    tensor ``[2, T, wps, W]``; the scales of one lane are one batch
    ``[n_scales, wps, W]``, so that temporary is never formed for every
    lane at once."""
    if any(not 0 <= ti < n_taucps for _, ti in echo_specs):
        raise ValueError(f"echo spec lanes {[ti for _, ti in echo_specs]} "
                         f"outside [0, {n_taucps})")
    dev = torch.device(device)
    s_col = torch.as_tensor(np.asarray(scales, np.float32).reshape(-1),
                            device=dev)[:, None, None]
    e_scale = torch.as_tensor(np.asarray([sv for sv, _ in echo_specs],
                                         np.float32), device=dev)
    e_lane = torch.as_tensor(np.asarray([ti for _, ti in echo_specs],
                                        np.int64), device=dev)
    s_flat = s_col.view(-1)
    echo = (e_lane, e_scale) if echo_specs else None

    def twin(wins, carry, u_prev, g_blk, echo_rows=None):
        SA, cA, SB, cB, prev_A, prev_B = carry
        x = wins[:, :, :num_water].transpose(0, 1)          # [2, wps, W]
        wps = x.shape[1]
        prev = torch.cat([torch.stack([prev_A, prev_B])[:, None],
                          x[:, :-1]], dim=1)
        d = x - u_prev[:, None] * prev                      # raw increments
        c = torch.cumsum(g_blk[:, :, None] * d[:, None], dim=2)
        s_sum = torch.stack([SA, SB])                       # [2, T, W]
        s = s_sum[:, :, None] + c                           # [2, T, wps, W]
        blks = []
        for t in range(n_taucps):
            inner = s_col * s[0, t] + s[1, t]               # [S, wps, W]
            blks.append(torch.stack(
                [torch.cos(inner).mean(dim=2),
                 g_blk[t] * torch.sin(inner).mean(dim=2)], dim=-1))
        # Kahan fold of the sprint's increments, every lane at once:
        # y = inc - comp; t = s + y; comp = (t - s) - y
        y = c[:, :, -1] - torch.stack([cA, cB])
        t_new = s_sum + y
        comp = (t_new - s_sum) - y
        carry = (t_new[0], comp[0], t_new[1], comp[1], x[0, -1].clone(),
                 x[1, -1].clone())
        block = torch.stack(blks, dim=1)                    # [S, T, wps, 2]
        if not echo_specs:
            return carry, block
        # every spec's rows in one gather from its lane of s
        flat = (echo_rows + e_lane[:, None] * wps).reshape(-1)
        sel = s.reshape(2, -1, s.shape[-1]).index_select(1, flat)
        sel = sel.view(2, *echo_rows.shape, -1)
        return carry, block, torch.cos(e_scale[:, None, None] * sel[0]
                                       + sel[1])

    def step(wins, carry, u_prev, g_blk, echo_rows=None):
        if wins.device.type == "cuda":
            return chunk_kernel.run_plane_fold(
                wins, carry, u_prev, g_blk, s_flat, num_water,
                echo and (echo_rows, *echo))
        return twin(wins, carry, u_prev, g_blk, echo_rows)

    step.twin = twin
    return step


def make_sharded_plane_step(params: Params, num_water: int, scales,
                            n_taucps: int, mesh, echo_specs=()):
    """:func:`make_plane_step` over a walker mesh: each shard folds its
    own walkers' record into its own carries on its device (the
    per-walker math is elementwise), and only the ``[S, T, wps, 2]``
    curve block crosses the mesh: the shards' walker means added in
    shard order on the first device (then over the processes) and
    divided by the shard count (equal shards, so the mean of the means
    is the mean).  The echo rows stay with their shard.

    ``step(wins, carry, u_prev, g_blk, echo_rows)`` takes ``wins`` and
    ``carry`` one a shard (a local step is built at ``local_w``, so each
    shard strips its own padding) and the tables as ``replicate``'s
    dicts; it returns ``(carry', block)`` (with ``echo_specs`` also each
    shard's ``[n_specs, E_max, local_w]`` cos rows)."""
    from ..parallel import sharding
    local_w = sharding.even_split(num_water, mesh)
    n_shards = mesh.shape[sharding.WALKER_AXIS]
    steps = {d: make_plane_step(params, local_w, scales, n_taucps,
                                echo_specs, device=d)
             for d in sharding.distinct(mesh.devices)}
    dev0 = mesh.devices[0]

    def step(wins, carry, u_prev, g_blk, echo_rows=None):
        outs = []
        for dev, w, c in zip(mesh.devices, wins, carry):
            with sharding.on_device(dev):
                outs.append(steps[dev](
                    w, c, u_prev[dev], g_blk[dev],
                    None if echo_rows is None else echo_rows[dev]))
        blk = outs[0][1].to(dev0, non_blocking=True)
        for o in outs[1:]:
            blk = blk + o[1].to(dev0, non_blocking=True)
        blk = sharding.reduce_over_processes(blk, mesh) / n_shards
        carry = tuple(o[0] for o in outs)
        if not echo_specs:
            return carry, blk
        return carry, blk, tuple(o[2] for o in outs)

    return step


class EchoCapture(NamedTuple):
    scale: float            #: moment scale of this capture
    taucp_ms: float         #: echo spacing
    times_ms: np.ndarray    #: [n_echoes] spin-echo times
    cos: np.ndarray         #: [n_echoes, W] per-walker cos at the echoes


def save_echoes(path: str, echoes, seed=None) -> None:
    """Save a list of :class:`EchoCapture` as one .npz (the CLI's
    ``--plane-device --dump-echoes`` product), in the reference
    package's schema, so either package reads the other's file.  The cos
    matrices are stored float32 — losslessly, since the on-device plane
    computes them in f32."""
    d = {"n_pairs": np.int64(len(echoes))}
    if seed is not None:
        d["seed"] = np.int64(seed)
    for i, e in enumerate(echoes):
        d[f"pair{i}_scale"] = np.float64(e.scale)
        d[f"pair{i}_taucp"] = np.float64(e.taucp_ms)
        d[f"pair{i}_times_ms"] = np.asarray(e.times_ms, np.float64)
        d[f"pair{i}_cos"] = np.asarray(e.cos, np.float32)
    np.savez_compressed(path, **d)


def load_echoes(path: str):
    """Load :func:`save_echoes` output back into :class:`EchoCapture`
    entries (``analysis`` ``--echoes``)."""
    with np.load(path) as z:
        if "n_pairs" not in z.files:
            raise ValueError(
                f"{path} is not an echo-capture file; expected the "
                f"mri-t2-sim --plane-device --dump-echoes .npz schema")
        return [EchoCapture(scale=float(z[f"pair{i}_scale"]),
                            taucp_ms=float(z[f"pair{i}_taucp"]),
                            times_ms=np.asarray(z[f"pair{i}_times_ms"],
                                                np.float64),
                            cos=np.asarray(z[f"pair{i}_cos"], np.float64))
                for i in range(int(z["n_pairs"]))]


@profiling.spanned("plane.run")
def run_plane_on_device(scene, params: Params, scales, taucps=None,
                        seed: int = 0, *, device="cuda",
                        engine: str = "pallas",
                        rng_impl: str = "threefry",
                        max_steps: Optional[int] = None, echo_pairs=(),
                        cache=None, mesh=None):
    """The (moment x taucp) plane computed on the device as the
    simulation runs.

    :func:`run_decomposition` + :class:`StreamingPlane` copy the
    per-walker record to the host every sprint (8 bytes x walkers x
    windows) and rebuild the plane there in float64.  Here the record
    never leaves the device: :func:`make_plane_step` folds each sprint's
    record into carried per-taucp signed Kahan sums on the device, and
    the ``[S, T, wps, 2]`` curve blocks (and the echo matrices) stay
    there until one copy to the host after the last sprint.  The loop
    never reads the device.

    Arguments as :func:`run_decomposition`'s (``device`` "cuda" unless
    the caller asks for "cpu"; ``cache`` for scenes above
    ``REBUILD_MAX_MNPS`` dipoles).  Precision: carries are f32 + Kahan,
    so curves match the float64 host plane to f32 rounding.

    ``echo_pairs``: optional ``[(scale, taucp_ms), ...]`` whose
    per-walker spin-echo cos matrices are gathered on the device in the
    same pass ([n_echoes, W] each) and returned as :class:`EchoCapture`
    entries, ready for :func:`bootstrap_from_echoes`.  An echo taucp
    that is not among ``taucps`` runs in a lane of its own, whose curve
    rows are left out of the result.

    Returns ``(times_ms, curves [S, T, n, 2], stats, echoes)`` with the
    curves walker means stacking (cos, sin) (float32), and ``stats``
    holding the counters, ``wall_s``, ``walker_steps_per_s``,
    ``sprints`` and the split: ``device_s`` (each sprint and its plane
    step, CUDA events; on the CPU the calls), ``copy_s`` (the one copy of
    curves and echoes to the host, after the last sprint has finished)
    and ``host_s`` (assembling the result on the host).

    ``engine`` "scan" runs the scan engine, whose record has no padding.
    ``mesh``: a walker mesh (``parallel.sharding``; ``device`` then
    unused): sprints and the plane folding run sharded
    (:func:`make_sharded_plane_step`), so nothing per walker crosses the
    mesh; curves differ from the unsharded plane's by the grouping of
    the mean only.  Over several processes each process fills only its
    own walkers' columns of the echo matrices (zero elsewhere):
    ``distributed.run_plane_multihost`` sums them.
    """
    from ..analysis import echo_indices

    with profiling.span("plane.setup"):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}")
        p = params.validate()
        num_water = scene.waters.shape[0]
        wps = p.sprint_steps // p.pfreq
        total = p.t if max_steps is None else min(p.t, max_steps)
        n_sprints = total // p.sprint_steps
        n = n_sprints * wps
        if n == 0:
            raise ValueError("run_plane_on_device needs at least one full "
                             "sprint of windows")
        taucps_l = [p.taucp] if taucps is None else \
            [float(t) for t in np.asarray(taucps, np.float64).reshape(-1)]
        T_req = len(taucps_l)
        s_arr = np.asarray(scales, np.float64).reshape(-1)
        times = np.arange(1, n + 1, dtype=np.float64) * p.pfreq * p.tau

        # echo specs: (scale, index into the taucp table); an echo taucp not
        # among the requested ones appends a lane sliced off the curves
        echo_specs, echo_meta = [], []
        for es, et in echo_pairs:
            et = float(et)
            if et not in taucps_l:
                p.replace(taucp=et).validate()
                taucps_l.append(et)
            eidx = echo_indices(times, et)
            if eidx.size == 0:
                raise ValueError(
                    f"no spin echo (t = 2k*taucp = {2 * et:g} ms) falls "
                    f"inside the {times[-1]:g} ms run")
            echo_specs.append((float(es), taucps_l.index(et)))
            echo_meta.append({"scale": float(es), "taucp": et, "eidx": eidx})
        tcps = [p.replace(taucp=t).validate().tcp for t in taucps_l]
        T = len(taucps_l)

        # sign tables on the host once: u_prev[r] undoes the base flip before
        # record row r; g[t, r] is the reconstruction parity g_{j-1} of row r
        j = np.arange(1, n + 1, dtype=np.int64)
        undo = np.where((j * p.pfreq) % p.tcp == 0, -1.0, 1.0)
        u_prev = np.concatenate([[1.0], undo[:-1]]).astype(np.float32)
        g_full = np.stack([_flip_parity(n, tcp, p.pfreq)
                           for tcp in tcps]).astype(np.float32)
        # per sprint: each spec's local echo rows, padded with row 0 to one
        # width E, and where the real ones go, from the step's [n_specs * E]
        # rows into the captures' rows laid end to end
        n_specs = len(echo_specs)
        rows = np.zeros((n_sprints, 1, 1), np.int64)
        places = [None] * n_sprints
        if n_specs:
            sel = [[np.nonzero((m["eidx"] >= i * wps)
                               & (m["eidx"] < (i + 1) * wps))[0]
                    for m in echo_meta] for i in range(n_sprints)]
            e_max = max(1, max(k.size for per in sel for k in per))
            rows = np.zeros((n_sprints, n_specs, e_max), np.int64)
            first = np.cumsum([0] + [m["eidx"].size for m in echo_meta])
            for i, per in enumerate(sel):
                src, dst = [], []
                for si, k in enumerate(per):
                    rows[i, si, :k.size] = echo_meta[si]["eidx"][k] - i * wps
                    src += [si * e_max + r for r in range(k.size)]
                    dst += list(first[si] + k)
                if src:
                    places[i] = (np.asarray(src, np.int64),
                                 np.asarray(dst, np.int64))

        sp = _decompose_sprints(scene, p, seed, device, rng_impl, cache,
                                engine, mesh)
        dev, ss = sp.dev, sp.state
        on_card = dev.type == "cuda"
        n_rows = sum(m["eidx"].size for m in echo_meta)
        if mesh is None:
            step = make_plane_step(p, num_water, s_arr, T, tuple(echo_specs),
                                   device=dev)

            def put(a):
                return torch.as_tensor(a, device=dev)

            def each(x, f):
                return f(x)

            carry = (torch.zeros((T, num_water), device=dev),) * 4 \
                + (torch.zeros(num_water, device=dev),) * 2
            captured = torch.zeros((n_rows, num_water), device=dev)

            def capture(emat, src, dst):
                captured.index_copy_(0, dst, emat.reshape(-1, num_water)
                                     .index_select(0, src))

            def captured_host():
                return captured.cpu().numpy()
        else:
            from ..parallel import sharding
            local_w = sharding.even_split(num_water, mesh)
            step = make_sharded_plane_step(p, num_water, s_arr, T, mesh,
                                           tuple(echo_specs))

            def put(a):
                return sharding.replicate(torch.as_tensor(a), mesh.devices)

            def each(x, f):
                return {d: f(t) for d, t in x.items()}

            carry = tuple((torch.zeros((T, local_w), device=d),) * 4
                          + (torch.zeros(local_w, device=d),) * 2
                          for d in mesh.devices)
            captured = [torch.zeros((n_rows, local_w), device=d)
                        for d in mesh.devices]

            def capture(emat, src, dst):
                for c, e, d in zip(captured, emat, mesh.devices):
                    c.index_copy_(0, dst[d], e.reshape(-1, local_w)
                                  .index_select(0, src[d]))

            def captured_host():
                # this process's walker columns; zero in other processes'
                full = np.zeros((n_rows, num_water), np.float32)
                lo = mesh.first_shard * local_w
                full[:, lo:lo + len(captured) * local_w] = np.concatenate(
                    [c.cpu().numpy() for c in captured], 1)
                return full
        # every table on the device once, sliced per sprint: the loop makes
        # no host -> device copy
        u_dev = put(u_prev)
        g_dev = put(g_full)
        rows_dev = put(rows)
        places = [pl and tuple(put(a) for a in pl) for pl in places]
        blocks, events = [], []
        split = {"device_s": 0.0, "copy_s": 0.0, "host_s": 0.0}

    t_start = time.perf_counter()
    for i in range(n_sprints):
        if on_card:
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        else:
            t0 = time.perf_counter()
        ss, wins = sp.step(ss)
        lo = i * wps
        with profiling.span("plane.fold"):
            carry, blk, *emat = step(
                wins, carry, each(u_dev, lambda t: t[lo:lo + wps]),
                each(g_dev, lambda t: t[:, lo:lo + wps]),
                each(rows_dev, lambda t: t[i]))
        blocks.append(blk)
        if places[i]:
            capture(emat[0], *places[i])
        if on_card:
            events[-1][1].record()
        else:
            split["device_s"] += time.perf_counter() - t0
    if on_card:
        for d in {dev, *([] if mesh is None else mesh.devices)}:
            torch.cuda.synchronize(d)
        split["device_s"] = sum(a.elapsed_time(b) for a, b in events) / 1e3
    t0 = time.perf_counter()
    with profiling.span("plane.copy"):
        # echo-only taucp lanes are not part of the requested plane
        curves = torch.cat(blocks, dim=2)[:, :T_req].cpu().numpy()
        captured = captured_host()
        final = sp.to_walker(ss)
    t1 = time.perf_counter()
    with profiling.span("plane.assemble"):
        mats = np.split(captured.astype(np.float64),
                        np.cumsum([m["eidx"].size for m in echo_meta])[:-1])
        echoes = [EchoCapture(scale=m["scale"], taucp_ms=m["taucp"],
                              times_ms=times[m["eidx"]], cos=mat)
                  for m, mat in zip(echo_meta, mats)]
    wall = time.perf_counter() - t_start
    split["copy_s"], split["host_s"] = t1 - t0, wall - (t1 - t_start)
    stats = {
        "steps": int(final.step),
        "escapes": int(final.escapes),
        "coverage_violations": int(final.coverage),
        "wall_s": wall,
        "walker_steps_per_s": n_sprints * p.sprint_steps * num_water / wall
        if wall > 0 else 0.0,
        "sprints": n_sprints,
        **split,
    }
    return times, curves, stats, echoes


def window_increments(A, B, params: Params):
    """Undo the base run's Carr-Purcell flips: raw per-window phase
    increments ``(dA, dB)`` as float64 host arrays.

    The engines emit each window's accumulated phase BEFORE applying the
    flip that fires at that window's end (cuda_sim.cu:996-1023 order:
    performUpdate, reduce, THEN flipPhases), so with ``s_j = -1`` iff
    ``(j*pfreq) % tcp == 0`` the recorded series satisfies
    ``A_j = s_{j-1} * A_{j-1} + dA_j`` — the increments are exactly
    recoverable in post-processing, no kernel support needed.
    """
    p = params.validate()
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    n = A.shape[0]
    j = np.arange(1, n + 1, dtype=np.int64)
    sign = np.where((j * p.pfreq) % p.tcp == 0, -1.0, 1.0)
    dA, dB = A.copy(), B.copy()
    dA[1:] -= sign[:-1, None] * A[:-1]
    dB[1:] -= sign[:-1, None] * B[:-1]
    return dA, dB


def _flip_parity(n_windows: int, tcp: int, pfreq: int) -> np.ndarray:
    """``g[r] = (-1)**F(r)`` where ``F(r)`` counts Carr-Purcell flips in
    windows 1..r (flip after window j iff ``(j*pfreq) % tcp == 0``, i.e.
    at multiples of tcp//pfreq windows).  Row r of the record holds
    window j = r+1, whose phase needs the parity of flips BEFORE it,
    ``g_{j-1} = g[r]``."""
    r = np.arange(n_windows, dtype=np.int64)
    flips = (r * pfreq) // tcp
    return (1.0 - 2.0 * (flips & 1)).astype(np.float64)


def flip_parity_schedule(n_windows: int, flip_windows) -> np.ndarray:
    """``g`` for an ARBITRARY refocusing schedule: ``flip_windows`` lists
    the (1-based) output windows after whose end a 180-degree pulse
    fires.  Row r of the record holds window j = r+1, whose phase needs
    the parity of pulses BEFORE it — the count of schedule entries
    <= r."""
    f = np.asarray(sorted({int(x) for x in flip_windows}), np.int64)
    if f.size and (f[0] < 1 or f[-1] > n_windows):
        raise ValueError(
            f"flip windows must be 1-based window indices in "
            f"[1, {n_windows}]; got range [{f[0]}, {f[-1]}]")
    counts = np.searchsorted(f, np.arange(n_windows, dtype=np.int64),
                             side="right")
    return (1.0 - 2.0 * (counts & 1)).astype(np.float64)


def _reconstruct(dA, dB, s_arr, g_stack, quadrature: bool,
                 walker_block: int) -> np.ndarray:
    """Shared inner loop: walker-mean curves [n_scales, n_schedules,
    n_windows(, 2)] given per-schedule parity vectors ``g_stack``
    [n_schedules, n_windows].  float64, streamed over walker blocks."""
    n, w = dA.shape
    comps = 2 if quadrature else 1
    acc = np.zeros((len(s_arr), g_stack.shape[0], n, comps), np.float64)
    for lo in range(0, w, walker_block):
        hi = min(lo + walker_block, w)
        a_blk, b_blk = dA[:, lo:hi], dB[:, lo:hi]
        for si, sv in enumerate(s_arr):
            dphi = sv * a_blk + b_blk
            for ti in range(g_stack.shape[0]):
                gi = g_stack[ti][:, None]
                phi = gi * np.cumsum(gi * dphi, axis=0)
                acc[si, ti, :, 0] += np.sum(np.cos(phi), axis=1)
                if quadrature:
                    acc[si, ti, :, 1] += np.sum(np.sin(phi), axis=1)
    acc /= w
    return acc if quadrature else acc[..., 0]


def reconstruct_curves(dA, dB, scales, taucps, params: Params,
                       quadrature: bool = False,
                       walker_block: int = 1024) -> np.ndarray:
    """T2 curves over the whole (moment-scale x echo-spacing) plane from
    ONE simulation's increment record.

    Phase is linear in the moment scale (phase_j = s*dA_j + dB_j per
    window) and a Carr-Purcell schedule only multiplies prefix sums by
    +-1, so for any taucp' whose flips land on window boundaries

        phi'_j = g_{j-1} * sum_{k<=j} g_{k-1} * dphi_k,
        g_m = (-1)**(number of flips among windows 1..m)

    — one cumulative sum per (scale, taucp) pair.  The reference answers
    this question with one ~14-minute recompile-and-rerun per grid point
    (README.md:13,16); here the whole plane is closed-form post-processing
    on common random numbers.

    Returns walker-MEAN curves ``[n_scales, n_taucps, n_windows]`` of
    cos(phi) (or ``[..., 2]`` stacking cos/sin when ``quadrature``).
    Accumulation is float64, streamed over walker blocks so the peak
    temporary stays ~``n_windows x walker_block`` regardless of the
    record size.
    """
    dA = np.asarray(dA, np.float64)
    dB = np.asarray(dB, np.float64)
    n = dA.shape[0]
    s_arr = np.asarray(scales, np.float64).reshape(-1)
    taucps = list(np.asarray(taucps, np.float64).reshape(-1))
    # one validated tcp per taucp (reuses the params error messages for
    # misaligned / sub-window echo spacings)
    tcps = [params.replace(taucp=float(t)).validate().tcp for t in taucps]
    g = np.stack([_flip_parity(n, tcp, params.pfreq) for tcp in tcps])
    return _reconstruct(dA, dB, s_arr, g, quadrature, walker_block)


def reconstruct_at_schedule(dA, dB, scales, schedules,
                            quadrature: bool = False,
                            walker_block: int = 1024) -> np.ndarray:
    """Curves for ARBITRARY refocusing-pulse schedules from one record —
    echo trains the engines never simulated.

    ``schedules`` is a list of pulse schedules, each a sequence of
    1-based output-window indices after whose end a 180-degree pulse
    fires (an empty schedule = free decay).  A 180-degree pulse only
    negates every walker's accumulated phase — it changes neither
    trajectories nor the per-window phase increments — so the exact
    reconstruction argument of :func:`reconstruct_curves` applies
    verbatim to non-uniform trains: variable-spacing CPMG, T2-prep
    blocks, or any other aligned sequence is one ±1-signed cumulative
    sum over the recorded increments.  (For the uniform-taucp grid the
    reference's workflow targets, use :func:`reconstruct_curves`; this
    is the generalization it cannot express at all.)

    Returns ``[n_scales, n_schedules, n_windows]`` walker-mean curves
    (``[..., 2]`` stacking cos/sin when ``quadrature``).
    """
    dA = np.asarray(dA, np.float64)
    dB = np.asarray(dB, np.float64)
    n = dA.shape[0]
    s_arr = np.asarray(scales, np.float64).reshape(-1)
    g = np.stack([flip_parity_schedule(n, sched) for sched in schedules])
    return _reconstruct(dA, dB, s_arr, g, quadrature, walker_block)


class StreamingPlane:
    """Incremental (moment-scale x taucp) plane reconstruction from
    per-sprint record blocks — the dense-sweep workflow WITHOUT ever
    materializing the [n_windows, W] record.

    Per window the phase increment is linear in the moment scale
    (dphi = s*dA + dB) and a Carr-Purcell train only signs prefix sums
    (reconstruct_curves), so per echo spacing it suffices to carry the
    per-walker SIGNED increment sums ``S_A = sum g_{k-1} dA_k`` and
    ``S_B`` — window j's phase at ANY scale is ``g_{j-1}(s*S_A + S_B)``,
    closed form.  Memory is ``2 x n_taucps x W`` float64, independent of
    BOTH the window count and the scale count: the full record for a
    100k-walker x 40k-window scale-up run is 32 GB; this is ~16 MB.

    Feed the engines' RAW recorded rows (accumulated phase with the base
    run's CP flips applied, exactly what ``run_decomposition`` drains per
    sprint) via :meth:`update` in window order — pass this object as
    ``run_decomposition(..., consumer=plane)``.  ``result()`` returns
    what :func:`curves_at_plane` returns, to float64 summation-order
    rounding (the batch path sums walkers in blocks of 1024).

    ``echo_pairs``: optional [(scale, taucp), ...] whose per-walker echo
    cos-matrices are captured during the stream (memory n_echoes x W
    each) and returned by :meth:`echo_matrix`: the per-walker cos at
    every spin echo, from which Monte-Carlo error bars follow with no
    record.
    """

    def __init__(self, params: Params, n_windows: int, scales,
                 taucps=None, quadrature: bool = False,
                 echo_pairs=(), row_block: int = 256):
        from ..analysis import echo_indices

        p = params.validate()
        self._p = p
        n = int(n_windows)
        if n <= 0:
            raise ValueError(f"n_windows must be > 0, got {n_windows!r}")
        if row_block < 1:
            raise ValueError(f"row_block must be >= 1, got {row_block!r}")
        self._n = n
        self._scales = np.asarray(scales, np.float64).reshape(-1)
        self._taucps = [p.taucp] if taucps is None else \
            [float(t) for t in np.asarray(taucps, np.float64).reshape(-1)]
        tcps = [p.replace(taucp=t).validate().tcp for t in self._taucps]
        self._g = np.stack([_flip_parity(n, tcp, p.pfreq) for tcp in tcps])
        # sign applied to the base run's accumulated phase AFTER window j
        # (1-based) — undoing it recovers raw increments, as in
        # window_increments
        j = np.arange(1, n + 1, dtype=np.int64)
        self._undo = np.where((j * p.pfreq) % p.tcp == 0, -1.0, 1.0)
        self._quad = bool(quadrature)
        self._row_block = int(row_block)
        self._curves = np.zeros(
            (len(self._scales), len(self._taucps), n,
             2 if self._quad else 1), np.float64)
        self.times_ms = np.arange(1, n + 1, dtype=np.float64) \
            * p.pfreq * p.tau
        self._echo = []
        for es, et in echo_pairs:
            tcp_e = p.replace(taucp=float(et)).validate().tcp
            eidx = echo_indices(self.times_ms, float(et))
            if eidx.size == 0:
                raise ValueError(
                    f"no spin echo (t = 2k*taucp = {2 * float(et):g} ms) "
                    f"falls inside the {self.times_ms[-1]:g} ms stream")
            self._echo.append({
                "scale": float(es), "taucp": float(et),
                "g": _flip_parity(n, tcp_e, p.pfreq),
                "eidx": eidx, "times": self.times_ms[eidx],
                "mat": None, "SA": None, "SB": None})
        self._r = 0
        self._prev_A = self._prev_B = None
        self._SA = self._SB = None

    def update(self, a_block, b_block) -> None:
        """Consume the next [n_block, W] raw record rows (window order)."""
        a_block = np.asarray(a_block, np.float64)
        b_block = np.asarray(b_block, np.float64)
        if a_block.shape != b_block.shape or a_block.ndim != 2:
            raise ValueError(
                f"expected matching [n_block, W] blocks; got "
                f"{a_block.shape} and {b_block.shape}")
        nb, w = a_block.shape
        if self._r + nb > self._n:
            raise ValueError(
                f"stream overflow: {self._r} + {nb} rows > the declared "
                f"{self._n} windows")
        if self._SA is None:
            t = len(self._taucps)
            self._SA = np.zeros((t, w), np.float64)
            self._SB = np.zeros((t, w), np.float64)
            for e in self._echo:
                e["SA"] = np.zeros(w, np.float64)
                e["SB"] = np.zeros(w, np.float64)
                e["mat"] = np.empty((e["eidx"].size, w), np.float64)
        elif w != self._SA.shape[1]:
            raise ValueError(f"walker count changed mid-stream: "
                             f"{self._SA.shape[1]} -> {w}")

        for c0 in range(0, nb, self._row_block):
            c1 = min(c0 + self._row_block, nb)
            g0 = self._r + c0
            # undo the base run's flips: dA_r = A_r - undo[r-1] * A_{r-1}
            dA = a_block[c0:c1].copy()
            dB = b_block[c0:c1].copy()
            if g0 > 0:
                dA[0] -= self._undo[g0 - 1] * self._prev_A
                dB[0] -= self._undo[g0 - 1] * self._prev_B
            if c1 - c0 > 1:
                u = self._undo[g0:g0 + (c1 - c0) - 1, None]
                dA[1:] -= u * a_block[c0:c1 - 1]
                dB[1:] -= u * b_block[c0:c1 - 1]
            self._prev_A = a_block[c1 - 1]
            self._prev_B = b_block[c1 - 1]

            for ti in range(len(self._taucps)):
                gc = self._g[ti, g0:g0 + (c1 - c0)][:, None]
                sa = self._SA[ti] + np.cumsum(gc * dA, axis=0)
                sb = self._SB[ti] + np.cumsum(gc * dB, axis=0)
                self._SA[ti] = sa[-1]
                self._SB[ti] = sb[-1]
                for si, sv in enumerate(self._scales):
                    inner = sv * sa + sb        # phi = g * inner
                    self._curves[si, ti, g0:g0 + (c1 - c0), 0] = \
                        np.mean(np.cos(inner), axis=1)
                    if self._quad:
                        self._curves[si, ti, g0:g0 + (c1 - c0), 1] = \
                            gc[:, 0] * np.mean(np.sin(inner), axis=1)
            for e in self._echo:
                gc = e["g"][g0:g0 + (c1 - c0)][:, None]
                sa = e["SA"] + np.cumsum(gc * dA, axis=0)
                sb = e["SB"] + np.cumsum(gc * dB, axis=0)
                e["SA"], e["SB"] = sa[-1], sb[-1]
                lo = np.searchsorted(e["eidx"], g0)
                hi = np.searchsorted(e["eidx"], g0 + (c1 - c0))
                for k in range(lo, hi):
                    r_loc = e["eidx"][k] - g0
                    e["mat"][k] = np.cos(
                        e["scale"] * sa[r_loc] + sb[r_loc])
        self._r += nb

    # -- snapshot / restore: resume a stream from a state_dict --
    def config_digest(self) -> str:
        """Hash of everything that shapes the stream's state and its
        float64 summation order — a snapshot may only be restored into
        an identically-configured plane."""
        import hashlib
        h = hashlib.sha256()
        h.update(repr((self._n, self._scales.tolist(), self._taucps,
                       self._quad, self._row_block, self._p.tcp,
                       self._p.pfreq,
                       [(e["scale"], e["taucp"]) for e in self._echo]))
                 .encode())
        return h.hexdigest()[:16]

    def state_dict(self) -> dict:
        """The consumed-stream state as flat numpy arrays (npz-able);
        :meth:`load_state` restores it exactly (bitwise)."""
        d = {"r": np.int64(self._r), "digest": self.config_digest()}
        if self._SA is not None:
            d.update(SA=self._SA, SB=self._SB, prev_A=self._prev_A,
                     prev_B=self._prev_B, curves=self._curves)
            for i, e in enumerate(self._echo):
                d[f"echo{i}_SA"] = e["SA"]
                d[f"echo{i}_SB"] = e["SB"]
                d[f"echo{i}_mat"] = e["mat"]
        return d

    def load_state(self, d: dict) -> None:
        """Restore a :meth:`state_dict` snapshot (same configuration
        required; refuses a digest mismatch)."""
        theirs = str(np.asarray(d["digest"]))
        if theirs != self.config_digest():
            raise ValueError(
                f"stream snapshot was taken under a different plane "
                f"configuration (digest {theirs} != "
                f"{self.config_digest()}); scales/taucps/quadrature/"
                f"row_block/echo_pairs must match exactly")
        self._r = int(np.asarray(d["r"]))
        if "SA" in d:
            self._SA = np.array(d["SA"], np.float64)
            self._SB = np.array(d["SB"], np.float64)
            self._prev_A = np.array(d["prev_A"], np.float64)
            self._prev_B = np.array(d["prev_B"], np.float64)
            self._curves = np.array(d["curves"], np.float64)
            for i, e in enumerate(self._echo):
                e["SA"] = np.array(d[f"echo{i}_SA"], np.float64)
                e["SB"] = np.array(d[f"echo{i}_SB"], np.float64)
                e["mat"] = np.array(d[f"echo{i}_mat"], np.float64)
        elif self._r:
            raise ValueError("stream snapshot claims consumed rows but "
                             "carries no state arrays")

    def _check_complete(self):
        if self._r != self._n:
            raise ValueError(
                f"stream incomplete: {self._r}/{self._n} windows consumed")

    def result(self) -> np.ndarray:
        """Walker-mean curves ``[n_scales, n_taucps, n_windows]``
        (``[..., 2]`` when quadrature) — :func:`curves_at_plane`'s
        contract, computed in one pass."""
        self._check_complete()
        return self._curves if self._quad else self._curves[..., 0]

    def echo_matrix(self, i: int = 0):
        """``(echo_times_ms, cos_echo [n_echoes, W])`` for echo_pairs[i]:
        the cos of each walker's phase at that pair's scale and spacing
        at every spin echo t = 2k taucp, captured in-stream."""
        if not self._echo:
            raise ValueError("no echo_pairs were requested at construction")
        self._check_complete()
        e = self._echo[i]
        return e["times"], e["mat"]


def curves_at_plane(A, B, scales, taucps, params: Params,
                    quadrature: bool = False) -> np.ndarray:
    """Convenience: ``window_increments`` + ``reconstruct_curves`` —
    the (moment x taucp) sweep plane from one decomposition record."""
    dA, dB = window_increments(A, B, params)
    return reconstruct_curves(dA, dB, scales, taucps, params,
                              quadrature=quadrature)


def write_curves(curves, params: Params, scales, taucps, csv_path: str,
                 quadrature: bool = False, log=None) -> None:
    """One T2 CSV per grid point of ``curves`` ``[s, t, n, 2]`` (walker
    means of cos and sin), in the reference's schema of walker sums
    (cuda_sim.cu:1013,1022): ``<stem>_mscale=<s>[_taucp=<t>]<ext>``
    beside ``csv_path``, the echo spacing in the name unless ``taucps``
    is None (the run's own spacing).  ``log(line)`` hears each path."""
    stem, ext = os.path.splitext(csv_path)
    for si, s in enumerate(scales):
        for ti, t_cp in enumerate([params.taucp] if taucps is None
                                  else taucps):
            pv = params.replace(mmoment=params.mmoment * s,
                                taucp=t_cp).validate()
            path = f"{stem}_mscale={s:g}"
            if taucps is not None:
                path += f"_taucp={t_cp:g}"
            path += ext or ".csv"
            wins = curves[si, ti] * params.num_water
            with writer_mod.T2CsvWriter(path, pv,
                                        quadrature=quadrature) as w:
                w.append_windows(0, wins)
            if log is not None:
                log(f"  mscale={s:g} taucp={t_cp:g}: wrote {path}")


def write_dispersion(path: str, times_ms, curves, scales, taucps,
                     num_water: int, log=None) -> None:
    """The CPMG dispersion table: a T2 fit of each grid point's spin-echo
    envelope, nan rows where it cannot be fit (``log(line)`` hears
    why)."""
    with open(path, "w") as f:
        f.write("mscale,taucp_ms,r2_per_ms,t2_ms,r_squared,n_echoes,"
                "t2_stderr_ms\n")
        for si, s in enumerate(scales):
            for ti, t_cp in enumerate(taucps):
                curve = curves[si, ti, :, 0] * num_water
                try:
                    te, me = analysis.sample_at_echoes(times_ms, curve,
                                                       t_cp)
                    fit = analysis.fit_t2(te, me)
                    f.write(f"{s:g},{t_cp:g},{1.0 / fit.t2_ms},"
                            f"{fit.t2_ms},{fit.r_squared},{fit.n_used},"
                            f"{fit.t2_stderr_ms}\n")
                except ValueError as e:
                    if log is not None:
                        log(f"  fit-r2: mscale={s:g} taucp={t_cp:g} "
                            f"unfittable ({e})")
                    f.write(f"{s:g},{t_cp:g},nan,nan,nan,0,nan\n")


def record_products(res: DecompositionResult, params: Params, scales,
                    taucps, csv_path: str, *, quadrature: bool = False,
                    fit_r2: Optional[str] = None, log=None) -> np.ndarray:
    """The record path's products after a decomposition run (the CLI's
    record branch, README configuration 5c): the walker-mean curves of
    every (scale, echo spacing) point reconstructed on the host in
    float64 from the record ``res`` (``curves_at_plane``; without
    ``taucps``, ``curves_at_scales`` at the run's own spacing), a CSV a
    point (``write_curves``) and with ``fit_r2`` the CPMG dispersion
    table at that path (``write_dispersion``).  Returns the curves
    ``[s, t, n, 2]``."""
    with profiling.span("record.reconstruct"):
        if taucps is None:
            curves = curves_at_scales(res.A, res.B, scales, quadrature=True)
            # [s, 2, n] -> [s, 1, n, 2], the plane's layout
            curves = np.moveaxis(curves, 1, -1)[:, None]
        else:
            curves = curves_at_plane(res.A, res.B, scales, taucps, params,
                                     quadrature=True)
    with profiling.span("record.write"):
        write_curves(curves, params, scales, taucps, csv_path, quadrature,
                     log)
        if fit_r2:
            write_dispersion(fit_r2, res.times_ms, curves, scales,
                             [params.taucp] if taucps is None else taucps,
                             params.num_water, log)
            if log is not None:
                log(f"CPMG dispersion table written: {fit_r2}")
    return curves


def open_record(path: str):
    """Load a saved decomposition record from EITHER format: a
    ``--dump-record`` .npz file (arrays in RAM) or an ``io.record``
    store directory (A/B stay read-only disk memmaps, so fits over
    records larger than RAM stream from disk).

    Returns ``(A, B, meta)`` with ``meta`` a dict holding whichever of
    ``times_ms / mmoment / seed / taucp / tau / pfreq`` the record
    carries (value ``None`` when absent)."""
    from ..io import record as record_mod

    keys = ("times_ms", "mmoment", "seed", "taucp", "tau", "pfreq")
    if record_mod.is_record_dir(path):
        store = record_mod.RecordStore.open(path)
        if not store.complete:
            raise ValueError(
                f"record store at {path} is incomplete "
                f"({store.rows}/{store.n_windows} windows committed); "
                f"finish or resume the run first")
        a, b = store.arrays()
        meta = {k: store.meta.get(k) for k in keys}
        meta["times_ms"] = store.times_ms()
        return a, b, meta
    with np.load(path) as z:
        a, b = z["A"], z["B"]
        meta = {k: (z[k] if k in z.files else None) for k in keys}
    for k in ("mmoment", "seed", "taucp", "tau"):
        if meta[k] is not None:
            meta[k] = float(meta[k])
    if meta["pfreq"] is not None:
        meta["pfreq"] = int(meta["pfreq"])
    return a, b, meta


def record_params(path: str, n_windows: int = None,
                  meta: dict = None) -> Params:
    """A minimal Params consistent with a saved record (the CLI's
    ``--dump-record`` .npz or an ``io.record`` store): the time axis and
    echo knobs the reconstruction math needs; every other field is an
    unused default.  Raises if the record lacks the knob fields.
    ``meta``: pass :func:`open_record`'s meta to skip re-opening the
    record (for .npz, reading the shape decompresses the whole
    potentially GB-scale A entry — pass ``n_windows`` to avoid it)."""
    from ..io import record as record_mod

    if meta is None:
        if record_mod.is_record_dir(path):
            store = record_mod.RecordStore.open(path)
            meta = {k: store.meta.get(k) for k in ("taucp", "tau", "pfreq")}
            if n_windows is None:
                n_windows = store.rows
        else:
            with np.load(path) as z:
                meta = {k: (float(z[k]) if k != "pfreq" else int(z[k]))
                        for k in ("taucp", "tau", "pfreq")
                        if k in z.files}
                if n_windows is None:
                    n_windows = z["A"].shape[0]
    for k in ("taucp", "tau", "pfreq"):
        if meta.get(k) is None:
            raise ValueError(
                f"{path} lacks {k!r}; re-dump the record with a "
                f"current build to reconstruct offline")
    if n_windows is None:
        times = meta.get("times_ms")
        if times is None:
            raise ValueError(f"{path} lacks a time axis; pass n_windows")
        n_windows = len(times)
    taucp, tau, pfreq = meta["taucp"], meta["tau"], meta["pfreq"]
    if n_windows == 0:
        raise ValueError(f"{path} holds an empty record (0 windows); "
                         f"nothing to reconstruct")
    pi = pfreq * tau
    return Params(totaltime=n_windows * pi, print_interval=pi, tau=tau,
                  taucp=taucp, sprint_steps=n_windows * pfreq,
                  chunk_steps=pfreq).validate()


def reconstruct_record(path: str, scales, taucps=None,
                       quadrature: bool = False, schedules=None):
    """Offline reconstruction from a saved record file alone: curves
    at each moment scale (``taucps=None``), over the full
    (moment x taucp) plane, or at arbitrary pulse ``schedules``
    (:func:`reconstruct_at_schedule`) — no simulator, no original
    Params object.  Returns what :func:`curves_at_scales` /
    :func:`curves_at_plane` / :func:`reconstruct_at_schedule` return
    (normalized per-walker means)."""
    if taucps is not None and schedules is not None:
        raise ValueError("pass taucps OR schedules, not both")
    A, B, meta = open_record(path)
    if taucps is None and schedules is None:
        return curves_at_scales(A, B, scales, quadrature=quadrature)
    # pass the window count: record_params would otherwise decompress
    # the (potentially GB-scale) A array a second time just for shape
    p = record_params(path, n_windows=A.shape[0], meta=meta)
    if schedules is not None:
        dA, dB = window_increments(A, B, p)
        return reconstruct_at_schedule(dA, dB, scales, schedules,
                                       quadrature=quadrature)
    return curves_at_plane(A, B, scales, taucps, p, quadrature=quadrature)


class BootstrapT2(NamedTuple):
    fit: "object"           #: analysis.T2Fit on the full-walker echo envelope
    t2_lo_ms: float         #: lower percentile bound of the T2 resamples
    t2_hi_ms: float         #: upper percentile bound
    t2_stderr_ms: float     #: sample std-dev of the T2 resamples
    n_ok: int               #: resamples that produced a valid fit
    t2_samples: np.ndarray  #: the resampled T2 values themselves


def echo_cos_matrix(A, B, params: Params, scale: float = 1.0,
                    taucp: Optional[float] = None,
                    walker_block: int = 1024, increments=None):
    """Per-walker ``cos(phi)`` at the spin-echo rows (t = 2k·taucp) for a
    given moment scale and echo spacing, from a decomposition record.

    Returns ``(echo_times_ms, cos_echo)`` with ``cos_echo`` shaped
    ``[n_echoes, num_water]`` — the sufficient statistic for any
    walker-resampling analysis of the echo envelope.  Streamed over
    walker blocks like :func:`reconstruct_curves`.  ``increments``:
    optionally pass precomputed ``window_increments(A, B, params)`` so
    multi-taucp callers pay the flip-undo once (A/B are then ignored).
    """
    from ..analysis import echo_indices

    p = params.validate()
    taucp_v = p.taucp if taucp is None else float(taucp)
    tcp = p.tcp if taucp is None else p.replace(taucp=taucp_v).validate().tcp
    dA, dB = increments if increments is not None \
        else window_increments(A, B, p)
    n, w = dA.shape
    times = np.arange(1, n + 1, dtype=np.float64) * p.pfreq * p.tau
    eidx = echo_indices(times, taucp_v)
    if eidx.size == 0:
        raise ValueError(
            f"no spin echo (t = 2k*taucp = {2 * taucp_v:g} ms) falls inside "
            f"the {times[-1]:g} ms record; nothing to sample")
    g = _flip_parity(n, tcp, p.pfreq)[:, None]
    cos_echo = np.empty((eidx.size, w), np.float64)
    for lo in range(0, w, walker_block):
        hi = min(lo + walker_block, w)
        dphi = scale * dA[:, lo:hi] + dB[:, lo:hi]
        phi = g * np.cumsum(g * dphi, axis=0)
        cos_echo[:, lo:hi] = np.cos(phi[eidx])
    return times[eidx], cos_echo


def bootstrap_t2(A, B, params: Params, scale: float = 1.0,
                 taucp: Optional[float] = None, n_boot: int = 200,
                 seed: int = 0, ci: float = 0.95, floor: float = 0.02,
                 walker_block: int = 1024,
                 increments=None) -> BootstrapT2:
    """Walker-bootstrap confidence interval on T2 from ONE simulation.

    The decay curve is a mean over walkers, so the record's per-walker
    (A, B) basis carries the full sampling distribution: resample the
    walker columns with replacement, reconstruct each resample's echo
    envelope (a single BLAS product against the multinomial weights), and
    fit T2 per resample.  This measures the real Monte-Carlo uncertainty
    of the simulation — which the per-row fit stderr understates, since
    decay rows share walkers and are strongly time-correlated.

    ``ci`` is the two-sided percentile level (0.95 -> [2.5%, 97.5%]).
    Resamples whose fit fails (e.g. a pathological draw that does not
    decay) are skipped and counted via ``n_ok``.
    """
    if not 0 < ci < 1:        # fail before the (possibly GB-scale)
        raise ValueError(f"ci must be in (0, 1), got {ci!r}")
    if n_boot < 2:            # echo-matrix pass, not after it
        raise ValueError(f"n_boot must be >= 2, got {n_boot!r}")
    te, cos_echo = echo_cos_matrix(A, B, params, scale=scale, taucp=taucp,
                                   walker_block=walker_block,
                                   increments=increments)
    return bootstrap_from_echoes(te, cos_echo, n_boot=n_boot, seed=seed,
                                 ci=ci, floor=floor)


def bootstrap_from_echoes(te, cos_echo, n_boot: int = 200, seed: int = 0,
                          ci: float = 0.95,
                          floor: float = 0.02) -> BootstrapT2:
    """The walker-bootstrap core of :func:`bootstrap_t2`, on an already
    materialized per-walker echo matrix ``[n_echoes, W]`` — e.g. one
    captured in-stream by :class:`StreamingPlane` (``echo_pairs``) or on
    the device by :func:`run_plane_on_device`, where no record ever
    exists to pass to :func:`bootstrap_t2`."""
    from ..analysis import fit_t2

    if not 0 < ci < 1:
        raise ValueError(f"ci must be in (0, 1), got {ci!r}")
    if n_boot < 2:
        raise ValueError(f"n_boot must be >= 2, got {n_boot!r}")
    te = np.asarray(te, np.float64)
    cos_echo = np.asarray(cos_echo, np.float64)
    w = cos_echo.shape[1]
    point = fit_t2(te, cos_echo.mean(axis=1), floor=floor)

    rng = np.random.default_rng(seed)
    counts = rng.multinomial(w, np.full(w, 1.0 / w), size=n_boot)
    curves = cos_echo @ (counts.T / w)          # [n_echoes, n_boot]
    samples = []
    for b in range(n_boot):
        try:
            samples.append(fit_t2(te, curves[:, b], floor=floor).t2_ms)
        except ValueError:
            continue
    if len(samples) < max(2, n_boot // 2):
        raise ValueError(
            f"only {len(samples)}/{n_boot} bootstrap resamples produced a "
            f"valid T2 fit; the curve is too noisy to bootstrap")
    s = np.asarray(samples, np.float64)
    alpha = 100.0 * (1.0 - ci) / 2.0
    lo, hi = np.percentile(s, [alpha, 100.0 - alpha])
    return BootstrapT2(fit=point, t2_lo_ms=float(lo), t2_hi_ms=float(hi),
                       t2_stderr_ms=float(s.std(ddof=1)),
                       n_ok=len(samples), t2_samples=s)


def bootstrap_dispersion(A, B, params: Params, taucps, scale: float = 1.0,
                         n_boot: int = 200, seed: int = 0,
                         ci: float = 0.95, floor: float = 0.02) -> list:
    """The CPMG dispersion table R2(taucp) WITH Monte-Carlo confidence
    intervals, from ONE decomposition record: per echo spacing, the
    walker bootstrap of :func:`bootstrap_t2` (the flip-undo pass over
    the record is paid once and shared).

    Returns one dict per taucp:
    ``{taucp_ms, r2_per_ms, t2_ms, t2_lo_ms, t2_hi_ms, t2_stderr_ms,
    n_ok}`` — nan row (n_ok=0) for grid points with too few echoes or
    an unfittable envelope, mirroring the ``--fit-r2`` sentinel.
    """
    p = params.validate()
    inc = window_increments(A, B, p)
    rows = []
    nan = float("nan")
    for t_cp in np.asarray(taucps, np.float64).reshape(-1):
        try:
            b = bootstrap_t2(A, B, p, scale=scale, taucp=float(t_cp),
                             n_boot=n_boot, seed=seed, ci=ci,
                             floor=floor, increments=inc)
            rows.append({"taucp_ms": float(t_cp),
                         "r2_per_ms": 1.0 / b.fit.t2_ms,
                         "t2_ms": b.fit.t2_ms,
                         "t2_lo_ms": b.t2_lo_ms,
                         "t2_hi_ms": b.t2_hi_ms,
                         "t2_stderr_ms": b.t2_stderr_ms,
                         "n_ok": b.n_ok})
        except ValueError:
            rows.append({"taucp_ms": float(t_cp), "r2_per_ms": nan,
                         "t2_ms": nan, "t2_lo_ms": nan, "t2_hi_ms": nan,
                         "t2_stderr_ms": nan, "n_ok": 0})
    return rows


def bootstrap_t2_record(path: str, scale: float = 1.0,
                        taucp: Optional[float] = None, n_boot: int = 200,
                        seed: int = 0, ci: float = 0.95,
                        floor: float = 0.02) -> BootstrapT2:
    """:func:`bootstrap_t2` from a saved record (``--dump-record`` npz
    or an ``io.record`` store) alone — error bars on T2 with no
    simulator and no original Params object."""
    A, B, meta = open_record(path)
    p = record_params(path, n_windows=A.shape[0], meta=meta)
    return bootstrap_t2(A, B, p, scale=scale, taucp=taucp, n_boot=n_boot,
                        seed=seed, ci=ci, floor=floor)


def bootstrap_dispersion_record(path: str, taucps, scale: float = 1.0,
                                n_boot: int = 200, seed: int = 0,
                                ci: float = 0.95,
                                floor: float = 0.02) -> list:
    """:func:`bootstrap_dispersion` from a saved record (npz or store
    directory)."""
    A, B, meta = open_record(path)
    p = record_params(path, n_windows=A.shape[0], meta=meta)
    return bootstrap_dispersion(A, B, p, taucps, scale=scale,
                                n_boot=n_boot, seed=seed, ci=ci,
                                floor=floor)


def curves_at_scales(A, B, scales, quadrature: bool = False):
    """Reconstruct normalized magnetization curves at each moment scale:
    ``curves[s, t] = mean_i cos(scales[s] * A[t, i] + B[t, i])``
    (and the sin component when ``quadrature``), as a NumPy array
    ``[n_scales, n_windows]`` (``[n_scales, 2, n_windows]``).

    float32 torch on the record's device (a tensor's own, the CPU for a
    NumPy record), one scale at a time, so sweeping hundreds of scales
    over a full-run record stays bounded in memory."""
    dev = A.device if isinstance(A, torch.Tensor) else torch.device("cpu")

    def f32(x):
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, np.float32)
            if not x.flags.writeable:      # a record store's memmap
                x = x.copy()
        return torch.as_tensor(x, device=dev).to(torch.float32)

    A, B = f32(A), f32(B)
    out = []
    for sv in np.asarray(scales, np.float32).reshape(-1):
        ph = torch.tensor(sv, device=dev) * A + B
        if quadrature:
            out.append(torch.stack([torch.cos(ph).mean(-1),
                                    torch.sin(ph).mean(-1)]))
        else:
            out.append(torch.cos(ph).mean(-1))
    return torch.stack(out).cpu().numpy()

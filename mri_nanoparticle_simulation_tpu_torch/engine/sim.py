"""Simulation orchestrator: scene -> device -> sprints -> CSV.

Counterpart of the reference's ``engine/sim.py`` on its main path: build
the scene, prove the near list (and on large scenes the cube candidate
tables) cover it, build the large-scene cache once, run sprints of
chunk-kernel launches without syncing the host, drain the window sums
every ``drain_depth`` sprints, and stream the T2 curve to CSV.

With ``--moment-scales`` and/or ``--echo-taucps`` the CLI runs one
phase-decomposition simulation (``engine/decompose.py``) and writes one
CSV per (moment scale, echo spacing) grid point, the reference's
sim.py:1198-1395: from the record on the host, from a plane streamed on
the host (``--stream-plane``), or from a plane folded on the device
(``--plane-device``, with ``--dump-echoes`` for the spin-echo captures).

``--ensemble N`` runs N trials and writes their mean curve; ``--sweep
KNOB`` and ``--sweep-grid`` run trials per value or grid point and write
one CSV each (``parallel/ensemble.py``), with ``--fit-t2`` the
dispersion table over the swept axis.  ``--trace DIR`` writes a
profiler trace of the run and the tally of the port's spans
(``utils/profiling``).

Runs survive a crash: ``--checkpoint C --checkpoint-every N`` snapshots
the walkers (``io/checkpoint.py``), ``--resume C`` continues a run, and
``--max-retries R`` rebuilds and resumes in the process after a failure
(``engine/resilience.py``); re-running the same command after a process
death resumes too.  A decomposition run is durable with ``--record-dir``
(a record store on disk) or ``--stream-plane --checkpoint``.  The scene
is the seeded ``BacteriaBox``, another family (``--scene-family``) or a
user's geometry (``--scene-file``: cell centres in a CSV or a scene
archive of ``--save-scene``); ``--dump-stats`` and ``--dump-field``
write the scene's statistics or its field and exit.

Run as a CLI:
    python -m mri_nanoparticle_simulation_tpu_torch.engine.sim \
        --num-water 4032 --totaltime 40 --out t2.csv --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from .. import analysis
from ..fields import expansion
from ..fields import grid as grid_mod
from ..io import checkpoint as ckpt_mod
from ..io import writer as writer_mod
from ..parallel import ensemble as ens
from ..parallel import sharding
from ..params import FIELD_GRID, Params, params_fingerprint
from ..scene import BacteriaBox, ClusteredBacteriaBox, FCCLatticeBox
from ..utils import profiling
from ..utils.device import require_cuda
from . import chunk_kernel, cuda_engine, reference_engine, resilience
from . import decompose as dec
from .convert import key_words, mnp_table
from .reference_engine import ENGINES, init_state


def fit_chunk_steps(params: Params, requested: int) -> int:
    """Largest chunk size <= requested that is a multiple of pfreq and
    divides the total step count (falls back to pfreq)."""
    c = min(requested, params.t)
    c -= c % params.pfreq
    while c > params.pfreq and params.t % c != 0:
        c -= params.pfreq
    return max(c, params.pfreq)


def fit_sprint_steps(params: Params, requested: int) -> int:
    """Largest sprint size <= requested that divides the total step count
    and is a multiple of both pfreq and chunk_steps."""
    unit = params.chunk_steps if params.chunk_steps >= params.pfreq \
        else params.pfreq
    best = unit
    for mult in range(1, requested // unit + 1):
        cand = unit * mult
        if params.t % cand == 0:
            best = cand
    return best


def _emit_sweep_outputs(csv_path, times, names, combos, flat, pv_fn,
                        fit_path, quadrature=False):
    """Per-grid-point outputs shared by --sweep and --sweep-grid: one
    reference-schema CSV per point (suffix KNOB=V[_KNOB2=V2]) and,
    when ``fit_path`` is set, the fitted dispersion table with one knob
    column per axis.  ``flat`` is [n_points, trials, n_windows]
    (+ a trailing (cos, sin) component axis when ``quadrature``);
    ``pv_fn(combo)`` yields the point's physical Params (header
    metadata and the echo spacing each point is fitted at)."""
    stem, ext = os.path.splitext(csv_path)
    fit_rows = []
    for ci, combo in enumerate(combos):
        pv = pv_fn(combo).validate()
        tag = "_".join(f"{n}={v:g}" for n, v in zip(names, combo))
        path = f"{stem}_{tag}{ext or '.csv'}"
        pt = flat[ci].mean(axis=0)           # trial mean
        if quadrature:
            mean, wins = pt[:, 0], pt
        else:
            mean = pt
            wins = np.stack([pt, np.zeros_like(pt)], -1)
        with writer_mod.T2CsvWriter(path, pv, quadrature=quadrature) as w:
            w.append_windows(0, wins)
        print(f"  {tag}: wrote {path}", file=sys.stderr)
        if fit_path:
            try:
                te, me = analysis.sample_at_echoes(times, mean, pv.taucp)
                fit = analysis.fit_t2(te, me)
                # error bar: with >= 2 trials, the scatter of per-trial
                # fits is the Monte-Carlo error of the mean-curve fit
                # (independent replicates); a single trial falls back to
                # the fit's linearized stderr, which understates (rows
                # share walkers; analysis.T2Fit)
                se = fit.t2_stderr_ms
                if flat[ci].shape[0] >= 2:
                    t2s = []
                    for trial in flat[ci]:
                        try:
                            tt, mt = analysis.sample_at_echoes(
                                times,
                                trial[:, 0] if quadrature else trial,
                                pv.taucp)
                            t2s.append(analysis.fit_t2(tt, mt).t2_ms)
                        except ValueError:
                            continue
                    if len(t2s) >= 2:
                        se = float(np.std(t2s, ddof=1) / np.sqrt(len(t2s)))
                fit_rows.append(combo + (1.0 / fit.t2_ms, fit.t2_ms,
                                         fit.r_squared, fit.n_used, se))
            except ValueError as e:
                print(f"  fit-t2: {tag} unfittable ({e})",
                      file=sys.stderr)
                fit_rows.append(combo + (float("nan"), float("nan"),
                                         float("nan"), 0, float("nan")))
    if fit_path:
        with open(fit_path, "w") as f:
            f.write(",".join(names)
                    + ",r2_per_ms,t2_ms,r_squared,n_echoes,t2_stderr_ms\n")
            for row in fit_rows:
                f.write(",".join(
                    [f"{v:g}" for v in row[:len(names)]]
                    + [str(v) for v in row[len(names):]]) + "\n")
        print(f"Sweep dispersion table written: {fit_path}",
              file=sys.stderr)


class SimulationRunner:
    """Owns the scene, the sprint function, the large-scene cache and the
    walker state.

    ``device`` is required (but with a ``mesh``), and a CUDA device
    without a card raises: the runner never moves to the CPU on its own.
    ``engine`` "pallas" runs the chunk kernels (``cuda_engine``), "scan"
    the torch-eager scan engine (``reference_engine.make_sprint_fn``:
    every chunk size, and the field modes exact and grid; it always
    draws Threefry, as the reference's scan engine).  ``rng_impl`` defaults to the fast
    generator, the reference runner's production default
    (``RNG_THREEFRY`` is the bit-reproducible validation path).
    ``cache_build_s`` is the wall time of the scene cache build (0 when
    the scene needs none); grid mode builds its grid (``field_grid``)
    once here.

    ``resume(path)`` continues from a checkpoint, and ``run`` writes them
    (``checkpoint_path``); both tag it as ``io/checkpoint.py`` says, so
    a Threefry checkpoint crosses to and from the reference runner of
    the same engine.

    ``mesh``: a walker mesh (``parallel.sharding.WalkerMesh``; ``device``
    then defaults to its first device, where the window sums and the
    gathered state live): the walkers shard over it on both engines, each
    shard with its global lanes, so every walker is the unsharded run's
    and the window sums differ by the grouping of their sum only.
    Checkpoints hold the gathered walker state: a run saved under one
    mesh resumes under another, or under none."""

    def __init__(self, params: Params, scene_seed: int = 0, seed: int = 0,
                 *, device=None, engine: str = "pallas",
                 rng_impl: str = cuda_engine.RNG_HARDWARE,
                 check_coverage: bool = True, scene=None, mesh=None):
        self.params = params.validate()
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; use one of "
                             f"{ENGINES}")
        grid_mode = params.field_mode == FIELD_GRID
        if grid_mode and engine == "pallas":
            raise ValueError(
                "field_mode='grid' is a scan-engine backend (the pallas "
                "engine's fused kernel always uses the local expansion, "
                "which is both faster and more accurate); use "
                "engine='scan'")
        if device is None:
            if mesh is None:
                raise ValueError("SimulationRunner needs a device "
                                 "(device='cuda' or 'cpu') or a mesh")
            device = mesh.devices[0]
        self.device = torch.device(device)
        self.engine = engine
        self.mesh = mesh
        if self.device.type == "cuda" or (
                mesh is not None
                and any(d.type == "cuda" for d in mesh.devices)):
            require_cuda()
            if engine == "pallas":
                chunk_kernel.load_library()   # the build is set-up, not run
        self.seed = seed
        self.scene_seed = scene_seed
        self.rng_impl = rng_impl if engine == "pallas" \
            else cuda_engine.RNG_THREEFRY
        if engine == "pallas":
            self._sprint = cuda_engine.make_sprint_fn(
                params, params.num_water, self.device, rng_impl=rng_impl)
        self.scene = scene if scene is not None \
            else BacteriaBox(params, seed=scene_seed).populate()
        # geometry content hash for checkpoints, once per scene
        self._scene_fp = ckpt_mod.scene_fingerprint(self.scene)
        self._drain_timeout_s = None
        n_mnp = len(self.scene.mnps)
        if not grid_mode:
            cuda_engine.check_scene(params, n_mnp)
        self.uses_cubes = (cuda_engine.needs_cache(params.num_water, n_mnp)
                           if engine == "pallas" else
                           expansion.uses_large_path(params.num_water,
                                                     n_mnp))
        if check_coverage and not grid_mode:
            worst = expansion.validate_near_k(self.scene.mnps[:, :3], params)
            if worst > params.near_k:
                raise ValueError(
                    f"scene requires near_k >= {worst} for exact in-cell "
                    f"tests at chunk_steps={params.chunk_steps} "
                    f"(configured near_k={params.near_k}); raise near_k or "
                    f"lower chunk_steps")
            if self.uses_cubes:
                worst_c = expansion.validate_cube_candidates(
                    self.scene.mnps[:, :3], params)
                if worst_c > params.cube_candidates:
                    raise ValueError(
                        f"scene requires cube_candidates >= {worst_c} "
                        f"(configured {params.cube_candidates}); raise it "
                        f"or shrink cube_hash_dim cubes")
        self.mnp_tbl = mnp_table(self.scene.mnps, torch.float32, self.device)
        # the scene cache, once per scene rather than once per sprint (the
        # scan engine builds its own, as the reference's does)
        self.cache = None
        self.cache_build_s = 0.0
        if self.uses_cubes and engine == "pallas":
            t0 = time.perf_counter()
            self.cache = expansion.build_cache(self.mnp_tbl.pos,
                                               self.mnp_tbl.m, params)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.cache_build_s = time.perf_counter() - t0
        self.field_grid = None
        if grid_mode:
            self.field_grid = grid_mod.build_grid(
                self.mnp_tbl.pos, self.mnp_tbl.m, params,
                grid_n=params.grid_n,
                max_residents=params.grid_max_residents)
        if engine == "scan":
            self._sprint = reference_engine.make_sprint_fn(
                params, self.device, field_grid=self.field_grid)
        self.key = key_words(seed)
        self.state = init_state(self.scene.waters, params, self.device)
        if mesh is not None:
            self._use_mesh(mesh)

    def _use_mesh(self, mesh) -> None:
        """Shard the walkers over ``mesh``: the sharded sprint and the
        state's conversions take the place of the single-device ones, so
        the sprint loop tests for no mesh."""
        p = self.params
        tables = sharding.replicate(self.mnp_tbl, mesh.devices)
        if self.engine == "pallas":
            sprint = sharding.make_sharded_pallas_sprint_fn(
                p, p.num_water, mesh, rng_impl=self.rng_impl,
                cache=self.cache)
            self._to_device_state = lambda st: sharding.to_planes_sharded(
                st, p, mesh)
            self._from_device_state = \
                lambda ss: sharding.from_planes_sharded(ss, p.num_water,
                                                        mesh)
        else:
            if self.field_grid is not None:
                raise ValueError("sharded grid-mode runs are not wired "
                                 "up; use field_mode='expansion'")
            sprint = sharding.make_sharded_sprint_fn(p, mesh)
            self._to_device_state = lambda st: sharding.shard_walkers(
                st, mesh)
            self._from_device_state = lambda ss: sharding.gather_walkers(
                ss, mesh)
        self._run_sprint = lambda ss: sprint(tables, self.key, ss)

    @property
    def _engine_tag(self) -> str:
        """The ``engine`` tag of this runner's checkpoints."""
        return ckpt_mod.ENGINE_TAG if self.engine == "pallas" else "scan"

    def _to_device_state(self, state):
        """The sprint's own form of ``state``: the kernels' planes, or the
        state itself on the scan engine."""
        return cuda_engine.to_soa(state, self.params) \
            if self.engine == "pallas" else state

    def _from_device_state(self, ss):
        """The WalkerState of the sprint's form of the state."""
        return cuda_engine.from_soa(ss, self.params.num_water) \
            if self.engine == "pallas" else ss

    def _run_sprint(self, ss):
        if self.engine == "pallas":
            return self._sprint(self.mnp_tbl, self.key, ss, cache=self.cache)
        return self._sprint(self.mnp_tbl.pos, self.mnp_tbl.m, self.key, ss)

    def resume(self, path: str):
        """Continue from the checkpoint at ``path``: raises ValueError when
        it was written under other params, seeds, scene, engine or
        generator."""
        state, seed, scene_seed = ckpt_mod.load_checkpoint(
            path, self.params, self.device, engine=self._engine_tag,
            rng_impl=ckpt_mod.rng_tag(self.rng_impl),
            scene_fp=self._scene_fp)
        if seed != self.seed or scene_seed != self.scene_seed:
            raise ValueError(
                f"checkpoint seeds (run={seed}, scene={scene_seed}) do not "
                f"match runner seeds (run={self.seed}, "
                f"scene={self.scene_seed})")
        self.state = state

    def _save_checkpoint(self, path: str) -> None:
        ckpt_mod.save_checkpoint(
            path, self.state, self.params, self.seed, self.scene_seed,
            engine=self._engine_tag,
            rng_impl=ckpt_mod.rng_tag(self.rng_impl),
            scene_fp=self._scene_fp)

    @profiling.spanned("runner.run")
    def run(self, csv_path: Optional[str] = None, quadrature: bool = False,
            checkpoint_path: Optional[str] = None,
            checkpoint_every_sprints: int = 0, progress: bool = True,
            max_steps: Optional[int] = None, drain_depth: int = 32,
            fault_hook=None, drain_timeout_s: Optional[float] = None):
        """Run from the current state to the end (or ``max_steps``),
        streaming CSV rows.  Sprints are queued without host syncs; the
        window sums of ``drain_depth`` sprints come back in one copy, so
        an un-checkpointed crash loses at most that many sprints of rows.

        ``checkpoint_path`` with ``checkpoint_every_sprints``: every that
        many sprints the pending rows are drained first, then the walker
        state is converted from the kernel layout and saved, so a
        checkpoint is never ahead of the rows on disk; the end state is
        saved too.  ``fault_hook(sprint_index)`` is called before each
        sprint is queued (``resilience.FaultInjector``); what it raises
        is handled as a device failure.  ``drain_timeout_s`` puts a
        watchdog deadline on every blocking readback (drains,
        checkpoint and final state fetches): one that exceeds it raises
        ``resilience.WatchdogTimeout``.  With none of these the sprint
        loop issues no host sync but the drains.

        Returns (times_ms, sum_cos, sum_sin, stats)."""
        if drain_depth < 1:
            raise ValueError("drain_depth must be >= 1")
        self._drain_timeout_s = drain_timeout_s
        p = self.params
        total = p.t if max_steps is None else min(p.t, max_steps)
        start_step = self.state.step
        n_sprints = (total - start_step) // p.sprint_steps
        win_per_sprint = p.sprint_steps // p.pfreq

        writer = None
        with profiling.span("runner.state_in"):
            if csv_path is not None:
                writer = writer_mod.T2CsvWriter(csv_path, p, quadrature,
                                                append=start_step > 0)
                writer.__enter__()
            ss = self._to_device_state(self.state)
        t0 = time.perf_counter()
        pending, all_wins = [], []
        try:
            for i in range(n_sprints):
                if fault_hook is not None:
                    fault_hook(start_step // p.sprint_steps + i)
                ss, wins = self._run_sprint(ss)
                pending.append((start_step // p.pfreq + i * win_per_sprint,
                                wins))
                if len(pending) >= drain_depth:
                    self._drain(pending, writer, all_wins)
                if checkpoint_path and checkpoint_every_sprints and \
                        (i + 1) % checkpoint_every_sprints == 0:
                    # the rows first: a checkpoint must never be ahead of
                    # the rows on disk
                    self._drain(pending, writer, all_wins)
                    self._state_out(ss, checkpoint_path)
                if progress and (i + 1) % max(1, n_sprints // 20) == 0:
                    rate = ((i + 1) * p.sprint_steps * p.num_water
                            / (time.perf_counter() - t0))
                    print(f"  sprint {i + 1}/{n_sprints} (queued "
                          f"{rate:.2e} walker-steps/s)", file=sys.stderr)
            self._drain(pending, writer, all_wins)
        finally:
            if writer is not None:
                writer.close()
        wall = time.perf_counter() - t0
        self._state_out(ss, checkpoint_path)

        wins = np.concatenate(all_wins, 0) if all_wins \
            else np.zeros((0, 2), np.float32)
        n = len(wins)
        times = (np.arange(start_step // p.pfreq + 1,
                           start_step // p.pfreq + n + 1) * p.pfreq) * p.tau
        stats = {
            "wall_s": wall,
            "walker_steps_per_s": n_sprints * p.sprint_steps * p.num_water
            / wall if wall > 0 else 0.0,
            "escapes": int(self.state.escapes),
            "coverage_violations": int(self.state.coverage),
            "steps": int(self.state.step),
        }
        return times, wins[:, 0], wins[:, 1], stats

    def _state_out(self, ss, checkpoint_path) -> None:
        """``_sync_and_save`` under the drain watchdog."""
        with profiling.span("runner.state_out"):
            self._guarded(lambda: self._sync_and_save(ss, checkpoint_path))

    def _sync_and_save(self, ss, checkpoint_path) -> None:
        """The walker state from the sprint's form, then its checkpoint
        when ``checkpoint_path`` is set."""
        self.state = self._from_device_state(ss)
        if checkpoint_path:
            self._save_checkpoint(checkpoint_path)

    def _fetch_pending(self, pending):
        """The one blocking device -> host copy of the steady state: all
        pending sprints' window sums in one copy.  Split out so the
        watchdog can bound it and tests can make it hang."""
        return torch.cat([w for _, w in pending]).cpu().numpy()

    def _on_caller_stream(self, fn):
        """``fn`` to run in another thread on this thread's current CUDA
        stream: torch's current stream is per thread, and a copy queued
        on another stream would not wait for the sprints queued here."""
        if self.device.type != "cuda":
            return fn
        stream = torch.cuda.current_stream(self.device)

        def on_stream():
            with torch.cuda.stream(stream):
                return fn()
        return on_stream

    def _guarded(self, fn, what="walker-state readback"):
        """Run a blocking device interaction under the drain watchdog
        (when one is armed), on this thread's stream."""
        if self._drain_timeout_s is None:
            return fn()
        return resilience.watchdog_call(self._on_caller_stream(fn),
                                        self._drain_timeout_s, what=what)

    def _drain(self, pending, writer, all_wins):
        """All pending sprints' window sums in one device->host copy."""
        if not pending:
            return
        first_idx = pending[0][0]
        with profiling.span("runner.fetch"):
            wins = self._guarded(
                lambda: self._fetch_pending(pending),
                what=f"drain of {len(pending)} pending sprint(s)")
        with profiling.span("runner.csv_append"):
            pending.clear()
            all_wins.append(wins)
            if writer is not None:
                writer.append_windows(first_idx, wins)


def build_parser() -> argparse.ArgumentParser:
    """The CLI's flags, those of the reference CLI that the port runs."""
    ap = argparse.ArgumentParser(
        description="Monte Carlo MRI T2 simulation on an NVIDIA GPU "
                    "(PyTorch + CUDA port; reference: "
                    "RabinKarp/MRI_Nanoparticle_Simulation)")
    ap.add_argument("--num-water", type=int, default=4032)
    ap.add_argument("--num-cells", type=int, default=270)
    ap.add_argument("--totaltime", type=float, default=40.0,
                    help="simulated time, ms")
    ap.add_argument("--taucp", type=float, default=5.5)
    ap.add_argument("--mmoment", type=float, default=3.5e-17)
    ap.add_argument("--cell-r", type=float, default=0.55)
    ap.add_argument("--kick-mode", default="as_written",
                    choices=["as_written", "intended", "constant", "none"])
    ap.add_argument("--permeable", action="store_true",
                    help="use the physical reflectIO/OI permeability")
    ap.add_argument("--impermeable", action="store_true",
                    help="reflectIO = reflectOI = 1")
    ap.add_argument("--engine", default="pallas", choices=ENGINES,
                    help="pallas: the chunk kernels (the production "
                         "path); scan: the torch-eager scan engine (the "
                         "reference's correctness anchor: every chunk "
                         "size and the exact and grid field modes, "
                         "Threefry only)")
    ap.add_argument("--walker-shards", type=int, default=1,
                    metavar="N",
                    help="with --ensemble/--sweep: shard each trial's "
                         "walkers over N devices on a 2D "
                         "(trials x walkers) mesh (single runs use "
                         "--shard-walkers)")
    ap.add_argument("--shard-walkers", action="store_true",
                    help="shard walkers over ALL local devices (every "
                         "card for --device cuda; window sums added over "
                         "the shards): every walker bitwise the "
                         "single-device run's, for multi-card hosts")
    ap.add_argument("--chunk-steps", type=int, default=4000,
                    help="field-model rebuild interval (auto-shrunk for "
                         "short runs)")
    ap.add_argument("--near-k", type=int, default=10)
    ap.add_argument("--max-neighbors", type=int, default=13,
                    help="nearest-cell lookup capacity; raise for dense "
                         "scenes (thousands of cells)")
    ap.add_argument("--hash-dim", type=int, default=20)
    ap.add_argument("--tau", type=float, default=1e-6,
                    help="timestep in ms (reference: 1e-6 = 1 ns)")
    ap.add_argument("--gradient", default=None, metavar="GX,GY,GZ",
                    help="constant background B_z gradient in T/µm; a "
                         "negative leading component needs the = form "
                         "(--gradient=-1e-4,0,0)")
    ap.add_argument("--cube-candidates", type=int, default=96)
    ap.add_argument("--far-table-order", type=int, default=5,
                    help="per-cube far-field Taylor order on the "
                         "large-scene path (0 = exact far sums each "
                         "chunk)")
    ap.add_argument("--sprint-steps", type=int, default=100000,
                    help="steps per sprint (auto-shrunk to divide the "
                         "total step count)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene-seed", type=int, default=0)
    ap.add_argument("--scene-family", default="bacteria",
                    choices=["bacteria", "clustered", "fcc"],
                    help="cell geometry: 'bacteria' = uniform random "
                         "throws (BacteriaBox.cpp:49-72), 'clustered' = "
                         "Gaussian clumps (octree-adaptivity stress "
                         "family), 'fcc' = deterministic face-centered-"
                         "cubic lattice (the reference lineage's "
                         "fcc_diffusion.h geometry, octree_test.cpp:14)")
    ap.add_argument("--n-clusters", type=int, default=8,
                    help="cluster count for --scene-family clustered")
    ap.add_argument("--cluster-sigma", type=float, default=1.5,
                    help="cluster spread (µm) for clustered scenes")
    ap.add_argument("--lattice-a", type=float, default=None,
                    help="FCC cubic lattice constant (µm); default "
                         "sizes the lattice to host num_cells centered "
                         "sites")
    ap.add_argument("--out", default=None,
                    help="CSV path (default: reference-style filename)")
    ap.add_argument("--quadrature", action="store_true",
                    help="also emit the sum-sin column")
    ap.add_argument("--drain-depth", type=int, default=32,
                    help="sprints queued between CSV drains; a crash "
                         "loses up to this many sprints of rows (1 = "
                         "per-sprint durability, one device sync a "
                         "sprint)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="sprints between checkpoints")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--max-retries", type=int, default=0, metavar="N",
                    help="elastic recovery: on a device failure, rebuild "
                         "the runner, resume from --checkpoint (trimming "
                         "CSV rows past it) and retry, up to N "
                         "consecutive failures without progress; "
                         "requires --checkpoint and --checkpoint-every. "
                         "The reference aborted on any CUDA error "
                         "(HANDLE_ERROR, cuda_sim.cu:407).  A sticky CUDA "
                         "error poisons the process: then only running "
                         "the same command again recovers")
    ap.add_argument("--drain-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="watchdog deadline on each device readback; a "
                         "hung drain raises (and, with --max-retries, "
                         "recovers) instead of blocking forever")
    ap.add_argument("--rng", default=None,
                    choices=[cuda_engine.RNG_HARDWARE,
                             cuda_engine.RNG_THREEFRY],
                    help="RNG implementation (default: hardware on the "
                         "pallas engine, the fast generator, "
                         "Philox4x32-10 in place of the TPU's hardware "
                         "PRNG; threefry is the bit-reproducible "
                         "cross-engine validation path and the scan "
                         "engine's only one)")
    ap.add_argument("--field-mode", default="expansion",
                    choices=["expansion", "exact", "grid"],
                    help="scan-engine field backend (the pallas engine "
                         "always uses the expansion). 'exact' and 'grid' "
                         "are cross-validation oracles, NOT production "
                         "engines: 'grid' (the reference octree's direct "
                         "analogue) is dispatch-bound at ~1000x the "
                         "production path's runtime — use it to check "
                         "curves, not to run experiments")
    ap.add_argument("--grid-n", type=int, default=64,
                    help="field-grid resolution (field-mode=grid)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails without a card")
    ap.add_argument("--moment-scales", default=None, metavar="S1,S2,...",
                    help="reconstruct the T2 curve at each moment scale s "
                         "(dipole moment = s * --mmoment) from ONE "
                         "phase-decomposition run, writing one CSV per "
                         "scale next to --out: trajectories never depend "
                         "on the moment, so a single simulation is a "
                         "complete basis for the whole moment axis "
                         "(engine/decompose.py).  All scales share the "
                         "same trajectories (common random numbers).  "
                         "Host memory: the per-walker record is 8 bytes x "
                         "windows x waters (~1.3 GB for the full 4032 x "
                         "40 ms run)")
    ap.add_argument("--echo-taucps", default=None, metavar="T1,T2,...",
                    help="reconstruct the curve at each Carr-Purcell "
                         "half-echo spacing (ms) from the SAME "
                         "decomposition run: flips only multiply window "
                         "prefix sums by +-1, so any taucp aligned to "
                         "the output interval is a closed-form cumsum "
                         "over the recorded increments "
                         "(engine/decompose.py).  Composes with "
                         "--moment-scales into the full (moment x taucp) "
                         "plane — the reference re-ran nvcc + ~14 min of "
                         "GPU per grid point; one CSV per pair")
    ap.add_argument("--dump-record", default=None, metavar="PATH",
                    help="with --moment-scales/--echo-taucps: also save "
                         "the raw per-walker decomposition record "
                         "(times_ms, A [n,W], B [n,W] + params "
                         "fingerprint) as .npz — a complete basis for "
                         "offline reconstruction at ANY moment scale / "
                         "aligned echo spacing (engine/decompose.py)")
    ap.add_argument("--plane-device", action="store_true",
                    help="with --moment-scales/--echo-taucps: compute "
                         "the (moment x taucp) plane ON THE DEVICE "
                         "(decompose.run_plane_on_device): the raw "
                         "per-walker record never crosses to the host, "
                         "only the curves come back after the run.  "
                         "Carries are f32 + Kahan (the engine's own "
                         "phase discipline): curves match the float64 "
                         "host reconstruction to f32 rounding")
    ap.add_argument("--dump-echoes", default=None, metavar="NPZ",
                    help="with --plane-device: also gather the "
                         "PER-WALKER spin-echo cos matrices of every "
                         "(moment-scale x echo-taucp) grid point on the "
                         "device and save them as .npz; "
                         "python -m mri_nanoparticle_simulation_tpu_torch"
                         ".analysis --echoes NPZ --bootstrap N then gives "
                         "walker-bootstrap T2 confidence intervals for "
                         "the whole grid with no record ever existing")
    ap.add_argument("--stream-plane", action="store_true",
                    help="with --moment-scales/--echo-taucps: reconstruct "
                         "the plane INCREMENTALLY per sprint "
                         "(decompose.StreamingPlane) instead of "
                         "materializing the per-walker record — host "
                         "memory drops from 8 bytes x windows x waters "
                         "(32 GB at 100k walkers x 40k windows) to "
                         "O(taucps x waters).  Same curves to f64 "
                         "rounding; incompatible with --dump-record "
                         "(there is no record to save).  With "
                         "--checkpoint the stream is DURABLE: walker "
                         "and plane state snapshot into one atomic "
                         "file every --checkpoint-every sprints, and "
                         "re-running the same command after a process "
                         "death resumes bitwise")
    ap.add_argument("--record-dir", default=None, metavar="DIR",
                    help="with --moment-scales/--echo-taucps: stream the "
                         "per-walker record to a DISK-backed store "
                         "directory (io/record.py) instead of host RAM "
                         "and --dump-record's end-of-run .npz — host "
                         "memory stays one sprint block regardless of "
                         "record size, and with --checkpoint/"
                         "--checkpoint-every the run RESUMES after a "
                         "process death (re-run the same command; the "
                         "record overhang past the checkpoint is "
                         "trimmed and the result is bitwise-identical "
                         "to an uninterrupted run).  Every record "
                         "consumer (the analysis CLI's --record, "
                         "decompose.reconstruct_record) accepts the "
                         "directory in place of the .npz")
    ap.add_argument("--fit-r2", default=None, metavar="PATH",
                    help="with --echo-taucps: fit each grid point's "
                         "spin-echo envelope (analysis.fit_t2 at "
                         "t = 2k*taucp) and write the CPMG dispersion "
                         "table mscale,taucp_ms,r2_per_ms,t2_ms,"
                         "r_squared,n_echoes to PATH — R2(taucp) is the "
                         "quantity MRI relaxometry experiments measure, "
                         "here from ONE simulation; grid points whose "
                         "envelope cannot be fit (too few echoes, no "
                         "decay) get nan rows")
    ap.add_argument("--dump-field", default=None, metavar="PATH",
                    help="write B_z on a uniform lattice over the scene "
                         "to PATH as x,y,z,Bz rows and exit — the "
                         "reference's DEBUG_FIELD product "
                         "(octree.cpp:435-449) as a runtime flag")
    ap.add_argument("--dump-field-n", type=int, default=32,
                    help="lattice points per box edge for --dump-field")
    ap.add_argument("--scene-file", default=None, metavar="PATH",
                    help="simulate a user-provided geometry: a .csv of "
                         "x,y,z cell centers (µm; dipoles, images, "
                         "lookup table and waters are built around "
                         "them — num_cells follows the file), or a "
                         ".npz scene archive from scene.save_scene "
                         "(exact array round trip; params must match). "
                         "The reference hard-codes its generator "
                         "(BacteriaBox.cpp) — geometry here is runtime "
                         "data")
    ap.add_argument("--dump-stats", default=None, metavar="PATH",
                    help="write the scene statistics CSV (MNPs, waters, "
                         "cells) to PATH and exit — the reference's "
                         "SimboxTest / print_simulation_stats product "
                         "(SimulationBox.cpp:214-237) as a runtime flag")
    ap.add_argument("--save-scene", default=None, metavar="NPZ",
                    help="archive the run's exact scene (cells, MNPs + "
                         "images, waters, lookup table) as a .npz "
                         "before simulating — reload it with "
                         "--scene-file")
    ap.add_argument("--ensemble", type=int, default=1, metavar="N",
                    help="run N independent trials (scenes seeded "
                         "scene-seed..scene-seed+N-1) and write the "
                         "ensemble-averaged curve — the reference's "
                         "'multitrial' PBS-resubmission workflow "
                         "(T2_GPU_sim.cu:45) as one device computation")
    ap.add_argument("--sweep", default=None, metavar="KNOB",
                    help="sweep a numeric Params knob over --sweep-values, "
                         "writing one CSV per value; mmoment/taucp/cell_r, "
                         "D (global diffusion scale: v scales D_cell "
                         "and D_extra together) and P (membrane "
                         "permeability µm/ms via the parameters.h:116-117 "
                         "formulas) ride runtime launch "
                         "scalars so the whole sweep shares ONE compiled "
                         "program (the reference re-ran nvcc per value, "
                         "README.md:13)")
    ap.add_argument("--sweep-values", default=None, metavar="V1,V2,...",
                    help="comma-separated values for --sweep")
    ap.add_argument("--sweep-grid", default=None, metavar="SPEC",
                    help="cross-product sweep over launch-scalar knobs "
                         "in ONE compiled program, e.g. "
                         "'D=0.25,0.5,1;taucp=0.001,0.002' runs every "
                         "combination as a trial (the full dispersion "
                         "surface; knobs: mmoment/taucp/cell_r/D); "
                         "writes one CSV per grid point and composes "
                         "with --paired/--trials-per-value/--fit-t2")
    ap.add_argument("--fit-t2", default=None, metavar="PATH",
                    help="with --sweep: fit each value's mean curve "
                         "(spin-echo envelope at its taucp) and write "
                         "the dispersion table "
                         "KNOB,r2_per_ms,t2_ms,r_squared,n_echoes to "
                         "PATH — e.g. R2(D) from --sweep D, or R2(taucp) "
                         "by fresh simulation (--echo-taucps + --fit-r2 "
                         "gets the same axis from ONE run)")
    ap.add_argument("--paired", action="store_true",
                    help="with --sweep: give trial k of every value the "
                         "same scene and the same RNG stream (common "
                         "random numbers), so differences along the "
                         "sweep axis are the knob's effect alone — "
                         "Monte-Carlo noise cancels in contrasts")
    ap.add_argument("--trials-per-value", type=int, default=1,
                    help="independent trials averaged per sweep value")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler device trace of the run "
                         "to DIR (DIR/trace.json, chrome://tracing- or "
                         "Perfetto-viewable; the port's spans tallied in "
                         "DIR/spans.json) — kernel-level "
                         "observability the reference's Timer never had")
    return ap


def params_from_args(ap: argparse.ArgumentParser, args) -> Params:
    """The run's Params from parsed flags, as the reference CLI builds
    them (sim.py:808-836): chunk and sprint sizes fitted to the step
    count, then the permeability flags."""
    params = Params(
        num_water=args.num_water, num_cells=args.num_cells,
        totaltime=args.totaltime, taucp=args.taucp, mmoment=args.mmoment,
        cell_r=args.cell_r, kick_mode=args.kick_mode,
        chunk_steps=args.chunk_steps, near_k=args.near_k,
        sprint_steps=args.sprint_steps, max_neighbors=args.max_neighbors,
        hash_dim=args.hash_dim, tau=args.tau,
        cube_candidates=args.cube_candidates,
        far_table_order=args.far_table_order,
        field_mode=args.field_mode, grid_n=args.grid_n)
    if args.gradient:
        try:
            g = tuple(float(v) for v in args.gradient.split(","))
            if len(g) != 3:
                raise ValueError(args.gradient)
        except ValueError:
            ap.error("--gradient wants three comma-separated numbers "
                     "(GX,GY,GZ in T/µm)")
        params = params.replace(b0_gradient=g)
    params = params.replace(
        chunk_steps=fit_chunk_steps(params, args.chunk_steps))
    params = params.replace(
        sprint_steps=fit_sprint_steps(params, args.sprint_steps))
    if args.permeable:
        params = params.with_permeability()
    if args.impermeable:
        params = params.impermeable()
    return params.validate()


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.rng is None:
        # the runner's generator on each engine (the scan engine draws
        # Threefry only)
        args.rng = cuda_engine.RNG_HARDWARE if args.engine == "pallas" \
            else cuda_engine.RNG_THREEFRY
    params = params_from_args(ap, args)
    params, build_scene = _scene_builder(ap, args, params)

    if args.dump_field:
        from ..fields import debug as dbg
        sc = build_scene() or BacteriaBox(params,
                                          seed=args.scene_seed).populate()
        dbg.dump_field_csv(sc.mnps, params, args.dump_field,
                           grid_n=args.dump_field_n, device=args.device)
        print(f"Field dump written: {args.dump_field} "
              f"({args.dump_field_n}^3 points)", file=sys.stderr)
        return 0
    if args.dump_stats:
        sc = build_scene() or BacteriaBox(params,
                                          seed=args.scene_seed).populate()
        sc.write_stats(args.dump_stats)
        print(f"Scene statistics written: {args.dump_stats}",
              file=sys.stderr)
        return 0

    csv_path = args.out or writer_mod.default_output_path(params)
    print(f"Starting simulation on {args.device}...\nPrinting to: "
          f"{csv_path}", file=sys.stderr)
    _check_flags(ap, args)
    if args.sweep_grid:
        return _run_grid_cli(ap, args, params, csv_path)
    if args.sweep:
        return _run_sweep_cli(ap, args, params, csv_path)
    if args.ensemble > 1:
        return _run_ensemble_cli(args, params, csv_path)
    if args.moment_scales or args.echo_taucps:
        return _run_decomposition_cli(ap, args, params, csv_path,
                                      build_scene)

    mesh = None
    if args.shard_walkers:
        mesh = sharding.make_walker_mesh(sharding.local_devices(args.device))
        print(f"Sharding walkers over {mesh.shape[sharding.WALKER_AXIS]} "
              f"device(s)", file=sys.stderr)

    def make_runner():
        return SimulationRunner(params, scene_seed=args.scene_seed,
                                seed=args.seed, device=args.device,
                                engine=args.engine, rng_impl=args.rng,
                                scene=build_scene(), mesh=mesh)

    if args.max_retries:
        with profiling.device_trace(args.trace, args.device):
            _, _, _, stats = resilience.run_resilient(
                make_runner, csv_path=csv_path, quadrature=args.quadrature,
                checkpoint_path=args.checkpoint,
                checkpoint_every_sprints=args.checkpoint_every,
                drain_depth=args.drain_depth, max_retries=args.max_retries,
                drain_timeout_s=args.drain_timeout)
        if stats.get("recovery_attempts"):
            print(f"Recovered from {stats['recovery_attempts']} "
                  f"failure(s)", file=sys.stderr)
    else:
        runner = make_runner()
        if args.resume:
            runner.resume(args.resume)
            resilience.trim_csv_overhang(runner, csv_path)
        with profiling.device_trace(args.trace, args.device):
            _, _, _, stats = runner.run(
                csv_path=csv_path, quadrature=args.quadrature,
                checkpoint_path=args.checkpoint,
                checkpoint_every_sprints=args.checkpoint_every,
                drain_depth=args.drain_depth,
                drain_timeout_s=args.drain_timeout)
    _trace_written(args)
    print(f"Simulation complete: {stats['steps']} steps in "
          f"{stats['wall_s']:.1f}s "
          f"({stats['walker_steps_per_s']:.3e} walker-steps/s), "
          f"{stats['escapes']} chunk escapes, "
          f"{stats['coverage_violations']} coverage violations",
          file=sys.stderr)
    return 0


def _scene_builder(ap, args, params: Params):
    """(params, build_scene): the reference CLI's scene branch
    (sim.py:838-865).  ``build_scene()`` returns the --scene-family /
    --scene-file geometry, or None for the runner's default BacteriaBox;
    with --save-scene it archives the scene it returns (the default one
    included).  A CSV scene file sets num_cells."""
    from ..scene import io as scene_io
    custom_cells = None
    if args.scene_file:
        if args.scene_family != "bacteria":
            ap.error("--scene-file IS the geometry; drop --scene-family")
        if not args.scene_file.endswith(".npz"):
            custom_cells = scene_io.load_cells_csv(args.scene_file)
            if len(custom_cells) != params.num_cells:
                # the file defines the cell count; --num-cells is the
                # generator knob
                params = params.replace(
                    num_cells=len(custom_cells)).validate()

    def build_scene():
        if args.scene_file:
            if args.scene_file.endswith(".npz"):
                return scene_io.load_scene(args.scene_file, params)
            return scene_io.CustomBox(params, custom_cells,
                                      seed=args.scene_seed).populate()
        if args.scene_family == "clustered":
            return ClusteredBacteriaBox(
                params, seed=args.scene_seed, n_clusters=args.n_clusters,
                cluster_sigma=args.cluster_sigma).populate()
        if args.scene_family == "fcc":
            return FCCLatticeBox(params, seed=args.scene_seed,
                                 lattice_a=args.lattice_a).populate()
        return None

    if not args.save_scene:
        return params, build_scene
    if not args.save_scene.endswith(".npz"):
        args.save_scene += ".npz"    # np.savez appends it anyway

    def build_and_save():
        sc = build_scene() or BacteriaBox(params,
                                          seed=args.scene_seed).populate()
        scene_io.save_scene(sc, args.save_scene)
        print(f"Scene archived: {args.save_scene}", file=sys.stderr)
        return sc

    return params, build_and_save


def _check_flags(ap, args) -> None:
    """The reference CLI's rules for the sweep, ensemble, checkpoint,
    recovery, decomposition and scene flags, in its order and words
    (sim.py:908-1049 and 1105-1109, those of the flags the port has)."""
    decomp_mode = bool(args.moment_scales or args.echo_taucps)
    sweepish = bool(args.sweep or args.sweep_grid)
    if args.sweep and args.sweep_grid:
        ap.error("--sweep is one knob, --sweep-grid a cross product; "
                 "use one")
    durable_decomp = decomp_mode and (args.record_dir
                                      or (args.stream_plane
                                          and args.checkpoint))
    if (sweepish or args.ensemble > 1 or decomp_mode) and \
            (args.checkpoint or args.resume or args.checkpoint_every
             or args.max_retries) and not durable_decomp:
        ap.error("--checkpoint/--resume/--max-retries are single-run "
                 "features; drop them for --ensemble/--sweep/"
                 "--moment-scales/--echo-taucps runs (decomposition "
                 "runs checkpoint through --record-dir, streaming "
                 "runs through --stream-plane --checkpoint)")
    if durable_decomp and (args.resume or args.max_retries):
        ap.error("--record-dir resumes automatically when its "
                 "checkpoint exists; drop --resume/--max-retries")
    if args.record_dir:
        if not decomp_mode:
            ap.error("--record-dir stores a phase-decomposition record; "
                     "run with --moment-scales and/or --echo-taucps")
        if args.dump_record:
            ap.error("--record-dir IS the saved record; drop "
                     "--dump-record")
        if args.stream_plane:
            ap.error("--stream-plane never materializes the record; "
                     "drop --record-dir (or drop --stream-plane to "
                     "store the record)")
        if args.checkpoint_every and not args.checkpoint:
            ap.error("--checkpoint-every needs --checkpoint PATH")
        d = os.path.dirname(os.path.abspath(args.record_dir)) or "."
        if not os.path.isdir(d):
            ap.error(f"--record-dir parent directory does not exist: {d}")
    if decomp_mode and (sweepish or args.ensemble > 1):
        ap.error("--moment-scales/--echo-taucps are themselves sweeps "
                 "over the (moment, taucp) plane; drop --sweep/--ensemble")
    if decomp_mode and args.shard_walkers and not args.plane_device:
        ap.error("--moment-scales/--echo-taucps record per-walker phase "
                 "components on one device; drop --shard-walkers (or add "
                 "--plane-device, whose sharded plane folding keeps the "
                 "record distributed with its walkers)")
    if args.fit_r2 and not args.echo_taucps:
        ap.error("--fit-r2 is the dispersion over the --echo-taucps "
                 "grid; pass the echo spacings to fit")
    if args.plane_device:
        if not decomp_mode:
            ap.error("--plane-device computes a phase-decomposition "
                     "plane; run with --moment-scales and/or "
                     "--echo-taucps")
        for bad, flag in ((args.stream_plane, "--stream-plane"),
                          (args.dump_record, "--dump-record"),
                          (args.record_dir, "--record-dir"),
                          (args.checkpoint, "--checkpoint")):
            if bad:
                ap.error(f"--plane-device keeps the record on the "
                         f"device; {flag} needs the host/disk record "
                         f"paths — drop one of the two")
    if args.dump_echoes and not args.plane_device:
        ap.error("--dump-echoes captures spin-echo matrices during an "
                 "on-device plane run; add --plane-device (record-based "
                 "paths bootstrap from the record itself, mri-t2-fit "
                 "--record)")
    if args.stream_plane:
        if not decomp_mode:
            ap.error("--stream-plane streams a phase-decomposition "
                     "reconstruction; run with --moment-scales and/or "
                     "--echo-taucps")
        if args.dump_record:
            ap.error("--stream-plane never materializes the record; "
                     "drop --dump-record (or drop --stream-plane to "
                     "save the record)")
    if args.dump_record:
        if not decomp_mode:
            ap.error("--dump-record saves a phase-decomposition record; "
                     "run with --moment-scales and/or --echo-taucps")
        d = os.path.dirname(os.path.abspath(args.dump_record)) or "."
        if not os.path.isdir(d):
            # fail fast: discovering an unwritable path AFTER a
            # multi-hour decomposition run would lose everything
            ap.error(f"--dump-record directory does not exist: {d}")
        if not args.dump_record.endswith(".npz"):
            args.dump_record += ".npz"   # np.savez appends it anyway
    if args.max_retries:
        if args.max_retries < 0:
            ap.error("--max-retries must be >= 0")
        if not (args.checkpoint and args.checkpoint_every >= 1):
            ap.error("--max-retries needs --checkpoint PATH and "
                     "--checkpoint-every N>=1 (recovery resumes from "
                     "the last checkpoint)")
        if args.resume:
            ap.error("--max-retries auto-resumes from --checkpoint when "
                     "it exists; drop --resume")
        if not args.out:
            ap.error("--max-retries needs an explicit --out: the "
                     "default output filename embeds a timestamp, so a "
                     "re-run after a process death would resume the "
                     "checkpoint but write its rows to a NEW file")
    if args.resume and not args.out:
        ap.error("--resume needs an explicit --out (the CSV being "
                 "continued): the default output filename embeds a "
                 "timestamp, so the resumed rows would land in a NEW "
                 "file while the original keeps its untrimmed overhang")
    if args.shard_walkers and (sweepish or args.ensemble > 1):
        ap.error("--shard-walkers shards ONE population; for "
                 "ensembles/sweeps use --walker-shards N (the 2D "
                 "trials x walkers mesh)")
    if args.walker_shards != 1:
        if args.walker_shards < 1:
            ap.error("--walker-shards must be >= 1")
        if not (sweepish or args.ensemble > 1):
            ap.error("--walker-shards is the ensemble/sweep 2D-mesh "
                     "knob; single runs shard with --shard-walkers")
    if (args.scene_family != "bacteria" or args.scene_file
            or args.save_scene) and (sweepish or args.ensemble > 1):
        ap.error("--scene-family/--scene-file/--save-scene are "
                 "single-run features (ensembles/sweeps build their "
                 "per-trial BacteriaBox scenes internally)")
    if args.paired and not sweepish:
        ap.error("--paired is a --sweep/--sweep-grid modifier (common "
                 "random numbers across sweep values)")
    if args.fit_t2 and not sweepish:
        ap.error("--fit-t2 is the dispersion over the --sweep/"
                 "--sweep-grid axes; pass the knob(s) and values to "
                 "sweep (the echo axis has --echo-taucps + --fit-r2)")
    if args.sweep_grid and args.ensemble > 1:
        ap.error("--sweep-grid runs --trials-per-value trials per "
                 "grid point; drop --ensemble")
    if args.sweep:
        if not args.sweep_values:
            ap.error("--sweep requires --sweep-values")
        if args.ensemble > 1:
            ap.error("--sweep runs --trials-per-value trials per value; "
                     "drop --ensemble")


def _grid_axes(ap, args) -> dict:
    """{knob: values} of --sweep-grid, with the reference CLI's errors
    (sim.py:1051-1067)."""
    axes = {}
    try:
        for part in args.sweep_grid.split(";"):
            knob, eq, vals = part.partition("=")
            knob = knob.strip()
            if not eq or knob in axes:
                raise ValueError(part)
            axes[knob] = [float(v) for v in vals.split(",")]
            if knob == "D" and any(not v > 0 for v in axes[knob]):
                ap.error("--sweep-grid D values must be > 0")
    except ValueError:
        ap.error("--sweep-grid wants 'KNOB=V1,V2;KNOB2=V1,V2' with "
                 "distinct knobs and numeric values")
    bad = [n for n in axes if n not in ens.SCALAR_AXES]
    if bad:
        ap.error(f"--sweep-grid knobs must be launch scalars "
                 f"{ens.SCALAR_AXES}; got {bad}")
    return axes


def _sweep_values(ap, args, params: Params) -> list:
    """The values of --sweep's knob from --sweep-values, with the
    reference CLI's errors (sim.py:1110-1147)."""
    name = args.sweep
    if name in ("Gz", "D", "P"):
        # Gz: the z background gradient, T/µm (static in the kernels);
        # D: the diffusion scale and P the membrane permeability, µm/ms,
        # both launch scalars
        values = [float(v) for v in args.sweep_values.split(",")]
        if name == "D" and any(not v > 0 for v in values):
            ap.error("--sweep D values must be > 0 (diffusion scale)")
        if name == "P":
            for v in values:
                try:
                    params.reflect_pair(v)
                except ValueError as e:
                    ap.error(f"--sweep P: {e}")
        return values
    # real dataclass fields only: derived read-only properties (tcp, t,
    # in_stdev, ...) cannot be replaced
    if name not in {f.name for f in dataclasses.fields(params)}:
        ap.error(f"unknown Params knob {name!r} (must be a "
                 f"settable field, not a derived property, or "
                 f"'D' for the global diffusion scale)")
    cast = type(getattr(params, name))
    if cast not in (int, float):
        ap.error(f"--sweep only supports numeric knobs; {name!r} "
                 f"is {cast.__name__}")
    return [cast(float(v)) for v in args.sweep_values.split(",")]


def _trace_written(args) -> None:
    if args.trace:
        print(f"Profiler trace written to {args.trace}", file=sys.stderr)


def _run_grid_cli(ap, args, params: Params, csv_path: str) -> int:
    """--sweep-grid: every combination of the axes' values as trials of
    one ensemble, one CSV per grid point (sim.py:1046-1102)."""
    axes = _grid_axes(ap, args)
    t0 = time.perf_counter()
    with profiling.device_trace(args.trace, args.device):
        times, curves = ens.run_parameter_grid(
            params, axes, n_trials_each=args.trials_per_value,
            base_seed=args.scene_seed, run_seed=args.seed + 1000,
            engine=args.engine, rng_impl=args.rng, paired=args.paired,
            walker_shards=args.walker_shards, quadrature=args.quadrature,
            device=args.device)
    wall = time.perf_counter() - t0
    names = list(axes)
    flat = curves.reshape((-1, args.trials_per_value)
                          + curves.shape[len(axes) + 1:])
    combos = list(itertools.product(*[axes[n] for n in names]))

    def pv_fn(combo):
        pv = params
        for n, v in zip(names, combo):
            pv = ens.sweep_params_for(pv, n, v)
        return pv

    _emit_sweep_outputs(csv_path, times, names, combos, flat, pv_fn,
                        args.fit_t2, quadrature=args.quadrature)
    n_runs = len(combos) * args.trials_per_value
    rate = n_runs * params.t * params.num_water / wall
    print(f"Grid sweep complete: {len(combos)} grid points x "
          f"{args.trials_per_value} trial(s) in {wall:.1f}s "
          f"({rate:.3e} walker-steps/s)", file=sys.stderr)
    _trace_written(args)
    return 0


def _run_sweep_cli(ap, args, params: Params, csv_path: str) -> int:
    """--sweep: --trials-per-value trials per value of one knob, one CSV
    per value (sim.py:1104-1173)."""
    name = args.sweep
    values = _sweep_values(ap, args, params)
    t0 = time.perf_counter()
    with profiling.device_trace(args.trace, args.device):
        times, curves = ens.run_parameter_sweep(
            params, name, values, n_trials_each=args.trials_per_value,
            base_seed=args.scene_seed, run_seed=args.seed + 1000,
            engine=args.engine, rng_impl=args.rng, paired=args.paired,
            walker_shards=args.walker_shards, quadrature=args.quadrature,
            device=args.device)
    wall = time.perf_counter() - t0
    _emit_sweep_outputs(
        csv_path, times, [name], [(v,) for v in values], curves,
        lambda combo: ens.sweep_params_for(params, name, combo[0]),
        args.fit_t2, quadrature=args.quadrature)
    n_runs = len(values) * args.trials_per_value
    rate = n_runs * params.t * params.num_water / wall
    print(f"Sweep complete: {len(values)} values x "
          f"{args.trials_per_value} trial(s) in {wall:.1f}s "
          f"({rate:.3e} walker-steps/s)", file=sys.stderr)
    _trace_written(args)
    return 0


def _run_ensemble_cli(args, params: Params, csv_path: str) -> int:
    """--ensemble N: N trials, the mean curve in one CSV
    (sim.py:1175-1196)."""
    t0 = time.perf_counter()
    with profiling.device_trace(args.trace, args.device):
        times, cos, sin, _ = ens.run_ensemble(
            params, n_trials=args.ensemble, base_seed=args.scene_seed,
            run_seed=args.seed + 1000, engine=args.engine,
            rng_impl=args.rng, walker_shards=args.walker_shards,
            device=args.device)
    wall = time.perf_counter() - t0
    with writer_mod.T2CsvWriter(csv_path, params, args.quadrature) as w:
        wins = np.stack([cos.mean(axis=0), sin.mean(axis=0)], -1)
        w.append_windows(0, wins)
    rate = args.ensemble * params.t * params.num_water / wall
    print(f"Ensemble complete: {args.ensemble} trials x {params.t} "
          f"steps in {wall:.1f}s ({rate:.3e} walker-steps/s)",
          file=sys.stderr)
    _trace_written(args)
    return 0


def _run_decomposition_cli(ap, args, params: Params, csv_path: str,
                           build_scene) -> int:
    """``--moment-scales`` / ``--echo-taucps``: one decomposition run, one
    CSV per (scale, taucp) grid point, and optionally the record
    (``--dump-record``), the spin-echo captures (``--dump-echoes``) and
    the CPMG dispersion table (``--fit-r2``); the reference CLI's
    sim.py:1198-1395 on its record, streaming and on-device plane
    paths, the record on disk with ``--record-dir`` and the stream
    durable with ``--stream-plane --checkpoint``."""
    if params.field_mode == FIELD_GRID:
        ap.error("--moment-scales/--echo-taucps need the production "
                 "expansion backend (the grid backend is a "
                 "cross-validation oracle)")
    try:
        scales = ([float(v) for v in args.moment_scales.split(",")]
                  if args.moment_scales else [1.0])
        taucps = ([float(v) for v in args.echo_taucps.split(",")]
                  if args.echo_taucps else None)
    except ValueError:
        ap.error("--moment-scales/--echo-taucps must be "
                 "comma-separated lists of numbers")
    for s in scales:
        # fail fast on scales the single-run path would reject
        params.replace(mmoment=params.mmoment * s).validate()
    for t_cp in taucps or ():
        # fail fast on sub-window / misaligned echo spacings
        params.replace(taucp=t_cp).validate()
    taucps_eff = taucps if taucps is not None else [params.taucp]
    echo_pairs = []
    if args.dump_echoes:
        # every grid point whose first spin echo (t = 2 taucp) fits
        # inside the run; the others cannot be bootstrapped
        for s in scales:
            for t_cp in taucps_eff:
                if 2.0 * t_cp <= params.totaltime:
                    echo_pairs.append((s, t_cp))
                else:
                    print(f"  --dump-echoes: skipping mscale={s:g} "
                          f"taucp={t_cp:g} (no spin echo inside "
                          f"{params.totaltime:g} ms)", file=sys.stderr)
        if not echo_pairs:
            ap.error("--dump-echoes: no (scale, taucp) grid point hosts a "
                     "spin echo inside the run")
    device = torch.device(args.device)
    if device.type == "cuda":
        require_cuda()
    sc = build_scene() or BacteriaBox(params,
                                      seed=args.scene_seed).populate()
    cache = None
    if args.engine == "pallas" and cuda_engine.needs_cache(
            params.num_water, len(sc.mnps)):
        tbl = mnp_table(sc.mnps, torch.float32, device)
        cache = expansion.build_cache(tbl.pos, tbl.m, params)
    t0 = time.perf_counter()
    with profiling.device_trace(args.trace, args.device):
        t_rec = None
        if args.plane_device:
            plane_mesh = None
            if args.shard_walkers:
                plane_mesh = sharding.make_walker_mesh(
                    sharding.local_devices(args.device))
                print(f"Sharding walkers + plane folding over "
                      f"{plane_mesh.shape[sharding.WALKER_AXIS]} device(s)",
                      file=sys.stderr)
            times, curves, stats, echoes = dec.run_plane_on_device(
                sc, params, scales, taucps, seed=args.seed, device=device,
                engine=args.engine, rng_impl=args.rng,
                echo_pairs=echo_pairs, cache=cache, mesh=plane_mesh)
            res = dec.DecompositionResult(
                times_ms=times, A=np.zeros((0, params.num_water)),
                B=np.zeros((0, params.num_water)), stats=stats)
        elif args.stream_plane:
            plane = dec.StreamingPlane(params, params.t // params.pfreq,
                                       scales, taucps, quadrature=True)
            if args.checkpoint:
                # walker and plane state in one atomic snapshot; a re-run
                # after a process death resumes and ends bitwise the same
                stats = dec.run_streaming_durable(
                    sc, params, plane, args.checkpoint, seed=args.seed,
                    scene_seed=args.scene_seed, device=device,
                    engine=args.engine, rng_impl=args.rng,
                    snapshot_every_sprints=args.checkpoint_every or 1,
                    progress=True, cache=cache)
                res = dec.DecompositionResult(
                    times_ms=plane.times_ms, A=np.zeros((0, params.num_water)),
                    B=np.zeros((0, params.num_water)), stats=stats)
            else:
                res = dec.run_decomposition(sc, params, seed=args.seed,
                                            device=device,
                                            engine=args.engine,
                                            rng_impl=args.rng,
                                            consumer=plane, cache=cache)
            curves = plane.result()          # [s, t, n, 2], walker means
        else:
            if args.record_dir:
                # a store on disk with checkpoint/resume; A and B come back
                # as read-only memmaps the reconstruction streams from
                res = dec.run_decomposition_durable(
                    sc, params, args.record_dir, seed=args.seed,
                    scene_seed=args.scene_seed, device=device,
                    engine=args.engine, rng_impl=args.rng,
                    checkpoint_path=args.checkpoint,
                    checkpoint_every_sprints=args.checkpoint_every or 1,
                    progress=True, cache=cache)
                print(f"Decomposition record stored: {args.record_dir} "
                      f"(A/B {res.A.shape})", file=sys.stderr)
            else:
                res = dec.run_decomposition(sc, params, seed=args.seed,
                                            device=device,
                                            engine=args.engine,
                                            rng_impl=args.rng, cache=cache)
            t_rec = time.perf_counter()
            curves = dec.record_products(
                res, params, scales, taucps, csv_path,
                quadrature=args.quadrature, fit_r2=args.fit_r2, log=_say)
    wall = time.perf_counter() - t0
    recon_s = 0.0 if t_rec is None else t0 + wall - t_rec
    if t_rec is None:
        # the plane and stream branches' products, as the record's
        dec.write_curves(curves, params, scales, taucps, csv_path,
                         args.quadrature, log=_say)
        if args.fit_r2:
            dec.write_dispersion(args.fit_r2, res.times_ms, curves, scales,
                                 taucps_eff, params.num_water, log=_say)
            _say(f"CPMG dispersion table written: {args.fit_r2}")
    if args.dump_record:
        # after the CSVs: a dump failure must never cost the run's
        # primary products
        np.savez_compressed(
            args.dump_record, times_ms=res.times_ms, A=res.A, B=res.B,
            params_fp=params_fingerprint(params), mmoment=params.mmoment,
            seed=args.seed, taucp=params.taucp, tau=params.tau,
            pfreq=params.pfreq)
        print(f"Decomposition record written: {args.dump_record} "
              f"(A/B {res.A.shape})", file=sys.stderr)
    if args.dump_echoes:
        # after the CSVs, like --dump-record
        dec.save_echoes(args.dump_echoes, echoes, seed=args.seed)
        print(f"Spin-echo capture written: {args.dump_echoes} "
              f"({len(echoes)} grid point(s); bootstrap with "
              f"mri-t2-fit --echoes)", file=sys.stderr)
    st = res.stats
    n_pts = len(scales) * len(taucps_eff)
    rate = params.t * params.num_water / wall if wall > 0 else 0.0
    # the run's own rate and the split: the device's sprints (with the
    # plane steps on --plane-device), the copies to the host (each
    # sprint's record, or the curves once after the run), the host's
    # work (on each sprint's record while the next sprint runs, or on
    # the curves), then the reconstruction and its products after the
    # run (the record branch)
    what = ("on-device plane run", "curve copy", "host after the run") \
        if args.plane_device else ("decomposition run", "record copy",
                                   "host per sprint")
    if "wall_s" in st:      # a complete durable store ran no sprint
        print(f"  {what[0]}: {st['wall_s']:.4f} s "
              f"({st['walker_steps_per_s']:.4e} walker-steps/s) over "
              f"{st['sprints']} sprints: device {st['device_s']:.4f} s, "
              f"{what[1]} {st['copy_s']:.4f} s, {what[2]} "
              f"{st['host_s']:.4f} s; reconstruction and products after "
              f"the run {recon_s:.4f} s", file=sys.stderr)
    _trace_written(args)
    print(f"(moment x taucp)-plane reconstruction complete: {n_pts} "
          f"grid point(s) from ONE {params.t}-step run in {wall:.1f}s "
          f"({rate:.3e} walker-steps/s), {st['escapes']} chunk escapes, "
          f"{st['coverage_violations']} coverage violations",
          file=sys.stderr)
    return 0


def _say(line: str) -> None:
    print(line, file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())

"""Simulation orchestrator: scene -> device -> sprints -> CSV.

Counterpart of the reference's ``engine/sim.py`` on its main path: build
the scene, prove the near list (and on large scenes the cube candidate
tables) cover it, build the large-scene cache once, run sprints of
chunk-kernel launches without syncing the host, drain the window sums
every ``drain_depth`` sprints, and stream the T2 curve to CSV.

Run as a CLI:
    python -m mri_nanoparticle_simulation_tpu_torch.engine.sim \
        --num-water 4032 --totaltime 40 --out t2.csv --device cuda
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from mri_nanoparticle_simulation_tpu.params import Params
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox

from ..fields import expansion
from ..io import writer as writer_mod
from ..utils.device import require_cuda
from . import chunk_kernel, cuda_engine
from .convert import key_words, mnp_table
from .reference_engine import init_state


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


class SimulationRunner:
    """Owns the scene, the sprint function, the large-scene cache and the
    walker state.

    ``device`` has no default, and a CUDA device without a card raises:
    the runner never moves to the CPU on its own.  ``rng_impl`` defaults
    to the fast generator, the reference runner's production default
    (``RNG_THREEFRY`` is the bit-reproducible validation path).
    ``cache_build_s`` is the wall time of the scene cache build (0 when
    the scene needs none)."""

    def __init__(self, params: Params, scene_seed: int = 0, seed: int = 0,
                 *, device, rng_impl: str = cuda_engine.RNG_HARDWARE,
                 check_coverage: bool = True, scene=None):
        self.params = params.validate()
        self.device = torch.device(device)
        if self.device.type == "cuda":
            require_cuda()
            chunk_kernel.load_library()   # the build is set-up, not run
        self.seed = seed
        self.scene_seed = scene_seed
        self.rng_impl = rng_impl
        self._sprint = cuda_engine.make_sprint_fn(
            params, params.num_water, self.device, rng_impl=rng_impl)
        self.scene = scene if scene is not None \
            else BacteriaBox(params, seed=scene_seed).populate()
        n_mnp = len(self.scene.mnps)
        cuda_engine.check_scene(params, n_mnp)
        self.uses_cubes = cuda_engine.needs_cache(params.num_water, n_mnp)
        if check_coverage:
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
        # the scene cache, once per scene rather than once per sprint
        self.cache = None
        self.cache_build_s = 0.0
        if self.uses_cubes:
            t0 = time.perf_counter()
            self.cache = expansion.build_cache(self.mnp_tbl.pos,
                                               self.mnp_tbl.m, params)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.cache_build_s = time.perf_counter() - t0
        self.key = key_words(seed)
        self.state = init_state(self.scene.waters, params, self.device)

    def run(self, csv_path: Optional[str] = None, quadrature: bool = False,
            progress: bool = True, max_steps: Optional[int] = None,
            drain_depth: int = 32):
        """Run from the current state to the end (or ``max_steps``),
        streaming CSV rows.  Sprints are queued without host syncs; the
        window sums of ``drain_depth`` sprints come back in one copy, so
        a crash loses at most that many sprints of rows.

        Returns (times_ms, sum_cos, sum_sin, stats)."""
        if drain_depth < 1:
            raise ValueError("drain_depth must be >= 1")
        p = self.params
        total = p.t if max_steps is None else min(p.t, max_steps)
        start_step = self.state.step
        n_sprints = (total - start_step) // p.sprint_steps
        win_per_sprint = p.sprint_steps // p.pfreq

        writer = None
        if csv_path is not None:
            writer = writer_mod.T2CsvWriter(csv_path, p, quadrature,
                                            append=start_step > 0)
            writer.__enter__()
        ss = cuda_engine.to_soa(self.state, p)
        t0 = time.perf_counter()
        pending, all_wins = [], []
        try:
            for i in range(n_sprints):
                ss, wins = self._sprint(self.mnp_tbl, self.key, ss,
                                        cache=self.cache)
                pending.append((start_step // p.pfreq + i * win_per_sprint,
                                wins))
                if len(pending) >= drain_depth:
                    self._drain(pending, writer, all_wins)
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
        self.state = cuda_engine.from_soa(ss, p.num_water)

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

    @staticmethod
    def _drain(pending, writer, all_wins):
        """All pending sprints' window sums in one device->host copy."""
        if not pending:
            return
        first_idx = pending[0][0]
        wins = torch.cat([w for _, w in pending]).cpu().numpy()
        pending.clear()
        all_wins.append(wins)
        if writer is not None:
            writer.append_windows(first_idx, wins)


def main(argv=None):
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
    ap.add_argument("--out", default=None,
                    help="CSV path (default: reference-style filename)")
    ap.add_argument("--quadrature", action="store_true",
                    help="also emit the sum-sin column")
    ap.add_argument("--rng", default=cuda_engine.RNG_HARDWARE,
                    choices=[cuda_engine.RNG_HARDWARE,
                             cuda_engine.RNG_THREEFRY],
                    help="RNG implementation: hardware (the default) is "
                         "the fast generator, Philox4x32-10 in place of "
                         "the TPU's hardware PRNG; threefry is the "
                         "bit-reproducible validation path")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails without a card")
    args = ap.parse_args(argv)

    params = Params(
        num_water=args.num_water, num_cells=args.num_cells,
        totaltime=args.totaltime, taucp=args.taucp, mmoment=args.mmoment,
        cell_r=args.cell_r, kick_mode=args.kick_mode,
        chunk_steps=args.chunk_steps, near_k=args.near_k,
        sprint_steps=args.sprint_steps, max_neighbors=args.max_neighbors,
        hash_dim=args.hash_dim, tau=args.tau,
        cube_candidates=args.cube_candidates,
        far_table_order=args.far_table_order)
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
    params.validate()

    csv_path = args.out or writer_mod.default_output_path(params)
    print(f"Starting simulation on {args.device}...\nPrinting to: "
          f"{csv_path}", file=sys.stderr)
    runner = SimulationRunner(params, scene_seed=args.scene_seed,
                              seed=args.seed, device=args.device,
                              rng_impl=args.rng)
    _, _, _, stats = runner.run(csv_path=csv_path,
                                quadrature=args.quadrature)
    print(f"Simulation complete: {stats['steps']} steps in "
          f"{stats['wall_s']:.1f}s "
          f"({stats['walker_steps_per_s']:.3e} walker-steps/s), "
          f"{stats['escapes']} chunk escapes, "
          f"{stats['coverage_violations']} coverage violations",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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

Run as a CLI:
    python -m mri_nanoparticle_simulation_tpu_torch.engine.sim \
        --num-water 4032 --totaltime 40 --out t2.csv --device cuda
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from .. import analysis
from ..fields import expansion
from ..io import writer as writer_mod
from ..params import Params, params_fingerprint
from ..scene import BacteriaBox
from ..utils.device import require_cuda
from . import chunk_kernel, cuda_engine
from . import decompose as dec
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
                         "(there is no record to save)")
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
    return params.validate()


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    params = params_from_args(ap, args)

    csv_path = args.out or writer_mod.default_output_path(params)
    print(f"Starting simulation on {args.device}...\nPrinting to: "
          f"{csv_path}", file=sys.stderr)
    _check_decomposition_flags(ap, args)
    if args.moment_scales or args.echo_taucps:
        return _run_decomposition_cli(ap, args, params, csv_path)
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


def _check_decomposition_flags(ap, args) -> None:
    """The reference CLI's rules for the decomposition flags, in its
    order and words (sim.py:953-995, those of the flags the port has)."""
    decomp_mode = bool(args.moment_scales or args.echo_taucps)
    if args.fit_r2 and not args.echo_taucps:
        ap.error("--fit-r2 is the dispersion over the --echo-taucps "
                 "grid; pass the echo spacings to fit")
    if args.plane_device:
        if not decomp_mode:
            ap.error("--plane-device computes a phase-decomposition "
                     "plane; run with --moment-scales and/or "
                     "--echo-taucps")
        for bad, flag in ((args.stream_plane, "--stream-plane"),
                          (args.dump_record, "--dump-record")):
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


def _run_decomposition_cli(ap, args, params: Params, csv_path: str) -> int:
    """``--moment-scales`` / ``--echo-taucps``: one decomposition run, one
    CSV per (scale, taucp) grid point, and optionally the record
    (``--dump-record``), the spin-echo captures (``--dump-echoes``) and
    the CPMG dispersion table (``--fit-r2``); the reference CLI's
    sim.py:1198-1395 on its record, streaming and on-device plane
    paths."""
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
    sc = BacteriaBox(params, seed=args.scene_seed).populate()
    cache = None
    if cuda_engine.needs_cache(params.num_water, len(sc.mnps)):
        tbl = mnp_table(sc.mnps, torch.float32, device)
        cache = expansion.build_cache(tbl.pos, tbl.m, params)
    t0 = time.perf_counter()
    t_rec = None
    if args.plane_device:
        times, curves, stats, echoes = dec.run_plane_on_device(
            sc, params, scales, taucps, seed=args.seed, device=device,
            rng_impl=args.rng, echo_pairs=echo_pairs, cache=cache)
        res = dec.DecompositionResult(
            times_ms=times, A=np.zeros((0, params.num_water)),
            B=np.zeros((0, params.num_water)), stats=stats)
    elif args.stream_plane:
        plane = dec.StreamingPlane(params, params.t // params.pfreq,
                                   scales, taucps, quadrature=True)
        res = dec.run_decomposition(sc, params, seed=args.seed,
                                    device=device, rng_impl=args.rng,
                                    consumer=plane, cache=cache)
        curves = plane.result()          # [s, t, n, 2], walker means
    else:
        res = dec.run_decomposition(sc, params, seed=args.seed,
                                    device=device, rng_impl=args.rng,
                                    cache=cache)
        t_rec = time.perf_counter()
        if taucps is None:
            curves = dec.curves_at_scales(res.A, res.B, scales,
                                          quadrature=True)
            # [s, 2, n] -> [s, 1, n, 2] so one writer loop serves both
            curves = np.moveaxis(curves, 1, -1)[:, None]
        else:
            curves = dec.curves_at_plane(res.A, res.B, scales, taucps,
                                         params, quadrature=True)
    wall = time.perf_counter() - t0
    recon_s = 0.0 if t_rec is None else t0 + wall - t_rec
    stem, ext = os.path.splitext(csv_path)
    for si, s in enumerate(scales):
        for ti, t_cp in enumerate(taucps_eff):
            pv = params.replace(mmoment=params.mmoment * s,
                                taucp=t_cp).validate()
            path = f"{stem}_mscale={s:g}"
            if taucps is not None:
                path += f"_taucp={t_cp:g}"
            path += ext or ".csv"
            # walker MEANS -> the reference schema's walker SUMS
            # (cuda_sim.cu:1013,1022)
            wins = curves[si, ti] * params.num_water
            with writer_mod.T2CsvWriter(path, pv,
                                        quadrature=args.quadrature) as w:
                w.append_windows(0, wins)
            print(f"  mscale={s:g} taucp={t_cp:g}: wrote {path}",
                  file=sys.stderr)
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
    if args.fit_r2:
        _write_dispersion(args.fit_r2, res.times_ms, curves, scales,
                          taucps_eff, params.num_water)
        print(f"CPMG dispersion table written: {args.fit_r2}",
              file=sys.stderr)
    st = res.stats
    n_pts = len(scales) * len(taucps_eff)
    rate = params.t * params.num_water / wall if wall > 0 else 0.0
    # the run's own rate and the split: the device's sprints (with the
    # plane steps on --plane-device), the copies to the host (each
    # sprint's record, or the curves once after the run), the host's
    # work (on each sprint's record while the next sprint runs, or on
    # the curves), then the reconstruction after the run
    what = ("on-device plane run", "curve copy", "host after the run") \
        if args.plane_device else ("decomposition run", "record copy",
                                   "host per sprint")
    print(f"  {what[0]}: {st['wall_s']:.4f} s "
          f"({st['walker_steps_per_s']:.4e} walker-steps/s) over "
          f"{st['sprints']} sprints: device {st['device_s']:.4f} s, "
          f"{what[1]} {st['copy_s']:.4f} s, {what[2]} "
          f"{st['host_s']:.4f} s; reconstruction after the run "
          f"{recon_s:.4f} s", file=sys.stderr)
    print(f"(moment x taucp)-plane reconstruction complete: {n_pts} "
          f"grid point(s) from ONE {params.t}-step run in {wall:.1f}s "
          f"({rate:.3e} walker-steps/s), {st['escapes']} chunk escapes, "
          f"{st['coverage_violations']} coverage violations",
          file=sys.stderr)
    return 0


def _write_dispersion(path, times_ms, curves, scales, taucps, num_water):
    """The CPMG dispersion table: a T2 fit of each grid point's spin-echo
    envelope, nan rows where it cannot be fit."""
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
                    print(f"  fit-r2: mscale={s:g} taucp={t_cp:g} "
                          f"unfittable ({e})", file=sys.stderr)
                    f.write(f"{s:g},{t_cp:g},nan,nan,nan,0,nan\n")


if __name__ == "__main__":
    sys.exit(main())

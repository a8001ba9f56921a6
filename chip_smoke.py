#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

Drives the port's paths (the reference headline T2 run, and the 100k x
2000 scale-up run on the large-scene path, each on the Threefry and on
the fast generator; the physics variants through the golden arms; the
phase-decomposition runs of README configuration 5c) through the
hand-written CUDA kernels, phase by phase; each phase prints what it
measured, and any failure raises (exit code != 0, no final line):

1. device: the card, its power limit, the torch/CUDA versions;
2. build: compile every csrc/*.cu with nvcc (one process per source, in
   parallel), print seconds and registers/spills of every entry and
   chunk-kernel mode (Threefry or fast generator, default physics or
   variants), each for K = 1..16; then csrc/math_check.cu: the kernels'
   sqrt_fast, rsqrt_ftz, rcp_fast and sincos_fast bitwise sqrtf's,
   rsqrtf's, 1.f / x's, sinf's and cosf's over every float input each
   can see;
3. rebuild kernel vs plain version (engine/cuda_engine.chunk_reference)
   on the same CUDA inputs at the main path's shapes, 50 and 4032
   walkers, in the split layout (128 blocks at 4032, each a chain warp, a
   field warp and the generator warps): the state bitwise equal, window sums within
   0.05, escapes and coverage equal, two kernel runs bitwise equal; times
   of both; then above the split layout's threshold (walkers from the
   occupancy API and the SM count), where it takes the flat layout;
4. the main path at full width on Threefry: SimulationRunner on the
   4032-water, 270-cell scene (seed 42), 2e6 steps, counting kernel
   launches;
5. physics at production width on Threefry: the reference's own scene
   dumps golden/testdata/scene_6000 and scene_6001 (moment x60, 8
   Carr-Purcell flips) against the reference oracle's curves, one rep
   each, with every gate of tests/test_golden_full.py (the port's copies
   in its golden module): per seed RMS, final, early and late windows,
   depth, and the tightened oracle's RMS and late mean (seed 6000);
   across seeds the final and late means;
6. the large-scene kernels vs their plain versions on the scale-up scene
   (5253 dipoles), first on its first 4096 waters: candidate-model (near
   slots equal but for d^2 ties, taylor within 1e-5 of the largest
   |component|, n_reach equal), far sums (1e-5 relative), near/taylor
   chunk (positions 1e-4, window sums 0.05, escapes equal), two kernel
   runs bitwise equal; the far table's build time, the f32 table within
   1e-4 of the same table in f64, and the f64 table's degree 0-2
   coefficients within 1e-9 of the f64 far sums at the cube centres;
7. the scale-up run at full width: SimulationRunner with the reference
   benchmark's scale-up Params (100000 waters, far-table order 5), 2e6
   steps: 1000 CSV rows, 0 escapes, 0 coverage violations, 500 launches
   each of the candidate-model and near/taylor chunk kernels, none of
   the others; then both kernels against their plain versions at full
   width (100096 walkers) on the run's final state, with times of both;
8. the same scene with far_table_order=0 for 2e5 steps (the far-sums
   kernel's path): 50 launches each of the cube selection, far sums and
   near/taylor chunk,
   Σcos/W within 1e-5 of phase 7's first 2e5 steps, its walker-steps/s
   and the far sums' share of a chunk's wall; then the far-sums kernel
   against its plain version at full width (1e-5 of each row's scale,
   two runs bitwise equal), with times of both, its bound (and with an
   issue slot per float operation), its layout (one wave, no local
   memory) and its SASS instructions a pair;
8c. the cube-selection kernel at the scaleup-exact cell's shape (its
   scene, 100096 walkers, C 32, K 10), in Morton and in shuffled order,
   and on tie, cube-face, clamp (anchors at and beyond the box) and K = C
   cases: ids, every near plane, the unscaled M and n_reach bitwise its
   plain version (expansion.cube_select_reference, the bf16 argmin
   passes on the card), two runs bitwise equal; its ms against its bound
   and the plain version's, registers and spills (ptxas), its layout;
   one launch a chunk of an order-0 sprint;
8b. the layout of every mode of both entries at its path's width:
   blocks, threads, generator warps, dynamic shared memory, resident
   blocks per SM, waves, registers and spills; the near entry's two
   default modes with no local memory (Threefry: its slots in shared
   memory, one wave), and their SASS step loop (instructions a step,
   beside ``counts.step_ops``); and the
   candidate-model kernel at the scale-up width (one wave: 6 or more
   blocks per SM, at most 80 registers, no spill);
9. (a) the fast and variant modes against their plain versions: the
   rebuild kernel on the headline scene at 50 and 4032 walkers, fast
   with the default physics, Threefry with every variant on (intended
   kick, sphere directions, permeable membranes, a z gradient) and fast
   with every variant on; the near/taylor kernel in the same three
   modes on the scale-up scene's first 4096 waters and at full width on
   phase 7's final walkers (100096, the state bitwise equal); the gates
   of phases 3 and 6, two kernel runs bitwise equal; times of both (the
   near entry's at full width);
10. (b) the headline through the runner on its default, the fast
   generator: 2e6 steps, 0 escapes, 0 coverage violations, 500
   chunk_kernel[fast] launches; its curve within 5 sqrt(2/W) of phase
   4's Threefry curve over the first 4e4 steps (tests/test_pallas.py:
   113-130);
11. (c) the golden arms on scene 6000, 4 runs each (keys FW_RUN0 + k,
   as the repository's scripts/golden_paired.py runs them; the scene and
   Params from the port's golden module): intended kick, permeable,
   gradient, each on both generators, and the as-written arm on the
   fast one, against oracle row 0 of the committed curves, gated at
   about 2.5x the committed JAX arm's own reading;
12. (d) the scale-up run on the fast generator, 2e6 steps, 0 escapes, 0
   coverage violations, the candidate-model kernel against its plain
   version on the run's final walkers (phase 6's gates); then 2e5 steps
   of it with every variant on, on each generator;
13. nothing of jax or of the JAX package has been imported;
14. the decompose mode of both chunk-kernel entries against its plain
   version in every mode (Threefry, fast, each with every variant on):
   the rebuild entry on the headline scene at 50 and 4032 walkers, the
   near entry on the scale-up scene's first 4096 waters; positions
   within 1e-4, A and B per walker within 1e-5, escapes and coverage
   equal, two kernel runs bitwise equal; times of kernel and plain
   version, and of each decompose kernel beside its plain-mode sibling
   (4032 walkers, K 5; 100096 walkers, K 10);
15. README configuration 5c through the port CLI at full width on the
   fast generator: the headline, 2e6 steps, taucp 0.25, four moment
   scales x four echo spacings, --dump-record and --fit-r2: 16 CSVs of
   2000 rows, 0 escapes, 0 violations, only chunk_kernel[fast+dec]
   launched (500 times), three grid points within 5e-5 (first 4e4
   steps) and 1e-3 (the run) in Σcos/W of direct runs; the time split
   (device, record copy, host); then a Threefry decompose run on golden
   scene 6000 at the base moment reconstructed at s = 60, within phase
   5's gates of the oracle and within 1e-3 of phase 5's direct curve;
   then 2e5 headline steps with every variant on, on each generator,
   against direct runs; (d) the same CLI run with --plane-device
   --dump-echoes in place of --dump-record: the same 500 launches, 16
   CSVs within 1e-4 in Σcos/W of the record run's, the same dispersion
   table's shape, then the port's mri-t2-fit (analysis.main --echoes
   --bootstrap 32) on the captures: one row per grid point, a finite T2
   inside its CI wherever a resample fitted; the two CLI walls and one
   plane_fold_kernel launch a sprint; (e) the plane fold's kernel against its
   twin at the headline-plane cell's shapes (4032 of 4096 walkers, 20
   windows, 4 x 4): the carry bitwise the CPU twin's, the block within
   1e-6, two launches bitwise equal; ms a sprint of both, host us a call,
   its bound, registers and layout;
16. the scale-up with a streaming (moment x taucp) plane on the fast
   generator, 2e5 steps: 0 escapes, 0 violations, only
   chunk_near_kernel[fast+dec] and cand_model_kernel launched, the s = 1
   curve within 5e-5 of a direct run, the candidate-model kernel against
   its plain version on the walkers after those 2e5 steps; the time
   split; then 2e4 steps on Threefry and with every variant on, on each
   generator; (c) the same 3 x 3 plane by run_plane_on_device: the same
   launches and one plane_fold_kernel a sprint, curves within 1e-4 of
   the host plane's, its split beside the host plane's;
18. durability at full width (before the kernels line; phase 13's check
   again after it): (a) the headline through run_resilient with faults
   at sprints 5 and 13, a checkpoint every 2 sprints, drain depth 1, on
   Threefry (the CSV bytewise phase 4's, the curve phase 4's) and on the
   fast generator (bytewise an uninterrupted fast run's), then a drain
   hung past a 2 s watchdog, recovered bytewise; (b) the headline CLI
   with --checkpoint --checkpoint-every 4 --max-retries 2 as a process,
   SIGKILLed at a checkpoint step of 8e5 or more, the same command again:
   its CSV bytewise the uninterrupted CLI run's; (c) phase 15's 5c run
   with --record-dir --checkpoint --checkpoint-every 4, killed and run
   again: the store's A/B bitwise phase 15's record, the 16 CSVs bytewise
   phase 15's, a third run on the complete store launching nothing; (d)
   phase 16's 3 x 3 plane through run_streaming_durable (10 sprints, a
   snapshot after each, a fault at the third), then the same call: curves
   bitwise equal to an uninterrupted call, within 1e-6 of phase 16's,
   only chunk_near_kernel[fast+dec] and cand_model_kernel launched; (e)
   --save-scene then --scene-file of the archive, and --scene-file of
   the 270 centres as a CSV (CustomBox), each CSV bytewise the seed-42
   CLI run's; --scene-family clustered and fcc for 2e5 steps, 0 escapes
   and violations, and the chunk entry each dipole count chose; (f) the
   seconds of a checkpoint save and a resume at 4032 and 100000 walkers;
19. ensembles and sweeps at full width (``parallel/ensemble.py``; before
   the kernels line): (a) 4 trials x 4032 walkers, 270 cells, scene
   seeds 42-45, K 10, 2e5 steps on Threefry: each trial bitwise its
   standalone run (positions, phases, windows, escapes, coverage), 4 x
   50 chunk_kernel launches; then one trial each with a taucp, a run
   cell_r, a d_scale and a moment of its own against static-parameter
   runs (bitwise for taucp and cell_r, within POS_TOL / WIN_TOL for the
   others); a P sweep on with_permeability(), only chunk_kernel[variants]
   launched, each point against its static run; (b) 2 scale-up trials
   (scene seeds 42 and the next seed with another dipole count, so one
   table is padded), one sprint on Threefry: only chunk_near_kernel and
   far_sums_kernel launched, 0 escapes and violations, trial 1 within
   POS_TOL / WIN_TOL of its standalone sprint, the cube cache's build
   seconds; (c) the golden T2 arms through golden.run_t2_arm (16 trials,
   10 at d_scale 0.5, 6 at run cell_r 0.8, on Threefry, and the first on
   the fast generator), |z_final| <= 3 against the oracle's final mean
   and standard error; walker-steps/s at 1024 walkers a trial and the
   layout; (d) the CLI as processes on the fast generator: --sweep D
   (3 CSVs of 2000 rows, a dispersion table with a finite T2 a row),
   --sweep-grid --paired --quadrature (4 CSVs bytewise an in-process
   run_parameter_grid's), --ensemble 4 (bytewise the in-process mean),
   --sweep Gz and --sweep num_cells (one sprint function a value;
   launches by mode), --trace on the Gz sweep (the trace names the chunk
   kernel); seconds and walker-steps/s of each part;
20. the scan engine and the inverse fits at full width (before the
   kernels line): (a) the scan engine (``engine="scan"``, eager torch, no
   chunk kernel) against the chunk kernel on the headline, one sprint of
   2e4 Threefry steps: positions within POS_TOL, window sums within
   WIN_TOL, escapes and coverage equal; the window-major order (chunk
   500, 4e3 steps) against the chunk kernel's curve; field_mode exact and grid
   (grid_n 64) for 2e3 steps each: residency equal at the walkers, the
   field's error against exact, curves within 5 sqrt(2/W); walker-steps/s
   of each mode; (b) run_decomposition(engine="scan") against the chunk
   kernel's decompose record over one sprint (DEC_TOL); (c) autograd
   through the scan engine: d(curve)/d(moment scale) and d/d(d_scale)
   against central finite differences (rtol 2e-2), then fit_moment_scale
   and fit_diffusion_scale, 3 Adam steps each, toward the hidden scale,
   seconds an iteration and peak memory; (d) the CRN fits on the chunk
   kernels (D and joint over 2e5 steps, cell_r and P over 2e6), each
   within 5% of its hidden value, only the chunk-kernel modes it needs
   launched; (e) the CLIs as
   processes side by side: ``--engine scan`` of the simulator (its curve
   against the chunk kernel's), and ``inverse`` with ``--method
   decompose``, ``crn`` on each axis, ``--record/--target`` on phase
   15's record (each its own 5% gate, exit 0), and ``--method ad`` on
   the moment and D axes with 2 iterations (their recovered scale moved
   from --init-scale toward --true-scale; at 2 iterations their exit
   code is no gate);
21. walker sharding and multi-process runs (``parallel/sharding.py``,
   ``parallel/distributed.py``; before the kernels line): (a) the
   headline through the runner, 2e5 steps on each generator, unsharded,
   on ``make_walker_mesh()`` (one shard a card) and on two shards of the
   one card: the state bitwise, window sums within WIN_TOL, escapes and
   coverage equal, twice the launches on two shards and nothing else;
   the scale-up (order 5) and its order-0 twin on two shards (2e5 and
   2e4 steps): the state bitwise, window sums within 1e-6 W; walker-
   steps/s beside phases 4, 7 and 8; (b) a two-sprint decomposition on
   two shards through ``run_decomposition_durable(mesh=)``: the record
   bitwise; three sprints killed after sprint 0 on two shards and
   resumed with no mesh: bitwise; ``run_plane_on_device(mesh=)``:
   curves within 1e-6, echo matrices bitwise; (c) 4 trials on a 2 x 2
   (trials x walkers) mesh, each bitwise its standalone run; (d) this
   script as two gloo worker processes sharing the card (``--worker``):
   every ``run_*_multihost`` (simulation, record, plane, 4-trial
   ensemble, 2 x 2 grid), both ranks equal and each equal to the
   one-process result, then a one-rank NCCL group's walker-sharded run;
   (e) ``--engine scan`` through the CLI (4032 walkers, 6e3 steps):
   ``--record-dir``, ``--stream-plane --checkpoint`` killed and run
   again, ``--plane-device --dump-echoes``, each within DEC_TOL (curves
   and echoes within (max scale + 1) DEC_TOL) of the chunk kernel's
   Threefry record; (f) ``--shard-walkers`` as a process (its line, its
   CSV bytewise the unsharded run's), ``--ensemble 4 --walker-shards 2``
   refused with the reference's message, and mri-t2-plot on a curve, a
   dispersion table, a scene archive and a spectrum where matplotlib is
   installed;
17. the kernels line (every entry and mode, with its launches in the
   run of its path, its time beside its plain version's and its bound,
   its layout, registers and spills),
   then {"ok": true, "device": {...}}.

    python3 chip_smoke.py
"""

import contextlib
import functools
import glob
import importlib.util
import io
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mri_nanoparticle_simulation_tpu_torch import (  # noqa: E402
    analysis, golden, inverse)
from mri_nanoparticle_simulation_tpu_torch.benchmark import (  # noqa: E402
    FAR_SUMS_K10, NEAR_K10, SCALEUP, all_variants, sass_loop,
    split_step_loops,
    time_on_device)
from mri_nanoparticle_simulation_tpu_torch.engine import (  # noqa: E402
    chunk_kernel, cuda_engine, reference_engine, resilience, sim)
from mri_nanoparticle_simulation_tpu_torch.engine import (  # noqa: E402
    decompose as dec)
from mri_nanoparticle_simulation_tpu_torch.engine.convert import (  # noqa
    key_words, mnp_table)
from mri_nanoparticle_simulation_tpu_torch.fields import (  # noqa: E402
    dipole, expansion, fartable)
from mri_nanoparticle_simulation_tpu_torch.fields import (  # noqa: E402
    grid as grid_mod)
from mri_nanoparticle_simulation_tpu_torch.engine.reference_engine import (  # noqa
    init_state)
from mri_nanoparticle_simulation_tpu_torch.engine.sim import (  # noqa: E402
    SimulationRunner)
from mri_nanoparticle_simulation_tpu_torch.io import (  # noqa: E402
    record as record_mod)
from mri_nanoparticle_simulation_tpu_torch.io.writer import (  # noqa: E402
    T2CsvWriter, read_t2_csv)
from mri_nanoparticle_simulation_tpu_torch.parallel import (  # noqa: E402
    ensemble as ens)
from mri_nanoparticle_simulation_tpu_torch.parallel.sharding import (  # noqa
    WALKER_AXIS)
from mri_nanoparticle_simulation_tpu_torch.params import Params  # noqa: E402
from mri_nanoparticle_simulation_tpu_torch.scene import (  # noqa: E402
    BacteriaBox, ClusteredBacteriaBox, FCCLatticeBox)
from mri_nanoparticle_simulation_tpu_torch.scene import (  # noqa: E402
    io as scene_io)
from mri_nanoparticle_simulation_tpu_torch.utils.device import (  # noqa: E402
    card_label, require_cuda)
from mri_nanoparticle_simulation_tpu_torch.utils import (  # noqa: E402
    profiling)
from port_bench.work import counts  # noqa: E402

POS_TOL = 1e-4     # tests/test_pallas.py:109-111, compiled kernel vs plain
WIN_TOL = 0.05
TAYLOR_TOL = 1e-5  # of the largest |component|; tests/test_fields.py:375
FAR_TOL = 1e-5     # of each row's scale, tests/test_fields.py:375
CURVE_TOL = 1e-5   # far table vs exact far sums, Σcos/W (1.563e-7 read)
TABLE_TOL = 1e-4   # f32 far table vs f64, of each coefficient's scale
LOW_TOL = 1e-9     # f64 degree 0-2 coefficients vs f64 far sums at centres
DEC_TOL = 1e-5     # A and B per walker, decompose kernel vs plain version
REC_TOL = 5e-5     # Σcos/W, reconstruction vs a direct run (early windows;
#                    tests/test_decompose.py:57)
REC_RUN_TOL = 1e-3  # the same over the whole run
PLANE_TOL = 1e-4   # cos/W, on-device plane vs float64 host plane
#                    (tests/test_decompose.py:390)
HEADLINE = dict(chunk_steps=4000, near_k=5)
#: the ensembles of phase 19: scene seeds 42-45 need K 7 (seed 44), and
#: a diffusion scale of 2 K 9 (near-k certificates)
ENSEMBLE = dict(chunk_steps=4000, near_k=10)
#: golden arm -> (committed curves and config, RMS gate, |final diff|
#: gate): about 2.5x the committed JAX arm's own reading against oracle
#: row 0 (scene 6000), and phase 5's gates for the as-written arm
ARMS = {"intended": ("GOLDEN_T2_FULL_intended", 0.025, 0.060),
        "permeable": ("GOLDEN_T2_P", 0.010, 0.020),
        "gradient": ("GOLDEN_T2_G", 0.020, 0.030),
        "as_written": ("GOLDEN_T2_FULL", 0.025, 0.060)}
PKG = "mri_nanoparticle_simulation_tpu_torch/csrc/"
REF = "mri_nanoparticle_simulation_tpu/"
REPLACES = REF + "engine/pallas_engine.py:171"


def work_mode(phys) -> counts.Mode:
    """The ``counts.Mode`` (what sets a walker-step's work) of a
    ``cuda_engine.ChunkPhysics``."""
    return counts.Mode(phys.fast_rng, phys.pfreq, phys.chunk_steps,
                       phys.near_k, phys.reflect, phys.intended, phys.sphere,
                       any(phys.gradient))


def issue_bound_ms(nbytes, flops, iops):
    """``counts.bound``'s time with every float operation in an issue slot
    of its own, as the kernels' --fmad=false code issues it: what the
    uncontracted build could reach at best."""
    return 1e3 * max(nbytes / counts.PEAK_BYTES,
                     (flops + iops) / counts.PEAK_ISSUE,
                     iops / counts.PEAK_INT32)


def phase(name):
    print(f"[{name}]", flush=True)
    return time.perf_counter()


def done(t0, msg):
    print(f"  {msg} ({time.perf_counter() - t0:.2f} s)", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def chunk_args(p, n_water, step0, tcp=None, rng_impl="threefry"):
    return dict(step0=step0, key=key_words(7), lane_offset=0,
                num_water=n_water, tcp=p.tcp if tcp is None else tcp,
                cell_r2=cuda_engine.cell_r2_f32(p.cell_r), dstd=1.0,
                phys=cuda_engine.chunk_physics(p, rng_impl))


def compare_chunk(p, sc, dev, n_water, tcp=None, rng_impl="threefry"):
    """One chunk of the kernel and of the plain version on the same
    CUDA input (the state after one kernel chunk from the start)."""
    st = init_state(sc.waters[:n_water], p, dev)
    planes = cuda_engine.to_soa(st, p).planes
    tbl = mnp_table(sc.mnps, torch.float32, dev).tbl
    planes, *_ = chunk_kernel.run_chunk(
        planes, tbl, **chunk_args(p, n_water, 0, tcp, rng_impl))
    args = chunk_args(p, n_water, p.chunk_steps, tcp, rng_impl)
    key = chunk_kernel.chunk_mode("chunk_kernel", args["phys"])
    before = chunk_kernel.LAUNCHES[key]
    k1 = chunk_kernel.run_chunk(planes, tbl, **args)
    k2 = chunk_kernel.run_chunk(planes, tbl, **args)
    torch.cuda.synchronize()
    check(chunk_kernel.LAUNCHES[key] == before + 2,
          f"LAUNCHES[{key!r}] did not count")
    for a, b in zip(k1, k2):
        check(torch.equal(a, b), "two kernel runs differ")
    ref = cuda_engine.chunk_reference(planes, tbl, **args)
    out, esc, cov, wins = k1
    r_out, r_esc, r_cov, r_wins = ref
    pos_err = (out[:3, :n_water] - r_out[:3, :n_water]).abs().max().item()
    phase_err = (out[4, :n_water] - r_out[4, :n_water]).abs().max().item()
    win_err = (wins.sum(0) - r_wins.sum(0)).abs().max().item()
    incell_diff = int((out[3] != r_out[3]).sum())
    print(f"  {key}, {n_water} walkers: |pos| err {pos_err:.3e} (tol "
          f"{POS_TOL}), |phase| err {phase_err:.3e}, |wins| err "
          f"{win_err:.3e} (tol {WIN_TOL}), in-cell flags differing "
          f"{incell_diff}, escapes "
          f"{int(esc.sum())}/{int(r_esc.sum())}, coverage "
          f"{int(cov.sum())}/{int(r_cov.sum())}", flush=True)
    check(pos_err < POS_TOL, f"positions differ by {pos_err}")
    check(torch.equal(out, r_out), "state not bitwise equal")
    check(win_err < WIN_TOL, f"window sums differ by {win_err}")
    check(torch.equal(esc, r_esc), "escapes differ")
    check(torch.equal(cov, r_cov), "coverage differs")
    check(bool(torch.isfinite(out).all()), "non-finite kernel state")
    return planes, tbl, args, pos_err, win_err


def reset_launches():
    for k in chunk_kernel.LAUNCHES:
        chunk_kernel.LAUNCHES[k] = 0


def launches():
    return dict(chunk_kernel.LAUNCHES)


def only(**want):
    """The LAUNCHES dict with ``want`` and every other key 0."""
    return {k: want.get(k, 0) for k in chunk_kernel.LAUNCHES}


def entry_label(name, flags):
    """The label of a kernel instantiation from its template flags:
    chunk kernels (<K, fast generator, variants, decompose>, the near
    entry with its layout's flag after them) by mode, as their LAUNCHES
    keys; the candidate-model kernel (<K, high>) with "[order 8]" for
    its high-order twin; the others (<K>) by name."""
    if len(flags) >= 3:
        return chunk_kernel.chunk_mode(name, SimpleNamespace(
            fast_rng=flags[0] == "1", variants=flags[1] == "1"),
            flags[2] == "1")
    return name + ("[order 8]" if flags == ["1"] else "")


def ptxas_resources(log):
    """{(label, K): (registers, spill line)} from the -Xptxas -v log:
    "Compiling entry function NAME", "Function properties for NAME", its
    stack/spill line, then "Used N registers" for the entry (labels:
    ``entry_label``)."""
    out, entry, props, spill = {}, None, None, {}
    pat = re.compile(r"([a-z_]+_kernel)ILi(\d+)E((?:Lb[01]E)*)")
    for ln in log.splitlines():
        m = pat.search(ln)
        key = ((entry_label(m.group(1), re.findall(r"Lb([01])E", m.group(3))),
                int(m.group(2))) if m else None)
        if "Compiling entry function" in ln:
            entry = key
        elif "Function properties for" in ln:
            props = key
        elif "spill stores" in ln and props is not None:
            spill[props] = ln.strip()
        elif "Used" in ln and "registers" in ln and entry is not None:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            out[entry] = (regs, spill.get(entry))
    return out


def compile_seconds(log):
    """{source: seconds} of each nvcc process of the build (the log's
    "# N s" line under each command)."""
    out, src = {}, None
    for ln in log.splitlines():
        if ln.startswith("$ ") and " -c " in ln:
            src = os.path.basename(ln.split()[-1])
        elif ln.startswith("# ") and ln.endswith(" s") and src:
            out[src] = float(ln[2:-2])
    return out


def time_chunk(fn, n):
    """ms per call of kernel call ``fn`` on the device: ``n`` calls after
    a warm-up, behind a sleep of the stream (``time_on_device``)."""
    fn()                                  # warm-up
    torch.cuda.synchronize()
    return time_on_device(fn, n)


def main():
    t_all = time.perf_counter()
    t0 = phase("1 device")
    dev = require_cuda()
    label = card_label()
    print(label, flush=True)
    done(t0, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(dev)}, "
         f"{torch.cuda.device_count()} card(s)")

    t0 = phase("2 build")
    chunk_kernel.build()
    build_s = time.perf_counter() - t0
    chunk_kernel.load_library()
    res = ptxas_resources(chunk_kernel.build_log())
    split_names = [chunk_kernel.chunk_mode(
        "chunk_split_kernel", SimpleNamespace(
            fast_rng="fast" in m, variants="variants" in m), "dec" in m)
        for m in chunk_kernel.CHUNK_MODES]
    # every kernel but the plane fold is instantiated for K = 1..16
    k_names = [n for n in chunk_kernel.LAUNCHES if n != "plane_fold_kernel"]
    for name in [*k_names, *split_names, "cand_model_kernel[order 8]"]:
        ks = sorted(k for n, k in res if n == name)
        check(ks == list(range(1, 17)), f"{name}: built for K = {ks}")
        print(f"  {name} registers by K: "
              f"{' '.join(f'{k}:{res[name, k][0]}' for k in ks)}")
        print(f"  {name} K=5: {res[name, 5][1]}; K=10: {res[name, 10][1]}")
    fold_info = chunk_kernel.plane_fold_info(len(FOLD_SCALES), 20, 0, dev)
    print(f"  plane_fold_kernel: {fold_info.regs} registers, "
          f"{fold_info.local_bytes} B local (4 scales, 20 windows)")
    secs = compile_seconds(chunk_kernel.build_log())
    print("  nvcc seconds by source: " + ", ".join(
        f"{s} {t:.1f}" for s, t in sorted(secs.items(), key=lambda x: -x[1])))
    bad = chunk_kernel.math_check(dev)
    for what, n in bad.items():
        print(f"  math check: {what}: {n} inputs differ", flush=True)
    check(set(bad.values()) == {0}, f"math check: {bad}")
    done(t0, f"built {chunk_kernel.library_path().name} ({len(res)} "
         f"entries) in {build_s:.2f} s with "
         f"{' '.join(chunk_kernel.NVCC_FLAGS)}")

    t0 = phase("3 kernel vs plain version")
    p = Params(**HEADLINE).validate()
    sc = BacteriaBox(p, seed=42).populate()
    check(len(sc.mnps) == 716, f"scene has {len(sc.mnps)} dipoles")
    # 50 walkers: padding and masking; tcp = 2 windows puts CP flips in it
    _, _, _, pos50, win50 = compare_chunk(p, sc, dev, 50, tcp=2 * p.pfreq)
    planes, tbl, args, pos_err, win_err = compare_chunk(
        p, sc, dev, p.num_water)
    kernel_ms = time_chunk(
        lambda: chunk_kernel.run_chunk(planes, tbl, **args), 5)
    _, plain_ms = timed(
        lambda: cuda_engine.chunk_reference(planes, tbl, **args))
    main_bound = counts.bound(*counts.chunk_work(
        args["num_water"], work_mode(args["phys"]), tbl.shape[1]))
    lay = chunk_kernel.LAYOUTS["chunk_kernel"]
    check(lay.split and lay.blocks >= 120 and lay.waves == 1,
          f"headline layout {lay}")
    # the other side of the split layout's threshold: the flat layout
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    edge = chunk_kernel.split_threshold(sms, {
        "split": chunk_kernel.kernel_info("chunk_kernel", args["phys"],
                                          False, "split", tbl.shape[1])})
    wide = Params(chunk_steps=1000, near_k=5, num_water=edge + 100).validate()
    compare_chunk(wide, BacteriaBox(wide, seed=42).populate(), dev,
                  wide.num_water)
    wlay = chunk_kernel.LAYOUTS["chunk_kernel"]
    check(not wlay.split, f"{wide.num_water} walkers took {wlay}")
    done(t0, f"one chunk (4032 walkers, K=5, 4000 steps): kernel "
         f"{kernel_ms:.3f} ms, plain version {plain_ms:.1f} ms, bound "
         f"{main_bound[0]:.4f} ms ({main_bound[1]}); layout {lay}; above "
         f"the split threshold ({edge} walkers) at {wide.num_water}: "
         f"{wlay} [{label}]")

    t0 = phase("4 main path, full width")
    runner = SimulationRunner(Params(**HEADLINE), scene_seed=42, seed=7,
                              device="cuda", rng_impl="threefry")
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "t2.csv")
        reset_launches()
        times, cos, sin, stats = runner.run(csv_path=csv, progress=False,
                                            max_steps=2_000_000)
        main_launches = launches()
        rows = read_t2_csv(csv)
        with open(csv) as fh:
            keep = {"t4_csv": fh.read(), "t4_cos": cos, "scene": runner.scene,
                    "t4_rate": stats["walker_steps_per_s"]}
    check(len(rows[0]) == 2000, f"{len(rows[0])} CSV rows, expected 2000")
    check(stats["escapes"] == 0, f"{stats['escapes']} escapes")
    check(stats["coverage_violations"] == 0,
          f"{stats['coverage_violations']} coverage violations")
    check(main_launches == only(chunk_kernel=500),
          f"kernel launches {main_launches}, expected 500 rebuild")
    check(bool(np.isfinite(cos).all() and np.isfinite(sin).all()),
          "non-finite window sums")
    check(float(np.abs(cos).max()) <= 4032.0, "|sum cos| > num_water")
    check(np.allclose(rows[1], cos), "CSV disagrees with the run")
    done(t0, f"2e6 steps x 4032 walkers: {stats['walker_steps_per_s']:.4e} "
         f"walker-steps/s, wall {stats['wall_s']:.3f} s, "
         f"{main_launches['chunk_kernel']} launches, final sum cos/W "
         f"{cos[-1] / 4032:.6f} [{label}]")

    t0 = phase("5 golden scenes 6000 and 6001 at production width")
    testdata = os.path.join(ROOT, "golden", "testdata")
    readings, curves, oracles = {}, {}, {}
    for seed in golden.SEEDS:
        curves[seed], gstats = golden.run_seed(testdata, seed, "cuda")
        oracles[seed] = golden.oracle_curve(testdata, seed)
        check(gstats["escapes"] == 0 and gstats["coverage_violations"] == 0,
              f"golden {seed}: escapes {gstats['escapes']}, coverage "
              f"{gstats['coverage_violations']}")
        check(bool(np.isfinite(curves[seed]).all()), f"golden {seed}: "
              "non-finite curve")
        r = readings[seed] = golden.gate_readings(
            oracles[seed], curves[seed],
            golden.oracle_curve(testdata, seed, tight=True))
        tight = (f", tight oracle rms {r['tight_rms']:.5f} (gate "
                 f"{golden.TIGHT_RMS_GATE}) late {r['tight_late']:+.5f} "
                 f"(gate {golden.TIGHT_LATE_ABS_GATE})"
                 if "tight_rms" in r else "")
        print(f"  seed {seed}: rms {r['rms']:.5f} (gate {golden.RMS_GATE}), "
              f"final diff {r['final']:+.5f} (gate {golden.FINAL_GATE}), "
              f"early {r['early']:+.5f} (gate {golden.EARLY_ABS_GATE}), late "
              f"{r['late']:+.5f} (range {golden.LATE_RANGE}){tight}; finals "
              f"oracle {r['oracle_final']:.4f} port {r['ours_final']:.4f} "
              f"(gate < {golden.DEPTH_GATE}); "
              f"{gstats['walker_steps_per_s']:.4e} walker-steps/s", flush=True)
    final_mean, late_mean = golden.cross_seed(readings)
    fails = golden.gate_failures(readings)
    check(not fails, f"golden gates: {fails}")
    oracle, ours = oracles[6000], curves[6000]
    done(t0, f"every gate of tests/test_golden_full.py met; cross-seed "
         f"final mean {final_mean:+.5f}, late mean {late_mean:+.5f} (range "
         f"{golden.LATE_MEAN_RANGE}) [{label}]")

    ctx, big = large_scene_phases(dev, label)
    big.append(cube_select_phase(dev, res, label))
    layouts = layout_report(dev, p, tbl.shape[1], ctx["p"], res, label)
    big[0].update(layouts["chunk_near_kernel"])
    big[1].update(layouts["cand_model_kernel"])
    regs, spill = res["far_sums_kernel", ctx["p"].near_k]   # K 10
    big[2].update(registers=regs, spill_bytes=spill_bytes(spill))
    modes = mode_phases(dev, label, p, sc, ctx)
    fast_launches, keep["fast_cos"] = fast_headline(runner, cos, label)
    arm_launches = golden_arms(label)
    near_launches = fast_scaleup(ctx, label)

    t0 = phase("13 imports")
    no_reference_imported()
    done(t0, "nothing of jax or of the JAX package imported")
    dec_modes = decompose_modes(dev, label, p, sc, ctx)
    dec_launches = decompose_headline(sc, ours, oracle, label, keep)
    fold = plane_fold_phase(label)
    dec_launches.update(decompose_scaleup(ctx, label, keep))
    durability(ctx, keep, label)
    ensembles(ctx, keep, label)
    scan_and_inverse(keep, label)
    sharded(ctx, keep, label)

    t0 = phase("17 kernels")
    no_reference_imported()
    print(f"  total {time.perf_counter() - t_all:.1f} s, no jax imported",
          flush=True)
    path_launches = {**main_launches, **fast_launches, **arm_launches,
                     **near_launches, **dec_launches}
    new = []
    for name, m in {**modes, **dec_modes}.items():
        entry = name.split("[")[0]
        fast = "fast" in name
        decomp = "dec" in name
        new.append({
            "name": name,
            "route": "cuda",
            "source": PKG + entry + ("_fast" if fast else "")
            + ("_dec" if decomp else "") + ".cu",
            "replaces": REPLACES + (" (hardware-RNG loop :603-684)" if fast
                                    else "") + (" (physics variants "
                                                ":493-583)"
                                                if "variants" in name
                                                else "")
            + (" (decompose :221-229, 564-575, 689-716, 736, 787-793)"
               if decomp else ""),
            "launches": path_launches[name],
            "max_abs_err": m["pos_err"],
            **({"max_abs_err_a_b": m["ab_err"],
                "tolerance": {"positions": POS_TOL, "a_b": DEC_TOL}}
               if decomp else
               {"max_abs_err_wins": m["win_err"],
                "tolerance": {"positions": POS_TOL,
                              "window_sums": WIN_TOL}}),
            **layouts[name],
            "ms": m["ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound"][0],
            "bound_by": m["bound"][1],
            "library_ms": None,
        })
    kernels = [{
        "name": "chunk_kernel",
        "route": "cuda",
        "source": PKG + "chunk_kernel.cu",
        "replaces": REPLACES,
        "launches": main_launches["chunk_kernel"],
        "max_abs_err": max(pos50, pos_err),
        "max_abs_err_wins": max(win50, win_err),
        "tolerance": {"positions": POS_TOL, "window_sums": WIN_TOL},
        **layouts["chunk_kernel"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": main_bound[0],
        "bound_by": main_bound[1],
        "library_ms": None,
    }, *big, *new, {
        "name": "plane_fold_kernel",
        "route": "cuda",
        "source": PKG + "plane_fold_kernel.cu",
        "replaces": None,
        "launches": path_launches["plane_fold_kernel"],
        "tolerance": {"block": FOLD_TOL, "carry": 0.0},
        **fold,
        "library_ms": None,
    }]
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    check(not missing, f"no launches in their path's run: {missing}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def spill_bytes(line):
    """The spill stores of a -Xptxas -v line (0 if none)."""
    m = re.search(r"(\d+) bytes spill stores", line or "")
    return int(m.group(1)) if m else 0


def layout_report(dev, hp, n_pad, sp, res, label):
    """Phase 8 (b): each mode of both chunk-kernel entries at its path's
    width, the rebuild entry at the headline (``hp``, an ``n_pad``-entry
    table) and the near entry at the scale-up (``sp``): its layout
    (blocks, threads, generator warps, dynamic shared memory; the
    runtime's answer), resident blocks per SM (the occupancy API), waves,
    and the registers and spills of the kernel it launches; then the
    candidate-model kernel's at the scale-up width, and its local memory
    (spills and stack, by the runtime).  Returns {LAUNCHES key:
    kernels-line fields}."""
    t0 = phase("8 (b) layouts of every chunk-kernel mode and of the "
               "candidate model")
    out = {}
    for entry, q in (("chunk_kernel", hp), ("chunk_near_kernel", sp)):
        w_pad = cuda_engine.pad_count(q.num_water)
        for m in chunk_kernel.CHUNK_MODES:
            dec = "dec" in m
            pm = all_variants(q) if "variants" in m else q
            phys = cuda_engine.chunk_physics(
                pm, "hardware" if "fast" in m else "threefry")
            lay = chunk_kernel.launch_layout(
                entry, torch.empty((8 if dec else 6, w_pad), device=dev),
                phys, dec, n_pad if entry == "chunk_kernel" else 0)
            kernel = "chunk_split_kernel" if lay.split else entry
            regs, spill = res[chunk_kernel.chunk_mode(kernel, phys, dec),
                              phys.near_k]
            key = chunk_kernel.chunk_mode(entry, phys, dec)
            out[key] = {"layout": {**lay._asdict(), "kernel": kernel},
                        "registers": regs, "spill_bytes": spill_bytes(spill)}
            print(f"  {key}, {w_pad} walkers: {kernel} {lay.blocks} x "
                  f"{lay.threads} threads, {lay.gen_warps} generator warps, "
                  f"{lay.smem} B dynamic shared memory; {lay.blocks_per_sm} "
                  f"resident per SM, {lay.waves} wave(s); {regs} registers, "
                  f"{spill_bytes(spill)} B spilled", flush=True)
            if entry == "chunk_kernel":
                check(lay.split and lay.blocks >= 120 and lay.waves == 1,
                      f"{key}: headline layout {lay}")
            if key in ("chunk_near_kernel", "chunk_near_kernel[fast]"):
                out[key].update(near_step_sass(phys, lay, dev, label))
            if key in ("chunk_kernel", "chunk_kernel[fast]"):
                out[key].update(split_step_sass(phys, lay, n_pad, dev, label))
    # the candidate-model kernel at the scale-up width, as the runtime
    # reports it; its last launch (phase 7, full width) took the same
    w_pad = cuda_engine.pad_count(sp.num_water)
    info = chunk_kernel.cand_model_info(sp.near_k, sp.far_table_order, dev)
    lay = chunk_kernel.walker_layout(
        w_pad, torch.cuda.get_device_properties(dev).multi_processor_count,
        info)
    regs, spill = res["cand_model_kernel", sp.near_k]
    out["cand_model_kernel"] = {
        "layout": lay._asdict(), "registers": regs,
        "spill_bytes": spill_bytes(spill), "local_bytes": info.local_bytes}
    print(f"  cand_model_kernel, {w_pad} walkers, K={sp.near_k}, order "
          f"{sp.far_table_order}: {lay.blocks} x {lay.threads} threads; "
          f"{lay.blocks_per_sm} resident per SM, {lay.waves} wave(s); "
          f"{regs} registers ({info.regs} by the runtime), "
          f"{spill_bytes(spill)} B spilled, {info.local_bytes} B local "
          f"memory", flush=True)
    check(chunk_kernel.LAYOUTS["cand_model_kernel"] == lay,
          f"cand_model_kernel launched as {chunk_kernel.LAYOUTS}")
    check(lay.blocks_per_sm >= 6 and lay.waves == 1 and regs <= 80
          and spill_bytes(spill) == 0 and info.local_bytes == 0,
          f"cand_model_kernel: scale-up layout {lay}, {regs} registers, "
          f"{spill}, {info.local_bytes} B local memory")
    done(t0, f"[{label}]")
    return out


def near_step_sass(phys, lay, dev, label):
    """The near entry's default mode of ``phys`` at the scale-up width:
    no local memory, and on Threefry its slots in shared memory and one
    wave (checked; the fast generator keeps them in registers, in two
    waves: PERF.md section 6); and its
    SASS step loop (``sass_loop``: a step, or a step pair on the fast
    generator) against ``counts.step_ops``; returns its kernels-line
    fields."""
    info = chunk_kernel.kernel_info("chunk_near_kernel", phys, device=dev)
    check(info.local_bytes == 0 and (phys.fast_rng or (
        lay.waves == 1 and lay.smem == info.smem > 0)),
          f"near entry{' [fast]' if phys.fast_rng else ''}: scale-up "
          f"layout {lay}, {info.local_bytes} B local memory")
    # the copy of the step loop that the runs take: on Threefry the one
    # with the rounds of Threefry-20 unrolled, the larger of the two
    copies = sass_loop(chunk_kernel, NEAR_K10[phys.fast_rng])["copies"]
    sass = max(copies, key=lambda c: c["instructions"])
    steps = 2 if phys.fast_rng else 1
    f, i = counts.step_ops(work_mode(phys))
    per_step = sass["instructions"] / steps
    print(f"    SASS step loop: {sass['instructions']} instructions for "
          f"{steps} step(s), {sass['rsqrt']} MUFU.RSQ, nested loops "
          f"{sass['inner']}: {per_step:.1f} a step against step_ops "
          f"{f:.1f} float + {i:.1f} integer = {f + i:.1f} (every copy: "
          f"{[c['instructions'] for c in copies]}); {lay.smem} B shared "
          f"memory a block, {info.local_bytes} B local memory [{label}]",
          flush=True)
    return {"sass_per_step": per_step, "sass_step_loop": sass,
            "step_ops": [f, i], "smem_per_block": lay.smem,
            "local_bytes": info.local_bytes}


def split_step_sass(phys, lay, n_pad, dev, label):
    """The split kernel's default mode of ``phys`` at the headline: its two
    walker warps' SASS step loops (``split_step_loops``: the chain warp's
    and the field warp's, each a step), beside the near entry's, with the
    generator warps, the resident blocks (checked: two a SM, as the split
    thresholds assume) and the local memory; returns its kernels-line
    fields."""
    info = chunk_kernel.kernel_info("chunk_kernel", phys, False, "split",
                                    n_pad, dev)
    check(lay.split and lay.blocks_per_sm == 2,
          f"split kernel{' [fast]' if phys.fast_rng else ''}: layout {lay}")
    loops = split_step_loops(chunk_kernel, phys.fast_rng)
    for warp, lp in loops.items():
        print(f"    SASS {warp} warp step loop: {lp['instructions']} "
              f"instructions, {lp['counts']}, nested loops {lp['inner']}: "
              f"{lp['per_step']:.1f} a step; {lay.gen_warps} generator "
              f"warps, {lay.blocks_per_sm} resident per SM, {info.regs} "
              f"registers, "
              f"{info.local_bytes} B local memory [{label}]", flush=True)
    return {"sass_split_per_step": {w: lp["per_step"]
                                    for w, lp in loops.items()},
            "gen_warps": lay.gen_warps, "local_bytes": info.local_bytes}


def mode_phases(dev, label, p, sc, ctx):
    """Phase 9 (a): every fast and variant mode of both chunk-kernel
    entries against its plain version; {LAUNCHES key: errors, K, ms}."""
    t0 = phase("9 (a) fast and variant modes vs plain versions")
    out = {}
    for rng_impl, physics in (("hardware", lambda q: q),
                              ("threefry", all_variants),
                              ("hardware", all_variants)):
        pm = physics(p)
        _, _, _, pos50, win50 = compare_chunk(pm, sc, dev, 50,
                                              tcp=2 * pm.pfreq,
                                              rng_impl=rng_impl)
        planes, tbl, args, pos_err, win_err = compare_chunk(
            pm, sc, dev, pm.num_water, rng_impl=rng_impl)
        ms = time_chunk(lambda: chunk_kernel.run_chunk(planes, tbl, **args),
                        5)
        _, plain = timed(
            lambda: cuda_engine.chunk_reference(planes, tbl, **args))
        key = chunk_kernel.chunk_mode("chunk_kernel", args["phys"])
        print(f"  {key}: one chunk (4032 walkers, K=5, 4000 steps) kernel "
              f"{ms:.3f} ms, plain version {plain:.1f} ms [{label}]",
              flush=True)
        out[key] = dict(pos_err=max(pos50, pos_err),
                        win_err=max(win50, win_err), k=pm.near_k, ms=ms,
                        plain_ms=plain, bound=counts.bound(
                            *counts.chunk_work(args["num_water"],
                                               work_mode(args["phys"]),
                                               tbl.shape[1])))
    big = ctx["p"]
    for rng_impl, physics in (("hardware", lambda q: q),
                              ("threefry", all_variants),
                              ("hardware", all_variants)):
        cargs = dict(ctx["cargs"], phys=cuda_engine.chunk_physics(
            physics(big), rng_impl))
        near, taylor, planes = ctx["near"], ctx["taylor"], ctx["planes"]
        pos_err, win_err, _ = compare_near_chunk(planes, near, taylor, cargs)
        # and at the width of its path, on phase 7's final walkers
        full, fnear, ftaylor = ctx["full"], ctx["fnear"], ctx["ftaylor"]
        fargs = dict(ctx["fargs"], phys=cargs["phys"])
        pos_full, win_full, plain = compare_near_chunk(full, fnear, ftaylor,
                                                       fargs)
        ms = time_chunk(lambda: chunk_kernel.run_chunk_near(
            full, fnear, ftaylor, **fargs), 3)
        key = chunk_kernel.chunk_mode("chunk_near_kernel", cargs["phys"])
        print(f"  {key}: one chunk ({fargs['num_water']} walkers, K="
              f"{big.near_k}) kernel {ms:.3f} ms, plain version "
              f"{plain:.1f} ms [{label}]", flush=True)
        out[key] = dict(pos_err=max(pos_err, pos_full),
                        win_err=max(win_err, win_full), k=big.near_k,
                        ms=ms, plain_ms=plain, bound=counts.bound(
                            *counts.chunk_work(fargs["num_water"],
                                               work_mode(fargs["phys"]))))
    done(t0, f"{len(out)} modes [{label}]")
    return out


def fast_headline(tf_runner, tf_cos, label):
    """Phase 10 (b): the headline through the runner on its default
    generator; its curve against phase 4's Threefry curve."""
    t0 = phase("10 (b) headline on the fast generator, full width")
    runner = SimulationRunner(Params(**HEADLINE), scene=tf_runner.scene,
                              seed=7, device="cuda")
    check(runner.rng_impl == "hardware", "the runner's default is not fast")
    reset_launches()
    _, cos, _, stats = runner.run(progress=False, max_steps=2_000_000)
    got = launches()
    check(got == only(**{"chunk_kernel[fast]": 500}),
          f"kernel launches {got}, expected 500 chunk_kernel[fast]")
    check(stats["escapes"] == 0, f"{stats['escapes']} escapes")
    check(stats["coverage_violations"] == 0,
          f"{stats['coverage_violations']} coverage violations")
    check(len(cos) == 2000 and bool(np.isfinite(cos).all()),
          "window sums missing or non-finite")
    w = 4032
    d = (cos - tf_cos) / w
    gate = 5.0 * np.sqrt(2.0 / w)
    d40 = float(np.abs(d[:40]).max())
    check(d40 < gate, f"fast vs Threefry over 4e4 steps: {d40}")
    done(t0, f"2e6 steps x 4032 walkers: {stats['walker_steps_per_s']:.4e} "
         f"walker-steps/s, wall {stats['wall_s']:.3f} s, launches "
         f"{got['chunk_kernel[fast]']}, 0 escapes, 0 violations; "
         f"max |d(sum cos/W)| vs Threefry {d40:.3e} over 4e4 steps (gate "
         f"{gate:.4f}), {float(np.abs(d).max()):.3e} over 2e6; final sum "
         f"cos/W {cos[-1] / w:.6f} fast, {tf_cos[-1] / w:.6f} Threefry "
         f"[{label}]")
    return {"chunk_kernel[fast]": got["chunk_kernel[fast]"]}, cos


def golden_arms(label):
    """Phase 11 (c): the golden arms on scene 6000 (4 runs each, keys
    FW_RUN0 + k), against oracle row 0 of the committed curves."""
    t0 = phase("11 (c) golden arms on scene 6000, 4 runs each")
    reset_launches()
    want = {}
    for arm, (stem, rms_gate, final_gate) in ARMS.items():
        with open(os.path.join(ROOT, stem + ".json")) as f:
            cfg = json.load(f)["config"]
        curves = np.load(os.path.join(ROOT, stem + "_curves.npz"))
        oracle, jax_arm = curves["oracle"][0], curves["framework"][0]
        gpar = golden.framework_params(
            steps=cfg["steps"], tcp=cfg["tcp"], kick=cfg["kick"],
            gradient=cfg["gradient_z"] or 0.0,
            reflect=tuple(cfg["reflect_io_oi"]) if cfg["reflect_io_oi"]
            else None)
        scene = golden.scale_moments(golden.load_scene(os.path.join(
            ROOT, "golden", "testdata", "scene_6000"), gpar),
            cfg["moment_scale"])
        j = oracle - jax_arm
        j_rms = float(np.sqrt(np.mean(j ** 2)))
        gens = ("hardware",) if arm == "as_written" else ("hardware",
                                                          "threefry")
        for rng_impl in gens:
            t1 = time.perf_counter()
            reps = []
            for k in range(4):
                run = SimulationRunner(gpar, seed=golden.FW_RUN0 + k,
                                       device="cuda", scene=scene,
                                       rng_impl=rng_impl,
                                       check_coverage=k == 0)
                _, gcos, _, st = run.run(progress=False,
                                         max_steps=cfg["steps"])
                check(st["escapes"] == 0 and st["coverage_violations"] == 0,
                      f"{arm} {rng_impl}: escapes {st['escapes']}, "
                      f"coverage {st['coverage_violations']}")
                reps.append(gcos / golden.N_WATER)
            key = chunk_kernel.chunk_mode(
                "chunk_kernel", cuda_engine.chunk_physics(gpar, rng_impl))
            want[key] = want.get(key, 0) + 4 * cfg["steps"] // \
                gpar.chunk_steps
            ours = np.mean(reps, 0)
            check(len(ours) == len(oracle) == cfg["steps"] // golden.PFREQ,
                  f"{arm}: {len(ours)} windows")
            diff = oracle - ours
            rms = float(np.sqrt(np.mean(diff ** 2)))
            print(f"  {arm:10s} {key:28s} rms {rms:.5f} (gate {rms_gate}; "
                  f"JAX arm {j_rms:.5f}), final diff {diff[-1]:+.5f} (gate "
                  f"{final_gate}; JAX arm {j[-1]:+.5f}), finals oracle "
                  f"{oracle[-1]:.4f} port {ours[-1]:.4f} "
                  f"({time.perf_counter() - t1:.1f} s)", flush=True)
            check(bool(np.isfinite(ours).all()), f"{arm}: non-finite curve")
            check(rms < rms_gate, f"{arm} {rng_impl}: rms {rms}")
            check(abs(diff[-1]) < final_gate,
                  f"{arm} {rng_impl}: final diff {diff[-1]}")
    got = launches()
    check(got == only(**want), f"kernel launches {got}, expected {want}")
    done(t0, f"launches {want} [{label}]")
    return {k: v for k, v in got.items() if "variants" in k}


def fast_scaleup(ctx, label):
    """Phase 12 (d): the scale-up run on the fast generator, then 2e5
    steps with every variant on, on each generator."""
    t0 = phase("12 (d) scale-up on the fast generator, full width")
    p, scene = ctx["p"], ctx["runner"].scene
    runner = SimulationRunner(p, scene=scene, seed=7, device="cuda")
    reset_launches()
    _, cos, _, stats = runner.run(progress=False, max_steps=2_000_000)
    got = launches()
    check(got == only(**{"chunk_near_kernel[fast]": 500,
                         "cand_model_kernel": 500}),
          f"kernel launches {got}")
    check(stats["escapes"] == 0, f"{stats['escapes']} escapes")
    check(stats["coverage_violations"] == 0,
          f"{stats['coverage_violations']} coverage violations")
    check(len(cos) == 1000 and bool(np.isfinite(cos).all()),
          "window sums missing or non-finite")
    print(f"  2e6 steps x {p.num_water} walkers: "
          f"{stats['walker_steps_per_s']:.4e} walker-steps/s, wall "
          f"{stats['wall_s']:.3f} s, launches "
          f"{got['chunk_near_kernel[fast]']}, final sum cos/W "
          f"{cos[-1] / p.num_water:.6f} [{label}]", flush=True)
    compare_cand_model(final_anchors(runner.state, p), p, runner.cache,
                       expansion.coverage_reach2(p))
    out = {"chunk_near_kernel[fast]": got["chunk_near_kernel[fast]"]}
    pv = all_variants(p)
    for rng_impl in ("threefry", "hardware"):
        run = SimulationRunner(pv, scene=scene, seed=7, device="cuda",
                               rng_impl=rng_impl, check_coverage=False)
        reset_launches()
        _, vcos, _, vstats = run.run(progress=False, max_steps=200_000)
        got = launches()
        key = chunk_kernel.chunk_mode("chunk_near_kernel",
                                      cuda_engine.chunk_physics(pv, rng_impl))
        check(got == only(**{key: 50, "cand_model_kernel": 50}),
              f"kernel launches {got}")
        check(vstats["escapes"] == 0 and vstats["coverage_violations"] == 0,
              f"{key}: escapes {vstats['escapes']}, coverage "
              f"{vstats['coverage_violations']}")
        check(len(vcos) == 100 and bool(np.isfinite(vcos).all()),
              f"{key}: window sums missing or non-finite")
        print(f"  every variant, {key}, 2e5 steps: "
              f"{vstats['walker_steps_per_s']:.4e} walker-steps/s, final "
              f"sum cos/W {vcos[-1] / p.num_water:.6f} [{label}]",
              flush=True)
        out[key] = got[key]
    done(t0, f"[{label}]")
    return out


def no_reference_imported():
    """Raise if any module of jax or of the JAX package is loaded."""
    bad = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "mri_nanoparticle_simulation_tpu", "golden_paired")]
    check(not bad, f"imported: {bad[:5]}")


def dec_planes(planes):
    """8-row decompose planes from 6-row ones: A and comp_A from the
    phase rows, B and comp_B nonzero (half of them) so both streams are
    exercised."""
    return torch.cat([planes[:6], 0.5 * planes[4:6]]).contiguous()


def check_dec(run, ref, n, what):
    """Two kernel runs and one plain run of a decompose chunk: the gates
    of phase 14; returns (position error, A/B error, plain ms)."""
    k1, k2 = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(k1, k2):
        check(torch.equal(a, b), f"{what}: two kernel runs differ")
    r, plain_ms = timed(ref)
    out, esc, cov, wins = k1
    pos_err = float((out[:3, :n] - r[0][:3, :n]).abs().max())
    ab_err = max(float((out[4:8, :n] - r[0][4:8, :n]).abs().max()),
                 float((wins[..., :n] - r[3][..., :n]).abs().max()))
    bitwise = torch.equal(out, r[0]) and torch.equal(wins, r[3])
    print(f"  {what}, {n} walkers: |pos| err {pos_err:.3e} (tol {POS_TOL}),"
          f" |A, B| err {ab_err:.3e} (tol {DEC_TOL}; state and record "
          f"{'bitwise equal' if bitwise else 'not bitwise equal'}), "
          f"escapes {int(esc.sum())}/{int(r[1].sum())}, coverage "
          f"{int(cov.sum())}/{int(r[2].sum())}; plain {plain_ms:.1f} ms",
          flush=True)
    check(pos_err < POS_TOL, f"{what}: positions differ by {pos_err}")
    check(ab_err < DEC_TOL, f"{what}: A, B differ by {ab_err}")
    check(bitwise, f"{what}: state or record not bitwise equal")
    check(torch.equal(esc, r[1]), f"{what}: escapes differ")
    check(torch.equal(cov, r[2]), f"{what}: coverage differs")
    check(bool(torch.isfinite(out).all() and torch.isfinite(wins).all()),
          f"{what}: non-finite state or record")
    return pos_err, ab_err, plain_ms


def decompose_modes(dev, label, p, sc, ctx):
    """Phase 14: the decompose mode of both entries in every mode against
    its plain version; times beside each plain-mode sibling."""
    t0 = phase("14 decompose modes vs plain versions")
    out = {}
    physics = (("threefry", lambda q: q), ("hardware", lambda q: q),
               ("threefry", all_variants), ("hardware", all_variants))
    tbl = mnp_table(sc.mnps, torch.float32, dev).tbl
    for rng_impl, fn in physics:
        pm = fn(p)
        errs = []
        for n_water, tcp in ((50, 2 * pm.pfreq), (pm.num_water, None)):
            st = init_state(sc.waters[:n_water], pm, dev, decompose=True)
            planes = cuda_engine.to_soa(st, pm).planes
            planes, *_ = chunk_kernel.run_chunk(
                planes, tbl, decompose=True,
                **chunk_args(pm, n_water, 0, tcp, rng_impl))
            args = chunk_args(pm, n_water, pm.chunk_steps, tcp, rng_impl)
            key = chunk_kernel.chunk_mode("chunk_kernel", args["phys"], True)
            errs.append(check_dec(
                lambda: chunk_kernel.run_chunk(planes, tbl, decompose=True,
                                               **args),
                lambda: cuda_engine.chunk_reference(planes, tbl,
                                                    decompose=True, **args),
                n_water, key))
        ms = time_chunk(lambda: chunk_kernel.run_chunk(
            planes, tbl, decompose=True, **args), 5)
        sib = planes[:6].contiguous()
        sib_ms = time_chunk(lambda: chunk_kernel.run_chunk(sib, tbl, **args),
                            5)
        print(f"  {key}: one chunk (4032 walkers, K=5, 4000 steps) kernel "
              f"{ms:.4f} ms, plain-mode sibling {sib_ms:.4f} ms "
              f"[{label}]", flush=True)
        out[key] = dict(pos_err=max(e[0] for e in errs),
                        ab_err=max(e[1] for e in errs), k=pm.near_k, ms=ms,
                        plain_ms=errs[-1][2], sibling_ms=sib_ms,
                        bound=counts.bound(*counts.chunk_work(
                            args["num_water"], work_mode(args["phys"]),
                            tbl.shape[1], decompose=True)))
    big = ctx["p"]
    planes = dec_planes(ctx["planes"])
    full = dec_planes(ctx["full"])
    for rng_impl, fn in physics:
        phys = cuda_engine.chunk_physics(fn(big), rng_impl)
        cargs = dict(ctx["cargs"], phys=phys)
        key = chunk_kernel.chunk_mode("chunk_near_kernel", phys, True)
        near, taylor = ctx["near"], ctx["taylor"]
        pos_err, ab_err, _ = check_dec(
            lambda: chunk_kernel.run_chunk_near(planes, near, taylor,
                                                decompose=True, **cargs),
            lambda: cuda_engine.chunk_near_reference(
                planes, near, taylor, decompose=True, **cargs),
            cargs["num_water"], key)
        # and at the width of its path (phase 16)
        fargs = dict(ctx["fargs"], phys=phys)
        fnear, ftaylor = ctx["fnear"], ctx["ftaylor"]
        errs = check_dec(
            lambda: chunk_kernel.run_chunk_near(full, fnear, ftaylor,
                                                decompose=True, **fargs),
            lambda: cuda_engine.chunk_near_reference(
                full, fnear, ftaylor, decompose=True, **fargs),
            fargs["num_water"], key)
        pos_err, ab_err, plain = (max(pos_err, errs[0]),
                                  max(ab_err, errs[1]), errs[2])
        ms = time_chunk(lambda: chunk_kernel.run_chunk_near(
            full, fnear, ftaylor, decompose=True, **fargs), 3)
        sib = full[:6].contiguous()
        sib_ms = time_chunk(lambda: chunk_kernel.run_chunk_near(
            sib, fnear, ftaylor, **fargs), 3)
        print(f"  {key}: one chunk ({full.shape[1]} walkers, K="
              f"{big.near_k}, 4000 steps) kernel {ms:.3f} ms, plain-mode "
              f"sibling {sib_ms:.3f} ms [{label}]", flush=True)
        out[key] = dict(pos_err=pos_err, ab_err=ab_err, k=big.near_k, ms=ms,
                        plain_ms=plain, sibling_ms=sib_ms,
                        bound=counts.bound(*counts.chunk_work(
                            fargs["num_water"], work_mode(phys),
                            decompose=True)))
    done(t0, f"{len(out)} decompose modes [{label}]")
    return out


def split_line(st, copied="record"):
    return (f"run {st['wall_s']:.4f} s ({st['walker_steps_per_s']:.4e} "
            f"walker-steps/s), {st['sprints']} sprints: device "
            f"{st['device_s']:.4f} s, {copied} copy {st['copy_s']:.4f} s, "
            f"host {st['host_s']:.4f} s")


def check_reconstruction(rec, cos, w, what, early=40):
    """A reconstructed walker-mean curve against a direct run's Σcos:
    within REC_TOL over the first ``early`` windows and REC_RUN_TOL over
    the run; returns the two errors."""
    check(len(rec) == len(cos), f"{what}: {len(rec)} vs {len(cos)} windows")
    d = np.abs(rec - cos / w)
    d_early, d_all = float(d[:early].max()), float(d.max())
    print(f"  {what}: max |d(sum cos/W)| {d_early:.3e} over the first "
          f"{min(early, len(d))} windows (tol {REC_TOL}), {d_all:.3e} over "
          f"{len(d)} (tol {REC_RUN_TOL})", flush=True)
    check(d_early < REC_TOL, f"{what}: {d_early} early")
    check(d_all < REC_RUN_TOL, f"{what}: {d_all} over the run")
    return d_early, d_all


def decompose_headline(sc, direct_golden, oracle, label, keep):
    """Phase 15: README configuration 5c through the port CLI at full
    width, the golden check of the Threefry decompose kernel, and the
    variants on the headline; returns the decompose launches of each
    path and keeps the 5c run's argv, CSVs and record in ``keep``."""
    t0 = phase("15 decomposition through the CLI, headline, fast generator")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "t2.csv")
        argv = ["--num-water", "4032", "--num-cells", "270", "--totaltime",
                "2", "--taucp", "0.25", "--chunk-steps", "4000", "--near-k",
                "5", "--scene-seed", "42", "--seed", "7", "--moment-scales",
                "0.5,1,2,4", "--echo-taucps", "0.05,0.1,0.25,0.5",
                "--dump-record", os.path.join(tmp, "rec.npz"), "--fit-r2",
                os.path.join(tmp, "r2.csv"), "--out", csv, "--device",
                "cuda"]
        ap = sim.build_parser()
        p = sim.params_from_args(ap, ap.parse_args(argv))
        check(p.t == 2_000_000 and p.num_water == 4032, "CLI params")
        got, text, cli_wall = run_cli(argv)
        check(got == only(**{"chunk_kernel[fast+dec]": 500}),
              f"kernel launches {got}, expected 500 chunk_kernel[fast+dec]")
        out["chunk_kernel[fast+dec]"] = got["chunk_kernel[fast+dec]"]
        curves = grid_csvs(tmp)
        with np.load(os.path.join(tmp, "rec.npz")) as z:
            keys = sorted(z.files)
            rec_shape = z["A"].shape
        check(keys == sorted(["times_ms", "A", "B", "params_fp", "mmoment",
                              "seed", "taucp", "tau", "pfreq"]),
              f"record keys {keys}")
        check(rec_shape == (2000, 4032), f"record A {rec_shape}")
        keep["5c"] = dict(argv=argv, csvs=csv_texts(tmp))
        with np.load(os.path.join(tmp, "rec.npz")) as z:
            keep["5c"].update(A=z["A"], B=z["B"], times_ms=z["times_ms"],
                              mmoment=float(z["mmoment"]))
        with open(os.path.join(tmp, "r2.csv")) as fh:
            r2 = fh.read().splitlines()
        check(len(r2) == 17, f"dispersion table of {len(r2)} lines")
        print(f"  16 CSVs x 2000 rows, record A/B {rec_shape}, dispersion "
              f"table of {len(r2) - 1} rows; launches {got}; CLI wall "
              f"{cli_wall:.4f} s", flush=True)
    base = BacteriaBox(p, seed=42).populate()
    for s, t_cp in ((1.0, 0.25), (2.0, 0.25), (1.0, 0.1)):
        pv = p.replace(mmoment=p.mmoment * s, taucp=t_cp).validate()
        run = SimulationRunner(pv, scene=golden.scale_moments(base, s),
                               seed=7, device="cuda", check_coverage=False)
        _, cos, _, st = run.run(progress=False)
        check(st["escapes"] == 0 and st["coverage_violations"] == 0,
              "direct run escapes or violations")
        rec = curves[f"t2_mscale={s:g}_taucp={t_cp:g}.csv"] / p.num_water
        check_reconstruction(rec, cos, p.num_water,
                             f"CLI s={s:g} taucp={t_cp:g} vs direct run")
    done(t0, f"[{label}]")

    t0 = phase("15 (b) golden scene 6000 from one Threefry decompose run")
    gpar = golden.framework_params()
    scene = golden.load_scene(os.path.join(ROOT, "golden", "testdata",
                                           "scene_6000"), gpar)
    reset_launches()
    res = dec.run_decomposition(scene, gpar, seed=golden.FW_RUN0,
                                device="cuda", rng_impl="threefry")
    got = launches()
    check(got == only(**{"chunk_kernel[dec]": 500}),
          f"kernel launches {got}, expected 500 chunk_kernel[dec]")
    out["chunk_kernel[dec]"] = got["chunk_kernel[dec]"]
    check(res.stats["escapes"] == 0 and res.stats["coverage_violations"]
          == 0, "golden decompose run: escapes or violations")
    curve = dec.curves_at_scales(res.A, res.B, [golden.MSCALE])[0]
    n = len(curve)
    diff = oracle[:n] - curve
    rms = float(np.sqrt(np.mean(diff ** 2)))
    d_direct = float(np.abs(curve - direct_golden[:n]).max())
    print(f"  s = {golden.MSCALE:g}: rms {rms:.5f} (gate 0.025), final diff "
          f"{diff[-1]:+.5f} (gate 0.060) against the oracle; max "
          f"|d| {d_direct:.3e} against phase 5's direct run (tol "
          f"{REC_RUN_TOL}); {split_line(res.stats)}", flush=True)
    check(n == golden.STEPS // golden.PFREQ, f"{n} windows")
    check(rms < 0.025, f"golden decompose rms {rms}")
    check(abs(diff[-1]) < 0.060, f"golden decompose final diff {diff[-1]}")
    check(d_direct < REC_RUN_TOL, f"golden decompose vs direct {d_direct}")
    done(t0, f"[{label}]")

    t0 = phase("15 (c) every variant in decompose mode, headline")
    hp = all_variants(Params(**HEADLINE, taucp=0.05, totaltime=0.2))
    for rng_impl in ("threefry", "hardware"):
        reset_launches()
        res = dec.run_decomposition(sc, hp, seed=7, device="cuda",
                                    rng_impl=rng_impl)
        got = launches()
        key = chunk_kernel.chunk_mode(
            "chunk_kernel", cuda_engine.chunk_physics(hp, rng_impl), True)
        check(got == only(**{key: 50}), f"kernel launches {got}")
        out[key] = got[key]
        check(res.stats["escapes"] == 0 and res.stats[
            "coverage_violations"] == 0, f"{key}: escapes or violations")
        run = SimulationRunner(hp, scene=sc, seed=7, device="cuda",
                               rng_impl=rng_impl, check_coverage=False)
        _, cos, _, _ = run.run(progress=False)
        check_reconstruction(dec.curves_at_scales(res.A, res.B, [1.0])[0],
                             cos, hp.num_water, f"{key}, 2e5 steps, s=1")
    done(t0, f"[{label}]")

    out.update(plane_cli(argv, curves, r2, cli_wall, p.num_water,
                         p.t // p.sprint_steps, label))
    return out


def plane_cli(argv, curves, r2, cli_wall, num_water, sprints, label):
    """Phase 15 (d): the 5c CLI run ``argv`` of phase 15 with
    --plane-device --dump-echoes in place of --dump-record, held to that
    run's CSVs ``curves`` and dispersion table ``r2`` (one fold launch
    for each of its ``sprints``); then the port's mri-t2-fit on the echo
    captures.  Returns the run's launches."""
    t0 = phase("15 (d) the same CLI run with --plane-device --dump-echoes")
    with tempfile.TemporaryDirectory() as tmp:
        echoes = os.path.join(tmp, "e.npz")
        i = argv.index("--dump-record")
        pargv = argv[:i] + ["--plane-device", "--dump-echoes", echoes] \
            + argv[i + 2:]
        pargv[pargv.index("--fit-r2") + 1] = os.path.join(tmp, "r2.csv")
        pargv[pargv.index("--out") + 1] = os.path.join(tmp, "t2.csv")
        got, text, plane_wall = run_cli(pargv)
        check(got == only(**{"chunk_kernel[fast+dec]": 500,
                             "plane_fold_kernel": sprints}),
              f"kernel launches {got}, expected 500 chunk_kernel[fast+dec] "
              f"and {sprints} plane_fold_kernel")
        plane_curves = grid_csvs(tmp)
        check(sorted(plane_curves) == sorted(curves), "grid points differ")
        d_plane = max(float(np.abs(plane_curves[k] - curves[k]).max())
                      for k in curves) / num_water
        print(f"  16 CSVs: max |d(sum cos/W)| {d_plane:.3e} against phase "
              f"15's (tol {PLANE_TOL})", flush=True)
        check(d_plane < PLANE_TOL, f"plane CSVs differ by {d_plane}")
        with open(os.path.join(tmp, "r2.csv")) as fh:
            r2_plane = fh.read().splitlines()
        check(len(r2_plane) == len(r2) and r2_plane[0] == r2[0]
              and [ln.split(",")[:2] for ln in r2_plane]
              == [ln.split(",")[:2] for ln in r2],
              "dispersion table differs in shape")
        table = os.path.join(tmp, "boot.csv")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = analysis.main(["--echoes", echoes, "--bootstrap", "32",
                                "--out-table", table])
        check(rc == 0, f"analysis exit {rc}")
        with open(table) as fh:
            boot = [ln.split(",") for ln in fh.read().splitlines()[1:]]
        check(len(boot) == 16, f"{len(boot)} bootstrap rows")
        n_fit = 0
        for row in boot:
            t2, lo, hi, n_ok = (float(row[3]), float(row[4]),
                                float(row[5]), int(row[7]))
            if n_ok > 0:
                n_fit += 1
                check(np.isfinite(t2) and lo <= t2 <= hi,
                      f"bootstrap row {row}")
        check(n_fit > 0, "no grid point could be bootstrapped")
    print(f"  echo bootstrap: {n_fit}/16 grid points fitted, T2 inside "
          f"its 95% CI; CLI wall {plane_wall:.4f} s (--plane-device) "
          f"against {cli_wall:.4f} s (phase 15, record and float64 host "
          f"reconstruction)", flush=True)
    done(t0, f"[{label}]")
    return {k: got[k] for k in ("chunk_kernel[fast+dec]",
                                "plane_fold_kernel")}


#: the headline-plane cell's fold (port_bench/cells/headline-plane.json):
#: 4032 walkers of 4096, four moment scales, four echo spacings (ms)
FOLD_W, FOLD_W_PAD = 4032, 4096
FOLD_SCALES = (0.5, 1.0, 2.0, 4.0)
FOLD_TAUCPS = (0.05, 0.1, 0.25, 0.5)
FOLD_TOL = 1e-6    # curve block, kernel vs twin (float32 sums)


def plane_fold_phase(label):
    """Phase 15 (e): the plane fold's kernel against its twin (the plain
    body of make_plane_step) at the headline-plane cell's shapes, on a
    seeded record, three sprints chained through the carry from the
    run's sprint 11 (the base run's flip at window 250): the carry bitwise
    the CPU twin's, the block within FOLD_TOL, two launches bitwise
    equal; ms a sprint of the kernel and of the twin on the card, the
    host's us a call of both, the bound, launches, registers and layout.
    Returns the kernel table's fields."""
    t0 = phase("15 (e) plane fold kernel vs its twin, headline-plane "
               "shapes")
    p = Params(**HEADLINE, totaltime=2.0, taucp=0.25).validate()
    wps = p.sprint_steps // p.pfreq
    n_win = p.t // p.pfreq
    tcps = [p.replace(taucp=t).validate().tcp for t in FOLD_TAUCPS]
    j = np.arange(1, n_win + 1, dtype=np.int64)
    undo = np.where((j * p.pfreq) % p.tcp == 0, -1.0, 1.0)
    u = torch.tensor(np.concatenate([[1.0], undo[:-1]]), dtype=torch.float32)
    g = torch.tensor(np.stack([dec._flip_parity(n_win, t, p.pfreq)
                               for t in tcps]), dtype=torch.float32)
    rng = np.random.default_rng(5)
    rec = torch.from_numpy(np.cumsum(
        rng.normal(0.0, 1.0, (3 * wps, 2, FOLD_W_PAD))
        * np.array([0.5, 0.1])[:, None], 0).astype(np.float32))
    n_t = len(tcps)
    card = dec.make_plane_step(p, FOLD_W, FOLD_SCALES, n_t, device="cuda")
    cpu = dec.make_plane_step(p, FOLD_W, FOLD_SCALES, n_t, device="cpu")
    rec_d, u_d, g_d = rec.cuda(), u.cuda(), g.cuda()

    def zeros(dev):
        return (torch.zeros((n_t, FOLD_W), device=dev),) * 4 \
            + (torch.zeros(FOLD_W, device=dev),) * 2
    ck, cc, ct = zeros("cuda"), zeros("cpu"), zeros("cuda")
    reset_launches()
    blk_err = twin_err = 0.0
    for i in range(3):
        lo = (11 + i) * wps
        args = (u_d[lo:lo + wps], g_d[:, lo:lo + wps])
        rows = rec_d[i * wps:(i + 1) * wps]
        k_out = card(rows, ck, *args)
        again = card(rows, ck, *args)
        c_out = cpu(rows.cpu(), cc, u[lo:lo + wps], g[:, lo:lo + wps])
        t_out = card.twin(rows, ct, *args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(k_out[0], again[0]))
              and torch.equal(k_out[1], again[1]),
              "two plane-fold launches differ")
        check(all(torch.equal(a.cpu(), b) for a, b in zip(k_out[0],
                                                          c_out[0])),
              f"sprint {i}: the kernel's carry is not the twin's")
        blk_err = max(blk_err, float((k_out[1].cpu() - c_out[1]).abs()
                                     .max()))
        twin_err = max(twin_err, float((k_out[1] - t_out[1]).abs().max()))
        ck, cc, ct = k_out[0], c_out[0], t_out[0]
    check(blk_err <= FOLD_TOL, f"plane-fold block differs by {blk_err}")
    check(launches() == only(plane_fold_kernel=6), f"launches {launches()}")
    rows, args = rec_d[:wps], (u_d[:wps], g_d[:, :wps])
    ms = time_chunk(lambda: card(rows, ck, *args), 200)
    plain_ms = time_chunk(lambda: card.twin(rows, ck, *args), 10)
    host_us = {}
    for name, fn in (("kernel", card), ("twin", card.twin)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(20):
            fn(rows, ck, *args)
        host_us[name] = (time.perf_counter() - t1) / 20 * 1e6
        torch.cuda.synchronize()
    bound = counts.bound(*counts.plane_fold_work(
        FOLD_W, FOLD_W_PAD, wps, len(FOLD_SCALES), n_t))
    info = chunk_kernel.plane_fold_info(len(FOLD_SCALES), wps, 0)
    blocks = -(-FOLD_W // chunk_kernel.BLOCK) * n_t
    print(f"  {FOLD_W} of {FOLD_W_PAD} walkers, {wps} windows, "
          f"{len(FOLD_SCALES)} scales x {n_t} spacings: carry bitwise the "
          f"CPU twin's, block within {blk_err:.3e} (tol {FOLD_TOL}) of it "
          f"and {twin_err:.3e} of the twin on the card; kernel "
          f"{ms:.5f} ms a sprint, twin on the card {plain_ms:.5f} ms, "
          f"bound {bound[0]:.6f} ms ({bound[1]}); host {host_us['kernel']:.1f}"
          f" us a call (twin {host_us['twin']:.1f}); 6 launches counted "
          f"for 6 calls; {blocks} blocks of "
          f"{info.threads} threads, {info.regs} registers, "
          f"{info.blocks_per_sm} resident per SM, {info.smem} B dynamic "
          f"shared, {info.local_bytes} B local [{label}]", flush=True)
    done(t0, f"[{label}]")
    return {"max_abs_err": blk_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "host_us": host_us["kernel"], "plain_host_us": host_us["twin"],
            "blocks": blocks, "threads": info.threads,
            "registers": info.regs, "blocks_per_sm": info.blocks_per_sm,
            "smem": info.smem, "local_bytes": info.local_bytes}


def decompose_scaleup(ctx, label, keep):
    """Phase 16: the scale-up with a streaming plane on the fast
    generator, then Threefry and every variant, each against a direct
    run; returns the decompose launches of each path and keeps the host
    plane in ``keep``."""
    t0 = phase("16 decomposition, scale-up, streaming plane, fast generator")
    p = ctx["p"].replace(totaltime=0.1).validate()     # 2e5 steps
    scene, cache = ctx["runner"].scene, ctx["runner"].cache
    scales, taucps = [0.5, 1.0, 2.0], [0.01, 0.02, p.taucp]
    plane = dec.StreamingPlane(p, p.t // p.pfreq, scales, taucps,
                               quadrature=True)
    reset_launches()
    res = dec.run_decomposition(scene, p, seed=7, device="cuda",
                                rng_impl="hardware", consumer=plane,
                                cache=cache)
    got = launches()
    check(got == only(**{"chunk_near_kernel[fast+dec]": 50,
                         "cand_model_kernel": 50}),
          f"kernel launches {got}")
    out = {"chunk_near_kernel[fast+dec]": got["chunk_near_kernel[fast+dec]"]}
    check(res.stats["escapes"] == 0 and res.stats["coverage_violations"]
          == 0, "scale-up decompose: escapes or violations")
    curves = plane.result()
    n_win = p.t // p.pfreq
    check(curves.shape == (3, 3, n_win, 2)
          and bool(np.isfinite(curves).all()), f"plane {curves.shape}")
    _, cos, _, final = cuda_engine.run_simulation(
        scene, p, seed=7, device="cuda", rng_impl="hardware", cache=cache)
    check_reconstruction(curves[1, 2, :, 0], cos, p.num_water,
                         "plane s=1 vs direct run", early=n_win)
    # the direct run moves the same walkers as the plane's run
    compare_cand_model(final_anchors(final, p), p, cache,
                       expansion.coverage_reach2(p))
    print(f"  {p.num_water} walkers, 2e5 steps, 9 grid points: "
          f"{split_line(res.stats)} [{label}]", flush=True)
    done(t0, f"launches {got} [{label}]")
    host_plane, host_stats = curves, res.stats
    keep["plane16"] = host_plane

    t0 = phase("16 (b) scale-up decompose on Threefry and every variant")
    p = p.replace(totaltime=0.01).validate()           # 2e4 steps
    for rng_impl, fn in (("threefry", lambda q: q),
                         ("threefry", all_variants),
                         ("hardware", all_variants)):
        pv = fn(p)
        reset_launches()
        res = dec.run_decomposition(scene, pv, seed=7, device="cuda",
                                    rng_impl=rng_impl, cache=cache)
        got = launches()
        key = chunk_kernel.chunk_mode(
            "chunk_near_kernel", cuda_engine.chunk_physics(pv, rng_impl),
            True)
        check(got == only(**{key: 5, "cand_model_kernel": 5}),
              f"kernel launches {got}")
        out[key] = got[key]
        check(res.stats["escapes"] == 0 and res.stats[
            "coverage_violations"] == 0, f"{key}: escapes or violations")
        _, cos, _, _ = cuda_engine.run_simulation(
            scene, pv, seed=7, device="cuda", rng_impl=rng_impl,
            cache=cache)
        check_reconstruction(dec.curves_at_scales(res.A, res.B, [1.0])[0],
                             cos, pv.num_water, f"{key}, 2e4 steps, s=1")
    done(t0, f"[{label}]")

    t0 = phase("16 (c) the same plane on the device")
    p = ctx["p"].replace(totaltime=0.1).validate()     # 2e5 steps
    reset_launches()
    _, dev_plane, st, _ = dec.run_plane_on_device(
        scene, p, scales, taucps, seed=7, device="cuda",
        rng_impl="hardware", cache=cache)
    got = launches()
    check(got == only(**{"chunk_near_kernel[fast+dec]": 50,
                         "cand_model_kernel": 50,
                         "plane_fold_kernel": p.t // p.sprint_steps}),
          f"kernel launches {got}")
    check(st["escapes"] == 0 and st["coverage_violations"] == 0,
          "on-device plane: escapes or violations")
    check(dev_plane.shape == host_plane.shape
          and bool(np.isfinite(dev_plane).all()), f"plane {dev_plane.shape}")
    d_plane = float(np.abs(dev_plane - host_plane).max())
    print(f"  curves: max |d| {d_plane:.3e} against phase 16's host plane "
          f"(tol {PLANE_TOL}); on the device: {split_line(st, 'curve')}, "
          f"beside "
          f"phase 16's {split_line(host_stats)}", flush=True)
    check(d_plane < PLANE_TOL, f"on-device plane differs by {d_plane}")
    done(t0, f"launches {got} [{label}]")
    return out


def csv_texts(tmp):
    """{file name: text} of the grid-point CSVs a 5c CLI run wrote into
    ``tmp``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(tmp, "t2_mscale=*.csv"))):
        with open(path) as fh:
            out[os.path.basename(path)] = fh.read()
    return out


def checkpoint_step(path):
    """The step of the checkpoint at ``path`` (None while there is none
    or it cannot be read)."""
    try:
        with np.load(path) as z:
            return int(z["step"])
    except (OSError, ValueError, KeyError, EOFError):
        return None


def kill_at_step(argv, ckpt, at_least, total, log):
    """Run the port CLI with ``argv`` as a process of its own, SIGKILL it
    as soon as its checkpoint ``ckpt`` holds a step of at least
    ``at_least`` (below ``total``, the run's end), and return that
    step.  The process is stopped whatever happens."""
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "mri_nanoparticle_simulation_tpu_torch.engine.sim", *argv],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=err)
        try:
            seen, step = None, None
            deadline = time.perf_counter() + 300
            while proc.poll() is None and time.perf_counter() < deadline:
                try:
                    mtime = os.stat(ckpt).st_mtime_ns
                except FileNotFoundError:
                    mtime = None
                if mtime is not None and mtime != seen:
                    seen = mtime
                    step = checkpoint_step(ckpt)
                    if step is not None and step >= at_least:
                        proc.send_signal(signal.SIGKILL)
                        break
                time.sleep(0.001)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    with open(log) as fh:
        tail = fh.read()[-2000:]
    check(proc.returncode == -signal.SIGKILL,
          f"the run was not killed (exit {proc.returncode}):\n{tail}")
    check(step is not None and at_least <= step < total,
          f"killed at checkpoint step {step}, not mid-run")
    return step


def run_process(argv, log):
    """Run the port CLI with ``argv`` as a process of its own; it must
    exit 0.  Returns its wall seconds."""
    t0 = time.perf_counter()
    with open(log, "w") as err:
        rc = subprocess.run(
            [sys.executable, "-m",
             "mri_nanoparticle_simulation_tpu_torch.engine.sim", *argv],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=err,
            timeout=600).returncode
    with open(log) as fh:
        text = fh.read()
    check(rc == 0, f"CLI process exit {rc}:\n{text[-2000:]}")
    m = re.search(r"(\d+) chunk escapes, (\d+) coverage violations", text)
    check(m is not None and m.groups() == ("0", "0"),
          "escapes or coverage violations")
    return time.perf_counter() - t0


def durability(ctx, keep, label):
    """Phase 18: durability at full width.  (a) the headline through
    run_resilient with injected faults, then a hung drain, on both
    generators; (b) the CLI killed mid-run and run again; (c) phase 15's
    5c run with a record store, killed and run again; (d) phase 16's
    plane through run_streaming_durable with a fault; (e) scene files
    and families through the CLI; (f) the cost of a checkpoint's save
    and resume."""
    t0 = phase("18 (a) durability: in-process recovery, headline")
    hp = Params(**HEADLINE)
    scene = keep["scene"]
    with tempfile.TemporaryDirectory() as tmp:
        for rng_impl in ("threefry", "hardware"):
            def make_runner():
                return SimulationRunner(hp, scene=scene, seed=7,
                                        device="cuda", rng_impl=rng_impl)
            if rng_impl == "threefry":
                ref = keep["t4_csv"]
            else:
                path = os.path.join(tmp, "fast.csv")
                make_runner().run(csv_path=path, progress=False,
                                  max_steps=2_000_000)
                with open(path) as fh:
                    ref = fh.read()
                check(np.array_equal(read_t2_csv(path)[1],
                                     keep["fast_cos"]),
                      "the fast run differs from phase 10's")
            csv = os.path.join(tmp, f"{rng_impl}.csv")
            ckpt = os.path.join(tmp, f"{rng_impl}.npz")
            inj = resilience.FaultInjector({5: 1, 13: 1})
            reset_launches()
            t1 = time.perf_counter()
            _, cos, _, stats = resilience.run_resilient(
                make_runner, csv_path=csv, checkpoint_path=ckpt,
                checkpoint_every_sprints=2, drain_depth=1, max_retries=2,
                fault_hook=inj, progress=False, max_steps=2_000_000)
            wall = time.perf_counter() - t1
            got = launches()
            with open(csv) as fh:
                text = fh.read()
            check(inj.faults_fired == 2 and stats["recovery_attempts"] == 2,
                  f"{rng_impl}: faults {inj.faults_fired}, recoveries "
                  f"{stats['recovery_attempts']}")
            check(text == ref, f"{rng_impl}: the recovered CSV differs "
                  f"from the uninterrupted run's")
            if rng_impl == "threefry":
                check(np.array_equal(cos, keep["t4_cos"]),
                      "the recovered curve differs from phase 4's")
            check(stats["escapes"] == 0
                  and stats["coverage_violations"] == 0,
                  f"{rng_impl}: escapes or violations")
            print(f"  {rng_impl}: faults at sprints 5 and 13 recovered "
                  f"(2 rebuilds, checkpoints every 2 sprints, drain depth "
                  f"1): CSV bytewise equal to the uninterrupted run's "
                  f"({len(text.splitlines())} rows); {wall:.3f} s, "
                  f"launches {launched(got)}", flush=True)
        # a drain that hangs past the watchdog's deadline
        built = []

        def hung_first():
            r = SimulationRunner(hp, scene=scene, seed=7, device="cuda",
                                 rng_impl="threefry")
            if not built:
                orig = r._fetch_pending
                r._fetch_pending = \
                    lambda pending: (time.sleep(4.0), orig(pending))[1]
            built.append(r)
            return r

        csv = os.path.join(tmp, "hung.csv")
        err = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            _, _, _, stats = resilience.run_resilient(
                hung_first, csv_path=csv,
                checkpoint_path=os.path.join(tmp, "hung.npz"),
                checkpoint_every_sprints=2, drain_depth=1, max_retries=1,
                drain_timeout_s=2.0, progress=False, max_steps=2_000_000)
        wall = time.perf_counter() - t1
        with open(csv) as fh:
            text = fh.read()
        check("WatchdogTimeout" in err.getvalue(), "no watchdog timeout")
        check(stats["recovery_attempts"] == 1 and len(built) == 2,
              f"hung drain: {stats['recovery_attempts']} recoveries")
        check(text == keep["t4_csv"], "hung drain: the CSV differs")
        print(f"  a drain hung 4 s past a 2 s deadline: WatchdogTimeout, "
              f"rebuilt, CSV bytewise equal; {wall:.3f} s", flush=True)
    done(t0, f"[{label}]")

    t0 = phase("18 (b) the CLI killed mid-run and run again")
    cli = ["--num-water", "4032", "--num-cells", "270", "--totaltime", "2",
           "--chunk-steps", "4000", "--near-k", "5", "--scene-seed", "42",
           "--seed", "7", "--rng", "threefry", "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        ref_csv = os.path.join(tmp, "ref.csv")
        got, _, ref_wall = run_cli(cli + ["--out", ref_csv])
        check(got == only(chunk_kernel=500), f"kernel launches {got}")
        with open(ref_csv) as fh:
            ref = fh.read()
        print(f"  the uninterrupted CLI run: {ref_wall:.3f} s; its CSV "
              f"{'equals' if ref == keep['t4_csv'] else 'differs from'} "
              f"phase 4's", flush=True)
        out, ckpt = os.path.join(tmp, "x.csv"), os.path.join(tmp, "c.npz")
        argv = cli + ["--checkpoint", ckpt, "--checkpoint-every", "4",
                      "--max-retries", "2", "--out", out]
        t1 = time.perf_counter()
        step = kill_at_step(argv, ckpt, 800_000, 2_000_000,
                            os.path.join(tmp, "kill.log"))
        kill_s = time.perf_counter() - t1
        rows = len(open(out).read().splitlines())
        again_s = run_process(argv, os.path.join(tmp, "again.log"))
        with open(out) as fh:
            check(fh.read() == ref, "the re-run's CSV differs from the "
                  "uninterrupted run's")
        print(f"  SIGKILL at checkpoint step {step} ({rows} rows on disk; "
              f"process {kill_s:.3f} s), the same command again "
              f"{again_s:.3f} s: CSV bytewise equal", flush=True)
        keep["headline_cli"] = (cli, ref)
    done(t0, f"[{label}]")

    t0 = phase("18 (c) a durable 5c record, killed and run again")
    c5 = keep["5c"]
    with tempfile.TemporaryDirectory() as tmp:
        argv = list(c5["argv"])
        i = argv.index("--dump-record")
        store, ckpt = os.path.join(tmp, "rec"), os.path.join(tmp, "c.npz")
        argv[i:i + 2] = ["--record-dir", store, "--checkpoint", ckpt,
                         "--checkpoint-every", "4"]
        argv[argv.index("--fit-r2") + 1] = os.path.join(tmp, "r2.csv")
        argv[argv.index("--out") + 1] = os.path.join(tmp, "t2.csv")
        t1 = time.perf_counter()
        step = kill_at_step(argv, ckpt, 800_000, 2_000_000,
                            os.path.join(tmp, "kill.log"))
        kill_s = time.perf_counter() - t1
        rows = record_mod.RecordStore.open(store).rows
        step = checkpoint_step(ckpt)          # where the re-run resumes
        got, _, again_s = run_cli(argv)
        want = (2_000_000 - step) // 100_000 * 25
        check(got == only(**{"chunk_kernel[fast+dec]": want}),
              f"kernel launches {got}, expected {want} "
              f"chunk_kernel[fast+dec]")
        st = record_mod.RecordStore.open(store)
        check(st.complete, "the store is not complete")
        a, b = st.arrays()
        check(np.array_equal(a, c5["A"]) and np.array_equal(b, c5["B"]),
              "the store's A/B differ from phase 15's record")
        check(csv_texts(tmp) == c5["csvs"], "the 16 CSVs differ from "
              "phase 15's")
        got3, _, third_s = run_cli(argv)
        check(got3 == only(), f"the run on the complete store launched "
              f"{got3}")
        check(csv_texts(tmp) == c5["csvs"], "the third run's CSVs differ")
        print(f"  SIGKILL at checkpoint step {step} ({rows} record rows "
              f"committed; process {kill_s:.3f} s), the same command "
              f"again {again_s:.3f} s ({want} launches): A/B bitwise "
              f"equal to phase 15's record, 16 CSVs bytewise equal; a "
              f"third run on the complete store {third_s:.3f} s, no "
              f"launch", flush=True)
    done(t0, f"[{label}]")

    t0 = phase("18 (d) a durable stream plane, scale-up, fast generator")
    p = ctx["p"].replace(totaltime=0.1).validate()     # 2e5 steps
    big, cache = ctx["runner"].scene, ctx["runner"].cache
    scales, taucps = [0.5, 1.0, 2.0], [0.01, 0.02, p.taucp]
    n_sprints = p.t // p.sprint_steps
    check(n_sprints >= 5, f"{n_sprints} sprints")

    def plane():
        return dec.StreamingPlane(p, p.t // p.pfreq, scales, taucps,
                                  quadrature=True)

    def durable(pl, snap, **kw):
        return dec.run_streaming_durable(
            big, p, pl, snap, seed=7, device="cuda", rng_impl="hardware",
            snapshot_every_sprints=1, cache=cache, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "snap.npz")
        reset_launches()
        t1 = time.perf_counter()
        try:
            durable(plane(), snap, fault_hook=resilience.FaultInjector(
                {2: 1}))
            raise AssertionError("the injected fault did not fire")
        except RuntimeError as e:
            check("injected fault at sprint 2" in str(e), str(e))
        killed_s = time.perf_counter() - t1
        resumed = plane()
        t1 = time.perf_counter()
        st = durable(resumed, snap)
        resume_s = time.perf_counter() - t1
        got = launches()
        check(0 < st["sprints"] < n_sprints, f"resumed {st['sprints']} of "
              f"{n_sprints} sprints")
        check(set(launched(got)) == {"chunk_near_kernel[fast+dec]",
                                     "cand_model_kernel"},
              f"kernel launches {got}")
        check(st["escapes"] == 0 and st["coverage_violations"] == 0,
              "durable plane: escapes or violations")
        whole = plane()
        reset_launches()
        st_whole = durable(whole, os.path.join(tmp, "whole.npz"))
        got_whole = launches()
        check(got_whole == only(**{"chunk_near_kernel[fast+dec]": 50,
                                   "cand_model_kernel": 50}),
              f"kernel launches {got_whole}")
        check(np.array_equal(resumed.result(), whole.result()),
              "the resumed plane differs from the uninterrupted one")
        d16 = float(np.abs(whole.result() - keep["plane16"]).max())
        check(d16 < 1e-6, f"the durable plane is {d16} from phase 16's")
        print(f"  {n_sprints} sprints, a snapshot after each, a fault at the "
              f"third: {killed_s:.3f} s, then resumed at sprint "
              f"{n_sprints - st['sprints']} in {resume_s:.3f} s "
              f"(launches {launched(got)}); curves bitwise equal to an "
              f"uninterrupted call ({st_whole['wall_s']:.3f} s), max |d| "
              f"{d16:.3e} from phase 16's plane (tol 1e-6)", flush=True)
    done(t0, f"[{label}]")

    t0 = phase("18 (e) scene files and scene families through the CLI")
    cli, ref = keep["headline_cli"]
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "scene.npz")
        runs = {}
        for name, extra in (("--save-scene", ["--save-scene", npz]),
                            ("--scene-file archive", ["--scene-file", npz])):
            out = os.path.join(tmp, "s.csv")
            got, _, wall = run_cli(cli + extra + ["--out", out])
            with open(out) as fh:
                check(fh.read() == ref, f"{name}: the CSV differs from the "
                      f"seed-42 CLI run's")
            runs[name] = (wall, launched(got))
        cells = os.path.join(tmp, "cells.csv")
        np.savetxt(cells, scene.cells, delimiter=",")
        custom = scene_io.CustomBox(
            hp, scene_io.load_cells_csv(cells), seed=42).populate()
        for f in ("cells", "mnps", "waters", "lookup_table"):
            check(np.array_equal(getattr(custom, f), getattr(scene, f)),
                  f"CustomBox of the 270 centres: {f} differs")
        out = os.path.join(tmp, "c.csv")
        got, _, wall = run_cli(cli + ["--scene-file", cells, "--out", out])
        with open(out) as fh:
            check(fh.read() == ref, "--scene-file cells.csv: the CSV "
                  "differs from the seed-42 CLI run's")
        runs["--scene-file cells.csv (CustomBox)"] = (wall, launched(got))
        for name, (wall, got) in runs.items():
            print(f"  {name}: CSV bytewise equal to the seed-42 run's; "
                  f"{wall:.3f} s, launches {got}", flush=True)
        fam = ["--num-water", "4032", "--num-cells", "270", "--totaltime",
               "0.2", "--scene-seed", "42", "--seed", "7", "--device",
               "cuda", "--chunk-steps", "1000"]
        for family, extra, box in (
                ("clustered", ["--near-k", "10", "--max-neighbors", "48"],
                 lambda q: ClusteredBacteriaBox(q, seed=42)),
                ("fcc", ["--near-k", "5"],
                 lambda q: FCCLatticeBox(q, seed=42))):
            argv = fam + extra + ["--scene-family", family,
                                  "--out", os.path.join(tmp, "f.csv")]
            got, _, wall = run_cli(argv)
            ap = sim.build_parser()
            q = sim.params_from_args(ap, ap.parse_args(argv))
            n_mnp = len(box(q).populate().mnps)
            entry = "rebuild entry (chunk_kernel)" \
                if n_mnp <= cuda_engine.REBUILD_MAX_MNPS \
                else "near entry (chunk_near_kernel)"
            check(sum(got.values()) == 200, f"{family}: launches {got}")
            rows = read_t2_csv(os.path.join(tmp, "f.csv"))
            check(len(rows[0]) == 200 and bool(np.isfinite(rows[1]).all()),
                  f"{family}: CSV")
            print(f"  --scene-family {family}: {n_mnp} dipoles -> the "
                  f"{entry}; 2e5 steps x 4032 walkers, 0 escapes, 0 "
                  f"violations, {wall:.3f} s, launches {launched(got)}",
                  flush=True)
    done(t0, f"[{label}]")

    t0 = phase("18 (f) the cost of a checkpoint")
    with tempfile.TemporaryDirectory() as tmp:
        for name, runner in (
                ("4032 walkers", SimulationRunner(hp, scene=scene, seed=7,
                                                  device="cuda")),
                (f"{ctx['p'].num_water} walkers", ctx["runner"])):
            path = os.path.join(tmp, "c.npz")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            runner._save_checkpoint(path)
            save_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            runner.resume(path)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t1
            print(f"  {name}: save {save_s:.4f} s, resume {resume_s:.4f} s "
                  f"({os.path.getsize(path)} bytes) [{label}]", flush=True)
    done(t0, f"[{label}]")


def ensemble_rate(n_trials, p, steps, wall):
    """Walker-steps/s of ``n_trials`` trials of ``steps`` steps."""
    return n_trials * steps * p.num_water / wall


def trial_setup(p, n, base_seed, d_scale=1.0, run_cell_r=0.0):
    """(scenes s, near-k certificates s) of an ensemble's set-up, timed
    ahead of it: its scenes built, then each scene's certificate at the
    trials' reach (cached on disk, so the ensemble's own check then
    finds them)."""
    t0 = time.perf_counter()
    _, _, _, scenes = ens.build_trial_scenes(p, n, base_seed)
    t1 = time.perf_counter()
    q = p.scale_D(max(d_scale, 1.0)).replace(cell_r=run_cell_r or p.cell_r)
    for sc in scenes:
        expansion.validate_near_k(sc.mnps[:, :3], q)
    return t1 - t0, time.perf_counter() - t1


def check_trial(st, i, alone, what, bitwise=True):
    """Trial ``i`` of an ensemble's state ``st`` against ``alone``, a
    standalone run's WalkerState: bitwise, or within POS_TOL; escapes
    and coverage 0 in both.  Returns the position error."""
    err = float((st.pos[i] - alone.pos).abs().max())
    same = all(torch.equal(getattr(st, f)[i], getattr(alone, f))
               for f in ("pos", "in_cell", "phase", "phase_comp"))
    check(int(st.escapes[i]) == int(alone.escapes) == 0
          and int(st.coverage[i]) == int(alone.coverage) == 0,
          f"{what}: escapes {int(st.escapes[i])}/{int(alone.escapes)}, "
          f"coverage {int(st.coverage[i])}/{int(alone.coverage)}")
    check(same if bitwise else err < POS_TOL,
          f"{what}: state {'not bitwise equal' if bitwise else err}")
    return err, same


def cli_process(argv, log):
    """(launches, sprint functions built, stderr text, wall s) of the
    port CLI with ``argv`` run as a process of its own that reports its
    kernel launches and sprint functions on its last line; it must exit
    0."""
    code = (
        "import json, sys\n"
        "from mri_nanoparticle_simulation_tpu_torch.engine import "
        "chunk_kernel, cuda_engine, sim\n"
        "made = []\n"
        "orig = cuda_engine.make_sprint_fn\n"
        "def counted(*a, **k):\n"
        "    made.append(1)\n"
        "    return orig(*a, **k)\n"
        "cuda_engine.make_sprint_fn = counted\n"
        "rc = sim.main(sys.argv[1:])\n"
        "print(json.dumps([chunk_kernel.LAUNCHES, len(made)]))\n"
        "sys.exit(rc)\n")
    t0 = time.perf_counter()
    with open(log, "w") as err:
        out = subprocess.run([sys.executable, "-c", code, *argv], cwd=ROOT,
                             stdout=subprocess.PIPE, stderr=err, text=True,
                             timeout=600)
    wall = time.perf_counter() - t0
    with open(log) as fh:
        text = fh.read()
    check(out.returncode == 0,
          f"CLI process exit {out.returncode}:\n{text[-2000:]}")
    got, made = json.loads(out.stdout.strip().splitlines()[-1])
    return got, made, text, wall


def ensembles(ctx, keep, label):
    """Phase 19: ensembles and sweeps at full width.  (a) the headline
    ensemble on Threefry, each trial bitwise its standalone run, then
    per-trial knobs against static-parameter runs and a P sweep; (b) a
    large-scene ensemble (near entry and far sums); (c) the golden T2
    arms; (d) the CLI's sweeps, grid and ensemble as processes."""
    t0 = phase("19 (a) headline ensemble on Threefry, 4 x 4032 walkers")
    p = Params(**ENSEMBLE).validate()
    steps = 200_000
    scenes_s, certs_s = trial_setup(p, 4, 42)
    reset_launches()
    t1 = time.perf_counter()
    _, cos, sin, st = ens.run_ensemble(p, 4, base_seed=42, run_seed=7,
                                       rng_impl="threefry", max_steps=steps,
                                       device="cuda")
    wall = time.perf_counter() - t1
    got = launches()
    check(got == only(chunk_kernel=4 * 50),
          f"kernel launches {got}, expected 4 x 50 chunk_kernel")
    lay4032 = chunk_kernel.LAYOUTS["chunk_kernel"]
    rate4032 = ensemble_rate(4, p, steps, wall)
    check(cos.shape == (4, 200) and bool(np.isfinite(cos).all()),
          f"window sums {cos.shape}")
    counts = []
    for i in range(4):
        sc = BacteriaBox(p, seed=42 + i).populate()
        counts.append(len(sc.mnps))
        _, c1, s1, alone = cuda_engine.run_simulation(
            sc, p, seed=7 + i, device="cuda", rng_impl="threefry",
            max_steps=steps)
        check(np.array_equal(cos[i], c1) and np.array_equal(sin[i], s1),
              f"trial {i}: window sums differ from its standalone run")
        check_trial(st, i, alone, f"trial {i}")
    print(f"  4 trials ({counts} dipoles) bitwise their standalone runs "
          f"(positions, phases, windows, escapes, coverage); launches "
          f"{launched(got)}; {rate4032:.4e} walker-steps/s (wall "
          f"{wall:.3f} s; set-up before it: scenes {scenes_s:.3f} s, "
          f"near-k certificates {certs_s:.3f} s), phase 4's single run "
          f"{keep['t4_rate']:.4e}; layout {lay4032} [{label}]", flush=True)

    # one knob a trial, the others at their static values
    knobs = dict(taucps=[0.05, p.taucp, p.taucp, p.taucp],
                 run_cell_rs=[p.cell_r, 0.6, p.cell_r, p.cell_r],
                 d_scales=[1.0, 1.0, 0.25, 1.0],
                 mmoments=[p.mmoment, p.mmoment, p.mmoment, 2 * p.mmoment])
    statics = [p.replace(taucp=0.05), p.replace(cell_r=0.6), p.scale_D(0.25),
               p.replace(mmoment=2 * p.mmoment)]
    names = ("taucp 0.05 ms", "run cell_r 0.6", "d_scale 0.25",
             "mmoment x2")
    _, kcos, _, kst = ens.run_ensemble(p, 4, base_seed=42, run_seed=7,
                                       rng_impl="threefry", max_steps=steps,
                                       device="cuda", **knobs)
    for i, (q, what) in enumerate(zip(statics, names)):
        q = q.validate()
        # the static run on the trial's scene: geometry at p's radius,
        # the moment of q
        sc = BacteriaBox(p if i < 3 else q, seed=42 + i).populate()
        _, c1, _, alone = cuda_engine.run_simulation(
            sc, q, seed=7 + i, device="cuda", rng_impl="threefry",
            max_steps=steps)
        bitwise = i < 2
        err, same = check_trial(kst, i, alone, what, bitwise=bitwise)
        werr = float(np.abs(kcos[i] - c1).max())
        check(werr < WIN_TOL if not bitwise
              else np.array_equal(kcos[i], c1),
              f"{what}: window sums differ by {werr}")
        print(f"  {what}: against the static-parameter run |pos| err "
              f"{err:.3e}, |wins| err {werr:.3e} (gate "
              f"{'bitwise' if bitwise else f'{POS_TOL} / {WIN_TOL}'}; "
              f"{'bitwise equal' if same else 'not bitwise equal'})",
              flush=True)

    # the permeability axis: reflection on, only the variants mode
    pp = p.with_permeability()
    bound_p = 1.0 / (np.sqrt(p.tau / (6.0 * p.D_cell)) * 4.0)
    pvals = [0.2 * bound_p, 0.8 * bound_p]
    reset_launches()
    _, pcurves = ens.run_parameter_sweep(pp, "P", pvals, base_seed=42,
                                         run_seed=7, rng_impl="threefry",
                                         max_steps=steps, device="cuda")
    got = launches()
    check(got == only(**{"chunk_kernel[variants]": 2 * 50}),
          f"P sweep launches {got}")
    sc = BacteriaBox(p, seed=42).populate()
    for i, v in enumerate(pvals):
        sc_i = sc if i == 0 else BacteriaBox(p, seed=43).populate()
        _, c1, _, alone = cuda_engine.run_simulation(
            sc_i, p.with_permeability(v), seed=7 + i, device="cuda",
            rng_impl="threefry", max_steps=steps)
        werr = float(np.abs(pcurves[i, 0] - c1).max())
        check(werr < WIN_TOL, f"P {v}: window sums differ by {werr}")
        print(f"  P {v:.4f} um/ms: |wins| err {werr:.3e} against the "
              f"static-parameter run (gate {WIN_TOL}; "
              f"{'bitwise equal' if werr == 0 else 'not bitwise equal'})",
              flush=True)
    done(t0, f"launches {launched(got)} in the P sweep [{label}]")

    t0 = phase("19 (b) large-scene ensemble: 2 scale-up trials, Threefry")
    q = ctx["p"]
    counts = [len(ctx["runner"].scene.mnps), 0]
    seed2 = 42
    while counts[1] in (0, counts[0]):   # a second count, so one is padded
        seed2 += 1
        sc2 = BacteriaBox(q, seed=seed2).populate()
        counts[1] = len(sc2.mnps)
    seeds = [42, seed2]
    tbl2 = mnp_table(sc2.mnps, torch.float32, "cuda")
    cache_s = []
    for _ in range(2):                   # the first build, then another
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        expansion.build_cache(tbl2.pos, tbl2.m, q, far_table=False)
        torch.cuda.synchronize()
        cache_s.append(time.perf_counter() - t1)
    reset_launches()
    t1 = time.perf_counter()
    _, bcos, _, bst = ens.run_ensemble(
        q, 2, base_seed=42, run_seed=7, scene_seeds=seeds,
        rng_impl="threefry", max_steps=q.sprint_steps, device="cuda")
    wall = time.perf_counter() - t1
    got = launches()
    n_chunks = q.sprint_steps // q.chunk_steps
    check(got == only(chunk_near_kernel=2 * n_chunks,
                      far_sums_kernel=2 * n_chunks,
                      cube_select_kernel=2 * n_chunks),
          f"kernel launches {got}: expected only chunk_near_kernel, "
          f"far_sums_kernel and cube_select_kernel, {2 * n_chunks} each")
    check(bst.escapes.tolist() == [0, 0] and bst.coverage.tolist() == [0, 0],
          f"escapes {bst.escapes.tolist()}, coverage "
          f"{bst.coverage.tolist()}")
    sprint = cuda_engine.make_sprint_fn(q, q.num_water, "cuda",
                                        rng_impl="threefry")
    ss = cuda_engine.to_soa(init_state(sc2.waters, q, "cuda"), q)
    ss, wins = sprint(tbl2, key_words(8), ss, cache=None)
    alone = cuda_engine.from_soa(ss, q.num_water)
    perr = float((bst.pos[1] - alone.pos).abs().max())
    werr = float(np.abs(bcos[1] - wins[:, 0].cpu().numpy()).max())
    check(perr < POS_TOL and werr < WIN_TOL,
          f"trial 1 vs its standalone sprint: |pos| {perr}, |wins| {werr}")
    done(t0, f"scene seeds {seeds} ({counts} dipoles, the tables padded "
         f"to {max(counts)}); one sprint of {q.sprint_steps} steps a trial: "
         f"launches {launched(got)}, 0 escapes, 0 violations, "
         f"{ensemble_rate(2, q, q.sprint_steps, wall):.4e} walker-steps/s "
         f"(wall {wall:.3f} s; the cube cache, rebuilt in each sprint "
         f"call, {cache_s[0]:.4f} s a first build, {cache_s[1]:.4f} s "
         f"another); trial 1 against its standalone "
         f"sprint: |pos| {perr:.3e} (tol {POS_TOL}), |wins| {werr:.3e} "
         f"(tol {WIN_TOL}) [{label}]")

    t0 = phase("19 (c) golden T2 arms through golden.run_t2_arm")
    tp = golden.t2_arm_params()
    for stem, n, d, cr, gen in (
            ("GOLDEN_T2", 16, 1.0, 0.0, "threefry"),
            ("GOLDEN_T2_D", 10, 0.5, 0.0, "threefry"),
            ("GOLDEN_T2_r0.8", 6, 1.0, 0.8, "threefry"),
            ("GOLDEN_T2", 16, 1.0, 0.0, "hardware")):
        scenes_s, certs_s = trial_setup(tp, n, golden.T2_BASE_SEED, d, cr)
        reset_launches()
        t1 = time.perf_counter()
        curves = golden.run_t2_arm(n, d, cr, "cuda", gen)
        wall = time.perf_counter() - t1
        got = launches()
        key = "chunk_kernel[fast]" if gen == "hardware" else "chunk_kernel"
        check(got == only(**{key: n * golden.T2_STEPS // tp.chunk_steps}),
              f"{stem}: launches {got}")
        check(curves.shape == (n, golden.T2_STEPS // golden.T2_PFREQ)
              and bool(np.isfinite(curves).all()), f"{stem}: curves")
        r = golden.t2_arm_gate(os.path.join(ROOT, stem + ".json"), curves)
        lay = chunk_kernel.LAYOUTS["chunk_kernel"]
        print(f"  {stem} ({n} trials, d_scale {d}, run cell_r "
              f"{cr or tp.cell_r}, {gen}): port final {r['mean']:.5f} +- "
              f"{r['stderr']:.5f}, oracle {r['oracle_mean']:.5f} +- "
              f"{r['oracle_stderr']:.5f}, JAX arm {r['jax_mean']:.5f}; "
              f"z_final {r['z_final']:+.3f} (gate {golden.T2_Z_GATE}); "
              f"{ensemble_rate(n, tp, golden.T2_STEPS, wall):.4e} "
              f"walker-steps/s at 1024 walkers a trial (wall {wall:.3f} s; "
              f"set-up before it: scenes {scenes_s:.3f} s, certificates "
              f"{certs_s:.3f} s); layout {lay} [{label}]", flush=True)
        check(abs(r["z_final"]) <= golden.T2_Z_GATE,
              f"{stem} {gen}: z_final {r['z_final']}")
    done(t0, f"4 arms within |z| {golden.T2_Z_GATE} [{label}]")

    t0 = phase("19 (d) the CLI's sweeps, grid and ensemble as processes")
    cli = ["--num-water", "4032", "--num-cells", "270", "--chunk-steps",
           "4000", "--near-k", "10", "--scene-seed", "42", "--seed", "7",
           "--device", "cuda"]
    long = cli + ["--totaltime", "2", "--taucp", "0.25"]
    with tempfile.TemporaryDirectory() as tmp:
        def out(name):
            d = os.path.join(tmp, name)
            os.makedirs(d)
            return d

        d = out("sweep")
        fit = os.path.join(d, "fit.csv")
        got, made, _, w = cli_process(
            long + ["--sweep", "D", "--sweep-values", "0.5,1,2",
                    "--trials-per-value", "2", "--fit-t2", fit, "--out",
                    os.path.join(d, "t2.csv")], os.path.join(tmp, "s.log"))
        for v in ("0.5", "1", "2"):
            rows = read_t2_csv(os.path.join(d, f"t2_D={v}.csv"))
            check(len(rows[0]) == 2000 and bool(np.isfinite(rows[1]).all()),
                  f"D={v}: CSV")
        with open(fit) as fh:
            table = fh.read().splitlines()
        t2s = [float(r.split(",")[2]) for r in table[1:]]
        check(len(table) == 4 and all(np.isfinite(t2s)),
              f"dispersion table {table}")
        check(launched(got) == {"chunk_kernel[fast]": 6 * 500} and made == 1,
              f"--sweep D: launches {launched(got)}, {made} sprint functions")
        print(f"  --sweep D 0.5,1,2 x 2 trials: 3 CSVs x 2000 rows, T2 "
              f"{t2s} ms; launches {launched(got)}, {made} sprint "
              f"function; process {w:.3f} s", flush=True)

        d = out("grid")
        grid = ["--sweep-grid", "D=0.5,1;taucp=0.25,0.5", "--paired",
                "--trials-per-value", "2", "--quadrature"]
        got, made, _, w = cli_process(
            long + grid + ["--out", os.path.join(d, "t2.csv")],
            os.path.join(tmp, "g.log"))
        check(launched(got) == {"chunk_kernel[fast]": 8 * 500} and made == 1,
              f"--sweep-grid: launches {launched(got)}")
        ap = sim.build_parser()
        args = ap.parse_args(long + grid + ["--out", "x"])
        gp = sim.params_from_args(ap, args)
        axes = {"D": [0.5, 1.0], "taucp": [0.25, 0.5]}
        t1 = time.perf_counter()
        times, curves = ens.run_parameter_grid(
            gp, axes, n_trials_each=2, base_seed=42, run_seed=1007,
            rng_impl="hardware", paired=True, quadrature=True,
            device="cuda")
        grid_wall = time.perf_counter() - t1
        di = out("grid_in_process")
        sim._emit_sweep_outputs(
            os.path.join(di, "t2.csv"), times, ["D", "taucp"],
            [(a, b) for a in axes["D"] for b in axes["taucp"]],
            curves.reshape((-1, 2) + curves.shape[3:]),
            lambda c: ens.sweep_params_for(
                ens.sweep_params_for(gp, "D", c[0]), "taucp", c[1]),
            None, quadrature=True)
        names = sorted(os.listdir(d))
        check(names == sorted(os.listdir(di)) and len(names) == 4,
              f"grid CSVs {names}")
        for n in names:
            with open(os.path.join(d, n), "rb") as a, \
                    open(os.path.join(di, n), "rb") as b:
                check(a.read() == b.read(), f"{n}: not bytewise equal")
        print(f"  --sweep-grid D x taucp, paired, 2 trials: 4 CSVs bytewise "
              f"the in-process grid's ({grid_wall:.3f} s in process, "
              f"{ensemble_rate(8, gp, gp.t, grid_wall):.4e} walker-steps/s); "
              f"launches {launched(got)}; process {w:.3f} s", flush=True)

        d = out("ensemble")
        got, made, _, w = cli_process(
            long + ["--ensemble", "4", "--out", os.path.join(d, "t2.csv")],
            os.path.join(tmp, "e.log"))
        check(launched(got) == {"chunk_kernel[fast]": 4 * 500},
              f"--ensemble: launches {launched(got)}")
        _, ecos, esin, _ = ens.run_ensemble(
            gp, 4, base_seed=42, run_seed=1007, rng_impl="hardware",
            device="cuda")
        di = out("ensemble_in_process")
        with T2CsvWriter(os.path.join(di, "t2.csv"), gp) as wr:
            wr.append_windows(0, np.stack([ecos.mean(0), esin.mean(0)], -1))
        with open(os.path.join(d, "t2.csv"), "rb") as a, \
                open(os.path.join(di, "t2.csv"), "rb") as b:
            check(a.read() == b.read(), "--ensemble CSV not bytewise the "
                  "in-process mean")
        print(f"  --ensemble 4: CSV bytewise the in-process mean; launches "
              f"{launched(got)}; process {w:.3f} s", flush=True)

        short = cli + ["--totaltime", "0.2"]
        trace = os.path.join(tmp, "trace")
        for knob, vals, want, extra in (
                ("Gz", "0,3e-5", {"chunk_kernel[fast]": 50,
                                  "chunk_kernel[fast+variants]": 50},
                 ["--trace", trace]),
                ("num_cells", "200,270", {"chunk_kernel[fast]": 100}, [])):
            d = out(knob)
            got, made, text, w = cli_process(
                short + ["--sweep", knob, "--sweep-values", vals, "--out",
                         os.path.join(d, "t2.csv")] + extra,
                os.path.join(tmp, f"{knob}.log"))
            check(launched(got) == want and made == 2,
                  f"--sweep {knob}: launches {launched(got)}, {made} sprint "
                  f"functions")
            check(len(os.listdir(d)) == 2, f"--sweep {knob}: CSVs")
            note = ""
            if extra:
                path = os.path.join(trace, profiling.TRACE_FILE)
                kernels = profiling.trace_kernels(path)
                check(any("chunk" in k for k in kernels),
                      f"the trace names no chunk kernel: {kernels[:5]}")
                note = (f"; --trace: {os.path.getsize(path)} B, "
                        f"{len(kernels)} kernel events, e.g. "
                        f"{sorted(set(kernels))[:2]}")
            print(f"  --sweep {knob} {vals}, 2e5 steps: launches "
                  f"{launched(got)}, {made} sprint functions; process "
                  f"{w:.3f} s{note}", flush=True)
    done(t0, f"[{label}]")


#: phase 20: the moment of the CRN fits (100x the headline's: a curve
#: the scales shape within 2e5 steps) and of the AD phase (1000x: its
#: 2e3 steps' curve must move in float32 under a 1% change of scale)
FIT_MOMENT = 3.5e-15
AD_MOMENT = 3.5e-14
#: phase 20: steps of the scan engine's headline sprint, and of its
#: exact and grid runs
SCAN_STEPS = 20_000
ORACLE_STEPS = 2_000


def curve_gate(a, b, w):
    """Max |a - b| of two Σcos curves over W, and the 5 sqrt(2/W) gate of
    two independent W-walker means (tests/test_pallas.py:113-130)."""
    return float(np.abs((a - b) / w).max()), 5.0 * np.sqrt(2.0 / w)


def scan_run(p, scene, steps, **kw):
    """(runner, cos, sin, stats) of ``steps`` steps of the scan engine on
    ``scene``, seed 7; no chunk kernel may launch."""
    reset_launches()
    run = SimulationRunner(p, scene=scene, seed=7, device="cuda",
                           engine="scan", **kw)
    _, cos, sin, st = run.run(progress=False, max_steps=steps)
    check(launched(launches()) == {}, f"the scan engine launched "
          f"{launched(launches())}")
    check(st["escapes"] == 0 and st["coverage_violations"] == 0,
          f"scan run: escapes {st['escapes']}, coverage "
          f"{st['coverage_violations']}")
    check(bool(np.isfinite(cos).all()), "non-finite scan curve")
    return run, cos, sin, st


def start_process(module, argv, log):
    """A port CLI (``module``, run with -m) as a process of its own with
    its stderr in ``log``; returns (Popen, log, start time)."""
    err = open(log, "w")
    proc = subprocess.Popen([sys.executable, "-m", module, *argv], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=err, text=True)
    err.close()
    return proc, log, time.perf_counter()


def finish_process(started, timeout=600):
    """(exit code, stdout, stderr, wall s) of a ``start_process``
    process."""
    proc, log, t0 = started
    out, _ = proc.communicate(timeout=timeout)
    wall = time.perf_counter() - t0
    with open(log) as fh:
        return proc.returncode, out, fh.read(), wall


def scan_and_inverse(keep, label):
    """Phase 20: the scan engine (eager torch) against the chunk kernel
    at full width, its window-major order and its exact and grid field
    modes; the decomposition on it; autograd through it and the AD fits;
    the CRN fits on the chunk kernels; the CLIs as processes."""
    scene = keep["scene"]
    t0 = phase("20 (a) the scan engine against the chunk kernel, headline")
    p = Params(**HEADLINE).validate()
    w = p.num_water
    check(p.sprint_steps == SCAN_STEPS, f"sprint of {p.sprint_steps}")
    reset_launches()
    kr = SimulationRunner(p, scene=scene, seed=7, device="cuda",
                          rng_impl="threefry")
    _, kcos, ksin, kst = kr.run(progress=False, max_steps=SCAN_STEPS)
    check(launches() == only(chunk_kernel=5), f"kernel run {launches()}")
    sr, scos, ssin, sst = scan_run(p, scene, SCAN_STEPS)
    pos_err = float((sr.state.pos - kr.state.pos).abs().max())
    win_err = float(max(np.abs(scos - kcos).max(),
                        np.abs(ssin - ksin).max()))
    incell = int((sr.state.in_cell != kr.state.in_cell).sum())
    print(f"  2e4 steps: |pos| err {pos_err:.3e} (tol {POS_TOL}), |wins| "
          f"err {win_err:.3e} (tol {WIN_TOL}), in-cell flags differing "
          f"{incell}, escapes {sst['escapes']}/{kst['escapes']}, coverage "
          f"{sst['coverage_violations']}/{kst['coverage_violations']}; "
          f"scan {sst['walker_steps_per_s']:.4e} walker-steps/s (wall "
          f"{sst['wall_s']:.2f} s), chunk kernel "
          f"{kst['walker_steps_per_s']:.4e}", flush=True)
    check(pos_err < POS_TOL, f"scan positions differ by {pos_err}")
    check(win_err < WIN_TOL, f"scan window sums differ by {win_err}")
    check(sst["escapes"] == kst["escapes"]
          and sst["coverage_violations"] == kst["coverage_violations"],
          "escapes or coverage differ")
    rates = {"expansion": sst["walker_steps_per_s"]}

    # the window-major order: two 500-step chunks a window
    pw = Params(**{**HEADLINE, "chunk_steps": 500,
                   "sprint_steps": 4000}).validate()
    _, wcos, _, wst = scan_run(pw, scene, 4000)
    wm_err, gate = curve_gate(wcos, kcos[:len(wcos)], w)
    print(f"  window-major (chunk 500), 4e3 steps: max |d Σcos/W| "
          f"{wm_err:.3e} against the chunk kernel (gate {gate:.4f}); "
          f"{wst['walker_steps_per_s']:.4e} walker-steps/s", flush=True)
    check(wm_err < gate, f"window-major curve off by {wm_err}")
    rates["window-major"] = wst["walker_steps_per_s"]

    oracle = {**HEADLINE, "chunk_steps": 1000, "sprint_steps": ORACLE_STEPS}
    pe_ = Params(**oracle, field_mode="exact").validate()
    er, ecos, _, est = scan_run(pe_, scene, ORACLE_STEPS)
    t_grid = time.perf_counter()
    pg = Params(**oracle, field_mode="grid", grid_n=64).validate()
    reset_launches()
    gr = SimulationRunner(pg, scene=scene, seed=7, device="cuda",
                          engine="scan")
    torch.cuda.synchronize()
    grid_build_s = time.perf_counter() - t_grid
    _, gcos, _, gst = gr.run(progress=False, max_steps=ORACLE_STEPS)
    check(launched(launches()) == {}, "the grid run launched a kernel")
    check(bool(np.isfinite(gcos).all()), "non-finite grid curve")
    grid_err, gate = curve_gate(gcos, ecos, w)
    # field and residency of the grid against exact at the walkers
    pos = reference_engine.wrap(er.state.pos, float(p.bound))
    mnp_pos, mnp_M = er.mnp_tbl.pos, er.mnp_tbl.m
    cr = torch.tensor(p.cell_r, device=pos.device)
    b_grid, in_grid = grid_mod.query(gr.field_grid, pos, cr)
    d = pos[:, None, :] - mnp_pos
    in_exact = torch.any(torch.sum(d * d, -1) < cr * cr, -1)
    b_exact = dipole.total_field_masked(pos.double(), mnp_pos.double(),
                                        mnp_M.double(), p.cell_r)
    ferr = (b_grid.double() - b_exact).abs()
    print(f"  exact 2e3 steps: {est['walker_steps_per_s']:.4e} "
          f"walker-steps/s; grid (G 64, built in {grid_build_s:.2f} s) "
          f"2e3 steps: {gst['walker_steps_per_s']:.4e} walker-steps/s, "
          f"curve max |d Σcos/W| {grid_err:.3e} against exact (gate "
          f"{gate:.4f}); at the {w} walkers: residency differing "
          f"{int((in_grid != in_exact).sum())} ({int(in_exact.sum())} in "
          f"cells), field error against the f64 exact sum max "
          f"{float(ferr.max()):.3e} T, mean {float(ferr.mean()):.3e} T "
          f"(tests/test_grid.py bounds 5e-6 / 2e-7 on its scene)",
          flush=True)
    check(torch.equal(in_grid, in_exact), "grid residency differs from "
          "exact's")
    check(grid_err < gate, f"grid curve off exact's by {grid_err}")
    rates.update(exact=est["walker_steps_per_s"],
                 grid=gst["walker_steps_per_s"])
    done(t0, "walker-steps/s: " + ", ".join(
        f"{k} {v:.4e}" for k, v in rates.items())
        + f"; phase 4's chunk kernel {keep['t4_rate']:.4e} "
        f"({keep['t4_rate'] / rates['expansion']:.0f}x the scan "
        f"engine's expansion mode) [{label}]")

    t0 = phase("20 (b) the decomposition on the scan engine")
    pd = Params(**{**HEADLINE, "sprint_steps": 4000}).validate()
    reset_launches()
    kd = dec.run_decomposition(scene, pd, seed=7, device="cuda",
                               rng_impl="threefry", max_steps=4000)
    check(launches() == only(**{"chunk_kernel[dec]": 1}),
          f"kernel decompose launches {launches()}")
    reset_launches()
    sd = dec.run_decomposition(scene, pd, seed=7, device="cuda",
                               engine="scan", max_steps=4000)
    check(launched(launches()) == {}, "the scan decomposition launched "
          "a kernel")
    ab_err = max(float(np.abs(sd.A - kd.A).max()),
                 float(np.abs(sd.B - kd.B).max()))
    check(sd.A.shape == kd.A.shape == (4, w), f"record {sd.A.shape}")
    check(ab_err < DEC_TOL, f"scan record differs by {ab_err}")
    done(t0, f"one sprint (4000 steps): A and B within {ab_err:.3e} of "
         f"the chunk kernel's record (tol {DEC_TOL}); scan device "
         f"{sd.stats['device_s']:.2f} s [{label}]")

    t0 = phase("20 (c) autograd through the scan engine, headline")
    pa = Params(**{**HEADLINE, "chunk_steps": 1000}, mmoment=AD_MOMENT,
                totaltime=0.002, sprint_steps=1000).validate()
    ad_scene = golden.scale_moments(scene, AD_MOMENT / p.mmoment)
    # the moment leaves the trajectories alone: float32 and a difference
    # of 1% (tests/test_differentiable.py).  The diffusion scale moves
    # every step, and a walker whose membrane crossing a finite step
    # turns over jumps the curve (the pathwise derivative leaves those
    # out; among 4032 walkers a 1% step turns over dozens): float64 and a
    # step of 1e-7, where such a walker is unlikely
    for axis, make, x0, dtype, eps in (
            ("moment", inverse.make_curve_fn, 1.0, torch.float32, 1e-2),
            ("D", inverse.make_diffusion_curve_fn, 0.7, torch.float64,
             1e-7)):
        # one sprint: the gradient's check needs no second
        curve = make(pa.replace(totaltime=0.001), ad_scene, seed=7,
                     device="cuda", dtype=dtype)
        x = torch.tensor(x0, dtype=dtype, device="cuda", requires_grad=True)
        torch.cuda.reset_peak_memory_stats()
        tg = time.perf_counter()
        curve(x)[-1].backward()
        g = float(x.grad)
        grad_s = time.perf_counter() - tg
        peak = torch.cuda.max_memory_allocated() / 2**30
        with torch.no_grad():
            fd = (float(curve(x0 + eps)[-1])
                  - float(curve(x0 - eps)[-1])) / (2 * eps)
        print(f"  d(final Σcos/W)/d({axis} scale) at {x0}, {dtype}: "
              f"autograd {g:.6e}, central difference {fd:.6e} (step "
              f"{eps:g}; rtol 2e-2); {grad_s:.2f} s, peak {peak:.3f} GiB",
              flush=True)
        check(np.isfinite(g) and abs(g - fd) <= 2e-2 * abs(fd),
              f"{axis} gradient {g} against {fd}")
    # D from below: at this width and depth the loss against d = 0.6
    # falls monotonically from 0.4, not from 1.0 (a bump near 0.8)
    fits = {}
    for axis, make, fit, hidden, init in (
            ("moment", inverse.make_curve_fn, inverse.fit_moment_scale, 1.4,
             1.0),
            ("D", inverse.make_diffusion_curve_fn,
             inverse.fit_diffusion_scale, 0.6, 0.4)):
        with torch.no_grad():
            target = make(pa, ad_scene, seed=7, device="cuda")(hidden)
        torch.cuda.reset_peak_memory_stats()
        tf = time.perf_counter()
        res = fit(target.cpu().numpy(), pa, ad_scene, seed=7,
                  init_scale=init, iters=3, lr=0.05, device="cuda")
        fits[axis] = (time.perf_counter() - tf) / 3
        hist = np.asarray(res.scale_history)
        print(f"  fit {axis}: scales {' '.join(f'{v:.5f}' for v in hist)} "
              f"(from {init} toward {hidden}), losses "
              f"{' '.join(f'{v:.4e}' for v in res.loss_history)}; "
              f"{fits[axis]:.2f} s an iteration, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
              flush=True)
        check(bool(np.isfinite(hist).all() and np.isfinite(
            res.loss_history).all()), f"{axis} fit: NaN")
        toward = np.sign(hidden - init)
        check(bool(np.all(np.diff(np.concatenate([[init], hist])) * toward
                          > 0)), f"{axis} fit did not move toward {hidden}")
    done(t0, f"2e3 steps x 4032 walkers in sprints of 1000; seconds an "
         f"Adam iteration: moment {fits['moment']:.2f}, D {fits['D']:.2f} "
         f"[{label}]")

    t0 = phase("20 (d) CRN fits on the chunk kernels")
    worst = expansion.validate_near_k(scene.mnps[:, :3],
                                      Params(**ENSEMBLE).replace(cell_r=1.0))
    pc = Params(**{**ENSEMBLE, "near_k": max(ENSEMBLE["near_k"], worst)},
                mmoment=FIT_MOMENT, totaltime=0.2,
                sprint_steps=100_000).validate()
    # the radius and the permeability act only where a walker meets a
    # membrane: 2e6 steps, so that enough of them do (at 2e5 the loss in
    # cell_r is flat over wide stretches and the search strays)
    pm = pc.replace(totaltime=2.0)
    pp = pm.with_permeability()
    crn_scene = golden.scale_moments(scene, FIT_MOMENT / p.mmoment)
    curve = inverse.make_engine_curve_fn(pc, crn_scene, seed=7, device="cuda")
    mcurve = inverse.make_engine_curve_fn(pm, crn_scene, seed=7,
                                          device="cuda")
    pcurve = inverse.make_engine_curve_fn(pp, crn_scene, seed=7, device="cuda")
    cases = (
        ("D", 0.6, "chunk_kernel", lambda: inverse.fit_diffusion_scale_crn(
            curve(0.6), pc, crn_scene, seed=7, bracket=(0.1, 1.0), iters=20,
            device="cuda")),
        ("cell_r", 0.6, "chunk_kernel", lambda: inverse.fit_cell_radius_crn(
            mcurve(cell_r=0.6), pm, crn_scene, seed=7, bracket=(0.3, 1.0),
            iters=20, device="cuda")),
        ("P", 5.0, "chunk_kernel[variants]",
         lambda: inverse.fit_permeability_crn(
             pcurve(p_expr=5.0), pp, crn_scene, seed=7, bracket=(0.5, 50.0),
             iters=20, device="cuda")),
        ("joint", (1.4, 0.6), "chunk_kernel", lambda: inverse.fit_joint_crn(
            curve(0.6, m_scale=1.4), pc, crn_scene, seed=7, max_evals=70,
            device="cuda")))
    for axis, hidden, mode, run_fit in cases:
        reset_launches()
        tf = time.perf_counter()
        res = run_fit()
        wall = time.perf_counter() - tf
        got = launched(launches())
        n_eval = len(res.loss_history)
        check(set(got) == {mode}, f"{axis} fit launched {got}")
        if axis == "joint":
            err = max(abs(res.m_scale - 1.4) / 1.4,
                      abs(res.d_scale - 0.6) / 0.6)
            found = f"({res.m_scale:.5f}, {res.d_scale:.5f})"
        else:
            err = abs(res.scale - hidden) / hidden
            found = f"{res.scale:.5f}"
        print(f"  {axis}: {found} against {hidden}, rel err {err:.2e} "
              f"(gate 0.05); {n_eval} evaluations ({n_eval + 1} with the "
              f"target), {wall:.2f} s; launches {got}", flush=True)
        check(err < 0.05, f"{axis} CRN fit off by {err}")
    done(t0, f"4032 walkers, K {pc.near_k}; an evaluation 2e5 steps (D, "
         f"joint) or 2e6 (cell_r, P) [{label}]")

    t0 = phase("20 (e) the CLIs as processes")
    procs = {}
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "rec.npz")
        np.savez(rec, A=keep["5c"]["A"], B=keep["5c"]["B"],
                 times_ms=keep["5c"]["times_ms"],
                 mmoment=keep["5c"]["mmoment"])
        target = os.path.join(tmp, "target.csv")
        with open(target, "w") as fh:
            fh.write(keep["5c"]["csvs"]["t2_mscale=2_taucp=0.25.csv"])
        scan_csv = os.path.join(tmp, "scan.csv")
        inv = "mri_nanoparticle_simulation_tpu_torch.inverse"
        base = ["--num-water", "4032", "--device", "cuda"]
        runs = {
            "sim --engine scan": (
                "mri_nanoparticle_simulation_tpu_torch.engine.sim",
                ["--num-water", "4032", "--num-cells", "270", "--totaltime",
                 "0.01", "--chunk-steps", "500", "--near-k", "5",
                 "--scene-seed", "42", "--seed", "7", "--engine", "scan",
                 "--device", "cuda", "--out", scan_csv]),
            "decompose": (inv, base + ["--method", "decompose", "--iters",
                                       "150"]),
            "crn D": (inv, base + ["--axis", "D", "--method", "crn",
                                   "--true-scale", "0.6", "--iters",
                                   "20"]),
            "crn cell_r": (inv, base + ["--axis", "cell_r", "--method",
                                        "crn", "--true-scale", "0.7",
                                        "--iters", "20"]),
            "crn joint": (inv, base + ["--axis", "joint", "--method", "crn",
                                       "--true-scale", "1.5", "--iters",
                                       "70"]),
            "record": (inv, ["--record", rec, "--target", target, "--iters",
                             "150", "--lr", "0.1", "--device", "cuda"]),
            "ad moment": (inv, base + ["--iters", "2"]),
            "ad D": (inv, base + ["--axis", "D", "--true-scale", "0.6",
                                  "--iters", "2"]),
        }
        try:
            for name, (mod, argv) in runs.items():
                procs[name] = start_process(
                    mod, argv, os.path.join(tmp, name.replace(" ", "_")
                                            + ".log"))
            results = {name: finish_process(pr)
                       for name, pr in procs.items()}
        finally:
            for pr, _, _ in procs.values():
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        rows = read_t2_csv(scan_csv)
    for name, (rc, out, err, wall) in results.items():
        last = (out.strip().splitlines() or [""])[-1]
        print(f"  {name}: exit {rc}, {wall:.1f} s: {last}", flush=True)
        if name.startswith("ad "):
            m = re.search(r"recovered scale = ([0-9.]+)", out)
            check(m is not None, f"{name}: no recovered-scale line:\n"
                  f"{err[-2000:]}")
            got, true = float(m.group(1)), (1.4 if name == "ad moment"
                                             else 0.6)
            check(np.isfinite(got) and (got - 1.0) * (true - 1.0) > 0,
                  f"{name}: {got} did not move from 1.0 toward {true}")
        else:
            check(rc == 0, f"{name}: exit {rc}:\n{err[-2000:]}")
    m = re.search(r"recovered moment scale = ([0-9.]+)",
                  results["record"][1])
    check(m is not None and abs(float(m.group(1)) - 2.0) < 0.1,
          f"record fit: {results['record'][1]}")
    cli_err, gate = curve_gate(rows[1], kcos[:len(rows[1])], w)
    check(len(rows[1]) == 10, f"scan CLI wrote {len(rows[1])} rows")
    check(cli_err < gate, f"scan CLI curve off by {cli_err}")
    done(t0, f"{len(runs)} processes side by side; the scan CLI's curve "
         f"max |d Σcos/W| {cli_err:.3e} against the chunk kernel's (gate "
         f"{gate:.4f}) [{label}]")


#: phase 21: steps of the sharded runs, and the decomposition, echo
#: pairs and grid both the one-process and the two-process runs use
SHARD_STEPS = 200_000
DEC21 = dict(HEADLINE, totaltime=0.2, taucp=0.05)   # 2 sprints, CP flips
DEC21_SCALES = [0.5, 1.0, 2.0]
DEC21_TAUCPS = [0.05, 0.1]
DEC21_ECHOES = [(1.0, 0.05), (2.0, 0.1)]
GRID21 = {"D": [0.5, 1.0], "taucp": [0.05, 0.1]}
SCAN21 = ["--num-water", "4032", "--num-cells", "270", "--totaltime",
          "0.006", "--taucp", "0.001", "--chunk-steps", "1000",
          "--sprint-steps", "2000", "--near-k", "5", "--scene-seed", "42",
          "--seed", "7", "--moment-scales", "0.5,1", "--echo-taucps",
          "0.001,0.002", "--engine", "scan", "--device", "cuda"]


def same_walkers(st, ref, what):
    """The gathered state ``st`` bitwise ``ref``'s, escapes and coverage
    equal."""
    for f in ("pos", "in_cell", "phase", "phase_comp"):
        check(torch.equal(getattr(st, f).to(getattr(ref, f).device),
                          getattr(ref, f)), f"{what}: {f} not bitwise equal")
    check(st.step == ref.step and int(st.escapes) == int(ref.escapes)
          and int(st.coverage) == int(ref.coverage),
          f"{what}: step/escapes/coverage {st.step}/{int(st.escapes)}/"
          f"{int(st.coverage)} vs {ref.step}/{int(ref.escapes)}/"
          f"{int(ref.coverage)}")


def sharded_run(p, scene, rng_impl, mesh, steps, runner=None):
    """(cos, sin, stats, state, launches) of ``steps`` steps of the
    runner (``runner``, or a new one on ``mesh``) from the start."""
    if runner is None:
        runner = SimulationRunner(p, scene=scene, seed=7, device="cuda",
                                  rng_impl=rng_impl, mesh=mesh)
    else:
        runner.state = init_state(scene.waters, p, runner.device)
    reset_launches()
    _, cos, sin, stats = runner.run(progress=False, max_steps=steps)
    got = launches()
    check(stats["escapes"] == 0 and stats["coverage_violations"] == 0,
          f"escapes {stats['escapes']}, coverage "
          f"{stats['coverage_violations']}")
    return cos, sin, stats, runner.state, got


def start_worker(args, log):
    """This script as a worker process (``worker``) with its output in
    ``log``; returns (Popen, log, start time)."""
    out = open(log, "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--worker", *map(str, args)], cwd=ROOT,
                            stdout=out, stderr=subprocess.STDOUT)
    out.close()
    return proc, log, time.perf_counter()


def finish_workers(started, timeout=600):
    """Wait for every started process, killing all that remain when one
    fails or its time is up; each must exit 0.  Returns their logs and
    walls."""
    res = []
    try:
        for proc, log, t0 in started:
            rc = proc.wait(timeout=max(1.0, t0 + timeout - time.perf_counter()))
            with open(log) as fh:
                text = fh.read()
            check(rc == 0, f"process exit {rc}:\n{text[-3000:]}")
            res.append((text, time.perf_counter() - t0))
    finally:
        for proc, _, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return res


def worker_results(mesh, what):
    """What a worker of phase 21 (d) saves: the multi-process entry
    points at the headline (``what`` "all"), or the walker-sharded run
    alone ("sim")."""
    from mri_nanoparticle_simulation_tpu_torch.parallel import distributed
    p = Params(**HEADLINE).validate()
    sc = BacteriaBox(p, seed=42).populate()
    out, walls = {}, {}
    t0 = time.perf_counter()
    _, c, s, st = distributed.run_simulation_multihost(
        sc, p, mesh, seed=7, max_steps=SHARD_STEPS, rng_impl="threefry")
    walls["sim"] = time.perf_counter() - t0
    out.update(sim_cos=c, sim_sin=s, sim_pos=st.pos.cpu().numpy(),
               sim_phase=st.phase.cpu().numpy(),
               sim_in_cell=st.in_cell.cpu().numpy(),
               sim_counts=np.array([st.step, int(st.escapes),
                                    int(st.coverage)]))
    if what == "all":
        pd = Params(**DEC21).validate()
        t0 = time.perf_counter()
        r = distributed.run_decomposition_multihost(sc, pd, mesh, seed=7,
                                                    rng_impl="hardware")
        walls["record"] = time.perf_counter() - t0
        out.update(dec_A=r.A, dec_B=r.B)
        t0 = time.perf_counter()
        _, curves, _, echoes = distributed.run_plane_multihost(
            sc, pd, DEC21_SCALES, DEC21_TAUCPS, mesh, seed=7,
            rng_impl="hardware", echo_pairs=DEC21_ECHOES)
        walls["plane"] = time.perf_counter() - t0
        out["plane"] = curves
        for i, e in enumerate(echoes):
            out[f"echo{i}"] = e.cos
        pe = Params(**ENSEMBLE).validate()
        t0 = time.perf_counter()
        _, c, s = distributed.run_ensemble_multihost(
            pe, 4, base_seed=42, run_seed=7, rng_impl="threefry",
            max_steps=SHARD_STEPS, devices=["cuda:0"])
        walls["ensemble"] = time.perf_counter() - t0
        out.update(ens_cos=c, ens_sin=s)
        t0 = time.perf_counter()
        _, g = distributed.run_parameter_grid_multihost(
            pe, GRID21, n_trials_each=1, base_seed=42, run_seed=7,
            rng_impl="threefry", max_steps=SHARD_STEPS, quadrature=True,
            devices=["cuda:0"])
        walls["grid"] = time.perf_counter() - t0
        out["grid"] = g
    return out, walls


def worker(argv):
    """Phase 21 (d)'s worker: ``--worker BACKEND RANK WORLD RDZV OUT``
    joins a ``torch.distributed`` group (``file://RDZV``) and saves its
    results to OUT; under gloo two ranks share the card, under NCCL one
    rank alone (NCCL refuses two ranks on one card)."""
    from mri_nanoparticle_simulation_tpu_torch.parallel import distributed
    backend, rank, world, rdzv, out = argv
    require_cuda()
    chunk_kernel.load_library()
    distributed.initialize(f"file://{rdzv}", int(world), int(rank),
                           backend=backend)
    import torch.distributed as tdist
    check(tdist.get_backend() == backend, f"group backend "
          f"{tdist.get_backend()}, asked for {backend}")
    if backend == "nccl":
        mesh = distributed.global_walker_mesh()
        what = "sim"
    else:
        mesh = distributed.global_walker_mesh(["cuda:0"])
        what = "all"
    check(mesh.shape[WALKER_AXIS] == int(world) and mesh.group is not None,
          f"mesh {mesh}")
    res, walls = worker_results(mesh, what)
    np.savez(out, **res)
    print(json.dumps({"rank": int(rank), "walls": walls}))
    tdist.destroy_process_group()
    return 0


def dispersion_table(keep, path):
    """A --fit-r2 table of phase 15's 5c CLI run (its 16 CSVs) at
    ``path``, written by the CLI's own writer."""
    c5 = keep["5c"]
    ap = sim.build_parser()
    p = sim.params_from_args(ap, ap.parse_args(c5["argv"]))
    scales, taucps = [0.5, 1, 2, 4], [0.05, 0.1, 0.25, 0.5]
    curves = np.zeros((4, 4, p.t // p.pfreq, 2))
    for si, s in enumerate(scales):
        for ti, t in enumerate(taucps):
            rows = np.loadtxt(io.StringIO(
                c5["csvs"][f"t2_mscale={s:g}_taucp={t:g}.csv"]),
                delimiter=",", ndmin=2)
            curves[si, ti, :, 0] = rows[:, 1] / p.num_water
    times = (np.arange(1, curves.shape[2] + 1) * p.pfreq) * p.tau
    dec.write_dispersion(path, times, curves, scales, taucps, p.num_water)


def sharded(ctx, keep, label):
    """Phase 21: walker sharding and multi-process runs at full width,
    the scan engine's durable writers and on-device plane, the CLI's
    sharding flags and mri-t2-plot."""
    from mri_nanoparticle_simulation_tpu_torch.parallel import distributed
    from mri_nanoparticle_simulation_tpu_torch.parallel import sharding
    t0 = phase("21 (a) sharded runs, headline and scale-up")
    one = sharding.make_walker_mesh()
    two = sharding.make_walker_mesh(["cuda:0", "cuda:0"])
    check(one.shape[WALKER_AXIS] == torch.cuda.device_count(), f"{one}")
    p = Params(**HEADLINE).validate()
    scene = keep["scene"]
    ref21 = {}
    for rng_impl, mode in (("threefry", "chunk_kernel"),
                           ("hardware", "chunk_kernel[fast]")):
        runs = {name: sharded_run(p, scene, rng_impl, mesh, SHARD_STEPS)
                for name, mesh in (("unsharded", None), ("1 shard", one),
                                   ("2 shards", two))}
        ref = runs["unsharded"]
        ref21[rng_impl] = ref
        n = SHARD_STEPS // p.chunk_steps
        for name, want in (("unsharded", n), ("1 shard", n),
                           ("2 shards", 2 * n)):
            check(runs[name][4] == only(**{mode: want}),
                  f"{rng_impl} {name}: launches {launched(runs[name][4])}, "
                  f"expected {want} {mode}")
        notes = []
        for name in ("1 shard", "2 shards"):
            cos, sin, stats, st, _ = runs[name]
            same_walkers(st, ref[3], f"{rng_impl} {name}")
            werr = max(float(np.abs(cos - ref[0]).max()),
                       float(np.abs(sin - ref[1]).max()))
            check(werr < WIN_TOL, f"{rng_impl} {name}: window sums differ "
                  f"by {werr}")
            notes.append(f"{name} {stats['walker_steps_per_s']:.4e} "
                         f"walker-steps/s, window sums "
                         f"{'bitwise' if werr == 0 else f'within {werr:.3e}'}")
        print(f"  headline {rng_impl}, 2e5 steps: state bitwise on both "
              f"meshes; unsharded {ref[2]['walker_steps_per_s']:.4e} "
              f"walker-steps/s, {'; '.join(notes)}; launches {mode} "
              f"{n} / {n} / {2 * n}; phase 4 (Threefry, 2e6 steps) "
              f"{keep['t4_rate']:.4e} [{label}]", flush=True)
    q = ctx["p"]
    big = ctx["runner"]
    ref = sharded_run(q, big.scene, "threefry", None, SHARD_STEPS,
                      runner=big)
    got = sharded_run(q, big.scene, "threefry", two, SHARD_STEPS)
    same_walkers(got[3], ref[3], "scale-up, 2 shards")
    werr = float(np.abs(got[0] - ref[0]).max())
    check(werr <= 1e-6 * q.num_water, f"scale-up: window sums differ by "
          f"{werr} (gate {1e-6 * q.num_water})")
    n = SHARD_STEPS // q.chunk_steps
    check(ref[4] == only(chunk_near_kernel=n, cand_model_kernel=n)
          and got[4] == only(chunk_near_kernel=2 * n,
                             cand_model_kernel=2 * n),
          f"scale-up launches {launched(ref[4])} / {launched(got[4])}")
    print(f"  scale-up 2 shards (order 5, Threefry), 2e5 steps: state "
          f"bitwise, window sums within {werr:.3e} (gate "
          f"{1e-6 * q.num_water:g}); unsharded "
          f"{ref[2]['walker_steps_per_s']:.4e}, 2 shards "
          f"{got[2]['walker_steps_per_s']:.4e} walker-steps/s (phase 7, "
          f"2e6 steps: {ctx['rate7']:.4e}); launches {launched(ref[4])} / "
          f"{launched(got[4])} [{label}]", flush=True)
    q0 = q.replace(far_table_order=0)
    steps0 = 20_000
    ref = sharded_run(q0, big.scene, "threefry", None, steps0)
    got = sharded_run(q0, big.scene, "threefry", two, steps0)
    same_walkers(got[3], ref[3], "order 0, 2 shards")
    werr = float(np.abs(got[0] - ref[0]).max())
    check(werr <= 1e-6 * q.num_water, f"order 0: window sums differ by "
          f"{werr}")
    n = steps0 // q.chunk_steps
    check(ref[4] == only(chunk_near_kernel=n, far_sums_kernel=n,
                         cube_select_kernel=n)
          and got[4] == only(chunk_near_kernel=2 * n,
                             far_sums_kernel=2 * n,
                             cube_select_kernel=2 * n),
          f"order-0 launches {launched(ref[4])} / {launched(got[4])}")
    done(t0, f"order 0, 2 shards, 2e4 steps: state bitwise, window sums "
         f"within {werr:.3e}; unsharded {ref[2]['walker_steps_per_s']:.4e}, "
         f"2 shards {got[2]['walker_steps_per_s']:.4e} walker-steps/s "
         f"(phase 8, 2e5 steps: {ctx['rate8']:.4e}); launches "
         f"{launched(got[4])} [{label}]")

    t0 = phase("21 (b) sharded decomposition and plane, headline, fast")
    pd = Params(**DEC21).validate()
    rec = dec.run_decomposition(scene, pd, seed=7, device="cuda",
                                rng_impl="hardware")
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        res = dec.run_decomposition_durable(
            scene, pd, os.path.join(tmp, "a"), seed=7, scene_seed=42,
            device="cuda", rng_impl="hardware", mesh=two,
            checkpoint_path=os.path.join(tmp, "a.npz"))
        got = launches()
        n = pd.t // pd.chunk_steps
        check(got == only(**{"chunk_kernel[fast+dec]": 2 * n}),
              f"launches {launched(got)}, expected {2 * n} "
              f"chunk_kernel[fast+dec]")
        check(np.array_equal(np.asarray(res.A), rec.A)
              and np.array_equal(np.asarray(res.B), rec.B),
              "sharded record not bitwise the unsharded record")
        # three sprints on 2 shards, killed before sprint 2 (the drain,
        # one sprint deep, has committed sprint 0 and its checkpoint),
        # then resumed with no mesh
        p3 = pd.replace(totaltime=3 * pd.sprint_steps * pd.tau).validate()
        rec3 = dec.run_decomposition(scene, p3, seed=7, device="cuda",
                                     rng_impl="hardware")
        fault = resilience.FaultInjector({2: 1})
        with contextlib.suppress(RuntimeError):
            dec.run_decomposition_durable(
                scene, p3, os.path.join(tmp, "b"), seed=7, scene_seed=42,
                device="cuda", rng_impl="hardware", mesh=two,
                checkpoint_path=os.path.join(tmp, "b.npz"),
                fault_hook=fault)
        check(fault.faults_fired == 1 and checkpoint_step(
            os.path.join(tmp, "b.npz")) == p3.sprint_steps,
              "the faulted run left no checkpoint after sprint 0")
        res = dec.run_decomposition_durable(
            scene, p3, os.path.join(tmp, "b"), seed=7, scene_seed=42,
            device="cuda", rng_impl="hardware",
            checkpoint_path=os.path.join(tmp, "b.npz"))
        check(res.stats["sprints"] == 2 and np.array_equal(
            np.asarray(res.A), rec3.A) and np.array_equal(
            np.asarray(res.B), rec3.B),
              "resumed record not bitwise the uninterrupted one")
    kw = dict(seed=7, rng_impl="hardware", echo_pairs=DEC21_ECHOES)
    plane1 = dec.run_plane_on_device(scene, pd, DEC21_SCALES, DEC21_TAUCPS,
                                     device="cuda", **kw)
    plane2 = dec.run_plane_on_device(scene, pd, DEC21_SCALES, DEC21_TAUCPS,
                                     mesh=two, **kw)
    cerr = float(np.abs(plane2[1] - plane1[1]).max())
    check(cerr <= 1e-6, f"sharded plane curves differ by {cerr}")
    for a, b in zip(plane2[3], plane1[3]):
        check(np.array_equal(a.cos, b.cos), "sharded echo matrix differs")
    done(t0, f"2 shards: record bitwise ({rec.A.shape}); 3 sprints killed "
         f"after sprint 0 and resumed unsharded: bitwise; plane curves within "
         f"{cerr:.3e} (gate 1e-6), {len(plane1[3])} echo matrices bitwise; "
         f"plane walls unsharded {plane1[2]['wall_s']:.3f} s, 2 shards "
         f"{plane2[2]['wall_s']:.3f} s [{label}]")

    t0 = phase("21 (c) ensemble on a 2 x 2 (trials x walkers) mesh")
    pe = Params(**ENSEMBLE).validate()
    mesh2d = ens.make_trial_mesh(["cuda:0"] * 4, 2)
    reset_launches()
    t1 = time.perf_counter()
    _, cos, sin, st = ens.run_ensemble(pe, 4, mesh=mesh2d, walker_shards=2,
                                       base_seed=42, run_seed=7,
                                       rng_impl="threefry",
                                       max_steps=SHARD_STEPS, device="cuda")
    wall = time.perf_counter() - t1
    got = launches()
    n = SHARD_STEPS // pe.chunk_steps
    check(got == only(chunk_kernel=4 * 2 * n),
          f"launches {launched(got)}, expected {8 * n} chunk_kernel")
    alone_cos, werr = [], 0.0
    for i in range(4):
        _, c1, s1, alone = cuda_engine.run_simulation(
            BacteriaBox(pe, seed=42 + i).populate(), pe, seed=7 + i,
            device="cuda", rng_impl="threefry", max_steps=SHARD_STEPS)
        check_trial(st, i, alone, f"2D trial {i}")
        werr = max(werr, float(np.abs(cos[i] - c1).max()),
                   float(np.abs(sin[i] - s1).max()))
        alone_cos.append((c1, s1))
    check(werr < WIN_TOL, f"2D trials' window sums differ by {werr}")
    done(t0, f"4 trials bitwise their standalone runs (window sums within "
         f"{werr:.3e}); {ensemble_rate(4, pe, SHARD_STEPS, wall):.4e} "
         f"walker-steps/s, launches {launched(got)} [{label}]")

    t0 = phase("21 (d) two processes on the card (gloo), then NCCL")
    with tempfile.TemporaryDirectory() as tmp:
        started = [start_worker(["gloo", r, 2, os.path.join(tmp, "rdzv"),
                                 os.path.join(tmp, f"r{r}.npz")],
                                os.path.join(tmp, f"r{r}.log"))
                   for r in range(2)]
        # the one-process references while the workers start
        grid1 = ens.run_parameter_grid(pe, GRID21, n_trials_each=1,
                                       base_seed=42, run_seed=7,
                                       rng_impl="threefry",
                                       max_steps=SHARD_STEPS,
                                       quadrature=True, device="cuda")[1]
        logs = finish_workers(started)
        r0, r1 = (dict(np.load(os.path.join(tmp, f"r{r}.npz")))
                  for r in range(2))
        check(sorted(r0) == sorted(r1) and all(
            np.array_equal(r0[k], r1[k]) for k in r0),
              "the two ranks returned different results")
        c, s, _, ref_st, _ = ref21["threefry"]
        check(np.array_equal(r0["sim_pos"], ref_st.pos.cpu().numpy())
              and np.array_equal(r0["sim_phase"],
                                 ref_st.phase.cpu().numpy())
              and np.array_equal(r0["sim_in_cell"],
                                 ref_st.in_cell.cpu().numpy()),
              "run_simulation_multihost: state not bitwise one process's")
        check(r0["sim_counts"].tolist() == [ref_st.step, 0, 0],
              f"run_simulation_multihost counts {r0['sim_counts']}")
        werr = float(np.abs(r0["sim_cos"] - c).max())
        check(werr < WIN_TOL, f"multihost window sums differ by {werr}")
        check(np.array_equal(r0["dec_A"], rec.A)
              and np.array_equal(r0["dec_B"], rec.B),
              "run_decomposition_multihost: record not bitwise")
        perr = float(np.abs(r0["plane"] - plane1[1]).max())
        check(perr <= 1e-6, f"run_plane_multihost curves differ by {perr}")
        for i, e in enumerate(plane1[3]):
            check(np.array_equal(r0[f"echo{i}"], e.cos),
                  "run_plane_multihost echo matrix differs")
        check(all(np.array_equal(r0["ens_cos"][i], alone_cos[i][0])
                  and np.array_equal(r0["ens_sin"][i], alone_cos[i][1])
                  for i in range(4)),
              "run_ensemble_multihost: trials differ from standalone runs")
        check(np.array_equal(r0["grid"], grid1),
              "run_parameter_grid_multihost differs from one process")
        walls = [json.loads(t.strip().splitlines()[-1])["walls"]
                 for t, _ in logs]
        print(f"  gloo, 2 ranks x 1 shard on cuda:0: both ranks equal; "
              f"simulation state bitwise, window sums within {werr:.3e}; "
              f"record bitwise; plane within {perr:.3e}, echoes bitwise; "
              f"ensemble (4 trials) and grid (2 x 2) bitwise; rank walls "
              f"{walls[0]}; processes {logs[0][1]:.1f} / {logs[1][1]:.1f} s "
              f"[{label}]", flush=True)
        logs = finish_workers([start_worker(
            ["nccl", 0, 1, os.path.join(tmp, "rdzv_nccl"),
             os.path.join(tmp, "nccl.npz")], os.path.join(tmp, "nccl.log"))])
        rn = dict(np.load(os.path.join(tmp, "nccl.npz")))
        check(np.array_equal(rn["sim_pos"], ref_st.pos.cpu().numpy())
              and np.array_equal(rn["sim_phase"],
                                 ref_st.phase.cpu().numpy()),
              "NCCL run: state not bitwise one process's")
        nerr = float(np.abs(rn["sim_cos"] - c).max())
        check(nerr < WIN_TOL, f"NCCL window sums differ by {nerr}")
        nwall = json.loads(logs[0][0].strip().splitlines()[-1])["walls"]
    done(t0, f"NCCL, one rank: state bitwise, window sums within "
         f"{nerr:.3e}; run {nwall['sim']:.3f} s, process "
         f"{logs[0][1]:.1f} s [{label}]")

    t0 = phase("21 (e) the scan engine's durable writers and plane (CLI)")
    ap = sim.build_parser()
    ps = sim.params_from_args(ap, ap.parse_args(SCAN21))
    sc_s = BacteriaBox(ps, seed=42).populate()
    krec = dec.run_decomposition(sc_s, ps, seed=7, device="cuda",
                                 rng_impl="threefry")
    scales, taucps = [0.5, 1.0], [0.001, 0.002]
    kcurves = dec.curves_at_plane(krec.A, krec.B, scales, taucps, ps,
                                  quadrature=True)
    gate = (max(scales) + 1) * DEC_TOL

    def curve_err(tmp, stem):
        err = 0.0
        for si, s_ in enumerate(scales):
            for ti, t_ in enumerate(taucps):
                rows = read_t2_csv(os.path.join(
                    tmp, f"{stem}_mscale={s_:g}_taucp={t_:g}.csv"))
                err = max(err, float(np.abs(rows[1] / ps.num_water
                                            - kcurves[si, ti, :, 0]).max()))
        return err

    with tempfile.TemporaryDirectory() as tmp:
        j = functools.partial(os.path.join, tmp)
        record_argv = SCAN21 + ["--record-dir", j("rec"), "--checkpoint",
                                j("ck.npz"), "--out", j("r.csv")]
        plane_argv = SCAN21 + ["--plane-device", "--dump-echoes",
                               j("e.npz"), "--fit-r2", j("r2.csv"),
                               "--out", j("p.csv")]
        stream_argv = SCAN21 + ["--stream-plane", "--checkpoint",
                                j("snap.npz"), "--checkpoint-every", "1",
                                "--out", j("s.csv")]
        procs = [start_process("mri_nanoparticle_simulation_tpu_torch."
                               "engine.sim", a, j(f"{n}.log"))
                 for n, a in (("record", record_argv),
                              ("plane", plane_argv))]
        try:
            step = kill_at_step(stream_argv, j("snap.npz"), ps.sprint_steps,
                                ps.t, j("killed.log"))
            run_process(stream_argv, j("stream.log"))
            outs = [finish_process(pr) for pr in procs]
        finally:
            for pr, _, _ in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        for (rc, _, text, _), what in zip(outs, ("record", "plane")):
            check(rc == 0, f"--engine scan {what}: exit {rc}:\n"
                  f"{text[-2000:]}")
        store = record_mod.RecordStore.open(j("rec"))
        a, b = store.arrays()
        check(store.complete and store.meta["engine"] == "scan",
              f"record store meta {store.meta.get('engine')}")
        aerr = max(float(np.abs(np.asarray(a) - krec.A).max()),
                   float(np.abs(np.asarray(b) - krec.B).max()))
        check(aerr < DEC_TOL, f"scan record vs kernel record: {aerr}")
        check(checkpoint_step(j("ck.npz")) == ps.t,
              "the record run's final checkpoint")
        serr, perr = curve_err(tmp, "s"), curve_err(tmp, "p")
        check(serr < gate and perr < gate,
              f"scan curves vs the kernel record's: stream {serr}, plane "
              f"{perr} (gate {gate})")
        eerr = 0.0
        for e in dec.load_echoes(j("e.npz")):
            _, want = dec.echo_cos_matrix(krec.A, krec.B, ps, e.scale,
                                          e.taucp_ms)
            eerr = max(eerr, float(np.abs(e.cos - want).max()))
        check(eerr < gate, f"scan echo captures vs kernel record: {eerr}")
    done(t0, f"--record-dir: A, B within {aerr:.3e} of the chunk kernel's "
         f"record (tol {DEC_TOL}); --stream-plane --checkpoint killed at "
         f"step {step} and run again: curves within {serr:.3e}; "
         f"--plane-device --dump-echoes: curves within {perr:.3e}, echoes "
         f"within {eerr:.3e} (gate {gate:.1e}) [{label}]")

    t0 = phase("21 (f) the CLI: --shard-walkers, --walker-shards, "
               "mri-t2-plot")
    with tempfile.TemporaryDirectory() as tmp:
        j = functools.partial(os.path.join, tmp)
        argv = ["--num-water", "4032", "--num-cells", "270", "--totaltime",
                "0.2", "--chunk-steps", "4000", "--near-k", "5",
                "--scene-seed", "42", "--seed", "7", "--rng", "threefry",
                "--device", "cuda"]
        shard = start_process("mri_nanoparticle_simulation_tpu_torch."
                              "engine.sim", argv + ["--shard-walkers",
                                                    "--out", j("a.csv")],
                              j("shard.log"))
        bad = start_process("mri_nanoparticle_simulation_tpu_torch."
                            "engine.sim", argv + ["--ensemble", "4",
                                                  "--walker-shards", "2",
                                                  "--out", j("b.csv")],
                            j("bad.log"))
        try:
            rc, _, text, swall = finish_process(shard)
            brc, _, btext, _ = finish_process(bad)
        finally:
            for pr, _, _ in (shard, bad):
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        check(rc == 0 and "Sharding walkers over 1 device(s)" in text,
              f"--shard-walkers: exit {rc}:\n{text[-2000:]}")
        pc = sim.params_from_args(ap, ap.parse_args(argv))
        SimulationRunner(pc, scene_seed=42, seed=7, device="cuda",
                         rng_impl="threefry").run(csv_path=j("ref.csv"),
                                                  progress=False)
        with open(j("a.csv")) as fa, open(j("ref.csv")) as fr:
            check(fa.read() == fr.read(), "--shard-walkers CSV differs")
        want = "walker_shards (2) must divide the device count (1)"
        check(brc != 0 and want in btext,
              f"--ensemble 4 --walker-shards 2: exit {brc}:\n{btext[-2000:]}")
        plots = "not run: matplotlib is not installed on this machine"
        if importlib.util.find_spec("matplotlib") is not None:
            with open(j("t4.csv"), "w") as fh:
                fh.write(keep["t4_csv"])
            dispersion_table(keep, j("r2.csv"))
            scene_io.save_scene(scene, j("scene.npz"))
            with contextlib.redirect_stdout(io.StringIO()):
                analysis.main([j("t4.csv"), "--spectrum", "--out-table",
                               j("spec.csv")])
            started = [start_process(
                "mri_nanoparticle_simulation_tpu_torch.plotting",
                [*args, "--out", j(f"{name}.png")], j(f"{name}.log"))
                for name, args in (
                    ("curve", [j("t4.csv"), "--num-water", "4032"]),
                    ("table", [j("r2.csv"), "--table"]),
                    ("scene", [j("scene.npz"), "--scene"]),
                    ("spectrum", [j("spec.csv"), "--spectrum"]))]
            sizes = []
            try:
                for pr, name in zip(started, ("curve", "table", "scene",
                                              "spectrum")):
                    prc, _, ptext, _ = finish_process(pr)
                    size = os.path.getsize(j(f"{name}.png")) \
                        if os.path.exists(j(f"{name}.png")) else 0
                    check(prc == 0 and size > 0,
                          f"mri-t2-plot {name}: exit {prc}, {size} B:\n"
                          f"{ptext[-2000:]}")
                    sizes.append(f"{name} {size} B")
            finally:
                for pr, _, _ in started:
                    if pr.poll() is None:
                        pr.kill()
                        pr.wait()
            plots = "PNGs written: " + ", ".join(sizes)
    done(t0, f"--shard-walkers: 'Sharding walkers over 1 device(s)', CSV "
         f"bytewise the unsharded run's (process {swall:.1f} s); "
         f"--ensemble 4 --walker-shards 2 refused: {want!r}; mri-t2-plot "
         f"{plots} [{label}]")


def launched(got):
    """The kernels and modes of a LAUNCHES dict that were launched."""
    return {k: v for k, v in got.items() if v}


def run_cli(argv):
    """(launches, stderr text, wall s) of one port CLI run that must exit
    0 with no escape and no coverage violation; prints its stderr but
    the lines naming each CSV."""
    err = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = sim.main(argv)
    wall = time.perf_counter() - t0
    got = launches()
    text = err.getvalue()
    print("  " + "\n  ".join(ln for ln in text.splitlines()
                              if "wrote" not in ln
                              and not ln.startswith("  sprint ")),
          flush=True)
    check(rc == 0, f"CLI exit {rc}")
    m = re.search(r"(\d+) chunk escapes, (\d+) coverage violations", text)
    check(m is not None and m.groups() == ("0", "0"),
          "escapes or coverage violations")
    return got, text, wall


def grid_csvs(tmp):
    """{file name: Σcos} of the 16 grid-point CSVs of 2000 rows each
    that a 5c CLI run wrote into ``tmp``."""
    paths = sorted(glob.glob(os.path.join(tmp, "t2_mscale=*.csv")))
    check(len(paths) == 16, f"{len(paths)} CSVs, expected 16")
    curves = {}
    for path in paths:
        rows = read_t2_csv(path)
        check(len(rows[0]) == 2000, f"{path}: {len(rows[0])} rows")
        check(bool(np.isfinite(rows[1]).all()), f"{path}: non-finite")
        curves[os.path.basename(path)] = rows[1]
    return curves


def timed(fn):
    """(result, ms) of one call of ``fn`` between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def scale_err(got, ref):
    """Largest |got - ref| of each of the leading rows over that row's
    largest |ref|, maximised over rows."""
    return max(float((g - r).abs().max()) / float(r.abs().max())
               for g, r in zip(got, ref))


def final_anchors(state, p):
    """The wrapped anchors f32[3, W_pad] of a run's final ``state``: what
    the large path's next chunk hands the candidate model."""
    planes = cuda_engine.to_soa(state, p).planes
    return cuda_engine._wrap(planes[:3], p.bound).contiguous()


def compare_cand_model(pos, p, cache, reach2):
    """Kernel 2 and its plain version on the same anchors ``pos``;
    returns (near, taylor, max taylor error over its scale, slots
    differing, plain ms)."""
    k1 = expansion.build_planes(pos, p, cache, reach2=reach2)
    k2 = expansion.build_planes(pos, p, cache, reach2=reach2)
    ref, plain_ms = timed(lambda: expansion.cand_model_reference(
        pos, cache.cand_table, cache.far_coeffs, near_k=p.near_k,
        order=p.far_table_order, h=p.cube_hash_dim, bound=float(p.bound),
        reach2=reach2))
    for a, b in zip(k1, k2):
        check(torch.equal(a, b), "two candidate-model runs differ")
    near, taylor, cnt = k1
    r_near, r_taylor, r_cnt = ref
    differ = (near != r_near).any(0)
    d2 = ((near[:3] - pos[:, None]) ** 2).sum(0)
    r_d2 = ((r_near[:3] - pos[:, None]) ** 2).sum(0)
    check(torch.equal(d2[differ], r_d2[differ]),
          "near slots differ where d^2 does not tie")
    terr = scale_err(taylor, r_taylor)
    check(terr < TAYLOR_TOL, f"taylor differs by {terr} of its scale")
    check(torch.equal(cnt, r_cnt), "n_reach differs")
    check(bool(torch.isfinite(taylor).all()), "non-finite taylor")
    print(f"  candidate-model, {pos.shape[1]} walkers: taylor err "
          f"{terr:.3e} of scale (tol {TAYLOR_TOL}), "
          f"{int(differ.sum())} tied slots differ, n_reach equal; plain "
          f"{plain_ms:.2f} ms", flush=True)
    return near, taylor, terr, plain_ms


def compare_far_sums(pos, tbl, idx):
    """Kernel 3 and its plain version; returns (error of each row's
    scale, plain ms)."""
    f1 = chunk_kernel.run_far_sums(pos, tbl, idx)
    f2 = chunk_kernel.run_far_sums(pos, tbl, idx)
    fref, plain_ms = timed(lambda: expansion.far_sums_reference(pos, tbl,
                                                                idx))
    check(torch.equal(f1, f2), "two far-sums runs differ")
    ferr = scale_err(f1, fref)
    check(ferr < FAR_TOL, f"far sums differ by {ferr} of a row's scale")
    check(bool(torch.isfinite(f1).all()), "non-finite far sums")
    print(f"  far sums, {pos.shape[1]} walkers: err {ferr:.3e} of each "
          f"row's scale (tol {FAR_TOL}); plain {plain_ms:.2f} ms", flush=True)
    return ferr, plain_ms


def compare_near_chunk(planes, near, taylor, cargs):
    """Kernel 1c and its plain version for one chunk; returns (position
    error, window-sum error, plain ms)."""
    n = cargs["num_water"]
    c1 = chunk_kernel.run_chunk_near(planes, near, taylor, **cargs)
    c2 = chunk_kernel.run_chunk_near(planes, near, taylor, **cargs)
    cref, plain_ms = timed(lambda: cuda_engine.chunk_near_reference(
        planes, near, taylor, **cargs))
    for a, b in zip(c1, c2):
        check(torch.equal(a, b), "two near/taylor chunk runs differ")
    out, esc, cov, wins = c1
    pos_err = float((out[:3, :n] - cref[0][:3, :n]).abs().max())
    win_err = float((wins.sum(0) - cref[3].sum(0)).abs().max())
    check(pos_err < POS_TOL, f"1c positions differ by {pos_err}")
    check(torch.equal(out, cref[0]), "1c state not bitwise equal")
    check(win_err < WIN_TOL, f"1c window sums differ by {win_err}")
    check(torch.equal(esc, cref[1]), "1c escapes differ")
    check(float(cov.abs().sum()) == 0.0, "1c coverage output not zero")
    check(bool(torch.isfinite(out).all()), "non-finite 1c state")
    key = chunk_kernel.chunk_mode("chunk_near_kernel", cargs["phys"])
    print(f"  {key}, {n} walkers, K={near.shape[1]}: |pos| err "
          f"{pos_err:.3e} (tol {POS_TOL}), |wins| err {win_err:.3e} (tol "
          f"{WIN_TOL}), escapes {int(esc.sum())}/{int(cref[1].sum())}; "
          f"plain {plain_ms:.1f} ms", flush=True)
    return pos_err, win_err, plain_ms


def check_far_table(tbl, cache, p, label):
    """The f32 far table against the same table in f64, and the f64
    table's degree 0-2 coefficients against the f64 far sums (value,
    gradient, Hessian) at the cube centres without the candidates.
    Returns (f32 error, low-degree error)."""
    h, order = p.cube_hash_dim, p.far_table_order
    cand = cache.payload[..., 4].long()
    pos64, m64 = tbl.pos.double(), tbl.m.double()
    t1 = time.perf_counter()
    c64 = fartable.build_far_table(pos64, m64, cand, h, float(p.bound),
                                   order)
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t1
    terr = scale_err(cache.far_coeffs.double().T, c64.T)
    centers = torch.as_tensor(fartable.cube_centers(h, float(p.bound)),
                              device=pos64.device)
    fs = expansion.far_sums_reference(centers.T.contiguous(),
                                      expansion.pack_table(pos64, m64),
                                      cand.T.contiguous())
    ix = {m: i for i, m in enumerate(fartable.monomials(order))}
    low = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (2, 0, 0),
           (0, 2, 0), (0, 0, 2), (1, 1, 0), (1, 0, 1), (0, 1, 1)]
    want = [fs[i] / 2 if 4 <= i <= 6 else fs[i] for i in range(10)]
    lerr = scale_err([c64[:, ix[m]] for m in low], want)
    print(f"  far table: f32 vs f64 {terr:.3e} of each coefficient's "
          f"scale (tol {TABLE_TOL}); f64 degree 0-2 vs f64 far sums at the "
          f"centres {lerr:.3e} (tol {LOW_TOL}); f64 build {f64_s:.3f} s "
          f"[{label}]", flush=True)
    check(terr < TABLE_TOL, f"f32 far table differs by {terr}")
    check(lerr < LOW_TOL, f"far table's low degrees differ by {lerr}")
    return terr, lerr


def large_scene_phases(dev, label):
    """Phases 6-8; returns the kernels-line entries of kernels 1c, 2, 3,
    and what the later phases reuse: the scale-up Params, runner, and
    the 4096-walker near/taylor inputs of phase 6."""
    t0 = phase("6 large-scene kernels vs plain versions (scale-up scene)")
    p = Params(**SCALEUP).validate()
    sc = BacteriaBox(p, seed=42).populate()
    check(len(sc.mnps) == 5253 or p.num_water != 100_000,
          f"scale-up scene has {len(sc.mnps)} dipoles")
    tbl = mnp_table(sc.mnps, torch.float32, dev)
    t1 = time.perf_counter()
    cache = expansion.build_cache(tbl.pos, tbl.m, p, far_table=False)
    torch.cuda.synchronize()
    cube_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    coeffs = fartable.build_far_table(
        tbl.pos, tbl.m, cache.payload[..., 4].long(), p.cube_hash_dim,
        float(p.bound), p.far_table_order)
    torch.cuda.synchronize()
    far_s = time.perf_counter() - t1
    check(bool(torch.isfinite(coeffs).all()), "non-finite far table")
    cache = expansion.SceneCache(cache.payload, coeffs, cache.cand_table)
    print(f"  cube table {cube_s:.3f} s, far table "
          f"({p.cube_hash_dim ** 3} cubes x "
          f"{len(sc.mnps)} dipoles, order {p.far_table_order}) {far_s:.3f} s "
          f"[{label}]", flush=True)
    table_err, low_err = check_far_table(tbl, cache, p, label)
    reach2 = expansion.coverage_reach2(p)
    n = min(4096, p.num_water)
    args = dict(key=key_words(7), lane_offset=0, num_water=n, tcp=p.tcp,
                cell_r2=cuda_engine.cell_r2_f32(p.cell_r), dstd=1.0,
                phys=cuda_engine.chunk_physics(p))
    planes = cuda_engine.to_soa(init_state(sc.waters[:n], p, dev), p).planes

    def wrapped(pl):
        return torch.cat([cuda_engine._wrap(pl[:3], p.bound), pl[3:]])

    def cube_ids(pos, payload):
        rows, _ = expansion.cube_select(pos.T, payload, p)
        return rows[..., 4].to(torch.int32).T.contiguous()

    # the cheap first check on 4096 waters; one chunk through kernels 2
    # and 1c first, so phases are nonzero
    planes = wrapped(planes)
    near, taylor, _ = expansion.build_planes(planes[:3], p, cache, reach2)
    planes, *_ = chunk_kernel.run_chunk_near(planes, near, taylor, step0=0,
                                             **args)
    planes = wrapped(planes)
    pos = planes[:3].contiguous()
    near, taylor, terr, _ = compare_cand_model(pos, p, cache, reach2)
    ferr, _ = compare_far_sums(pos, tbl.tbl, cube_ids(pos, cache.payload))
    cargs = dict(args, step0=p.chunk_steps)
    pos_err, win_err, _ = compare_near_chunk(planes, near, taylor, cargs)
    done(t0, f"{n} walkers [{label}]")

    t0 = phase("7 scale-up run, full width (far-table order 5)")
    runner = SimulationRunner(p, scene_seed=42, seed=7, device="cuda",
                              rng_impl="threefry")
    check(runner.uses_cubes and runner.cache.far_coeffs is not None,
          "the scale-up runner did not take the cube path")
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "t2.csv")
        reset_launches()
        _, cos, _, stats = runner.run(csv_path=csv, progress=False,
                                      max_steps=2_000_000)
        big_launches = launches()
        rows = read_t2_csv(csv)
    check(len(rows[0]) == 1000, f"{len(rows[0])} CSV rows, expected 1000")
    check(np.allclose(rows[1], cos), "CSV disagrees with the run")
    check(stats["escapes"] == 0, f"{stats['escapes']} escapes")
    check(stats["coverage_violations"] == 0,
          f"{stats['coverage_violations']} coverage violations")
    check(big_launches == only(chunk_near_kernel=500, cand_model_kernel=500),
          f"kernel launches {big_launches}")
    check(bool(np.isfinite(cos).all()), "non-finite window sums")
    check(float(np.abs(cos).max()) <= p.num_water, "|sum cos| > num_water")
    print(f"  2e6 steps x {p.num_water} walkers: "
          f"{stats['walker_steps_per_s']:.4e} walker-steps/s, wall "
          f"{stats['wall_s']:.3f} s, scene cache {runner.cache_build_s:.3f} "
          f"s, launches {big_launches}, final sum cos/W "
          f"{cos[-1] / p.num_water:.6f} [{label}]", flush=True)
    # kernels 2 and 1c against their plain versions at full width, on the
    # run's final state, with the runner's cache
    ss = cuda_engine.to_soa(runner.state, p)
    full = wrapped(ss.planes)
    fpos = full[:3].contiguous()
    fnear, ftaylor, terr_full, cand_plain_ms = compare_cand_model(
        fpos, p, runner.cache, reach2)
    fargs = dict(args, num_water=p.num_water, step0=ss.step)
    pos_full, win_full, near_plain_ms = compare_near_chunk(
        full, fnear, ftaylor, fargs)
    cand_ms = time_chunk(lambda: expansion.build_planes(
        fpos, p, runner.cache, reach2), 20)
    near_ms = time_chunk(lambda: chunk_kernel.run_chunk_near(
        full, fnear, ftaylor, **fargs), 3)
    near_bound = counts.bound(*counts.chunk_work(fargs["num_water"],
                                                 work_mode(fargs["phys"])))
    cand_work = counts.cand_model_work(
        p.num_water, p.near_k, runner.cache.cand_table.shape[1],
        p.cube_hash_dim, runner.cache.far_coeffs.shape[1])
    cand_bound = counts.bound(*cand_work)
    cand_issue = issue_bound_ms(*cand_work)
    done(t0, f"per chunk at {fpos.shape[1]} walkers: candidate-model "
         f"{cand_ms:.4f} ms (plain {cand_plain_ms:.2f} ms; bound "
         f"{cand_bound[0]:.4f} ms, {cand_bound[1]}; {cand_issue:.4f} ms "
         f"with an issue slot per float operation), near/taylor chunk "
         f"{near_ms:.3f} ms (plain {near_plain_ms:.1f} ms) [{label}]")

    t0 = phase("8 scale-up, far_table_order=0 (far-sums kernel)")
    p0 = p.replace(far_table_order=0)
    runner0 = SimulationRunner(p0, scene=runner.scene, seed=7,
                               device="cuda", rng_impl="threefry")
    check(runner0.uses_cubes and runner0.cache.far_coeffs is None,
          "the order-0 runner has a far table")
    reset_launches()
    _, cos0, _, stats0 = runner0.run(progress=False, max_steps=200_000)
    exact_launches = launches()
    check(exact_launches == only(chunk_near_kernel=50, far_sums_kernel=50,
                                 cube_select_kernel=50),
          f"kernel launches {exact_launches}")
    check(stats0["escapes"] == 0 and stats0["coverage_violations"] == 0,
          f"escapes {stats0['escapes']}, coverage "
          f"{stats0['coverage_violations']}")
    check(len(cos0) == 100, f"{len(cos0)} windows, expected 100")
    dcurve = float(np.abs(cos0 - cos[:100]).max()) / p.num_water
    check(dcurve < CURVE_TOL, f"order 0 vs order 5: {dcurve}")
    print(f"  2e5 steps: max |d(sum cos/W)| vs order 5 {dcurve:.3e} (tol "
          f"{CURVE_TOL}), {stats0['walker_steps_per_s']:.4e} walker-steps/s, "
          f"launches {exact_launches} [{label}]", flush=True)
    # kernel 3 against its plain version at full width, on the run's
    # final state; its launch as the runtime reports it, and its SASS
    apos = wrapped(cuda_engine.to_soa(runner0.state, p0).planes)[:3]
    apos = apos.contiguous()
    idx0 = cube_ids(apos, runner0.cache.payload)
    ferr_full, far_plain_ms = compare_far_sums(apos, runner0.mnp_tbl.tbl,
                                               idx0)
    far_ms = time_chunk(lambda: chunk_kernel.run_far_sums(
        apos, runner0.mnp_tbl.tbl, idx0), 5)
    far_shape = (p0.num_water, runner0.mnp_tbl.tbl.shape[1], idx0.shape[0])
    far_work = counts.far_sums_work(*far_shape)
    far_bound = counts.bound(*far_work)
    far_issue = issue_bound_ms(*far_work)
    far_info = chunk_kernel.far_sums_info(p0.near_k, dev)
    far_lay = chunk_kernel.LAYOUTS["far_sums_kernel"]
    check(far_lay == chunk_kernel.walker_layout(
        apos.shape[1], torch.cuda.get_device_properties(dev)
        .multi_processor_count, far_info), f"far sums launched as {far_lay}")
    check(far_info.local_bytes == 0 and far_lay.waves == 1,
          f"far sums: {far_lay}, {far_info.local_bytes} B local memory")
    far_sass = sass_loop(chunk_kernel, FAR_SUMS_K10)
    far_pair = far_sass["instructions"] / far_sass["rsqrt"]
    chunk_ms = 1e3 * stats0["wall_s"] / exact_launches["far_sums_kernel"]
    print(f"  far sums, {apos.shape[1]} walkers x "
          f"{runner0.mnp_tbl.tbl.shape[1]} entries, K={p0.near_k}: "
          f"{far_ms:.4f} ms (plain {far_plain_ms:.2f} ms), bound "
          f"{far_bound[0]:.4f} ms ({far_bound[1]}), {far_issue:.4f} ms with "
          f"an issue slot per float operation; err {ferr_full:.3e} of each "
          f"row's scale (tol {FAR_TOL}); {far_lay.blocks} x "
          f"{far_lay.threads} threads, {far_lay.blocks_per_sm} resident per "
          f"SM, {far_lay.waves} wave(s), {far_info.regs} registers, "
          f"{far_info.local_bytes} B local memory; SASS {far_pair:.2f} "
          f"instructions a pair ({far_sass['instructions']} for "
          f"{far_sass['rsqrt']}) [{label}]",
          flush=True)
    done(t0, f"order-0 run {stats0['walker_steps_per_s']:.4e} "
         f"walker-steps/s, {chunk_ms:.3f} ms of wall a chunk, far sums "
         f"{far_ms:.4f} ms of it ({far_ms / chunk_ms:.1%}) [{label}]")

    ctx = dict(p=p, runner=runner, planes=planes, near=near, taylor=taylor,
               cargs=cargs, full=full, fnear=fnear, ftaylor=ftaylor,
               fargs=fargs, rate7=stats["walker_steps_per_s"],
               rate8=stats0["walker_steps_per_s"])
    return ctx, [{
        "name": "chunk_near_kernel",
        "route": "cuda",
        "source": PKG + "chunk_near_kernel.cu",
        "replaces": REPLACES,
        "launches": big_launches["chunk_near_kernel"],
        "max_abs_err": max(pos_err, pos_full),
        "max_abs_err_wins": max(win_err, win_full),
        "tolerance": {"positions": POS_TOL, "window_sums": WIN_TOL},
        "ms": near_ms,
        "plain_ms": near_plain_ms,
        "bound_ms": near_bound[0],
        "bound_by": near_bound[1],
        "library_ms": None,
    }, {
        "name": "cand_model_kernel",
        "route": "cuda",
        "source": PKG + "cand_model_kernel.cu",
        "replaces": REF + "fields/expansion.py:497",
        "launches": big_launches["cand_model_kernel"],
        "max_abs_err": max(terr, terr_full),
        "tolerance": {"taylor_of_scale": TAYLOR_TOL, "near_slots": "equal "
                      "but for d^2 ties", "n_reach": "equal"},
        "far_table_err": {"f32_vs_f64": table_err, "low_degrees": low_err,
                          "tolerance": [TABLE_TOL, LOW_TOL]},
        "ms": cand_ms,
        "plain_ms": cand_plain_ms,
        "bound_ms": cand_bound[0],
        "bound_by": cand_bound[1],
        "issue_bound_ms": cand_issue,
        "library_ms": None,
    }, {
        "name": "far_sums_kernel",
        "route": "cuda",
        "source": PKG + "far_sums_kernel.cu",
        "replaces": REF + "fields/expansion.py:358",
        "launches": exact_launches["far_sums_kernel"],
        "max_abs_err": max(ferr, ferr_full),
        "tolerance": {"of_each_rows_scale": FAR_TOL},
        "layout": far_lay._asdict(),
        "local_bytes": far_info.local_bytes,
        "sass_per_pair": far_pair,
        "ms": far_ms,
        "plain_ms": far_plain_ms,
        "bound_ms": far_bound[0],
        "bound_by": far_bound[1],
        "issue_bound_ms": far_issue,
        "library_ms": None,
    }]


def cube_select_work(w, k, c, h):
    """(bytes, float, integer operations) of one cube selection: the
    anchors read and the K rows (x, y, z, M * FIELD_SCALE, M, id) and
    reach counts written once, the scene's candidates (16 bytes a
    candidate, and the M and id, 8) read once; per walker and candidate
    d^2 and the reach test (9 float operations), the bf16 key (5 integer)
    and its sorted insertion (2K integer)."""
    return (4 * w * (3 + 6 * k + 1) + 24 * h ** 3 * c, 9 * w * c,
            w * c * (5 + 2 * k))


def _select_cases(pos, payload, cand, p):
    """(name, anchors, payload, cand, K) of the edge cases on the scene's
    own candidate table: anchors on every cube face of the box's corner
    cubes; at and beyond [0, bound) on each axis (the clamp); at the
    cube's candidates themselves (d^2 0, and ties among the equidistant);
    and K = C on the first 16 candidates of every cube."""
    dev, bound, h = pos.device, float(p.bound), p.cube_hash_dim
    cube = bound / h
    grid = torch.arange(h + 1, dtype=torch.float32, device=dev) * cube
    faces = torch.stack(torch.meshgrid(grid, grid, grid, indexing="ij"),
                        0).reshape(3, -1).contiguous()
    edge = torch.tensor([-cube, -1e-6, -0.0, 0.0, 1e-6, bound - 1e-6, bound,
                         bound + 1e-6, bound + cube, 2 * bound], device=dev)
    clamp = torch.stack([edge.repeat(100), edge.repeat_interleave(10)
                         .repeat(10), edge.repeat_interleave(100)])
    at = payload[:, :8, :3].reshape(-1, 3).T.contiguous()
    pay16 = payload[:, :16].contiguous()
    return [("cube faces", faces, payload, cand, p.near_k),
            ("clamp", clamp.contiguous(), payload, cand, p.near_k),
            ("at candidates", at, payload, cand, p.near_k),
            ("K = C = 16", pos, pay16, expansion.pack_candidates(pay16),
             16)]


def _same_selection(got, want, what):
    for name, a, b in zip(("near", "near_M", "ids", "n_reach"), got, want):
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"{what}: {name} differs from the plain version")


def cube_select_phase(dev, res, label):
    """Phase 8 (c): the cube-selection kernel at the scaleup-exact cell's
    shape against its plain version, bitwise, then its edge cases, its
    time, bound, registers and layout, and its launches in an order-0
    sprint.  Returns its kernels-line entry."""
    from port_bench import catalog
    t0 = phase("8 (c) cube-selection kernel vs plain version "
               "(scaleup-exact scene)")
    cfg = catalog.load_config("scaleup-exact")
    kv = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg["keys"].items() if k in Params.__dataclass_fields__}
    p = Params(**kv).validate()
    runner = SimulationRunner(p, scene_seed=cfg["scene_seed"], seed=7,
                              device="cuda", rng_impl="hardware")
    cache = runner.cache
    check(runner.uses_cubes and cache.far_coeffs is None,
          "the scaleup-exact runner has a far table")
    pos = cuda_engine._wrap(cuda_engine.to_soa(runner.state, p).planes[:3],
                            p.bound).contiguous()
    mixed = pos[:, torch.randperm(pos.shape[1], generator=torch.Generator()
                                  .manual_seed(7)).to(dev)].contiguous()
    reach2 = expansion.coverage_reach2(p)
    args = dict(h=p.cube_hash_dim, bound=float(p.bound), reach2=reach2)
    c = cache.payload.shape[1]

    def kernel(anchors, payload=cache.payload, cand=cache.cand_table,
               k=p.near_k):
        return chunk_kernel.run_cube_select(anchors, payload, cand,
                                            near_k=k, **args)

    def plain(anchors, payload=cache.payload, k=p.near_k):
        return expansion.cube_select_reference(anchors, payload, near_k=k,
                                               **args)
    reset_launches()
    for what, anchors in (("Morton order", pos), ("shuffled", mixed)):
        got = kernel(anchors)
        _same_selection(got, kernel(anchors), f"{what}: two runs")
        want, plain_ms = timed(lambda: plain(anchors))
        _same_selection(got, want, what)
        # ties the passes break by slot: adjacent selected rows of one bf16
        b = ((got[0][:3] - anchors[:, None]) ** 2).sum(0).to(torch.bfloat16)
        ties = int((b[1:] == b[:-1]).any(0).sum())
        print(f"  {what}, {anchors.shape[1]} walkers, C {c}, K {p.near_k}: "
              f"bitwise (ids, near x y z M*FIELD_SCALE, M, n_reach); "
              f"{ties} walkers with tied bf16 keys among their K; reach "
              f"counts up to {int(got[3].max())}; plain {plain_ms:.3f} ms",
              flush=True)
    check(chunk_kernel.LAUNCHES["cube_select_kernel"] == 4,
          f"LAUNCHES {launched(launches())}")
    for what, anchors, payload, cand, k in _select_cases(
            pos, cache.payload, cache.cand_table, p):
        got = kernel(anchors, payload, cand, k)
        _same_selection(got, plain(anchors, payload, k), what)
        print(f"  {what}: {anchors.shape[1]} anchors, C "
              f"{payload.shape[1]}, K {k}: bitwise", flush=True)
    w = pos.shape[1]
    ms = time_chunk(lambda: kernel(pos), 50)
    ms_mixed = time_chunk(lambda: kernel(mixed), 50)
    plain_dev_ms = time_chunk(lambda: plain(mixed), 5)
    work = cube_select_work(w, p.near_k, c, p.cube_hash_dim)
    bnd = counts.bound(*work)
    info = chunk_kernel.cube_select_info(p.near_k, dev)
    lay = chunk_kernel.LAYOUTS["cube_select_kernel"]
    check(lay == chunk_kernel.walker_layout(
        w, torch.cuda.get_device_properties(dev).multi_processor_count,
        info), f"cube selection launched as {lay}")
    regs, spill = res["cube_select_kernel", p.near_k]
    check(spill_bytes(spill) == 0 and info.local_bytes == 0,
          f"cube selection: {spill}, {info.local_bytes} B local memory")
    print(f"  {w} walkers: kernel {ms:.4f} ms Morton order, {ms_mixed:.4f} "
          f"ms shuffled; plain version {plain_dev_ms:.4f} ms; bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}: {work[0]} B, {work[1]} float, "
          f"{work[2]} integer operations); {lay.blocks} x {lay.threads} "
          f"threads, {lay.blocks_per_sm} resident per SM, {lay.waves} "
          f"wave(s); {regs} registers, {spill_bytes(spill)} B spilled "
          f"[{label}]", flush=True)
    # one order-0 sprint through the runner: one selection a chunk
    reset_launches()
    runner.run(progress=False, max_steps=p.sprint_steps)
    got = launches()
    n = p.sprint_steps // p.chunk_steps
    near = chunk_kernel.chunk_mode("chunk_near_kernel",
                                   cuda_engine.chunk_physics(p, "hardware"))
    check(got == only(**{near: n}, far_sums_kernel=n, cube_select_kernel=n),
          f"order-0 sprint launches {launched(got)}")
    done(t0, f"one order-0 sprint ({n} chunks): launches {launched(got)} "
         f"[{label}]")
    return {
        "name": "cube_select_kernel",
        "route": "cuda",
        "source": PKG + "cube_select_kernel.cu",
        "replaces": None,
        "launches": got["cube_select_kernel"],
        "max_abs_err": 0.0,
        "tolerance": {"near ids M n_reach": "bitwise"},
        "layout": lay._asdict(),
        "registers": regs,
        "spill_bytes": spill_bytes(spill),
        "local_bytes": info.local_bytes,
        "ms": ms_mixed,
        "ms_morton": ms,
        "plain_ms": plain_dev_ms,
        "bound_ms": bnd[0],
        "bound_by": bnd[1],
        "library_ms": None,
    }


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(sys.argv[2:]))
    sys.exit(main())

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
   variants), each for K = 1..16;
3. rebuild kernel vs plain version (engine/cuda_engine.chunk_reference)
   on the same CUDA inputs at the main path's shapes, 50 and 4032
   walkers, in the split layout (128 blocks of one walker warp and three
   generator warps at 4032): the state bitwise equal, window sums within
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
   kernel's path): 50 launches each of far sums and near/taylor chunk,
   Σcos/W within 1e-5 of phase 7's first 2e5 steps, its walker-steps/s
   and the far sums' share of a chunk's wall; then the far-sums kernel
   against its plain version at full width (1e-5 of each row's scale,
   two runs bitwise equal), with times of both, its bound (and with an
   issue slot per float operation), its layout (one wave, no local
   memory) and its SASS instructions a pair;
8b. the layout of every mode of both entries at its path's width:
   blocks, threads, generator warps, dynamic shared memory, resident
   blocks per SM, waves, registers and spills; and of the candidate-model
   kernel at the scale-up width (one wave: 6 or more blocks per SM, at
   most 80 registers, no spill);
9. (a) the fast and variant modes against their plain versions: the
   rebuild kernel on the headline scene at 50 and 4032 walkers, fast
   with the default physics, Threefry with every variant on (intended
   kick, sphere directions, permeable membranes, a z gradient) and fast
   with every variant on; the near/taylor kernel in the same three
   modes on the scale-up scene's first 4096 waters; the gates of phases
   3 and 6, two kernel runs bitwise equal; times of both;
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
   against direct runs;
16. the scale-up with a streaming (moment x taucp) plane on the fast
   generator, 2e5 steps: 0 escapes, 0 violations, only
   chunk_near_kernel[fast+dec] and cand_model_kernel launched, the s = 1
   curve within 5e-5 of a direct run, the candidate-model kernel against
   its plain version on the walkers after those 2e5 steps; the time
   split; then 2e4 steps on Threefry and with every variant on, on each
   generator;
17. the kernels line (every entry and mode, with its launches in the
   run of its path, its time beside its plain version's and its bound,
   its layout, registers and spills),
   then {"ok": true, "device": {...}}.

    python3 chip_smoke.py
"""

import contextlib
import glob
import io
import json
import os
import re
import sys
import tempfile
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mri_nanoparticle_simulation_tpu_torch import golden  # noqa: E402
from mri_nanoparticle_simulation_tpu_torch.benchmark import (  # noqa: E402
    FAR_SUMS_K10, SCALEUP, all_variants, sass_loop, time_on_device)
from mri_nanoparticle_simulation_tpu_torch.engine import (  # noqa: E402
    chunk_kernel, cuda_engine, sim)
from mri_nanoparticle_simulation_tpu_torch.engine import (  # noqa: E402
    decompose as dec)
from mri_nanoparticle_simulation_tpu_torch.engine.convert import (  # noqa
    key_words, mnp_table)
from mri_nanoparticle_simulation_tpu_torch.fields import (  # noqa: E402
    expansion, fartable)
from mri_nanoparticle_simulation_tpu_torch.engine.reference_engine import (  # noqa
    init_state)
from mri_nanoparticle_simulation_tpu_torch.engine.sim import (  # noqa: E402
    SimulationRunner)
from mri_nanoparticle_simulation_tpu_torch.io.writer import (  # noqa: E402
    read_t2_csv)
from mri_nanoparticle_simulation_tpu_torch.params import Params  # noqa: E402
from mri_nanoparticle_simulation_tpu_torch.scene import (  # noqa: E402
    BacteriaBox)
from mri_nanoparticle_simulation_tpu_torch.utils.device import (  # noqa: E402
    card_label, require_cuda)

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
HEADLINE = dict(chunk_steps=4000, near_k=5)
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
#: the card's peak rates for the bounds (NVIDIA H100 SXM at 700 W, 132
#: SMs at 1.98 GHz): HBM3 bytes/s; the published float32 rate outside
#: the tensor cores, 67 TFLOP/s (128 FP32 lanes per SM and cycle, a fused
#: multiply-add counted as two operations); issue slots, 4 schedulers x
#: 32 lanes per SM and cycle; and the INT32 lanes, 64 per SM and cycle
PEAK_BYTES = 3.35e12
PEAK_FP32 = 2 * 128 * 132 * 1.98e9
PEAK_ISSUE = 128 * 132 * 1.98e9
PEAK_INT32 = 64 * 132 * 1.98e9


def bound(nbytes, flops, iops):
    """(bound_ms, bound_by): the least time the card could take for work
    that moves ``nbytes`` and does ``flops`` float and ``iops`` integer
    operations: the larger of the bytes over the memory rate
    ("bytes") and the operations' time ("operations").  The operations'
    time is the larger of two: the issue slots, which float and integer
    instructions share, with the float operations at the published
    float32 peak (two to a fused multiply-add, one slot) and each integer
    one a slot; and the integer operations over the INT32 lanes.  The
    kernels are built with --fmad=false, so they issue one instruction
    per float operation and can reach half the float rate counted here
    (``issue_bound_ms`` gives that figure)."""
    t_ops = max(flops / PEAK_FP32 + iops / PEAK_ISSUE, iops / PEAK_INT32)
    t_bytes = nbytes / PEAK_BYTES
    return ((1e3 * t_bytes, "bytes") if t_bytes > t_ops
            else (1e3 * t_ops, "operations"))


def issue_bound_ms(nbytes, flops, iops):
    """``bound``'s time with every float operation in an issue slot of
    its own, as the kernels' --fmad=false code issues it: what the
    uncontracted build could reach at best."""
    return 1e3 * max(nbytes / PEAK_BYTES, (flops + iops) / PEAK_ISSUE,
                     iops / PEAK_INT32)


def cand_model_work(w, p, cache):
    """(bytes, float operations) of one candidate-model launch on ``w``
    walkers: the anchors, the scene's candidate table (4 columns) and far
    table read once, the near, taylor and n_reach outputs written once;
    per walker 8 float operations of distance and 4K of insertion for
    each of the C candidates, 65 of Taylor parts for each of the C - K
    not selected, and 20 per far-table coefficient (its value, gradient
    and Hessian terms)."""
    c, k = cache.cand_table.shape[1], p.near_k
    nc = cache.far_coeffs.shape[1]
    nbytes = (4 * (3 + 4 * k + 10 + 1) * w + 4 * cache.cand_table.numel()
              + 4 * cache.far_coeffs.numel())
    return nbytes, w * (c * (8 + 4 * k) + (c - k) * 65 + 20 * nc)


def far_sums_work(w, n_pad, k):
    """(bytes, float operations, integer operations) of one far-sums
    launch: the table once, the anchors, the K near ids and the 10 sums
    per walker; 65 float operations per walker and table entry (the
    Taylor parts and their accumulation) and, per walker, one integer
    operation for each of the K ids it leaves out."""
    return 16 * n_pad + 4 * (3 + k + 10) * w, 65 * w * n_pad, k * w


def far_sums_bound(w, n_pad, k):
    """(bound_ms, bound_by) of one far-sums launch (``far_sums_work``)."""
    return bound(*far_sums_work(w, n_pad, k))


#: integer operations per walker of one Threefry-2x32-20 block
#: (field_math.cuh:threefry2x32_n): 20 rounds of add, rotate (one funnel
#: shift), xor; of each key injection only the add into x1, since
#: ``kb + (g + 1)`` is the same for every walker and ``x0 += ka`` folds
#: into the next round's add (one three-input add), plus the last
#: injection's add into x0.  The initial ``c1 + k1`` is the same on every
#: step of a walker and ``step + k0`` on every walker: none.
THREEFRY_IOPS = 20 * 3 + 5 + 1
#: integer operations per walker of one Philox4x32-10 block
#: (field_math.cuh:philox4x32_10): per round 2 mul.hi, 2 mul.lo and two
#: three-input xors (one LOP3 each); the key schedule is the same for
#: every walker (the key comes from the launch).  The counter is (step,
#: lane, block, 0), so only the lane is the walker's own: round 1 has 1
#: such operation, round 2 has 3, round 3 has 4, rounds 4-10 have 6.
PHILOX_IOPS = 1 + 3 + 4 + 7 * 6


def step_ops(phys, k):
    """(float, integer) operations of one walker-step of the chunk kernel
    in the mode of ``phys``, counted from csrc/field_math.cuh:run_steps
    (a multiply, add, compare, select or conversion is one operation; a
    transcendental one; work that is the same for every walker of the
    launch is not counted):

    * field at the new position (eval_field): 19 per near slot (offsets,
      d^2, rsqrt, r^-5, the masked term, the minimum) + 30 for the far
      Taylor polynomial; the move, in-cell test, kick, window sum: 25;
    * Threefry: three (four with reflection or the intended kick)
      blocks of ``THREEFRY_IOPS``, the uniforms (a shift each: 5, +1 for
      the coin, +1 for the kick; 5 conversions and scalings), the normal
      (6) and the cube direction with its inverse norm (13), escape
      tracking (9);
    * fast generator, per step half a step pair: two Philox4x32-10
      blocks (three with sphere directions and a variant) of
      ``PHILOX_IOPS``, the polynomial Box-Muller (40 per pair), the
      packed directions (6 integer, 16 float per pair), escape tracking
      every second (pfreq % 4 != 0) or fourth step;
    * variants: reflection 10, intended kick 12, gradient 7, sphere
      directions 12 (Threefry: per step; fast: the same per step)."""
    flops = 19 * k + 30 + 25
    iops = 0
    extra = int(phys.reflect) + int(phys.intended)
    if phys.fast_rng:
        blocks = 2 + int((8 if phys.sphere else 5) + 2 * extra > 8)
        iops += blocks * PHILOX_IOPS / 2 + 3
        flops += 20 + 8 + 9 / (2 if phys.pfreq % 4 else 4)
    else:
        iops += (4 if extra else 3) * THREEFRY_IOPS + 5 + extra
        flops += 5 + 6 + 13 + 9
    flops += (10 * phys.reflect + 12 * phys.intended + 7 * any(phys.gradient)
              + 12 * phys.sphere)
    return flops, iops


def chunk_bound(w, phys, n_pad=0, decompose=False):
    """(bound_ms, bound_by) of one chunk-kernel launch on ``w`` real
    walkers (the padding walkers are no work): the rebuild entry over an
    ``n_pad``-entry dipole table, or (``n_pad`` 0) the near entry.
    Bytes: the state in and out, escapes, coverage, the window output
    (warp sums, or the per-walker record in decompose mode), and the
    model (the table once; near and taylor per walker).  Operations:
    ``step_ops`` per walker-step (+1 float for the second accumulator in
    decompose mode), and in the rebuild entry the chunk-start selection
    over the table (8 + 4K per entry) and far sums (65 + K per entry)."""
    k = phys.near_k
    n_win = phys.chunk_steps // phys.pfreq
    rows = 8 if decompose else 6
    warps = -(-w // 32)
    wins = n_win * 2 * w if decompose else warps * n_win * 2
    nbytes = 4 * (2 * rows * w + w + warps + wins)
    f, i = step_ops(phys, k)
    flops = w * phys.chunk_steps * (f + decompose)
    iops = w * phys.chunk_steps * i
    if n_pad:
        nbytes += 16 * n_pad
        flops += w * n_pad * (8 + 4 * k + 65 + k)
    else:
        nbytes += 4 * (4 * k + 10) * w
    return bound(nbytes, flops, iops)


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
    chunk kernels (<K, fast generator, variants, decompose>) by mode, as
    their LAUNCHES keys; the candidate-model kernel (<K, high>) with
    "[order 8]" for its high-order twin; the others (<K>) by name."""
    if len(flags) == 3:
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
    for name in [*chunk_kernel.LAUNCHES, *split_names,
                 "cand_model_kernel[order 8]"]:
        ks = sorted(k for n, k in res if n == name)
        check(ks == list(range(1, 17)), f"{name}: built for K = {ks}")
        print(f"  {name} registers by K: "
              f"{' '.join(f'{k}:{res[name, k][0]}' for k in ks)}")
        print(f"  {name} K=5: {res[name, 5][1]}; K=10: {res[name, 10][1]}")
    secs = compile_seconds(chunk_kernel.build_log())
    print("  nvcc seconds by source: " + ", ".join(
        f"{s} {t:.1f}" for s, t in sorted(secs.items(), key=lambda x: -x[1])))
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
    main_bound = chunk_bound(args["num_water"], args["phys"], tbl.shape[1])
    lay = chunk_kernel.LAYOUTS["chunk_kernel"]
    check(lay.split and lay.blocks >= 120 and lay.waves == 1,
          f"headline layout {lay}")
    # the other side of the split layout's threshold: the flat layout
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    edge = chunk_kernel.split_threshold(sms, {
        "split": chunk_kernel.kernel_info("chunk_kernel", args["phys"],
                                          False, "split", tbl.shape[1])},
        args["phys"].fast_rng)
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
    layouts = layout_report(dev, p, tbl.shape[1], ctx["p"], res, label)
    big[0].update(layouts["chunk_near_kernel"])
    big[1].update(layouts["cand_model_kernel"])
    regs, spill = res["far_sums_kernel", ctx["p"].near_k]   # K 10
    big[2].update(registers=regs, spill_bytes=spill_bytes(spill))
    modes = mode_phases(dev, label, p, sc, ctx)
    fast_launches = fast_headline(runner, cos, label)
    arm_launches = golden_arms(label)
    near_launches = fast_scaleup(ctx, label)

    t0 = phase("13 imports")
    no_reference_imported()
    done(t0, "nothing of jax or of the JAX package imported")
    dec_modes = decompose_modes(dev, label, p, sc, ctx)
    dec_launches = decompose_headline(sc, ours, oracle, label)
    dec_launches.update(decompose_scaleup(ctx, label))

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
    }, *big, *new]
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
            if key == "chunk_near_kernel":   # compiled for one wave
                check(lay.blocks_per_sm >= 6 and lay.waves == 1,
                      f"{key}: scale-up layout {lay}")
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
                        plain_ms=plain, bound=chunk_bound(
                            args["num_water"], args["phys"], tbl.shape[1]))
    big = ctx["p"]
    for rng_impl, physics in (("hardware", lambda q: q),
                              ("threefry", all_variants),
                              ("hardware", all_variants)):
        cargs = dict(ctx["cargs"], phys=cuda_engine.chunk_physics(
            physics(big), rng_impl))
        near, taylor, planes = ctx["near"], ctx["taylor"], ctx["planes"]
        pos_err, win_err, plain = compare_near_chunk(planes, near, taylor,
                                                     cargs)
        ms = time_chunk(lambda: chunk_kernel.run_chunk_near(
            planes, near, taylor, **cargs), 3)
        key = chunk_kernel.chunk_mode("chunk_near_kernel", cargs["phys"])
        print(f"  {key}: one chunk ({cargs['num_water']} walkers, K="
              f"{big.near_k}) kernel {ms:.3f} ms, plain version "
              f"{plain:.1f} ms [{label}]", flush=True)
        out[key] = dict(pos_err=pos_err, win_err=win_err, k=big.near_k,
                        ms=ms, plain_ms=plain, bound=chunk_bound(
                            cargs["num_water"], cargs["phys"]))
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
    return {"chunk_kernel[fast]": got["chunk_kernel[fast]"]}


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
                        bound=chunk_bound(args["num_water"], args["phys"],
                                          tbl.shape[1], decompose=True))
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
                        bound=chunk_bound(fargs["num_water"], phys,
                                          decompose=True))
    done(t0, f"{len(out)} decompose modes [{label}]")
    return out


def split_line(st):
    return (f"run {st['wall_s']:.4f} s ({st['walker_steps_per_s']:.4e} "
            f"walker-steps/s), {st['sprints']} sprints: device "
            f"{st['device_s']:.4f} s, record copy {st['copy_s']:.4f} s, "
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


def decompose_headline(sc, direct_golden, oracle, label):
    """Phase 15: README configuration 5c through the port CLI at full
    width, the golden check of the Threefry decompose kernel, and the
    variants on the headline; returns the decompose launches of each
    path."""
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
        err = io.StringIO()
        reset_launches()
        with contextlib.redirect_stderr(err):
            rc = sim.main(argv)
        got = launches()
        text = err.getvalue()
        print("  " + "\n  ".join(ln for ln in text.splitlines()
                                  if "wrote" not in ln), flush=True)
        check(rc == 0, f"CLI exit {rc}")
        check(got == only(**{"chunk_kernel[fast+dec]": 500}),
              f"kernel launches {got}, expected 500 chunk_kernel[fast+dec]")
        out["chunk_kernel[fast+dec]"] = got["chunk_kernel[fast+dec]"]
        m = re.search(r"(\d+) chunk escapes, (\d+) coverage violations",
                      text)
        check(m is not None and m.groups() == ("0", "0"),
              "escapes or coverage violations")
        paths = sorted(glob.glob(os.path.join(tmp, "t2_mscale=*.csv")))
        check(len(paths) == 16, f"{len(paths)} CSVs, expected 16")
        curves = {}
        for path in paths:
            rows = read_t2_csv(path)
            check(len(rows[0]) == 2000, f"{path}: {len(rows[0])} rows")
            check(bool(np.isfinite(rows[1]).all()), f"{path}: non-finite")
            curves[os.path.basename(path)] = rows[1]
        with np.load(os.path.join(tmp, "rec.npz")) as z:
            keys = sorted(z.files)
            rec_shape = z["A"].shape
        check(keys == sorted(["times_ms", "A", "B", "params_fp", "mmoment",
                              "seed", "taucp", "tau", "pfreq"]),
              f"record keys {keys}")
        check(rec_shape == (2000, 4032), f"record A {rec_shape}")
        with open(os.path.join(tmp, "r2.csv")) as fh:
            r2 = fh.read().splitlines()
        check(len(r2) == 17, f"dispersion table of {len(r2)} lines")
        print(f"  16 CSVs x 2000 rows, record A/B {rec_shape}, dispersion "
              f"table of {len(r2) - 1} rows; launches {got}", flush=True)
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
    return out


def decompose_scaleup(ctx, label):
    """Phase 16: the scale-up with a streaming plane on the fast
    generator, then Threefry and every variant, each against a direct
    run; returns the decompose launches of each path."""
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
    return out


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
    near_bound = chunk_bound(fargs["num_water"], fargs["phys"])
    cand_work = cand_model_work(p.num_water, p, runner.cache)
    cand_bound = bound(*cand_work, 0)
    cand_issue = issue_bound_ms(*cand_work, 0)
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
    check(exact_launches == only(chunk_near_kernel=50, far_sums_kernel=50),
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
    far_bound = far_sums_bound(*far_shape)
    far_issue = issue_bound_ms(*far_sums_work(*far_shape))
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
               fargs=fargs)
    return ctx, [{
        "name": "chunk_near_kernel",
        "route": "cuda",
        "source": PKG + "chunk_kernel.cu",
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


if __name__ == "__main__":
    sys.exit(main())

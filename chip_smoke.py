#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

Drives the port's paths (the reference headline T2 run, and the 100k x
2000 scale-up run on the large-scene path) through the hand-written CUDA
kernels, phase by phase; each phase prints what it measured, and any
failure raises (exit code != 0, no final line):

1. device: the card, its power limit, the torch/CUDA versions;
2. build: compile every csrc/*.cu with nvcc (one process per source, in
   parallel), print seconds and registers/spills of every entry;
3. rebuild kernel vs plain version (engine/cuda_engine.chunk_reference)
   on the same CUDA inputs at the main path's shapes, 50 and 4032
   walkers: positions within 1e-4, window sums within 0.05, escapes and
   coverage equal, two kernel runs bitwise equal; times of both;
4. the main path at full width: SimulationRunner on the 4032-water,
   270-cell scene (seed 42), 2e6 steps, counting kernel launches;
5. physics at production width: the reference's own scene dump
   golden/testdata/scene_6000 (moment x60, 8 Carr-Purcell flips) against
   the reference oracle's curve, with the gates of
   tests/test_golden_full.py;
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
   Σcos/W within 1e-5 of phase 7's first 2e5 steps; then the far-sums
   kernel against its plain version at full width, with times of both;
9. the kernels line, then {"ok": true, "device": {...}}.

    python3 chip_smoke.py
"""

import json
import os
import re
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mri_nanoparticle_simulation_tpu.params import Params  # noqa: E402
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox  # noqa: E402
from mri_nanoparticle_simulation_tpu_torch.benchmark import (  # noqa: E402
    SCALEUP)
from mri_nanoparticle_simulation_tpu_torch.engine import (  # noqa: E402
    chunk_kernel, cuda_engine)
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
from mri_nanoparticle_simulation_tpu_torch.utils.device import (  # noqa: E402
    card_label, require_cuda)

POS_TOL = 1e-4     # tests/test_pallas.py:109-111, compiled kernel vs plain
WIN_TOL = 0.05
TAYLOR_TOL = 1e-5  # of the largest |component|; tests/test_fields.py:375
FAR_TOL = 1e-5     # relative, tests/test_fields.py:375
CURVE_TOL = 1e-5   # far table vs exact far sums, Σcos/W (1.563e-7 read)
TABLE_TOL = 1e-4   # f32 far table vs f64, of each coefficient's scale
LOW_TOL = 1e-9     # f64 degree 0-2 coefficients vs f64 far sums at centres
HEADLINE = dict(chunk_steps=4000, near_k=5)
PKG = "mri_nanoparticle_simulation_tpu_torch/csrc/"
REF = "mri_nanoparticle_simulation_tpu/"
REPLACES = REF + "engine/pallas_engine.py:171"


def phase(name):
    print(f"[{name}]", flush=True)
    return time.perf_counter()


def done(t0, msg):
    print(f"  {msg} ({time.perf_counter() - t0:.2f} s)", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def chunk_args(p, n_water, step0, tcp=None):
    return dict(step0=step0, key=key_words(7), lane_offset=0,
                num_water=n_water, tcp=p.tcp if tcp is None else tcp,
                cell_r2=cuda_engine.cell_r2_f32(p.cell_r), dstd=1.0,
                phys=cuda_engine.chunk_physics(p))


def compare_chunk(p, sc, dev, n_water, tcp=None):
    """One chunk of the kernel and of the plain version on the same
    CUDA input (the state after one kernel chunk from the start)."""
    st = init_state(sc.waters[:n_water], p, dev)
    planes = cuda_engine.to_soa(st, p).planes
    tbl = mnp_table(sc.mnps, torch.float32, dev).tbl
    planes, *_ = chunk_kernel.run_chunk(
        planes, tbl, **chunk_args(p, n_water, 0, tcp))
    args = chunk_args(p, n_water, p.chunk_steps, tcp)
    before = chunk_kernel.LAUNCHES["chunk_kernel"]
    k1 = chunk_kernel.run_chunk(planes, tbl, **args)
    k2 = chunk_kernel.run_chunk(planes, tbl, **args)
    torch.cuda.synchronize()
    check(chunk_kernel.LAUNCHES["chunk_kernel"] == before + 2,
          "LAUNCHES did not count")
    for a, b in zip(k1, k2):
        check(torch.equal(a, b), "two kernel runs differ")
    ref = cuda_engine.chunk_reference(planes, tbl, **args)
    out, esc, cov, wins = k1
    r_out, r_esc, r_cov, r_wins = ref
    pos_err = (out[:3, :n_water] - r_out[:3, :n_water]).abs().max().item()
    phase_err = (out[4, :n_water] - r_out[4, :n_water]).abs().max().item()
    win_err = (wins.sum(0) - r_wins.sum(0)).abs().max().item()
    incell_diff = int((out[3] != r_out[3]).sum())
    print(f"  {n_water} walkers: |pos| err {pos_err:.3e} (tol {POS_TOL}), "
          f"|phase| err {phase_err:.3e}, |wins| err {win_err:.3e} (tol "
          f"{WIN_TOL}), in-cell flags differing {incell_diff}, escapes "
          f"{int(esc.sum())}/{int(r_esc.sum())}, coverage "
          f"{int(cov.sum())}/{int(r_cov.sum())}", flush=True)
    check(pos_err < POS_TOL, f"positions differ by {pos_err}")
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


def ptxas_resources(log):
    """{(kernel, K): (registers, spill line)} from the -Xptxas -v log:
    "Compiling entry function NAME", "Function properties for NAME", its
    stack/spill line, then "Used N registers" for the entry."""
    out, entry, props, spill = {}, None, None, {}
    pat = re.compile(r"([a-z_]+_kernel)ILi(\d+)E")
    for ln in log.splitlines():
        m = pat.search(ln)
        key = (m.group(1), int(m.group(2))) if m else None
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


def time_chunk(fn, n):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()                                  # warm-up
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


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
    chunk_kernel.load_library()
    res = ptxas_resources(chunk_kernel.build_log())
    for name in ("chunk_kernel", "chunk_near_kernel", "cand_model_kernel",
                 "far_sums_kernel"):
        ks = sorted(k for n, k in res if n == name)
        check(ks == list(range(1, 17)), f"{name}: built for K = {ks}")
        print(f"  {name} registers by K: "
              f"{' '.join(f'{k}:{res[name, k][0]}' for k in ks)}")
        print(f"  {name} K=5: {res[name, 5][1]}; K=10: {res[name, 10][1]}")
    done(t0, f"built {chunk_kernel.library_path().name} with "
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
    plain_ms = time_chunk(
        lambda: cuda_engine.chunk_reference(planes, tbl, **args), 1)
    done(t0, f"one chunk (4032 walkers, K=5, 4000 steps): kernel "
         f"{kernel_ms:.3f} ms, plain version {plain_ms:.1f} ms [{label}]")

    t0 = phase("4 main path, full width")
    runner = SimulationRunner(Params(**HEADLINE), scene_seed=42, seed=7,
                              device="cuda")
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
    check(main_launches == {"chunk_kernel": 500, "chunk_near_kernel": 0,
                            "cand_model_kernel": 0, "far_sums_kernel": 0},
          f"kernel launches {main_launches}, expected 500 rebuild")
    check(bool(np.isfinite(cos).all() and np.isfinite(sin).all()),
          "non-finite window sums")
    check(float(np.abs(cos).max()) <= 4032.0, "|sum cos| > num_water")
    check(np.allclose(rows[1], cos), "CSV disagrees with the run")
    done(t0, f"2e6 steps x 4032 walkers: {stats['walker_steps_per_s']:.4e} "
         f"walker-steps/s, wall {stats['wall_s']:.3f} s, "
         f"{main_launches['chunk_kernel']} launches, final sum cos/W "
         f"{cos[-1] / 4032:.6f} [{label}]")

    t0 = phase("5 golden scene 6000 at production width")
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import argparse
    import dataclasses

    import golden_paired as gp
    gargs = argparse.Namespace(steps=gp.STEPS, tcp=gp.TCP, mscale=gp.MSCALE,
                               fw_reps=1, reflect=None, kick="aswritten",
                               gradient=0.0)
    gpar = gp.framework_params(gargs)
    testdata = os.path.join(ROOT, "golden", "testdata")
    scene = gp.load_scene(os.path.join(testdata, "scene_6000"), gpar)
    check(len(scene.mnps) == 745, f"{len(scene.mnps)} dipoles")
    mnps = scene.mnps.copy()
    mnps[:, 4] *= gp.MSCALE
    scene = dataclasses.replace(scene, mnps=mnps)
    oracle = np.loadtxt(os.path.join(testdata, "paired_6000.csv"),
                        delimiter=",")[:, 1] / gp.N_WATER
    grun = SimulationRunner(gpar, seed=gp.FW_RUN0, device="cuda",
                            scene=scene)
    _, gcos, _, gstats = grun.run(progress=False, max_steps=gp.STEPS)
    ours = gcos / gp.N_WATER
    n = min(len(oracle), len(ours))
    check(n == gp.STEPS // gp.PFREQ, f"{n} windows")
    diff = oracle[:n] - ours[:n]
    rms = float(np.sqrt(np.mean(diff ** 2)))
    print(f"  rms {rms:.5f} (gate 0.025), final diff {diff[-1]:+.5f} "
          f"(gate 0.060), finals oracle {oracle[n - 1]:.4f} port "
          f"{ours[n - 1]:.4f} (gate < 0.45), escapes {gstats['escapes']}, "
          f"coverage {gstats['coverage_violations']}", flush=True)
    check(rms < 0.025, f"golden rms {rms}")
    check(abs(diff[-1]) < 0.060, f"golden final diff {diff[-1]}")
    check(oracle[n - 1] < 0.45 and ours[n - 1] < 0.45,
          "deep-decay regime not reached")
    done(t0, f"{gstats['walker_steps_per_s']:.4e} walker-steps/s "
         f"[{label}]")

    big = large_scene_phases(dev, label)

    jax_mods = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
    check(not jax_mods, f"jax was imported: {jax_mods[:5]}")
    print(f"[9 total {time.perf_counter() - t_all:.1f} s, no jax imported]")
    print(json.dumps({"kernels": [{
        "name": "chunk_kernel",
        "route": "cuda",
        "source": PKG + "chunk_kernel.cu",
        "replaces": REPLACES,
        "launches": main_launches["chunk_kernel"],
        "max_abs_err": max(pos50, pos_err),
        "max_abs_err_wins": max(win50, win_err),
        "tolerance": {"positions": POS_TOL, "window_sums": WIN_TOL},
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, *big]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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


def compare_cand_model(pos, p, cache, reach2):
    """Kernel 2 and its plain version on the same anchors ``pos``;
    returns (near, taylor, max taylor error over its scale, slots
    differing, plain ms)."""
    k1 = expansion.build_planes(pos, p, cache, reach2=reach2)
    k2 = expansion.build_planes(pos, p, cache, reach2=reach2)
    ref, plain_ms = timed(lambda: expansion.cand_model_reference(
        pos, cache.payload, cache.far_coeffs, near_k=p.near_k,
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
    """Kernel 3 and its plain version; returns (relative error, plain
    ms)."""
    f1 = chunk_kernel.run_far_sums(pos, tbl, idx)
    f2 = chunk_kernel.run_far_sums(pos, tbl, idx)
    fref, plain_ms = timed(lambda: expansion.far_sums_reference(pos, tbl,
                                                                idx))
    check(torch.equal(f1, f2), "two far-sums runs differ")
    ferr = scale_err(f1, fref)
    check(ferr < FAR_TOL, f"far sums differ by {ferr} relative")
    check(bool(torch.isfinite(f1).all()), "non-finite far sums")
    print(f"  far sums, {pos.shape[1]} walkers: err {ferr:.3e} relative "
          f"(tol {FAR_TOL}); plain {plain_ms:.2f} ms", flush=True)
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
    check(win_err < WIN_TOL, f"1c window sums differ by {win_err}")
    check(torch.equal(esc, cref[1]), "1c escapes differ")
    check(float(cov.abs().sum()) == 0.0, "1c coverage output not zero")
    check(bool(torch.isfinite(out).all()), "non-finite 1c state")
    print(f"  near/taylor chunk, {n} walkers, K={near.shape[1]}: |pos| err "
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
    """Phases 6-8; returns the kernels-line entries of kernels 1c, 2, 3."""
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
    cache = expansion.SceneCache(cache.payload, coeffs)
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
    runner = SimulationRunner(p, scene_seed=42, seed=7, device="cuda")
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
    check(big_launches == {"chunk_kernel": 0, "chunk_near_kernel": 500,
                           "cand_model_kernel": 500, "far_sums_kernel": 0},
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
    done(t0, f"per chunk at {fpos.shape[1]} walkers: candidate-model "
         f"{cand_ms:.4f} ms (plain {cand_plain_ms:.2f} ms), near/taylor "
         f"chunk {near_ms:.3f} ms (plain {near_plain_ms:.1f} ms) [{label}]")

    t0 = phase("8 scale-up, far_table_order=0 (far-sums kernel)")
    p0 = p.replace(far_table_order=0)
    runner0 = SimulationRunner(p0, scene_seed=42, seed=7, device="cuda")
    check(runner0.uses_cubes and runner0.cache.far_coeffs is None,
          "the order-0 runner has a far table")
    reset_launches()
    _, cos0, _, stats0 = runner0.run(progress=False, max_steps=200_000)
    exact_launches = launches()
    check(exact_launches == {"chunk_kernel": 0, "chunk_near_kernel": 50,
                             "cand_model_kernel": 0, "far_sums_kernel": 50},
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
    # final state
    apos = wrapped(cuda_engine.to_soa(runner0.state, p0).planes)[:3]
    apos = apos.contiguous()
    idx0 = cube_ids(apos, runner0.cache.payload)
    ferr_full, far_plain_ms = compare_far_sums(apos, runner0.mnp_tbl.tbl,
                                               idx0)
    far_ms = time_chunk(lambda: chunk_kernel.run_far_sums(
        apos, runner0.mnp_tbl.tbl, idx0), 5)
    done(t0, f"far sums at {apos.shape[1]} walkers {far_ms:.3f} ms (plain "
         f"{far_plain_ms:.2f} ms) [{label}]")

    return [{
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
    }, {
        "name": "far_sums_kernel",
        "route": "cuda",
        "source": PKG + "far_sums_kernel.cu",
        "replaces": REF + "fields/expansion.py:358",
        "launches": exact_launches["far_sums_kernel"],
        "max_abs_err": max(ferr, ferr_full),
        "tolerance": {"relative": FAR_TOL},
        "ms": far_ms,
        "plain_ms": far_plain_ms,
    }]


if __name__ == "__main__":
    sys.exit(main())

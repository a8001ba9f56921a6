"""Benchmark: walker-steps/s of the port on the reference headline run.

Runs the headline configuration (4032 waters, 270 cells at scene seed 42,
chunk 4000, near_k 5, 2e6-step sprints, Threefry) through the port's
sprint on one CUDA card, times whole sprints with CUDA events after a
warm-up sprint, and prints ONE JSON line:

    {"metric": "walker_steps_per_sec", "value": ..., "unit":
     "walker-steps/s", "vs_baseline": ..., "device": {...},
     "detail": {..., "scaleup": {...}}}

``vs_baseline`` is the speedup over the reference's Tesla K40 (~1.9e8
walker-steps/s, BASELINE.md).  ``device.label`` is the card's name and
power limit from nvidia-smi.  ``detail.scaleup`` is the same measurement
on the scale-up configuration of the reference's benchmark
(benchmark.py:156-159: 100000 waters, 2000 cells, tau 5e-7, K 10, C 32,
chunk 4000, far-table order 5), here with Threefry, which runs the
large-scene path (candidate-model kernel + near/taylor chunk kernel).
The headline value and ``detail.scaleup`` run Threefry, the generator
of the port's earlier figures; ``detail.fast_rng`` holds both runs on
the fast generator (the runner's default).  Without a card it raises.

Two further modes print one JSON line each:

* ``--profile [--far-table-order N]``: the scale-up path's device time
  per kernel over 20 chunks (torch.profiler), and its device idle share
  (one minus the traced device time over the wall time of the same
  traced chunks); at order 0 the path of the exact far sums;
* ``--rebuild-ms [DIR]``: the ms per launch of the candidate-model
  kernel (``build_planes``: K 10, C 32, far-table order 5; the walkers
  in the scene's order and shuffled) and of the far-sums kernel (5256
  dipoles, K 10) at the scale-up width (100096 walkers, the initial
  walkers' anchors), 7 rounds of 20 launches, with the far sums' SASS
  pair loop (``sass_loop``: its instructions for its pairs); the ms of
  a chunk of the scale-up's order-0 sprints (the near entry, the cube
  selection and the far sums; 7 rounds of 10 chunks, wall between CUDA
  events), in turns three times over; then
  the chunk kernel's ms per chunk in every mode of both entries: the
  rebuild entry at the headline shape (4032 walkers, K 5) and the near
  entry at the scale-up width (100096 walkers, K 10), 4000 steps, 7 rounds
  of 10 launches, with the layout each launch took (and the SASS step
  loops in the two default modes: the near entry's, and the split
  kernel's chain and field warps', ``sass_loop``); then the rebuild
  entry on the headline's scene at the widths of ``REBUILD_WIDTHS`` (both
  sides of the split layout's threshold, up to a 100k-walker small scene)
  in both its layouts.  Each round runs between two CUDA events behind a
  sleep of the stream, so it times the device and not the host's calls.
  With DIR, the port's package of the checkout at DIR (e.g. the parent
  commit, unpacked with ``git archive``) is loaded beside this one and
  timed in turns on the same inputs: DIR, this, this, DIR (at the
  widths each tree in both layouts: DIR flat, this flat, this split, DIR
  split, and back).

    python -m mri_nanoparticle_simulation_tpu_torch.benchmark [--profile
        [--far-table-order N] | --rebuild-ms [DIR]]
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from .engine import chunk_kernel, convert, cuda_engine, reference_engine
from .engine.convert import key_words, mnp_table
from .engine.reference_engine import init_state
from .fields import expansion
from .params import Params
from .scene import BacteriaBox
from .utils.device import card_label, require_cuda

#: the reference's Tesla K40 on the headline run, walker-steps/s
#: (BASELINE.md: 4032 walkers x 4e7 steps in ~14 min)
K40_BASELINE = 1.9e8


#: 2e6-step sprints timed after the warm-up sprint
N_SPRINTS = 2
#: the reference benchmark's scale-up Params (benchmark.py:156-159)
SCALEUP = dict(num_water=100_000, num_cells=2000, tau=5e-7,
               sprint_steps=20_000, mmoment=3.5e-17, water_start_bound=28.0,
               max_neighbors=24, near_k=10, cube_candidates=32,
               chunk_steps=4000)
#: the background gradient of the every-variant runs, T/µm (the golden
#: gradient arm's)
GRADIENT = (0.0, 0.0, 3e-5)
#: 2e4-step scale-up sprints timed after the warm-up sprint
N_SCALEUP_SPRINTS = 10
#: scale-up sprints (5 chunks each) traced by --profile
N_PROFILE_SPRINTS = 4
#: order-0 scale-up sprints (5 chunks each) a round of --rebuild-ms
N_ORDER0_SPRINTS = 2
#: times --rebuild-ms runs the order-0 sprints in turns (DIR, this,
#: this, DIR each time)
ORDER0_TURNS = 3
#: GPU cycles the stream sleeps before a timed round (``time_on_device``;
#: ~5 ms at 1.98 GHz): the host queues the round's launches meanwhile,
#: so the events time the device alone (a candidate-model launch is
#: shorter on the card than its call on the host)
SLEEP_CYCLES = 10_000_000
#: walkers at which --rebuild-ms times the rebuild entry in both layouts:
#: on a 132-SM card within the split layout's first wave (8448 walkers
#: at two blocks per SM), just above it, between its second and third
#: waves, just above its second, then a wider width and a 100k-walker
#: small scene
REBUILD_WIDTHS = (4352, 8576, 12800, 17024, 33792, 100000)
#: the mangled name of the far-sums kernel at the scale-up's K, whose
#: SASS pair loop ``sass_loop`` reads
FAR_SUMS_K10 = "far_sums_kernelILi10E"
#: the mangled names of the near entry's K-10 kernels with the default
#: physics, by generator (fast_rng), whose SASS step loop ``sass_loop``
#: reads (a step pair on the fast generator)
NEAR_K10 = {False: "chunk_near_kernelILi10ELb0ELb0ELb0E",
            True: "chunk_near_kernelILi10ELb1ELb0ELb0E"}
#: the same of the split kernel's K-5 kernels (the headline), whose walker
#: warps' step loops ``sass_loop`` reads: the chain warp's, the one loop
#: that stores the hand-off and reads the ring without an rsqrt, and the
#: field warp's, the one that takes rsqrt of what it reads and stores
#: nothing (the generator warps' loops read no shared memory, and the far
#: parts' loop both takes rsqrt and stores)
SPLIT_K5 = {False: "chunk_split_kernelILi5ELb0ELb0ELb0E",
            True: "chunk_split_kernelILi5ELb1ELb0ELb0E"}
CHAIN_LOOP = dict(ops=("STS", "LDS"), without=("MUFU.RSQ",))
FIELD_LOOP = dict(ops=("MUFU.RSQ", "LDS"), without=("STS",))
_GENERATOR = {cuda_engine.RNG_THREEFRY: "Threefry-20",
              cuda_engine.RNG_HARDWARE: "fast generator (Philox4x32-10)"}


def all_variants(p: Params) -> Params:
    """``p`` with every physics variant on: the intended kick with
    sphere directions, permeable membranes and a z gradient."""
    return p.replace(kick_mode="intended", direction_mode="sphere",
                     b0_gradient=GRADIENT).with_permeability().validate()


def _timed_sprints(sprint, n, ss, *args, **kw):
    """``n`` sprints between two CUDA events; returns (seconds, state,
    last window sums)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        ss, wins = sprint(*args, ss, **kw)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3, ss, wins


def _scaleup_setup(rng_impl: str = cuda_engine.RNG_THREEFRY,
                   order: int = 5):
    """The scale-up scene, its table and cache (far table of ``order``;
    none at 0) on the card, its sprint and the state after one warm-up
    sprint."""
    dev = require_cuda()
    p = Params(**SCALEUP, far_table_order=order).validate()
    sc = BacteriaBox(p, seed=42).populate()
    tbl = mnp_table(sc.mnps, torch.float32, dev)
    chunk_kernel.load_library()
    t0 = time.perf_counter()
    cache = expansion.build_cache(tbl.pos, tbl.m, p)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    key = key_words(7)
    sprint = cuda_engine.make_sprint_fn(p, p.num_water, dev,
                                        rng_impl=rng_impl)
    ss = cuda_engine.to_soa(init_state(sc.waters, p, dev), p)
    ss, _ = sprint(tbl, key, ss, cache=cache)        # warm-up
    torch.cuda.synchronize()
    return p, sc, tbl, cache, cache_s, key, sprint, ss


def scaleup_rate(rng_impl: str = cuda_engine.RNG_THREEFRY) -> dict:
    """Walker-steps/s of the large-scene path at full width."""
    p, sc, tbl, cache, cache_s, key, sprint, ss = _scaleup_setup(rng_impl)
    seconds, ss, wins = _timed_sprints(sprint, N_SCALEUP_SPRINTS, ss, tbl,
                                       key, cache=cache)
    rate = N_SCALEUP_SPRINTS * p.sprint_steps * p.num_water / seconds
    return {
        "config": "100000 waters x 2000 cells (scene seed 42, "
                  f"{len(sc.mnps)} dipoles), tau 5e-7, K 10, C 32, chunk "
                  f"4000, far-table order 5, {_GENERATOR[rng_impl]}, "
                  "2e4-step sprints",
        "walker_steps_per_sec": rate,
        "sprints_timed": N_SCALEUP_SPRINTS,
        "seconds": seconds,
        "cache_build_s": cache_s,
        "escapes": int(ss.escapes),
        "coverage_violations": int(ss.coverage),
        "sum_cos_per_walker": float(wins[-1, 0]) / p.num_water,
    }


def scaleup_profile(top: int = 12, order: int = 5) -> dict:
    """Device time per kernel of the scale-up path at far-table order
    ``order`` (torch.profiler over ``N_PROFILE_SPRINTS`` sprints), and
    the device idle share against the wall time of those same traced
    sprints, which ends in a device sync.  At order 0 every chunk runs
    the cube selection of the near ids in torch, the far-sums kernel and
    the near entry."""
    from torch.profiler import ProfilerActivity, profile

    p, _, tbl, cache, _, key, sprint, ss = _scaleup_setup(order=order)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(N_PROFILE_SPRINTS):
            ss, _ = sprint(tbl, key, ss, cache=cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the kernels themselves: the CPU-side ops that launched them carry
    # the same device time again
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in rows)
    if not device_us:
        raise RuntimeError("the profiler recorded no device time")
    rows.sort(key=lambda e: -e.self_device_time_total)
    return {
        "config": "scale-up path, 100000 waters, K 10, far-table order "
                  f"{order}, Threefry",
        "label": card_label(),
        "chunks": N_PROFILE_SPRINTS * p.sprint_steps // p.chunk_steps,
        "traced_wall_s": wall,
        "device_us": device_us,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "kernels": [{"name": e.key[:100], "calls": e.count,
                     "us": e.self_device_time_total,
                     "share": e.self_device_time_total / device_us}
                    for e in rows[:top]],
    }


def _load_tree(root: str, alias: str):
    """The port's package of the checkout at ``root``, imported under
    ``alias`` beside this one (its kernels build in that checkout)."""
    pkg = Path(root).resolve() / "mri_nanoparticle_simulation_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return alias


def _chunk_cases(dev) -> dict:
    """The chunk-kernel calls ``--rebuild-ms`` times, as functions of a
    tree's ``chunk_kernel`` module, by ``LAUNCHES`` key: every mode of
    the rebuild entry at the headline shape (4032 walkers, 716 dipoles,
    K 5) and of the near entry at the scale-up width (100096 walkers,
    K 10, the model of the initial walkers), each one 4000-step chunk on
    inputs built once by this tree, so every tree runs the same launches.
    The variant modes have every variant on (``all_variants``)."""
    hp = Params(chunk_steps=4000, near_k=5).validate()
    hsc = BacteriaBox(hp, seed=42).populate()
    tbl = mnp_table(hsc.mnps, torch.float32, dev).tbl
    sp = Params(**SCALEUP).validate()
    ssc = BacteriaBox(sp, seed=42).populate()
    stbl = mnp_table(ssc.mnps, torch.float32, dev)
    cache = expansion.build_cache(stbl.pos, stbl.m, sp)
    splanes = cuda_engine.to_soa(init_state(ssc.waters, sp, dev), sp).planes
    splanes = torch.cat([cuda_engine._wrap(splanes[:3], sp.bound),
                         splanes[3:]])
    near, taylor, _ = expansion.build_planes(
        splanes[:3].contiguous(), sp, cache,
        reach2=expansion.coverage_reach2(sp))
    planes = {}
    for dec in (False, True):
        st = init_state(hsc.waters, hp, dev, decompose=dec)
        planes["chunk_kernel", dec] = cuda_engine.to_soa(st, hp).planes
        planes["chunk_near_kernel", dec] = (
            torch.cat([splanes, 0.5 * splanes[4:6]]).contiguous() if dec
            else splanes)

    cases = {}
    for entry, p in (("chunk_kernel", hp), ("chunk_near_kernel", sp)):
        for variants in (False, True):
            pm = all_variants(p) if variants else p
            for dec in (False, True):
                for rng_impl in (cuda_engine.RNG_THREEFRY,
                                 cuda_engine.RNG_HARDWARE):
                    a = dict(step0=p.chunk_steps, key=key_words(7),
                             lane_offset=0, num_water=p.num_water,
                             tcp=p.tcp,
                             cell_r2=cuda_engine.cell_r2_f32(pm.cell_r),
                             dstd=1.0, decompose=dec,
                             phys=cuda_engine.chunk_physics(pm, rng_impl))
                    pl = planes[entry, dec]
                    mode = chunk_kernel.chunk_mode(entry, a["phys"], dec)
                    cases[mode] = (
                        (lambda ck, a=a, pl=pl: ck.run_chunk(pl, tbl, **a))
                        if entry == "chunk_kernel" else
                        (lambda ck, a=a, pl=pl: ck.run_chunk_near(
                            pl, near, taylor, **a)))
    return cases


def _model_cases(dev):
    """(walkers, calls): the large-scene model kernels' calls
    ``--rebuild-ms`` times, as functions of a tree (its ``ck``:
    ``engine.chunk_kernel``, ``exp``: ``fields.expansion``), by
    ``LAUNCHES`` key, on inputs built once by this tree at the scale-up
    width (100096 walkers, the initial walkers' wrapped anchors): the
    candidate model through ``build_planes`` (the scene cache as the
    tree's ``SceneCache`` of the same tables), once with the anchors in
    the scene's order (Morton order, so a warp's walkers share cubes) and
    once in a random order from a seed (``[shuffled]``: as after a long
    run, when the walkers have mixed, each warp reading 32 cubes' rows);
    the far sums over the 5256-entry table without each walker's K
    cube-selected ids."""
    sp = Params(**SCALEUP).validate()
    sc = BacteriaBox(sp, seed=42).populate()
    tbl = mnp_table(sc.mnps, torch.float32, dev)
    cache = expansion.build_cache(tbl.pos, tbl.m, sp)
    planes = cuda_engine.to_soa(init_state(sc.waters, sp, dev), sp).planes
    pos = cuda_engine._wrap(planes[:3], sp.bound).contiguous()
    mixed = pos[:, torch.randperm(pos.shape[1], generator=torch.Generator()
                                  .manual_seed(7)).to(dev)].contiguous()
    reach2 = expansion.coverage_reach2(sp)
    rows, _ = expansion.cube_select(pos.T, cache.payload, sp)
    idx = rows[..., 4].to(torch.int32).T.contiguous()

    def cand(anchors):
        def call(tree):
            tc = tree.exp.SceneCache(*(getattr(cache, f)
                                       for f in tree.exp.SceneCache._fields))
            return tree.exp.build_planes(anchors, sp, tc, reach2)
        return call
    return pos.shape[1], {
        "cand_model_kernel": cand(pos),
        "cand_model_kernel[shuffled]": cand(mixed),
        "far_sums_kernel": lambda tree: tree.ck.run_far_sums(pos, tbl.tbl,
                                                             idx)}


def sass_loop(ck, kernel: str, ops=("MUFU.RSQ",), without=()) -> dict:
    """The innermost loop that holds an instruction of each opcode of
    ``ops`` (a reciprocal square root, MUFU.RSQ, unless asked otherwise)
    and none of ``without``, in the SASS (``cuobjdump -sass`` beside nvcc)
    of the entry whose mangled name holds ``kernel``, in the library of
    ``ck`` (a tree's ``engine.chunk_kernel``, built here if it is not):
    ``innermost_loop`` of its text.  In the far-sums kernel that loop is
    the pair loop, one MUFU.RSQ a (walker, dipole) pair; in a chunk kernel
    the step loop (the near entry: a step on Threefry, a step pair on the
    fast generator; the split kernel's walker warps, ``SPLIT_K5``: the
    chain warp's with ``CHAIN_LOOP``, the field warp's with
    ``FIELD_LOOP``)."""
    ck.build()
    name = re.search(r"Compiling entry function '(\w*" + kernel + r"\w*)'",
                     ck.build_log()).group(1)
    tool = Path(ck._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", "-fun", name,
                           str(ck.library_path())], capture_output=True,
                          text=True, check=True).stdout
    try:
        return innermost_loop(sass, ops, without)
    except ValueError as e:
        raise RuntimeError(f"{e} in the SASS of {name}") from None


def split_step_loops(ck, fast: bool) -> dict:
    """The split kernel's walker warps' step loops at K 5 in the default
    physics (``SPLIT_K5``), in the library of ``ck``: the chain warp's and
    the field warp's ``sass_loop``, each with its instructions a step (the
    chain warp stores 2 K + 4 floats a step, the field warp takes K
    rsqrt; the compiler unrolls both loops)."""
    k = 5
    chain = sass_loop(ck, SPLIT_K5[fast], **CHAIN_LOOP)
    field = sass_loop(ck, SPLIT_K5[fast], **FIELD_LOOP)
    return {"chain": {**chain, "per_step": chain["instructions"] * (2 * k + 4)
                      / chain["counts"]["STS"]},
            "field": {**field, "per_step": field["instructions"] * k
                      / field["counts"]["MUFU.RSQ"]}}


def innermost_loop(sass: str, ops=("MUFU.RSQ",), without=()) -> dict:
    """The innermost loop (a backward branch and the instructions from
    its target to it) that holds, in the SASS text ``sass``, an
    instruction whose opcode starts with each of ``ops`` and none that
    starts with one of ``without``: its instructions (as written, each
    once: a loop nested in it counts once, and a branch never taken counts
    too), its MUFU.RSQ, and the instructions of each loop nested in it
    (``inner``), with ``counts``, the instructions of each opcode of
    ``ops``, where others than a MUFU.RSQ are asked for; the smallest such
    loop where there are several, and every one of them, in address
    order, as ``copies`` (the near entry's Threefry kernel holds two
    copies of its step loop: the rounds of Threefry-20 unrolled, and the
    rounds as a loop for any other count)."""
    ins = [(int(a, 16), op) for a, op in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass)]
    loops = []
    for addr, op in ins:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            loops.append((lo, addr, [re.sub(r"^@!?U?P[T0-9]+\s+", "",
                                            o.strip())
                                     for a, o in ins if lo <= a <= addr]))

    def within(inner, outer):
        return inner != outer and outer[0] <= inner[0] and inner[1] <= outer[1]

    def count(lp, prefix):
        return sum(o.startswith(prefix) for o in lp[2])
    held = [lp for lp in loops if all(count(lp, p) for p in ops)
            and not any(count(lp, p) for p in without)]
    default = tuple(ops) == ("MUFU.RSQ",) and not without
    copies = [{"instructions": len(lp[2]), "rsqrt": count(lp, "MUFU.RSQ"),
               **({} if default else {"counts": {p: count(lp, p)
                                                 for p in ops}}),
               "inner": [len(n[2]) for n in loops if within(n, lp)]}
              for lp in sorted(held, key=lambda lp: lp[:2])
              if not any(within(n, lp) for n in held)]
    if not copies:
        raise ValueError("no loop with " + " and ".join(
            f"a {p}" for p in ops) + "".join(f" and no {p}" for p in without))
    best = min(copies, key=lambda c: c["instructions"])
    return {**best, "copies": copies}


def time_on_device(fn, n: int) -> float:
    """ms per call of ``fn`` on the device: ``n`` calls between two CUDA
    events behind a sleep of the stream, so that the host has queued them
    all before the first starts and the events time the card alone.
    Whether it had is read from the start event once they are queued: if
    the sleep had already ended, the round is timed again behind a sleep
    8 times as long, and if that ends too soon as well, it raises."""
    for cycles in (SLEEP_CYCLES, 8 * SLEEP_CYCLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / n
    raise RuntimeError(f"the host took longer to queue {n} calls than the "
                       f"stream slept ({8 * SLEEP_CYCLES} cycles)")


def _chunk_timer(ck, call, rounds: int, launches: int):
    """A function timing ``rounds`` x ``launches`` calls of ``call(ck)``
    (``time_on_device``); returns ms per launch for each round."""
    call(ck)                                     # build, load, warm up
    torch.cuda.synchronize()
    return lambda: [time_on_device(lambda: call(ck), launches)
                    for _ in range(rounds)]


def _order0_timer(tree, dev, rounds: int):
    """A function timing ``rounds`` rounds of ``N_ORDER0_SPRINTS``
    scale-up sprints (2e4 steps, 5 chunks each; Threefry) at far-table
    order 0 through a tree's sprint (``tree.ce``: its
    ``engine.cuda_engine``, ``cv``: ``engine.convert``, ``ri``:
    ``engine.reference_engine``, ``exp``: ``fields.expansion``), from
    the scene's initial walkers after one warm-up sprint; returns the ms
    of a chunk for each round.  A round runs between two CUDA events with
    no sleep of the stream, so the host's share of the path (the cube
    selection's torch calls) counts as it does in a run."""
    p = Params(**SCALEUP, far_table_order=0).validate()
    sc = BacteriaBox(p, seed=42).populate()
    tbl = tree.cv.mnp_table(sc.mnps, torch.float32, dev)
    cache = tree.exp.build_cache(tbl.pos, tbl.m, p)
    key = tree.cv.key_words(7)
    sprint = tree.ce.make_sprint_fn(p, p.num_water, dev)
    box = [tree.ce.to_soa(tree.ri.init_state(sc.waters, p, dev), p)]
    box[0], _ = sprint(tbl, key, box[0], cache=cache)     # warm-up
    torch.cuda.synchronize()
    chunks = N_ORDER0_SPRINTS * p.sprint_steps // p.chunk_steps

    def timer():
        ms = []
        for _ in range(rounds):
            seconds, box[0], _ = _timed_sprints(
                sprint, N_ORDER0_SPRINTS, box[0], tbl, key, cache=cache)
            ms.append(1e3 * seconds / chunks)
        return ms
    return timer


def _width_cases(dev) -> list:
    """The rebuild entry's calls at ``REBUILD_WIDTHS``: every mode on the
    headline's scene (K 5) with its walkers widened, as (mode, walkers,
    the call through a tree's ``run_chunk``, the call of this tree in a
    forced layout)."""
    wp = Params(chunk_steps=4000, near_k=5,
                num_water=max(REBUILD_WIDTHS)).validate()
    sc = BacteriaBox(wp, seed=42).populate()
    tbl = mnp_table(sc.mnps, torch.float32, dev).tbl
    cases = []
    for variants in (False, True):
        pm = all_variants(wp) if variants else wp
        for dec in (False, True):
            for rng_impl in (cuda_engine.RNG_THREEFRY,
                             cuda_engine.RNG_HARDWARE):
                phys = cuda_engine.chunk_physics(pm, rng_impl)
                for n in REBUILD_WIDTHS:
                    pl = cuda_engine.to_soa(init_state(
                        sc.waters[:n], wp, dev, decompose=dec), wp).planes
                    a = dict(step0=wp.chunk_steps, key=key_words(7),
                             lane_offset=0, num_water=n, tcp=wp.tcp,
                             cell_r2=cuda_engine.cell_r2_f32(pm.cell_r),
                             dstd=1.0, phys=phys)
                    cases.append((
                        chunk_kernel.chunk_mode("chunk_kernel", phys, dec),
                        n,
                        lambda ck, a=a, pl=pl, dec=dec: ck.run_chunk(
                            pl, tbl, decompose=dec, **a),
                        lambda kind, a=a, pl=pl, dec=dec: (
                            lambda ck: ck._run_chunk_kernel(
                                "chunk_kernel", pl, [tbl], a, dec,
                                tbl.shape[1], kind))))
    return cases


def _turns(timers: dict, names: list) -> list:
    """Each timer of ``names`` in turn, then in the reverse order."""
    runs = []
    for name in names + names[::-1]:
        ms = timers[name]()
        runs.append({"tree": name, "median_ms": statistics.median(ms),
                     "rounds_ms": ms})
    return runs


def rebuild_ms(other: str | None = None, rounds: int = 7,
               launches: int = 10) -> dict:
    """Kernel ms per launch of this tree, or of ``other`` and this tree
    in turns (other, this, this, other) in one process: the candidate
    model and the far sums at the scale-up width (``_model_cases``, 20
    launches a round); a chunk of the scale-up's order-0 sprints
    (``_order0_timer``), in turns ``ORDER0_TURNS`` times; every mode of the chunk kernel's rebuild entry at
    the headline shape and of its near entry at the scale-up width, with
    this tree's layout of each; then the rebuild entry at
    ``REBUILD_WIDTHS`` in both its layouts, each tree's, in turns: other
    flat, flat, split, other split, and back."""
    dev = require_cuda()
    that = None
    here = SimpleNamespace(ck=chunk_kernel, exp=expansion, ce=cuda_engine,
                           cv=convert, ri=reference_engine)
    if other is not None:
        alias = _load_tree(other, "_other_tree")
        that = importlib.import_module(alias + ".engine.chunk_kernel")
        there = SimpleNamespace(**{
            f: importlib.import_module(f"{alias}.{mod}") for f, mod in (
                ("ck", "engine.chunk_kernel"), ("exp", "fields.expansion"),
                ("ce", "engine.cuda_engine"), ("cv", "engine.convert"),
                ("ri", "engine.reference_engine"))})
    models = []
    walkers, calls = _model_cases(dev)
    for name, call in calls.items():
        timers = {"this": _chunk_timer(here, call, rounds, 2 * launches)}
        names = ["this"]
        if that is not None:
            timers[other] = _chunk_timer(there, call, rounds, 2 * launches)
            names.insert(0, other)
        runs = _turns(timers, names)
        call(here)
        lay = chunk_kernel.LAYOUTS.get(name.split("[")[0])
        models.append({"kernel": name, "walkers": walkers,
                       "layout": lay._asdict() if lay else None,
                       "runs": runs})
        if name == "far_sums_kernel":
            models[-1]["sass_pair_loop"] = {
                tree: sass_loop(ck, FAR_SUMS_K10) for tree, ck in
                (("this", chunk_kernel), (other, that)) if ck is not None}
    timers = {"this": _order0_timer(here, dev, rounds)}
    names = ["this"]
    if that is not None:
        timers[other] = _order0_timer(there, dev, rounds)
        names.insert(0, other)
    order0 = {"sprints_a_round": N_ORDER0_SPRINTS,
              "runs": [run for _ in range(ORDER0_TURNS)
                       for run in _turns(timers, names)]}
    out = []
    for mode, call in _chunk_cases(dev).items():
        timers = {"this": _chunk_timer(chunk_kernel, call, rounds, launches)}
        names = ["this"]
        if that is not None:
            timers[other] = _chunk_timer(that, call, rounds, launches)
            names.insert(0, other)
        runs = _turns(timers, names)
        call(chunk_kernel)
        out.append({"kernel": mode,
                    "layout": chunk_kernel.LAYOUTS[mode]._asdict(),
                    "runs": runs})
        fast = "fast" in mode
        if mode in ("chunk_near_kernel", "chunk_near_kernel[fast]"):
            out[-1]["sass_step_loop"] = {
                tree: sass_loop(ck, NEAR_K10[fast]) for tree, ck in
                (("this", chunk_kernel), (other, that)) if ck is not None}
        if mode in ("chunk_kernel", "chunk_kernel[fast]"):
            out[-1]["sass_step_loops"] = split_step_loops(chunk_kernel, fast)
    widths = []
    for mode, n, call, forced in _width_cases(dev):
        trees = {"this": chunk_kernel}
        names = ["this, flat layout", "this, split layout"]
        if that is not None:
            trees[other] = that
            names = [f"{other}, flat layout", *names,
                     f"{other}, split layout"]
        timers = {f"{tree}, {kind} layout": _chunk_timer(
            ck, forced(kind), rounds, launches)
            for tree, ck in trees.items() for kind in ("flat", "split")}
        runs = _turns(timers, names)
        call(chunk_kernel)
        widths.append({"kernel": mode, "walkers": n,
                       "layout": chunk_kernel.LAYOUTS[mode]._asdict(),
                       "runs": runs})
    return {"config": "models: 100096 walkers, K 10, C 32, far-table "
                      "order 5, 5256 dipoles, "
                      f"{rounds} rounds x {2 * launches} launches; "
                      "rebuild entry: 4032 walkers x 716 dipoles, K 5; "
                      "near entry: 100096 walkers (100000 real), K 10; "
                      "4000 steps; every variant on in the variant modes; "
                      f"{rounds} rounds x {launches} launches; widths: the "
                      "rebuild entry on the headline's scene at "
                      f"{REBUILD_WIDTHS} walkers",
            "label": card_label(), "models": models, "order0": order0,
            "cases": out, "widths": widths}


def _headline_run(rng_impl: str) -> dict:
    """Walker-steps/s of the headline run: two timed 2e6-step sprints
    after a warm-up sprint."""
    dev = require_cuda()
    p = Params(chunk_steps=4000, near_k=5,
               sprint_steps=2_000_000).validate()
    sc = BacteriaBox(p, seed=42).populate()
    tbl = mnp_table(sc.mnps, torch.float32, dev)
    key = key_words(7)
    sprint = cuda_engine.make_sprint_fn(p, p.num_water, dev,
                                        rng_impl=rng_impl)
    ss = cuda_engine.to_soa(init_state(sc.waters, p, dev), p)
    chunk_kernel.load_library()
    ss, wins = sprint(tbl, key, ss)          # warm-up
    torch.cuda.synchronize()
    seconds, ss, wins = _timed_sprints(sprint, N_SPRINTS, ss, tbl, key)
    rate = N_SPRINTS * p.sprint_steps * p.num_water / seconds
    return {
        "config": "4032 waters x 270 cells (scene seed 42), chunk 4000, "
                  f"near_k 5, {_GENERATOR[rng_impl]}, 2e6-step sprints",
        "walker_steps_per_sec": rate,
        "sprints_timed": N_SPRINTS,
        "seconds": seconds,
        "projected_full_run_s": p.t * p.num_water / rate,
        "escapes": int(ss.escapes),
        "coverage_violations": int(ss.coverage),
        "sum_cos_per_walker": float(wins[-1, 0]) / p.num_water,
    }


def headline_rate() -> dict:
    run = _headline_run(cuda_engine.RNG_THREEFRY)
    rate = run.pop("walker_steps_per_sec")
    dev = require_cuda()
    return {
        "metric": "walker_steps_per_sec",
        "value": rate,
        "unit": "walker-steps/s",
        "vs_baseline": rate / K40_BASELINE,
        "device": {"name": torch.cuda.get_device_name(dev),
                   "label": card_label()},
        "detail": {
            **run,
            "scaleup": scaleup_rate(),
            "fast_rng": {
                "headline": _headline_run(cuda_engine.RNG_HARDWARE),
                "scaleup": scaleup_rate(cuda_engine.RNG_HARDWARE),
            },
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--profile", action="store_true",
                      help="device time per kernel of the scale-up path")
    ap.add_argument("--far-table-order", type=int, default=5,
                    help="with --profile: the scale-up path's far-table "
                         "order (0: the exact far sums every chunk)")
    mode.add_argument("--rebuild-ms", nargs="?", const="", default=None,
                      metavar="DIR",
                      help="kernel ms per launch (the candidate model and "
                           "far sums, every mode of both chunk entries); "
                           "with DIR, also that checkout's, in turns")
    args = ap.parse_args(argv)
    if args.far_table_order != 5 and not args.profile:
        ap.error("--far-table-order goes with --profile")
    if args.profile:
        out = scaleup_profile(order=args.far_table_order)
    elif args.rebuild_ms is not None:
        out = rebuild_ms(args.rebuild_ms or None)
    else:
        out = headline_rate()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

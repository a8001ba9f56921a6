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

* ``--profile``: the scale-up path's device time per kernel over 20
  chunks (torch.profiler), and its device idle share (one minus the
  traced device time over the wall time of the same chunks untraced);
* ``--rebuild-ms [DIR]``: the rebuild kernel's ms per chunk at the
  headline shape (4032 walkers, K 5, 4000 steps; 7 rounds of 10
  launches, CUDA events).  With DIR, the port's package of the checkout
  at DIR (e.g. the parent commit, unpacked with ``git archive``) is
  loaded beside this one and timed in turns: DIR, this, this, DIR.

    python -m mri_nanoparticle_simulation_tpu_torch.benchmark [--profile |
        --rebuild-ms [DIR]]
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from .engine import chunk_kernel, cuda_engine
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
#: 2e4-step scale-up sprints timed after the warm-up sprint
N_SCALEUP_SPRINTS = 10
#: scale-up sprints (5 chunks each) traced by --profile
N_PROFILE_SPRINTS = 4
_GENERATOR = {cuda_engine.RNG_THREEFRY: "Threefry-20",
              cuda_engine.RNG_HARDWARE: "fast generator (Philox4x32-10)"}


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


def _scaleup_setup(rng_impl: str = cuda_engine.RNG_THREEFRY):
    """The scale-up scene, its table and cache on the card, its sprint
    and the state after one warm-up sprint."""
    dev = require_cuda()
    p = Params(**SCALEUP).validate()
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


def scaleup_profile(top: int = 12) -> dict:
    """Device time per kernel of the scale-up path (torch.profiler over
    ``N_PROFILE_SPRINTS`` sprints), and the device idle share against
    the wall time of as many untraced sprints."""
    from torch.profiler import ProfilerActivity, profile

    p, _, tbl, cache, _, key, sprint, ss = _scaleup_setup()
    t0 = time.perf_counter()
    for _ in range(N_PROFILE_SPRINTS):
        ss, _ = sprint(tbl, key, ss, cache=cache)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(N_PROFILE_SPRINTS):
            ss, _ = sprint(tbl, key, ss, cache=cache)
        torch.cuda.synchronize()
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
        "config": "scale-up path, 100000 waters, K 10, far-table order 5",
        "label": card_label(),
        "chunks": N_PROFILE_SPRINTS * p.sprint_steps // p.chunk_steps,
        "untraced_wall_s": wall,
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


def _rebuild_timer(pkg: str, rounds: int, launches: int):
    """A function timing ``rounds`` x ``launches`` rebuild-kernel chunks
    of package ``pkg`` at the headline shape; returns ms per launch for
    each round."""
    ck = importlib.import_module(pkg + ".engine.chunk_kernel")
    ce = importlib.import_module(pkg + ".engine.cuda_engine")
    cv = importlib.import_module(pkg + ".engine.convert")
    re_ = importlib.import_module(pkg + ".engine.reference_engine")
    dev = require_cuda()
    p = Params(chunk_steps=4000, near_k=5).validate()
    sc = BacteriaBox(p, seed=42).populate()
    tbl = cv.mnp_table(sc.mnps, torch.float32, dev).tbl
    planes = ce.to_soa(re_.init_state(sc.waters, p, dev), p).planes
    args = dict(key=cv.key_words(7), lane_offset=0, num_water=p.num_water,
                tcp=p.tcp, cell_r2=ce.cell_r2_f32(p.cell_r), dstd=1.0,
                phys=ce.chunk_physics(p))
    ck.load_library()
    planes, *_ = ck.run_chunk(planes, tbl, step0=0, **args)
    torch.cuda.synchronize()

    def run():
        out = []
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                ck.run_chunk(planes, tbl, step0=p.chunk_steps, **args)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / launches)
        return out
    return run


def rebuild_ms(other: str | None = None, rounds: int = 7,
               launches: int = 10) -> dict:
    """Rebuild-kernel ms per chunk of this tree, or of ``other`` and this
    tree in turns (other, this, this, other) in one process."""
    this = _rebuild_timer(__package__, rounds, launches)
    order = [("this", this)]
    if other is not None:
        that = _rebuild_timer(_load_tree(other, "_other_tree"), rounds,
                              launches)
        order = [(other, that), ("this", this), ("this", this),
                 (other, that)]
    runs = []
    for name, fn in order:
        ms = fn()
        runs.append({"tree": name, "median_ms": statistics.median(ms),
                     "rounds_ms": ms})
    return {"config": "rebuild kernel, 4032 walkers x 716 dipoles, K 5, "
                      f"4000 steps, {rounds} rounds x {launches} launches",
            "label": card_label(), "runs": runs}


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
    mode.add_argument("--rebuild-ms", nargs="?", const="", default=None,
                      metavar="DIR",
                      help="rebuild-kernel ms per chunk; with DIR, also "
                           "that checkout's, in turns")
    args = ap.parse_args(argv)
    if args.profile:
        out = scaleup_profile()
    elif args.rebuild_ms is not None:
        out = rebuild_ms(args.rebuild_ms or None)
    else:
        out = headline_rate()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: set-up, the measured window, the output check.

    python3 -m port_bench --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (``setup_s``) runs from the process's start to the window's:
imports, the kernel library, the scene, certificates and caches, and a
warm-up of the cell's shapes.  The window drives the cell's entry point
for ``--seconds`` and ends in a device sync.  With ``--trace 1`` its
first calls run under torch.profiler and the line carries the per-layer
metrics, the device's busy and window seconds and a breakdown.  Then the
peak memory is read, the program's state freed, and the sampled outputs
of the window are held to the plain reference (``reference/``), each
number beside its limit from the cell's file.  The last line of
standard output is the result; a run without enough cards, or in which
JAX was loaded, prints none and exits non-zero.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from port_bench import catalog, guard
from port_bench.reference import build_scene
from port_bench.trace import Tracer

CHECKOUT = Path(__file__).resolve().parent.parent
#: build and kernel caches, at fixed paths inside the checkout
CACHE = CHECKOUT / ".port_bench_cache"


def process_age() -> float:
    """Seconds since this process started (/proc), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def context(cell_name: str, seed: int, device: str, cell: dict = None,
            config: dict = None):
    cell = cell or catalog.load_cell(cell_name)
    config = config or catalog.load_config(cell["config"])
    return SimpleNamespace(name=cell_name, cell=cell, config=config,
                           seed=int(seed), device=device)


def scene_of(ctx) -> dict:
    """The cell's scene as the reference builds it."""
    return build_scene(ctx.config["keys"] | ctx.cell.get("keys", {}),
                       ctx.config["scene_seed"])


def run_cell(ctx, seconds: float, trace: bool, t_start: float,
             age: float = 0.0, control_dtype=None) -> dict:
    """The result line of one run of ``ctx`` (``context``); ``t_start``
    is the perf_counter reading set-up counts from, ``age`` the seconds
    the process ran before it."""
    on_card = torch.device(ctx.device).type == "cuda"
    driver = catalog.load_driver(ctx.cell["driver"])
    st = driver.setup(ctx)
    setup_s = age + time.perf_counter() - t_start
    tracer = Tracer(trace and on_card)
    window = driver.window(st, seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    driver.release(st)
    gc.collect()
    t_check = time.perf_counter()
    scene = scene_of(ctx)
    try:
        readings, notes = driver.check(st, scene)
        if control_dtype is not None:
            notes["control"], _ = driver.check(st, scene, control_dtype)
    finally:
        driver.finish(st)
    notes["check_s"] = time.perf_counter() - t_check
    limits = ctx.cell["limits"]
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in readings.items()}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    mctx = SimpleNamespace(cell=ctx.cell, config=ctx.config, window=window,
                           setup_s=setup_s, trace=tracer.summary,
                           n_mnp=len(scene["mnps"]))
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for name, mod in catalog.metrics().items():
        if mod.KIND != kind:
            continue
        value = mod.read(mctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": mod.UNIT}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    res = {"correct": bool(correct), "attempted": window["calls"],
           "failed": 0, "metrics": metrics, "device": device}
    if tracer.summary is not None:
        s = tracer.summary
        device.update(busy_s=s.busy_s, window_s=s.window_s)
        res["breakdown"] = {"device_ops": s.device_ops,
                            "idle_gaps": s.idle_gaps}
    res["notes"] = {**notes, "window": window}
    res["checks"] = checks
    return res


def main(argv=None, t_start: float = None, age: float = 0.0) -> int:
    """The command; ``t_start`` and ``age`` as ``run_cell`` takes them
    (``__main__`` reads them first thing)."""
    t_start = time.perf_counter() if t_start is None else t_start
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    ap = argparse.ArgumentParser(prog="python3 -m port_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    ctx = context(args.workload, args.seed, "cuda")
    chips = ctx.cell.get("chips", 1)
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"port_bench: {args.workload} needs {chips} CUDA card(s); "
              f"this process sees {seen}", file=sys.stderr)
        return 3
    res = run_cell(ctx, args.seconds, bool(args.trace), t_start, age)
    found = guard.loaded()
    if found:
        print(f"port_bench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 4
    print(f"card: {card_label()}", file=sys.stderr)
    print(f"notes: {json.dumps(res['notes'])}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0

"""The readings the limits of ``correct`` are set from.

    python3 -m port_bench.control --workload <cell> --seeds a,b,c \
        --seconds <s> [--out FILE]

One set-up, then for each seed a window of ``--seconds`` at the cell's
own sizes and load, and its sampled outputs compared twice against the
float32 reference: the program's (the lower readings) and the control's,
the reference itself in bfloat16 put in the program's place (the upper
readings).  Prints one JSON line a seed and a last line with, for each
number, the largest program reading and the smallest control reading.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from port_bench import catalog, run
from port_bench.trace import Tracer


def readings(ctx, seeds, seconds, device="cuda", dtype=torch.bfloat16,
             out=None):
    driver = catalog.load_driver(ctx.cell["driver"])
    st = driver.setup(ctx)
    scene = run.scene_of(ctx)
    lines = []
    try:
        for i, seed in enumerate(seeds):
            if i:
                driver.reseed(st, seed)
            t0 = time.perf_counter()
            window = driver.window(st, seconds, Tracer(False))
            prog, notes = driver.check(st, scene)
            ctl, _ = driver.check(st, scene, dtype)
            line = {"seed": seed, "program": prog, "control": ctl,
                    "notes": notes, "window": window,
                    "s": time.perf_counter() - t0}
            lines.append(line)
            print(json.dumps(line), flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    finally:
        driver.finish(st)
    names = lines[0]["program"].keys()
    return {"lower": {k: max(ln["program"][k] for ln in lines)
                      for k in names},
            "upper": {k: min(ln["control"][k] for ln in lines)
                      for k in names},
            "seeds": len(lines)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA card", file=sys.stderr)
        return 3
    ctx = run.context(args.workload, seeds[0], "cuda")
    summary = readings(ctx, seeds, args.seconds, out=args.out)
    print(json.dumps({"workload": args.workload, **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

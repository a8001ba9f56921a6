"""What the drivers share: the configuration as the program's Params,
the window's counts, and the comparison of a chunk's outputs with the
reference's."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..reference.rng import MASK

RNG_IMPL = {"fast": "hardware", "threefry": "threefry"}
#: chunks drawn from the seed for the check, beside the first and the
#: first holding a flip; plane-fold sprints likewise
SAMPLE_CHUNKS = 2
SAMPLE_SPRINTS = 2
#: runner slices under the profiler in a ``--trace 1`` run
TRACE_SLICES = 1


def keys(ctx) -> dict:
    """The configuration's keys with the cell's own on top."""
    return ctx.config["keys"] | ctx.cell.get("keys", {})


def params(ctx):
    from mri_nanoparticle_simulation_tpu_torch.params import Params
    names = {f.name for f in dataclasses.fields(Params)}
    kv = {k: tuple(v) if isinstance(v, list) else v
          for k, v in keys(ctx).items() if k in names}
    return Params(**kv).validate()


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window_stats(p, done, wall, traced, calls):
    """The window's work: walker-steps, chunks and sprints, in all and in
    the traced part."""
    def counts(d):
        return {"walker_steps": d["steps"] * p.num_water,
                "chunks": d["steps"] // p.chunk_steps,
                "sprints": d["steps"] // p.sprint_steps}
    return {**counts(done), "wall_s": wall, "calls": calls,
            "traced": None if traced is None else counts(traced)}


def scene_gap(program: dict, ref: dict) -> float:
    """Entries of the program's scene (waters, dipoles with images) that
    differ from the reference's; every entry when the shapes differ."""
    n = 0
    for k in ("waters", "mnps"):
        a, b = np.asarray(program[k]), np.asarray(ref[k])
        n += (int((a != b).sum()) if a.shape == b.shape
              else max(a.size, b.size))
    return float(n)


def gap(a, b, w: int, rows=slice(None)) -> float:
    """Largest |a - b| over the real walkers' columns of ``rows``."""
    d = (a[rows, :w].double() - b[rows, :w].double()).abs()
    return float(torch.nan_to_num(d, nan=float("inf")).max()) \
        if d.numel() else 0.0


def start_state(ref, item, w_pad):
    """The state a sampled chunk starts from: the walk's previous chunk
    output as the program produced it, or the reference's own start for
    a walk's first chunk."""
    dec = item["out"][0].shape[0] == 8
    if item["state"] is None:
        return ref.init_planes(w_pad, dec)
    return item["state"]


def start_gap(ref, item, w_pad) -> float:
    """The program's start against the reference's, as the program
    handed a walk's first chunk (wrapped on the near entry)."""
    dec = item["out"][0].shape[0] == 8
    init = ref.init_planes(w_pad, dec)
    if item["near"]:
        init = torch.cat([ref.wrap(init[:3]), init[3:]])
    return gap(item["wrapped"].to(init.device), init, ref.ph.num_water)


def program_candidate(item, w, rows):
    out, esc, cov, wins = item["out"]
    model = item["model"]
    return {"step0": item["prog_step0"], "out": out, "esc": esc, "cov": cov, "wins": wins,
            "n_reach": None if model is None else model[2],
            "near": None if model is None else model[0],
            "taylor": None if model is None else model[1], "rows": rows}


def as_candidate(r, step0, decompose=False):
    """A reference result in the program's place (the control)."""
    rows = None if decompose else r.wins[..., 0].double().sum(0).cpu().numpy()
    return {"step0": step0, "out": r.out, "esc": r.esc, "cov": r.cov, "wins": r.wins,
            "n_reach": r.n_reach, "near": r.near, "taylor": r.taylor,
            "rows": rows}


def _rel(a, b):
    """Largest |a - b| over each row's largest |b|, over the rows of the
    last axis' leading dimensions."""
    a = a.double().reshape(-1, a.shape[-1])
    b = b.double().reshape(-1, b.shape[-1])
    scale = b.abs().amax(1).clamp_min(1e-30)
    return float(((a - b).abs().amax(1) / scale).max())


def compare(got, want, step0s, w, large, decompose=False):
    """The numbers compared over the sampled chunks: ``pos_gap_um`` and
    ``phase_gap_rad``, the largest gaps in the walkers' positions and
    phases (with their compensations; A and B on a decomposition run);
    ``count_gap``, the escape flags, coverage counts (the large path's
    reach counts), in-cell flags and chunk step counters (the program's
    against the walk's own count) that differ; ``model_gap`` (large path)
    the near slots' and Taylor sums' largest gap over each row's scale;
    ``row_gap``, the largest gap of a window's Σcos over the walkers,
    over W (or ``record_gap``, the per-walker (A, B) record's, rad)."""
    pos = phase = count = model = row = 0.0
    for g, r, s0 in zip(got, want, step0s):
        dev = r.out.device
        count += float(g["step0"] != s0 & MASK)
        out = g["out"].to(dev)
        pos = max(pos, gap(out, r.out, w, slice(0, 3)))
        phase = max(phase, gap(out, r.out, w, slice(4, None)))
        count += float((out[3, :w] != r.out[3, :w]).sum())
        count += float((g["esc"].to(dev)[:w].double()
                        - r.esc[:w].double()).abs().sum())
        count += float((g["cov"].to(dev).double()
                        - r.cov.double()).abs().sum())
        if large:
            count += float((g["n_reach"].to(dev)[:w].double()
                            - r.n_reach[:w].double()).abs().sum())
            model = max(model, _rel(g["near"].to(dev)[..., :w],
                                    r.near[..., :w]),
                        _rel(g["taylor"].to(dev)[..., :w],
                             r.taylor[..., :w]))
        if decompose:
            row = max(row, gap(g["wins"].to(dev).reshape(-1, out.shape[1]),
                               r.wins.reshape(-1, out.shape[1]), w))
        else:
            want_rows = r.wins[..., 0].double().sum(0).cpu().numpy()
            if g["rows"] is None or len(g["rows"]) != len(want_rows):
                row = float("inf")
            else:
                row = max(row, float(np.abs(np.asarray(g["rows"])
                                            - want_rows).max()) / w)
    out = {"pos_gap_um": pos, "phase_gap_rad": phase, "count_gap": count}
    if large:
        out["model_gap"] = model
    out["record_gap_rad" if decompose else "row_gap"] = row
    return out

"""The constants of one chunk, worked out from a configuration's keys.

The reference's formulas (parameters.h:88-122, cuda_sim.cu:42-45 and
625-640): step-length deviations sqrt(pi D tau), phase per tesla
2 pi g tau 1e-3, the as-written kick's chemical-shift term, the
Carr-Purcell interval and output window in steps, and the per-chunk
travel bound (``travel_sigmas`` sigma per axis, times sqrt(3)).  Each
float is rounded to float32 once, as the device code holds it.  Only the
default physics is served: the as-written kick, cube directions, no
membrane reflection, no gradient.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

FIELD_SCALE = 1e11


def f32(v) -> float:
    return float(np.float32(v))


class Phys(NamedTuple):
    num_water: int
    bound: float
    chunk_steps: int
    sprint_steps: int
    total_steps: int
    pfreq: int
    tcp: int
    near_k: int
    rounds: int
    fast: bool
    in_sd: float
    out_sd: float
    phase_per_tesla: float
    kick: float
    cell_r: float
    cell_r2: float          # float32 product cell_r * cell_r
    travel: float
    travel2: float
    near_reach2: float      # the large path's coverage reach, squared
    cube_hash_dim: int
    cube_candidates: int
    far_table_order: int


def phys_of(cfg: dict, generator: str) -> Phys:
    """``cfg``: the configuration's keys (a Params-like dict);
    ``generator``: "fast" or "threefry"."""
    if (cfg.get("kick_mode", "as_written") != "as_written"
            or cfg.get("direction_mode", "cube") != "cube"
            or cfg.get("reflect_io", 0.0) or cfg.get("reflect_oi", 0.0)
            or any(cfg.get("b0_gradient", (0.0, 0.0, 0.0)))):
        raise NotImplementedError("the reference serves the default "
                                  "physics only")
    tau = cfg["tau"]
    out_sd = math.sqrt(math.pi * cfg["D_extra"] * tau)
    sigma_axis = out_sd * float(np.sqrt(cfg["chunk_steps"]))
    travel_bound = float(cfg["travel_sigmas"] * sigma_axis * np.sqrt(3.0))
    travel2 = float(travel_bound ** 2)
    cr = np.float32(cfg["cell_r"])
    reach = np.float32(cfg["cell_r"]) + np.float32(travel_bound)
    return Phys(
        num_water=int(cfg["num_water"]), bound=f32(cfg["bound"]),
        chunk_steps=int(cfg["chunk_steps"]),
        sprint_steps=int(cfg["sprint_steps"]),
        total_steps=int(round(cfg["totaltime"] / tau)),
        pfreq=int(round(cfg["print_interval"] / tau)),
        tcp=int(round(cfg["taucp"] / tau)), near_k=int(cfg["near_k"]),
        rounds=int(cfg["rng_rounds"]), fast=generator == "fast",
        in_sd=f32(math.sqrt(math.pi * cfg["D_cell"] * tau)),
        out_sd=f32(out_sd),
        phase_per_tesla=f32(2.0 * math.pi * cfg["g"] * tau * 1e-3),
        kick=f32(cfg["phase_k"] * 1e-3 * 42.58 * 2.0 * math.pi * 7.0 * tau),
        cell_r=float(cfg["cell_r"]), cell_r2=float(cr * cr),
        travel=f32(np.sqrt(travel2)), travel2=f32(travel2),
        near_reach2=float(reach * reach),
        cube_hash_dim=int(cfg["cube_hash_dim"]),
        cube_candidates=int(cfg["cube_candidates"]),
        far_table_order=int(cfg["far_table_order"]))

"""Field debugging and inspection.

Counterpart of the reference's ``fields/debug.py``: the reference's
DEBUG_FIELD flag rebuilt the octree uniformly and dumped B_z at every
leaf to ``T2_sim_tree_field_info.csv`` (octree.cpp:393-394, 435-449).
Here the same products are functions in plain torch on the caller's
device, through the exact masked dipole sum
(``dipole.total_field_masked``) in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import Params
from . import dipole

#: points per evaluation block: [8192, n_mnp, 3] float32 at a time
BLOCK = 8192


def _field(pts: np.ndarray, mnps: np.ndarray, params: Params, device):
    device = torch.device(device)
    if device.type == "cuda":
        from ..utils.device import require_cuda
        require_cuda()
    mnp_pos = torch.as_tensor(np.asarray(mnps[:, :3], np.float32),
                              device=device)
    mnp_M = torch.as_tensor(np.asarray(mnps[:, 4], np.float32),
                            device=device)
    out = []
    for s in range(0, len(pts), BLOCK):
        chunk = torch.as_tensor(np.asarray(pts[s:s + BLOCK], np.float32),
                                device=device)
        out.append(dipole.total_field_masked(
            chunk, mnp_pos, mnp_M, params.cell_r).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def dump_field_csv(mnps: np.ndarray, params: Params, path: str,
                   grid_n: int = 32, *, device="cuda") -> None:
    """Write B_z sampled on a uniform grid_n^3 lattice of voxel centres to
    CSV rows ``x,y,z,B_z`` (the DEBUG_FIELD product, on the uniform grid
    that replaced the octree), computed on ``device`` ("cuda" unless the
    caller asks for "cpu")."""
    h = params.bound / grid_n
    ax = (np.arange(grid_n) + 0.5) * h
    pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    b = _field(pts, mnps, params, device)
    with open(path, "w") as f:
        for (x, y, z), v in zip(pts, b):
            f.write(f"{x:.9g},{y:.9g},{z:.9g},{v:.9g}\n")


def field_profile(mnps: np.ndarray, params: Params, start, end,
                  n: int = 512, *, device="cuda") -> np.ndarray:
    """B_z along a line segment (for plots and inspection): returns
    [n, 2] (arclength µm, B_z Tesla)."""
    start = np.asarray(start, float)
    end = np.asarray(end, float)
    ts = np.linspace(0.0, 1.0, n)
    pts = start[None, :] + ts[:, None] * (end - start)[None, :]
    b = _field(pts, mnps, params, device)
    return np.stack([ts * np.linalg.norm(end - start), b], axis=1)

"""Uniform field grid: the scan engine's octree-like field backend, in
torch.

Counterpart of the reference's ``fields/grid.py``: the box is cut into
G^3 voxels; each voxel stores

* the far field B_z at its eight corners with the voxel's resident
  dipoles left out, interpolated trilinearly at a query point;
* a fixed-width resident list: every dipole within ``scale * cell_r +
  half-diagonal`` of the voxel centre (Octree::MNP_in_space,
  octree.cpp:168-174), whose masked field is summed exactly at query
  time.

It is a second, independent implementation of the field the expansion
computes, for cross-validation (``field_mode="grid"`` of the scan
engine), not a production path.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..params import Params
from .dipole import dipole_bz, dipole_bz_masked


class FieldGrid(NamedTuple):
    corners: torch.Tensor      # [G, G, G, 8] far-field B_z at the corners
    res_idx: torch.Tensor      # [G, G, G, K] resident dipole ids, -1 pad
    #: [G^3, K, 4] residents (x, y, z, M); padding sits 1e9 µm away with
    #: zero moment, so the query needs no validity mask
    res_payload: torch.Tensor
    mnp_pos: torch.Tensor      # [N, 3]
    mnp_M: torch.Tensor        # [N]
    spacing: float
    grid_n: int


#: corner offsets in (x, y, z) bit order (i>>2 & 1, i>>1 & 1, i & 1), the
#: reference's sub-octant enumeration (octree.cpp:274-278)
_CORNERS = np.array([[(i >> 2) & 1, (i >> 1) & 1, i & 1]
                     for i in range(8)], np.float64)

#: voxels per build batch: bounds the [B, 8, N, 3] corner intermediate
BATCH = 2048


def build_grid(mnp_pos, mnp_M, params: Params, grid_n: int = 32,
               max_residents: int = 16, dtype=torch.float32) -> FieldGrid:
    """The grid on the device of ``mnp_pos`` [N, 3] and ``mnp_M`` [N], in
    batches of ``BATCH`` voxels: per voxel the ``max_residents`` nearest
    dipoles by exact d^2 (first index on ties), kept where within the
    residency reach, and the corner values without them.  Raises when a
    voxel has more dipoles within reach than ``max_residents``."""
    h = params.bound / grid_n
    reach = params.scale * params.cell_r + math.sqrt(3.0) * h / 2.0
    mnp_pos = mnp_pos.to(dtype)
    mnp_M = mnp_M.to(dtype)
    dev = mnp_pos.device
    n = mnp_pos.shape[0]
    max_residents = min(max_residents, n)
    reach2 = torch.tensor(reach * reach, dtype=dtype, device=dev)

    ax = np.arange(grid_n)
    centers_np = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                          axis=-1).reshape(-1, 3) * h + h / 2.0
    n_voxels = centers_np.shape[0]
    corners_off = torch.as_tensor(_CORNERS - 0.5, device=dev).to(dtype)
    h_t = torch.tensor(h, dtype=dtype, device=dev)
    col = torch.arange(n, device=dev)[None, :]

    def batch(centers):                                 # [B, 3]
        d2 = torch.sum((centers[:, None, :] - mnp_pos) ** 2, -1)
        remaining = d2.clone()
        rows = torch.arange(centers.shape[0], device=dev)
        idxs, dists = [], []
        for _ in range(max_residents):
            j = torch.argmin(remaining, 1)
            idxs.append(j)
            dists.append(remaining[rows, j])
            remaining[rows, j] = float("inf")
        res_idx = torch.stack(idxs, 1)                  # [B, K]
        res_d2 = torch.stack(dists, 1)
        overflow = torch.sum(torch.isfinite(remaining)
                             & (remaining < reach2), 1)
        res_idx = torch.where(res_d2 < reach2, res_idx,
                              torch.full_like(res_idx, -1))

        cpos = centers[:, None, :] + corners_off * h_t   # [B, 8, 3]
        d = cpos[:, :, None, :] - mnp_pos                # [B, 8, N, 3]
        contrib = dipole_bz(d[..., 0], d[..., 1], d[..., 2],
                            mnp_M[None, None, :])
        # an additive scatter: padded (-1) entries land on column 0 with
        # weight 0 and cannot clear a real resident flag there
        is_res = torch.zeros((centers.shape[0], n), dtype=torch.int32,
                             device=dev)
        is_res.index_put_((rows[:, None].expand_as(res_idx),
                           res_idx.clamp(0, n - 1)),
                          (res_idx >= 0).to(torch.int32), accumulate=True)
        corners = torch.sum(torch.where(is_res[:, None, :] > 0,
                                        torch.zeros_like(contrib), contrib),
                            -1)
        return corners, res_idx, int(overflow.max())

    pad = (-n_voxels) % BATCH
    if pad:
        centers_np = np.concatenate([centers_np, np.zeros((pad, 3))])
    all_c, all_i = [], []
    with torch.no_grad():
        for s in range(0, len(centers_np), BATCH):
            c, i, ov = batch(torch.as_tensor(
                centers_np[s:s + BATCH], device=dev).to(dtype))
            if ov > 0:
                raise ValueError(
                    f"a voxel has more than max_residents={max_residents} "
                    f"dipoles within its residency reach; raise "
                    f"max_residents or grid_n")
            all_c.append(c)
            all_i.append(i)
    corners = torch.cat(all_c)[:n_voxels]
    res_idx = torch.cat(all_i)[:n_voxels]

    valid = res_idx >= 0
    safe = res_idx.clamp(0, n - 1)
    res_pos = torch.where(valid[..., None], mnp_pos[safe],
                          torch.full((), 1e9, dtype=dtype, device=dev))
    res_M = torch.where(valid, mnp_M[safe], torch.zeros((), dtype=dtype,
                                                        device=dev))
    payload = torch.cat([res_pos, res_M[..., None]], -1)
    return FieldGrid(
        corners=corners.reshape(grid_n, grid_n, grid_n, 8),
        res_idx=res_idx.reshape(grid_n, grid_n, grid_n, max_residents),
        res_payload=payload, mnp_pos=mnp_pos, mnp_M=mnp_M,
        spacing=float(h), grid_n=grid_n)


def query(grid: FieldGrid, pos, cell_r):
    """B_z and residency at [W, 3] positions: the trilinear far field of
    the position's voxel plus the exact masked field of its residents.
    Positions outside [0, bound)^3 are clamped to the boundary voxel (the
    engine wraps first).  ``cell_r`` a float or a scalar tensor."""
    g = grid.grid_n
    h = torch.tensor(grid.spacing, dtype=pos.dtype, device=pos.device)
    scaled = pos / h
    v = torch.clamp(torch.floor(scaled).to(torch.int32), 0, g - 1)
    frac = torch.clamp(scaled - v, 0.0, 1.0)                      # [W, 3]
    flat = ((v[:, 0] * g + v[:, 1]) * g + v[:, 2]).long()         # [W]

    corners = grid.corners.reshape(g * g * g, 8)[flat]            # [W, 8]
    wx = torch.stack([1.0 - frac[:, 0], frac[:, 0]], 1)           # [W, 2]
    wy = torch.stack([1.0 - frac[:, 1], frac[:, 1]], 1)
    wz = torch.stack([1.0 - frac[:, 2], frac[:, 2]], 1)
    weights = (wx[:, :, None, None] * wy[:, None, :, None]
               * wz[:, None, None, :]).reshape(-1, 8)
    b_far = torch.sum(corners * weights, 1)

    payload = grid.res_payload[flat]                              # [W, K, 4]
    d = pos[:, None, :] - payload[..., :3]
    b_res = torch.sum(dipole_bz_masked(d[..., 0], d[..., 1], d[..., 2],
                                       payload[..., 3], cell_r), -1)
    d2 = torch.sum(d * d, -1)
    in_cell = torch.any(d2 < cell_r * cell_r, -1)
    return b_far + b_res, in_cell

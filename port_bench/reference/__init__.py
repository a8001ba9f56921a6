"""The plain reference the benchmark holds the port to.

Plain PyTorch and NumPy only: it imports nothing of the program, and it
works out again from the benchmark's own inputs (the configuration's
keys, the scene seed, the seed) everything the program derives from
them: the scene (``scene.build``), the dipole table, the scene's cube candidates and far table, each
chunk's field model, the initial walker state, the chunk's steps and
window sums, and the plane fold.  ``Reference(..., dtype=torch.bfloat16)``
is the control: the same arithmetic a precision below the float32 the
configuration states.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import chunk, model, plane
from .scene import build as build_scene  # noqa: F401
from .physics import Phys, phys_of
from .rng import MASK, key_of

#: the whole-table selection's dipole limit; larger scenes select
#: through the cube cache
REBUILD_MAX = 2048


class ChunkResult(NamedTuple):
    out: torch.Tensor        # [R, W_pad] state after the chunk
    esc: torch.Tensor        # [W_pad] escape flags
    cov: torch.Tensor        # [W_pad / 32] coverage violations per warp
    wins: torch.Tensor       # [W_pad / 32, n_win, 2] or [n_win, 2, W_pad]
    n_reach: torch.Tensor | None   # [W_pad], the large path only
    near: torch.Tensor
    taylor: torch.Tensor


class Reference:
    def __init__(self, cfg: dict, generator: str, scene: dict, seed: int,
                 device, dtype=torch.float32):
        self.ph: Phys = phys_of(cfg, generator)
        self.dev, self.dt = torch.device(device), dtype
        self.key = key_of(seed)
        mnps = scene["mnps"]
        self.waters = scene["waters"]
        pos = torch.as_tensor(mnps[:, :3], device=self.dev).to(torch.float32)
        m = torch.as_tensor(mnps[:, 4], device=self.dev).to(torch.float32)
        self.n_mnp = len(mnps)
        self.large = self.n_mnp > REBUILD_MAX
        self.tbl = model.pack_table(pos, m).to(dtype)
        if self.large:
            cand, coeffs = model.scene_cache(
                pos.to(dtype), m.to(dtype), self.ph.cube_hash_dim,
                self.ph.cube_candidates, self.ph.bound,
                self.ph.far_table_order)
            self.cand, self.coeffs = cand, coeffs

    def init_planes(self, w_pad: int, decompose: bool = False):
        """The walkers at the scene's waters, zero phase, padded to
        ``w_pad`` columns at the box centre."""
        w = self.ph.num_water
        planes = torch.zeros((8 if decompose else 6, w_pad), dtype=self.dt,
                             device=self.dev)
        planes[:3, w:] = self.ph.bound / 2
        planes[:3, :w] = torch.as_tensor(self.waters, device=self.dev).to(
            torch.float32).T.to(self.dt)
        return planes

    def wrap(self, v):
        b = self.ph.bound
        r = torch.fmod(v + b, b)
        return torch.where((r != 0) & (r < 0), r + b, r)

    def chunks(self, states, step0s, decompose: bool = False):
        """Each (pre-wrap state [R, W_pad], first global step) through one
        chunk, all side by side.  Returns a list of ``ChunkResult``."""
        ph, dev, dt = self.ph, self.dev, self.dt
        w_pad = states[0].shape[1]
        n = len(states)
        state = torch.cat([s.to(dev).to(dt) for s in states], 1)
        state = torch.cat([self.wrap(state[:3]), state[3:]])
        idx = torch.arange(w_pad, device=dev).repeat(n)
        valid = idx < ph.num_water
        step0 = torch.cat([torch.full((w_pad,), int(s) & MASK,
                                      dtype=torch.int64, device=dev)
                           for s in step0s])
        n_reach = cov = None
        if self.large:
            near, taylor, n_reach = model.cand_model(
                state[:3], self.cand, self.coeffs, k=ph.near_k,
                order=ph.far_table_order, h=ph.cube_hash_dim,
                bound=ph.bound, reach2=ph.near_reach2)
            cov = torch.zeros(n * w_pad // model.WARP, dtype=dt, device=dev)
        else:
            near, taylor, cov = model.rebuild_model(
                state[:3], self.tbl, ph.near_k, ph.cell_r2, ph.travel, valid)
        out, esc, wins = chunk.chunk_steps(
            state, near, taylor, step0=step0, lane=idx, valid=valid,
            key=self.key, ph=ph, decompose=decompose)
        res = []
        g = w_pad // model.WARP
        for i in range(n):
            sl = slice(i * w_pad, (i + 1) * w_pad)
            res.append(ChunkResult(
                out[:, sl], esc[sl], cov[i * g:(i + 1) * g],
                wins[:, :, sl] if decompose else wins[i * g:(i + 1) * g],
                None if n_reach is None else n_reach[sl],
                near[:, :, sl], taylor[:, sl]))
        return res

    def plane_tables(self, taucps, tau: float):
        """(u_prev, g) over the whole run for the echo spacings
        ``taucps`` (ms)."""
        ph = self.ph
        tcps = [int(round(t / tau)) for t in taucps]
        return plane.sign_tables(ph.total_steps // ph.pfreq, ph.pfreq,
                                 ph.tcp, tcps)

    def fold(self, wins, carry, u_prev, g_blk, scales):
        dt, dev = self.dt, self.dev
        carry = tuple(c.to(dev).to(dt) for c in carry)
        return plane.fold(wins.to(dev).to(dt), carry,
                          torch.as_tensor(u_prev, device=dev).to(dt),
                          torch.as_tensor(g_blk, device=dev).to(dt),
                          scales, self.ph.num_water)

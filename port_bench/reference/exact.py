"""The large path with the exact far field (configuration
``scaleup-exact``, far-table order 0) in plain PyTorch.

The simulator this repo rebuilds sums every dipole's closed form at
every step (``src/octree.cpp:206-215``, ``src/cuda_sim.cu:107``): no
series is truncated.  Order 0 keeps that for all but the chunk's
split: at each chunk start a walker's K nearest dipoles are summed
exactly at every step, and the rest enters as the exact value, gradient
and Hessian at the anchor of the sum over every other dipole of the
table, its images included.  Per walker:

* the C candidates of the anchor's cube from the scene's cube table
  (``model.scene_cache``'s selection, kept here with the candidates'
  indices into the dipole table);
* the K nearest of them by K masked argmin passes in bfloat16 over the
  exact float32 d^2 (first index on ties), in the order they are
  picked;
* the candidates within the coverage reach (``n_reach``);
* the near slots (x, y, z, M * FIELD_SCALE) of the K;
* the far sums: ``model.far_sums`` over the whole table but the K
  selected indices, one dipole at a time in table order.

Then the chunk's steps, ``chunk.chunk_steps``, as on the candidate
model's path.  ``ExactReference(..., dtype=torch.bfloat16)`` is the
control.

Departures from the program: the far-sums kernel rounds each pair's
reciprocal square root by the flush-to-zero instruction and contracts
its accumulation into fused multiply-adds; these sums are uncontracted.
Both add in table order, so the far sums agree to float32 rounding of
each sum (about 1e-6 of a row's largest value), not bit for bit, and
the phases that the far field kicks follow them.
"""

from __future__ import annotations

import torch

from . import ChunkResult, Reference, chunk, model
from .rng import MASK


def cube_table(pos, h: int, c: int, bound: float):
    """Each cube's C candidates as indices into ``pos`` [N, 3], int64
    [H^3, C]: C masked argmin passes in bfloat16 over |centre|^2 +
    |p|^2 - 2 centre.p, as ``model.scene_cache`` selects them."""
    c = min(c, pos.shape[0])
    centers = torch.as_tensor(model.cube_centers(h, bound),
                              device=pos.device).to(pos.dtype)
    an2 = (centers * centers).sum(-1)
    bn2 = (pos * pos).sum(-1)
    d2 = an2[:, None] + bn2[None, :] - 2.0 * (centers @ pos.T)
    return argmin_passes(d2, c)


def argmin_passes(d2, k: int):
    """The K smallest columns of each row of ``d2``, int64 [rows, K], by
    K masked argmin passes in bfloat16 (first index on ties)."""
    remaining = (d2.to(torch.bfloat16) if d2.dtype == torch.float32
                 else d2).clone()
    rows = torch.arange(d2.shape[0], device=d2.device)
    picked = []
    for _ in range(k):
        j = torch.argmin(remaining, dim=1)
        picked.append(j)
        remaining[rows, j] = float("inf")
    return torch.stack(picked, 1)


def exact_model(pos, cand, ids, tbl, *, k, h, bound, reach2):
    """The model at wrapped anchors ``pos`` [3, W]: ``cand`` [H^3, C, 4]
    (x, y, z, M * FIELD_SCALE) and ``ids`` [H^3, C] the cube table,
    ``tbl`` [4, n_pad] the dipole table.  Returns (near [4, K, W],
    taylor [10, W], n_reach [W])."""
    ci, _ = model.cube_index(pos, h, bound)
    flat = (ci[0] * h + ci[1]) * h + ci[2]
    pc = cand[flat]                                       # [W, C, 4]
    dc = pos.T[:, None, :] - pc[..., :3]
    d2 = (dc[..., 0] * dc[..., 0] + dc[..., 1] * dc[..., 1]
          + dc[..., 2] * dc[..., 2])                      # [W, C]
    n_reach = (d2 < reach2).sum(1)
    sel = argmin_passes(d2, k)                            # [W, K]
    near = torch.take_along_dim(pc, sel[..., None], 1).permute(2, 1, 0)
    far_ids = torch.take_along_dim(ids[flat], sel, 1).T   # [K, W]
    return near.contiguous(), model.far_sums(pos, tbl, far_ids), n_reach


class ExactReference(Reference):
    """``Reference`` whose large-path model is ``exact_model``, whatever
    far-table order the keys give: the scene, table, start and chunk
    steps are ``Reference``'s."""

    def __init__(self, cfg: dict, generator: str, scene: dict, seed: int,
                 device, dtype=torch.float32):
        # float32 products on the card, as the program's (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(cfg | {"far_table_order": 0}, generator, scene,
                         seed, device, dtype)
        if not self.large:
            raise NotImplementedError("the exact far field is served on "
                                      "the large path")
        pos = torch.as_tensor(scene["mnps"][:, :3], device=self.dev).to(
            torch.float32).to(dtype)
        self.ids = cube_table(pos, self.ph.cube_hash_dim,
                              self.ph.cube_candidates, self.ph.bound)

    def chunks(self, states, step0s, decompose: bool = False):
        """As ``Reference.chunks``: the chunks side by side, each one's
        model worked out apart, so the far sums hold one chunk's walkers
        at a time."""
        ph, dev, dt = self.ph, self.dev, self.dt
        w_pad = states[0].shape[1]
        n = len(states)
        state = torch.cat([s.to(dev).to(dt) for s in states], 1)
        state = torch.cat([self.wrap(state[:3]), state[3:]])
        lane = torch.arange(w_pad, device=dev).repeat(n)
        valid = lane < ph.num_water
        step0 = torch.cat([torch.full((w_pad,), int(s) & MASK,
                                      dtype=torch.int64, device=dev)
                           for s in step0s])
        models = [exact_model(state[:3, i * w_pad:(i + 1) * w_pad],
                              self.cand, self.ids, self.tbl, k=ph.near_k,
                              h=ph.cube_hash_dim, bound=ph.bound,
                              reach2=ph.near_reach2) for i in range(n)]
        near = torch.cat([m[0] for m in models], 2)
        taylor = torch.cat([m[1] for m in models], 1)
        out, esc, wins = chunk.chunk_steps(
            state, near, taylor, step0=step0, lane=lane, valid=valid,
            key=self.key, ph=ph, decompose=decompose)
        g = w_pad // model.WARP
        cov = torch.zeros(g, dtype=dt, device=dev)
        res = []
        for i, (_, _, n_reach) in enumerate(models):
            sl = slice(i * w_pad, (i + 1) * w_pad)
            res.append(ChunkResult(
                out[:, sl], esc[sl], cov,
                wins[:, :, sl] if decompose else wins[i * g:(i + 1) * g],
                n_reach, near[:, :, sl], taylor[:, sl]))
        return res

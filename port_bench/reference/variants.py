"""The reference's own physics (configuration ``variants``) in plain
PyTorch: the intended Cauchy kick and permeable membranes on top of the
default step of ``chunk.py``.

The reference CUDA code (github.com/RabinKarp/MRI_Nanoparticle_
Simulation) describes both:

* the kick, ``src/parameters.h:54-63`` (``RANDOM_KICK``): a walker in a
  cell adds ``phase_stdev * tau * cauchy * sign(u - 1/2)`` to the
  chemical-shift kick each step, with ``cauchy = sqrt(1 / (2 |u - 1/2|)
  - 1)`` from a uniform u.  As the reference writes it, operator
  precedence drops the Cauchy term (SURVEY.md, bugs, item 1); this is
  the kick it intended.  ``2 |u - 1/2|`` is floored at 1e-12 and
  sign(0) is 0, so u = 1/2 adds the chemical-shift term alone.
* the membranes, ``src/parameters.h:84-86, 99-117`` and ``cuda_sim.cu:502``
  (``cell_reflect``): a step whose in-cell test changes is refused when
  the walker's coin is below reflectIO (leaving a cell) or reflectOI
  (entering one); the walker keeps its position, field and in-cell
  test.  reflectIO = 1 - sqrt(tau / (6 D_cell)) 4 P and reflectOI = 1 -
  (1 - reflectIO) sqrt(D_cell / D_extra), from P_expr (parameters.h:
  116-117, commented out there; the configuration's keys hold them).

Departures from the reference CUDA code, as the program makes them:
the in-cell test is "nearest dipole within cell_r" (the program's, as in
``chunk.py``) in place of the reference's cell lookup; the coin and the
kick's uniform are words of the program's counter-based generators, not
cuRAND's: on Threefry word 5 (the coin) and word 6 (the kick's uniform)
of a fourth block a step, on the fast generator words 5-6 (the pair's
coins) and 7-8 (its kicks' uniforms) of a third Philox block a step
pair; the kick's square root is rounded to nearest (through float64),
as the card's ``sqrtf``.  Sphere directions and a background gradient
have no source and are not served.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import ChunkResult, Reference, model, rng
from .chunk import DRAW_BLOCK, F32, WARP, _inv_norm, kahan
from .physics import Phys, f32

#: the keys ``Reference`` is handed: its default physics, on which the
#: variants below are laid
DEFAULT_PHYSICS = {"kick_mode": "as_written", "reflect_io": 0.0,
                   "reflect_oi": 0.0}
KICK_FLOOR = f32(1e-12)


class Variants(NamedTuple):
    reflect: bool
    reflect_io: float
    reflect_oi: float
    intended: bool
    kick_sd: float          # phase_stdev * tau, rounded to float32


def variants_of(cfg: dict) -> Variants:
    """The variant constants of a configuration's keys; raises for the
    variants with no source (sphere directions, a gradient)."""
    if (cfg.get("direction_mode", "cube") != "cube"
            or any(cfg.get("b0_gradient", (0.0, 0.0, 0.0)))):
        raise NotImplementedError("sphere directions and a gradient are "
                                  "not served")
    rio, roi = float(cfg.get("reflect_io", 0.0)), float(
        cfg.get("reflect_oi", 0.0))
    intended = cfg.get("kick_mode", "as_written") == "intended"
    if cfg.get("kick_mode", "as_written") not in ("as_written", "intended"):
        raise NotImplementedError(f"kick mode {cfg['kick_mode']!r}")
    return Variants(reflect=rio > 0 or roi > 0, reflect_io=f32(rio),
                    reflect_oi=f32(roi), intended=intended,
                    kick_sd=f32(cfg["phase_stdev"] * cfg["tau"])
                    if intended else 0.0)


def _draws(key, win_step0, lane, ph: Phys, var: Variants, dt):
    """Per step of one window: (dx, dy, dz, inv_norm, normal, coin, kick
    uniform, track), the uniforms None where their variant is off."""
    extra = int(var.reflect) + int(var.intended)
    if not ph.fast:
        for b0 in range(0, ph.pfreq, DRAW_BLOCK):
            n = min(DRAW_BLOCK, ph.pfreq - b0)
            offs = torch.arange(b0, b0 + n, device=lane.device)[:, None]
            w = rng.threefry_words(key, win_step0[None] + offs, lane[None],
                                   7 if extra else 5, ph.rounds)
            u0, u1, u2 = (rng.uniform(x, F32) for x in w[:3])
            dx, dy, dz = 2.0 * u0 - 1.0, 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
            inv = _inv_norm(dx, dy, dz)
            nrm = rng.normal(w[3], w[4], F32)
            coin = rng.uniform(w[5], F32) if var.reflect else None
            kick = rng.uniform(w[6], F32) if var.intended else None
            vals = [v if v is None else v.to(dt)
                    for v in (dx, dy, dz, inv, nrm, coin, kick)]
            for i in range(n):
                yield (*(v if v is None else v[i] for v in vals), True)
        return
    if ph.pfreq % 2:
        raise NotImplementedError("odd output windows")
    n_pairs = ph.pfreq // 2
    for b0 in range(0, n_pairs, DRAW_BLOCK):
        n = min(DRAW_BLOCK, n_pairs - b0)
        first = win_step0[None] + 2 * torch.arange(
            b0, b0 + n, device=lane.device)[:, None]
        w = rng.philox_words(key, first, lane[None].expand_as(first),
                             5 + 2 * extra)
        n1, n2 = (v.to(dt) for v in rng.fast_normal_pair(w[3], w[4]))
        dx1, dy1 = rng.unpack_pm1(w[0])
        dz1, dx2 = rng.unpack_pm1(w[1])
        dy2, dz2 = rng.unpack_pm1(w[2])
        dirs = [tuple(v.to(dt) for v in (dx1, dy1, dz1,
                                          _inv_norm(dx1, dy1, dz1))),
                tuple(v.to(dt) for v in (dx2, dy2, dz2,
                                          _inv_norm(dx2, dy2, dz2)))]
        nw = 5
        coins = kicks = (None, None)
        if var.reflect:
            coins = [rng.uniform(w[nw + h], F32).to(dt) for h in (0, 1)]
            nw += 2
        if var.intended:
            kicks = [rng.uniform(w[nw + h], F32).to(dt) for h in (0, 1)]
        for i in range(n):
            track = ph.pfreq % 4 != 0 or (b0 + i) % 2 == 1
            for h, nrm in enumerate((n1, n2)):
                d = dirs[h]
                yield (d[0][i], d[1][i], d[2][i], d[3][i], nrm[i],
                       None if coins[h] is None else coins[h][i],
                       None if kicks[h] is None else kicks[h][i],
                       h == 1 and track)


def intended_kick(u, per_step, kick_sd, in_cell):
    """The intended kick of a step from its uniform ``u``, where the
    walker is in a cell (else 0)."""
    c = u - 0.5
    cauchy = rng.sqrt_rn(1.0 / torch.clamp_min(2.0 * c.abs(), KICK_FLOOR)
                         - 1.0)
    kick = kick_sd * cauchy * torch.sign(c) + per_step
    return torch.where(in_cell, kick, torch.zeros_like(kick))


def chunk_steps(state, near, taylor, *, step0, lane, valid, key, ph: Phys,
                var: Variants, decompose: bool = False):
    """``chunk.chunk_steps`` with the membranes and the intended kick:
    the steps of one chunk from the anchors ``state[:3]`` (already
    wrapped) against ``near`` [4, K, W] and ``taylor`` [10, W]."""
    dev, dt = state.device, state.dtype
    w = state.shape[1]
    k = ph.near_k
    validf = valid.to(dt)
    cr2 = torch.tensor(ph.cell_r2, dtype=dt, device=dev)
    ax, ay, az = state[0], state[1], state[2]
    nx, ny, nz, nm = near
    tb0, tgx, tgy, tgz, thxx, thyy, thzz, thxy, thxz, thyz = taylor

    def field(px, py, pz):
        ddx, ddy, ddz = px - nx, py - ny, pz - nz
        dz2 = ddz * ddz
        dd2 = ddx * ddx + ddy * ddy + dz2
        rs = torch.rsqrt(dd2)
        rs2 = rs * rs
        contrib = nm * (3.0 * dz2 - dd2) * (rs2 * rs2 * rs)
        contrib = torch.where(dd2 > cr2, contrib, torch.zeros_like(contrib))
        b_near = contrib[0]
        for j in range(1, k):
            b_near = b_near + contrib[j]
        min_d2 = torch.clamp_max(dd2.min(0).values, 1e9)
        ex, ey, ez = px - ax, py - ay, pz - az
        b_far = (tb0 + tgx * ex + tgy * ey + tgz * ez
                 + 0.5 * (thxx * ex * ex + thyy * ey * ey + thzz * ez * ez)
                 + thxy * ex * ey + thxz * ex * ez + thyz * ey * ez)
        return b_near + b_far, min_d2

    def const(v):
        return torch.tensor(v, dtype=dt, device=dev)

    in_sd, out_sd, kick_c, zero = (const(ph.in_sd), const(ph.out_sd),
                                   const(ph.kick), const(0.0))
    rio, roi = const(var.reflect_io), const(var.reflect_oi)
    x, y, z = ax, ay, az
    phase, comp = state[4], state[5]
    phase_b, comp_b = (state[6], state[7]) if decompose else (None, None)
    bprev, mind2 = field(x, y, z)
    maxd2 = torch.zeros(w, dtype=dt, device=dev)
    n_win = ph.chunk_steps // ph.pfreq
    wins = torch.zeros((n_win, 2, w) if decompose
                       else (w // WARP, n_win, 2), dtype=dt, device=dev)
    for wi in range(n_win):
        win_step0 = (step0 + wi * ph.pfreq) & rng.MASK
        acc = torch.zeros(w, dtype=dt, device=dev)
        acc_b = torch.zeros(w, dtype=dt, device=dev) if decompose else None
        for dx, dy, dz, inv, nrm, coin, ukick, track in _draws(
                key, win_step0, lane, ph, var, dt):
            incell = mind2 < cr2
            mag = nrm * torch.where(incell, in_sd, out_sd) * inv
            x2, y2, z2 = x + dx * mag, y + dy * mag, z + dz * mag
            b, mind2_new = field(x2, y2, z2)
            in_new = mind2_new < cr2
            if var.reflect:
                back = ((incell & ~in_new & (coin < rio))
                        | (~incell & in_new & (coin < roi)))
                x2 = torch.where(back, x, x2)
                y2 = torch.where(back, y, y2)
                z2 = torch.where(back, z, z2)
                b = torch.where(back, bprev, b)
                in_new = torch.where(back, incell, in_new)
                mind2_new = torch.where(back, mind2, mind2_new)
            kick = b * ph.phase_per_tesla
            if var.intended:
                intra = intended_kick(ukick, ph.kick, var.kick_sd, in_new)
            else:
                intra = torch.where(in_new, kick_c, zero)
            if decompose:
                acc = acc + kick
                acc_b = acc_b + intra
            else:
                acc = acc + (kick + intra)
            if track:
                ex, ey, ez = x2 - ax, y2 - ay, z2 - az
                maxd2 = torch.maximum(maxd2, ex * ex + ey * ey + ez * ez)
            x, y, z, mind2, bprev = x2, y2, z2, mind2_new, b
        phase, comp = kahan(phase, comp, acc)
        if decompose:
            phase_b, comp_b = kahan(phase_b, comp_b, acc_b)
            wins[wi, 0] = phase
            wins[wi, 1] = phase_b
        else:
            wins[:, wi, 0] = (torch.cos(phase) * validf).reshape(
                -1, WARP).sum(1)
            wins[:, wi, 1] = (torch.sin(phase) * validf).reshape(
                -1, WARP).sum(1)
        flip = (((win_step0 + ph.pfreq) & rng.MASK) % ph.tcp) == 0
        sign = torch.where(flip, -1.0, 1.0).to(dt)
        phase, comp = phase * sign, comp * sign
        if decompose:
            phase_b, comp_b = phase_b * sign, comp_b * sign
    rows = [x, y, z, (mind2 < cr2).to(dt), phase, comp]
    out = torch.stack(rows + [phase_b, comp_b] if decompose else rows)
    esc = ((maxd2 > ph.travel2) & valid).to(dt)
    return out, esc, wins


class VariantReference(Reference):
    """``Reference`` with the configuration's variants: the scene, table,
    start and model of the default physics, the steps of
    ``chunk_steps`` above.  Scenes of up to ``REBUILD_MAX`` dipoles (the
    whole-table selection) only."""

    def __init__(self, cfg: dict, generator: str, scene: dict, seed: int,
                 device, dtype=torch.float32):
        # float32 products on the card, as the program's (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(cfg | DEFAULT_PHYSICS, generator, scene, seed,
                         device, dtype)
        self.var = variants_of(cfg)
        if self.large:
            raise NotImplementedError("the variants are served on scenes "
                                      "of the whole-table selection")

    def chunks(self, states, step0s, decompose: bool = False):
        """As ``Reference.chunks``."""
        ph, dev, dt = self.ph, self.dev, self.dt
        w_pad = states[0].shape[1]
        n = len(states)
        state = torch.cat([s.to(dev).to(dt) for s in states], 1)
        state = torch.cat([self.wrap(state[:3]), state[3:]])
        idx = torch.arange(w_pad, device=dev).repeat(n)
        valid = idx < ph.num_water
        step0 = torch.cat([torch.full((w_pad,), int(s) & rng.MASK,
                                      dtype=torch.int64, device=dev)
                           for s in step0s])
        near, taylor, cov = model.rebuild_model(
            state[:3], self.tbl, ph.near_k, ph.cell_r2, ph.travel, valid)
        out, esc, wins = chunk_steps(
            state, near, taylor, step0=step0, lane=idx, valid=valid,
            key=self.key, ph=ph, var=self.var, decompose=decompose)
        g = w_pad // WARP
        res = []
        for i in range(n):
            sl = slice(i * w_pad, (i + 1) * w_pad)
            res.append(ChunkResult(
                out[:, sl], esc[sl], cov[i * g:(i + 1) * g],
                wins[:, :, sl] if decompose else wins[i * g:(i + 1) * g],
                None, near[:, :, sl], taylor[:, sl]))
        return res

"""One chunk of the walk, in plain PyTorch, for many chunks side by side.

State layout: ``[6, W]`` (x, y, z, in_cell, phase, comp) or, for a
phase-decomposition run, ``[8, W]`` (x, y, z, in_cell, A, comp_A, B,
comp_B).  Each column is one walker of one chunk: ``step0`` [W] is its
chunk's first global step and ``lane`` [W] its generator lane, so the
chunks sampled from a run are worked out together.

Each step: the generator's words -> direction (cube: 2u - 1 per axis,
normalised) and normal -> step length sqrt(pi D tau) by the in-cell test
-> move -> field (K-near exact, masked within cell_r, plus the far
Taylor polynomial about the anchor) -> phase kick (field x phase per
tesla, plus the chemical-shift kick in a cell) -> escape tracking.
Each window of ``pfreq`` steps: a Kahan fold of the window's kicks into
the phase, the per-warp sums of (cos, sin) (or the per-walker record
(A, B)), then the Carr-Purcell flip where the window ends on a multiple
of ``tcp``.  The fast generator serves step pairs from Philox blocks at
the pair's first step: directions packed in 16-bit halves of words 0-2,
the normal pair from words 3-4; escapes are tracked at the second step
of each pair, or of every second pair when pfreq % 4 == 0.
"""

from __future__ import annotations

import torch

from . import rng
from .physics import Phys

WARP = 32
F32 = torch.float32
#: steps (Threefry) or step pairs (fast) whose words are drawn at once
DRAW_BLOCK = 250


def _inv_norm(dx, dy, dz):
    return torch.rsqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-12))


def _draws(key, win_step0, lane, ph: Phys, dt):
    """Per step of one window: (dx, dy, dz, inv_norm, normal, track),
    worked out in float32 and handed on in ``dt``."""
    if not ph.fast:
        for b0 in range(0, ph.pfreq, DRAW_BLOCK):
            n = min(DRAW_BLOCK, ph.pfreq - b0)
            offs = torch.arange(b0, b0 + n, device=lane.device)[:, None]
            w = rng.threefry_words(key, win_step0[None] + offs, lane[None],
                                   5, ph.rounds)
            u0, u1, u2 = (rng.uniform(x, F32) for x in w[:3])
            dx, dy, dz = 2.0 * u0 - 1.0, 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
            inv = _inv_norm(dx, dy, dz)
            nrm = rng.normal(w[3], w[4], F32)
            dx, dy, dz, inv, nrm = (v.to(dt) for v in (dx, dy, dz, inv, nrm))
            for i in range(n):
                yield dx[i], dy[i], dz[i], inv[i], nrm[i], True
        return
    n_pairs = ph.pfreq // 2
    for b0 in range(0, n_pairs, DRAW_BLOCK):
        n = min(DRAW_BLOCK, n_pairs - b0)
        first = win_step0[None] + 2 * torch.arange(
            b0, b0 + n, device=lane.device)[:, None]
        w = rng.philox_words(key, first, lane[None].expand_as(first), 5)
        n1, n2 = (v.to(dt) for v in rng.fast_normal_pair(w[3], w[4]))
        dx1, dy1 = rng.unpack_pm1(w[0])
        dz1, dx2 = rng.unpack_pm1(w[1])
        dy2, dz2 = rng.unpack_pm1(w[2])
        dirs = [tuple(v.to(dt) for v in (dx1, dy1, dz1,
                                          _inv_norm(dx1, dy1, dz1))),
                tuple(v.to(dt) for v in (dx2, dy2, dz2,
                                          _inv_norm(dx2, dy2, dz2)))]
        for i in range(n):
            track = ph.pfreq % 4 != 0 or (b0 + i) % 2 == 1
            for h, nrm in enumerate((n1, n2)):
                d = dirs[h]
                yield d[0][i], d[1][i], d[2][i], d[3][i], nrm[i], \
                    h == 1 and track
    if ph.pfreq % 2:
        raise NotImplementedError("odd output windows")


def kahan(phase, comp, acc):
    ky = acc - comp
    kt = phase + ky
    return kt, (kt - phase) - ky


def chunk_steps(state, near, taylor, *, step0, lane, valid, key, ph: Phys,
                decompose: bool = False):
    """The steps of one chunk from the anchors ``state[:3]`` (already
    wrapped) against ``near`` [4, K, W] and ``taylor`` [10, W].  Returns
    (state', esc [W], wins): per-warp (cos, sin) sums [W / 32, n_win, 2],
    or with ``decompose`` the per-walker record [n_win, 2, W]."""
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

    in_sd = torch.tensor(ph.in_sd, dtype=dt, device=dev)
    out_sd = torch.tensor(ph.out_sd, dtype=dt, device=dev)
    kick_c = torch.tensor(ph.kick, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    x, y, z = ax, ay, az
    phase, comp = state[4], state[5]
    phase_b, comp_b = (state[6], state[7]) if decompose else (None, None)
    _, mind2 = field(x, y, z)
    maxd2 = torch.zeros(w, dtype=dt, device=dev)
    n_win = ph.chunk_steps // ph.pfreq
    wins = torch.zeros((n_win, 2, w) if decompose
                       else (w // WARP, n_win, 2), dtype=dt, device=dev)
    for wi in range(n_win):
        win_step0 = (step0 + wi * ph.pfreq) & rng.MASK
        acc = torch.zeros(w, dtype=dt, device=dev)
        acc_b = torch.zeros(w, dtype=dt, device=dev) if decompose else None
        for dx, dy, dz, inv, nrm, track in _draws(key, win_step0, lane, ph,
                                                  dt):
            incell = mind2 < cr2
            mag = nrm * torch.where(incell, in_sd, out_sd) * inv
            x2, y2, z2 = x + dx * mag, y + dy * mag, z + dz * mag
            b, mind2_new = field(x2, y2, z2)
            in_new = mind2_new < cr2
            kick = b * ph.phase_per_tesla
            intra = torch.where(in_new, kick_c, zero)
            if decompose:
                acc = acc + kick
                acc_b = acc_b + intra
            else:
                acc = acc + (kick + intra)
            if track:
                ex, ey, ez = x2 - ax, y2 - ay, z2 - az
                maxd2 = torch.maximum(maxd2, ex * ex + ey * ey + ez * ez)
            x, y, z, mind2 = x2, y2, z2, mind2_new
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

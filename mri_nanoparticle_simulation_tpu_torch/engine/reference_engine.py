"""Walker state and the intracellular kick, in torch.

Counterpart of the parts of the reference's ``engine/reference_engine.py``
that the chunk-kernel path uses: ``WalkerState``, ``init_state``,
``intracellular_kick`` in all four kick modes, and the guard on the
sprint's launch-scalar overrides (``check_overrides``).  The torch-eager
scan engine is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mri_nanoparticle_simulation_tpu.params import (KICK_AS_WRITTEN,
                                                    KICK_CONSTANT,
                                                    KICK_INTENDED, KICK_NONE,
                                                    Params)

from .. import rng


class WalkerState(NamedTuple):
    """Everything that persists across sprints, field names as in the
    reference.  ``step`` is a host int: the sprint needs it to form the
    kernel's counters, and keeping it on the host costs no sync."""
    pos: torch.Tensor         # [W, 3] positions, µm
    in_cell: torch.Tensor     # [W] bool
    phase: torch.Tensor       # [W] accumulated phase, rad
    phase_comp: torch.Tensor  # [W] Kahan compensation for phase
    step: int                 # completed global steps
    escapes: torch.Tensor     # int64 scalar: chunk-anchor escapes
    #: int64 scalar: walker-chunks whose anchor had more dipoles within
    #: cell_r + travel than near_k (see the reference's WalkerState)
    coverage: torch.Tensor


def init_state(waters: np.ndarray, params: Params, device,
               dtype=torch.float32) -> WalkerState:
    """Walkers at ``waters`` [W, 3] with zero phase, on ``device``."""
    device = torch.device(device)
    w = waters.shape[0]
    zeros = torch.zeros(w, dtype=dtype, device=device)
    return WalkerState(
        pos=torch.as_tensor(np.asarray(waters), device=device).to(dtype),
        in_cell=torch.zeros(w, dtype=torch.bool, device=device),
        phase=zeros,
        phase_comp=zeros.clone(),
        step=0,
        escapes=torch.zeros((), dtype=torch.int64, device=device),
        coverage=torch.zeros((), dtype=torch.int64, device=device),
    )


def constant_kick(params: Params) -> float:
    """The constant part of the per-step intracellular phase kick
    (accumulatePhase, cuda_sim.cu:625-640).  KICK_AS_WRITTEN keeps the
    reference's precedence bug: only the chemical-shift term survives.
    KICK_INTENDED adds its Cauchy term (``cauchy_kick_sd``) to the same
    chemical-shift term."""
    mode = params.kick_mode
    if mode in (KICK_AS_WRITTEN, KICK_INTENDED):
        return float(params.chem_shift_kick)
    if mode == KICK_CONSTANT:
        return float(params.phase_k * params.tau)
    if mode == KICK_NONE:
        return 0.0
    raise ValueError(mode)


def cauchy_kick_sd(params: Params) -> float:
    """The scale of the intended kick's Cauchy term, phase_stdev * tau
    (a float64 product; the engines round it to float32 once)."""
    return float(params.phase_stdev * params.tau)


def intracellular_kick(per_step: float, in_cell: torch.Tensor, dtype,
                       u_kick: torch.Tensor | None = None,
                       kick_sd: float = 0.0):
    """The per-step kick where a walker is in a cell, else 0, as the
    reference's ``intracellular_kick`` (reference_engine.py:140-166).

    Without ``u_kick`` (the constant modes) the kick is ``per_step``
    (``constant_kick``), and None when that is 0 (adding +0.0 would
    change no phase).  With ``u_kick`` (KICK_INTENDED) it is
    ``kick_sd * cauchy * sign(u - 1/2) + per_step`` with ``cauchy =
    sqrt(1 / max(2 |u - 1/2|, 1e-12) - 1)`` and sign(0) = 0; the
    constants are float32 values."""
    if u_kick is None:
        if per_step == 0.0:
            return None
        c = torch.tensor(per_step, dtype=dtype, device=in_cell.device)
        return torch.where(in_cell, c, torch.zeros_like(c))
    centered = u_kick - 0.5
    floor = float(np.float32(1e-12))
    cauchy = rng.sqrt_rn(
        1.0 / torch.clamp_min(2.0 * centered.abs(), floor) - 1.0)
    kick = kick_sd * cauchy * torch.sign(centered) + per_step
    return torch.where(in_cell, kick, torch.zeros_like(kick))


def check_overrides(tcp=None, cell_r=None, d_scale=None, reflect=None):
    """Raise for a launch-scalar override the kernels cannot take, as the
    reference's ``_check_dyn_overrides`` (reference_engine.py:84-107):
    tcp, cell_r and d_scale must be > 0 (tcp = 0 would reach the
    kernel's ``step % tcp``), each of the (reflect_io, reflect_oi) pair
    in [0, 1].  None leaves the static value."""
    for name, v in (("tcp", tcp), ("cell_r", cell_r),
                    ("d_scale", d_scale)):
        if v is not None and float(v) <= 0:
            raise ValueError(f"{name} override must be > 0; got {float(v)}")
    if reflect is not None:
        for comp, v in zip(("reflect_io", "reflect_oi"), reflect):
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(
                    f"{comp} override must be in [0, 1]; got {float(v)}")

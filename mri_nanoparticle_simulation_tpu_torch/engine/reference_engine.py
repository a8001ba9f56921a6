"""The torch-eager scan engine, the walker state and the kicks.

Counterpart of the reference's ``engine/reference_engine.py``: the
correctness anchor beside the chunk kernels.  A sprint
(``make_sprint_fn``) is plain torch on tensors in eager mode, Python
loops where the reference has ``lax.scan``:

    sprint
      └─ windows (pfreq steps: one (Σcos φ, Σsin φ) output, the
         Carr-Purcell flip when the step count hits a multiple of tcp)
           └─ chunks (chunk_steps: the field model rebuilt at each chunk
              start, after the periodic wrap)
                └─ steps: Threefry draws -> displacement -> field and
                   residency -> membrane reflection -> kicks

when ``pfreq % chunk_steps == 0`` (window-major), and chunks outside
windows otherwise (chunk-major, ``chunk_steps`` a multiple of pfreq, the
chunk kernels' order).  Its field modes are the local expansion
(``fields.expansion.build`` with the far sums in torch, and
``evaluate``), the exact masked sum over every dipole, and the uniform
grid (``fields.grid``; positions wrapped every step).  Every physics
variant, the launch-scalar overrides (tcp, cell_r, d_scale, reflect),
the decompose state (A, B) and a float64 phase run as in the reference.

Its draws are the reference's Threefry words (c0 = step, c1 = lane +
(pair << 27)), drawn for a block of steps at once: the words depend only
on (key, step, lane), so a block gives what the steps would draw one by
one.  Everything else is a handful of torch ops per step, so autograd
differentiates a sprint (``inverse.py``): the draws and the near
selection are constants of the differentiation, as in the reference.

Also here: ``WalkerState``, ``init_state``, the intracellular kick in
all four modes and the guard on launch-scalar overrides, which the
chunk engine (``cuda_engine``) shares.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import rng
from ..fields import dipole, expansion
from ..fields import grid as grid_mod
from ..params import (DIRECTION_SPHERE, FIELD_EXACT, FIELD_GRID,
                      KICK_AS_WRITTEN, KICK_CONSTANT, KICK_INTENDED,
                      KICK_NONE, Params)


#: the sprint engines: the chunk kernels (``cuda_engine``, the reference's
#: Pallas engine) and this module's scan engine
ENGINES = ("pallas", "scan")


class WalkerState(NamedTuple):
    """Everything that persists across sprints, field names as in the
    reference.  ``step`` is a host int: the sprint needs it to form the
    kernel's counters, and keeping it on the host costs no sync."""
    pos: torch.Tensor         # [W, 3] positions, µm
    in_cell: torch.Tensor     # [W] bool
    phase: torch.Tensor       # [W] accumulated phase, rad ([W, 2] (A, B)
    #                           in a phase-decomposition run)
    phase_comp: torch.Tensor  # [W] Kahan compensation for phase
    step: int                 # completed global steps
    escapes: torch.Tensor     # int64 scalar: chunk-anchor escapes
    #: int64 scalar: walker-chunks whose anchor had more dipoles within
    #: cell_r + travel than near_k (see the reference's WalkerState)
    coverage: torch.Tensor


def init_state(waters: np.ndarray, params: Params, device,
               dtype=torch.float32, decompose: bool = False,
               phase_dtype=None) -> WalkerState:
    """Walkers at ``waters`` [W, 3] with zero phase, on ``device``.
    ``decompose`` builds the state of a phase-decomposition run: phase
    and phase_comp ``[W, 2]``, column 0 the dipole-field part A, column
    1 the kick part B (the reference's reference_engine.py:112-128).
    ``phase_dtype`` (default ``dtype``) is the phase's precision; the
    scan engine accumulates in it (a float64 phase beside float32
    positions isolates the accumulation's drift)."""
    device = torch.device(device)
    w = waters.shape[0]
    zeros = torch.zeros((w, 2) if decompose else w,
                        dtype=phase_dtype or dtype, device=device)
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
    in [0, 1].  None leaves the static value; a tensor (a d_scale with
    autograd) is read without its graph."""
    def value(v):
        return float(v.detach()) if isinstance(v, torch.Tensor) \
            else float(v)
    for name, v in (("tcp", tcp), ("cell_r", cell_r),
                    ("d_scale", d_scale)):
        if v is not None and value(v) <= 0:
            raise ValueError(f"{name} override must be > 0; got {value(v)}")
    if reflect is not None:
        for comp, v in zip(("reflect_io", "reflect_oi"), reflect):
            if not 0.0 <= value(v) <= 1.0:
                raise ValueError(
                    f"{comp} override must be in [0, 1]; got {value(v)}")


#: 2 pi in float32, the sphere direction's azimuth scale
TWO_PI = float(np.float32(2.0 * np.pi))


def inv_norm(dx, dy, dz):
    """1 / |(dx, dy, dz)|, the squared norm floored at 1e-12."""
    return torch.rsqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-12))


def direction(u0, u1, u2, sphere: bool):
    """Step direction from three uniforms: (dx, dy, dz, inv_norm), with
    inv_norm None where the direction is a unit vector already.  Cube
    (the reference's quirk): 2u - 1 per axis, normalised; sphere:
    cos(theta) = 2 u0 - 1 and azimuth 2 pi u1 (pallas_engine.py:512-525,
    reference_engine.py:336-350)."""
    if not sphere:
        dx, dy, dz = 2.0 * u0 - 1.0, 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
        return dx, dy, dz, inv_norm(dx, dy, dz)
    cos_t = 2.0 * u0 - 1.0
    sin_t = rng.sqrt_rn(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = TWO_PI * u1
    return sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t, None


def wrap(v: torch.Tensor, bound) -> torch.Tensor:
    """``jnp.mod(v + bound, bound)``: fmod with the sign fixed."""
    r = torch.fmod(v + bound, bound)
    return torch.where((r != 0) & (r < 0), r + bound, r)


class _AnchorOnly(NamedTuple):
    """The field model of the modes that query positions directly (grid,
    exact): only the chunk's anchor, for the travel bound."""
    anchor: torch.Tensor


#: steps x walkers of one block of draws (bounds the int64 words' memory)
DRAW_BLOCK = 1 << 22


def make_sprint_fn(params: Params, device, field_grid=None,
                   phase_dtype=None, decompose: bool = False,
                   dtype=torch.float32):
    """The scan engine's sprint: ``sprint(mnp_pos, mnp_M, key, state,
    lane_offset=0, tcp=None, cell_r=None, d_scale=None, reflect=None) ->
    (state', windows)``, as the reference's ``make_sprint_fn``
    (reference_engine.py:175-551).

    ``mnp_pos`` [N, 3] and ``mnp_M`` [N] are the dipoles with images,
    ``key`` the Threefry key words (``convert.key_words``), ``state`` a
    ``WalkerState`` on ``device``; ``windows`` is [n_windows, 2] (Σcos φ,
    Σsin φ) per output window.  ``lane_offset`` shifts the walkers'
    generator lanes.  ``tcp`` (steps), ``cell_r`` (µm), ``d_scale`` (the
    diffusion scale; both stdevs times its square root) and ``reflect``
    (a (reflect_io, reflect_oi) pair, with reflection on in ``params``)
    override their ``params`` values for this call.  ``d_scale`` and
    ``mnp_M`` may carry autograd.

    ``field_grid`` (``fields.grid.build_grid``, once per scene) is needed
    when ``params.field_mode == "grid"``.  ``phase_dtype`` (default
    ``dtype``) is the phase's precision.  ``decompose`` runs the
    phase-decomposition sprint: the state's phase and comp are [W, 2]
    (A, B) (``init_state(decompose=True)``), A the dipole-field part and
    B the kicks', and ``windows`` is the per-walker record
    [n_windows, W, 2].

    Raises, as the reference's ``guarded``: for a cell_r override in grid
    mode (the grid's residents were chosen for the static radius), for
    reflect overrides without reflection in ``params``, and for
    overrides out of range (``check_overrides``)."""
    params.validate()
    device = torch.device(device)
    pdt = phase_dtype or dtype
    window_major = params.pfreq % params.chunk_steps == 0
    if not window_major and params.chunk_steps % params.pfreq != 0:
        raise ValueError("chunk_steps must divide or be a multiple of pfreq")
    n_windows = params.sprint_steps // params.pfreq
    npdt = np.float32 if dtype == torch.float32 else np.float64

    def rnd(v):
        """A constant rounded to the engine's dtype, as ``dtype(v)``."""
        return float(npdt(v))

    travel_f = float(expansion.default_travel_bound(params))
    travel2 = rnd(travel_f ** 2)
    use_reflection = params.reflect_io > 0 or params.reflect_oi > 0
    use_kick_u = params.kick_mode == KICK_INTENDED
    n_words = 7 if (use_reflection or use_kick_u) else 5
    sphere = params.direction_mode == DIRECTION_SPHERE
    in_stdev, out_stdev = rnd(params.in_stdev), rnd(params.out_stdev)
    phase_per_tesla = rnd(params.phase_per_tesla)
    gradient = tuple(rnd(g) for g in params.b0_gradient) \
        if params.use_gradient else None
    kick_const = None if params.kick_mode == KICK_NONE \
        else constant_kick(params)
    kick_sd = cauchy_kick_sd(params) if use_kick_u else 0.0
    exact_mode = params.field_mode == FIELD_EXACT
    grid_mode = params.field_mode == FIELD_GRID
    if grid_mode:
        if field_grid is None:
            raise ValueError("field_mode='grid' requires a prebuilt "
                             "field_grid (fields.grid.build_grid)")
        # the grid clamps out-of-box queries, so grid mode wraps every
        # step, the reference's per-step boundary_conditions
        # (cuda_sim.cu:597-601), and no chunk travel bound applies
        travel2 = float("inf")

    def const(v):
        return torch.tensor(v, dtype=dtype, device=device)

    def draws(key, base, n_steps, lane):
        """Per step of ``base .. base + n_steps - 1``: (dx, dy, dz,
        inv_norm, normal, coin, kick uniform), drawn a block at a time."""
        block = max(1, min(n_steps, DRAW_BLOCK // lane.shape[0]))
        for s0 in range(0, n_steps, block):
            nb = min(block, n_steps - s0)
            offs = torch.arange(nb, device=device)[:, None]
            words = rng.words_for_step(key, base + s0 + offs, lane[None, :],
                                       n_words, rounds=params.rng_rounds)
            u = [rng.uniform_from_bits(wd, dtype) for wd in words[:3]]
            dx, dy, dz, inorm = direction(*u, sphere)
            nrm = rng.normal_from_bits(words[3], words[4], dtype)
            coin = rng.uniform_from_bits(words[5], dtype) \
                if n_words > 5 else None
            ukick = rng.uniform_from_bits(words[6], dtype) \
                if n_words > 6 else None
            for i in range(nb):
                yield (dx[i], dy[i], dz[i],
                       None if inorm is None else inorm[i], nrm[i],
                       None if coin is None else coin[i],
                       None if ukick is None else ukick[i])

    def sprint(mnp_pos, mnp_M, key, state: WalkerState, lane_offset=0,
               tcp=None, cell_r=None, d_scale=None, reflect=None):
        if grid_mode and cell_r is not None:
            raise ValueError(
                "cell_r runtime overrides are not supported in "
                "field_mode='grid': the grid's resident lists were built "
                "for the static cell_r — rebuild the grid instead")
        if reflect is not None and not use_reflection:
            raise ValueError(
                "reflect overrides need reflection enabled in the static "
                "params (e.g. params.with_permeability()); the engine "
                "was built with reflect_io = reflect_oi = 0")
        check_overrides(tcp, cell_r, d_scale, reflect)
        if state.pos.device.type != device.type or (
                device.index is not None
                and state.pos.device.index != device.index):
            raise ValueError(f"state is on {state.pos.device}, the sprint "
                             f"was built for {device}")
        n_mnp = mnp_pos.shape[0]
        if not grid_mode and params.near_k > n_mnp:
            raise ValueError(
                f"near_k={params.near_k} exceeds the number of dipoles "
                f"({n_mnp}); selection would duplicate entries and "
                f"double-count their field")
        bound = const(params.bound)
        cr = const(params.cell_r if cell_r is None else cell_r)
        tcp_i = params.tcp if tcp is None else int(tcp)
        dstd = const(1.0) if d_scale is None \
            else torch.sqrt(torch.as_tensor(d_scale, device=device)
                            .to(dtype))
        rio = const(params.reflect_io if reflect is None else reflect[0])
        roi = const(params.reflect_oi if reflect is None else reflect[1])
        in_sd, out_sd = const(in_stdev), const(out_stdev)
        w = state.pos.shape[0]
        lane = (torch.arange(w, device=device) + int(lane_offset)) & rng.MASK
        cache = None
        if not grid_mode and not exact_mode \
                and expansion.uses_large_path(w, n_mnp):
            with torch.no_grad():
                cache = expansion.build_cache(mnp_pos, mnp_M, params,
                                              far_table=False)
        reach = cr + travel_f
        reach2 = reach * reach

        def field_at(nf, pos):
            """(B, in_cell) at ``pos``: expansion, grid or exact."""
            if grid_mode:
                return grid_mod.query(field_grid, pos, cr)
            if not exact_mode:
                b, in_c, _ = expansion.evaluate(nf, pos, cr)
                return b, in_c
            d = pos[:, None, :] - mnp_pos
            d2 = torch.sum(d * d, -1)
            b = dipole.total_field_masked(pos, mnp_pos, mnp_M, cr)
            return b, torch.any(d2 < cr * cr, -1)

        def chunk_start(pos):
            """Wrap, rebuild the field model at the new anchors and
            evaluate it there: (pos, model, coverage count, B, in_cell).
            The exact and grid modes keep only the anchor (the
            reference builds an expansion in exact mode and uses no more
            of it)."""
            pos = wrap(pos, bound)
            if grid_mode or exact_mode:
                nf, cov = _AnchorOnly(pos), 0
            else:
                nf = expansion.build(pos, mnp_pos, mnp_M, params,
                                     cache=cache, reach2=reach2,
                                     far_impl="torch")
                cov = torch.sum(nf.n_reach > params.near_k)
            b0, in0 = field_at(nf, pos)
            return pos, nf, cov, b0, in0

        def steps(nf, carry, base, n_steps):
            """``n_steps`` steps from global step ``base``."""
            pos, in_cell, b_prev, acc, max_d2 = carry
            for dx, dy, dz, inorm, nrm, coin, ukick in draws(
                    key, base, n_steps, lane):
                mag = nrm * torch.where(in_cell, in_sd, out_sd)
                if inorm is not None:
                    mag = mag * inorm
                mag = mag * dstd
                new_pos = pos + torch.stack([dx * mag, dy * mag, dz * mag],
                                            -1)
                if grid_mode:
                    new_pos = wrap(new_pos, bound)
                b, in_new = field_at(nf, new_pos)
                if use_reflection:
                    # cell_reflect (cuda_sim.cu:502-509): a bounce
                    # reverts position, field and residency
                    flip = ((in_cell & ~in_new & (coin < rio))
                            | (~in_cell & in_new & (coin < roi)))
                    new_pos = torch.where(flip[:, None], pos, new_pos)
                    b = torch.where(flip, b_prev, b)
                    in_new = torch.where(flip, in_cell, in_new)
                kick = b * phase_per_tesla
                intra = None if kick_const is None else \
                    intracellular_kick(kick_const, in_new, dtype, ukick,
                                       kick_sd)
                if gradient is not None:
                    bg = (new_pos[:, 0] * gradient[0]
                          + new_pos[:, 1] * gradient[1]
                          + new_pos[:, 2] * gradient[2]) * phase_per_tesla
                    intra = bg if intra is None else intra + bg
                if decompose:
                    acc = acc + torch.stack(
                        [kick, torch.zeros_like(kick) if intra is None
                         else intra], -1).to(acc.dtype)
                else:
                    if intra is not None:
                        kick = kick + intra
                    acc = acc + kick.to(acc.dtype)
                delta = new_pos - nf.anchor
                max_d2 = torch.maximum(max_d2, torch.sum(delta * delta, -1))
                pos, in_cell, b_prev = new_pos, in_new, b
            return pos, in_cell, b_prev, acc, max_d2

        def emit(phase, comp, acc, end_step):
            """Kahan fold, the window's output, then the Carr-Purcell
            flip when ``end_step`` is a multiple of tcp (performUpdate,
            cuda_sim.cu:814-828, 1015-1020)."""
            y = acc - comp
            t = phase + y
            comp = (t - phase) - y
            phase = t
            out = phase if decompose else torch.stack(
                [torch.sum(torch.cos(phase)), torch.sum(torch.sin(phase))])
            if (end_step & rng.MASK) % tcp_i == 0:
                phase, comp = -phase, -comp
            return phase, comp, out

        def zeros_acc():
            return torch.zeros((w, 2) if decompose else w, dtype=pdt,
                               device=device)

        zero_d2 = torch.zeros(w, dtype=dtype, device=device)
        pos, in_cell = state.pos, state.in_cell
        phase, comp = state.phase, state.phase_comp
        step, escapes, coverage = state.step, state.escapes, state.coverage
        outs = []
        if window_major:
            for _ in range(n_windows):
                acc = zeros_acc()
                for c in range(params.pfreq // params.chunk_steps):
                    pos, nf, cov, b0, in0 = chunk_start(pos)
                    coverage = coverage + cov
                    pos, in_cell, _, acc, max_d2 = steps(
                        nf, (pos, in0, b0, acc, zero_d2),
                        step + c * params.chunk_steps, params.chunk_steps)
                    escapes = escapes + torch.sum(max_d2 > travel2)
                step += params.pfreq
                phase, comp, out = emit(phase, comp, acc, step)
                outs.append(out)
        else:
            for _ in range(params.sprint_steps // params.chunk_steps):
                pos, nf, cov, b_prev, in_cell = chunk_start(pos)
                coverage = coverage + cov
                max_d2 = zero_d2
                for wi in range(params.chunk_steps // params.pfreq):
                    base = step + wi * params.pfreq
                    pos, in_cell, b_prev, acc, max_d2 = steps(
                        nf, (pos, in_cell, b_prev, zeros_acc(), max_d2),
                        base, params.pfreq)
                    phase, comp, out = emit(phase, comp, acc,
                                            base + params.pfreq)
                    outs.append(out)
                escapes = escapes + torch.sum(max_d2 > travel2)
                step += params.chunk_steps
        return (WalkerState(pos=pos, in_cell=in_cell, phase=phase,
                            phase_comp=comp, step=step, escapes=escapes,
                            coverage=coverage),
                torch.stack(outs))

    return sprint


def run_simulation(scene, params: Params, seed: int = 0, *, device,
                   dtype=torch.float32, max_steps: int | None = None,
                   phase_dtype=None):
    """Single-device run of the scan engine (the reference's
    ``reference_engine.run_simulation``): returns (times_ms, sum_cos,
    sum_sin, WalkerState) with the sums as NumPy arrays; grid mode
    builds its grid first."""
    device = torch.device(device)
    mnp_pos = torch.as_tensor(np.asarray(scene.mnps[:, :3]),
                              device=device).to(dtype)
    mnp_M = torch.as_tensor(np.asarray(scene.mnps[:, 4]),
                            device=device).to(dtype)
    field_grid = None
    if params.field_mode == FIELD_GRID:
        field_grid = grid_mod.build_grid(
            mnp_pos, mnp_M, params, grid_n=params.grid_n,
            max_residents=params.grid_max_residents, dtype=dtype)
    sprint = make_sprint_fn(params, device, field_grid=field_grid,
                            phase_dtype=phase_dtype, dtype=dtype)
    key = rng.key_from_seed(seed)
    state = init_state(scene.waters, params, device, dtype,
                       phase_dtype=phase_dtype)
    total = params.t if max_steps is None else min(params.t, max_steps)
    outs = []
    for _ in range(total // params.sprint_steps):
        state, wins = sprint(mnp_pos, mnp_M, key, state)
        outs.append(wins)
    wins = (torch.cat(outs).cpu().numpy() if outs
            else np.zeros((0, 2), np.float32))
    times = (np.arange(1, len(wins) + 1) * params.pfreq) * params.tau
    return times, wins[:, 0], wins[:, 1], state

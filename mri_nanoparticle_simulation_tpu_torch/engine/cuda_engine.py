"""Chunk engine: sprints of chunk-kernel launches, and the plain chunks.

Counterpart of the reference's ``engine/pallas_engine.py`` with the
Threefry RNG and the default physics, on both of its paths:

* scenes of at most ``REBUILD_MAX_MNPS`` dipoles: one chunk of
  ``chunk_steps`` steps is one launch of the rebuild kernel
  (``chunk_kernel.run_chunk``), which selects and sums over the whole
  table itself;
* larger scenes (pallas_engine.py:991-1078): each chunk wraps the
  positions, builds the field model outside the chunk kernel, either by
  the candidate-model kernel over a scene cache with a far table
  (``expansion.build_planes``) or by ``expansion.build`` with the
  far-sums kernel, counts coverage there, and launches the chunk kernel
  in near/taylor mode (``chunk_kernel.run_chunk_near``).

A sprint is a Python loop over chunks that never syncs with the host.

Walker layout: structure of arrays ``f32[6, W_pad]`` (x, y, z, in_cell,
phase, phase_comp), one CUDA thread per walker, W_pad the walker count
rounded up to the kernel's block size.  Padding walkers start at the box
centre and are masked out of every sum.

``chunk_reference`` and ``chunk_near_reference`` are the plain PyTorch
versions of one chunk in each mode, with the kernel's inputs, outputs and
arithmetic; both build a model and run the one step loop
(``_chunk_steps``).  The wrappers use them for CPU tensors; on a card
they are only the yardsticks the kernels are held against.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mri_nanoparticle_simulation_tpu.params import (DIRECTION_CUBE,
                                                    Params)

from .. import rng
from ..fields import expansion
from ..fields.dipole import FIELD_SCALE
from . import chunk_kernel
from .reference_engine import WalkerState, constant_kick, intracellular_kick

RNG_THREEFRY = "threefry"
RNG_HARDWARE = "hardware"

#: dipole-table limit of the in-kernel rebuild: the table is copied into
#: each block's shared memory (f32[4, 2048] = 32 KB)
REBUILD_MAX_MNPS = chunk_kernel.MAX_MNPS
#: threads per block; W_pad is a multiple of it
BLOCK = chunk_kernel.BLOCK
#: random words per walker-step on this path: direction xyz + normal pair
N_WORDS = 5


class ChunkPhysics(NamedTuple):
    """The static physics of one chunk, every float already rounded to
    float32 (the kernel's and the reference kernel's constants)."""
    chunk_steps: int
    pfreq: int
    near_k: int
    rounds: int
    in_stdev: float
    out_stdev: float
    phase_per_tesla: float
    kick: float           # per-step intracellular kick while in a cell
    bound: float
    travel: float         # per-chunk travel bound, µm
    travel2: float        # its square (the escape threshold)


class SoAState(NamedTuple):
    """Walker state in the kernel's layout."""
    planes: torch.Tensor   # f32[6, W_pad]: x, y, z, in_cell, phase, comp
    step: int              # completed global steps
    escapes: torch.Tensor  # int64 scalar
    coverage: torch.Tensor  # int64 scalar


class MnpTable(NamedTuple):
    """Packed dipole table: ``tbl`` f32[4, n_pad] (x, y, z,
    M * FIELD_SCALE), padded to a multiple of 8 with zero-moment entries
    1e6 µm away; ``n_mnp`` counts the real dipoles; ``pos`` [n_mnp, 3]
    and ``m`` [n_mnp] (unscaled) are the same dipoles for the large-scene
    selection."""
    tbl: torch.Tensor
    n_mnp: int
    pos: torch.Tensor
    m: torch.Tensor


def _f32(v: float) -> float:
    return float(np.float32(v))


def chunk_physics(params: Params) -> ChunkPhysics:
    """The kernel's static arguments for ``params``; raises
    NotImplementedError for physics this slice does not port."""
    if params.reflect_io > 0 or params.reflect_oi > 0:
        raise NotImplementedError(
            "membrane reflection (reflect_io/reflect_oi > 0) is not ported "
            "yet: ROADMAP Queue 2, chunk-kernel mode 1e")
    if params.direction_mode != DIRECTION_CUBE:
        raise NotImplementedError(
            "direction_mode='sphere' is not ported yet: ROADMAP Queue 2, "
            "chunk-kernel mode 1e")
    if params.use_gradient:
        raise NotImplementedError(
            "a nonzero b0_gradient is not ported yet: ROADMAP Queue 2, "
            "chunk-kernel mode 1e")
    if params.chunk_steps % params.pfreq != 0:
        raise NotImplementedError(
            "chunk_steps that are not a multiple of pfreq are not ported "
            "yet: ROADMAP Queue 2, chunk-kernel mode 1e")
    kick = constant_kick(params)      # raises for the intended kick
    travel2 = float(expansion.default_travel_bound(params) ** 2)
    return ChunkPhysics(
        chunk_steps=params.chunk_steps, pfreq=params.pfreq,
        near_k=params.near_k, rounds=params.rng_rounds,
        in_stdev=_f32(params.in_stdev), out_stdev=_f32(params.out_stdev),
        phase_per_tesla=_f32(params.phase_per_tesla), kick=_f32(kick),
        bound=_f32(params.bound), travel=_f32(np.sqrt(travel2)),
        travel2=_f32(travel2))


def cell_r2_f32(cell_r: float) -> float:
    """cell_r^2 as the product of two f32 values, rounded to f32 (the
    reference engines' rounding; squaring in f64 is an ulp off for radii
    like 0.55)."""
    cr = np.float32(cell_r)
    return float(cr * cr)


def check_scene(params: Params, n_mnp: int) -> None:
    """Raise for a scene this path cannot run."""
    if params.near_k > n_mnp:
        raise ValueError(
            f"near_k={params.near_k} exceeds the number of dipoles "
            f"({n_mnp}); selection would duplicate entries and "
            f"double-count their field")


def needs_cache(num_water: int, n_mnp: int) -> bool:
    """Whether a run of ``num_water`` walkers over ``n_mnp`` dipoles
    selects through the scene cache: above the rebuild kernel's table
    limit, where the whole-table selection would be large (the
    reference's sim.py:172-179 and pallas_engine.py:993-999)."""
    return (n_mnp > REBUILD_MAX_MNPS
            and expansion.uses_large_path(pad_count(num_water), n_mnp))


def pad_count(num_water: int) -> int:
    """Walkers padded to whole thread blocks."""
    return -(-num_water // BLOCK) * BLOCK


def to_soa(state: WalkerState, params: Params) -> SoAState:
    """[W]-vector state -> padded ``f32[6, W_pad]`` planes on the state's
    device.  Padding walkers start at the box centre."""
    w = state.pos.shape[0]
    wp = pad_count(w)
    planes = torch.zeros((6, wp), dtype=state.pos.dtype,
                         device=state.pos.device)
    planes[:3, w:] = torch.tensor(params.bound / 2, dtype=state.pos.dtype)
    planes[:3, :w] = state.pos.T
    planes[3, :w] = state.in_cell.to(state.pos.dtype)
    planes[4, :w] = state.phase
    planes[5, :w] = state.phase_comp
    return SoAState(planes, int(state.step), state.escapes, state.coverage)


def from_soa(ss: SoAState, num_water: int) -> WalkerState:
    pl = ss.planes[:, :num_water]
    return WalkerState(pos=pl[:3].T.contiguous(), in_cell=pl[3] > 0.5,
                       phase=pl[4].clone(), phase_comp=pl[5].clone(),
                       step=ss.step, escapes=ss.escapes,
                       coverage=ss.coverage)


def _wrap(v: torch.Tensor, bound: float) -> torch.Tensor:
    """``jnp.mod(v + bound, bound)``: fmod with the sign fixed."""
    r = torch.fmod(v + bound, bound)
    return torch.where((r != 0) & (r < 0), r + bound, r)


def chunk_reference(state, mnp, *, step0, key, lane_offset, num_water,
                    tcp, cell_r2, dstd, phys: ChunkPhysics):
    """One rebuild-mode chunk in plain PyTorch: the CUDA rebuild kernel's
    contract.

    ``state`` f32[6, W_pad], ``mnp`` f32[4, n_pad] (the packed table).
    Returns ``(state' f32[6, W_pad], esc f32[W_pad], cov f32[n_blocks],
    wins f32[n_blocks, n_win, 2])``: per-walker escape flags, per-block
    coverage-violation counts and per-block window sums (Σcos φ, Σsin φ),
    all masked to the ``num_water`` real walkers.

    Chunk start: periodic wrap; exact K-nearest selection by sorted
    insertion over the table; the coverage count within
    (cell_r + travel)^2; the far Taylor sums without the K selected.
    Then the steps (``_chunk_steps``)."""
    dev, dt = state.device, state.dtype
    wp = state.shape[1]
    k = phys.near_k
    valid = torch.arange(wp, device=dev) < num_water

    ax, ay, az = (_wrap(state[i], phys.bound) for i in range(3))
    cr2 = torch.tensor(cell_r2, dtype=dt, device=dev)
    reach = torch.sqrt(cr2) + phys.travel
    reach2 = reach * reach
    dx = ax - mnp[0][:, None]                           # [n_pad, W]
    dy = ay - mnp[1][:, None]
    dz = az - mnp[2][:, None]
    d2 = dx * dx + dy * dy + dz * dz
    cnt = (d2 < reach2).sum(0)
    d2s = torch.full((k, wp), 1e30, dtype=dt, device=dev)
    near = torch.zeros((4, k, wp), dtype=dt, device=dev)
    near[:3] = 1e9                      # unfilled slots: far, zero moment
    ids = torch.full((k, wp), -1, dtype=torch.int64, device=dev)
    for j in range(mnp.shape[1]):
        d2s, near, ids = expansion.sorted_insert(
            d2s, near, ids, d2[j], mnp[:, j:j + 1], j)
    cov = ((cnt > k) & valid).to(dt).reshape(-1, BLOCK).sum(1)
    anchor = torch.stack([ax, ay, az])
    taylor = expansion.far_sums_reference(anchor, mnp, ids)
    out, esc, wins = _chunk_steps(state, anchor, near, taylor, step0=step0,
                                  key=key, lane_offset=lane_offset,
                                  num_water=num_water, tcp=tcp,
                                  cell_r2=cell_r2, dstd=dstd, phys=phys)
    return out, esc, cov, wins


def chunk_near_reference(state, near, taylor, *, step0, key, lane_offset,
                         num_water, tcp, cell_r2, dstd, phys: ChunkPhysics):
    """One near/taylor-mode chunk in plain PyTorch: the CUDA
    ``chunk_near_kernel``'s contract.  ``state`` f32[6, W_pad] is already
    wrapped and is the anchor; ``near`` f32[4, K, W_pad] (x, y, z,
    M * FIELD_SCALE) and ``taylor`` f32[10, W_pad] are the model.
    Returns (state', esc, cov, wins) as ``chunk_reference``, with cov
    all zero (coverage is counted where the model is selected)."""
    out, esc, wins = _chunk_steps(state, state[:3], near, taylor,
                                  step0=step0, key=key,
                                  lane_offset=lane_offset,
                                  num_water=num_water, tcp=tcp,
                                  cell_r2=cell_r2, dstd=dstd, phys=phys)
    cov = torch.zeros(state.shape[1] // BLOCK, dtype=state.dtype,
                      device=state.device)
    return out, esc, cov, wins


def _chunk_steps(state, anchor, near, taylor, *, step0, key, lane_offset,
                 num_water, tcp, cell_r2, dstd, phys: ChunkPhysics):
    """The steps of one chunk from ``anchor`` [3, W] against the model
    ``near`` [4, K, W] and ``taylor`` [10, W], phases from ``state``.
    Each step: Threefry words -> cube direction and Box-Muller normal ->
    move -> masked K-near field + far Taylor -> kick.  Each window: Kahan
    fold, sums, then the Carr-Purcell flip.  Returns (state', esc,
    wins)."""
    dev, dt = state.device, state.dtype
    wp = state.shape[1]
    n_blk = wp // BLOCK
    k = phys.near_k

    def const(v):
        return torch.tensor(v, dtype=dt, device=dev)

    cr2 = const(cell_r2)
    idx = torch.arange(wp, device=dev)
    valid = idx < num_water
    validf = valid.to(dt)
    lane = (idx + lane_offset) & rng.MASK
    ax, ay, az = anchor
    nx, ny, nz, nm = near
    tb0, tgx, tgy, tgz, thxx, thyy, thzz, thxy, thxz, thyz = taylor

    def eval_field(px, py, pz):
        """Masked K-near sum + far Taylor; returns (B, min_j d2_j)."""
        ddx = px - nx
        ddy = py - ny
        ddz = pz - nz
        dz2 = ddz * ddz
        dd2 = ddx * ddx + ddy * ddy + dz2
        rs = torch.rsqrt(dd2)
        rs2 = rs * rs
        inv_r5 = rs2 * rs2 * rs
        contrib = nm * (3.0 * dz2 - dd2) * inv_r5
        contrib = torch.where(dd2 > cr2, contrib, torch.zeros_like(contrib))
        b_near = contrib[0]
        for j in range(1, k):
            b_near = b_near + contrib[j]
        min_d2 = torch.clamp_max(dd2.min(0).values, 1e9)
        ex = px - ax
        ey = py - ay
        ez = pz - az
        b_far = (tb0 + tgx * ex + tgy * ey + tgz * ez
                 + 0.5 * (thxx * ex * ex + thyy * ey * ey
                          + thzz * ez * ez)
                 + thxy * ex * ey + thxz * ex * ez + thyz * ey * ez)
        return b_near + b_far, min_d2

    in_sd = const(phys.in_stdev) * dstd
    out_sd = const(phys.out_stdev) * dstd
    x, y, z = ax, ay, az
    phase, comp = state[4], state[5]
    _, mind2 = eval_field(x, y, z)
    maxd2 = torch.zeros(wp, dtype=dt, device=dev)
    n_win = phys.chunk_steps // phys.pfreq
    wins = torch.zeros((n_blk, n_win, 2), dtype=dt, device=dev)
    offs = torch.arange(phys.pfreq, device=dev)[:, None]
    for w in range(n_win):
        win_step0 = (step0 + w * phys.pfreq) & rng.MASK
        # the whole window's words in one batched draw: [pfreq, W]
        words = rng.words_for_step(key, win_step0 + offs, lane, N_WORDS,
                                   rounds=phys.rounds)
        u0, u1, u2 = (rng.uniform_from_bits(wd, dt) for wd in words[:3])
        nrm = rng.normal_from_bits(words[3], words[4], dt)
        acc = torch.zeros(wp, dtype=dt, device=dev)
        for i in range(phys.pfreq):
            incell = mind2 < cr2
            ux = 2.0 * u0[i] - 1.0
            uy = 2.0 * u1[i] - 1.0
            uz = 2.0 * u2[i] - 1.0
            inv_norm = torch.rsqrt(
                torch.clamp_min(ux * ux + uy * uy + uz * uz, 1e-12))
            mag = nrm[i] * torch.where(incell, in_sd, out_sd) * inv_norm
            x = x + ux * mag
            y = y + uy * mag
            z = z + uz * mag
            b, mind2 = eval_field(x, y, z)
            kick = b * phys.phase_per_tesla
            intra = intracellular_kick(phys.kick, mind2 < cr2, dt)
            if intra is not None:
                kick = kick + intra
            acc = acc + kick
            ex = x - ax
            ey = y - ay
            ez = z - az
            maxd2 = torch.maximum(maxd2, ex * ex + ey * ey + ez * ez)
        # Kahan fold (performUpdate, cuda_sim.cu:814-828), then emit
        ky = acc - comp
        kt = phase + ky
        comp = (kt - phase) - ky
        phase = kt
        wins[:, w, 0] = (torch.cos(phase) * validf).reshape(
            n_blk, BLOCK).sum(1)
        wins[:, w, 1] = (torch.sin(phase) * validf).reshape(
            n_blk, BLOCK).sum(1)
        # Carr-Purcell flip after emission (cuda_sim.cu:1015-1020)
        if ((win_step0 + phys.pfreq) & rng.MASK) % tcp == 0:
            phase = -phase
            comp = -comp

    out = torch.stack([x, y, z, (mind2 < cr2).to(dt), phase, comp])
    esc = ((maxd2 > phys.travel2) & valid).to(dt)
    return out, esc, wins


def make_sprint_fn(params: Params, num_water: int, device,
                   dtype=torch.float32, rng_impl: str = RNG_THREEFRY):
    """``sprint(mnp_tbl, key, state, lane_offset=0, cache=None) ->
    (state', wins)``: ``params.sprint_steps`` steps as a loop of chunk
    launches.

    ``mnp_tbl`` is an ``MnpTable`` (``convert.mnp_table``), ``key`` the
    Threefry key words (``convert.key_words``), ``state`` an ``SoAState``
    and ``wins`` f32[n_windows, 2] (Σcos φ, Σsin φ) on the device.
    ``cache`` (``expansion.SceneCache``, from ``expansion.build_cache``
    once per scene) serves scenes above ``REBUILD_MAX_MNPS`` dipoles; a
    large scene without one gets a cache without far table, built in
    each sprint call, as in the reference.  The loop never reads the
    device, so sprints queue behind each other."""
    params.validate()
    if rng_impl == RNG_HARDWARE:
        raise NotImplementedError(
            "rng_impl='hardware' (a fast in-kernel generator in place of "
            "the TPU's PRNG) is not ported yet: ROADMAP Queue 2, "
            "chunk-kernel mode 1b")
    if rng_impl != RNG_THREEFRY:
        raise ValueError(f"unknown rng_impl {rng_impl!r}")
    if dtype != torch.float32:
        raise ValueError("the chunk kernel runs in float32")
    phys = chunk_physics(params)
    if params.sprint_steps % params.chunk_steps != 0:
        raise ValueError("sprint_steps must be a multiple of chunk_steps")
    n_chunks = params.sprint_steps // params.chunk_steps
    cr2 = cell_r2_f32(params.cell_r)
    device = torch.device(device)
    k = params.near_k
    reach2 = expansion.coverage_reach2(params)

    def large_model(planes, tbl: MnpTable, cache):
        """The field model of one large-scene chunk at the wrapped
        anchors ``planes[:3]``: (near, taylor, n_reach)."""
        if cache is not None and cache.far_coeffs is not None:
            return expansion.build_planes(planes[:3], params, cache,
                                          reach2=reach2)
        nf = expansion.build(planes[:3].T, tbl.pos, tbl.m, params,
                             cache=cache, reach2=reach2, tbl=tbl.tbl)
        m = nf.near_M * torch.tensor(FIELD_SCALE, dtype=dtype,
                                     device=planes.device)
        near = torch.stack([nf.near_pos[..., 0].T, nf.near_pos[..., 1].T,
                            nf.near_pos[..., 2].T, m.T])
        taylor = torch.cat([nf.b0[None], nf.grad.T, nf.hess.T])
        return near.contiguous(), taylor.contiguous(), nf.n_reach

    def sprint(mnp_tbl: MnpTable, key, state: SoAState, lane_offset=0,
               cache=None):
        n_mnp = mnp_tbl.n_mnp
        check_scene(params, n_mnp)
        planes, step, escapes, coverage = state
        if planes.device.type != device.type or (
                device.index is not None
                and planes.device.index != device.index):
            raise ValueError(f"state is on {planes.device}, the sprint "
                             f"was built for {device}")
        args = dict(key=key, lane_offset=lane_offset, num_water=num_water,
                    tcp=params.tcp, cell_r2=cr2, dstd=1.0, phys=phys)
        rebuild = n_mnp <= REBUILD_MAX_MNPS
        if not rebuild:
            if cache is None and needs_cache(num_water, n_mnp):
                cache = expansion.build_cache(mnp_tbl.pos, mnp_tbl.m,
                                              params, far_table=False)
            valid = torch.arange(planes.shape[1],
                                 device=planes.device) < num_water
        outs = []
        for _ in range(n_chunks):
            if rebuild:
                planes, esc, cov, wins = chunk_kernel.run_chunk(
                    planes, mnp_tbl.tbl, step0=step & rng.MASK, **args)
            else:
                planes = torch.cat([_wrap(planes[:3], phys.bound),
                                    planes[3:]])
                near, taylor, n_reach = large_model(planes, mnp_tbl, cache)
                coverage = coverage + ((n_reach > k) & valid).sum()
                planes, esc, cov, wins = chunk_kernel.run_chunk_near(
                    planes, near, taylor, step0=step & rng.MASK, **args)
            escapes = escapes + esc.sum().to(torch.int64)
            coverage = coverage + cov.sum().to(torch.int64)
            step += params.chunk_steps
            outs.append(wins.sum(0))
        return SoAState(planes, step, escapes, coverage), torch.cat(outs)

    return sprint


def run_simulation(scene, params: Params, seed: int = 0, *, device,
                   dtype=torch.float32, rng_impl: str = RNG_THREEFRY,
                   max_steps: int | None = None, cache=None):
    """Single-device run (mirror of the reference's
    ``pallas_engine.run_simulation``): returns (times_ms, sum_cos,
    sum_sin, WalkerState) with the sums as NumPy arrays.  ``cache`` is
    passed to every sprint."""
    from .convert import key_words, mnp_table
    from .reference_engine import init_state

    num_water = scene.waters.shape[0]
    sprint = make_sprint_fn(params, num_water, device, dtype, rng_impl)
    tbl = mnp_table(scene.mnps, dtype, device)
    key = key_words(seed)
    ss = to_soa(init_state(scene.waters, params, device, dtype), params)
    total = params.t if max_steps is None else min(params.t, max_steps)
    outs = []
    for _ in range(total // params.sprint_steps):
        ss, wins = sprint(tbl, key, ss, cache=cache)
        outs.append(wins)
    wins = (torch.cat(outs).cpu().numpy() if outs
            else np.zeros((0, 2), np.float32))
    times = (np.arange(1, len(wins) + 1) * params.pfreq) * params.tau
    return times, wins[:, 0], wins[:, 1], from_soa(ss, num_water)

"""Chunk engine: sprints of chunk-kernel launches, and the plain chunks.

Counterpart of the reference's ``engine/pallas_engine.py`` with both of
its generators, every physics variant (kick mode, direction mode,
membrane reflection, background gradient) and its decompose mode, on
both of its paths:

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
centre and are masked out of every sum; window sums and coverage counts
come per warp of 32 walkers, whichever layout the kernel ran in.  In decompose mode (a
phase-decomposition run, ``engine/decompose.py``) the phase is split as
phase = s * A + B for any moment scale s: ``f32[8, W_pad]`` (x, y, z,
in_cell, A, comp_A, B, comp_B), and each window emits the per-walker
record (A, B) in place of the walker sums.

``chunk_reference`` and ``chunk_near_reference`` are the plain PyTorch
versions of one chunk in each mode, with the kernel's inputs, outputs and
arithmetic; both build a model and run the one step loop
(``_chunk_steps``).  The wrappers use them for CPU tensors; on a card
they are only the yardsticks the kernels are held against.

The generators: ``RNG_THREEFRY`` draws the reference's Threefry words
(c0 = step, c1 = lane + (pair << 27)), so the port reproduces the JAX
engines on the same key.  ``RNG_HARDWARE`` is the reference's production
loop (pallas_engine.py:603-684: step pairs sharing one polynomial
Box-Muller pair, 16-bit packed cube directions, sparse escape sampling)
with Philox4x32-10 in place of the TPU's hardware PRNG.  The TPU seeds
that PRNG per block of walkers and per chunk (pallas_engine.py:415-420,
894-899), so its stream depends on the block layout and the chunk size;
the port's is counter-based instead: block j of the words that serve
the step pair starting at global step s is Philox((key_hi, key_lo),
(s, lane, j, 0)).  So the plain version reproduces the kernel bit for
bit, the stream does not change with the chunk size, and walker shards
(lane_offset) draw distinct streams.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import rng
from ..fields import expansion
from ..fields.dipole import FIELD_SCALE
from ..params import DIRECTION_SPHERE, KICK_INTENDED, Params
from . import chunk_kernel
from .reference_engine import (WalkerState, cauchy_kick_sd, check_overrides,
                               constant_kick, intracellular_kick)

RNG_THREEFRY = "threefry"
RNG_HARDWARE = "hardware"

#: dipole-table limit of the in-kernel rebuild: the table is copied into
#: each block's shared memory (f32[4, 2048] = 32 KB)
REBUILD_MAX_MNPS = chunk_kernel.MAX_MNPS
#: threads per block of the kernels' flat layout; W_pad is a multiple
BLOCK = chunk_kernel.BLOCK
#: walkers per row of the window sums and coverage counts (one warp)
GROUP = chunk_kernel.WARP
#: Threefry words per walker-step: direction xyz + normal pair, then the
#: reflection coin (word 5) and the intended kick's uniform (word 6)
N_WORDS = 5
N_WORDS_VARIANTS = 7


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
    kick: float           # per-step intracellular kick (its constant part)
    bound: float
    travel: float         # per-chunk travel bound, µm
    travel2: float        # its square (the escape threshold)
    fast_rng: bool = False        # RNG_HARDWARE: the Philox pair loop
    intended: bool = False        # KICK_INTENDED: + kick_sd * Cauchy term
    kick_sd: float = 0.0
    sphere: bool = False          # DIRECTION_SPHERE
    reflect: bool = False         # membrane reflection compiled in
    reflect_io: float = 0.0       # bounce probabilities (launch scalars)
    reflect_oi: float = 0.0
    gradient: tuple = (0.0, 0.0, 0.0)   # background gradient, T/µm

    @property
    def variants(self) -> bool:
        """Whether any physics variant is on (the kernel's variant
        instantiation reads them as flags)."""
        return (self.intended or self.sphere or self.reflect
                or any(self.gradient))


class SoAState(NamedTuple):
    """Walker state in the kernel's layout."""
    planes: torch.Tensor   # f32[6, W_pad]: x, y, z, in_cell, phase, comp
    #                        (decompose: f32[8, W_pad], A, comp_A, B, comp_B)
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


def chunk_physics(params: Params,
                  rng_impl: str = RNG_THREEFRY) -> ChunkPhysics:
    """The kernel's static arguments for ``params`` and the generator
    ``rng_impl``; raises NotImplementedError for chunks that are not a
    whole number of windows (only the reference's scan engine runs
    those) and ValueError for an unknown generator."""
    if rng_impl not in (RNG_THREEFRY, RNG_HARDWARE):
        raise ValueError(f"unknown rng_impl {rng_impl!r}")
    if params.chunk_steps % params.pfreq != 0:
        raise NotImplementedError(
            "chunk_steps that are not a multiple of pfreq run only in the "
            "reference's scan engine (its window-major mode), which is not "
            "ported yet: ROADMAP Queue 1 item 1")
    travel2 = float(expansion.default_travel_bound(params) ** 2)
    intended = params.kick_mode == KICK_INTENDED
    return ChunkPhysics(
        chunk_steps=params.chunk_steps, pfreq=params.pfreq,
        near_k=params.near_k, rounds=params.rng_rounds,
        in_stdev=_f32(params.in_stdev), out_stdev=_f32(params.out_stdev),
        phase_per_tesla=_f32(params.phase_per_tesla),
        kick=_f32(constant_kick(params)), bound=_f32(params.bound),
        travel=_f32(np.sqrt(travel2)), travel2=_f32(travel2),
        fast_rng=rng_impl == RNG_HARDWARE, intended=intended,
        kick_sd=_f32(cauchy_kick_sd(params)) if intended else 0.0,
        sphere=params.direction_mode == DIRECTION_SPHERE,
        reflect=params.reflect_io > 0 or params.reflect_oi > 0,
        reflect_io=_f32(params.reflect_io),
        reflect_oi=_f32(params.reflect_oi),
        gradient=tuple(_f32(g) for g in params.b0_gradient))


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
    device; a decompose state (phase and comp ``[W, 2]``, column 0 the
    dipole-field part A, column 1 the kick part B) -> ``f32[8, W_pad]``
    with rows A, comp_A, B, comp_B.  Padding walkers start at the box
    centre."""
    w = state.pos.shape[0]
    wp = pad_count(w)
    dec = state.phase.dim() == 2
    planes = torch.zeros((8 if dec else 6, wp), dtype=state.pos.dtype,
                         device=state.pos.device)
    planes[:3, w:] = torch.tensor(params.bound / 2, dtype=state.pos.dtype)
    planes[:3, :w] = state.pos.T
    planes[3, :w] = state.in_cell.to(state.pos.dtype)
    if dec:
        planes[4, :w] = state.phase[:, 0]
        planes[5, :w] = state.phase_comp[:, 0]
        planes[6, :w] = state.phase[:, 1]
        planes[7, :w] = state.phase_comp[:, 1]
    else:
        planes[4, :w] = state.phase
        planes[5, :w] = state.phase_comp
    return SoAState(planes, int(state.step), state.escapes, state.coverage)


def from_soa(ss: SoAState, num_water: int) -> WalkerState:
    """The inverse of ``to_soa``: ``[W]`` phase, or ``[W, 2]`` (A, B)
    from the 8 rows of a decompose state."""
    pl = ss.planes[:, :num_water]
    if pl.shape[0] == 8:
        phase = torch.stack([pl[4], pl[6]], -1)
        comp = torch.stack([pl[5], pl[7]], -1)
    else:
        phase, comp = pl[4].clone(), pl[5].clone()
    return WalkerState(pos=pl[:3].T.contiguous(), in_cell=pl[3] > 0.5,
                       phase=phase, phase_comp=comp, step=ss.step,
                       escapes=ss.escapes, coverage=ss.coverage)


def _wrap(v: torch.Tensor, bound: float) -> torch.Tensor:
    """``jnp.mod(v + bound, bound)``: fmod with the sign fixed."""
    r = torch.fmod(v + bound, bound)
    return torch.where((r != 0) & (r < 0), r + bound, r)


def chunk_reference(state, mnp, *, step0, key, lane_offset, num_water,
                    tcp, cell_r2, dstd, phys: ChunkPhysics,
                    decompose: bool = False):
    """One rebuild-mode chunk in plain PyTorch: the CUDA rebuild kernel's
    contract.

    ``state`` f32[6, W_pad], ``mnp`` f32[4, n_pad] (the packed table).
    Returns ``(state' f32[6, W_pad], esc f32[W_pad], cov f32[W_pad / 32],
    wins f32[W_pad / 32, n_win, 2])``: per-walker escape flags, per-warp
    coverage-violation counts and per-warp window sums (Σcos φ, Σsin φ),
    all masked to the ``num_water`` real walkers.  With ``decompose``
    the state is f32[8, W_pad] and ``wins`` the per-walker record
    f32[n_win, 2, W_pad] of (A, B), padding walkers included.

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
    cov = ((cnt > k) & valid).to(dt).reshape(-1, GROUP).sum(1)
    anchor = torch.stack([ax, ay, az])
    taylor = expansion.far_sums_reference(anchor, mnp, ids)
    out, esc, wins = _chunk_steps(state, anchor, near, taylor, step0=step0,
                                  key=key, lane_offset=lane_offset,
                                  num_water=num_water, tcp=tcp,
                                  cell_r2=cell_r2, dstd=dstd, phys=phys,
                                  decompose=decompose)
    return out, esc, cov, wins


def chunk_near_reference(state, near, taylor, *, step0, key, lane_offset,
                         num_water, tcp, cell_r2, dstd, phys: ChunkPhysics,
                         decompose: bool = False):
    """One near/taylor-mode chunk in plain PyTorch: the CUDA
    ``chunk_near_kernel``'s contract.  ``state`` f32[6, W_pad] (f32[8,
    W_pad] with ``decompose``) is already wrapped and is the anchor;
    ``near`` f32[4, K, W_pad] (x, y, z, M * FIELD_SCALE) and ``taylor``
    f32[10, W_pad] are the model.  Returns (state', esc, cov, wins) as
    ``chunk_reference``, with cov all zero (coverage is counted where the
    model is selected)."""
    out, esc, wins = _chunk_steps(state, state[:3], near, taylor,
                                  step0=step0, key=key,
                                  lane_offset=lane_offset,
                                  num_water=num_water, tcp=tcp,
                                  cell_r2=cell_r2, dstd=dstd, phys=phys,
                                  decompose=decompose)
    cov = torch.zeros(state.shape[1] // GROUP, dtype=state.dtype,
                      device=state.device)
    return out, esc, cov, wins


#: 2 pi in float32, the sphere direction's azimuth scale
TWO_PI = _f32(2.0 * np.pi)


def _direction(u0, u1, u2, sphere: bool):
    """Step direction from three uniforms: (dx, dy, dz, inv_norm), with
    inv_norm None where the direction is a unit vector already.  Cube:
    2u - 1 per axis, normalised; sphere: cos(theta) = 2 u0 - 1 and azimuth
    2 pi u1 (pallas_engine.py:512-525)."""
    if not sphere:
        dx, dy, dz = 2.0 * u0 - 1.0, 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
        return dx, dy, dz, _inv_norm(dx, dy, dz)
    cos_t = 2.0 * u0 - 1.0
    sin_t = rng.sqrt_rn(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = TWO_PI * u1
    return sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t, None


def _inv_norm(dx, dy, dz):
    return torch.rsqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-12))


def _threefry_draws(key, win_step0, lane, phys: ChunkPhysics, dt):
    """The random inputs of each step of one window on the Threefry path,
    the whole window's words drawn in one batch: per step (dx, dy, dz,
    inv_norm, normal, coin, kick uniform, track escapes)."""
    n_words = N_WORDS_VARIANTS if phys.reflect or phys.intended \
        else N_WORDS
    offs = torch.arange(phys.pfreq, device=lane.device)[:, None]
    words = rng.words_for_step(key, win_step0 + offs, lane, n_words,
                               rounds=phys.rounds)
    u0, u1, u2 = (rng.uniform_from_bits(wd, dt) for wd in words[:3])
    nrm = rng.normal_from_bits(words[3], words[4], dt)
    coin = rng.uniform_from_bits(words[5], dt) if phys.reflect else None
    ukick = rng.uniform_from_bits(words[6], dt) if phys.intended else None
    for i in range(phys.pfreq):
        yield (*_direction(u0[i], u1[i], u2[i], phys.sphere), nrm[i],
               None if coin is None else coin[i],
               None if ukick is None else ukick[i], True)


def _fast_draws(key, win_step0, lane, phys: ChunkPhysics, dt):
    """The random inputs of each step of one window on the fast path
    (pallas_engine.py:603-684), as ``_threefry_draws`` yields them.  Step
    pairs share one ``fast_normal_pair``; a pair's words come from
    Philox blocks at its first step (``rng.philox_words``): cube
    directions packed in the 16-bit halves of words 0-2 and the normal
    pair from words 3-4, or sphere directions from uniforms 0-5 and the
    normals from words 6-7; then the two coins, then the two kick
    uniforms.  Escapes are sampled at the second step of every pair, or
    of every second pair when pfreq % 4 == 0; an odd pfreq ends in a
    single step of 5 words plus its coin and kick."""
    extra = int(phys.reflect) + int(phys.intended)
    n_pairs = phys.pfreq // 2
    first = win_step0 + 2 * torch.arange(n_pairs, device=lane.device)[:, None]
    if phys.sphere:
        w = rng.philox_words(key, first, lane, 8 + 2 * extra)
        n1, n2 = rng.fast_normal_pair(w[6], w[7])
        u = [rng.uniform_from_bits(w[j], dt) for j in range(6)]
        dirs = [_direction(*u[:3], True), _direction(*u[3:], True)]
        nw = 8
    else:
        w = rng.philox_words(key, first, lane, 5 + 2 * extra)
        n1, n2 = rng.fast_normal_pair(w[3], w[4])
        dx1, dy1 = rng.unpack_pm1(w[0])
        dz1, dx2 = rng.unpack_pm1(w[1])
        dy2, dz2 = rng.unpack_pm1(w[2])
        dirs = [(dx1, dy1, dz1, _inv_norm(dx1, dy1, dz1)),
                (dx2, dy2, dz2, _inv_norm(dx2, dy2, dz2))]
        nw = 5
    coins = kicks = (None, None)
    if phys.reflect:
        coins = [rng.uniform_from_bits(w[nw + h], dt) for h in (0, 1)]
        nw += 2
    if phys.intended:
        kicks = [rng.uniform_from_bits(w[nw + h], dt) for h in (0, 1)]
    for i in range(n_pairs):
        track = phys.pfreq % 4 != 0 or i % 2 == 1
        for h, nrm in enumerate((n1, n2)):
            yield (*(d if d is None else d[i] for d in dirs[h]), nrm[i],
                   None if coins[h] is None else coins[h][i],
                   None if kicks[h] is None else kicks[h][i],
                   h == 1 and track)
    if phys.pfreq % 2:
        w = rng.philox_words(key, win_step0 + phys.pfreq - 1, lane,
                             5 + extra)
        nrm, _ = rng.fast_normal_pair(w[3], w[4])
        u0, u1, u2 = (rng.uniform_from_bits(wd, dt) for wd in w[:3])
        yield (*_direction(u0, u1, u2, phys.sphere), nrm,
               rng.uniform_from_bits(w[5], dt) if phys.reflect else None,
               rng.uniform_from_bits(w[5 + phys.reflect], dt)
               if phys.intended else None, True)


def _chunk_steps(state, anchor, near, taylor, *, step0, key, lane_offset,
                 num_water, tcp, cell_r2, dstd, phys: ChunkPhysics,
                 decompose: bool = False):
    """The steps of one chunk from ``anchor`` [3, W] against the model
    ``near`` [4, K, W] and ``taylor`` [10, W], phases from ``state``.
    Each step (pallas_engine.py:493-583): random inputs
    (``_threefry_draws`` or ``_fast_draws``) -> direction and normal ->
    move -> masked K-near field + far Taylor -> membrane reflection (the
    walker keeps its old position, field and in-cell test when its coin
    says bounce) -> field kick + intracellular kick + gradient kick.
    Each window: Kahan fold, sums, then the Carr-Purcell flip.  Returns
    (state', esc, wins).

    ``decompose`` (pallas_engine.py:564-575, 702-729): the field kick
    goes into A (rows 4, 5 of the state), the intracellular and gradient
    kicks into B (rows 6, 7), each with its own Kahan fold; each window
    records the per-walker (A, B) as ``wins[w]`` f32[2, W], and the flip
    negates all four rows."""
    dev, dt = state.device, state.dtype
    wp = state.shape[1]
    n_grp = wp // GROUP
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
    rio, roi = const(phys.reflect_io), const(phys.reflect_oi)
    gx, gy, gz = phys.gradient
    draws = _fast_draws if phys.fast_rng else _threefry_draws
    x, y, z = ax, ay, az
    phase, comp = state[4], state[5]
    phase_b, comp_b = (state[6], state[7]) if decompose else (None, None)
    bprev, mind2 = eval_field(x, y, z)
    maxd2 = torch.zeros(wp, dtype=dt, device=dev)
    n_win = phys.chunk_steps // phys.pfreq
    wins = torch.zeros((n_win, 2, wp) if decompose else (n_grp, n_win, 2),
                       dtype=dt, device=dev)
    for w in range(n_win):
        win_step0 = (step0 + w * phys.pfreq) & rng.MASK
        acc = torch.zeros(wp, dtype=dt, device=dev)
        acc_b = torch.zeros(wp, dtype=dt, device=dev) if decompose else None
        for dx, dy, dz, inv_norm, nrm, coin, ukick, track in draws(
                key, win_step0, lane, phys, dt):
            incell = mind2 < cr2
            mag = nrm * torch.where(incell, in_sd, out_sd)
            if inv_norm is not None:
                mag = mag * inv_norm
            x2 = x + dx * mag
            y2 = y + dy * mag
            z2 = z + dz * mag
            b, mind2_new = eval_field(x2, y2, z2)
            in_new = mind2_new < cr2
            if phys.reflect:
                flip = ((incell & ~in_new & (coin < rio))
                        | (~incell & in_new & (coin < roi)))
                x2 = torch.where(flip, x, x2)
                y2 = torch.where(flip, y, y2)
                z2 = torch.where(flip, z, z2)
                b = torch.where(flip, bprev, b)
                in_new = torch.where(flip, incell, in_new)
                mind2_new = torch.where(flip, mind2, mind2_new)
            kick = b * phys.phase_per_tesla
            intra = intracellular_kick(phys.kick, in_new, dt, ukick,
                                       phys.kick_sd)
            if any(phys.gradient):
                bg = (x2 * gx + y2 * gy + z2 * gz) * phys.phase_per_tesla
                intra = bg if intra is None else intra + bg
            if decompose:
                acc = acc + kick
                if intra is not None:
                    acc_b = acc_b + intra
            else:
                if intra is not None:
                    kick = kick + intra
                acc = acc + kick
            if track:
                ex = x2 - ax
                ey = y2 - ay
                ez = z2 - az
                maxd2 = torch.maximum(maxd2, ex * ex + ey * ey + ez * ez)
            x, y, z, mind2, bprev = x2, y2, z2, mind2_new, b
        # Kahan fold (performUpdate, cuda_sim.cu:814-828), then emit
        phase, comp = _kahan(phase, comp, acc)
        if decompose:
            phase_b, comp_b = _kahan(phase_b, comp_b, acc_b)
            wins[w, 0] = phase
            wins[w, 1] = phase_b
        else:
            wins[:, w, 0] = (torch.cos(phase) * validf).reshape(
                n_grp, GROUP).sum(1)
            wins[:, w, 1] = (torch.sin(phase) * validf).reshape(
                n_grp, GROUP).sum(1)
        # Carr-Purcell flip after emission (cuda_sim.cu:1015-1020)
        if ((win_step0 + phys.pfreq) & rng.MASK) % tcp == 0:
            phase = -phase
            comp = -comp
            if decompose:
                phase_b = -phase_b
                comp_b = -comp_b

    rows = [x, y, z, (mind2 < cr2).to(dt), phase, comp]
    out = torch.stack(rows + [phase_b, comp_b] if decompose else rows)
    esc = ((maxd2 > phys.travel2) & valid).to(dt)
    return out, esc, wins


def _kahan(phase, comp, acc):
    """One Kahan fold of the window's kicks ``acc`` into (phase, comp)."""
    ky = acc - comp
    kt = phase + ky
    return kt, (kt - phase) - ky


def make_sprint_fn(params: Params, num_water: int, device,
                   dtype=torch.float32, rng_impl: str = RNG_THREEFRY,
                   decompose: bool = False):
    """``sprint(mnp_tbl, key, state, lane_offset=0, cache=None, tcp=None,
    cell_r=None, d_scale=None, reflect=None) -> (state', wins)``:
    ``params.sprint_steps`` steps as a loop of chunk launches.

    ``mnp_tbl`` is an ``MnpTable`` (``convert.mnp_table``), ``key`` the
    key words (``convert.key_words``), ``state`` an ``SoAState`` and
    ``wins`` f32[n_windows, 2] (Σcos φ, Σsin φ) on the device.
    ``cache`` (``expansion.SceneCache``, from ``expansion.build_cache``
    once per scene) serves scenes above ``REBUILD_MAX_MNPS`` dipoles; a
    large scene without one gets a cache without far table, built in
    each sprint call, as in the reference.  The loop never reads the
    device, so sprints queue behind each other.

    ``tcp`` (Carr-Purcell interval, steps), ``cell_r`` (µm), ``d_scale``
    (diffusion scale) and ``reflect`` (a (reflect_io, reflect_oi) pair;
    needs reflection on in ``params``) override their ``params`` values
    as the kernels' launch scalars, as in the reference's sprint
    (pallas_engine.py:901-929): cell_r is squared as a float32 product
    and d_scale rides as its float32 square root.

    ``decompose`` (pallas_engine.py:826-858): a phase-decomposition
    sprint on both paths, its state the 8-row decompose planes
    (``to_soa`` of an ``init_state(..., decompose=True)`` state) and
    ``wins`` the per-walker record f32[n_windows, 2, W_pad] of (A, B),
    padding walkers included."""
    params.validate()
    if dtype != torch.float32:
        raise ValueError("the chunk kernel runs in float32")
    phys = chunk_physics(params, rng_impl)
    if params.sprint_steps % params.chunk_steps != 0:
        raise ValueError("sprint_steps must be a multiple of chunk_steps")
    n_chunks = params.sprint_steps // params.chunk_steps
    device = torch.device(device)
    k = params.near_k

    def large_model(planes, tbl: MnpTable, cache, reach2):
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
               cache=None, tcp=None, cell_r=None, d_scale=None,
               reflect=None):
        if reflect is not None and not phys.reflect:
            raise ValueError(
                "reflect overrides need reflection enabled in the static "
                "params (e.g. params.with_permeability()); the engine was "
                "built with reflect_io = reflect_oi = 0")
        check_overrides(tcp, cell_r, d_scale, reflect)
        n_mnp = mnp_tbl.n_mnp
        check_scene(params, n_mnp)
        planes, step, escapes, coverage = state
        if planes.device.type != device.type or (
                device.index is not None
                and planes.device.index != device.index):
            raise ValueError(f"state is on {planes.device}, the sprint "
                             f"was built for {device}")
        cr = params.cell_r if cell_r is None else float(cell_r)
        dstd = 1.0 if d_scale is None \
            else float(np.sqrt(np.float32(d_scale)))
        cphys = phys if reflect is None else phys._replace(
            reflect_io=_f32(reflect[0]), reflect_oi=_f32(reflect[1]))
        args = dict(key=key, lane_offset=lane_offset, num_water=num_water,
                    tcp=params.tcp if tcp is None else int(tcp),
                    cell_r2=cell_r2_f32(cr), dstd=dstd, phys=cphys)
        rebuild = n_mnp <= REBUILD_MAX_MNPS
        if not rebuild:
            if cache is None and needs_cache(num_water, n_mnp):
                cache = expansion.build_cache(mnp_tbl.pos, mnp_tbl.m,
                                              params, far_table=False)
            valid = torch.arange(planes.shape[1],
                                 device=planes.device) < num_water
            reach2 = expansion.coverage_reach2(params, cr)
        outs = []
        for _ in range(n_chunks):
            if rebuild:
                planes, esc, cov, wins = chunk_kernel.run_chunk(
                    planes, mnp_tbl.tbl, step0=step & rng.MASK,
                    decompose=decompose, **args)
            else:
                planes = torch.cat([_wrap(planes[:3], phys.bound),
                                    planes[3:]])
                near, taylor, n_reach = large_model(planes, mnp_tbl, cache,
                                                    reach2)
                coverage = coverage + ((n_reach > k) & valid).sum()
                planes, esc, cov, wins = chunk_kernel.run_chunk_near(
                    planes, near, taylor, step0=step & rng.MASK,
                    decompose=decompose, **args)
            escapes = escapes + esc.sum().to(torch.int64)
            coverage = coverage + cov.sum().to(torch.int64)
            step += params.chunk_steps
            outs.append(wins if decompose else wins.sum(0))
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

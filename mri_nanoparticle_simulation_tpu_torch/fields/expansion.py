"""Chunk-local field model: K-nearest selection, far sums, the
large-scene cube cache and the candidate-model rebuild.

Counterpart of the reference's ``fields/expansion.py``:

* ``sorted_insert`` / ``excluded_weight``: the K-nearest selection and
  far-pass exclusion, on stacked ``[K, ...]`` slot tensors.  The CUDA
  kernels unroll the same branchless insertion over register slots.
* ``far_sums_reference``: the far value, gradient and Hessian at each
  anchor over the whole dipole table without the K near ids, the plain
  version of ``csrc/far_sums_kernel.cu`` (``chunk_kernel.run_far_sums``).
* ``SceneCache`` / ``build_cache``: per spatial cube, its C nearest
  dipoles and the cube's far-field Taylor table (``fields.fartable``).
* ``build``: the per-walker model (``NearField``) by cube-pruned or
  whole-table selection and the far sums; ``coverage_reach2``, the
  large path's coverage reach.
* ``build_planes``: the large-scene rebuild straight into the chunk
  kernel's near/taylor inputs; its CUDA route is
  ``csrc/cand_model_kernel.cu``, its plain version
  ``cand_model_reference``.
* ``default_travel_bound``, ``validate_near_k``,
  ``validate_cube_candidates`` and the covering-lattice helpers: NumPy
  host code, carried over unchanged apart from imports (the reference
  module imports jax, so it cannot be reused by import).

Layouts follow the port's flat walker axis: the reference's ``[R, 128]``
planes are ``[W]`` rows here, so ``near`` is ``[4, K, W]`` and ``taylor``
``[10, W]``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..engine import chunk_kernel
from ..params import Params
from ..utils import cache as cache_mod
from . import fartable
from .dipole import FIELD_SCALE, bz_taylor_parts


class SceneCache(NamedTuple):
    """Scene-constant tables of the large path: ``payload`` f32[H^3, C,
    5] per cube (x, y, z, M, global index) and ``far_coeffs`` f32[H^3,
    n_coeffs] (the cube's Taylor table of the beyond-candidates field),
    or None without a table (``far_table_order == 0``)."""
    payload: torch.Tensor
    far_coeffs: torch.Tensor | None


class NearField(NamedTuple):
    """Per-walker chunk-local field model, leading dims = walkers, as the
    reference's ``NearField`` (``near_M`` unscaled)."""
    anchor: torch.Tensor    # [W, 3]
    near_pos: torch.Tensor  # [W, K, 3]
    near_M: torch.Tensor    # [W, K]
    b0: torch.Tensor        # [W]
    grad: torch.Tensor      # [W, 3]
    hess: torch.Tensor      # [W, 6] (xx, yy, zz, xy, xz, yz)
    #: [W] dipoles within reach of the anchor (None without ``reach2``);
    #: coverage is violated where it exceeds K
    n_reach: torch.Tensor | None = None


def sorted_insert(d2s, fields, ids, d2, new_fields, j):
    """One branchless sorted-insertion step into K ascending slots.

    ``d2s`` / ``ids``: ``[K, ...]`` slot tensors; ``fields``: ``[F, K,
    ...]`` payload slots (x, y, z, M); ``d2``: ``[...]`` candidate
    distance, ``new_fields``: ``[F, ...]`` its payload, ``j`` its id.
    Slot s takes the candidate iff it beats slot s (strict ``<``) but not
    slot s-1; the slots it displaces shift down by one.  Ties keep the
    earlier candidate first, as in the reference.  Returns the updated
    (d2s, fields, ids)."""
    lt = d2 < d2s
    take_prev = torch.cat([torch.zeros_like(lt[:1]), lt[:-1]])
    take_new = lt & ~take_prev

    def put(new, old, k_dim):
        prev = torch.cat([old.narrow(k_dim, 0, 1),
                          old.narrow(k_dim, 0, old.shape[k_dim] - 1)],
                         k_dim)
        return torch.where(take_prev, prev, torch.where(take_new, new, old))

    ids_new = torch.as_tensor(j, dtype=ids.dtype, device=ids.device)
    return (put(d2, d2s, 0), put(new_fields.unsqueeze(1), fields, 1),
            put(ids_new, ids, 0))


def merge_sorted(d2s, ids):
    """The K nearest of ``P`` sorted K-lists, as the rebuild kernel's
    split layout merges the lists its warps select over consecutive
    parts of the table (csrc/chunk_kernel.cuh merge_selected).

    ``d2s`` / ``ids``: ``[P, K, ...]``, list p from ``sorted_insert``
    over table part p, the parts in table order.  Slot by slot the
    smallest head is taken, a tie going to the lower part: that is the
    order (d2, id) in which the serial insertion over the whole table
    keeps its K, so the result is the same (d2s, ids) ``[K, ...]``.
    The plain version of the kernel's merge, for the tests."""
    p, k = d2s.shape[:2]
    flat_d2 = d2s.reshape(p * k, *d2s.shape[2:])
    order = torch.sort(flat_d2, dim=0, stable=True).indices[:k]
    return (torch.gather(flat_d2, 0, order),
            torch.gather(ids.reshape(p * k, *ids.shape[2:]), 0, order))


def excluded_weight(ids, j, dtype):
    """1.0 where candidate ``j`` is in none of the K id slots of ``ids``
    (``[K, ...]``), else 0.0.  ``j`` may be a tensor of ids that
    broadcasts against ``ids[0]``, giving one weight per (j, walker)."""
    return (ids != j).all(0).to(dtype)


def pack_table(mnp_pos: torch.Tensor, mnp_M: torch.Tensor) -> torch.Tensor:
    """The kernels' dipole table f32[4, n_pad] (x, y, z, M * FIELD_SCALE,
    the scaling an f32 product) padded to a multiple of 8 with
    zero-moment entries 1e6 µm away (expansion._far_sums_pallas,
    pallas_engine.py:967-975)."""
    n = mnp_pos.shape[0]
    n_pad = -(-n // 8) * 8
    tbl = torch.zeros((4, n_pad), dtype=mnp_pos.dtype,
                      device=mnp_pos.device)
    tbl[:3, n:] = 1e6
    tbl[:3, :n] = mnp_pos.T
    tbl[3, :n] = mnp_M * torch.tensor(FIELD_SCALE, dtype=mnp_M.dtype,
                                      device=mnp_M.device)
    return tbl


def far_sums_reference(anchor, tbl, idx, block: int = 512):
    """Plain version of ``csrc/far_sums_kernel.cu``: ``anchor`` [3, W],
    ``tbl`` [4, n_pad] (M scaled), ``idx`` [K, W] global ids left out.
    Returns taylor [10, W] (b0, gx, gy, gz, hxx, hyy, hzz, hxy, hxz,
    hyz).  Blocks of ``block`` dipoles are evaluated together, then added
    one dipole at a time in table order, as the kernel sums."""
    ax, ay, az = anchor[0], anchor[1], anchor[2]
    taylor = torch.zeros((10, anchor.shape[1]), dtype=anchor.dtype,
                         device=anchor.device)
    ids = idx[:, None, :]
    for j0 in range(0, tbl.shape[1], block):
        t = tbl[:, j0:j0 + block, None]                  # [4, B, 1]
        parts = torch.stack(bz_taylor_parts(ax - t[0], ay - t[1], az - t[2],
                                            t[3]))      # [10, B, W]
        col = torch.arange(j0, j0 + t.shape[1], device=anchor.device)
        parts = parts * excluded_weight(ids, col[:, None], anchor.dtype)
        for j in range(parts.shape[1]):
            taylor = taylor + parts[:, j]
    return taylor


def _pairwise_d2(a, b):
    """Pairwise squared distances |a|^2 + |b|^2 - 2 a.b through one
    matrix product.  The cancellation only fuzzes the selection order of
    near-equidistant points, which the K slack absorbs; a BLAS rounds the
    product differently from XLA, so selections match as sets."""
    an2 = (a * a).sum(-1)
    bn2 = (b * b).sum(-1)
    return an2[:, None] + bn2[None, :] - 2.0 * (a @ b.T)


def _argmin_passes(d2, k):
    """K nearest columns per row by K masked argmin passes in bfloat16
    (the reference's selection: 0.4% distance fuzz, first index on ties).
    Returns int64 [rows, K]."""
    remaining = d2.to(torch.bfloat16) if d2.dtype == torch.float32 else d2
    remaining = remaining.clone()
    rows = torch.arange(d2.shape[0], device=d2.device)
    idx = []
    for _ in range(k):
        j = torch.argmin(remaining, dim=1)
        idx.append(j)
        remaining[rows, j] = float("inf")
    return torch.stack(idx, 1)


def uses_large_path(num_walkers: int, n_mnp: int) -> bool:
    """Whether callers should precompute the cube cache (the reference's
    policy: more than 2^24 walker-dipole pairs)."""
    return num_walkers * n_mnp > (1 << 24)


def build_cache(mnp_pos, mnp_M, params: Params,
                far_table: bool = True) -> SceneCache:
    """The scene cache: for each of the H^3 cubes its C nearest dipoles
    (by the bf16 argmin passes over one [H^3, N] distance matrix to the
    cube centres), and, when ``params.far_table_order > 0`` and
    ``far_table``, the cube's far table (``fartable.build_far_table``).
    ``mnp_pos`` [N, 3] and ``mnp_M`` [N] include the periodic images."""
    h = params.cube_hash_dim
    c = min(params.cube_candidates, mnp_pos.shape[0])
    centers = torch.as_tensor(fartable.cube_centers(h, float(params.bound)),
                              device=mnp_pos.device).to(mnp_pos.dtype)
    table = _argmin_passes(_pairwise_d2(centers, mnp_pos), c)   # [H^3, C]
    payload = torch.cat([mnp_pos[table], mnp_M[table][..., None],
                         table[..., None].to(mnp_pos.dtype)], -1)
    coeffs = None
    if far_table and params.far_table_order > 0:
        coeffs = fartable.build_far_table(mnp_pos, mnp_M, table, h,
                                          float(params.bound),
                                          params.far_table_order)
    return SceneCache(payload=payload, far_coeffs=coeffs)


def _cube_index(pos, h: int, bound: float):
    """(clip(int(p / cube), 0, h - 1) int64 per coordinate, same shape as
    ``pos``; the cube edge as a device scalar).  True division by a
    device scalar: a CPU float divisor may be turned into a product with
    its reciprocal on the card."""
    cube = torch.tensor(bound / h, dtype=pos.dtype, device=pos.device)
    return torch.clamp((pos / cube).to(torch.int32), 0, h - 1).long(), cube


def coverage_reach2(params: Params, cell_r: float | None = None) -> float:
    """The large path's squared coverage reach (cell_r + travel)^2 in
    f32, from cell_r itself (pallas_engine.py:1011-1013; the rebuild
    kernel squares sqrt(cell_r^2) + travel instead); ``cell_r``
    overrides ``params.cell_r``."""
    cr = params.cell_r if cell_r is None else cell_r
    r = np.float32(cr) + np.float32(default_travel_bound(params))
    return float(r * r)


def cube_select(anchor, payload, params: Params, reach2=None):
    """Cube-pruned selection (the reference ``build``'s cube path): each
    anchor ([W, 3]) takes its cube's C candidates from ``payload``
    [H^3, C, 5] and picks the K nearest by bf16 argmin passes over the
    exact f32 d^2.  Returns (the K selected rows [W, K, 5], n_reach int32
    [W] or None)."""
    k = params.near_k
    if k > payload.shape[1]:
        raise ValueError(
            f"near_k={k} exceeds cube_candidates={payload.shape[1]}; "
            f"selection would duplicate entries and double-count "
            f"their field")
    h = params.cube_hash_dim
    ci, _ = _cube_index(anchor, h, params.bound)
    cand = payload[(ci[:, 0] * h + ci[:, 1]) * h + ci[:, 2]]
    dc = anchor[:, None, :] - cand[..., :3]
    d2 = (dc[..., 0] * dc[..., 0] + dc[..., 1] * dc[..., 1]
          + dc[..., 2] * dc[..., 2])                        # [W, C]
    n_reach = (None if reach2 is None
               else (d2 < reach2).sum(1).to(torch.int32))
    sel = _argmin_passes(d2, k)
    return torch.take_along_dim(cand, sel[..., None], 1), n_reach


def build(anchor, mnp_pos, mnp_M, params: Params, cache=None, reach2=None,
          tbl=None) -> NearField:
    """Each walker's K nearest dipoles and the far Taylor model of the
    rest (the reference's ``build`` with ``far_impl='pallas'`` and no far
    table; a cache with a far table goes through ``build_planes``).

    ``anchor`` [W, 3]; ``mnp_pos`` [N, 3], ``mnp_M`` [N] all dipoles with
    images; ``cache`` a ``SceneCache`` without far table (cube-pruned
    selection) or None (selection over all N); ``reach2`` the squared
    coverage reach, giving ``n_reach``; ``tbl`` the packed table
    (``pack_table``), made here when None.  The far sums go through
    ``chunk_kernel.run_far_sums`` (the CUDA kernel on a card)."""
    k = params.near_k
    if k > mnp_pos.shape[0]:
        raise ValueError(
            f"near_k={k} exceeds the number of dipoles "
            f"({mnp_pos.shape[0]}); selection would duplicate entries and "
            f"double-count their field")
    if cache is not None:
        if cache.far_coeffs is not None:
            raise ValueError("a cache with a far table goes through "
                             "build_planes")
        rows, n_reach = cube_select(anchor, cache.payload, params, reach2)
        near_pos, near_M = rows[..., :3], rows[..., 3]
        idx = rows[..., 4].to(torch.int32)
    else:
        d2 = _pairwise_d2(anchor, mnp_pos)                  # [W, N]
        n_reach = (None if reach2 is None
                   else (d2 < reach2).sum(1).to(torch.int32))
        sel = _argmin_passes(d2, k)
        near_pos, near_M = mnp_pos[sel], mnp_M[sel]
        idx = sel.to(torch.int32)
    if tbl is None:
        tbl = pack_table(mnp_pos, mnp_M)
    t = chunk_kernel.run_far_sums(anchor.T.contiguous(), tbl,
                                  idx.T.contiguous())
    return NearField(anchor, near_pos, near_M, t[0], t[1:4].T, t[4:10].T,
                     n_reach)


def cand_model_reference(pos, payload, coeffs, *, near_k, order, h, bound,
                         reach2):
    """Plain version of ``csrc/cand_model_kernel.cu`` (the reference's
    ``_make_cand_model_kernel`` with the gathers of ``build_planes``).

    ``pos`` [3, W] wrapped anchors; ``payload`` [H^3, C, 5]; ``coeffs``
    [H^3, n_coeffs]; ``reach2`` a float.  Per walker over its cube's C
    candidates, in candidate order: exact K-nearest by sorted insertion
    with slot ids and the count within ``reach2``; the mid sums of the
    candidates not selected, excluded by slot id; then the cube's far
    table at ``e = p - (ci + 0.5) * cube``.  Returns (near [4, K, W] with
    M * FIELD_SCALE, taylor [10, W], n_reach [W] as floats)."""
    dev, dt = pos.device, pos.dtype
    w = pos.shape[1]
    c = payload.shape[1]
    ci, cube = _cube_index(pos, h, bound)
    flat = (ci[0] * h + ci[1]) * h + ci[2]
    pc = payload[flat].permute(2, 1, 0)                     # [5, C, W]
    cx, cy, cz = pc[0], pc[1], pc[2]
    cm = pc[3] * torch.tensor(FIELD_SCALE, dtype=dt, device=dev)
    ax, ay, az = pos[0], pos[1], pos[2]

    d2s = torch.full((near_k, w), 1e30, dtype=dt, device=dev)
    slots = torch.zeros((4, near_k, w), dtype=dt, device=dev)
    ids = torch.full((near_k, w), -1, dtype=torch.int64, device=dev)
    cnt = torch.zeros(w, dtype=dt, device=dev)
    for j in range(c):
        dx = ax - cx[j]
        dy = ay - cy[j]
        dz = az - cz[j]
        d2 = dx * dx + dy * dy + dz * dz
        cnt = cnt + (d2 < reach2).to(dt)
        d2s, slots, ids = sorted_insert(
            d2s, slots, ids, d2, torch.stack([cx[j], cy[j], cz[j], cm[j]]),
            j)

    parts = torch.stack(bz_taylor_parts(ax - cx, ay - cy, az - cz, cm))
    parts = parts * excluded_weight(
        ids[:, None, :], torch.arange(c, device=dev)[:, None], dt)
    accs = torch.zeros((10, w), dtype=dt, device=dev)
    for j in range(c):                  # candidate order, as the kernel
        accs = accs + parts[:, j]

    e = pos - (ci.to(dt) + 0.5) * cube
    co = coeffs[flat].T                                     # [nc, W]
    taylor = fartable.eval_far_table_parts(lambda t: co[t], e[0], e[1], e[2],
                                           order, accs=tuple(accs))
    return slots, torch.stack(taylor), cnt


def build_planes(pos, params: Params, cache: SceneCache, reach2=None):
    """The large-scene chunk rebuild into the chunk kernel's inputs
    (the reference's ``build_planes``): ``pos`` f32[3, W] wrapped
    anchors, ``cache`` built with a far table.  Returns (near [4, K, W]
    with M * FIELD_SCALE, taylor [10, W], n_reach [W], all zero when
    ``reach2`` is None) from the CUDA kernel for CUDA tensors and from
    ``cand_model_reference`` for CPU tensors."""
    k = params.near_k
    if cache.far_coeffs is None:
        raise ValueError(
            "build_planes requires a cache built with the far table "
            "(params.far_table_order > 0 and build_cache(far_table=True))")
    c = cache.payload.shape[1]
    if k > c:
        raise ValueError(
            f"near_k={k} exceeds cube_candidates={c}; selection would "
            f"duplicate entries and double-count their field")
    order = params.far_table_order
    if cache.far_coeffs.shape[-1] != fartable.n_coeffs(order):
        raise ValueError(
            f"far table was built at a different order than "
            f"params.far_table_order={order} ({cache.far_coeffs.shape[-1]} "
            f"!= {fartable.n_coeffs(order)} coefficients)")
    return chunk_kernel.run_cand_model(
        pos, cache.payload, cache.far_coeffs, near_k=k, order=order,
        h=params.cube_hash_dim, bound=float(params.bound),
        reach2=0.0 if reach2 is None else float(reach2))


def validate_cube_candidates(dipole_pos: np.ndarray, params: Params,
                             travel_bound: float | None = None) -> int:
    """Worst-case number of dipoles a cube's candidate table must hold:
    max over cube centers of dipoles within reach + cube half-diagonal.
    Callers raise if it exceeds params.cube_candidates (only relevant on
    the large-scene path)."""
    if travel_bound is None:
        travel_bound = default_travel_bound(params)
    h = params.cube_hash_dim
    cube = params.bound / h
    crit = params.cell_r + travel_bound + np.sqrt(3.0) * cube / 2.0
    pos = np.asarray(dipole_pos, np.float64)
    key = pos.tobytes() + np.float64(crit).tobytes() + \
        np.int64(h).tobytes() + b"cube_cand.v1"
    cached = cache_mod.certificate_get("cubec", key)
    if cached is not None:
        return cached
    ax = (np.arange(h) + 0.5) * cube
    centers = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                       -1).reshape(-1, 3)
    counts = np.zeros(len(centers), np.int64)
    for c in pos:
        d2 = np.sum((centers - c) ** 2, axis=1)
        counts += d2 < crit * crit
    worst = int(counts.max())
    cache_mod.certificate_put("cubec", key, worst)
    return worst


def validate_near_k(dipole_pos: np.ndarray, params: Params,
                    travel_bound: float | None = None,
                    n_probe: int = 200_000, seed: int = 0) -> int:
    """Scene-level DETERMINISTIC guarantee for the near-list size K.

    Correctness requires: every dipole within ``cell_r + travel_bound`` of
    any chunk anchor is among that anchor's K nearest.  Sufficient
    condition: no point in the box has more than K dipoles within
    ``reach = cell_r + travel_bound``.  ``dipole_pos`` must be ALL
    dipoles **including periodic images** (Scene.mnps[:, :3]): near a box
    face, images compete for near-list slots and can crowd out the one
    base cell a walker is about to enter.

    This is a PROVEN upper bound via a two-level covering lattice:

      For any continuous point x there is a lattice point l with
      |x - l| <= delta (half the lattice cell diagonal), so
      ball(x, reach) is contained in ball(l, reach + delta) and

          max_x count_reach(x)  <=  max_l count_{reach+delta}(l).

      Level 1 computes that bound on a coarse lattice; every coarse cell
      whose bound exceeds the level-1 *floor* (the max lattice-point
      count at exact reach, which is a lower bound on the true max) is
      re-covered with a fine lattice whose delta is ~reach/100,
      tightening the inflation to a sub-dipole-radius margin.  The
      returned value is a certified upper bound on the continuous max —
      if it equals the floor, it is exact.

    ``n_probe``/``seed`` are kept for API compatibility and ignored.
    """
    del n_probe, seed
    if travel_bound is None:
        travel_bound = default_travel_bound(params)
    reach = params.cell_r + travel_bound
    pos = np.asarray(dipole_pos, np.float64)
    key = pos.tobytes() + np.float64(reach).tobytes() + b"near_k.v1"
    cached = cache_mod.certificate_get("neark", key)
    if cached is not None:
        return cached
    worst = _max_count_bound(pos, reach, params.bound)
    cache_mod.certificate_put("neark", key, worst)
    return worst


def _counts_at(points: np.ndarray, dipole_pos: np.ndarray,
               radius: float) -> np.ndarray:
    """#{dipoles within radius} per point, via a dipole bin grid of cell
    size = radius (27-neighbor search): O(points * local density) instead
    of O(points * n_dipoles)."""
    if len(dipole_pos) <= 64:      # direct loop beats binning overhead
        counts = np.zeros(len(points), np.int64)
        for d in dipole_pos:
            d2 = np.sum((points - d) ** 2, axis=1)
            counts += d2 < radius * radius
        return counts
    c = radius
    dcell = np.floor(dipole_pos / c).astype(np.int64)
    lo = dcell.min(0) - 1
    dims = dcell.max(0) - lo + 3

    def code(cells):
        rel = cells - lo
        return (rel[:, 0] * dims[1] + rel[:, 1]) * dims[2] + rel[:, 2]

    order = np.argsort(code(dcell), kind="stable")
    dsort = dipole_pos[order]
    dcode_s = code(dcell)[order]
    pcell = np.floor(points / c).astype(np.int64)
    counts = np.zeros(len(points), np.int64)
    r2 = radius * radius
    off = np.array([-1, 0, 1])
    for ox in off:
        for oy in off:
            for oz in off:
                ncell = pcell + np.array([ox, oy, oz])
                valid = np.all((ncell >= lo) & (ncell < lo + dims), axis=1)
                if not valid.any():
                    continue
                pt_idx = np.flatnonzero(valid)
                ncode = code(ncell[valid])
                s = np.searchsorted(dcode_s, ncode, "left")
                e = np.searchsorted(dcode_s, ncode, "right")
                lens = e - s
                total = int(lens.sum())
                if total == 0:
                    continue
                rep = np.repeat(np.arange(len(ncode)), lens)
                base = np.repeat(np.cumsum(lens) - lens, lens)
                didx = np.repeat(s, lens) + np.arange(total) - base
                d = points[pt_idx[rep]] - dsort[didx]
                within = np.einsum("ij,ij->i", d, d) < r2
                counts += np.bincount(pt_idx[rep][within],
                                      minlength=len(points))
    return counts


def _lattice_pass(dipole_pos: np.ndarray, reach: float, g: float,
                  batch: int = 512):
    """Exact dipole counts at every lattice point (spacing g) lying
    within reach + delta of any dipole, via one incidence histogram:
    each (dipole, nearby-lattice-point) pair is enumerated from a shared
    integer offset cube and bucketed by linear cell code — O(n_dipoles *
    ball volume), no point-wise neighbor search.  Dipoles are processed
    ``batch`` at a time so the [batch, C~3800, 3] candidate tensor stays
    ~50 MB regardless of scene size (a 30k-dipole clustered scene would
    otherwise peak at several GB); only the masked incidence codes
    (one int64 per in-ball pair, inherent to the histogram) accumulate.

    Returns (points [P, 3], counts_inflated [P] at radius reach+delta,
    counts_exact [P] at radius reach), delta = g*sqrt(3)/2."""
    delta = g * np.sqrt(3.0) / 2.0
    r_in = reach + delta
    base = np.floor(dipole_pos / g).astype(np.int64)        # [N, 3]
    n = int(np.ceil(r_in / g)) + 1
    offs = np.arange(-n, n + 1, dtype=np.int64)
    cube = np.stack(np.meshgrid(offs, offs, offs, indexing="ij"),
                    -1).reshape(-1, 3)
    # prefilter the shared cube: a lattice offset can only be within r_in
    # of a dipole whose in-cell fraction shifts it by < g*sqrt(3)
    keep = np.sum((cube * g) ** 2, axis=1) <= (r_in + g * np.sqrt(3)) ** 2
    cube = cube[keep]
    # global grid origin/extent from the dipole cells (covers every
    # candidate; decoded points add lo back so the choice is neutral)
    lo = base.min(0) - n
    dims = base.max(0) + n - lo + 1
    codes_in, codes_ex = [], []
    for i in range(0, len(base), batch):
        cand = base[i:i + batch, None, :] + cube[None]      # [B, C, 3]
        d = cand * g - dipole_pos[i:i + batch, None, :]
        d2 = np.sum(d * d, axis=-1)                         # [B, C]
        rel = cand - lo
        code = (rel[..., 0] * dims[1] + rel[..., 1]) * dims[2] \
            + rel[..., 2]
        codes_in.append(code[d2 < r_in * r_in])
        codes_ex.append(code[d2 < reach * reach])
    flat_in = np.concatenate(codes_in)
    occupied, inv = np.unique(flat_in, return_inverse=True)
    counts_inflated = np.bincount(inv, minlength=len(occupied))
    counts_exact = np.bincount(
        np.searchsorted(occupied, np.concatenate(codes_ex)),
        minlength=len(occupied))
    cz = occupied % dims[2]
    cy = (occupied // dims[2]) % dims[1]
    cx = occupied // (dims[1] * dims[2])
    pts = (np.stack([cx, cy, cz], -1) + lo) * g
    return pts, counts_inflated, counts_exact


def _max_count_bound(dipole_pos: np.ndarray, reach: float,
                     bound: float) -> int:
    """Certified upper bound on max_x #{dipoles within reach of x} —
    see validate_near_k for the covering argument.  Iteratively refines
    (lattice spacing /6 per round) around the points whose inflated
    bound still beats the exact floor; almost always converges to the
    floor (then the bound is exact).  ``bound`` (the box size) is unused:
    lattice points slightly outside the box still upper-bound interior
    positions, so no clipping is needed."""
    del bound
    g = max(reach / 6.0, 1e-3)
    pts, c_in, c_ex = _lattice_pass(dipole_pos, reach, g)
    floor = int(c_ex.max())
    hot = pts[c_in > floor]
    worst_bound = int(c_in.max())
    for _ in range(3):
        if not len(hot):
            return floor                 # bound meets floor: exact
        prev_delta = g * np.sqrt(3.0) / 2.0
        g = g / 6.0
        delta = g * np.sqrt(3.0) / 2.0
        new_hot = []
        worst_bound = floor
        # refine each hot point's prev_delta-neighborhood with local
        # dipoles only (every x that could beat the floor lies within
        # prev_delta of a hot point, by the covering induction)
        offs = np.arange(-(prev_delta + g), prev_delta + 2 * g, g)
        cube = np.stack(np.meshgrid(offs, offs, offs, indexing="ij"),
                        -1).reshape(-1, 3)
        for h in hot:
            d2h = np.sum((dipole_pos - h) ** 2, axis=1)
            local = dipole_pos[
                d2h <= (reach + delta + prev_delta + 2 * g) ** 2]
            fine = h[None] + cube
            ci = _counts_at(fine, local, reach + delta)
            ce = _counts_at(fine, local, reach)
            floor = max(floor, int(ce.max()))
            worst_bound = max(worst_bound, int(ci.max()))
            new_hot.append(fine[ci > floor])
        hot = np.concatenate(new_hot) if new_hot else np.zeros((0, 3))
        hot = hot[_counts_at(hot, dipole_pos, reach + delta) > floor] \
            if len(hot) else hot
    return worst_bound                   # still certified, conservative


def default_travel_bound(params: Params) -> float:
    """Per-chunk walker travel bound, µm: ``travel_sigmas`` sigma per axis
    (times sqrt(3) for the 3D norm).

    Per-axis displacement over ``chunk_steps`` is a random walk with
    sigma = out_stdev * sqrt(chunk_steps) (extracellular D dominates).
    By the reflection principle, P(max_t |axis| > s*sigma) <= 2 P(N > s),
    so P(any-time 3D excursion > s*sigma*sqrt(3)) <= 6 P(N > s).  At the
    default s = 7 that is ~8e-12 per walker-chunk, i.e. ~3e-4 expected
    escape events over the full reference run (4032 walkers x 1e4
    chunks) — and every escape is *counted* by the engines (the escapes
    metric), so a violated bound is observable, not silent.  Single
    steps are hard-capped at 5.8 sigma by the 24-bit Box-Muller
    (rng.normal_from_bits).
    """
    sigma_axis = params.out_stdev * float(np.sqrt(params.chunk_steps))
    return float(params.travel_sigmas * sigma_axis * np.sqrt(3.0))

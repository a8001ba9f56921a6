"""The chunk-local field model, in plain PyTorch.

At each chunk start a walker's field is split in two: its K nearest
dipoles, summed exactly at every step, and the rest, as a second-order
Taylor expansion about the chunk's anchor.  Two ways to select:

* ``rebuild_model``: over the whole dipole table (scenes of at most
  2048 dipoles): sorted insertion of every entry, the coverage count
  within (cell_r + travel)^2, and the far sums without the K selected;
* ``scene_cache`` + ``cand_model``: over the C candidates of the
  anchor's cube (the scene's cube table, by bfloat16 argmin passes over
  the distances to the cube centres, as the simulator specifies), the
  candidates not selected as exact Taylor parts, and the beyond-candidate
  field from the cube's far table, an order-``order`` Taylor series
  about the cube centre built once per scene.

Layouts: walkers along the last axis; ``near`` [4, K, W] (x, y, z,
M * FIELD_SCALE), ``taylor`` [10, W] (b0, grad xyz, hess xx yy zz xy xz
yz).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .physics import FIELD_SCALE

WARP = 32


def bz_taylor_parts(dx, dy, dz, m_scaled):
    """Value, gradient and Hessian of one dipole's B_z at (dx, dy, dz);
    r^2 clamped at 1e-8 (an excluded dipole at r ~ 0 has weight 0)."""
    r2 = torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-8)
    inv_r = torch.rsqrt(r2)
    inv_r2 = inv_r * inv_r
    inv_r5 = inv_r2 * inv_r2 * inv_r
    inv_r7 = inv_r5 * inv_r2
    dz2 = dz * dz
    b0 = m_scaled * (3.0 * dz2 - r2) * inv_r5
    u = r2 - 5.0 * dz2
    v = 3.0 * r2 - 5.0 * dz2
    m3r7 = 3.0 * m_scaled * inv_r7
    u_r2 = 7.0 * u * inv_r2
    return (b0,
            m3r7 * dx * u, m3r7 * dy * u, m3r7 * dz * v,
            m3r7 * (u + dx * dx * (2.0 - u_r2)),
            m3r7 * (u + dy * dy * (2.0 - u_r2)),
            m3r7 * (v - dz2 * (4.0 + 7.0 * v * inv_r2)),
            m3r7 * dx * dy * (2.0 - u_r2),
            m3r7 * dx * dz * (-8.0 - u_r2),
            m3r7 * dy * dz * (-8.0 - u_r2))


def _inserter(d2s, d2):
    """Slot s takes a candidate of distance ``d2`` iff it beats slot s
    (strict) but not slot s-1; displaced slots shift down by one."""
    lt = d2 < d2s
    take_prev = torch.cat([torch.zeros_like(lt[:1]), lt[:-1]])
    take_new = lt & ~take_prev

    def put(new, old, k_dim=0):
        prev = torch.cat([old.narrow(k_dim, 0, 1),
                          old.narrow(k_dim, 0, old.shape[k_dim] - 1)],
                         k_dim)
        return torch.where(take_prev, prev, torch.where(take_new, new, old))
    return put


def sorted_insert(d2s, ids, d2, j):
    put = _inserter(d2s, d2)
    return put(d2, d2s), put(torch.as_tensor(j, dtype=ids.dtype,
                                             device=ids.device), ids)


def fetch_slots(rows, ids):
    """``rows`` [F, C, W] at slot ids [K, W] (-1: zeros) -> [F, K, W]."""
    at = ids.clamp(min=0).unsqueeze(0).expand(rows.shape[0], *ids.shape)
    got = torch.gather(rows, 1, at)
    return torch.where(ids >= 0, got, torch.zeros((), dtype=rows.dtype,
                                                  device=rows.device))


def excluded_weight(ids, j, dtype):
    return (ids != j).all(0).to(dtype)


def pack_table(pos, m):
    """[4, n_pad] table (x, y, z, M * FIELD_SCALE) padded to a multiple of
    8 with zero moments 1e6 µm away."""
    n = pos.shape[0]
    n_pad = -(-n // 8) * 8
    tbl = torch.zeros((4, n_pad), dtype=pos.dtype, device=pos.device)
    tbl[:3, n:] = 1e6
    tbl[:3, :n] = pos.T
    tbl[3, :n] = m * torch.tensor(FIELD_SCALE, dtype=m.dtype,
                                  device=m.device)
    return tbl


def far_sums(anchor, tbl, idx, block: int = 512):
    """The Taylor sums at ``anchor`` [3, W] over the table without the
    ids ``idx`` [K, W], added one dipole at a time in table order."""
    ax, ay, az = anchor[0], anchor[1], anchor[2]
    taylor = torch.zeros((10, anchor.shape[1]), dtype=anchor.dtype,
                         device=anchor.device)
    ids = idx[:, None, :]
    for j0 in range(0, tbl.shape[1], block):
        t = tbl[:, j0:j0 + block, None]
        parts = torch.stack(bz_taylor_parts(ax - t[0], ay - t[1],
                                            az - t[2], t[3]))
        col = torch.arange(j0, j0 + t.shape[1], device=anchor.device)
        parts = parts * excluded_weight(ids, col[:, None], anchor.dtype)
        for j in range(parts.shape[1]):
            taylor = taylor + parts[:, j]
    return taylor


def rebuild_model(anchor, tbl, k, cell_r2, travel, valid):
    """Whole-table selection at ``anchor`` [3, W]: (near, taylor, cov
    per warp)."""
    dev, dt = anchor.device, anchor.dtype
    w = anchor.shape[1]
    ax, ay, az = anchor
    cr2 = torch.tensor(cell_r2, dtype=dt, device=dev)
    reach = torch.sqrt(cr2) + travel
    reach2 = reach * reach
    dx = ax - tbl[0][:, None]
    dy = ay - tbl[1][:, None]
    dz = az - tbl[2][:, None]
    d2 = dx * dx + dy * dy + dz * dz
    cnt = (d2 < reach2).sum(0)
    d2s = torch.full((k, w), 1e30, dtype=dt, device=dev)
    ids = torch.full((k, w), -1, dtype=torch.int64, device=dev)
    for j in range(tbl.shape[1]):
        d2s, ids = sorted_insert(d2s, ids, d2[j], j)
    near = torch.where(ids[None] >= 0, tbl[:, ids.clamp(min=0)],
                       torch.zeros((), dtype=dt, device=dev))
    near[:3] = torch.where(ids[None] >= 0, near[:3],
                           torch.full((), 1e9, dtype=dt, device=dev))
    cov = ((cnt > k) & valid).to(dt).reshape(-1, WARP).sum(1)
    return near, far_sums(anchor, tbl, ids), cov


# -- the large-scene path ---------------------------------------------------

@functools.lru_cache(maxsize=16)
def monomials(order: int) -> tuple:
    out = []
    for p in range(order + 1):
        for i in range(p, -1, -1):
            for j in range(p - i, -1, -1):
                out.append((i, j, p - i - j))
    return tuple(out)


def cube_centers(h: int, bound: float) -> np.ndarray:
    cube = bound / h
    ax = (np.arange(h) + 0.5) * cube
    return np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                    -1).reshape(-1, 3)


@functools.lru_cache(maxsize=16)
def _product_pairs(order: int):
    mons = monomials(order)
    index = {m: t for t, m in enumerate(mons)}
    pairs = [[] for _ in mons]
    for a, ma in enumerate(mons):
        for b, mb in enumerate(mons):
            s = (ma[0] + mb[0], ma[1] + mb[1], ma[2] + mb[2])
            if sum(s) <= order:
                pairs[index[s]].append((a, b))
    width = max(len(p) for p in pairs)
    nc = len(mons)
    arr = np.array([p + [(nc, nc)] * (width - len(p)) for p in pairs],
                   np.int64)
    return arr[..., 0], arr[..., 1]


def _poly_mul(a, b, pairs):
    ia, ib = pairs
    za = torch.nn.functional.pad(a, (0, 1))
    zb = torch.nn.functional.pad(b, (0, 1))
    return (za[..., ia] * zb[..., ib]).sum(-1)


def _dipole_series(d0, order: int):
    """Taylor coefficients in e of (2 dz^2 - dx^2 - dy^2) / r^5 at
    d = d0 + e, by truncated polynomial arithmetic: (1 + s)^(-5/2) with
    s = (2 d0.e + |e|^2) / r0^2 by Horner over the binomial series."""
    mons = monomials(order)
    index = {m: t for t, m in enumerate(mons)}
    nc = len(mons)
    dev, dt = d0.device, d0.dtype
    pairs = tuple(torch.as_tensor(x, device=dev)
                  for x in _product_pairs(order))
    dx, dy, dz = d0[..., 0], d0[..., 1], d0[..., 2]
    r0sq = dx * dx + dy * dy + dz * dz
    inv_r0sq = 1.0 / r0sq
    unit = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
    square = ((2, 0, 0), (0, 2, 0), (0, 0, 2))

    def poly(const, lin, quad):
        p = torch.zeros((*d0.shape[:-1], nc), dtype=dt, device=dev)
        p[..., 0] = const
        for m, v in zip(unit, lin):
            p[..., index[m]] = v
        if order >= 2:
            for m, v in zip(square, quad):
                p[..., index[m]] = v
        return p

    s = poly(0.0, [2.0 * v * inv_r0sq for v in (dx, dy, dz)],
             [inv_r0sq] * 3)
    coef = [1.0]
    for n in range(1, order + 1):
        coef.append(coef[-1] * (-2.5 - (n - 1)) / n)
    series = torch.zeros_like(s)
    series[..., 0] = coef[order]
    for n in range(order - 1, -1, -1):
        series = _poly_mul(s, series, pairs)
        series[..., 0] = series[..., 0] + coef[n]
    num = poly(2.0 * dz * dz - dx * dx - dy * dy,
               [-2.0 * dx, -2.0 * dy, 4.0 * dz], [-1.0, -1.0, 2.0])
    inv_r5 = inv_r0sq * inv_r0sq / torch.sqrt(r0sq)
    return _poly_mul(num, series, pairs) * inv_r5[..., None]


def _far_table(pos, m, cand_idx, h, bound, order, max_elems=1 << 25):
    dev, dt = pos.device, pos.dtype
    n = pos.shape[0]
    centers = torch.as_tensor(cube_centers(h, bound), device=dev).to(dt)
    keep = torch.ones((h ** 3, n), dtype=torch.bool, device=dev)
    keep.scatter_(1, cand_idx.to(torch.int64), False)
    m_scaled = m * FIELD_SCALE
    ia, _ = _product_pairs(order)
    batch = max(1, max_elems // (n * ia.size))
    out = []
    for c0 in range(0, h ** 3, batch):
        d0 = centers[c0:c0 + batch, None, :] - pos[None]
        coef = _dipole_series(d0, order) * m_scaled[None, :, None]
        coef = torch.where(keep[c0:c0 + batch, :, None], coef,
                           torch.zeros((), dtype=dt, device=dev))
        out.append(coef.sum(1))
    return torch.cat(out)


def scene_cache(pos, m, h: int, c: int, bound: float, order: int):
    """(cand [H^3, C, 4] with M * FIELD_SCALE, far coefficients [H^3,
    n_coeffs]): each cube's C candidates by C masked argmin passes in
    bfloat16 over |centre|^2 + |p|^2 - 2 centre.p (first index on ties),
    then its far table over every other dipole."""
    c = min(c, pos.shape[0])
    centers = torch.as_tensor(cube_centers(h, bound),
                              device=pos.device).to(pos.dtype)
    an2 = (centers * centers).sum(-1)
    bn2 = (pos * pos).sum(-1)
    d2 = an2[:, None] + bn2[None, :] - 2.0 * (centers @ pos.T)
    remaining = (d2.to(torch.bfloat16) if d2.dtype == torch.float32
                 else d2).clone()
    rows = torch.arange(d2.shape[0], device=pos.device)
    picked = []
    for _ in range(c):
        j = torch.argmin(remaining, dim=1)
        picked.append(j)
        remaining[rows, j] = float("inf")
    table = torch.stack(picked, 1)
    scale = torch.tensor(FIELD_SCALE, dtype=pos.dtype, device=pos.device)
    cand = torch.cat([pos[table], (m[table] * scale)[..., None]],
                     -1).contiguous()
    coeffs = _far_table(pos, m, table, h, bound, order) if order else None
    return cand, coeffs


def _pows(x, order):
    ps = [torch.ones_like(x)]
    for _ in range(order):
        ps.append(ps[-1] * x)
    return ps


DERIVS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (2, 0, 0), (0, 2, 0),
          (0, 0, 2), (1, 1, 0), (1, 0, 1), (0, 1, 1))


def _falling(n, d):
    return 1 if d == 0 else n if d == 1 else n * (n - 1)


def eval_far_table(co, ex, ey, ez, order, accs):
    """Value, gradient and Hessian of the cube's series at (ex, ey, ez),
    added onto ``accs``: per monomial, each sum takes (c * f) * x^a
    (y^b z^c)."""
    px, py, pz = (_pows(x, order) for x in (ex, ey, ez))
    mono = {}

    def monomial(a, b, c):
        if (a, b, c) not in mono:
            mono[a, b, c] = px[a] * (py[b] * pz[c])
        return mono[a, b, c]

    out = list(accs)
    for t, (i, j, k) in enumerate(monomials(order)):
        for q, (di, dj, dk) in enumerate(DERIVS):
            if i >= di and j >= dj and k >= dk:
                f = _falling(i, di) * _falling(j, dj) * _falling(k, dk)
                out[q] = out[q] + co[t] * f * monomial(i - di, j - dj,
                                                       k - dk)
    return out


def cube_index(pos, h, bound):
    cube = torch.tensor(bound / h, dtype=pos.dtype, device=pos.device)
    return torch.clamp((pos / cube).to(torch.int32), 0, h - 1).long(), cube


def cand_model(pos, cand, coeffs, *, k, order, h, bound, reach2):
    """The model at wrapped anchors ``pos`` [3, W] from the anchor's
    cube: (near, taylor, n_reach as floats)."""
    dev, dt = pos.device, pos.dtype
    w = pos.shape[1]
    c = cand.shape[1]
    ci, cube = cube_index(pos, h, bound)
    flat = (ci[0] * h + ci[1]) * h + ci[2]
    pc = cand[flat].permute(2, 1, 0)
    cx, cy, cz, cm = pc
    ax, ay, az = pos[0], pos[1], pos[2]
    d2s = torch.full((k, w), 1e30, dtype=dt, device=dev)
    ids = torch.full((k, w), -1, dtype=torch.int64, device=dev)
    cnt = torch.zeros(w, dtype=dt, device=dev)
    for j in range(c):
        dx = ax - cx[j]
        dy = ay - cy[j]
        dz = az - cz[j]
        d2 = dx * dx + dy * dy + dz * dz
        cnt = cnt + (d2 < reach2).to(dt)
        d2s, ids = sorted_insert(d2s, ids, d2, j)
    parts = torch.stack(bz_taylor_parts(ax - cx, ay - cy, az - cz, cm))
    parts = parts * excluded_weight(
        ids[:, None, :], torch.arange(c, device=dev)[:, None], dt)
    accs = torch.zeros((10, w), dtype=dt, device=dev)
    for j in range(c):
        accs = accs + parts[:, j]
    e = pos - (ci.to(dt) + 0.5) * cube
    co = coeffs[flat].T
    taylor = eval_far_table(co, e[0], e[1], e[2], order, tuple(accs))
    return fetch_slots(pc, ids), torch.stack(taylor), cnt

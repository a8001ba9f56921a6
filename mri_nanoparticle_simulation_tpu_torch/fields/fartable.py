"""Per-cube far-field Taylor tables, in torch.

Counterpart of the reference's ``fields/fartable.py``: for every cube of
the selection lattice (``expansion.build_cache``), the Taylor expansion
about the cube centre, up to total degree ``order``, of the summed B_z of
every dipole NOT among the cube's candidates.  A large-scene chunk rebuild
then sums only the C candidates exactly and adds one polynomial.

The reference builds the coefficients with ``jax.jacfwd`` nested
``order`` deep, which computes 3^p partials at rank p where only
(p+1)(p+2)/2 differ.  Here they come from truncated Taylor arithmetic in
the offset e, batched over (cube, dipole) pairs: with d = c - p + e,

    B(e) = M' (2 dz^2 - dx^2 - dy^2) (r0^2 + delta)^(-5/2),
    delta = 2 d0.e + |e|^2,
    (r0^2 + delta)^(-5/2) = r0^-5 sum_n binom(-5/2, n) (delta / r0^2)^n,

each factor a polynomial in e truncated at ``order``; the product's
monomial coefficients are the table's (1/a! included), exactly, not an
approximation.  It is plain torch, and it runs once per scene.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .dipole import FIELD_SCALE


@functools.lru_cache(maxsize=16)
def monomials(order: int) -> tuple:
    """All (i, j, k) exponent triples with i+j+k <= order, grouped by
    total degree (the coefficient layout of the table's last axis)."""
    out = []
    for p in range(order + 1):
        for i in range(p, -1, -1):
            for j in range(p - i, -1, -1):
                out.append((i, j, p - i - j))
    return tuple(out)


def n_coeffs(order: int) -> int:
    return len(monomials(order))


def cube_centers(h: int, bound: float) -> np.ndarray:
    """[H^3, 3] cube-center lattice matching expansion.build_cache's
    flat index order ((ix * H + iy) * H + iz)."""
    cube = bound / h
    ax = (np.arange(h) + 0.5) * cube
    return np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                    -1).reshape(-1, 3)


@functools.lru_cache(maxsize=16)
def _product_pairs(order: int):
    """For each monomial t of ``order``, the index pairs (a, b) with
    monomial a + monomial b = monomial t, padded to one length with the
    pair (nc, nc), which points at a zero appended to each factor."""
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
    pad = [p + [(nc, nc)] * (width - len(p)) for p in pairs]
    arr = np.array(pad, np.int64)                       # [nc, width, 2]
    return arr[..., 0], arr[..., 1]


def _poly_mul(a, b, pairs):
    """Product of two truncated polynomials [..., nc] (same order)."""
    ia, ib = pairs
    za = torch.nn.functional.pad(a, (0, 1))
    zb = torch.nn.functional.pad(b, (0, 1))
    return (za[..., ia] * zb[..., ib]).sum(-1)


def _dipole_series(d0, order: int):
    """Taylor coefficients in e of (2 dz^2 - dx^2 - dy^2) / r^5 at
    d = d0 + e, for ``d0`` [..., 3]: [..., n_coeffs(order)]."""
    mons = monomials(order)
    index = {m: t for t, m in enumerate(mons)}
    nc = len(mons)
    dev, dt = d0.device, d0.dtype
    ia, ib = (torch.as_tensor(x, device=dev) for x in _product_pairs(order))
    pairs = (ia, ib)
    dx, dy, dz = d0[..., 0], d0[..., 1], d0[..., 2]
    r0sq = dx * dx + dy * dy + dz * dz
    inv_r0sq = 1.0 / r0sq
    unit = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
    square = ((2, 0, 0), (0, 2, 0), (0, 0, 2))

    def poly(const, lin, quad):
        """const + lin . e + quad . e^2 (quadratic terms dropped at
        order 1); ``lin`` / ``quad`` are 3 tensors or numbers each."""
        p = torch.zeros((*d0.shape[:-1], nc), dtype=dt, device=dev)
        p[..., 0] = const
        for m, v in zip(unit, lin):
            p[..., index[m]] = v
        if order >= 2:
            for m, v in zip(square, quad):
                p[..., index[m]] = v
        return p

    # s = delta / r0^2, delta = 2 d0.e + |e|^2
    s = poly(0.0, [2.0 * v * inv_r0sq for v in (dx, dy, dz)],
             [inv_r0sq] * 3)
    # (1 + s)^(-5/2) by Horner over the binomial series, truncated
    coef = [1.0]
    for n in range(1, order + 1):
        coef.append(coef[-1] * (-2.5 - (n - 1)) / n)
    series = torch.zeros_like(s)
    series[..., 0] = coef[order]
    for n in range(order - 1, -1, -1):
        series = _poly_mul(s, series, pairs)
        series[..., 0] = series[..., 0] + coef[n]
    # numerator 2 (d0z + ez)^2 - (d0x + ex)^2 - (d0y + ey)^2
    num = poly(2.0 * dz * dz - dx * dx - dy * dy,
               [-2.0 * dx, -2.0 * dy, 4.0 * dz], [-1.0, -1.0, 2.0])
    inv_r5 = inv_r0sq * inv_r0sq / torch.sqrt(r0sq)
    return _poly_mul(num, series, pairs) * inv_r5[..., None]


def build_far_table(mnp_pos, mnp_M, cand_idx, h: int, bound: float,
                    order: int, max_elems: int = 1 << 25):
    """[H^3, n_coeffs(order)] Taylor coefficients (monomial basis, 1/a!
    folded in) of the beyond-candidates field about each cube centre, in
    the dtype and on the device of ``mnp_pos``.

    ``mnp_pos`` [N, 3], ``mnp_M`` [N] (unscaled) include the periodic
    images; ``cand_idx`` [H^3, C] are the global ids of each cube's
    candidates, left out of its expansion.  Cubes go in batches that keep
    the [cubes, N, n_coeffs, pairs] product below ``max_elems``
    elements."""
    dev, dt = mnp_pos.device, mnp_pos.dtype
    n = mnp_pos.shape[0]
    n_cubes = h ** 3
    centers = torch.as_tensor(cube_centers(h, bound), device=dev).to(dt)
    keep = torch.ones((n_cubes, n), dtype=torch.bool, device=dev)
    keep.scatter_(1, cand_idx.to(device=dev, dtype=torch.int64), False)
    m_scaled = mnp_M * FIELD_SCALE
    ia, _ = _product_pairs(order)
    batch = max(1, max_elems // (n * ia.size))
    out = []
    for c0 in range(0, n_cubes, batch):
        d0 = centers[c0:c0 + batch, None, :] - mnp_pos[None]   # [B, N, 3]
        coef = _dipole_series(d0, order) * m_scaled[None, :, None]
        # where, not a product: a candidate at a cube centre is inf/nan
        coef = torch.where(keep[c0:c0 + batch, :, None], coef,
                           torch.zeros((), dtype=dt, device=dev))
        out.append(coef.sum(1))
    return torch.cat(out)


def eval_far_table_parts(get_coeff, ex, ey, ez, order: int, accs=None):
    """Value, gradient and Hessian of the tabulated series at offsets
    (ex, ey, ez), added onto ``accs`` (10 tensors, zeros when None).
    ``get_coeff(t)`` returns coefficient ``t`` broadcastable against the
    offsets.  Every term is formed left to right as in the reference, as
    the candidate-model kernel forms it (field_math.cuh:add_far_table)."""
    def pows(x):
        ps = [torch.ones_like(x)]
        for _ in range(order):
            ps.append(ps[-1] * x)
        return ps

    px, py, pz = pows(ex), pows(ey), pows(ez)
    if accs is None:
        z = torch.zeros_like(ex)
        accs = (z,) * 10
    b0, gx, gy, gz, hxx, hyy, hzz, hxy, hxz, hyz = accs
    for t, (i, j, k) in enumerate(monomials(order)):
        c = get_coeff(t)
        b0 = b0 + c * px[i] * py[j] * pz[k]
        if i:
            gx = gx + c * i * px[i - 1] * py[j] * pz[k]
        if j:
            gy = gy + c * j * px[i] * py[j - 1] * pz[k]
        if k:
            gz = gz + c * k * px[i] * py[j] * pz[k - 1]
        if i > 1:
            hxx = hxx + c * (i * (i - 1)) * px[i - 2] * py[j] * pz[k]
        if j > 1:
            hyy = hyy + c * (j * (j - 1)) * px[i] * py[j - 2] * pz[k]
        if k > 1:
            hzz = hzz + c * (k * (k - 1)) * px[i] * py[j] * pz[k - 2]
        if i and j:
            hxy = hxy + c * (i * j) * px[i - 1] * py[j - 1] * pz[k]
        if i and k:
            hxz = hxz + c * (i * k) * px[i - 1] * py[j] * pz[k - 1]
        if j and k:
            hyz = hyz + c * (j * k) * px[i] * py[j - 1] * pz[k - 1]
    return (b0, gx, gy, gz, hxx, hyy, hzz, hxy, hxz, hyz)


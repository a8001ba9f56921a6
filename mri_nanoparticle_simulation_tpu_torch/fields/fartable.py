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


def _pows(x, order: int):
    """[1, x, x^2, ..., x^order], each power the previous one times x."""
    ps = [torch.ones_like(x)]
    for _ in range(order):
        ps.append(ps[-1] * x)
    return ps


#: the orders (along x, y, z) of the derivative that each of the 10 sums
#: takes: value, gradient x y z, Hessian xx yy zz xy xz yz
DERIVS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (2, 0, 0), (0, 2, 0),
          (0, 0, 2), (1, 1, 0), (1, 0, 1), (0, 1, 1))


def _falling(n: int, d: int) -> int:
    """n (n - 1) ... (n - d + 1), for d = 0, 1, 2."""
    return 1 if d == 0 else n if d == 1 else n * (n - 1)


def eval_far_table_grouped(get_coeff, ex, ey, ez, order: int, accs=None):
    """Value, gradient and Hessian of the tabulated series at offsets
    (ex, ey, ez), added onto ``accs`` (10 tensors, zeros when None), as
    the candidate-model kernel evaluates them
    (field_math.cuh:add_far_table).  ``get_coeff(t)`` returns coefficient
    ``t`` broadcastable against the offsets.  Monomial by monomial, each
    of the 10 sums takes its term (c * f) * (x^a * (y^b * z^c)), with f
    the derivative's integer factor and (a, b, c) the monomial left after
    it; a monomial is the same product in every term that reaches it, so
    it is formed once.  The reference forms c f x^a y^b z^c left to right
    per term: the two differ by f32 rounding only."""
    px, py, pz = (_pows(x, order) for x in (ex, ey, ez))
    mono = {}

    def monomial(a, b, c):
        if (a, b, c) not in mono:
            mono[a, b, c] = px[a] * (py[b] * pz[c])
        return mono[a, b, c]

    if accs is None:
        accs = (torch.zeros_like(ex),) * 10
    out = list(accs)
    for t, (i, j, k) in enumerate(monomials(order)):
        c = get_coeff(t)
        for q, (di, dj, dk) in enumerate(DERIVS):
            if i >= di and j >= dj and k >= dk:
                f = _falling(i, di) * _falling(j, dj) * _falling(k, dk)
                out[q] = out[q] + c * f * monomial(i - di, j - dj, k - dk)
    return tuple(out)

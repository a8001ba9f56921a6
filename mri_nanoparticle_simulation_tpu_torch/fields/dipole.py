"""Point-dipole B_z field and its derivatives, in torch.

Counterpart of the reference's ``fields/dipole.py``: a walker at
displacement (dx, dy, dz) [µm] from a dipole of moment M feels
``B_z = M * 1e11 * (2 dz^2 - dx^2 - dy^2) / |r|^5`` [T], zeroed within
``cell_r`` of the dipole (the intracellular field is the phase kick's).
The expressions keep the reference's operation order, so the plain
chunk and the CUDA kernel round as the JAX kernels do.  The closed forms
of the unmasked field, its gradient and Hessian (``dipole_bz``,
``dipole_bz_grad``, ``dipole_bz_hessian``) serve the field grid and the
torch route of the far sums, which autograd differentiates.
"""

from __future__ import annotations

import torch

#: unit conversion baked into the reference formula (octree.cpp:209)
FIELD_SCALE = 1e11


def bz_taylor_parts(dx, dy, dz, m_scaled):
    """Value, gradient and Hessian of ONE dipole's B_z at displacement
    (dx, dy, dz): the 10 far-Taylor accumulator terms (b0, gx, gy, gz,
    hxx, hyy, hzz, hxy, hxz, hyz).  ``m_scaled`` is the moment already
    multiplied by FIELD_SCALE.  r^2 is clamped at 1e-8: an excluded
    dipole can sit at r ~ 0 and its weight of 0 discards the value."""
    r2 = dx * dx + dy * dy + dz * dz
    r2 = torch.clamp_min(r2, 1e-8)
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


def dipole_bz(dx, dy, dz, M):
    """Unmasked dipole B_z (octree.cpp:206-210); inputs broadcast.  1/r^5
    by sqrt and products, as the reference (exactly rounded, unlike a
    pow)."""
    r2 = dx * dx + dy * dy + dz * dz
    inv_r5 = 1.0 / (r2 * r2 * torch.sqrt(r2))
    return M * FIELD_SCALE * (2 * dz * dz - dx * dx - dy * dy) * inv_r5


def dipole_bz_grad(dx, dy, dz, M):
    """Gradient of the unmasked B_z with respect to the field point: with
    u = r^2 - 5 dz^2 and v = 3 r^2 - 5 dz^2, (3 M' dx u, 3 M' dy u,
    3 M' dz v) / r^7."""
    m = M * FIELD_SCALE
    r2 = dx * dx + dy * dy + dz * dz
    inv_r7 = 1.0 / (r2 * r2 * r2 * torch.sqrt(r2))
    u = r2 - 5 * dz * dz
    v = 3 * r2 - 5 * dz * dz
    return (3 * m * dx * u * inv_r7, 3 * m * dy * u * inv_r7,
            3 * m * dz * v * inv_r7)


def dipole_bz_hessian(dx, dy, dz, M):
    """Hessian (xx, yy, zz, xy, xz, yz) of the unmasked B_z, the
    reference's closed forms (dipole.py:105-137); traceless."""
    m3 = 3 * M * FIELD_SCALE
    r2 = dx * dx + dy * dy + dz * dz
    inv_r2 = 1.0 / r2
    inv_r7 = 1.0 / (r2 * r2 * r2 * torch.sqrt(r2))
    u = r2 - 5 * dz * dz
    v = 3 * r2 - 5 * dz * dz
    u_r2 = 7 * u * inv_r2
    hxx = m3 * (u + 2 * dx * dx - dx * dx * u_r2) * inv_r7
    hyy = m3 * (u + 2 * dy * dy - dy * dy * u_r2) * inv_r7
    hzz = m3 * (v - 4 * dz * dz - 7 * dz * dz * v * inv_r2) * inv_r7
    hxy = m3 * dx * dy * (2 - u_r2) * inv_r7
    hxz = m3 * dx * dz * (-8 - u_r2) * inv_r7
    hyz = m3 * dy * dz * (-8 - u_r2) * inv_r7
    return hxx, hyy, hzz, hxy, hxz, hyz


def dipole_bz_masked(dx, dy, dz, M, cell_r):
    """Dipole B_z, zero within ``cell_r`` (cuda_sim.cu:107-114); safe at
    r -> 0."""
    r2 = dx * dx + dy * dy + dz * dz
    outside = r2 > cell_r * cell_r
    safe_r2 = torch.where(outside, r2, torch.ones_like(r2))
    rs = torch.sqrt(safe_r2)
    inv_r5 = 1.0 / (safe_r2 * safe_r2 * rs)
    val = M * FIELD_SCALE * (2 * dz * dz - dx * dx - dy * dy) * inv_r5
    return torch.where(outside, val, torch.zeros_like(val))


def total_field_masked(pos, mnp_pos, mnp_M, cell_r):
    """Explicit masked dipole sum: the exact field the reference GPU
    integrates (get_field, cuda_sim.cu:269-286, every dipole at full
    precision).  O(n_pos * n_mnp); the oracle of the field dumps.

    pos: [..., 3]; mnp_pos: [N, 3]; mnp_M: [N].  Returns [...] B_z in
    Tesla."""
    d = pos[..., None, :] - mnp_pos  # [..., N, 3]
    return torch.sum(
        dipole_bz_masked(d[..., 0], d[..., 1], d[..., 2], mnp_M, cell_r),
        dim=-1)

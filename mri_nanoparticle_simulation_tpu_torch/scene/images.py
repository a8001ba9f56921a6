"""Periodic-boundary images of magnetic nanoparticles.

Mirrors SimulationBox::apply_bcs_on_mnps (src/SimulationBox.cpp:293-528).
A walker near a box face feels the field of dipoles across the periodic
boundary; the reference models this by duplicating every MNP within
``border`` (6 µm) of a face across that face (and edge/corner combinations).

The reference's default path (non-FULL_BOUNDARIES, SimulationBox.cpp:348-527)
appends, for each MNP, every non-identity combination of the per-axis shifts
available to it — that is exactly what the vectorized implementation below
produces (same image *set*; emission order differs, which is physically
irrelevant since dipole fields sum).

The FULL_BOUNDARIES variant (SimulationBox.cpp:293-340) is also provided; the
reference version contains a bug — it emits the ``x - bound`` image twice and
never emits ``x + bound`` (lines 307-308) — which we fix (all 26 distinct
images), as the buggy set cannot have been intended.
"""

from __future__ import annotations

import numpy as np

from ..params import BOUNDARY_FULL, BOUNDARY_NONE, Params


def apply_bcs_on_mnps(mnps: np.ndarray, params: Params) -> np.ndarray:
    """Append periodic images to an [n, 5] (x, y, z, r, M) MNP array.

    Returns a new array with the original rows first (order preserved),
    followed by image rows.
    """
    if params.boundary_mode == BOUNDARY_NONE:
        return mnps.copy()
    if params.boundary_mode == BOUNDARY_FULL:
        shifts = _all_26_shifts(params.bound)
        images = (mnps[:, None, :3] + shifts[None, :, :]).reshape(-1, 3)
        rest = np.repeat(mnps[:, 3:], len(shifts), axis=0)
        return np.concatenate(
            [mnps, np.concatenate([images, rest], axis=1)], axis=0)

    # BOUNDARY_BORDER: per-axis shift available only when the MNP is within
    # `border` of that face (else-if: one side per axis, matching
    # SimulationBox.cpp:356,419,482).
    b, brd = params.bound, params.border
    out = [mnps]
    x = mnps[:, :3]
    # shift per axis: -bound when near the + face, +bound when near the - face
    shift = np.zeros_like(x)
    for ax in range(3):
        near_hi = x[:, ax] + brd > b
        near_lo = (~near_hi) & (x[:, ax] - brd < 0)
        shift[near_hi, ax] = -b
        shift[near_lo, ax] = b
    # all 7 non-identity combinations of the available axis shifts
    for mask in range(1, 8):
        use = np.array([(mask >> 2) & 1, (mask >> 1) & 1, mask & 1], bool)
        sel = np.all((shift[:, use] != 0), axis=1) if use.any() else None
        rows = np.where(sel)[0]
        if len(rows) == 0:
            continue
        imgs = mnps[rows].copy()
        imgs[:, :3] += shift[rows] * use[None, :]
        out.append(imgs)
    return np.concatenate(out, axis=0)


def _all_26_shifts(bound: float) -> np.ndarray:
    shifts = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if (dx, dy, dz) != (0, 0, 0):
                    shifts.append((dx * bound, dy * bound, dz * bound))
    return np.array(shifts)

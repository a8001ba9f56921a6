"""Nearest-cell lookup table.

Mirrors SimulationBox::init_lookuptable (src/SimulationBox.cpp:262-290): a
hash_dim^3 lattice of points over the box; each lattice point lists the
indices of every cell whose center lies within ``cell_r + sqrt(3) *
cube_length`` of it (the criterion that guarantees any point in the hash
cube that is inside a cell has that cell in the candidate list).  Entries
beyond the candidate count are filled with -1, and — like the reference's
``assert(ncells.size() < p.maxNeighbors)`` — we require strictly fewer than
``max_neighbors`` candidates.

On device this becomes a dense int32 [hash_dim^3, max_neighbors] array
(the reference shipped it to the GPU as 8000 separate mallocs,
cuda_sim.cu:849-861).  The production engine does not consult it per step —
the chunked local expansion subsumes the in-cell test — but it is used by
scene utilities, the lookup-based reference engine path, and tests.
"""

from __future__ import annotations

import numpy as np

from ..params import Params


def build_lookup_table(cells: np.ndarray, params: Params) -> np.ndarray:
    """[hash_dim^3, max_neighbors] int32 candidate table, -1 padded."""
    h = params.hash_dim
    cl = params.hash_cube_length
    reach = params.cell_r + np.sqrt(3.0) * cl

    i = np.arange(h ** 3)
    # lattice point = lower corner of hash cube (SimulationBox.cpp:268-270)
    lat = np.stack([(i % h) * cl, ((i // h) % h) * cl, (i // (h * h)) * cl],
                   axis=1)
    d2 = np.sum((lat[:, None, :] - cells[None, :, :]) ** 2, axis=2)
    near = d2 < reach * reach  # [h^3, num_cells]

    counts = near.sum(axis=1)
    if counts.max() >= params.max_neighbors:
        raise ValueError(
            f"a lattice point has {counts.max()} candidate cells; "
            f"max_neighbors={params.max_neighbors} requires strictly fewer "
            f"(SimulationBox.cpp:281)")

    table = np.full((h ** 3, params.max_neighbors), -1, np.int32)
    # fill candidates in ascending cell-index order, like the reference loop
    rows, cols = np.nonzero(near)
    slot = np.zeros(h ** 3, np.int64)
    for r, c in zip(rows, cols):
        table[r, slot[r]] = c
        slot[r] += 1
    return table


def nearest_cell(pos: np.ndarray, cells: np.ndarray, table: np.ndarray,
                 params: Params):
    """Vectorized updateNearest (cuda_sim.cu:453-485) for [n, 3] positions.

    Returns (nearest_index, in_cell).  Used by tests and the scene's
    containment checks; the device engines have their own fused versions.
    """
    cl = params.hash_cube_length
    h = params.hash_dim
    idx = np.clip((pos // cl).astype(np.int64), 0, h - 1)
    flat = idx[:, 2] * h * h + idx[:, 1] * h + idx[:, 0]
    cand = table[flat]  # [n, K]
    valid = cand >= 0
    centers = cells[np.clip(cand, 0, None)]  # [n, K, 3]
    d2 = np.sum((pos[:, None, :] - centers) ** 2, axis=2)
    d2 = np.where(valid, d2, np.inf)
    best = np.argmin(d2, axis=1)
    best_d2 = d2[np.arange(len(pos)), best]
    nearest = np.where(np.isfinite(best_d2),
                       cand[np.arange(len(pos)), best], -1)
    in_cell = best_d2 < params.cell_r ** 2
    return nearest.astype(np.int32), in_cell

"""The scene, built again from the configuration's keys and scene seed in
plain NumPy (the words from ``rng.threefry``).

The simulator's documented scene: ``num_cells`` cells of radius
``cell_r`` thrown uniformly in [cell_r, bound - cell_r]^3, each throw
rejected while it lies closer than 2 cell_r to a cell already placed;
one dipole (radius 0, moment ``mmoment``) at each cell's centre, then
its periodic images across every face within ``border`` (and the edges
and corners those shifts combine to); waters thrown uniformly in the
centred ``water_start_bound`` cube, each throw rejected while inside a
cell, then sorted along a depth-7 Z-curve.  Each throw takes the next
two Threefry-20 counters (c0 = throw pair, c1 = the stream) under the
key (seed >> 32, seed & 0xFFFFFFFF), and its three uniforms are the
top 24 bits of the first three words.
"""

from __future__ import annotations

import numpy as np
import torch

from .rng import MASK, key_of, threefry

STREAM_CELLS = 0x800000C0
STREAM_WATERS = 0x800000A0
MORTON_DEPTH = 7


def throws(key, stream: int, first: int, n: int) -> np.ndarray:
    """Throws ``first`` .. ``first + n - 1`` of a stream: [n, 3] uniforms
    in [0, 1) as float64."""
    c0 = torch.arange(2 * first, 2 * (first + n), dtype=torch.int64) & MASK
    w0, w1 = threefry(key, c0, torch.full_like(c0, stream))
    words = torch.stack([w0, w1], -1).reshape(n, 4)[:, :3]
    return (words >> 8).numpy().astype(np.float64) * 2.0 ** -24


def cells(key, n: int, r: float, bound: float) -> np.ndarray:
    lo, span = r, bound - 2 * r
    out = np.empty((n, 3))
    i = t = 0
    batch = np.empty((0, 3))
    while i < n:
        if not len(batch):
            batch = lo + throws(key, STREAM_CELLS, t, 1024) * span
        xyz, batch = batch[0], batch[1:]
        t += 1
        if i == 0 or np.sum((out[:i] - xyz) ** 2, axis=1).min() \
                >= 4 * r * r:
            out[i] = xyz
            i += 1
    return out


def waters(key, n: int, centres: np.ndarray, r: float, bound: float,
           start: float, avoid: bool) -> np.ndarray:
    """Throws are rejected by the cells alone, so each is judged apart:
    the first ``n`` accepted throws in stream order.  A throw inside a
    cell has that cell's centre in one of the 27 bins (of side just over
    r) around its own, and no bin holds two centres 2r apart."""
    offset = (bound - start) / 2.0
    side = r * 1.01
    nb = int(np.ceil(bound / side)) + 3
    table = np.full((nb,) * 3, len(centres))
    table[tuple(np.floor(centres / side).astype(np.int64).T + 1)] = \
        np.arange(len(centres))
    padded = np.concatenate([centres, np.full((1, 3), np.inf)])
    steps = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3,
                                 indexing="ij"), -1).reshape(-1, 3)
    got, t = [], 0
    while sum(len(g) for g in got) < n:
        m = max(1024, n + n // 4)
        xyz = offset + throws(key, STREAM_WATERS, t, m) * start
        t += m
        if avoid:
            b = np.floor(xyz / side).astype(np.int64) + 1
            idx = table[tuple((b[:, None] + steps[None]).transpose(2, 0, 1))]
            d2 = np.sum((padded[idx] - xyz[:, None]) ** 2, axis=2)
            xyz = xyz[d2.min(axis=1) >= r ** 2]
        got.append(xyz)
    return np.concatenate(got)[:n]


def images(mnps: np.ndarray, bound: float, border: float) -> np.ndarray:
    """The dipoles, then for each within ``border`` of a face (the upper
    face first) every non-empty combination of its axes' shifts."""
    x = mnps[:, :3]
    shift = np.zeros_like(x)
    for ax in range(3):
        hi = x[:, ax] + border > bound
        shift[hi, ax] = -bound
        shift[~hi & (x[:, ax] - border < 0), ax] = bound
    out = [mnps]
    for mask in range(1, 8):
        use = np.array([(mask >> 2) & 1, (mask >> 1) & 1, mask & 1], bool)
        rows = np.where(np.all(shift[:, use] != 0, axis=1))[0]
        if len(rows):
            img = mnps[rows].copy()
            img[:, :3] += shift[rows] * use[None, :]
            out.append(img)
    return np.concatenate(out)


def _spread(v: np.ndarray) -> np.ndarray:
    v = v & np.uint64(0x1FFFFF)
    for s, m in ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
                 (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                 (2, 0x1249249249249249)):
        v = (v | (v << np.uint64(s))) & np.uint64(m)
    return v


def z_order(pos: np.ndarray, bound: float) -> np.ndarray:
    """Stable sort order along the Z-curve (x the high bit of each
    triple, z the low) of the positions quantised to 2^7 a side."""
    size = float(2 ** MORTON_DEPTH)
    q = np.clip(np.floor(pos / bound * size).astype(np.uint64), 0,
                2 ** MORTON_DEPTH - 1)
    code = (_spread(q[:, 0]) << np.uint64(2)) \
        | (_spread(q[:, 1]) << np.uint64(1)) | _spread(q[:, 2])
    return np.argsort(code, kind="stable")


def build(keys: dict, scene_seed: int) -> dict:
    """``waters`` [W, 3] and ``mnps`` [n, 5] (x, y, z, r, M; images
    after the dipoles) of the configuration's scene, as float64."""
    if keys["boundary_mode"] != "border":
        raise ValueError(f"boundary_mode {keys['boundary_mode']!r}: the "
                         f"reference builds the 'border' scene only")
    key = key_of(scene_seed)
    r, bound = float(keys["cell_r"]), float(keys["bound"])
    c = cells(key, int(keys["num_cells"]), r, bound)
    mnps = np.zeros((len(c), 5))
    mnps[:, :3] = c
    mnps[:, 4] = keys["mmoment"]
    w = waters(key, int(keys["num_water"]), c, r, bound,
               float(keys["water_start_bound"]),
               bool(keys["avoid_intracellular_throw"]))
    return {"waters": w[z_order(w, bound)],
            "mnps": images(mnps, bound, float(keys["border"]))}

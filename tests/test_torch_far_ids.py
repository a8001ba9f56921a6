"""The exclusion sets of the far-sums tests, shared by
tests/test_torch_large.py (the port against JAX on the CPU) and
tests/test_torch_cuda.py (the kernel against its plain version on the
card), and a check that they reach every edge of the kernel's tiling.

The far-sums kernel streams the table in 1024-entry tiles and leaves a
walker's near ids out through a bit mask per 32-entry sub-tile, so the
ids that matter are those on the first and last entry of a sub-tile or
tile and on the last real entry before the padding.
"""

import numpy as np

#: the ragged far-sums case: 301 walkers (not a multiple of 128 or of
#: 2) over 1029 dipoles, a table of 1032 entries (padded to a multiple of
#: 8) that crosses the kernel's 1024-entry tile and is no multiple of its
#: 32-entry sub-tile
FAR_RAGGED = (301, 1029)


def far_sums_ids(r, n, k, w):
    """int32 [K, w] near ids from the NumPy generator ``r``: distinct per
    walker, every second walker's drawn first from the entries at the
    edges of 16- and 32-entry sub-tiles and of the 1024-entry tile and
    the last real entry (n - 1), in turn, so each edge is left out by
    some walker; the order random."""
    edges = sorted({e for e in (0, 15, 16, 31, 32, 63, 64, 1023, 1024,
                                n - 1) if e < n})
    idx = np.empty((k, w), np.int32)
    for i in range(w):
        pick = ([edges[(i // 2 + j) % len(edges)]
                 for j in range(min(k, len(edges)))] if i % 2 == 0 else [])
        rest = r.choice(np.setdiff1d(np.arange(n), pick), k - len(pick),
                        replace=False)
        idx[:, i] = r.permutation(np.concatenate([pick, rest]))
    return idx


def test_far_sums_ids_reach_every_edge():
    """K distinct ids per walker, and every sub-tile, tile and table edge
    left out somewhere."""
    w, n = FAR_RAGGED
    for k in (1, 5, 10, 16):
        idx = far_sums_ids(np.random.default_rng(k), n, k, w)
        assert idx.shape == (k, w) and idx.dtype == np.int32
        assert all(len(set(col)) == k for col in idx.T)
        assert {0, 15, 16, 31, 32, 63, 64, 1023, 1024, 1028} <= set(
            idx.ravel().tolist())

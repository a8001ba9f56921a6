"""The (moment scale x echo spacing) plane folded from a decomposition
record, in plain PyTorch.

A decomposition run records, per walker and output window j, the field
part A_j and the kick part B_j of the phase, with the run's own
Carr-Purcell flips applied (a flip after window j iff j * pfreq is a
multiple of tcp).  The raw increments are d_j = x_j - s_{j-1} x_{j-1},
s = -1 at a flip.  At echo spacing t and moment scale s, window j's
phase is g_{j-1} (s SA_j + SB_j), with SA_j = sum_{k <= j} g_{k-1} dA_k
and g the parity of the flips at spacing t before window j.  The curve
point is the walker mean of (cos, g sin) of that phase.  Sums carry
from sprint to sprint with a Kahan compensation.
"""

from __future__ import annotations

import numpy as np
import torch


def sign_tables(n_windows: int, pfreq: int, tcp: int, tcps):
    """(u_prev [n], g [T, n]): the sign undoing the run's flip before each
    record row, and each spacing's flip parity g_{j-1} of row j - 1."""
    j = np.arange(1, n_windows + 1, dtype=np.int64)
    undo = np.where((j * pfreq) % tcp == 0, -1.0, 1.0)
    u_prev = np.concatenate([[1.0], undo[:-1]]).astype(np.float32)
    r = np.arange(n_windows, dtype=np.int64)
    g = np.stack([1.0 - 2.0 * (((r * pfreq) // t) & 1) for t in tcps])
    return u_prev, g.astype(np.float32)


def fold(wins, carry, u_prev, g_blk, scales, num_water):
    """One sprint: ``wins`` [wps, 2, W_pad] record, ``carry`` (SA, cA, SB,
    cB [T, W], prev_A, prev_B [W]), the sprint's ``u_prev`` [wps] and
    ``g_blk`` [T, wps].  Returns (carry', block [S, T, wps, 2])."""
    SA, cA, SB, cB, prev_A, prev_B = carry
    s_col = torch.as_tensor(np.asarray(scales, np.float32),
                            device=wins.device).to(wins.dtype)[:, None, None]
    x = wins[:, :, :num_water].transpose(0, 1)
    prev = torch.cat([torch.stack([prev_A, prev_B])[:, None], x[:, :-1]], 1)
    d = x - u_prev[:, None] * prev
    c = torch.cumsum(g_blk[:, :, None] * d[:, None], dim=2)
    s_sum = torch.stack([SA, SB])
    s = s_sum[:, :, None] + c
    blks = []
    for t in range(g_blk.shape[0]):
        inner = s_col * s[0, t] + s[1, t]
        blks.append(torch.stack([torch.cos(inner).mean(dim=2),
                                 g_blk[t] * torch.sin(inner).mean(dim=2)],
                                dim=-1))
    y = c[:, :, -1] - torch.stack([cA, cB])
    t_new = s_sum + y
    comp = (t_new - s_sum) - y
    carry = (t_new[0], comp[0], t_new[1], comp[1], x[0, -1].clone(),
             x[1, -1].clone())
    return carry, torch.stack(blks, dim=1)

"""The (moment scale x echo spacing) curves reconstructed from a whole
decomposition record, in plain PyTorch: the record path's host step
(README configuration 5c), written from its description.

A decomposition run records, per walker and output window j, the field
part A_j and the kick part B_j of the phase, with the run's own
Carr-Purcell flips applied (a flip after window j iff j * pfreq is a
multiple of tcp).  The raw increments are d_j = x_j - s_{j-1} x_{j-1},
s = -1 at a flip (``plane.sign_tables``).  At echo spacing t and moment
scale s, window j's phase is g_{j-1} sum_{k <= j} g_{k-1} (s dA_k +
dB_k), g the parity of the flips at spacing t before window j; the curve
point is the walker mean of the cosine and the sine of that phase.

Departures from the program's reconstruction: one cumulative sum over
all walkers at once (the program streams blocks of 1024 walkers), and
the means in torch's reduction order; in float64 both agree to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from .plane import sign_tables


def curves(A, B, scales, taucps, *, tau: float, pfreq: int, tcp: int,
           dtype=torch.float64, device="cpu") -> np.ndarray:
    """Walker-mean curves ``[S, T, n, 2]`` (cos, sin) of the record
    ``A``, ``B`` ``[n, W]`` at each moment scale and echo spacing (ms),
    worked out in ``dtype`` (float64; the control a precision below)."""
    dev = torch.device(device)
    a = torch.as_tensor(np.asarray(A), device=dev).to(dtype)
    b = torch.as_tensor(np.asarray(B), device=dev).to(dtype)
    n = a.shape[0]
    tcps = [int(round(t / tau)) for t in taucps]
    u_prev, g = sign_tables(n, pfreq, tcp, tcps)
    u = torch.as_tensor(u_prev, device=dev).to(dtype)[:, None]
    g = torch.as_tensor(g, device=dev).to(dtype)
    da = torch.cat([a[:1], a[1:] - u[1:] * a[:-1]])
    db = torch.cat([b[:1], b[1:] - u[1:] * b[:-1]])
    out = np.zeros((len(scales), len(tcps), n, 2))
    for si, s in enumerate(scales):
        d = float(s) * da + db
        for ti in range(len(tcps)):
            gi = g[ti][:, None]
            phi = gi * torch.cumsum(gi * d, dim=0)
            out[si, ti, :, 0] = torch.cos(phi).mean(1).double().cpu().numpy()
            out[si, ti, :, 1] = torch.sin(phi).mean(1).double().cpu().numpy()
    return out

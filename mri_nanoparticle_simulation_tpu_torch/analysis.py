"""T2 extraction from simulated decay curves (the subset the
phase-decomposition path uses).

The port's copy of the reference package's ``analysis.py`` lines 39-170,
pure NumPy: ``T2Fit``, ``echo_times``, ``echo_indices``,
``sample_at_echoes`` and ``fit_t2``.  A mono-exponential
``M(t) = A * exp(-t / T2)`` is fitted by Guggenheim-weighted log-linear
least squares (rows below ``floor`` of M0 left out), then refined by
Gauss-Newton in the signal domain.  With Carr-Purcell flips every
``taucp``, spin echoes refocus at t = 2k·taucp; ``echo_indices`` picks
the rows nearest those times so a fit sees the echo envelope.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class T2Fit(NamedTuple):
    t2_ms: float          #: fitted relaxation time
    amplitude: float      #: fitted M(0)
    r_squared: float      #: coefficient of determination in signal domain
    n_used: int           #: rows that entered the fit
    rms_residual: float   #: signal-domain RMS residual over used rows
    #: linearized 1-sigma errors from the Gauss-Newton normal matrix,
    #: assuming independent homoscedastic row noise.  Monte-Carlo decay
    #: rows share walkers and are therefore time-correlated, so these
    #: UNDERSTATE the true uncertainty — for honest error bars resample
    #: the walkers themselves (decompose.bootstrap_t2).
    t2_stderr_ms: float = float("nan")
    amplitude_stderr: float = float("nan")


def echo_times(taucp_ms: float, total_ms: float) -> np.ndarray:
    """Spin-echo centers t = 2k·taucp in (0, total]."""
    if not taucp_ms > 0:
        raise ValueError(f"taucp must be > 0 ms (got {taucp_ms!r})")
    # the epsilon keeps an echo that lands exactly on total_ms: the
    # binary ratio can fall a few ulps short of the integer (e.g.
    # 0.0002 / (2 * 0.0001)), which would silently drop the last echo
    n = int(np.floor(total_ms / (2.0 * taucp_ms) + 1e-9))
    return np.arange(1, n + 1) * (2.0 * taucp_ms)


def echo_indices(times_ms, taucp_ms: float) -> np.ndarray:
    """Row indices nearest each spin-echo center t = 2k·taucp
    (deduplicated, one row per echo)."""
    times_ms = np.asarray(times_ms, np.float64)
    centers = echo_times(taucp_ms, float(times_ms[-1]))
    idx = np.searchsorted(times_ms, centers)
    idx = np.clip(idx, 0, len(times_ms) - 1)
    # searchsorted gives the right neighbor; take whichever side is closer
    left = np.maximum(idx - 1, 0)
    pick = np.where(
        np.abs(times_ms[left] - centers) <= np.abs(times_ms[idx] - centers),
        left, idx)
    return np.unique(pick)


def sample_at_echoes(times_ms, signal, taucp_ms: float):
    """(times, signal) rows nearest each echo center (one row per echo)."""
    times_ms = np.asarray(times_ms, np.float64)
    signal = np.asarray(signal, np.float64)
    pick = echo_indices(times_ms, taucp_ms)
    return times_ms[pick], signal[pick]


def fit_t2(times_ms, signal, floor: float = 0.02,
           gn_iters: int = 8) -> T2Fit:
    """Fit M(t) = A exp(-t/T2) to a decay curve.

    ``signal`` is the magnetization (e.g. the CSV's Σcos φ column; scale
    does not matter).  ``floor``: rows below this fraction of the initial
    signal are excluded (decayed-to-noise tail).  Raises ValueError when
    fewer than 3 usable rows remain or the curve does not decay.
    """
    t = np.asarray(times_ms, np.float64)
    m = np.asarray(signal, np.float64)
    if t.shape != m.shape or t.ndim != 1:
        raise ValueError("times and signal must be equal-length 1D arrays")
    m0 = np.max(np.abs(m[: max(1, len(m) // 20)]))  # early-curve scale
    keep = m > floor * m0
    if keep.sum() < 3:
        raise ValueError(
            f"only {int(keep.sum())} rows above the noise floor "
            f"({floor:g} of M0={m0:g}); cannot fit")
    tk, mk = t[keep], m[keep]

    # Guggenheim-weighted log-linear start: minimize sum m^2 (ln m - (a - t/T2))^2
    w = mk * mk
    ln = np.log(mk)
    sw = w.sum()
    tbar = (w * tk).sum() / sw
    lbar = (w * ln).sum() / sw
    stt = (w * (tk - tbar) ** 2).sum()
    slope = (w * (tk - tbar) * (ln - lbar)).sum() / stt
    if slope >= 0:
        raise ValueError("curve does not decay (non-negative log slope)")
    t2 = -1.0 / slope
    amp = float(np.exp(lbar - slope * tbar))

    # Gauss-Newton in the signal domain on (A, T2)
    for _ in range(gn_iters):
        e = np.exp(-tk / t2)
        model = amp * e
        r = mk - model
        # Jacobian columns: d/dA = e; d/dT2 = A t e / T2^2
        j2 = amp * tk * e / (t2 * t2)
        a11 = (e * e).sum()
        a12 = (e * j2).sum()
        a22 = (j2 * j2).sum()
        b1 = (e * r).sum()
        b2 = (j2 * r).sum()
        det = a11 * a22 - a12 * a12
        if det <= 0:
            break
        da = (a22 * b1 - a12 * b2) / det
        dt = (a11 * b2 - a12 * b1) / det
        amp += da
        t2 += dt
        if not (np.isfinite(t2) and t2 > 0 and np.isfinite(amp)):
            raise ValueError("Gauss-Newton refinement diverged")
        if abs(dt) < 1e-12 * t2:
            break

    model = amp * np.exp(-tk / t2)
    res = mk - model
    ss_tot = ((mk - mk.mean()) ** 2).sum()
    r2 = 1.0 - (res ** 2).sum() / ss_tot if ss_tot > 0 else 0.0

    # Linearized parameter covariance at the solution: sigma^2 (J^T J)^-1
    # with J the final Jacobian.  See the T2Fit field note on why this
    # understates Monte-Carlo uncertainty (rows are walker-correlated).
    t2_se = amp_se = float("nan")
    n = len(mk)
    if n > 2:
        e = np.exp(-tk / t2)
        j2 = amp * tk * e / (t2 * t2)
        a11, a12, a22 = (e * e).sum(), (e * j2).sum(), (j2 * j2).sum()
        det = a11 * a22 - a12 * a12
        if det > 0:
            sigma2 = (res ** 2).sum() / (n - 2)
            amp_se = float(np.sqrt(sigma2 * a22 / det))
            t2_se = float(np.sqrt(sigma2 * a11 / det))

    return T2Fit(t2_ms=float(t2), amplitude=float(amp),
                 r_squared=float(r2), n_used=int(keep.sum()),
                 rms_residual=float(np.sqrt((res ** 2).mean())),
                 t2_stderr_ms=t2_se, amplitude_stderr=amp_se)

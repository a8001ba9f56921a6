"""T2 extraction from simulated decay curves.

The port's copy of the reference package's ``analysis.py``, pure NumPy
and carried over as it is: ``T2Fit``, ``echo_times``, ``echo_indices``,
``sample_at_echoes`` and ``fit_t2``; the closed-form CPMG rate
(``carr_purcell_r2``, ``design_gradient_for_r2``); the regularized T2
spectrum (``T2Spectrum``, ``_nnls``, ``fit_t2_spectrum``); the CSV fits
and ``main``, the ``mri-t2-fit`` command line:

    python -m mri_nanoparticle_simulation_tpu_torch.analysis t2.csv
    python -m mri_nanoparticle_simulation_tpu_torch.analysis \
        --echoes echoes.npz --bootstrap 200 --out-table t2_ci.csv

A mono-exponential ``M(t) = A * exp(-t / T2)`` is fitted by
Guggenheim-weighted log-linear least squares (rows below ``floor`` of M0
left out), then refined by Gauss-Newton in the signal domain.  With
Carr-Purcell flips every ``taucp``, spin echoes refocus at t = 2k·taucp;
``echo_indices`` picks the rows nearest those times so a fit sees the
echo envelope.  ``--record`` and ``--echoes`` bootstrap the walkers of a
decomposition record or of an on-device echo capture
(``engine.decompose``).
"""

from __future__ import annotations

import argparse
import sys
from typing import NamedTuple, Optional

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


def carr_purcell_r2(params, D: Optional[float] = None) -> float:
    """Closed-form CPMG decay rate for free diffusion in the configured
    background gradient (Carr & Purcell 1954, eq. for a pulse train with
    half echo spacing tau_cp):

        R2 = gamma^2 |G|^2 D_eff taucp^2 / 3        [1/ms]

    with gamma = phase_per_tesla / tau (rad/ms/T), |G| the magnitude of
    ``params.b0_gradient`` (T/µm) and D_eff = pi*D/6 — the engine's
    per-axis diffusivity (step stdev sqrt(pi*D*tau) with a normalized
    cube direction, E[u_z^2] = 1/3; the reference's kinematics,
    parameters.h:120-121 + cuda_sim.cu:562-583).  ``D`` defaults to
    ``params.D_extra`` (uniform free diffusion); pass the cell value or
    an effective one as appropriate.  This is the analytic anchor the
    gradient implementation is tested against (tests/test_gradient.py)
    and the b-value-style design tool for choosing a gradient."""
    import math as _math
    gamma_ms = params.phase_per_tesla / params.tau
    g2 = sum(float(g) ** 2 for g in params.b0_gradient)
    d = params.D_extra if D is None else float(D)
    d_eff = _math.pi * d / 6.0
    return gamma_ms ** 2 * g2 * d_eff * params.taucp ** 2 / 3.0


def design_gradient_for_r2(params, r2_per_ms: float,
                           D: Optional[float] = None) -> float:
    """Invert :func:`carr_purcell_r2`: the gradient MAGNITUDE (T/µm)
    whose CPMG train decays at ``r2_per_ms`` for free diffusion at
    ``D`` (default ``params.D_extra``) and the configured taucp.  The
    b-value design tool: put the result on one axis of
    ``b0_gradient`` (only |G| matters for the rate)."""
    import math as _math
    if not r2_per_ms >= 0:
        raise ValueError(f"r2_per_ms must be >= 0; got {r2_per_ms!r}")
    gamma_ms = params.phase_per_tesla / params.tau
    d = params.D_extra if D is None else float(D)
    d_eff = _math.pi * d / 6.0
    return _math.sqrt(3.0 * r2_per_ms
                      / (gamma_ms ** 2 * d_eff * params.taucp ** 2))


class T2Spectrum(NamedTuple):
    """A regularized multi-exponential T2 spectrum (``fit_t2_spectrum``)."""
    t2_grid_ms: np.ndarray   #: [K] log-spaced candidate T2 grid
    weights: np.ndarray      #: [K] nonnegative component amplitudes
    #: detected components: (T2_ms, amplitude) per contiguous weight
    #: cluster — T2 is the amplitude-weighted geometric mean
    peaks: tuple
    lambda_reg: float        #: Tikhonov weight actually used
    r_squared: float         #: signal-domain R^2 of the spectral model
    rms_residual: float      #: signal-domain RMS residual
    chi2_ratio: float        #: chi^2(lambda) / chi^2(0) (the W-M target)
    #: True when a component sits on the FIRST or LAST grid point: the
    #: true T2 lies at or beyond the grid edge (e.g. decay slower than
    #: the acquisition window resolves) and that peak's position is a
    #: bound, not an estimate — widen the grid or the window
    edge_clipped: bool = False


def _nnls(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Nonnegative least squares, Lawson-Hanson active-set (the
    classical algorithm; dependency-free so the analysis module stays
    NumPy-only).  Deterministic; sized for the K<=256 spectral grids
    this module solves."""
    m, n = A.shape
    x = np.zeros(n)
    passive = np.zeros(n, bool)
    atb = A.T @ b
    w = atb - A.T @ (A @ x)
    tol = 1e-11 * max(np.abs(atb).max(), 1.0)
    outer = 0
    while (~passive).any() and np.max(w[~passive]) > tol:
        outer += 1
        if outer > 3 * n:
            break
        j = int(np.argmax(np.where(~passive, w, -np.inf)))
        passive[j] = True
        while True:
            s = np.zeros(n)
            s[passive], *_ = np.linalg.lstsq(A[:, passive], b, rcond=None)
            if np.min(s[passive]) > 0:
                break
            # step toward s until the first passive coefficient hits 0,
            # then retire every zeroed coefficient to the active set
            blocking = passive & (s <= 0)
            alpha = np.min(x[blocking] / (x[blocking] - s[blocking]))
            x = x + alpha * (s - x)
            passive &= x > 1e-12 * (np.abs(x).max() + 1.0)
            x[~passive] = 0.0
            if not passive.any():
                return x
        x = s
        w = atb - A.T @ (A @ x)
    return x


def fit_t2_spectrum(times_ms, signal, n_t2: int = 64,
                    t2_min_ms: Optional[float] = None,
                    t2_max_ms: Optional[float] = None,
                    chi2_factor: float = 1.02,
                    lambda_reg: Optional[float] = None,
                    peak_floor: float = 1e-3) -> T2Spectrum:
    """Fit a T2 SPECTRUM: M(t) = sum_k a_k exp(-t / T2_k), a_k >= 0
    over a log-spaced T2 grid — the multi-compartment generalization of
    :func:`fit_t2` (heterogeneous scenes — clustered geometries, mixed
    cell sizes, D sweeps — decay multi-exponentially, and a
    mono-exponential fit averages the compartments away).

    Method: Tikhonov-regularized nonnegative least squares, the standard
    myelin-water-imaging estimator (Whittall & MacKay, J. Magn. Reson.
    84:134, 1989): solve ``min ||A a - y||^2 + lambda^2 ||a||^2, a >= 0``
    with ``A[i,k] = exp(-t_i / T2_k)``, choosing lambda (unless given)
    so the misfit is ``chi2_factor`` x the unregularized minimum —
    bias-variance at a documented, conventional knob (1.02).

    Grid defaults: ``t2_min_ms`` = 2x the first sample time (faster
    components are not resolvable), ``t2_max_ms`` = 3x the last (slower
    ones are indistinguishable from a constant).  ``peaks`` reports
    contiguous weight clusters above ``peak_floor`` x max weight as
    (T2, amplitude) pairs.
    """
    t = np.asarray(times_ms, np.float64)
    y = np.asarray(signal, np.float64)
    if t.shape != y.shape or t.ndim != 1:
        raise ValueError("times and signal must be equal-length 1D arrays")
    if n_t2 < 8 or n_t2 > 256:
        raise ValueError(f"n_t2 must be in [8, 256]; got {n_t2}")
    ok = np.isfinite(y)
    t, y = t[ok], y[ok]
    if len(t) < 8:
        raise ValueError(f"need >= 8 finite samples for a spectrum "
                         f"({len(t)} of {len(ok)})")
    t2_min = 2.0 * t[0] if t2_min_ms is None else float(t2_min_ms)
    t2_max = 3.0 * t[-1] if t2_max_ms is None else float(t2_max_ms)
    if not (0 < t2_min < t2_max):
        raise ValueError(f"need 0 < t2_min < t2_max; got "
                         f"({t2_min:g}, {t2_max:g})")
    grid = np.geomspace(t2_min, t2_max, n_t2)
    A = np.exp(-t[:, None] / grid[None, :])

    def solve(lam):
        if lam == 0.0:
            return _nnls(A, y)
        A_aug = np.vstack([A, lam * np.eye(n_t2)])
        return _nnls(A_aug, np.concatenate([y, np.zeros(n_t2)]))

    def chi2(x):
        return float(((A @ x - y) ** 2).sum())

    x0 = solve(0.0)
    c0 = chi2(x0)
    if lambda_reg is not None:
        lam = float(lambda_reg)
        x = solve(lam)
    elif c0 == 0.0 or chi2_factor <= 1.0:
        lam, x = 0.0, x0
    else:
        target = chi2_factor * c0
        # bracket then bisect on log lambda (chi^2 is monotone in lambda)
        hi = np.sqrt((A * A).sum() / n_t2)
        x_hi = solve(hi)
        grow = 0
        while chi2(x_hi) < target and grow < 60:
            hi *= 4.0
            x_hi = solve(hi)
            grow += 1
        lam, x = hi, x_hi
        lo_l = hi / 4.0 if grow else 0.0
        for _ in range(24):
            mid = np.sqrt(lo_l * hi) if lo_l > 0 else hi / 2.0
            xm = solve(mid)
            if chi2(xm) < target:
                lo_l = mid
            else:
                hi, lam, x = mid, mid, xm
            if lo_l > 0 and hi / lo_l < 1.01:
                break

    resid = A @ x - y
    ss_tot = ((y - y.mean()) ** 2).sum()
    r2 = 1.0 - (resid ** 2).sum() / ss_tot if ss_tot > 0 else 0.0

    peaks = []
    thresh = peak_floor * x.max() if x.max() > 0 else np.inf
    in_run = False
    for k in range(n_t2 + 1):
        on = k < n_t2 and x[k] > thresh
        if on and not in_run:
            start, in_run = k, True
        elif not on and in_run:
            w_run = x[start:k]
            amp = float(w_run.sum())
            t2_gm = float(np.exp((w_run * np.log(grid[start:k])).sum()
                                 / amp))
            peaks.append((t2_gm, amp))
            in_run = False

    return T2Spectrum(t2_grid_ms=grid, weights=x, peaks=tuple(peaks),
                      lambda_reg=float(lam), r_squared=float(r2),
                      rms_residual=float(np.sqrt((resid ** 2).mean())),
                      chi2_ratio=float(chi2(x) / c0) if c0 > 0 else 1.0,
                      edge_clipped=bool(np.isfinite(thresh)
                                        and (x[0] > thresh
                                             or x[-1] > thresh)))


def fit_t2_spectrum_csv(path: str, taucp_ms: Optional[float] = None,
                        magnitude: bool = False,
                        **kw) -> T2Spectrum:
    """:func:`fit_t2_spectrum` on a decay CSV; ``taucp_ms`` samples the
    Carr-Purcell echo envelope first (as :func:`fit_t2_csv`)."""
    from .io.writer import read_t2_csv
    cols = read_t2_csv(path)
    if magnitude:
        if len(cols) < 3:
            raise ValueError(
                f"{path} has no quadrature (sum_sin) column; --magnitude "
                f"needs a --quadrature CSV")
        t, m = cols[0], np.hypot(cols[1], cols[2])
    else:
        t, m = cols[0], cols[1]
    if taucp_ms is not None:
        t, m = sample_at_echoes(t, m, taucp_ms)
    return fit_t2_spectrum(t, m, **kw)


def fit_t2_csv(path: str, taucp_ms: Optional[float] = None,
               floor: float = 0.02, magnitude: bool = False) -> T2Fit:
    """Fit a T2 CSV (ours or the reference's).  ``taucp_ms`` switches to
    echo-envelope sampling (rows nearest t = 2k·taucp).

    ``magnitude`` fits |M| = sqrt(sum_cos^2 + sum_sin^2) instead of the
    in-phase component — the quantity magnitude-mode acquisitions
    measure, robust to global off-resonance rotation (requires the
    quadrature column, ``--quadrature`` products; the reference emits
    cos only, cuda_sim.cu:825)."""
    from .io.writer import read_t2_csv
    cols = read_t2_csv(path)
    if magnitude:
        if len(cols) < 3:
            raise ValueError(
                f"{path} has no quadrature (sum_sin) column; --magnitude "
                f"needs a --quadrature CSV")
        t, m = cols[0], np.hypot(cols[1], cols[2])
    else:
        t, m = cols[0], cols[1]
    if taucp_ms is not None:
        t, m = sample_at_echoes(t, m, taucp_ms)
    return fit_t2(t, m, floor=floor)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Fit T2 from a decay CSV (time_ms, sum_cos_phi), or "
                    "with Monte-Carlo error bars from a decomposition "
                    "record (mri-t2-sim --dump-record)")
    ap.add_argument("csv", nargs="*", help="CSV path(s)")
    ap.add_argument("--taucp", type=float, default=None,
                    help="Carr-Purcell taucp (ms): fit the echo envelope "
                         "(rows nearest t = 2k*taucp) instead of every row")
    ap.add_argument("--floor", type=float, default=0.02,
                    help="exclude rows below this fraction of M0")
    ap.add_argument("--magnitude", action="store_true",
                    help="fit |M| = sqrt(cos^2 + sin^2) (needs the "
                         "--quadrature column; CSV inputs only)")
    ap.add_argument("--spectrum", action="store_true",
                    help="fit a multi-exponential T2 SPECTRUM "
                         "(regularized NNLS over a log-spaced T2 grid, "
                         "Whittall-MacKay) instead of one exponential — "
                         "heterogeneous scenes decay multi-"
                         "exponentially; prints the detected "
                         "(T2, amplitude) components")
    ap.add_argument("--spectrum-bins", type=int, default=64,
                    help="T2 grid size for --spectrum")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="decomposition record (--dump-record .npz or "
                         "--record-dir store directory): walker-"
                         "bootstrap T2 with a confidence interval")
    ap.add_argument("--echoes", default=None, metavar="NPZ",
                    help="on-device spin-echo capture (mri-t2-sim "
                         "--plane-device --dump-echoes): walker-"
                         "bootstrap T2 with confidence intervals for "
                         "every captured (moment-scale x taucp) grid "
                         "point — no record ever existed")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="moment scale to reconstruct at (--record only)")
    ap.add_argument("--bootstrap", type=int, default=200, metavar="N",
                    help="bootstrap resamples (--record only)")
    ap.add_argument("--ci", type=float, default=0.95,
                    help="two-sided confidence level (--record only)")
    ap.add_argument("--seed", type=int, default=0,
                    help="bootstrap resampling seed (--record only)")
    ap.add_argument("--taucp-grid", default=None, metavar="T1,T2,...",
                    help="with --record: bootstrap the whole CPMG "
                         "dispersion R2(taucp) with confidence "
                         "intervals from the one record")
    ap.add_argument("--out-table", default=None, metavar="CSV",
                    help="with --taucp-grid: write the dispersion table "
                         "(taucp_ms,r2_per_ms,t2_ms,t2_lo_ms,t2_hi_ms,"
                         "t2_stderr_ms,n_ok)")
    args = ap.parse_args(argv)
    if args.taucp_grid is not None and args.record is None:
        ap.error("--taucp-grid reconstructs echo spacings from a "
                 "decomposition record; pass --record")
    if args.out_table is not None and args.taucp_grid is None \
            and args.echoes is None and not args.spectrum:
        ap.error("--out-table goes with --taucp-grid, --echoes or "
                 "--spectrum")
    if args.spectrum and (args.record or args.echoes):
        ap.error("--spectrum fits decay CSVs; reconstruct a CSV from "
                 "the record first (mri-t2-sim --moment-scales)")
    if args.spectrum and not args.csv:
        ap.error("--spectrum needs CSV input(s)")
    if args.spectrum and args.out_table and len(args.csv) > 1:
        ap.error("--spectrum --out-table writes ONE table; pass one CSV")
    if args.taucp is not None and not args.taucp > 0:
        ap.error("--taucp must be > 0 (ms)")
    if not args.csv and args.record is None and args.echoes is None:
        ap.error("give CSV path(s), --record, and/or --echoes")
    if args.magnitude and not args.csv:
        ap.error("--magnitude applies to CSV inputs")
    if args.spectrum:
        for path in args.csv:
            sp = fit_t2_spectrum_csv(path, taucp_ms=args.taucp,
                                     magnitude=args.magnitude,
                                     n_t2=args.spectrum_bins)
            comps = ", ".join(f"T2 = {t2:.4g} ms (A = {a:.4g})"
                              for t2, a in sp.peaks) or "none detected"
            print(f"{path}: {len(sp.peaks)} component(s): {comps}  "
                  f"[lambda = {sp.lambda_reg:.3g}, "
                  f"R^2 = {sp.r_squared:.5f}, "
                  f"chi2 ratio {sp.chi2_ratio:.4g}]")
            if sp.edge_clipped:
                print(f"  WARNING: a component sits on the T2-grid "
                      f"edge ([{sp.t2_grid_ms[0]:.3g}, "
                      f"{sp.t2_grid_ms[-1]:.3g}] ms) — its true T2 "
                      f"lies at or beyond the edge (position is a "
                      f"bound, not an estimate); lengthen the "
                      f"acquisition or widen the grid")
            if args.out_table:
                with open(args.out_table, "w") as f:
                    f.write("t2_ms,weight\n")
                    for t2, wv in zip(sp.t2_grid_ms, sp.weights):
                        f.write(f"{t2:.10g},{wv:.10g}\n")
                print(f"spectrum table written: {args.out_table}")
        return 0
    for path in args.csv:
        f = fit_t2_csv(path, taucp_ms=args.taucp, floor=args.floor,
                       magnitude=args.magnitude)
        print(f"{path}: T2 = {f.t2_ms:.4g} ms  (A = {f.amplitude:.4g}, "
              f"R^2 = {f.r_squared:.5f}, {f.n_used} rows, "
              f"rms residual {f.rms_residual:.3g})")
    if args.echoes is not None:
        from .engine.decompose import bootstrap_from_echoes, load_echoes
        if not args.bootstrap >= 2:
            ap.error("--bootstrap must be >= 2")
        nan = float("nan")
        rows = []
        for e in load_echoes(args.echoes):
            row = {"mscale": e.scale, "taucp_ms": e.taucp_ms,
                   "r2_per_ms": nan, "t2_ms": nan, "t2_lo_ms": nan,
                   "t2_hi_ms": nan, "t2_stderr_ms": nan, "n_ok": 0}
            try:
                b = bootstrap_from_echoes(
                    e.times_ms, e.cos, n_boot=args.bootstrap,
                    seed=args.seed, ci=args.ci, floor=args.floor)
                row.update(r2_per_ms=1.0 / b.fit.t2_ms, t2_ms=b.fit.t2_ms,
                           t2_lo_ms=b.t2_lo_ms, t2_hi_ms=b.t2_hi_ms,
                           t2_stderr_ms=b.t2_stderr_ms, n_ok=b.n_ok)
            except ValueError as err:
                print(f"{args.echoes} mscale={e.scale:g} "
                      f"taucp={e.taucp_ms:g}: unfittable ({err})")
            rows.append(row)
        cols = ("mscale", "taucp_ms", "r2_per_ms", "t2_ms", "t2_lo_ms",
                "t2_hi_ms", "t2_stderr_ms", "n_ok")
        if args.out_table:
            with open(args.out_table, "w") as f:
                f.write("\n".join(
                    [",".join(cols)]
                    + [",".join(str(r[c]) for c in cols) for r in rows])
                    + "\n")
            print(f"echo-bootstrap table written: {args.out_table}")
        pct = 100.0 * args.ci
        for r in rows:
            if r["n_ok"]:
                print(f"{args.echoes} mscale={r['mscale']:g} "
                      f"taucp={r['taucp_ms']:g}: "
                      f"T2 = {r['t2_ms']:.4g} ms "
                      f"[{r['t2_lo_ms']:.4g}, {r['t2_hi_ms']:.4g}] "
                      f"{pct:g}% CI, sigma = {r['t2_stderr_ms']:.3g} ms "
                      f"({r['n_ok']}/{args.bootstrap} resamples)")
    if args.record is not None and args.taucp_grid is not None:
        from .engine.decompose import bootstrap_dispersion_record
        if not args.bootstrap >= 2:
            ap.error("--bootstrap must be >= 2")
        try:
            taucps = [float(x) for x in args.taucp_grid.split(",") if x]
        except ValueError:
            ap.error(f"--taucp-grid must be comma-separated ms values, "
                     f"got {args.taucp_grid!r}")
        rows = bootstrap_dispersion_record(
            args.record, taucps, scale=args.scale, n_boot=args.bootstrap,
            seed=args.seed, ci=args.ci, floor=args.floor)
        cols = ("taucp_ms", "r2_per_ms", "t2_ms", "t2_lo_ms", "t2_hi_ms",
                "t2_stderr_ms", "n_ok")
        lines = [",".join(cols)] + [
            ",".join(str(r[c]) for c in cols) for r in rows]
        if args.out_table:
            with open(args.out_table, "w") as f:
                f.write("\n".join(lines) + "\n")
            print(f"dispersion table written: {args.out_table}")
        pct = 100.0 * args.ci
        for r in rows:
            print(f"{args.record} taucp={r['taucp_ms']:g}: "
                  f"T2 = {r['t2_ms']:.4g} ms "
                  f"[{r['t2_lo_ms']:.4g}, {r['t2_hi_ms']:.4g}] {pct:g}% "
                  f"CI, sigma = {r['t2_stderr_ms']:.3g} ms "
                  f"({r['n_ok']}/{args.bootstrap} resamples)")
        return 0
    if args.record is not None:
        from .engine.decompose import bootstrap_t2_record
        if not args.bootstrap >= 2:
            ap.error("--bootstrap must be >= 2")
        b = bootstrap_t2_record(args.record, scale=args.scale,
                                taucp=args.taucp, n_boot=args.bootstrap,
                                seed=args.seed, ci=args.ci,
                                floor=args.floor)
        pct = 100.0 * args.ci
        print(f"{args.record} (scale {args.scale:g}): "
              f"T2 = {b.fit.t2_ms:.4g} ms  "
              f"[{b.t2_lo_ms:.4g}, {b.t2_hi_ms:.4g}] {pct:g}% CI, "
              f"sigma = {b.t2_stderr_ms:.3g} ms "
              f"({b.n_ok}/{args.bootstrap} resamples, "
              f"R^2 = {b.fit.r_squared:.5f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

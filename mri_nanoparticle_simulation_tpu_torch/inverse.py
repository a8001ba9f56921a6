"""Inverse relaxometry: recover physical parameters from an observed
magnetization decay, in torch.

Counterpart of the reference's ``inverse.py``, function by function and
in its order:

* **AD through the simulator** (``make_curve_fn`` / ``fit_moment_scale``
  for the moment, ``make_diffusion_curve_fn`` / ``fit_diffusion_scale``
  for the diffusion coefficients): the scan engine
  (``engine/reference_engine.py``) is plain torch, so torch autograd
  differentiates a whole run.  The Threefry draws and the near
  selection are integer or selection work, constants of the
  differentiation: the pathwise derivative on frozen trajectories.
  Each sprint runs under ``torch.utils.checkpoint`` (the reference's
  ``jax.checkpoint``): the forward keeps no tape, and the backward
  recomputes one sprint at a time, so its memory is one sprint's tape.
  The draws are counter-based, so the recompute is exact.  Adam is
  ``torch.optim.Adam`` (optax's defaults), the loop a Python loop.
* **Common random numbers on the kernels** (``make_engine_curve_fn``,
  ``fit_diffusion_scale_crn``, ``fit_cell_radius_crn``,
  ``fit_permeability_crn``, ``fit_joint_crn``): forward runs of the
  chunk kernels (``engine="pallas"``) or the scan engine at launch
  scalars, with a derivative-free search on the host; the counter
  generators make the loss a deterministic function of the parameter.
* **The decomposition record** (``fit_moment_scale_decomposed``,
  ``fit_from_record``): phase = s * A + B exactly, so the moment scale
  is fitted on the closed form mean(cos(s A + B)) with no simulator in
  the loop.

Every function takes ``device``, the card unless the caller asks for
the CPU.  ``python -m mri_nanoparticle_simulation_tpu_torch.inverse``
is the reference's ``mri-t2-invert`` demo.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .params import Params


class MomentFitResult(NamedTuple):
    scale: float            #: fitted scale (moment, d_scale, cell_r or P)
    mmoment: float          #: fitted absolute moment (nan if not a moment)
    loss: float             #: final (or best) mean-squared curve error
    scale_history: np.ndarray   #: [iters] scale per iteration / probe
    loss_history: np.ndarray    #: [iters] loss per iteration / probe


def _scene_tensors(scene, device, dtype):
    """The scene's dipole positions [N, 3] and moments [N], rounded to
    float32 first as the reference does, on ``device``."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=device).to(dtype)
    return t(scene.mnps[:, :3]), t(scene.mnps[:, 4])


def _scan_curve(params: Params, scene, seed: int, dtype, device,
                sprint_kw: Callable) -> Callable:
    """``curve(x) -> m[t]`` through the scan engine, each sprint under a
    non-reentrant ``torch.utils.checkpoint``; ``sprint_kw(x, M)`` gives
    the sprint's (mnp_M, overrides) for the value ``x``."""
    from torch.utils.checkpoint import checkpoint

    from . import rng
    from .engine import reference_engine as re

    dtype = dtype or torch.float32
    device = torch.device(device)
    p = params.validate()   # rejects t % sprint_steps != 0, among others
    sprint = re.make_sprint_fn(p, device, dtype=dtype)
    key = rng.key_from_seed(seed)
    mnp_pos, base_M = _scene_tensors(scene, device, dtype)
    st0 = re.init_state(scene.waters, p, device, dtype)
    n_sprints = p.t // p.sprint_steps

    def body(st, x):
        mM, kw = sprint_kw(x, base_M)
        st, wins = sprint(mnp_pos, mM, key, st, 0, **kw)
        return st, wins[:, 0]

    def curve(x):
        x = torch.as_tensor(x, dtype=dtype, device=device)
        st, cos = st0, []
        for _ in range(n_sprints):
            if x.requires_grad:
                st, c = checkpoint(body, st, x, use_reentrant=False)
            else:
                st, c = body(st, x)
            cos.append(c)
        return torch.cat(cos) / p.num_water

    return curve


def make_curve_fn(params: Params, scene, seed: int = 0, dtype=None, *,
                  device="cuda") -> Callable:
    """Build ``curve(moment_scale) -> m[t]``: the normalized magnetization
    curve (Σcos φ / num_water, one point per output window) as a
    differentiable function of the moment scale (a float or a scalar
    tensor, with autograd), on a fixed scene and RNG seed (frozen
    trajectories).  Each sprint is checkpointed: the backward's memory
    is one sprint's tape."""
    return _scan_curve(params, scene, seed, dtype, device,
                       lambda s, M: (M * s, {}))


def _adam_fit(loss_fn, init_scale: float, iters: int, lr: float, device):
    """Adam on theta = log(scale) (``torch.optim.Adam``: optax's
    b1 0.9, b2 0.999, eps 1e-8 outside the root).  Returns (scale,
    scales [iters] after each update, losses [iters] before it), as the
    reference's one-scan loop records them."""
    theta = torch.tensor(np.log(init_scale), dtype=torch.float32,
                         device=device, requires_grad=True)
    opt = torch.optim.Adam([theta], lr=lr)
    scales, losses = [], []
    for _ in range(iters):
        opt.zero_grad()
        loss = loss_fn(theta)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        scales.append(float(torch.exp(theta.detach())))
    return float(torch.exp(theta.detach())), np.asarray(scales, np.float32), \
        np.asarray(losses, np.float32)


def _check_target(target, params: Params, device):
    target = torch.as_tensor(np.array(target, np.float32), device=device)
    n = params.t // params.pfreq
    if tuple(target.shape) != (n,):
        raise ValueError(f"target must have one value per output window "
                         f"([{n}]), got {tuple(target.shape)}")
    return target


def fit_moment_scale(target, params: Params, scene, *, seed: int = 0,
                     init_scale: float = 1.0, iters: int = 80,
                     lr: float = 0.05, dtype=None,
                     device="cuda") -> MomentFitResult:
    """Recover the moment scale that produced ``target`` (a normalized
    magnetization curve, one value per output window): Adam on
    log(scale) through the scan engine by autograd.  With ``seed`` equal
    to the target's simulation seed the loss minimum is exactly the true
    scale; against other data it sits within the walkers' Monte-Carlo
    noise."""
    curve = make_curve_fn(params, scene, seed=seed, dtype=dtype,
                          device=device)
    target = _check_target(target, params, device)
    scale, scales, losses = _adam_fit(
        lambda th: torch.mean((curve(torch.exp(th)) - target) ** 2),
        init_scale, iters, lr, device)
    return MomentFitResult(scale=scale, mmoment=scale * params.mmoment,
                           loss=float(losses[-1]), scale_history=scales,
                           loss_history=losses)


def make_diffusion_curve_fn(params: Params, scene, seed: int = 0,
                            dtype=None, *, device="cuda") -> Callable:
    """Build ``curve(d_scale) -> m[t]``: the magnetization curve as a
    differentiable function of a global diffusion-coefficient scale
    (D_cell and D_extra both scaled), through the scan engine's
    ``d_scale`` launch scalar (both stdevs times its square root).
    Diffusion bends trajectories, so this differentiates every step.

    The chunk-travel bound and the near-k certificate are sized for the
    static params' stdevs: for a D fit, set ``params.D_cell/D_extra`` to
    the top of the search bracket and fit d_scale in (0, 1]."""
    return _scan_curve(params, scene, seed, dtype, device,
                       lambda d, M: (M, {"d_scale": d}))


def fit_diffusion_scale(target, params: Params, scene, *, seed: int = 0,
                        init_scale: float = 1.0, iters: int = 80,
                        lr: float = 0.05, dtype=None,
                        device="cuda") -> MomentFitResult:
    """Recover the diffusion-coefficient scale that produced ``target``
    (ADC recovery): Adam on log(d_scale) through the full simulator by
    autograd.  ``scale`` is the fitted d_scale (``mmoment`` nan)."""
    curve = make_diffusion_curve_fn(params, scene, seed=seed, dtype=dtype,
                                    device=device)
    target = _check_target(target, params, device)
    scale, scales, losses = _adam_fit(
        lambda th: torch.mean((curve(torch.exp(th)) - target) ** 2),
        init_scale, iters, lr, device)
    return MomentFitResult(scale=scale, mmoment=float("nan"),
                           loss=float(losses[-1]), scale_history=scales,
                           loss_history=losses)


def make_engine_curve_fn(params: Params, scene, seed: int = 0,
                         engine: str = "pallas",
                         rng_impl: str = "threefry", dtype=None, *,
                         device="cuda") -> Callable:
    """Build ``curve(d_scale=1.0, *, m_scale=1.0, cell_r=None,
    p_expr=None) -> m[t]`` (NumPy) on the chunk kernels
    (``engine="pallas"``, ``cuda_engine.make_sprint_fn``) or the scan
    engine: a forward run at concrete values.  ``d_scale``, ``cell_r``
    and the reflect pair of ``p_expr`` (µm/ms, ``Params.reflect_pair``;
    needs reflection on in ``params``) are launch scalars, ``m_scale``
    multiplies the moments; the counter generators give every call the
    same draws (common random numbers).

    ``cell_r`` overrides the residency radius on the FIXED scene; the
    caller owns the coverage argument for radii above the params value
    (``fit_cell_radius_crn`` validates its bracket top)."""
    from . import rng
    from .engine import cuda_engine
    from .engine import reference_engine as re
    from .fields.expansion import pack_table

    dtype = dtype or torch.float32
    device = torch.device(device)
    p = params.validate()
    key = rng.key_from_seed(seed)
    mnp_pos, mnp_M = _scene_tensors(scene, device, dtype)
    n_sprints = p.t // p.sprint_steps
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    if engine == "pallas":
        sprint = cuda_engine.make_sprint_fn(p, scene.waters.shape[0],
                                            device, dtype, rng_impl)
        st0 = cuda_engine.to_soa(re.init_state(scene.waters, p, device,
                                               dtype), p)

        def run(mM, st, **kw):
            tbl = cuda_engine.MnpTable(pack_table(mnp_pos, mM),
                                       mnp_pos.shape[0], mnp_pos, mM)
            return sprint(tbl, key, st, 0, **kw)
    elif engine == "scan":
        scan = re.make_sprint_fn(p, device, dtype=dtype)
        st0 = re.init_state(scene.waters, p, device, dtype)

        def run(mM, st, **kw):
            return scan(mnp_pos, mM, key, st, 0, **kw)
    else:
        raise ValueError(f"unknown engine {engine!r}")

    def curve(d_scale: float = 1.0, *, m_scale: float = 1.0,
              cell_r: Optional[float] = None,
              p_expr: Optional[float] = None) -> np.ndarray:
        mM = mnp_M if m_scale == 1.0 else mnp_M * float(np_dt(m_scale))
        cr = None if cell_r is None else float(np_dt(cell_r))
        rf = None if p_expr is None else p.reflect_pair(float(p_expr))
        st, outs = st0, []
        for _ in range(n_sprints):
            st, wins = run(mM, st, cell_r=cr, d_scale=float(d_scale),
                           reflect=rf)
            outs.append(wins[:, 0].cpu().numpy())
        return np.concatenate(outs) / p.num_water

    return curve


def _crn_search(curve_at, target, params: Params, lo: float, hi: float,
                iters: int) -> MomentFitResult:
    """Golden-section search of ``curve_at(x)``'s MSE against ``target``
    over [lo, hi] on log x; every probe in ``*_history``."""
    target = np.asarray(target, np.float64)
    n = params.t // params.pfreq
    if target.shape != (n,):
        raise ValueError(f"target must have one value per output window "
                         f"([{n}]), got {target.shape}")
    hist_x, hist_l = [], []

    def loss(logx):
        x = float(np.exp(logx))
        val = float(np.mean((np.asarray(curve_at(x), np.float64)
                             - target) ** 2))
        hist_x.append(x)
        hist_l.append(val)
        return val

    _golden_log_search(loss, lo, hi, iters)
    best = int(np.argmin(hist_l))
    return MomentFitResult(scale=float(hist_x[best]), mmoment=float("nan"),
                           loss=float(hist_l[best]),
                           scale_history=np.asarray(hist_x),
                           loss_history=np.asarray(hist_l))


def _check_bracket(bracket, name: str = "bracket"):
    lo, hi = float(bracket[0]), float(bracket[1])
    if not (0 < lo < hi):
        raise ValueError(f"{name} must satisfy 0 < lo < hi; got {bracket}")
    return lo, hi


def fit_diffusion_scale_crn(target, params: Params, scene, *,
                            seed: int = 0,
                            bracket: tuple = (0.05, 1.0),
                            iters: int = 20, engine: str = "pallas",
                            rng_impl: str = "threefry", dtype=None,
                            device="cuda") -> MomentFitResult:
    """ADC recovery on the kernels: golden-section search on log(d) for
    the diffusion scale minimizing the curve MSE, each evaluation a
    forward run at the ``d_scale`` launch scalar.  Size
    ``params.D_cell/D_extra`` to the bracket top and keep ``bracket[1]
    <= 1`` so the near-k certificate holds at every probe.  ``scale`` is
    the best probe; ``*_history`` every probe in evaluation order."""
    lo, hi = _check_bracket(bracket)
    curve = make_engine_curve_fn(params, scene, seed=seed, engine=engine,
                                 rng_impl=rng_impl, dtype=dtype,
                                 device=device)
    return _crn_search(lambda d: curve(d), target, params, lo, hi, iters)


def _golden_log_search(loss, lo: float, hi: float, iters: int) -> None:
    """Golden-section minimization of ``loss(log_x)`` over
    ``[log lo, log hi]`` with ``iters`` evaluations in all; the history
    is the ``loss`` closure's."""
    invphi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = np.log(lo), np.log(hi)
    c, d_ = b - invphi * (b - a), a + invphi * (b - a)
    fc, fd = loss(c), loss(d_)
    for _ in range(max(0, iters - 2)):
        if fc < fd:
            b, d_, fd = d_, c, fc
            c = b - invphi * (b - a)
            fc = loss(c)
        else:
            a, c, fc = c, d_, fd
            d_ = a + invphi * (b - a)
            fd = loss(d_)


def fit_cell_radius_crn(target, params: Params, scene, *,
                        seed: int = 0,
                        bracket: tuple = (0.3, 1.0),
                        iters: int = 20, engine: str = "pallas",
                        rng_impl: str = "threefry", dtype=None,
                        device="cuda") -> MomentFitResult:
    """Cell-size recovery on the kernels: golden-section search for the
    cell radius (µm) on a FIXED scene, the radius entering only through
    the cell_r launch scalar.  The near list's reach grows with cell_r,
    so the certificate is checked once at the bracket top; a bracket
    above what the scene's near_k covers raises before any run.
    ``scale`` is the fitted cell_r in µm."""
    from .fields import expansion

    lo, hi = _check_bracket(bracket)
    p_hi = params.replace(cell_r=hi).validate()
    worst = expansion.validate_near_k(scene.mnps[:, :3], p_hi)
    if worst > params.near_k:
        raise ValueError(
            f"bracket top cell_r={hi} needs near_k >= {worst} on this "
            f"scene (configured {params.near_k}); raise near_k or lower "
            f"the bracket")
    curve = make_engine_curve_fn(params, scene, seed=seed, engine=engine,
                                 rng_impl=rng_impl, dtype=dtype,
                                 device=device)
    return _crn_search(lambda r: curve(cell_r=r), target, params, lo, hi,
                       iters)


def fit_permeability_crn(target, params: Params, scene, *,
                         seed: int = 0,
                         bracket: tuple = (0.1, 100.0),
                         iters: int = 20, engine: str = "pallas",
                         rng_impl: str = "threefry", dtype=None,
                         device="cuda") -> MomentFitResult:
    """Membrane-permeability recovery on the kernels: golden-section
    search on log(P) (µm/ms), each probe mapped to (reflect_io,
    reflect_oi) by ``Params.reflect_pair`` and fed as the reflect launch
    scalars.  The bracket top is checked against the formulas' bound
    first; reflection is turned on in ``params`` when it is off.
    ``scale`` is the fitted P."""
    lo, hi = _check_bracket(bracket)
    params.reflect_pair(hi)     # raises past the formula's validity bound
    if not (params.reflect_io > 0 or params.reflect_oi > 0):
        params = params.with_permeability()
    curve = make_engine_curve_fn(params, scene, seed=seed, engine=engine,
                                 rng_impl=rng_impl, dtype=dtype,
                                 device=device)
    return _crn_search(lambda pv: curve(p_expr=pv), target, params, lo, hi,
                       iters)


class JointFitResult(NamedTuple):
    m_scale: float          #: fitted moment scale (relative to params.mmoment)
    d_scale: float          #: fitted diffusion-coefficient scale
    mmoment: float          #: fitted absolute moment, m_scale * mmoment
    loss: float             #: best mean-squared curve error
    m_history: np.ndarray   #: [n_evals] probed moment scales
    d_history: np.ndarray   #: [n_evals] probed diffusion scales
    loss_history: np.ndarray  #: [n_evals] loss per evaluation


def _nelder_mead(loss, x0: np.ndarray, step: np.ndarray,
                 max_evals: int, xtol: float = 1e-4) -> None:
    """Deterministic Nelder-Mead on ``loss(x)`` (x: [n]): the standard
    reflect / expand / contract / shrink coefficients; stops after
    ``max_evals`` evaluations or at a simplex diameter below ``xtol``.
    History, best point and bounds (+inf outside) are the ``loss``
    closure's."""
    n = x0.size
    evals = [0]

    def f(x):
        evals[0] += 1
        return loss(x)

    simplex = [np.asarray(x0, np.float64)]
    for i in range(n):
        v = np.asarray(x0, np.float64).copy()
        v[i] += step[i]
        simplex.append(v)
    vals = [f(v) for v in simplex]
    while evals[0] < max_evals:
        order = np.argsort(vals)
        simplex = [simplex[i] for i in order]
        vals = [vals[i] for i in order]
        if max(np.max(np.abs(v - simplex[0])) for v in simplex[1:]) < xtol:
            break
        centroid = np.mean(simplex[:-1], axis=0)
        xr = centroid + (centroid - simplex[-1])        # reflection
        fr = f(xr)
        if fr < vals[0]:
            xe = centroid + 2.0 * (centroid - simplex[-1])  # expansion
            fe = f(xe)
            simplex[-1], vals[-1] = (xe, fe) if fe < fr else (xr, fr)
        elif fr < vals[-2]:
            simplex[-1], vals[-1] = xr, fr
        else:
            xc = centroid + 0.5 * (simplex[-1] - centroid)  # contraction
            fc = f(xc)
            if fc < vals[-1]:
                simplex[-1], vals[-1] = xc, fc
            else:                                       # shrink toward best
                for i in range(1, n + 1):
                    simplex[i] = simplex[0] + 0.5 * (simplex[i] - simplex[0])
                    vals[i] = f(simplex[i])


def fit_joint_crn(target, params: Params, scene, *, seed: int = 0,
                  m_bracket: tuple = (0.25, 4.0),
                  d_bracket: tuple = (0.05, 1.0),
                  max_evals: int = 80, engine: str = "pallas",
                  rng_impl: str = "threefry", dtype=None,
                  device="cuda") -> JointFitResult:
    """Joint recovery of (moment scale, diffusion scale) from one decay:
    Nelder-Mead on (log s, log d), each evaluation a forward run with
    the moment in the table and the diffusion scale as the d_scale
    launch scalar (common random numbers: the 2D loss is deterministic
    and, against a same-seed target, least at the truth).  Probes
    outside the brackets cost +inf and are never run."""
    m_lo, m_hi = _check_bracket(m_bracket, "m_bracket")
    d_lo, d_hi = _check_bracket(d_bracket, "d_bracket")
    curve = make_engine_curve_fn(params, scene, seed=seed, engine=engine,
                                 rng_impl=rng_impl, dtype=dtype,
                                 device=device)
    target = np.asarray(target, np.float64)
    n = params.t // params.pfreq
    if target.shape != (n,):
        raise ValueError(f"target must have one value per output window "
                         f"([{n}]), got {target.shape}")

    hist_m, hist_d, hist_l = [], [], []

    def loss(x):
        s, d = float(np.exp(x[0])), float(np.exp(x[1]))
        if not (m_lo <= s <= m_hi and d_lo <= d <= d_hi):
            return float("inf")
        val = float(np.mean(
            (np.asarray(curve(d, m_scale=s), np.float64) - target) ** 2))
        hist_m.append(s)
        hist_d.append(d)
        hist_l.append(val)
        return val

    x0 = np.array([np.log(m_lo * m_hi) / 2.0, np.log(d_lo * d_hi) / 2.0])
    step = np.array([np.log(m_hi / m_lo) / 4.0, np.log(d_hi / d_lo) / 4.0])
    _nelder_mead(loss, x0, step, max_evals)
    if not hist_l:
        raise RuntimeError("no in-bracket evaluation happened; check the "
                           "brackets")
    best = int(np.argmin(hist_l))
    return JointFitResult(
        m_scale=float(hist_m[best]), d_scale=float(hist_d[best]),
        mmoment=float(hist_m[best]) * params.mmoment,
        loss=float(hist_l[best]), m_history=np.asarray(hist_m),
        d_history=np.asarray(hist_d), loss_history=np.asarray(hist_l))


def fit_moment_scale_decomposed(target, A, B, *, mmoment: float = None,
                                init_scale: float = 1.0, iters: int = 200,
                                lr: float = 0.1,
                                device="cuda") -> MomentFitResult:
    """Recover the moment scale from a phase-decomposition record
    (``engine/decompose.run_decomposition``): Adam on log(s) of
    ``mean((mean_i cos(s A + B) - target)^2)``, one elementwise pass
    over (A, B) on ``device`` an iteration, no simulator in the loop.
    ``mmoment`` (the record's base moment) fills the absolute moment
    (nan if omitted)."""
    A = torch.as_tensor(np.array(A, np.float32), device=device)
    B = torch.as_tensor(np.array(B, np.float32), device=device)
    target = torch.as_tensor(np.array(target, np.float32), device=device)
    if tuple(target.shape) != (A.shape[0],):
        raise ValueError(f"target must have one value per window "
                         f"([{A.shape[0]}]), got {tuple(target.shape)}")
    if not init_scale > 0:
        raise ValueError("init_scale must be > 0")

    def loss_fn(theta):
        rec = torch.mean(torch.cos(torch.exp(theta) * A + B), -1)
        return torch.mean((rec - target) ** 2)

    scale, scales, losses = _adam_fit(loss_fn, init_scale, iters, lr,
                                      device)
    return MomentFitResult(
        scale=scale,
        mmoment=scale * mmoment if mmoment is not None else float("nan"),
        loss=float(losses[-1]), scale_history=scales, loss_history=losses)


def fit_from_record(record_path: str, target_csv: str, *,
                    init_scale: float = 1.0, iters: int = 200,
                    lr: float = 0.1, device="cuda") -> MomentFitResult:
    """Moment recovery from saved artifacts: a decomposition record (a
    ``--dump-record`` .npz or a ``--record-dir`` store) and an observed
    decay in the T2 CSV schema, its sum_cos column normalized by the
    record's walker count.  The CSV must cover the record's windows
    (extra rows are ignored) on the record's time grid."""
    from .engine.decompose import open_record
    from .io.writer import read_t2_csv

    A, B, meta = open_record(record_path)
    times = meta["times_ms"]
    mmoment = meta["mmoment"]
    cols = read_t2_csv(target_csv)
    n, w = A.shape
    if len(cols[0]) < n:
        raise ValueError(
            f"target has {len(cols[0])} rows but the record holds {n} "
            f"windows; the measured curve must cover the record")
    if times is not None and not np.allclose(cols[0][:n], times,
                                             rtol=1e-9, atol=1e-9):
        raise ValueError(
            f"target time axis does not match the record's windows "
            f"(target starts {cols[0][:3]}, record {times[:3]} ms); "
            f"resample the measurement onto the record's output grid")
    target = np.asarray(cols[1][:n], np.float64) / w
    if np.max(np.abs(target)) > 1.0 + 1e-3:
        raise ValueError(
            f"normalized target reaches {np.max(np.abs(target)):.3g} "
            f"(> 1): the CSV's sums were not produced by the record's "
            f"{w} walkers — check the measurement's walker count")
    return fit_moment_scale_decomposed(
        target, A, B, mmoment=mmoment, init_scale=init_scale,
        iters=iters, lr=lr, device=device)


def build_parser() -> argparse.ArgumentParser:
    """The flags of the reference's ``mri-t2-invert``, and ``--device``."""
    ap = argparse.ArgumentParser(
        description="Recover the nanoparticle moment from a decay curve "
                    "by differentiating through the simulator")
    ap.add_argument("--true-scale", type=float, default=1.4,
                    help="hidden moment scale that generates the target")
    ap.add_argument("--init-scale", type=float, default=1.0)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--num-water", type=int, default=256)
    ap.add_argument("--scene-seed", type=int, default=1)
    ap.add_argument("--seed", type=int, default=2,
                    help="simulation RNG seed (shared by target and fit)")
    ap.add_argument("--method", choices=["ad", "decompose", "crn"],
                    default="ad",
                    help="'ad': reverse-mode AD through the simulator "
                         "(general); 'decompose': one forward "
                         "phase-decomposition run + closed-form fit "
                         "(exact for the moment axis, production-fast); "
                         "'crn': derivative-free golden-section with "
                         "common random numbers on the production "
                         "chunk kernels (the production path for the "
                         "D axis)")
    ap.add_argument("--axis", choices=["moment", "D", "cell_r", "joint"],
                    default="moment",
                    help="which physical parameter to recover: the "
                         "nanoparticle moment (default), the global "
                         "diffusion-coefficient scale (ADC), the cell "
                         "radius (um, CRN bracket search on a fixed "
                         "scene), or 'joint' — moment AND diffusion "
                         "scale together by CRN Nelder-Mead (the "
                         "measured-data problem; --true-scale sets the "
                         "hidden moment scale, the hidden d_scale is "
                         "fixed at 0.6)")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="fit against a SAVED decomposition record "
                         "(the simulator's --dump-record .npz or "
                         "--record-dir store directory): closed-form "
                         "moment recovery from real data — pass the "
                         "measured curve via --target")
    ap.add_argument("--target", default=None, metavar="CSV",
                    help="with --record: the observed decay curve "
                         "(reference CSV schema time_ms,sum_cos; "
                         "normalized by the record's walker count)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails without a card.  On "
                         "the card --method crn runs the chunk kernels, "
                         "on the CPU the scan engine, as the reference "
                         "runs its Pallas kernel on a TPU only")
    return ap


def main(argv=None) -> int:
    """The ``mri-t2-invert`` demo: simulate a target curve at a hidden
    scale, then recover it.  Exit code 0 when the recovered scale is
    within 5% of the hidden one."""
    from .params import small_test_params
    from .scene import BacteriaBox
    from .utils.device import require_cuda

    ap = build_parser()
    args = ap.parse_args(argv)
    if (args.record is None) != (args.target is None):
        ap.error("--record and --target go together (record = the "
                 "simulation basis, target = the measured curve)")
    device = torch.device(args.device)
    if device.type == "cuda":
        require_cuda()
    if args.record:
        if args.axis != "moment" or args.method == "crn":
            ap.error("--record is the moment axis's closed-form basis "
                     "(phase = s*A + B); D fits need fresh simulation")
        if not args.init_scale > 0:
            ap.error("scales must be > 0")
        fit = fit_from_record(args.record, args.target,
                              init_scale=args.init_scale,
                              iters=args.iters, lr=args.lr, device=device)
        print(f"recovered moment scale = {fit.scale:.5f} "
              f"(absolute moment {fit.mmoment:.4e}), "
              f"loss {fit.loss:.3e}")
        return 0
    if not args.true_scale > 0 or not args.init_scale > 0:
        ap.error("scales must be > 0")
    if args.axis == "D":
        if args.method == "decompose":
            ap.error("no decomposition shortcut exists for the D axis "
                     "(diffusion BENDS trajectories); use 'ad' or 'crn'")
        if not args.true_scale <= 1.0:
            ap.error("--axis D fits within the certified bracket "
                     "(0, 1]: size the params' D to the bracket top "
                     "(see inverse.make_diffusion_curve_fn)")
    elif args.axis in ("cell_r", "joint"):
        if args.method != "crn":
            ap.error(f"--axis {args.axis} is a CRN bracket search "
                     f"(cell_r enters through booleans — not usefully "
                     f"differentiable; joint fits are 2D); use "
                     f"--method crn")
        if args.axis == "cell_r" and not 0.3 <= args.true_scale <= 1.0:
            ap.error("--axis cell_r demo searches radii in "
                     "[0.3, 1.0] um; pick --true-scale inside it")
    elif args.method == "crn":
        ap.error("'crn' searches the launch scalars; use it with "
                 "--axis D, cell_r or joint (the moment axis has the "
                 "exact 'decompose' shortcut instead)")

    # ~20x the tiny-test moment: deep intra-window dephasing gives the
    # fit a strong signal (at 3.5e-15 the curve barely decays)
    p = small_test_params(num_water=args.num_water,
                          mmoment=2e-14 if args.axis == "moment" else 5e-14)
    sc = BacteriaBox(p, seed=args.scene_seed).populate()
    if args.method == "crn":
        # the chunk kernels on the card, the scan engine on the CPU (the
        # reference: its Pallas kernel on a TPU, its scan engine
        # elsewhere).  The target comes from the SAME engine as the fit:
        # the engines fold sqrt(d_scale) in different multiply orders,
        # and a cross-engine target would put a trajectory-divergence
        # floor under the CRN loss, whose premise is zero at the truth.
        eng = "pallas" if device.type == "cuda" else "scan"
        if args.axis == "cell_r":
            # size the static near list for the bracket top so the
            # coverage certificate holds at every probed radius
            from .fields import expansion
            worst = expansion.validate_near_k(
                sc.mnps[:, :3], p.replace(cell_r=1.0))
            if worst > p.near_k:
                p = p.replace(near_k=worst)
        curve = make_engine_curve_fn(p, sc, seed=args.seed, engine=eng,
                                     device=device)
    elif args.axis == "D":
        curve = make_diffusion_curve_fn(p, sc, seed=args.seed,
                                        device=device)
    else:
        curve = make_curve_fn(p, sc, seed=args.seed, device=device)
    hidden_d = 0.6          # the joint demo's second hidden parameter
    with torch.no_grad():
        if args.axis == "joint":
            target = np.asarray(curve(hidden_d, m_scale=args.true_scale))
        elif args.axis == "cell_r":
            target = np.asarray(curve(cell_r=args.true_scale))
        elif args.method == "crn":
            target = np.asarray(curve(args.true_scale))
        else:
            target = curve(args.true_scale).cpu().numpy()
    print(f"target: {len(target)} windows, final m = {target[-1]:.4f} "
          f"(hidden {args.axis} scale {args.true_scale})")
    if args.method == "decompose":
        from .engine.decompose import run_decomposition
        rec = run_decomposition(sc, p, seed=args.seed, engine="scan",
                                device=device)
        fit = fit_moment_scale_decomposed(
            target, rec.A, rec.B, mmoment=p.mmoment,
            init_scale=args.init_scale, iters=args.iters, lr=args.lr,
            device=device)
    elif args.method == "crn" and args.axis == "joint":
        jfit = fit_joint_crn(target, p, sc, seed=args.seed,
                             max_evals=args.iters, engine=eng,
                             device=device)
        err = max(abs(jfit.m_scale - args.true_scale) / args.true_scale,
                  abs(jfit.d_scale - hidden_d) / hidden_d)
        print(f"recovered (moment, D) scales = ({jfit.m_scale:.5f}, "
              f"{jfit.d_scale:.5f}) (true ({args.true_scale}, "
              f"{hidden_d}), worst rel err {err:.2e}), "
              f"loss {jfit.loss:.3e} after {len(jfit.loss_history)} "
              f"evaluations")
        return 0 if err < 0.05 else 1
    elif args.method == "crn" and args.axis == "cell_r":
        fit = fit_cell_radius_crn(target, p, sc, seed=args.seed,
                                  bracket=(0.3, 1.0), iters=args.iters,
                                  engine=eng, device=device)
    elif args.method == "crn":
        # the bracket straddles the hidden truth: lo never above half of
        # it (a truth below a fixed lo would converge to the bracket
        # edge), hi at the certified 1.0
        lo = min(max(0.05, args.true_scale / 5), args.true_scale / 2)
        fit = fit_diffusion_scale_crn(
            target, p, sc, seed=args.seed, bracket=(lo, 1.0),
            iters=args.iters, engine=eng, device=device)
    elif args.axis == "D":
        fit = fit_diffusion_scale(target, p, sc, seed=args.seed,
                                  init_scale=args.init_scale,
                                  iters=args.iters, lr=args.lr,
                                  device=device)
    else:
        fit = fit_moment_scale(target, p, sc, seed=args.seed,
                               init_scale=args.init_scale, iters=args.iters,
                               lr=args.lr, device=device)
    err = abs(fit.scale - args.true_scale) / args.true_scale
    print(f"recovered scale = {fit.scale:.5f} "
          f"(true {args.true_scale}, rel err {err:.2e}), "
          f"loss {fit.loss:.3e} after {args.iters} {args.method} iterations")
    return 0 if err < 0.05 else 1


if __name__ == "__main__":
    sys.exit(main())

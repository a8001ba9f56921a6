"""The golden scene of the reference's own geometry dumps.

``golden/testdata/scene_<seed>/`` holds a scene that the reference's
compiled C++ built and dumped (cells, dipoles with their periodic
images, the Morton-sorted initial waters), and ``paired_<seed>.csv`` the
reference oracle's T2 curve on it.  The constants and the two functions
here are those of the repository's ``scripts/golden_paired.py``
(``framework_params`` and ``load_scene``) on this package's ``Params``,
``Scene`` and ``build_lookup_table``: production scale (4032 walkers, 2e6
steps of 1 ns) with the moment x60 and tcp 250k, so the curve reaches
the deep-decay regime through 8 Carr-Purcell flips.

The gates below are those of the repository's
``tests/test_golden_full.py`` (its constants, copied; a CPU test holds
the copies equal to it): ``gate_readings`` reads one seed's curve
against its oracles, ``gate_failures`` applies every limit, per seed and
across seeds.  ``run_seed`` runs the port on a seed's scene.

The T2 arms are those of the repository's ``scripts/golden_t2.py``
(its constants and Params, copied as ``T2_*`` and ``t2_arm_params``): an
ensemble of 1024-walker trials of 5e5 steps, moment x20, against the
reference oracle's ensemble in ``GOLDEN_T2.json`` (d_scale 1),
``GOLDEN_T2_D.json`` (d_scale 0.5) and ``GOLDEN_T2_r0.8.json`` (run
cell_r 0.8).  ``run_t2_arm`` runs the port's arm, ``t2_arm_gate``
reads it against the oracle's final mean and standard error.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from . import params as P
from .scene import Scene, build_lookup_table

N_WATER = 4032
STEPS = 2_000_000
PFREQ = 1000
TCP = 250_000
MSCALE = 60.0
#: the run seed of the first framework trial (trial k runs FW_RUN0 + k)
FW_RUN0 = 8100

#: the scene seeds of the committed oracle curves
SEEDS = (6000, 6001)
#: the limits of tests/test_golden_full.py (its reasons there): the
#: per-seed RMS of oracle - port and |final difference|; the mean
#: difference over the first EARLY_WINDOW windows (before the first
#: echo) and the last LATE_WINDOW windows, per seed and across seeds;
#: against the tightened-octree oracle (seed 6000) the RMS and |late
#: mean|; and both finals below DEPTH_GATE (the deep decay is reached)
RMS_GATE = 0.025
FINAL_GATE = 0.060
EARLY_WINDOW = 250
LATE_WINDOW = 500
EARLY_ABS_GATE = 0.020
LATE_RANGE = (-0.055, +0.010)
LATE_MEAN_RANGE = (-0.040, 0.000)
TIGHT_RMS_GATE = 0.015
TIGHT_LATE_ABS_GATE = 0.014
DEPTH_GATE = 0.45


def framework_params(steps: int = STEPS, tcp: int = TCP,
                     kick: str = "aswritten", gradient: float = 0.0,
                     reflect=None) -> P.Params:
    """The golden run's Params: every reference default but 4032 waters,
    ``steps`` steps in 500k-step sprints of 4000-step chunks, 1000-step
    windows, a Carr-Purcell flip every ``tcp`` steps and K = 10.  ``kick``
    "aswritten" or "intended" (the intended arm also draws sphere
    directions), ``gradient`` a z gradient in T/µm, ``reflect`` a
    (reflect_io, reflect_oi) pair or None."""
    kick_mode = {"aswritten": P.KICK_AS_WRITTEN,
                 "intended": P.KICK_INTENDED}[kick]
    direction = {"aswritten": P.DIRECTION_CUBE,
                 "intended": P.DIRECTION_SPHERE}[kick]
    return P.DEFAULT.replace(
        num_water=N_WATER,
        totaltime=steps * P.DEFAULT.tau,
        sprint_steps=min(steps, 500_000),
        chunk_steps=4000,
        print_interval=PFREQ * P.DEFAULT.tau,
        taucp=tcp * P.DEFAULT.tau,
        near_k=10,
        kick_mode=kick_mode,
        direction_mode=direction,
        b0_gradient=(0.0, 0.0, float(gradient or 0.0)),
        reflect_io=reflect[0] if reflect else 0.0,
        reflect_oi=reflect[1] if reflect else 0.0,
    ).validate()


def load_scene(d: str, p: P.Params) -> Scene:
    """The Scene of the reference's dumped geometry in directory ``d``
    (``scene_mnps.csv``, ``scene_cells.csv``, ``scene_waters.csv``).  The
    lookup table is rebuilt with this package's builder: candidate
    semantics stay the package's, geometry stays the reference's."""
    mnps = np.loadtxt(os.path.join(d, "scene_mnps.csv"),
                      delimiter=",", skiprows=1)
    cells = np.loadtxt(os.path.join(d, "scene_cells.csv"),
                       delimiter=",", skiprows=1)
    waters = np.loadtxt(os.path.join(d, "scene_waters.csv"),
                        delimiter=",", skiprows=1)
    if waters.shape != (p.num_water, 3) or cells.shape != (p.num_cells, 3):
        raise ValueError(f"scene dump {d} holds {waters.shape} waters and "
                         f"{cells.shape} cells; params want "
                         f"({p.num_water}, 3) and ({p.num_cells}, 3)")
    lookup = build_lookup_table(cells, p)
    return Scene(params=p, cells=cells, mnps=mnps, waters=waters,
                 lookup_table=lookup, num_intra_mnps=p.num_cells)


def oracle_curve(testdata: str, seed: int, tight: bool = False):
    """Σcos/W of the reference oracle on scene ``seed`` (``tight``: the
    tightened-octree oracle, None where it is not committed)."""
    name = f"paired_tight2.5e-7_{seed}.csv" if tight else f"paired_{seed}.csv"
    path = os.path.join(testdata, name)
    if tight and not os.path.exists(path):
        return None
    return np.loadtxt(path, delimiter=",")[:, 1] / N_WATER


def scale_moments(scene: Scene, s: float) -> Scene:
    """``scene`` with every dipole moment multiplied by ``s``."""
    mnps = scene.mnps.copy()
    mnps[:, 4] *= s
    return dataclasses.replace(scene, mnps=mnps)


def run_seed(testdata: str, seed: int, device):
    """Σcos/W per window and the run's stats of the port on scene
    ``seed`` at production width (``framework_params``, the moments
    x MSCALE) on Threefry, one rep keyed FW_RUN0, as
    tests/test_golden_full.py runs the JAX engine."""
    from .engine.sim import SimulationRunner
    p = framework_params()
    scene = load_scene(os.path.join(testdata, f"scene_{seed}"), p)
    runner = SimulationRunner(p, seed=FW_RUN0, device=device,
                              scene=scale_moments(scene, MSCALE),
                              rng_impl="threefry")
    _, cos, _, stats = runner.run(progress=False, max_steps=STEPS)
    return cos / N_WATER, stats


def gate_readings(oracle, ours, tight=None) -> dict:
    """What the gates read of one seed: the windows compared, the RMS,
    final, early and late differences oracle - ``ours``, both finals,
    and against the ``tight`` oracle (if given) its RMS and late mean."""
    n = min(len(oracle), len(ours))
    diff = oracle[:n] - ours[:n]
    r = dict(n=n, rms=float(np.sqrt(np.mean(diff ** 2))),
             final=float(diff[-1]),
             early=float(diff[:EARLY_WINDOW].mean()),
             late=float(diff[-LATE_WINDOW:].mean()),
             oracle_final=float(oracle[n - 1]), ours_final=float(ours[n - 1]))
    if tight is not None:
        td = tight[:n] - ours[:n]
        r.update(tight_rms=float(np.sqrt(np.mean(td ** 2))),
                 tight_late=float(td[-LATE_WINDOW:].mean()))
    return r


def gate_failures(readings: dict) -> list:
    """Every limit of tests/test_golden_full.py that ``readings`` ({scene
    seed: ``gate_readings``}) break, as text: per seed the window count,
    the depth, RMS, final, early and late gates and the tight ones; with
    more than one seed the cross-seed final and late means."""
    out = []
    for seed, r in readings.items():
        checks = [
            (r["n"] == STEPS // PFREQ, f"{r['n']} windows"),
            (r["oracle_final"] < DEPTH_GATE and r["ours_final"] < DEPTH_GATE,
             f"finals {r['oracle_final']:.4f} / {r['ours_final']:.4f} not "
             f"below {DEPTH_GATE}"),
            (r["rms"] < RMS_GATE, f"rms {r['rms']:.5f}"),
            (abs(r["final"]) < FINAL_GATE, f"final diff {r['final']:+.5f}"),
            (abs(r["early"]) < EARLY_ABS_GATE, f"early {r['early']:+.5f}"),
            (LATE_RANGE[0] < r["late"] < LATE_RANGE[1],
             f"late {r['late']:+.5f}")]
        if "tight_rms" in r:
            checks += [
                (r["tight_rms"] < TIGHT_RMS_GATE,
                 f"tight rms {r['tight_rms']:.5f}"),
                (abs(r["tight_late"]) < TIGHT_LATE_ABS_GATE,
                 f"tight late {r['tight_late']:+.5f}")]
        out += [f"seed {seed}: {what}" for ok, what in checks if not ok]
    if len(readings) > 1:
        final_mean, late_mean = cross_seed(readings)
        if not abs(final_mean) < FINAL_GATE:
            out.append(f"cross-seed final mean {final_mean:+.5f}")
        if not LATE_MEAN_RANGE[0] < late_mean < LATE_MEAN_RANGE[1]:
            out.append(f"cross-seed late mean {late_mean:+.5f}")
    return out


def cross_seed(readings: dict) -> tuple:
    """The means over seeds of the final and the late-window
    differences of ``readings`` ({scene seed: ``gate_readings``})."""
    return (float(np.mean([r["final"] for r in readings.values()])),
            float(np.mean([r["late"] for r in readings.values()])))


#: the T2 arms' configuration (scripts/golden_t2.py:55-59): walkers,
#: steps, steps a window, steps between Carr-Purcell flips, moment scale
T2_N_WATER = 1024
T2_STEPS = 500_000
T2_PFREQ = 1000
T2_TCP = 125_000
T2_MSCALE = 20.0
#: the scene seed of trial 0 (trial k builds T2_BASE_SEED + k) and the
#: run seed of trial 0 (trial k runs T2_RUN_SEED + k)
T2_BASE_SEED = 7000
T2_RUN_SEED = 8000
#: the gate on the final window: |oracle - port| within this many
#: standard errors of the difference
T2_Z_GATE = 3.0


def t2_arm_params() -> P.Params:
    """The T2 arms' Params (scripts/golden_t2.py:125-138 without
    reflection): 1024 waters, 5e5 steps in one sprint of 4000-step
    chunks, 1000-step windows, a flip every 125000 steps, the moment
    x20, K = 10."""
    return P.DEFAULT.replace(
        num_water=T2_N_WATER,
        totaltime=T2_STEPS * P.DEFAULT.tau,
        sprint_steps=T2_STEPS,
        chunk_steps=4000,
        print_interval=T2_PFREQ * P.DEFAULT.tau,
        taucp=T2_TCP * P.DEFAULT.tau,
        mmoment=P.DEFAULT.mmoment * T2_MSCALE,
        near_k=10,
        reflect_io=0.0,
        reflect_oi=0.0,
    ).validate()


def run_t2_arm(n_trials: int, d_scale: float, cell_r: float, device,
               rng_impl: str):
    """Σcos/W [n_trials, n_windows] of the port's T2 arm: an ensemble
    of ``n_trials`` trials of ``t2_arm_params`` (scene seeds 7000 + k,
    run seeds 8000 + k) with every trial's ``d_scale`` (1 = none) and
    run cell_r (0 = the params' radius on fixed geometry), as
    scripts/golden_t2.py:139-146 runs the JAX ensemble."""
    from .parallel import ensemble
    _, cos, _, _ = ensemble.run_ensemble(
        t2_arm_params(), n_trials=n_trials, base_seed=T2_BASE_SEED,
        run_seed=T2_RUN_SEED, engine="pallas", rng_impl=rng_impl,
        d_scales=None if d_scale == 1.0 else [d_scale] * n_trials,
        run_cell_rs=None if not cell_r else [cell_r] * n_trials,
        device=device)
    return np.asarray(cos) / T2_N_WATER


def t2_arm_gate(path: str, curves) -> dict:
    """The final window of the port's arm ``curves`` (Σcos/W, [trials,
    windows]) against the oracle's in the report at ``path``: the
    port's mean and standard error (std with ddof 1 over sqrt(trials),
    scripts/golden_t2.py:218-219), the oracle's, the committed JAX arm's
    mean, and z_final = (oracle - port) / sqrt(se_o^2 + se_p^2)."""
    with open(path) as f:
        rep = json.load(f)
    curves = np.asarray(curves, np.float64)
    mean = float(curves[:, -1].mean())
    se = float(curves[:, -1].std(ddof=1) / np.sqrt(len(curves)))
    mo, so = rep["oracle_final_mean"], rep["oracle_final_stderr"]
    return dict(mean=mean, stderr=se, oracle_mean=mo, oracle_stderr=so,
                jax_mean=rep["framework_final_mean"],
                z_final=(mo - mean) / float(np.sqrt(so ** 2 + se ** 2)))

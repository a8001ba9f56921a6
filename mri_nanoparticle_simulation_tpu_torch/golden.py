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
"""

from __future__ import annotations

import dataclasses
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

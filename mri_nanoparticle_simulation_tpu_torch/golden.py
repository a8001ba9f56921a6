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
"""

from __future__ import annotations

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

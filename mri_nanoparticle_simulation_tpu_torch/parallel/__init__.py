"""Ensembles and parameter sweeps on one device (``ensemble.py``).  The
reference's walker sharding and multi-host runs (``sharding.py``,
``distributed.py``) are not ported yet: ROADMAP Queue 1 item 11."""

from .ensemble import (SCALAR_AXES, build_trial_scenes, run_ensemble,
                       run_parameter_grid, run_parameter_sweep)

__all__ = [
    "SCALAR_AXES", "build_trial_scenes", "run_ensemble",
    "run_parameter_grid", "run_parameter_sweep",
]

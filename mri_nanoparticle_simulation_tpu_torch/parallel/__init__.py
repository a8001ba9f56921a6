"""Ensembles and parameter sweeps (``ensemble.py``), walker sharding
(``sharding.py``) and runs over several processes
(``distributed.py``)."""

from .ensemble import (SCALAR_AXES, build_trial_scenes, run_ensemble,
                       run_parameter_grid, run_parameter_sweep)
from .sharding import (WALKER_AXIS, make_sharded_sprint_fn, make_walker_mesh,
                       run_simulation_sharded)

__all__ = [
    "SCALAR_AXES", "build_trial_scenes", "run_ensemble",
    "run_parameter_grid", "run_parameter_sweep",
    "WALKER_AXIS", "make_sharded_sprint_fn", "make_walker_mesh",
    "run_simulation_sharded",
]

"""Scene construction: cells, dipoles with their periodic images, the
initial waters and the nearest-cell lookup table.

The port's own copy of the reference's host-only scene modules
(``box``, ``images``, ``lookup``, ``morton``, ``native``, ``nprng``),
carried over unchanged apart from their imports: the same seed builds
the bitwise-same scene on the NumPy and the native (g++) path.  ``io``
adds user geometries (``CustomBox``, ``load_cells_csv``) and the scene
archive (``save_scene`` / ``load_scene``), in the reference's format.
"""

from .box import (BacteriaBox, ClusteredBacteriaBox, FCCLatticeBox, Scene,
                  SimulationBox)
from .images import apply_bcs_on_mnps
from .io import CustomBox, load_cells_csv, load_scene, save_scene
from .lookup import build_lookup_table, nearest_cell
from .morton import morton_argsort, morton_code_positions, morton_encode
from .nprng import CounterRNG, threefry2x32_np

__all__ = [
    "BacteriaBox", "ClusteredBacteriaBox", "FCCLatticeBox", "Scene",
    "SimulationBox", "apply_bcs_on_mnps",
    "CustomBox", "load_cells_csv", "load_scene", "save_scene",
    "build_lookup_table",
    "nearest_cell", "morton_argsort", "morton_code_positions",
    "morton_encode", "CounterRNG", "threefry2x32_np",
]

"""Scene I/O: user-provided geometries and exact scene round trips.

The port's copy of the reference package's ``scene/io.py``, carried over
as it is (host NumPy): the same archive keys and encoding, so a scene
that either package saves loads in the other, bitwise.

* :class:`CustomBox` builds a full scene (dipoles, periodic images,
  lookup table, thrown waters) around caller-supplied cell centres: the
  scene pipeline of BacteriaBox (SimulationBox.cpp:77-97) with
  ``init_cells`` replaced by your array;
* :func:`save_scene` / :func:`load_scene` round-trip a populated Scene
  through one ``.npz`` (bitwise: every array is stored verbatim), so a
  scene can be archived, shared, or re-simulated exactly;
* :func:`load_cells_csv` reads plain ``x,y,z`` rows (µm), the
  interchange format for cell centres from segmentation or microscopy
  pipelines.
"""

from __future__ import annotations

import numpy as np

from ..params import Params
from .box import BacteriaBox, Scene


class CustomBox(BacteriaBox):
    """BacteriaBox with caller-supplied cell centers.

    ``cells`` is [n, 3] in µm; every center must keep the whole sphere
    inside the box ([cell_r, bound - cell_r] per axis, the same domain
    BacteriaBox throws into, BacteriaBox.cpp:53-60).  Overlapping cells
    are allowed (a measured geometry may contain touching cells — the
    physics is well-defined; the reference's non-overlap constraint is
    a property of its generator, not of the simulation).

    The params' ``num_cells`` must match ``len(cells)`` so the scene is
    self-consistent (CLI callers: ``params.replace(num_cells=len(cells))``).
    """

    def __init__(self, params: Params, cells, seed: int = 0,
                 prefer_native: bool = True):
        super().__init__(params, seed=seed, prefer_native=prefer_native)
        cells = np.asarray(cells, np.float64)
        if cells.ndim != 2 or cells.shape[1] != 3:
            raise ValueError(f"cells must be [n, 3] centers in µm; got "
                             f"shape {cells.shape}")
        if len(cells) != params.num_cells:
            raise ValueError(
                f"params.num_cells ({params.num_cells}) must equal the "
                f"provided cell count ({len(cells)}); use "
                f"params.replace(num_cells=...)")
        if not np.isfinite(cells).all():
            bad = np.argwhere(~np.isfinite(cells).all(axis=1))[0][0]
            raise ValueError(f"cell {bad} has a non-finite coordinate")
        lo, hi = params.cell_r, params.bound - params.cell_r
        if np.any(cells < lo) or np.any(cells > hi):
            raise ValueError(
                f"every cell center must lie in [{lo:g}, {hi:g}] µm per "
                f"axis (sphere fully inside the box)")
        self._custom_cells = cells

    #: bound on rejection throws per water — generator families
    #: guarantee free space by construction; a measured geometry does
    #: not, and an unbounded loop would hang instead of diagnosing
    MAX_THROWS = 100_000

    def init_cells(self) -> np.ndarray:
        return self._custom_cells.copy()

    def init_waters(self, cells: np.ndarray) -> np.ndarray:
        p = self.params
        if not p.avoid_intracellular_throw:
            return super().init_waters(cells)
        from .box import _STREAM_WATERS
        from .nprng import CounterRNG
        gen = CounterRNG(self.seed, _STREAM_WATERS)
        offset = (p.bound - p.water_start_bound) / 2.0
        waters = np.empty((p.num_water, 3))
        r2 = p.cell_r ** 2
        for i in range(p.num_water):
            for _ in range(self.MAX_THROWS):
                xyz = offset + gen.uniform3() * p.water_start_bound
                d2 = np.sum((cells - xyz) ** 2, axis=1)
                if d2.min() >= r2:
                    break
            else:
                raise ValueError(
                    f"could not place water {i}: {self.MAX_THROWS} "
                    f"throws all landed inside the provided cells — the "
                    f"geometry covers (nearly) the whole "
                    f"water_start_bound sub-cube; shrink the cells, "
                    f"enlarge water_start_bound, or run with "
                    f"avoid_intracellular_throw=False")
            waters[i] = xyz
        return waters


def load_cells_csv(path: str) -> np.ndarray:
    """Cell centers from ``x,y,z`` rows (µm, one cell per line;
    '#'-comment lines skipped)."""
    cells = np.loadtxt(path, delimiter=",", comments="#", ndmin=2)
    if cells.shape[1] != 3:
        raise ValueError(f"{path}: expected 3 columns (x,y,z µm), got "
                         f"{cells.shape[1]}")
    if not np.isfinite(cells).all():
        bad = np.argwhere(~np.isfinite(cells).all(axis=1))[0][0]
        raise ValueError(f"{path}: row {bad} has a non-finite value")
    return cells


#: Params fields baked into the stored scene arrays: a load under
#: different values of THESE silently breaks the geometry's invariants
#: (cell_r in the lookup reach and water rejection, border in the
#: images, mmoment in the dipole column, ...).  Purely-simulation knobs
#: (taucp, chunk_steps, D, ...) are deliberately NOT compared: re-running
#: an archived geometry under new sequence parameters is the point.
GEOMETRY_FIELDS = ("num_cells", "num_water", "cell_r", "bound", "border",
                   "water_start_bound", "hash_dim", "max_neighbors",
                   "mmoment", "avoid_intracellular_throw", "scale")


def _geometry_repr(params: Params) -> str:
    return ";".join(f"{n}={getattr(params, n)!r}"
                    for n in GEOMETRY_FIELDS)


def save_scene(scene: Scene, path: str) -> str:
    """Archive a populated Scene to ``.npz`` (arrays verbatim + the
    geometry-affecting params fields for a mismatch check at load)."""
    np.savez_compressed(
        path, cells=scene.cells, mnps=scene.mnps, waters=scene.waters,
        lookup_table=scene.lookup_table,
        num_intra_mnps=np.int64(scene.num_intra_mnps),
        geom_repr=np.bytes_(_geometry_repr(scene.params).encode()))
    return path


def read_scene_arrays(path: str):
    """Raw reader for the :func:`save_scene` .npz format — the ONE place
    that knows the archive's keys and geom_repr encoding (params-less
    consumers go through here; :func:`load_scene` adds the
    params-match check on top).

    Returns ``(cells, mnps, waters, num_intra_mnps, geom)`` with
    ``geom`` the parsed geometry fields as a {name: str} dict (empty
    for pre-geom_repr archives)."""
    with np.load(path) as z:
        for need in ("cells", "mnps", "waters"):
            if need not in z.files:
                raise ValueError(f"{path} is not a scene archive "
                                 f"(missing {need!r}); expected "
                                 f"scene.save_scene / mri-t2-sim "
                                 f"--save-scene output")
        cells = np.asarray(z["cells"], np.float64)
        mnps = np.asarray(z["mnps"], np.float64)
        waters = np.asarray(z["waters"], np.float64)
        n_intra = int(z["num_intra_mnps"]) if "num_intra_mnps" in z.files \
            else len(cells)
        stored = bytes(z["geom_repr"]).decode() \
            if "geom_repr" in z.files else ""
    geom = dict(kv.split("=", 1) for kv in stored.split(";") if "=" in kv)
    return cells, mnps, waters, n_intra, geom


def load_scene(path: str, params: Params,
               strict_params: bool = True) -> Scene:
    """Rebuild the exact Scene from :func:`save_scene` output.

    ``strict_params`` (default) requires the loading params to match
    the saving params on the GEOMETRY-affecting fields
    (:data:`GEOMETRY_FIELDS`) baked into the stored arrays; simulation
    knobs (taucp, D, chunk/sprint sizing, ...) are free to differ —
    re-running an archived geometry under new sequence parameters is
    the point of the archive.  Pass False to skip even the geometry
    check (then you own the consistency)."""
    with np.load(path) as z:
        stored = bytes(z["geom_repr"]).decode() \
            if "geom_repr" in z.files else ""
        want = _geometry_repr(params)
        if strict_params and stored and stored != want:
            diffs = [f"{a}  vs  {b}"
                     for a, b in zip(stored.split(";"), want.split(";"))
                     if a != b]
            raise ValueError(
                f"{path} was saved under different geometry params "
                f"(simulation knobs may differ; these may not):\n  "
                + "\n  ".join(diffs))
        return Scene(params=params,
                     cells=z["cells"], mnps=z["mnps"],
                     waters=z["waters"],
                     lookup_table=z["lookup_table"],
                     num_intra_mnps=int(z["num_intra_mnps"]))

"""Scene construction: SimulationBox / BacteriaBox.

Host-side construction of the simulation scene, mirroring the reference's
class pair (src/SimulationBox.{h,cpp}, src/BacteriaBox.{h,cpp}) with the
same template-method structure (populateSimulation, SimulationBox.cpp:77-97):

    init_cells -> init_mnps -> init_waters -> init_lookuptable ->
    apply_bcs_on_mnps -> [field acceleration structure] -> sortWaters

Differences from the reference, by design:

* Products are dense NumPy arrays (device-uploadable), not vectors of
  structs: cells [n,3], mnps [m,5] (x,y,z,r,M), waters [w,3],
  lookup [hash_dim^3, max_neighbors].
* Reproducible: driven by the same counter-based Threefry stream as the
  device engine (the reference seeded xoroshiro128+ with time(NULL),
  cuda_sim.cu:911-912).
* Step 6 of the reference populate() built the CPU octree here
  (SimulationBox.cpp:86-92); the TPU design needs no octree — the field
  acceleration structure (chunked local expansion / field grid) is built
  on device from the MNP array by the fields/ package.
* An optional native C++ fast path (csrc/scene_builder.cpp via
  scene/native.py) produces bit-identical arrays for large scenes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..params import Params
from . import images as images_mod
from . import lookup as lookup_mod
from . import morton
from . import native
from .nprng import CounterRNG

# Distinct Threefry streams for each independent draw sequence.  These are
# c1 counter values; the engine's per-step streams use c1 = lane + pair<<27
# (< 2^29 for <=134M walkers), so scene streams live above 2^31 where no
# walker lane can ever collide with them (same key when seed == scene_seed).
_STREAM_CELLS = 0x800000C0
_STREAM_WATERS = 0x800000A0


@dataclasses.dataclass
class Scene:
    """The populated simulation scene (the reference's accessor surface:
    getCells/getWaters/getMNPs/getLookupTable/getMNPCount,
    SimulationBox.h:50-93)."""

    params: Params
    cells: np.ndarray          # [num_cells, 3] cell centers, µm
    mnps: np.ndarray           # [n_mnp, 5] x,y,z,r,M — base dipoles first,
                               # then periodic images
    waters: np.ndarray         # [num_water, 3] initial positions, µm
    lookup_table: np.ndarray   # [hash_dim^3, max_neighbors] int32, -1 padded
    num_intra_mnps: int        # MNPs inside the box (= num_cells here)

    @property
    def mnp_count(self) -> int:
        """Total MNPs including periodic images (getMNPCount,
        SimulationBox.cpp:592-594)."""
        return len(self.mnps)

    def write_stats(self, path: str = "simulation_stats.csv") -> None:
        """print_simulation_stats parity (SimulationBox.cpp:214-237)."""
        p = self.params
        with open(path, "w") as f:
            f.write(f"Number of MNPs, {self.num_intra_mnps}\n")
            for x, y, z, r, _ in self.mnps[: self.num_intra_mnps]:
                f.write(f"{x:.17g},{y:.17g},{z:.17g},{r:.17g}\n")
            f.write(f"Number of Waters, {p.num_water}\n")
            for x, y, z in self.waters:
                f.write(f"{x:.17g},{y:.17g},{z:.17g}\n")
            f.write(f"Number of Cells, {p.num_cells}\n")
            for x, y, z in self.cells:
                f.write(f"{x:.17g},{y:.17g},{z:.17g},{p.cell_r:.17g}\n")


class SimulationBox:
    """Abstract scene builder; subclasses supply init_cells/init_mnps/
    init_waters (SimulationBox.h:50-93)."""

    def __init__(self, params: Params, seed: int = 0,
                 prefer_native: bool = True):
        self.params = params.validate()
        self.seed = seed
        #: use the C++ scene builder when available (bit-identical to the
        #: NumPy path; matters for thousands of cells / 100k+ waters)
        self.use_native = prefer_native and native.available()
        self._scene: Optional[Scene] = None

    # -- template method ----------------------------------------------------

    def populate(self) -> Scene:
        """populateSimulation (SimulationBox.cpp:77-97)."""
        p = self.params
        cells = self.init_cells()
        mnps = self.init_mnps(cells)
        num_intra = len(mnps)
        if self.use_native:
            lookup = native.build_lookup(cells, p.hash_dim, p.bound,
                                         p.cell_r, p.max_neighbors)
        else:
            lookup = lookup_mod.build_lookup_table(cells, p)
        waters = self.init_waters(cells)
        mnps = images_mod.apply_bcs_on_mnps(mnps, p)
        waters = self.sort_waters(waters)
        self._scene = Scene(params=p, cells=cells, mnps=mnps, waters=waters,
                            lookup_table=lookup, num_intra_mnps=num_intra)
        return self._scene

    # -- hooks ---------------------------------------------------------------

    def init_cells(self) -> np.ndarray:
        raise NotImplementedError

    def init_mnps(self, cells: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def init_waters(self, cells: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def sort_waters(self, waters: np.ndarray) -> np.ndarray:
        """Z-order walker sort (sortWaters, SimulationBox.cpp:131-147).

        Physically inert (walker order doesn't enter the dynamics); retained
        so spatially-adjacent walkers share chunk candidates, and for parity.
        """
        order = morton.morton_argsort(waters, self.params.bound)
        return waters[order]

    # -- queries -------------------------------------------------------------

    def check_lattice_containment(self, cells: np.ndarray,
                                  pos: np.ndarray) -> np.ndarray:
        """Index of the cell containing each position, -1 if none
        (checkLatticeContainment, SimulationBox.cpp:161-173)."""
        d2 = np.sum((pos[:, None, :] - cells[None, :, :]) ** 2, axis=2)
        inside = d2 < self.params.cell_r ** 2
        # reference loop keeps the *last* containing index
        idx = np.where(inside.any(axis=1),
                       (len(cells) - 1) - np.argmax(inside[:, ::-1], axis=1),
                       -1)
        return idx.astype(np.int32)

    @property
    def scene(self) -> Scene:
        if self._scene is None:  # accessor guards, SimulationBox.cpp:536-583
            raise RuntimeError("populate() has not been called")
        return self._scene


class BacteriaBox(SimulationBox):
    """Randomly-thrown non-overlapping spherical cells, one point dipole at
    each center, waters thrown in a centered sub-cube
    (src/BacteriaBox.{h,cpp})."""

    def init_cells(self) -> np.ndarray:
        """Rejection-throw cell centers in [cell_r, bound - cell_r]^3 with
        pairwise separation >= 2*cell_r (BacteriaBox.cpp:49-72)."""
        p = self.params
        if self.use_native:
            return native.build_cells(self.seed, _STREAM_CELLS,
                                      p.num_cells, p.cell_r, p.bound)
        gen = CounterRNG(self.seed, _STREAM_CELLS)
        lo, span = p.cell_r, p.bound - 2 * p.cell_r
        cells = np.empty((p.num_cells, 3))
        for i in range(p.num_cells):
            while True:
                xyz = lo + gen.uniform3() * span
                if i == 0:
                    break
                d2 = np.sum((cells[:i] - xyz) ** 2, axis=1)
                if d2.min() >= 4 * p.cell_r * p.cell_r:
                    break
            cells[i] = xyz
        return cells

    def init_mnps(self, cells: np.ndarray) -> np.ndarray:
        """One dipole of moment mmoment and radius 0 at each cell center
        (BacteriaBox.cpp:114-121).

        The radius column is carried for schema parity with MNP_info.r
        (rand_walk.h:58-69) but is deliberately 0: the reference's only
        consumer of a nonzero radius, ``mnp_reflect``, is dead code
        (defined at cuda_sim.cu:528, never called), so nonzero-radius
        MNPs have no reference semantics to match."""
        p = self.params
        mnps = np.zeros((p.num_cells, 5))
        mnps[:, :3] = cells
        mnps[:, 4] = p.mmoment
        return mnps

    def init_waters(self, cells: np.ndarray) -> np.ndarray:
        """Throw waters uniformly in the centered water_start_bound^3
        sub-cube, rejecting intracellular throws when configured
        (BacteriaBox.cpp:80-105, AVOID_INTRACELLULAR_THROW)."""
        p = self.params
        if self.use_native:
            return native.build_waters(
                self.seed, _STREAM_WATERS, p.num_water, cells, p.cell_r,
                p.bound, p.water_start_bound, p.avoid_intracellular_throw)
        gen = CounterRNG(self.seed, _STREAM_WATERS)
        offset = (p.bound - p.water_start_bound) / 2.0
        waters = np.empty((p.num_water, 3))
        r2 = p.cell_r ** 2
        for i in range(p.num_water):
            while True:
                xyz = offset + gen.uniform3() * p.water_start_bound
                if not p.avoid_intracellular_throw:
                    break
                d2 = np.sum((cells - xyz) ** 2, axis=1)
                if d2.min() >= r2:
                    break
            waters[i] = xyz
        return waters


class FCCLatticeBox(BacteriaBox):
    """Cells at face-centered-cubic lattice sites — the reference
    lineage's ordered scene family: its stale octree benchmark driver
    still builds an ``FCC`` lattice from ``fcc_diffusion.h``
    (octree_test.cpp:14,24-25), a geometry removed from the tree but
    predating BacteriaBox.  FCC is the densest packing of equal
    spheres, making this the ordered/dense counterpart to BacteriaBox's
    uniform random throws and ClusteredBacteriaBox's Gaussian clumps.

    Cell placement is deterministic (no RNG): all FCC sites with cubic
    lattice constant ``lattice_a`` inside the admissible cube
    ``[cell_r, bound-cell_r]^3`` are generated, and the ``num_cells``
    sites nearest the box center are kept (stable tie-break by site
    order).  Waters and the dipole-per-cell layout are inherited from
    BacteriaBox unchanged, so only the cell geometry differs.

    ``lattice_a``: cubic lattice constant in µm.  Default sizes the
    lattice so the admissible cube holds ~1.5x num_cells sites (4 sites
    per cubic cell), leaving a centered margin.  The FCC
    nearest-neighbor distance is a/√2; a lattice_a below 2√2·cell_r
    would overlap cells and is rejected.
    """

    def __init__(self, params: Params, seed: int = 0,
                 lattice_a: Optional[float] = None):
        # cells are lattice-generated; the native builder's rejection
        # throw does not apply (waters still use the NumPy path so the
        # scene is identical with or without the C++ extension)
        super().__init__(params, seed, prefer_native=False)
        self.lattice_a = lattice_a

    def init_cells(self) -> np.ndarray:
        p = self.params
        lo, hi = p.cell_r, p.bound - p.cell_r
        span = hi - lo
        if span <= 0:
            raise ValueError("bound too small for cell_r")
        a = self.lattice_a
        if a is None:
            a = (4.0 * span ** 3 / (1.5 * p.num_cells)) ** (1.0 / 3.0)
        if a / np.sqrt(2.0) < 2.0 * p.cell_r:
            raise ValueError(
                f"lattice_a={a:g} gives FCC nearest-neighbor distance "
                f"{a / np.sqrt(2.0):g} < cell diameter "
                f"{2 * p.cell_r:g}; cells would overlap")
        basis = np.array([[0.0, 0.0, 0.0], [0.0, 0.5, 0.5],
                          [0.5, 0.0, 0.5], [0.5, 0.5, 0.0]])
        n = int(np.floor(span / a)) + 1
        ii = np.arange(n, dtype=np.float64)
        grid = np.stack(np.meshgrid(ii, ii, ii, indexing="ij"),
                        axis=-1).reshape(-1, 1, 3)
        sites = ((grid + basis) * a + lo).reshape(-1, 3)
        sites = sites[np.all(sites <= hi + 1e-9, axis=1)]
        if len(sites) < p.num_cells:
            raise ValueError(
                f"FCC lattice with a={a:g} hosts only {len(sites)} sites "
                f"in the admissible cube (need num_cells={p.num_cells}); "
                f"shrink lattice_a or num_cells")
        center = p.bound / 2.0
        d2 = np.sum((sites - center) ** 2, axis=1)
        order = np.argsort(d2, kind="stable")
        return sites[order[: p.num_cells]]


class ClusteredBacteriaBox(BacteriaBox):
    """BacteriaBox variant with cells thrown in Gaussian clumps — the
    scene family where the reference's octree *adaptivity* mattered
    (octree.cpp:262-297 subdivides until < max_product field-gradient
    criterion, i.e. deepest around dipole clusters).  The TPU expansion
    has no tree to deepen; its analogous cost knob is the near-list size
    K, which grows with the worst local dipole density.  This scene
    exists to stress-test that K demand (tests/test_coverage.py and the
    K-vs-scene table in ACCURACY.md).

    ``n_clusters`` cluster centers are thrown uniformly; cells are thrown
    Gaussian(sigma=``cluster_sigma``) around a random cluster center with
    the same non-overlap rejection as BacteriaBox (>= 2*cell_r pairwise).
    """

    def __init__(self, params: Params, seed: int = 0, n_clusters: int = 8,
                 cluster_sigma: float = 1.5, max_tries: int = 100_000):
        # the native builder implements the uniform throw only
        super().__init__(params, seed, prefer_native=False)
        self.n_clusters = n_clusters
        self.cluster_sigma = cluster_sigma
        self.max_tries = max_tries

    def init_cells(self) -> np.ndarray:
        p = self.params
        gen = CounterRNG(self.seed, _STREAM_CELLS)
        lo, hi = p.cell_r, p.bound - p.cell_r
        centers = lo + np.stack(
            [gen.uniform3() for _ in range(self.n_clusters)]) * (hi - lo)
        cells = np.empty((p.num_cells, 3))
        for i in range(p.num_cells):
            for _ in range(self.max_tries):
                c = centers[int(gen.uniform3()[0] * self.n_clusters)
                            % self.n_clusters]
                # Box-Muller from the same counter stream
                u = np.clip(np.concatenate([gen.uniform3(), gen.uniform3()]),
                            1e-12, 1.0)
                nrm = np.sqrt(-2.0 * np.log(u[:3])) * np.cos(
                    2.0 * np.pi * u[3:])
                xyz = np.clip(c + nrm * self.cluster_sigma, lo, hi)
                if i == 0:
                    break
                d2 = np.sum((cells[:i] - xyz) ** 2, axis=1)
                if d2.min() >= 4 * p.cell_r * p.cell_r:
                    break
            else:
                raise ValueError(
                    f"could not place cell {i}: clusters too dense "
                    f"(sigma={self.cluster_sigma}, "
                    f"{p.num_cells} cells of r={p.cell_r})")
            cells[i] = xyz
        return cells

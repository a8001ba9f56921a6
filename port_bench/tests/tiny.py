"""Cells of the benchmark cut to a size a CPU test holds: 64 walkers,
1000-step chunks, 2000-step sprints, a Carr-Purcell flip every 2000
steps.  The large path is forced on a small scene (in the program and
in the reference alike) by ``force_large``."""

from __future__ import annotations

import copy

from port_bench import catalog, run

SMALL = dict(num_water=64, totaltime=0.006, sprint_steps=2000,
             chunk_steps=1000, taucp=0.002, near_k=10)
SMALL_SCALEUP = dict(tau=1e-6, num_cells=270, water_start_bound=10.0,
                     max_neighbors=13, cube_candidates=32,
                     far_table_order=3)


def force_large(monkeypatch):
    from mri_nanoparticle_simulation_tpu_torch.engine import cuda_engine
    from mri_nanoparticle_simulation_tpu_torch.fields import expansion

    import port_bench.reference as ref
    monkeypatch.setattr(cuda_engine, "REBUILD_MAX_MNPS", 0)
    monkeypatch.setattr(expansion, "uses_large_path", lambda *a: True)
    monkeypatch.setattr(ref, "REBUILD_MAX", 0)


def context(cell_name: str, seed: int, monkeypatch):
    """A CPU context of ``cell_name`` at the small size."""
    cell = copy.deepcopy(catalog.load_cell(cell_name))
    cfg = copy.deepcopy(catalog.load_config(cell["config"]))
    cfg["keys"].update(SMALL)
    if cfg["name"] == "scaleup":
        cfg["keys"].update(SMALL_SCALEUP)
        force_large(monkeypatch)
    cell.setdefault("keys", {})
    if "totaltime" in cell["keys"]:
        cell["keys"].update(totaltime=0.004, taucp=0.002)
    for k in ("slice_sprints", "trace_calls"):
        if k in cell:
            cell[k] = 1
    return run.context(cell_name, seed, "cpu", cell, cfg)

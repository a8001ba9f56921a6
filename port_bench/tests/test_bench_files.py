"""The benchmark's files: every configuration, cell and metric parses and
keeps to the names and units the benchmark's contract allows, agrees
with BENCHMARK.json, and a new cell is found by its file alone; the
guard against JAX compares whole top-level names; the reference imports
nothing of the program."""

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from port_bench import catalog, guard

ROOT = Path(catalog.__file__).resolve().parent
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("name", catalog.config_names())
def test_config_parses(name):
    cfg = catalog.load_config(name)
    assert cfg["name"] == name and NAME.match(name)
    assert cfg["source"].startswith("https://")
    assert all(NAME.match(k) for k in cfg["reduced"])
    assert isinstance(cfg["scene_seed"], int)
    from mri_nanoparticle_simulation_tpu_torch.params import Params
    Params(**{k: tuple(v) if isinstance(v, list) else v
              for k, v in cfg["keys"].items()}).validate()


@pytest.mark.parametrize("name", catalog.cell_names())
def test_cell_parses(name):
    cell = catalog.load_cell(name)
    assert NAME.match(name)
    assert cell["config"] in catalog.config_names()
    assert cell["generator"] in ("fast", "threefry")
    assert cell["chips"] == 1
    assert catalog.load_driver(cell["driver"]).check
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    assert all(isinstance(v, (int, float)) for v in cell["limits"].values())


@pytest.mark.parametrize("name", sorted(catalog.metrics()))
def test_metric_parses(name):
    mod = catalog.metrics()[name]
    assert NAME.match(name) and UNIT.match(mod.UNIT)
    assert mod.KIND in ("end_to_end", "per_layer")
    if mod.KIND == "per_layer":
        assert mod.MOVES in {m["name"] for m in BENCH["end_to_end"]}
        assert 1 <= len(mod.LAYER) <= 200 and "\n" not in mod.LAYER


def test_benchmark_json_matches_the_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    mods = catalog.metrics()
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert m["name"] in mods and mods[m["name"]].KIND == kind
            assert m["unit"] == mods[m["name"]].UNIT
            if kind == "per_layer":
                assert m["layer"] == mods[m["name"]].LAYER
                assert m["moves"] == mods[m["name"]].MOVES
    assert {c["name"] for c in BENCH["configs"]} <= set(
        catalog.config_names())
    for c in BENCH["configs"]:
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
    for w in BENCH["workloads"]:
        assert w["traffic"] == w["name"]
        assert catalog.load_cell(w["name"])["config"] == w["config"]
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_every_per_layer_metric_moves_what_its_cells_report():
    """Every cell reports every end-to-end metric, so each per-layer
    metric's ``moves`` is reported wherever the metric is."""
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
        for cell in cells:
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", [cell])


def test_a_new_cell_file_is_found_with_no_edit(tmp_path):
    root = tmp_path / "bench"
    for sub in ("cells", "configs"):
        shutil.copytree(ROOT / sub, root / sub)
    before = catalog.cell_names(root)
    new = dict(catalog.load_cell("headline-fast"), generator="threefry")
    (root / "cells" / "headline-threefry.json").write_text(json.dumps(new))
    assert catalog.cell_names(root) == sorted(before + ["headline-threefry"])
    assert catalog.load_cell("headline-threefry", root)["generator"] == \
        "threefry"


@pytest.mark.parametrize("module,trips", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax", True),
    ("mri_nanoparticle_simulation_tpu", True),
    ("mri_nanoparticle_simulation_tpu.params", True),
    ("mri_nanoparticle_simulation_tpu_torch", False),
    ("mri_nanoparticle_simulation_tpu_torch.params", False),
    ("jaxtyping", False)])
def test_guard_compares_whole_top_level_names(module, trips):
    assert bool(guard.loaded({module: None, "torch": None})) is trips


@pytest.mark.parametrize("path", sorted(
    (ROOT / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "functools", "math", "typing", "numpy",
               "torch"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                continue
            names = [node.module]
        else:
            continue
        for n in names:
            assert n.split(".")[0] in allowed, (path.name, n)


def test_no_harness_file_imports_jax():
    for path in ROOT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            assert not guard.loaded(dict.fromkeys(names)), (path, names)

"""Finds configurations, cells, drivers and metrics by name.

Every configuration is ``configs/<name>.json``, every cell
``cells/<name>.json``, every driver ``drivers/<name>.py`` and every
metric ``metrics/<name>.py``: a later change adds one by adding its file.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _named(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    path = root / kind / f"{_named(name)}.json"
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    return load_json("cells", name, root)


def load_config(name: str, root: Path = ROOT) -> dict:
    return load_json("configs", name, root)


def cell_names(root: Path = ROOT) -> list:
    return sorted(p.stem for p in (root / "cells").glob("*.json"))


def config_names(root: Path = ROOT) -> list:
    return sorted(p.stem for p in (root / "configs").glob("*.json"))


def load_driver(name: str):
    return importlib.import_module(f"port_bench.drivers.{_named(name)}")


def metrics(root: Path = ROOT) -> dict:
    """Every metric module by its name (the file's name without
    ``.py``; names hold dots, so each loads from its file)."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        name = _named(path.name[:-3])
        spec = importlib.util.spec_from_file_location(
            "port_bench.metrics._" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out

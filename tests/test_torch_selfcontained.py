"""The port owns what it uses: its own ``params``, ``scene``, coverage
certificates, golden-scene loader and record fingerprint, each equal to
the JAX package's; and no module of the port (nor ``chip_smoke.py``)
imports jax, the JAX package or the repository's ``scripts/``.

* ``Params``: every field and derived property equal for ``DEFAULT``,
  ``small_test_params``, the scale-up configuration, ``with_permeability``
  and ``impermeable``; the same invalid inputs raise the same errors.
* ``BacteriaBox(p, seed).populate()``: bitwise the same cells, dipoles,
  waters and lookup table, on the NumPy and on the native path.
* ``golden.framework_params`` / ``load_scene`` against
  ``scripts/golden_paired.py`` on ``golden/testdata/scene_6000``.
* ``params_fingerprint`` against ``io/checkpoint.params_fingerprint``;
  the certificate files readable by both packages.
* A static walk of every ``.py`` of the port with ``ast``.
"""

import ast
import dataclasses
import os
import sys

import numpy as np
import pytest

from mri_nanoparticle_simulation_tpu import params as JP
from mri_nanoparticle_simulation_tpu.io.checkpoint import \
    params_fingerprint as jfingerprint
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox as JBox
from mri_nanoparticle_simulation_tpu.utils import cache as jcache
from mri_nanoparticle_simulation_tpu_torch import golden
from mri_nanoparticle_simulation_tpu_torch import params as TP
from mri_nanoparticle_simulation_tpu_torch.benchmark import SCALEUP
from mri_nanoparticle_simulation_tpu_torch.engine import convert
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox as TBox
from mri_nanoparticle_simulation_tpu_torch.scene import native as tnative
from mri_nanoparticle_simulation_tpu_torch.utils import cache as tcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "mri_nanoparticle_simulation_tpu_torch")

#: (JAX Params, port Params) built the same way
CONFIGS = {
    "default": lambda P: P.DEFAULT,
    "small": lambda P: P.small_test_params(),
    "small_in_cells": lambda P: P.small_test_params(
        num_water=64, mmoment=2e-14, avoid_intracellular_throw=False),
    "scaleup": lambda P: P.Params(**SCALEUP).validate(),
    "permeable": lambda P: P.DEFAULT.with_permeability(),
    "impermeable": lambda P: P.small_test_params().impermeable(),
    "variants": lambda P: P.small_test_params(
        kick_mode=P.KICK_INTENDED, direction_mode=P.DIRECTION_SPHERE,
        b0_gradient=(1e-4, 0.0, 2e-4)).with_permeability(),
}


def _properties(cls):
    return sorted(n for n, v in vars(cls).items() if isinstance(v, property))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_equal_jax_params(name):
    jp, tp = CONFIGS[name](JP), CONFIGS[name](TP)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert _properties(TP.Params) == _properties(JP.Params)
    for prop in _properties(JP.Params):
        assert getattr(tp, prop) == getattr(jp, prop), prop
    assert tp.output_filename(123) == jp.output_filename(123)
    assert convert.params_from_fields(dataclasses.asdict(jp)) == tp


def test_params_module_constants_equal():
    names = sorted(n for n in vars(JP) if n.isupper() and n != "DEFAULT")
    assert names == sorted(n for n in vars(TP)
                           if n.isupper() and n != "DEFAULT")
    for n in names:
        assert getattr(TP, n) == getattr(JP, n), n
    assert dataclasses.asdict(TP.DEFAULT) == dataclasses.asdict(JP.DEFAULT)


BAD = {
    "misaligned_taucp": dict(taucp=0.00055),
    "sub_window_taucp": dict(taucp=0.00005),
    "cell_r_outside_box": dict(cell_r=9.0),
    "unknown_kick": dict(kick_mode="sideways"),
    "unknown_direction": dict(direction_mode="cone"),
    "chunk_vs_pfreq": dict(chunk_steps=150),
    "sprint_vs_total": dict(sprint_steps=700),
    "rounds": dict(rng_rounds=10),
    "reflect_outside_unit": dict(reflect_io=1.5),
    "far_table_order": dict(far_table_order=9),
    "gradient_shape": dict(b0_gradient=(1.0, 2.0)),
    "travel_sigmas": dict(travel_sigmas=2.0),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_invalid_params_raise_as_jax(name):
    with pytest.raises(Exception) as jerr:
        JP.small_test_params(**BAD[name])
    with pytest.raises(type(jerr.value)) as terr:
        TP.small_test_params(**BAD[name])
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("p", [1e-3, 5.0, -1.0, 1e6])
def test_permeability_matches_jax(p):
    """with_permeability's formulas and their validity bounds."""
    def run(P):
        try:
            q = P.DEFAULT.with_permeability(p)
            return q.reflect_io, q.reflect_oi
        except ValueError as e:
            return str(e)
    assert run(TP) == run(JP)


def test_params_from_fields_rejects_unknown_names():
    fields = dataclasses.asdict(JP.small_test_params())
    fields["b0_gradient"] = list(fields["b0_gradient"])   # as from JSON
    assert convert.params_from_fields(fields) == TP.small_test_params()
    with pytest.raises(ValueError, match="not Params fields"):
        convert.params_from_fields({**fields, "moment": 1.0})


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_fingerprint_equals_jax(name):
    assert TP.params_fingerprint(CONFIGS[name](TP)) == \
        jfingerprint(CONFIGS[name](JP))


def _assert_scene_equal(a, b):
    for field in ("cells", "mnps", "waters", "lookup_table"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape, field
        np.testing.assert_array_equal(x, y, err_msg=field)
    assert a.num_intra_mnps == b.num_intra_mnps


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("name,seed", [("small", 3), ("small_in_cells", 3),
                                       ("default", 42)])
def test_scene_bitwise_equal_jax(name, seed, native):
    if native and not tnative.available():
        pytest.skip("no g++ for the native scene builder")
    jb = JBox(CONFIGS[name](JP), seed=seed, prefer_native=native)
    tb = TBox(CONFIGS[name](TP), seed=seed, prefer_native=native)
    assert tb.use_native == native
    _assert_scene_equal(tb.populate(), jb.populate())


def test_native_library_is_the_ports_own():
    if not tnative.available():
        pytest.skip("no g++ for the native scene builder")
    assert os.path.dirname(tnative._SRC) == os.path.join(PORT, "csrc")
    assert tnative._LIB.startswith(os.path.join(PORT, "csrc", "build"))
    with open(tnative._SRC, "rb") as f, \
            open(os.path.join(REPO, "csrc", "scene_builder.cpp"), "rb") as g:
        assert f.read() == g.read()


@pytest.fixture(scope="module")
def golden_paired():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import golden_paired as gp
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    return gp


ARMS = [dict(), dict(kick="intended"), dict(gradient=3e-5),
        dict(reflect=(0.1, 0.02), steps=500_000, tcp=100_000)]


@pytest.mark.parametrize("arm", range(len(ARMS)))
def test_golden_params_equal_golden_paired(golden_paired, arm):
    import argparse
    kw = ARMS[arm]
    args = argparse.Namespace(
        steps=kw.get("steps", golden.STEPS), tcp=kw.get("tcp", golden.TCP),
        mscale=golden.MSCALE, fw_reps=1, kick=kw.get("kick", "aswritten"),
        gradient=kw.get("gradient", 0.0), reflect=kw.get("reflect"))
    assert dataclasses.asdict(golden.framework_params(**kw)) == \
        dataclasses.asdict(golden_paired.framework_params(args))
    for n in ("N_WATER", "STEPS", "PFREQ", "TCP", "MSCALE", "FW_RUN0"):
        assert getattr(golden, n) == getattr(golden_paired, n), n


def test_golden_scene_equals_golden_paired(golden_paired):
    d = os.path.join(REPO, "golden", "testdata", "scene_6000")
    ours = golden.load_scene(d, golden.framework_params())
    args = dict(steps=golden.STEPS, tcp=golden.TCP, mscale=golden.MSCALE,
                fw_reps=1, kick="aswritten", gradient=0.0, reflect=None)
    import argparse
    theirs = golden_paired.load_scene(
        d, golden_paired.framework_params(argparse.Namespace(**args)))
    _assert_scene_equal(ours, theirs)
    assert len(ours.mnps) == 745


def _golden_t2_tree():
    with open(os.path.join(REPO, "scripts", "golden_t2.py")) as f:
        return ast.parse(f.read())


#: scripts/golden_t2.py's module constants -> the port's copies
T2_CONSTANTS = {"N_WATER": "T2_N_WATER", "STEPS": "T2_STEPS",
                "PFREQ": "T2_PFREQ", "TCP": "T2_TCP", "MSCALE": "T2_MSCALE"}


def test_t2_arm_constants_equal_golden_t2():
    ref = {t.id: ast.literal_eval(node.value)
           for node in _golden_t2_tree().body
           if isinstance(node, ast.Assign) for t in node.targets
           if isinstance(t, ast.Name) and t.id in T2_CONSTANTS}
    assert set(ref) == set(T2_CONSTANTS)
    for name, ours in T2_CONSTANTS.items():
        assert getattr(golden, ours) == ref[name], name


def test_t2_arm_params_and_seeds_equal_golden_t2():
    """The Params of scripts/golden_t2.py's framework arm (its
    ``P.DEFAULT.replace(...)`` without reflection, each field's
    expression evaluated with its constants) and the seeds of its
    ``run_ensemble`` call."""
    fn = next(n for n in _golden_t2_tree().body
              if isinstance(n, ast.FunctionDef)
              and n.name == "run_framework_trials")
    calls = {c.func.attr: c for c in ast.walk(fn)
             if isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)}
    env = {"P": JP, "reflect": None,
           **{n: getattr(golden, ours) for n, ours in T2_CONSTANTS.items()}}
    fields = {k.arg: eval(compile(ast.Expression(k.value), "golden_t2",
                                  "eval"), env)
              for k in calls["replace"].keywords}
    assert dataclasses.asdict(golden.t2_arm_params()) == \
        dataclasses.asdict(JP.DEFAULT.replace(**fields).validate())
    run = {k.arg: k.value for k in calls["run_ensemble"].keywords}
    assert ast.literal_eval(run["base_seed"]) == golden.T2_BASE_SEED
    assert ast.literal_eval(run["run_seed"]) == golden.T2_RUN_SEED
    assert ast.literal_eval(run["engine"]) == "pallas"


def test_golden_scene_rejects_wrong_sizes():
    d = os.path.join(REPO, "golden", "testdata", "scene_6000")
    with pytest.raises(ValueError, match="scene dump"):
        golden.load_scene(d, golden.framework_params().replace(num_water=64))


def test_certificates_shared_with_jax(tmp_path, monkeypatch):
    """Same keys, same file format: each package reads what the other
    wrote."""
    monkeypatch.setenv("MRI_TPU_COMPILE_CACHE", str(tmp_path))
    tcache.certificate_put("neark", b"scene-a", 7)
    assert jcache.certificate_get("neark", b"scene-a") == 7
    jcache.certificate_put("cubec", b"scene-b", 31)
    assert tcache.certificate_get("cubec", b"scene-b") == 31
    assert tcache.certificate_get("cubec", b"scene-c") is None
    assert sorted(os.listdir(tmp_path / "certs")) == sorted(
        os.listdir(tmp_path / "certs"))
    assert tcache._default_dir() == jcache._default_dir()


# -- nothing of jax, the JAX package or scripts/ in the port ------------------

FORBIDDEN = ("jax", "jaxlib", "mri_nanoparticle_simulation_tpu",
             "golden_paired")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(tree):
    """(line, module) of every import anywhere in the tree, functions
    included; relative imports give None."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, None if node.level else node.module
        elif isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                yield node.lineno, node.args[0].value


def _path_insertions(tree):
    """Source text of every argument given to sys.path.insert/append."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr in ("insert", "append") \
                and ast.unparse(node.func.value) == "sys.path":
            yield node.lineno, " ".join(ast.unparse(a) for a in node.args)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    for mod in ("io/checkpoint.py", "engine/resilience.py", "scene/io.py",
                "fields/debug.py", "parallel/__init__.py",
                "parallel/ensemble.py", "utils/profiling.py",
                "fields/grid.py", "inverse.py", "parallel/sharding.py",
                "parallel/distributed.py", "plotting.py"):
        assert os.path.join(PORT, mod) in files, mod
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for line, mod in _imports(tree):
            if mod and mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{os.path.relpath(path, REPO)}:{line} {mod}")
        for line, arg in _path_insertions(tree):
            if "scripts" in arg:
                bad.append(f"{os.path.relpath(path, REPO)}:{line} "
                           f"sys.path <- {arg}")
    assert not bad, bad


def test_the_ast_check_sees_imports_inside_functions(tmp_path):
    """The walk above finds what it must: imports in function bodies,
    importlib calls and path insertions."""
    src = ("import os\n"
           "def f():\n"
           "    from mri_nanoparticle_simulation_tpu.params import Params\n"
           "    import importlib\n"
           "    importlib.import_module('jax.numpy')\n"
           "    sys.path.insert(0, os.path.join(ROOT, 'scripts'))\n"
           "    import golden_paired\n")
    tree = ast.parse(src)
    mods = [m for _, m in _imports(tree)]
    assert "mri_nanoparticle_simulation_tpu.params" in mods
    assert "jax.numpy" in mods and "golden_paired" in mods
    assert [a for _, a in _path_insertions(tree)] == [
        "0 os.path.join(ROOT, 'scripts')"]

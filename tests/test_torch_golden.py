"""The port at production depth against the reference oracle, under every
limit of tests/test_golden_full.py.

On the card (marked ``cuda``; skipped from a fixture without one): the
golden scenes 6000 and 6001 (the reference's own scene dumps, moments
x60, 4032 walkers, 2e6 steps, 8 Carr-Purcell flips) through the port on
Threefry, one rep keyed ``FW_RUN0`` as that test runs the JAX engine,
held to every gate: per seed the RMS, final, early-window and
late-window differences and the depth, against the tightened oracle of
seed 6000 its RMS and late mean, and across seeds the final and late
means.  Run it with

    python -m pytest tests/test_torch_golden.py -m cuda -q

The T2 arms (also on the card): the port's ensembles of
``golden.run_t2_arm`` against the reference oracle's final mean and
standard error in GOLDEN_T2.json, GOLDEN_T2_D.json (d_scale 0.5) and
GOLDEN_T2_r0.8.json (run cell_r 0.8), |z_final| <= 3 each.

On the CPU: the port keeps its own copies of the gates (it imports
nothing of the reference's scripts or tests); they are held equal to
tests/test_golden_full.py, read with ``ast``; and the gate function is
held to the committed JAX curves (GOLDEN_T2_FULL_curves.npz, which the
gates were set from) and to curves shifted past each limit.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu_torch import golden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "golden", "testdata")
CONSTANTS = ("RMS_GATE", "FINAL_GATE", "EARLY_WINDOW", "LATE_WINDOW",
             "EARLY_ABS_GATE", "LATE_RANGE", "LATE_MEAN_RANGE",
             "TIGHT_RMS_GATE", "TIGHT_LATE_ABS_GATE", "SEEDS")


def _reference_tree():
    with open(os.path.join(REPO, "tests", "test_golden_full.py")) as f:
        return ast.parse(f.read())


def test_gate_constants_equal_the_reference():
    tree = _reference_tree()
    ref = {t.id: ast.literal_eval(node.value)
           for node in tree.body if isinstance(node, ast.Assign)
           for t in node.targets
           if isinstance(t, ast.Name) and t.id in CONSTANTS}
    assert set(ref) == set(CONSTANTS)
    for name in CONSTANTS:
        assert getattr(golden, name) == ref[name], name
    # the depth gate is a literal in the test body: `oracle[n - 1] < 0.45`
    depth = {c.value for node in ast.walk(tree)
             if isinstance(node, ast.Compare)
             for c in node.comparators if isinstance(c, ast.Constant)
             and isinstance(c.value, float)}
    assert depth == {golden.DEPTH_GATE}


def _committed():
    """{seed: (oracle, the JAX framework's curve, tight oracle or None)}
    from the committed 4-rep curves (rows 0 and 1 are scenes 6000 and
    6001)."""
    z = np.load(os.path.join(REPO, "GOLDEN_T2_FULL_curves.npz"))
    out = {}
    for row, seed in enumerate(golden.SEEDS):
        oracle = golden.oracle_curve(TESTDATA, seed)
        np.testing.assert_array_equal(oracle, z["oracle"][row])
        out[seed] = (oracle, z["framework"][row],
                     golden.oracle_curve(TESTDATA, seed, tight=True))
    return out


def test_committed_jax_curves_meet_every_gate():
    curves = _committed()
    assert curves[6000][2] is not None and curves[6001][2] is None
    readings = {s: golden.gate_readings(*c) for s, c in curves.items()}
    assert golden.gate_failures(readings) == []
    # the measured values the reference's comments give
    assert readings[6000]["rms"] == pytest.approx(0.0098, abs=1e-4)
    assert readings[6001]["rms"] == pytest.approx(0.0180, abs=1e-4)
    assert readings[6000]["tight_rms"] == pytest.approx(0.0061, abs=1e-4)


@pytest.mark.parametrize("shift, where, broken", [
    (0.030, slice(None), "seed 6000: rms"),
    (0.025, slice(0, 250), "seed 6000: early"),
    (-0.050, slice(-500, None), "seed 6000: late"),
    (-0.080, slice(-1, None), "seed 6000: final diff"),
    (0.020, slice(-500, None), "seed 6000: tight late"),
    (0.020, slice(None), "seed 6000: tight rms"),
    (-0.045, slice(-500, None), "cross-seed late mean"),
    (0.5, slice(-1, None), "seed 6000: finals"),
])
def test_each_gate_catches_its_fault(shift, where, broken):
    curves = _committed()
    oracle, ours, tight = curves[6000]
    ours = ours.astype(np.float64).copy()
    ours[where] += shift
    readings = {6000: golden.gate_readings(oracle, ours, tight),
                6001: golden.gate_readings(*curves[6001])}
    fails = golden.gate_failures(readings)
    assert any(f.startswith(broken) for f in fails), fails


def test_short_curve_fails_the_window_count():
    oracle, ours, _ = _committed()[6001]
    fails = golden.gate_failures({6001: golden.gate_readings(oracle,
                                                             ours[:1999])})
    assert "seed 6001: 1999 windows" in fails


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible to torch")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_port_meets_every_golden_gate(dev):
    readings = {}
    for seed in golden.SEEDS:
        ours, stats = golden.run_seed(TESTDATA, seed, dev)
        assert stats["escapes"] == 0 and stats["coverage_violations"] == 0
        assert np.isfinite(ours).all()
        readings[seed] = golden.gate_readings(
            golden.oracle_curve(TESTDATA, seed), ours,
            golden.oracle_curve(TESTDATA, seed, tight=True))
    assert "tight_rms" in readings[6000]
    assert golden.gate_failures(readings) == [], readings


#: committed T2 report -> (trials, d_scale, run cell_r; 0 = none)
T2_ARMS = {"GOLDEN_T2.json": (16, 1.0, 0.0),
           "GOLDEN_T2_D.json": (10, 0.5, 0.0),
           "GOLDEN_T2_r0.8.json": (6, 1.0, 0.8)}


@pytest.mark.parametrize("name", sorted(T2_ARMS))
def test_t2_arms_are_the_committed_reports(name):
    with open(os.path.join(REPO, name)) as f:
        cfg = json.load(f)["config"]
    n, d, cr = T2_ARMS[name]
    assert (cfg["n_water"], cfg["steps"], cfg["pfreq"], cfg["tcp"],
            cfg["moment_scale"]) == (golden.T2_N_WATER, golden.T2_STEPS,
                                     golden.T2_PFREQ, golden.T2_TCP,
                                     golden.T2_MSCALE)
    assert cfg["framework_trials"] == n
    assert cfg.get("d_scale", 1.0) == d
    assert (cfg.get("cell_r_run") or 0.0) == cr


def test_t2_arm_gate_reads_the_report(tmp_path):
    path = tmp_path / "r.json"
    path.write_text(json.dumps({"oracle_final_mean": 0.85,
                                "oracle_final_stderr": 0.03,
                                "framework_final_mean": 0.84}))
    curves = np.ones((4, 3)) * np.array([0.80, 0.82, 0.84, 0.86])[:, None]
    r = golden.t2_arm_gate(str(path), curves)
    se = np.std([0.80, 0.82, 0.84, 0.86], ddof=1) / 2
    assert r["mean"] == pytest.approx(0.83)
    assert r["stderr"] == pytest.approx(se)
    assert r["z_final"] == pytest.approx(0.02 / np.sqrt(0.03 ** 2 + se ** 2))
    assert (r["oracle_mean"], r["oracle_stderr"], r["jax_mean"]) == \
        (0.85, 0.03, 0.84)


@pytest.mark.cuda
def test_port_meets_the_t2_arms(dev):
    for name, (n, d, cr) in T2_ARMS.items():
        curves = golden.run_t2_arm(n, d, cr, dev, "threefry")
        assert curves.shape == (n, golden.T2_STEPS // golden.T2_PFREQ)
        assert np.isfinite(curves).all()
        r = golden.t2_arm_gate(os.path.join(REPO, name), curves)
        assert abs(r["z_final"]) <= golden.T2_Z_GATE, (name, r)

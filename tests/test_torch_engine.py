"""The port's main path as a whole against the JAX package.

* ``cuda_engine.run_simulation`` (on the CPU: the plain chunk) against
  the reference's Pallas engine (interpret mode) and scan engine, on the
  configurations of tests/test_pallas.py:29-82 this slice supports, with
  their tolerances (positions 5e-6, window sums 1e-3);
* a run handed across frameworks mid-way (``engine.convert``);
* the runner's CSV against the reference runner's, and the writers' bytes;
* the CLI's physics flags build the reference CLI's Params;
* what the port does not run raises, and nothing falls back to the CPU;
* the package imports without jax.

The physics variants and the fast generator are held against the JAX
package in tests/test_torch_variants.py.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu import params as P
from mri_nanoparticle_simulation_tpu import rng as jrng
from mri_nanoparticle_simulation_tpu.engine import pallas_engine as pe
from mri_nanoparticle_simulation_tpu.engine import reference_engine as jre
from mri_nanoparticle_simulation_tpu.engine import sim as jsim
from mri_nanoparticle_simulation_tpu.io import writer as jwriter
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
from mri_nanoparticle_simulation_tpu_torch.engine import (chunk_kernel,
                                                          convert,
                                                          cuda_engine, sim)
from mri_nanoparticle_simulation_tpu_torch.engine.reference_engine import \
    init_state
from mri_nanoparticle_simulation_tpu_torch.io import writer
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox as TBox

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tp(p):
    """The port's Params of the JAX Params ``p``."""
    return convert.params_from_fields(dataclasses.asdict(p))

# tests/test_pallas.py TestEngineEquivalence, the configurations of the
# default physics (its reflection and intended-kick cases are in
# tests/test_torch_variants.py)
ENGINE_CASES = {
    "chunk_equals_pfreq": dict(chunk_steps=100, num_water=64,
                               totaltime=0.001, sprint_steps=500),
    "chunk_spans_windows": dict(chunk_steps=200, num_water=64,
                                totaltime=0.0008, sprint_steps=400),
    "nonmultiple_walker_padding": dict(chunk_steps=100, num_water=50,
                                       totaltime=0.0002, sprint_steps=200),
}


@pytest.fixture(scope="module", params=sorted(ENGINE_CASES))
def engines(request):
    p = P.small_test_params(print_interval=0.0001,
                            **ENGINE_CASES[request.param])
    sc = BacteriaBox(p, seed=3).populate()
    scan = jre.run_simulation(sc, p, seed=1, dtype=jnp.float32)
    pallas = pe.run_simulation(sc, p, seed=1, dtype=jnp.float32,
                               interpret=True)
    port = cuda_engine.run_simulation(TBox(_tp(p), seed=3).populate(),
                                      _tp(p), seed=1, device="cpu")
    return p, scan, pallas, port


def test_run_simulation_matches_pallas_engine(engines):
    p, _, (t1, c1, s1, st1), (t2, c2, s2, st2) = engines
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_allclose(st2.pos.numpy(), np.asarray(st1.pos),
                               atol=5e-6)
    np.testing.assert_allclose(c2, c1, atol=1e-3)
    np.testing.assert_allclose(s2, s1, atol=1e-3)
    assert st2.step == int(st1.step) == p.t
    assert int(st2.escapes) == int(st1.escapes)
    assert int(st2.coverage) == int(st1.coverage)
    np.testing.assert_array_equal(st2.in_cell.numpy(),
                                  np.asarray(st1.in_cell))


def test_run_simulation_matches_scan_engine(engines):
    p, (_, c1, _, st1), _, (_, c2, _, st2) = engines
    np.testing.assert_allclose(st2.pos.numpy(), np.asarray(st1.pos),
                               atol=5e-6)
    np.testing.assert_allclose(c2, c1, atol=1e-3)
    assert abs(c2[0]) <= p.num_water + 1e-6


@pytest.fixture(scope="module")
def two_sprints():
    """The reference Pallas engine running sprint 1 and then sprint 2."""
    p = P.small_test_params(chunk_steps=200, print_interval=0.0001,
                            num_water=64, totaltime=0.0008,
                            sprint_steps=400, taucp=0.0003)
    sc = BacteriaBox(p, seed=4).populate()
    sprint = pe.make_sprint_fn(p, p.num_water, interpret=True)
    kk = jrng.key_from_seed(5)
    key_arr = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
    mp = jnp.asarray(sc.mnps[:, :3], jnp.float32)
    mM = jnp.asarray(sc.mnps[:, 4], jnp.float32)
    ps0 = pe.to_planes(jre.init_state(sc.waters, p), p)
    ps1, w1 = sprint(mp, mM, key_arr, ps0, 0)
    ps2, w2 = sprint(mp, mM, key_arr, ps1, 0)
    host = lambda ps: pe.PlaneState(*(np.asarray(f) for f in ps))  # noqa
    return p, sc, sprint, (mp, mM, key_arr), host(ps1), \
        (host(ps2), np.asarray(w1), np.asarray(w2))


def test_resume_jax_sprint_then_port_sprint(two_sprints):
    p, sc, _, _, ps1, (ps2, _, w2) = two_sprints
    tp = _tp(p)
    ws = convert.state_from_planes(ps1, p.num_water, "cpu")
    sprint = cuda_engine.make_sprint_fn(tp, p.num_water, "cpu")
    ss, wins = sprint(convert.mnp_table(TBox(tp, seed=4).populate().mnps,
                                        torch.float32, "cpu"),
                      convert.key_words(5), cuda_engine.to_soa(ws, tp))
    ref = pe.from_planes(ps2, p.num_water)
    got = cuda_engine.from_soa(ss, p.num_water)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos),
                               atol=5e-6)
    np.testing.assert_allclose(got.phase.numpy(), np.asarray(ref.phase),
                               atol=5e-6)
    np.testing.assert_allclose(wins.numpy(), w2, atol=1e-3)
    assert got.step == int(ref.step) == 800
    assert int(got.escapes) == int(ref.escapes)
    assert int(got.coverage) == int(ref.coverage)


def test_resume_port_sprint_then_jax_sprint(two_sprints):
    p, _, jsprint, jargs, _, (ps2, w1, w2) = two_sprints
    tp = _tp(p)
    sc = TBox(tp, seed=4).populate()
    sprint = cuda_engine.make_sprint_fn(tp, p.num_water, "cpu")
    ss, wins = sprint(convert.mnp_table(sc.mnps, torch.float32, "cpu"),
                      convert.key_words(5),
                      cuda_engine.to_soa(init_state(sc.waters, tp, "cpu"),
                                         tp))
    np.testing.assert_allclose(wins.numpy(), w1, atol=1e-3)
    ws = convert.state_to_numpy(cuda_engine.from_soa(ss, p.num_water))
    assert ws.step.dtype == np.uint32 and ws.escapes.dtype == np.int32
    ps, wj = jsprint(*jargs, pe.to_planes(jre.WalkerState(*ws), p), 0)
    np.testing.assert_allclose(np.asarray(wj), w2, atol=1e-3)
    np.testing.assert_allclose(
        np.asarray(pe.from_planes(ps, p.num_water).pos),
        np.asarray(pe.from_planes(ps2, p.num_water).pos), atol=5e-6)


def test_state_from_numpy_roundtrip():
    p = P.small_test_params(num_water=50)
    st = jre.init_state(BacteriaBox(p, seed=1).populate().waters, p)
    ws = convert.state_from_numpy(st, "cpu")
    back = convert.state_to_numpy(ws)
    np.testing.assert_array_equal(back.pos, st.pos)
    np.testing.assert_array_equal(back.in_cell, st.in_cell)
    ss = cuda_engine.to_soa(ws, _tp(p))
    assert ss.planes.shape == (6, 128)
    assert float(ss.planes[0, 50:].min()) == p.bound / 2
    np.testing.assert_array_equal(
        cuda_engine.from_soa(ss, 50).pos.numpy(), st.pos)


def test_mnp_table_packs_as_the_pallas_sprint():
    p = P.small_test_params()
    sc = BacteriaBox(p, seed=3).populate()
    t = convert.mnp_table(TBox(_tp(p), seed=3).populate().mnps,
                          torch.float32, "cpu")
    n = len(sc.mnps)
    assert t.n_mnp == n and t.tbl.shape == (4, -(-n // 8) * 8)
    m = jnp.asarray(sc.mnps[:, 4], jnp.float32) * jnp.float32(1e11)
    np.testing.assert_array_equal(t.tbl[3, :n].numpy(), np.asarray(m))
    np.testing.assert_array_equal(
        t.tbl[:3, :n].numpy(), np.asarray(sc.mnps[:, :3], np.float32).T)
    assert (t.tbl[:3, n:] == 1e6).all() and (t.tbl[3, n:] == 0).all()


@pytest.fixture(scope="module")
def runner_csvs(tmp_path_factory):
    d = tmp_path_factory.mktemp("csv")
    p = P.small_test_params(totaltime=0.001, sprint_steps=500)
    jr = jsim.SimulationRunner(p, scene_seed=3, seed=2, engine="pallas",
                               rng_impl="threefry", interpret=True)
    j = jr.run(csv_path=str(d / "jax.csv"), quadrature=True,
               progress=False)
    tr = sim.SimulationRunner(_tp(p), scene_seed=3, seed=2, device="cpu",
                              rng_impl="threefry")
    t = tr.run(csv_path=str(d / "port.csv"), quadrature=True,
               progress=False, drain_depth=1)
    return p, (d / "jax.csv").read_text(), (d / "port.csv").read_text(), \
        j, t


def test_runner_csv_matches_jax_runner(runner_csvs):
    p, jtxt, ttxt, _, _ = runner_csvs
    jrows = [r.split(",") for r in jtxt.splitlines()]
    trows = [r.split(",") for r in ttxt.splitlines()]
    assert len(trows) == len(jrows) == p.t // p.pfreq
    assert [r[0] for r in trows] == [r[0] for r in jrows]   # byte-equal
    np.testing.assert_allclose(np.array(trows, float)[:, 1:],
                               np.array(jrows, float)[:, 1:], atol=1e-3)


def test_runner_returns_the_jax_runner_contract(runner_csvs):
    _, _, _, (jt, jc, js, jstats), (tt, tc, ts, tstats) = runner_csvs
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tc, jc, atol=1e-3)
    np.testing.assert_allclose(ts, js, atol=1e-3)
    assert set(tstats) == set(jstats)
    for k in ("escapes", "coverage_violations", "steps"):
        assert tstats[k] == jstats[k]


@pytest.mark.parametrize("quadrature", [False, True])
def test_writer_bytes_equal_jax_writer(tmp_path, quadrature):
    p = P.small_test_params()
    wins = np.random.default_rng(0).normal(size=(7, 2)).astype(np.float32)
    for mod, name, q in ((jwriter, "j.csv", p), (writer, "t.csv", _tp(p))):
        with mod.T2CsvWriter(str(tmp_path / name), q, quadrature) as w:
            w.append_windows(0, wins[:3])
            w.append_windows(3, wins[3:])
            assert w.rows_written == 7
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()
    got = writer.read_t2_csv(str(tmp_path / "t.csv"))
    assert len(got) == (3 if quadrature else 2)
    assert writer.default_output_path(_tp(p), "d") == \
        os.path.join("d", os.path.basename(jwriter.default_output_path(p)))


@pytest.mark.parametrize("t, req", [(2000, 4000), (2000, 700), (40000, 3000)])
def test_fit_steps_match_jax(t, req):
    p = P.small_test_params(totaltime=t * 1e-6, tau=1e-6, taucp=1e-3,
                            print_interval=1e-4, sprint_steps=t,
                            chunk_steps=100)
    assert sim.fit_chunk_steps(_tp(p), req) == jsim.fit_chunk_steps(p, req)
    pc = p.replace(chunk_steps=sim.fit_chunk_steps(_tp(p), req))
    assert sim.fit_sprint_steps(_tp(pc), req * 3) == \
        jsim.fit_sprint_steps(pc, req * 3)


UNPORTED = {
    "chunk_below_pfreq": dict(chunk_steps=50),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_physics_raises(name):
    p = _tp(P.small_test_params(**UNPORTED[name]))
    with pytest.raises(NotImplementedError,
                       match="scan engine.*engine='scan'"):
        cuda_engine.make_sprint_fn(p, p.num_water, "cpu")


def test_unported_paths_raise():
    """The hardware generator builds and runs on the CPU (its plain
    version), as the runner's default; an unknown generator raises."""
    p = _tp(P.small_test_params(totaltime=0.0002, sprint_steps=200))
    runner = sim.SimulationRunner(p, scene_seed=3, device="cpu")
    assert runner.rng_impl == "hardware"
    _, c, _, stats = runner.run(progress=False)
    assert stats["steps"] == p.t and np.all(np.isfinite(c))
    assert np.all(np.abs(c) <= p.num_water)
    with pytest.raises(ValueError, match="unknown rng_impl"):
        cuda_engine.make_sprint_fn(p, p.num_water, "cpu", rng_impl="mt")
    with pytest.raises(ValueError, match="unknown rng_impl"):
        sim.SimulationRunner(p, device="cpu", rng_impl="mt")


def test_near_k_above_dipole_count_raises():
    p = _tp(P.small_test_params(near_k=6))
    mnps = np.zeros((3, 5))
    mnps[:, :3] = [[1, 1, 1], [2, 2, 2], [3, 3, 3]]
    sprint = cuda_engine.make_sprint_fn(p, p.num_water, "cpu")
    with pytest.raises(ValueError, match="exceeds the number of dipoles"):
        sprint(convert.mnp_table(mnps, torch.float32, "cpu"), (0, 1),
               cuda_engine.to_soa(init_state(
                   np.full((p.num_water, 3), 4.0), p, "cpu"), p))


def test_cuda_runner_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks a box without one")
    p = _tp(P.small_test_params())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.SimulationRunner(p, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.main(["--num-water", "64", "--totaltime", "0.002",
                  "--out", os.devnull])


def test_cuda_sprint_refuses_cpu_state():
    """A sprint built for the card never computes on the CPU."""
    p = _tp(P.small_test_params())
    sc = TBox(p, seed=3).populate()
    sprint = cuda_engine.make_sprint_fn(p, p.num_water, "cuda")
    before = dict(chunk_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="state is on cpu"):
        sprint(convert.mnp_table(sc.mnps, torch.float32, "cpu"), (0, 1),
               cuda_engine.to_soa(init_state(sc.waters, p, "cpu"), p))
    assert chunk_kernel.LAUNCHES == before


def test_cli_runs_on_cpu(tmp_path):
    out = tmp_path / "t2.csv"
    rc = sim.main(["--num-water", "64", "--totaltime", "0.002",
                   "--taucp", "0.001", "--chunk-steps", "1000",
                   "--sprint-steps", "1000", "--near-k", "10",
                   "--scene-seed", "1", "--out", str(out), "--quadrature",
                   "--device", "cpu"])
    assert rc == 0
    t, c, s = writer.read_t2_csv(str(out))
    np.testing.assert_allclose(t, [1e-3, 2e-3])
    assert np.all(np.abs(c) <= 64) and np.all(np.isfinite(s))


VARIANT_FLAGS = ["--kick-mode", "intended", "--permeable",
                 "--gradient=0,0,2e-5", "--mmoment", "7e-17", "--cell-r",
                 "0.6", "--num-water", "64", "--totaltime", "0.002",
                 "--taucp", "0.001", "--chunk-steps", "1000",
                 "--sprint-steps", "1000", "--scene-seed", "1"]


class _Built(Exception):
    pass


def _cli_runner_args(monkeypatch, mod, argv):
    """(params, rng_impl) that ``mod.main(argv)`` hands its runner."""
    def capture(params, *a, **kw):
        raise _Built(params, kw.get("rng_impl"))
    monkeypatch.setattr(mod, "SimulationRunner", capture)
    if hasattr(mod, "enable_compile_cache"):
        monkeypatch.setattr(mod, "enable_compile_cache", lambda: None)
    with pytest.raises(_Built) as got:
        mod.main(argv)
    return got.value.args


@pytest.mark.parametrize("flags", [
    VARIANT_FLAGS, VARIANT_FLAGS[:2] + ["--impermeable", "--rng",
                                        "threefry"], []])
def test_cli_params_match_jax_cli(monkeypatch, tmp_path, flags):
    """The same flags build the same Params as the reference CLI
    (sim.py:808-836), and both default to the hardware generator."""
    out = ["--out", str(tmp_path / "t2.csv")]
    p, rng_impl = _cli_runner_args(monkeypatch, sim,
                                   flags + out + ["--device", "cpu"])
    jp, jrng_impl = _cli_runner_args(monkeypatch, jsim, flags + out)
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    assert p == _tp(jp)
    assert rng_impl == jrng_impl == ("threefry" if "threefry" in flags
                                     else "hardware")


def test_cli_runs_physics_variants_on_cpu(tmp_path):
    out = tmp_path / "t2.csv"
    assert sim.main(VARIANT_FLAGS + ["--out", str(out), "--device",
                                     "cpu"]) == 0
    t, c = writer.read_t2_csv(str(out))
    np.testing.assert_allclose(t, [1e-3, 2e-3])
    assert np.all(np.abs(c) <= 64) and np.all(np.isfinite(c))


@pytest.mark.parametrize("bad", ["1,2", "a,b,c", "1,2,3,4"])
def test_cli_rejects_malformed_gradient(bad, capsys):
    with pytest.raises(SystemExit):
        sim.main([f"--gradient={bad}", "--device", "cpu"])
    assert "three comma-separated numbers" in capsys.readouterr().err


def test_package_imports_without_jax():
    """In a subprocess: xdist runs several files per worker, and a
    poisoned ``sys.modules['jax']`` (and the JAX package's) must not leak
    into them.  Every module of the port, and chip_smoke.py, imports with
    neither importable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mri_nanoparticle_simulation_tpu'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import mri_nanoparticle_simulation_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for m in ('parallel', 'parallel.ensemble', 'utils.profiling',\n"
        "          'fields.grid', 'inverse', 'parallel.sharding',\n"
        "          'parallel.distributed', 'plotting'):\n"
        "    assert pkg.__name__ + '.' + m in sys.modules, m\n"
        "bad = [m for m, v in sys.modules.items()\n"
        "       if v is not None and m.split('.')[0] in ('jax', 'jaxlib',\n"
        "           'mri_nanoparticle_simulation_tpu', 'golden_paired')]\n"
        "assert not bad, bad\n"
        "print('ok', len(list(pkgutil.walk_packages(pkg.__path__))))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")

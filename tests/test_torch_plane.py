"""The port's on-device (moment x taucp) plane on the CPU, against the
JAX package: ``decompose.make_plane_step``, ``run_plane_on_device``,
the echo captures and their files, and the CLI's ``--plane-device`` and
``--dump-echoes``.

* ``make_plane_step`` against JAX's ``make_plane_step(raw=True)`` on the
  same seeded record planes, sign tables and carries, three sprints in
  a row, with and without echo specs: carries, curve blocks and echo
  rows within 1e-6 (both float32; XLA on the CPU contracts the
  multiply-adds into FMAs and orders its cumsum its own way, the port
  does neither).
* ``run_plane_on_device`` against JAX's (scan engine, and Pallas in
  interpret mode) and against the port's float64 ``StreamingPlane`` on
  the same run: curves and echo captures within 1e-4 in cos/walker
  mean, the JAX tolerance (tests/test_decompose.py:369-475).  The
  fixture's Carr-Purcell flips land on sprint boundaries, so the carry
  across sprints is exercised on every sprint.
* The CLI: ``--plane-device`` CSVs against ``--stream-plane`` CSVs
  within 32 x 1e-4 in Σcos (tests/test_sim_io.py:878-895), and against
  the JAX CLI's ``--plane-device`` files; ``--dump-echoes`` files read
  by both packages.  The flag rules are cases of
  tests/test_torch_decompose.py::test_cli_flag_rules_match_jax.
"""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu import params as JP
from mri_nanoparticle_simulation_tpu.engine import decompose as jdec
from mri_nanoparticle_simulation_tpu.engine import sim as jsim
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox as JBox
from mri_nanoparticle_simulation_tpu_torch.engine import convert, sim
from mri_nanoparticle_simulation_tpu_torch.engine import decompose as tdec
from mri_nanoparticle_simulation_tpu_torch.io import writer
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox as TBox

torch.set_num_threads(1)

STEP_TOL = 1e-6
PLANE_TOL = 1e-4
SCALES = [0.5, 1.0, 2.0]


def _tp(p):
    return convert.params_from_fields(dataclasses.asdict(p))


@pytest.fixture(scope="module")
def setup():
    # tests/test_decompose.py:30-38
    p = JP.small_test_params(num_water=64, mmoment=2e-14,
                             avoid_intracellular_throw=False)
    return p, JBox(p, seed=3).populate(), _tp(p), TBox(_tp(p), seed=3) \
        .populate()


# -- make_plane_step on seeded record planes ----------------------------------

def _step_inputs(n_sprints=3, wps=10, w=100, w_pad=128, t=2, seed=21):
    """Seeded record planes [n_win, 2, W_pad] with the walk's statistics
    (A drifting by 0.05 a window, B by 0.01, as the record fixture of
    tests/test_torch_decompose.py; the padding walkers hold garbage,
    which the step must leave out), the sign tables of each sprint and
    echo rows."""
    g = np.random.default_rng(seed)
    rec = np.cumsum(g.normal(0.0, 1.0, (n_sprints * wps, 2, w_pad))
                    * np.array([0.05, 0.01])[:, None], 0).astype(np.float32)
    rec[:, :, w:] = 1e3
    u = np.where(g.random(n_sprints * wps) < 0.2, -1.0, 1.0).astype(
        np.float32)
    gb = np.where(g.random((t, n_sprints * wps)) < 0.3, -1.0, 1.0).astype(
        np.float32)
    rows = np.array([[3, 9, 0], [0, 5, 7]], np.int32)
    return rec, u, gb, rows, wps, w


@pytest.mark.parametrize("echo", [False, True], ids=["plain", "echo"])
def test_plane_step_matches_jax(echo):
    rec, u, gb, rows, wps, w = _step_inputs()
    p = JP.small_test_params()
    specs = ((1.5, 1), (0.5, 0)) if echo else ()
    jstep = jdec.make_plane_step(p, w, SCALES, 2, "pallas", jnp.float32,
                                 echo_specs=specs, raw=True)
    tstep = tdec.make_plane_step(_tp(p), w, SCALES, 2, specs, device="cpu")
    jc = (jnp.zeros((2, w), jnp.float32),) * 4 \
        + (jnp.zeros((w,), jnp.float32),) * 2
    tc = (torch.zeros((2, w)),) * 4 + (torch.zeros(w),) * 2
    for i in range(3):
        sl = slice(i * wps, (i + 1) * wps)
        jout = jstep(jnp.asarray(rec[sl].reshape(wps, 2, 1, 128)), jc,
                     jnp.asarray(u[sl]), jnp.asarray(gb[:, sl]),
                     jnp.asarray(rows if echo else np.zeros((0, 1),
                                                            np.int32)))
        tout = tstep(torch.from_numpy(rec[sl]), tc, torch.from_numpy(u[sl]),
                     torch.from_numpy(gb[:, sl]),
                     torch.from_numpy(rows.astype(np.int64)))
        assert len(tout) == len(jout) == (3 if echo else 2)
        jc, tc = jout[0], tout[0]
        for a, b in zip(tc, jc):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=STEP_TOL)
        assert tout[1].shape == (3, 2, wps, 2)
        np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]),
                                   rtol=0, atol=STEP_TOL)
        if echo:
            assert tout[2].shape == (2, 3, w)
            np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]),
                                       rtol=0, atol=STEP_TOL)
    # the Kahan compensation is live: the carried sums are not all exact
    assert torch.any(tc[1] != 0)


def test_plane_step_folds_as_written():
    """One step's fold is exactly y = inc - comp; t = s + y;
    comp = (t - s) - y in float32, on an increment that loses bits."""
    p = _tp(JP.small_test_params())
    step = tdec.make_plane_step(p, 1, [1.0], 1, device="cpu")
    s0 = torch.tensor([[1.0e4]])
    c0 = torch.tensor([[3.0e-4]])
    wins = torch.tensor([[[1.2345e-3], [0.0]]])     # [1, 2, 1]
    carry, _ = step(wins, (s0, c0, s0, c0, torch.zeros(1), torch.zeros(1)),
                    torch.ones(1), torch.ones((1, 1)))
    y = np.float32(1.2345e-3) - np.float32(3.0e-4)
    t = np.float32(1.0e4) + y
    assert carry[0].item() == t
    assert carry[1].item() == np.float32((t - np.float32(1.0e4)) - y)


# -- run_plane_on_device against JAX and the host plane -----------------------

PAIRS = [(1.0, 0.0005), (2.0, 0.001), (1.5, 0.0002)]


@functools.lru_cache(maxsize=None)
def _runs():
    """(port plane, JAX scan plane, port StreamingPlane) of the fixture,
    taucps [0.0005, 0.001], echo pairs PAIRS (0.0002 is a lane of its
    own)."""
    p = JP.small_test_params(num_water=64, mmoment=2e-14,
                             avoid_intracellular_throw=False)
    tp = _tp(p)
    sc, tsc = JBox(p, seed=3).populate(), TBox(tp, seed=3).populate()
    taucps = [p.taucp, 0.001]
    port = tdec.run_plane_on_device(tsc, tp, SCALES, taucps, seed=5,
                                    device="cpu", echo_pairs=PAIRS)
    jax_ = jdec.run_plane_on_device(sc, p, SCALES, taucps, seed=5,
                                    engine="scan", echo_pairs=PAIRS)
    host = tdec.StreamingPlane(tp, tp.t // tp.pfreq, SCALES, taucps,
                               quadrature=True, echo_pairs=PAIRS)
    tdec.run_decomposition(tsc, tp, seed=5, device="cpu", consumer=host)
    return port, jax_, host


def test_plane_matches_jax_scan_engine():
    (tt, tc, ts, _), (jt, jc, js, _), _ = _runs()
    np.testing.assert_array_equal(tt, jt)
    assert tc.shape == jc.shape == (3, 2, 20, 2) and tc.dtype == np.float32
    np.testing.assert_allclose(tc, jc, rtol=0, atol=PLANE_TOL)
    for k in ("steps", "escapes", "coverage_violations"):
        assert ts[k] == js[k], k


def test_plane_matches_the_host_plane():
    (tt, tc, ts, _), _, host = _runs()
    np.testing.assert_allclose(tc, host.result(), rtol=0, atol=PLANE_TOL)
    np.testing.assert_array_equal(tt, host.times_ms)
    assert ts["steps"] == 2000 and ts["sprints"] == 2
    assert ts["wall_s"] > 0 and ts["device_s"] > 0
    assert ts["copy_s"] >= 0 and ts["host_s"] >= 0


def test_plane_matches_jax_pallas_engine(setup):
    p, sc, tp, tsc = setup
    t, c, _, _ = tdec.run_plane_on_device(tsc, tp, [1.0, 2.0], None,
                                          seed=5, device="cpu")
    jt, jc, _, _ = jdec.run_plane_on_device(sc, p, [1.0, 2.0], None,
                                            seed=5, engine="pallas",
                                            interpret=True)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_allclose(c, jc, rtol=0, atol=PLANE_TOL)


def test_plane_on_the_large_scene_branch(setup, monkeypatch):
    """The sprints of the large-scene path (``REBUILD_MAX_MNPS`` -> 0,
    the scene's cache handed to every sprint, as the CLI does) feed the
    plane as they feed the host plane."""
    from mri_nanoparticle_simulation_tpu_torch.engine import cuda_engine
    from mri_nanoparticle_simulation_tpu_torch.fields import expansion
    _, _, tp, tsc = setup
    monkeypatch.setattr(cuda_engine, "REBUILD_MAX_MNPS", 0)
    tbl = convert.mnp_table(tsc.mnps, torch.float32, "cpu")
    cache = expansion.build_cache(tbl.pos, tbl.m, tp)
    _, c, st, _ = tdec.run_plane_on_device(tsc, tp, SCALES, [0.0005, 0.001],
                                           seed=5, device="cpu",
                                           max_steps=1000, cache=cache)
    host = tdec.StreamingPlane(tp, 10, SCALES, [0.0005, 0.001],
                               quadrature=True)
    tdec.run_decomposition(tsc, tp, seed=5, device="cpu", max_steps=1000,
                           consumer=host, cache=cache)
    assert st["steps"] == 1000 and c.shape == (3, 2, 10, 2)
    np.testing.assert_allclose(c, host.result(), rtol=0, atol=PLANE_TOL)


def test_plane_carries_flips_on_sprint_boundaries(setup):
    """The base run's flips land on sprint boundaries here (tcp divides
    sprint_steps), so each sprint's first row pairs the carried previous
    row with u_prev = -1: the s = 1 curve of the base spacing equals
    mean cos(A + B) of the record."""
    _, _, tp, tsc = setup
    assert tp.sprint_steps % tp.tcp == 0
    _, c, _, _ = tdec.run_plane_on_device(tsc, tp, [1.0], None, seed=5,
                                          device="cpu")
    r = tdec.run_decomposition(tsc, tp, seed=5, device="cpu")
    direct = np.mean(np.cos(r.A.astype(np.float64) + r.B), axis=1)
    np.testing.assert_allclose(c[0, 0, :, 0], direct, rtol=0,
                               atol=PLANE_TOL)


@pytest.mark.parametrize("i", range(len(PAIRS)))
def test_echo_capture_matches_host_and_jax(i):
    (_, _, _, te), (_, _, _, je), host = _runs()
    assert len(te) == len(je) == len(PAIRS)
    e, j = te[i], je[i]
    assert (e.scale, e.taucp_ms) == (j.scale, j.taucp_ms) == PAIRS[i]
    times, mat = host.echo_matrix(i)
    np.testing.assert_array_equal(e.times_ms, times)
    np.testing.assert_array_equal(e.times_ms, j.times_ms)
    assert e.cos.shape == (times.size, 64) and e.cos.dtype == np.float64
    np.testing.assert_allclose(e.cos, mat, rtol=0, atol=PLANE_TOL)
    np.testing.assert_allclose(e.cos, j.cos, rtol=0, atol=PLANE_TOL)


def test_echo_taucp_outside_the_plane(setup):
    """An echo taucp absent from the plane's taucps gets a lane of its
    own; the curves cover only the requested taucps."""
    p, sc, tp, tsc = setup
    _, c, _, te = tdec.run_plane_on_device(tsc, tp, [1.0], [tp.taucp],
                                           seed=5, device="cpu",
                                           echo_pairs=[(1.0, 0.001)])
    _, jc, _, je = jdec.run_plane_on_device(sc, p, [1.0], [p.taucp], seed=5,
                                            engine="scan",
                                            echo_pairs=[(1.0, 0.001)])
    assert c.shape == jc.shape == (1, 1, 20, 2)
    np.testing.assert_allclose(c, jc, rtol=0, atol=PLANE_TOL)
    assert te[0].taucp_ms == 0.001
    np.testing.assert_allclose(te[0].cos, je[0].cos, rtol=0, atol=PLANE_TOL)


@pytest.mark.parametrize("case", ["short_run", "echo_outside_run"])
def test_plane_errors_match_jax(setup, case):
    p, sc, tp, tsc = setup
    kw = ({"max_steps": p.sprint_steps - 1} if case == "short_run"
          else {"echo_pairs": [(1.0, p.totaltime)]})
    with pytest.raises(ValueError) as ours:
        tdec.run_plane_on_device(tsc, tp, [1.0], seed=5, device="cpu", **kw)
    with pytest.raises(ValueError) as theirs:
        jdec.run_plane_on_device(sc, p, [1.0], seed=5, engine="scan", **kw)
    assert str(ours.value) == str(theirs.value)
    assert ("needs at least one full sprint" if case == "short_run"
            else "no spin echo") in str(ours.value)


def test_plane_raises_without_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks a box without one")
    _, _, tp, tsc = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdec.run_plane_on_device(tsc, tp, [1.0], seed=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.main(CLI + ["--moment-scales", "1", "--plane-device", "--out",
                        os.devnull])


# -- echo files across packages ------------------------------------------------

def _captures(mod):
    g = np.random.default_rng(7)
    te = np.arange(1, 21) * 0.5
    return [mod.EchoCapture(scale=s, taucp_ms=0.25, times_ms=te,
                            cos=np.exp(-te / t2)[:, None]
                            + g.normal(0, 0.05, (te.size, 32)))
            for s, t2 in ((1.0, 8.0), (2.0, 4.0))]


@pytest.mark.parametrize("writer_mod,reader_mod", [(tdec, jdec), (jdec, tdec)],
                         ids=["port_to_jax", "jax_to_port"])
def test_echo_files_cross_packages(tmp_path, writer_mod, reader_mod):
    caps = _captures(writer_mod)
    path = str(tmp_path / "e.npz")
    writer_mod.save_echoes(path, caps, seed=3)
    back = reader_mod.load_echoes(path)
    assert len(back) == 2
    for b, c in zip(back, caps):
        assert (b.scale, b.taucp_ms) == (c.scale, c.taucp_ms)
        np.testing.assert_array_equal(b.times_ms, c.times_ms)
        assert b.cos.dtype == np.float64
        np.testing.assert_array_equal(b.cos, c.cos.astype(np.float32))
    with np.load(path) as z:
        assert int(z["seed"]) == 3


def test_echo_files_written_alike(tmp_path):
    a, b = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tdec.save_echoes(a, _captures(tdec))
    jdec.save_echoes(b, _captures(jdec))
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_load_echoes_refuses_other_files(tmp_path):
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, A=np.zeros((2, 2)))
    with pytest.raises(ValueError) as ours:
        tdec.load_echoes(bad)
    with pytest.raises(ValueError) as theirs:
        jdec.load_echoes(bad)
    assert str(ours.value) == str(theirs.value)
    assert "not an echo-capture file" in str(ours.value)


# -- the CLI -------------------------------------------------------------------

#: tests/test_sim_io.py:870-876 (the JAX CLI adds --engine scan)
CLI = ["--num-water", "32", "--num-cells", "8", "--totaltime", "0.002",
       "--sprint-steps", "1000", "--chunk-steps", "100", "--near-k", "6",
       "--taucp", "0.001", "--hash-dim", "8", "--mmoment", "3.5e-13",
       "--rng", "threefry"]
GRID = ["--moment-scales", "1,2", "--echo-taucps", "0.001,0.002"]
TAGS = [f"_mscale={s}_taucp={t}.csv" for s in ("1", "2")
        for t in ("0.001", "0.002")]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The port CLI with --stream-plane and with --plane-device
    --dump-echoes --fit-r2, and the JAX CLI with the latter."""
    d = tmp_path_factory.mktemp("plane_cli")
    mp = pytest.MonkeyPatch()
    try:
        from mri_nanoparticle_simulation_tpu.utils import cache as jcache
        mp.setattr(jcache, "enable_compile_cache", lambda *a: None)
        for name, mod, extra in (
                ("host", sim, ["--stream-plane", "--device", "cpu"]),
                ("port", sim, ["--device", "cpu"]),
                ("jax", jsim, ["--engine", "scan"])):
            if name != "host":
                extra = extra + ["--plane-device", "--dump-echoes",
                                 str(d / f"{name}_e.npz"), "--fit-r2",
                                 str(d / f"{name}_r2.csv")]
            assert mod.main(CLI + GRID + extra
                            + ["--out", str(d / f"{name}.csv")]) == 0
    finally:
        mp.undo()
    return d


def test_cli_plane_device_matches_stream_plane(cli_runs):
    for tag in TAGS:
        h = writer.read_t2_csv(str(cli_runs / ("host" + tag)))
        d = writer.read_t2_csv(str(cli_runs / ("port" + tag)))
        np.testing.assert_array_equal(d[0], h[0])
        np.testing.assert_allclose(d[1], h[1], rtol=0, atol=32 * PLANE_TOL)


def test_cli_plane_device_matches_jax_cli(cli_runs):
    for tag in TAGS:
        t = writer.read_t2_csv(str(cli_runs / ("port" + tag)))
        j = writer.read_t2_csv(str(cli_runs / ("jax" + tag)))
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_allclose(t[1], j[1], rtol=0, atol=32 * PLANE_TOL)
    tl = (cli_runs / "port_r2.csv").read_text().splitlines()
    jl = (cli_runs / "jax_r2.csv").read_text().splitlines()
    assert tl[0] == jl[0] and len(tl) == len(jl) == 5
    for a, b in zip(tl[1:], jl[1:]):
        assert a.split(",")[:2] == b.split(",")[:2]


def test_cli_dump_echoes_matches_jax_cli(cli_runs):
    """Grid points without a spin echo inside the 0.002 ms run (taucp
    0.002) are skipped; the other two are captured, and each package
    reads the other's file."""
    ours = tdec.load_echoes(str(cli_runs / "port_e.npz"))
    theirs = tdec.load_echoes(str(cli_runs / "jax_e.npz"))
    assert [(e.scale, e.taucp_ms) for e in ours] == [(1.0, 0.001),
                                                    (2.0, 0.001)]
    assert len(jdec.load_echoes(str(cli_runs / "port_e.npz"))) == 2
    for a, b in zip(ours, theirs):
        assert (a.scale, a.taucp_ms) == (b.scale, b.taucp_ms)
        np.testing.assert_array_equal(a.times_ms, b.times_ms)
        assert a.cos.shape == (1, 32)
        np.testing.assert_allclose(a.cos, b.cos, rtol=0, atol=PLANE_TOL)
    with np.load(cli_runs / "port_e.npz") as z, \
            np.load(cli_runs / "jax_e.npz") as zj:
        assert sorted(z.files) == sorted(zj.files)
        assert int(z["seed"]) == 0


def test_cli_dump_echoes_notes_skipped_points(tmp_path, capsys):
    assert sim.main(CLI + ["--moment-scales", "1", "--echo-taucps",
                           "0.001,0.002", "--plane-device", "--dump-echoes",
                           str(tmp_path / "e.npz"), "--device", "cpu",
                           "--out", str(tmp_path / "t2.csv")]) == 0
    err = capsys.readouterr().err
    assert ("--dump-echoes: skipping mscale=1 taucp=0.002 (no spin echo "
            "inside 0.002 ms)") in err
    assert "Spin-echo capture written" in err
    assert "on-device plane run:" in err
    assert len(tdec.load_echoes(str(tmp_path / "e.npz"))) == 1


# -- the scan engine and walker meshes -------------------------------------------

def test_scan_plane_matches_jax_scan_plane():
    """``run_plane_on_device(engine="scan")``, the scan record (no
    padding), against JAX's scan plane: curves and echo captures within
    PLANE_TOL."""
    p = JP.small_test_params(num_water=64, mmoment=2e-14,
                             avoid_intracellular_throw=False)
    tp = _tp(p)
    tsc = TBox(tp, seed=3).populate()
    tt, tc, ts, te = tdec.run_plane_on_device(
        tsc, tp, SCALES, [p.taucp, 0.001], seed=5, device="cpu",
        engine="scan", echo_pairs=PAIRS)
    jt, jc, js, je = _runs()[1]
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=PLANE_TOL)
    for a, b in zip(te, je):
        np.testing.assert_allclose(a.cos, b.cos, rtol=0, atol=PLANE_TOL)
    for k in ("steps", "escapes", "coverage_violations"):
        assert ts[k] == js[k], k


def _mesh(n):
    from mri_nanoparticle_simulation_tpu_torch.parallel import sharding
    return sharding.make_walker_mesh(["cpu"] * n)


@pytest.mark.parametrize("engine,n", [("pallas", 4), ("pallas", 2),
                                      ("scan", 4)])
def test_sharded_plane_equals_unsharded(setup, engine, n):
    """``run_plane_on_device(mesh=...)``: per-shard carries and one sum
    of the shards' walker means a sprint; curves within 1e-6 of the
    unsharded plane (the grouping of the mean), echo matrices and the
    counters bitwise."""
    _, _, tp, tsc = setup
    kw = dict(seed=5, engine=engine, echo_pairs=PAIRS)
    t0, c0, s0, e0 = tdec.run_plane_on_device(tsc, tp, SCALES,
                                              [0.0005, 0.001],
                                              device="cpu", **kw)
    t1, c1, s1, e1 = tdec.run_plane_on_device(tsc, tp, SCALES,
                                              [0.0005, 0.001],
                                              mesh=_mesh(n), **kw)
    np.testing.assert_array_equal(t1, t0)
    np.testing.assert_allclose(c1, c0, rtol=0, atol=STEP_TOL)
    for a, b in zip(e1, e0):
        np.testing.assert_array_equal(a.cos, b.cos)
    for k in ("steps", "escapes", "coverage_violations"):
        assert s1[k] == s0[k], k


def test_sharded_plane_step_equals_plane_step():
    """``make_sharded_plane_step`` over 4 shards of 25 walkers (each
    record padded to 32 with garbage) against ``make_plane_step`` on the
    unpadded record: carries and echo rows bitwise, blocks within
    1e-6."""
    from mri_nanoparticle_simulation_tpu_torch.parallel import sharding
    rec, u, gb, rows, wps, w = _step_inputs()
    tp = _tp(JP.small_test_params())
    specs = ((1.0, 0), (0.5, 1))
    mesh = _mesh(4)
    whole = tdec.make_plane_step(tp, w, SCALES, 2, specs, device="cpu")
    shard = tdec.make_sharded_plane_step(tp, w, SCALES, 2, mesh, specs)
    lw = w // 4
    carry = (torch.zeros((2, w)),) * 4 + (torch.zeros(w),) * 2
    carries = tuple((torch.zeros((2, lw)),) * 4 + (torch.zeros(lw),) * 2
                    for _ in range(4))
    rep = functools.partial(sharding.replicate, devices=mesh.devices)
    for i in range(3):
        blk = torch.as_tensor(rec[i * wps:(i + 1) * wps])
        parts = []
        for s in range(4):
            pad = torch.full((wps, 2, 32), 1e3)
            pad[:, :, :lw] = blk[:, :, s * lw:(s + 1) * lw]
            parts.append(pad)
        ub = torch.as_tensor(u[i * wps:(i + 1) * wps])
        gbb = torch.as_tensor(gb[:, i * wps:(i + 1) * wps])
        rr = torch.as_tensor(rows)
        carry, b0, e0 = whole(blk, carry, ub, gbb, rr)
        carries, b1, e1 = shard(tuple(parts), carries, rep(ub), rep(gbb),
                                rep(rr))
        np.testing.assert_allclose(b1.numpy(), b0.numpy(), rtol=0,
                                   atol=STEP_TOL)
        np.testing.assert_array_equal(torch.cat(e1, -1).numpy(),
                                      e0.numpy())
        for k in range(6):
            np.testing.assert_array_equal(
                torch.cat([c[k] for c in carries], -1).numpy(),
                carry[k].numpy())


def test_cli_plane_device_shard_walkers_and_scan(tmp_path, capsys):
    """``--plane-device --shard-walkers`` (one CPU shard: the line the
    reference CLI prints, the CSVs of the plain run), and ``--engine
    scan --plane-device`` against the JAX CLI's."""
    from mri_nanoparticle_simulation_tpu.utils import cache as jcache
    base = CLI + GRID + ["--plane-device"]
    assert sim.main(base + ["--device", "cpu", "--out",
                            str(tmp_path / "a.csv")]) == 0
    capsys.readouterr()
    assert sim.main(base + ["--device", "cpu", "--shard-walkers", "--out",
                            str(tmp_path / "b.csv")]) == 0
    assert "Sharding walkers + plane folding over 1 device(s)" in \
        capsys.readouterr().err
    assert sim.main(base + ["--device", "cpu", "--engine", "scan", "--out",
                            str(tmp_path / "s.csv")]) == 0
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jcache, "enable_compile_cache", lambda *a: None)
        assert jsim.main(base + ["--engine", "scan", "--out",
                                 str(tmp_path / "j.csv")]) == 0
    finally:
        mp.undo()
    for tag in TAGS:
        a = (tmp_path / ("a" + tag)).read_bytes()
        assert (tmp_path / ("b" + tag)).read_bytes() == a
        s = writer.read_t2_csv(str(tmp_path / ("s" + tag)))
        j = writer.read_t2_csv(str(tmp_path / ("j" + tag)))
        np.testing.assert_array_equal(s[0], j[0])
        np.testing.assert_allclose(s[1], j[1], rtol=0, atol=32 * PLANE_TOL)

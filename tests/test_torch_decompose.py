"""The port's phase-decomposition path (chunk-kernel mode 1d on the CPU,
through its plain versions) against the JAX package.

* The per-walker (A, B) record of ``decompose.run_decomposition`` on
  Threefry against JAX's Pallas engine (interpret mode) and scan engine,
  with the default physics and each variant, on the rebuild and the
  large-scene branch (``REBUILD_MAX_MNPS`` -> 0 on both sides); a JAX
  sprint's decompose state continued in the port.
* Reconstruction at s in {0.25, 1, 1.7} against direct port runs with
  the moments scaled by s (tests/test_decompose.py:57), on both
  generators (the fast one has no JAX counterpart).
* The float64 reconstruction functions and ``StreamingPlane`` against
  JAX's on one seeded record; ``curves_at_scales`` (float32).
* The CLI against the JAX CLI: file names, Σcos/W, the ``.npz`` record,
  the dispersion table, and the rules of the flags.

Tolerances.  B (the intracellular and gradient kicks) and the positions
follow the reference's own: B within rtol 2e-6, atol 1e-7
(tests/test_decompose.py:81-82), positions within 5e-6
(tests/test_pallas.py:34-36).  A within 1e-5 absolute (|A| <= 1.7 here):
XLA's CPU backend contracts a multiply and an add into one fused
multiply-add (``x + a * b`` jitted equals the fused result on every
input and differs from two roundings on 29% of them), while the port
keeps the reference kernel's uncontracted order, as its CUDA build does
(``--fmad=false``).  Positions then differ by an ulp after some steps,
and the near-dipole field of this fixture's strong moment (2e-14, 570x
the default) amplifies that in A: measured up to 4.3e-6 against both
JAX engines, which agree with each other to 2.4e-7.  The same walk in
float64 is the witness (``test_record_a_gap_is_float32_rounding``): each
float32 record lies ~4e-5 from it, the port no farther than JAX, so the
gap between them is float32 rounding and not a fault of the port.
"""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu import params as JP
from mri_nanoparticle_simulation_tpu import rng as jrng
from mri_nanoparticle_simulation_tpu.engine import decompose as jdec
from mri_nanoparticle_simulation_tpu.engine import pallas_engine as pe
from mri_nanoparticle_simulation_tpu.engine import reference_engine as jre
from mri_nanoparticle_simulation_tpu.engine import sim as jsim
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox as JBox
from mri_nanoparticle_simulation_tpu_torch.engine import (chunk_kernel,
                                                          convert,
                                                          cuda_engine, sim)
from mri_nanoparticle_simulation_tpu_torch.engine import decompose as tdec
from mri_nanoparticle_simulation_tpu_torch.engine.reference_engine import \
    init_state
from mri_nanoparticle_simulation_tpu_torch.io import writer
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox as TBox

torch.set_num_threads(1)

A_TOL = 1e-5
B_TOL = dict(rtol=2e-6, atol=1e-7)
GRADIENT = (1e-4, 0.0, 2e-4)
VARIANTS = {
    "default": lambda p: p,
    "reflection": lambda p: p.with_permeability(),
    "intended_kick": lambda p: p.replace(kick_mode=JP.KICK_INTENDED),
    "sphere_directions": lambda p: p.replace(
        direction_mode=JP.DIRECTION_SPHERE),
    "gradient": lambda p: p.replace(b0_gradient=GRADIENT),
    "all": lambda p: p.replace(
        kick_mode=JP.KICK_INTENDED, direction_mode=JP.DIRECTION_SPHERE,
        b0_gradient=GRADIENT).with_permeability(),
}


def _tp(p):
    """The port's Params of the JAX Params ``p``."""
    return convert.params_from_fields(dataclasses.asdict(p))


def _base():
    # tests/test_decompose.py:30-38: walkers start in cells too, so B and
    # the in-cell paths are active from step 0
    return JP.small_test_params(num_water=64, mmoment=2e-14,
                                avoid_intracellular_throw=False)


def _scaled(scene, s):
    mnps = scene.mnps.copy()
    mnps[:, 4] *= s
    return dataclasses.replace(scene, mnps=mnps)


@pytest.fixture(scope="module")
def setup():
    p = _base()
    return p, JBox(p, seed=3).populate(), _tp(p), TBox(_tp(p), seed=3) \
        .populate()


def _assert_records_close(got, ref):
    assert got.A.shape == ref.A.shape and got.A.dtype == np.float32
    np.testing.assert_allclose(got.A, ref.A, rtol=0, atol=A_TOL)
    np.testing.assert_allclose(got.B, ref.B, **B_TOL)
    np.testing.assert_array_equal(got.times_ms, ref.times_ms)
    for k in ("steps", "escapes", "coverage_violations"):
        assert got.stats[k] == ref.stats[k], k


# (variant, branch, steps): every variant on the rebuild branch, the
# default and every variant at once on the large-scene branch; the
# variants run one sprint (1000 steps, one Carr-Purcell flip)
RECORD_CASES = [("default", "rebuild", None)] + [
    (v, "rebuild", 1000) for v in sorted(VARIANTS) if v != "default"] + [
    ("default", "large", 1000), ("all", "large", 1000)]


CASE_IDS = ["-".join(map(str, c)) for c in RECORD_CASES]


@functools.lru_cache(maxsize=None)
def _record_runs(variant, branch, steps):
    """(params, port record, JAX Pallas record, JAX scan record) of one
    case of RECORD_CASES on the fixture's scene."""
    p0 = _base()
    p = VARIANTS[variant](p0).validate()
    sc, tsc = JBox(p0, seed=3).populate(), TBox(_tp(p0), seed=3).populate()
    mp = pytest.MonkeyPatch()
    if branch == "large":
        mp.setattr(pe, "REBUILD_MAX_MNPS", 0)
        mp.setattr(cuda_engine, "REBUILD_MAX_MNPS", 0)
    try:
        port = tdec.run_decomposition(tsc, _tp(p), seed=5, device="cpu",
                                      rng_impl="threefry", max_steps=steps)
        pallas = jdec.run_decomposition(sc, p, seed=5, engine="pallas",
                                        interpret=True, max_steps=steps)
        scan = jdec.run_decomposition(sc, p, seed=5, engine="scan",
                                      max_steps=steps)
    finally:
        mp.undo()
    return p, port, pallas, scan


@pytest.fixture(scope="module", params=RECORD_CASES, ids=CASE_IDS)
def records(request):
    return _record_runs(*request.param)


def test_record_matches_pallas_engine(records):
    p, port, pallas, _ = records
    assert port.A.shape == (port.stats["steps"] // p.pfreq, p.num_water)
    _assert_records_close(port, pallas)


def test_record_matches_scan_engine(records):
    _, port, _, scan = records
    _assert_records_close(port, scan)
    assert np.any(port.B != 0.0)


def _float64_record_a(tsc, tp, steps):
    """A of the same walk in float64: the port's plain rebuild chunk run
    on float64 state and dipoles, from the same Threefry words."""
    dt = torch.float64
    planes = cuda_engine.to_soa(init_state(tsc.waters, tp, "cpu",
                                           decompose=True), tp).planes.to(dt)
    tbl = convert.mnp_table(tsc.mnps, torch.float32, "cpu").tbl.to(dt)
    args = dict(key=convert.key_words(5), lane_offset=0,
                num_water=tp.num_water, tcp=tp.tcp,
                cell_r2=cuda_engine.cell_r2_f32(tp.cell_r), dstd=1.0,
                phys=cuda_engine.chunk_physics(tp, "threefry"))
    rec = []
    for c in range(steps // tp.chunk_steps):
        planes, _, _, wins = cuda_engine.chunk_reference(
            planes, tbl, step0=c * tp.chunk_steps, decompose=True, **args)
        rec.append(wins[:, 0, :tp.num_water])
    return torch.cat(rec).numpy()


REBUILD_CASES = [c for c in RECORD_CASES if c[1] == "rebuild"]


@pytest.mark.parametrize("case", REBUILD_CASES, ids=[
    i for i, c in zip(CASE_IDS, RECORD_CASES) if c[1] == "rebuild"])
def test_record_a_gap_is_float32_rounding(setup, case):
    """Why A is held at A_TOL and not at B's tolerance: against the same
    walk in float64, the port's A is no farther than JAX's (within 25%),
    and the two float32 records lie within a quarter of that distance of
    each other (measured: 4.27e-5 and 3.88e-5 from float64, 4.3e-6
    apart, on the default case)."""
    p, port, _, scan = _record_runs(*case)
    a64 = _float64_record_a(setup[3], _tp(p), port.stats["steps"])
    e_port = np.abs(port.A - a64).max()
    e_jax = np.abs(scan.A - a64).max()
    gap = np.abs(port.A - scan.A).max()
    assert e_jax > 0 and e_port <= 1.25 * e_jax, (e_port, e_jax)
    assert gap <= 0.25 * e_jax, (gap, e_jax)


def test_record_split_is_reported(records):
    _, port, _, _ = records
    st = port.stats
    assert st["sprints"] >= 1 and st["wall_s"] > 0
    assert st["device_s"] > 0 and st["copy_s"] == 0.0 and st["host_s"] >= 0


def test_jax_decompose_sprint_continues_in_the_port(setup):
    """A JAX Pallas decompose sprint's state (its [2, R, 128] stacks) runs
    its second sprint in the port; the record of that sprint and the
    state agree with JAX's own second sprint."""
    p, sc, tp, _ = setup
    sprint = pe.make_sprint_fn(p, p.num_water, interpret=True,
                               decompose=True)
    kk = jrng.key_from_seed(5)
    key = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
    mp, mm = (jnp.asarray(sc.mnps[:, :3], jnp.float32),
              jnp.asarray(sc.mnps[:, 4], jnp.float32))
    ps1, _ = sprint(mp, mm, key, pe.to_planes(
        jre.init_state(sc.waters, p, decompose=True), p), 0)
    ps2, w2 = sprint(mp, mm, key, ps1, 0)
    host = pe.PlaneState(*(np.asarray(f) for f in ps1))
    ws = convert.state_from_planes(host, p.num_water, "cpu")
    assert ws.phase.shape == (p.num_water, 2)
    tsprint = cuda_engine.make_sprint_fn(tp, tp.num_water, "cpu",
                                         decompose=True)
    ss, wins = tsprint(convert.mnp_table(sc.mnps, torch.float32, "cpu"),
                       convert.key_words(5), cuda_engine.to_soa(ws, tp))
    assert ss.planes.shape == (8, 128) and wins.shape == (10, 2, 128)
    w2 = np.asarray(w2).reshape(10, 2, -1)
    np.testing.assert_allclose(wins[:, 0, :64].numpy(), w2[:, 0, :64],
                               rtol=0, atol=A_TOL)
    np.testing.assert_allclose(wins[:, 1, :64].numpy(), w2[:, 1, :64],
                               **B_TOL)
    ref = convert.state_from_planes(
        pe.PlaneState(*(np.asarray(f) for f in ps2)), p.num_water, "cpu")
    got = cuda_engine.from_soa(ss, p.num_water)
    np.testing.assert_allclose(got.pos.numpy(), ref.pos.numpy(), atol=5e-6)
    np.testing.assert_allclose(got.phase[:, 1].numpy(),
                               ref.phase[:, 1].numpy(), **B_TOL)
    assert got.step == ref.step == 2 * p.sprint_steps


def test_decompose_state_roundtrip_and_scan_state(setup):
    p, sc, tp, _ = setup
    st = jre.init_state(sc.waters, p, decompose=True)
    st = st._replace(
        phase=np.arange(64 * 2, dtype=np.float32).reshape(64, 2),
        phase_comp=np.ones((64, 2), np.float32) * [1, 2])
    ws = convert.state_from_numpy(st, "cpu")
    ss = cuda_engine.to_soa(ws, tp)
    assert ss.planes.shape == (8, 128)
    np.testing.assert_array_equal(ss.planes[4, :64].numpy(), st.phase[:, 0])
    np.testing.assert_array_equal(ss.planes[5, :64].numpy(), 1.0)
    np.testing.assert_array_equal(ss.planes[6, :64].numpy(), st.phase[:, 1])
    np.testing.assert_array_equal(ss.planes[7, :64].numpy(), 2.0)
    back = cuda_engine.from_soa(ss, 64)
    np.testing.assert_array_equal(back.phase.numpy(), st.phase)
    np.testing.assert_array_equal(back.phase_comp.numpy(), st.phase_comp)
    fresh = init_state(sc.waters, tp, "cpu", decompose=True)
    assert fresh.phase.shape == fresh.phase_comp.shape == (64, 2)


def test_chunk_wrappers_check_the_decompose_shapes(setup):
    _, sc, tp, _ = setup
    tbl = convert.mnp_table(sc.mnps, torch.float32, "cpu").tbl
    args = dict(step0=0, key=(1, 2), lane_offset=0, num_water=64,
                tcp=tp.tcp, cell_r2=cuda_engine.cell_r2_f32(tp.cell_r),
                dstd=1.0, phys=cuda_engine.chunk_physics(tp))
    six = cuda_engine.to_soa(init_state(sc.waters, tp, "cpu"), tp).planes
    eight = cuda_engine.to_soa(init_state(sc.waters, tp, "cpu",
                                          decompose=True), tp).planes
    with pytest.raises(ValueError, match=r"state must be \[8, N\]"):
        chunk_kernel.run_chunk(six, tbl, decompose=True, **args)
    with pytest.raises(ValueError, match=r"state must be \[6, N\]"):
        chunk_kernel.run_chunk(eight, tbl, **args)
    out, esc, cov, wins = chunk_kernel.run_chunk(eight, tbl, decompose=True,
                                                 **args)
    assert out.shape == (8, 128) and wins.shape == (1, 2, 128)
    near = torch.zeros((4, tp.near_k, 128))
    with pytest.raises(ValueError, match=r"state must be \[8, N\]"):
        chunk_kernel.run_chunk_near(six, near, torch.zeros((10, 128)),
                                    decompose=True, **args)
    assert chunk_kernel.chunk_mode("chunk_kernel", args["phys"], True) == \
        "chunk_kernel[dec]"
    fast = args["phys"]._replace(fast_rng=True, reflect=True)
    assert chunk_kernel.chunk_mode("chunk_near_kernel", fast, True) == \
        "chunk_near_kernel[fast+variants+dec]"
    assert {k for k in chunk_kernel.LAUNCHES if k.endswith("dec]")} == {
        e + m for e in ("chunk_kernel", "chunk_near_kernel")
        for m in ("[dec]", "[variants+dec]", "[fast+dec]",
                  "[fast+variants+dec]")}


def test_cuda_decomposition_raises_without_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks a box without one")
    _, _, tp, tsc = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdec.run_decomposition(tsc, tp, seed=5)


# -- reconstruction against direct port runs ----------------------------------

@pytest.mark.parametrize("rng_impl", ["threefry", "hardware"])
def test_reconstruction_matches_direct_runs(setup, rng_impl):
    """mean cos(s A + B) against a direct run with the moments scaled by
    s, for s in {0.25, 1, 1.7}; the run crosses Carr-Purcell flips."""
    _, _, tp, tsc = setup
    r = tdec.run_decomposition(tsc, tp, seed=5, device="cpu",
                               rng_impl=rng_impl)
    assert r.A.shape == (tp.t // tp.pfreq, 64) and np.any(r.B != 0.0)
    assert tp.t > tp.tcp                      # flips inside the run
    curves = tdec.curves_at_scales(r.A, r.B, [0.25, 1.0, 1.7])
    for i, s in enumerate((0.25, 1.0, 1.7)):
        _, cos_d, _, _ = cuda_engine.run_simulation(
            _scaled(tsc, s), tp, seed=5, device="cpu", rng_impl=rng_impl)
        rec = np.mean(np.cos(s * r.A.astype(np.float64) + r.B), axis=-1)
        np.testing.assert_allclose(rec, cos_d / 64, atol=5e-5)
        np.testing.assert_allclose(curves[i], cos_d / 64, atol=5e-5)


# -- the float64 reconstruction functions against JAX's -----------------------

@pytest.fixture(scope="module")
def record():
    """A seeded record with the walk's statistics: [40 windows, 300
    walkers], A drifting, B small."""
    g = np.random.default_rng(11)
    a = np.cumsum(g.normal(0.0, 0.05, (40, 300)), 0).astype(np.float32)
    b = np.cumsum(g.normal(0.0, 0.01, (40, 300)), 0).astype(np.float32)
    p = JP.small_test_params(totaltime=0.004, sprint_steps=1000,
                             taucp=0.0005)
    return p, _tp(p), a, b


SCALES = [0.0, 0.5, 1.0, 2.5]
TAUCPS = [0.0001, 0.0003, 0.0005, 0.002]


def test_window_increments_match_jax(record):
    p, tp, a, b = record
    for got, ref in zip(tdec.window_increments(a, b, tp),
                        jdec.window_increments(a, b, p)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("quadrature", [False, True])
def test_reconstruct_curves_and_plane_match_jax(record, quadrature):
    p, tp, a, b = record
    da, db = jdec.window_increments(a, b, p)
    got = tdec.reconstruct_curves(da, db, SCALES, TAUCPS, tp,
                                  quadrature=quadrature)
    ref = jdec.reconstruct_curves(da, db, SCALES, TAUCPS, p,
                                  quadrature=quadrature)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tdec.curves_at_plane(a, b, SCALES, TAUCPS, tp, quadrature),
        jdec.curves_at_plane(a, b, SCALES, TAUCPS, p, quadrature),
        rtol=0, atol=1e-12)


def test_reconstruct_at_schedule_matches_jax(record):
    p, tp, a, b = record
    da, db = jdec.window_increments(a, b, p)
    scheds = [[], [5, 9, 17], list(range(3, 40, 6))]
    np.testing.assert_allclose(
        tdec.reconstruct_at_schedule(da, db, SCALES, scheds, True),
        jdec.reconstruct_at_schedule(da, db, SCALES, scheds, True),
        rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tdec.flip_parity_schedule(40, [5, 9]),
                                  jdec.flip_parity_schedule(40, [5, 9]))
    with pytest.raises(ValueError, match="1-based window indices"):
        tdec.flip_parity_schedule(40, [0])


def _feed(plane, a, b, cuts):
    lo = 0
    for hi in cuts + [len(a)]:
        plane.update(a[lo:hi], b[lo:hi])
        lo = hi


def test_streaming_plane_matches_jax(record):
    p, tp, a, b = record
    pairs = [(1.0, 0.0003), (2.5, 0.0005)]
    ours = tdec.StreamingPlane(tp, 40, SCALES, TAUCPS, quadrature=True,
                               echo_pairs=pairs, row_block=7)
    theirs = jdec.StreamingPlane(p, 40, SCALES, TAUCPS, quadrature=True,
                                 echo_pairs=pairs, row_block=7)
    _feed(ours, a, b, [3, 20, 21])
    _feed(theirs, a, b, [3, 20, 21])
    np.testing.assert_allclose(ours.result(), theirs.result(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(
        ours.result(), jdec.curves_at_plane(a, b, SCALES, TAUCPS, p, True),
        rtol=0, atol=1e-12)
    for i in range(len(pairs)):
        (t1, m1), (t2, m2) = ours.echo_matrix(i), theirs.echo_matrix(i)
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_allclose(m1, m2, rtol=0, atol=1e-12)
    assert ours.config_digest() == theirs.config_digest()


def test_streaming_plane_state_dict_roundtrip(record):
    """A snapshot after 17 rows restores into a fresh plane, which ends
    bitwise where the uninterrupted stream ends; a plane configured
    otherwise refuses it."""
    _, tp, a, b = record
    def plane(**kw):
        return tdec.StreamingPlane(tp, 40, SCALES, TAUCPS, quadrature=True,
                                   echo_pairs=[(1.0, 0.0003)], **kw)
    whole, first = plane(), plane()
    _feed(whole, a, b, [17])
    first.update(a[:17], b[:17])
    snap = {k: np.array(v) for k, v in first.state_dict().items()}
    resumed = plane()
    resumed.load_state(snap)
    resumed.update(a[17:], b[17:])
    np.testing.assert_array_equal(resumed.result(), whole.result())
    np.testing.assert_array_equal(resumed.echo_matrix()[1],
                                  whole.echo_matrix()[1])
    with pytest.raises(ValueError, match="different plane configuration"):
        plane(row_block=5).load_state(snap)
    with pytest.raises(ValueError, match="stream incomplete"):
        first.result()
    with pytest.raises(ValueError, match="stream overflow"):
        whole.update(a[:1], b[:1])


@pytest.mark.parametrize("quadrature", [False, True])
def test_curves_at_scales_matches_jax(record, quadrature):
    _, _, a, b = record
    got = tdec.curves_at_scales(a, b, SCALES, quadrature=quadrature)
    ref = jdec.curves_at_scales(a, b, SCALES, quadrature=quadrature)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    t = tdec.curves_at_scales(torch.from_numpy(a), torch.from_numpy(b),
                              SCALES, quadrature=quadrature)
    np.testing.assert_array_equal(t, got)


# -- the CLI against the JAX CLI ----------------------------------------------

CLI = ["--num-water", "64", "--totaltime", "0.002", "--taucp", "0.001",
       "--chunk-steps", "1000", "--sprint-steps", "1000", "--near-k", "10",
       "--scene-seed", "1", "--seed", "2", "--mmoment", "1e-15"]


def _run_cli(mod, d, extra):
    d.mkdir()
    argv = CLI + ["--moment-scales", "0.5,1", "--echo-taucps",
                  "0.001,0.002", "--dump-record", str(d / "rec"),
                  "--fit-r2", str(d / "r2.csv"), "--out",
                  str(d / "t2.csv")] + extra
    assert mod.main(argv) == 0
    return d


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        from mri_nanoparticle_simulation_tpu.utils import cache as jcache
        mp.setattr(jcache, "enable_compile_cache", lambda *a: None)
        base = tmp_path_factory.mktemp("cli")
        j = _run_cli(jsim, base / "jax", ["--engine", "scan"])
        t = _run_cli(sim, base / "port", ["--rng", "threefry", "--device",
                                          "cpu"])
    finally:
        mp.undo()
    return j, t


def test_cli_writes_the_jax_clis_files(cli_runs):
    j, t = cli_runs
    names = sorted(os.listdir(j))
    assert names == sorted(os.listdir(t))
    csvs = [n for n in names if n.startswith("t2_mscale=")]
    assert csvs == sorted(f"t2_mscale={s}_taucp={c}.csv"
                          for s in ("0.5", "1") for c in ("0.001", "0.002"))
    for n in csvs:
        jr = writer.read_t2_csv(str(j / n))
        tr = writer.read_t2_csv(str(t / n))
        np.testing.assert_array_equal(tr[0], jr[0])
        np.testing.assert_allclose(tr[1] / 64, jr[1] / 64, atol=5e-5)


def test_cli_record_matches_jax(cli_runs):
    j, t = cli_runs
    with np.load(j / "rec.npz") as zj, np.load(t / "rec.npz") as zt:
        assert sorted(zt.files) == sorted(zj.files)
        for k in ("params_fp", "mmoment", "seed", "taucp", "tau", "pfreq",
                  "times_ms"):
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
        assert zt["A"].dtype == zj["A"].dtype
        np.testing.assert_allclose(zt["A"], zj["A"], rtol=0, atol=A_TOL)
        np.testing.assert_allclose(zt["B"], zj["B"], **B_TOL)


def test_cli_dispersion_table_matches_jax(cli_runs):
    j, t = cli_runs
    jl = (j / "r2.csv").read_text().splitlines()
    tl = (t / "r2.csv").read_text().splitlines()
    assert tl[0] == jl[0] and len(tl) == len(jl) == 5
    for a, b in zip(tl[1:], jl[1:]):
        fa, fb = a.split(","), b.split(",")
        assert fa[:2] == fb[:2] and fa[5] == fb[5]
        np.testing.assert_allclose(np.array(fa[2:], float),
                                   np.array(fb[2:], float), rtol=1e-4)


def test_cli_stream_plane_matches_the_record_path(tmp_path):
    argv = CLI + ["--moment-scales", "0.5,1", "--echo-taucps",
                  "0.001,0.002", "--rng", "threefry", "--device", "cpu"]
    assert sim.main(argv + ["--out", str(tmp_path / "r.csv")]) == 0
    assert sim.main(argv + ["--stream-plane",
                            "--out", str(tmp_path / "s.csv")]) == 0
    for s in ("0.5", "1"):
        for c in ("0.001", "0.002"):
            tag = f"_mscale={s}_taucp={c}.csv"
            r = writer.read_t2_csv(str(tmp_path / ("r" + tag)))
            st = writer.read_t2_csv(str(tmp_path / ("s" + tag)))
            np.testing.assert_allclose(st[1], r[1], rtol=0, atol=1e-9)


ERRORS = {
    "fit_r2_without_echoes": ["--fit-r2", "r2.csv"],
    "stream_plane_without_decomposition": ["--stream-plane"],
    "stream_plane_and_dump_record": ["--moment-scales", "1",
                                     "--stream-plane", "--dump-record",
                                     "rec.npz"],
    "dump_record_without_decomposition": ["--dump-record", "rec.npz"],
    "dump_record_missing_directory": ["--moment-scales", "1",
                                      "--dump-record", "no/such/rec.npz"],
    "plane_device_without_decomposition": ["--plane-device"],
    "plane_device_and_stream_plane": ["--moment-scales", "1",
                                      "--plane-device", "--stream-plane"],
    "plane_device_and_dump_record": ["--moment-scales", "1",
                                     "--plane-device", "--dump-record",
                                     "rec.npz"],
    "dump_echoes_without_plane_device": ["--moment-scales", "1",
                                         "--dump-echoes", "e.npz"],
    "dump_echoes_without_a_spin_echo": ["--echo-taucps", "0.002",
                                        "--plane-device", "--dump-echoes",
                                        "e.npz"],
    "scales_not_numbers": ["--moment-scales", "1,x"],
    "echo_spacing_misaligned": ["--echo-taucps", "0.0015"],
    "echo_spacing_below_window": ["--echo-taucps", "0.0005"],
    "scene_file_and_scene_family": ["--scene-file", "cells.csv",
                                    "--scene-family", "fcc"],
    "checkpoint_in_a_decomposition": ["--moment-scales", "1",
                                      "--checkpoint", "c.npz"],
    "resume_with_record_dir": ["--moment-scales", "1", "--record-dir",
                               "rec", "--resume", "c.npz"],
    "record_dir_without_decomposition": ["--record-dir", "rec"],
    "record_dir_and_dump_record": ["--moment-scales", "1", "--record-dir",
                                   "rec", "--dump-record", "rec.npz"],
    "record_dir_and_stream_plane": ["--moment-scales", "1", "--record-dir",
                                    "rec", "--stream-plane"],
    "record_dir_checkpoint_every_alone": ["--moment-scales", "1",
                                          "--record-dir", "rec",
                                          "--checkpoint-every", "2"],
    "record_dir_missing_parent": ["--moment-scales", "1", "--record-dir",
                                  "no/such/rec"],
    "plane_device_and_record_dir": ["--moment-scales", "1",
                                    "--plane-device", "--record-dir",
                                    "rec"],
    "max_retries_negative": ["--max-retries", "-1"],
    "max_retries_without_checkpoint": ["--max-retries", "2"],
    "max_retries_and_resume": ["--max-retries", "2", "--checkpoint",
                               "c.npz", "--checkpoint-every", "1",
                               "--resume", "c.npz"],
    "sweep_and_sweep_grid": ["--sweep", "D", "--sweep-values", "1",
                             "--sweep-grid", "D=1"],
    "checkpoint_in_an_ensemble": ["--ensemble", "2", "--checkpoint",
                                  "c.npz"],
    "max_retries_in_a_sweep": ["--sweep", "D", "--sweep-values", "1",
                               "--max-retries", "1"],
    "resume_in_a_sweep_grid": ["--sweep-grid", "D=1", "--resume", "c.npz"],
    "decomposition_and_ensemble": ["--moment-scales", "1", "--ensemble",
                                   "2"],
    "decomposition_and_sweep": ["--echo-taucps", "0.001", "--sweep", "D",
                                "--sweep-values", "1"],
    "scene_family_in_an_ensemble": ["--scene-family", "fcc", "--ensemble",
                                    "2"],
    "save_scene_in_a_sweep": ["--save-scene", "s.npz", "--sweep", "D",
                              "--sweep-values", "1"],
    "scene_file_in_a_sweep_grid": ["--scene-file", "scene.npz",
                                   "--sweep-grid", "D=1"],
    "paired_without_a_sweep": ["--paired"],
    "fit_t2_without_a_sweep": ["--fit-t2", "fit.csv"],
    "sweep_grid_and_ensemble": ["--sweep-grid", "D=1", "--ensemble", "2"],
    "sweep_without_values": ["--sweep", "D"],
    "sweep_and_ensemble": ["--sweep", "D", "--sweep-values", "1",
                           "--ensemble", "2"],
    "sweep_grid_without_equals": ["--sweep-grid", "D1,2"],
    "sweep_grid_repeated_knob": ["--sweep-grid", "D=1;D=2"],
    "sweep_grid_not_numbers": ["--sweep-grid", "D=1,x"],
    "sweep_grid_d_not_positive": ["--sweep-grid", "D=0,1"],
    "sweep_grid_not_a_launch_scalar": ["--sweep-grid", "num_cells=10,20"],
    "sweep_d_not_positive": ["--sweep", "D", "--sweep-values", "-1"],
    "sweep_p_outside_formulas": ["--sweep", "P", "--sweep-values", "1e6"],
    "sweep_gz_not_numbers": ["--sweep", "Gz", "--sweep-values", "x"],
    "sweep_derived_property": ["--sweep", "tcp", "--sweep-values", "1"],
    "sweep_non_numeric_knob": ["--sweep", "kick_mode", "--sweep-values",
                               "1"],
    "sweep_values_not_numbers": ["--sweep", "cell_r", "--sweep-values",
                                 "0.5,x"],
    "unknown_engine": ["--engine", "eager"],
    "unknown_field_mode": ["--field-mode", "octree"],
    "grid_n_not_a_number": ["--grid-n", "x"],
    "grid_n_below_two": ["--field-mode", "grid", "--grid-n", "1"],
    "grid_field_in_a_decomposition": ["--field-mode", "grid",
                                      "--moment-scales", "1,2"],
    # walker sharding (the reference CLI's sim.py:948-952, 1016-1025)
    "shard_walkers_in_an_ensemble": ["--shard-walkers", "--ensemble", "2"],
    "shard_walkers_in_a_sweep": ["--shard-walkers", "--sweep", "D",
                                 "--sweep-values", "1"],
    "shard_walkers_in_a_record_decomposition": ["--moment-scales", "1",
                                                "--shard-walkers"],
    "walker_shards_below_one": ["--walker-shards", "0", "--ensemble", "2"],
    "walker_shards_on_a_single_run": ["--walker-shards", "2"],
    # the durable and plane flags on the scan engine (sim.py:925-980)
    "scan_record_dir_and_dump_record": ["--engine", "scan",
                                        "--moment-scales", "1",
                                        "--record-dir", "rec",
                                        "--dump-record", "r.npz"],
    "scan_record_dir_and_resume": ["--engine", "scan", "--moment-scales",
                                   "1", "--record-dir", "rec", "--resume",
                                   "c.npz"],
    "scan_stream_plane_and_record_dir": ["--engine", "scan",
                                         "--echo-taucps", "0.001",
                                         "--stream-plane", "--record-dir",
                                         "rec"],
    "scan_plane_device_and_checkpoint": ["--engine", "scan",
                                         "--moment-scales", "1",
                                         "--plane-device", "--checkpoint",
                                         "c.npz"],
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_cli_flag_rules_match_jax(name, tmp_path, monkeypatch, capsys):
    """The same flags fail the same way in both CLIs, before any run:
    ``ap.error`` (exit 2, same message) or ValueError (same message)."""
    monkeypatch.chdir(tmp_path)
    from mri_nanoparticle_simulation_tpu.utils import cache as jcache
    monkeypatch.setattr(jcache, "enable_compile_cache", lambda *a: None)
    argv = CLI + ERRORS[name] + ["--out", "t2.csv"]

    def fail(mod, extra):
        with pytest.raises((SystemExit, ValueError)) as e:
            mod.main(argv + extra)
        if isinstance(e.value, SystemExit):
            assert e.value.code == 2
            return capsys.readouterr().err.splitlines()[-1].split(
                "error: ", 1)[1]
        return f"ValueError: {e.value}"

    assert fail(sim, ["--device", "cpu"]) == fail(jsim, ["--engine", "scan"])
    assert not list(tmp_path.iterdir())       # nothing was written


#: rules about a missing --out, which the table above always passes
ERRORS_WITHOUT_OUT = {
    "max_retries_without_out": ["--max-retries", "2", "--checkpoint",
                                "c.npz", "--checkpoint-every", "1"],
    "resume_without_out": ["--resume", "c.npz"],
}


@pytest.mark.parametrize("name", sorted(ERRORS_WITHOUT_OUT))
def test_cli_out_rules_match_jax(name, tmp_path, monkeypatch, capsys):
    """As ``test_cli_flag_rules_match_jax``, with no --out: the default
    file name holds a timestamp, so a resumed run would not find its
    CSV; both CLIs refuse before any run."""
    monkeypatch.chdir(tmp_path)
    from mri_nanoparticle_simulation_tpu.utils import cache as jcache
    monkeypatch.setattr(jcache, "enable_compile_cache", lambda *a: None)
    msgs = []
    for mod, extra in ((sim, ["--device", "cpu"]),
                       (jsim, ["--engine", "scan"])):
        with pytest.raises(SystemExit) as e:
            mod.main(CLI + ERRORS_WITHOUT_OUT[name] + extra)
        assert e.value.code == 2
        msgs.append(capsys.readouterr().err.splitlines()[-1].split(
            "error: ", 1)[1])
    assert msgs[0] == msgs[1]
    assert not list(tmp_path.iterdir())       # nothing was written

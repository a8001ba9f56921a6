"""The port's physics variants, launch-scalar overrides and fast generator
against the JAX package, on the CPU (the wrappers run their plain
versions).

* Each physics variant (membrane reflection, the intended kick, sphere
  directions, a background gradient, and all four together) on the
  Threefry path against the reference's Pallas engine (interpret mode)
  and scan engine, on the rebuild path and on the large-scene path
  (``REBUILD_MAX_MNPS`` -> 0 on both sides, as tests/test_torch_large.py
  does).  Tolerances of tests/test_pallas.py:34-36: positions within
  5e-6, window sums within 1e-3; in-cell flags, escapes and coverage
  equal.
* The sprint's launch-scalar overrides (tcp, cell_r, d_scale, reflect),
  as tests/test_pallas.py:239-317, 320-381 and 420-479 hold the
  reference's: identity overrides bitwise equal, an override equal to the
  same value compiled in statically, bad values raising.
* The fast generator (the JAX package's hardware-RNG loop with Philox in
  place of the TPU's PRNG), which has no bitwise counterpart in JAX:
  deterministic, its stream keyed by the lane, exact step counting at an
  odd pfreq, and its curve within 5 sqrt(2/W) of the JAX Threefry curve
  (the criterion of tests/test_pallas.py:113-130) with no escapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu import params as P
from mri_nanoparticle_simulation_tpu import rng as jrng
from mri_nanoparticle_simulation_tpu.engine import pallas_engine as pe
from mri_nanoparticle_simulation_tpu.engine import reference_engine as jre
from mri_nanoparticle_simulation_tpu.fields import expansion as jexp
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
from mri_nanoparticle_simulation_tpu_torch.engine import convert, cuda_engine
from mri_nanoparticle_simulation_tpu_torch.engine.reference_engine import \
    init_state

torch.set_num_threads(1)

GRADIENT = (1e-4, 0.0, 2e-4)
VARIANTS = {
    "reflection": lambda p: p.with_permeability(),
    "intended_kick": lambda p: p.replace(kick_mode=P.KICK_INTENDED),
    "sphere_directions": lambda p: p.replace(
        direction_mode=P.DIRECTION_SPHERE),
    "gradient": lambda p: p.replace(b0_gradient=GRADIENT),
    "all": lambda p: p.replace(
        kick_mode=P.KICK_INTENDED, direction_mode=P.DIRECTION_SPHERE,
        b0_gradient=GRADIENT).with_permeability(),
}
# walkers start anywhere (in cells too), so every variant is exercised
IN_CELLS = dict(water_start_bound=7.9, avoid_intracellular_throw=False)


def _variant(name, **base):
    return VARIANTS[name](P.small_test_params(**base)).validate()


def _jax_key(seed):
    kk = jrng.key_from_seed(seed)
    return jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])


def _assert_state_close(got, ref, p):
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos),
                               atol=5e-6)
    np.testing.assert_array_equal(got.in_cell.numpy(),
                                  np.asarray(ref.in_cell))
    assert got.step == int(ref.step) == p.t
    assert int(got.escapes) == int(ref.escapes)
    assert int(got.coverage) == int(ref.coverage)


# -- each variant on the rebuild path -----------------------------------------

@pytest.fixture(scope="module", params=sorted(VARIANTS))
def rebuild_runs(request):
    """The Pallas engine, the scan engine and the port on one variant
    (tests/test_pallas.py:50-70's configuration)."""
    p = _variant(request.param, chunk_steps=100, num_water=32,
                 totaltime=0.0004, sprint_steps=400, **IN_CELLS)
    sc = BacteriaBox(p, seed=3).populate()
    pallas = pe.run_simulation(sc, p, seed=1, dtype=jnp.float32,
                               interpret=True)
    scan = jre.run_simulation(sc, p, seed=1, dtype=jnp.float32)
    port = cuda_engine.run_simulation(sc, p, seed=1, device="cpu")
    return p, pallas, scan, port


def test_variant_matches_pallas_engine(rebuild_runs):
    p, (t1, c1, s1, st1), _, (t2, c2, s2, st2) = rebuild_runs
    np.testing.assert_array_equal(t1, t2)
    _assert_state_close(st2, st1, p)
    np.testing.assert_allclose(c2, c1, atol=1e-3)
    np.testing.assert_allclose(s2, s1, atol=1e-3)


def test_variant_matches_scan_engine(rebuild_runs):
    p, _, (_, c1, s1, st1), (_, c2, s2, st2) = rebuild_runs
    np.testing.assert_allclose(st2.pos.numpy(), np.asarray(st1.pos),
                               atol=5e-6)
    np.testing.assert_allclose(c2, c1, atol=1e-3)
    np.testing.assert_allclose(s2, s1, atol=1e-3)


def test_gradient_leaves_trajectories_unbent():
    """tests/test_gradient.py:77-85: the gradient changes phase only."""
    p0 = P.small_test_params(num_water=32, totaltime=0.0005,
                             sprint_steps=500)
    sc = BacteriaBox(p0, seed=3).populate()
    _, c0, _, st0 = cuda_engine.run_simulation(sc, p0, seed=2, device="cpu")
    _, cg, _, stg = cuda_engine.run_simulation(
        sc, p0.replace(b0_gradient=(0.0, 0.0, 2e-4)), seed=2, device="cpu")
    assert torch.equal(st0.pos, stg.pos)
    assert not torch.equal(st0.phase, stg.phase)
    assert not np.array_equal(c0, cg)


# -- each variant on the large-scene path -------------------------------------

@pytest.fixture(scope="module", params=sorted(VARIANTS))
def large_runs(request):
    """One sprint of the JAX Pallas engine and of the port, both forced
    onto the big-scene path with the same cache (the candidate-model
    route with a far table)."""
    p = _variant(request.param, num_cells=30, cube_hash_dim=4,
                 cube_candidates=16, near_k=4, far_table_order=3,
                 num_water=128, chunk_steps=200, totaltime=0.0004,
                 sprint_steps=400, mmoment=3.5e-15, **IN_CELLS)
    sc = BacteriaBox(p, seed=3).populate()
    mp = jnp.asarray(sc.mnps[:, :3], jnp.float32)
    mM = jnp.asarray(sc.mnps[:, 4], jnp.float32)
    jc = jexp.build_cache(mp, mM, p)
    mpatch = pytest.MonkeyPatch()
    try:
        mpatch.setattr(pe, "REBUILD_MAX_MNPS", 0)
        mpatch.setattr(cuda_engine, "REBUILD_MAX_MNPS", 0)
        ps = pe.to_planes(jre.init_state(sc.waters, p), p)
        ps, jw = pe.make_sprint_fn(p, 128, interpret=True)(
            mp, mM, _jax_key(9), ps, 0, jc)
        ss = cuda_engine.to_soa(init_state(sc.waters, p, "cpu"), p)
        cache = convert.scene_cache_from_numpy(
            np.asarray(jc.payload), np.asarray(jc.far_coeffs), "cpu")
        ss, tw = cuda_engine.make_sprint_fn(p, 128, "cpu")(
            convert.mnp_table(sc.mnps, torch.float32, "cpu"),
            convert.key_words(9), ss, cache=cache)
    finally:
        mpatch.undo()
    return p, (pe.from_planes(ps, 128), np.asarray(jw)), \
        (cuda_engine.from_soa(ss, 128), tw.numpy())


def test_variant_large_path_matches_pallas_sprint(large_runs):
    p, (rst, rw), (st, w) = large_runs
    _assert_state_close(st, rst, p)
    assert w.shape == rw.shape == (p.t // p.pfreq, 2)
    np.testing.assert_allclose(w, rw, atol=1e-3)


# -- launch-scalar overrides --------------------------------------------------

def _sprints(p, sc, seed=9, rng_impl=cuda_engine.RNG_THREEFRY, **over):
    """All of ``p``'s sprints through one port sprint function, with
    launch-scalar overrides ``over``; returns (WalkerState, wins)."""
    sprint = cuda_engine.make_sprint_fn(p, sc.waters.shape[0], "cpu",
                                        rng_impl=rng_impl)
    tbl = convert.mnp_table(sc.mnps, torch.float32, "cpu")
    ss = cuda_engine.to_soa(init_state(sc.waters, p, "cpu"), p)
    outs = []
    for _ in range(p.t // p.sprint_steps):
        ss, wins = sprint(tbl, convert.key_words(seed), ss, **over)
        outs.append(wins)
    return cuda_engine.from_soa(ss, sc.waters.shape[0]), torch.cat(outs)


def _perm_params():
    """tests/test_pallas.py:427-433: D x100 so 500 steps cross many
    membranes."""
    base = P.small_test_params(num_water=64, totaltime=0.0005,
                               sprint_steps=500, **IN_CELLS)
    return base.replace(D_cell=base.D_cell * 100,
                        D_extra=base.D_extra * 100).with_permeability()


def _assert_same_run(a, b):
    (st_a, w_a), (st_b, w_b) = a, b
    assert torch.equal(st_a.pos, st_b.pos)
    assert torch.equal(st_a.phase, st_b.phase)
    assert torch.equal(w_a, w_b)


def test_tcp_and_cell_r_overrides_match_static():
    p = P.small_test_params(num_water=64, totaltime=0.001, sprint_steps=500)
    pv = p.replace(taucp=0.0003, cell_r=0.4).validate()
    sc = BacteriaBox(pv, seed=3).populate()
    _assert_same_run(_sprints(p, sc, tcp=pv.tcp, cell_r=pv.cell_r),
                     _sprints(pv, sc))


def test_identity_overrides_are_bitwise_identical():
    p = _perm_params()
    sc = BacteriaBox(p, seed=5).populate()
    _assert_same_run(
        _sprints(p, sc, tcp=p.tcp, cell_r=p.cell_r, d_scale=1.0,
                 reflect=(p.reflect_io, p.reflect_oi)),
        _sprints(p, sc))


def test_d_scale_override_matches_pallas_engine():
    p = P.small_test_params(num_water=64, totaltime=0.0005,
                            sprint_steps=500)
    sc = BacteriaBox(p, seed=3).populate()
    st, w = _sprints(p, sc, d_scale=0.25)
    sprint = pe.make_sprint_fn(p, 64, interpret=True)
    ps, jw = sprint(jnp.asarray(sc.mnps[:, :3], jnp.float32),
                    jnp.asarray(sc.mnps[:, 4], jnp.float32), _jax_key(9),
                    pe.to_planes(jre.init_state(sc.waters, p), p), 0,
                    d_scale=0.25)
    np.testing.assert_allclose(
        st.pos.numpy(), np.asarray(pe.from_planes(ps, 64).pos), atol=5e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-3)
    st1, _ = _sprints(p, sc)
    assert not torch.equal(st.pos, st1.pos)


@pytest.mark.parametrize("rng_impl", [cuda_engine.RNG_THREEFRY,
                                      cuda_engine.RNG_HARDWARE])
def test_reflect_override_matches_static(rng_impl):
    """(0.9, 0.3) as launch scalars through a sprint built with other
    probabilities equals the same values built in; transparent
    membranes differ (the scalars are live)."""
    p = _perm_params()
    sc = BacteriaBox(p, seed=5).populate()
    dyn = _sprints(p, sc, rng_impl=rng_impl, reflect=(0.9, 0.3))
    _assert_same_run(dyn, _sprints(p.replace(reflect_io=0.9, reflect_oi=0.3),
                                   sc, rng_impl=rng_impl))
    st0, _ = _sprints(p, sc, rng_impl=rng_impl, reflect=(0.0, 0.0))
    assert not torch.equal(dyn[0].pos, st0.pos)


@pytest.mark.parametrize("over, what", [
    (dict(tcp=0), "tcp"), (dict(cell_r=-0.5), "cell_r"),
    (dict(d_scale=-1.0), "d_scale"), (dict(d_scale=0.0), "d_scale"),
    (dict(reflect=(1.5, 0.2)), "reflect_io"),
    (dict(reflect=(0.2, -0.1)), "reflect_oi")])
def test_bad_overrides_raise(over, what):
    p = _perm_params()
    sc = BacteriaBox(p, seed=5).populate()
    with pytest.raises(ValueError, match=what):
        _sprints(p, sc, **over)


def test_reflect_override_needs_reflection_compiled_in():
    p = P.small_test_params(num_water=64, totaltime=0.0005,
                            sprint_steps=500)
    sc = BacteriaBox(p, seed=5).populate()
    with pytest.raises(ValueError, match="reflection enabled"):
        _sprints(p, sc, reflect=(0.5, 0.5))


# -- the fast generator -------------------------------------------------------

def _fast_run(p, sc, seed=7, lane_offset=0):
    sprint = cuda_engine.make_sprint_fn(p, p.num_water, "cpu",
                                        rng_impl=cuda_engine.RNG_HARDWARE)
    tbl = convert.mnp_table(sc.mnps, torch.float32, "cpu")
    ss = cuda_engine.to_soa(init_state(sc.waters, p, "cpu"), p)
    outs = []
    for _ in range(p.t // p.sprint_steps):
        ss, wins = sprint(tbl, convert.key_words(seed), ss,
                          lane_offset=lane_offset)
        outs.append(wins)
    return cuda_engine.from_soa(ss, p.num_water), torch.cat(outs)


@pytest.mark.parametrize("variant", [None, "all"])
def test_fast_path_is_deterministic(variant):
    base = dict(num_water=64, totaltime=0.0004, sprint_steps=400,
                **IN_CELLS)
    p = _variant(variant, **base) if variant else \
        P.small_test_params(**base)
    sc = BacteriaBox(p, seed=3).populate()
    a, b = _fast_run(p, sc), _fast_run(p, sc)
    _assert_same_run(a, b)
    assert torch.isfinite(a[0].pos).all() and torch.isfinite(a[1]).all()
    assert a[0].step == p.t


def test_fast_lane_offset_changes_the_stream():
    p = P.small_test_params(num_water=64, totaltime=0.0002,
                            sprint_steps=200)
    sc = BacteriaBox(p, seed=3).populate()
    st0, _ = _fast_run(p, sc)
    st1, _ = _fast_run(p, sc, lane_offset=64)
    assert not torch.equal(st0.pos, st1.pos)
    # the key changes it too, and Threefry draws another stream again
    st2, _ = _fast_run(p, sc, seed=8)
    st3, _ = _sprints(p, sc, seed=7)
    assert not torch.equal(st0.pos, st2.pos)
    assert not torch.equal(st0.pos, st3.pos)


def test_fast_odd_pfreq_counts_steps_exactly():
    """tests/test_pallas.py:212-236 on the fast path, which the JAX
    package runs only on a TPU: pfreq = 125 pairs 62 step pairs with a
    single trailing step; a constant kick in one big cell makes the
    phase count steps."""
    p = P.Params(num_water=32, num_cells=1, mmoment=0.0,
                 kick_mode=P.KICK_CONSTANT, phase_k=400.0, bound=8.0,
                 cell_r=3.5, water_start_bound=1.0,
                 avoid_intracellular_throw=False, tau=8e-6,
                 totaltime=0.002, taucp=0.001, print_interval=1e-3,
                 sprint_steps=250, chunk_steps=125, near_k=1,
                 hash_dim=4, max_neighbors=4).validate()
    assert p.pfreq % 2 == 1
    sc = BacteriaBox(p, seed=2).populate()
    _, c, _, st = cuda_engine.run_simulation(
        sc, p, seed=8, device="cpu", rng_impl=cuda_engine.RNG_HARDWARE)
    k = p.phase_k * p.tau
    phase, expect = 0.0, []
    for step in range(p.pfreq, p.t + 1, p.pfreq):
        phase += p.pfreq * k
        expect.append(p.num_water * np.cos(phase))
        if step % p.tcp == 0:
            phase = -phase
    np.testing.assert_allclose(c, expect, rtol=1e-5)
    assert st.step == p.t


def test_fast_pfreq_even_not_multiple_of_4_runs():
    """pfreq = 50: step pairs, escapes sampled at every pair."""
    p = P.small_test_params(num_water=64, totaltime=0.0002,
                            print_interval=0.00005, sprint_steps=200,
                            chunk_steps=100, taucp=0.0001)
    assert p.pfreq % 2 == 0 and p.pfreq % 4 != 0
    sc = BacteriaBox(p, seed=3).populate()
    st, w = _fast_run(p, sc)
    assert w.shape == (4, 2) and torch.isfinite(w).all()
    assert (w[:, 0].abs() <= 64).all()
    assert st.step == p.t and int(st.escapes) == 0


def test_fast_curve_matches_jax_threefry_curve():
    """Σcos/W of the fast generator against the JAX Threefry curve on the
    same scene: two independent samples of the same ensemble, so they
    agree within the walker noise, 5 sqrt(2/W) (tests/test_pallas.py:
    113-130); no escapes.  The moment is raised so the curve decays."""
    p = P.small_test_params(num_water=256, totaltime=0.004,
                            sprint_steps=1000, chunk_steps=200,
                            mmoment=3.5e-13)
    sc = BacteriaBox(p, seed=3).populate()
    _, c_fast, _, st = cuda_engine.run_simulation(
        sc, p, seed=7, device="cpu", rng_impl=cuda_engine.RNG_HARDWARE)
    _, c_tf, _, _ = jre.run_simulation(sc, p, seed=7, dtype=jnp.float32)
    d = (c_fast - np.asarray(c_tf)) / p.num_water
    assert np.abs(d).max() < 5.0 * np.sqrt(2.0 / p.num_water)
    assert not np.array_equal(c_fast, np.asarray(c_tf))
    assert c_fast[-1] / p.num_water < 0.97        # it decayed
    assert int(st.escapes) == 0


def test_fast_variants_rebuild_and_large_path_agree(monkeypatch):
    """The fast stream is keyed by step and lane alone, so both paths
    draw the same words: with a cache whose candidates cover every
    dipole (the far table is zero, the partition exact, as
    tests/test_pallas.py:420-452), the large path reproduces the rebuild
    path with every variant on."""
    p = _variant("all", num_water=128, totaltime=0.001, sprint_steps=500,
                 mmoment=3.5e-15, cube_hash_dim=8, far_table_order=3,
                 **IN_CELLS)
    sc = BacteriaBox(p, seed=3).populate()
    assert sc.mnps.shape[0] <= p.cube_candidates
    rebuild = _fast_run(p, sc)
    tbl = convert.mnp_table(sc.mnps, torch.float32, "cpu")
    cache = cuda_engine.expansion.build_cache(tbl.pos, tbl.m, p)
    monkeypatch.setattr(cuda_engine, "REBUILD_MAX_MNPS", 0)
    sprint = cuda_engine.make_sprint_fn(p, 128, "cpu",
                                        rng_impl=cuda_engine.RNG_HARDWARE)
    ss = cuda_engine.to_soa(init_state(sc.waters, p, "cpu"), p)
    outs = []
    for _ in range(p.t // p.sprint_steps):
        ss, wins = sprint(tbl, convert.key_words(7), ss, cache=cache)
        outs.append(wins)
    st = cuda_engine.from_soa(ss, 128)
    np.testing.assert_allclose(st.pos.numpy(), rebuild[0].pos.numpy(),
                               atol=5e-6)
    np.testing.assert_allclose(torch.cat(outs).numpy(),
                               rebuild[1].numpy(), atol=1e-3)
    assert int(st.escapes) == int(rebuild[0].escapes) == 0

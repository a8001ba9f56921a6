"""The port's large-scene path against the JAX package's, on the CPU.

The port runs its plain versions (``expansion.cand_model_reference``,
``expansion.far_sums_reference``, ``cuda_engine.chunk_near_reference``);
the JAX side runs its Pallas kernels in interpret mode under ``jax.jit``,
as tests/test_fields.py:401-404 does.  Inputs are made with NumPy from a
seed, and both sides get the same scene cache (``build_cache`` of the
JAX package, carried over by ``convert.scene_cache_from_numpy``).

Tolerances:

* ``build_cache``: equal member sets per cube, except swaps between
  candidates whose cube-centre d^2 differ by less than 2^-8 of the C-th
  d^2 (bf16 spacing: the selection runs in bfloat16 on a matrix-product
  distance, which a BLAS rounds differently from XLA);
* ``build_planes``: near slots equal (where they differ, the two
  candidates' d^2 tie), taylor within 1e-5 of the largest |component|,
  n_reach equal;
* far sums within 1e-5 relative (tests/test_fields.py:375);
* one near/taylor chunk and whole sprints: positions within 5e-6, window
  sums within 1e-3 (tests/test_pallas.py:34-36), escapes and coverage
  equal.
"""

import dataclasses

import jax
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
from mri_nanoparticle_simulation_tpu_torch.engine import (chunk_kernel,
                                                          convert,
                                                          cuda_engine, sim)
from mri_nanoparticle_simulation_tpu_torch.engine.reference_engine import \
    init_state
from mri_nanoparticle_simulation_tpu_torch.fields import expansion, fartable
from mri_nanoparticle_simulation_tpu_torch.fields.dipole import (
    FIELD_SCALE, bz_taylor_parts)
from mri_nanoparticle_simulation_tpu_torch.io import writer
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox as TBox
from test_torch_far_ids import FAR_RAGGED, far_sums_ids

torch.set_num_threads(1)

KEY = (0x0BADC0DE, 0x12345678)
W = 256


def _params(**over):
    base = dict(num_cells=30, cube_hash_dim=4, cube_candidates=16,
                near_k=4, far_table_order=3)
    base.update(over)
    return P.small_test_params(**base)


def _tp(p):
    """The port's Params of the JAX Params ``p``."""
    return convert.params_from_fields(dataclasses.asdict(p))


def _jax_cache(p, sc, far_table=True):
    mp = jnp.asarray(sc.mnps[:, :3], jnp.float32)
    mM = jnp.asarray(sc.mnps[:, 4], jnp.float32)
    c = jexp.build_cache(mp, mM, p, far_table=far_table)
    return (np.asarray(c.payload),
            None if c.far_coeffs is None else np.asarray(c.far_coeffs))


@pytest.fixture(scope="module")
def scene():
    """Scene, JAX cache as NumPy, and W random in-box anchors."""
    p = _params()
    sc = BacteriaBox(p, seed=3).populate()
    payload, coeffs = _jax_cache(p, sc)
    anchors = np.random.default_rng(0).random((W, 3)).astype(np.float32) \
        * np.float32(p.bound)
    return p, sc, payload, coeffs, anchors


# -- build_cache ---------------------------------------------------------------

def _assert_same_members(got, ref, centers, pos):
    """Equal candidate sets per cube, up to bf16-tie swaps (module doc)."""
    for cube, (g, r) in enumerate(zip(got, ref)):
        diff = set(g.tolist()) ^ set(r.tolist())
        if not diff:
            continue
        d2 = ((pos - centers[cube]) ** 2).sum(1)
        c_th = d2[r].max()
        vals = d2[sorted(diff)]
        assert vals.max() - vals.min() < 2.0 ** -8 * c_th, (cube, diff)


@pytest.mark.parametrize("h, c", [(4, 16), (3, 40)])
def test_build_cache_matches_jax(scene, h, c):
    p, sc, _, _, _ = scene
    p = p.replace(cube_hash_dim=h, cube_candidates=c)
    payload, _ = _jax_cache(p, sc, far_table=False)
    pos = torch.from_numpy(sc.mnps[:, :3].astype(np.float32))
    m = torch.from_numpy(sc.mnps[:, 4].astype(np.float32))
    got = expansion.build_cache(pos, m, _tp(p), far_table=False)
    assert got.far_coeffs is None
    assert got.payload.shape == payload.shape == (h ** 3, c, 5)
    g_idx = got.payload[..., 4].numpy().astype(np.int64)
    r_idx = payload[..., 4].astype(np.int64)
    _assert_same_members(g_idx, r_idx, fartable.cube_centers(h, p.bound),
                         sc.mnps[:, :3].astype(np.float64))
    # each row carries its dipole's position and moment
    np.testing.assert_array_equal(got.payload[..., :3].numpy(),
                                  sc.mnps[g_idx, :3].astype(np.float32))
    np.testing.assert_array_equal(got.payload[..., 3].numpy(),
                                  sc.mnps[g_idx, 4].astype(np.float32))


def test_build_cache_with_table(scene):
    p, sc, _, coeffs, _ = scene
    pos = torch.from_numpy(sc.mnps[:, :3].astype(np.float32))
    m = torch.from_numpy(sc.mnps[:, 4].astype(np.float32))
    got = expansion.build_cache(pos, m, _tp(p))
    assert got.far_coeffs.shape == coeffs.shape
    assert got.far_coeffs.dtype == torch.float32
    # same table to float32 rounding where the candidate sets agree
    np.testing.assert_allclose(got.far_coeffs.numpy(), coeffs, rtol=1e-3,
                               atol=1e-4 * np.abs(coeffs).max())


def test_scene_cache_from_numpy(scene):
    _, _, payload, coeffs, _ = scene
    c = convert.scene_cache_from_numpy(payload, coeffs, "cpu")
    np.testing.assert_array_equal(c.payload.numpy(), payload)
    np.testing.assert_array_equal(c.far_coeffs.numpy(), coeffs)
    assert convert.scene_cache_from_numpy(payload, None, "cpu") \
        .far_coeffs is None


# -- build_planes (kernel 2's plain version) -----------------------------------

@pytest.fixture(scope="module")
def planes_pair(scene):
    p, _, payload, coeffs, anchors = scene
    r2 = expansion.coverage_reach2(_tp(p))
    pl = [jnp.asarray(anchors[:, i].reshape(W // 128, 128))
          for i in range(3)]
    jc = jexp.SceneCache(jnp.asarray(payload), jnp.asarray(coeffs))
    ref = jax.jit(lambda a, b, c: jexp.build_planes(
        a, b, c, p, jc, interpret=True, reach2=r2))(*pl)
    ref = [np.asarray(a).reshape(*a.shape[:-2], W) for a in ref]
    cache = convert.scene_cache_from_numpy(payload, coeffs, "cpu")
    got = expansion.build_planes(torch.from_numpy(anchors.T.copy()), _tp(p),
                                 cache, reach2=r2)
    return p, anchors, ref, got


def test_build_planes_near_slots_match_jax(planes_pair):
    p, anchors, (r_near, _, _), (near, _, _) = planes_pair
    assert near.shape == r_near.shape == (4, p.near_k, W)
    differ = (near.numpy() != r_near).any(0)
    # where slots differ, the two candidates tie in d^2
    for s, w in zip(*np.nonzero(differ)):
        d2 = [((np.asarray(n[:3, s, w]) - anchors[w]) ** 2).sum()
              for n in (near.numpy(), r_near)]
        assert d2[0] == d2[1], (s, w)
    assert differ.mean() < 0.01


def test_build_planes_taylor_and_counts_match_jax(planes_pair):
    _, _, (_, r_taylor, r_cnt), (_, taylor, cnt) = planes_pair
    assert taylor.shape == r_taylor.shape == (10, W)
    for i in range(10):
        scale = np.abs(r_taylor[i]).max()
        np.testing.assert_allclose(taylor[i].numpy(), r_taylor[i], rtol=0,
                                   atol=1e-5 * scale)
    np.testing.assert_array_equal(cnt.numpy(), r_cnt)
    assert cnt.max() > 0


def test_build_planes_rejects_cache_without_table():
    p = _tp(_params(far_table_order=0))
    cache = expansion.SceneCache(torch.zeros((64, 16, 5)), None)
    with pytest.raises(ValueError, match="far table"):
        expansion.build_planes(torch.zeros((3, 128)), p, cache)


# -- far sums (kernel 3's plain version) ---------------------------------------

#: far-sums cases: (walkers, dipoles or None for the scene's own 152).
#: 152 is no multiple of the kernel's sub-tile either; JAX runs the 301
#: walkers of the ragged case padded to 384
FAR_SHAPES = {"scene": (256, None), "ragged": FAR_RAGGED}


def far_sums_inputs(sc, k, shape, bound):
    """(anchors f32 [w, 3], dipole positions f32 [n, 3], moments f32 [n],
    ids int32 [K, w]) of a far-sums case, from a seed: the scene's
    dipoles, or ``n`` placed at random in the box with moments drawn
    around the scene's."""
    w, n = FAR_SHAPES[shape]
    r = np.random.default_rng(k)
    if n is None:
        mp = sc.mnps[:, :3].astype(np.float32)
        mM = sc.mnps[:, 4].astype(np.float32)
    else:
        mp = r.random((n, 3)).astype(np.float32) * np.float32(bound)
        mM = (sc.mnps[0, 4] * r.uniform(0.5, 1.5, n)).astype(np.float32)
    anchors = r.random((w, 3)).astype(np.float32) * np.float32(bound)
    return anchors, mp, mM, far_sums_ids(r, len(mp), k, w)


@pytest.mark.parametrize("shape", list(FAR_SHAPES))
@pytest.mark.parametrize("k", [1, 5, 10, 16])
def test_far_sums_match_jax(scene, k, shape):
    p, sc, _, _, _ = scene
    anchors, mp, mM, idx = far_sums_inputs(sc, k, shape, p.bound)
    w = len(anchors)
    w_jax = -(-w // 128) * 128     # the Pallas kernel takes rows of 128
    a_pad = np.zeros((w_jax, 3), np.float32)
    a_pad[:w] = anchors
    i_pad = np.zeros((w_jax, k), np.int32)
    i_pad[:w] = idx.T
    b0, g, h = jax.jit(lambda a, i: jexp._far_sums_pallas(
        a, jnp.asarray(mp), jnp.asarray(mM), i, interpret=True))(
        jnp.asarray(a_pad), jnp.asarray(i_pad))
    ref = np.concatenate([np.asarray(b0)[None], np.asarray(g).T,
                          np.asarray(h).T])[:, :w]
    tbl = expansion.pack_table(torch.from_numpy(mp), torch.from_numpy(mM))
    got = chunk_kernel.run_far_sums(torch.from_numpy(anchors.T.copy()), tbl,
                                    torch.from_numpy(idx))
    assert got.shape == (10, w)
    for i in range(10):
        a, b = got[i].numpy(), ref[i]
        assert np.abs(a - b).max() / np.abs(b).max() < 1e-5, i


def zeroed_moment_far_sums(anchor, tbl, idx):
    """The far sums as the far-sums kernel leaves the near ids out: the
    moment of an excluded entry zeroed by a select, not its parts
    multiplied by a 0/1 weight; one entry at a time in table order."""
    t = torch.zeros((10, anchor.shape[1]), dtype=anchor.dtype,
                    device=anchor.device)
    for j in range(tbl.shape[1]):
        m = torch.where((idx == j).any(0), torch.zeros_like(tbl[3, j]),
                        tbl[3, j])
        parts = bz_taylor_parts(anchor[0] - tbl[0, j], anchor[1] - tbl[1, j],
                                anchor[2] - tbl[2, j], m)
        t = t + torch.stack(parts)
    return t


@pytest.mark.parametrize("shape", list(FAR_SHAPES))
def test_zeroed_moment_keeps_the_far_sums(scene, shape):
    """For finite parts p * 1 is p and p * 0 is +-0, so zeroing an
    excluded entry's moment gives the plain version's sums bitwise."""
    p, sc, _, _, _ = scene
    anchors, mp, mM, idx = far_sums_inputs(sc, 10, shape, p.bound)
    tbl = expansion.pack_table(torch.from_numpy(mp), torch.from_numpy(mM))
    a, i = torch.from_numpy(anchors.T.copy()), torch.from_numpy(idx)
    ref = expansion.far_sums_reference(a, tbl, i)
    assert torch.equal(zeroed_moment_far_sums(a, tbl, i), ref)


@pytest.mark.parametrize("with_table", [True, False])
def test_build_cube_path_matches_jax(scene, with_table):
    """The cube path against the JAX ``build`` with the Pallas far sums.
    With a far table the port's model is ``build_planes`` (mid sums plus
    the table; its ``build`` refuses such a cache): its exact f32
    selection picks the same near set as the bf16 argmin passes but for
    ties, in ascending order.  Without one, ``build`` with the far sums
    selects as JAX does."""
    p, sc, payload, coeffs, anchors = scene
    if not with_table:
        p = p.replace(far_table_order=0)
        coeffs = None
    mp = sc.mnps[:, :3].astype(np.float32)
    mM = sc.mnps[:, 4].astype(np.float32)
    jc = jexp.SceneCache(jnp.asarray(payload),
                         None if coeffs is None else jnp.asarray(coeffs))
    tp = _tp(p)
    r2 = expansion.coverage_reach2(tp)
    ref = jax.jit(lambda a: jexp.build(
        a, jnp.asarray(mp), jnp.asarray(mM), p, cache=jc, far_impl="pallas",
        interpret=True, reach2=r2))(jnp.asarray(anchors))
    cache = convert.scene_cache_from_numpy(payload, coeffs, "cpu")
    r_pos, r_M = np.asarray(ref.near_pos), np.asarray(ref.near_M)
    if with_table:
        with pytest.raises(ValueError, match="build_planes"):
            expansion.build(torch.from_numpy(anchors), torch.from_numpy(mp),
                            torch.from_numpy(mM), tp, cache=cache)
        near, taylor, cnt = expansion.build_planes(
            torch.from_numpy(anchors.T.copy()), tp, cache, reach2=r2)
        got = dict(b0=taylor[0].numpy(), grad=taylor[1:4].T.numpy(),
                   hess=taylor[4:10].T.numpy(), n_reach=cnt.numpy())
        rows = near.permute(2, 1, 0).numpy()                  # [W, K, 4]
        r_rows = np.concatenate(
            [r_pos, (r_M * np.float32(FIELD_SCALE))[..., None]], -1)
        same = np.array([set(map(tuple, a)) == set(map(tuple, b))
                         for a, b in zip(rows, r_rows)])
        d2 = ((rows[..., :3] - anchors[:, None]) ** 2).sum(-1)
        assert np.all(np.diff(d2, axis=1) >= 0)               # ascending
        for w in np.flatnonzero(~same):   # swaps within bf16 spacing only
            diff = set(map(tuple, rows[w])) ^ set(map(tuple, r_rows[w]))
            dd = [((np.array(t[:3]) - anchors[w]) ** 2).sum() for t in diff]
            assert max(dd) - min(dd) < 2.0 ** -8 * d2[w].max(), w
        assert same.mean() > 0.99
    else:
        nf = expansion.build(torch.from_numpy(anchors), torch.from_numpy(mp),
                             torch.from_numpy(mM), tp, cache=cache,
                             reach2=r2)
        np.testing.assert_array_equal(nf.near_pos.numpy(), r_pos)
        np.testing.assert_array_equal(nf.near_M.numpy(), r_M)
        got = {f: getattr(nf, f).numpy()
               for f in ("b0", "grad", "hess", "n_reach")}
        same = np.ones(W, bool)
    np.testing.assert_array_equal(got["n_reach"], np.asarray(ref.n_reach))
    for f in ("b0", "grad", "hess"):
        a, b = got[f][same], np.asarray(getattr(ref, f))[same]
        assert np.abs(a - b).max() / np.abs(b).max() < 1e-5, f


def test_build_whole_table_path_selects_as_jax(scene):
    """Selection over all N (no cache): the same near sets per walker up
    to ties of the bf16 matrix-product distance; far sums then follow
    from the selection."""
    p, sc, _, _, anchors = scene
    mp = sc.mnps[:, :3].astype(np.float32)
    mM = sc.mnps[:, 4].astype(np.float32)
    ref = jexp.build(jnp.asarray(anchors), jnp.asarray(mp), jnp.asarray(mM),
                     p, far_impl="pallas", interpret=True)
    got = expansion.build(torch.from_numpy(anchors), torch.from_numpy(mp),
                          torch.from_numpy(mM), _tp(p))
    same = [set(map(tuple, a)) == set(map(tuple, b)) for a, b in
            zip(got.near_pos.numpy(), np.asarray(ref.near_pos))]
    assert np.mean(same) > 0.95
    ok = np.array(same)
    b, r_ = got.b0.numpy()[ok], np.asarray(ref.b0)[ok]
    assert np.abs(b - r_).max() / np.abs(r_).max() < 1e-5


# -- one near/taylor chunk (kernel 1c's plain version) -------------------------

@pytest.fixture(scope="module")
def near_chunk(planes_pair):
    """One chunk of the plain 1c version and of the Pallas kernel in
    near/taylor mode, on the same state, near and taylor."""
    p, anchors, (near, taylor, _), _ = planes_pair
    p = p.replace(chunk_steps=200, num_water=W - 6)   # 6 padding walkers
    nw = p.num_water
    scal = np.array([4000, KEY[0], KEY[1], 0, 9, nw, p.tcp,
                     np.float32(cuda_engine.cell_r2_f32(p.cell_r))
                     .view(np.uint32), np.float32(1.0).view(np.uint32), 0, 0],
                    np.uint32)
    state = np.zeros((6, W), np.float32)
    state[:3] = anchors.T
    state[4] = np.random.default_rng(2).uniform(-3, 3, W)
    kern = pe.make_chunk_kernel(p, W // 128, jnp.float32, "threefry",
                                interpret=True, n_mnp_pad=None)
    out = jax.jit(kern)(jnp.asarray(scal),
                        jnp.asarray(state.reshape(6, -1, 128)),
                        jnp.asarray(near.reshape(4, p.near_k, -1, 128)),
                        jnp.asarray(taylor.reshape(10, -1, 128)))
    so, esc, cov, wins = (np.asarray(a) for a in out)
    ref = dict(state=so.reshape(6, W)[:, :nw], esc=esc.reshape(W)[:nw],
               cov=cov.sum(), wins=wins.sum(0))
    got = chunk_kernel.run_chunk_near(
        torch.from_numpy(state), torch.from_numpy(near.copy()),
        torch.from_numpy(taylor.copy()), step0=4000, key=KEY, lane_offset=9,
        num_water=nw, tcp=p.tcp, cell_r2=cuda_engine.cell_r2_f32(p.cell_r),
        dstd=1.0, phys=cuda_engine.chunk_physics(_tp(p)))
    return p, ref, got


def test_chunk_near_state_matches_pallas_kernel(near_chunk):
    p, ref, (state, _, _, _) = near_chunk
    np.testing.assert_allclose(state.numpy()[:, :p.num_water], ref["state"],
                               rtol=0, atol=5e-6)


def test_chunk_near_windows_and_counts_match_pallas_kernel(near_chunk):
    p, ref, (_, esc, cov, wins) = near_chunk
    assert wins.shape == (W // cuda_engine.GROUP, p.chunk_steps // p.pfreq,
                          2)
    np.testing.assert_allclose(wins.sum(0).numpy(), ref["wins"], rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(esc.numpy()[:p.num_water], ref["esc"])
    assert float(esc[p.num_water:].sum()) == 0.0
    assert float(cov.sum()) == ref["cov"] == 0.0


# -- the slice as a whole ------------------------------------------------------

SPRINT_CASES = {"far_table_order_3": 3, "far_table_order_0": 0}


@pytest.fixture(scope="module", params=sorted(SPRINT_CASES))
def sprints(request):
    """The JAX Pallas sprint and the port's sprint, both forced onto the
    big-scene path (REBUILD_MAX_MNPS -> 0, as tests/test_pallas.py:384-417)
    with the same cache: the candidate-model route (order 3) or
    ``build`` with the far sums (order 0)."""
    order = SPRINT_CASES[request.param]
    p = _params(num_water=128, totaltime=0.001, sprint_steps=500,
                mmoment=3.5e-15, far_table_order=order)
    sc = BacteriaBox(p, seed=3).populate()
    payload, coeffs = _jax_cache(p, sc)
    assert (coeffs is None) == (order == 0)
    mp = jnp.asarray(sc.mnps[:, :3], jnp.float32)
    mM = jnp.asarray(sc.mnps[:, 4], jnp.float32)
    jcache = jexp.SceneCache(jnp.asarray(payload),
                             None if coeffs is None else jnp.asarray(coeffs))
    mp_ = pytest.MonkeyPatch()
    try:
        mp_.setattr(pe, "REBUILD_MAX_MNPS", 0)
        mp_.setattr(cuda_engine, "REBUILD_MAX_MNPS", 0)
        jsprint = pe.make_sprint_fn(p, 128, interpret=True)
        kk = jrng.key_from_seed(9)
        key_arr = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
        ps = pe.to_planes(jre.init_state(sc.waters, p), p)
        jw = []
        for _ in range(p.t // p.sprint_steps):
            ps, wins = jsprint(mp, mM, key_arr, ps, 0, jcache)
            jw.append(np.asarray(wins))
        ref = (pe.from_planes(ps, 128), np.concatenate(jw))
        tp = _tp(p)
        tsc = TBox(tp, seed=3).populate()
        tsprint = cuda_engine.make_sprint_fn(tp, 128, "cpu")
        tbl = convert.mnp_table(tsc.mnps, torch.float32, "cpu")
        cache = convert.scene_cache_from_numpy(payload, coeffs, "cpu")
        ss = cuda_engine.to_soa(init_state(tsc.waters, tp, "cpu"), tp)
        tw = []
        for _ in range(p.t // p.sprint_steps):
            ss, wins = tsprint(tbl, convert.key_words(9), ss, cache=cache)
            tw.append(wins.numpy())
        got = (cuda_engine.from_soa(ss, 128), np.concatenate(tw))
    finally:
        mp_.undo()
    return p, ref, got


def test_sprint_positions_match_jax(sprints):
    p, (rst, _), (st, _) = sprints
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(rst.pos),
                               atol=5e-6)
    np.testing.assert_array_equal(st.in_cell.numpy(),
                                  np.asarray(rst.in_cell))
    assert st.step == int(rst.step) == p.t


def test_sprint_windows_and_counts_match_jax(sprints):
    p, (rst, rw), (st, w) = sprints
    assert w.shape == rw.shape == (p.t // p.pfreq, 2)
    np.testing.assert_allclose(w, rw, atol=1e-3)
    assert int(st.escapes) == int(rst.escapes)
    assert int(st.coverage) == int(rst.coverage)


# -- entry points --------------------------------------------------------------

def test_large_scene_takes_cube_path(monkeypatch):
    """A scene of more than REBUILD_MAX_MNPS dipoles runs: the sprint
    builds its model with build_planes over the cache and counts
    coverage there."""
    p = _tp(_params(num_water=128, chunk_steps=100, sprint_steps=100,
                    totaltime=0.0001, far_table_order=2))
    n = cuda_engine.REBUILD_MAX_MNPS + 52
    r = np.random.default_rng(5)
    mnps = np.zeros((n, 5))
    mnps[:, :3] = r.random((n, 3)) * p.bound
    mnps[:, 3] = p.cell_r
    mnps[:, 4] = p.mmoment
    cuda_engine.check_scene(p, n)               # no longer raises
    calls = []
    real = expansion.build_planes

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(expansion, "build_planes", spy)
    tbl = convert.mnp_table(mnps, torch.float32, "cpu")
    cache = expansion.build_cache(tbl.pos, tbl.m, p)
    sprint = cuda_engine.make_sprint_fn(p, 128, "cpu")
    waters = r.random((128, 3)) * p.bound
    ss, wins = sprint(tbl, (0, 1), cuda_engine.to_soa(
        init_state(waters, p, "cpu"), p), cache=cache)
    assert calls == [1]
    assert ss.step == 100 and wins.shape == (1, 2)
    assert torch.isfinite(ss.planes).all()
    assert abs(float(wins[0, 0])) <= 128
    # 2100 dipoles in a 8 µm box: far more than K within reach
    assert int(ss.coverage) > 0


def test_runner_and_cli_take_cube_path_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_engine, "REBUILD_MAX_MNPS", 0)
    monkeypatch.setattr(expansion, "uses_large_path", lambda w, n: True)
    calls = []
    real = expansion.build_planes
    monkeypatch.setattr(expansion, "build_planes",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = tmp_path / "t2.csv"
    rc = sim.main(["--num-water", "64", "--num-cells", "20",
                   "--totaltime", "0.002", "--taucp", "0.001",
                   "--chunk-steps", "1000", "--sprint-steps", "1000",
                   "--near-k", "10", "--cube-candidates", "96",
                   "--far-table-order", "2", "--hash-dim", "20",
                   "--max-neighbors", "13", "--tau", "1e-6",
                   "--scene-seed", "1", "--out", str(out), "--device",
                   "cpu"])
    assert rc == 0
    assert calls == [1, 1]
    t, c = writer.read_t2_csv(str(out))
    np.testing.assert_allclose(t, [1e-3, 2e-3])
    assert np.all(np.abs(c) <= 64) and np.all(np.isfinite(c))


def test_new_wrappers_have_no_fallback(scene):
    p, sc, payload, coeffs, anchors = scene
    p = _tp(p)
    cache = convert.scene_cache_from_numpy(payload, coeffs, "meta")
    before = dict(chunk_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="no candidate-model kernel"):
        expansion.build_planes(torch.zeros((3, 128), device="meta"), p,
                               cache, reach2=1.0)
    with pytest.raises(ValueError, match="no far-sums kernel"):
        chunk_kernel.run_far_sums(torch.zeros((3, 128), device="meta"),
                                  torch.zeros((4, 8), device="meta"),
                                  torch.zeros((2, 128), dtype=torch.int32,
                                              device="meta"))
    with pytest.raises(ValueError, match="no chunk kernel"):
        chunk_kernel.run_chunk_near(
            torch.zeros((6, 128), device="meta"),
            torch.zeros((4, p.near_k, 128), device="meta"),
            torch.zeros((10, 128), device="meta"), step0=0, key=KEY,
            lane_offset=0, num_water=100, tcp=p.tcp, cell_r2=0.3, dstd=1.0,
            phys=cuda_engine.chunk_physics(p))
    with pytest.raises(TypeError, match="int32"):
        chunk_kernel.run_far_sums(torch.zeros((3, 128)), torch.zeros((4, 8)),
                                  torch.zeros((2, 128), dtype=torch.int64))
    with pytest.raises(ValueError, match="does not match order"):
        chunk_kernel.run_cand_model(
            torch.zeros((3, 128)), torch.zeros((64, 16, 5)),
            torch.zeros((64, 10)), near_k=4, order=3, h=4, bound=8.0,
            reach2=1.0)
    assert chunk_kernel.LAUNCHES == before

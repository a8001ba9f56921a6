"""The port's far-field pieces against the JAX package's: the dipole
Taylor parts against the JAX closed forms, the monomial layout, the
per-cube far table (built by truncated Taylor arithmetic here, by nested
``jax.jacfwd`` there) and its polynomial evaluation.  Inputs are made
with NumPy from a seed.

Tolerances: the table within rtol 1e-9 in float64 (two exact methods,
different rounding); the Taylor parts within 1e-12 (float64) and 1e-5
(float32) of each term's scale; the polynomial evaluation within 1e-5 in
float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu import params as P
from mri_nanoparticle_simulation_tpu.fields import dipole as jdipole
from mri_nanoparticle_simulation_tpu.fields import expansion as jexp
from mri_nanoparticle_simulation_tpu.fields import fartable as jfar
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
from mri_nanoparticle_simulation_tpu_torch import params as TP
from mri_nanoparticle_simulation_tpu_torch.fields import dipole, fartable
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox as TBox

torch.set_num_threads(1)


def _displacements(dtype, n=2048, seed=0):
    r = np.random.default_rng(seed)
    d = r.uniform(-3.0, 3.0, size=(3, n))
    d[:, 0] = [0.2, -0.1, 0.05]                      # close to the dipole
    m = r.uniform(-5.0, 5.0, size=n) * 1e-17
    return [a.astype(dtype) for a in (*d, m)]


PARTS = {"dipole_bz": slice(0, 1), "dipole_bz_grad": slice(1, 4),
         "dipole_bz_hessian": slice(4, 10)}


@pytest.mark.parametrize("np_dtype, rtol", [(np.float64, 1e-12),
                                            (np.float32, 1e-5)])
@pytest.mark.parametrize("name", sorted(PARTS))
def test_taylor_parts_match_jax_closed_forms(name, np_dtype, rtol):
    """bz_taylor_parts (M * FIELD_SCALE) against the JAX package's
    dipole_bz / _grad / _hessian (M unscaled)."""
    dx, dy, dz, m = _displacements(np_dtype)
    with jax.enable_x64(np_dtype == np.float64):
        ref = getattr(jdipole, name)(*(jnp.asarray(a) for a in
                                       (dx, dy, dz, m)))
        ref = [np.asarray(v) for v in (ref if isinstance(ref, tuple)
                                       else (ref,))]
    t = [torch.from_numpy(a) for a in (dx, dy, dz, m)]
    got = dipole.bz_taylor_parts(*t[:3], t[3] * dipole.FIELD_SCALE)
    got = got[PARTS[name]]
    assert len(got) == len(ref)
    for r_, g in zip(ref, got):
        assert g.dtype == t[0].dtype
        np.testing.assert_allclose(g.numpy(), r_, rtol=rtol,
                                   atol=rtol * np.abs(r_).max())


@pytest.mark.parametrize("order", range(9))
def test_monomials_match_jax(order):
    assert fartable.monomials(order) == jfar.monomials(order)
    assert fartable.n_coeffs(order) == jfar.n_coeffs(order) == \
        (order + 1) * (order + 2) * (order + 3) // 6


def test_cube_centers_match_jax():
    np.testing.assert_array_equal(fartable.cube_centers(4, 8.0),
                                  jfar.cube_centers(4, 8.0))


@pytest.fixture(scope="module")
def table_scene():
    """A scene whose 64 cubes each keep 8 of its ~150 dipoles as
    candidates, and the candidate ids of the JAX cache (float64).  The
    port's inputs come from the port's own scene, the same arrays."""
    over = dict(num_cells=30, cube_hash_dim=4, cube_candidates=8,
                far_table_order=3)
    p = P.small_test_params(**over)
    sc = BacteriaBox(p, seed=3).populate()
    tsc = TBox(TP.small_test_params(**over), seed=3).populate()
    np.testing.assert_array_equal(tsc.mnps, sc.mnps)
    with jax.enable_x64(True):
        mp = jnp.asarray(sc.mnps[:, :3], jnp.float64)
        mM = jnp.asarray(sc.mnps[:, 4], jnp.float64)
        cache = jexp.build_cache(mp, mM, p, far_table=False)
        cand = np.asarray(cache.payload[..., 4]).astype(np.int32)
    return p, tsc, cand


@pytest.mark.parametrize("order", [1, 2, 3])
def test_build_far_table_matches_jax_f64(table_scene, order):
    p, sc, cand = table_scene
    h = p.cube_hash_dim
    with jax.enable_x64(True):
        ref = np.asarray(jfar.build_far_table(
            jnp.asarray(sc.mnps[:, :3], jnp.float64),
            jnp.asarray(sc.mnps[:, 4], jnp.float64), jnp.asarray(cand), h,
            p.bound, order))
    got = fartable.build_far_table(
        torch.from_numpy(sc.mnps[:, :3].astype(np.float64)),
        torch.from_numpy(sc.mnps[:, 4].astype(np.float64)),
        torch.from_numpy(cand), h, p.bound, order)
    assert got.dtype == torch.float64
    assert got.shape == ref.shape == (h ** 3, fartable.n_coeffs(order))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9, atol=0)


def test_build_far_table_batches_agree(table_scene):
    """The cube batching changes nothing: one cube per batch equals the
    whole lattice at once, bitwise."""
    p, sc, cand = table_scene
    args = (torch.from_numpy(sc.mnps[:, :3].astype(np.float64)),
            torch.from_numpy(sc.mnps[:, 4].astype(np.float64)),
            torch.from_numpy(cand), p.cube_hash_dim, p.bound, 3)
    whole = fartable.build_far_table(*args)
    single = fartable.build_far_table(*args, max_elems=1)
    assert torch.equal(whole, single)


def test_low_coefficients_are_the_taylor_part_sums(table_scene):
    """Degree 0, 1 and 2 coefficients are the value, gradient and Hessian
    (halved on the diagonal) of the beyond-candidates field at the cube
    centre, summed from bz_taylor_parts (an independent check of the
    Taylor arithmetic)."""
    p, sc, cand = table_scene
    h = p.cube_hash_dim
    pos = torch.from_numpy(sc.mnps[:, :3].astype(np.float64))
    m = torch.from_numpy(sc.mnps[:, 4].astype(np.float64))
    co = fartable.build_far_table(pos, m, torch.from_numpy(cand), h,
                                  p.bound, 2)
    centers = torch.from_numpy(fartable.cube_centers(h, p.bound))
    d = centers[:, None, :] - pos[None]
    keep = torch.ones((h ** 3, len(pos)), dtype=torch.float64)
    keep.scatter_(1, torch.from_numpy(cand).long(), 0.0)
    parts = [(c * keep).sum(1) for c in dipole.bz_taylor_parts(
        d[..., 0], d[..., 1], d[..., 2], m * dipole.FIELD_SCALE)]
    b0, g, hs = parts[0], parts[1:4], parts[4:10]
    mons = fartable.monomials(2)
    want = {(0, 0, 0): b0, (1, 0, 0): g[0], (0, 1, 0): g[1],
            (0, 0, 1): g[2], (2, 0, 0): hs[0] / 2, (0, 2, 0): hs[1] / 2,
            (0, 0, 2): hs[2] / 2, (1, 1, 0): hs[3], (1, 0, 1): hs[4],
            (0, 1, 1): hs[5]}
    for t, mon in enumerate(mons):
        torch.testing.assert_close(co[:, t], want[mon], rtol=1e-9,
                                   atol=1e-9 * float(want[mon].abs().max()))


@pytest.mark.parametrize("order", [2, 5])
def test_eval_far_table_matches_jax(order):
    r = np.random.default_rng(order)
    nc = fartable.n_coeffs(order)
    coeffs = r.normal(size=(64, nc)).astype(np.float32)
    e = r.uniform(-1.0, 1.0, size=(64, 3)).astype(np.float32)
    ref = jfar.eval_far_table(jnp.asarray(coeffs), jnp.asarray(e), order)
    got = fartable.eval_far_table_grouped(
        lambda t: torch.from_numpy(coeffs[:, t]), *torch.from_numpy(e).T,
        order)
    got = (got[0], torch.stack(got[1:4], -1), torch.stack(got[4:10], -1))
    for r_, g in zip(ref, got):
        r_ = np.asarray(r_)
        assert g.shape == r_.shape
        np.testing.assert_allclose(g.numpy(), r_, rtol=1e-5,
                                   atol=1e-5 * np.abs(r_).max())
    # the parts add onto given accumulators
    acc = tuple(torch.full((64,), 1.0) for _ in range(10))
    parts = fartable.eval_far_table_grouped(
        lambda t: torch.from_numpy(coeffs[:, t]), *torch.from_numpy(e).T,
        order, accs=acc)
    torch.testing.assert_close(parts[0] - 1.0, got[0])

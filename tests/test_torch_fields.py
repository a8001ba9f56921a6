"""The port's field helpers against the JAX package's: the dipole closed
forms, the K-nearest selection and its exclusion mask, and the NumPy
scene guards.  Inputs are made with NumPy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu import params as P
from mri_nanoparticle_simulation_tpu.fields import dipole as jdipole
from mri_nanoparticle_simulation_tpu.fields import expansion as jexp
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
from mri_nanoparticle_simulation_tpu_torch import params as TP
from mri_nanoparticle_simulation_tpu_torch.fields import dipole, expansion
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox as TBox

torch.set_num_threads(1)


def _displacements(dtype, n=2048, seed=0):
    r = np.random.default_rng(seed)
    d = r.uniform(-3.0, 3.0, size=(3, n))
    d[:, :8] = [[0.0] * 8, [0.0] * 8, [1e-6] * 8]       # r -> 0 clamp arm
    m = r.uniform(-5.0, 5.0, size=n)
    return [a.astype(dtype) for a in (*d, m)]


@pytest.mark.parametrize("np_dtype, t_dtype, rtol", [
    (np.float64, torch.float64, 1e-12),
    (np.float32, torch.float32, 1e-5),
])
def test_bz_taylor_parts_matches_jax(np_dtype, t_dtype, rtol):
    dx, dy, dz, m = _displacements(np_dtype)
    with jax.enable_x64(np_dtype == np.float64):
        ref = [np.asarray(v) for v in jdipole.bz_taylor_parts(
            *(jnp.asarray(a) for a in (dx, dy, dz, m)))]
    got = dipole.bz_taylor_parts(
        *(torch.from_numpy(a) for a in (dx, dy, dz, m)))
    assert len(got) == 10
    for r_, g in zip(ref, got):
        assert g.dtype == t_dtype
        # relative to each term's scale: the Hessian sums cancel, so a
        # term near zero carries the rounding of its larger addends
        scale = np.abs(r_).max()
        np.testing.assert_allclose(g.numpy(), r_, rtol=rtol,
                                   atol=rtol * scale)


@pytest.mark.parametrize("np_dtype, rtol", [(np.float64, 1e-12),
                                            (np.float32, 1e-5)])
def test_dipole_bz_masked_matches_jax(np_dtype, rtol):
    dx, dy, dz, m = _displacements(np_dtype, seed=1)
    m = m * np_dtype(1e-17)
    cell_r = np_dtype(0.55)
    with jax.enable_x64(np_dtype == np.float64):
        ref = np.asarray(jdipole.dipole_bz_masked(
            *(jnp.asarray(a) for a in (dx, dy, dz, m)), cell_r))
    got = dipole.dipole_bz_masked(
        *(torch.from_numpy(a) for a in (dx, dy, dz, m)), cell_r)
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())
    assert (got.numpy() == 0).sum() == (ref == 0).sum() > 0


def _selection_inputs(seed, k=5, w=64, n=40):
    r = np.random.default_rng(seed)
    d2 = r.uniform(0, 10, size=(n, w)).astype(np.float32)
    d2[5] = d2[3]                    # exact ties keep the earlier entry
    d2[17, :10] = d2[2, :10]
    pay = r.uniform(-5, 5, size=(n, 4)).astype(np.float32)
    return d2, pay, k, w, n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sorted_insert_selects_as_jax(seed):
    d2, pay, k, w, n = _selection_inputs(seed)
    # JAX: K-tuples of planes
    jd2 = (jnp.full((w,), 1e30, jnp.float32),) * k
    jf = tuple((jnp.zeros((w,), jnp.float32),) * k for _ in range(4))
    jid = (jnp.full((w,), -1, jnp.int32),) * k
    # port: stacked [K, W] / [4, K, W] slots
    td2 = torch.full((k, w), 1e30)
    tf = torch.zeros((4, k, w))
    tid = torch.full((k, w), -1, dtype=torch.int64)
    for j in range(n):
        jd2, jf, jid = jexp.sorted_insert(
            jd2, jf, jid, jnp.asarray(d2[j]),
            tuple(jnp.float32(v) for v in pay[j]), j)
        td2, tf, tid = expansion.sorted_insert(
            td2, tf, tid, torch.from_numpy(d2[j]),
            torch.from_numpy(pay[j])[:, None], j)
    np.testing.assert_array_equal(tid.numpy(), np.stack(jid))
    np.testing.assert_array_equal(td2.numpy(), np.stack(jd2))
    np.testing.assert_array_equal(
        tf.numpy(), np.stack([np.stack(f) for f in jf]))
    # the K smallest, ascending
    np.testing.assert_array_equal(td2.numpy(), np.sort(d2, 0)[:k])


def test_excluded_weight_matches_jax():
    r = np.random.default_rng(3)
    ids = r.integers(-1, 20, size=(6, 64)).astype(np.int32)
    for j in range(-1, 21):
        ref = np.asarray(jexp.excluded_weight(
            tuple(jnp.asarray(i) for i in ids), j, jnp.float32))
        got = expansion.excluded_weight(torch.from_numpy(ids), j,
                                        torch.float32)
        np.testing.assert_array_equal(got.numpy(), ref)
    # one weight per (candidate, walker) when j is a column of ids
    got = expansion.excluded_weight(torch.from_numpy(ids)[:, None, :],
                                    torch.arange(21)[:, None],
                                    torch.float32)
    assert got.shape == (21, 64)
    assert got[3, 0] == float((ids[:, 0] != 3).all())


@pytest.mark.parametrize("chunk_steps, near_k", [(100, 6), (1000, 2)])
def test_scene_guards_match_jax(chunk_steps, near_k):
    over = dict(chunk_steps=chunk_steps, near_k=near_k, totaltime=0.002,
                sprint_steps=1000)
    p, tp = P.small_test_params(**over), TP.small_test_params(**over)
    sc, tsc = BacteriaBox(p, seed=3).populate(), TBox(tp, seed=3).populate()
    assert expansion.default_travel_bound(tp) == \
        jexp.default_travel_bound(p)
    assert expansion.validate_near_k(tsc.mnps[:, :3], tp) == \
        jexp.validate_near_k(sc.mnps[:, :3], p) >= 1
    # the lattice bound is computed, not only read from the cache
    assert expansion._max_count_bound(
        np.asarray(tsc.mnps[:, :3], np.float64),
        tp.cell_r + expansion.default_travel_bound(tp), tp.bound) == \
        jexp._max_count_bound(
            np.asarray(sc.mnps[:, :3], np.float64),
            p.cell_r + jexp.default_travel_bound(p), p.bound)

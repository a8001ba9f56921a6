"""The candidate-model kernel's pieces on the CPU, against the JAX package.

The kernel (csrc/cand_model_kernel.cu) reads the scene's candidates from
a table in its own layout (``SceneCache.cand_table``), selects by
distance and slot id alone and fetches the winners' rows by slot, skips
the selected candidates in the mid sums, and evaluates the far-table
polynomial with each monomial formed once.  Each of these is held here
against what it replaces, with inputs made by NumPy from a seed:

* the candidate table equals the payload's (x, y, z, M * FIELD_SCALE)
  bitwise, from ``build_cache`` and from ``scene_cache_from_numpy``;
* slot-only insertion and the fetch by slot give the six-array
  insertion's (d^2, slot, x, y, z, M) bitwise, ties included;
* the mid sums without the selected candidates equal the sums of the
  parts times the exclusion weight bitwise;
* the grouped polynomial (``eval_far_table_grouped``) within 1e-5 of the
  JAX package's ``eval_far_table`` (tests/test_torch_fartable.py's
  tolerance), orders 1-8, and added onto given sums;
* ``build_planes`` against the JAX package's (Pallas kernel in interpret
  mode) at the scale-up's K 10, C 32 and order 5: near slots equal but
  where the two candidates' d^2 tie, taylor within 1e-5 of the largest
  |component|, n_reach equal (as tests/test_torch_large.py:160-180);
* the kernel's launch: one wave at the scale-up width at 6 blocks per SM.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mri_nanoparticle_simulation_tpu import params as P
from mri_nanoparticle_simulation_tpu.fields import expansion as jexp
from mri_nanoparticle_simulation_tpu.fields import fartable as jfar
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
from mri_nanoparticle_simulation_tpu_torch.engine import chunk_kernel, convert
from mri_nanoparticle_simulation_tpu_torch.fields import (dipole, expansion,
                                                          fartable)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)

W = 256


def _params(**over):
    """The scale-up's selection (K 10, C 32, order 5) on a small scene."""
    base = dict(num_cells=60, max_neighbors=24, cube_hash_dim=4,
                cube_candidates=32, near_k=10, far_table_order=5)
    base.update(over)
    return P.small_test_params(**base)


def _tp(p):
    return convert.params_from_fields(dataclasses.asdict(p))


@pytest.fixture(scope="module")
def scene():
    """The scene, the JAX cache as NumPy, and W random in-box anchors."""
    p = _params()
    sc = BacteriaBox(p, seed=5).populate()
    c = jexp.build_cache(jnp.asarray(sc.mnps[:, :3], jnp.float32),
                         jnp.asarray(sc.mnps[:, 4], jnp.float32), p)
    anchors = np.random.default_rng(1).random((W, 3)).astype(np.float32) \
        * np.float32(p.bound)
    return p, sc, np.asarray(c.payload), np.asarray(c.far_coeffs), anchors


# -- the candidate table -------------------------------------------------------

@pytest.mark.parametrize("source", ["build_cache", "scene_cache_from_numpy"])
def test_cand_table_is_the_payload_scaled_bitwise(scene, source):
    p, sc, payload, coeffs, _ = scene
    if source == "build_cache":
        cache = expansion.build_cache(
            torch.from_numpy(sc.mnps[:, :3].astype(np.float32)),
            torch.from_numpy(sc.mnps[:, 4].astype(np.float32)), _tp(p))
    else:
        cache = convert.scene_cache_from_numpy(payload, coeffs, "cpu")
    pay = cache.payload.numpy()
    got = cache.cand_table.numpy()
    assert got.shape == (*pay.shape[:2], 4) and got.dtype == np.float32
    assert cache.cand_table.is_contiguous()
    np.testing.assert_array_equal(got[..., :3], pay[..., :3])
    np.testing.assert_array_equal(
        got[..., 3], pay[..., 3] * np.float32(dipole.FIELD_SCALE))


def test_build_planes_needs_the_cand_table(scene):
    p, _, payload, coeffs, anchors = scene
    cache = convert.scene_cache_from_numpy(payload, coeffs, "cpu")
    bare = expansion.SceneCache(cache.payload, cache.far_coeffs)
    with pytest.raises(ValueError, match="candidate table"):
        expansion.build_planes(torch.from_numpy(anchors.T.copy()), _tp(p),
                               bare)


# -- selection by slot ---------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(data=st.data(), k=st.integers(1, 16), c=st.integers(1, 40))
def test_slot_insertion_and_fetch_match_the_six_array_insertion(data, k, c):
    """Candidates with d^2 drawn from few values (so they tie) and some
    rows duplicated outright: the same slots, ids, d^2 and rows."""
    n = 4
    seed = data.draw(st.integers(0, 2 ** 31 - 1))
    r = np.random.default_rng(seed)
    rows = r.normal(size=(4, c, n)).astype(np.float32)
    dup = data.draw(st.integers(0, c - 1))
    rows[:, dup:] = rows[:, :c - dup]
    d2 = r.integers(0, 4, size=(c, n)).astype(np.float32)
    d2[dup:] = d2[:c - dup]
    rows_t, d2_t = torch.from_numpy(rows), torch.from_numpy(d2)
    sd = torch.full((k, n), 1e30)
    fields = torch.zeros((4, k, n))
    ids = torch.full((k, n), -1, dtype=torch.int64)
    sd2, ids2 = sd.clone(), ids.clone()
    for j in range(c):
        sd, fields, ids = expansion.sorted_insert(sd, fields, ids, d2_t[j],
                                                  rows_t[:, j], j)
        sd2, ids2 = expansion.sorted_insert_ids(sd2, ids2, d2_t[j], j)
    assert torch.equal(sd2, sd)
    assert torch.equal(ids2, ids)
    assert torch.equal(expansion.fetch_slots(rows_t, ids2), fields)


def test_skipping_the_selected_equals_the_weighted_sum():
    """The kernel adds the parts of the unselected candidates only, in
    candidate order; the plain version adds every part times its
    exclusion weight.  The sums start at +0, so the two agree bitwise."""
    r = np.random.default_rng(3)
    c, k, n = 32, 10, 512
    d = torch.from_numpy(r.normal(size=(3, c, n)).astype(np.float32))
    m = torch.from_numpy((r.normal(size=(c, n)) * 1e6).astype(np.float32))
    ids = torch.from_numpy(np.stack([r.choice(c, k, replace=False)
                                     for _ in range(n)], 1))
    parts = torch.stack(dipole.bz_taylor_parts(d[0], d[1], d[2], m))
    w = expansion.excluded_weight(ids[:, None, :],
                                  torch.arange(c)[:, None], torch.float32)
    weighted = torch.zeros((10, n))
    skipped = torch.zeros((10, n))
    for j in range(c):
        weighted = weighted + parts[:, j] * w[j]
        skipped = torch.where(w[j] > 0, skipped + parts[:, j], skipped)
    assert torch.equal(skipped, weighted)


# -- the far-table polynomial --------------------------------------------------

@pytest.mark.parametrize("order", range(1, 9))
def test_grouped_far_table_matches_the_reference_and_jax(order):
    r = np.random.default_rng(order)
    nc = fartable.n_coeffs(order)
    coeffs = r.normal(size=(64, nc)).astype(np.float32)
    e = r.uniform(-1.0, 1.0, size=(64, 3)).astype(np.float32)
    get = (lambda t: torch.from_numpy(coeffs[:, t]))
    ex, ey, ez = torch.from_numpy(e).T
    j0, jg, jh = jfar.eval_far_table(jnp.asarray(coeffs), jnp.asarray(e),
                                     order)
    jax_parts = [np.asarray(j0), *np.asarray(jg).T, *np.asarray(jh).T]
    plain = fartable.eval_far_table_grouped(get, ex, ey, ez, order)
    for g, r_ in zip(plain, jax_parts):
        np.testing.assert_allclose(g.numpy(), r_, rtol=1e-5,
                                   atol=1e-5 * np.abs(r_).max())
    # the terms add onto given sums
    acc = tuple(torch.full((64,), 0.5) for _ in range(10))
    got = fartable.eval_far_table_grouped(get, ex, ey, ez, order, accs=acc)
    for g, r_ in zip(got, plain):
        torch.testing.assert_close(g - 0.5, r_)


# -- build_planes at the scale-up's selection ----------------------------------

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


def test_scale_up_selection_near_slots_match_jax(planes_pair):
    p, anchors, (r_near, _, _), (near, _, _) = planes_pair
    assert (p.near_k, p.cube_candidates, p.far_table_order) == (10, 32, 5)
    assert near.shape == r_near.shape == (4, 10, W)
    differ = (near.numpy() != r_near).any(0)
    for s, w in zip(*np.nonzero(differ)):
        d2 = [((np.asarray(n[:3, s, w]) - anchors[w]) ** 2).sum()
              for n in (near.numpy(), r_near)]
        assert d2[0] == d2[1], (s, w)
    assert differ.mean() < 0.01


def test_scale_up_selection_taylor_and_counts_match_jax(planes_pair):
    _, _, (_, r_taylor, r_cnt), (_, taylor, cnt) = planes_pair
    assert taylor.shape == r_taylor.shape == (10, W)
    for i in range(10):
        scale = np.abs(r_taylor[i]).max()
        np.testing.assert_allclose(taylor[i].numpy(), r_taylor[i], rtol=0,
                                   atol=1e-5 * scale)
    np.testing.assert_array_equal(cnt.numpy(), r_cnt)
    assert cnt.max() > 0


# -- the launch ----------------------------------------------------------------

@pytest.mark.parametrize("bps, waves", [(6, 1), (5, 2), (4, 2)])
def test_scale_up_width_is_one_wave_at_six_per_sm(bps, waves):
    info = chunk_kernel.KernelInfo(80, bps, 0, chunk_kernel.BLOCK)
    lay = chunk_kernel.cand_model_layout(100096, 132, info)
    assert (lay.blocks, lay.threads, lay.waves) == (782, 128, waves)
    assert lay.kind == "flat" and lay.gen_warps == 0 and lay.smem == 0


def test_wrapper_checks_the_cand_table():
    args = dict(near_k=4, order=1, h=2, bound=8.0, reach2=1.0)
    with pytest.raises(ValueError, match=r"cand must be \[8, N, 4\]"):
        chunk_kernel.run_cand_model(torch.zeros((3, 128)),
                                    torch.zeros((8, 16, 5)),
                                    torch.zeros((8, 4)), **args)
    with pytest.raises(ValueError, match="near_k=4 outside"):
        chunk_kernel.run_cand_model(torch.zeros((3, 128)),
                                    torch.zeros((8, 3, 4)),
                                    torch.zeros((8, 4)), **args)


def _entry(name, k, flags, regs, spill):
    mangled = (f"_ZN53_GLOBAL__N__98bdcb4d_20_cand_model_kernel_cu_4bfae417"
               f"{name}ILi{k}E{''.join(f'Lb{f}E' for f in flags)}EEvPKf")
    return (f"ptxas info    : Compiling entry function '{mangled}' for "
            f"'sm_90a'\nptxas info    : Function properties for {mangled}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} "
            f"bytes spill loads\nptxas info    : Used {regs} registers\n")


def test_build_log_names_both_candidate_model_kernels():
    """chip_smoke reads registers and spills per kernel from the build
    log: the candidate-model kernel <K, high> under its own name and, for
    order 8, "[order 8]"; the chunk kernels by mode; and the seconds of
    each source's nvcc."""
    log = ("$ nvcc -c -o x.o csrc/cand_model_kernel.cu\n# 35.1 s\n"
           + _entry("cand_model_kernel", 10, "0", 80, 0)
           + _entry("cand_model_kernel", 10, "1", 127, 0)
           + "$ nvcc -c -o y.o csrc/chunk_kernel_fast.cu\n# 53.2 s\n"
           + _entry("chunk_kernel", 5, "100", 86, 4)
           + _entry("far_sums_kernel", 10, "", 48, 0))
    got = cs.ptxas_resources(log)
    assert set(got) == {("cand_model_kernel", 10),
                        ("cand_model_kernel[order 8]", 10),
                        ("chunk_kernel[fast]", 5), ("far_sums_kernel", 10)}
    assert got["cand_model_kernel", 10][0] == 80
    assert got["cand_model_kernel[order 8]", 10][0] == 127
    assert cs.spill_bytes(got["chunk_kernel[fast]", 5][1]) == 4
    assert cs.spill_bytes(got["cand_model_kernel", 10][1]) == 0
    assert cs.compile_seconds(log) == {"cand_model_kernel.cu": 35.1,
                                       "chunk_kernel_fast.cu": 53.2}

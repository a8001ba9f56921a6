"""The port's field grid (``fields/grid.py``) against the JAX package's,
on the CPU, on the scene of tests/test_grid.py.

* ``build_grid``: the resident ids equal (both select on exact f32 d^2,
  first index on ties), the padded payload equal, the corner values
  within f32 rounding of the sums (rtol 1e-5 of the largest corner);
* ``query``: the field within 1e-9 T of JAX's and the residency equal;
* the grid's own accuracy against the exact masked sum (the bounds of
  tests/test_grid.py:34-36) and its agreement with the expansion;
* the resident flags' additive scatter: padding never clears column 0;
* the overflow raise, with JAX's message;
* the fields the grid and the scan engine build on: the closed forms,
  ``expansion.build``'s torch route of the far sums (one pass and in
  blocks) and ``evaluate``, against JAX's ``far_impl="xla"`` build and
  ``evaluate`` (selection equal as sets; sums within f32 rounding).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu import params as P
from mri_nanoparticle_simulation_tpu.fields import expansion as jexp
from mri_nanoparticle_simulation_tpu.fields import grid as jgrid
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
from mri_nanoparticle_simulation_tpu_torch.engine import convert
from mri_nanoparticle_simulation_tpu_torch.fields import dipole as tdipole
from mri_nanoparticle_simulation_tpu_torch.fields import expansion as texp
from mri_nanoparticle_simulation_tpu_torch.fields import grid as tgrid

torch.set_num_threads(1)


def _tp(p):
    return convert.params_from_fields(dataclasses.asdict(p))


@pytest.fixture(scope="module")
def grids():
    p = P.small_test_params(num_cells=12, bound=8.0)
    sc = BacteriaBox(p, seed=4).populate()
    mp = np.asarray(sc.mnps[:, :3], np.float32)
    mM = np.asarray(sc.mnps[:, 4], np.float32)
    jg = jgrid.build_grid(jnp.asarray(mp), jnp.asarray(mM), p, grid_n=24)
    tg = tgrid.build_grid(torch.as_tensor(mp), torch.as_tensor(mM), _tp(p),
                          grid_n=24)
    return p, sc, jg, tg


def test_build_grid_matches_jax(grids):
    _, _, jg, tg = grids
    assert tg.grid_n == jg.grid_n and tg.spacing == jg.spacing
    np.testing.assert_array_equal(tg.res_idx.numpy(), np.asarray(jg.res_idx))
    np.testing.assert_array_equal(tg.res_payload.numpy(),
                                  np.asarray(jg.res_payload))
    jc = np.asarray(jg.corners)
    np.testing.assert_allclose(tg.corners.numpy(), jc,
                               atol=1e-5 * np.abs(jc).max())
    assert (tg.res_idx >= 0).any() and (tg.res_idx < 0).any()


def _probes(p, sc, n, seed, near_cells=False):
    rng = np.random.default_rng(seed)
    if near_cells:
        pos = np.clip(sc.cells[rng.integers(0, p.num_cells, n)]
                      + rng.normal(scale=0.7, size=(n, 3)),
                      0.0, p.bound * (1 - 1e-6))
    else:
        pos = rng.random((n, 3)) * p.bound
    return pos.astype(np.float32)


@pytest.mark.parametrize("near_cells", [False, True])
def test_query_matches_jax(grids, near_cells):
    p, sc, jg, tg = grids
    pos = _probes(p, sc, 800, 0, near_cells)
    jb, ji = jgrid.query(jg, jnp.asarray(pos), p.cell_r)
    tb, ti = tgrid.query(tg, torch.as_tensor(pos), p.cell_r)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-9)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if near_cells:
        assert ti.sum() > 20


def test_query_vs_exact_sum(grids):
    """The grid's own accuracy (tests/test_grid.py:25-37): the trilinear
    far field plus exact residents against the float64 masked sum."""
    p, sc, _, tg = grids
    pos = _probes(p, sc, 800, 0)
    b, _ = tgrid.query(tg, torch.as_tensor(pos), p.cell_r)
    exact = tdipole.total_field_masked(
        torch.as_tensor(pos, dtype=torch.float64),
        torch.as_tensor(sc.mnps[:, :3]), torch.as_tensor(sc.mnps[:, 4]),
        p.cell_r).numpy()
    err = np.abs(b.numpy().astype(np.float64) - exact)
    assert err.max() < 5e-6
    assert err.mean() < 2e-7


def test_grid_agrees_with_expansion(grids):
    """Two independent field implementations of the port agree, as the
    reference's do (tests/test_grid.py:39-49)."""
    p, sc, _, tg = grids
    mp = torch.as_tensor(sc.mnps[:, :3]).float()
    mM = torch.as_tensor(sc.mnps[:, 4]).float()
    anchors = torch.as_tensor(_probes(p, sc, 400, 2))
    nf = texp.build(anchors, mp, mM, _tp(p), far_impl="torch")
    b_exp, inc_exp, _ = texp.evaluate(nf, anchors, torch.tensor(p.cell_r))
    b_grid, inc_grid = tgrid.query(tg, anchors, p.cell_r)
    np.testing.assert_array_equal(inc_exp.numpy(), inc_grid.numpy())
    assert (b_exp - b_grid).abs().max() < 5e-6


def test_padding_cannot_clear_a_resident_flag():
    """A voxel whose resident is dipole 0 and whose list has padding: the
    padded -1 entries land on column 0 with weight 0, so the corners
    still leave dipole 0 out (the reference's additive scatter)."""
    p = _tp(P.small_test_params(num_cells=12, bound=8.0))
    mp = torch.tensor([[1.0, 1.2, 0.7], [7.0, 7.0, 7.0], [1.0, 7.0, 4.0]])
    mM = torch.tensor([1e-15, 1e-15, 1e-15])
    g = tgrid.build_grid(mp, mM, p, grid_n=4, max_residents=3)
    ids = g.res_idx.reshape(-1, 3)
    row = int(torch.nonzero((ids[:, 0] == 0) & (ids[:, 1] == -1))[0])
    centre = (torch.tensor([row // 16, (row // 4) % 4, row % 4]) + 0.5) * 2.0
    corners = centre + (torch.as_tensor(tgrid._CORNERS).float() - 0.5) * 2.0
    others = [j for j in range(3) if j not in ids[row].tolist()]
    d = corners[:, None, :] - mp[others]
    want = tdipole.dipole_bz(d[..., 0], d[..., 1], d[..., 2],
                             mM[others]).sum(-1)
    np.testing.assert_allclose(g.corners.reshape(-1, 8)[row].numpy(),
                               want.numpy(), rtol=1e-5)


def test_resident_overflow_raises_as_jax():
    p = P.small_test_params(num_cells=30, bound=6.0, water_start_bound=4.0)
    sc = BacteriaBox(p, seed=2).populate()
    mp = np.asarray(sc.mnps[:, :3], np.float32)
    mM = np.asarray(sc.mnps[:, 4], np.float32)
    with pytest.raises(ValueError, match="max_residents") as je:
        jgrid.build_grid(jnp.asarray(mp), jnp.asarray(mM), p, grid_n=8,
                         max_residents=2)
    with pytest.raises(ValueError) as te:
        tgrid.build_grid(torch.as_tensor(mp), torch.as_tensor(mM), _tp(p),
                         grid_n=8, max_residents=2)
    assert str(te.value) == str(je.value)


def test_dipole_closed_forms_match_jax():
    """``dipole_bz``, ``dipole_bz_grad`` and ``dipole_bz_hessian`` of the
    port against the JAX package's, and the Hessian traceless."""
    from mri_nanoparticle_simulation_tpu.fields import dipole as jdipole
    rng = np.random.default_rng(5)
    d = rng.uniform(-3, 3, size=(3, 500)).astype(np.float32)
    m = rng.uniform(1e-17, 1e-15, size=500).astype(np.float32)
    for name in ("dipole_bz", "dipole_bz_grad", "dipole_bz_hessian"):
        got = getattr(tdipole, name)(*torch.as_tensor(d), torch.as_tensor(m))
        ref = getattr(jdipole, name)(*jnp.asarray(d), jnp.asarray(m))
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for a, b in zip(got, ref):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b,
                                       atol=2e-6 * np.abs(b).max())
    h = tdipole.dipole_bz_hessian(*torch.as_tensor(d).double(),
                                  torch.as_tensor(m).double())
    assert (h[0] + h[1] + h[2]).abs().max() < 1e-9 * h[2].abs().max()


@pytest.fixture(scope="module")
def models(grids):
    """JAX's and the port's expansion at 300 anchors of the grid scene."""
    p, sc, _, _ = grids
    mp = np.asarray(sc.mnps[:, :3], np.float32)
    mM = np.asarray(sc.mnps[:, 4], np.float32)
    anchors = _probes(p, sc, 300, 7, near_cells=True)
    jnf = jexp.build(jnp.asarray(anchors), jnp.asarray(mp), jnp.asarray(mM),
                     p, reach2=2.0)
    tnf = texp.build(torch.as_tensor(anchors), torch.as_tensor(mp),
                     torch.as_tensor(mM), _tp(p), reach2=2.0,
                     far_impl="torch")
    return p, sc, anchors, jnf, tnf


@pytest.mark.parametrize("blocked", [False, True])
def test_build_torch_route_matches_jax(models, monkeypatch, blocked):
    p, sc, anchors, jnf, tnf = models
    if blocked:
        monkeypatch.setattr(texp, "FAR_ONE_PASS", 0)
        tnf = texp.build(torch.as_tensor(anchors),
                         torch.as_tensor(sc.mnps[:, :3]).float(),
                         torch.as_tensor(sc.mnps[:, 4]).float(), _tp(p),
                         reach2=2.0, far_impl="torch")
    np.testing.assert_array_equal(np.sort(tnf.near_M.numpy(), 1),
                                  np.sort(np.asarray(jnf.near_M), 1))
    np.testing.assert_array_equal(tnf.n_reach.numpy(),
                                  np.asarray(jnf.n_reach))
    for f in ("b0", "grad", "hess"):
        ref = np.asarray(getattr(jnf, f))
        np.testing.assert_allclose(getattr(tnf, f).numpy(), ref,
                                   atol=2e-5 * np.abs(ref).max())
    with pytest.raises(ValueError, match="unknown far_impl"):
        texp.build(torch.as_tensor(anchors), torch.zeros(8, 3),
                   torch.zeros(8), _tp(p), far_impl="xla")


def test_blocked_far_sums_match_jax_blocked(models, monkeypatch):
    """``far_sums_torch`` in blocks against the reference's
    ``_far_sums_blocked`` on the same near ids."""
    p, sc, anchors, jnf, _ = models
    monkeypatch.setattr(texp, "FAR_ONE_PASS", 0)
    mp = np.asarray(sc.mnps[:, :3], np.float32)
    mM = np.asarray(sc.mnps[:, 4], np.float32)
    a = jnp.asarray(anchors)
    d2 = np.sum((anchors[:, None] - mp[None]) ** 2, -1)
    idx = np.argsort(d2, 1)[:, :p.near_k].astype(np.int32)
    jb0, jg, jh = jexp._far_sums_blocked(a, jnp.asarray(mp), jnp.asarray(mM),
                                         jnp.asarray(idx), block=64)
    tb0, tg, th = texp.far_sums_torch(
        torch.as_tensor(anchors), torch.as_tensor(mp), torch.as_tensor(mM),
        torch.as_tensor(idx).long(), block=64)
    for got, ref in ((tb0, jb0), (tg, jg), (th, jh)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=2e-5 * np.abs(ref).max())


def test_evaluate_matches_jax(models):
    p, sc, anchors, jnf, tnf = models
    rng = np.random.default_rng(8)
    pos = (anchors + rng.normal(scale=0.05, size=anchors.shape)).astype(
        np.float32)
    jb, ji, jd = jexp.evaluate(jnf, jnp.asarray(pos), p.cell_r)
    tb, ti, td = texp.evaluate(tnf, torch.as_tensor(pos),
                               torch.tensor(p.cell_r))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.sum() > 10
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb),
                               atol=2e-5 * np.abs(np.asarray(jb)).max())
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)

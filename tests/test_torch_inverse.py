"""The port's ``inverse.py`` against the JAX package's, on the CPU.

* AD through the scan engine: d(curve)/d(moment scale) and
  d(curve)/d(d_scale) by torch autograd against a central finite
  difference of the port's own forward curve and of JAX's (rtol 2e-2,
  tests/test_differentiable.py:55-56), and against ``jax.grad`` on the
  same inputs (rtol 1e-4: the same arithmetic, summed in another
  order); finite with a walker sitting on a dipole;
* ``fit_moment_scale`` and ``fit_diffusion_scale`` against JAX's (Adam:
  ``torch.optim.Adam`` against optax, scales within 1e-4);
* ``make_engine_curve_fn`` on the chunk kernels' plain twin against
  JAX's Pallas engine in interpret mode, and on the scan engine
  (tests/test_pallas.py:34-36: 1e-3 of the sums, so 1e-3 / W here);
* every CRN fit against JAX's on the scan engine, probe for probe
  (probes within 1e-6, the same number); the host searches bitwise;
* the decomposition fits and ``fit_from_record``;
* ``main`` of both packages on the same argv for every method and
  axis (recovered scales within 1e-3), and every rejected combination
  with the same message.
"""

import copy
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu import inverse as jinv
from mri_nanoparticle_simulation_tpu import params as P
from mri_nanoparticle_simulation_tpu.engine import decompose as jdec
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
from mri_nanoparticle_simulation_tpu_torch import inverse as tinv
from mri_nanoparticle_simulation_tpu_torch.engine import convert
from mri_nanoparticle_simulation_tpu_torch.io import writer
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox as TBox

torch.set_num_threads(1)

#: tests/test_differentiable.py's configuration
AD = dict(num_water=32, totaltime=0.0005, sprint_steps=500,
          mmoment=3.5e-15)
#: two sprints, 10 windows, a moment that decays the curve
FIT = dict(num_water=32, totaltime=0.001, sprint_steps=500,
           mmoment=2e-14)


def _tp(p):
    return convert.params_from_fields(dataclasses.asdict(p))


def _scenes(p, seed=4):
    return BacteriaBox(p, seed=seed).populate(), \
        TBox(_tp(p), seed=seed).populate()


def _grad(curve, x, idx=-1):
    t = torch.tensor(x, requires_grad=True)
    curve(t)[idx].backward()
    return float(t.grad)


@pytest.fixture(scope="module")
def ad_setup():
    p = P.small_test_params(**AD)
    return p, *_scenes(p)


@pytest.mark.parametrize("axis", ["moment", "D"])
def test_autograd_matches_finite_difference_and_jax_grad(ad_setup, axis):
    """d(final Σcos φ / W)/d(scale) at 1.0 (moment) and 0.7 (D)."""
    p, jsc, tsc = ad_setup
    make_t, make_j = {"moment": (tinv.make_curve_fn, jinv.make_curve_fn),
                      "D": (tinv.make_diffusion_curve_fn,
                            jinv.make_diffusion_curve_fn)}[axis]
    x0, eps = {"moment": (1.0, 1e-2), "D": (0.7, 1e-2)}[axis]
    tc = make_t(_tp(p), tsc, seed=2, device="cpu")
    jc = make_j(p, jsc, seed=2)
    g = _grad(tc, x0)
    jg = float(jax.grad(lambda s: jc(s)[-1])(jnp.float32(x0)))
    with torch.no_grad():
        fd = (float(tc(x0 + eps)[-1]) - float(tc(x0 - eps)[-1])) / (2 * eps)
    jfd = (float(jc(jnp.float32(x0 + eps))[-1])
           - float(jc(jnp.float32(x0 - eps))[-1])) / (2 * eps)
    assert np.isfinite(g) and abs(g) > 1e-6
    np.testing.assert_allclose(g, jg, rtol=1e-4)
    np.testing.assert_allclose(g, fd, rtol=2e-2)
    np.testing.assert_allclose(g, jfd, rtol=2e-2)


def test_gradient_finite_with_a_walker_on_a_dipole(ad_setup):
    """A walker at a dipole: the masked field's 1.0 guards keep the
    untaken branches out of both passes."""
    p, _, tsc = ad_setup
    sc = copy.copy(tsc)
    sc.waters = tsc.waters.copy()
    sc.waters[0] = tsc.mnps[0, :3]
    sc.waters[1] = tsc.mnps[1, :3] + 1e-4
    for make, x0 in ((tinv.make_diffusion_curve_fn, 0.7),
                     (tinv.make_curve_fn, 1.0)):
        curve = make(_tp(p), sc, seed=2, device="cpu")
        t = torch.tensor(x0, requires_grad=True)
        loss = torch.mean((curve(t) - 0.99) ** 2)
        loss.backward()
        assert torch.isfinite(t.grad)


@pytest.fixture(scope="module")
def fit_setup():
    p = P.small_test_params(**FIT)
    jsc, tsc = _scenes(p, seed=1)
    target = np.asarray(jinv.make_curve_fn(p, jsc, seed=2)(1.4))
    dtarget = np.asarray(jinv.make_diffusion_curve_fn(p, jsc, seed=2)(0.6))
    return p, jsc, tsc, target, dtarget


@pytest.mark.parametrize("axis", ["moment", "D"])
def test_ad_fits_match_jax(fit_setup, axis):
    p, jsc, tsc, target, dtarget = fit_setup
    fn = {"moment": "fit_moment_scale", "D": "fit_diffusion_scale"}[axis]
    tgt = target if axis == "moment" else dtarget
    # one sprint of the two: the fit's loop, at half the cost
    p = p.replace(totaltime=0.0005)
    tgt = tgt[:p.t // p.pfreq]
    kw = dict(seed=2, init_scale=1.0, iters=3, lr=0.05)
    j = getattr(jinv, fn)(tgt, p, jsc, **kw)
    t = getattr(tinv, fn)(tgt, _tp(p), tsc, device="cpu", **kw)
    np.testing.assert_allclose(t.scale_history, j.scale_history, rtol=1e-4)
    np.testing.assert_allclose(t.loss_history, j.loss_history, rtol=1e-3)
    assert abs(t.scale - j.scale) < 1e-4 * j.scale
    if axis == "moment":
        assert t.mmoment == pytest.approx(t.scale * p.mmoment)
        assert 1.0 < t.scale < 1.4         # toward the hidden scale
    else:
        assert np.isnan(t.mmoment) and 0.6 < t.scale < 1.0
    with pytest.raises(ValueError, match="one value per output window"):
        getattr(tinv, fn)(tgt[:-1], _tp(p), tsc, device="cpu", iters=1)


@pytest.mark.parametrize("engine", ["pallas", "scan"])
def test_engine_curve_matches_jax(fit_setup, engine):
    """The kernels' plain twin against JAX's Pallas engine in interpret
    mode, and the scan engines, at every launch scalar at once."""
    p, jsc, tsc, _, _ = fit_setup
    p = p.with_permeability()
    kw = dict(m_scale=1.3, cell_r=0.5, p_expr=2.0)
    jc = jinv.make_engine_curve_fn(p, jsc, seed=2, engine=engine,
                                   interpret=True)
    tc = tinv.make_engine_curve_fn(_tp(p), tsc, seed=2, engine=engine,
                                   device="cpu")
    for d, extra in ((1.0, {}), (0.6, kw)):
        j, t = jc(d, **extra), tc(d, **extra)
        assert t.shape == j.shape == (p.t // p.pfreq,)
        np.testing.assert_allclose(t, j, atol=1e-3 / p.num_water)
    with pytest.raises(ValueError, match="unknown engine"):
        tinv.make_engine_curve_fn(_tp(p), tsc, engine="eager",
                                  device="cpu")


def _crn(fit_setup, name):
    p, jsc, tsc, _, _ = fit_setup
    p = p.replace(mmoment=5e-14, near_k=10)
    jsc, tsc = _scenes(p, seed=1)
    curve = jinv.make_engine_curve_fn(p, jsc, seed=2, engine="scan")
    target, kw = {
        "fit_diffusion_scale_crn": (curve(0.6), dict(bracket=(0.1, 1.0))),
        "fit_cell_radius_crn": (curve(cell_r=0.6), {}),
        "fit_permeability_crn": (None, dict(bracket=(0.5, 50.0))),
        "fit_joint_crn": (curve(0.6, m_scale=1.4), dict(max_evals=12)),
    }[name]
    if target is None:
        pp = p.with_permeability()
        target = jinv.make_engine_curve_fn(pp, jsc, seed=2,
                                           engine="scan")(p_expr=5.0)
    if name != "fit_joint_crn":
        kw["iters"] = 8
    return p, jsc, tsc, target, kw


@pytest.mark.parametrize("name", ["fit_diffusion_scale_crn",
                                  "fit_cell_radius_crn",
                                  "fit_permeability_crn", "fit_joint_crn"])
def test_crn_fits_match_jax(fit_setup, name):
    p, jsc, tsc, target, kw = _crn(fit_setup, name)
    j = getattr(jinv, name)(target, p, jsc, seed=2, engine="scan", **kw)
    t = getattr(tinv, name)(target, _tp(p), tsc, seed=2, engine="scan",
                            device="cpu", **kw)
    for field in j._fields:
        a, b = np.asarray(getattr(t, field)), np.asarray(getattr(j, field))
        if field.endswith("loss") or field == "loss_history":
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=1e-2)
        else:
            assert a.shape == b.shape, field
            np.testing.assert_allclose(a, b, rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("name,kw,msg", [
    ("fit_diffusion_scale_crn", dict(bracket=(1.0, 0.5)), "0 < lo < hi"),
    ("fit_cell_radius_crn", dict(bracket=(0.3, 3.0)), "needs near_k"),
    ("fit_permeability_crn", dict(bracket=(0.1, 1e7)), "."),
    ("fit_joint_crn", dict(d_bracket=(0.0, 1.0)), "d_bracket must"),
])
def test_crn_fits_raise_as_jax(fit_setup, name, kw, msg):
    p, jsc, tsc, target, _ = fit_setup
    with pytest.raises(ValueError, match=msg) as je:
        getattr(jinv, name)(target, p, jsc, engine="scan", **kw)
    with pytest.raises(ValueError) as te:
        getattr(tinv, name)(target, _tp(p), tsc, engine="scan",
                            device="cpu", **kw)
    assert str(te.value) == str(je.value)


def test_host_searches_bitwise_jax():
    """The golden-section and Nelder-Mead searches probe the same points
    as the reference's on the same loss."""
    def probes(mod, search):
        seen = []

        def loss(x):
            x = np.atleast_1d(x)
            seen.append(x.copy())
            return float(np.sum((x - np.array([0.3, -1.2])[:x.size]) ** 2))
        if search == "golden":
            mod._golden_log_search(loss, 0.1, 5.0, 15)
        else:
            mod._nelder_mead(loss, np.array([0.0, 0.0]),
                             np.array([0.5, 0.5]), 40)
        return np.concatenate(seen)
    for search in ("golden", "nm"):
        np.testing.assert_array_equal(probes(tinv, search),
                                      probes(jinv, search))


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    p = P.small_test_params(**FIT)
    sc = BacteriaBox(p, seed=1).populate()
    rec = jdec.run_decomposition(sc, p, seed=2, engine="scan")
    target = np.mean(np.cos(1.4 * rec.A + rec.B), -1)
    d = tmp_path_factory.mktemp("rec")
    np.savez(d / "rec.npz", A=rec.A, B=rec.B, times_ms=rec.times_ms,
             mmoment=p.mmoment)
    with writer.T2CsvWriter(str(d / "t.csv"), _tp(p)) as w:
        w.append_windows(0, np.stack([target * p.num_water,
                                      np.zeros_like(target)], -1))
    return p, rec, target, d


def test_decomposed_fit_matches_jax(record):
    p, rec, target, _ = record
    kw = dict(mmoment=p.mmoment, init_scale=1.0, iters=150, lr=0.1)
    j = jinv.fit_moment_scale_decomposed(target, rec.A, rec.B, **kw)
    t = tinv.fit_moment_scale_decomposed(target, rec.A, rec.B,
                                         device="cpu", **kw)
    np.testing.assert_allclose(t.scale_history, j.scale_history, rtol=1e-3)
    assert abs(t.scale - 1.4) < 1e-3 and abs(j.scale - 1.4) < 1e-3
    assert t.mmoment == pytest.approx(t.scale * p.mmoment)
    with pytest.raises(ValueError, match="init_scale must be > 0"):
        tinv.fit_moment_scale_decomposed(target, rec.A, rec.B,
                                         init_scale=0.0, device="cpu")


def test_fit_from_record_matches_jax(record):
    _, _, _, d = record
    j = jinv.fit_from_record(str(d / "rec.npz"), str(d / "t.csv"),
                             iters=150)
    t = tinv.fit_from_record(str(d / "rec.npz"), str(d / "t.csv"),
                             iters=150, device="cpu")
    assert abs(t.scale - j.scale) < 1e-4 and abs(t.scale - 1.4) < 1e-3
    assert t.mmoment == pytest.approx(j.mmoment)


# -- main ---------------------------------------------------------------------

MAIN = ["--num-water", "32", "--iters", "2"]
METHODS = {
    "ad_moment": ["--method", "ad", "--iters", "1"],
    "ad_D": ["--method", "ad", "--axis", "D", "--true-scale", "0.7",
             "--iters", "1"],
    "decompose": ["--method", "decompose"],
    "crn_D": ["--method", "crn", "--axis", "D", "--true-scale", "0.7"],
    "crn_cell_r": ["--method", "crn", "--axis", "cell_r", "--true-scale",
                   "0.6"],
    "crn_joint": ["--method", "crn", "--axis", "joint"],
}


def _main_lines(mod, argv, capsys):
    rc = mod.main(argv)
    out = capsys.readouterr().out.splitlines()
    return rc, out


def _numbers(line):
    """The numbers of a result line but its loss: the scales and errors.
    (At a probe where a walker crosses a membrane on the other side of
    an ulp of the two packages' arithmetic, its trajectory and the loss
    part; the search's path does not.)"""
    line = re.sub(r"loss \S+", "", line)
    return [float(v) for v in re.findall(r"-?\d+\.\d+(?:e[-+]\d+)?", line)]


@pytest.mark.parametrize("name", sorted(METHODS))
def test_main_matches_jax_main(name, capsys):
    argv = MAIN + METHODS[name]
    jrc, jout = _main_lines(jinv, argv, capsys)
    trc, tout = _main_lines(tinv, argv + ["--device", "cpu"], capsys)
    assert trc == jrc
    assert len(tout) == len(jout) == 2
    assert tout[0] == jout[0]              # the target line
    np.testing.assert_allclose(_numbers(tout[1]), _numbers(jout[1]),
                               rtol=1e-3, atol=1e-9)


def test_main_record_matches_jax(record, capsys):
    _, _, _, d = record
    argv = ["--record", str(d / "rec.npz"), "--target", str(d / "t.csv"),
            "--iters", "150", "--lr", "0.1"]
    jrc, jout = _main_lines(jinv, argv, capsys)
    trc, tout = _main_lines(tinv, argv + ["--device", "cpu"], capsys)
    assert trc == jrc == 0
    np.testing.assert_allclose(_numbers(tout[-1]), _numbers(jout[-1]),
                               rtol=1e-3, atol=1e-9)


REJECTED = {
    "record_without_target": ["--record", "r.npz"],
    "target_without_record": ["--target", "t.csv"],
    "record_on_d_axis": ["--record", "r.npz", "--target", "t.csv",
                         "--axis", "D"],
    "record_with_crn": ["--record", "r.npz", "--target", "t.csv",
                        "--method", "crn"],
    "record_bad_init": ["--record", "r.npz", "--target", "t.csv",
                        "--init-scale", "0"],
    "negative_scale": ["--true-scale", "-1"],
    "decompose_on_d_axis": ["--method", "decompose", "--axis", "D"],
    "d_above_one": ["--axis", "D", "--true-scale", "1.5"],
    "cell_r_by_ad": ["--axis", "cell_r"],
    "joint_by_decompose": ["--axis", "joint", "--method", "decompose"],
    "cell_r_outside_demo": ["--axis", "cell_r", "--method", "crn",
                            "--true-scale", "0.2"],
    "crn_on_moment": ["--method", "crn"],
    "unknown_method": ["--method", "newton"],
    "unknown_axis": ["--axis", "T1"],
}


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_main_rejects_as_jax(name, capsys):
    def fail(mod, extra):
        with pytest.raises(SystemExit) as e:
            mod.main(REJECTED[name] + extra)
        assert e.value.code == 2
        return capsys.readouterr().err.splitlines()[-1].split("error: ",
                                                              1)[1]
    assert fail(tinv, ["--device", "cpu"]) == fail(jinv, [])


def test_main_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks a box without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinv.main(MAIN + ["--method", "decompose"])

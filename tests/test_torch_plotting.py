"""The port's ``plotting.py`` (mri-t2-plot) against the JAX package's, on
the same inputs.

``main`` of both packages draws each kind of figure (decay curves, with
``--logy``/``--num-water``/``--magnitude``; dispersion tables, with
``--ycol``, a ``--fit-r2`` schema and a stderr column; a scene archive
of each package; T2 spectra), each in the light and the ``--dark``
palette: the PNGs, read back with ``matplotlib.image.imread`` (file
bytes may carry metadata), are pixel-identical.  The rejected inputs and
flag combinations give the same error (``ap.error`` exit 2 with the same
message, or the same ValueError).
"""

import numpy as np
import pytest
from matplotlib import image

from mri_nanoparticle_simulation_tpu import plotting as jplot
from mri_nanoparticle_simulation_tpu.params import small_test_params as jsmall
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox as JBox
from mri_nanoparticle_simulation_tpu.scene.io import save_scene as jsave
from mri_nanoparticle_simulation_tpu_torch import plotting as tplot
from mri_nanoparticle_simulation_tpu_torch.params import \
    small_test_params as tsmall
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox as TBox
from mri_nanoparticle_simulation_tpu_torch.scene.io import \
    save_scene as tsave


def _curves(d):
    t = np.linspace(0.001, 0.02, 20)
    paths = []
    for i, t2 in enumerate((0.01, 0.005, 0.02)):
        path = d / f"c{i}.csv"
        mag = 64 * np.exp(-t / t2)
        np.savetxt(path, np.c_[t, mag * np.cos(300 * t),
                               mag * np.sin(300 * t)], delimiter=",")
        paths.append(str(path))
    return paths


def _table(d, name, text):
    path = d / name
    path.write_text(text)
    return str(path)


def _spectra(d):
    t2 = np.geomspace(0.5, 100, 48)
    paths = []
    for i, mu in enumerate((8.0, 20.0)):
        w = np.exp(-0.5 * ((np.log(t2) - np.log(mu)) / 0.3) ** 2)
        path = d / f"s{i}.csv"
        path.write_text("t2_ms,weight\n" + "".join(
            f"{a},{b}\n" for a, b in zip(t2, w)))
        paths.append(str(path))
    return paths


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("plot_inputs")
    return {
        "curves": _curves(d),
        "sweep": _table(d, "sweep.csv",
                        "D,taucp,r2_per_ms,t2_ms,r_squared,n_echoes\n"
                        "0.25,2.5,0.023,42.4,0.999,8\n"
                        "1,2.5,0.053,18.8,0.999,8\n"
                        "0.25,5.5,0.025,39.3,0.999,3\n"
                        "1,5.5,nan,nan,nan,0\n"),
        "fit_r2": _table(d, "r2.csv",
                         "mscale,taucp_ms,r2_per_ms,t2_ms,r_squared,"
                         "n_echoes\n1,2.5,0.023,42.4,0.999,8\n"
                         "1,5.5,0.025,39.3,0.999,3\n1,11,0.027,37.0,0.99,1\n"),
        "stderr": _table(d, "e.csv",
                         "D,r2_per_ms,t2_ms,r_squared,n_echoes,"
                         "t2_stderr_ms\n0.25,0.023,42.4,0.999,8,1.2\n"
                         "0.5,0.035,28.3,0.999,8,nan\n"
                         "1,0.053,18.8,0.999,8,0.6\n"),
        "jax_scene": jsave(JBox(jsmall(num_water=48), seed=3).populate(),
                           str(d / "jscene.npz")),
        "port_scene": tsave(TBox(tsmall(num_water=48), seed=3).populate(),
                            str(d / "tscene.npz")),
        "spectra": _spectra(d),
    }


#: (inputs key, flags): every kind of figure main draws
KINDS = {
    "curves": ("curves", ["--num-water", "64", "--title", "decay"]),
    "curves_logy": ("curves", ["--logy"]),
    "curves_magnitude": ("curves", ["--magnitude", "--num-water", "64"]),
    "table": ("sweep", ["--table"]),
    "table_t2": ("sweep", ["--table", "--ycol", "t2_ms"]),
    "table_fit_r2": ("fit_r2", ["--table"]),
    "table_stderr": ("stderr", ["--table", "--ycol", "t2_ms"]),
    "scene_of_jax": ("jax_scene", ["--scene"]),
    "scene_of_port": ("port_scene", ["--scene", "--title", "box"]),
    "spectrum": ("spectra", ["--spectrum", "--title", "T2 spectrum"]),
}


@pytest.mark.parametrize("dark", [False, True])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_main_draws_the_same_pixels(kind, dark, inputs, tmp_path):
    key, flags = KINDS[kind]
    src = inputs[key]
    argv = (src if isinstance(src, list) else [src]) + flags \
        + (["--dark"] if dark else [])
    pngs = []
    for name, mod in (("jax", jplot), ("port", tplot)):
        out = str(tmp_path / f"{name}.png")
        assert mod.main(argv + ["--out", out]) == 0
        pngs.append(image.imread(out))
    assert pngs[0].shape == pngs[1].shape and pngs[0].size > 0
    np.testing.assert_array_equal(pngs[1], pngs[0])


#: inputs that both packages refuse, by main (flags) or by a function
REFUSED = {
    "table_and_scene": ("sweep", ["--table", "--scene"]),
    "spectrum_and_table": ("spectra", ["--spectrum", "--table"]),
    "spectrum_logy": ("spectra", ["--spectrum", "--logy"]),
    "two_scenes": ("curves", ["--scene"]),
    "scene_magnitude": ("port_scene", ["--scene", "--magnitude"]),
    "two_tables": ("curves", ["--table"]),
    "table_magnitude": ("sweep", ["--table", "--magnitude"]),
    "bad_ycol": ("sweep", ["--table", "--ycol", "depth"]),
    "magnitude_without_sin": ("sweep", ["--magnitude"]),
}


def _error(mod, argv, capsys):
    with pytest.raises((SystemExit, ValueError)) as e:
        mod.main(argv)
    if isinstance(e.value, SystemExit):
        assert e.value.code == 2
        return capsys.readouterr().err.splitlines()[-1].split(
            "error: ", 1)[1]
    return f"{type(e.value).__name__}: {e.value}"


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_inputs_give_the_same_error(name, inputs, tmp_path, capsys):
    key, flags = REFUSED[name]
    src = inputs[key]
    argv = (src if isinstance(src, list) else [src]) + flags + [
        "--out", str(tmp_path / "x.png")]
    assert _error(tplot, argv, capsys) == _error(jplot, argv, capsys)
    assert not (tmp_path / "x.png").exists()


@pytest.mark.parametrize("fn,args", [
    ("plot_dispersion", lambda d: [_table(d, "bad.csv", "a,b\n1,2\n")]),
    ("plot_spectrum", lambda d: [[_table(d, "bad.csv", "a,b\n1,2\n")]]),
    ("plot_scene", lambda d: [str(d / "bad.npz")]),
    ("plot_curves", lambda d: [_curves(d) * 3]),
])
def test_functions_raise_as_jax(fn, args, tmp_path):
    np.savez(tmp_path / "bad.npz", a=np.zeros(3))
    a = args(tmp_path)
    errors = []
    for mod in (jplot, tplot):
        with pytest.raises(ValueError) as e:
            getattr(mod, fn)(*a, str(tmp_path / "x.png"))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_palette_and_module_constants_equal():
    for name in ("SERIES", "SURFACE", "INK", "INK_2", "GRID"):
        assert getattr(tplot, name) == getattr(jplot, name), name
    for th in ("LIGHT", "DARK"):
        assert vars(getattr(tplot, th)) == vars(getattr(jplot, th)), th

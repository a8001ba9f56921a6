"""The port's scene I/O (``scene/io.py``: ``CustomBox``, the ``.npz``
scene archive, cell-centre CSVs), its CLI flags (``--scene-file
--save-scene --scene-family --dump-stats --dump-field``) and its field
dump (``fields/debug.py``).

* Port against port: each case of tests/test_scene_io.py (the sweep
  cases wait for the port's sweeps), runs through the plain chunks.
* Across the packages: an archive either package saves loads in the
  other bitwise; ``scene_fingerprint``, ``CustomBox``,
  ``read_scene_arrays`` and the scene families of both CLIs
  (``--save-scene`` with ``--dump-stats``) bitwise equal;
  ``dump_field_csv`` / ``field_profile`` within 1e-6 of the dump's
  largest |B_z| of JAX's: both sum the same float32 dipole terms in
  another order (a point's own relative error can be larger where the
  terms cancel).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu import params as JP
from mri_nanoparticle_simulation_tpu.engine import sim as jsim
from mri_nanoparticle_simulation_tpu.fields import debug as jdebug
from mri_nanoparticle_simulation_tpu.io import checkpoint as jck
from mri_nanoparticle_simulation_tpu.scene import io as jsio
from mri_nanoparticle_simulation_tpu_torch import params as P
from mri_nanoparticle_simulation_tpu_torch.engine import (convert,
                                                          cuda_engine, sim)
from mri_nanoparticle_simulation_tpu_torch.engine.sim import \
    SimulationRunner
from mri_nanoparticle_simulation_tpu_torch.fields import debug
from mri_nanoparticle_simulation_tpu_torch.io import checkpoint as ck
from mri_nanoparticle_simulation_tpu_torch.scene import (BacteriaBox,
                                                         CustomBox,
                                                         load_cells_csv,
                                                         load_scene,
                                                         save_scene)
from mri_nanoparticle_simulation_tpu_torch.scene import io as sio

torch.set_num_threads(1)

FIELD_TOL = 1e-6    # of the dump's largest |B_z|


def _params(n_cells=3, **kw):
    return P.small_test_params(num_cells=n_cells, **kw)


def _tp(p):
    return convert.params_from_fields(dataclasses.asdict(p))


CENTERS = np.array([[2.0, 2.0, 2.0], [5.0, 5.0, 5.0], [2.0, 5.5, 3.0]])


def _run(sc, p):
    return cuda_engine.run_simulation(sc, p, seed=2, device="cpu",
                                      max_steps=p.sprint_steps)


def _assert_scenes_equal(a, b):
    for f in ("cells", "mnps", "waters", "lookup_table"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.num_intra_mnps == b.num_intra_mnps


class TestCustomBox:
    def test_builds_full_scene_around_given_centers(self):
        p = _params()
        sc = CustomBox(p, CENTERS, seed=1).populate()
        np.testing.assert_array_equal(sc.cells, CENTERS)
        # one point dipole at each centre (BacteriaBox.cpp:114-121)
        np.testing.assert_array_equal(sc.mnps[:3, :3], CENTERS)
        assert sc.num_intra_mnps == 3
        assert sc.mnps.shape[0] >= 3          # plus periodic images
        assert sc.waters.shape == (p.num_water, 3)
        _, cos, _, _ = _run(sc, p)            # and the scene simulates
        assert np.isfinite(cos).all()

    def test_waters_and_images_follow_custom_geometry(self):
        p = _params()
        sc = CustomBox(p, CENTERS, seed=1).populate()
        d2 = np.sum((sc.waters[:, None, :] - CENTERS) ** 2, axis=2)
        assert d2.min() >= p.cell_r ** 2

    def test_out_of_bounds_rejected(self):
        p = _params()
        bad = CENTERS.copy()
        bad[0, 0] = p.bound  # sphere pokes out of the box
        with pytest.raises(ValueError, match="inside the box"):
            CustomBox(p, bad)

    def test_count_mismatch_rejected(self):
        with pytest.raises(ValueError, match="num_cells"):
            CustomBox(_params(n_cells=5), CENTERS)

    def test_bad_shape_rejected(self):
        with pytest.raises(ValueError, match=r"\[n, 3\]"):
            CustomBox(_params(), np.zeros((3, 2)))

    def test_equals_the_jax_custom_box(self):
        p = _params()
        jp = JP.small_test_params(num_cells=3)
        _assert_scenes_equal(CustomBox(p, CENTERS, seed=1).populate(),
                             jsio.CustomBox(jp, CENTERS, seed=1).populate())


class TestSceneRoundTrip:
    def test_npz_round_trip_bitwise(self, tmp_path):
        p = _params(n_cells=4)
        sc = BacteriaBox(p, seed=3).populate()
        path = str(tmp_path / "scene.npz")
        save_scene(sc, path)
        sc2 = load_scene(path, p)
        _assert_scenes_equal(sc2, sc)
        # identical arrays -> identical curve
        _, c1, _, _ = _run(sc, p)
        _, c2, _, _ = _run(sc2, p)
        np.testing.assert_array_equal(c1, c2)

    def test_params_mismatch_guard(self, tmp_path):
        """Geometry-affecting fields are pinned; simulation knobs are
        free."""
        p = _params(n_cells=4)
        sc = BacteriaBox(p, seed=3).populate()
        path = str(tmp_path / "scene.npz")
        save_scene(sc, path)
        other = p.replace(cell_r=0.4).validate()
        with pytest.raises(ValueError, match="geometry params"):
            load_scene(path, other)
        sc2 = load_scene(path, p.replace(taucp=0.001).validate())
        np.testing.assert_array_equal(sc2.mnps, sc.mnps)
        sc3 = load_scene(path, other, strict_params=False)
        np.testing.assert_array_equal(sc3.mnps, sc.mnps)

    def test_dense_geometry_fails_loudly_not_hangs(self):
        p = _params(n_cells=1, num_water=4).replace(
            cell_r=3.4, water_start_bound=2.0).validate()
        center = np.array([[p.bound / 2] * 3])
        box = CustomBox(p, center, seed=1)
        box.MAX_THROWS = 2000
        with pytest.raises(ValueError, match="could not place water"):
            box.populate()

    def test_nan_cells_rejected(self, tmp_path):
        bad = CENTERS.copy()
        bad[1, 2] = np.nan
        with pytest.raises(ValueError, match="non-finite"):
            CustomBox(_params(), bad)
        f = tmp_path / "bad.csv"
        f.write_text("2,2,2\n5,nan,5\n")
        with pytest.raises(ValueError, match="non-finite"):
            load_cells_csv(str(f))

    @pytest.mark.parametrize("saver", ["jax", "port"])
    def test_archives_cross_the_packages_bitwise(self, tmp_path, saver):
        p = _params(n_cells=4)
        jp = JP.small_test_params(num_cells=4)
        sc = BacteriaBox(p, seed=3).populate()
        path = str(tmp_path / "scene.npz")
        (jsio if saver == "jax" else sio).save_scene(sc, path)
        _assert_scenes_equal(load_scene(path, p), sc)
        _assert_scenes_equal(jsio.load_scene(path, jp), sc)
        for a, b in zip(sio.read_scene_arrays(path),
                        jsio.read_scene_arrays(path)):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
        with pytest.raises(ValueError) as te:
            load_scene(path, p.replace(cell_r=0.4).validate())
        with pytest.raises(ValueError) as je:
            jsio.load_scene(path, jp.replace(cell_r=0.4).validate())
        assert str(te.value) == str(je.value)


class TestSceneFingerprint:
    def test_equals_jax(self):
        p = _params(n_cells=4)
        sc = BacteriaBox(p, seed=3).populate()
        assert ck.scene_fingerprint(sc) == jck.scene_fingerprint(sc)
        other = CustomBox(_params(), CENTERS, seed=1).populate()
        assert ck.scene_fingerprint(other) == jck.scene_fingerprint(other)
        assert ck.scene_fingerprint(other) != ck.scene_fingerprint(sc)

    def test_resume_rejects_different_geometry(self, tmp_path):
        p = _params()
        ckpt = str(tmp_path / "c.npz")
        sc_a = CustomBox(p, CENTERS, seed=1).populate()
        r1 = SimulationRunner(p, scene_seed=1, seed=2, device="cpu",
                              rng_impl="threefry", scene=sc_a)
        r1.run(max_steps=p.sprint_steps, checkpoint_path=ckpt,
               progress=False)
        sc_b = CustomBox(p, CENTERS + 0.5, seed=1).populate()
        r2 = SimulationRunner(p, scene_seed=1, seed=2, device="cpu",
                              rng_impl="threefry", scene=sc_b)
        with pytest.raises(ValueError, match="different scene"):
            r2.resume(ckpt)
        r3 = SimulationRunner(p, scene_seed=1, seed=2, device="cpu",
                              rng_impl="threefry",
                              scene=CustomBox(p, CENTERS,
                                              seed=1).populate())
        r3.resume(ckpt)
        assert r3.state.step == p.sprint_steps


SCENE_CLI = ["--num-water", "32", "--num-cells", "8", "--totaltime",
             "0.002", "--sprint-steps", "1000", "--chunk-steps", "100",
             "--near-k", "3", "--taucp", "0.001", "--hash-dim", "8"]
PORT = ["--device", "cpu", "--rng", "threefry"]


@pytest.fixture
def no_jax_cache(monkeypatch):
    from mri_nanoparticle_simulation_tpu.utils import cache as jcache
    monkeypatch.setattr(jcache, "enable_compile_cache", lambda *a: None)


class TestCellsCsvAndCli:
    def test_load_cells_csv(self, tmp_path):
        f = tmp_path / "cells.csv"
        f.write_text("# x,y,z um\n2,2,2\n5,5,5\n")
        cells = load_cells_csv(str(f))
        np.testing.assert_array_equal(cells, [[2, 2, 2], [5, 5, 5]])
        bad = tmp_path / "bad.csv"
        bad.write_text("1,2\n")
        with pytest.raises(ValueError, match="3 columns"):
            load_cells_csv(str(bad))

    def test_cli_scene_file_csv(self, tmp_path):
        """--scene-file cells.csv: num_cells follows the file and the
        run completes end to end."""
        f = tmp_path / "cells.csv"
        np.savetxt(f, CENTERS, delimiter=",")
        out = str(tmp_path / "custom.csv")
        assert sim.main(SCENE_CLI + PORT + ["--scene-file", str(f),
                                            "--out", out]) == 0
        d = np.loadtxt(out, delimiter=",")
        assert d.shape == (2, 2)

    def test_cli_scene_file_excludes_family(self, tmp_path):
        f = tmp_path / "cells.csv"
        np.savetxt(f, CENTERS, delimiter=",")
        with pytest.raises(SystemExit):
            sim.main(["--scene-file", str(f), "--scene-family", "fcc",
                      "--out", str(tmp_path / "x.csv")] + PORT)


class TestSaveSceneCli:
    ARGS = SCENE_CLI + ["--seed", "7", "--scene-seed", "5"] + PORT

    def test_round_trip_reproduces_run(self, tmp_path):
        """A run re-executed from its own --save-scene archive writes a
        bitwise-identical CSV (the archive IS the geometry)."""
        npz = str(tmp_path / "geom.npz")
        out1 = str(tmp_path / "a.csv")
        assert sim.main(self.ARGS + ["--save-scene", npz,
                                     "--out", out1]) == 0
        out2 = str(tmp_path / "b.csv")
        assert sim.main(self.ARGS + ["--scene-file", npz,
                                     "--out", out2]) == 0
        with open(out1) as f1, open(out2) as f2:
            assert f1.read() == f2.read()

    @pytest.mark.parametrize("family", [
        ["--scene-family", "bacteria"],
        ["--scene-family", "clustered", "--n-clusters", "3",
         "--cluster-sigma", "1.0"],
        ["--scene-family", "fcc"],
        ["--scene-family", "fcc", "--lattice-a", "3.0"]])
    def test_families_equal_the_jax_clis(self, tmp_path, no_jax_cache,
                                         family):
        """--save-scene with --dump-stats builds, archives and describes
        the scene and exits: both CLIs write the same scene and the same
        statistics file."""
        out = {}
        for name, mod, extra in (("j", jsim, []), ("t", sim, PORT)):
            argv = SCENE_CLI + ["--scene-seed", "5"] + family + extra + [
                "--save-scene", str(tmp_path / f"{name}.npz"),
                "--dump-stats", str(tmp_path / f"{name}_stats.csv")]
            assert mod.main(argv) == 0
            out[name] = sio.read_scene_arrays(str(tmp_path / f"{name}.npz"))
        for a, b in zip(out["t"], out["j"]):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
        assert (tmp_path / "t_stats.csv").read_bytes() == \
            (tmp_path / "j_stats.csv").read_bytes()


class TestFieldDump:
    def test_dump_field_csv_matches_jax(self, tmp_path):
        jp = JP.small_test_params()
        sc = BacteriaBox(_tp(jp), seed=3).populate()
        jdebug.dump_field_csv(sc.mnps, jp, str(tmp_path / "j.csv"),
                              grid_n=12)
        debug.dump_field_csv(sc.mnps, _tp(jp), str(tmp_path / "t.csv"),
                             grid_n=12, device="cpu")
        j = np.loadtxt(tmp_path / "j.csv", delimiter=",")
        t = np.loadtxt(tmp_path / "t.csv", delimiter=",")
        assert t.shape == j.shape == (12 ** 3, 4)
        np.testing.assert_array_equal(t[:, :3], j[:, :3])
        scale = np.abs(j[:, 3]).max()
        assert scale > 0
        np.testing.assert_allclose(t[:, 3], j[:, 3], rtol=0,
                                   atol=FIELD_TOL * scale)

    def test_field_profile_matches_jax(self):
        jp = JP.small_test_params()
        sc = BacteriaBox(_tp(jp), seed=3).populate()
        ends = ([0.5, 1.0, 1.5], [7.5, 6.0, 7.0])
        j = jdebug.field_profile(sc.mnps, jp, *ends, n=200)
        t = debug.field_profile(sc.mnps, _tp(jp), *ends, n=200,
                                device="cpu")
        np.testing.assert_array_equal(t[:, 0], j[:, 0])
        np.testing.assert_allclose(t[:, 1], j[:, 1], rtol=0,
                                   atol=FIELD_TOL * np.abs(j[:, 1]).max())

    def test_cli_dump_field_matches_jax_cli(self, tmp_path, no_jax_cache):
        for name, mod, extra in (("j", jsim, []), ("t", sim, PORT)):
            assert mod.main(SCENE_CLI + extra + [
                "--dump-field", str(tmp_path / f"{name}.csv"),
                "--dump-field-n", "6"]) == 0
        j = np.loadtxt(tmp_path / "j.csv", delimiter=",")
        t = np.loadtxt(tmp_path / "t.csv", delimiter=",")
        assert t.shape == j.shape == (6 ** 3, 4)
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=FIELD_TOL * np.abs(j[:, 3]).max())

    def test_cuda_dump_raises_without_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is visible")
        p = P.small_test_params()
        sc = BacteriaBox(p, seed=3).populate()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            debug.dump_field_csv(sc.mnps, p, str(tmp_path / "f.csv"),
                                 grid_n=2)
        assert not (tmp_path / "f.csv").exists()

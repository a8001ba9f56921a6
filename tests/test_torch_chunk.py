"""One chunk of the port (``chunk_kernel.run_chunk`` on CPU tensors, i.e.
the plain version ``cuda_engine.chunk_reference``) against one launch of
the reference Pallas kernel ``pallas_engine.make_chunk_kernel`` in
in-kernel-rebuild mode, run in interpret mode as tests/test_pallas.py
runs it.  Same state, same dipole table, same Threefry key and counters.

Tolerances are those of tests/test_pallas.py:34-36: state within 5e-6,
window sums within 1e-3; escapes and coverage counts equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu import params as P
from mri_nanoparticle_simulation_tpu.engine import pallas_engine as pe
from mri_nanoparticle_simulation_tpu.engine import reference_engine as jre
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
from mri_nanoparticle_simulation_tpu_torch.engine import (chunk_kernel,
                                                          convert,
                                                          cuda_engine)
from mri_nanoparticle_simulation_tpu_torch.engine.reference_engine import \
    init_state
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox as TBox

torch.set_num_threads(1)

KEY = (0x0BADC0DE, 0x12345678)

CASES = {
    # 64 walkers, one window per chunk
    "chunk_equals_pfreq": dict(
        p=dict(chunk_steps=100, num_water=64), step0=0, lane_offset=0),
    # two windows, tcp = 1 window: a CP flip between them and at the end;
    # a large moment and walkers starting in cells load the phase
    "two_windows_cp_flip": dict(
        p=dict(chunk_steps=200, num_water=64, taucp=0.0001,
               mmoment=3.5e-15, water_start_bound=7.9,
               avoid_intracellular_throw=False),
        step0=12345, lane_offset=77),
    # 50 walkers: 78 padding walkers masked out of every sum
    "padding_50": dict(
        p=dict(chunk_steps=200, num_water=50, taucp=0.0001), step0=0,
        lane_offset=0),
    # K = 1 over a long chunk: coverage violations are counted
    "coverage_nonzero": dict(
        p=dict(chunk_steps=1000, num_water=128, num_cells=40, near_k=1,
               totaltime=0.002, mmoment=3.5e-15, water_start_bound=7.9,
               avoid_intracellular_throw=False),
        step0=0, lane_offset=0),
}


def _params(over):
    base = dict(print_interval=0.0001, totaltime=0.0008, sprint_steps=400)
    base.update(over)
    return P.small_test_params(**base)


def _tp(p):
    """The port's Params of the JAX Params ``p``."""
    return convert.params_from_fields(dataclasses.asdict(p))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """Inputs and the Pallas kernel's outputs, shared by the tests."""
    c = CASES[request.param]
    p = _params(c["p"])
    tp = _tp(p)
    nw = p.num_water
    sc = BacteriaBox(p, seed=3).populate()
    tbl = convert.mnp_table(TBox(tp, seed=3).populate().mnps, torch.float32,
                            "cpu")
    st = jre.init_state(sc.waters, p)
    ps = pe.to_planes(st, p)
    kern = pe.make_chunk_kernel(p, ps.px.shape[0], jnp.float32, "threefry",
                                interpret=True, n_mnp_pad=tbl.tbl.shape[1])
    cr2 = np.float32(cuda_engine.cell_r2_f32(tp.cell_r))
    scal = np.array([c["step0"], KEY[0], KEY[1], 0, c["lane_offset"], nw,
                     p.tcp, cr2.view(np.uint32),
                     np.float32(1.0).view(np.uint32), 0, 0], np.uint32)
    state = np.stack([ps.px, ps.py, ps.pz, ps.in_cell, ps.phase,
                      ps.phase_comp])
    out = kern(jnp.asarray(scal), jnp.asarray(state),
               jnp.asarray(tbl.tbl.numpy()))
    so, esc, cov, wins = (np.asarray(a) for a in out)
    ref = dict(state=so.reshape(6, -1)[:, :nw],
               esc=int(esc.reshape(-1)[:nw].sum()), cov=int(cov.sum()),
               wins=wins.sum(0))
    ss = cuda_engine.to_soa(convert.state_from_numpy(st, "cpu"), tp)
    got = chunk_kernel.run_chunk(
        ss.planes, tbl.tbl, step0=c["step0"], key=KEY,
        lane_offset=c["lane_offset"], num_water=nw, tcp=tp.tcp,
        cell_r2=float(cr2), dstd=1.0, phys=cuda_engine.chunk_physics(tp))
    return request.param, p, ref, got


def test_state_matches_pallas_kernel(case):
    _, p, ref, (state, _, _, _) = case
    assert state.shape == (6, cuda_engine.pad_count(p.num_water))
    np.testing.assert_allclose(state.numpy()[:, :p.num_water],
                               ref["state"], rtol=0, atol=5e-6)


def test_window_sums_match_pallas_kernel(case):
    _, p, ref, (_, _, _, wins) = case
    n_win = p.chunk_steps // p.pfreq
    assert wins.shape == (cuda_engine.pad_count(p.num_water)
                          // cuda_engine.BLOCK, n_win, 2)
    np.testing.assert_allclose(wins.sum(0).numpy(), ref["wins"], rtol=0,
                               atol=1e-3)
    assert abs(float(wins.sum(0)[0, 0])) <= p.num_water + 1e-3


def test_escapes_and_coverage_match_pallas_kernel(case):
    name, _, ref, (_, esc, cov, _) = case
    assert int(esc.sum()) == ref["esc"]
    assert int(cov.sum()) == ref["cov"]
    if name == "coverage_nonzero":
        assert ref["cov"] > 0


def test_padding_walkers_stay_out_of_the_sums(case):
    name, p, _, (state, esc, cov, wins) = case
    w = p.num_water
    assert float(esc[w:].sum()) == 0.0
    # padding walkers start at the box centre and move like any walker
    assert torch.isfinite(state[:, w:]).all()


class TestWrapperChecks:
    """run_chunk raises on what the kernel does not take; there is no
    path that carries on elsewhere."""

    def _args(self, p):
        return dict(step0=0, key=KEY, lane_offset=0, num_water=p.num_water,
                    tcp=p.tcp, cell_r2=cuda_engine.cell_r2_f32(p.cell_r),
                    dstd=1.0, phys=cuda_engine.chunk_physics(p))

    def _inputs(self):
        p = _tp(_params(dict(chunk_steps=100, num_water=64)))
        sc = TBox(p, seed=3).populate()
        tbl = convert.mnp_table(sc.mnps, torch.float32, "cpu").tbl
        st = cuda_engine.to_soa(init_state(sc.waters, p, "cpu"), p)
        return p, st.planes, tbl

    def test_rejects_bad_inputs(self):
        p, planes, tbl = self._inputs()
        a = self._args(p)
        with pytest.raises(TypeError, match="float32"):
            chunk_kernel.run_chunk(planes.double(), tbl, **a)
        with pytest.raises(ValueError, match=r"\[6, N\]"):
            chunk_kernel.run_chunk(planes[:5], tbl, **a)
        with pytest.raises(ValueError, match="contiguous"):
            chunk_kernel.run_chunk(planes[:, ::2], tbl, **a)
        with pytest.raises(ValueError, match="multiple of 128"):
            chunk_kernel.run_chunk(planes[:, :100].contiguous(), tbl, **a)
        with pytest.raises(ValueError, match="multiple of 8"):
            chunk_kernel.run_chunk(planes, tbl[:, :-1].contiguous(), **a)
        with pytest.raises(ValueError, match="near_k"):
            chunk_kernel.run_chunk(planes, tbl, **{
                **a, "phys": a["phys"]._replace(near_k=17)})

    def test_no_fallback_for_other_devices(self):
        p, planes, tbl = self._inputs()
        before = dict(chunk_kernel.LAUNCHES)
        with pytest.raises(ValueError, match="no chunk kernel"):
            chunk_kernel.run_chunk(planes.to("meta"), tbl.to("meta"),
                                   **self._args(p))
        # the CPU path is the plain version and launches nothing
        chunk_kernel.run_chunk(planes, tbl, **self._args(p))
        assert chunk_kernel.LAUNCHES == before

    def test_build_needs_nvcc_and_names_the_sources(self, monkeypatch):
        lib = chunk_kernel.library_path()
        assert lib.parent == chunk_kernel.BUILD_DIR
        assert lib.name.startswith("libchunk_kernel-")
        assert "--fmad=false" in chunk_kernel.NVCC_FLAGS
        assert "arch=compute_90a,code=sm_90a" in chunk_kernel.NVCC_FLAGS
        monkeypatch.setenv("PATH", "")
        monkeypatch.delenv("CUDA_HOME", raising=False)
        monkeypatch.delenv("CUDA_PATH", raising=False)
        monkeypatch.setattr(chunk_kernel.os.path, "exists",
                            lambda path: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            chunk_kernel._nvcc()

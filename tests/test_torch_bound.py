"""The bounds chip_smoke.py prints beside each kernel's time (no card
needed: the script imports without one).

The kernels are built with --fmad=false, so every float add and multiply
is its own instruction on one of the FP32 pipe's 128 lanes per SM: the
float rate is 128 x 132 SMs x 1.98 GHz, half the published 67 TFLOP/s,
which counts a fused multiply-add as two operations.  Float and integer
operations share the schedulers' issue slots (the same 128 a cycle per
SM), and integer ones have 64 lanes per SM besides.  The four chunk
bounds are pinned at the headline (4032 walkers, 720-entry table, K 5)
and the scale-up (100000 walkers, K 10) shapes within 1%.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from mri_nanoparticle_simulation_tpu_torch.benchmark import SCALEUP  # noqa
from mri_nanoparticle_simulation_tpu_torch.engine import cuda_engine  # noqa
from mri_nanoparticle_simulation_tpu_torch.params import Params  # noqa: E402

HEADLINE = Params(chunk_steps=4000, near_k=5).validate()
SCALE = Params(**SCALEUP).validate()

#: (entry, generator) -> (bound ms, bound_by)
CHUNK_BOUNDS = {
    ("rebuild", "threefry"): (0.1957, "integer"),
    ("rebuild", "hardware"): (0.121, "issue"),
    ("near", "threefry"): (5.75, "issue"),
    ("near", "hardware"): (3.93, "issue"),
}


@pytest.mark.parametrize("entry, rng_impl", sorted(CHUNK_BOUNDS))
def test_chunk_bound_is_pinned(entry, rng_impl):
    want, by = CHUNK_BOUNDS[entry, rng_impl]
    if entry == "rebuild":
        got = cs.chunk_bound(HEADLINE.num_water,
                             cuda_engine.chunk_physics(HEADLINE, rng_impl),
                             720)
    else:
        got = cs.chunk_bound(SCALE.num_water,
                             cuda_engine.chunk_physics(SCALE, rng_impl))
    assert got[1] == by
    assert got[0] == pytest.approx(want, rel=0.01)


def test_peak_rates():
    assert cs.PEAK_ISSUE == pytest.approx(3.345e13, rel=1e-3)
    assert cs.PEAK_INT32 == pytest.approx(1.6727e13, rel=1e-4)
    assert cs.PEAK_ISSUE == 2 * cs.PEAK_INT32


@pytest.mark.parametrize("nbytes, flops, iops, by", [
    (3.35e12, 0, 0, "bytes"),
    (0, 3.345e13, 0, "issue"),
    (0, 1e13, 1e13, "issue"),            # the two kinds share issue slots
    (0, 0, 1e13, "integer"),              # integer lanes: half the rate
    (0, 1e12, 1.6e13, "integer"),
])
def test_bound_takes_the_slowest_limit(nbytes, flops, iops, by):
    ms, got = cs.bound(nbytes, flops, iops)
    assert got == by
    assert ms == pytest.approx(1e3 * max(nbytes / cs.PEAK_BYTES,
                                         (flops + iops) / cs.PEAK_ISSUE,
                                         iops / cs.PEAK_INT32))


def test_other_kernels_bounds_name_their_limit():
    cache = type("Cache", (), {})()
    cache.payload = type("T", (), {"shape": (4096, 32, 5),
                                   "numel": lambda self: 4096 * 32 * 5})()
    cache.far_coeffs = type("T", (), {"shape": (4096, 56),
                                      "numel": lambda self: 4096 * 56})()
    ms, by = cs.cand_model_bound(100096, SCALE, cache)
    assert by in ("bytes", "issue", "integer") and ms > 0
    ms, by = cs.far_sums_bound(100096, 5256, 10)
    assert by == "issue"
    assert ms == pytest.approx(1e3 * 100096 * 5256 * 75 / cs.PEAK_ISSUE,
                               rel=1e-3)

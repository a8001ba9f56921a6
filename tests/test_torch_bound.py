"""The bounds chip_smoke.py prints beside each kernel's time (no card
needed: the script imports without one).

Float operations count at the published float32 peak, 67 TFLOP/s (128
FP32 lanes per SM at 132 SMs x 1.98 GHz, a fused multiply-add two
operations in one issue slot); integer ones share the schedulers' issue
slots (128 a cycle per SM) and have 64 INT32 lanes per SM besides.  The
kernels, built with --fmad=false, issue a slot per float operation:
``issue_bound_ms`` is that figure.  The four chunk bounds are pinned at
the headline (4032 walkers, 720-entry table, K 5) and the scale-up
(100000 walkers, K 10) shapes within 1%.
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
    ("rebuild", "threefry"): (0.1957, "operations"),
    ("rebuild", "hardware"): (0.0733, "operations"),
    ("near", "threefry"): (4.854, "operations"),
    ("near", "hardware"): (2.279, "operations"),
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
    assert cs.PEAK_FP32 == pytest.approx(6.69e13, rel=1e-3)
    assert cs.PEAK_ISSUE == pytest.approx(3.345e13, rel=1e-3)
    assert cs.PEAK_INT32 == pytest.approx(1.6727e13, rel=1e-4)
    assert cs.PEAK_FP32 == 2 * cs.PEAK_ISSUE == 4 * cs.PEAK_INT32


@pytest.mark.parametrize("nbytes, flops, iops, by, ms", [
    (3.35e12, 0, 0, "bytes", 1e3),
    (0, 6.69e13, 0, "operations", 1e3),   # the published float32 peak
    (0, 3.345e13, 1e13, "operations", 1e3 * (0.5 + 1e13 / 3.3454e13)),
    (0, 0, 1e13, "operations", 1e3 * 1e13 / 1.6727e13),  # INT32 lanes
    (1e9, 1e12, 1.6e13, "operations", 1e3 * 1.6e13 / 1.6727e13),
])
def test_bound_takes_the_slowest_limit(nbytes, flops, iops, by, ms):
    got_ms, got = cs.bound(nbytes, flops, iops)
    assert got == by
    assert got_ms == pytest.approx(ms, rel=1e-3)
    assert cs.issue_bound_ms(nbytes, flops, iops) == pytest.approx(
        1e3 * max(nbytes / cs.PEAK_BYTES, (flops + iops) / cs.PEAK_ISSUE,
                  iops / cs.PEAK_INT32))


def test_other_kernels_bounds_name_their_limit():
    cache = type("Cache", (), {})()
    cache.cand_table = type("T", (), {"shape": (4096, 32, 4),
                                      "numel": lambda self: 4096 * 32 * 4})()
    cache.far_coeffs = type("T", (), {"shape": (4096, 56),
                                      "numel": lambda self: 4096 * 56})()
    # the scale-up's candidate model: per walker distance and insertion
    # over 32 candidates, Taylor parts over the 22 not selected, 56
    # coefficients; the 4-column table, the anchors and the outputs
    nbytes, flops = cs.cand_model_work(100096, SCALE, cache)
    assert flops == 100096 * (32 * 48 + 22 * 65 + 20 * 56) == 100096 * 4086
    assert nbytes == 4 * (54 * 100096 + 4096 * 32 * 4 + 4096 * 56)
    ms, by = cs.bound(nbytes, flops, 0)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * nbytes / cs.PEAK_BYTES)
    assert cs.issue_bound_ms(nbytes, flops, 0) == pytest.approx(
        1e3 * flops / cs.PEAK_ISSUE)
    ms, by = cs.far_sums_bound(100096, 5256, 10)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 100096 * 5256 * 65 / cs.PEAK_FP32,
                               rel=1e-3)


def test_far_sums_work_and_issue_bound():
    """The far sums at the scale-up: 65 float operations a (walker, table
    entry) pair and K integer ones a walker for the ids it leaves out,
    1.0222 ms with an issue slot per operation, about half that (the
    bound) at the published rate."""
    nbytes, flops, iops = cs.far_sums_work(100096, 5256, 10)
    assert flops == 100096 * 5256 * 65
    assert iops == 100096 * 10
    assert nbytes == 16 * 5256 + 4 * 23 * 100096
    assert cs.issue_bound_ms(nbytes, flops, iops) == pytest.approx(1.0222,
                                                                   abs=1e-4)
    assert cs.far_sums_bound(100096, 5256, 10) == (pytest.approx(
        1e3 * (flops / cs.PEAK_FP32 + iops / cs.PEAK_ISSUE)), "operations")
    assert cs.far_sums_bound(100096, 5256, 10)[0] == pytest.approx(0.5111,
                                                                   abs=1e-4)

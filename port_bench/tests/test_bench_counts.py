"""The frozen work counts against values worked out by hand, one small
shape per cell, and the refusal of a roofline share above 100%."""

import pytest

from port_bench.work import counts as c

PF = 2 * 128 * 132 * 1.98e9      # 6.690816e13 float32 operations/s
PI = 128 * 132 * 1.98e9          # issue slots/s
PN = 64 * 132 * 1.98e9           # INT32 lanes/s
PB = 3.35e12                     # bytes/s


def test_peaks_are_the_published_ones():
    assert (c.PEAK_FP32, c.PEAK_ISSUE, c.PEAK_INT32, c.PEAK_BYTES) == \
        (PF, PI, PN, PB)
    assert round(c.PEAK_FP32 / 1e12, 1) == 66.9


@pytest.mark.parametrize("mode,flops,iops", [
    # headline, fast generator, K 5, pfreq 1000 (escapes every 4th step):
    # 19*5 + 55 = 150; + 20 + 8 + 9/4; two Philox blocks of 50 over 2, + 3
    (c.Mode(True, 1000, 4000, 5), 180.25, 53.0),
    # scale-up, Threefry, K 10: 19*10 + 55 + 5 + 6 + 13 + 9; 3 * 66 + 5
    (c.Mode(False, 2000, 4000, 10), 278.0, 203.0),
    # scale-up, fast, K 10, pfreq 2000
    (c.Mode(True, 2000, 4000, 10), 275.25, 53.0),
])
def test_step_ops_by_hand(mode, flops, iops):
    assert c.step_ops(mode) == (flops, iops)


def test_chunk_bound_by_hand_headline_fast():
    """64 walkers, one 1000-step window, a 720-entry table: bytes
    4 (2*6*64 + 64 + 2 warps + 2*1*2 sums) + 16*720 = 14872; floats
    64*1000*180.25 + 64*720*(8 + 20 + 65 + 5) = 16051840; integers
    64*1000*53 = 3392000; operations bound."""
    m = c.Mode(True, 1000, 1000, 5)
    assert c.chunk_work(64, m, n_pad=720) == (14872, 16051840.0, 3392000.0)
    ms, by = c.bound(14872, 16051840.0, 3392000.0)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * (16051840 / PF + 3392000 / PI),
                               rel=1e-12)


def test_chunk_work_by_hand_plane_decompose():
    """The same chunk in decompose mode: 8 rows, the per-walker record
    2*64 a window, one more float operation a walker-step."""
    m = c.Mode(True, 1000, 1000, 5)
    nbytes, flops, _ = c.chunk_work(64, m, n_pad=720, decompose=True)
    assert nbytes == 4 * (2 * 8 * 64 + 64 + 2 + 128) + 16 * 720
    assert flops == 64 * 1000 * 181.25 + 64 * 720 * 98


def test_chunk_work_by_hand_scaleup_near():
    """Near entry (no table): the near slots and Taylor sums per walker,
    4 (4*10 + 10) * 64 bytes more."""
    m = c.Mode(False, 2000, 4000, 10)
    nbytes, flops, iops = c.chunk_work(64, m)
    assert nbytes == 4 * (2 * 6 * 64 + 64 + 2 + 2 * 2 * 2) + 4 * 50 * 64
    assert (flops, iops) == (64 * 4000 * 278.0, 64 * 4000 * 203.0)


def test_cand_model_work_by_hand():
    """64 walkers, K 10, C 32, 16^3 cubes, order 3 (20 coefficients)."""
    assert c.n_coeffs(3) == 20 and c.n_coeffs(5) == 56
    nbytes, flops, iops = c.cand_model_work(64, 10, 32, 16, 20)
    assert nbytes == 13824 + 2097152 + 327680
    assert flops == 64 * (32 * 48 + 22 * 65 + 400) and iops == 0


def test_plane_fold_work_by_hand():
    """64 walkers padded to 128, 2 windows a sprint, 4 scales x 4
    spacings: bytes 4 (2*2*128 + 2*18*64 + 32*2) = 11520, floats
    64*2*(4 + 4*(4 + 24)) = 14848."""
    assert c.plane_fold_work(64, 128, 2, 4, 4) == (11520, 14848, 0)


def test_window_bound_adds_its_chunks_and_folds():
    cfg = {"num_water": 64, "print_interval": 1e-3, "tau": 1e-6,
           "chunk_steps": 1000, "near_k": 5, "sprint_steps": 2000,
           "far_table_order": 5, "cube_candidates": 32, "cube_hash_dim": 16,
           "reflect_io": 0.0, "reflect_oi": 0.0, "kick_mode": "as_written",
           "direction_mode": "cube", "b0_gradient": [0.0, 0.0, 0.0]}
    per = c.bound(*c.chunk_work(64, c.Mode(True, 1000, 1000, 5), 720))[0]
    assert c.window_bound_ms(cfg, True, 716, 10, 5) == pytest.approx(
        10 * per)
    plane = {"moment_scales": [1, 2], "echo_taucps": [0.1]}
    per_dec = c.bound(*c.chunk_work(64, c.Mode(True, 1000, 1000, 5), 720,
                                    True))[0]
    fold = c.bound(*c.plane_fold_work(64, 128, 2, 2, 1))[0]
    assert c.window_bound_ms(cfg, True, 716, 10, 5, plane) == \
        pytest.approx(10 * per_dec + 5 * fold)
    large = dict(cfg, near_k=10)
    near = c.bound(*c.chunk_work(64, c.Mode(True, 1000, 1000, 10)))[0]
    cand = c.bound(*c.cand_model_work(64, 10, 32, 16, 56))[0]
    assert c.window_bound_ms(large, True, 5253, 3, 1) == pytest.approx(
        3 * (near + cand))
    exact = dict(large, far_table_order=0)
    far = c.bound(*c.far_sums_work(64, 5256, 10))[0]
    assert c.window_bound_ms(exact, True, 5253, 3, 1) == pytest.approx(
        3 * (near + far))
    variants = dict(cfg, kick_mode="intended", b0_gradient=[0, 0, 1e-5])
    m = c.Mode(True, 1000, 1000, 5, intended=True, gradient=True)
    assert c.window_bound_ms(variants, True, 716, 1, 1) == pytest.approx(
        c.bound(*c.chunk_work(64, m, 720))[0])


def test_a_share_over_100_percent_is_refused():
    assert c.share_pct(1.0, 2.0) == 50.0
    assert c.share_pct(2.0, 2.0) == 100.0
    with pytest.raises(ValueError, match="exceeds 100%"):
        c.share_pct(2.1, 2.0)
    with pytest.raises(ValueError):
        c.share_pct(1.0, 0.0)

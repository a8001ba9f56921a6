"""The port's Threefry RNG against the Random123 known answers and,
bitwise, against the JAX package's ``rng``.

torch's CPU ``uint32`` lacks add, shift and compare, so the port keeps
words in int64 masked to 32 bits; these tests pin that form to the
reference's uint32 arithmetic.  Inputs are made with NumPy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu import rng as jrng
from mri_nanoparticle_simulation_tpu_torch import rng

torch.set_num_threads(1)


@pytest.mark.parametrize("key, ctr, expect", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_known_answer_20_rounds(key, ctr, expect):
    x0, x1 = rng.threefry2x32(key, ctr[0], ctr[1])
    assert (int(x0), int(x1)) == expect


def test_reduced_rounds_differ():
    assert (tuple(int(v) for v in rng.threefry2x32((0, 0), 0, 0, rounds=12))
            != tuple(int(v) for v in rng.threefry2x32((0, 0), 0, 0)))


def test_rounds_must_be_multiple_of_4():
    with pytest.raises(ValueError, match="multiple of 4"):
        rng.threefry2x32((0, 0), 0, 0, rounds=13)


def _lanes_and_key(seed):
    r = np.random.default_rng(seed)
    lane = r.integers(0, 2 ** 32, size=4096, dtype=np.uint64)
    key = tuple(int(v) for v in r.integers(0, 2 ** 32, size=2,
                                           dtype=np.uint64))
    return lane, key


@pytest.mark.parametrize("rounds", [20, 12])
def test_threefry_bitwise_equal_to_jax(rounds):
    lane, key = _lanes_and_key(1)
    c0 = np.random.default_rng(2).integers(0, 2 ** 32, size=4096,
                                           dtype=np.uint64)
    j0, j1 = jrng.threefry2x32(
        (jnp.uint32(key[0]), jnp.uint32(key[1])),
        jnp.asarray(c0.astype(np.uint32)), jnp.asarray(lane.astype(np.uint32)),
        rounds=rounds)
    t0, t1 = rng.threefry2x32(key, torch.from_numpy(c0.astype(np.int64)),
                              torch.from_numpy(lane.astype(np.int64)),
                              rounds=rounds)
    np.testing.assert_array_equal(np.asarray(j0).astype(np.int64), t0.numpy())
    np.testing.assert_array_equal(np.asarray(j1).astype(np.int64), t1.numpy())


@pytest.mark.parametrize("rounds", [20, 12])
@pytest.mark.parametrize("step", [0, 123456789, 2 ** 32 - 1])
def test_words_for_step_bitwise_equal_to_jax(rounds, step):
    lane, key = _lanes_and_key(3)
    jw = jrng.words_for_step((jnp.uint32(key[0]), jnp.uint32(key[1])),
                             jnp.uint32(step),
                             jnp.asarray(lane.astype(np.uint32)), 5,
                             rounds=rounds)
    tw = rng.words_for_step(key, step, torch.from_numpy(lane.astype(np.int64)),
                            5, rounds=rounds)
    assert len(tw) == 5
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy())


def test_batched_window_draw_equals_per_step_draws():
    """The plain chunk draws a whole window's words as [T, W] at once."""
    lane = torch.arange(64)
    key = rng.key_from_seed(9)
    steps = torch.arange(10, 20)[:, None]
    batch = rng.words_for_step(key, steps, lane, 5)
    for i in range(10):
        for a, b in zip(rng.words_for_step(key, 10 + i, lane, 5), batch):
            assert torch.equal(a, b[i])


def test_uniform_from_bits_bitwise_equal_to_jax():
    bits = np.random.default_rng(4).integers(0, 2 ** 32, size=4096,
                                             dtype=np.uint64)
    u_j = np.asarray(jrng.uniform_from_bits(jnp.asarray(
        bits.astype(np.uint32))))
    u_t = rng.uniform_from_bits(torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(u_j, u_t.numpy())
    assert u_t.dtype == torch.float32
    assert float(u_t.min()) >= 0.0 and float(u_t.max()) < 1.0


def test_normal_from_bits_matches_jax():
    """Within 2e-6: torch's and XLA's CPU log/cos/sqrt differ by up to
    1 ulp (normals reach ~5.8, where 1 ulp of f32 is ~4.8e-7)."""
    r = np.random.default_rng(5)
    a, b = (r.integers(0, 2 ** 32, size=4096, dtype=np.uint64)
            for _ in range(2))
    n_j = np.asarray(jrng.normal_from_bits(jnp.asarray(a.astype(np.uint32)),
                                           jnp.asarray(b.astype(np.uint32))))
    n_t = rng.normal_from_bits(torch.from_numpy(a.astype(np.int64)),
                               torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_allclose(n_t.numpy(), n_j, rtol=0, atol=2e-6)


def test_key_from_seed_matches_jax():
    for seed in (0, 7, 2 ** 40 + 3, -1):
        jk = jrng.key_from_seed(seed)
        assert rng.key_from_seed(seed) == (int(jk[0]), int(jk[1]))


# -- the fast generator: Philox4x32-10, fast_normal_pair, unpack_pm1 ----------

@pytest.mark.parametrize("ctr, key, expect", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, expect):
    """Random123's known-answer vectors for Philox4x32-10."""
    assert tuple(int(v) for v in rng.philox4x32(key, *ctr)) == expect


def _philox_numpy(key, ctr, rounds=10):
    """Philox4x32 in NumPy uint64 (products below 2^64, no overflow)."""
    m = np.uint64(0xFFFFFFFF)
    k0, k1 = (np.uint64(k) for k in key)
    c0, c1, c2, c3 = (c.astype(np.uint64) for c in ctr)
    for r in range(rounds):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & m
            k1 = (k1 + np.uint64(0xBB67AE85)) & m
        p0 = np.uint64(0xD2511F53) * c0
        p1 = np.uint64(0xCD9E8D57) * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & m,
                          (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & m)
    return c0, c1, c2, c3


@pytest.mark.parametrize("rounds", [10, 7])
def test_philox_matches_numpy_uint64(rounds):
    r = np.random.default_rng(6)
    ctr = [r.integers(0, 2 ** 32, size=4096, dtype=np.uint64)
           for _ in range(4)]
    key = tuple(int(v) for v in r.integers(0, 2 ** 32, size=2,
                                           dtype=np.uint64))
    got = rng.philox4x32(key, *(torch.from_numpy(c.astype(np.int64))
                                for c in ctr), rounds=rounds)
    for g, w in zip(got, _philox_numpy(key, ctr, rounds)):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


def test_philox_words_layout():
    """Block j at the counter (step, lane, j, 0) gives words 4j..4j+3; a
    [T, 1] step column and a [W] lane row broadcast."""
    key = rng.key_from_seed(11)
    lane = torch.arange(5, 9)
    steps = torch.tensor([[3], [2 ** 32 - 1]])
    words = rng.philox_words(key, steps, lane, 9)
    assert len(words) == 9 and words[0].shape == (2, 4)
    for j in range(3):
        block = rng.philox4x32(key, steps, lane, j, 0)
        for i in range(4 * j, min(4 * j + 4, 9)):
            assert torch.equal(words[i], block[i - 4 * j])


def _words(seed, n=100_000):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=n,
                                                dtype=np.uint64)


def test_fast_normal_pair_bitwise_equal_to_jax():
    """Bitwise on 1e5 random word pairs: the same float32 operations in
    the same order, and a correctly rounded square root (``sqrt_rn``)."""
    a, b = _words(7), _words(8)
    j1, j2 = jrng.fast_normal_pair(jnp.asarray(a.astype(np.uint32)),
                                   jnp.asarray(b.astype(np.uint32)))
    t1, t2 = rng.fast_normal_pair(torch.from_numpy(a.astype(np.int64)),
                                  torch.from_numpy(b.astype(np.int64)))
    assert t1.dtype == t2.dtype == torch.float32
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))
    # both arms of ln(1-u) and all four quadrants were drawn
    u_a, u_b = a >> 8, b >> 8
    assert (u_a < 0.29 * 2 ** 24).any() and (u_a > 0.29 * 2 ** 24).any()
    assert len(np.unique(u_b // 2 ** 22)) == 4


def test_unpack_pm1_bitwise_equal_to_pallas_expression():
    """pallas_engine.py:611-624 on 1e5 random words."""
    w = _words(9)
    ju = jnp.asarray(w.astype(np.uint32))
    scale = jnp.float32(2.0 ** -15)
    hi = (ju >> jnp.uint32(16)).view(jnp.int32).astype(jnp.float32) \
        * scale - 1.0
    lo = (ju & jnp.uint32(0xFFFF)).view(jnp.int32).astype(jnp.float32) \
        * scale - 1.0
    t_hi, t_lo = rng.unpack_pm1(torch.from_numpy(w.astype(np.int64)))
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(hi))
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(lo))
    assert float(t_hi.min()) >= -1.0 and float(t_lo.max()) < 1.0


def test_sqrt_rn_rounds_to_nearest():
    x = np.random.default_rng(10).random(100_000).astype(np.float32) * 40
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(
        rng.sqrt_rn(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(want, np.sqrt(x))    # IEEE float32 sqrt

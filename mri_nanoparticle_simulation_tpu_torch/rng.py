"""Counter-based random numbers (Threefry-2x32 and Philox4x32-10), in
torch.

Counterpart of the reference's ``rng.py``: the same Threefry (key,
counter) -> bits function, so every (walker, step, word) coordinate
names the same random number in both frameworks, and the port can be
held against the JAX package on identical streams.

The reference's production kernel draws from the TPU's hardware PRNG,
which a GPU does not have.  The port's fast generator in its place is
Philox4x32-10 (Random123), with the reference's polynomial Box-Muller
(``fast_normal_pair``) and 16-bit packed directions (``unpack_pm1``).
Its bits differ from the TPU's, so it is held against the Threefry path
statistically; the CUDA kernel and the plain version here agree bit for
bit.

torch's CPU ``uint32`` has no add, shift or compare, so the words live in
``int64`` tensors masked with ``& 0xFFFFFFFF`` after every operation that
can carry past bit 31.  That form is bitwise equal to the ``uint32``
arithmetic of the reference.  Keys are plain Python ints: there is no
global RNG state.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
# Threefry-2x32 rotation schedule and key-schedule parity (Random123)
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
PARITY = 0x1BD11BDA
#: counter stride between the word pairs of one step (c1 = lane + pair*2^27)
PAIR_STRIDE_SHIFT = 27
# Philox4x32 multipliers and Weyl key increments (Random123)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)

Key = Tuple[int, int]


def key_from_seed(seed: int) -> Key:
    """Threefry key (hi, lo) of a 64-bit integer seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32, seed & MASK)


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(key: Key, c0, c1, rounds: int = 20):
    """Encrypt the counter (c0, c1) under ``key``.  ``c0``/``c1`` are
    int64 tensors (or ints) holding values in [0, 2^32) and broadcast
    together; returns two int64 tensors of words in [0, 2^32)."""
    if rounds % 4 != 0:
        raise ValueError("rounds must be a multiple of 4")
    ks0, ks1 = int(key[0]) & MASK, int(key[1]) & MASK
    ks = (ks0, ks1, ks0 ^ ks1 ^ PARITY)
    x0 = (torch.as_tensor(c0, dtype=torch.int64) + ks0) & MASK
    x1 = (torch.as_tensor(c1, dtype=torch.int64) + ks1) & MASK
    x0, x1 = torch.broadcast_tensors(x0, x1)
    for i in range(rounds):
        x0 = (x0 + x1) & MASK
        x1 = _rotl32(x1, ROTATIONS[i % 8]) ^ x0
        if i % 4 == 3:
            j = i // 4 + 1
            x0 = (x0 + ks[j % 3]) & MASK
            x1 = (x1 + ((ks[(j + 1) % 3] + j) & MASK)) & MASK
    return x0, x1


def words_for_step(key: Key, step, lane, n_words: int,
                   rounds: int = 20) -> list:
    """``n_words`` words for timestep(s) ``step`` and walker lane(s)
    ``lane``: counter ``c0 = step``, ``c1 = lane + (pair << 27)``.  Both
    broadcast, so a ``[T, 1]`` step column and a ``[W]`` lane row give a
    whole window's words in one call."""
    step = torch.as_tensor(step, dtype=torch.int64) & MASK
    lane = torch.as_tensor(lane, dtype=torch.int64) & MASK
    out = []
    for pair in range((n_words + 1) // 2):
        c1 = (lane + (pair << PAIR_STRIDE_SHIFT)) & MASK
        out += threefry2x32(key, step, c1, rounds=rounds)
    return out[:n_words]


def uniform_from_bits(bits: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """Top 24 bits -> a uniform in [0, 1), exactly representable in f32."""
    return (bits >> 8).to(dtype) * (2.0 ** -24)


def normal_from_bits(bits_a: torch.Tensor, bits_b: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
    """Box-Muller: ``sqrt(-2 log(1 - u_a)) cos(2 pi u_b)``.  ``log(1-u)``
    and not ``log1p(-u)``: 1-u is exact for 24-bit uniforms, and the
    reference engines use this form."""
    u_a = uniform_from_bits(bits_a, dtype)
    u_b = uniform_from_bits(bits_b, dtype)
    r = torch.sqrt(-2.0 * torch.log(1.0 - u_a))
    return r * torch.cos(float(2.0 * math.pi) * u_b)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of ``a * m`` for words ``a`` in [0, 2^32) and
    a constant ``m``: a 32x32-bit product overflows int64, so ``m`` is
    split into 16-bit halves and every partial product stays below
    2^48."""
    p = a * (m >> 16)                     # < 2^48
    q = ((p & 0xFFFF) << 16) + a * (m & 0xFFFF)   # < 2^49
    return (p >> 16) + (q >> 32), q & MASK


def philox4x32(key: Key, c0, c1, c2, c3, rounds: int = 10):
    """Philox4x32 (Random123; 10 rounds is the standard strength): encrypt
    the counter (c0, c1, c2, c3) under ``key`` = (k0, k1).  Counters are
    int64 tensors (or ints) in [0, 2^32) that broadcast together; returns
    four int64 tensors of words in [0, 2^32)."""
    k0, k1 = int(key[0]) & MASK, int(key[1]) & MASK
    dev = next((c.device for c in (c0, c1, c2, c3)
                if isinstance(c, torch.Tensor)), None)
    x0, x1, x2, x3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64, device=dev) & MASK
          for c in (c0, c1, c2, c3)))
    for r in range(rounds):
        if r:
            k0 = (k0 + PHILOX_W[0]) & MASK
            k1 = (k1 + PHILOX_W[1]) & MASK
        hi0, lo0 = _mulhilo(x0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(x2, PHILOX_M[1])
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
    return x0, x1, x2, x3


def philox_words(key: Key, step, lane, n_words: int) -> list:
    """``n_words`` words for the step(s) ``step`` and walker lane(s)
    ``lane`` of the fast generator: Philox block j at the counter (step,
    lane, j, 0) gives words 4j..4j+3.  Both broadcast, as in
    ``words_for_step``."""
    lane = torch.as_tensor(lane, dtype=torch.int64) & MASK
    step = torch.as_tensor(step, dtype=torch.int64,
                           device=lane.device) & MASK
    out = []
    for j in range((n_words + 3) // 4):
        out += philox4x32(key, step, lane, j, 0)
    return out[:n_words]


# Polynomial transcendentals of the fast generator: the reference's
# coefficients (rng.py:173-189), rounded to float32 here as JAX's weak
# typing rounds them where they meet a float32 array.
def _f32(v: float) -> float:
    return float(np.float32(v))


LOG2_C = tuple(map(_f32, (1.4426688869485185, -0.7201758216206064,
                          0.4680272392716005, -0.3010465580177073,
                          0.14468375751156232, -0.03417634452694971)))
COS_C = tuple(map(_f32, (0.9999999672698001, -1.23369874640111,
                         0.25365382913455387, -0.02081621162152305,
                         0.0008612932951789545)))
SIN_C = tuple(map(_f32, (1.5707963220855086, -0.6459638380556043,
                         0.07969037204200492, -0.004674963271538138,
                         0.00015212617510292162)))
LN1M_C = tuple(map(_f32, (0.9999997031078102, 0.5000403028246534,
                          0.3320388732188125, 0.2663687307521427,
                          0.10610806995246555, 0.3989336089305266)))
LN2 = _f32(0.6931471805599453)
#: below it ln(1-u) takes the direct series (the exponent/mantissa route
#: cancels near v = 1 - u = 1)
LN_SMALL_U = _f32(0.29)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded to nearest, as CUDA's ``sqrtf`` and
    XLA's: torch's vectorised CPU ``sqrt`` is off by one ulp for about
    0.7% of inputs.  The float64 root of a float32 rounds correctly."""
    return torch.sqrt(x.double()).to(x.dtype)


def _poly(x: torch.Tensor, coeffs) -> torch.Tensor:
    """Horner, highest coefficient first, one multiply and one add per
    step (never fused: the CUDA build uses --fmad=false)."""
    acc = x * coeffs[-1] + coeffs[-2]
    for c in coeffs[-3::-1]:
        acc = acc * x + c
    return acc


def fast_normal_pair(bits_a: torch.Tensor, bits_b: torch.Tensor):
    """Two standard normals from two words by Box-Muller with polynomial
    log, cos and sin (float32), operation by operation as the
    reference's ``rng.fast_normal_pair``: ln(1-u) by the exponent/
    mantissa split and a degree-6 log2 polynomial, or by a direct series
    for u < 0.29; cos and sin of 2 pi u' by quadrant reduction and
    degree-4 polynomials in f^2.  Agrees with the exact formulas to
    about 1e-5 sigma."""
    f32 = torch.float32
    u_a = uniform_from_bits(bits_a, f32)
    u_b = uniform_from_bits(bits_b, f32)
    v = 1.0 - u_a                       # in (2^-24, 1], exact
    vb = v.view(torch.int32)
    e = ((vb >> 23) & 0xFF) - 127
    m = ((vb & 0x7FFFFF) | 0x3F800000).view(f32)
    t = m - 1.0
    ln_big = LN2 * (e.to(f32) + t * _poly(t, LOG2_C))
    ln_small = -u_a * _poly(u_a, LN1M_C)
    ln_v = torch.where(u_a < LN_SMALL_U, ln_small, ln_big)
    r = sqrt_rn(torch.clamp_min(-2.0 * ln_v, 0.0))
    a = u_b * 4.0
    q = torch.floor(a)
    f = a - q
    f2 = f * f
    c0 = _poly(f2, COS_C)
    s0 = f * _poly(f2, SIN_C)
    qi = q.to(torch.int32)
    cosv = torch.where(qi == 0, c0, torch.where(
        qi == 1, -s0, torch.where(qi == 2, -c0, s0)))
    sinv = torch.where(qi == 0, s0, torch.where(
        qi == 1, c0, torch.where(qi == 2, -s0, -c0)))
    return r * cosv, r * sinv


def unpack_pm1(word: torch.Tensor):
    """Two values in [-1, 1) from one word's 16-bit halves (high, low):
    ``half * 2^-15 - 1``, exact in float32 (pallas_engine.py:611-624)."""
    hi = (word >> 16).to(torch.float32)
    lo = (word & 0xFFFF).to(torch.float32)
    return hi * 2.0 ** -15 - 1.0, lo * 2.0 ** -15 - 1.0

"""Counter-based generators of the simulator, in plain PyTorch.

Threefry-2x32 (the reproducible path) and Philox4x32-10 with the
polynomial Box-Muller and 16-bit packed directions (the fast generator),
written from their published definitions (Random123) and the
simulator's documented use of them: counter ``(step, lane + pair<<27)``
for Threefry, ``(step, lane, block, 0)`` for Philox, uniforms from the
top 24 bits.  Words live in int64 tensors masked to 32 bits.  Every
step counter is a tensor, so walkers of different chunks draw side by
side.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
PARITY = 0x1BD11BDA
PAIR_SHIFT = 27
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def key_of(seed: int) -> tuple:
    """(hi, lo) 32-bit halves of a 64-bit seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed >> 32, seed & MASK


def threefry(key, c0, c1, rounds: int = 20):
    ks0, ks1 = int(key[0]) & MASK, int(key[1]) & MASK
    ks = (ks0, ks1, ks0 ^ ks1 ^ PARITY)
    x0 = (c0 + ks0) & MASK
    x1 = (c1 + ks1) & MASK
    x0, x1 = torch.broadcast_tensors(x0, x1)
    for i in range(rounds):
        x0 = (x0 + x1) & MASK
        r = ROTATIONS[i % 8]
        x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        if i % 4 == 3:
            j = i // 4 + 1
            x0 = (x0 + ks[j % 3]) & MASK
            x1 = (x1 + ((ks[(j + 1) % 3] + j) & MASK)) & MASK
    return x0, x1


def threefry_words(key, step, lane, n_words: int, rounds: int = 20):
    """``n_words`` words at int64 ``step`` and ``lane`` (broadcasting)."""
    out = []
    for pair in range((n_words + 1) // 2):
        out += threefry(key, step & MASK,
                        (lane + (pair << PAIR_SHIFT)) & MASK, rounds)
    return out[:n_words]


def _mulhilo(a, m: int):
    p = a * (m >> 16)
    q = ((p & 0xFFFF) << 16) + a * (m & 0xFFFF)
    return (p >> 16) + (q >> 32), q & MASK


def philox_words(key, step, lane, n_words: int):
    """Philox4x32-10 block j at counter (step, lane, j, 0) gives words
    4j..4j+3."""
    out = []
    step, lane = torch.broadcast_tensors(step & MASK, lane & MASK)
    for j in range((n_words + 3) // 4):
        k0, k1 = int(key[0]) & MASK, int(key[1]) & MASK
        x0, x1 = step, lane
        x2 = torch.full_like(step, j)
        x3 = torch.zeros_like(step)
        for r in range(10):
            if r:
                k0 = (k0 + PHILOX_W[0]) & MASK
                k1 = (k1 + PHILOX_W[1]) & MASK
            hi0, lo0 = _mulhilo(x0, PHILOX_M[0])
            hi1, lo1 = _mulhilo(x2, PHILOX_M[1])
            x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        out += [x0, x1, x2, x3]
    return out[:n_words]


def uniform(bits, dtype):
    """Top 24 bits -> [0, 1)."""
    return (bits >> 8).to(dtype) * (2.0 ** -24)


def sqrt_rn(x):
    """Square root rounded to nearest (through float64)."""
    return torch.sqrt(x.double()).to(x.dtype)


def normal(bits_a, bits_b, dtype):
    """Box-Muller ``sqrt(-2 log(1 - u_a)) cos(2 pi u_b)``."""
    u_a, u_b = uniform(bits_a, dtype), uniform(bits_b, dtype)
    return torch.sqrt(-2.0 * torch.log(1.0 - u_a)) * torch.cos(
        float(2.0 * math.pi) * u_b)


def _f32(v):
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
LN_SMALL_U = _f32(0.29)


def _horner(x, coeffs):
    acc = x * coeffs[-1] + coeffs[-2]
    for c in coeffs[-3::-1]:
        acc = acc * x + c
    return acc


def fast_normal_pair(bits_a, bits_b):
    """Two float32 normals from two words: ln(1-u) by the exponent and
    mantissa split and a degree-6 log2 polynomial (a direct series below
    u = 0.29), cos and sin of 2 pi u by quadrant and degree-4
    polynomials."""
    f32 = torch.float32
    u_a = uniform(bits_a, f32)
    u_b = uniform(bits_b, f32)
    v = 1.0 - u_a
    vb = v.view(torch.int32)
    e = (((vb >> 23) & 0xFF) - 127).to(f32)
    t = ((vb & 0x7FFFFF) | 0x3F800000).view(f32) - 1.0
    ln_big = LN2 * (e + t * _horner(t, LOG2_C))
    ln_small = -u_a * _horner(u_a, LN1M_C)
    ln_v = torch.where(u_a < LN_SMALL_U, ln_small, ln_big)
    r = sqrt_rn(torch.clamp_min(-2.0 * ln_v, 0.0))
    a = u_b * 4.0
    q = torch.floor(a)
    f = a - q
    f2 = f * f
    c0 = _horner(f2, COS_C)
    s0 = f * _horner(f2, SIN_C)
    qi = q.to(torch.int32)
    cosv = torch.where(qi == 0, c0, torch.where(
        qi == 1, -s0, torch.where(qi == 2, -c0, s0)))
    sinv = torch.where(qi == 0, s0, torch.where(
        qi == 1, c0, torch.where(qi == 2, -s0, -c0)))
    return r * cosv, r * sinv


def unpack_pm1(word):
    """Two float32 values in [-1, 1) from a word's 16-bit halves (high,
    low)."""
    hi = (word >> 16).to(torch.float32)
    lo = (word & 0xFFFF).to(torch.float32)
    return hi * 2.0 ** -15 - 1.0, lo * 2.0 ** -15 - 1.0

"""NumPy port of the Threefry-2x32 counter-based RNG for host-side scene
construction.

The reference builds its scene with a stateful xoroshiro128+ generator
seeded from ``time(NULL)`` (src/xorshift.h, cuda_sim.cu:911-912) — every
run gets a different scene.  We use the same Threefry stream cipher as the
device engine (see ``rng.py``), implemented here in pure NumPy so that

* scene construction needs no JAX/device round-trips,
* the C++ native scene builder (csrc/scene_builder.cpp) can reproduce the
  exact same bitstream, making the native and Python paths bit-identical
  and cross-testable.

Verified against the same Random123 known-answer vectors as the JAX
implementation (tests/test_scene.py).
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = np.uint32(0x1BD11BDA)


def threefry2x32_np(key, c0, c1, rounds: int = 20):
    """NumPy Threefry-2x32; mirrors rng.threefry2x32 exactly."""
    old = np.seterr(over="ignore")  # uint32 wraparound is the point
    try:
        ks0 = np.uint32(key[0])
        ks1 = np.uint32(key[1])
        ks2 = ks0 ^ ks1 ^ _PARITY
        ks = (ks0, ks1, ks2)
        x0 = np.asarray(c0, np.uint32) + ks0
        x1 = np.asarray(c1, np.uint32) + ks1
        for i in range(rounds):
            x0 = x0 + x1
            r = _ROTATIONS[i % 8]
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
            if i % 4 == 3:
                j = i // 4 + 1
                x0 = x0 + ks[j % 3]
                x1 = x1 + ks[(j + 1) % 3] + np.uint32(j)
        return x0, x1
    finally:
        np.seterr(**old)


class CounterRNG:
    """Sequential uniform stream over a Threefry counter.

    Plays the role of the reference's ``XORShift<> gen`` handed to the scene
    builders (BacteriaBox.cpp:55-57,90-92), but reproducible and portable.
    Uniforms use the top 24 bits (same convention as the device engine).
    """

    def __init__(self, seed: int, stream: int = 0):
        seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        self.key = (np.uint32(seed >> 32), np.uint32(seed & 0xFFFFFFFF))
        self.stream = np.uint32(stream)
        self.counter = 0

    def uniforms(self, n: int) -> np.ndarray:
        """Next ``n`` uniforms in [0, 1) as float64 (values exactly
        representable in float32)."""
        n_pairs = (n + 1) // 2
        c0 = (np.arange(n_pairs, dtype=np.uint64) +
              np.uint64(self.counter)).astype(np.uint32)
        c1 = np.full(n_pairs, self.stream, np.uint32)
        w0, w1 = threefry2x32_np(self.key, c0, c1)
        self.counter += n_pairs
        bits = np.stack([w0, w1], axis=-1).reshape(-1)[:n]
        return (bits >> np.uint32(8)).astype(np.float64) * 2.0 ** -24

    def uniform3(self) -> np.ndarray:
        return self.uniforms(3)

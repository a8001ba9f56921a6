// Native scene builder: C++ fast path for host-side scene construction.
//
// The reference builds its scene in host C++ (src/SimulationBox.cpp,
// src/BacteriaBox.cpp); this library is the TPU framework's native
// equivalent, used for large scenes (thousands of cells, 100k+ waters)
// where the NumPy path's per-throw Python loop dominates.  It reproduces
// the Python implementation BIT FOR BIT: the same Threefry-2x32 streams
// (scene/nprng.py), the same rejection loops (scene/box.py), the same
// IEEE-754 double arithmetic — scene/native.py cross-checks equality in
// tests.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kParity = 0x1BD11BDA;
constexpr int kRotations[8] = {13, 15, 26, 6, 17, 29, 16, 24};

inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds; mirrors rng.threefry2x32 / nprng exactly.
inline void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                         uint32_t* out0, uint32_t* out1) {
  uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
  for (int i = 0; i < 20; ++i) {
    x0 += x1;
    x1 = rotl32(x1, kRotations[i % 8]);
    x1 ^= x0;
    if (i % 4 == 3) {
      int j = i / 4 + 1;
      x0 += ks[j % 3];
      x1 += ks[(j + 1) % 3] + static_cast<uint32_t>(j);
    }
  }
  *out0 = x0;
  *out1 = x1;
}

// Sequential uniform stream: mirrors scene/nprng.py CounterRNG.
// uniforms(n) consumes ceil(n/2) counters and discards the trailing word
// when n is odd — replicated exactly.
struct CounterRNG {
  uint32_t k0, k1, stream;
  uint64_t counter = 0;

  CounterRNG(uint64_t seed, uint32_t stream_id)
      : k0(static_cast<uint32_t>(seed >> 32)),
        k1(static_cast<uint32_t>(seed & 0xFFFFFFFFull)),
        stream(stream_id) {}

  void uniform3(double* u) {
    uint32_t w0, w1, w2, w3;
    threefry2x32(k0, k1, static_cast<uint32_t>(counter), stream, &w0, &w1);
    threefry2x32(k0, k1, static_cast<uint32_t>(counter + 1), stream, &w2,
                 &w3);
    counter += 2;
    u[0] = static_cast<double>(w0 >> 8) * 0x1.0p-24;
    u[1] = static_cast<double>(w1 >> 8) * 0x1.0p-24;
    u[2] = static_cast<double>(w2 >> 8) * 0x1.0p-24;
    (void)w3;  // the odd-n discard, as in CounterRNG.uniforms(3)
  }
};

}  // namespace

extern "C" {

// KAT hook so Python can verify the stream implementation directly.
void scene_threefry(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                    uint32_t* out) {
  threefry2x32(k0, k1, c0, c1, out, out + 1);
}

// Rejection-throw non-overlapping cells (BacteriaBox::init_cells,
// BacteriaBox.cpp:49-72; scene/box.py init_cells).  out: [num_cells*3].
// Returns the number of throws performed.
int64_t scene_build_cells(uint64_t seed, uint32_t stream, int num_cells,
                          double cell_r, double bound, double* out) {
  CounterRNG gen(seed, stream);
  const double lo = cell_r;
  const double span = bound - 2.0 * cell_r;
  const double min_d2 = 4.0 * cell_r * cell_r;
  int64_t throws = 0;
  for (int i = 0; i < num_cells; ++i) {
    for (;;) {
      double u[3];
      gen.uniform3(u);
      ++throws;
      const double x = lo + u[0] * span;
      const double y = lo + u[1] * span;
      const double z = lo + u[2] * span;
      bool ok = true;
      for (int j = 0; j < i; ++j) {
        const double dx = out[3 * j] - x;
        const double dy = out[3 * j + 1] - y;
        const double dz = out[3 * j + 2] - z;
        if (dx * dx + dy * dy + dz * dz < min_d2) {
          ok = false;
          break;
        }
      }
      if (ok || i == 0) {
        out[3 * i] = x;
        out[3 * i + 1] = y;
        out[3 * i + 2] = z;
        break;
      }
    }
  }
  return throws;
}

// Throw waters in the centered sub-cube, optionally rejecting
// intracellular throws (BacteriaBox::init_waters, BacteriaBox.cpp:80-105;
// scene/box.py init_waters).  out: [num_water*3].
int64_t scene_build_waters(uint64_t seed, uint32_t stream, int num_water,
                           const double* cells, int num_cells, double cell_r,
                           double bound, double water_start_bound,
                           int avoid_intracellular, double* out) {
  CounterRNG gen(seed, stream);
  const double offset = (bound - water_start_bound) / 2.0;
  const double r2 = cell_r * cell_r;
  int64_t throws = 0;
  for (int i = 0; i < num_water; ++i) {
    for (;;) {
      double u[3];
      gen.uniform3(u);
      ++throws;
      const double x = offset + u[0] * water_start_bound;
      const double y = offset + u[1] * water_start_bound;
      const double z = offset + u[2] * water_start_bound;
      bool ok = true;
      if (avoid_intracellular) {
        for (int j = 0; j < num_cells; ++j) {
          const double dx = cells[3 * j] - x;
          const double dy = cells[3 * j + 1] - y;
          const double dz = cells[3 * j + 2] - z;
          if (dx * dx + dy * dy + dz * dz < r2) {
            ok = false;
            break;
          }
        }
      }
      if (ok) {
        out[3 * i] = x;
        out[3 * i + 1] = y;
        out[3 * i + 2] = z;
        break;
      }
    }
  }
  return throws;
}

// Nearest-cell lookup table (SimulationBox::init_lookuptable,
// SimulationBox.cpp:262-290; scene/lookup.py).  out: [hash_dim^3 * maxn]
// int32, -1 padded.  Returns the max candidate count (caller enforces the
// strict < maxn rule), or -1 on overflow.
int32_t scene_build_lookup(const double* cells, int num_cells, int hash_dim,
                           double bound, double cell_r, int maxn,
                           int32_t* out) {
  const double cl = bound / hash_dim;
  const double reach = cell_r + std::sqrt(3.0) * cl;
  const double reach2 = reach * reach;
  const int64_t total = static_cast<int64_t>(hash_dim) * hash_dim * hash_dim;
  int32_t worst = 0;
  for (int64_t i = 0; i < total; ++i) {
    const double x = static_cast<double>(i % hash_dim) * cl;
    const double y = static_cast<double>((i / hash_dim) % hash_dim) * cl;
    const double z = static_cast<double>(i / (hash_dim * hash_dim)) * cl;
    int32_t count = 0;
    int32_t* row = out + i * maxn;
    for (int j = 0; j < num_cells; ++j) {
      const double dx = x - cells[3 * j];
      const double dy = y - cells[3 * j + 1];
      const double dz = z - cells[3 * j + 2];
      if (dx * dx + dy * dy + dz * dz < reach2) {
        if (count >= maxn) return -1;
        row[count++] = j;
      }
    }
    for (int32_t s = count; s < maxn; ++s) row[s] = -1;
    if (count > worst) worst = count;
  }
  return worst;
}

}  // extern "C"

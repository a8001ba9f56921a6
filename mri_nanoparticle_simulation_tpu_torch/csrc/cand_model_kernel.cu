// The large-scene chunk rebuild for every walker, on Hopper.
//
// Replaces the TPU kernel fields/expansion.py:_make_cand_model_kernel
// (mri_nanoparticle_simulation_tpu/fields/expansion.py:497-649) together
// with the XLA gathers of its caller build_planes (:652-709).  Per walker,
// over the C candidates of its cube:
//
//   1. exact f32 K-nearest by sorted insertion of the distances and slot
//      ids alone (strict '<', so ties keep the earlier candidate), and the
//      count of candidates within reach2 (the coverage sentinel); then the
//      K winners' (x, y, z, M * FIELD_SCALE) fetched from the row by slot;
//   2. the mid sums (value, gradient, Hessian) of the candidates not
//      selected, in candidate order, walking the bits of a mask of the
//      unselected ones per 32 candidates;
//   3. the cube's far-table polynomial (fields/fartable.py) at the offset
//      e = p - (ci + 0.5) * cube, added onto the mid sums, unrolled at
//      compile time for each order (field_math.cuh:add_far_table); orders
//      1-7 in one kernel per K, order 8 in another.
//
// Outputs are the near/taylor inputs of chunk_kernel.cuh's
// chunk_near_kernel: near f32[4, K, w] (x, y, z, M * FIELD_SCALE), taylor
// f32[10, w], and n_reach f32[w].  The plain PyTorch version is
// fields/expansion.py:cand_model_reference.
//
// What holds it on the H100: issue slots (4086 float operations a walker
// by port_bench/work/counts.py:cand_model_work at the scale-up's K 10, C 32,
// order 5, each its own instruction with --fmad=false, against 0.25 KB of
// device memory a walker) and the latency of the candidate rows, which
// the 100096 walkers read in no spatial order.  So: the scene's
// candidate table comes in the kernel's layout, f32[h^3, C, 4]
// (SceneCache.cand_table, made once per scene), one 16-byte load per
// candidate and pass; the selection moves two arrays of K registers, not
// six, so the kernel fits the 80 registers of 6 resident 128-thread
// blocks per SM and 100096 walkers are one wave on 132 SMs; the
// polynomial forms each monomial once, with the integer factors and
// exponents known at compile time.  The rows (2 MB) and the far table
// (0.9 MB) stay in the 50 MB L2.

#include "field_math.cuh"

namespace {

// Resident blocks per SM the kernel is compiled for: 6 (at most 80
// registers; 782 blocks of 100096 walkers in one wave of 792) up to far-
// table order kWaveMaxOrder.  Order 8's polynomial needs more registers
// (at 80 it spilled 84 bytes), so it is a kernel of its own (kHigh),
// compiled for 4.
constexpr int kWaveMaxOrder = 7;

template <int K, bool kHigh>
__global__ void __launch_bounds__(kBlock, kHigh ? 4 : 6)
cand_model_kernel(const float* __restrict__ pos,
                  const float4* __restrict__ cand,
                  const float* __restrict__ coeffs, float* __restrict__ near,
                  float* __restrict__ taylor, float* __restrict__ n_reach,
                  int w, int c, int nc, int order, int h, float cube,
                  float reach2) {
  const int gid = blockIdx.x * kBlock + threadIdx.x;
  if (gid >= w) return;
  const float ax = pos[gid];
  const float ay = pos[w + gid];
  const float az = pos[2 * w + gid];
  // the cube, as build_planes: clip(int(p / cube), 0, h - 1)
  const int cix = min(max(static_cast<int>(ax / cube), 0), h - 1);
  const int ciy = min(max(static_cast<int>(ay / cube), 0), h - 1);
  const int ciz = min(max(static_cast<int>(az / cube), 0), h - 1);
  const int flat = (cix * h + ciy) * h + ciz;
  const float4* __restrict__ row = cand + static_cast<size_t>(flat) * c;

  // 1. selection and the coverage count, then the winners by slot
  float sd[K];
  int sid[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    sd[s] = 1e30f;
    sid[s] = -1;
  }
  float cnt = 0.f;
#pragma unroll 8
  for (int j = 0; j < c; ++j) {
    const float4 v = __ldg(row + j);
    const float dx = ax - v.x;
    const float dy = ay - v.y;
    const float dz = az - v.z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    cnt = cnt + (d2 < reach2 ? 1.f : 0.f);
    sorted_insert_ids<K>(sd, sid, d2, j);
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const float4 v = sid[s] >= 0 ? __ldg(row + sid[s])
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    near[(0 * K + s) * w + gid] = v.x;
    near[(1 * K + s) * w + gid] = v.y;
    near[(2 * K + s) * w + gid] = v.z;
    near[(3 * K + s) * w + gid] = v.w;
  }

  // 2. mid sums over the candidates not selected, 32 candidates at a
  // time: the bits of `rest` are the tile's candidates left, lowest first.
  // Every walker has K selected, so the lanes of a warp loop alike.  The
  // plain version adds every candidate's parts times 0 or 1; the sum
  // starts at +0, so leaving out a zero term changes no bit.
  float t[10];
#pragma unroll
  for (int q = 0; q < 10; ++q) t[q] = 0.f;
  for (int base = 0; base < c; base += 32) {
    const int n = min(32, c - base);
    unsigned rest = n == 32 ? ~0u : (1u << n) - 1u;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const unsigned off = static_cast<unsigned>(sid[s] - base);
      rest &= off < 32u ? ~(1u << off) : ~0u;
    }
    while (rest != 0u) {
      const int j = base + __ffs(rest) - 1;
      rest &= rest - 1u;
      const float4 v = __ldg(row + j);
      float p[10];
      bz_taylor_parts(ax - v.x, ay - v.y, az - v.z, v.w, p);
#pragma unroll
      for (int q = 0; q < 10; ++q) t[q] = t[q] + p[q];
    }
  }

  // 3. the far-table polynomial about the cube centre
  const float ex = ax - (static_cast<float>(cix) + 0.5f) * cube;
  const float ey = ay - (static_cast<float>(ciy) + 0.5f) * cube;
  const float ez = az - (static_cast<float>(ciz) + 0.5f) * cube;
  const float* __restrict__ co = coeffs + static_cast<size_t>(flat) * nc;
  if constexpr (kHigh) {
    static_assert(kMaxOrder == kWaveMaxOrder + 1, "one high order");
    add_far_table<kMaxOrder>(co, ex, ey, ez, t);
  } else {
    switch (order) {
      case 1: add_far_table<1>(co, ex, ey, ez, t); break;
      case 2: add_far_table<2>(co, ex, ey, ez, t); break;
      case 3: add_far_table<3>(co, ex, ey, ez, t); break;
      case 4: add_far_table<4>(co, ex, ey, ez, t); break;
      case 5: add_far_table<5>(co, ex, ey, ez, t); break;
      case 6: add_far_table<6>(co, ex, ey, ez, t); break;
      default: add_far_table<7>(co, ex, ey, ez, t); break;
    }
  }

#pragma unroll
  for (int q = 0; q < 10; ++q) taylor[q * w + gid] = t[q];
  n_reach[gid] = cnt;
}

// The kernel for `near_k` and far-table `order`; false for a K or an
// order it is not instantiated for.
bool cand_kernel(int near_k, int order, const void*& fn) {
  if (order < 1 || order > kMaxOrder) return false;
  return dispatch_k(near_k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    fn = order > kWaveMaxOrder
        ? reinterpret_cast<const void*>(cand_model_kernel<K, true>)
        : reinterpret_cast<const void*>(cand_model_kernel<K, false>);
  });
}

}  // namespace

// Launch the rebuild of `w` walkers: `pos` f32[3, w] wrapped anchors,
// `cand` f32[h^3, c, 4] (x, y, z, M * FIELD_SCALE), `coeffs` f32[h^3, nc]
// with nc the monomial count of `order`, both 16-byte aligned.  Returns a
// cudaError_t: cudaErrorInvalidValue for arguments the kernel does not
// take, else cudaGetLastError().
extern "C" int cand_model_launch(int device, void* stream, const float* pos,
                                 const float* cand, const float* coeffs,
                                 float* near, float* taylor, float* n_reach,
                                 int w, int near_k, int c, int nc, int order,
                                 int h, float cube, float reach2) {
  const void* fn = nullptr;
  if (w <= 0 || c < near_k || h <= 0 || nc != n_coeffs(order) ||
      reinterpret_cast<size_t>(cand) % 16 != 0 ||
      reinterpret_cast<size_t>(coeffs) % 16 != 0 ||
      !cand_kernel(near_k, order, fn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float4* rows = reinterpret_cast<const float4*>(cand);
  void* args[] = {&pos, &rows, &coeffs, &near, &taylor, &n_reach, &w, &c,
                  &nc, &order, &h, &cube, &reach2};
  err = cudaLaunchKernel(fn, dim3((w + kBlock - 1) / kBlock), dim3(kBlock),
                         args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The kernel of `near_k` and `order` as the runtime reports it
// (field_math.cuh:kernel_info): registers, resident blocks per SM,
// dynamic shared-memory bytes (0), threads per block and local-memory
// bytes per thread, into out[0..4].  Returns a cudaError_t.
extern "C" int cand_model_info(int near_k, int order, int* out) {
  const void* fn = nullptr;
  if (out == nullptr || !cand_kernel(near_k, order, fn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return kernel_info(fn, kBlock, 0, out);
}

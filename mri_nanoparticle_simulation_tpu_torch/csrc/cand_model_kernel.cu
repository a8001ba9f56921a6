// The large-scene chunk rebuild for every walker, on Hopper.
//
// Replaces the TPU kernel fields/expansion.py:_make_cand_model_kernel
// (mri_nanoparticle_simulation_tpu/fields/expansion.py:497-649) together
// with the XLA gathers of its caller build_planes (:652-709).  Per walker,
// over the C candidates of its cube:
//
//   1. exact f32 K-nearest by sorted insertion (strict '<', so ties keep
//      the earlier candidate), tracking the candidate's slot id, and the
//      count of candidates within reach2 (the coverage sentinel);
//   2. the mid sums (value, gradient, Hessian) of the candidates not
//      selected, excluded by slot id, in candidate order;
//   3. the cube's far-table polynomial (fields/fartable.py) at the offset
//      e = p - (ci + 0.5) * cube, added onto the mid sums.
//
// Outputs are the near/taylor inputs of csrc/chunk_kernel.cu's
// chunk_near_kernel: near f32[4, K, w] (x, y, z, M * FIELD_SCALE), taylor
// f32[10, w], and n_reach f32[w].  The plain PyTorch version is
// fields/expansion.py:cand_model_reference.
//
// What bounds it on the H100: the candidate rows.  A walker reads its
// cube's [C, 5] payload row twice (selection, then mid sums) and its
// n_coeffs coefficients once, straight from the scene tables; at the
// scale-up size those tables are 2.6 MB and 0.9 MB, so they stay in the
// 50 MB L2 and the [4, C, W] candidate slab the TPU kernel streamed
// (51 MB per chunk at 100k walkers) is never formed.  The K slots and the
// 10 sums live in registers (the kernel is templated on K).  The
// far-table monomials are enumerated by loops at run time, in
// fartable.monomials' order, so one instantiation serves every order.

#include "field_math.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(kBlock)
cand_model_kernel(const float* __restrict__ pos,
                  const float* __restrict__ payload,
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
  const float* __restrict__ row = payload + static_cast<size_t>(flat) * c * 5;

  // 1. selection and the coverage count
  float sd[K], nx[K], ny[K], nz[K], nm[K];
  int sid[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    sd[s] = 1e30f;
    nx[s] = 0.f;
    ny[s] = 0.f;
    nz[s] = 0.f;
    nm[s] = 0.f;
    sid[s] = -1;
  }
  float cnt = 0.f;
  for (int j = 0; j < c; ++j) {
    const float x0 = row[j * 5];
    const float y0 = row[j * 5 + 1];
    const float z0 = row[j * 5 + 2];
    const float m0 = row[j * 5 + 3] * kFieldScale;
    const float dx = ax - x0;
    const float dy = ay - y0;
    const float dz = az - z0;
    const float d2 = dx * dx + dy * dy + dz * dz;
    cnt = cnt + (d2 < reach2 ? 1.f : 0.f);
    sorted_insert<K>(sd, nx, ny, nz, nm, sid, d2, x0, y0, z0, m0, j);
  }

  // 2. mid sums over the candidates not selected
  float t[10];
#pragma unroll
  for (int q = 0; q < 10; ++q) t[q] = 0.f;
  for (int j = 0; j < c; ++j) {
    add_unselected<K>(t, sid, j, ax, ay, az, row[j * 5], row[j * 5 + 1],
                      row[j * 5 + 2], row[j * 5 + 3] * kFieldScale);
  }

  // 3. the far-table polynomial about the cube centre
  const float ex = ax - (static_cast<float>(cix) + 0.5f) * cube;
  const float ey = ay - (static_cast<float>(ciy) + 0.5f) * cube;
  const float ez = az - (static_cast<float>(ciz) + 0.5f) * cube;
  add_far_table(coeffs + static_cast<size_t>(flat) * nc, order, ex, ey, ez,
                t);

#pragma unroll
  for (int s = 0; s < K; ++s) {
    near[(0 * K + s) * w + gid] = nx[s];
    near[(1 * K + s) * w + gid] = ny[s];
    near[(2 * K + s) * w + gid] = nz[s];
    near[(3 * K + s) * w + gid] = nm[s];
  }
#pragma unroll
  for (int q = 0; q < 10; ++q) taylor[q * w + gid] = t[q];
  n_reach[gid] = cnt;
}

}  // namespace

// Launch the rebuild of `w` walkers: `pos` f32[3, w] wrapped anchors,
// `payload` f32[h^3, c, 5], `coeffs` f32[h^3, nc] with nc the monomial
// count of `order`.  Returns a cudaError_t: cudaErrorInvalidValue for
// arguments the kernel does not take, else cudaGetLastError().
extern "C" int cand_model_launch(int device, void* stream, const float* pos,
                                 const float* payload, const float* coeffs,
                                 float* near, float* taylor, float* n_reach,
                                 int w, int near_k, int c, int nc, int order,
                                 int h, float cube, float reach2) {
  if (w <= 0 || c < near_k || h <= 0 || order < 1 || order > kMaxOrder ||
      nc != (order + 1) * (order + 2) * (order + 3) / 6) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (w + kBlock - 1) / kBlock;
  const bool ok = dispatch_k(near_k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    cand_model_kernel<K><<<blocks, kBlock, 0, s>>>(
        pos, payload, coeffs, near, taylor, n_reach, w, c, nc, order, h,
        cube, reach2);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

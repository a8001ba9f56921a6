// Far-field value, gradient and Hessian at every walker anchor, on Hopper.
//
// Replaces the TPU kernel fields/expansion.py:_make_far_sums_kernel
// (mri_nanoparticle_simulation_tpu/fields/expansion.py:358-421, driven by
// _far_sums_pallas :424-444): per anchor, the sum over the whole dipole
// table of bz_taylor_parts, leaving out the K near dipoles by global
// index.  The plain PyTorch version is
// fields/expansion.py:far_sums_reference.
//
// What bounds it on the H100: float work, ~60 operations per (walker,
// dipole) pair, with every thread reading the same dipole at the same
// time.  One thread per walker keeps its 10 sums and its K near ids in
// registers (templated on K); the table, f32[4, n_pad] (5256 entries,
// 84 KB, at the scale-up size: above the 48 KB static limit), streams
// through a 16 KB shared-memory tile that the block loads together.  The
// sum runs in table order, as the reference loop does, and as the far
// pass of csrc/chunk_kernel.cu's rebuild, whose term it shares
// (field_math.cuh:add_unselected).

#include "field_math.cuh"

namespace {

constexpr int kTile = 1024;

template <int K>
__global__ void __launch_bounds__(kBlock)
far_sums_kernel(const float* __restrict__ mnp, int n_pad,
                const float* __restrict__ anchor, const int* __restrict__ idx,
                float* __restrict__ taylor, int w) {
  __shared__ float s_tbl[4][kTile];
  const int tid = threadIdx.x;
  const int gid = blockIdx.x * kBlock + tid;
  const bool valid = gid < w;
  const int g = valid ? gid : 0;
  const float ax = anchor[g];
  const float ay = anchor[w + g];
  const float az = anchor[2 * w + g];
  int sid[K];
#pragma unroll
  for (int s = 0; s < K; ++s) sid[s] = idx[s * w + g];
  float t[10];
#pragma unroll
  for (int c = 0; c < 10; ++c) t[c] = 0.f;

  for (int base = 0; base < n_pad; base += kTile) {
    const int n = min(kTile, n_pad - base);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < n; i += kBlock) {
      s_tbl[0][i] = mnp[base + i];
      s_tbl[1][i] = mnp[n_pad + base + i];
      s_tbl[2][i] = mnp[2 * n_pad + base + i];
      s_tbl[3][i] = mnp[3 * n_pad + base + i];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      add_unselected<K>(t, sid, base + j, ax, ay, az, s_tbl[0][j],
                        s_tbl[1][j], s_tbl[2][j], s_tbl[3][j]);
    }
  }
  if (valid) {
#pragma unroll
    for (int c = 0; c < 10; ++c) taylor[c * w + gid] = t[c];
  }
}

}  // namespace

// Launch the far sums of `w` anchors: `mnp` f32[4, n_pad] (x, y, z,
// M * FIELD_SCALE), `anchor` f32[3, w], `idx` i32[near_k, w] global ids of
// the near dipoles, `taylor` f32[10, w] out.  Returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernel does not take, else
// cudaGetLastError().
extern "C" int far_sums_launch(int device, void* stream, const float* mnp,
                               int n_pad, const float* anchor,
                               const int* idx, float* taylor, int w,
                               int near_k) {
  if (w <= 0 || n_pad <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (w + kBlock - 1) / kBlock;
  const bool ok = dispatch_k(near_k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    far_sums_kernel<K><<<blocks, kBlock, 0, s>>>(mnp, n_pad, anchor, idx,
                                                 taylor, w);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

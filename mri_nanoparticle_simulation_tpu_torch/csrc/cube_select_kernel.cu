// The order-0 cube selection of every walker, on Hopper.
//
// Replaces no TPU kernel: the JAX package selects with jnp, inside the
// cube path of build (mri_nanoparticle_simulation_tpu/fields/
// expansion.py:239-270): each anchor's cube, its C candidates' exact f32
// d^2, the reach count, and K masked bfloat16 argmin passes, each
// winner's payload row taken out by a one-hot reduce.  The port's torch
// spelling of it (fields/expansion.py:cube_select, then the gathers,
// transposes, stack and cat that repacked the selection for the near
// entry and the far sums) ran as ~50 small kernels a chunk at the order-0
// scale-up; the plain PyTorch version of this kernel is
// fields/expansion.py:cube_select_reference.
//
// Per walker, bitwise what those passes select:
//
//   1. the cube clip(int(p / cube), 0, h - 1) by IEEE division (as
//      cand_model_kernel.cu and expansion._cube_index);
//   2. over the cube's C candidates, in slot order: d^2 = ((dx dx) +
//      (dy dy)) + dz dz, each d the anchor minus the candidate rounded in
//      f32 (no contraction: the library builds with --fmad=false), the
//      count of d^2 < reach2, and the key (bf16(d^2) << 16) | slot, with
//      bf16 torch's float -> bfloat16 rounding (to nearest even).  d^2 >=
//      0, so the keys order as (bf16(d^2), slot): the order of the K
//      passes, each the smallest remaining bf16 value, the first slot on
//      a tie.  The keys are unique, so a sorted insertion of them (a min
//      and a max a slot) keeps exactly the passes' K, in their order;
//   3. the K winners' rows, in the layouts their readers take: near
//      f32[4, K, w] (x, y, z, M * FIELD_SCALE, the near entry's input),
//      the unscaled M f32[K, w], the global ids i32[K, w] (the far-sums
//      kernel's input), n_reach i32[w].
//
// What bounds it on the H100: bytes.  A walker reads its anchor and
// writes 24 K + 4 bytes (256 at K 10); the candidate rows (2 MB of
// x, y, z, M * FIELD_SCALE, 0.3 MB of ids and moments) are read once
// from device memory and stay in the 50 MB L2.  Its operations (9 float
// and ~2 K + 6 integer a candidate) are a fraction of the bytes' time.
// So: one walker a thread, 128 a block, the outputs written by
// consecutive threads; one 16-byte load a candidate from the scene's
// candidate table in the candidate-model kernel's layout
// (SceneCache.cand_table); K unsigned keys in registers, the slot in the
// key, so no index array rides along; C a loop bound, not a template
// argument.

#include "field_math.cuh"

namespace {

// slot bits of a key: a cube holds at most 2^16 candidates
constexpr int kSlotBits = 16;

// The bits of torch's float -> bfloat16 (round to nearest even) of a
// finite x >= 0, which order as the values do.
__device__ __forceinline__ unsigned bf16_bits(float x) {
  const unsigned u = __float_as_uint(x);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

template <int K>
__global__ void __launch_bounds__(kBlock)
cube_select_kernel(const float* __restrict__ pos,
                   const float4* __restrict__ cand,
                   const float* __restrict__ payload,
                   float* __restrict__ near, float* __restrict__ near_m,
                   int* __restrict__ ids, int* __restrict__ n_reach, int w,
                   int c, int h, float cube, float reach2) {
  const int gid = blockIdx.x * kBlock + threadIdx.x;
  if (gid >= w) return;
  const float ax = pos[gid];
  const float ay = pos[w + gid];
  const float az = pos[2 * w + gid];
  const int cix = min(max(static_cast<int>(ax / cube), 0), h - 1);
  const int ciy = min(max(static_cast<int>(ay / cube), 0), h - 1);
  const int ciz = min(max(static_cast<int>(az / cube), 0), h - 1);
  const size_t row = static_cast<size_t>((cix * h + ciy) * h + ciz) * c;

  unsigned key[K];
#pragma unroll
  for (int s = 0; s < K; ++s) key[s] = ~0u;
  int cnt = 0;
#pragma unroll 8
  for (int j = 0; j < c; ++j) {
    const float4 v = __ldg(cand + row + j);
    const float dx = ax - v.x;
    const float dy = ay - v.y;
    const float dz = az - v.z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    cnt += d2 < reach2 ? 1 : 0;
    unsigned x = (bf16_bits(d2) << kSlotBits) | static_cast<unsigned>(j);
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const unsigned lo = min(key[s], x);
      x = max(key[s], x);
      key[s] = lo;
    }
  }

#pragma unroll
  for (int s = 0; s < K; ++s) {
    const size_t at = row + (key[s] & ((1u << kSlotBits) - 1u));
    const float4 v = __ldg(cand + at);
    near[(0 * K + s) * w + gid] = v.x;
    near[(1 * K + s) * w + gid] = v.y;
    near[(2 * K + s) * w + gid] = v.z;
    near[(3 * K + s) * w + gid] = v.w;
    near_m[s * w + gid] = __ldg(payload + 5 * at + 3);
    ids[s * w + gid] = static_cast<int>(__ldg(payload + 5 * at + 4));
  }
  n_reach[gid] = cnt;
}

// The kernel for `near_k`; false for a K it is not instantiated for.
bool select_kernel(int near_k, const void*& fn) {
  return dispatch_k(near_k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    fn = reinterpret_cast<const void*>(cube_select_kernel<K>);
  });
}

}  // namespace

// Launch the cube selection of `w` walkers: `pos` f32[3, w] wrapped
// anchors, `cand` f32[h^3, c, 4] (x, y, z, M * FIELD_SCALE; 16-byte
// aligned) and `payload` f32[h^3, c, 5] (x, y, z, M, global id) the
// scene's candidates, `cube` the f32 cube edge; out near f32[4, near_k,
// w], near_m f32[near_k, w], ids i32[near_k, w], n_reach i32[w].  Returns
// a cudaError_t: cudaErrorInvalidValue for arguments the kernel does not
// take, else cudaGetLastError().
extern "C" int cube_select_launch(int device, void* stream, const float* pos,
                                  const float* cand, const float* payload,
                                  float* near, float* near_m, int* ids,
                                  int* n_reach, int w, int near_k, int c,
                                  int h, float cube, float reach2) {
  const void* fn = nullptr;
  if (w <= 0 || h <= 0 || c < near_k || c > (1 << kSlotBits) ||
      reinterpret_cast<size_t>(cand) % 16 != 0 ||
      !select_kernel(near_k, fn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float4* rows = reinterpret_cast<const float4*>(cand);
  void* args[] = {&pos, &rows, &payload, &near, &near_m, &ids, &n_reach,
                  &w, &c, &h, &cube, &reach2};
  err = cudaLaunchKernel(fn, dim3((w + kBlock - 1) / kBlock), dim3(kBlock),
                         args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The kernel of `near_k` as the runtime reports it
// (field_math.cuh:kernel_info): registers, resident blocks per SM,
// dynamic shared-memory bytes (0), threads per block and local-memory
// bytes per thread, into out[0..4].  Returns a cudaError_t.
extern "C" int cube_select_info(int near_k, int* out) {
  const void* fn = nullptr;
  if (out == nullptr || !select_kernel(near_k, fn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return kernel_info(fn, kBlock, 0, out);
}

// Far-field value, gradient and Hessian at every walker anchor, on Hopper.
//
// Replaces the TPU kernel fields/expansion.py:_make_far_sums_kernel
// (mri_nanoparticle_simulation_tpu/fields/expansion.py:358-421, driven by
// _far_sums_pallas :424-444): per anchor, the sum over the whole dipole
// table of bz_taylor_parts, leaving out the K near dipoles by global
// index.  The plain PyTorch version is
// fields/expansion.py:far_sums_reference.
//
// What bounds it on the H100: issue slots.  Every (walker, dipole) pair
// is one evaluation of the Taylor parts (5.26e8 pairs at the scale-up's
// 100096 walkers x 5256 dipoles), each instruction a slot of the SM's
// four schedulers; the bytes (the table once, 13 + K words a walker) are
// nothing beside it.  The first kernel issued 98 instructions a pair
// (SASS at K 10), ~40 of them not on the field: the K id compares on
// every pair (only K of the 5256 entries are ever left out), ten
// multiplies by a weight that is 1 on all but those K, four scalar
// shared loads, and the loop.
//
// What this design does about it:
// * The exclusion leaves the pair loop.  Each walker sorts its K near
//   ids once; per sub-tile of kFarSub entries it pops the ids that fall
//   inside into a bit mask (take_excluded: one compare a sub-tile, the
//   pops K times a walker in all).  In the unrolled pair loop an entry
//   costs a bit test (the compiler moves the mask into predicates, R2P)
//   and one select that zeroes its moment: for finite parts p * 1 is p
//   and p * 0 is +-0, so every sum keeps its value.
// * The table streams through shared memory as float4 (x, y, z,
//   M * FIELD_SCALE), one 16-byte broadcast load an entry.  The last
//   tile is padded to whole sub-tiles with zero-moment entries (adding
//   +-0).  One walker a thread: carrying 2 or 4, so that a load serves
//   them all, measured slower (fewer warps for the schedulers to pick
//   from), and so did 32-entry sub-tiles at 2 walkers (the unrolled loop
//   outgrew the instruction cache).
// * The pair's own term (far_term) is this kernel's: its rsqrt is the
//   ftz instruction (r2 >= 1e-8 is never subnormal, so the value is
//   rsqrtf's), and its accumulation is contracted into fused
//   multiply-adds (t = fma(m3r7 dx, u, t), ...), the library's
//   --fmad=false notwithstanding.  The far sums are held to their plain
//   version by tolerance (1e-5 of each row's scale), not bitwise; the
//   chunk kernels' far pass keeps field_math.cuh's uncontracted
//   bz_taylor_parts / add_unselected and its bitwise match.
//
// Each walker's sum still runs in table order, one dipole at a time, as
// the plain version adds it.  At K 10 the pair loop issues 49.6
// instructions a pair (cuobjdump -sass of the build, benchmark.sass_loop:
// 1587 for 32 pairs), 56 registers, 9 blocks of 128 resident per SM, so
// 100096 walkers are 782 blocks in one wave (NVIDIA H100 80GB HBM3;
// PERF.md section 6).

#include <climits>

#include "field_math.cuh"

namespace {

constexpr int kFarSub = 32;      // entries a sub-tile (one exclusion mask)
constexpr int kFarTile = 1024;   // entries of the shared tile (16 KB)
static_assert(kFarTile % kFarSub == 0 && kFarSub <= 32, "sub-tile");

// rsqrt.approx.ftz: rsqrtf's value for a normal input, without the
// subnormal scaling around it
__device__ __forceinline__ float rsqrt_normal(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The Taylor parts of bz_taylor_parts (field_math.cuh) for the table
// entry e seen from the anchor, added to t with fused multiply-adds;
// `skip` zeroes the moment (an excluded entry adds +-0).
__device__ __forceinline__ void far_term(float (&t)[10], float ax, float ay,
                                         float az, const float4& e,
                                         bool skip) {
  const float m = skip ? 0.f : e.w;
  const float dx = ax - e.x;
  const float dy = ay - e.y;
  const float dz = az - e.z;
  const float r2 = fmaxf(__fmaf_rn(dz, dz, __fmaf_rn(dy, dy, dx * dx)),
                         1e-8f);
  const float inv_r = rsqrt_normal(r2);
  const float inv_r2 = inv_r * inv_r;
  const float inv_r5 = inv_r2 * inv_r2 * inv_r;
  const float inv_r7 = inv_r5 * inv_r2;
  const float dz2 = dz * dz;
  t[0] = __fmaf_rn(m * __fmaf_rn(3.f, dz2, -r2), inv_r5, t[0]);
  const float u = __fmaf_rn(-5.f, dz2, r2);
  const float v = __fmaf_rn(-5.f, dz2, 3.f * r2);
  const float m3r7 = 3.f * m * inv_r7;
  const float u_r2 = 7.f * u * inv_r2;
  const float a = 2.f - u_r2;
  const float b = -8.f - u_r2;
  const float mx = m3r7 * dx;
  const float my = m3r7 * dy;
  t[1] = __fmaf_rn(mx, u, t[1]);
  t[2] = __fmaf_rn(my, u, t[2]);
  t[3] = __fmaf_rn(m3r7 * dz, v, t[3]);
  t[4] = __fmaf_rn(m3r7, __fmaf_rn(dx * dx, a, u), t[4]);
  t[5] = __fmaf_rn(m3r7, __fmaf_rn(dy * dy, a, u), t[5]);
  t[6] = __fmaf_rn(m3r7, __fmaf_rn(-dz2, __fmaf_rn(7.f * v, inv_r2, 4.f), v),
                   t[6]);
  t[7] = __fmaf_rn(mx * dy, a, t[7]);
  t[8] = __fmaf_rn(mx * dz, b, t[8]);
  t[9] = __fmaf_rn(my * dz, b, t[9]);
}

// The bits of the sub-tile [base, base + kFarSub) that hold one of the
// walker's ids, `ids` ascending: pops every id below the sub-tile's end
// (ids outside the table are popped without a bit, or never reached).
template <int K>
__device__ __forceinline__ unsigned take_excluded(int (&ids)[K], int base) {
  unsigned mask = 0u;
  while (ids[0] < base + kFarSub) {
    const unsigned d = static_cast<unsigned>(ids[0] - base);
    if (d < static_cast<unsigned>(kFarSub)) mask |= 1u << d;
#pragma unroll
    for (int s = 0; s + 1 < K; ++s) ids[s] = ids[s + 1];
    ids[K - 1] = INT_MAX;
  }
  return mask;
}

// ids ascending, by an insertion network (compile-time slots only)
template <int K>
__device__ __forceinline__ void sort_ids(int (&ids)[K]) {
#pragma unroll
  for (int i = 1; i < K; ++i) {
#pragma unroll
    for (int j = i; j > 0; --j) {
      const int lo = min(ids[j - 1], ids[j]);
      ids[j] = max(ids[j - 1], ids[j]);
      ids[j - 1] = lo;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kBlock)
far_sums_kernel(const float* __restrict__ mnp, int n_pad,
                const float* __restrict__ anchor, const int* __restrict__ idx,
                float* __restrict__ taylor, int w) {
  __shared__ float4 s_tbl[kFarTile];
  const int tid = threadIdx.x;
  const int gid = blockIdx.x * kBlock + tid;
  const int g = min(gid, w - 1);
  const float ax = anchor[g];
  const float ay = anchor[w + g];
  const float az = anchor[2 * w + g];
  int ids[K];
#pragma unroll
  for (int s = 0; s < K; ++s) ids[s] = idx[s * w + g];
  sort_ids<K>(ids);
  float t[10];
#pragma unroll
  for (int c = 0; c < 10; ++c) t[c] = 0.f;

  const int n_all = (n_pad + kFarSub - 1) / kFarSub * kFarSub;
  for (int base0 = 0; base0 < n_all; base0 += kFarTile) {
    const int n = min(kFarTile, n_all - base0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < n; i += kBlock) {
      const int j = base0 + i;
      s_tbl[i] = j < n_pad
                     ? make_float4(mnp[j], mnp[n_pad + j], mnp[2 * n_pad + j],
                                   mnp[3 * n_pad + j])
                     : make_float4(1e6f, 1e6f, 1e6f, 0.f);
    }
    __syncthreads();
    for (int sb = 0; sb < n; sb += kFarSub) {
      const unsigned mask = take_excluded<K>(ids, base0 + sb);
#pragma unroll
      for (int u = 0; u < kFarSub; ++u) {
        // a register copy: handed the shared entry itself, the compiler
        // loads the moment again under the mask bit (a scalar shared load
        // and a zero a pair) in place of the one select
        const float4 e = s_tbl[sb + u];
        far_term(t, ax, ay, az, e, (mask >> u) & 1u);
      }
    }
  }
  if (gid < w) {
#pragma unroll
    for (int c = 0; c < 10; ++c) taylor[c * w + gid] = t[c];
  }
}

// The kernel for `near_k`; false for a K it is not instantiated for.
bool far_kernel(int near_k, const void*& fn) {
  return dispatch_k(near_k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    fn = reinterpret_cast<const void*>(far_sums_kernel<K>);
  });
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
  const void* fn = nullptr;
  if (w <= 0 || n_pad <= 0 || !far_kernel(near_k, fn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&mnp, &n_pad, &anchor, &idx, &taylor, &w};
  err = cudaLaunchKernel(fn, dim3((w + kBlock - 1) / kBlock), dim3(kBlock),
                         args, 0,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The kernel of `near_k` as the runtime reports it
// (field_math.cuh:kernel_info): registers, resident blocks per SM,
// dynamic shared-memory bytes (0), threads per block and local-memory
// bytes per thread, into out[0..4].  Returns a cudaError_t.
extern "C" int far_sums_info(int near_k, int* out) {
  const void* fn = nullptr;
  if (out == nullptr || !far_kernel(near_k, fn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return kernel_info(fn, kBlock, 0, out);
}

// One chunk of the Monte Carlo MRI walk for every walker, on Hopper.
//
// Replaces the TPU kernel pallas_engine.make_chunk_kernel
// (mri_nanoparticle_simulation_tpu/engine/pallas_engine.py:171-823), all
// but its decompose mode, in two entries:
//
// * chunk_kernel (in-kernel rebuild, n_mnp_pad set): wrap, then the
//   recandidate over the whole dipole table, then the steps.  The plain
//   PyTorch version is engine/cuda_engine.py:chunk_reference.
// * chunk_near_kernel (near/taylor inputs, n_mnp_pad=None;
//   pallas_engine.py:748-755, 770-772, 802-808): the field model comes
//   from outside (csrc/cand_model_kernel.cu or expansion.build), the
//   input state is already wrapped and is the anchor, and the coverage
//   output is 0 (the caller counts coverage where it selects).  The plain
//   version is engine/cuda_engine.py:chunk_near_reference.
//
// Each entry has four modes: the Threefry generator (the reference's
// validation path, bit for bit) or the fast one (its production path,
// pallas_engine.py:603-684, with Philox4x32-10 in place of the TPU's
// hardware PRNG), each with the default physics or with the variants
// (reflection, intended kick, sphere directions, gradient) read as
// launch flags.  This header holds the kernels and their host launchers;
// chunk_kernel.cu, chunk_kernel_fast.cu, chunk_near_kernel.cu and
// chunk_near_kernel_fast.cu each instantiate one entry and generator, so
// the 128 kernels build in four parallel nvcc processes.
//
// What bounds it on the H100: integer ALU work.  Three Threefry-2x32-20
// blocks per walker-step cost about 300 integer operations, against
// about 100 float operations of physics, and nothing goes to device
// memory inside a chunk.  The fast generator draws two Philox-10 blocks
// (about 100 integer operations each) per step pair, and its polynomial
// Box-Muller replaces logf/cosf (a headline chunk: 1.08 ms against
// 3.33 ms on Threefry, H100 80GB HBM3 at 700 W).  The design keeps the
// work on the ALUs: one thread per walker; its state, its K near dipoles
// and its 10 far-Taylor sums stay in registers for the whole chunk (the
// kernels are templated on K so the slot arrays unroll into registers);
// in rebuild mode the dipole table,
// read by every thread at the same address, sits in shared memory.
// Device memory is touched once at chunk start and once at chunk end.
//
// Arithmetic follows the reference kernel operation by operation (build
// with --fmad=false so no multiply-add is contracted): the Threefry
// counter c0 = step, c1 = lane + (pair << 27); uniforms from the top 24
// bits; the normal sqrtf(-2 logf(1 - u)) cosf(2 pi u'); the fast path's
// Horner polynomials as the plain version (rng.fast_normal_pair) runs
// them; the wrap fmod(x + bound, bound); strict '<' in the sorted
// insertion; the field masked by d2 > cell_r^2; the kick at the new
// position with the new in-cell flag; Kahan fold, emit, then the
// Carr-Purcell flip.  The step loop is field_math.cuh:run_steps, shared
// by both entries.
//
// Launch: w_pad / 128 blocks of 128 threads, one walker per thread.  Each
// block reduces its own windows and coverage count (warp shuffles, then
// shared memory, in a fixed order); the wrapper sums over blocks, so the
// result is the same from run to run.

#pragma once

#include "field_math.cuh"

namespace {

constexpr int kMaxMnps = 2048;

template <int K, bool kFast, bool kVariants>
__global__ void __launch_bounds__(kBlock)
chunk_kernel(const float* __restrict__ state_in, float* __restrict__ state_out,
             float* __restrict__ esc, float* __restrict__ cov,
             float* __restrict__ wins, const float* __restrict__ mnp,
             int w_pad, Launch a) {
  __shared__ float s_mnp[4][kMaxMnps];
  __shared__ float s_red[kBlock / 32];
  const int tid = threadIdx.x;
  const int gid = blockIdx.x * kBlock + tid;
  for (int i = tid; i < a.n_pad; i += kBlock) {
    s_mnp[0][i] = mnp[i];
    s_mnp[1][i] = mnp[a.n_pad + i];
    s_mnp[2][i] = mnp[2 * a.n_pad + i];
    s_mnp[3][i] = mnp[3 * a.n_pad + i];
  }
  __syncthreads();

  const bool valid = static_cast<unsigned>(gid) < a.num_water;
  const unsigned lane = static_cast<unsigned>(gid) + a.lane_offset;

  // chunk start: wrap; the anchor is the wrapped position
  const float ax = wrap(state_in[gid], a.bound);
  const float ay = wrap(state_in[w_pad + gid], a.bound);
  const float az = wrap(state_in[2 * w_pad + gid], a.bound);
  const float phase = state_in[4 * w_pad + gid];
  const float comp = state_in[5 * w_pad + gid];

  // recandidate: exact K-nearest by branchless sorted insertion, and the
  // count of dipoles within (cell_r + travel)^2
  const float reach = sqrtf(a.cell_r2) + a.travel;
  const float reach2 = reach * reach;
  float sd[K], nx[K], ny[K], nz[K], nm[K];
  int sid[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    sd[s] = 1e30f;
    nx[s] = 1e9f;
    ny[s] = 1e9f;
    nz[s] = 1e9f;
    nm[s] = 0.f;
    sid[s] = -1;
  }
  int cnt = 0;
  for (int j = 0; j < a.n_pad; ++j) {
    const float x0 = s_mnp[0][j], y0 = s_mnp[1][j], z0 = s_mnp[2][j];
    const float dx = ax - x0;
    const float dy = ay - y0;
    const float dz = az - z0;
    const float d2 = dx * dx + dy * dy + dz * dz;
    cnt += d2 < reach2 ? 1 : 0;
    sorted_insert<K>(sd, nx, ny, nz, nm, sid, d2, x0, y0, z0, s_mnp[3][j],
                     j);
  }
  const float n_cov = block_sum(valid && cnt > K ? 1.f : 0.f, s_red);
  if (tid == 0) cov[blockIdx.x] = n_cov;

  // far Taylor sums over the table, the K selected dipoles left out
  float t[10];
#pragma unroll
  for (int c = 0; c < 10; ++c) t[c] = 0.f;
  for (int j = 0; j < a.n_pad; ++j) {
    add_unselected<K>(t, sid, j, ax, ay, az, s_mnp[0][j], s_mnp[1][j],
                      s_mnp[2][j], s_mnp[3][j]);
  }

  run_steps<K, kFast, kVariants>(nx, ny, nz, nm, t, ax, ay, az, phase,
                                 comp, valid, lane, a, s_red, wins,
                                 state_out, esc, w_pad, gid);
}

template <int K, bool kFast, bool kVariants>
__global__ void __launch_bounds__(kBlock)
chunk_near_kernel(const float* __restrict__ state_in,
                  float* __restrict__ state_out, float* __restrict__ esc,
                  float* __restrict__ cov, float* __restrict__ wins,
                  const float* __restrict__ near,
                  const float* __restrict__ taylor, int w_pad, Launch a) {
  __shared__ float s_red[kBlock / 32];
  const int tid = threadIdx.x;
  const int gid = blockIdx.x * kBlock + tid;
  const bool valid = static_cast<unsigned>(gid) < a.num_water;
  const unsigned lane = static_cast<unsigned>(gid) + a.lane_offset;

  // the input position is the anchor (wrapped by the caller)
  const float ax = state_in[gid];
  const float ay = state_in[w_pad + gid];
  const float az = state_in[2 * w_pad + gid];
  const float phase = state_in[4 * w_pad + gid];
  const float comp = state_in[5 * w_pad + gid];

  // the model: near [4, K, w_pad] (x, y, z, M * FIELD_SCALE) and taylor
  // [10, w_pad], each row read coalesced
  float nx[K], ny[K], nz[K], nm[K], t[10];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    nx[s] = near[(0 * K + s) * w_pad + gid];
    ny[s] = near[(1 * K + s) * w_pad + gid];
    nz[s] = near[(2 * K + s) * w_pad + gid];
    nm[s] = near[(3 * K + s) * w_pad + gid];
  }
#pragma unroll
  for (int c = 0; c < 10; ++c) t[c] = taylor[c * w_pad + gid];
  if (tid == 0) cov[blockIdx.x] = 0.f;

  run_steps<K, kFast, kVariants>(nx, ny, nz, nm, t, ax, ay, az, phase,
                                 comp, valid, lane, a, s_red, wins,
                                 state_out, esc, w_pad, gid);
}

// Launch one rebuild-mode chunk on `stream` of device `device`; `mnp` is
// f32[4, a->n_pad].  Returns a cudaError_t: cudaErrorInvalidValue for
// arguments the kernel does not take, else cudaGetLastError() after the
// launch.
template <bool kFast>
int launch_chunk(int device, void* stream, const float* state_in,
                 float* state_out, float* esc, float* cov, float* wins,
                 const float* mnp, int w_pad, int near_k, const Launch* a) {
  if (a == nullptr ||
      bad_chunk_args(w_pad, near_k, a->chunk_steps, a->pfreq, a->tcp,
                     a->rounds) ||
      a->n_pad < near_k || a->n_pad > kMaxMnps || a->n_pad % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch_k(near_k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    if (a->flags != 0) {
      chunk_kernel<K, kFast, true><<<w_pad / kBlock, kBlock, 0, s>>>(
          state_in, state_out, esc, cov, wins, mnp, w_pad, *a);
    } else {
      chunk_kernel<K, kFast, false><<<w_pad / kBlock, kBlock, 0, s>>>(
          state_in, state_out, esc, cov, wins, mnp, w_pad, *a);
    }
  });
  return static_cast<int>(cudaGetLastError());
}

// Launch one near/taylor-mode chunk; `near` is f32[4, near_k, w_pad],
// `taylor` f32[10, w_pad].  Returns a cudaError_t as above.
template <bool kFast>
int launch_chunk_near(int device, void* stream, const float* state_in,
                      float* state_out, float* esc, float* cov, float* wins,
                      const float* near, const float* taylor, int w_pad,
                      int near_k, const Launch* a) {
  if (a == nullptr || near == nullptr || taylor == nullptr ||
      bad_chunk_args(w_pad, near_k, a->chunk_steps, a->pfreq, a->tcp,
                     a->rounds)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch_k(near_k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    if (a->flags != 0) {
      chunk_near_kernel<K, kFast, true><<<w_pad / kBlock, kBlock, 0, s>>>(
          state_in, state_out, esc, cov, wins, near, taylor, w_pad, *a);
    } else {
      chunk_near_kernel<K, kFast, false><<<w_pad / kBlock, kBlock, 0, s>>>(
          state_in, state_out, esc, cov, wins, near, taylor, w_pad, *a);
    }
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C entry points, one per entry and generator, each defined in its own
// source: fn(device, stream, state_in, state_out, esc, cov, wins, model0,
// model1, w_pad, near_k, launch) with model0 = mnp and model1 unused in
// rebuild mode, model0 = near and model1 = taylor in near/taylor mode.
#define CHUNK_ENTRY(name, launcher, fast, ...)                              \
  extern "C" int name(int device, void* stream, const float* state_in,     \
                      float* state_out, float* esc, float* cov,            \
                      float* wins, const float* model0,                    \
                      const float* model1, int w_pad, int near_k,          \
                      const Launch* a) {                                   \
    (void)model1;                                                          \
    return launcher<fast>(device, stream, state_in, state_out, esc, cov,   \
                          wins, __VA_ARGS__, w_pad, near_k, a);            \
  }

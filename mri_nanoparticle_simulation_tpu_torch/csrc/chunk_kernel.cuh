// One chunk of the Monte Carlo MRI walk for every walker, on Hopper.
//
// Replaces the TPU kernel pallas_engine.make_chunk_kernel
// (mri_nanoparticle_simulation_tpu/engine/pallas_engine.py:171-823), every
// mode of it, in two entries:
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
// Each entry has eight modes: the Threefry generator (the reference's
// validation path, bit for bit) or the fast one (its production path,
// pallas_engine.py:603-684, with Philox4x32-10 in place of the TPU's
// hardware PRNG), each with the default physics or with the variants
// (reflection, intended kick, sphere directions, gradient) read as
// launch flags, each plain or in decompose mode (the state f32[8, w_pad]
// with the phase split as A, comp_A, B, comp_B, and the per-walker
// record wins f32[n_win, 2, w_pad] of (A, B) in place of the warp
// sums; pallas_engine.py:221-229, 736, 787-793).  This header holds the
// kernels and their host launchers; chunk_kernel.cu, chunk_kernel_fast.cu,
// chunk_near_kernel.cu, chunk_near_kernel_fast.cu and their four *_dec.cu
// twins each instantiate one entry, generator and decompose flag, so the
// kernels build in eight parallel nvcc processes.
//
// What bounds it on the H100: issue slots and integer ALU work.  Three
// Threefry-2x32-20 blocks per walker-step cost about 200 integer
// operations, against about 180 float operations of physics at K = 5,
// and nothing goes to device memory inside a chunk.  The fast generator
// draws two Philox-10 blocks (about 50 integer operations each) per step
// pair, and its polynomial Box-Muller replaces logf/cosf.  The state
// stays on chip: one walker per thread; its state, its K near dipoles
// and its 10 far-Taylor sums stay in registers for the whole chunk (the
// kernels are templated on K so the slot arrays unroll into registers);
// in rebuild mode the dipole table, read by every thread at the same
// address, sits in shared memory.  Device memory is touched once at
// chunk start and once at chunk end, and in decompose mode once per
// window for the record (8 bytes per walker and window, coalesced).
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
// Layouts (the wrapper, engine/chunk_kernel.py:layout, picks one by
// width):
//
// * flat: w_pad / 128 blocks of 128 threads, one walker per thread, each
//   drawing its own words.  The near entry; the rebuild entry above
//   chunk_kernel.split_threshold (where it measured faster).  The near
//   entry's Threefry kernel with the default physics (not decompose) is
//   compiled for kWaveBlocks = 6 resident blocks per SM (at most 80
//   registers), so the 100096-walker scale-up is one wave, with a step's
//   Threefry blocks fused into one loop (threefry_words); that measured
//   faster than the uncapped kernel, while on the fast generator the cap
//   measured slower (PERF.md section 6), so near_min_blocks picks it by
//   template.
// * split (rebuild entry, chunk_split_kernel): w_pad / 32 blocks of one
//   walker warp and kGenWarps generator warps (field_math.cuh: G = 3,
//   the ring of kRingSteps = 64 steps).  At the headline width (4096
//   padded walkers) that is 128 blocks, one per SM, where the flat layout
//   put 32 blocks on 32 SMs.  The generator warps draw everything a step
//   needs that does not depend on the walker's position (the words, the
//   direction and its inverse norm, the normal, the coin and the kick
//   uniform) ahead of the walker warp into the ring; the walker warp runs
//   only the chain move -> field -> bounce -> kicks.  The chunk start is
//   shared: each of the four warps selects over a quarter of the table,
//   the walker warp merges the quarters exactly, and the generator warps
//   compute the far Taylor parts that the walker warp adds in table
//   order (chunk_split_kernel).
//
// Each warp reduces its own windows and coverage count (a shuffle tree,
// in a fixed order) into the per-warp outputs cov[w_pad / 32] and
// wins[w_pad / 32, n_win, 2]; the wrapper sums over warps, so the result
// is the same from run to run and in either layout.

#pragma once

#include "field_math.cuh"

namespace {

constexpr int kMaxMnps = 2048;

// The launch layouts (the C entry points' `layout` argument).
constexpr int kLayoutFlat = 0, kLayoutSplit = 1;

// Resident 128-thread blocks per SM the near entry's kernel is compiled
// for (__launch_bounds__' second argument).  Threefry with the default
// physics, not in decompose mode: kWaveBlocks = 6 (at most 80 registers),
// so 100096 walkers, 782 blocks, are one wave on 132 SMs (in decompose
// mode 80 registers spill).  The fast generator with the variants: 4 (128
// registers), which ran faster than its 152-156 uncapped (3 per SM).  The
// other modes ran fastest uncapped (PERF.md section 6).
constexpr int kWaveBlocks = 6;

template <bool kFast, bool kVariants, bool kDecompose>
__host__ __device__ constexpr int near_min_blocks() {
  return !kFast && !kVariants && !kDecompose ? kWaveBlocks
         : kFast && kVariants                ? 4
                                             : 1;
}

// The one-wave kernel fuses a step's Threefry blocks into one loop so
// their chains overlap (at 6 per SM there are few warps to hide them).
template <bool kFast, bool kVariants, bool kDecompose>
__host__ __device__ constexpr bool near_fuse() {
  return near_min_blocks<kFast, kVariants, kDecompose>() == kWaveBlocks;
}

// Chunk start of the flat rebuild entry and then the steps, for the
// walker `gid` of this thread: wrap (the anchor is the wrapped
// position), the exact K-nearest selection by branchless sorted
// insertion over the table (sx, sy, sz, sm in shared memory), the warp's
// count of walkers with more than K dipoles within (cell_r + travel)^2,
// the far Taylor sums over the table without the K selected, then
// run_steps.
template <int K, bool kFast, bool kVariants, bool kDecompose>
__device__ __forceinline__ void rebuild_and_run(
    const float* __restrict__ state_in, float* __restrict__ state_out,
    float* __restrict__ esc, float* __restrict__ cov,
    float* __restrict__ wins, const float* sx, const float* sy,
    const float* sz, const float* sm, int w_pad, const Launch& a, int gid) {
  const bool valid = static_cast<unsigned>(gid) < a.num_water;
  const unsigned lane = static_cast<unsigned>(gid) + a.lane_offset;

  const float ax = wrap(state_in[gid], a.bound);
  const float ay = wrap(state_in[w_pad + gid], a.bound);
  const float az = wrap(state_in[2 * w_pad + gid], a.bound);
  const float phase = state_in[4 * w_pad + gid];
  const float comp = state_in[5 * w_pad + gid];
  const float phase_b = kDecompose ? state_in[6 * w_pad + gid] : 0.f;
  const float comp_b = kDecompose ? state_in[7 * w_pad + gid] : 0.f;

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
    const float x0 = sx[j], y0 = sy[j], z0 = sz[j];
    const float dx = ax - x0;
    const float dy = ay - y0;
    const float dz = az - z0;
    const float d2 = dx * dx + dy * dy + dz * dz;
    cnt += d2 < reach2 ? 1 : 0;
    sorted_insert<K>(sd, nx, ny, nz, nm, sid, d2, x0, y0, z0, sm[j], j);
  }
  const float n_cov = warp_sum(valid && cnt > K ? 1.f : 0.f);
  if ((gid & (kWarp - 1)) == 0) cov[gid / kWarp] = n_cov;

  float t[10];
#pragma unroll
  for (int c = 0; c < 10; ++c) t[c] = 0.f;
  for (int j = 0; j < a.n_pad; ++j) {
    add_unselected<K>(t, sid, j, ax, ay, az, sx[j], sy[j], sz[j], sm[j]);
  }

  run_steps<K, kFast, kVariants, kDecompose, false>(
      nx, ny, nz, nm, t, ax, ay, az, phase, comp, phase_b, comp_b, valid,
      lane, a, nullptr, wins, state_out, esc, w_pad, gid);
}

template <int K, bool kFast, bool kVariants, bool kDecompose>
__global__ void __launch_bounds__(kBlock)
chunk_kernel(const float* __restrict__ state_in, float* __restrict__ state_out,
             float* __restrict__ esc, float* __restrict__ cov,
             float* __restrict__ wins, const float* __restrict__ mnp,
             int w_pad, Launch a) {
  __shared__ float s_mnp[4][kMaxMnps];
  const int tid = threadIdx.x;
  for (int i = tid; i < a.n_pad; i += kBlock) {
    s_mnp[0][i] = mnp[i];
    s_mnp[1][i] = mnp[a.n_pad + i];
    s_mnp[2][i] = mnp[2 * a.n_pad + i];
    s_mnp[3][i] = mnp[3 * a.n_pad + i];
  }
  __syncthreads();
  rebuild_and_run<K, kFast, kVariants, kDecompose>(
      state_in, state_out, esc, cov, wins, s_mnp[0], s_mnp[1], s_mnp[2],
      s_mnp[3], w_pad, a, blockIdx.x * kBlock + tid);
}

// The split layout's chunk start is shared by the block's warps.  Each
// of the kSplitWarps warps scans a quarter of the table for the walkers
// of its lanes (the K nearest by sorted_insert_ids, and the count within
// reach) into shared memory; the walker warp merges the four sorted
// lists by (d2, id), which is exactly the serial insertion's result
// (ties go to the lower id, which is the lower quarter); the generator
// warps then compute the far Taylor parts of the table in tiles of
// kPartTile entries into two buffers, and the walker warp adds them in
// table order, leaving out its K, one entry at a time as the serial sum.
constexpr int kSplitWarps = 1 + kGenWarps;
constexpr int kPartTile = 16;
constexpr int kPartFloats = 2 * 10 * kPartTile * kWarp;

// Dynamic shared memory of one split block: the table f32[4, n_pad], the
// ring, the two far-part buffers, then the quarters' K-lists (f32 and
// i32 [kSplitWarps, K, 32]) and counts (i32 [kSplitWarps, 32]).
template <bool kVariants>
__host__ __device__ constexpr int split_smem_bytes(int n_pad, int k) {
  return 16 * n_pad + ring_bytes<kVariants>() + 4 * kPartFloats
      + 8 * kSplitWarps * k * kWarp + 4 * kSplitWarps * kWarp;
}

// The walker warp's merge of the quarters' K-lists (s_sd, s_sid), and
// the chosen dipoles' payload from the table.
template <int K>
__device__ __forceinline__ void merge_selected(
    const float* s_sd, const int* s_sid, const float* sx, const float* sy,
    const float* sz, const float* sm, int lane_id, float (&nx)[K],
    float (&ny)[K], float (&nz)[K], float (&nm)[K], int (&sid)[K]) {
  int head[kSplitWarps];
#pragma unroll
  for (int w = 0; w < kSplitWarps; ++w) head[w] = 0;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    // at slot s every list has given at most s < K entries
    float best = s_sd[head[0] * kWarp + lane_id];
    int id = s_sid[head[0] * kWarp + lane_id];
    int from = 0;
#pragma unroll
    for (int w = 1; w < kSplitWarps; ++w) {
      const int at = (w * K + head[w]) * kWarp + lane_id;
      const float d = s_sd[at];
      if (d < best) {
        best = d;
        id = s_sid[at];
        from = w;
      }
    }
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) head[w] += from == w ? 1 : 0;
    const int j = max(id, 0);   // n_pad >= K: every slot holds a dipole
    sid[s] = id;
    nx[s] = id >= 0 ? sx[j] : 1e9f;
    ny[s] = id >= 0 ? sy[j] : 1e9f;
    nz[s] = id >= 0 ? sz[j] : 1e9f;
    nm[s] = id >= 0 ? sm[j] : 0.f;
  }
}

// The split layout: warp 0 walks the block's 32 walkers, warps
// 1..kGenWarps fill the ring with their draws; all of them share the
// chunk start (above).  While the walker warp merges, the generator
// warps fill the ring's first two halves, then the far parts, then the
// rest of the ring as the walker warp frees it.
template <int K, bool kFast, bool kVariants, bool kDecompose>
__global__ void __launch_bounds__(kSplitThreads, 1)
chunk_split_kernel(const float* __restrict__ state_in,
                   float* __restrict__ state_out, float* __restrict__ esc,
                   float* __restrict__ cov, float* __restrict__ wins,
                   const float* __restrict__ mnp, int w_pad, Launch a) {
  extern __shared__ float s_dyn[];
  const int n = a.n_pad;
  float* s_mnp = s_dyn;
  const float* sx = s_mnp;
  const float* sy = s_mnp + n;
  const float* sz = s_mnp + 2 * n;
  const float* sm = s_mnp + 3 * n;
  float* ring = s_mnp + 4 * n;
  float* parts = ring + ring_bytes<kVariants>() / 4;
  float* sel_d2 = parts + kPartFloats;
  int* sel_id = reinterpret_cast<int*>(sel_d2 + kSplitWarps * K * kWarp);
  int* sel_cnt = sel_id + kSplitWarps * K * kWarp;
  const int tid = threadIdx.x;
  for (int i = tid; i < 4 * n; i += kSplitThreads) s_mnp[i] = mnp[i];
  __syncthreads();
  const int warp = tid / kWarp;
  const int lane_id = tid & (kWarp - 1);
  const int gid = blockIdx.x * kWarp + lane_id;
  const unsigned lane = static_cast<unsigned>(gid) + a.lane_offset;

  // chunk start: wrap; the anchor is the wrapped position
  const float ax = wrap(state_in[gid], a.bound);
  const float ay = wrap(state_in[w_pad + gid], a.bound);
  const float az = wrap(state_in[2 * w_pad + gid], a.bound);
  {
    const float reach = sqrtf(a.cell_r2) + a.travel;
    const float reach2 = reach * reach;
    float sd[K];
    int sid[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      sd[s] = 1e30f;
      sid[s] = -1;
    }
    const int q = (n + kSplitWarps - 1) / kSplitWarps;
    const int j1 = min(n, (warp + 1) * q);
    int cnt = 0;
    for (int j = warp * q; j < j1; ++j) {
      const float dx = ax - sx[j];
      const float dy = ay - sy[j];
      const float dz = az - sz[j];
      const float d2 = dx * dx + dy * dy + dz * dz;
      cnt += d2 < reach2 ? 1 : 0;
      sorted_insert_ids<K>(sd, sid, d2, j);
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      sel_d2[(warp * K + s) * kWarp + lane_id] = sd[s];
      sel_id[(warp * K + s) * kWarp + lane_id] = sid[s];
    }
    sel_cnt[warp * kWarp + lane_id] = cnt;
  }
  __syncthreads();
  const int n_tiles = (n + kPartTile - 1) / kPartTile;

  if (warp > 0) {   // generator warp g = warp - 1
    const int g = warp - 1;
    const int n_fill = (a.chunk_steps + kFill - 1) / kFill;
    generate<kFast, kVariants>(a, lane, ring, g, lane_id, 0, min(2, n_fill));
    for (int tt = 0; tt < n_tiles; ++tt) {
      const int b = tt & 1;
      if (tt >= 2) bar_sync(kBarPartEmpty + b, kSplitThreads);
      const int e0 = tt * kPartTile;
      const int e1 = min(e0 + kPartTile, n);
      for (int e = e0 + g; e < e1; e += kGenWarps) {
        float p[10];
        bz_taylor_parts(ax - sx[e], ay - sy[e], az - sz[e], sm[e], p);
#pragma unroll
        for (int c = 0; c < 10; ++c) {
          parts[((b * 10 + c) * kPartTile + e - e0) * kWarp + lane_id] = p[c];
        }
      }
      __threadfence_block();
      bar_arrive(kBarPartFull + b, kSplitThreads);
    }
    generate<kFast, kVariants>(a, lane, ring, g, lane_id, 2, n_fill);
    return;
  }

  const bool valid = static_cast<unsigned>(gid) < a.num_water;
  float nx[K], ny[K], nz[K], nm[K];
  int sid[K];
  merge_selected<K>(sel_d2, sel_id, sx, sy, sz, sm, lane_id, nx, ny, nz, nm,
                    sid);
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < kSplitWarps; ++w) cnt += sel_cnt[w * kWarp + lane_id];
  const float n_cov = warp_sum(valid && cnt > K ? 1.f : 0.f);
  if (lane_id == 0) cov[gid / kWarp] = n_cov;

  // far Taylor sums over the table, the K selected dipoles left out, in
  // table order from the generator warps' parts
  float t[10];
#pragma unroll
  for (int c = 0; c < 10; ++c) t[c] = 0.f;
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int b = tt & 1;
    bar_sync(kBarPartFull + b, kSplitThreads);
    const int e0 = tt * kPartTile;
    const int e1 = min(e0 + kPartTile, n);
    for (int e = e0; e < e1; ++e) {
      bool selected = false;
#pragma unroll
      for (int s = 0; s < K; ++s) selected |= sid[s] == e;
      const float w = selected ? 0.f : 1.f;
#pragma unroll
      for (int c = 0; c < 10; ++c) {
        t[c] = t[c]
            + parts[((b * 10 + c) * kPartTile + e - e0) * kWarp + lane_id] * w;
      }
    }
    if (tt + 2 < n_tiles) bar_arrive(kBarPartEmpty + b, kSplitThreads);
  }

  run_steps<K, kFast, kVariants, kDecompose, true>(
      nx, ny, nz, nm, t, ax, ay, az, state_in[4 * w_pad + gid],
      state_in[5 * w_pad + gid],
      kDecompose ? state_in[6 * w_pad + gid] : 0.f,
      kDecompose ? state_in[7 * w_pad + gid] : 0.f, valid, lane, a, ring,
      wins, state_out, esc, w_pad, gid);
}

// The near entry's walker of this thread: the model from the inputs, then
// the steps (kFuse: run_steps' fused Threefry blocks).
template <int K, bool kFast, bool kVariants, bool kDecompose, bool kFuse>
__device__ __forceinline__ void near_walker(
    const float* __restrict__ state_in, float* __restrict__ state_out,
    float* __restrict__ esc, float* __restrict__ cov,
    float* __restrict__ wins, const float* __restrict__ near,
    const float* __restrict__ taylor, int w_pad, const Launch& a) {
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
  const float phase_b = kDecompose ? state_in[6 * w_pad + gid] : 0.f;
  const float comp_b = kDecompose ? state_in[7 * w_pad + gid] : 0.f;

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
  if ((tid & (kWarp - 1)) == 0) cov[gid / kWarp] = 0.f;

  run_steps<K, kFast, kVariants, kDecompose, false, kFuse>(
      nx, ny, nz, nm, t, ax, ay, az, phase, comp, phase_b, comp_b, valid,
      lane, a, nullptr, wins, state_out, esc, w_pad, gid);
}

template <int K, bool kFast, bool kVariants, bool kDecompose>
__global__ void __launch_bounds__(
    kBlock, (near_min_blocks<kFast, kVariants, kDecompose>()))
chunk_near_kernel(const float* __restrict__ state_in,
                  float* __restrict__ state_out, float* __restrict__ esc,
                  float* __restrict__ cov, float* __restrict__ wins,
                  const float* __restrict__ near,
                  const float* __restrict__ taylor, int w_pad, Launch a) {
  near_walker<K, kFast, kVariants, kDecompose,
              near_fuse<kFast, kVariants, kDecompose>()>(
      state_in, state_out, esc, cov, wins, near, taylor, w_pad, a);
}

// Registers, resident blocks per SM, dynamic shared-memory bytes and
// threads per block of kernel `fn` launched with `threads` threads and
// `smem` dynamic bytes, into out[0..3]; returns a cudaError_t.
// A dynamic size above 48 KB is allowed for `fn` first; a size the card
// refuses is the error returned.
inline int kernel_info(const void* fn, int threads, int smem, int* out) {
  cudaError_t err = cudaSuccess;
  if (smem > 0) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = blocks;
  out[2] = smem;
  out[3] = threads;
  return 0;
}

// The rebuild entry's kernel for `near_k`, the variants flag and the
// layout, with its launch shape: (function, threads per block, walkers
// per block, dynamic shared-memory bytes).  Returns false for a K the
// kernels are not instantiated for.
template <bool kFast, bool kDecompose>
bool rebuild_kernel(int near_k, bool variants, bool split, int n_pad,
                    const void*& fn, int& threads, int& walkers, int& smem) {
  return dispatch_k(near_k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    if (split) {
      fn = variants
          ? reinterpret_cast<const void*>(
                chunk_split_kernel<K, kFast, true, kDecompose>)
          : reinterpret_cast<const void*>(
                chunk_split_kernel<K, kFast, false, kDecompose>);
      threads = kSplitThreads;
      walkers = kWarp;
      smem = variants ? split_smem_bytes<true>(n_pad, K)
                      : split_smem_bytes<false>(n_pad, K);
    } else {
      fn = variants ? reinterpret_cast<const void*>(
                          chunk_kernel<K, kFast, true, kDecompose>)
                    : reinterpret_cast<const void*>(
                          chunk_kernel<K, kFast, false, kDecompose>);
      threads = kBlock;
      walkers = kBlock;
      smem = 0;
    }
  });
}

// The near entry's kernel for `near_k` and the variants flag; false for
// a K it is not instantiated for.
template <bool kFast, bool kDecompose>
bool near_kernel(int near_k, bool variants, const void*& fn) {
  return dispatch_k(near_k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    fn = variants ? reinterpret_cast<const void*>(
                        chunk_near_kernel<K, kFast, true, kDecompose>)
                  : reinterpret_cast<const void*>(
                        chunk_near_kernel<K, kFast, false, kDecompose>);
  });
}

// Launch one rebuild-mode chunk on `stream` of device `device` in the
// flat or the split layout; `mnp` is f32[4, a->n_pad].
// Returns a cudaError_t: cudaErrorInvalidValue for arguments the kernel
// does not take, the error of a refused shared-memory size, else
// cudaGetLastError() after the launch.
template <bool kFast, bool kDecompose>
int launch_chunk(int device, void* stream, const float* state_in,
                 float* state_out, float* esc, float* cov, float* wins,
                 const float* mnp, int w_pad, int near_k, const Launch* a,
                 int layout) {
  if (a == nullptr ||
      bad_chunk_args(w_pad, near_k, a->chunk_steps, a->pfreq, a->tcp,
                     a->rounds) ||
      a->n_pad < near_k || a->n_pad > kMaxMnps || a->n_pad % 8 != 0 ||
      (layout != kLayoutFlat && layout != kLayoutSplit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* fn = nullptr;
  int threads = 0, walkers = 0, smem = 0;
  rebuild_kernel<kFast, kDecompose>(near_k, a->flags != 0,
                                    layout == kLayoutSplit, a->n_pad, fn,
                                    threads, walkers, smem);
  if (smem > 0) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Launch la = *a;
  void* args[] = {&state_in, &state_out, &esc, &cov, &wins, &mnp, &w_pad,
                  &la};
  err = cudaLaunchKernel(fn, dim3(w_pad / walkers), dim3(threads), args,
                         static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launch one near/taylor-mode chunk (flat layout only);
// `near` is f32[4, near_k, w_pad], `taylor` f32[10, w_pad].  Returns a
// cudaError_t as above.
template <bool kFast, bool kDecompose>
int launch_chunk_near(int device, void* stream, const float* state_in,
                      float* state_out, float* esc, float* cov, float* wins,
                      const float* near, const float* taylor, int w_pad,
                      int near_k, const Launch* a, int layout) {
  const void* fn = nullptr;
  if (a == nullptr || near == nullptr || taylor == nullptr ||
      bad_chunk_args(w_pad, near_k, a->chunk_steps, a->pfreq, a->tcp,
                     a->rounds) ||
      layout != kLayoutFlat ||
      !near_kernel<kFast, kDecompose>(near_k, a->flags != 0, fn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Launch la = *a;
  void* args[] = {&state_in, &state_out, &esc, &cov, &wins, &near, &taylor,
                  &w_pad, &la};
  err = cudaLaunchKernel(fn, dim3(w_pad / kBlock), dim3(kBlock), args, 0,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// kernel_info of the rebuild entry's kernel in `layout` (flat or split)
// at an n_pad-entry table.
template <bool kFast, bool kDecompose>
int info_chunk(int near_k, int variants, int layout, int n_pad, int* out) {
  const void* fn = nullptr;
  int threads = 0, walkers = 0, smem = 0;
  if (out == nullptr || n_pad < 0 || n_pad > kMaxMnps ||
      (layout != kLayoutFlat && layout != kLayoutSplit) ||
      !rebuild_kernel<kFast, kDecompose>(near_k, variants != 0,
                                         layout == kLayoutSplit, n_pad, fn,
                                         threads, walkers, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return kernel_info(fn, threads, smem, out);
}

// kernel_info of the near entry's kernel (flat layout only).
template <bool kFast, bool kDecompose>
int info_chunk_near(int near_k, int variants, int layout, int n_pad,
                    int* out) {
  (void)n_pad;
  const void* fn = nullptr;
  if (out == nullptr || layout != kLayoutFlat ||
      !near_kernel<kFast, kDecompose>(near_k, variants != 0, fn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return kernel_info(fn, kBlock, 0, out);
}

}  // namespace

// The C entry points, two per entry, generator and decompose flag, each
// defined in its own source:
//   name_launch(device, stream, state_in, state_out, esc, cov, wins,
//               model0, model1, w_pad, near_k, launch, layout)
// with model0 = mnp and model1 unused in rebuild mode, model0 = near and
// model1 = taylor in near/taylor mode, and the layout kLayoutFlat (0) or
// kLayoutSplit (1, rebuild entry only).  In decompose mode state_in and
// state_out are f32[8, w_pad] and wins is f32[n_win, 2, w_pad].
//   name_info(near_k, variants, layout, n_pad, out[4])
// fills out with the registers, resident blocks per SM, dynamic
// shared-memory bytes and threads per block of that launch.
#define CHUNK_ENTRY(name, launcher, info, fast, dec, ...)                   \
  extern "C" int name##_launch(int device, void* stream,                    \
                               const float* state_in, float* state_out,     \
                               float* esc, float* cov, float* wins,         \
                               const float* model0, const float* model1,    \
                               int w_pad, int near_k, const Launch* a,      \
                               int layout) {                                \
    (void)model1;                                                           \
    return launcher<fast, dec>(device, stream, state_in, state_out, esc,    \
                               cov, wins, __VA_ARGS__, w_pad, near_k, a,    \
                               layout);                                     \
  }                                                                         \
  extern "C" int name##_info(int near_k, int variants, int layout,          \
                             int n_pad, int* out) {                         \
    return info<fast, dec>(near_k, variants, layout, n_pad, out);           \
  }

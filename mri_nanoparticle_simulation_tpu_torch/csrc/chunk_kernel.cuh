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
// What bounds it on the H100: issue slots.  Three Threefry-2x32-20
// blocks per walker-step cost about 200 integer operations, against
// about 280 float operations of physics at K = 10 (--fmad=false: one
// instruction each), and nothing goes to device memory inside a chunk.
// The fast generator draws two Philox-10 blocks (about 50 integer
// operations each) per step pair, and its polynomial Box-Muller replaces
// logf/cosf.  The state stays on chip: one walker per thread; its state
// and its 10 far-Taylor sums stay in registers for the whole chunk (the
// kernels are templated on K so the slot arrays unroll); in rebuild mode
// the dipole table, read by every thread at the same address, sits in
// shared memory.  Device memory is touched once at chunk start and once
// at chunk end, and in decompose mode once per window for the record (8
// bytes per walker and window, coalesced).
//
// The step's instructions (field_math.cuh): each slot's rsqrt is one
// MUFU.RSQ (rsqrt_ftz, where rsqrtf adds four instructions of subnormal
// scaling) and its mask one predicated add (add_where_greater, where a
// select and an add were two); the normals' sqrtf is its own fast path
// without the branch (sqrt_fast).  All three give the plain version's
// bits: csrc/math_check.cu proves it over every input they can see.
//
// The near entry (its step loop on the H100, PERF.md section 6): at
// 100096 walkers the work fills ~6 blocks of 128 per SM, so it cannot
// hide its chain behind more warps; it gives each thread more
// independent work instead.  The next step's words (Threefry: the three
// blocks fused and their 20 rounds unrolled, kUnrolledRounds; fast: the
// next step pair's Philox blocks) are computed after this step's draw is
// formed and before its field, one stretch of code without a branch, so
// the integer chains of the words and the float chain of the field
// interleave (run_steps_ahead, the flat rebuild entry's step loop too).
// On Threefry the K slots live in
// shared memory (float4 [K][128], the thread's own column, read with
// LDS.128: no bank conflict, 20 KB a block at K = 10), which frees 40
// registers: 8 blocks per SM fit (64 registers), no local memory, one
// wave.  On the fast generator the pair loop keeps both steps' slots,
// words and state in ~120 registers; the slots stay there and it runs 4
// blocks per SM, two waves at 100096 walkers, faster than any one-wave
// build that squeezed it into 80 (near_min_blocks).
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
// by the near entry and the flat rebuild entry; the split layout's is
// run_chain and run_field, the same arithmetic split over two warps.
//
// Layouts (the wrapper, engine/chunk_kernel.py:layout, picks one by
// width):
//
// * flat: w_pad / 128 blocks of 128 threads, one walker per thread, each
//   drawing its own words a step (pair) ahead (run_steps_ahead).  The
//   near entry (its slots and residency by generator, near_min_blocks);
//   the rebuild entry above chunk_kernel.split_threshold (where it
//   measured faster).
// * split (rebuild entry, chunk_split_kernel): w_pad / 32 blocks, each
//   of two walker warps and kGenWarps generator warps (field_math.cuh:
//   two on the fast generator, four on Threefry; the ring of kRingSteps
//   = 32 steps).  At the headline width (4096 padded walkers) that is
//   128 blocks, one per SM, where the flat layout put 32 blocks on 32
//   SMs; two blocks fit an SM (split_smem_bytes).  The generator warps
//   draw and finish everything a step needs that does not depend on the
//   walker's position (the step's displacement in and out of a cell, the
//   coin, the intracellular kick with its Cauchy term) ahead of the walker
//   warps into the ring.  Each walker is held by a lane of each walker warp,
//   which split its step by task (PERF.md section 6): the chain warp runs
//   the move, the near distances, the in-cell test and the bounce, the
//   chain from step to step, and hands each step's distances over through
//   shared memory; the field warp runs the near terms, the far Taylor
//   polynomial, the kicks and the windows.  Each walker warp so issues
//   about half of a step's instructions, and on the fast generator each
//   of the four warps has a scheduler to itself.  The chunk start is
//   shared: each warp selects over a part of the table, the walker warps
//   merge the parts exactly, and the generator warps compute the far
//   Taylor parts that the walker warps add in table order, five
//   coefficients each (chunk_split_kernel).
//
// Each warp of 32 walkers (in the split layout its chain warp for the
// coverage count, its field warp for the windows) reduces its own windows
// and coverage count (a shuffle tree, in a fixed order) into the per-warp
// outputs cov[w_pad / 32] and wins[w_pad / 32, n_win, 2]; the wrapper sums
// over warps, so the result is the same from run to run and in either
// layout.

#pragma once

#include "field_math.cuh"

namespace {

constexpr int kMaxMnps = 2048;

// The launch layouts (the C entry points' `layout` argument).
constexpr int kLayoutFlat = 0, kLayoutSplit = 1;

// The near entry's layout, by generator (PERF.md section 6, each chosen
// from timings of the alternatives on the H100).  Threefry: the K near
// slots in shared memory (SmemSlots, a float4 [K][kBlock] array) and
// __launch_bounds__ of 8 blocks per SM (at most 64 registers; 6 with the
// variants in decompose mode, where 64 spill): no local memory, one wave
// at 100096 walkers.  The fast generator: the slots in registers
// (RegSlots) and 4 blocks per SM (at most 128 registers; its step-pair
// loop holds both steps' slots, words and state): two waves at 100096
// walkers, which ran faster than every one-wave build (slots and far sums
// in shared memory at 80 registers: spills).  Both draw a step (pair)
// ahead, run_steps_ahead.
template <bool kFast, bool kVariants, bool kDecompose>
__host__ __device__ constexpr int near_min_blocks() {
  return kFast ? 4 : kVariants && kDecompose ? 6 : 8;
}

// Whether the near entry keeps its K slots in shared memory (else in
// registers), and its dynamic shared memory at K slots: float4
// [K][kBlock] with the slots in shared memory, else none.
template <bool kFast>
constexpr bool kNearSmemSlots = !kFast;

template <bool kFast>
__host__ __device__ constexpr int near_smem_bytes(int k) {
  return kNearSmemSlots<kFast> ? k * kBlock * 16 : 0;
}
static_assert(near_smem_bytes<false>(kMaxK) <= 48 * 1024,
              "the near entry launches without opting in to more than 48 KB");

// The Threefry rounds the flat layouts unroll (the reference's
// Threefry-20; other counts run the rounds as a loop).
constexpr int kUnrolledRounds = 20;

// run_steps, each step's (pair's) words drawn beside the step before, the
// flat layouts' step loop: on Threefry with the rounds unrolled where the
// launch asks for kUnrolledRounds, else as a loop.
template <int K, bool kFast, bool kVariants, bool kDecompose, class Slots>
__device__ __forceinline__ void run_steps_ahead(
    const Slots& slots, const float (&t)[10], float ax, float ay, float az,
    float phase, float comp, float phase_b, float comp_b, bool valid,
    unsigned lane, const Launch& a, float* __restrict__ wins,
    float* __restrict__ state_out, float* __restrict__ esc, int w_pad,
    int gid) {
  if constexpr (!kFast) {
    if (a.rounds == kUnrolledRounds) {
      run_steps<K, kFast, kVariants, kDecompose, kUnrolledRounds>(
          slots, t, ax, ay, az, phase, comp, phase_b, comp_b, valid, lane, a,
          wins, state_out, esc, w_pad, gid);
      return;
    }
  }
  run_steps<K, kFast, kVariants, kDecompose>(
      slots, t, ax, ay, az, phase, comp, phase_b, comp_b, valid, lane, a,
      wins, state_out, esc, w_pad, gid);
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

  run_steps_ahead<K, kFast, kVariants, kDecompose>(
      RegSlots<K>{nx, ny, nz, nm}, t, ax, ay, az, phase, comp, phase_b,
      comp_b, valid, lane, a, wins, state_out, esc, w_pad, gid);
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
// of the kSplitWarps warps scans a consecutive part of the table for the
// walkers of its lanes (the K nearest by sorted_insert_ids, and the count
// within reach) into shared memory; each walker warp merges the parts'
// sorted lists by (d2, id), which is exactly the serial insertion's result
// (ties go to the lower id, which is the lower part); the generator warps
// then compute the far Taylor parts of the table in tiles of kPartTile
// entries into two buffers, and the walker warps add them in table order,
// leaving out their K, one entry at a time as the serial sum: the field
// warp coefficients 0-4, the chain warp 5-9, which it hands over.
template <bool kFast>
constexpr int kSplitWarps = kWalkerWarps + kGenWarps<kFast>;
constexpr int kPartTile = 8;
constexpr int kPartFloats = 2 * 10 * kPartTile * kWarp;
constexpr int kBarTaylor = 9;   // the chain warp's far sums handed over
// The walker warps' places in a split block; the generator warps are the
// others, in order (a warp's scheduler is its index mod 4).
constexpr int kChainWarp = 0, kFieldWarp = 1;

// Dynamic shared memory of one split block at K slots before its
// hand-off: the table f32[4, n_pad], the ring, the two far-part buffers,
// the parts' K-lists (f32 and i32 [kSplitWarps, K, 32]) and counts (i32
// [kSplitWarps, 32]) and the chain warp's five far sums (f32 [5, 32]).
template <bool kFast, bool kVariants, int K>
__host__ __device__ constexpr int split_fixed_bytes(int n_pad) {
  return 16 * n_pad + ring_bytes<kVariants>() + 4 * kPartFloats
      + (8 * K + 4) * kSplitWarps<kFast> * kWarp + 4 * 5 * kWarp;
}

// Two split blocks fit an H100 SM's shared memory (228 KB, of it 1 KB
// reserved a block) in every mode and at every K, up to a table of 768
// entries (the headline's 716 dipoles pad to 720); a larger table leaves
// one, which the occupancy API reports and split_threshold follows.
constexpr int kSmBytes = 228 * 1024, kFitTable = 768;

// The hand-off's steps in a split block (run_chain, run_field): a power
// of two from 4 to 32, at most 32 KB, and halved while two blocks would
// not fit an SM at kFitTable.
template <bool kFast, bool kVariants, int K>
__host__ __device__ constexpr int split_hand_steps() {
  constexpr int kBytes = hand_fields<K, kVariants>() * kWarp * 4;
  int d = 32;
  while (d > 4 && (d * kBytes > 32768
                   || 2 * (split_fixed_bytes<kFast, kVariants, K>(kFitTable)
                           + d * kBytes + 1024) > kSmBytes)) {
    d /= 2;
  }
  return d;
}

// Dynamic shared memory of one split block at K slots, the hand-off last.
template <bool kFast, bool kVariants, int K>
__host__ __device__ constexpr int split_smem_bytes(int n_pad) {
  return split_fixed_bytes<kFast, kVariants, K>(n_pad)
      + split_hand_steps<kFast, kVariants, K>() * hand_fields<K, kVariants>()
          * kWarp * 4;
}

template <int K>
constexpr bool split_fits_two() {
  constexpr int kSm = kSmBytes, kTable = kFitTable;
  return 2 * (split_smem_bytes<false, false, K>(kTable) + 1024) <= kSm
      && 2 * (split_smem_bytes<false, true, K>(kTable) + 1024) <= kSm
      && 2 * (split_smem_bytes<true, false, K>(kTable) + 1024) <= kSm
      && 2 * (split_smem_bytes<true, true, K>(kTable) + 1024) <= kSm;
}
template <int... Ks>
constexpr bool split_fits_two_at(std::integer_sequence<int, Ks...>) {
  return (split_fits_two<Ks + 1>() && ...);
}
static_assert(split_fits_two_at(std::make_integer_sequence<int, kMaxK>{}),
              "two split blocks a SM at every K");

// A walker warp's merge of the parts' K-lists (s_sd, s_sid), and the
// chosen dipoles' payload from the table.
template <int K, int P>
__device__ __forceinline__ void merge_selected(
    const float* s_sd, const int* s_sid, const float* sx, const float* sy,
    const float* sz, const float* sm, int lane_id, float (&nx)[K],
    float (&ny)[K], float (&nz)[K], float (&nm)[K], int (&sid)[K]) {
  int head[P];
#pragma unroll
  for (int w = 0; w < P; ++w) head[w] = 0;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    // at slot s every list has given at most s < K entries
    float best = s_sd[head[0] * kWarp + lane_id];
    int id = s_sid[head[0] * kWarp + lane_id];
    int from = 0;
#pragma unroll
    for (int w = 1; w < P; ++w) {
      const int at = (w * K + head[w]) * kWarp + lane_id;
      const float d = s_sd[at];
      if (d < best) {
        best = d;
        id = s_sid[at];
        from = w;
      }
    }
#pragma unroll
    for (int w = 0; w < P; ++w) head[w] += from == w ? 1 : 0;
    const int j = max(id, 0);   // n_pad >= K: every slot holds a dipole
    sid[s] = id;
    nx[s] = id >= 0 ? sx[j] : 1e9f;
    ny[s] = id >= 0 ? sy[j] : 1e9f;
    nz[s] = id >= 0 ? sz[j] : 1e9f;
    nm[s] = id >= 0 ? sm[j] : 0.f;
  }
}

// The split layout: a block serves 32 walkers, one a lane in each warp:
// warp kChainWarp is their chain warp (run_chain), warp kFieldWarp their
// field warp (run_field), the others fill the ring with their draws; all
// of them share the chunk start (above).  While the walker warps merge,
// the generator warps fill the ring's first two halves, then the far
// parts, then the rest of the ring as the chain warp frees it.
template <int K, bool kFast, bool kVariants, bool kDecompose>
__global__ void __launch_bounds__(kSplitThreads<kFast>, 1)
chunk_split_kernel(const float* __restrict__ state_in,
                   float* __restrict__ state_out, float* __restrict__ esc,
                   float* __restrict__ cov, float* __restrict__ wins,
                   const float* __restrict__ mnp, int w_pad, Launch a) {
  constexpr int kParts = kSplitWarps<kFast>;
  constexpr int kThreads = kSplitThreads<kFast>;
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
  int* sel_id = reinterpret_cast<int*>(sel_d2 + kParts * K * kWarp);
  int* sel_cnt = sel_id + kParts * K * kWarp;
  float* s_taylor = reinterpret_cast<float*>(sel_cnt + kParts * kWarp);
  float* hand = s_taylor + 5 * kWarp;
  const int tid = threadIdx.x;
  for (int i = tid; i < 4 * n; i += kThreads) s_mnp[i] = mnp[i];
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
    const int q = (n + kParts - 1) / kParts;
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

  if (warp != kChainWarp && warp != kFieldWarp) {   // generator warp g
    const int g = warp - (warp > kChainWarp ? 1 : 0)
        - (warp > kFieldWarp ? 1 : 0);
    const int n_fill = (a.chunk_steps + kFill - 1) / kFill;
    generate<kFast, kVariants>(a, lane, ring, g, lane_id, 0, min(2, n_fill));
    for (int tt = 0; tt < n_tiles; ++tt) {
      const int b = tt & 1;
      if (tt >= 2) bar_sync(kBarPartEmpty + b, kThreads);
      const int e0 = tt * kPartTile;
      const int e1 = min(e0 + kPartTile, n);
      for (int e = e0 + g; e < e1; e += kGenWarps<kFast>) {
        float p[10];
        bz_taylor_parts(ax - sx[e], ay - sy[e], az - sz[e], sm[e], p);
#pragma unroll
        for (int c = 0; c < 10; ++c) {
          parts[((b * 10 + c) * kPartTile + e - e0) * kWarp + lane_id] = p[c];
        }
      }
      __threadfence_block();
      bar_arrive(kBarPartFull + b, kThreads);
    }
    generate<kFast, kVariants>(a, lane, ring, g, lane_id, 2, n_fill);
    return;
  }

  const bool valid = static_cast<unsigned>(gid) < a.num_water;
  float nx[K], ny[K], nz[K], nm[K];
  int sid[K];
  merge_selected<K, kParts>(sel_d2, sel_id, sx, sy, sz, sm, lane_id, nx, ny,
                            nz, nm, sid);
  if (warp == kChainWarp) {
    int cnt = 0;
#pragma unroll
    for (int w = 0; w < kParts; ++w) cnt += sel_cnt[w * kWarp + lane_id];
    const float n_cov = warp_sum(valid && cnt > K ? 1.f : 0.f);
    if (lane_id == 0) cov[gid / kWarp] = n_cov;
  }

  // far Taylor sums over the table, the K selected dipoles left out, in
  // table order from the generator warps' parts: five coefficients in
  // each walker warp
  const int c0 = warp == kChainWarp ? 5 : 0;
  float tp[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) tp[c] = 0.f;
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int b = tt & 1;
    bar_sync(kBarPartFull + b, kThreads);
    const int e0 = tt * kPartTile;
    const int e1 = min(e0 + kPartTile, n);
    for (int e = e0; e < e1; ++e) {
      bool selected = false;
#pragma unroll
      for (int s = 0; s < K; ++s) selected |= sid[s] == e;
      const float w = selected ? 0.f : 1.f;
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        tp[c] = tp[c]
            + parts[((b * 10 + c0 + c) * kPartTile + e - e0) * kWarp + lane_id]
                * w;
      }
    }
    if (tt + 2 < n_tiles) bar_arrive(kBarPartEmpty + b, kThreads);
  }

  if (warp == kChainWarp) {
#pragma unroll
    for (int c = 0; c < 5; ++c) s_taylor[c * kWarp + lane_id] = tp[c];
    __threadfence_block();
    bar_arrive(kBarTaylor, kHandThreads);
    run_chain<K, kFast, kVariants, split_hand_steps<kFast, kVariants, K>()>(
        nx, ny, nz, ax, ay, az, valid, a, ring, hand, state_out, esc, w_pad,
        gid);
  } else {
    bar_sync(kBarTaylor, kHandThreads);
    float t[10];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      t[c] = tp[c];
      t[5 + c] = s_taylor[c * kWarp + lane_id];
    }
    run_field<K, kVariants, kDecompose,
              split_hand_steps<kFast, kVariants, K>()>(
        RegSlots<K>{nx, ny, nz, nm}, t, ax, ay, az, state_in[4 * w_pad + gid],
        state_in[5 * w_pad + gid],
        kDecompose ? state_in[6 * w_pad + gid] : 0.f,
        kDecompose ? state_in[7 * w_pad + gid] : 0.f, valid, a, hand, wins,
        state_out, w_pad, gid);
  }
}

// The near entry: one walker a thread, its model from the inputs (the
// near slots into shared memory, each thread its own column, on
// Threefry, into registers on the fast generator; the far sums into
// registers), then the steps, each step's (pair's) words drawn beside
// the step before.
template <int K, bool kFast, bool kVariants, bool kDecompose>
__global__ void __launch_bounds__(
    kBlock, near_min_blocks<kFast, kVariants, kDecompose>())
chunk_near_kernel(const float* __restrict__ state_in,
                  float* __restrict__ state_out, float* __restrict__ esc,
                  float* __restrict__ cov, float* __restrict__ wins,
                  const float* __restrict__ near,
                  const float* __restrict__ taylor, int w_pad, Launch a) {
  extern __shared__ float4 s_slots[];
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
  if ((tid & (kWarp - 1)) == 0) cov[gid / kWarp] = 0.f;

  // the model: near [4, K, w_pad] (x, y, z, M * FIELD_SCALE) and taylor
  // [10, w_pad], each row read coalesced
  float nx[K], ny[K], nz[K], nm[K], t[10];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const float* row = near + s * w_pad + gid;   // x of slot s
    if constexpr (!kNearSmemSlots<kFast>) {
      nx[s] = row[0];
      ny[s] = row[K * w_pad];
      nz[s] = row[2 * K * w_pad];
      nm[s] = row[3 * K * w_pad];
    } else {
      s_slots[s * kBlock + tid] = make_float4(
          row[0], row[K * w_pad], row[2 * K * w_pad], row[3 * K * w_pad]);
    }
  }
#pragma unroll
  for (int c = 0; c < 10; ++c) t[c] = taylor[c * w_pad + gid];

  if constexpr (kNearSmemSlots<kFast>) {
    run_steps_ahead<K, kFast, kVariants, kDecompose>(
        SmemSlots{s_slots + tid}, t, ax, ay, az, phase, comp, phase_b,
        comp_b, valid, lane, a, wins, state_out, esc, w_pad, gid);
  } else {
    run_steps_ahead<K, kFast, kVariants, kDecompose>(
        RegSlots<K>{nx, ny, nz, nm}, t, ax, ay, az, phase, comp, phase_b,
        comp_b, valid, lane, a, wins, state_out, esc, w_pad, gid);
  }
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
      threads = kSplitThreads<kFast>;
      walkers = kWarp;
      smem = variants ? split_smem_bytes<kFast, true, K>(n_pad)
                      : split_smem_bytes<kFast, false, K>(n_pad);
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

// The near entry's kernel for `near_k` and the variants flag, with its
// dynamic shared-memory bytes; false for a K it is not instantiated for.
template <bool kFast, bool kDecompose>
bool near_kernel(int near_k, bool variants, const void*& fn, int& smem) {
  return dispatch_k(near_k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    fn = variants ? reinterpret_cast<const void*>(
                        chunk_near_kernel<K, kFast, true, kDecompose>)
                  : reinterpret_cast<const void*>(
                        chunk_near_kernel<K, kFast, false, kDecompose>);
    smem = near_smem_bytes<kFast>(K);
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
  int smem = 0;
  if (a == nullptr || near == nullptr || taylor == nullptr ||
      bad_chunk_args(w_pad, near_k, a->chunk_steps, a->pfreq, a->tcp,
                     a->rounds) ||
      layout != kLayoutFlat ||
      !near_kernel<kFast, kDecompose>(near_k, a->flags != 0, fn, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Launch la = *a;
  void* args[] = {&state_in, &state_out, &esc, &cov, &wins, &near, &taylor,
                  &w_pad, &la};
  err = cudaLaunchKernel(fn, dim3(w_pad / kBlock), dim3(kBlock), args,
                         static_cast<size_t>(smem),
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
  int smem = 0;
  if (out == nullptr || layout != kLayoutFlat ||
      !near_kernel<kFast, kDecompose>(near_k, variants != 0, fn, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return kernel_info(fn, kBlock, smem, out);
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
//   name_info(near_k, variants, layout, n_pad, out[5])
// fills out with the registers, resident blocks per SM, dynamic
// shared-memory bytes, threads per block and local-memory bytes per
// thread of that launch (field_math.cuh:kernel_info).
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

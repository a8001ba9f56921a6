// One sprint of the on-device (moment x echo-spacing) plane, on Hopper:
// the sprint's per-walker decomposition record folded into the carried
// per-spacing sums and the [S, T, wps, 2] curve block, in one launch.
//
// Replaces no TPU kernel: the JAX package's plane step
// (mri_nanoparticle_simulation_tpu/engine/decompose.py:make_plane_step)
// is jnp, which XLA fuses into a few kernels.  The port's plain version,
// engine/decompose.py:make_plane_step, is the same math in torch, about
// 47 small launches a sprint; at the headline (4032 walkers, 20 windows
// a sprint, 4 moment scales x 4 echo spacings) they took ~150 us of
// device time a sprint against a 2.4 ms sprint, and their ~40 host calls
// sat in the queue that feeds the chunk kernel.  The plain version stays
// the kernel's twin (the CPU path and the tests).
//
// What bounds it on the H100: bytes.  The record read once, the carry
// read and written, the block written: 1.24 MB a sprint at the headline
// (port_bench/work/counts.py:plane_fold_work), 0.37 us at 3.35 TB/s; its
// 9.35 MFLOP are less still.  What it takes in practice is latency: a
// chain of 20 windows of prefix sums, sincosf of each phase, and sums
// over the walkers.
//
// What this design does about it:
// * The grid is walker tiles x echo-spacing lanes (blockIdx.y = t), and a
//   block holds one thread per walker of its tile for each of up to
//   kMaxSlots moment scales: 32 x 4 blocks of 512 threads at the
//   headline, about one a SM and 16 warps each.  Every thread runs its
//   walker's prefix sums over the windows in order (the scale slots of a
//   walker repeat them; the record row comes from L1), so the phases of
//   all scales are in flight at once.
// * The prefix sums are the twin's operation for operation: the raw
//   increment d = x - u_prev * prev, g * d, added in window order in
//   double and rounded to float after each window (torch.cumsum on the
//   CPU accumulates float in double), then s = S + c and the Kahan update
//   of the carry.  So the carry is bitwise the CPU twin's.
// * The walker sums: a shuffle tree a warp, the tile's warps in order in
//   shared memory, one partial a block (tile, lane), and the last block
//   to finish (a ticket: the one atomic, on the counter, none in a sum)
//   adds the tiles' partials in tile order in double.  The same inputs
//   give the same bits, run after run, whatever order the blocks ran in.
// * sincosf and cosf are the accurate library functions (the phases
//   reach tens of radians), and the library's --fmad=false keeps every
//   product and sum apart as the twin computes them.

#include "field_math.cuh"

// The launch arguments; engine/chunk_kernel.py's `PlaneFold` mirrors it
// field by field.
struct PlaneFold {
  const float* wins;            // record [wps, 2, W_pad] (strides below)
  const float* sa;              // carried sums and compensations [T, W]
  const float* ca;
  const float* sb;
  const float* cb;
  const float* prev_a;          // the previous sprint's last row [W]
  const float* prev_b;
  const float* u_prev;          // [wps] sign undoing the base run's flip
  const float* g;               // [T, g_row] reconstruction parities
  const float* scales;          // [S] moment scales
  const long long* echo_rows;   // [n_specs, e_max] local echo rows
  const long long* echo_lane;   // [n_specs] spacing lane of each spec
  const float* echo_scale;      // [n_specs] moment scale of each spec
  float* carry;                 // out [4T + 2, W]: SA, cA, SB, cB, prev
  float* block;                 // out [S, T, wps, 2]
  float* echo;                  // out [n_specs, e_max, W]
  float* partials;              // scratch [tiles, T, S, wps, 2]
  unsigned* ticket;             // blocks done; 0 between launches
  long long win_row, win_half;  // record strides of a window, of B
  int g_row;                    // row stride of g
  int w, wps, n_scales, n_taucps, n_specs, e_max;
};

namespace {

constexpr int kTileWarps = kBlock / 32;  // warps over a tile's walkers
constexpr int kMaxSlots = 8;             // scale slots a block at most

int fold_threads(int n_scales) {
  return kBlock * (n_scales < kMaxSlots ? n_scales : kMaxSlots);
}

// Dynamic shared memory: the tile's warp sums [S][kTileWarps][wps][2],
// the sprint's u_prev and the lane's g [wps] each, the scales [S], and
// the block's echo list (row, destination, scale) of at most n_echo
// entries.
int fold_smem(int n_scales, int wps, int n_echo) {
  return static_cast<int>(sizeof(float)) *
             ((n_scales * kTileWarps + 1) * wps * 2 + n_scales) +
         static_cast<int>(sizeof(int) * 2 + sizeof(float)) * n_echo;
}

// Tiles added a batch in the last block: their loads in flight together.
constexpr int kSumBatch = 32;

__global__ void __launch_bounds__(kBlock * kMaxSlots)
plane_fold_kernel(const PlaneFold a) {
  extern __shared__ float smem[];
  __shared__ int n_echo;
  __shared__ bool is_last;
  const int n_t = a.n_taucps, n_s = a.n_scales, wps = a.wps, w = a.w;
  const int n_q = a.n_specs * a.e_max;
  float* red = smem;
  float* u_s = red + n_s * kTileWarps * wps * 2;
  float* g_s = u_s + wps;
  float* sc_s = g_s + wps;
  int* e_row = reinterpret_cast<int*>(sc_s + n_s);
  int* e_dst = e_row + n_q;
  float* e_sc = reinterpret_cast<float*>(e_dst + n_q);

  const int tid = threadIdx.x;
  const int lw = tid % kBlock;
  const int slot = tid / kBlock;
  const int n_slots = blockDim.x / kBlock;
  const int t = blockIdx.y;
  const int gw = blockIdx.x * kBlock + lw;
  const bool valid = gw < w;
  const int gr = valid ? gw : w - 1;   // padding threads read a real walker
  const int wq = lw / 32;
  const int lane = tid % 32;

  // this lane's echo rows, in spec order
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < a.n_specs; ++k) {
      if (a.echo_lane[k] != t) continue;
      for (int e = 0; e < a.e_max; ++e) {
        e_row[n] = static_cast<int>(a.echo_rows[k * a.e_max + e]);
        e_dst[n] = k * a.e_max + e;
        e_sc[n] = a.echo_scale[k];
        ++n;
      }
    }
    n_echo = n;
  }
  for (int j = tid; j < wps; j += blockDim.x) {
    u_s[j] = a.u_prev[j];
    g_s[j] = a.g[t * a.g_row + j];
  }
  for (int s = tid; s < n_s; s += blockDim.x) sc_s[s] = a.scales[s];
  __syncthreads();

  const float sa0 = a.sa[t * w + gr], ca0 = a.ca[t * w + gr];
  const float sb0 = a.sb[t * w + gr], cb0 = a.cb[t * w + gr];
  float pa = a.prev_a[gr], pb = a.prev_b[gr];
  const float validf = valid ? 1.f : 0.f;
  double acc_a = 0.0, acc_b = 0.0;
  float c_a = 0.f, c_b = 0.f;
  // the next window's record row is loaded while this one is folded
  const float* rec = a.wins + gr;
  float na = rec[0], nb = rec[a.win_half];
  // two windows an iteration: the second's phases, sines and shuffles
  // overlap the first's
#pragma unroll 2
  for (int j = 0; j < wps; ++j) {
    const float xa = na, xb = nb;
    if (j + 1 < wps) {
      na = rec[(j + 1) * a.win_row];
      nb = rec[(j + 1) * a.win_row + a.win_half];
    }
    const float u = u_s[j];
    const float gj = g_s[j];
    const float da = xa - u * pa;
    const float db = xb - u * pb;
    acc_a += static_cast<double>(gj * da);
    acc_b += static_cast<double>(gj * db);
    c_a = static_cast<float>(acc_a);
    c_b = static_cast<float>(acc_b);
    const float s_a = sa0 + c_a;
    const float s_b = sb0 + c_b;
    for (int s = slot; s < n_s; s += n_slots) {
      float sn, cs;
      sincosf(sc_s[s] * s_a + s_b, &sn, &cs);
      cs = warp_sum(cs * validf);
      sn = warp_sum(sn * validf);
      if (lane == 0) {
        float* r = red + ((s * kTileWarps + wq) * wps + j) * 2;
        r[0] = cs;
        r[1] = sn;
      }
    }
    if (slot == 0 && valid) {
      for (int e = 0; e < n_echo; ++e) {
        if (e_row[e] == j) {
          a.echo[static_cast<size_t>(e_dst[e]) * w + gw] =
              cosf(e_sc[e] * s_a + s_b);
        }
      }
    }
    pa = xa;
    pb = xb;
  }
  // Kahan fold of the sprint's increments: y = inc - comp; t = s + y;
  // comp = (t - s) - y
  if (slot == 0 && valid) {
    const float ya = c_a - ca0;
    const float ta = sa0 + ya;
    const float yb = c_b - cb0;
    const float tb = sb0 + yb;
    a.carry[t * w + gw] = ta;
    a.carry[(n_t + t) * w + gw] = (ta - sa0) - ya;
    a.carry[(2 * n_t + t) * w + gw] = tb;
    a.carry[(3 * n_t + t) * w + gw] = (tb - sb0) - yb;
    if (t == 0) {
      a.carry[4 * n_t * w + gw] = pa;
      a.carry[(4 * n_t + 1) * w + gw] = pb;
    }
  }

  // the block's partial: its tile's warps in order
  __syncthreads();
  const int per = n_s * wps * 2;
  float* part = a.partials + static_cast<size_t>(blockIdx.x * n_t + t) * per;
  for (int i = tid; i < per; i += blockDim.x) {
    const int s = i / (wps * 2), r = i % (wps * 2);
    float v = 0.f;
    for (int q = 0; q < kTileWarps; ++q) {
      v += red[(s * kTileWarps + q) * wps * 2 + r];
    }
    part[i] = v;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    is_last = atomicAdd(a.ticket, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!is_last) return;

  // the last block: every tile's partial in tile order, the walker mean,
  // g times the sine's
  __threadfence();
  const size_t tile_stride = static_cast<size_t>(n_t) * per;
  for (int o = tid; o < n_s * n_t * wps * 2; o += blockDim.x) {
    const int c = o % 2;
    const int j = (o / 2) % wps;
    const int tt = (o / (2 * wps)) % n_t;
    const int s = o / (2 * wps * n_t);
    const float* p = a.partials + static_cast<size_t>(tt) * per +
                     (s * wps + j) * 2 + c;
    const int n_tiles = gridDim.x;
    double acc = 0.0;
    int b = 0;
    for (; b + kSumBatch <= n_tiles; b += kSumBatch) {
      float v[kSumBatch];
#pragma unroll
      for (int k = 0; k < kSumBatch; ++k) {
        v[k] = __ldcg(p + (b + k) * tile_stride);
      }
#pragma unroll
      for (int k = 0; k < kSumBatch; ++k) acc += static_cast<double>(v[k]);
    }
    for (; b < n_tiles; ++b) {
      acc += static_cast<double>(__ldcg(p + b * tile_stride));
    }
    const float mean = static_cast<float>(acc) / static_cast<float>(w);
    a.block[o] = c ? a.g[tt * a.g_row + j] * mean : mean;
  }
  if (tid == 0) *a.ticket = 0u;
}

bool fold_args_ok(const PlaneFold& a) {
  return a.w > 0 && a.wps > 0 && a.n_scales > 0 && a.n_taucps > 0 &&
         a.n_taucps <= 65535 && a.n_specs >= 0 && a.e_max >= 0 &&
         a.wins != nullptr && a.carry != nullptr && a.block != nullptr &&
         a.partials != nullptr && a.ticket != nullptr &&
         (a.n_specs == 0 || a.echo != nullptr);
}

}  // namespace

// Launch one sprint's fold (the fields of `a` as PlaneFold says) on
// `stream`; `a.ticket` must be 0 and no other fold may use it until this
// one ends (the kernel leaves it 0).  Returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernel does not take, else
// cudaGetLastError().
extern "C" int plane_fold_launch(int device, void* stream,
                                 const PlaneFold* a) {
  if (a == nullptr || !fold_args_ok(*a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the launch's own shared memory, every launch: it varies with the echo
  // rows, and plane_fold_info's query leaves the attribute at its own
  const int smem = fold_smem(a->n_scales, a->wps, a->n_specs * a->e_max);
  err = cudaFuncSetAttribute(plane_fold_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a->w + kBlock - 1) / kBlock, a->n_taucps);
  plane_fold_kernel<<<grid, fold_threads(a->n_scales), smem,
                      static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// The kernel at `n_scales` scales, `wps` windows and `n_echo` echo rows
// as the runtime reports it (field_math.cuh:kernel_info): registers,
// resident blocks per SM, dynamic shared-memory bytes, threads per block
// and local-memory bytes per thread, into out[0..4].  Returns a
// cudaError_t.
extern "C" int plane_fold_info(int n_scales, int wps, int n_echo,
                               int* out) {
  if (out == nullptr || n_scales <= 0 || wps <= 0 || n_echo < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return kernel_info(reinterpret_cast<const void*>(plane_fold_kernel),
                     fold_threads(n_scales), fold_smem(n_scales, wps, n_echo),
                     out);
}

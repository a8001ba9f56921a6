// The rebuild-mode chunk kernel with the fast generator (Philox4x32-10) in
// decompose mode (the per-walker (A, B) record of a phase-decomposition run),
// K = 1..16, default physics and variants, flat and split layouts:
// instantiated here, defined in chunk_kernel.cuh.

#include "chunk_kernel.cuh"

CHUNK_ENTRY(chunk_kernel_fast_dec, launch_chunk, info_chunk,
            true, true, model0)

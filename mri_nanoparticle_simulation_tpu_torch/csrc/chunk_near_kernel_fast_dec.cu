// The near/taylor-mode chunk kernel with the fast generator (Philox4x32-10)
// in decompose mode (the per-walker (A, B) record of a phase-decomposition
// run), K = 1..16, default physics and variants, flat layout: instantiated
// here, defined in chunk_kernel.cuh.

#include "chunk_kernel.cuh"

CHUNK_ENTRY(chunk_near_kernel_fast_dec, launch_chunk_near, info_chunk_near,
            true, true, model0, model1)

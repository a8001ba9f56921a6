// The near/taylor-mode chunk kernel with the Threefry generator in decompose
// mode (the per-walker (A, B) record of a phase-decomposition run), K =
// 1..16, default physics and variants, flat layout: instantiated here,
// defined in chunk_kernel.cuh.

#include "chunk_kernel.cuh"

CHUNK_ENTRY(chunk_near_kernel_dec, launch_chunk_near, info_chunk_near,
            false, true, model0, model1)

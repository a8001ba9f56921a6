// The near/taylor-mode chunk kernel with the fast generator
// (Philox4x32-10), K = 1..16, default physics and variants: instantiated
// here, defined in chunk_kernel.cuh.

#include "chunk_kernel.cuh"

CHUNK_ENTRY(chunk_near_kernel_fast_launch, launch_chunk_near, true, false,
            model0, model1)

// The rebuild-mode chunk kernel with the Threefry generator, K = 1..16,
// default physics and variants: instantiated here, defined in
// chunk_kernel.cuh.

#include "chunk_kernel.cuh"

CHUNK_ENTRY(chunk_kernel_launch, launch_chunk, false, model0)

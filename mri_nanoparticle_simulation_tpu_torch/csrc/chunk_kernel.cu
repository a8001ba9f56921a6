// The rebuild-mode chunk kernel with the Threefry generator, K = 1..16,
// default physics and variants, flat and split layouts: instantiated here,
// defined in chunk_kernel.cuh.

#include "chunk_kernel.cuh"

CHUNK_ENTRY(chunk_kernel, launch_chunk, info_chunk, false, false, model0)

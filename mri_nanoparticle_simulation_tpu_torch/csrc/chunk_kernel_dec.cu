// The rebuild-mode chunk kernel with the Threefry generator in decompose
// mode (the per-walker (A, B) record of a phase-decomposition run),
// K = 1..16, default physics and variants: instantiated here, defined in
// chunk_kernel.cuh.

#include "chunk_kernel.cuh"

CHUNK_ENTRY(chunk_kernel_dec_launch, launch_chunk, false, true, model0)

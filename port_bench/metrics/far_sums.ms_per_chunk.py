"""Device milliseconds of the exact far sums a chunk: the device seconds
(CUDA events on the launching stream) of the span
``chunk_kernel.far_sums``, which brackets each launch of the far-sums
kernel, over the span's calls, one a chunk at far-table order 0.
Layer: the far sums ``csrc/far_sums_kernel.cu``.  It moves
walker_steps_per_s where the exact far field is rebuilt every chunk."""

from mri_nanoparticle_simulation_tpu_torch.utils import profiling

KIND = "per_layer"
UNIT = "ms/chunk"
LAYER = "far sums csrc/far_sums_kernel.cu"
MOVES = "walker_steps_per_s"
SPAN = "chunk_kernel.far_sums"


def read(ctx):
    span = getattr(profiling, "span_summary", dict)().get(SPAN)
    if ctx.trace is None or span is None or not span["calls"] \
            or span["device_s"] is None:
        return None
    return 1e3 * span["device_s"] / span["calls"]

"""Device milliseconds a chunk of the chunk kernel's variant modes: the
device seconds (CUDA events on the launching stream) of the span
``chunk_kernel.variants``, which brackets each launch whose physics has
a variant on (membrane reflection, the intended kick, sphere directions,
a gradient), over the span's calls, one a chunk.  Layer: the kernels'
variant modes (``csrc/field_math.cuh``, ``kVariants``).  It moves
walker_steps_per_s where the variant chunk kernel holds the card."""

from mri_nanoparticle_simulation_tpu_torch.utils import profiling

KIND = "per_layer"
UNIT = "ms/chunk"
LAYER = "kernels' variant modes csrc/field_math.cuh"
MOVES = "walker_steps_per_s"
SPAN = "chunk_kernel.variants"


def read(ctx):
    span = getattr(profiling, "span_summary", dict)().get(SPAN)
    if ctx.trace is None or span is None or not span["calls"] \
            or span["device_s"] is None:
        return None
    return 1e3 * span["device_s"] / span["calls"]

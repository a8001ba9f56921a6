"""Device milliseconds of the large path's cube selection a chunk at
far-table order 0: the device seconds (CUDA events on the sprint's
stream) of the span ``expansion.select`` (each anchor's cube
candidates, their exact d^2, the K masked bfloat16 argmin passes and
the reach count, as torch kernels) over the span's calls, one a chunk.
Layer: the cube selection ``fields/expansion.cube_select``.  It moves
walker_steps_per_s where the selection's chain of small kernels shares
the card with the near entry and the far sums."""

from mri_nanoparticle_simulation_tpu_torch.utils import profiling

KIND = "per_layer"
UNIT = "ms/chunk"
LAYER = "cube selection fields/expansion.cube_select"
MOVES = "walker_steps_per_s"
SPAN = "expansion.select"


def read(ctx):
    span = getattr(profiling, "span_summary", dict)().get(SPAN)
    if ctx.trace is None or span is None or not span["calls"] \
            or span["device_s"] is None:
        return None
    return 1e3 * span["device_s"] / span["calls"]

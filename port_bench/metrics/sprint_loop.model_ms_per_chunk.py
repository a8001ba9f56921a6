"""Device milliseconds of the large-scene model a chunk: the device
seconds (CUDA events on the sprint's stream) of the span
``sprint_loop.model`` (the wrap of the anchors, the candidate model or
the far sums, the coverage count) over the traced window's chunks.
Layer: the large-scene model ``fields/expansion.build_planes``.  It
moves walker_steps_per_s on the scale-up, where every chunk rebuilds
the model before the near entry runs."""

from mri_nanoparticle_simulation_tpu_torch.utils import profiling

KIND = "per_layer"
UNIT = "ms/chunk"
LAYER = "large-scene model fields/expansion.build_planes"
MOVES = "walker_steps_per_s"


def read(ctx):
    traced = ctx.window.get("traced")
    model = getattr(profiling, "span_summary", dict)().get(
        "sprint_loop.model")
    if ctx.trace is None or not traced or not traced["chunks"] \
            or model is None or model["device_s"] is None:
        return None
    return 1e3 * model["device_s"] / traced["chunks"]

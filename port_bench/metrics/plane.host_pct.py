"""Share of the traced window spent in the plane's own host work, in %:
the host seconds of the spans ``plane.setup`` (a call's sign and echo
tables, its sprint and plane step, the tables put on the device) and
``plane.assemble`` (the echo matrices and result assembled in NumPy
after the final copy) over the window.  Layer: the plane
``engine/decompose.run_plane_on_device``.  It moves walker_steps_per_s
where each call's set-up and assembly leave the card idle."""

from mri_nanoparticle_simulation_tpu_torch.utils import profiling

KIND = "per_layer"
UNIT = "%"
LAYER = "plane engine/decompose.run_plane_on_device"
MOVES = "walker_steps_per_s"
SPANS = ("plane.setup", "plane.assemble")


def read(ctx):
    t = ctx.trace
    spans = getattr(profiling, "span_summary", dict)()
    if t is None or t.window_s <= 0 or not all(s in spans for s in SPANS):
        return None
    return 100.0 * sum(spans[s]["host_s"] for s in SPANS) / t.window_s

"""The host's microseconds to queue one chunk of the walk: the host
seconds of the span ``sprint_loop.sprint`` (the sprint's loop of chunk
launches, the wrappers and the large-scene model included) over the
traced window's chunks, to set against a chunk's device time.  Where
the card sets the pace, the launch queue fills and the host waits in
it, so the reading comes near the chunk's device time.  Layer: the
sprint loop ``engine/cuda_engine.make_sprint_fn``.  It moves
walker_steps_per_s where the host queues a chunk slower than the card
runs it."""

from mri_nanoparticle_simulation_tpu_torch.utils import profiling

KIND = "per_layer"
UNIT = "us/chunk"
LAYER = "sprint loop engine/cuda_engine.make_sprint_fn"
MOVES = "walker_steps_per_s"


def read(ctx):
    traced = ctx.window.get("traced")
    spans = getattr(profiling, "span_summary", dict)()
    if ctx.trace is None or not traced or not traced["chunks"] \
            or "sprint_loop.sprint" not in spans:
        return None
    return 1e6 * spans["sprint_loop.sprint"]["host_s"] / traced["chunks"]

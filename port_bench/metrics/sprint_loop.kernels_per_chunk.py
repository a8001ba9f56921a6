"""Kernels launched on the card per chunk of the walk in the traced
window, torch's glue kernels included: the chunk kernel, the candidate
model, and every small kernel the sprint loop, the runner and the plane
step issue around them.  A count that repeats exactly.  Layer: the
sprint loop ``engine/cuda_engine.make_sprint_fn`` with the wrappers
``engine/chunk_kernel.run_*``.  It moves walker_steps_per_s where the
glue shares the card with a short chunk."""

KIND = "per_layer"
UNIT = "launches/chunk"
LAYER = "sprint loop engine/cuda_engine.make_sprint_fn"
MOVES = "walker_steps_per_s"


def read(ctx):
    t, traced = ctx.trace, ctx.window.get("traced")
    if t is None or traced is None or not traced["chunks"] or not t.kernels:
        return None
    return t.kernels / traced["chunks"]

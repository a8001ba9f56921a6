"""The least time the card could take for the traced window's work over
the summed device time of every kernel in it, in %.  The work is
counted from the cell's shapes and physics (``work/counts.py``): each
chunk of the walk, the candidate model of the large path, the plane
fold; no kernel's name enters it, so fusing or splitting kernels moves
the share only through time.  Layer: the kernels of ``csrc/*.cu``.  It
moves walker_steps_per_s where the chunk kernel holds the card."""

from port_bench.work import counts

KIND = "per_layer"
UNIT = "%"
LAYER = "kernels csrc/*.cu"
MOVES = "walker_steps_per_s"


def read(ctx):
    t, traced = ctx.trace, ctx.window.get("traced")
    if t is None or traced is None or t.kernel_s <= 0:
        return None
    cell = ctx.cell
    keys = ctx.config["keys"] | cell.get("keys", {})
    plane = cell if "moment_scales" in cell else None
    bound_ms = counts.window_bound_ms(
        keys, cell["generator"] == "fast", ctx.n_mnp, traced["chunks"],
        traced["sprints"], plane)
    return counts.share_pct(bound_ms, 1e3 * t.kernel_s)

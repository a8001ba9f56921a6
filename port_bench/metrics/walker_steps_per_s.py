"""Walker-steps completed over the window's wall time: every step of
every walker the window's calls ran, over the time from the window's
start to the end of its last call, which ends in a device sync.  The
figure users compare with the reference's K40 (~1.9e8), and the
reciprocal of their wall per curve."""

KIND = "end_to_end"
UNIT = "walker-steps/s"


def read(ctx):
    w = ctx.window
    return w["walker_steps"] / w["wall_s"] if w["wall_s"] > 0 else None

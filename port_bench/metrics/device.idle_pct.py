"""Share of the traced window in which no operation ran on the card:
100 x (1 - the union of the device operations' intervals over the
window's length).  Layer: the device.  It moves walker_steps_per_s where
the host cannot keep the card fed: short chunks, host work between
calls."""

KIND = "per_layer"
UNIT = "%"
LAYER = "device"
MOVES = "walker_steps_per_s"


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

"""Share of the traced window in which the runner's own host work ran
with nothing new queued on the card, in %: the host seconds of the
spans ``runner.state_in`` (the CSV writer's open, the walkers into the
kernels' layout), ``runner.csv_append`` (a drain's rows into the CSV)
and ``runner.state_out`` (the walkers back, checkpoints) over the
window.  Layer: the runner ``engine/sim.SimulationRunner.run``.  It
moves walker_steps_per_s where the card's queue runs dry at each drain
while the host formats rows."""

from mri_nanoparticle_simulation_tpu_torch.utils import profiling

KIND = "per_layer"
UNIT = "%"
LAYER = "runner engine/sim.SimulationRunner.run"
MOVES = "walker_steps_per_s"
SPANS = ("runner.state_in", "runner.csv_append", "runner.state_out")


def read(ctx):
    t = ctx.trace
    spans = getattr(profiling, "span_summary", dict)()
    if t is None or t.window_s <= 0 or not any(s in spans for s in SPANS):
        return None
    host_s = sum(spans[s]["host_s"] for s in SPANS if s in spans)
    return 100.0 * host_s / t.window_s

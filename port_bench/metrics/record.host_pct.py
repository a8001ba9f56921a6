"""Share of the traced window spent in the record path's host work, in
%: the host seconds of the spans ``record.commit`` (each sprint's record
blocks kept on the host, while the card runs the next sprint),
``record.reconstruct`` (the float64 curves of every grid point from the
whole record) and ``record.write`` (the CSVs and the dispersion table)
over the window.  Layer: the record path
``engine/decompose.run_decomposition`` and its reconstruction.  It
moves walker_steps_per_s where the host's work after each run leaves
the card idle."""

from mri_nanoparticle_simulation_tpu_torch.utils import profiling

KIND = "per_layer"
UNIT = "%"
LAYER = "record path engine/decompose.run_decomposition + reconstruction"
MOVES = "walker_steps_per_s"
SPANS = ("record.commit", "record.reconstruct", "record.write")


def read(ctx):
    t = ctx.trace
    spans = getattr(profiling, "span_summary", dict)()
    if t is None or t.window_s <= 0 or not all(s in spans for s in SPANS):
        return None
    return 100.0 * sum(spans[s]["host_s"] for s in SPANS) / t.window_s

"""The host's microseconds per call of a kernel wrapper: the host
seconds over the calls of the spans ``chunk_kernel.run_chunk``,
``run_chunk_near``, ``run_cand_model`` and ``run_far_sums`` in the
traced window (argument checks, the layout, the ctypes launch, and a
wait in a full launch queue where the card sets the pace).  Layer: the
wrappers ``engine/chunk_kernel.run_*``.  It moves walker_steps_per_s
where the launches set the host's pace."""

from mri_nanoparticle_simulation_tpu_torch.utils import profiling

KIND = "per_layer"
UNIT = "us/launch"
LAYER = "wrappers engine/chunk_kernel.run_*"
MOVES = "walker_steps_per_s"
SPANS = ("chunk_kernel.run_chunk", "chunk_kernel.run_chunk_near",
         "chunk_kernel.run_cand_model", "chunk_kernel.run_far_sums")


def read(ctx):
    spans = getattr(profiling, "span_summary", dict)()
    calls = sum(spans[s]["calls"] for s in SPANS if s in spans)
    if ctx.trace is None or not calls:
        return None
    return 1e6 * sum(spans[s]["host_s"] for s in SPANS if s in spans) / calls

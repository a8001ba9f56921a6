"""The far-sums kernel's share of its roofline, in %: the least time the
card could take for the exact far sums of every call of the span
``chunk_kernel.far_sums`` (``work/counts.far_sums_work``: the table
once and each walker's anchor, K ids and ten sums, 65 float operations
a walker-dipole pair and K integer ones a walker, over the
configuration's walkers and the scene's table padded to a multiple of
8) over the span's device time.  Layer: the far sums
``csrc/far_sums_kernel.cu``.  It moves walker_steps_per_s where the
exact far field is rebuilt every chunk."""

from mri_nanoparticle_simulation_tpu_torch.utils import profiling
from port_bench.work import counts

KIND = "per_layer"
UNIT = "%"
LAYER = "far sums csrc/far_sums_kernel.cu"
MOVES = "walker_steps_per_s"
SPAN = "chunk_kernel.far_sums"


def read(ctx):
    span = getattr(profiling, "span_summary", dict)().get(SPAN)
    if ctx.trace is None or span is None or not span["calls"] \
            or not span["device_s"]:
        return None
    keys = ctx.config["keys"] | ctx.cell.get("keys", {})
    bound_ms = counts.bound(*counts.far_sums_work(
        keys["num_water"], -(-ctx.n_mnp // 8) * 8, keys["near_k"]))[0]
    return counts.share_pct(span["calls"] * bound_ms,
                            1e3 * span["device_s"])

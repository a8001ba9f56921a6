"""The work a run does, counted from its shapes and physics, and the
least time the card could take for it.

Counts come from what the algorithm needs, never from which kernels
implement it: a chunk of the walk, the candidate model of the large
path and the plane fold are counted the same whatever fuses or splits
them.  Peaks: NVIDIA H100 SXM (132 SMs at 1.98 GHz, 700 W), HBM3 at
3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s (128 lanes per SM
and cycle, a fused multiply-add two operations), issue slots 4 x 32 per
SM and cycle, INT32 lanes 64 per SM and cycle.
"""

from __future__ import annotations

from typing import NamedTuple

PEAK_BYTES = 3.35e12
PEAK_FP32 = 2 * 128 * 132 * 1.98e9
PEAK_ISSUE = 128 * 132 * 1.98e9
PEAK_INT32 = 64 * 132 * 1.98e9

#: integer operations per walker of one Threefry-2x32-20 block: 20
#: rounds of add, rotate, xor, the key injections' adds into x1 and the
#: last injection's add into x0
THREEFRY_IOPS = 20 * 3 + 5 + 1
#: integer operations per walker of one Philox4x32-10 block: per round
#: two mul.hi, two mul.lo and two three-input xors, fewer in the first
#: three rounds, where only the lane is the walker's own
PHILOX_IOPS = 1 + 3 + 4 + 7 * 6


class Mode(NamedTuple):
    """What sets a walker-step's work."""
    fast_rng: bool
    pfreq: int
    chunk_steps: int
    near_k: int
    reflect: bool = False
    intended: bool = False
    sphere: bool = False
    gradient: bool = False


def bound(nbytes, flops, iops):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations' time, itself the larger of the issue
    slots (float at the float32 peak, each integer operation a slot) and
    the integer operations over the INT32 lanes."""
    t_ops = max(flops / PEAK_FP32 + iops / PEAK_ISSUE, iops / PEAK_INT32)
    t_bytes = nbytes / PEAK_BYTES
    return ((1e3 * t_bytes, "bytes") if t_bytes > t_ops
            else (1e3 * t_ops, "operations"))


def step_ops(m: Mode):
    """(float, integer) operations of one walker-step: the field at the
    new position (19 per near slot, 30 for the far Taylor polynomial),
    the move, in-cell test, kick and window sum (25); Threefry: three
    blocks (four with a variant that draws more), the uniforms (5, +1
    per extra word), their conversions and scalings (5), the normal (6),
    the cube direction and its inverse norm (13), escape tracking (9);
    the fast generator, per step half a pair: two Philox blocks (three
    when the words outgrow them), the polynomial Box-Muller (40 a pair)
    and packed directions (6 integer and 16 float a pair), escape
    tracking every second or fourth step; variants: reflection 10, the
    intended kick 12, a gradient 7, sphere directions 12."""
    k = m.near_k
    flops = 19 * k + 30 + 25
    iops = 0
    extra = int(m.reflect) + int(m.intended)
    if m.fast_rng:
        blocks = 2 + int((8 if m.sphere else 5) + 2 * extra > 8)
        iops += blocks * PHILOX_IOPS / 2 + 3
        flops += 20 + 8 + 9 / (2 if m.pfreq % 4 else 4)
    else:
        iops += (4 if extra else 3) * THREEFRY_IOPS + 5 + extra
        flops += 5 + 6 + 13 + 9
    flops += (10 * m.reflect + 12 * m.intended + 7 * m.gradient
              + 12 * m.sphere)
    return flops, iops


def chunk_work(w: int, m: Mode, n_pad: int = 0, decompose: bool = False):
    """(bytes, float, integer operations) of one chunk on ``w`` walkers:
    the state in and out, escapes, coverage, the window output (warp
    sums, or the per-walker record of a decomposition run) and the model
    (with ``n_pad``, the whole-table selection: the table once, 8 + 4K
    operations of selection and 65 + K of far sums per entry; without,
    the near slots and Taylor sums of each walker)."""
    k = m.near_k
    n_win = m.chunk_steps // m.pfreq
    rows = 8 if decompose else 6
    warps = -(-w // 32)
    wins = n_win * 2 * w if decompose else warps * n_win * 2
    nbytes = 4 * (2 * rows * w + w + warps + wins)
    f, i = step_ops(m)
    flops = w * m.chunk_steps * (f + decompose)
    iops = w * m.chunk_steps * i
    if n_pad:
        nbytes += 16 * n_pad
        flops += w * n_pad * (8 + 4 * k + 65 + k)
    else:
        nbytes += 4 * (4 * k + 10) * w
    return nbytes, flops, iops


def cand_model_work(w: int, k: int, c: int, h: int, n_coeffs: int):
    """(bytes, float, integer operations) of one candidate-model pass:
    the anchors, the scene's candidate table (4 values per candidate)
    and far table read once, the near slots, Taylor sums and reach
    counts written once; per walker 8 + 4K operations for each of the C
    candidates, 65 for each of the C - K not selected, and 20 per far
    table coefficient."""
    nbytes = (4 * (3 + 4 * k + 10 + 1) * w + 4 * h ** 3 * c * 4
              + 4 * h ** 3 * n_coeffs)
    return nbytes, w * (c * (8 + 4 * k) + (c - k) * 65 + 20 * n_coeffs), 0


def far_sums_work(w: int, n_pad: int, k: int):
    """(bytes, float, integer operations) of the exact far sums over an
    ``n_pad``-entry table without each walker's K near ids."""
    return 16 * n_pad + 4 * (3 + k + 10) * w, 65 * w * n_pad, k * w


def plane_fold_work(w: int, w_pad: int, wps: int, n_scales: int,
                    n_taucps: int):
    """(bytes, float, integer operations) of one sprint of the plane
    fold: the sprint's record read once, the carried sums and
    compensations read and written, the curve block written; per walker
    and window 4 operations of raw increments, and per echo spacing 2 of
    prefix sums and 2 of carry, then per moment scale 2 for the phase,
    2 for its cosine and sine and 2 for their means."""
    nbytes = 4 * (wps * 2 * w_pad + 2 * (4 * n_taucps + 2) * w
                  + n_scales * n_taucps * wps * 2)
    flops = w * wps * (4 + n_taucps * (4 + 6 * n_scales))
    return nbytes, flops, 0


def n_coeffs(order: int) -> int:
    """Monomials of total degree at most ``order`` in three variables."""
    return (order + 1) * (order + 2) * (order + 3) // 6


def window_bound_ms(cfg: dict, fast_rng: bool, n_mnp: int, chunks: int,
                    sprints: int, plane: dict | None = None) -> float:
    """The least time for ``chunks`` chunks and ``sprints`` sprints of a
    run of configuration ``cfg`` over ``n_mnp`` dipoles: each chunk
    bound on its own, as each waits for the one before; the candidate
    model per chunk on the large path (the exact far sums at far-table
    order 0); with ``plane`` (its ``moment_scales`` and ``echo_taucps``)
    the fold per sprint."""
    w = cfg["num_water"]
    pfreq = int(round(cfg["print_interval"] / cfg["tau"]))
    m = Mode(fast_rng, pfreq, cfg["chunk_steps"], cfg["near_k"],
             reflect=bool(cfg["reflect_io"] or cfg["reflect_oi"]),
             intended=cfg["kick_mode"] == "intended",
             sphere=cfg["direction_mode"] == "sphere",
             gradient=any(cfg["b0_gradient"]))
    large = n_mnp > 2048
    n_pad = 0 if large else -(-n_mnp // 8) * 8
    per_chunk = bound(*chunk_work(w, m, n_pad, plane is not None))[0]
    if large:
        if cfg["far_table_order"] > 0:
            per_chunk += bound(*cand_model_work(
                w, cfg["near_k"], cfg["cube_candidates"],
                cfg["cube_hash_dim"], n_coeffs(cfg["far_table_order"])))[0]
        else:
            per_chunk += bound(*far_sums_work(w, -(-n_mnp // 8) * 8,
                                              cfg["near_k"]))[0]
    total = chunks * per_chunk
    if plane is not None:
        wps = cfg["sprint_steps"] // pfreq
        total += sprints * bound(*plane_fold_work(
            w, -(-w // 128) * 128, wps, len(plane["moment_scales"]),
            len(plane["echo_taucps"])))[0]
    return total


def share_pct(bound_ms: float, device_ms: float) -> float:
    """100 x bound / device time; a share above 100% means the work or
    the time is counted wrong, and raises."""
    if device_ms <= 0:
        raise ValueError("no device time to share")
    pct = 100.0 * bound_ms / device_ms
    if pct > 100.0:
        raise ValueError(f"roofline share {pct:.4f}% exceeds 100%: the work "
                         f"({bound_ms} ms) is counted too high or the "
                         f"device time ({device_ms} ms) leaves work out")
    return pct

"""Driver of the variant cells: ``SimulationRunner.run`` as the CLI runs
it with ``--kick-mode intended --permeable``, in slices of whole
sprints, exactly as the runner driver (``runner.py``, whose set-up,
window and release it is); the walk's physics comes from the
configuration's keys.

The check is the runner driver's (the scene, the walkers' start, the
sampled chunks against their CSV rows), held to the reference of the
variants (``reference/variants.py``): the membranes' reflection and the
intended kick.
"""

from __future__ import annotations

import torch

from ..reference.variants import VariantReference
from . import common
from .runner import _rows, finish, release, reseed, setup, window  # noqa: F401


def check(st, scene, dtype=torch.float32):
    """(readings, notes), as ``runner.check``, against
    ``VariantReference``."""
    ctx = st.ctx
    kv = common.keys(ctx)
    items = st.tap.sampler.items()
    ref = VariantReference(kv, ctx.cell["generator"], scene, ctx.seed,
                           ctx.device)
    w = ref.ph.num_water
    w_pad = items[0]["out"][0].shape[1]
    n_win = ref.ph.chunk_steps // ref.ph.pfreq
    states = [common.start_state(ref, it, w_pad) for it in items]
    step0s = [it["step0"] for it in items]
    want = ref.chunks(states, step0s)
    readings = {"scene": common.scene_gap(st.scene, scene),
                "start_gap": common.start_gap(ref, items[0], w_pad)}
    if dtype != torch.float32:
        ctl = VariantReference(kv, ctx.cell["generator"], scene, ctx.seed,
                               ctx.device, dtype=dtype)
        got = [common.as_candidate(r, s0)
               for r, s0 in zip(ctl.chunks(states, step0s), step0s)]
        readings["start_gap"] = common.gap(
            ctl.init_planes(w_pad), ref.init_planes(w_pad), w)
    else:
        got = [common.program_candidate(it, w, _rows(st, it, n_win))
               for it in items]
    readings.update(common.compare(got, want, step0s, w, ref.large))
    notes = {"chunks_checked": len(items),
             "flip_checked": int(st.tap.sampler.flip_seen),
             "walks": st.walks + 1}
    return readings, notes

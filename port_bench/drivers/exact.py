"""Run of the exact-far-field cells: ``SimulationRunner.run`` at
far-table order 0 as the CLI runs it with ``--far-table-order 0``, in
slices of whole sprints, exactly as ``runner.py`` runs them (with
its set-up, window and release).  Each chunk's model is the
cube selection and the exact far sums of ``expansion.build``.

Its tap also wraps ``expansion.build`` and keeps a reference to each
``NearField`` it returns, as the tap of ``runner.py`` keeps
``build_planes``'s model; the model is put in the near entry's layout
only in the check, after the window.

The check is that of ``runner.py`` (the scene, the walkers' start, the
sampled chunks against their CSV rows), held to ``ExactReference``
(``reference/exact.py``): the selection, reach counts, near slots and
far sums of each sampled chunk, and its steps.
"""

from __future__ import annotations

import torch

from .. import tap as tap_mod
from ..reference.exact import ExactReference
from . import common, runner
from .runner import _rows, finish, release, window  # noqa: F401


class ExactTap(tap_mod.ChunkTap):
    """``ChunkTap`` that also takes the model from ``expansion.build``."""

    def install(self):
        super().install()
        self._orig["build"] = self._ex.build
        self._ex.build = self._wrap_model(self._orig["build"])

    def remove(self):
        if self._orig:
            self._ex.build = self._orig["build"]
        super().remove()


def _tap(seed, p):
    return ExactTap(seed, common.SAMPLE_CHUNKS, p.pfreq, p.tcp)


def setup(ctx):
    st = runner.setup(ctx)
    st.tap = _tap(ctx.seed, st.p)
    return st


def reseed(st, seed):
    runner.reseed(st, seed)
    st.tap = _tap(seed, st.p)


def near_layout(model):
    """A kept model in the near entry's layout (near [4, K, W] with
    M * FIELD_SCALE, taylor [10, W], n_reach [W]), as the sprint loop
    hands ``build``'s to the near entry; a ``build_planes`` model as it
    is."""
    if not hasattr(model, "near_pos"):
        return model
    from mri_nanoparticle_simulation_tpu_torch.fields.dipole import \
        FIELD_SCALE
    m = model.near_M * torch.tensor(FIELD_SCALE, dtype=model.near_M.dtype,
                                    device=model.near_M.device)
    p = model.near_pos
    near = torch.stack([p[..., 0].T, p[..., 1].T, p[..., 2].T, m.T])
    taylor = torch.cat([model.b0[None], model.grad.T, model.hess.T])
    return near, taylor, model.n_reach


def check(st, scene, dtype=torch.float32):
    """(readings, notes), as ``runner.check``, against
    ``ExactReference``."""
    ctx = st.ctx
    kv = common.keys(ctx)
    items = [dict(it, model=near_layout(it["model"]))
             for it in st.tap.sampler.items()]
    ref = ExactReference(kv, ctx.cell["generator"], scene, ctx.seed,
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
        ctl = ExactReference(kv, ctx.cell["generator"], scene, ctx.seed,
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

"""Driver of the plane cells: ``decompose.run_plane_on_device`` as the
CLI's ``--plane-device`` branch calls it.

Set-up builds the scene once, as one CLI process does, and makes one
whole call to warm every shape up.  The window makes one call per plane,
each a whole decomposition run of the configuration (every call the same
walk: same scene, seed and steps), until the window ends; each call ends
in its one copy of the curves to the host.

The check: the program's scene against the reference's; the walkers'
start; the sampled chunks of the decomposition kernel (the first, the
first holding the run's Carr-Purcell flip, two drawn from the seed)
worked out again from the call's previous chunk output at the call's own
step count, compared in state, counts and the per-walker (A, B) record;
and the sampled sprints of the plane fold (the first, the one holding
the run's first flip, two drawn from the seed) folded again from the
windows the sprint's chunks produced and the carry the call's previous
fold returned (zero for its first), compared with the curves the call
returned; the record the fold was handed is held to those windows.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import tap as tap_mod
from ..reference import Reference
from . import common


def setup(ctx):
    from mri_nanoparticle_simulation_tpu_torch.engine import decompose
    from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox
    cell, seed = ctx.cell, ctx.seed
    p = common.params(ctx)
    scene = BacteriaBox(p, seed=ctx.config["scene_seed"]).populate()
    st = SimpleNamespace(ctx=ctx, p=p, prog_scene=scene,
                         dev=torch.device(ctx.device),
                         rng_impl=common.RNG_IMPL[cell["generator"]],
                         dec=decompose, curves={},
                         scene={"waters": scene.waters, "mnps": scene.mnps})
    _call(st)
    common.sync(ctx.device)
    reseed(st, seed)
    return st


def reseed(st, seed):
    """The same set-up on another run seed."""
    p = st.p
    st.ctx.seed = seed
    st.curves = {}
    st.tap = tap_mod.ChunkTap(seed, common.SAMPLE_CHUNKS, p.pfreq, p.tcp,
                              keep_wins=True)
    st.plane_tap = tap_mod.PlaneTap(seed + 1, common.SAMPLE_SPRINTS,
                                    (p.tcp - 1) // p.sprint_steps, st.tap)


def _call(st):
    cell = st.ctx.cell
    _, curves, stats, _ = st.dec.run_plane_on_device(
        st.prog_scene, st.p, cell["moment_scales"], cell["echo_taucps"],
        seed=st.ctx.seed, device=st.dev, rng_impl=st.rng_impl)
    return curves, stats


def window(st, seconds, tracer):
    p = st.p
    done = {"steps": 0, "calls": 0}
    split = dict.fromkeys(("device_s", "copy_s", "host_s", "wall_s"), 0.0)

    def one_call():
        st.plane_tap.call = done["calls"]
        st.tap.new_walk(done["calls"])
        curves, stats = _call(st)
        st.curves[done["calls"]] = curves
        done["steps"] += stats["sprints"] * p.sprint_steps
        done["calls"] += 1
        for k in split:
            split[k] += stats[k]

    st.tap.install()
    st.plane_tap.install()
    try:
        t0 = time.perf_counter()
        traced = None
        if tracer.enabled:
            with tracer.window():
                for _ in range(st.ctx.cell["trace_calls"]):
                    one_call()
            traced = dict(done)
        while time.perf_counter() - t0 < seconds:
            one_call()
        wall = time.perf_counter() - t0
    finally:
        st.plane_tap.remove()
        st.tap.remove()
    # the calls' own split of their wall (decompose.run_plane_on_device)
    return dict(common.window_stats(p, done, wall, traced,
                                    calls=done["calls"]), split=split)


def release(st):
    st.prog_scene = None


def finish(st):
    pass


def check(st, scene, dtype=torch.float32):
    """(readings, notes), as the runner driver's, with the record and
    the plane fold in place of the CSV rows."""
    ctx, cell = st.ctx, st.ctx.cell
    kv = common.keys(ctx)
    items = st.tap.sampler.items()
    ref = Reference(kv, cell["generator"], scene, ctx.seed, ctx.device)
    ph = ref.ph
    w = ph.num_water
    w_pad = items[0]["out"][0].shape[1]
    states = [common.start_state(ref, it, w_pad) for it in items]
    step0s = [it["step0"] for it in items]
    want = ref.chunks(states, step0s, decompose=True)
    readings = {"scene": common.scene_gap(st.scene, scene),
                "start_gap": common.start_gap(ref, items[0], w_pad)}
    ctl = None
    if dtype != torch.float32:
        ctl = Reference(kv, cell["generator"], scene, ctx.seed, ctx.device,
                        dtype=dtype)
        got = [common.as_candidate(r, s0, decompose=True) for r, s0 in
               zip(ctl.chunks(states, step0s, decompose=True), step0s)]
        readings["start_gap"] = common.gap(
            ctl.init_planes(w_pad, True), ref.init_planes(w_pad, True), w)
    else:
        got = [common.program_candidate(it, w, None) for it in items]
    readings.update(common.compare(got, want, step0s, w, ref.large,
                                   decompose=True))

    u_prev, g = ref.plane_tables(cell["echo_taucps"], kv["tau"])
    wps = ph.sprint_steps // ph.pfreq
    curve = handed = 0.0
    folds = st.plane_tap.sampler.items()
    for it in folds:
        i = it["sprint"]
        rows = slice(i * wps, (i + 1) * wps)
        carry = it["carry"]
        if carry is None:
            t = len(cell["echo_taucps"])
            carry = (torch.zeros((t, w)),) * 4 + (torch.zeros(w),) * 2
        if it["made"] and sum(m.shape[0] for m in it["made"]) == wps:
            made = torch.cat(it["made"])
            handed = max(handed, common.gap(
                it["wins"].reshape(wps * 2, -1).cpu(),
                made.reshape(wps * 2, -1).cpu(), w))
        else:
            made, handed = it["wins"], float("inf")
        args = (made, carry, u_prev[rows], g[:, rows],
                cell["moment_scales"])
        _, blk = ref.fold(*args)
        if ctl is not None:
            _, cand = ctl.fold(*args)
            cand = cand.double().cpu().numpy()
        else:
            cand = st.curves[it["call"]][:, :, rows]
        curve = max(curve, float(np.abs(
            np.asarray(cand, np.float64)
            - blk.double().cpu().numpy()).max()))
    if ctl is None:
        readings["record_gap_rad"] = max(readings["record_gap_rad"], handed)
    readings["curve_gap"] = curve
    notes = {"chunks_checked": len(items),
             "flip_checked": int(st.tap.sampler.flip_seen),
             "sprints_folded": len(folds),
             "fold_flip_checked": int(st.plane_tap.sampler.flip_seen)}
    return readings, notes

"""Driver of the record cells: README configuration 5c on the CLI's
default record path, ``decompose.run_decomposition`` and then the CLI's
own record tail, ``decompose.record_products``.

Set-up builds the scene once, as one CLI process does, and makes one
whole call to warm every shape up.  The window makes one call after
another, each a whole decomposition run of the configuration (every
call the same walk: same scene, seed and steps): the run with its
record copied to the host sprint by sprint, then the float64
reconstruction of every (moment scale, echo spacing) point on the host,
a CSV a point and the ``--fit-r2`` dispersion table, written under
TMPDIR.  ``--dump-record``'s compressed archive is left out: an optional
copy of the record after the products, whose zlib time would be the
noisiest part of a call.

The check: the program's scene against the reference's; the walkers'
start; the sampled chunks of the decomposition kernel (the first, the
first holding the run's Carr-Purcell flip, two drawn from the seed)
worked out again from the call's previous chunk output at the call's own
step count, compared in state, counts and the per-walker (A, B) record,
and the record the host kept held to those chunks' windows; and each
call's curves held to the plain reconstruction (``reference/record.py``)
from that call's own record.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import tap as tap_mod
from ..reference import Reference
from ..reference import record as record_ref
from . import common


def setup(ctx):
    from mri_nanoparticle_simulation_tpu_torch.engine import decompose
    from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox
    p = common.params(ctx)
    scene = BacteriaBox(p, seed=ctx.config["scene_seed"]).populate()
    st = SimpleNamespace(ctx=ctx, p=p, prog_scene=scene,
                         dev=torch.device(ctx.device),
                         rng_impl=common.RNG_IMPL[ctx.cell["generator"]],
                         dec=decompose, records={}, curves={},
                         tmp=tempfile.mkdtemp(prefix="port_bench_"),
                         scene={"waters": scene.waters, "mnps": scene.mnps})
    _call(st)
    common.sync(ctx.device)
    reseed(st, ctx.seed)
    return st


def reseed(st, seed):
    """The same set-up on another run seed."""
    st.ctx.seed = seed
    st.records, st.curves = {}, {}
    st.tap = tap_mod.ChunkTap(seed, common.SAMPLE_CHUNKS, st.p.pfreq,
                              st.p.tcp)


def _call(st):
    cell = st.ctx.cell
    res = st.dec.run_decomposition(st.prog_scene, st.p, seed=st.ctx.seed,
                                   device=st.dev, rng_impl=st.rng_impl)
    curves = st.dec.record_products(
        res, st.p, cell["moment_scales"], cell["echo_taucps"],
        os.path.join(st.tmp, "plane.csv"),
        fit_r2=os.path.join(st.tmp, "dispersion.csv"))
    return res, curves


def window(st, seconds, tracer):
    p = st.p
    done = {"steps": 0, "calls": 0}
    split = dict.fromkeys(("device_s", "copy_s", "host_s", "wall_s"), 0.0)

    def one_call():
        st.tap.new_walk(done["calls"])
        res, curves = _call(st)
        st.records[done["calls"]] = (res.A, res.B)
        st.curves[done["calls"]] = curves
        done["steps"] += res.stats["sprints"] * p.sprint_steps
        done["calls"] += 1
        for k in split:
            split[k] += res.stats[k]

    st.tap.install()
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
        st.tap.remove()
    # the runs' own split of their wall (decompose.run_decomposition)
    return dict(common.window_stats(p, done, wall, traced,
                                    calls=done["calls"]), split=split)


def release(st):
    st.prog_scene = None


def finish(st):
    shutil.rmtree(st.tmp, ignore_errors=True)


def check(st, scene, dtype=torch.float32):
    """(readings, notes), as the plane driver's, with the host's record
    and its reconstruction in place of the plane fold."""
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
    rec_dtype = torch.float64
    if dtype != torch.float32:
        ctl = Reference(kv, cell["generator"], scene, ctx.seed, ctx.device,
                        dtype=dtype)
        got = [common.as_candidate(r, s0, decompose=True) for r, s0 in
               zip(ctl.chunks(states, step0s, decompose=True), step0s)]
        readings["start_gap"] = common.gap(
            ctl.init_planes(w_pad, True), ref.init_planes(w_pad, True), w)
        rec_dtype = dtype
    else:
        got = [common.program_candidate(it, w, None) for it in items]
    readings.update(common.compare(got, want, step0s, w, ref.large,
                                   decompose=True))

    # the record the host kept, against the sampled chunks' windows
    n_win = ph.chunk_steps // ph.pfreq
    kept = 0.0
    for it in items:
        a, b = st.records[it["walk"]]
        rows = slice(it["step0"] // ph.pfreq, it["step0"] // ph.pfreq + n_win)
        host = torch.as_tensor(np.stack([a[rows], b[rows]], 1))
        if host.shape[0] != n_win:
            kept = float("inf")
            continue
        kept = max(kept, common.gap(
            host.reshape(n_win * 2, w),
            it["out"][3].reshape(n_win * 2, -1).cpu(), w))
    if dtype == torch.float32:
        readings["record_gap_rad"] = max(readings["record_gap_rad"], kept)

    # each call's curves, against the plain reconstruction of its record
    curve = 0.0
    for call, (a, b) in st.records.items():
        want_c = record_ref.curves(
            a, b, cell["moment_scales"], cell["echo_taucps"], tau=kv["tau"],
            pfreq=ph.pfreq, tcp=ph.tcp, device=ctx.device)
        if dtype != torch.float32:
            cand = record_ref.curves(
                a, b, cell["moment_scales"], cell["echo_taucps"],
                tau=kv["tau"], pfreq=ph.pfreq, tcp=ph.tcp, dtype=rec_dtype,
                device=ctx.device)
        else:
            cand = np.asarray(st.curves[call], np.float64)
        if cand.shape != want_c.shape:
            curve = float("inf")
            continue
        curve = max(curve, float(np.nan_to_num(
            np.abs(cand - want_c), nan=np.inf).max()))
    readings["curve_gap"] = curve
    notes = {"chunks_checked": len(items),
             "flip_checked": int(st.tap.sampler.flip_seen),
             "calls_reconstructed": len(st.records)}
    return readings, notes

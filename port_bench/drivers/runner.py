"""Driver of the T2-curve cells: ``SimulationRunner.run`` as the CLI
runs it, in slices of whole sprints.

Set-up builds the runner (kernel library, scene, near-k and cube
certificates, scene cache), runs one sprint to warm every shape up, and
puts the walkers back at their start.  The window calls
``run(csv_path=..., max_steps=...)`` slice after slice (``slice_sprints``
sprints, long enough that the restart between two calls is a small
share: users run a whole curve in one call), each ending in the
runner's drain and device sync, continuing one walk and starting it
afresh after the configuration's last step; each walk streams its rows
to a CSV of its own under TMPDIR.

The check: the program's scene against the reference's; the walkers'
start against the reference's; then the sampled chunks (the first, the
first holding a Carr-Purcell flip, two drawn from the seed) worked out
again by the reference from the walk's previous chunk output (its own
start for a walk's first chunk) at the walk's own step count, so the
state carried between chunks, sprints and slices is held too; compared
are the state, escape and coverage counts, step counters, the large
path's model, and the chunk's windows as they reached the CSV rows.
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
from . import common


def setup(ctx):
    from mri_nanoparticle_simulation_tpu_torch.engine.sim import \
        SimulationRunner
    cell, seed = ctx.cell, ctx.seed
    p = common.params(ctx)
    rng_impl = common.RNG_IMPL[cell["generator"]]
    runner = SimulationRunner(p, scene_seed=ctx.config["scene_seed"],
                              seed=seed, device=ctx.device,
                              rng_impl=rng_impl)
    tmp = tempfile.mkdtemp(prefix="port_bench_")
    init = runner.state
    runner.run(csv_path=os.path.join(tmp, "warm.csv"),
               max_steps=p.sprint_steps, progress=False)
    runner.state = init
    common.sync(ctx.device)
    tap = tap_mod.ChunkTap(seed, common.SAMPLE_CHUNKS, p.pfreq, p.tcp)
    return SimpleNamespace(ctx=ctx, p=p, runner=runner, init=init, tmp=tmp,
                           tap=tap, walks=0,
                           scene={"waters": runner.scene.waters,
                                  "mnps": runner.scene.mnps})


def reseed(st, seed):
    """The same set-up on another run seed: the walk from its start."""
    from mri_nanoparticle_simulation_tpu_torch.engine.convert import \
        key_words
    finish(st)
    st.ctx.seed = st.runner.seed = seed
    st.runner.key = key_words(seed)
    st.runner.state = st.init
    st.walks = 0
    st.tmp = tempfile.mkdtemp(prefix="port_bench_")
    st.tap = tap_mod.ChunkTap(seed, common.SAMPLE_CHUNKS, st.p.pfreq,
                              st.p.tcp)


def _csv(st, walk):
    return os.path.join(st.tmp, f"t2_walk{walk}.csv")


def window(st, seconds, tracer):
    p, runner = st.p, st.runner
    slice_steps = st.ctx.cell["slice_sprints"] * p.sprint_steps
    done = {"steps": 0, "slices": 0}

    def one_slice():
        if runner.state.step >= p.t:
            st.walks += 1
            runner.state = st.init
            st.tap.new_walk(st.walks)
        s0 = runner.state.step
        runner.run(csv_path=_csv(st, st.walks),
                   max_steps=min(p.t, s0 + slice_steps), progress=False)
        done["steps"] += runner.state.step - s0
        done["slices"] += 1

    st.tap.install()
    try:
        t0 = time.perf_counter()
        traced = None
        if tracer.enabled:
            with tracer.window():
                for _ in range(common.TRACE_SLICES):
                    one_slice()
            traced = dict(done)
        while time.perf_counter() - t0 < seconds:
            one_slice()
        wall = time.perf_counter() - t0
    finally:
        st.tap.remove()
    return common.window_stats(p, done, wall, traced, calls=done["slices"])


def release(st):
    """Drop the program's objects; the tap's items stay."""
    st.runner = st.init = None


def finish(st):
    shutil.rmtree(st.tmp, ignore_errors=True)


def _rows(st, item, n_win):
    """The CSV rows (Σcos) of a chunk's windows, or None if missing."""
    first = item["step0"] // st.p.pfreq
    path = _csv(st, item["walk"])
    if not os.path.exists(path):
        return None
    data = np.loadtxt(path, delimiter=",", ndmin=2)
    if len(data) < first + n_win:
        return None
    return data[first:first + n_win, 1]


def check(st, scene, dtype=torch.float32):
    """(readings, notes): the numbers compared, of the program (or, with
    ``dtype`` below float32, of the control in its place) against the
    float32 reference, and what the check covered."""
    ctx = st.ctx
    items = st.tap.sampler.items()
    ref = Reference(ctx.config["keys"] | ctx.cell.get("keys", {}),
                    ctx.cell["generator"], scene, ctx.seed, ctx.device)
    w = ref.ph.num_water
    w_pad = items[0]["out"][0].shape[1]
    n_win = ref.ph.chunk_steps // ref.ph.pfreq
    states = [common.start_state(ref, it, w_pad) for it in items]
    step0s = [it["step0"] for it in items]
    want = ref.chunks(states, step0s)
    readings = {"scene": common.scene_gap(st.scene, scene),
                "start_gap": common.start_gap(ref, items[0], w_pad)}
    if dtype != torch.float32:
        ctl = Reference(ctx.config["keys"] | ctx.cell.get("keys", {}),
                        ctx.cell["generator"], scene, ctx.seed, ctx.device,
                        dtype=dtype)
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

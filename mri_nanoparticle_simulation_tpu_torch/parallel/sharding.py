"""Walker sharding: one population's walkers split over several devices.

Counterpart of the reference's ``parallel/sharding.py``.  Walkers are
independent, so a population splits into contiguous blocks, one a
shard: the scene is copied to every device, each shard runs its own
walkers through the single-device sprint, and the only data that
crosses shards are the per-window (Σcos φ, Σsin φ) pairs and the
escape and coverage counts, summed in a fixed shard order on the
mesh's first device.

Counter-based generators make the split exact: shard ``g`` passes
``lane_offset = g * local_w`` to its sprint, so every walker draws the
stream of its global index, the stream it draws in the unsharded run.
Positions, phases, residency, escapes, coverage and every per-walker
record are bitwise those of the unsharded run; the window sums differ
only by the grouping of the final sum.  Both generators are keyed this
way in the port (Threefry by (step, lane), the fast generator's
Philox by (step, lane, block)), so both are shard-invariant.

There is no ``shard_map`` here: a mesh is a plain ``WalkerMesh`` of
devices, and a sharded sprint launches each shard's sprint on its own
device, all of them queued before any result is read; the host never
reads the device inside a sprint.  Each shard pads its own walkers to
the kernels' width (``to_planes_sharded``), so a record is stripped of
padding shard by shard.  A mesh may name one device more than once:
the shards then run one after another on it (the CPU tests run eight
shards on torch's one CPU device this way); the CLI never builds such
a mesh.  Across processes (``distributed.py``) a mesh carries its
process group, and the sums cross processes once a sprint.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..engine import cuda_engine, reference_engine
from ..engine.convert import key_words, mnp_table
from ..engine.reference_engine import WalkerState, init_state
from ..params import Params
from ..utils.device import require_cuda

WALKER_AXIS = "walkers"


@dataclasses.dataclass(frozen=True)
class WalkerMesh:
    """The devices this process drives, one walker shard each, in global
    shard order, and the process group that joins the processes of a
    multi-process mesh (None, rank 0 and world size 1 in one process).
    Shard ``first_shard + i`` runs on ``devices[i]``."""
    devices: tuple
    group: object = None
    rank: int = 0
    world_size: int = 1

    @property
    def n_shards(self) -> int:
        """Shards over every process of the mesh."""
        return self.world_size * len(self.devices)

    @property
    def first_shard(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * len(self.devices)

    @property
    def axis_names(self) -> tuple:
        return (WALKER_AXIS,)

    @property
    def shape(self) -> dict:
        return {WALKER_AXIS: self.n_shards}


class ShardedState(NamedTuple):
    """The state of a sharded run: each shard's state in its sprint's
    form on its device (the kernels' ``SoAState`` or the scan engine's
    ``WalkerState``, counters zero), the completed steps, and the escape
    and coverage counts over every shard, on the mesh's first device."""
    shards: tuple
    step: int
    escapes: torch.Tensor
    coverage: torch.Tensor


def resolve_device(d) -> torch.device:
    """``d`` as a device with its index; raises for a card this machine
    lacks."""
    d = torch.device(d)
    if d.type != "cuda":
        return d
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = d.index
    if index is None and n:
        index = torch.cuda.current_device()
    if index is None or index >= n:
        raise ValueError(f"{d}: this machine has {n} CUDA device(s)")
    return torch.device("cuda", index)


def local_devices(device="cuda") -> list:
    """The devices ``device`` names on this machine: every card for
    ``"cuda"`` (raises without one), else ``[device]``."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        require_cuda()
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(d)]


def make_walker_mesh(devices: Optional[Sequence] = None) -> WalkerMesh:
    """A one-process walker mesh over ``devices`` (default: every local
    card).  A device may appear more than once: its shards then run one
    after another on it, which is how the same code is tested on a
    single device."""
    devs = tuple(resolve_device(d) for d in (local_devices("cuda")
                                      if devices is None else devices))
    if not devs:
        raise ValueError("a walker mesh needs at least one device")
    return WalkerMesh(devs)


def distinct(devices) -> list:
    """The devices of ``devices`` without repeats, in first-seen order."""
    return list(dict.fromkeys(devices))


def on_device(dev):
    """Make ``dev`` the current card for the launches in the block."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _to(x, dev):
    """``x`` (a tensor, or a NamedTuple of tensors) on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, non_blocking=True)
    return type(x)(*[_to(f, dev) if isinstance(f, torch.Tensor) else f
                     for f in x])


def replicate(x, devices) -> dict:
    """{device: ``x`` on it} over the distinct ``devices``: one copy per
    device, however many shards it runs; a dict passes through."""
    if isinstance(x, dict):
        return x
    return {d: _to(x, d) for d in distinct(devices)}


def even_split(num_water: int, mesh: WalkerMesh) -> int:
    """Walkers a shard; raises unless they divide evenly."""
    n = mesh.shape[WALKER_AXIS]
    if num_water % n != 0:
        raise ValueError(f"num_water ({num_water}) must divide evenly over "
                         f"{n} devices")
    return num_water // n


def reduce_over_processes(t: torch.Tensor, mesh: WalkerMesh) -> torch.Tensor:
    """``t`` summed over the mesh's processes (itself without a process
    group; a one-process group still runs the collective).  Under NCCL
    the sum stays on the card; under gloo it crosses through a host
    copy."""
    if mesh.group is None:
        return t
    if dist.get_backend(mesh.group) == "nccl":
        dist.all_reduce(t, group=mesh.group)
        return t
    h = t.cpu()
    dist.all_reduce(h, group=mesh.group)
    return h.to(t.device)


def gather_over_processes(t: torch.Tensor, mesh: WalkerMesh) -> torch.Tensor:
    """The processes' ``t`` (equal shapes) concatenated along axis 0 in
    rank order (``t`` itself without a process group), on ``t``'s
    device."""
    if mesh.group is None:
        return t
    nccl = dist.get_backend(mesh.group) == "nccl"
    src = t.contiguous() if nccl else t.cpu().contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world_size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def _zeros(devices) -> dict:
    return {d: torch.zeros((), dtype=torch.int64, device=d)
            for d in distinct(devices)}


def _combine(mesh: WalkerMesh, state: ShardedState, outs, zeros: dict,
             decompose: bool):
    """The sharded sprint's result from each shard's (state, windows):
    the shards' counters (their deltas: each started at zero) and window
    sums added in shard order on the first device, then over the
    processes; a decompose record stays with its shard."""
    dev0 = mesh.devices[0]
    counts = [torch.stack([o[0].escapes, o[0].coverage]) for o in outs]
    total = counts[0].to(dev0, non_blocking=True)
    for c in counts[1:]:
        total = total + c.to(dev0, non_blocking=True)
    total = reduce_over_processes(total, mesh)
    shards = tuple(o[0]._replace(escapes=zeros[d], coverage=zeros[d])
                   for o, d in zip(outs, mesh.devices))
    new = ShardedState(shards, outs[0][0].step, state.escapes + total[0],
                       state.coverage + total[1])
    if decompose:
        return new, tuple(o[1] for o in outs)
    wins = outs[0][1].to(dev0, non_blocking=True)
    for o in outs[1:]:
        wins = wins + o[1].to(dev0, non_blocking=True)
    return new, reduce_over_processes(wins, mesh)


def make_sharded_sprint_fn(params: Params, mesh: WalkerMesh,
                           dtype=torch.float32, decompose: bool = False):
    """The scan engine's sprint over ``mesh``: ``sprint(tbl, key, state,
    tcp=None, cell_r=None, d_scale=None, reflect=None) -> (state',
    wins)`` with ``tbl`` an ``MnpTable`` (or ``replicate``'s dict of
    them), ``state`` a ``ShardedState`` of ``shard_walkers`` and
    ``wins`` [n_windows, 2] the sums over every shard on the first
    device.  ``decompose``: the phase-decomposition sprint, whose
    ``wins`` is the tuple of each shard's record [n_windows, local_w,
    2], left on its device."""
    local_w = even_split(params.num_water, mesh)
    sprints = {d: reference_engine.make_sprint_fn(params, d, dtype=dtype,
                                                  decompose=decompose)
               for d in distinct(mesh.devices)}
    offsets = [(mesh.first_shard + i) * local_w
               for i in range(len(mesh.devices))]
    zeros = _zeros(mesh.devices)

    def sprint(tbl, key, state: ShardedState, **scalars):
        tables = replicate(tbl, mesh.devices)
        outs = []
        for dev, ws, off in zip(mesh.devices, state.shards, offsets):
            t = tables[dev]
            with on_device(dev):
                outs.append(sprints[dev](t.pos, t.m, key, ws, off,
                                         **scalars))
        return _combine(mesh, state, outs, zeros, decompose)

    return sprint


def make_sharded_decomp_sprint_fn(params: Params, mesh: WalkerMesh,
                                  dtype=torch.float32):
    """:func:`make_sharded_sprint_fn` in decompose mode: each shard's
    per-walker record [n_windows, local_w, 2] stays with its shard; only
    the counts cross the mesh."""
    return make_sharded_sprint_fn(params, mesh, dtype, decompose=True)


def decomp_state_spec() -> WalkerState:
    """The layout of a decompose-mode walker state over a mesh: the
    walker fields split on their first axis (phase and comp [W, 2]),
    the step and counters whole."""
    row = (WALKER_AXIS,)
    return WalkerState(pos=row, in_cell=row, phase=(WALKER_AXIS, None),
                       phase_comp=(WALKER_AXIS, None), step=(), escapes=(),
                       coverage=())


def _split(state: WalkerState, mesh: WalkerMesh, convert) -> ShardedState:
    """This process's shards of the global ``state``: shard ``g``'s
    walkers ``[g * local_w, (g + 1) * local_w)`` on its device, through
    ``convert``; the counters on the first device."""
    local_w = even_split(state.pos.shape[0], mesh)
    spec = decomp_state_spec()
    shards = []
    for i, dev in enumerate(mesh.devices):
        lo = (mesh.first_shard + i) * local_w
        fields = {f: getattr(state, f)[lo:lo + local_w].to(dev)
                  for f in WalkerState._fields if getattr(spec, f)}
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        shards.append(convert(WalkerState(**fields, step=int(state.step),
                                          escapes=zero, coverage=zero)))
    dev0 = mesh.devices[0]
    return ShardedState(tuple(shards), int(state.step),
                        state.escapes.to(dev0), state.coverage.to(dev0))


def shard_walkers(state: WalkerState, mesh: WalkerMesh) -> ShardedState:
    """The scan engine's sharded state of the global ``state``."""
    return _split(state, mesh, lambda ws: ws)


def to_planes_sharded(state: WalkerState, params: Params,
                      mesh: WalkerMesh) -> ShardedState:
    """The kernels' sharded state of the global ``state``: each shard's
    walkers padded on their own to the kernels' width (``to_soa``), a
    decompose state ([W, 2] phase) to the 8-row decompose planes."""
    return _split(state, mesh, lambda ws: cuda_engine.to_soa(ws, params))


def _gather(parts, ss: ShardedState, mesh: WalkerMesh) -> WalkerState:
    """The global WalkerState on the first device from each shard's
    walker-form ``parts``, over every process of the mesh."""
    dev0 = mesh.devices[0]
    cols = [torch.cat([getattr(w, f).to(dev0) for w in parts])
            for f in ("pos", "in_cell", "phase", "phase_comp")]
    if mesh.group is not None:
        # one gather of every field packed as float64 columns, exact for
        # f32 values and residency as 0 / 1: each process holds a
        # contiguous block of walkers
        flat = [c.reshape(c.shape[0], -1).to(torch.float64) for c in cols]
        widths = [f.shape[1] for f in flat]
        packed = gather_over_processes(torch.cat(flat, 1), mesh)
        pos, in_cell, phase, comp = torch.split(packed, widths, 1)
        cols = [pos.to(cols[0].dtype), in_cell[:, 0] > 0.5,
                phase.reshape(-1, *cols[2].shape[1:]).to(cols[2].dtype),
                comp.reshape(-1, *cols[3].shape[1:]).to(cols[3].dtype)]
    return WalkerState(pos=cols[0], in_cell=cols[1], phase=cols[2],
                       phase_comp=cols[3], step=ss.step,
                       escapes=ss.escapes, coverage=ss.coverage)


def gather_walkers(ss: ShardedState, mesh: WalkerMesh) -> WalkerState:
    """The inverse of :func:`shard_walkers`."""
    return _gather(ss.shards, ss, mesh)


def from_planes_sharded(ss: ShardedState, num_water: int,
                        mesh: WalkerMesh) -> WalkerState:
    """The inverse of :func:`to_planes_sharded`: each shard stripped of
    its own padding, then the shards in global order."""
    local_w = even_split(num_water, mesh)
    return _gather([cuda_engine.from_soa(s, local_w) for s in ss.shards],
                   ss, mesh)


def make_sharded_pallas_sprint_fn(params: Params, num_water: int,
                                  mesh: WalkerMesh, dtype=torch.float32,
                                  rng_impl: str = cuda_engine.RNG_THREEFRY,
                                  cache=None, decompose: bool = False):
    """The chunk kernels' sprint over ``mesh``: ``sprint(tbl, key,
    state, tcp=None, cell_r=None, d_scale=None, reflect=None) ->
    (state', wins)``, each shard the single-device sprint
    (``cuda_engine.make_sprint_fn``) at its ``local_w`` walkers with
    lane offset ``global shard index * local_w``; ``state`` from
    :func:`to_planes_sharded`, ``wins`` [n_windows, 2] summed over every
    shard on the first device.

    ``cache`` (``expansion.SceneCache``) is copied once to each distinct
    device and handed to its shards' sprints, so a large scene runs the
    candidate-model kernel per shard on its own walkers.  ``decompose``:
    ``wins`` is the tuple of each shard's record [n_windows, 2,
    W_pad(local_w)], left on its device."""
    local_w = even_split(num_water, mesh)
    sprints = {d: cuda_engine.make_sprint_fn(params, local_w, d, dtype,
                                             rng_impl, decompose=decompose)
               for d in distinct(mesh.devices)}
    caches = None if cache is None else replicate(cache, mesh.devices)
    offsets = [(mesh.first_shard + i) * local_w
               for i in range(len(mesh.devices))]
    zeros = _zeros(mesh.devices)

    def sprint(tbl, key, state: ShardedState, **scalars):
        tables = replicate(tbl, mesh.devices)
        outs = []
        for dev, ss, off in zip(mesh.devices, state.shards, offsets):
            with on_device(dev):
                outs.append(sprints[dev](
                    tables[dev], key, ss, off,
                    cache=None if caches is None else caches[dev],
                    **scalars))
        return _combine(mesh, state, outs, zeros, decompose)

    return sprint


def _run(sprint, scene, params: Params, mesh: WalkerMesh, seed: int,
         dtype, max_steps, state: ShardedState):
    """Every sprint of a sharded run -> (times_ms, sum_cos, sum_sin)."""
    tables = replicate(mnp_table(scene.mnps, dtype, mesh.devices[0]),
                       mesh.devices)
    key = key_words(seed)
    total = params.t if max_steps is None else min(params.t, max_steps)
    outs = []
    for _ in range(total // params.sprint_steps):
        state, wins = sprint(tables, key, state)
        outs.append(wins)
    wins = (torch.cat(outs).cpu().numpy() if outs
            else np.zeros((0, 2), np.float32))
    times = (np.arange(1, len(wins) + 1) * params.pfreq) * params.tau
    return times, wins[:, 0], wins[:, 1], state


def run_simulation_sharded(scene, params: Params,
                           mesh: Optional[WalkerMesh] = None, seed: int = 0,
                           dtype=torch.float32,
                           max_steps: Optional[int] = None):
    """A whole run of the scan engine over ``mesh`` (default: every
    local card), as ``reference_engine.run_simulation``: (times_ms,
    sum_cos, sum_sin, the gathered WalkerState)."""
    mesh = mesh or make_walker_mesh()
    sprint = make_sharded_sprint_fn(params, mesh, dtype)
    state = shard_walkers(init_state(scene.waters, params, mesh.devices[0],
                                     dtype), mesh)
    times, cos, sin, state = _run(sprint, scene, params, mesh, seed, dtype,
                                  max_steps, state)
    return times, cos, sin, gather_walkers(state, mesh)


def run_simulation_sharded_pallas(scene, params: Params,
                                  mesh: Optional[WalkerMesh] = None,
                                  seed: int = 0, dtype=torch.float32,
                                  rng_impl: str = cuda_engine.RNG_THREEFRY,
                                  max_steps: Optional[int] = None,
                                  cache=None):
    """A whole run of the chunk kernels over ``mesh`` (default: every
    local card), as ``cuda_engine.run_simulation``; pass a scene
    ``cache`` (``expansion.build_cache``) for a large scene.  Returns
    (times_ms, sum_cos, sum_sin, the gathered WalkerState)."""
    mesh = mesh or make_walker_mesh()
    num_water = scene.waters.shape[0]
    sprint = make_sharded_pallas_sprint_fn(params, num_water, mesh, dtype,
                                           rng_impl, cache=cache)
    state = to_planes_sharded(init_state(scene.waters, params,
                                         mesh.devices[0], dtype),
                              params, mesh)
    times, cos, sin, state = _run(sprint, scene, params, mesh, seed, dtype,
                                  max_steps, state)
    return times, cos, sin, from_planes_sharded(state, num_water, mesh)

"""Multi-trial ensembles and parameter sweeps.

Counterpart of the reference's ``parallel/ensemble.py``.  An ensemble
is T independent trials, each its own scene and Threefry key; a sweep
gives each trial its own value of a knob.  The trials of a device run
one after another through ONE sprint function
(``cuda_engine.make_sprint_fn``), as the reference's Pallas ensemble
scans them through one compiled chunk kernel
(``make_ensemble_pallas_sprint_fn``): each trial hands every sprint its
own dipole table, key and launch scalars (tcp, cell_r, d_scale,
reflect), with ``lane_offset`` 0, so a trial is bitwise its standalone
run.

A trial mesh (``TrialMesh``, the reference's ``trials`` axis) spreads
the trials over devices in contiguous blocks, right-sized as the
reference's ``_trial_mesh`` does; on one card the trials run one after
another as above.  With ``walker_shards`` > 1 each trial slot is a row
of devices and each trial's walkers shard over its row
(``sharding.make_sharded_pallas_sprint_fn``, global lanes), so a trial
stays bitwise its standalone run but for the grouping of its window
sums.

Scenes differ per trial (other cell throws and/or a swept moment), so
the per-trial dipole arrays are padded to the largest dipole count with
zero-moment dipoles 1e6 µm outside the box: never selected into a near
list, no field.  Trials of at most ``cuda_engine.REBUILD_MAX_MNPS``
padded dipoles run the rebuild entry; larger ones the near entry with
the far-sums kernel, their cube cache (without far table) built in every
sprint call, as in the reference.

``engine="scan"`` runs the trials through the torch-eager scan engine
(``reference_engine.make_sprint_fn``) the same way: one sprint function,
each trial its own padded dipoles, key and launch scalars.  The port's
default stays ``"pallas"`` (the reference's functions default to its
scan engine, its CLI passes ``"pallas"``): on Threefry the two engines
give the same trials to f32 rounding, and on the card the default is
the production engine.

"""

from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from ..engine import chunk_kernel, cuda_engine, reference_engine
from ..engine.convert import key_words, mnp_table
from ..engine.reference_engine import WalkerState, init_state
from ..fields import expansion
from ..params import FIELD_EXPANSION, Params
from ..scene import BacteriaBox
from ..utils.device import require_cuda
from . import sharding
from .sharding import WALKER_AXIS

TRIAL_AXIS = "trials"


def window_times(params: Params, n_windows: int) -> np.ndarray:
    """Window-end times in ms for n output windows (the CSV time column:
    row i covers steps (i*pfreq, (i+1)*pfreq], cuda_sim.cu:1022)."""
    return (np.arange(1, n_windows + 1) * params.pfreq) * params.tau


def build_trial_scenes(params: Params, n_trials: int, base_seed: int = 0,
                       mmoments: Optional[Sequence[float]] = None,
                       cell_rs: Optional[Sequence[float]] = None,
                       scene_seeds: Optional[Sequence[int]] = None):
    """Build T scenes -> stacked (mnp_pos [T,N,3], mnp_M [T,N],
    waters [T,W,3], scenes), float64.  ``mmoments`` (len T) sweeps the
    per-cell moment; ``cell_rs`` (len T) sweeps the cell radius (each
    trial's scene is built with its own radius).  ``scene_seeds`` (len T)
    overrides the default ``base_seed + i`` per-trial seeds: repeated
    seeds give trials the SAME scene (paired sweeps)."""
    trial_params = [params if cell_rs is None
                    else params.replace(cell_r=float(cell_rs[i]))
                    for i in range(n_trials)]
    seeds = ([base_seed + i for i in range(n_trials)]
             if scene_seeds is None else list(scene_seeds))
    # paired sweeps repeat (seed, geometry) across values: build each
    # distinct scene once and share the object (scenes are read-only)
    built = {}
    scenes = []
    for i in range(n_trials):
        key = (seeds[i], trial_params[i].cell_r)
        if key not in built:
            built[key] = BacteriaBox(trial_params[i],
                                     seed=seeds[i]).populate()
        scenes.append(built[key])
    n_max = max(s.mnps.shape[0] for s in scenes)
    pos = np.full((n_trials, n_max, 3), 1e6)
    mom = np.zeros((n_trials, n_max))
    waters = np.zeros((n_trials, params.num_water, 3))
    for i, s in enumerate(scenes):
        n = s.mnps.shape[0]
        pos[i, :n] = s.mnps[:, :3]
        mom[i, :n] = s.mnps[:, 4]
        if mmoments is not None:
            mom[i, :n] *= mmoments[i] / params.mmoment
        waters[i] = s.waters
    return pos, mom, waters, scenes


def trial_table(pos: np.ndarray, mom: np.ndarray, dtype,
                device) -> cuda_engine.MnpTable:
    """The dipole table of one trial from its padded rows of
    ``build_trial_scenes`` (pos [N, 3], mom [N]), packed as a scene's
    (``convert.mnp_table``), as the reference's sprint packs the trial's
    arrays.  ``n_mnp`` is the padded count N, which the sprint's checks
    and path choice see."""
    rows = np.column_stack([pos, np.zeros(len(pos)), mom])  # x y z r M
    return mnp_table(rows, dtype, device)


@dataclasses.dataclass(frozen=True)
class TrialMesh:
    """Devices laid out as trial slots: ``devices[s]`` is slot ``s``'s
    row of devices, one device each on a ``(trials,)`` mesh, the walker
    shards of each trial on a ``(trials, walkers)`` mesh.  Trials fill
    the slots in contiguous blocks, and a slot runs its block one trial
    after another."""
    devices: tuple
    axis_names: tuple = (TRIAL_AXIS,)

    @property
    def shape(self) -> dict:
        s = {TRIAL_AXIS: len(self.devices)}
        if WALKER_AXIS in self.axis_names:
            s[WALKER_AXIS] = len(self.devices[0])
        return s


def make_trial_mesh(devices, walker_shards: int = 0) -> TrialMesh:
    """A ``(trials,)`` mesh of one slot a device, or with
    ``walker_shards`` a ``(trials, walkers)`` mesh of rows of that many
    devices.  A device may appear more than once (its slots or shards
    then run one after another on it)."""
    devs = [sharding.resolve_device(d) for d in devices]
    if not walker_shards:
        return TrialMesh(tuple((d,) for d in devs))
    if not devs or len(devs) % walker_shards:
        raise ValueError(f"{len(devs)} devices do not make rows of "
                         f"{walker_shards} walker shards")
    return TrialMesh(tuple(tuple(devs[i:i + walker_shards])
                           for i in range(0, len(devs), walker_shards)),
                     (TRIAL_AXIS, WALKER_AXIS))


def right_sized(n_trials: int, n_slots: int):
    """(slots used, rounds) of ``n_trials`` over at most ``n_slots``:
    rounds = ceil(n_trials / n_slots) is the fastest any schedule
    finishes, and the fewest slots that keep it waste the fewest
    padding trials."""
    rounds = -(-n_trials // n_slots)
    return -(-n_trials // rounds), rounds


def _trial_mesh(n_trials: int, mesh: Optional[TrialMesh], devices):
    """Pick a trial mesh over ``devices``; returns (mesh,
    padded_n_trials), as the reference's ``_trial_mesh``.

    The mesh chosen here is right-sized: rounds r = ceil(n_trials /
    n_devices) is the fastest any schedule can finish, and the smallest
    device count d with r*d >= n_trials keeps that wall-clock while
    running at most r-1 padding trials.  A caller's mesh is honored as
    it is (trials then pad up to a multiple of its trial slots, with a
    warning)."""
    if mesh is not None:
        n_dev = mesh.shape[TRIAL_AXIS]
        pad = (-n_trials) % n_dev
        if pad:
            warnings.warn(
                f"n_trials={n_trials} does not divide over the given "
                f"{n_dev}-device mesh; running {pad} extra padding "
                f"trial(s) (their results are discarded). Use a multiple "
                f"of the mesh size, or drop the mesh argument to get a "
                f"right-sized one.", stacklevel=3)
        return mesh, n_trials + pad
    d, rounds = right_sized(n_trials, len(devices))
    mesh = make_trial_mesh(devices[:d])
    pad = rounds * d - n_trials
    if pad:
        warnings.warn(
            f"n_trials={n_trials} pads to {rounds * d} on a right-sized "
            f"{d}-device mesh ({pad} discarded padding trial(s) — the "
            f"minimum at this wall-clock).", stacklevel=3)
    return mesh, rounds * d


def _trial_mesh_2d(n_trials: int, walker_shards: int,
                   mesh: Optional[TrialMesh], devices):
    """A (trials x walkers) mesh; the right-sizing of
    :func:`_trial_mesh` on the trial axis, with len(devices) //
    walker_shards slots (the reference's ``_trial_mesh_2d``)."""
    if mesh is not None:
        if set(mesh.axis_names) != {TRIAL_AXIS, WALKER_AXIS}:
            raise ValueError(
                f"a walker-sharded ensemble mesh needs axes "
                f"({TRIAL_AXIS!r}, {WALKER_AXIS!r}); got "
                f"{mesh.axis_names}")
        if mesh.shape[WALKER_AXIS] != walker_shards:
            # the lane offsets follow the mesh's walker axis: a mismatch
            # would give walkers other streams
            raise ValueError(
                f"mesh walker axis ({mesh.shape[WALKER_AXIS]}) "
                f"must equal walker_shards ({walker_shards})")
        n_dev = mesh.shape[TRIAL_AXIS]
        pad = (-n_trials) % n_dev
        if pad:
            warnings.warn(
                f"n_trials={n_trials} does not divide over the given "
                f"{n_dev}-trial-slot mesh; running {pad} extra padding "
                f"trial(s).", stacklevel=3)
        return mesh, n_trials + pad
    if len(devices) % walker_shards != 0 or walker_shards > len(devices):
        raise ValueError(
            f"walker_shards ({walker_shards}) must divide the device "
            f"count ({len(devices)})")
    d, rounds = right_sized(n_trials, len(devices) // walker_shards)
    mesh = make_trial_mesh(devices[:d * walker_shards], walker_shards)
    pad = rounds * d - n_trials
    if pad:
        warnings.warn(
            f"n_trials={n_trials} pads to {rounds * d} on a right-sized "
            f"{d}x{walker_shards} mesh ({pad} discarded padding "
            f"trial(s)).", stacklevel=3)
    return mesh, rounds * d


def _slot_sprint(params: Params, row: tuple, engine: str, dtype,
                 rng_impl: str, walker_shards: int):
    """One trial slot's sprint, ``sprint(tbl, key, state, **scalars)``,
    with its state's conversions ``(to_device, to_walker)``: the
    single-device sprint with lane offset 0, or over the row's walker
    shards."""
    if walker_shards > 1:
        wm = sharding.WalkerMesh(row)
        if engine == "pallas":
            return (sharding.make_sharded_pallas_sprint_fn(
                        params, params.num_water, wm, dtype, rng_impl),
                    lambda st: sharding.to_planes_sharded(st, params, wm),
                    lambda ss: sharding.from_planes_sharded(
                        ss, params.num_water, wm))
        return (sharding.make_sharded_sprint_fn(params, wm, dtype),
                lambda st: sharding.shard_walkers(st, wm),
                lambda ss: sharding.gather_walkers(ss, wm))
    if engine == "pallas":
        base = cuda_engine.make_sprint_fn(params, params.num_water, row[0],
                                          dtype, rng_impl)

        def sprint(tbl, key, state, **scalars):
            return base(tbl, key, state, 0, **scalars)

        return (sprint, lambda st: cuda_engine.to_soa(st, params),
                lambda ss: cuda_engine.from_soa(ss, params.num_water))
    scan = reference_engine.make_sprint_fn(params, row[0], dtype=dtype)

    def sprint(tbl, key, state, **scalars):
        return scan(tbl.pos, tbl.m, key, state, 0, **scalars)

    return sprint, (lambda st: st), (lambda ss: ss)


def run_ensemble(params: Params, n_trials: int, mesh=None,
                 base_seed: int = 0, run_seed: int = 1000,
                 mmoments: Optional[Sequence[float]] = None,
                 taucps: Optional[Sequence[float]] = None,
                 cell_rs: Optional[Sequence[float]] = None,
                 run_cell_rs: Optional[Sequence[float]] = None,
                 d_scales: Optional[Sequence[float]] = None,
                 permeabilities: Optional[Sequence[float]] = None,
                 scene_seeds: Optional[Sequence[int]] = None,
                 run_seeds: Optional[Sequence[int]] = None,
                 walker_shards: int = 1, dtype=torch.float32,
                 max_steps: Optional[int] = None, engine: str = "pallas",
                 rng_impl: str = cuda_engine.RNG_THREEFRY,
                 check_coverage: bool = True, *, device):
    """Run T independent trials; returns (times_ms, sum_cos [T, n],
    sum_sin [T, n], state).  Average over axis 0 for the ensemble curve.
    ``state`` is a ``WalkerState`` with the trial axis leading (pos [T,
    W, 3], escapes and coverage [T]; ``step`` the steps every trial
    ran), on the mesh's first device.

    ``mesh``: a ``TrialMesh``; by default one right-sized over the
    devices ``device`` names (``sharding.local_devices``: every card for
    "cuda", one device otherwise), so on one device the trials run one
    after another.  ``walker_shards`` > 1 shards each trial's walkers
    over a row of that many devices of a (trials, walkers) mesh
    (global lanes: every walker as in the standalone run).  Trials that
    do not fill the mesh pad with discarded trials, with the
    reference's warnings.

    ``mmoments`` / ``taucps`` (ms) / ``cell_rs`` (µm) / ``d_scales``
    (scales D_cell and D_extra together) / ``permeabilities`` (µm/ms,
    mapped to (reflect_io, reflect_oi) by :meth:`Params.reflect_pair`;
    needs reflection on in the static params, e.g.
    ``params.with_permeability()``), each len T, give per-trial values
    of the knob as launch data: every trial runs the same kernels.  Every
    taucp must keep tcp a multiple of pfreq.  d_scales > 1 walk farther
    per chunk, so the near-list coverage is validated at the scaled
    diffusion coefficients.

    ``run_cell_rs`` (µm, len T) also rides the cell_r launch scalar but
    keeps every scene's geometry at ``params.cell_r``; ``cell_rs``
    rebuilds each trial's scene at its radius.  The two are mutually
    exclusive.

    ``scene_seeds`` / ``run_seeds`` (each len T) override the default
    ``base_seed + i`` / ``run_seed + i`` per-trial seeds; repeating one
    gives trials the same scene and the same stream (paired sweeps).

    ``engine`` is ``"pallas"``, the chunk kernels (the port's default:
    the reference's function defaults to its scan engine, and on
    Threefry the two give the same trials to f32 rounding), or
    ``"scan"``, the scan engine (Threefry whatever ``rng_impl`` says, as
    the reference's).  ``check_coverage`` validates near_k against every
    distinct (scene, effective params) once."""
    params.validate()
    for name, vals in (("scene_seeds", scene_seeds),
                       ("run_seeds", run_seeds)):
        if vals is not None and len(vals) != n_trials:
            raise ValueError(f"{name} must have one value per trial "
                             f"([{n_trials}]), got {len(vals)}")
    if taucps is not None:
        for v in taucps:
            params.replace(taucp=float(v)).validate()
    if cell_rs is not None and run_cell_rs is not None:
        raise ValueError("cell_rs rebuilds each scene at its radius; "
                         "run_cell_rs varies only the runtime residency "
                         "radius on fixed geometry — pass one, not both")
    if cell_rs is not None:
        for v in cell_rs:
            params.replace(cell_r=float(v)).validate()
    if run_cell_rs is not None:
        if len(run_cell_rs) != n_trials:
            raise ValueError(f"run_cell_rs must have one value per trial "
                             f"([{n_trials}]), got {len(run_cell_rs)}")
        for v in run_cell_rs:
            params.replace(cell_r=float(v)).validate()
    if d_scales is not None:
        for v in d_scales:
            if not float(v) > 0:
                raise ValueError(f"d_scales must be > 0; got {v}")
            params.scale_D(float(v)).validate()
    if permeabilities is not None:
        if not (params.reflect_io > 0 or params.reflect_oi > 0):
            raise ValueError(
                "permeability sweeps ride the engines' reflect launch "
                "scalars, which need reflection enabled in the static "
                "params — build them with params.with_permeability() "
                "(any value; per-trial probabilities override it)")
        for v in permeabilities:
            params.reflect_pair(float(v))
    if params.field_mode != FIELD_EXPANSION:
        raise ValueError(
            f"ensembles run the expansion field backend; field_mode="
            f"{params.field_mode!r} is only wired into single-scene "
            f"SimulationRunner/scan runs")
    if engine not in reference_engine.ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if mesh is not None and not isinstance(mesh, TrialMesh):
        raise ValueError(f"mesh must be a TrialMesh (make_trial_mesh); "
                         f"got {type(mesh).__name__}")
    devices = sharding.local_devices(device)
    if walker_shards > 1:
        mesh, n_padded = _trial_mesh_2d(n_trials, walker_shards, mesh,
                                        devices)
        if params.num_water % walker_shards != 0:
            raise ValueError(
                f"num_water ({params.num_water}) must divide evenly over "
                f"{walker_shards} walker shards")
    else:
        mesh, n_padded = _trial_mesh(n_trials, mesh, devices)
    slots = mesh.devices
    if any(d.type == "cuda" for row in slots for d in row):
        require_cuda()
        if engine == "pallas":
            chunk_kernel.load_library()   # the build is set-up, not run

    def pad_vals(vals):
        if vals is not None and n_padded > n_trials:
            return list(vals) + [vals[-1]] * (n_padded - n_trials)
        return vals

    mmoments, taucps, cell_rs = (pad_vals(mmoments), pad_vals(taucps),
                                 pad_vals(cell_rs))
    run_cell_rs, d_scales = pad_vals(run_cell_rs), pad_vals(d_scales)
    permeabilities = pad_vals(permeabilities)
    scene_seeds, run_seeds = pad_vals(scene_seeds), pad_vals(run_seeds)
    mnp_pos, mnp_M, waters, scenes = build_trial_scenes(
        params, n_padded, base_seed, mmoments, cell_rs,
        scene_seeds=scene_seeds)
    if check_coverage:
        validated = {}    # (scene, effective params) -> worst count;
        # paired sweeps repeat both, so each distinct case runs once
        for i, s in enumerate(scenes[:n_trials]):
            p_i = params if cell_rs is None \
                else params.replace(cell_r=float(cell_rs[i]))
            if run_cell_rs is not None:
                # fixed geometry, runtime residency radius: the reach
                # (cell_r + travel) follows the run radius
                p_i = p_i.replace(cell_r=float(run_cell_rs[i]))
            if d_scales is not None and float(d_scales[i]) > 1:
                # the chunk-travel bound scales with sqrt(D): validate
                # the near-list coverage at the trial's actual reach
                p_i = p_i.scale_D(float(d_scales[i]))
            vkey = (id(s), p_i)
            if vkey not in validated:
                validated[vkey] = expansion.validate_near_k(
                    s.mnps[:, :3], p_i, n_probe=20_000)
            worst = validated[vkey]
            if worst > params.near_k:
                seed_i = (base_seed + i if scene_seeds is None
                          else scene_seeds[i])
                raise ValueError(
                    f"trial {i} (scene seed {seed_i}) requires "
                    f"near_k >= {worst} (configured {params.near_k}); "
                    f"raise near_k or lower chunk_steps")

    # one sprint function a distinct slot row; trial i runs in slot
    # i // rounds (contiguous blocks, as the reference shards them)
    per_row = {row: _slot_sprint(params, row, engine, dtype, rng_impl,
                                 walker_shards)
               for row in dict.fromkeys(slots)}
    rounds = n_padded // len(slots)
    run_crs = run_cell_rs if run_cell_rs is not None else cell_rs
    trials, states = [], []
    for i in range(n_padded):
        row = slots[i // rounds]
        sprint, to_device, to_walker = per_row[row]
        tbl = trial_table(mnp_pos[i], mnp_M[i], dtype, row[0])
        trials.append(dict(
            sprint=sprint, to_walker=to_walker,
            tbl=tbl if walker_shards == 1
            else sharding.replicate(tbl, row),
            key=key_words(run_seed + i if run_seeds is None
                          else int(run_seeds[i])),
            scalars=dict(
                tcp=(params.tcp if taucps is None
                     else int(round(taucps[i] / params.tau))),
                cell_r=(params.cell_r if run_crs is None
                        else float(run_crs[i])),
                d_scale=1.0 if d_scales is None else float(d_scales[i]),
                reflect=(None if permeabilities is None
                         else params.reflect_pair(
                             float(permeabilities[i]))))))
        states.append(to_device(init_state(waters[i], params, row[0],
                                           dtype)))

    total = params.t if max_steps is None else min(params.t, max_steps)
    outs = [[] for _ in range(n_padded)]
    # each round queues one trial on every slot before the next round
    order = [s * rounds + r for r in range(rounds)
             for s in range(len(slots))]
    for _ in range(total // params.sprint_steps):
        # sprint-major, a slot's trials one after another, as the
        # reference scans them inside each sprint
        for i in order:
            tr = trials[i]
            states[i], wins = tr["sprint"](tr["tbl"], tr["key"], states[i],
                                           **tr["scalars"])
            outs[i].append(wins)
    dev0 = slots[0][0]
    if outs[0]:
        wins = torch.stack([torch.cat(o).to(dev0)
                            for o in outs[:n_trials]]).cpu().numpy()
    else:
        wins = np.zeros((n_trials, 0, 2), np.float32)
    walkers = [trials[i]["to_walker"](states[i]) for i in range(n_trials)]

    def stack(f):
        return torch.stack([getattr(w, f).to(dev0) for w in walkers])

    state = WalkerState(
        pos=stack("pos"), in_cell=stack("in_cell"), phase=stack("phase"),
        phase_comp=stack("phase_comp"), step=states[0].step,
        escapes=stack("escapes"), coverage=stack("coverage"))
    times = window_times(params, wins.shape[1])
    return times, wins[..., 0], wins[..., 1], state


#: Params knobs the kernels take as launch scalars (one set of kernels
#: across values); every other knob builds its sprint function per value
SCALAR_AXES = ("mmoment", "taucp", "cell_r", "D", "P")

#: sweep-axis name -> run_ensemble per-trial kwarg (shared by
#: grid_per_trial and run_parameter_sweep so they cannot diverge)
_AXIS_KWARG = {"mmoment": "mmoments", "taucp": "taucps",
               "cell_r": "cell_rs", "D": "d_scales",
               "P": "permeabilities"}


def sweep_params_for(base_params: Params, name: str, value):
    """The ONE mapping from a sweep-axis name + value to concrete
    Params, used by run_parameter_sweep and the CLI's per-point output
    metadata.  Special axes: ``D`` scales both diffusion coefficients;
    ``P`` sets the membrane permeability; ``Gz`` sets the z background
    gradient (a tuple field the generic replace cannot reach)."""
    if name == "D":
        return base_params.scale_D(float(value))
    if name == "P":
        return base_params.with_permeability(float(value))
    if name == "Gz":
        bg = base_params.b0_gradient
        return base_params.replace(b0_gradient=(bg[0], bg[1],
                                                float(value)))
    return base_params.replace(**{name: value})


def grid_per_trial(axes: dict, n_trials_each: int, paired: bool,
                   base_seed: int, run_seed: int):
    """Grid expansion: validates that every axis is a launch scalar,
    expands the cross product (row-major), and returns (value_lists,
    combos, per_trial_kwargs) where per_trial_kwargs holds the per-trial
    axis vectors for :func:`run_ensemble` (+ the paired seed overrides
    when asked)."""
    names = list(axes.keys())
    bad = [n for n in names if n not in SCALAR_AXES]
    if bad:
        raise ValueError(
            f"parameter grids sweep launch-scalar knobs only "
            f"({SCALAR_AXES}); {bad} would need a recompile per value "
            f"— loop run_parameter_sweep for those")
    if not names:
        raise ValueError("axes must name at least one knob")
    value_lists = [list(axes[n]) for n in names]
    combos = list(itertools.product(*value_lists))   # row-major
    per_trial = {}
    for ai, n in enumerate(names):
        per_trial[_AXIS_KWARG[n]] = [c[ai] for c in combos
                                     for _ in range(n_trials_each)]
    if paired:
        per_trial["scene_seeds"] = [base_seed + k for _ in combos
                                    for k in range(n_trials_each)]
        per_trial["run_seeds"] = [run_seed + k for _ in combos
                                  for k in range(n_trials_each)]
    return value_lists, combos, per_trial


def run_parameter_grid(base_params: Params, axes: dict,
                       n_trials_each: int = 1, base_seed: int = 0,
                       run_seed: int = 1000, dtype=torch.float32,
                       max_steps=None, engine: str = "pallas",
                       rng_impl: str = cuda_engine.RNG_THREEFRY,
                       paired: bool = False, walker_shards: int = 1,
                       mesh=None, quadrature: bool = False, *, device):
    """Cross-product sweep over several launch-scalar knobs as the
    trials of one ensemble: ``axes`` maps knob names (a subset of
    :data:`SCALAR_AXES`) to value lists, e.g. ``{"D": [.25, .5, 1],
    "taucp": [1, 2, 5.5]}`` for the surface R2(D, taucp).

    ``paired=True`` gives trial k of every grid point the same scene
    and stream (common random numbers across the whole surface).

    ``walker_shards`` and ``mesh`` lay the trials out as
    :func:`run_ensemble`'s do.

    Returns ``(times_ms, curves)`` with curves shaped
    ``[n1, n2, ..., n_trials_each, n_windows]``, one leading axis per
    key of ``axes`` in iteration order; ``quadrature=True`` appends a
    trailing (sum cos, sum sin) component axis."""
    value_lists, combos, per_trial = grid_per_trial(
        axes, n_trials_each, paired, base_seed, run_seed)
    if "P" in axes and not (base_params.reflect_io > 0
                            or base_params.reflect_oi > 0):
        # the reflect launch scalars need reflection compiled in; the
        # static values are immaterial (every trial overrides them)
        base_params = base_params.with_permeability()
    times, cos, sin, _ = run_ensemble(
        base_params, n_trials=len(combos) * n_trials_each,
        base_seed=base_seed, run_seed=run_seed, **per_trial,
        dtype=dtype, max_steps=max_steps, engine=engine,
        rng_impl=rng_impl, walker_shards=walker_shards, mesh=mesh,
        device=device)
    flat = np.stack([cos, sin], -1) if quadrature else cos
    shape = [len(v) for v in value_lists] + [n_trials_each, -1] + \
        ([2] if quadrature else [])
    return times, flat.reshape(shape)


def run_parameter_sweep(base_params: Params, name: str, values,
                        n_trials_each: int = 1, base_seed: int = 0,
                        run_seed: int = 1000, dtype=torch.float32,
                        max_steps=None, engine: str = "pallas",
                        rng_impl: str = cuda_engine.RNG_THREEFRY,
                        paired: bool = False, walker_shards: int = 1,
                        mesh=None, quadrature: bool = False, *, device):
    """Sweep any Params field (e.g. cell_r, taucp, mmoment) across runs.

    ``mmoment``, ``taucp``, ``cell_r``, ``D`` and ``P`` sweeps are one
    :func:`run_ensemble`: the moment is table data, and tcp / cell_r /
    d_scale / reflect are the kernels' launch scalars.  ``D`` scales
    D_cell and D_extra by v; ``P`` is the membrane permeability (µm/ms)
    mapped by :meth:`Params.reflect_pair`, reflection turned on when the
    base params have it off.  Every other knob (``Gz``, the z background
    gradient, among them) is a static argument of the kernels, so each
    value builds its own sprint function and scenes; ``cell_r`` rebuilds
    scenes too, per trial.

    ``paired=True`` gives trial k of every value the same scene seed
    (``base_seed + k``) and the same stream (``run_seed + k``): common
    random numbers along the sweep axis, so the Monte-Carlo noise
    cancels in contrasts.  Otherwise the values of a non-scalar knob use
    run seeds ``run_seed + i * 10000``.

    ``walker_shards`` and ``mesh`` lay the trials out as
    :func:`run_ensemble`'s do.

    Returns (times_ms, curves [len(values), n_trials_each, n_windows]);
    ``quadrature=True`` appends a trailing (cos, sin) component axis."""
    if name in SCALAR_AXES:
        if name == "P" and not (base_params.reflect_io > 0
                                or base_params.reflect_oi > 0):
            # reflection on; per-trial scalars override the values
            base_params = base_params.with_permeability()
        key = _AXIS_KWARG[name]
        per_trial = {key: [v for v in values for _ in range(n_trials_each)]}
        if paired:
            per_trial["scene_seeds"] = [base_seed + k for _ in values
                                        for k in range(n_trials_each)]
            per_trial["run_seeds"] = [run_seed + k for _ in values
                                      for k in range(n_trials_each)]
        times, cos, sin, _ = run_ensemble(
            base_params, n_trials=len(values) * n_trials_each,
            base_seed=base_seed, run_seed=run_seed, **per_trial,
            dtype=dtype, max_steps=max_steps, engine=engine,
            rng_impl=rng_impl, walker_shards=walker_shards, mesh=mesh,
            device=device)
        flat = np.stack([cos, sin], -1) if quadrature else cos
        shape = (len(values), n_trials_each, -1) + \
            ((2,) if quadrature else ())
        return times, flat.reshape(shape)

    curves = []
    times = None
    for i, v in enumerate(values):
        p = sweep_params_for(base_params, name, v).validate()
        times, cos, sin, _ = run_ensemble(
            p, n_trials=n_trials_each, base_seed=base_seed,
            run_seed=run_seed if paired else run_seed + i * 10000,
            dtype=dtype, max_steps=max_steps, engine=engine,
            rng_impl=rng_impl, walker_shards=walker_shards, mesh=mesh,
            device=device)
        curves.append(np.stack([cos, sin], -1) if quadrature else cos)
    return times, np.stack(curves)

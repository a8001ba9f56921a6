"""Checkpoint / resume for walker state.

Counterpart of the reference's ``io/checkpoint.py``, in the same file
format: one ``.npz`` with the same keys, ``FORMAT_VERSION`` 2, a params
fingerprint and the identity tags, so either package reads what the
other wrote.  The generators are counter-based, so the complete
resumable state is (positions, in_cell, phase, phase compensation, step,
escapes, coverage) plus the seeds: the step counter IS the generator's
state.

Identity tags.  ``engine`` and ``rng_impl`` name the random sequence a
checkpoint continues; the loader refuses a mismatch when both sides
recorded one.  The port writes:

* ``engine="pallas"`` (``ENGINE_TAG``): its chunk kernels draw the
  reference Pallas engine's Threefry words in its step order, so a
  Threefry checkpoint crosses between the packages both ways, and a scan
  engine's (``"scan"``) is refused;
* ``rng_impl="threefry"`` for Threefry and ``"philox4x32"`` for its fast
  generator (``rng_tag``).  The CLI calls the fast generator
  ``hardware``, as the reference does its TPU hardware PRNG, but it is
  another sequence: under one tag a checkpoint of either would resume
  silently in the other's stream.  So each package refuses the other's
  fast-generator checkpoint.

Decompose states.  A phase-decomposition state holds phase and
phase_comp ``[W, 2]``.  The port keeps phase = (A, B) and phase_comp =
(comp_A, comp_B); a Pallas checkpoint stores the reference kernel's
state rows 4-7 (A, comp_A, B, comp_B) as phase = (A, comp_A) and
phase_comp = (B, comp_B) (the reference's pallas_engine.py:881-885,
940-941).  Save and load under ``engine="pallas"`` convert; a ``"scan"``
checkpoint read with the check skipped keeps its (A, B) layout.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Tuple

import numpy as np
import torch

from ..engine.reference_engine import WalkerState
from ..params import Params, params_fingerprint

FORMAT_VERSION = 2

#: the ``engine`` tag of every checkpoint and record store the port writes
ENGINE_TAG = "pallas"
#: the port's generators -> their ``rng_impl`` tags
RNG_TAGS = {"threefry": "threefry", "hardware": "philox4x32"}

__all__ = ["ENGINE_TAG", "FORMAT_VERSION", "RNG_TAGS", "load_checkpoint",
           "load_extra", "params_fingerprint", "rng_tag", "save_checkpoint",
           "scene_fingerprint"]


def rng_tag(rng_impl: str) -> str:
    """The ``rng_impl`` tag of the port's generator ``rng_impl``."""
    if rng_impl not in RNG_TAGS:
        raise ValueError(f"unknown rng_impl {rng_impl!r}")
    return RNG_TAGS[rng_impl]


def scene_fingerprint(scene) -> str:
    """Content hash of the geometry the walkers move through.  With
    user-provided scenes (--scene-file, ``scene.CustomBox``) the
    (params, scene_seed) pair no longer determines the geometry, so a
    resume must check the arrays themselves."""
    h = hashlib.sha256()
    for arr in (scene.cells, scene.mnps, scene.waters):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _pallas_swap(phase, comp):
    """(A, B) / (comp_A, comp_B) <-> (A, comp_A) / (B, comp_B): the same
    swap of phase column 1 with comp column 0 both ways."""
    return (np.stack([phase[:, 0], comp[:, 0]], -1),
            np.stack([phase[:, 1], comp[:, 1]], -1))


def save_checkpoint(path: str, state: WalkerState, params: Params,
                    seed: int, scene_seed: int,
                    engine: str = "", rng_impl: str = "",
                    scene_fp: str = "", extra: dict = None) -> None:
    """Atomic: writes a temp file in the same directory and renames it,
    so a process death mid-save leaves either the old snapshot or the
    new one (the re-run contract of ``engine/resilience.py``).

    ``extra``: arrays stored in the SAME atomic file (keys ``x_<key>``),
    e.g. the streaming plane of a durable ``--stream-plane`` run; read
    them back with :func:`load_extra`."""
    phase, comp = _host(state.phase), _host(state.phase_comp)
    if phase.ndim == 2 and engine == ENGINE_TAG:
        phase, comp = _pallas_swap(phase, comp)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        # through a file object: np.savez on a name without .npz appends
        # the suffix, which would break the rename
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f,
                **{f"x_{k}": np.asarray(v) for k, v in (extra or {}).items()},
                version=FORMAT_VERSION,
                pos=_host(state.pos),
                in_cell=_host(state.in_cell),
                phase=phase,
                phase_comp=comp,
                step=np.uint32(int(state.step)),
                escapes=np.int32(int(state.escapes)),
                coverage=np.int32(int(state.coverage)),
                seed=seed,
                scene_seed=scene_seed,
                params_fp=params_fingerprint(params),
                engine=engine,
                rng_impl=rng_impl,
                scene_fp=scene_fp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, params: Params, device,
                    dtype=torch.float32, engine: str = "",
                    rng_impl: str = "",
                    scene_fp: str = "") -> Tuple[WalkerState, int, int]:
    """Returns (state on ``device``, seed, scene_seed); raises on a params
    mismatch, and on an engine / rng_impl / scene-content mismatch when
    both sides recorded one (pass the resuming run's tags; an empty
    string skips the check)."""
    device = torch.device(device)
    with np.load(path) as z:
        if int(z["version"]) not in (1, FORMAT_VERSION):
            raise ValueError(f"unknown checkpoint version {z['version']}")
        fp = str(z["params_fp"])
        want = params_fingerprint(params)
        if fp != want:
            raise ValueError(
                f"checkpoint was written with different parameters "
                f"(fingerprint {fp} != {want}); refusing to resume")
        tags = {}
        for name, ours in (("engine", engine), ("rng_impl", rng_impl)):
            theirs = tags[name] = str(z[name]) if name in z.files else ""
            if ours and theirs and ours != theirs:
                raise ValueError(
                    f"checkpoint was written under {name}={theirs!r} but "
                    f"is being resumed under {name}={ours!r}; the random "
                    f"sequence would silently diverge — resume with the "
                    f"original {name}")
        theirs = str(z["scene_fp"]) if "scene_fp" in z.files else ""
        if scene_fp and theirs and scene_fp != theirs:
            raise ValueError(
                f"checkpoint was written for a different scene (geometry "
                f"hash {theirs} != {scene_fp}); the walk would silently "
                f"continue in a different box — resume with the original "
                f"scene (same --scene-file / scene seed)")
        phase, comp = z["phase"], z["phase_comp"]
        if phase.ndim == 2 and tags["engine"] != "scan":
            phase, comp = _pallas_swap(phase, comp)

        def t(a, dt):
            return torch.as_tensor(np.asarray(a), device=device).to(dt)

        state = WalkerState(
            pos=t(z["pos"], dtype),
            in_cell=t(z["in_cell"], torch.bool),
            phase=t(phase, dtype),
            phase_comp=t(comp, dtype),
            step=int(z["step"]),
            escapes=t(z["escapes"], torch.int64),
            coverage=t(z["coverage"] if "coverage" in z.files else 0,
                       torch.int64))
        return state, int(z["seed"]), int(z["scene_seed"])


def load_extra(path: str) -> dict:
    """The ``extra`` arrays a checkpoint was saved with (empty dict if
    none), the counterpart of ``save_checkpoint(extra=...)``."""
    with np.load(path) as z:
        return {k[2:]: z[k] for k in z.files if k.startswith("x_")}

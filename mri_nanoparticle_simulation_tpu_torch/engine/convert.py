"""State carried between the JAX package and the port.

The system has no weights: what carries over is the walker state, the
packed dipole table, the large-scene cache and the Threefry key.  With
these, both frameworks compute the same thing from the same state, so a
run can start in one and continue in the other.  Everything crosses as
NumPy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import rng
from ..fields.expansion import SceneCache, pack_candidates, pack_table
from ..params import Params
from .cuda_engine import MnpTable
from .reference_engine import WalkerState


def params_from_fields(d: dict) -> Params:
    """The port's ``Params`` from a field dict, e.g.
    ``dataclasses.asdict`` of the reference's ``Params``; lists become
    tuples (the dataclass is frozen and hashable).  Raises for a name
    that is not a field."""
    names = {f.name for f in dataclasses.fields(Params)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"not Params fields: {unknown}")
    return Params(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in d.items()})


def _counters(ws, device):
    return (int(ws.step),
            torch.tensor(int(ws.escapes), dtype=torch.int64, device=device),
            torch.tensor(int(ws.coverage), dtype=torch.int64, device=device))


def state_from_numpy(ws, device) -> WalkerState:
    """The port's WalkerState from a reference ``WalkerState`` whose
    fields are NumPy arrays (``init_state`` output, or ``np.asarray`` of
    each field of a device state).  A decompose state of the reference's
    scan engine (phase and comp ``[W, 2]``, columns A and B) carries over
    as it is."""
    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)
    return WalkerState(t(ws.pos), t(ws.in_cell).to(torch.bool), t(ws.phase),
                       t(ws.phase_comp), *_counters(ws, device))


def state_from_planes(ps, num_water: int, device) -> WalkerState:
    """The port's WalkerState from a reference ``PlaneState`` of NumPy
    ``[R, 128]`` planes (``pallas_engine`` native form).

    A decompose ``PlaneState`` (phase and phase_comp ``[2, R, 128]``) is
    the reference sprint's own: it packs them as the kernel's state rows
    4-7 (A, comp_A, B, comp_B; pallas_engine.py:881-885, 940-941), so
    phase holds (A, comp_A) and phase_comp (B, comp_B).  They become
    ``[W, 2]`` phase (A, B) and comp (comp_A, comp_B)."""
    def vec(a):
        return torch.as_tensor(
            np.asarray(a).reshape(-1)[:num_water].copy(), device=device)
    phase, comp = np.asarray(ps.phase), np.asarray(ps.phase_comp)
    if phase.ndim == 3:
        ph = torch.stack([vec(phase[0]), vec(comp[0])], -1)
        cp = torch.stack([vec(phase[1]), vec(comp[1])], -1)
    else:
        ph, cp = vec(phase), vec(comp)
    return WalkerState(
        torch.stack([vec(ps.px), vec(ps.py), vec(ps.pz)], -1),
        vec(ps.in_cell) > 0.5, ph, cp, *_counters(ps, device))


def state_to_numpy(ws: WalkerState) -> WalkerState:
    """A WalkerState of NumPy arrays with the reference's field names
    and scalar types (uint32 step, int32 counters), which the reference
    engines accept (wrap it in their ``WalkerState`` for a jitted scan)."""
    return WalkerState(
        pos=ws.pos.cpu().numpy(), in_cell=ws.in_cell.cpu().numpy(),
        phase=ws.phase.cpu().numpy(), phase_comp=ws.phase_comp.cpu().numpy(),
        step=np.uint32(ws.step), escapes=np.int32(int(ws.escapes)),
        coverage=np.int32(int(ws.coverage)))


def mnp_table(mnps: np.ndarray, dtype, device) -> MnpTable:
    """Pack ``Scene.mnps`` ([n, 5]: x, y, z, r, M) as the kernels'
    ``[4, n_pad]`` table: positions and M cast to ``dtype``, M then
    multiplied by FIELD_SCALE in ``dtype``; padded to a multiple of 8
    with zero-moment entries 1e6 µm away (the reference's packing,
    pallas_engine.py:967-975).  The cast positions and moments ride
    along for the large-scene selection."""
    pos = torch.as_tensor(np.asarray(mnps[:, :3]), device=device).to(dtype)
    m = torch.as_tensor(np.asarray(mnps[:, 4]), device=device).to(dtype)
    return MnpTable(pack_table(pos, m), mnps.shape[0], pos, m)


def scene_cache_from_numpy(payload, far_coeffs, device) -> SceneCache:
    """The port's ``SceneCache`` from the reference's (``payload``
    [H^3, C, 5] and ``far_coeffs`` [H^3, n_coeffs] or None, as NumPy
    arrays, e.g. ``np.asarray`` of a JAX ``build_cache`` result), with
    the candidates also in the kernel's layout (``pack_candidates``)."""
    def t(a):
        return torch.tensor(np.asarray(a), device=device)
    pay = t(payload)
    return SceneCache(pay, None if far_coeffs is None else t(far_coeffs),
                      pack_candidates(pay))


def key_words(seed: int):
    """The two uint32 Threefry key words of ``seed``, as Python ints."""
    return rng.key_from_seed(seed)

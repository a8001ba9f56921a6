"""The order-0 cube selection (``chunk_kernel.run_cube_select``,
``csrc/cube_select_kernel.cu``) on the CPU, and on the card where there
is one:

* its CPU route is bitwise ``cube_select`` with the packing the sprint
  loop made of it (near [4, K, W] with M * FIELD_SCALE, ids int32 [K, W],
  n_reach), and ``build``'s model from it bitwise the torch route's;
* the kernel's algorithm spelled in plain torch (each candidate's key
  (bf16 bits of d^2) << 16 | slot, inserted in slot order into K sorted
  slots by a min and a max a slot) selects what the K bfloat16 argmin
  passes select, in their order: on ties, on cube faces, at and beyond
  the box (the clamp), and at K = C;
* the wrapper refuses what the kernel does not take;
* an order-0 sprint on the CPU keeps its state bitwise, launching no
  kernel, and ``far_impl="torch"`` launches none either;
* marked ``cuda``: the kernel bitwise its plain version on the card, one
  launch a chunk of an order-0 sprint.
"""

import os
import sys

import pytest
import torch

from mri_nanoparticle_simulation_tpu_torch.engine import (chunk_kernel,
                                                          convert,
                                                          cuda_engine)
from mri_nanoparticle_simulation_tpu_torch.engine.reference_engine import \
    init_state
from mri_nanoparticle_simulation_tpu_torch.fields import expansion
from mri_nanoparticle_simulation_tpu_torch.fields.dipole import FIELD_SCALE
from mri_nanoparticle_simulation_tpu_torch.params import Params
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from port_bench.work import counts  # noqa: E402

torch.set_num_threads(1)

KEY = (0x0BADC0DE, 0x12345678)


def _small():
    """The small order-0 scene of tests/test_torch_bench_exact.py."""
    return Params(chunk_steps=1000, near_k=10, num_water=64,
                  totaltime=0.004, sprint_steps=1000, taucp=0.002,
                  cube_candidates=32, cube_hash_dim=8,
                  far_table_order=0).validate()


@pytest.fixture(scope="module")
def scene():
    p = _small()
    sc = BacteriaBox(p, seed=42).populate()
    tbl = convert.mnp_table(sc.mnps, torch.float32, "cpu")
    cache = expansion.build_cache(tbl.pos, tbl.m, p)
    planes = cuda_engine.to_soa(init_state(sc.waters, p, "cpu"), p).planes
    return p, sc, tbl, cache, planes


def _old_packing(pos, tbl, cache, p, reach2):
    """What the sprint loop made of ``build``'s torch selection before
    the kernel: near [4, K, W] with M * FIELD_SCALE, the unscaled M
    [K, W], ids int32 [K, W], n_reach."""
    rows, n_reach = expansion.cube_select(pos.T, cache.payload, p, reach2)
    idx = rows[..., 4].long()
    near_pos, near_m = tbl.pos[idx], tbl.m[idx]
    m = near_m * torch.full((), FIELD_SCALE, dtype=torch.float32)
    near = torch.stack([near_pos[..., 0].T, near_pos[..., 1].T,
                        near_pos[..., 2].T, m.T]).contiguous()
    return near, near_m.T, idx.to(torch.int32).T.contiguous(), n_reach


def _anchor_sets(p, planes):
    """The walkers' wrapped start, and anchors strewn over the box from a
    seed (mixed walkers, as late in a run)."""
    g = torch.Generator().manual_seed(5)
    strewn = torch.rand((3, 256), generator=g) * p.bound
    return {"start": cuda_engine._wrap(planes[:3], p.bound).contiguous(),
            "strewn": strewn}


@pytest.mark.parametrize("anchors", ["start", "strewn"])
def test_cpu_route_is_cube_select_and_the_old_packing(scene, anchors):
    p, _, tbl, cache, planes = scene
    pos = _anchor_sets(p, planes)[anchors]
    reach2 = expansion.coverage_reach2(p)
    got = chunk_kernel.run_cube_select(
        pos, cache.payload, cache.cand_table, near_k=p.near_k,
        h=p.cube_hash_dim, bound=float(p.bound), reach2=reach2)
    want = _old_packing(pos, tbl, cache, p, reach2)
    for name, a, b in zip(("near", "near_M", "ids", "n_reach"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert got[3].sum() > 0


@pytest.mark.parametrize("reach", [True, False], ids=["reach2", "no_reach"])
def test_build_model_is_the_torch_route_bitwise(scene, reach):
    """``build`` through ``run_cube_select``: the fields of the model are
    what the gathers of the torch selection gave, and the near entry's
    inputs ride along as the sprint loop used to pack them."""
    p, _, tbl, cache, planes = scene
    pos = _anchor_sets(p, planes)["start"]
    reach2 = expansion.coverage_reach2(p) if reach else None
    nf = expansion.build(pos.T, tbl.pos, tbl.m, p, cache=cache,
                         reach2=reach2, tbl=tbl.tbl)
    near, near_m, ids, n_reach = _old_packing(pos, tbl, cache, p,
                                              reach2)
    idx = ids.T.long()
    assert torch.equal(nf.near_pos, tbl.pos[idx])
    assert torch.equal(nf.near_M, tbl.m[idx])
    assert torch.equal(nf.near, near)
    taylor = chunk_kernel.run_far_sums(pos, tbl.tbl, ids)
    assert torch.equal(nf.taylor, taylor)
    assert torch.equal(nf.b0, taylor[0])
    assert torch.equal(nf.grad, taylor[1:4].T)
    assert torch.equal(nf.hess, taylor[4:10].T)
    if reach:
        assert torch.equal(nf.n_reach, n_reach)
    else:
        assert nf.n_reach is None


# -- the kernel's algorithm in plain torch ---------------------------------

def bf16_bits(x):
    """The kernel's float -> bfloat16 bits (csrc/cube_select_kernel.cu
    bf16_bits) of float32 ``x`` >= 0, by integer arithmetic."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (u + 0x7FFF + ((u >> 16) & 1)) >> 16


def key_select(pos, payload, k, h, bound, reach2):
    """The kernel's selection, step for step: the cube, each candidate's
    d^2 in f32 and its key (bf16 bits << 16 | slot), inserted in slot
    order into K sorted slots by a min and a max a slot.  Returns (slots
    int64 [W, K], n_reach int32 [W])."""
    ci, _ = expansion._cube_index(pos.T, h, bound)
    cand = payload[(ci[:, 0] * h + ci[:, 1]) * h + ci[:, 2]]   # [W, C, 5]
    w, c = cand.shape[:2]
    keys = torch.full((w, k), 2 ** 32 - 1, dtype=torch.int64)
    cnt = torch.zeros(w, dtype=torch.int32)
    for j in range(c):
        dx = pos[0] - cand[:, j, 0]
        dy = pos[1] - cand[:, j, 1]
        dz = pos[2] - cand[:, j, 2]
        d2 = dx * dx + dy * dy + dz * dz
        cnt = cnt + (d2 < reach2).to(torch.int32)
        x = (bf16_bits(d2) << 16) | j
        for s in range(k):
            lo = torch.minimum(keys[:, s], x)
            x = torch.maximum(keys[:, s], x)
            keys[:, s] = lo
    return keys & 0xFFFF, cnt


def _cube_payload(h, c, bound, fill):
    """A payload [h^3, C, 5] whose every cube holds the candidates
    ``fill(cube centre)`` [C, 3] gives, with moments and ids from the
    row number."""
    cube = bound / h
    ax = (torch.arange(h, dtype=torch.float64) + 0.5) * cube
    centres = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                          -1).reshape(-1, 3)
    pos = torch.stack([fill(cc) for cc in centres]).to(torch.float32)
    n = h ** 3 * c
    m = (torch.arange(n, dtype=torch.float32) % 7 - 3).reshape(h ** 3, c)
    ids = torch.arange(n, dtype=torch.float32).reshape(h ** 3, c)
    return torch.cat([pos, m[..., None], ids[..., None]], -1).contiguous()


def _case(name):
    """(payload, anchors [3, W], K, h, bound) of one case."""
    g = torch.Generator().manual_seed(11)
    h, bound = 4, 8.0
    cube = bound / h
    if name == "ties":
        # candidates on a few shells about each cube centre, several at
        # one distance, and distances apart by less than a bf16 step:
        # equal keys but for the slot, anchors at the centres
        c, k = 32, 10
        dirs = torch.tensor([[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0],
                             [0, -1, 0], [0, 0, -1], [1, 1, 0], [0, 1, 1]],
                            dtype=torch.float64)
        radii = torch.tensor([0.25, 0.25 * (1 + 2 ** -12), 0.5, 0.375])

        def fill(cc):
            r = radii.repeat_interleave(8)
            d = dirs.repeat(4, 1)
            return cc + d / d.norm(dim=1, keepdim=True) * r[:, None]
        payload = _cube_payload(h, c, bound, fill)
        ax = (torch.arange(h, dtype=torch.float32) + 0.5) * cube
        anchors = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                              0).reshape(3, -1)
        return payload, anchors.contiguous(), k, h, bound
    c = 16 if name == "k_equals_c" else 32
    k = c if name == "k_equals_c" else 10

    def fill(cc):
        return cc + (torch.rand((c, 3), generator=g,
                                dtype=torch.float64) - 0.5) * 3 * cube
    payload = _cube_payload(h, c, bound, fill)
    if name == "cube_faces":
        # every coordinate a multiple of the cube edge, the box's faces
        # at 0 and bound included
        grid = torch.arange(h + 1, dtype=torch.float32) * cube
        anchors = torch.stack(torch.meshgrid(grid, grid, grid,
                                             indexing="ij"), 0).reshape(3, -1)
    elif name == "clamp":
        edge = torch.tensor([-1.0, -1e-6, -0.0, 0.0, bound - 1e-6, bound,
                             bound + 1e-6, bound + 1.0, 2 * bound])
        anchors = torch.stack([edge, edge.flip(0), edge.roll(3)])
    else:
        anchors = torch.rand((3, 200), generator=g) * bound
    return payload, anchors.contiguous(), k, h, bound


CASES = ["ties", "cube_faces", "clamp", "k_equals_c", "uniform"]


@pytest.mark.parametrize("name", CASES)
def test_key_insertion_selects_as_the_argmin_passes(name):
    payload, anchors, k, h, bound = _case(name)
    reach2 = 1.0
    slots, cnt = key_select(anchors, payload, k, h, bound, reach2)
    rows, n_reach = expansion._cube_rows(anchors.T, payload, k, h, bound,
                                         reach2)
    ci, _ = expansion._cube_index(anchors.T, h, bound)
    flat = (ci[:, 0] * h + ci[:, 1]) * h + ci[:, 2]
    want = payload[flat[:, None], slots]                    # [W, K, 5]
    assert torch.equal(rows, want)
    assert torch.equal(cnt, n_reach)
    if name == "ties":
        d2 = ((rows[..., :3] - anchors.T[:, None]) ** 2).sum(-1)
        b = d2.to(torch.bfloat16)
        assert (b[:, 1:] == b[:, :-1]).any(1).all()   # ties in every row


def test_kernel_bf16_rounding_is_torchs():
    """The kernel's integer rounding to bfloat16 against torch's over
    every exponent: mantissas on, beside and between the halfway points,
    and the extremes (0, the smallest subnormal, the largest finite)."""
    exps = torch.arange(0, 255, dtype=torch.int64) << 23
    mants = torch.tensor([0, 1, 0x7FFF, 0x8000, 0x8001, 0xFFFF, 0x10000,
                          0x17FFF, 0x18000, 0x18001, 0x7FFFFF, 0x7F8000,
                          0x7F7FFF, 0x12345, 0x6543FF], dtype=torch.int64)
    bits = (exps[:, None] | mants[None]).reshape(-1)
    bits = torch.cat([bits, torch.randint(0, 0x7F800000, (4096,),
                                          generator=torch.Generator()
                                          .manual_seed(3))])
    x = bits.to(torch.int32).view(torch.float32)
    want = x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    assert torch.equal(bf16_bits(x), want)


# -- the wrapper's checks ----------------------------------------------------

def _inputs(h=2, c=12, w=128):
    payload = torch.zeros((h ** 3, c, 5))
    return (torch.zeros((3, w)), payload,
            expansion.pack_candidates(payload))


def _misaligned(shape):
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + 1)[1:].view(shape)


BAD = {
    "pos_dtype": (lambda pos, pay, cand: (pos.double(), pay, cand), {},
                  TypeError, "pos must be"),
    "pos_shape": (lambda pos, pay, cand: (pos[:2].contiguous(), pay, cand),
                  {}, ValueError, r"pos must be \[3, N\]"),
    "pos_strided": (lambda pos, pay, cand: (pos.T.contiguous().T, pay, cand),
                    {}, ValueError, "pos must be contiguous"),
    "payload_dtype": (lambda pos, pay, cand: (pos, pay.half(), cand), {},
                      TypeError, "payload must be"),
    "payload_cubes": (lambda pos, pay, cand: (pos, pay[:7], cand), {},
                      ValueError, r"payload must be \[8, N, 5\]"),
    "payload_width": (lambda pos, pay, cand: (pos, pay[..., :4].contiguous(),
                                              cand), {},
                      ValueError, r"payload must be \[8, N, 5\]"),
    "cand_shape": (lambda pos, pay, cand: (pos, pay, cand[:, :11]
                                           .contiguous()), {},
                   ValueError, r"cand must be \[8, 12, 4\]"),
    "cand_dtype": (lambda pos, pay, cand: (pos, pay, cand.double()), {},
                   TypeError, "cand must be"),
    "cand_aligned": (lambda pos, pay, cand: (pos, pay,
                                             _misaligned(cand.shape)), {},
                     ValueError, "16-byte aligned"),
    "k_above_c": (lambda *a: a, {"near_k": 13}, ValueError,
                  r"near_k=13 outside \[1, 12\]"),
    "k_above_max": (lambda pos, pay, cand: (
        pos, torch.zeros((8, 20, 5)), torch.zeros((8, 20, 4))),
        {"near_k": chunk_kernel.MAX_K + 1}, ValueError, "outside"),
    "k_zero": (lambda *a: a, {"near_k": 0}, ValueError, "outside"),
    "c_above_slots": (lambda pos, pay, cand: (
        pos, torch.zeros((1, chunk_kernel.MAX_CUBE_CANDIDATES + 1, 5)),
        torch.zeros((1, chunk_kernel.MAX_CUBE_CANDIDATES + 1, 4))),
        {"h": 1}, ValueError, "the slots a key holds"),
    "device": (lambda pos, pay, cand: (pos, pay, cand.to("meta")), {},
               ValueError, "cand is on meta"),
    "no_kernel": (lambda pos, pay, cand: (pos.to("meta"), pay.to("meta"),
                                          cand.to("meta")), {},
                  ValueError, "no cube-selection kernel for device meta"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    change, kw, err, match = BAD[case]
    pos, pay, cand = change(*_inputs())
    args = dict(near_k=4, h=2, bound=8.0, reach2=1.0) | kw
    with pytest.raises(err, match=match):
        chunk_kernel.run_cube_select(pos, pay, cand, **args)


# -- the order-0 sprint ------------------------------------------------------

def _old_sprint(p, phys, tbl, cache, planes, n_chunks, args):
    """The order-0 sprint loop as it ran before the kernel: the torch
    selection packed for the near entry, chunk after chunk."""
    reach2 = expansion.coverage_reach2(p)
    out, wins = planes, []
    for c in range(n_chunks):
        wp = torch.cat([cuda_engine._wrap(out[:3], phys.bound), out[3:]])
        near, _, ids, _ = _old_packing(wp[:3], tbl, cache, p, reach2)
        taylor = chunk_kernel.run_far_sums(wp[:3], tbl.tbl, ids)
        out, _, _, w = cuda_engine.chunk_near_reference(
            wp, near, taylor, step0=c * p.chunk_steps, **args)
        wins.append(w.sum(0))
    return out, torch.cat(wins)


def test_order0_sprint_keeps_its_state_bitwise(scene, monkeypatch):
    p, sc, tbl, cache, _ = scene
    p = p.replace(sprint_steps=2 * p.chunk_steps)
    monkeypatch.setattr(cuda_engine, "REBUILD_MAX_MNPS", 0)
    phys = cuda_engine.chunk_physics(p, "hardware")
    sprint = cuda_engine.make_sprint_fn(p, p.num_water, "cpu",
                                        rng_impl="hardware")
    start = cuda_engine.to_soa(init_state(sc.waters, p, "cpu"), p)
    monkeypatch.setattr(chunk_kernel, "LAUNCHES",
                        dict.fromkeys(chunk_kernel.LAUNCHES, 0))
    s, wins = sprint(tbl, KEY, start, cache=cache)
    assert not any(chunk_kernel.LAUNCHES.values())
    args = dict(key=KEY, lane_offset=0, num_water=p.num_water, tcp=p.tcp,
                cell_r2=cuda_engine.cell_r2_f32(p.cell_r), dstd=1.0,
                phys=phys)
    out, want = _old_sprint(p, phys, tbl, cache, start.planes, 2, args)
    assert s.step == 2 * p.chunk_steps
    assert torch.equal(s.planes, out)
    assert torch.equal(wins, want)


def test_torch_route_and_cpu_launch_no_kernel(scene, monkeypatch):
    p, _, tbl, cache, planes = scene
    pos = _anchor_sets(p, planes)["start"]
    monkeypatch.setattr(chunk_kernel, "LAUNCHES",
                        dict.fromkeys(chunk_kernel.LAUNCHES, 0))
    reach2 = expansion.coverage_reach2(p)
    ker = expansion.build(pos.T, tbl.pos, tbl.m, p, cache=cache,
                          reach2=reach2)
    tor = expansion.build(pos.T, tbl.pos, tbl.m, p, cache=cache,
                          reach2=reach2, far_impl="torch")
    assert not any(chunk_kernel.LAUNCHES.values())
    assert tor.near is None and tor.taylor is None
    assert torch.equal(tor.near_pos, ker.near_pos)
    assert torch.equal(tor.n_reach, ker.n_reach)


# -- chip_smoke's phase 8 (c) ------------------------------------------------

def test_chip_smoke_edge_cases_run_on_the_cpu(scene):
    """The edge cases phase 8 (c) holds the kernel to, on the scene's own
    table: every case a shape the wrapper takes, the clamp's anchors at
    and beyond the box, K = C on the first 16 candidates."""
    p, _, _, cache, planes = scene
    pos = _anchor_sets(p, planes)["start"]
    cases = cs._select_cases(pos, cache.payload, cache.cand_table, p)
    assert [c[0] for c in cases] == ["cube faces", "clamp", "at candidates",
                                     "K = C = 16"]
    for what, anchors, payload, cand, k in cases:
        args = dict(near_k=k, h=p.cube_hash_dim, bound=float(p.bound),
                    reach2=expansion.coverage_reach2(p))
        got = chunk_kernel.run_cube_select(anchors, payload, cand, **args)
        cs._same_selection(got, _old_packing_of(anchors, payload, args),
                           what)
    clamp = cases[1][1]
    assert clamp.min() < 0 and clamp.max() >= p.bound
    assert cases[3][2].shape[1] == cases[3][4] == 16


def _old_packing_of(pos, payload, args):
    """``cube_select``'s rows of ``payload`` packed as the sprint loop
    packed them."""
    k = args["near_k"]
    p = Params(near_k=k, cube_hash_dim=args["h"], bound=args["bound"])
    rows, n_reach = expansion.cube_select(pos.T, payload, p, args["reach2"])
    m = rows[..., 3] * torch.full((), FIELD_SCALE, dtype=torch.float32)
    near = torch.stack([rows[..., 0].T, rows[..., 1].T, rows[..., 2].T,
                        m.T]).contiguous()
    return (near, rows[..., 3].T.contiguous(),
            rows[..., 4].long().to(torch.int32).T.contiguous(), n_reach)


def test_chip_smoke_bound_of_the_selection():
    """The work phase 8 (c) bounds the kernel by, at the cell's shape
    (100096 walkers, K 10, C 32, 16^3 cubes): 256 bytes a walker and
    the candidate rows once; bound by bytes at 8.59 us."""
    work = cs.cube_select_work(100096, 10, 32, 16)
    assert work == (100096 * 256 + 24 * 16 ** 3 * 32, 9 * 100096 * 32,
                    100096 * 32 * 25)
    ms, by = counts.bound(*work)
    assert by == "bytes" and ms == pytest.approx(28770304 / 3.35e9)


# -- on the card ---------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible to torch")
    chunk_kernel.load_library()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_is_its_plain_version_on_the_card(dev, name):
    payload, anchors, k, h, bound = _case(name)
    payload, anchors = payload.to(dev), anchors.to(dev)
    cand = expansion.pack_candidates(payload)
    args = dict(near_k=k, h=h, bound=bound, reach2=1.0)
    got = chunk_kernel.run_cube_select(anchors, payload, cand, **args)
    want = expansion.cube_select_reference(anchors, payload, **args)
    for name_, a, b in zip(("near", "near_M", "ids", "n_reach"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name_


@pytest.mark.cuda
def test_order0_sprint_launches_one_selection_a_chunk(dev, scene,
                                                      monkeypatch):
    p, sc, _, _, _ = scene
    tbl = convert.mnp_table(sc.mnps, torch.float32, dev)
    cache = expansion.build_cache(tbl.pos, tbl.m, p)
    monkeypatch.setattr(cuda_engine, "REBUILD_MAX_MNPS", 0)
    monkeypatch.setattr(chunk_kernel, "LAUNCHES",
                        dict.fromkeys(chunk_kernel.LAUNCHES, 0))
    sprint = cuda_engine.make_sprint_fn(p, p.num_water, dev,
                                        rng_impl="hardware")
    sprint(tbl, KEY, cuda_engine.to_soa(init_state(sc.waters, p, dev), p),
           cache=cache)
    n_chunks = p.sprint_steps // p.chunk_steps
    assert chunk_kernel.LAUNCHES["cube_select_kernel"] == n_chunks
    assert chunk_kernel.LAUNCHES["far_sums_kernel"] == n_chunks

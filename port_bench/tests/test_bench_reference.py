"""The frozen plain reference against the port's own plain twins at a
tiny size (64 walkers, one 1000-step chunk in every mode, three chunks
side by side), and the reference's scenes against the port's scene
builder:
an edit of the port's twins cannot move the yardstick unseen."""

import dataclasses

import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu_torch.engine import convert, cuda_engine
from mri_nanoparticle_simulation_tpu_torch.engine import decompose
from mri_nanoparticle_simulation_tpu_torch.engine.reference_engine import \
    init_state
from mri_nanoparticle_simulation_tpu_torch.fields import expansion
from mri_nanoparticle_simulation_tpu_torch.params import Params
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox

from port_bench import catalog
from port_bench.reference import Reference, build_scene, model

SEED = 2**40 + 12345


def _params(large):
    p = Params(chunk_steps=1000, near_k=10, num_water=64, totaltime=0.004,
               sprint_steps=1000, taucp=0.002)
    return (p.replace(cube_candidates=32, cube_hash_dim=8, far_table_order=3)
            if large else p)


@pytest.mark.parametrize("decompose_", [False, True], ids=["plain", "dec"])
@pytest.mark.parametrize("large", [False, True], ids=["rebuild", "near"])
@pytest.mark.parametrize("gen", ["fast", "threefry"])
def test_reference_chunks_match_the_port_twins(gen, large, decompose_):
    p = _params(large)
    sc = BacteriaBox(p, seed=42).populate()
    phys = cuda_engine.chunk_physics(
        p, "hardware" if gen == "fast" else "threefry")
    tbl = convert.mnp_table(sc.mnps, torch.float32, "cpu")
    planes = cuda_engine.to_soa(init_state(sc.waters, p, "cpu",
                                           decompose=decompose_), p).planes
    args = dict(key=convert.key_words(SEED), lane_offset=0, num_water=64,
                tcp=p.tcp, cell_r2=cuda_engine.cell_r2_f32(p.cell_r),
                dstd=1.0, phys=phys, decompose=decompose_)
    ref = Reference(dataclasses.asdict(p), gen,
                    {"waters": sc.waters, "mnps": sc.mnps}, SEED, "cpu")
    if large:
        ref.large = True
        ref.cand, ref.coeffs = model.scene_cache(
            tbl.pos, tbl.m, p.cube_hash_dim, p.cube_candidates, p.bound,
            p.far_table_order)
        cache = expansion.build_cache(tbl.pos, tbl.m, p)
        assert torch.equal(cache.cand_table, ref.cand)
        assert torch.equal(cache.far_coeffs, ref.coeffs)
        reach2 = expansion.coverage_reach2(p)
    ins, outs = [], []
    for c in range(3):
        ins.append(planes)
        if large:
            wp = torch.cat([cuda_engine._wrap(planes[:3], p.bound),
                            planes[3:]])
            near, taylor, nr = expansion.build_planes(wp[:3], p, cache,
                                                      reach2=reach2)
            o = cuda_engine.chunk_near_reference(wp, near, taylor,
                                                 step0=1000 * c, **args)
            o = (*o, nr, near, taylor)
        else:
            o = cuda_engine.chunk_reference(planes, tbl.tbl, step0=1000 * c,
                                            **args)
        outs.append(o)
        planes = o[0]
    got = ref.chunks(ins, [0, 1000, 2000], decompose=decompose_)
    for o, r in zip(outs, got):
        assert torch.equal(o[0], r.out)
        assert torch.equal(o[1], r.esc)
        assert torch.equal(o[2], r.cov)
        assert torch.equal(o[3], r.wins)
        if large:
            assert torch.equal(o[4], r.n_reach)
            assert torch.equal(o[5], r.near)
            assert torch.equal(o[6], r.taylor)


def test_reference_plane_fold_matches_the_port():
    """Two sprints of a record through the port's plane step and the
    reference's fold, with the sign tables each works out itself."""
    p = Params(num_water=64, totaltime=0.008, sprint_steps=2000,
               taucp=0.002, chunk_steps=1000)
    scales, taucps = [0.5, 1.0, 2.0], [0.001, 0.002, 0.004]
    g = torch.Generator().manual_seed(7)
    wins = [torch.randn((2, 2, 128), generator=g) for _ in range(2)]
    n = p.t // p.pfreq
    j = np.arange(1, n + 1)
    undo = np.where((j * p.pfreq) % p.tcp == 0, -1.0, 1.0)
    u_prev = np.concatenate([[1.0], undo[:-1]]).astype(np.float32)
    tcps = [p.replace(taucp=t).tcp for t in taucps]
    g_full = np.stack([decompose._flip_parity(n, t, p.pfreq)
                       for t in tcps]).astype(np.float32)
    ref = Reference(dataclasses.asdict(p), "fast",
                    {"waters": np.zeros((64, 3)),
                     "mnps": np.zeros((8, 5))}, 1, "cpu")
    ru, rg = ref.plane_tables(taucps, p.tau)
    assert np.array_equal(ru, u_prev) and np.array_equal(rg, g_full)
    step = decompose.make_plane_step(p, 64, np.asarray(scales), 3,
                                     device="cpu")
    carry = (torch.zeros((3, 64)),) * 4 + (torch.zeros(64),) * 2
    rcarry = carry
    for i, w in enumerate(wins):
        sl = slice(2 * i, 2 * i + 2)
        carry, blk = step(w, carry, torch.as_tensor(u_prev[sl]),
                          torch.as_tensor(g_full[:, sl]))
        rcarry, rblk = ref.fold(w, rcarry, ru[sl], rg[:, sl], scales)
        assert torch.equal(blk, rblk)
        for a, b in zip(carry, rcarry):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", catalog.config_names())
@pytest.mark.parametrize("seed,extra", [
    (None, {}), (7, {"num_water": 500}),
    (2**33 + 5, {"num_water": 500, "water_start_bound": 28.0})],
    ids=["own", "seed7", "wide"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_reference_scene_is_the_builders(name, seed, extra, native):
    """The scene the reference builds from the configuration's keys is
    what the port's builder makes of them, at the configuration's scene
    seed and size and at others, on both of the builder's paths."""
    cfg = catalog.load_config(name)
    seed = cfg["scene_seed"] if seed is None else seed
    if not native and not extra:
        extra = {"num_water": 500}
    kv = cfg["keys"] | extra
    p = Params(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in kv.items()})
    sc = BacteriaBox(p, seed=seed, prefer_native=native).populate()
    got = build_scene(kv, seed)
    assert np.array_equal(got["waters"], sc.waters)
    assert np.array_equal(got["mnps"], sc.mnps)

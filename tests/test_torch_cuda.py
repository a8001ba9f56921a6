"""The CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``; skipped (from a fixture) where torch sees no card.  Run
on a machine with an NVIDIA H100:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: the chunk kernels have the reference's compiled-kernel ones
(tests/test_pallas.py:109-111): positions within 1e-4, window sums
within 0.05; escapes and coverage counts equal.  The layout tests hold
every mode of both entries tighter: the state, escapes, coverage and
decompose record bitwise equal to the plain version (the same
operations in the same order), the window sums within 0.05 (the warp's
shuffle tree adds in another order than torch) -- the rebuild entry in
its split layout at 50 and 4032 walkers (and in two waves on Threefry),
at 32, 1024 and 4032 walkers at K 1, 5, 10 and 16 (its window sums also
bit for bit the warp's shuffle tree over the walkers' phases), and in
its flat layout above the threshold, the near entry at 4096 and
100096 walkers (its Threefry kernel in one wave), at K 1, 5, 10 and 16
on a ragged count, and in two waves.  That holds in every
mode: the Threefry and the fast generator, each with the default
physics and with every variant on.  The candidate-model
kernel, K 1-16 and far-table orders 1, 5 and 8: near slots equal (ties
excepted), taylor within 1e-5 of the largest |component|, n_reach equal;
one wave at the scale-up width with no spill.  The far-sums kernel: 1e-5
of each row's scale (tests/test_fields.py:375), K 1-16, on the large
scene and on a ragged table and walker count, the near ids on the edges
of the kernel's sub-tiles and tile; two runs bitwise equal; one wave at
the scale-up width with no local memory.  The decompose mode of both
chunk-kernel entries, in every generator and physics mode: positions
within 1e-4, the state's A and B and the per-walker record within 1e-5
(both expected bitwise), escapes and coverage equal; a decomposition run
on the card reconstructs the run on the CPU.  The math the kernels
write in place of the compiler's (csrc/math_check.cu) is bitwise the
compiler's over every float input it can see, and with it the variant
modes of the flat rebuild entry and the near entry call no more general
paths in their SASS than their default modes.
"""

import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu_torch import params as P
from mri_nanoparticle_simulation_tpu_torch.benchmark import kernel_sass
from mri_nanoparticle_simulation_tpu_torch.engine import (chunk_kernel,
                                                          convert,
                                                          cuda_engine, sim)
from mri_nanoparticle_simulation_tpu_torch.engine import decompose as dec
from mri_nanoparticle_simulation_tpu_torch.engine.reference_engine import \
    init_state
from mri_nanoparticle_simulation_tpu_torch.fields import expansion
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox
from test_torch_far_ids import FAR_RAGGED, far_sums_ids

pytestmark = pytest.mark.cuda

KEY = (0x0BADC0DE, 0x12345678)

CASES = {
    "small_64": (dict(chunk_steps=200, num_water=64, taucp=0.0001,
                      mmoment=3.5e-15, water_start_bound=7.9,
                      avoid_intracellular_throw=False), 3),
    "padding_50": (dict(chunk_steps=200, num_water=50, taucp=0.0001), 3),
    "coverage_nonzero": (dict(chunk_steps=1000, num_water=128,
                              num_cells=40, near_k=1, totaltime=0.002,
                              mmoment=3.5e-15, water_start_bound=7.9,
                              avoid_intracellular_throw=False), 3),
}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible to torch")
    chunk_kernel.load_library()
    return torch.device("cuda", 0)


def _params(over):
    base = dict(print_interval=0.0001, totaltime=0.0008, sprint_steps=400)
    base.update(over)
    return P.small_test_params(**base)


def _chunk(p, sc, dev, step0=0, rng_impl=cuda_engine.RNG_THREEFRY):
    ss = cuda_engine.to_soa(init_state(sc.waters, p, dev), p)
    tbl = convert.mnp_table(sc.mnps, torch.float32, dev).tbl
    args = dict(step0=step0, key=KEY, lane_offset=3,
                num_water=p.num_water, tcp=p.tcp,
                cell_r2=cuda_engine.cell_r2_f32(p.cell_r), dstd=1.0,
                phys=cuda_engine.chunk_physics(p, rng_impl))
    return ss.planes, tbl, args


def _assert_close(got, ref, n):
    out, esc, cov, wins = got
    r_out, r_esc, r_cov, r_wins = ref
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[:3, :n], r_out[:3, :n], rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(wins.sum(0), r_wins.sum(0), rtol=0,
                               atol=0.05)
    assert torch.equal(esc, r_esc)
    assert torch.equal(cov, r_cov)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(dev, name):
    over, seed = CASES[name]
    p = _params(over)
    sc = BacteriaBox(p, seed=seed).populate()
    planes, tbl, args = _chunk(p, sc, dev, step0=4000)
    got = chunk_kernel.run_chunk(planes, tbl, **args)
    ref = cuda_engine.chunk_reference(planes, tbl, **args)
    torch.cuda.synchronize()
    _assert_close(got, ref, p.num_water)
    if name == "coverage_nonzero":
        assert float(got[2].sum()) > 0


def test_kernel_matches_plain_version_at_headline_width(dev):
    """4032 walkers, the 716-dipole headline scene, K = 5; one window."""
    p = P.Params(chunk_steps=1000, near_k=5).validate()
    sc = BacteriaBox(p, seed=42).populate()
    planes, tbl, args = _chunk(p, sc, dev)
    got = chunk_kernel.run_chunk(planes, tbl, **args)
    ref = cuda_engine.chunk_reference(planes, tbl, **args)
    _assert_close(got, ref, p.num_water)


def test_kernel_is_deterministic_and_counted(dev):
    p = _params(CASES["small_64"][0])
    sc = BacteriaBox(p, seed=3).populate()
    planes, tbl, args = _chunk(p, sc, dev)
    before = chunk_kernel.LAUNCHES["chunk_kernel"]
    a = chunk_kernel.run_chunk(planes, tbl, **args)
    b = chunk_kernel.run_chunk(planes, tbl, **args)
    assert chunk_kernel.LAUNCHES["chunk_kernel"] == before + 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_sprint_on_card_matches_cpu_plain_version(dev):
    p = _params(dict(chunk_steps=200, num_water=64, taucp=0.0003,
                     mmoment=3.5e-15))
    sc = BacteriaBox(p, seed=4).populate()
    before = chunk_kernel.LAUNCHES["chunk_kernel"]
    _, c_gpu, s_gpu, st_gpu = cuda_engine.run_simulation(sc, p, seed=5,
                                                         device=dev)
    assert chunk_kernel.LAUNCHES["chunk_kernel"] == \
        before + p.t // p.chunk_steps
    _, c_cpu, s_cpu, st_cpu = cuda_engine.run_simulation(sc, p, seed=5,
                                                         device="cpu")
    np.testing.assert_allclose(st_gpu.pos.cpu().numpy(),
                               st_cpu.pos.numpy(), atol=1e-4)
    np.testing.assert_allclose(c_gpu, c_cpu, atol=0.05)
    np.testing.assert_allclose(s_gpu, s_cpu, atol=0.05)
    assert st_gpu.step == st_cpu.step == p.t


def test_runner_on_card(dev, tmp_path):
    p = P.small_test_params(totaltime=0.001, sprint_steps=500)
    before = chunk_kernel.LAUNCHES["chunk_kernel"]
    _, c, _, stats = sim.SimulationRunner(p, scene_seed=3, seed=2,
                                          device="cuda",
                                          rng_impl="threefry").run(
        csv_path=str(tmp_path / "t2.csv"), progress=False)
    assert chunk_kernel.LAUNCHES["chunk_kernel"] - before == \
        p.t // p.chunk_steps
    assert stats["steps"] == p.t and stats["escapes"] == 0
    _, c_cpu, _, _ = sim.SimulationRunner(p, scene_seed=3, seed=2,
                                          device="cpu",
                                          rng_impl="threefry").run(
        progress=False)
    np.testing.assert_allclose(c, c_cpu, atol=0.05)


# -- the fast generator and the physics variants -------------------------------

GRADIENT = (1e-4, 0.0, 2e-4)


def _all_variants(p):
    return p.replace(kick_mode=P.KICK_INTENDED,
                     direction_mode=P.DIRECTION_SPHERE,
                     b0_gradient=GRADIENT).with_permeability()


#: name -> (generator, physics, LAUNCHES key suffix)
MODES = {
    "fast": (cuda_engine.RNG_HARDWARE, lambda p: p, "[fast]"),
    "variants": (cuda_engine.RNG_THREEFRY, _all_variants, "[variants]"),
    "fast+variants": (cuda_engine.RNG_HARDWARE, _all_variants,
                      "[fast+variants]"),
    # one extra word per step pair: the coins sit where the kicks would
    "fast_reflection": (cuda_engine.RNG_HARDWARE,
                        lambda p: p.with_permeability(), "[fast+variants]"),
}


@pytest.mark.parametrize("pfreq", [100, 50, 125])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_kernel_matches_plain_version(dev, mode, pfreq):
    """Each mode at pfreq % 4 == 0, even and odd: the kernel against its
    plain version, bitwise in two runs, counted under its mode's key."""
    rng_impl, physics, tag = MODES[mode]
    p = physics(_params(dict(
        chunk_steps=2 * pfreq, print_interval=pfreq * 1e-6,
        totaltime=4 * pfreq * 1e-6, sprint_steps=4 * pfreq,
        taucp=pfreq * 1e-6, num_water=200, mmoment=3.5e-15,
        water_start_bound=7.9, avoid_intracellular_throw=False))).validate()
    sc = BacteriaBox(p, seed=3).populate()
    planes, tbl, args = _chunk(p, sc, dev, step0=1000, rng_impl=rng_impl)
    key = chunk_kernel.chunk_mode("chunk_kernel", args["phys"])
    assert key == "chunk_kernel" + tag
    before = chunk_kernel.LAUNCHES[key]
    got = chunk_kernel.run_chunk(planes, tbl, **args)
    again = chunk_kernel.run_chunk(planes, tbl, **args)
    assert chunk_kernel.LAUNCHES[key] == before + 2
    ref = cuda_engine.chunk_reference(planes, tbl, **args)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    _assert_close(got, ref, p.num_water)


@pytest.mark.parametrize("mode", ["fast", "variants", "fast+variants"])
def test_mode_near_kernel_matches_plain_version(large, mode):
    p, _, cache, planes, reach2 = large
    rng_impl, physics, tag = MODES[mode]
    p = physics(p).validate()
    near, taylor, _ = expansion.build_planes(planes[:3].contiguous(), p,
                                             cache, reach2=reach2)
    args = dict(step0=p.chunk_steps, key=KEY, lane_offset=3,
                num_water=p.num_water - 6, tcp=p.tcp,
                cell_r2=cuda_engine.cell_r2_f32(p.cell_r), dstd=1.0,
                phys=cuda_engine.chunk_physics(p, rng_impl))
    key = "chunk_near_kernel" + tag
    before = chunk_kernel.LAUNCHES[key]
    got = chunk_kernel.run_chunk_near(planes, near, taylor, **args)
    assert chunk_kernel.LAUNCHES[key] == before + 1
    ref = cuda_engine.chunk_near_reference(planes, near, taylor, **args)
    torch.cuda.synchronize()
    _assert_close(got, ref, p.num_water - 6)


def test_fast_runner_on_card_matches_cpu(dev):
    """The runner's default generator on the card and on the CPU: the
    same counter-based stream, so the same run."""
    p = P.small_test_params(totaltime=0.001, sprint_steps=500)
    before = chunk_kernel.LAUNCHES["chunk_kernel[fast]"]
    _, c, _, st = sim.SimulationRunner(p, scene_seed=3, seed=2,
                                       device="cuda").run(progress=False)
    assert chunk_kernel.LAUNCHES["chunk_kernel[fast]"] - before == \
        p.t // p.chunk_steps
    _, c_cpu, _, st_cpu = sim.SimulationRunner(
        p, scene_seed=3, seed=2, device="cpu").run(progress=False)
    np.testing.assert_allclose(c, c_cpu, atol=0.05)
    assert st["escapes"] == st_cpu["escapes"] == 0


# -- the large-scene kernels ---------------------------------------------------

def _large_params(**over):
    base = dict(num_cells=30, cube_hash_dim=4, cube_candidates=16,
                near_k=4, far_table_order=3, num_water=256,
                chunk_steps=200, totaltime=0.0008, sprint_steps=400,
                mmoment=3.5e-15)
    base.update(over)
    return P.small_test_params(**base)


@pytest.fixture(scope="module")
def large(dev):
    """A 30-cell scene's table and cache on the card, and wrapped
    anchors (the walkers after one rebuild chunk)."""
    p = _large_params()
    sc = BacteriaBox(p, seed=3).populate()
    tbl = convert.mnp_table(sc.mnps, torch.float32, dev)
    cache = expansion.build_cache(tbl.pos, tbl.m, p)
    planes, _, args = _chunk(p, sc, dev)
    planes, *_ = chunk_kernel.run_chunk(planes, tbl.tbl, **args)
    planes = torch.cat([cuda_engine._wrap(planes[:3], p.bound), planes[3:]])
    return p, tbl, cache, planes, expansion.coverage_reach2(p)


@pytest.fixture(scope="module")
def order_caches(large):
    """The large scene's cache at far-table orders 1, 5 and 8."""
    p, tbl, _, _, _ = large
    return {o: expansion.build_cache(tbl.pos, tbl.m,
                                     p.replace(far_table_order=o))
            for o in (1, 5, 8)}


@pytest.mark.parametrize("order", [1, 5, 8])
@pytest.mark.parametrize("k", [1, 5, 10, 16])
def test_cand_model_kernel_matches_plain_version(large, order_caches, k,
                                                 order):
    """K 1 to 16 over the 16 candidates, orders 1 (the one-wave kernel's
    smallest), 5 (the scale-up's) and 8 (the high-order kernel), at 250
    walkers (the last block partly empty)."""
    p, _, _, planes, reach2 = large
    p = p.replace(near_k=k, far_table_order=order)
    cache = order_caches[order]
    pos = planes[:3, :250].contiguous()
    before = chunk_kernel.LAUNCHES["cand_model_kernel"]
    near, taylor, cnt = expansion.build_planes(pos, p, cache, reach2=reach2)
    again = expansion.build_planes(pos, p, cache, reach2=reach2)
    assert chunk_kernel.LAUNCHES["cand_model_kernel"] == before + 2
    r_near, r_taylor, r_cnt = expansion.cand_model_reference(
        pos, cache.cand_table, cache.far_coeffs, near_k=p.near_k,
        order=p.far_table_order, h=p.cube_hash_dim, bound=p.bound,
        reach2=reach2)
    torch.cuda.synchronize()
    for a, b in zip((near, taylor, cnt), again):
        assert torch.equal(a, b)
    differ = (near != r_near).any(0)
    d2 = ((near[:3] - pos[:, None]) ** 2).sum(0)
    r_d2 = ((r_near[:3] - pos[:, None]) ** 2).sum(0)
    assert torch.equal(d2[differ], r_d2[differ])
    for i in range(10):
        scale = float(r_taylor[i].abs().max())
        torch.testing.assert_close(taylor[i], r_taylor[i], rtol=0,
                                   atol=1e-5 * scale)
    assert torch.equal(cnt, r_cnt)


@pytest.mark.parametrize("k", [1, 5, 10, 16])
def test_cand_model_is_one_wave_at_the_scale_up_width(dev, k):
    """Up to order 7 the kernel runs 6 blocks of 128 per SM in at most 80
    registers, so 100096 walkers are one wave on an H100; up to the
    scale-up's K 10 with no local memory (no spill), and so order 8's
    kernel.  (At K 16 the 80 registers leave 8 bytes of local memory.)"""
    info = chunk_kernel.cand_model_info(k, 5, dev)
    assert info.blocks_per_sm >= 6 and info.regs <= 80
    assert info.threads == chunk_kernel.BLOCK
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if sms >= 132:
        assert chunk_kernel.walker_layout(100096, sms, info).waves == 1
    assert chunk_kernel.cand_model_info(k, 1, dev) == info
    if k <= 10:
        assert info.local_bytes == 0
        assert chunk_kernel.cand_model_info(k, 8, dev).local_bytes == 0


#: far-sums cases (as tests/test_torch_large.py's, against JAX there):
#: the large scene's table (152 dipoles) and walkers, or the ragged case
#: (tests/test_torch_far_ids.py)
FAR_SHAPES = {"scene": None, "ragged": FAR_RAGGED}


def _far_case(large, k, shape):
    """(anchors f32[3, w], packed table, ids int32[K, w]) on the card of
    the far-sums case ``shape`` at ``k``, from a seed."""
    p, tbl, _, planes, _ = large
    g = torch.Generator().manual_seed(k)
    if FAR_SHAPES[shape] is None:
        pos = planes[:3].contiguous()
        table, n = tbl.tbl, tbl.n_mnp
    else:
        w, n = FAR_SHAPES[shape]
        pos = (torch.rand((3, w), generator=g) * p.bound).to(planes.device)
        mp = torch.rand((n, 3), generator=g) * p.bound
        mm = tbl.m[0].cpu() * (0.5 + torch.rand(n, generator=g))
        table = expansion.pack_table(mp, mm).to(planes.device)
    idx = far_sums_ids(np.random.default_rng(k), n, k, pos.shape[1])
    return pos, table, torch.from_numpy(idx).to(pos.device)


@pytest.mark.parametrize("shape", list(FAR_SHAPES))
@pytest.mark.parametrize("k", [1, 5, 10, 16])
def test_far_sums_kernel_matches_plain_version(large, k, shape):
    pos, table, idx = _far_case(large, k, shape)
    before = chunk_kernel.LAUNCHES["far_sums_kernel"]
    got = chunk_kernel.run_far_sums(pos, table, idx)
    again = chunk_kernel.run_far_sums(pos, table, idx)
    assert chunk_kernel.LAUNCHES["far_sums_kernel"] == before + 2
    assert torch.equal(got, again) and bool(torch.isfinite(got).all())
    ref = expansion.far_sums_reference(pos, table, idx)
    for i in range(10):
        err = float((got[i] - ref[i]).abs().max())
        assert err <= 1e-5 * float(ref[i].abs().max()), i


@pytest.mark.parametrize("k", [1, 5, 10, 16])
def test_far_sums_kernel_is_one_wave_without_spill(dev, k):
    """One walker a thread, 128 a block, no local memory; at the
    scale-up's 100096 walkers one wave on an H100."""
    info = chunk_kernel.far_sums_info(k, dev)
    assert info.threads == chunk_kernel.BLOCK and info.local_bytes == 0
    assert info.smem == 0 and info.blocks_per_sm >= 6
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if sms >= 132:
        lay = chunk_kernel.walker_layout(100096, sms, info)
        assert lay.blocks == 782 and lay.waves == 1
    chunk_kernel.run_far_sums(torch.zeros((3, 300), device=dev),
                              torch.zeros((4, 40), device=dev),
                              torch.zeros((k, 300), dtype=torch.int32,
                                          device=dev))
    assert chunk_kernel.LAYOUTS["far_sums_kernel"] == \
        chunk_kernel.walker_layout(300, sms, info)


def test_chunk_near_kernel_matches_plain_version(large):
    p, _, cache, planes, reach2 = large
    near, taylor, _ = expansion.build_planes(planes[:3].contiguous(), p,
                                             cache, reach2=reach2)
    args = dict(step0=p.chunk_steps, key=KEY, lane_offset=3,
                num_water=p.num_water - 6, tcp=p.tcp,
                cell_r2=cuda_engine.cell_r2_f32(p.cell_r), dstd=1.0,
                phys=cuda_engine.chunk_physics(p))
    before = chunk_kernel.LAUNCHES["chunk_near_kernel"]
    got = chunk_kernel.run_chunk_near(planes, near, taylor, **args)
    assert chunk_kernel.LAUNCHES["chunk_near_kernel"] == before + 1
    ref = cuda_engine.chunk_near_reference(planes, near, taylor, **args)
    torch.cuda.synchronize()
    _assert_close(got, ref, p.num_water - 6)
    assert float(got[2].abs().sum()) == 0.0


def test_cube_path_sprint_on_card_matches_cpu(dev, monkeypatch):
    """One sprint of the cube path through kernels 2 and 1c, against the
    same sprint on the CPU (plain versions) with the same cache."""
    monkeypatch.setattr(cuda_engine, "REBUILD_MAX_MNPS", 0)
    p = _large_params()
    sc = BacteriaBox(p, seed=3).populate()
    cpu = torch.device("cpu")
    tbl0 = convert.mnp_table(sc.mnps, torch.float32, cpu)
    cache0 = expansion.build_cache(tbl0.pos, tbl0.m, p)
    n = p.sprint_steps // p.chunk_steps
    out = {}
    for d in (cpu, dev):
        tbl = convert.mnp_table(sc.mnps, torch.float32, d)
        cache = expansion.SceneCache(*(t.to(d) for t in cache0))
        sprint = cuda_engine.make_sprint_fn(p, p.num_water, d)
        before = dict(chunk_kernel.LAUNCHES)
        ss, wins = sprint(tbl, KEY, cuda_engine.to_soa(
            init_state(sc.waters, p, d), p), cache=cache)
        launched = {k: chunk_kernel.LAUNCHES[k] - before[k] for k in before}
        want = n if d.type == "cuda" else 0
        assert launched == {**{k: 0 for k in before},
                            "chunk_near_kernel": want,
                            "cand_model_kernel": want}
        out[d.type] = (cuda_engine.from_soa(ss, p.num_water), wins.cpu())
    (st_c, w_c), (st_g, w_g) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(st_g.pos.cpu().numpy(), st_c.pos.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(w_g.numpy(), w_c.numpy(), atol=0.05)
    assert int(st_g.escapes) == int(st_c.escapes)
    assert int(st_g.coverage) == int(st_c.coverage)


# -- the decompose mode --------------------------------------------------------

#: name -> (generator, physics) of each decompose mode
DEC_MODES = {
    "dec": (cuda_engine.RNG_THREEFRY, lambda p: p),
    "fast+dec": (cuda_engine.RNG_HARDWARE, lambda p: p),
    "variants+dec": (cuda_engine.RNG_THREEFRY, _all_variants),
    "fast+variants+dec": (cuda_engine.RNG_HARDWARE, _all_variants),
}


def _dec_planes(planes):
    """8 decompose rows from 6: B and comp_B half of A and comp_A."""
    return torch.cat([planes[:6], 0.5 * planes[4:6]]).contiguous()


def _assert_dec_close(got, again, ref, n):
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    out, esc, cov, wins = got
    r_out, r_esc, r_cov, r_wins = ref
    assert torch.isfinite(out).all() and torch.isfinite(wins).all()
    torch.testing.assert_close(out[:3, :n], r_out[:3, :n], rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(out[4:, :n], r_out[4:, :n], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(wins[..., :n], r_wins[..., :n], rtol=0,
                               atol=1e-5)
    assert torch.equal(esc, r_esc)
    assert torch.equal(cov, r_cov)


@pytest.mark.parametrize("mode", sorted(DEC_MODES))
def test_decompose_kernel_matches_plain_version(dev, mode):
    """The rebuild entry in decompose mode: 200 walkers (56 padding), a
    Carr-Purcell flip at each window, bitwise in two runs, counted."""
    rng_impl, physics = DEC_MODES[mode]
    p = physics(_params(dict(
        chunk_steps=200, num_water=200, taucp=0.0001, mmoment=3.5e-15,
        water_start_bound=7.9, avoid_intracellular_throw=False))).validate()
    sc = BacteriaBox(p, seed=3).populate()
    planes, tbl, args = _chunk(p, sc, dev, step0=1000, rng_impl=rng_impl)
    planes = _dec_planes(planes)
    key = "chunk_kernel[" + mode + "]"
    assert chunk_kernel.chunk_mode("chunk_kernel", args["phys"], True) == key
    before = chunk_kernel.LAUNCHES[key]
    got = chunk_kernel.run_chunk(planes, tbl, decompose=True, **args)
    again = chunk_kernel.run_chunk(planes, tbl, decompose=True, **args)
    assert chunk_kernel.LAUNCHES[key] == before + 2
    assert got[0].shape == (8, 256) and got[3].shape == (2, 2, 256)
    ref = cuda_engine.chunk_reference(planes, tbl, decompose=True, **args)
    torch.cuda.synchronize()
    _assert_dec_close(got, again, ref, p.num_water)


@pytest.mark.parametrize("mode", sorted(DEC_MODES))
def test_decompose_near_kernel_matches_plain_version(large, mode):
    p, _, cache, planes, reach2 = large
    rng_impl, physics = DEC_MODES[mode]
    p = physics(p).validate()
    near, taylor, _ = expansion.build_planes(planes[:3].contiguous(), p,
                                             cache, reach2=reach2)
    args = dict(step0=p.chunk_steps, key=KEY, lane_offset=3,
                num_water=p.num_water - 6, tcp=p.tcp,
                cell_r2=cuda_engine.cell_r2_f32(p.cell_r), dstd=1.0,
                phys=cuda_engine.chunk_physics(p, rng_impl))
    dplanes = _dec_planes(planes)
    key = "chunk_near_kernel[" + mode + "]"
    before = chunk_kernel.LAUNCHES[key]
    got = chunk_kernel.run_chunk_near(dplanes, near, taylor, decompose=True,
                                      **args)
    again = chunk_kernel.run_chunk_near(dplanes, near, taylor,
                                        decompose=True, **args)
    assert chunk_kernel.LAUNCHES[key] == before + 2
    ref = cuda_engine.chunk_near_reference(dplanes, near, taylor,
                                           decompose=True, **args)
    torch.cuda.synchronize()
    _assert_dec_close(got, again, ref, p.num_water - 6)
    assert float(got[2].abs().sum()) == 0.0


@pytest.mark.parametrize("rng_impl", [cuda_engine.RNG_THREEFRY,
                                      cuda_engine.RNG_HARDWARE])
def test_decomposition_on_card_matches_cpu(dev, rng_impl):
    """run_decomposition on the card and on the CPU: the same records
    (within the kernels' tolerances), the card's time split measured."""
    p = _params(dict(chunk_steps=200, num_water=64, taucp=0.0003,
                     mmoment=3.5e-15, water_start_bound=7.9,
                     avoid_intracellular_throw=False))
    sc = BacteriaBox(p, seed=4).populate()
    key = "chunk_kernel[fast+dec]" if rng_impl == cuda_engine.RNG_HARDWARE \
        else "chunk_kernel[dec]"
    before = chunk_kernel.LAUNCHES[key]
    gpu = dec.run_decomposition(sc, p, seed=5, rng_impl=rng_impl)
    assert chunk_kernel.LAUNCHES[key] - before == p.t // p.chunk_steps
    cpu = dec.run_decomposition(sc, p, seed=5, device="cpu",
                                rng_impl=rng_impl)
    np.testing.assert_allclose(gpu.A, cpu.A, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gpu.B, cpu.B, rtol=0, atol=1e-5)
    assert gpu.stats["escapes"] == cpu.stats["escapes"] == 0
    assert gpu.stats["device_s"] > 0 and gpu.stats["copy_s"] > 0


# -- the layouts: every mode bitwise, on both sides of the threshold -----------

#: name -> (generator, physics, decompose) of all eight chunk-kernel modes
ALL_MODES = {
    "": (cuda_engine.RNG_THREEFRY, lambda p: p, False),
    "fast": (cuda_engine.RNG_HARDWARE, lambda p: p, False),
    "variants": (cuda_engine.RNG_THREEFRY, _all_variants, False),
    "fast+variants": (cuda_engine.RNG_HARDWARE, _all_variants, False),
    **{k: (*v, True) for k, v in DEC_MODES.items()},
}


def _cell_variants(p):
    """The variant physics of the benchmark's ``variants`` configuration:
    the intended kick and permeable membranes, with cube directions and no
    gradient (the hand-off keeps no position, and the ring's kick is
    finished without sphere directions)."""
    return p.replace(kick_mode=P.KICK_INTENDED).with_permeability()


#: the split layout's modes: all eight, and the benchmark's variant
#: physics on both generators, with and without decompose
SPLIT_MODES = {
    **ALL_MODES,
    "cell": (cuda_engine.RNG_THREEFRY, _cell_variants, False),
    "fast+cell": (cuda_engine.RNG_HARDWARE, _cell_variants, False),
    "cell+dec": (cuda_engine.RNG_THREEFRY, _cell_variants, True),
    "fast+cell+dec": (cuda_engine.RNG_HARDWARE, _cell_variants, True),
}


def _key(entry, mode):
    return entry + (f"[{mode}]" if mode else "")


#: the rebuild entry's LAUNCHES key of each split mode: the benchmark's
#: variant physics launches the variant modes
SPLIT_KEYS = {**{m: _key("chunk_kernel", m) for m in ALL_MODES},
              "cell": "chunk_kernel[variants]",
              "fast+cell": "chunk_kernel[fast+variants]",
              "cell+dec": "chunk_kernel[variants+dec]",
              "fast+cell+dec": "chunk_kernel[fast+variants+dec]"}


def _assert_bitwise(got, again, ref, dec):
    """State, escapes, coverage (and the decompose record) bitwise equal
    to the plain version and between two runs; window sums within the
    reference's compiled-kernel tolerance (their order is the warp's
    shuffle tree)."""
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    out, esc, cov, wins = got
    r_out, r_esc, r_cov, r_wins = ref
    assert torch.isfinite(out).all()
    assert torch.equal(out, r_out)
    assert torch.equal(esc, r_esc)
    assert torch.equal(cov, r_cov)
    if dec:
        assert torch.equal(wins, r_wins)
    else:
        assert wins.shape == r_wins.shape
        torch.testing.assert_close(wins.sum(0), r_wins.sum(0), rtol=0,
                                   atol=0.05)


@pytest.fixture(scope="module")
def headline(dev):
    p = P.Params(chunk_steps=1000, near_k=5).validate()
    return p, BacteriaBox(p, seed=42).populate()


def _rebuild_case(p, sc, dev, mode, n, tcp=None):
    """The state after one kernel chunk of ``n`` walkers in ``mode`` (of
    ``SPLIT_MODES``), and the arguments of the next chunk."""
    rng_impl, physics, dec = SPLIT_MODES[mode]
    pm = physics(p).validate()
    st = init_state(sc.waters[:n], pm, dev, decompose=dec)
    planes = cuda_engine.to_soa(st, pm).planes
    tbl = convert.mnp_table(sc.mnps, torch.float32, dev).tbl
    args = dict(step0=0, key=KEY, lane_offset=3, num_water=n,
                tcp=pm.tcp if tcp is None else tcp,
                cell_r2=cuda_engine.cell_r2_f32(pm.cell_r), dstd=1.0,
                phys=cuda_engine.chunk_physics(pm, rng_impl))
    planes, *_ = chunk_kernel.run_chunk(planes, tbl, decompose=dec, **args)
    if dec:
        planes = _dec_planes(planes[:6])
    return planes, tbl, dict(args, step0=pm.chunk_steps), dec


def _check_rebuild(planes, tbl, args, dec, mode):
    key = SPLIT_KEYS[mode]
    before = chunk_kernel.LAUNCHES[key]
    got = chunk_kernel.run_chunk(planes, tbl, decompose=dec, **args)
    again = chunk_kernel.run_chunk(planes, tbl, decompose=dec, **args)
    assert chunk_kernel.LAUNCHES[key] == before + 2
    ref = cuda_engine.chunk_reference(planes, tbl, decompose=dec, **args)
    torch.cuda.synchronize()
    _assert_bitwise(got, again, ref, dec)
    return chunk_kernel.LAYOUTS[key]


@pytest.mark.parametrize("n", [50, 4032])
@pytest.mark.parametrize("mode", sorted(SPLIT_MODES))
def test_split_layout_bitwise(headline, dev, mode, n):
    """The rebuild entry's split layout (32 walkers a block, each on a
    lane of its chain warp and of its field warp, fed by four generator
    warps on Threefry and two on the fast generator) in every mode, and
    in the benchmark's variant physics, at 50
    walkers (a Carr-Purcell flip every two windows) and at the headline's
    4032; two blocks resident a SM, as the split thresholds assume."""
    p, sc = headline
    planes, tbl, args, dec = _rebuild_case(p, sc, dev, mode, n,
                                           tcp=2 * p.pfreq if n == 50
                                           else None)
    lay = _check_rebuild(planes, tbl, args, dec, mode)
    gen_warps = 2 if args["phys"].fast_rng else 4
    assert lay.split and lay.gen_warps == gen_warps
    assert lay.threads == 32 * (2 + gen_warps)
    assert lay.blocks == planes.shape[1] // 32 and lay.waves == 1
    assert lay.blocks_per_sm == 2
    if n == 4032:
        assert lay.blocks >= 120


@pytest.mark.parametrize("n", [32, 1024, 4032])
@pytest.mark.parametrize("k", [1, 4, 5, 10, 12, 16])
@pytest.mark.parametrize("mode", sorted(SPLIT_MODES))
def test_split_walker_side_bitwise(headline, dev, mode, k, n):
    """The split layout's walker side (each walker's step split between
    its chain warp and its field warp through the hand-off, whose depth
    falls with K: 16 steps at K 5, 8 at K 10, 4 at K 16; with the
    variants 16 at K 4, and at K 12 8 on the fast generator and 4 on
    Threefry) in every mode and in the benchmark's variant physics at
    K 1, 4, 5, 10, 12 and 16, on 32 walkers (one block holds them all; a
    Carr-Purcell flip every two windows), 1024 and the headline's 4032
    (4096 padded): state, escapes, coverage and decompose record bitwise
    the plain version's, window sums within its tolerance, and the launch
    shape the runtime reports."""
    p, sc = headline
    pk = p.replace(near_k=k).validate()
    planes, tbl, args, dec = _rebuild_case(pk, sc, dev, mode, n,
                                           tcp=2 * pk.pfreq if n == 32
                                           else None)
    lay = _check_rebuild(planes, tbl, args, dec, mode)
    gen_warps = 2 if args["phys"].fast_rng else 4
    assert lay.split and lay.gen_warps == gen_warps
    assert lay.threads == 32 * (chunk_kernel.WALKER_WARPS + gen_warps)
    assert lay.blocks == planes.shape[1] // 32 and lay.waves == 1


def _block_tree(v):
    """The 32-wide shuffle tree of ``warp_sum`` (csrc/field_math.cuh) over
    each row of ``v`` [blocks, 32], in float32: lane i adds lane i + o for
    o = 16, 8, 4, 2, 1; lane 0's sum."""
    v = v.clone()
    for o in (16, 8, 4, 2, 1):
        v[:, :o] = v[:, :o] + v[:, o:2 * o]
    return v[:, 0]


@pytest.mark.parametrize("k", [1, 5, 10, 16])
@pytest.mark.parametrize("mode", sorted(m for m in ALL_MODES
                                        if "dec" not in m))
def test_split_window_sums_are_the_warp_tree(headline, dev, mode, k):
    """The split block's window sums, from its field warp, are bit for
    bit the 32-wide shuffle tree (``warp_sum``) over the block's walkers
    in column order: one window a chunk (1000 steps, no flip), so each
    walker's window phase is its end phase, and torch's cos and sin of it
    are the kernel's."""
    p, sc = headline
    pk = p.replace(near_k=k).validate()
    assert pk.chunk_steps == pk.pfreq
    planes, tbl, args, dec = _rebuild_case(pk, sc, dev, mode, 4032)
    assert (args["step0"] + pk.chunk_steps) % args["tcp"] != 0
    out, _, _, wins = chunk_kernel.run_chunk(planes, tbl, decompose=dec,
                                             **args)
    torch.cuda.synchronize()
    valid = (torch.arange(out.shape[1], device=dev) < 4032).float()
    for c, fn in ((0, torch.cos), (1, torch.sin)):
        want = _block_tree((fn(out[4]) * valid).reshape(-1, 32))
        assert torch.equal(wins[:, 0, c], want)


def _check_flat_above_threshold(dev, mode, rounds=20):
    """The rebuild entry in ``mode`` on 100 walkers more than the split
    layout's threshold, with ``rounds`` Threefry rounds: the flat layout,
    bitwise its plain version's."""
    rng_impl, physics, dec = ALL_MODES[mode]
    phys = cuda_engine.chunk_physics(physics(P.Params(
        chunk_steps=1000, near_k=5)).validate(), rng_impl)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    edge = chunk_kernel.split_threshold(sms, {
        "split": chunk_kernel.kernel_info("chunk_kernel", phys, dec, "split",
                                          720)})
    p = P.Params(chunk_steps=1000, near_k=5, num_water=edge + 100,
                 rng_rounds=rounds).validate()
    sc = BacteriaBox(p, seed=42).populate()
    planes, tbl, args, dec = _rebuild_case(p, sc, dev, mode, p.num_water)
    assert tbl.shape[1] == 720 and args["phys"].rounds == rounds
    lay = _check_rebuild(planes, tbl, args, dec, mode)
    assert not lay.split and lay.threads == 128
    assert planes.shape[1] > edge


@pytest.mark.parametrize("mode", sorted(ALL_MODES))
def test_flat_layout_above_threshold_bitwise(dev, mode):
    """Wider than the split layout's threshold the rebuild entry takes
    the flat layout (one walker per thread), in every mode."""
    _check_flat_above_threshold(dev, mode)


@pytest.mark.parametrize("mode", sorted(m for m in ALL_MODES
                                        if "fast" not in m))
def test_flat_layout_bitwise_at_other_rounds(dev, mode):
    """Threefry with 12 rounds (``rng_rounds``: any positive multiple of
    4) in the rebuild entry's flat layout: the copy of its step loop that
    runs the rounds as a loop (20 runs them unrolled), bitwise, in every
    Threefry mode."""
    _check_flat_above_threshold(dev, mode, rounds=12)


@pytest.mark.parametrize("mode", sorted(m for m in ALL_MODES
                                        if "fast" not in m))
def test_split_layout_in_two_waves_bitwise(dev, mode):
    """The split layout past one wave, as the benchmark forces it at the
    widths where the rebuild entry takes the flat one
    (chunk_kernel.split_threshold): just wider than one wave it runs two
    waves, bitwise its plain version, in every Threefry mode."""
    rng_impl, physics, dec = ALL_MODES[mode]
    phys = cuda_engine.chunk_physics(physics(P.Params(
        chunk_steps=1000, near_k=5)).validate(), rng_impl)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bps = chunk_kernel.kernel_info("chunk_kernel", phys, dec, "split",
                                   720).blocks_per_sm
    p = P.Params(chunk_steps=1000, near_k=5,
                 num_water=32 * sms * bps + 100).validate()
    sc = BacteriaBox(p, seed=42).populate()
    planes, tbl, args, dec = _rebuild_case(p, sc, dev, mode, p.num_water)
    run = lambda: chunk_kernel._run_chunk_kernel(
        "chunk_kernel", planes, [tbl], args, dec, tbl.shape[1], "split")
    got, again = run(), run()
    ref = cuda_engine.chunk_reference(planes, tbl, decompose=dec, **args)
    torch.cuda.synchronize()
    _assert_bitwise(got, again, ref, dec)
    lay = chunk_kernel.LAYOUTS[_key("chunk_kernel", mode)]
    assert lay.split and lay.waves == 2


@pytest.fixture(scope="module")
def scaleup_scene(dev):
    """The scale-up scene (100000 waters, 2000 cells, K 10): its Params,
    its initial walkers wrapped on the card, and its scene cache."""
    from mri_nanoparticle_simulation_tpu_torch.benchmark import SCALEUP
    p = P.Params(**SCALEUP).replace(chunk_steps=2000).validate()
    sc = BacteriaBox(p, seed=42).populate()
    tbl = convert.mnp_table(sc.mnps, torch.float32, dev)
    cache = expansion.build_cache(tbl.pos, tbl.m, p)
    planes = cuda_engine.to_soa(init_state(sc.waters, p, dev), p).planes
    planes = torch.cat([cuda_engine._wrap(planes[:3], p.bound), planes[3:]])
    return p, planes, cache


@pytest.fixture(scope="module")
def scaleup(scaleup_scene):
    """The scale-up scene's model at its initial walkers."""
    p, planes, cache = scaleup_scene
    near, taylor, _ = expansion.build_planes(
        planes[:3].contiguous(), p, cache,
        reach2=expansion.coverage_reach2(p))
    return p, planes, near, taylor


def _check_near(p, planes, near, taylor, mode, n):
    """One near-entry chunk of the first ``n`` walkers of ``planes`` in
    ``mode``, twice, against its plain version (``_assert_bitwise``);
    returns the layout it took."""
    rng_impl, physics, dec = ALL_MODES[mode]
    if dec:
        planes = _dec_planes(planes)
    pm = physics(p).validate()
    args = dict(step0=p.chunk_steps, key=KEY, lane_offset=3, num_water=n,
                tcp=p.tcp, cell_r2=cuda_engine.cell_r2_f32(pm.cell_r),
                dstd=1.0, phys=cuda_engine.chunk_physics(pm, rng_impl))
    key = _key("chunk_near_kernel", mode)
    before = chunk_kernel.LAUNCHES[key]
    got = chunk_kernel.run_chunk_near(planes, near, taylor, decompose=dec,
                                      **args)
    again = chunk_kernel.run_chunk_near(planes, near, taylor, decompose=dec,
                                        **args)
    assert chunk_kernel.LAUNCHES[key] == before + 2
    ref = cuda_engine.chunk_near_reference(planes, near, taylor,
                                           decompose=dec, **args)
    torch.cuda.synchronize()
    _assert_bitwise(got, again, ref, dec)
    lay = chunk_kernel.LAYOUTS[key]
    assert not lay.split and lay.blocks == planes.shape[1] // 128
    return lay


@pytest.mark.parametrize("n", [4096, 100000])
@pytest.mark.parametrize("mode", sorted(ALL_MODES))
def test_near_entry_bitwise(scaleup, mode, n):
    """The near entry in every mode on the scale-up scene's model, on its
    first 4096 walkers and at its full width (100096 padded)."""
    p, planes, near, taylor = scaleup
    w = cuda_engine.pad_count(n)
    _check_near(p, planes[:, :w].contiguous(), near[..., :w].contiguous(),
                taylor[:, :w].contiguous(), mode, n)


@pytest.mark.parametrize("k", [1, 5, 10, 16])
@pytest.mark.parametrize("mode", sorted(ALL_MODES))
def test_near_entry_bitwise_at_every_k(scaleup_scene, mode, k):
    """The near entry with 1, 5, 10 and 16 slots on a ragged count, 3000
    of 3072 padded walkers, in every mode; its dynamic shared memory is
    the slots' on Threefry (a float4 each) and none on the fast
    generator (registers)."""
    p, planes, cache = scaleup_scene
    p = p.replace(near_k=k).validate()
    w = cuda_engine.pad_count(3000)
    planes = planes[:, :w].contiguous()
    near, taylor, _ = expansion.build_planes(
        planes[:3].contiguous(), p, cache,
        reach2=expansion.coverage_reach2(p))
    lay = _check_near(p, planes, near, taylor, mode, 3000)
    slots = 0 if "fast" in mode else 16 * k * chunk_kernel.BLOCK
    assert lay.smem == slots and lay.waves == 1


@pytest.mark.parametrize("pfreq", [100, 50, 125])
@pytest.mark.parametrize("mode", sorted(ALL_MODES))
def test_near_entry_bitwise_at_every_pfreq(scaleup_scene, mode, pfreq):
    """Windows of pfreq % 4 == 0, even and odd (the fast generator's
    pairs, and a last single step whose words the next window's first
    pair draws again after it) and a Carr-Purcell flip every window, in
    every mode, on the scale-up's first 1000 walkers (1024 padded)."""
    p, planes, cache = scaleup_scene
    p = p.replace(chunk_steps=2 * pfreq, print_interval=pfreq * p.tau,
                  sprint_steps=4 * pfreq, taucp=pfreq * p.tau,
                  totaltime=4 * pfreq * p.tau).validate()
    assert (p.pfreq, p.tcp) == (pfreq, pfreq)
    w = cuda_engine.pad_count(1000)
    planes = planes[:, :w].contiguous()
    near, taylor, _ = expansion.build_planes(
        planes[:3].contiguous(), p, cache,
        reach2=expansion.coverage_reach2(p))
    _check_near(p, planes, near, taylor, mode, 1000)


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("mode", sorted(m for m in ALL_MODES
                                        if "fast" not in m))
def test_near_entry_bitwise_at_other_rounds(scaleup_scene, mode, k):
    """Threefry with 12 rounds (``rng_rounds``: any positive multiple of
    4): the near entry's copy of its step loop that runs the rounds as a
    loop (20 runs them unrolled), bitwise, in every Threefry mode at K 1
    and 10 on a ragged count, 3000 of 3072 padded walkers."""
    p, planes, cache = scaleup_scene
    p = p.replace(near_k=k, rng_rounds=12).validate()
    w = cuda_engine.pad_count(3000)
    planes = planes[:, :w].contiguous()
    near, taylor, _ = expansion.build_planes(
        planes[:3].contiguous(), p, cache,
        reach2=expansion.coverage_reach2(p))
    assert all(cuda_engine.chunk_physics(physics(p).validate(), rng).rounds
               == 12 for rng, physics, _ in ALL_MODES.values())
    _check_near(p, planes, near, taylor, mode, 3000)


@pytest.mark.parametrize("mode", sorted(ALL_MODES))
def test_near_entry_in_two_waves_bitwise(scaleup_scene, dev, mode):
    """1000 walkers wider than one wave of the kernel (the occupancy
    API's resident blocks on every SM): the scale-up's walkers and a
    copy of their first ones, the model at all of them; two waves,
    bitwise."""
    p, planes, cache = scaleup_scene
    rng_impl, physics, dec = ALL_MODES[mode]
    info = chunk_kernel.kernel_info(
        "chunk_near_kernel",
        cuda_engine.chunk_physics(physics(p).validate(), rng_impl), dec)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = chunk_kernel.BLOCK * sms * info.blocks_per_sm + 1000
    w = cuda_engine.pad_count(n)
    reps = -(-w // planes.shape[1])
    planes = torch.cat([planes] * reps, dim=1)[:, :w].contiguous()
    near, taylor, _ = expansion.build_planes(
        planes[:3].contiguous(), p, cache,
        reach2=expansion.coverage_reach2(p))
    lay = _check_near(p, planes, near, taylor, mode, n)
    assert lay.waves == 2


def test_near_entry_wave_layout_is_one_wave(scaleup):
    """The near entry's default Threefry mode holds its slots in shared
    memory and is compiled for 8 blocks per SM (at most 64 registers): all
    782 blocks of the 100096-walker scale-up at once, with no local
    memory, and the chunk is bitwise its plain version's."""
    p, planes, near, taylor = scaleup
    phys = cuda_engine.chunk_physics(p, cuda_engine.RNG_THREEFRY)
    info = chunk_kernel.kernel_info("chunk_near_kernel", phys)
    assert info.regs <= 64 and info.blocks_per_sm >= 6
    assert info.local_bytes == 0
    assert (info.threads, info.smem) == (128, 16 * p.near_k * 128)
    lay = _check_near(p, planes, near, taylor, "", p.num_water)
    assert (lay.kind, lay.blocks, lay.waves) == ("flat", 782, 1)


def test_near_entry_fast_layout_keeps_its_slots_in_registers(scaleup, dev):
    """The near entry's default fast mode keeps its slots in registers
    (no shared memory) at 4 blocks per SM (at most 128 registers), with
    no local memory: two waves at the scale-up width, which ran faster
    than the one-wave builds (PERF.md section 6), bitwise
    its plain version's."""
    p, planes, near, taylor = scaleup
    phys = cuda_engine.chunk_physics(p, cuda_engine.RNG_HARDWARE)
    info = chunk_kernel.kernel_info("chunk_near_kernel", phys)
    assert info.regs <= 128 and info.blocks_per_sm >= 4
    assert (info.threads, info.smem, info.local_bytes) == (128, 0, 0)
    lay = _check_near(p, planes, near, taylor, "fast", p.num_water)
    assert (lay.kind, lay.blocks) == ("flat", 782)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert lay.waves == -(-782 // (sms * info.blocks_per_sm))


def test_math_check_finds_no_difference(dev):
    """The chunk kernels' sqrt_fast and rsqrt_ftz are bitwise what sqrtf
    and rsqrtf give (and eval_field's inv_r5 with either), over every
    float input each can see (csrc/math_check.cu)."""
    assert set(chunk_kernel.math_check(dev).values()) == {0}


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("k", [5, 10])
@pytest.mark.parametrize("entry", ["chunk_kernel", "chunk_near_kernel"])
def test_variant_mode_calls_no_more_slow_paths(dev, entry, k, fast):
    """The flat rebuild entry and the near entry draw the variants' sphere
    directions and intended kick with sqrt_fast, sincos_fast and rcp_fast
    (math_check's), as the split layout's generator warps do: the variant
    mode's SASS holds no more calls to a general path (CALL.REL.NOINC, an
    IEEE root's or reciprocal's slow path) than the default mode's of the
    same entry, K and generator."""
    calls = {}
    for variants in (False, True):
        name, sass = kernel_sass(
            chunk_kernel,
            f"{entry}ILi{k}ELb{int(fast)}ELb{int(variants)}ELb0E")
        calls[name] = sass.count("CALL.REL.NOINC")
    default, variant = calls.values()
    assert variant <= default, calls

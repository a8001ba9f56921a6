"""The chunk kernels' launch layout, as plain Python (no card needed).

``chunk_kernel.layout`` picks, by width, how a chunk-kernel entry is
launched: the rebuild entry in the split layout (32 walkers a block, each
on two lanes, one in its chain warp and one in its field warp, and
generator warps: four on Threefry, two on the fast generator) up to
``split_threshold`` walkers (a number
of its waves that depends on the generator), else in the flat layout
(one walker per thread, 128 a block), the near entry always flat, its
K near slots in dynamic shared memory (a float4 per slot and thread).
Each kernel's threads, dynamic shared memory and resident blocks per SM
come from the runtime on the card (``KernelInfo``); here they are given
as the H100 build reports them.

The split layout's chunk start selects over consecutive parts of the
table, one per warp of the block, and merges the parts' K-lists;
``expansion.merge_sorted`` is that merge's plain version, held here
bitwise against the serial insertion over the whole table.
"""

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mri_nanoparticle_simulation_tpu_torch.engine import chunk_kernel as ck
from mri_nanoparticle_simulation_tpu_torch.engine import cuda_engine
from mri_nanoparticle_simulation_tpu_torch.fields import expansion

SMS = 132
#: dynamic shared memory of a split block at the headline on Threefry (a
#: 720-entry table, the ring, the far parts, the K-lists at K 5 and the
#: hand-off): two fit an SM
SPLIT_SMEM = 94336
#: threads of a split block on Threefry: two walker warps (a chain warp
#: and a field warp, two lanes a walker) and four generator warps
SPLIT_THREADS = 192


def _near_info(bps=6, k=10):
    """The near entry's kernel as the runtime reports it: its K slots'
    dynamic shared memory, float4 [K][128]."""
    return {"flat": ck.KernelInfo(80, bps, 16 * k * ck.BLOCK, ck.BLOCK)}


def _infos(split_bps=2, flat_bps=6, split_threads=SPLIT_THREADS):
    """The rebuild entry's two kernels as the runtime reports them: the
    split one with its dynamic table and ring, the flat one with its
    static table."""
    return {"split": ck.KernelInfo(104, split_bps, SPLIT_SMEM, split_threads),
            "flat": ck.KernelInfo(74, flat_bps, 0, ck.BLOCK)}


@pytest.mark.parametrize("fast_rng", [False, True])
@pytest.mark.parametrize("num_water", [50, 4032, 4096])
def test_rebuild_entry_spreads_small_widths_over_the_card(num_water,
                                                          fast_rng):
    w_pad = cuda_engine.pad_count(num_water)
    lay = ck.layout("chunk_kernel", w_pad, SMS, _infos(), fast_rng)
    assert lay.split
    assert lay.blocks == w_pad // 32 and lay.threads == SPLIT_THREADS
    assert lay.gen_warps == 4
    assert lay.smem == SPLIT_SMEM
    assert lay.waves == 1
    if num_water >= 4032:
        assert lay.blocks >= 120          # on at least 120 SMs


def test_headline_is_128_blocks_against_32_flat():
    infos = _infos()
    split = ck.layout("chunk_kernel", 4096, SMS, infos)
    assert (split.blocks, split.blocks_per_sm) == (128, 2)
    flat = ck.layout("chunk_near_kernel", 4096, SMS, _near_info())
    assert flat.blocks == 32 and not flat.split


@pytest.mark.parametrize("fast_rng", [False, True])
def test_rebuild_entry_is_flat_at_the_scale_up_width(fast_rng):
    lay = ck.layout("chunk_kernel", 100096, SMS, _infos(), fast_rng)
    assert not lay.split
    assert (lay.blocks, lay.threads, lay.gen_warps, lay.smem) == (
        782, 128, 0, 0)
    assert lay.waves == 1                 # 6 resident: 792 slots


@pytest.mark.parametrize("fast_rng", [False, True])
@pytest.mark.parametrize("sms", [100, 132])
@pytest.mark.parametrize("split_bps", [1, 2, 3, 4])
def test_threshold_both_sides(sms, split_bps, fast_rng):
    infos = _infos(split_bps)
    waves = ck.SPLIT_WAVES[fast_rng]
    edge = ck.split_threshold(sms, infos, fast_rng)
    assert edge == 32 * sms * split_bps * waves and edge % ck.BLOCK == 0
    below = ck.layout("chunk_kernel", edge, sms, infos, fast_rng)
    above = ck.layout("chunk_kernel", edge + ck.BLOCK, sms, infos,
                      fast_rng)
    assert below.split and below.waves == waves
    assert below.blocks == sms * split_bps * waves
    assert not above.split and above.threads == ck.BLOCK


def test_split_threshold_follows_the_occupancy():
    assert ck.SPLIT_WAVES == {False: 1, True: 1}
    assert ck.split_threshold(132, _infos(1), True) == 4224
    assert ck.split_threshold(132, _infos(2), True) == 8448
    assert ck.split_threshold(100, _infos(4), True) == 12800
    assert ck.split_threshold(132, _infos(2), False) == 8448


@pytest.mark.parametrize("fast_rng", [False, True])
@pytest.mark.parametrize("w_pad, kind, waves", [
    (4096, "split", 1), (4352, "split", 1), (8448, "split", 1),
    (8576, "flat", 1), (12800, "flat", 1), (16896, "flat", 1),
    (17024, "flat", 1), (25472, "flat", 1)])
def test_threshold_at_the_measured_widths(fast_rng, w_pad, kind, waves):
    """The widths timed on the H100 (132 SMs, 2 split blocks per SM, 6
    flat ones): both generators keep the split layout within one wave
    (8448 walkers) and take the flat one above it."""
    lay = ck.layout("chunk_kernel", w_pad, SMS, _infos(), fast_rng)
    assert (lay.kind, lay.waves) == (kind, waves)


@pytest.mark.parametrize("bps, waves", [(6, 1), (5, 2), (4, 2), (1, 6)])
def test_near_entry_waves_at_the_scale_up_width(bps, waves):
    """100096 walkers are 782 blocks: one wave needs 6 resident per SM
    (at most 80 registers a thread and 20 KB of slots a block)."""
    lay = ck.layout("chunk_near_kernel", 100096, SMS, _near_info(bps))
    assert (lay.blocks, lay.split, lay.waves) == (782, False, waves)
    assert lay.smem == 20480


def test_near_entry_is_flat_at_every_width():
    for w_pad in (128, 4096, 100096):
        lay = ck.layout("chunk_near_kernel", w_pad, SMS, _near_info(4))
        assert lay.kind == "flat" and not lay.split
        assert lay.blocks == w_pad // 128 and lay.blocks_per_sm == 4
        assert (lay.gen_warps, lay.smem) == (0, 20480)


@pytest.mark.parametrize("k, bps, waves", [(1, 16, 1), (5, 8, 1),
                                           (10, 6, 1), (16, 5, 2)])
def test_near_entry_takes_its_shared_memory_from_the_runtime(k, bps,
                                                             waves):
    """The near block's dynamic shared memory (its K slots) and its
    residency are the runtime's answer, not a copy kept here: the layout
    carries them, and the waves at the scale-up width follow."""
    info = _near_info(bps, k)
    lay = ck.layout("chunk_near_kernel", 100096, SMS, info)
    assert (lay.smem, lay.blocks_per_sm) == (info["flat"].smem, bps)
    assert lay.waves == waves


@pytest.mark.parametrize("threads, gen_warps", [(96, 1), (128, 2),
                                                (160, 3), (256, 6)])
def test_generator_warps_are_the_threads_the_runtime_reports(threads,
                                                             gen_warps):
    """Two walker warps a block, each with a lane of every walker; every
    other warp the kernel launches with is a generator warp."""
    lay = ck.layout("chunk_kernel", 4096, SMS,
                    _infos(split_threads=threads))
    assert lay.split and (lay.threads, lay.gen_warps) == (threads, gen_warps)
    assert lay.threads == 32 * (ck.WALKER_WARPS + lay.gen_warps)
    assert lay.blocks == 128


@pytest.mark.parametrize("fast_rng, threads, gen_warps", [(False, 192, 4),
                                                          (True, 128, 2)])
def test_split_layout_at_the_headline_width(fast_rng, threads, gen_warps):
    """At the headline (4032 walkers, 4096 padded, K 5) the split layout
    is 128 blocks of 32 walkers, each block a chain warp, a field warp and
    the generator warps: four on Threefry (192 threads), two on the fast
    generator (128 threads, a scheduler for each warp)."""
    lay = ck.layout("chunk_kernel", 4096, SMS,
                    _infos(split_threads=threads), fast_rng)
    assert (lay.kind, lay.blocks, lay.threads,
            lay.gen_warps) == ("split", 128, threads, gen_warps)
    assert (lay.blocks_per_sm, lay.waves) == (2, 1)


@pytest.mark.parametrize("kind, w_pad, blocks, waves", [
    ("flat", 4096, 32, 1), ("split", 100096, 3128, 12),
    ("split", 8576, 268, 2), ("flat", 8448, 66, 1)])
def test_forced_layout_counts_its_waves(kind, w_pad, blocks, waves):
    """A forced layout (the benchmark times both sides of the threshold)
    has the blocks of its walkers per block and the waves of its
    kernel's residency."""
    lay = ck.layout("chunk_kernel", w_pad, SMS, _infos(), kind=kind)
    assert (lay.kind, lay.blocks, lay.waves) == (kind, blocks, waves)


def test_unknown_entry_raises():
    with pytest.raises(ValueError):
        ck.layout("chunk_split_kernel", 4096, SMS, _infos())


# -- the split chunk start's exact merge --------------------------------------

def _serial(d2, k):
    """expansion.sorted_insert over table rows ``d2`` [n, W] in order:
    (d2s, ids) [K, W]."""
    w = d2.shape[1]
    d2s = torch.full((k, w), 1e30)
    fields = torch.zeros((1, k, w))
    ids = torch.full((k, w), -1, dtype=torch.int64)
    for j in range(d2.shape[0]):
        d2s, fields, ids = expansion.sorted_insert(
            d2s, fields, ids, d2[j], torch.zeros((1, w)), j)
    return d2s, ids


def _split_then_merge(d2, k, parts):
    """The kernel's chunk start: each of ``parts`` warps (a split block's:
    six on Threefry, four on the fast generator) inserts over a
    consecutive ceil(n / parts) rows; the lists are merged."""
    n = d2.shape[0]
    q = -(-n // parts)
    lists = []
    for p in range(parts):
        rows = d2[p * q:min(n, (p + 1) * q)]
        d2s, ids = _serial(rows, k)
        lists.append((d2s, torch.where(ids >= 0, ids + p * q, ids)))
    return expansion.merge_sorted(torch.stack([a for a, _ in lists]),
                                  torch.stack([b for _, b in lists]))


@settings(max_examples=200, deadline=None)
@given(data=st.data(), k=st.integers(1, 8), n=st.integers(1, 40),
       walkers=st.integers(1, 3), parts=st.sampled_from([4, 6]))
def test_split_selection_merges_to_the_serial_insertion(data, k, n,
                                                        walkers, parts):
    """Distances drawn from a few values, so ties and duplicates are
    common: the merge of the parts' lists (one per warp of a split block,
    four or six) is bitwise the serial insertion over the whole table,
    distances and ids."""
    n = max(n, k)      # the kernels take n_pad >= K
    values = data.draw(st.lists(st.sampled_from(
        [0.0, 0.25, 1.0, 1.0 + 2 ** -20, 2.0, 3e12]), min_size=n * walkers,
        max_size=n * walkers))
    d2 = torch.tensor(values, dtype=torch.float32).reshape(n, walkers)
    want = _serial(d2, k)
    got = _split_then_merge(d2, k, parts)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_merge_takes_the_lower_part_on_ties():
    d2s = torch.tensor([[[1.0], [2.0]], [[1.0], [1.5]]])
    ids = torch.tensor([[[3], [4]], [[0], [1]]])
    got_d2, got_ids = expansion.merge_sorted(d2s, ids)
    assert got_d2.flatten().tolist() == [1.0, 1.0]
    assert got_ids.flatten().tolist() == [3, 0]

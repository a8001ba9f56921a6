"""The plane fold's kernel (csrc/plane_fold_kernel.cu, the card's path of
``decompose.make_plane_step``) against its twin, the plain torch body of
``make_plane_step`` run on the same record moved to the CPU.

On the CPU (no card): the wrapper ``chunk_kernel.run_plane_fold`` raises
on what the kernel does not take before it loads the library, a CPU
record takes the twin and launches nothing, and the kernel's arithmetic
for the carry (window order, prefix sums added in double as the CPU's
``torch.cumsum`` adds float32) reproduces the twin's carry bit for bit.

On the card (marked ``cuda``; skipped from a fixture where torch sees no
card), at the headline cell's shapes (4032 of 4096 walkers, 4 moment
scales, the echo spacings 0.05, 0.1, 0.25 and 0.5 ms, 20 windows a
sprint, a Carr-Purcell undo and parity changes inside the sprints), with
two echo specs one of them on an echo-only lane, on a width that is not
a whole tile and on an unpadded scan-engine record, three sprints
chained through the carry: the carry bitwise the twin's, the curve block
and the echo rows within 1e-6, two runs on the same inputs bitwise
equal.  ``run_plane_on_device`` on the card counts one launch a sprint
and its curves lie within 1e-5 (the headline-plane cell's curve_gap) of
the twin's fold of the same records.
"""

import numpy as np
import pytest
import torch

from mri_nanoparticle_simulation_tpu_torch import params as P
from mri_nanoparticle_simulation_tpu_torch.engine import chunk_kernel
from mri_nanoparticle_simulation_tpu_torch.engine import decompose as dec
from mri_nanoparticle_simulation_tpu_torch.scene import BacteriaBox

STEP_TOL = 1e-6     # block and echo rows: float32 rounding of the sums
CURVE_TOL = 1e-5    # port_bench/cells/headline-plane.json curve_gap
PFREQ = 1000        # steps a window at the headline
BASE_TCP = 250_000  # the base run's taucp, 0.25 ms at 1e-6 ms a step
CELL_TCPS = (50_000, 100_000, 250_000, 500_000)   # 0.05 ... 0.5 ms
CELL_SCALES = (0.5, 1.0, 2.0, 4.0)
WPS = 20
FIRST = 11          # sprints 11-13: rows 220-279 hold the undo at row 250


def _record(n_rows, w, w_pad, seed):
    """A seeded record [n_rows, 2, w_pad]: A drifting by 0.5 rad a window
    (tens of radians by row 200), B by 0.1; padding walkers garbage."""
    g = np.random.default_rng(seed)
    rec = np.cumsum(g.normal(0.0, 1.0, (n_rows, 2, w_pad))
                    * np.array([0.5, 0.1])[:, None], 0).astype(np.float32)
    rec[:, :, w:] = 1e3
    return rec


def _tables(n_rows, tcps):
    """(u_prev [n], g [T, n]) as run_plane_on_device builds them."""
    j = np.arange(1, n_rows + 1, dtype=np.int64)
    undo = np.where((j * PFREQ) % BASE_TCP == 0, -1.0, 1.0)
    u = np.concatenate([[1.0], undo[:-1]]).astype(np.float32)
    g = np.stack([dec._flip_parity(n_rows, t, PFREQ) for t in tcps])
    return u, g.astype(np.float32)


def _zero_carry(t, w, dev="cpu"):
    return (torch.zeros((t, w), device=dev),) * 4 \
        + (torch.zeros(w, device=dev),) * 2


def _inputs(w, w_pad, tcps, seed=21):
    n_rows = (FIRST + 3) * WPS
    rec = _record(n_rows, w, w_pad, seed)
    u, g = _tables(n_rows, tcps)
    return torch.from_numpy(rec), torch.from_numpy(u), torch.from_numpy(g)


# -- on the CPU ---------------------------------------------------------------

def _wrapper_args(**over):
    w, t = 100, 2
    args = dict(wins=torch.zeros((WPS, 2, 128)),
                carry=_zero_carry(t, w), u_prev=torch.ones(WPS),
                g_blk=torch.ones((t, WPS)), scales=torch.ones(3),
                num_water=w, echo=None)
    args.update(over)
    return args


BAD = {
    "wins_dtype": (dict(wins=torch.zeros((WPS, 2, 128), dtype=torch.float64)),
                   TypeError, "wins must be torch.float32"),
    "carry_dtype": (dict(carry=(torch.zeros((2, 100), dtype=torch.float64),)
                         * 4 + (torch.zeros(100),) * 2),
                    TypeError, "SA must be torch.float32"),
    "narrow_record": (dict(wins=torch.zeros((WPS, 2, 64))), ValueError,
                      "cannot hold 100 walkers"),
    "u_prev_length": (dict(u_prev=torch.ones(WPS - 1)), ValueError,
                      r"u_prev must be \[20\]"),
    "g_blk_length": (dict(g_blk=torch.ones((2, WPS + 1))), ValueError,
                     r"g_blk must be \[2, 20\]"),
    "g_blk_lanes": (dict(g_blk=torch.ones((3, WPS))), ValueError,
                    r"g_blk must be \[2, 20\]"),
    "echo_rows_dtype": (dict(echo=(torch.zeros((2, 3), dtype=torch.int32),
                                   torch.zeros(2, dtype=torch.int64),
                                   torch.ones(2))),
                        TypeError, "echo rows must be torch.int64"),
    "cpu_record": ({}, ValueError, "no plane-fold kernel for device cpu"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_raises_before_loading(case, monkeypatch):
    """Each check raises before the library is built or loaded (a CPU
    record that passes them all is refused: it takes the twin)."""
    def no_load():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(chunk_kernel, "load_library", no_load)
    over, exc, match = BAD[case]
    with pytest.raises(exc, match=match):
        chunk_kernel.run_plane_fold(**_wrapper_args(**over))


def test_echo_lane_outside_the_plane_raises():
    with pytest.raises(ValueError, match="outside"):
        dec.make_plane_step(P.small_test_params(), 10, [1.0], 2, ((1.0, 2),),
                            device="cpu")


def _carry_as_kernel(rec, carry, u, g):
    """The kernel's carry arithmetic in numpy, walker by walker in
    float32, the prefix sums added in window order in float64."""
    f = np.float32
    sa, ca, sb, cb, pa, pb = (c.numpy() for c in carry)
    rec, u, g = rec.numpy(), u.numpy(), g.numpy()
    w = sa.shape[1]
    x = rec[:, :, :w]
    out = [np.empty_like(sa) for _ in range(4)]
    for t in range(g.shape[0]):
        acc_a = np.zeros(w, np.float64)
        acc_b = np.zeros(w, np.float64)
        qa, qb = pa, pb
        for j in range(rec.shape[0]):
            da = x[j, 0] - u[j] * qa
            db = x[j, 1] - u[j] * qb
            acc_a = acc_a + (g[t, j] * da).astype(np.float64)
            acc_b = acc_b + (g[t, j] * db).astype(np.float64)
            qa, qb = x[j, 0], x[j, 1]
        c_a, c_b = acc_a.astype(f), acc_b.astype(f)
        ya, yb = c_a - ca[t], c_b - cb[t]
        ta, tb = sa[t] + ya, sb[t] + yb
        out[0][t], out[1][t] = ta, (ta - sa[t]) - ya
        out[2][t], out[3][t] = tb, (tb - sb[t]) - yb
    return (*out, x[-1, 0], x[-1, 1])


def test_kernel_carry_arithmetic_is_the_twins():
    """The kernel's order of operations for the carry, three sprints at
    the cell's spacings: bitwise the twin's carry (the CPU's cumsum of
    float32 adds in float64 and rounds each prefix)."""
    w, t = 300, len(CELL_TCPS)
    rec, u, g = _inputs(w, 384, CELL_TCPS)
    step = dec.make_plane_step(P.small_test_params(), w, CELL_SCALES, t,
                               device="cpu")
    carry = _zero_carry(t, w)
    for i in range(FIRST, FIRST + 3):
        sl = slice(i * WPS, (i + 1) * WPS)
        want = _carry_as_kernel(rec[sl], carry, u[sl], g[:, sl])
        carry, _ = step(rec[sl], carry, u[sl], g[:, sl])
        for a, b in zip(carry, want):
            np.testing.assert_array_equal(a.numpy(), b)
    assert torch.any(carry[1] != 0)         # the compensation is live


def test_cpu_record_takes_the_twin():
    """run_plane_on_device on the CPU launches no kernel."""
    p = P.small_test_params(num_water=32, mmoment=2e-14,
                            avoid_intracellular_throw=False)
    sc = BacteriaBox(p, seed=3).populate()
    before = chunk_kernel.LAUNCHES["plane_fold_kernel"]
    _, curves, st, echoes = dec.run_plane_on_device(
        sc, p, [0.5, 1.0], [0.0005, 0.001], seed=5, device="cpu",
        echo_pairs=[(1.0, 0.0002)])
    assert chunk_kernel.LAUNCHES["plane_fold_kernel"] == before
    assert st["sprints"] == p.t // p.sprint_steps
    assert np.isfinite(curves).all() and len(echoes) == 1


# -- on the card --------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible to torch")
    chunk_kernel.load_library()
    return torch.device("cuda", 0)


#: name -> (W, W_pad, echo spacings in steps, echo specs, echo rows)
FOLDS = {
    "cell": (4032, 4096, CELL_TCPS, (), None),
    "cell_echo": (4032, 4096, CELL_TCPS + (30_000,),
                  ((1.5, 1), (0.7, 4)), [[3, 19, 0], [0, 7, 12]]),
    "ragged_tile": (100, 128, CELL_TCPS[:2], ((2.0, 0),), [[5, 0]]),
    "scan_unpadded": (4032, 4032, CELL_TCPS, ((1.0, 2),), [[0, 10, 19]]),
}


def _fold_on_both(dev, name, scales=CELL_SCALES):
    """Three sprints of the kernel and of the twin, each chained through
    its own carry; yields (kernel out, twin out) a sprint."""
    w, w_pad, tcps, specs, rows = FOLDS[name]
    t = len(tcps)
    rec, u, g = _inputs(w, w_pad, tcps)
    rows = torch.tensor(rows or [[0]], dtype=torch.int64)
    p = P.small_test_params()
    twin = dec.make_plane_step(p, w, scales, t, specs, device="cpu")
    card = dec.make_plane_step(p, w, scales, t, specs, device=dev)
    rec_d, u_d, g_d, rows_d = (x.to(dev) for x in (rec, u, g, rows))
    ct, ck = _zero_carry(t, w), _zero_carry(t, w, dev)
    for i in range(FIRST, FIRST + 3):
        sl = slice(i * WPS, (i + 1) * WPS)
        before = chunk_kernel.LAUNCHES["plane_fold_kernel"]
        ok = card(rec_d[sl], ck, u_d[sl], g_d[:, sl], rows_d)
        torch.cuda.synchronize(dev)
        assert chunk_kernel.LAUNCHES["plane_fold_kernel"] == before + 1
        ot = twin(rec[sl], ct, u[sl], g[:, sl], rows)
        assert len(ok) == len(ot) == (3 if specs else 2)
        yield ok, ot, (rec_d[sl], ck, u_d[sl], g_d[:, sl], rows_d), card
        ck, ct = ok[0], ot[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FOLDS))
def test_fold_kernel_matches_twin(dev, name):
    """Carry bitwise, block and echo rows within 1e-6, three sprints."""
    for ok, ot, _, _ in _fold_on_both(dev, name):
        for a, b in zip(ok[0], ot[0]):
            assert a.device.type == "cuda"
            assert torch.equal(a.cpu(), b)
        assert ok[1].shape == ot[1].shape
        torch.testing.assert_close(ok[1].cpu(), ot[1], rtol=0, atol=STEP_TOL)
        if len(ok) == 3:
            assert ok[2].shape == ot[2].shape
            torch.testing.assert_close(ok[2].cpu(), ot[2], rtol=0,
                                       atol=STEP_TOL)


@pytest.mark.cuda
def test_fold_kernel_after_an_occupancy_query(dev):
    """An occupancy query at fewer echo rows than a later launch takes
    (its shared memory is smaller) leaves the kernel launchable."""
    info = chunk_kernel.plane_fold_info(len(CELL_SCALES), WPS, 0, dev)
    assert info.threads == 128 * len(CELL_SCALES) and info.local_bytes == 0
    for ok, ot, _, _ in _fold_on_both(dev, "cell_echo"):
        torch.testing.assert_close(ok[2].cpu(), ot[2], rtol=0, atol=STEP_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cell_echo", "ragged_tile"])
def test_fold_kernel_is_deterministic(dev, name):
    """Two launches on the same inputs give the same bits."""
    for ok, _, args, card in _fold_on_both(dev, name):
        again = card(*args)
        for a, b in zip(ok, again):
            if isinstance(a, tuple):
                assert all(torch.equal(x, y) for x, y in zip(a, b))
            else:
                assert torch.equal(a, b)


@pytest.mark.cuda
def test_fold_kernel_carry_is_new_every_sprint(dev):
    """The carry is six views of a new tensor each sprint: the carry a
    step was handed is never written."""
    seen = []
    for ok, _, args, _ in _fold_on_both(dev, "ragged_tile"):
        seen.append((args[1], tuple(c.clone() for c in args[1]), ok[0]))
    for carry, copy, _ in seen:
        assert all(torch.equal(a, b) for a, b in zip(carry, copy))
    stores = [{c.untyped_storage().data_ptr() for c in out}
              for _, _, out in seen]
    assert all(len(s) == 1 for s in stores)
    assert len(set.union(*stores)) == len(seen)


@pytest.mark.cuda
def test_plane_on_card_counts_and_matches_twin(dev, monkeypatch):
    """run_plane_on_device on the card: one fold launch a sprint; curves
    and echo captures within 1e-5 of the twin folding the same records
    (the chunk kernels are deterministic, so both runs walk alike)."""
    p = P.small_test_params(num_water=64, mmoment=2e-14,
                            avoid_intracellular_throw=False)
    sc = BacteriaBox(p, seed=3).populate()
    kw = dict(seed=5, device=dev, echo_pairs=[(1.0, 0.0005),
                                              (1.5, 0.0002)])
    scales, taucps = [0.5, 1.0, 2.0], [0.0005, 0.001]
    before = chunk_kernel.LAUNCHES["plane_fold_kernel"]
    _, curves, st, echoes = dec.run_plane_on_device(sc, p, scales, taucps,
                                                    **kw)
    assert chunk_kernel.LAUNCHES["plane_fold_kernel"] - before \
        == st["sprints"] == p.t // p.sprint_steps
    orig = dec.make_plane_step

    def on_cpu(*args, device=None, **kws):
        twin = orig(*args, device="cpu", **kws)

        def step(wins, carry, *rest):
            out = twin(wins.cpu(), tuple(c.cpu() for c in carry),
                       *(None if r is None else r.cpu() for r in rest))
            return (tuple(c.to(dev) for c in out[0]),
                    *(o.to(dev) for o in out[1:]))
        return step
    monkeypatch.setattr(dec, "make_plane_step", on_cpu)
    before = chunk_kernel.LAUNCHES["plane_fold_kernel"]
    _, want, _, want_e = dec.run_plane_on_device(sc, p, scales, taucps, **kw)
    assert chunk_kernel.LAUNCHES["plane_fold_kernel"] == before
    assert float(np.abs(curves - want).max()) <= CURVE_TOL
    for a, b in zip(echoes, want_e):
        assert float(np.abs(a.cos - b.cos).max()) <= CURVE_TOL

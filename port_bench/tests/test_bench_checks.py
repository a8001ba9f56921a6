"""The output check, driven through the harness on the CPU at a size a
test holds (the card's look skipped; the program runs its plain twins):
a sound run comes out correct, the bfloat16 control in the program's
place does not, and neither does a run with the timed path broken
underneath: a chunk that hands its state back unchanged, half of the
walkers left out of the sums (the rest counted twice, as a mean over
them), an answer altered where it is produced, and a loop that carries
a stale state: a chunk fed the previous chunk's input, a step counter
repeated, a plane fold handed a zeroed carry or the previous sprint's
record."""

import time

import pytest
import torch

from port_bench import run

from . import tiny

SEED = 3_000_000_123


def _run(ctx, control=None):
    return run.run_cell(ctx, 0.5, False, time.perf_counter(),
                        control_dtype=control)


def _failed(res):
    return [k for k, c in res["checks"].items() if c["value"] > c["limit"]]


CELLS = ["headline-fast", "scaleup-fast", "headline-plane"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(cell, monkeypatch):
    res = _run(tiny.context(cell, SEED, monkeypatch),
               torch.bfloat16)
    assert res["correct"], res["checks"]
    assert res["metrics"]["walker_steps_per_s"]["value"] > 0
    assert set(res["metrics"]) == {"walker_steps_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    limits = res["checks"]
    ctl = res["notes"]["control"]
    assert [k for k in ctl if ctl[k] > limits[k]["limit"]], ctl


def _chunk_fault(monkeypatch, kind):
    from mri_nanoparticle_simulation_tpu_torch.engine import chunk_kernel

    def broken(fn):
        last = {}

        def call(state, *a, **kw):
            if kind == "stale":
                state, last["state"] = last.get("state", state), state
            if kind == "counter":
                kw["step0"], last["step0"] = (last.get("step0", kw["step0"]),
                                              kw["step0"])
            out, esc, cov, wins = fn(state, *a, **kw)
            if kind == "unchanged":
                return state, esc, cov, wins
            if kind == "half" and wins.dim() == 3 and wins.shape[-1] == 2:
                half = wins.shape[0] // 2       # warp sums
                wins = torch.cat([2 * wins[:half], 0 * wins[half:]])
            return out, esc, cov, wins
        return call
    for name in ("run_chunk", "run_chunk_near"):
        monkeypatch.setattr(chunk_kernel, name,
                            broken(getattr(chunk_kernel, name)))


def _row_fault(monkeypatch):
    from mri_nanoparticle_simulation_tpu_torch.io import writer
    orig = writer.T2CsvWriter.append_windows

    def altered(self, first, wins):
        wins = wins.copy()
        wins[0, 0] += 1.0       # one walker's cos counted twice
        return orig(self, first, wins)
    monkeypatch.setattr(writer.T2CsvWriter, "append_windows", altered)


def _plane_fault(monkeypatch, kind):
    from mri_nanoparticle_simulation_tpu_torch.engine import decompose
    orig = decompose.make_plane_step

    def make(params, num_water, *a, **kw):
        step = orig(params, num_water, *a, **kw)
        last = {}

        def call(wins, carry, *rest):
            if kind == "half":
                half = num_water // 2
                wins = wins.clone()
                wins[..., half:2 * half] = wins[..., :half]
                return step(wins, carry, *rest)
            if kind == "carry":
                return step(wins, tuple(torch.zeros_like(c) for c in carry),
                            *rest)
            if kind == "record":
                wins, last["wins"] = last.get("wins", wins), wins
                return step(wins, carry, *rest)
            carry, blk, *more = step(wins, carry, *rest)
            blk = blk.clone()
            blk[0, 0, 0, 0] += 1.0 / num_water
            return (carry, blk, *more)
        return call
    monkeypatch.setattr(decompose, "make_plane_step", make)


@pytest.mark.parametrize("cell,fault", [
    ("headline-fast", "unchanged"), ("headline-fast", "half"),
    ("headline-fast", "row"),
    ("scaleup-fast", "unchanged"), ("scaleup-fast", "half"),
    ("headline-plane", "unchanged"), ("headline-plane", "half"),
    ("headline-plane", "row"),
    ("headline-fast", "stale"), ("headline-fast", "counter"),
    ("scaleup-fast", "stale"), ("scaleup-fast", "counter"),
    ("headline-plane", "stale"), ("headline-plane", "carry"),
    ("headline-plane", "record")])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    ctx = tiny.context(cell, SEED, monkeypatch)
    plane = cell.endswith("plane")
    if fault in ("unchanged", "stale", "counter") or (
            fault == "half" and not plane):
        _chunk_fault(monkeypatch, fault)
    elif plane:
        _plane_fault(monkeypatch, fault)
    else:
        _row_fault(monkeypatch)
    res = _run(ctx)
    assert not res["correct"] and _failed(res), res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["headline-fast", "headline-plane",
                                  "scaleup-fast", "scaleup-threefry"])
def test_control_fails_at_the_cells_own_size(cell, card):
    """On the card at the cell's own size: the program passes its limits
    and the bfloat16 control fails one."""
    from port_bench import control
    ctx = run.context(cell, SEED, "cuda")
    out = control.readings(ctx, [SEED], 2.0)
    limits = ctx.cell["limits"]
    assert all(out["lower"][k] <= limits[k] for k in limits)
    assert any(out["upper"][k] > limits[k] for k in limits)

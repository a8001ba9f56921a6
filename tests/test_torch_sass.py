"""How ``benchmark.innermost_loop`` reads a kernel's SASS (no card
needed): the innermost loop holding a MUFU.RSQ is a backward branch and
the instructions from its target to it, each counted once as written,
with the loops nested in it listed by size, and every such loop where a
kernel holds several copies; asked for other opcodes, the innermost loop
that holds each of them and none of those it is to be without.
``chip_smoke`` prints the near entry's step loop, the split kernel's
chain and field warps' step loops and the far sums' pair loop this way
(``benchmark.sass_loop`` feeds it ``cuobjdump -sass``), and
``benchmark.step_loops`` counts the split kernel's walker loops a step in
either physics."""

import re
from pathlib import Path

import pytest

from mri_nanoparticle_simulation_tpu_torch import benchmark
from mri_nanoparticle_simulation_tpu_torch.benchmark import (CHAIN_LOOP,
                                                         FIELD_LOOP,
                                                         hand_fields,
                                                         innermost_loop,
                                                         step_loops)


def _sass(lines):
    """SASS text in cuobjdump's layout, one instruction each 16 bytes."""
    return "\n".join(f"        /*{16 * i:04x}*/                   {op} ;"
                     for i, op in enumerate(lines))


#: a step loop (0x10-0x70) holding an inner loop without an rsqrt
#: (0x30-0x50), as the near entry's Threefry rounds were before they were
#: unrolled
NESTED = ["MOV R1, c[0x0][0x28]", "FADD R2, R2, R3", "MUFU.RSQ R4, R2",
          "IADD3 R5, R5, 0x1, RZ", "@P0 BRA 0x30", "FMUL R2, R2, R4",
          "MUFU.RSQ R6, R2", "@P1 BRA 0x10", "EXIT"]
#: two loops with an rsqrt: the smaller one is the innermost
TWO = ["MUFU.RSQ R4, R2", "FADD R2, R2, R4", "@P0 BRA 0x0",
       "MUFU.RSQ R5, R3", "FMUL R3, R3, R5", "FADD R3, R3, R1",
       "FADD R3, R3, R1", "@P1 BRA 0x30", "EXIT"]


#: two copies of a step loop inside one window loop, as the near
#: entry's Threefry kernel holds them (0x10-0x40 with its rounds as an
#: inner loop, 0x50-0x90 with them unrolled, the larger)
COPIES = ["MOV R1, R1", "MUFU.RSQ R4, R2", "IADD3 R5, R5, 0x1, RZ",
          "@P0 BRA 0x20", "@P1 BRA 0x10", "MUFU.RSQ R4, R2",
          "IADD3 R5, R5, 0x1, RZ", "IADD3 R5, R5, 0x1, RZ",
          "IADD3 R5, R5, 0x1, RZ", "@P1 BRA 0x50", "@P2 BRA 0x0", "EXIT"]


def _loop(n, rsqrt, inner):
    return {"instructions": n, "rsqrt": rsqrt, "inner": inner}


@pytest.mark.parametrize("lines, want, copies", [
    (NESTED, _loop(7, 2, [2]), None),
    (TWO, _loop(3, 1, []), [_loop(3, 1, []), _loop(5, 1, [])]),
    (["BRA 0x10", "MUFU.RSQ R1, R1", "@P0 BRA 0x10", "EXIT"],
     _loop(2, 1, []), None),
    (COPIES, _loop(4, 1, [2]), [_loop(4, 1, [2]), _loop(5, 1, [])]),
])
def test_innermost_rsqrt_loop(lines, want, copies):
    got = innermost_loop(_sass(lines))
    assert got == {**want, "copies": copies or [want]}


@pytest.mark.parametrize("lines", [
    ["MUFU.RSQ R1, R1", "FADD R1, R1, R1", "EXIT"],         # no loop
    ["FADD R1, R1, R1", "@P0 BRA 0x0", "MUFU.RSQ R1, R1"],  # rsqrt outside
    ["BRA 0x20", "MUFU.RSQ R1, R1", "EXIT"],                # forward branch
])
def test_no_rsqrt_loop_raises(lines):
    with pytest.raises(ValueError, match="no loop with a MUFU.RSQ"):
        innermost_loop(_sass(lines))


#: a split kernel: a generator's draw loop (0x00-0x30: an rsqrt and
#: stores, no loads), the far parts' loop (0x40-0x70: loads, an rsqrt,
#: stores), the chain warp's step loop (0x80-0xc0: ring loads, hand-off
#: stores, no rsqrt), its window loop around it (to 0xd0) and the field
#: warp's step loop (0xe0-0x110: hand-off loads and an rsqrt, no stores)
SPLIT = ["MUFU.RSQ R4, R2", "STS [R3], R2", "STS [R3+0x80], R4",
         "@P0 BRA 0x0", "LDS R6, [R7]", "MUFU.RSQ R6, R6", "STS [R3], R6",
         "@P1 BRA 0x40", "LDS R8, [R9]", "FADD R2, R2, R8", "STS [R5], R2",
         "STS [R5+0x80], R2", "@P2 BRA 0x80", "@P3 BRA 0x80",
         "LDS R6, [R5]", "MUFU.RSQ R7, R6", "FADD R1, R1, R7",
         "@P4 BRA 0xe0", "EXIT"]


def test_walker_loops_of_the_split_kernel():
    """The chain and field warps' step loops by what they hold and what
    they do not: neither the generator's loop (no loads) nor the far
    parts' (an rsqrt and stores) is taken, nor the chain warp's window
    loop around its step loop; asked for a MUFU.RSQ alone, the smallest
    loop holding one is the generator's."""
    chain = innermost_loop(_sass(SPLIT), **CHAIN_LOOP)
    assert (chain["instructions"], chain["rsqrt"], chain["inner"]) == (5, 0,
                                                                       [])
    assert chain["counts"] == {"STS": 2, "LDS": 1}
    assert len(chain["copies"]) == 1
    field = innermost_loop(_sass(SPLIT), **FIELD_LOOP)
    assert (field["instructions"], field["rsqrt"]) == (4, 1)
    assert field["counts"] == {"MUFU.RSQ": 1, "LDS": 1}
    assert len(field["copies"]) == 1
    assert innermost_loop(_sass(SPLIT))["instructions"] == 4
    with pytest.raises(ValueError, match="and a SHFL and no STS"):
        innermost_loop(_sass(SPLIT), ops=("LDS", "SHFL"), without=("STS",))


def _split_listing(k, variants, steps, field_extra=()):
    """A split kernel's SASS at ``k`` slots: a generator's draw loop (an
    rsqrt and a store), the chain warp's step loop of ``steps`` steps (a
    ring load and ``hand_fields`` hand-off stores a step, the kept
    position's under a forward branch) and the field warp's (``hand_fields``
    loads, ``k`` rsqrt and ``field_extra`` a step)."""
    f = hand_fields(k, variants)
    lines = ["MUFU.RSQ R4, R2", "STS [R3], R2", "@P0 BRA 0x0"]
    chain = len(lines)
    for _ in range(steps):
        lines += ["LDS R6, [R7]", "FADD R2, R2, R6", "BSSY B0, 0x10"]
        lines += [f"STS [R5+{hex(128 * j)}], R2" for j in range(f)]
        lines += ["BSYNC B0"]
    lines += [f"@P2 BRA {hex(16 * chain)}"]
    field = len(lines)
    for _ in range(steps):
        lines += [f"LDS R6, [R5+{hex(128 * j)}]" for j in range(f)]
        lines += ["MUFU.RSQ R7, R6"] * k + ["FADD R1, R1, R7", *field_extra]
    lines += [f"@P4 BRA {hex(16 * field)}", "EXIT"]
    # each loop's instructions, its backward branch included
    return _sass(lines), field - chain, len(lines) - 1 - field


#: the parent's variant field loop held the intended kick's IEEE
#: reciprocal and square root, each a slow path under a BSSY and a CALL
SLOW = ("BSSY B1, 0x100", "MUFU.RCP R8, R9", "CALL.REL.NOINC 0x2000",
        "BSYNC B1", "BSSY B2, 0x200", "CALL.REL.NOINC 0x2400", "BSYNC B2")


@pytest.mark.parametrize("k, variants, field_extra, slow", [
    (5, False, (), {"CALL": 0, "MUFU.RCP": 0, "BSSY": 0}),
    (10, True, (), {"CALL": 0, "MUFU.RCP": 0, "BSSY": 0}),
    (10, True, SLOW, {"CALL": 4, "MUFU.RCP": 2, "BSSY": 4}),
    (1, True, (), {"CALL": 0, "MUFU.RCP": 0, "BSSY": 0}),
])
def test_step_loops_of_a_split_kernel(k, variants, field_extra, slow):
    """``step_loops`` counts each walker warp's step loop a step, at any K
    and in either physics: the chain warp's by its hand-off stores and the
    field warp's by its hand-off loads (``hand_fields`` a step, 2 K + 4
    in the default physics and 2 K + 8 with the variants), over the two
    steps the compiler unrolls; and the slow paths of an IEEE division or
    square root (``SLOW_PATHS``) in each."""
    sass, chain_n, field_n = _split_listing(k, variants, 2, field_extra)
    loops = step_loops(sass, k, variants)
    assert hand_fields(k, variants) == 2 * k + (8 if variants else 4)
    assert loops["chain"]["instructions"] == chain_n
    assert loops["chain"]["per_step"] == chain_n / 2
    assert loops["chain"]["counts"]["BSSY"] == 2
    assert loops["chain"]["counts"]["CALL"] == 0
    assert loops["field"]["instructions"] == field_n
    assert loops["field"]["per_step"] == field_n / 2
    assert loops["field"]["rsqrt"] == 2 * k
    assert {p: loops["field"]["counts"][p] for p in slow} == slow


def test_hand_fields_is_the_kernels():
    """``benchmark.hand_fields`` counts the hand-off's floats as
    ``csrc/field_math.cuh:hand_fields`` does, at every K in both
    physics."""
    src = (Path(benchmark.__file__).parent / "csrc"
           / "field_math.cuh").read_text()
    m = re.search(r"hand_fields\(\) \{\s*return 2 \* K \+ 4 \+ "
                  r"\(kVariants \? (\d+) : 0\);", src)
    assert m is not None
    assert all(hand_fields(k, v) == 2 * k + 4 + (int(m.group(1)) if v else 0)
               for k in range(1, 17) for v in (False, True))

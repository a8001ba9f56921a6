"""How ``benchmark.rsqrt_loop`` reads a kernel's SASS (no card needed):
the innermost loop holding a MUFU.RSQ is a backward branch and the
instructions from its target to it, each counted once as written, with
the loops nested in it listed by size, and every such loop where a
kernel holds several copies.  ``chip_smoke`` prints the near
entry's step loop and the far sums' pair loop this way
(``benchmark.sass_loop`` feeds it ``cuobjdump -sass``)."""

import pytest

from mri_nanoparticle_simulation_tpu_torch.benchmark import rsqrt_loop


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
    got = rsqrt_loop(_sass(lines))
    assert got == {**want, "copies": copies or [want]}


@pytest.mark.parametrize("lines", [
    ["MUFU.RSQ R1, R1", "FADD R1, R1, R1", "EXIT"],         # no loop
    ["FADD R1, R1, R1", "@P0 BRA 0x0", "MUFU.RSQ R1, R1"],  # rsqrt outside
    ["BRA 0x20", "MUFU.RSQ R1, R1", "EXIT"],                # forward branch
])
def test_no_rsqrt_loop_raises(lines):
    with pytest.raises(ValueError, match="no loop with a MUFU.RSQ"):
        rsqrt_loop(_sass(lines))

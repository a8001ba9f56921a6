"""ctypes bindings to the native C++ scene builder (csrc/scene_builder.cpp
of this package, built into its own csrc/build/).

The shared library is compiled on demand with g++ (no pybind11 in this
environment; the C ABI + ctypes keeps the binding dependency-free).  All
entry points are bit-identical to the NumPy implementations in box.py /
lookup.py — they share the Threefry streams — which tests assert, so
either path can serve any scene.  The native path matters for the
scale-up configurations (thousands of cells, 100k+ waters) where the
Python rejection loops dominate scene build time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "scene_builder.cpp")
_LIB_DIR = os.path.join(os.path.dirname(_SRC), "build")
_LIB = os.path.join(_LIB_DIR, "libscene_builder.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compile() -> Optional[str]:
    os.makedirs(_LIB_DIR, exist_ok=True)
    # -ffp-contract=off: no FMA contraction, so comparisons in the
    # rejection loops round exactly like NumPy and the streams stay
    # bit-identical to the Python path.  Built under a name of this
    # process and renamed into place, so processes that build at the
    # same time never load a half-written library.
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-shared",
           "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return _LIB
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            OSError):
        return None


def load() -> Optional[ctypes.CDLL]:
    """Load (compiling if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _LIB if os.path.exists(_LIB) else _compile()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None

        u32, i32, i64, f64 = (ctypes.c_uint32, ctypes.c_int32,
                              ctypes.c_int64, ctypes.c_double)
        pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        pi = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        pu = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")

        lib.scene_threefry.argtypes = [u32, u32, u32, u32, pu]
        lib.scene_threefry.restype = None
        lib.scene_build_cells.argtypes = [ctypes.c_uint64, u32,
                                          ctypes.c_int, f64, f64, pd]
        lib.scene_build_cells.restype = i64
        lib.scene_build_waters.argtypes = [ctypes.c_uint64, u32,
                                           ctypes.c_int, pd, ctypes.c_int,
                                           f64, f64, f64, ctypes.c_int, pd]
        lib.scene_build_waters.restype = i64
        lib.scene_build_lookup.argtypes = [pd, ctypes.c_int, ctypes.c_int,
                                           f64, f64, ctypes.c_int, pi]
        lib.scene_build_lookup.restype = i32
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def threefry_kat(k0: int, k1: int, c0: int, c1: int):
    lib = load()
    assert lib is not None
    out = np.zeros(2, np.uint32)
    lib.scene_threefry(k0, k1, c0, c1, out)
    return int(out[0]), int(out[1])


def build_cells(seed: int, stream: int, num_cells: int, cell_r: float,
                bound: float) -> np.ndarray:
    lib = load()
    assert lib is not None
    out = np.zeros((num_cells, 3))
    lib.scene_build_cells(seed & 0xFFFFFFFFFFFFFFFF, stream, num_cells,
                          cell_r, bound, out)
    return out


def build_waters(seed: int, stream: int, num_water: int, cells: np.ndarray,
                 cell_r: float, bound: float, water_start_bound: float,
                 avoid_intracellular: bool) -> np.ndarray:
    lib = load()
    assert lib is not None
    out = np.zeros((num_water, 3))
    lib.scene_build_waters(seed & 0xFFFFFFFFFFFFFFFF, stream, num_water,
                           np.ascontiguousarray(cells), len(cells), cell_r,
                           bound, water_start_bound,
                           int(avoid_intracellular), out)
    return out


def build_lookup(cells: np.ndarray, hash_dim: int, bound: float,
                 cell_r: float, max_neighbors: int) -> np.ndarray:
    lib = load()
    assert lib is not None
    out = np.zeros((hash_dim ** 3, max_neighbors), np.int32)
    worst = lib.scene_build_lookup(np.ascontiguousarray(cells), len(cells),
                                   hash_dim, bound, cell_r, max_neighbors,
                                   out)
    if worst < 0 or worst >= max_neighbors:
        raise ValueError(
            f"a lattice point has >= {max_neighbors} candidate cells "
            f"(native); max_neighbors requires strictly fewer "
            f"(SimulationBox.cpp:281)")
    return out

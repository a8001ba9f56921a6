"""Streaming CSV output of the T2 decay curve.

Counterpart of the reference's ``io/writer.py`` (which cannot be imported
without jax: its package ``__init__`` pulls in the checkpoint module).
The bytes written are identical: one row per output window,
``time_ms,sum_cos_phi`` (cuda_sim.cu:1022), with an optional third column
``sum_sin_phi``, and the reference's filename convention
(T2_GPU_sim.cu:28-49).
"""

from __future__ import annotations

import os
import time
from typing import IO, Optional

import numpy as np

from ..params import Params


class T2CsvWriter:
    """Append-streaming writer; flushes on every ``append_windows`` call.
    How many rows a crash can lose is set by the caller's drain cadence
    (``SimulationRunner.run``'s ``drain_depth``)."""

    def __init__(self, path: str, params: Params, quadrature: bool = False,
                 append: bool = False):
        self.path = path
        self.params = params
        self.quadrature = quadrature
        self.append = append
        self._f: Optional[IO[str]] = None
        self._rows = 0

    def __enter__(self):
        self._f = open(self.path, "a" if self.append else "w")
        return self

    def __exit__(self, *exc):
        self.close()

    def append_windows(self, first_window_index: int,
                       wins: np.ndarray) -> None:
        """wins: [n, 2] (sum cos, sum sin) for windows starting at
        ``first_window_index`` (0-based)."""
        if self._f is None:
            raise RuntimeError("writer not opened")
        pfreq, tau = self.params.pfreq, self.params.tau
        lines = []
        for i, (c, s) in enumerate(np.asarray(wins)):
            t_ms = (first_window_index + i + 1) * pfreq * tau
            if self.quadrature:
                lines.append(f"{t_ms:.17g},{c:.17g},{s:.17g}\n")
            else:
                lines.append(f"{t_ms:.17g},{c:.17g}\n")
        self._f.write("".join(lines))
        self._f.flush()
        self._rows += len(lines)

    @property
    def rows_written(self) -> int:
        return self._rows

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


def truncate_rows(path: str, n_keep: int) -> int:
    """Truncate a T2 CSV to its first ``n_keep`` rows; returns the number
    of rows dropped (0 if the file is missing or already short enough).

    Needed by checkpoint resume: the checkpoint path drains the CSV
    *before* snapshotting, so the rows on disk are always at or AHEAD of
    the checkpoint.  A resume that simply appended would then duplicate
    every window between the checkpoint step and the crash; this trims
    the overhang so the resumed run re-produces those rows instead
    (bitwise, the generators being counter-based)."""
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        lines = f.readlines()
    if len(lines) <= n_keep:
        return 0
    with open(path, "w") as f:
        f.writelines(lines[:n_keep])
    return len(lines) - n_keep


def default_output_path(params: Params, out_dir: str = ".") -> str:
    return os.path.join(out_dir, params.output_filename(int(time.time())))


def read_t2_csv(path: str):
    """Load a T2 CSV -> (times_ms, sum_cos[, sum_sin])."""
    data = np.loadtxt(path, delimiter=",", ndmin=2)
    return tuple(data[:, i] for i in range(data.shape[1]))

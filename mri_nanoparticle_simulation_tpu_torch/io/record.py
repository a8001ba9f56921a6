"""Disk-backed decomposition-record store: crash-safe, memory-bounded.

``mri-t2-sim --dump-record`` materializes the per-walker (A, B) record in
host RAM and writes one compressed .npz at the end — fine at reference
scale (1.3 GB), but a scale-up record (100k walkers x 40k windows) is
32 GB and a crash at window 39,999 loses all of it.  This store is the
durable alternative: a directory holding two pre-sized ``.npy`` memmaps
(one per component) plus a ``meta.json`` whose atomic rewrite is the
commit point —

    record_dir/
      A.npy        [n_windows, num_water] f32 memmap (dipole-phase A)
      B.npy        [n_windows, num_water] f32 memmap (kick-phase B)
      meta.json    {"rows": r, ...}   <- rows [0, r) are committed

``append`` writes the next rows into both memmaps, flushes them, THEN
rewrites meta (temp file + ``os.replace``).  A process death mid-append
leaves ``rows`` at its old value, so the torn rows are simply overwritten
on resume — the store is always either the old consistent state or the
new one, the same discipline as ``io.checkpoint.save_checkpoint``.

Host memory is one sprint's record block regardless of the record size;
readers get the components back as read-only memmaps
(:meth:`RecordStore.arrays`), so closed-form fits over a record larger
than RAM stream from disk.  The store quacks like a
``decompose.run_decomposition`` consumer (``update == append``), so a
run writes one with ``consumer=RecordStore.create(...)``.

The port's copy of the reference package's ``io/record.py``, carried
over as it is: the format, the file names and the meta keys are the
same, so either package reads the other's store.  The resumable run on
top of it is ``decompose.run_decomposition_durable``.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

FORMAT_VERSION = 1

_META = "meta.json"
_COMPONENTS = ("A", "B")


def _atomic_write_json(path: str, payload: dict) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def is_record_dir(path: str) -> bool:
    """True iff ``path`` is a record-store directory (vs a .npz file)."""
    return os.path.isdir(path) and \
        os.path.exists(os.path.join(path, _META))


class RecordStore:
    """One decomposition record on disk.  Use :meth:`create` /
    :meth:`open` (the constructor is shared plumbing)."""

    def __init__(self, path: str, meta: dict, mode: str):
        self.path = path
        self.meta = meta
        self._mode = mode      # "r+" for writers, "r" for readers
        self._mm = {}          # lazily-opened component memmaps

    # -- construction --------------------------------------------------
    @classmethod
    def create(cls, path: str, n_windows: int, num_water: int,
               extra_meta: dict | None = None) -> "RecordStore":
        """Create an empty store (rows=0).  ``path`` must not already
        hold a store; the two memmaps are pre-sized to the full record
        (sparse files — no 32 GB write happens here)."""
        if n_windows <= 0 or num_water <= 0:
            raise ValueError(
                f"record shape must be positive, got "
                f"[{n_windows}, {num_water}]")
        if is_record_dir(path):
            raise FileExistsError(
                f"{path} already holds a record store; open() it or "
                f"remove it first")
        os.makedirs(path, exist_ok=True)
        for comp in _COMPONENTS:
            mm = np.lib.format.open_memmap(
                os.path.join(path, f"{comp}.npy"), mode="w+",
                dtype=np.float32, shape=(int(n_windows), int(num_water)))
            del mm
        meta = {"version": FORMAT_VERSION, "n_windows": int(n_windows),
                "num_water": int(num_water), "rows": 0, "complete": False}
        for k, v in (extra_meta or {}).items():
            if k in meta:
                raise ValueError(f"extra_meta may not override {k!r}")
            meta[k] = v
        _atomic_write_json(os.path.join(path, _META), meta)
        return cls(path, meta, "r+")

    @classmethod
    def open(cls, path: str, writable: bool = False) -> "RecordStore":
        if not is_record_dir(path):
            raise FileNotFoundError(f"no record store at {path}")
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        if int(meta.get("version", -1)) != FORMAT_VERSION:
            raise ValueError(
                f"unknown record-store version {meta.get('version')!r} "
                f"at {path}")
        return cls(path, meta, "r+" if writable else "r")

    # -- properties ----------------------------------------------------
    @property
    def rows(self) -> int:
        return int(self.meta["rows"])

    @property
    def n_windows(self) -> int:
        return int(self.meta["n_windows"])

    @property
    def num_water(self) -> int:
        return int(self.meta["num_water"])

    @property
    def complete(self) -> bool:
        return bool(self.meta["complete"])

    # -- write side ------------------------------------------------------
    def _memmap(self, comp: str):
        if comp not in self._mm:
            self._mm[comp] = np.load(
                os.path.join(self.path, f"{comp}.npy"),
                mmap_mode=self._mode)
        return self._mm[comp]

    def append(self, a_block, b_block) -> None:
        """Commit the next record rows (window order).  Data lands in the
        memmaps first, the meta rewrite commits it."""
        if self._mode != "r+":
            raise ValueError("store opened read-only")
        a_block = np.asarray(a_block, np.float32)
        b_block = np.asarray(b_block, np.float32)
        nb = a_block.shape[0]
        want = (nb, self.num_water)
        if a_block.shape != want or b_block.shape != want:
            raise ValueError(
                f"expected [{nb}, {self.num_water}] blocks, got "
                f"{a_block.shape} and {b_block.shape}")
        lo = self.rows
        if lo + nb > self.n_windows:
            raise ValueError(
                f"record overflow: {lo} + {nb} rows > the declared "
                f"{self.n_windows} windows")
        for comp, blk in (("A", a_block), ("B", b_block)):
            mm = self._memmap(comp)
            mm[lo:lo + nb] = blk
            mm.flush()
        self.meta["rows"] = lo + nb
        _atomic_write_json(os.path.join(self.path, _META), self.meta)

    # consumer protocol of decompose.run_decomposition(consumer=...)
    update = append

    def truncate(self, rows: int) -> int:
        """Drop committed rows past ``rows`` (resume overhang — record
        rows written after the last checkpoint, the
        ``io.writer.truncate_rows`` analogue).  Returns rows dropped."""
        if self._mode != "r+":
            raise ValueError("store opened read-only")
        if rows < 0 or rows > self.rows:
            raise ValueError(
                f"cannot truncate to {rows} rows (store holds "
                f"{self.rows})")
        dropped = self.rows - rows
        if dropped:
            self.meta["rows"] = int(rows)
            self.meta["complete"] = False
            _atomic_write_json(os.path.join(self.path, _META), self.meta)
        return dropped

    def finalize(self, extra_meta: dict | None = None) -> None:
        """Mark the record complete (all windows committed)."""
        if self._mode != "r+":
            raise ValueError("store opened read-only")
        if self.rows != self.n_windows:
            raise ValueError(
                f"cannot finalize: {self.rows}/{self.n_windows} windows "
                f"committed")
        self.meta.update(extra_meta or {})
        self.meta["complete"] = True
        _atomic_write_json(os.path.join(self.path, _META), self.meta)

    # -- read side -------------------------------------------------------
    def arrays(self):
        """``(A, B)`` as read-only memmaps over the COMMITTED rows —
        downstream fits stream from disk, RAM stays O(walker block)."""
        a = np.load(os.path.join(self.path, "A.npy"), mmap_mode="r")
        b = np.load(os.path.join(self.path, "B.npy"), mmap_mode="r")
        return a[:self.rows], b[:self.rows]

    def times_ms(self) -> np.ndarray:
        """Window end times of the committed rows, ms (requires the
        tau/pfreq meta the durable run records)."""
        if "tau" not in self.meta or "pfreq" not in self.meta:
            raise ValueError(
                f"record store at {self.path} lacks tau/pfreq meta; "
                f"no time axis can be derived")
        tau, pfreq = self.meta["tau"], self.meta["pfreq"]
        return np.arange(1, self.rows + 1, dtype=np.float64) * pfreq * tau

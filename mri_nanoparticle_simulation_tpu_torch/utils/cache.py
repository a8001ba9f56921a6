"""The coverage-certificate cache.

The covering-lattice proofs of ``fields/expansion.validate_near_k`` and
``validate_cube_candidates`` depend only on the dipole positions and the
reach radius, so each certified bound is stored once per scene under a
content hash and read back by later runs (~3 s of lattice sweep saved
per CLI start).  Same keys and file format as the reference package's
``utils/cache.py``: ``<dir>/certs/<kind>-<sha256[:32]>.txt`` holding one
integer, in ``$MRI_TPU_COMPILE_CACHE`` or else ``.jax_cache/`` beside
the package, so both packages read each other's certificates.
"""

from __future__ import annotations

import hashlib
import os
import tempfile


def _default_dir() -> str:
    return os.environ.get(
        "MRI_TPU_COMPILE_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), ".jax_cache"))


def certificate_get(kind: str, key_bytes: bytes) -> int | None:
    """Look up a previously proven integer certificate (e.g. the
    covering-lattice near-K bound) by content hash.  Returns None on any
    miss or I/O problem — the caller then recomputes the proof."""
    h = hashlib.sha256(key_bytes).hexdigest()[:32]
    path = os.path.join(_default_dir(), "certs", f"{kind}-{h}.txt")
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def certificate_put(kind: str, key_bytes: bytes, value: int) -> None:
    """Record a proven certificate; atomic (tmp+rename), best-effort."""
    h = hashlib.sha256(key_bytes).hexdigest()[:32]
    d = os.path.join(_default_dir(), "certs")
    try:
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d)
        with os.fdopen(fd, "w") as f:
            f.write(str(int(value)))
        os.replace(tmp, os.path.join(d, f"{kind}-{h}.txt"))
    except OSError:
        pass

"""Taps on the program's chunk and plane calls, for the output check.

A tap wraps a function of the program for the length of a run and keeps
references to the inputs and outputs of a few calls: the first (the
start of the walk), the first whose chunk holds a Carr-Purcell flip, and
a uniform sample of the rest (reservoir sampling from the run's seed).
It copies nothing and reads nothing from the card, so the timed path
runs as it would untapped, but for one Python call a chunk.
"""

from __future__ import annotations

import random


class Sampler:
    """Which call indices to keep: 0, the first that ``is_flip`` picks,
    and ``k`` more drawn uniformly over all calls."""

    def __init__(self, seed: int, k: int):
        self.rng = random.Random(seed)
        self.k = k
        self.n = 0
        self.kept = {}          # index -> item
        self.reservoir = []     # indices
        self.flip_seen = False

    def offer(self, item_fn, is_flip: bool = False):
        """Count one call; keep ``item_fn()`` when it is picked."""
        i = self.n
        self.n += 1
        if i == 0 or (is_flip and not self.flip_seen):
            self.flip_seen |= is_flip
            self.kept[i] = item_fn()
            return
        if len(self.reservoir) < self.k:
            self.reservoir.append(i)
            self.kept[i] = item_fn()
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            del self.kept[self.reservoir[j]]
            self.reservoir[j] = i
            self.kept[i] = item_fn()

    def items(self):
        """The kept items in call order, each with its ``index``."""
        return [dict(self.kept[i], index=i) for i in sorted(self.kept)]


def holds_flip(step0: int, steps: int, pfreq: int, tcp: int) -> bool:
    """Whether a window of the steps [step0, step0 + steps) ends on a
    multiple of ``tcp`` (a flip follows it)."""
    for end in range(step0 + pfreq, step0 + steps + 1, pfreq):
        if end % tcp == 0:
            return True
    return False


class ChunkTap:
    """Wraps ``chunk_kernel.run_chunk`` and ``run_chunk_near`` (and on the
    large path ``expansion.build_planes``, whose model feeds the next
    near chunk).  Each kept item: the chunk's first step as the tap
    counts it (chunks since the walk began) and as the program passed
    it; the walk's previous chunk output (None for a walk's first
    chunk), which the reference starts from; the state the wrapper was
    handed; its outputs; the large path's model; and the walk it belongs
    to (``new_walk``, called by the driver).  With ``keep_wins`` it also
    holds each chunk's windows until ``take_wins`` (the plane's fold
    takes a sprint's)."""

    def __init__(self, seed: int, k: int, pfreq: int, tcp: int,
                 keep_wins: bool = False):
        from mri_nanoparticle_simulation_tpu_torch.engine import chunk_kernel
        from mri_nanoparticle_simulation_tpu_torch.fields import expansion
        self._ck, self._ex = chunk_kernel, expansion
        self.sampler = Sampler(seed, k)
        self.pfreq, self.tcp = pfreq, tcp
        self.keep_wins = keep_wins
        self.wins = []
        self._model = None
        self._orig = {}
        self.new_walk(0)

    def new_walk(self, walk: int):
        self.walk = walk
        self.steps = 0
        self.prev_out = None

    def take_wins(self) -> list:
        wins, self.wins = self.wins, []
        return wins

    def _wrap(self, fn, near: bool):
        def tapped(state, *args, **kw):
            out = fn(state, *args, **kw)
            step0, before = self.steps, self.prev_out
            n = kw["phys"].chunk_steps
            self.steps += n
            flip = holds_flip(step0, n, self.pfreq, self.tcp)
            model = self._model
            self.sampler.offer(lambda: dict(
                step0=step0, prog_step0=int(kw["step0"]), walk=self.walk,
                near=near, state=before, wrapped=state, out=out,
                model=model), flip)
            self.prev_out = out[0]
            if self.keep_wins:
                self.wins.append(out[3])
            self._model = None
            return out
        return tapped

    def _wrap_model(self, fn):
        def tapped(*args, **kw):
            self._model = fn(*args, **kw)
            return self._model
        return tapped

    def install(self):
        ck, ex = self._ck, self._ex
        self._orig = {"run_chunk": ck.run_chunk,
                      "run_chunk_near": ck.run_chunk_near,
                      "build_planes": ex.build_planes}
        ck.run_chunk = self._wrap(self._orig["run_chunk"], False)
        ck.run_chunk_near = self._wrap(self._orig["run_chunk_near"], True)
        ex.build_planes = self._wrap_model(self._orig["build_planes"])

    def remove(self):
        if self._orig:
            self._ck.run_chunk = self._orig["run_chunk"]
            self._ck.run_chunk_near = self._orig["run_chunk_near"]
            self._ex.build_planes = self._orig["build_planes"]
            self._orig = {}


class PlaneTap:
    """Wraps ``decompose.make_plane_step``: each plane step it makes keeps,
    for sampled sprints, the record the fold was handed, the windows the
    sprint's chunks produced (from ``chunks``, a ``ChunkTap`` with
    ``keep_wins``) and the carry the call's previous fold returned (None
    for its first), all by reference, with the call and the sprint's
    place in it."""

    def __init__(self, seed: int, k: int, flip_sprint: int, chunks):
        from mri_nanoparticle_simulation_tpu_torch.engine import decompose
        self._dec = decompose
        self.sampler = Sampler(seed, k)
        self.flip_sprint = flip_sprint
        self.chunks = chunks
        self.call = 0
        self._orig = None

    def install(self):
        self._orig = self._dec.make_plane_step

        def make(*args, **kw):
            step = self._orig(*args, **kw)
            call, count, prev = self.call, [0], [None]
            self.chunks.take_wins()

            def tapped(wins, carry, *rest):
                i = count[0]
                count[0] += 1
                made, before = self.chunks.take_wins(), prev[0]
                self.sampler.offer(lambda: dict(
                    call=call, sprint=i, wins=wins, made=made,
                    carry=before), i == self.flip_sprint)
                out = step(wins, carry, *rest)
                prev[0] = out[0]
                return out
            return tapped
        self._dec.make_plane_step = make

    def remove(self):
        if self._orig is not None:
            self._dec.make_plane_step = self._orig
            self._orig = None

"""Failure detection and elastic recovery around the sprint loop.

Counterpart of the reference's ``engine/resilience.py``.  The generators
are counter-based, so a rebuilt runner resumed from a checkpoint
continues the identical random sequence: recovery is invisible in the
output.

* **Watchdog**: ``watchdog_call`` bounds every blocking readback of the
  device (``SimulationRunner``'s drains and its checkpoint fetches); a
  hung one raises ``WatchdogTimeout`` instead of blocking forever.
* **Elastic retry**: ``run_resilient`` wraps ``SimulationRunner.run``:
  on a failure it builds a fresh runner, resumes it from the last
  checkpoint, trims the CSV rows written past that checkpoint
  (``io.writer.truncate_rows``) and retries.  The retry budget counts
  consecutive failures without progress: a retry that advanced the
  checkpoint refills it.
* **Fault injection**: ``FaultInjector`` and the ``fault_hook`` seam of
  ``SimulationRunner.run`` raise failures at chosen sprints, so tests
  prove the recovered output bitwise equal to an uninterrupted run.

Process-level recovery is the same machinery: re-running the same CLI
command (``--checkpoint C --checkpoint-every N --max-retries R``) after
a process death resumes from C and trims the CSV overhang.

Limits.  In-process retry survives exceptions raised on the host,
watchdog timeouts and injected faults.  A sticky CUDA error (an illegal
address, a device-side assert) poisons the process's CUDA context: every
later CUDA call fails too, so the retries fail and only a new process,
the same command run again, recovers.  A watchdog thread abandoned
behind a hung kernel stays blocked; its process may not exit until the
kernel does.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Callable, Optional

import numpy as np

from ..io import writer as writer_mod


class WatchdogTimeout(RuntimeError):
    """A bounded device interaction exceeded its deadline."""


def watchdog_call(fn: Callable, timeout_s: float, what: str = "device call"):
    """Run ``fn()`` under a deadline; raise WatchdogTimeout if it does not
    finish within ``timeout_s`` seconds.

    The call runs in a daemon thread, which is abandoned if it is truly
    wedged; the caller tears the runner down and rebuilds it, as
    ``run_resilient`` does.  torch's current CUDA stream is per thread:
    a ``fn`` that reads the device must enter the caller's stream itself
    (``SimulationRunner._on_caller_stream``).  Exceptions raised by
    ``fn`` propagate."""
    result: list = []
    error: list = []

    def target():
        try:
            result.append(fn())
        except BaseException as e:   # noqa: BLE001 — relayed to caller
            error.append(e)

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise WatchdogTimeout(
            f"{what} exceeded the {timeout_s:g}s watchdog deadline")
    if error:
        raise error[0]
    return result[0]


class FaultInjector:
    """Raise a device-failure-shaped error at chosen sprint indices.

    ``fail_at`` maps absolute sprint index -> number of times to fail
    there (a retry that reaches the same sprint again succeeds once the
    budget is spent: the transient-fault shape).  Pass it as
    ``fault_hook`` to ``SimulationRunner.run`` / ``run_resilient`` or to
    the durable decomposition runs."""

    def __init__(self, fail_at: dict, exc_type=RuntimeError):
        self.fail_at = dict(fail_at)
        self.exc_type = exc_type
        self.faults_fired = 0

    def __call__(self, sprint_index: int) -> None:
        left = self.fail_at.get(sprint_index, 0)
        if left > 0:
            self.fail_at[sprint_index] = left - 1
            self.faults_fired += 1
            raise self.exc_type(
                f"injected fault at sprint {sprint_index}")


def _checkpoint_step(path: Optional[str]) -> int:
    if not path or not os.path.exists(path):
        return 0
    try:
        with np.load(path) as z:
            return int(z["step"])
    except Exception:
        # a checkpoint torn by the failure itself counts as no progress
        return 0


def trim_csv_overhang(runner, csv_path: str) -> int:
    """Drop CSV rows written past a just-resumed runner's checkpoint step
    (the checkpoint path drains first, so the rows on disk are at or
    ahead of it).  The resumed run re-produces the trimmed rows bitwise.
    Returns the resumed step."""
    start = int(runner.state.step)
    dropped = writer_mod.truncate_rows(csv_path, start // runner.params.pfreq)
    if dropped:
        print(f"  recovery: trimmed {dropped} CSV row(s) written past "
              f"the checkpoint (step {start})", file=sys.stderr)
    return start


def _resume_if_possible(runner, checkpoint_path: str,
                        csv_path: str) -> int:
    """Resume from the checkpoint when one exists and is readable;
    returns the step resumed from (0 when starting fresh).

    A torn or unreadable file is warned about and skipped: the attempt
    restarts from scratch.  A semantic mismatch (params fingerprint,
    seeds, engine, rng_impl, scene: ValueError from ``load_checkpoint``)
    stays fatal: retrying cannot fix a configuration error, and
    discarding the checkpoint would overwrite the run the user asked to
    continue."""
    if not os.path.exists(checkpoint_path):
        return 0
    try:
        runner.resume(checkpoint_path)
    except ValueError:
        raise
    except Exception as e:   # noqa: BLE001 — torn file tolerance
        print(f"  recovery: checkpoint {checkpoint_path} unreadable "
              f"({type(e).__name__}: {e}); restarting from scratch",
              file=sys.stderr)
        return 0
    return trim_csv_overhang(runner, csv_path)


def run_resilient(make_runner: Callable, csv_path: str,
                  checkpoint_path: Optional[str] = None,
                  checkpoint_every_sprints: int = 1,
                  quadrature: bool = False, drain_depth: int = 32,
                  max_retries: int = 3,
                  drain_timeout_s: Optional[float] = None,
                  fault_hook=None, progress: bool = True,
                  max_steps: Optional[int] = None):
    """``SimulationRunner.run`` with bounded elastic recovery.

    ``make_runner`` builds a FRESH ``SimulationRunner`` on the device the
    run uses (it is called once per attempt; recovery never moves a run
    to another device).  The whole attempt (build, resume, run) sits
    inside the recovery boundary, so a failure while rebuilding or
    resuming consumes retry budget like any other.  Returns ``run``'s
    ``(times_ms, sum_cos, sum_sin, stats)`` with
    ``stats['recovery_attempts']``.

    ``csv_path`` is required: a failed attempt's undrained windows are
    lost with it, and only the CSV carries the whole curve.  After any
    recovery the curve is re-read from the CSV; with
    ``quadrature=False`` the CSV has no sum-sin column, so ``sum_sin``
    is returned as NaNs (loudly absent, never silently zero).

    ``max_retries`` bounds consecutive failures *without progress*
    (progress = the checkpoint step advanced since the last failure).
    """
    if csv_path is None:
        raise ValueError(
            "run_resilient requires a csv_path: a failed attempt's "
            "undrained windows are lost with it, and only the CSV "
            "carries the full recovered curve")
    if checkpoint_path is None:
        raise ValueError(
            "elastic recovery requires a checkpoint_path: without one a "
            "device failure loses all walker state and there is nothing "
            "to recover from")
    if checkpoint_every_sprints < 1:
        raise ValueError(
            "elastic recovery requires checkpoint_every_sprints >= 1 "
            "(a run that only checkpoints at the end always restarts "
            "from scratch)")
    if max_retries < 0:
        raise ValueError("max_retries must be >= 0")

    failures_without_progress = 0
    attempts = 0
    last_failed_step = -1
    resumed_from = 0
    while True:
        attempts += 1
        try:
            runner = make_runner()
            resumed_from = _resume_if_possible(runner, checkpoint_path,
                                               csv_path)
            times, cos, sin, stats = runner.run(
                csv_path=csv_path, quadrature=quadrature,
                checkpoint_path=checkpoint_path,
                checkpoint_every_sprints=checkpoint_every_sprints,
                progress=progress, max_steps=max_steps,
                drain_depth=drain_depth, fault_hook=fault_hook,
                drain_timeout_s=drain_timeout_s)
        except (KeyboardInterrupt, SystemExit):
            raise
        except ValueError:
            # configuration and contract errors are not transient
            raise
        except Exception as e:   # noqa: BLE001 — the recovery boundary
            reached = _checkpoint_step(checkpoint_path)
            if reached > last_failed_step:
                failures_without_progress = 1   # progress since last fail
            else:
                failures_without_progress += 1
            last_failed_step = max(last_failed_step, reached)
            if failures_without_progress > max_retries:
                raise
            print(f"  recovery: {type(e).__name__}: {e} — rebuilding "
                  f"and resuming from step {reached} "
                  f"(failure {failures_without_progress}/{max_retries} "
                  f"without progress)", file=sys.stderr)
            continue

        stats = dict(stats)
        stats["recovery_attempts"] = attempts - 1
        if attempts > 1 or resumed_from:
            # the last attempt saw only the resumed tail; the CSV holds
            # the whole (bitwise-continuous) curve
            cols = writer_mod.read_t2_csv(csv_path)
            times = cols[0]
            cos = cols[1]
            sin = cols[2] if len(cols) > 2 \
                else np.full_like(cos, np.nan)
        return times, cos, sin, stats

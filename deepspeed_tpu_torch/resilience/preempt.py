"""Preemption guard: SIGTERM → durable checkpoint → clean exit
(counterpart of ``deepspeed_tpu/resilience/preempt.py``).

Schedulers (Kubernetes, spot and preemptible VMs, Slurm) send SIGTERM with
a grace window before the SIGKILL. Without a handler, a death in the middle
of an async save leaves the newest checkpoint uncommitted and ``latest``
one save back. The guard turns the signal into: await the in-flight async
write, write the manifest, flip ``latest``, then exit, so the next
incarnation resumes from the newest checkpoint:

    engine = dt.initialize(cfg, model)
    guard = PreemptionGuard(engine).install()
    for batch in loader:
        engine.train_batch(batch)
        if step % save_every == 0:
            engine.save_checkpoint(ckpt_dir)
        if guard.preempted:          # cooperative path, if preferred
            break

In a world of several ranks the commit is a collective, and a signal
handler may interrupt a rank inside another collective; so there the
handler only marks the guard, and the ranks agree at the start of the
next ``train_batch`` (an all-reduce of the flag): if any rank was
signalled, every rank commits (and exits) together.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional

from ..utils.logging import log_dist

# 128 + SIGTERM(15): the conventional "died to SIGTERM" exit code, which
# supervisors read as a restartable death.
DEFAULT_EXIT_CODE = 143


class PreemptionGuard:
    """SIGTERM handler that makes the in-flight checkpoint durable first.

    ``exit_on_signal=True`` (default) raises ``SystemExit(exit_code)`` from
    the handler once the commit is durable: the process unwinds through
    ``finally`` blocks and atexit. ``exit_on_signal=False`` only sets
    ``preempted`` for a loop that breaks on its own schedule; the commit is
    still awaited inside the handler.

    ``save_dir`` + ``save_on_preempt=True`` also saves the CURRENT state
    before exiting (for long save intervals). That save runs synchronously
    inside the grace window."""

    def __init__(self, engine, *, signals=(signal.SIGTERM,),
                 exit_code: int = DEFAULT_EXIT_CODE,
                 exit_on_signal: bool = True,
                 save_dir: Optional[str] = None,
                 save_on_preempt: bool = False):
        if save_on_preempt and not save_dir:
            raise ValueError("save_on_preempt=True requires save_dir")
        self.engine = engine
        self.signals = tuple(signals)
        self.exit_code = exit_code
        self.exit_on_signal = exit_on_signal
        self.save_dir = save_dir
        self.save_on_preempt = save_on_preempt
        self.preempted = False
        self.committed = False      # a multi-rank world's agreed commit ran
        self._prev: dict = {}

    def install(self) -> "PreemptionGuard":
        """Register the handlers (main thread only, ``signal.signal``'s own
        rule) and the guard with its engine. Returns self."""
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("PreemptionGuard.install() must run on the "
                               "main thread (signal.signal requirement)")
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._handle)
        self.engine._preempt_guard = self
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}
        self.engine._preempt_guard = None

    def _handle(self, signum, frame) -> None:
        self.preempted = True
        log_dist(f"preemption: signal {signum} received — committing the "
                 "in-flight checkpoint before exit", ranks=[0],
                 level="WARNING")
        if self.engine.mesh.world == 1:
            self.commit()

    def commit(self) -> None:
        """The preempted run's epilogue: the extra save if asked, the
        in-flight save committed, then the exit if asked."""
        if self.save_on_preempt:
            # an extra snapshot of the current state; its failure must not
            # stop the in-flight commit from being awaited
            try:
                self.engine.save_checkpoint(self.save_dir)
            except Exception as e:
                log_dist(f"preemption: save_on_preempt failed ({e}); "
                         "committing the in-flight save only", ranks=[0],
                         level="WARNING")
        # awaits the async write, writes the manifest, flips 'latest'
        self.engine.wait_for_checkpoint()
        log_dist("preemption: checkpoint durable; 'latest' flipped",
                 ranks=[0], level="WARNING")
        if self.exit_on_signal:
            raise SystemExit(self.exit_code)

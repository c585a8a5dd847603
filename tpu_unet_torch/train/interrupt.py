"""Preemption-tolerant training: SIGTERM -> checkpoint -> clean exit
(counterpart of ``tpu_unet/train/interrupt.py``).

Preemptible machines, kubelet evictions and ``docker stop`` deliver SIGTERM
with a short grace window before SIGKILL. The trainer installs a flag-only
SIGTERM handler around its epoch loop; the epoch driver polls it between
steps, and the trainer then saves ``checkpoint_interrupt.pth`` whose epoch
field is the last COMPLETED epoch, so ``--resume
outputs/<exp>/checkpoints/checkpoint_interrupt.pth`` replays the interrupted
epoch from its start and continues. Exit code 75 (EX_TEMPFAIL) marks the run
requeueable for orchestrators.

Under a data-parallel process group the ranks must stop together, since
every step joins collectives: :meth:`GracefulInterrupt.step_poll` returns
None (no rank leaves an epoch early), and
:meth:`GracefulInterrupt.poll_global` all-gathers the flags at the epoch
boundary, so every rank stops there when any one was signalled.
"""

from __future__ import annotations

import os
import signal
from typing import Callable, Optional

import numpy as np

from tpu_unet_torch.parallel.collectives import all_gather_host_values
from tpu_unet_torch.parallel.mesh import world_size

# sysexits.h EX_TEMPFAIL: "temporary failure, retry later".
INTERRUPT_EXIT_CODE = 75

# File name the trainer writes on interruption.
INTERRUPT_CHECKPOINT = "checkpoint_interrupt.pth"


class GracefulInterrupt:
    """Context manager: latch SIGTERM into a flag instead of dying.

    >>> with GracefulInterrupt() as intr:
    ...     for epoch in range(epochs):
    ...         train_epoch(..., should_stop=intr.step_poll())
    ...         if intr.poll_global():
    ...             save_interrupt_checkpoint(); break

    The previous signal disposition is restored on exit. The handler only sets
    a flag; all checkpoint and file work happens at the next poll on the main
    thread.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._previous = {}
        self._triggered = False

    def _handler(self, signum, frame):
        self._triggered = True

    def install(self) -> "GracefulInterrupt":
        for sig in self._signals:
            self._previous[sig] = signal.signal(sig, self._handler)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()

    def __enter__(self) -> "GracefulInterrupt":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    @property
    def triggered(self) -> bool:
        """This process's flag."""
        return self._triggered

    def step_poll(self) -> Optional[Callable[[], bool]]:
        """Per-step ``should_stop`` callable for the epoch driver; None under
        a process group (stops are epoch-granular there)."""
        if world_size() > 1:
            return None
        return lambda: self._triggered

    def poll_global(self) -> bool:
        """True if any rank latched a signal (the epoch-boundary check): the
        local flag in one process, else an all-gather of every rank's."""
        if world_size() == 1:
            return self._triggered
        flags = all_gather_host_values(np.asarray([self._triggered]))
        return bool(flags.any())


def interrupt_checkpoint_path(checkpoints_dir: str) -> str:
    return os.path.join(checkpoints_dir, INTERRUPT_CHECKPOINT)

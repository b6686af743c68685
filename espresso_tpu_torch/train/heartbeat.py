"""Heartbeat watchdog: kill a hung training job so the scheduler restarts it.

The port's own copy of ``espresso_tpu/train/heartbeat.py`` (the reference's
``DistributedTimeoutWrapper``, ``--heartbeat-timeout``): a daemon thread
checks that the train loop pinged within ``timeout`` seconds; if not, it
dumps every Python stack and kills the process, which resumes from its last
checkpoint when the scheduler restarts it. ``timeout <= 0`` disables it.
"""

from __future__ import annotations

import faulthandler
import logging
import os
import signal
import sys
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger("espresso_tpu_torch.heartbeat")


def _default_timeout_action(timeout: float) -> None:
    logger.error(
        "no training progress for %.0f s — dumping stacks and killing the "
        "process (resume from the last checkpoint)",
        timeout,
    )
    try:
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
    except Exception:
        pass
    os.kill(os.getpid(), signal.SIGKILL)


class HeartbeatMonitor:
    """Context manager; call ``ping()`` whenever forward progress is made.

    ``on_timeout`` overrides the kill action (used by tests).
    ``timeout <= 0`` disables the monitor entirely."""

    def __init__(
        self,
        timeout: float,
        on_timeout: Optional[Callable[[float], None]] = None,
        poll_interval: Optional[float] = None,
    ):
        self.timeout = float(timeout)
        self.on_timeout = on_timeout or _default_timeout_action
        self.poll = poll_interval if poll_interval is not None else max(
            self.timeout / 10.0, 0.05
        )
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    @property
    def enabled(self) -> bool:
        return self.timeout > 0

    def ping(self) -> None:
        self._last = time.monotonic()

    def _run(self) -> None:
        while not self._stop.wait(self.poll):
            if time.monotonic() - self._last > self.timeout:
                self.fired = True
                self.on_timeout(self.timeout)
                return

    def start(self) -> "HeartbeatMonitor":
        if self.enabled and self._thread is None:
            self._last = time.monotonic()
            self._thread = threading.Thread(
                target=self._run, name="heartbeat", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "HeartbeatMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

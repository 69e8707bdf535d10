"""Fault-tolerance machinery: restart supervision, preemption capture,
heartbeats, straggler detection.

The port of ``repro.distributed.fault``: plain Python, the same classes
and behaviour, kept as the port's own copy.

On a real multi-pod deployment each host runs the same binary; the
coordinator restarts the job on failure and every worker resumes from the
latest checkpoint (ckpt.py is atomic + elastic, so a shrunk/grown slice
restores cleanly).  The pieces here are host-local and testable on CPU:

  * ``run_with_restarts``   — supervision loop: run, catch, restore, retry
  * ``PreemptionHandler``   — SIGTERM/SIGINT -> "save and exit cleanly"
  * ``HeartbeatMonitor``    — per-host liveness files + staleness check
                              (the file protocol stands in for the control
                              plane; tests simulate dead hosts)
  * ``StragglerWatchdog``   — EMA step-time monitor; flags steps slower
                              than k x EMA so the trainer can skip-and-log
                              (at scale: trigger data re-balancing or
                              hot-spare swap)
"""
from __future__ import annotations

import os
import signal
import time
from typing import Callable, Dict, List, Optional


def run_with_restarts(
    fn: Callable[[int], object],
    max_restarts: int = 3,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
):
    """Run ``fn(attempt)`` with supervised restarts on exceptions."""
    last: Optional[BaseException] = None
    for attempt in range(max_restarts + 1):
        try:
            return fn(attempt)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — supervisor catches all
            last = e
            if on_restart is not None:
                on_restart(attempt, e)
    raise RuntimeError(f"exceeded {max_restarts} restarts") from last


class PreemptionHandler:
    """Latches SIGTERM/SIGINT; the train loop polls ``should_stop``."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = False
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self._flag = True

    @property
    def should_stop(self) -> bool:
        return self._flag

    def restore(self) -> None:
        for s, h in self._prev.items():
            signal.signal(s, h)


class HeartbeatMonitor:
    """File-based liveness: each host touches <dir>/<host_id> every beat."""

    def __init__(self, directory: str, host_id: str, timeout_s: float = 60.0):
        self.dir = directory
        self.host_id = host_id
        self.timeout_s = timeout_s
        os.makedirs(directory, exist_ok=True)

    def beat(self, t: Optional[float] = None) -> None:
        path = os.path.join(self.dir, self.host_id)
        with open(path, "w") as f:
            f.write(str(t if t is not None else time.time()))

    def dead_hosts(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.time()
        dead = []
        for h in os.listdir(self.dir):
            with open(os.path.join(self.dir, h)) as f:
                last = float(f.read() or 0)
            if now - last > self.timeout_s:
                dead.append(h)
        return sorted(dead)


class StragglerWatchdog:
    """EMA step-time monitor.  ``observe`` returns True for stragglers."""

    def __init__(self, threshold: float = 3.0, ema_decay: float = 0.9,
                 warmup: int = 5):
        self.threshold = threshold
        self.decay = ema_decay
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.n = 0
        self.flagged: List[int] = []

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = self.n > self.warmup and dt > self.threshold * self.ema
        if is_straggler:
            self.flagged.append(step)
        else:
            # stragglers don't poison the EMA
            self.ema = self.decay * self.ema + (1 - self.decay) * dt
        return is_straggler

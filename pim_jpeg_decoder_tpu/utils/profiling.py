"""Stage profiling with the reference's metric taxonomy.

Equivalent of the reference's timing harness
(reference: src/decoder_host.cpp:82-99 accumulators + :379-394 "Profiles:"
report): monotonic-clock pairs around every pipeline stage, accumulated
globally, printed at exit.  Stage names mirror the reference so numbers are
comparable (BASELINE.md):

  prepare   <- mcu_prepare (scan + entropy decode)       [:202-203]
  queue     <- queue waiting + batch pop                 [:236-238,255-259]
  h2d       <- CPU->DPUs transfer                        [:275-279]
  kernel    <- DPU execution                             [:291-295]
  d2h       <- DPUs->CPU transfer                        [:307-314]
  write     <- BMP write                                 [:325-334]

The reference times its cv.wait and its queue.pop as two stages ("queue
waiting" + "batch pop", reference: src/decoder_host.cpp:236-238,255-259)
because they are two mutex operations there; Python's ``queue.Queue.get``
performs both atomically, so the single "queue" stage here covers both and
no separate "pop" stage exists.

For device-side kernel timing (the reference's per-DPU cycle counters) take
a ``jax.profiler`` trace (CLI ``--profile DIR``); this module is the cheap
always-on host wall-clock layer.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Tuple

STAGES = ("prepare", "queue", "h2d", "kernel", "d2h", "write")


class StageTimers:
    """Thread-safe accumulated wall-clock per pipeline stage."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._acc: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._t0 = time.monotonic()

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - start
            with self._lock:
                self._acc[name] = self._acc.get(name, 0.0) + dt
                self._count[name] = self._count.get(name, 0) + 1

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._acc[name] = self._acc.get(name, 0.0) + seconds
            self._count[name] = self._count.get(name, 0) + 1

    def total(self) -> float:
        return time.monotonic() - self._t0

    def snapshot(self) -> Dict[str, Tuple[float, int]]:
        with self._lock:
            return {k: (self._acc[k], self._count.get(k, 0)) for k in self._acc}

    def report(self, extra: Dict[str, str] | None = None) -> str:
        """Human-readable profile block (reference: decoder_host.cpp:379-394)."""
        snap = self.snapshot()
        lines: List[str] = ["Profiles:"]
        lines.append(f" - Total execution time: {self.total():.6f} (s)")
        labels = {
            "prepare": "MCU prepare (scan + entropy decode) time",
            "queue": "Queue waiting time (incl. batch pop)",
            "h2d": "Host->device transfer time",
            "kernel": "Device kernel execution time",
            "d2h": "Device->host transfer time",
            "write": "BMP write time",
        }
        for key in STAGES:
            if key in snap:
                acc, count = snap[key]
                lines.append(f" - {labels.get(key, key)}: {acc:.6f} (s)")
        for key in sorted(snap):
            if key not in STAGES:
                acc, count = snap[key]
                lines.append(f" - {key}: {acc:.6f} (s)")
        if "kernel" in snap:
            lines.append(f" - The number of device launches: {snap['kernel'][1]}")
        for k, v in (extra or {}).items():
            lines.append(f" - {k}: {v}")
        return "\n".join(lines)

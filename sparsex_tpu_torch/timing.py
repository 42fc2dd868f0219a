"""Timers.

The port's own copy of ``sparsex_tpu/timing.py``,
with its imports pointed at ``sparsex_tpu_torch``: it behaves as the
reference does, so both packages plan alike.

Parity with the reference timing API (``include/sparsex/timing.h:24-85``:
start/pause/get-seconds accumulation) and the internal ``TimerCollection``
(``include/sparsex/internals/TimerCollection.hpp``) used for the
"PREPROCESSING TIMING STATISTICS" report.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional


class Timer:
    """Accumulating wall-clock timer (spx_timer_t parity)."""

    def __init__(self, description: str = ""):
        self.description = description
        self._elapsed = 0.0
        self._start: Optional[float] = None

    def clear(self) -> None:
        self._elapsed = 0.0
        self._start = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def pause(self) -> None:
        if self._start is not None:
            self._elapsed += time.perf_counter() - self._start
            self._start = None

    def get_secs(self) -> float:
        running = 0.0
        if self._start is not None:
            running = time.perf_counter() - self._start
        return self._elapsed + running

    def __enter__(self) -> "Timer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.pause()


class TimerCollection:
    """Named-timer map with a formatted report (TimerCollection parity)."""

    def __init__(self):
        self._timers: Dict[str, Timer] = {}

    def create_timer(self, name: str, description: str = "") -> None:
        self._timers.setdefault(name, Timer(description or name))

    def start_timer(self, name: str) -> None:
        self.create_timer(name)
        self._timers[name].start()

    def pause_timer(self, name: str) -> None:
        if name in self._timers:
            self._timers[name].pause()

    def get_secs(self, name: str) -> float:
        return self._timers[name].get_secs() if name in self._timers else 0.0

    def names(self) -> Iterable[str]:
        return self._timers.keys()

    def report(self) -> str:
        lines = []
        for name, t in self._timers.items():
            lines.append(f"{t.description or name}: {t.get_secs():.6f} s")
        return "\n".join(lines)

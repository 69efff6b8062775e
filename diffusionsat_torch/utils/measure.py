"""Wall-clock timer, the counterpart of the TPU package's
`utils/measure.py`: `lap` reads the seconds since `start` (and asserts
that the timer was started), `stop` reads them and clears the timer."""

from __future__ import annotations

import time


class Timer:
    def __init__(self, start_now: bool = False):
        self._start: float | None = time.perf_counter() if start_now else None

    def start(self) -> None:
        self._start = time.perf_counter()

    def lap(self) -> float:
        assert self._start is not None, "Timer not started"
        return time.perf_counter() - self._start

    def stop(self) -> float:
        elapsed = self.lap()
        self._start = None
        return elapsed

"""Wall-clock timer context (port of ``dal3d_tpu/utils/timer.py``)."""
from __future__ import annotations

import time


class Timer:
    def __init__(self, msg: str | None = None, print_tmpl: str | None = None):
        self.msg = msg
        self.print_tmpl = print_tmpl or "{:.3f}s"
        self._start = None
        self._running = False

    def start(self):
        self._start = time.perf_counter()
        self._running = True

    def since_start(self) -> float:
        if not self._running:
            raise RuntimeError("timer not running")
        return time.perf_counter() - self._start

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        elapsed = self.since_start()
        self._running = False
        if self.msg is not None:
            print(self.msg, self.print_tmpl.format(elapsed))
        return False

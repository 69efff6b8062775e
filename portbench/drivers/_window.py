"""The window every cell shares: calls of the program over a cycle of
units (chunks of train steps, batches to solve), in turn, until the
window's seconds have passed and the cycle is whole, at most two calls in
flight; it ends in a device sync. So every window holds whole cycles, and
its work does not depend on where the clock stopped.

With tracing, whole cycles after the first third of the window are
profiled, at least `TRACE_SECONDS` of them (`harness.traced_stretch`).
"""

from __future__ import annotations

import collections
import time

import torch

from portbench import harness

TRACE_SECONDS = 2.0


class WindowedCell:
    """A subclass sets `self.items` (per unit, a list of dicts of the real
    sizes of its work; "n_graphs" counts formulas or systems) and
    implements `_call(i, outs)`, which enqueues unit i and appends what
    `_finite(outs)` checks."""

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def window(self, seconds: float) -> dict:
        rec, k = self.rec, len(self.items)
        done, outs = [], []
        inflight: collections.deque = collections.deque()
        traced = not self.ctx.trace
        self.sync()
        t0 = time.perf_counter()
        i = 0
        while True:
            if not traced and i % k == 0 and \
                    time.perf_counter() - t0 >= seconds / 3:
                stretch = []
                with harness.traced_stretch(rec, self.sync):
                    t1 = time.perf_counter()
                    while not stretch or \
                            time.perf_counter() - t1 < TRACE_SECONDS:
                        for j in range(k):
                            self._call(j, outs)
                            stretch.append(j)
                rec.counters["stretch_items"] = [
                    it for j in stretch for it in self.items[j]]
                done += stretch
                i += len(stretch)
                traced = True
                continue
            self._call(i % k, outs)
            done.append(i % k)
            ev = None
            if self.dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
            inflight.append(ev)
            while len(inflight) > 2:
                e = inflight.popleft()
                if e is not None:
                    with rec.span("wait"):
                        e.synchronize()
            i += 1
            if i % k == 0 and time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        wall = time.perf_counter() - t0
        self.done = done
        work = [it for c in done for it in self.items[c]]
        return {"seconds": wall, "attempted": self.attempted(work),
                "failed": self.failed(outs),
                "graphs": sum(it["n_graphs"] for it in work)}


"""Spans and counters of the port, to lay over a device trace.

Spans. `span(name, **attrs)` is a context manager that records one
`Span`: its name, start and end in ns, the enclosing span (`parent`, so
self time can be computed) and its attributes. It records only while
torch's profiler records; otherwise it returns one shared no-op context,
and the test is a single attribute read. So a traced stretch of the
benchmark (`portbench/`), or an operator's own `torch.profiler.profile`
around `solve_eval` or `diffusion_training`, turns the spans on; no flag,
variable or option does. The sites sit at the CUDA-graph layer's
boundaries, a few a train chunk or an eval batch, none a round or a
kernel:

    eval.batch       one item of `evaluate_metrics`
    predict.step     `make_predict_step`'s call
    graph.lookup     signature and cache lookup, capture on a miss
    graph.copy_in    inputs into a graph's static buffers
    graph.replay     the replays of one call (replays, segsum_launches)
    graph.copy_out   results out of the buffers

A train chunk (`make_scanned_train_step_for`'s call) records the four
`graph.*` spans alone.

Timestamps are `time.time_ns()`: Unix-epoch ns, the clock of the
profiler's own events (`prof.profiler.kineto_results.events()`), so a
span lays over the kernels of the same trace with no offset. Spans stay
in memory, at most `MAX_SPANS` of them (about 22 MB; later ones are
counted by `dropped()`), until `clear()`. Spans are opened and closed on one thread.

Counters. Named families of counts (`family`), always on. A family is
touched where its work is launched; a CUDA graph snapshots every family
around its capture and credits each replay with what the capture counted
(`cuda_graphs.CapturedGraph`: `counters`, `changes_since`, `restore`,
`credit`). The families:

    segsum.launches  kernel launches per plan direction (`ops/segsum.LAUNCHES`)
    graph            `captures`: graphs recorded; `record_ns`: host time
                     inside the recording block of each capture
"""

from __future__ import annotations

import time

from torch.autograd import profiler as _profiler

MAX_SPANS = 100_000


class Span:
    """One recorded span; `end_ns` is None while it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.parent: Span | None = None
        self.start_ns = self.end_ns = None

    def set(self, **attrs) -> None:
        """Attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        global _current, _dropped
        self.parent = _current
        _current = self
        if len(_spans) < MAX_SPANS:
            _spans.append(self)
        else:
            _dropped += 1
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _current
        self.end_ns = time.time_ns()
        _current = self.parent
        return False


class _NoSpan:
    """The context every site gets while no profiler records. False, so a
    site computes costly attributes only under `if sp:`."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False


NO_SPAN = _NoSpan()
_spans: list[Span] = []
_dropped = 0
_current: Span | None = None


def span(name: str, **attrs) -> Span | _NoSpan:
    """A span named `name` while torch's profiler records, else `NO_SPAN`."""
    if not _profiler._is_profiler_enabled:
        return NO_SPAN
    return Span(name, attrs)


def spans() -> list[Span]:
    """The recorded spans in the order they opened (still open ones too)."""
    return list(_spans)


def dropped() -> int:
    """Spans not kept because `MAX_SPANS` were held."""
    return _dropped


def clear() -> None:
    global _dropped
    _spans.clear()
    _dropped = 0


# ---------------------------------------------------------------------------
# Counters

_families: dict[str, dict[str, int]] = {}


def family(name: str, keys=()) -> dict[str, int]:
    """The counts of family `name`, made at first use with `keys` at 0.
    The dict is the family itself: callers keep it and count into it."""
    fam = _families.get(name)
    if fam is None:
        fam = _families[name] = dict.fromkeys(keys, 0)
    return fam


def counters() -> dict[str, dict[str, int]]:
    """A copy of every family's counts."""
    return {name: dict(fam) for name, fam in _families.items()}


def changes_since(before: dict) -> dict[str, dict[str, int]]:
    """The counts that moved since `before` (a `counters()` copy), by
    family; families and keys that did not move are left out."""
    out = {}
    for name, fam in _families.items():
        old = before.get(name, {})
        moved = {k: n - old.get(k, 0) for k, n in fam.items()
                 if n != old.get(k, 0)}
        if moved:
            out[name] = moved
    return out


def restore(before: dict) -> None:
    """Every family back to `before` (a `counters()` copy), in place."""
    for name, fam in _families.items():
        fam.clear()
        fam.update(before.get(name, {}))


def credit(changes: dict) -> None:
    """Add `changes` (as `changes_since` gives them) to the families."""
    for name, moved in changes.items():
        fam = family(name)
        for k, n in moved.items():
            fam[k] = fam.get(k, 0) + n

"""Share of the traced stretch in which the card idled while the host
looked up a CUDA graph or copied a train chunk into its buffers, in
percent: idle under the program's `graph.lookup` and `graph.copy_in` spans.

The shared reading of every idle split (`idle_*.py` load it from here):
the stretch's idle intervals, the complement of the kernels' union
(`harness.Trace.busy_intervals`), are intersected with the host interval
of each program span (`diffusionsat_torch/tracing.py`) less those of its
children, so every idle ns goes to the innermost span around it; summed
by span name, in percent of the stretch's wall time. Idle outside every
program span (the benchmark's own loop) goes to no part, so the parts sum
to at most `device_idle.*`. A program without spans reads nothing.
"""

import bisect

FEED = ("graph.lookup", "graph.copy_in")
REPLAY = ("graph.replay",)
MODEL_HOST = ("eval.batch", "predict.step")


def program_spans(trace):
    """The program's closed spans inside the stretch, or None where the
    program has no spans or the stretch recorded none."""
    try:
        from diffusionsat_torch import tracing
    except ImportError:
        return None
    if trace is None or not trace.host:
        return None
    lo = min(a for _, a, _ in trace.host)
    hi = max(b for _, _, b in trace.host)
    spans = [s for s in tracing.spans() if s.end_ns is not None
             and lo <= s.start_ns and s.end_ns <= hi]
    return spans or None


class Busy:
    """The union of kernel intervals, for the busy ns inside any [a, b]."""

    def __init__(self, intervals):
        self.starts = [a for a, _ in intervals]
        self.ends = [b for _, b in intervals]
        self.prefix = [0]
        for a, b in intervals:
            self.prefix.append(self.prefix[-1] + b - a)

    def within(self, a: int, b: int) -> int:
        i = bisect.bisect_right(self.ends, a)
        j = bisect.bisect_left(self.starts, b)
        if i >= j:
            return 0
        return (self.prefix[j] - self.prefix[i] - max(0, a - self.starts[i])
                - max(0, self.ends[j - 1] - b))


def self_idle_ns(busy_intervals, spans) -> dict:
    """Idle ns inside each span but inside none of its children, summed by
    span name."""
    busy = Busy(busy_intervals)
    idle = {id(s): (s.end_ns - s.start_ns) - busy.within(s.start_ns,
                                                          s.end_ns)
            for s in spans}
    own = dict(idle)
    for s in spans:
        if s.parent is not None and id(s.parent) in own:
            own[id(s.parent)] -= idle[id(s)]
    out: dict = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + own[id(s)]
    return out


def split(run):
    """Idle by innermost span name, in percent of the stretch, or None."""
    t = run.rec.trace
    spans = program_spans(t)
    if spans is None or t.window_s <= 0:
        return None
    ns = self_idle_ns(t.busy_intervals(), spans)
    return {k: 100.0 * v / 1e9 / t.window_s for k, v in ns.items()}


def share(run, names):
    parts = split(run)
    if parts is None:
        return None
    return sum(parts.get(n, 0.0) for n in names)


def read(run):
    return share(run, FEED)

"""The readers of the program's spans and counters: the idle split on a
synthetic trace, the launches a round, the graph counters, and nothing
read from a program without them."""

import random
import sys
import types

import pytest

from portbench import harness


def _trace(kernels, host, window_ns):
    t = object.__new__(harness.Trace)
    t.kernels = [("k", a, b) for a, b in kernels]
    t.host = host
    t.window_s = window_ns / 1e9
    return t


def _span(name, a, b, parent=None, **attrs):
    return types.SimpleNamespace(name=name, start_ns=a, end_ns=b,
                                 parent=parent, attrs=attrs)


def _solve_batch(at=0):
    """One solving batch's spans, as the program nests them, from `at`."""
    batch = _span("eval.batch", at + 10, at + 990)
    step = _span("predict.step", at + 20, at + 980, batch)
    return [batch, step,
            _span("graph.lookup", at + 30, at + 90, step),
            _span("graph.copy_in", at + 90, at + 150, step),
            _span("graph.replay", at + 150, at + 900, step, replays=64,
                  segsum_launches=256),
            _span("graph.copy_out", at + 900, at + 950, step)]


@pytest.fixture
def run(monkeypatch):
    from diffusionsat_torch import tracing

    spans = _solve_batch()
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    rec = harness.Record()
    # one benchmark span over the batch; kernels in [100, 200],
    # [300, 600] (two that overlap) and [650, 700]; 1200 ns of wall
    rec.trace = _trace([(100, 200), (300, 500), (450, 600), (650, 700)],
                       [("batch", 5, 995)], 1200)
    return types.SimpleNamespace(rec=rec, spans=spans)


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_idle_goes_to_the_innermost_span(run):
    idle = harness.load_module("metrics", "idle_feed.train")
    parts = idle.split(run)
    pct = {k: v * 1200 / 100 for k, v in parts.items()}     # back to ns
    want = {"graph.lookup": 60, "graph.copy_in": 10, "graph.replay": 350,
            "graph.copy_out": 50, "predict.step": 40, "eval.batch": 20}
    assert set(pct) == set(want)
    for k, v in want.items():
        assert pct[k] == pytest.approx(v, abs=1e-9), k
    assert _read("idle_feed.solve", run) == pytest.approx(70 / 12)
    assert _read("idle_feed.train", run) == pytest.approx(70 / 12)
    assert _read("idle_replay.solve", run) == pytest.approx(350 / 12)
    assert _read("idle_replay.train", run) == pytest.approx(350 / 12)
    assert _read("idle_model_host.solve", run) == pytest.approx(60 / 12)


def test_parts_are_non_negative_and_within_device_idle(run):
    device_idle = _read("device_idle.solve", run)
    assert device_idle == pytest.approx(100 * 750 / 1200)
    parts = [_read(n, run) for n in ("idle_feed.solve", "idle_replay.solve",
                                     "idle_model_host.solve")]
    assert all(p >= 0 for p in parts)
    assert sum(parts) <= device_idle
    # the whole split, copy-out included, leaves the time outside every
    # program span (0-10 and 990-1200 ns, where no kernel runs)
    whole = harness.load_module("metrics", "idle_feed.train").split(run)
    assert device_idle - sum(whole.values()) == pytest.approx(
        100 * (10 + 210) / 1200)


def test_spans_outside_the_stretch_are_left_out(run):
    run.spans += _solve_batch(at=5000)
    assert _read("idle_feed.solve", run) == pytest.approx(70 / 12)
    assert _read("segsum_launches.solve", run) == 4.0


@pytest.mark.parametrize("seed", range(5))
def test_busy_within_an_interval_against_a_count_by_ns(seed):
    rnd = random.Random(seed)
    kernels = sorted((a, a + rnd.randint(1, 30)) for a in
                     rnd.sample(range(400), 25))
    busy = _trace(kernels, [], 1).busy_intervals()
    covered = {x for a, b in busy for x in range(a, b)}
    b = harness.load_module("metrics", "idle_feed.train").Busy(busy)
    for _ in range(50):
        lo = rnd.randint(-10, 440)
        hi = lo + rnd.randint(0, 100)
        assert b.within(lo, hi) == sum(1 for x in range(lo, hi)
                                       if x in covered)


def test_launches_a_round_from_the_replay_spans():
    m = harness.load_module("metrics", "segsum_launches.solve")
    spans = _solve_batch() + _solve_batch(at=1000)
    assert m.per_round(spans) == 4.0
    spans[4].attrs.update(replays=10, segsum_launches=30)
    assert m.per_round(spans) == pytest.approx(286 / 74)
    assert m.per_round(_solve_batch()[:2]) is None


def test_graph_counters_at_the_end_of_a_traced_run(run, monkeypatch):
    from diffusionsat_torch import cuda_graphs

    monkeypatch.setitem(cuda_graphs.GRAPHS, "captures", 3)
    monkeypatch.setitem(cuda_graphs.GRAPHS, "record_ns", 2_500_000_000)
    assert _read("graphs_captured", run) == 3
    assert _read("graph_record_s", run) == 2.5
    run.rec.trace = None
    assert _read("graphs_captured", run) is None
    assert _read("graph_record_s", run) is None


def test_a_program_without_spans_or_counters_reads_nothing(run,
                                                           monkeypatch):
    import diffusionsat_torch

    monkeypatch.delattr(diffusionsat_torch, "tracing")
    monkeypatch.setitem(sys.modules, "diffusionsat_torch.tracing", None)
    for name in ("idle_feed.train", "idle_feed.solve", "idle_replay.train",
                 "idle_replay.solve", "idle_model_host.solve",
                 "segsum_launches.solve", "graphs_captured",
                 "graph_record_s"):
        assert _read(name, run) is None, name


def test_no_spans_in_the_stretch_reads_nothing(run, monkeypatch):
    from diffusionsat_torch import tracing

    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert _read("idle_feed.solve", run) is None
    assert _read("segsum_launches.solve", run) is None
    run.rec.trace = None
    assert _read("idle_replay.train", run) is None

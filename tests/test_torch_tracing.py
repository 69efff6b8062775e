"""The port's spans and counters (`diffusionsat_torch/tracing.py`): spans
record only under torch's profiler, on the clock of its events, with their
parent and attributes; the CUDA-graph layer's calls record their spans on
the CPU as on the card; `segsum.LAUNCHES` is a counter family.

CPU only and fast: a tiny round loop and a tiny dense train chunk."""

import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from diffusionsat_torch import cuda_graphs, tracing
from diffusionsat_torch.graph import dense_batch as tdb
from diffusionsat_torch.graph.batch import BucketSpec, build_batch
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.models.query_sat_dense import query_sat_dense_apply
from diffusionsat_torch.ops import segsum
from diffusionsat_torch.train.adabelief import adabelief
from diffusionsat_torch.train import loop as tloop

GRAPH_SPANS = ["graph.lookup", "graph.copy_in", "graph.replay",
               "graph.copy_out"]


@pytest.fixture(autouse=True)
def no_spans():
    tracing.clear()
    yield
    tracing.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _names(spans):
    return [s.name for s in spans]


def test_nothing_is_recorded_without_a_profiler():
    assert tracing.span("x", a=1) is tracing.NO_SPAN
    with tracing.span("x") as sp:
        assert not sp
        with tracing.span("y"):
            pass
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_nested_spans_carry_parent_and_attrs():
    with _profiled():
        with tracing.span("outer", steps=3) as outer:
            with tracing.span("inner") as inner:
                inner.set(hit=True)
            with tracing.span("second"):
                pass
    spans = tracing.spans()
    assert _names(spans) == ["outer", "inner", "second"]
    assert outer.attrs == {"steps": 3} and inner.attrs == {"hit": True}
    assert outer.parent is None
    assert spans[1].parent is outer and spans[2].parent is outer
    for s in spans:
        assert s.start_ns <= s.end_ns
        assert outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns
    assert spans[1].end_ns <= spans[2].start_ns
    # off again once the profiler stops
    assert tracing.span("after") is tracing.NO_SPAN


def test_spans_are_on_the_clock_of_the_profilers_events():
    reps = 21
    with _profiled() as prof:
        with record_function("warm"):
            pass
        for i in range(reps):
            with tracing.span(f"s{i}"):
                with record_function(f"r{i}"):
                    torch.ones(4).add_(1)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    spans = {s.name: s for s in tracing.spans()}
    lead, tail = [], []
    for i in range(reps):
        e, s = events[f"r{i}"], spans[f"s{i}"]
        lead.append(e.start_ns() - s.start_ns)
        tail.append(s.end_ns - (e.start_ns() + e.duration_ns()))
    # the span opens before the range and closes after it, by a few us
    for gap in (statistics.median(lead), statistics.median(tail)):
        assert -2_000 <= gap <= 20_000, (lead, tail)


def test_run_rounds_records_the_graph_layers_spans():
    def make_round(ctx):
        def step(carry, gen, noise):
            x, done = carry
            return x * ctx["w"] + 1.0, done
        return step

    ctx = {"w": torch.full((4,), 2.0)}
    carry = (torch.zeros(4), torch.zeros((), dtype=torch.bool))
    cuda_graphs.clear_round_graphs()
    try:
        with _profiled():
            with tracing.span("caller") as caller:
                out = cuda_graphs.run_rounds(make_round, ("t",), ctx, carry,
                                             3, None)
            again = cuda_graphs.run_rounds(make_round, ("t",), ctx, carry,
                                           3, None)
    finally:
        cuda_graphs.clear_round_graphs()
    assert out[0].tolist() == again[0].tolist() == [7.0] * 4
    spans = tracing.spans()
    assert _names(spans) == ["caller"] + GRAPH_SPANS + GRAPH_SPANS
    first, second = spans[1:5], spans[5:]
    assert all(s.parent is caller for s in first)
    assert all(s.parent is None for s in second)
    # one replay span a call, the only span with attributes; the CPU's
    # plain sums launch no kernel
    for call in (first, second):
        assert [s.attrs for s in call] == [
            {}, {}, {"replays": 3, "segsum_launches": 0}, {}]


def _dense_chunk(n_batches=2):
    rng = np.random.default_rng(0)
    flats = []
    for _ in range(n_batches):
        formulas = []
        for _ in range(3):
            n = int(rng.integers(3, 6))
            formulas.append((n, [
                [int(v) if rng.random() < 0.5 else -int(v)
                 for v in rng.choice(n, size=3, replace=False) + 1]
                for _ in range(3 * n)]))
        flats.append(build_batch(formulas, BucketSpec(32, 64, 256, 4)))
    return tloop.stack_batches(tdb.densify_batches(flats))


def test_mega_step_records_the_graph_layers_spans(monkeypatch):
    monkeypatch.setattr(cuda_graphs, "graphs_enabled", lambda dev: True)
    cfg = tqs.QuerySATConfig(feature_maps=8, query_maps=4, logit_maps=2,
                             train_rounds=1, test_rounds=1)
    opt = adabelief(learning_rate=1e-2)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tqs.query_sat_init(gen, cfg)
    state = tloop.TrainState(params, opt.init(params), 0, gen)
    mega = tloop.make_scanned_train_step_for(query_sat_dense_apply, cfg,
                                             opt, "cpu")
    chunk = _dense_chunk()
    with _profiled():
        with tracing.span("caller") as caller:
            state, _ = mega(state, chunk)
        state, _ = mega(state, chunk)
    spans = tracing.spans()
    assert _names(spans) == ["caller"] + GRAPH_SPANS * 2
    first, second = spans[1:5], spans[5:]
    assert all(s.parent is caller for s in first)
    assert all(s.parent is None for s in second)
    for call in (first, second):
        # one replay a chunk
        assert [s.attrs for s in call] == [
            {}, {}, {"replays": 1, "segsum_launches": 0}, {}]
        assert all(a.end_ns <= b.start_ns for a, b in zip(call, call[1:]))


def test_segsum_launches_is_a_counter_family():
    assert segsum.LAUNCHES is tracing.family(segsum.LAUNCH_FAMILY)
    segsum.reset_launch_counts()
    try:
        assert segsum.LAUNCHES == {"lit_to_clause": 0, "clause_to_lit": 0}
        before = tracing.counters()
        segsum.LAUNCHES["lit_to_clause"] += 2
        segsum.LAUNCHES["node_to_clause"] = 1
        moved = tracing.changes_since(before)
        assert moved == {segsum.LAUNCH_FAMILY: {"lit_to_clause": 2,
                                                "node_to_clause": 1}}
        tracing.restore(before)
        assert segsum.LAUNCHES == {"lit_to_clause": 0, "clause_to_lit": 0}
        tracing.credit(moved)
        tracing.credit(moved)
        assert segsum.LAUNCHES == {"lit_to_clause": 4, "clause_to_lit": 0,
                                   "node_to_clause": 2}
        assert segsum.LAUNCHES is tracing.family(segsum.LAUNCH_FAMILY)
    finally:
        segsum.reset_launch_counts()


def test_spans_past_the_bound_are_counted_not_kept(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 2)
    with _profiled():
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    assert _names(tracing.spans()) == ["s0", "s1"]
    assert tracing.dropped() == 3

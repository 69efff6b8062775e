"""`lowp_tc_share.train`: the share of a replay's f32-accumulating
products on the card's routes, read from the replay spans' attributes;
nothing read where the spans carry no product counts (a program that
does not count them)."""

import types

import pytest

from portbench import harness


def _span(name, **attrs):
    return types.SimpleNamespace(name=name, start_ns=0, end_ns=1,
                                 parent=None, attrs=attrs)


def _share(spans):
    return harness.load_module("metrics", "lowp_tc_share.train").share(spans)


def test_every_product_on_the_card_reads_100():
    spans = [_span("graph.lookup"),
             _span("graph.replay", replays=1, segsum_launches=0,
                   lowp_tensor_core=96, lowp_split=160),
             _span("graph.replay", replays=1, segsum_launches=0,
                   lowp_tensor_core=48, lowp_split=80)]
    assert _share(spans) == 100.0


def test_plain_products_count_against_the_share():
    spans = [_span("graph.replay", lowp_tensor_core=30, lowp_split=30,
                   lowp_plain=20),
             _span("graph.copy_in", lowp_plain=1000)]
    assert _share(spans) == pytest.approx(75.0)


def test_replays_without_product_counts_read_nothing(monkeypatch):
    assert _share([_span("graph.replay", replays=1,
                         segsum_launches=128)]) is None
    assert _share([]) is None
    from diffusionsat_torch import tracing

    monkeypatch.setattr(tracing, "spans", lambda: [
        _span("graph.replay", replays=1, segsum_launches=4)])
    rec = harness.Record()
    rec.trace = object.__new__(harness.Trace)
    rec.trace.kernels, rec.trace.host, rec.trace.window_s = [], [], 1.0
    run = types.SimpleNamespace(rec=rec)
    # no benchmark span in the stretch: nothing to read
    assert harness.load_module("metrics", "lowp_tc_share.train").read(
        run) is None

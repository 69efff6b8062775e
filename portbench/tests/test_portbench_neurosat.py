"""The `neurosat-train-flat` and `qs-train-dense-f32` cells on the CPU, at
sizes of their own: NeuroSAT follows its plain reference in f32; a state
left unchanged and a chunk whose later steps repeat its third read
`correct` false; the FLOP count against a hand count; the dense f32 mix
resolves and runs; the `lstm_launches.train` reader."""

import contextlib
import types

import pytest

from portbench import harness
from portbench import run as run_mod

SMALL = {
    "neurosat-train-flat": {
        "config": {"feature_maps": 16, "rounds": 4},
        "traffic": {"formulas_per_size": 4, "node_budget": 600,
                    "mega_steps": 4}},
    "qs-train-dense-f32": {
        "config": {"feature_maps": 16, "query_maps": 16, "train_rounds": 4},
        "traffic": {"formulas_per_size": 4, "node_budget": 600,
                    "mega_steps": 4}},
}


def run_small(workload, fault=contextlib.nullcontext(), seed=2 ** 31 + 7):
    args = types.SimpleNamespace(workload=workload, seed=seed, seconds=0.5,
                                 trace=0)
    with fault:
        return run_mod.run(args, device="cpu", overrides=SMALL[workload])


@contextlib.contextmanager
def state_unchanged():
    from diffusionsat_torch.train.adabelief import AdaBelief
    orig = AdaBelief.update
    AdaBelief.update = lambda self, grads, state, params: (params, state)
    try:
        yield
    finally:
        AdaBelief.update = orig


@contextlib.contextmanager
def rows_past_two_repeat_row_two():
    """A chunk's steps past its third train on the third step's rows."""
    from diffusionsat_torch import cuda_graphs
    orig = cuda_graphs.index_tree
    cuda_graphs.index_tree = lambda tree, i: orig(tree, min(i, 2))
    try:
        yield
    finally:
        cuda_graphs.index_tree = orig


@pytest.mark.parametrize("workload", list(SMALL))
def test_the_cell_follows_its_reference(workload):
    res = run_small(workload)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"train_graphs_per_s", "setup_s"}
    limits = harness.load_json("traffic", run_mod.cell_spec(workload)[
        "traffic"])["limits"]
    assert set(res["checks"]) == set(limits[run_mod.cell_spec(workload)[
        "config"]])


def test_a_step_that_leaves_its_state_unchanged():
    res = run_small("neurosat-train-flat", state_unchanged())
    assert res["correct"] is False
    assert res["checks"]["change3_gap"]["value"] == pytest.approx(1.0)


def test_a_chunk_that_repeats_a_row():
    res = run_small("neurosat-train-flat", rows_past_two_repeat_row_two())
    assert res["correct"] is False
    assert res["checks"]["loss_gap"]["value"] > \
        res["checks"]["loss_gap"]["limit"]


def test_the_flop_count_by_hand():
    """d = 128, 32 rounds; 10 variables (20 literal rows), 40 clauses, 120
    edges. A round's multiply-adds: MLPs 20 x 3 x 128^2 + 40 x 3 x 128^2 +
    10 x (256^2 + 256^2 + 256); LSTMs 40 x (128 + 128) x 512 + 20 x (256 +
    128) x 512; sums 2 x 120 x 128. A step: 2 FLOPs a multiply-add, 32
    rounds, forward and twice that backward."""
    flops = harness.load_module("flops", "neurosat-3sat-128")
    cfg = harness.load_json("configs", "neurosat-3sat-128")
    got = flops.step_flops(cfg, {"n_vars": 10, "n_clauses": 40,
                                 "n_edges": 120}, "train")
    step = 2 * 32 * 3
    assert got == {"mlp": (983_040 + 1_966_080 + 1_313_280) * step,
                   "lstm": (5_242_880 + 3_932_160) * step,
                   "incidence": 30_720 * step}


class Span:
    def __init__(self, name, **attrs):
        self.name, self.attrs = name, attrs


def test_lstm_launches_a_step():
    metric = harness.load_module("metrics", "lstm_launches.train")
    spans = [Span("graph.replay", replays=1, lstm_launches=8 * 834),
             Span("graph.copy_in"),
             Span("graph.replay", replays=1, lstm_launches=8 * 834)]
    assert metric.per_step(spans, 8) == 834
    # a program without the family reads nothing
    assert metric.per_step([Span("graph.replay", replays=1,
                                 segsum_launches=4)], 8) is None
    run = types.SimpleNamespace(rec=types.SimpleNamespace(trace=None),
                                traffic={"mega_steps": 8})
    assert metric.read(run) is None

"""The `lstm` counter family (`nn/lstm.COUNTS`) on the CPU: a cell per
forward call, and no launch outside a capture; what a cell's forward and
backward would add to a graph under capture, with the graph's node count
stood in for by the operators dispatched; NeuroSAT's rounds; the counts a
graphed chunk runs, once a replay; and a replay span's `lstm_<key>`
attributes. The launches against the profiler's kernels are a card test
(`tests/test_torch_main_mega_cuda.py`)."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from diffusionsat_torch import cuda_graphs, tracing
from diffusionsat_torch.graph.batch import BucketSpec, build_batch
from diffusionsat_torch.models import neuro_sat as ns
from diffusionsat_torch.nn import lstm
from diffusionsat_torch.train.adabelief import adabelief
from diffusionsat_torch.train.loop import (
    TrainState,
    chunk_batches,
    make_scanned_train_step_for,
    plan_batches,
)

CFG = ns.NeuroSATConfig(feature_maps=8, rounds=3)


def _moved(before):
    return tracing.changes_since(before).get(lstm.FAMILY, {})


def _cell(gen, rows=5, hidden=4):
    p = lstm.lstm_init(gen, 6, hidden)
    x = torch.randn((rows, 6), generator=gen)
    c = torch.zeros((rows, hidden))
    return p, x, c


@pytest.mark.parametrize("expanded", [False, True])
def test_a_cell_counts_one_cell_and_no_launch_outside_a_capture(expanded):
    gen = torch.Generator().manual_seed(0)
    p, x, c = _cell(gen)
    h = torch.randn((1, 4), generator=gen)
    h = h.expand(5, 4) if expanded else h.repeat(5, 1)
    before = tracing.counters()
    lstm.lstm_apply(p, x, (h, c))
    lstm.lstm_apply(p, x, (h.contiguous(), c))
    assert _moved(before) == {"cells": 2}


class _Ops(TorchDispatchMode):
    """Counts the operators dispatched: the stand-in for a graph's nodes."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def capturing(monkeypatch):
    """A capture stood in for on the CPU: the node count is the operators
    dispatched so far."""
    ops = _Ops()
    monkeypatch.setattr(cuda_graphs, "capturing_stream", lambda dev: 7)
    monkeypatch.setattr(cuda_graphs, "capture_nodes", lambda s: ops.n)
    with ops:
        yield ops


@pytest.mark.parametrize("first_round", [False, True])
def test_a_cell_counts_what_its_forward_and_backward_add(capturing,
                                                         first_round):
    """Everything between the forward's entry and the backward's exit is
    the cell's: with the gradient taken of its two outputs, every operator
    dispatched is counted. In NeuroSAT's first round h is an init row
    expanded and c holds no gradient."""
    gen = torch.Generator().manual_seed(0)
    p, x, c = _cell(gen)
    p = {k: v.requires_grad_() for k, v in p.items()}
    x.requires_grad_()
    h = torch.randn((1, 4), generator=gen)
    h = (h.expand(5, 4) if first_round else h.repeat(5, 1)).detach()
    h.requires_grad_()
    if not first_round:
        c = torch.randn((5, 4), generator=gen).requires_grad_()
    gh, gc = torch.ones((5, 4)), torch.full((5, 4), 0.5)
    wrt = [x, h, *p.values()] + ([] if first_round else [c])
    before, n0 = tracing.counters(), capturing.n
    h_new, (_, c_new) = lstm.lstm_apply(p, x, (h, c))
    forward = capturing.n - n0
    torch.autograd.grad((h_new, c_new), wrt, (gh, gc))
    moved = _moved(before)
    assert moved["cells"] == 1
    assert moved["launches"] == capturing.n - n0 > 2 * forward


def _batches(n):
    gen = torch.Generator().manual_seed(1)
    out = []
    for _ in range(n):
        clauses = (torch.randint(1, 6, (12, 3), generator=gen) *
                   (2 * torch.randint(0, 2, (12, 3), generator=gen) - 1))
        out.append(build_batch([(5, clauses.tolist())],
                               BucketSpec(64, 128, 512, 4)))
    return out


def test_neurosat_counts_two_cells_a_round():
    """Each round runs the clause and the literal cell; the first round's
    states are the init rows expanded, so each of its cells copies h."""
    params = ns.neuro_sat_init(torch.Generator().manual_seed(2), CFG)
    before = tracing.counters()
    ns.neuro_sat_apply(params, CFG, _batches(1)[0], device="cpu")
    assert _moved(before) == {"cells": 2 * CFG.rounds}


def test_neurosat_cells_backward_one_at_a_time(capturing, monkeypatch):
    """In a NeuroSAT step's backward each cell's block runs whole: autograd
    enters a cell and leaves it before it enters the next. The launches
    counted are the same for every call, and less than the step
    dispatches in all."""
    log = []
    count_backward = lstm._count_backward

    def logged(stream, first, last):
        i = len(log)
        first.register_prehook(lambda g: log.append(("enter", i)))
        last.register_hook(lambda gi, go: log.append(("leave", i)))
        log.append(None)
        count_backward(stream, first, last)
    monkeypatch.setattr(lstm, "_count_backward", logged)
    params = ns.neuro_sat_init(torch.Generator().manual_seed(2), CFG)
    for t in cuda_graphs.tree_leaves(params):
        t.requires_grad_()
    batch = _batches(1)[0]
    counted = []
    for _ in range(2):
        log.clear()
        before, n0 = tracing.counters(), capturing.n
        _, loss, _, _ = ns.neuro_sat_apply(params, CFG, batch,
                                           training=True, device="cpu")
        loss.backward()
        moved = _moved(before)
        assert moved["cells"] == 2 * CFG.rounds
        assert 0 < moved["launches"] < capturing.n - n0
        counted.append(moved["launches"])
        blocks = [e for e in log if e is not None]
        assert len(blocks) == 4 * CFG.rounds
        assert all(blocks[k] == ("enter", blocks[k + 1][1]) and
                   blocks[k + 1][0] == "leave"
                   for k in range(0, len(blocks), 2))
    assert counted[0] == counted[1]


def test_a_graphed_chunk_counts_its_steps_once_a_replay(monkeypatch):
    """On the CPU a replay runs the chunk's function on the buffers, so the
    family moves by the chunk's steps at each call, and by nothing else."""
    monkeypatch.setattr(cuda_graphs, "graphs_enabled", lambda dev: True)
    params = ns.neuro_sat_init(torch.Generator().manual_seed(3), CFG)
    opt = adabelief(learning_rate=1e-3, eps=1e-8, clip_gradients=True)
    mega = make_scanned_train_step_for(ns.neuro_sat_apply, CFG, opt, "cpu")
    chunk, = chunk_batches(plan_batches(_batches(2), "cpu"), 2, "cpu")
    state = TrainState(params=params, opt_state=opt.init(params), step=0,
                       generator=torch.Generator())
    a_step = {"cells": 2 * CFG.rounds}
    for _ in range(2):
        before = tracing.counters()
        state, _ = mega(state, chunk)
        assert _moved(before) == {k: 2 * v for k, v in a_step.items()}
    assert state.step == 4


def test_a_replay_span_carries_the_lstm_counts():
    graph = cuda_graphs.CapturedGraph(lambda static, gen: None, (),
                                      torch.device("cpu"),
                                      with_generator=False)
    graph.counts = {lstm.FAMILY: {"cells": 64, "launches": 834},
                    "lowp": {"plain": 5}}
    attrs = graph.replay_attrs(3)
    assert attrs["lstm_cells"] == 192 and attrs["lstm_launches"] == 2502
    assert attrs["lowp_plain"] == 15 and attrs["replays"] == 3

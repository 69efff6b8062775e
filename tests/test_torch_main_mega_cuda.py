"""`main --mega_steps` on the card: NeuroSAT's graphed chunk against the
same eager steps, bit for bit, at `main`'s width on 20k-node batches; the
`lstm` family's launches, counted in a captured cell's forward and
backward, against the kernels the profiler sees in a replay of that graph
and in the same cell run eagerly; one replay credited once.

Needs an NVIDIA card; skips elsewhere. This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_main_mega_cuda.py
"""

import numpy as np
import pytest
import torch

from diffusionsat_torch import cuda_graphs, tracing
from diffusionsat_torch.graph.batch import BucketSpec, build_batch
from diffusionsat_torch.models import neuro_sat as ns
from diffusionsat_torch.nn import lstm
from diffusionsat_torch.train.adabelief import adabelief
from diffusionsat_torch.train.loop import (
    TrainState,
    chunk_batches,
    make_scanned_train_step_for,
    make_train_step_for,
    plan_batches,
)
from portbench.gen import threshold_3sat as gen3

CFG = ns.NeuroSATConfig(feature_maps=128)     # main's width, 32 rounds
STEPS = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _planned(dev):
    """The first STEPS 20k-node batches of shuffled threshold 3-SAT, with
    their padded plans."""
    traffic = dict(min_vars=3, max_vars=30, formulas_per_size=60)
    limits = gen3.bucket_limits(20000, 512)
    raw = gen3.pack(gen3.sized_pool(np.random.default_rng(5), traffic),
                    20000, limits, sort=False)[:STEPS]
    bucket = BucketSpec(**limits)
    return plan_batches([build_batch([(n, c) for n, c, _ in b], bucket)
                         for b in raw], dev)


def _state(opt, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = ns.neuro_sat_init(gen, CFG)
    return TrainState(params=params, opt_state=opt.init(params), step=0,
                      generator=gen)


@pytest.mark.cuda
def test_a_graphed_chunk_equals_the_eager_steps_bit_for_bit(cuda):
    opt = adabelief(learning_rate=3e-4, eps=1e-8, clip_gradients=True)
    planned = _planned(cuda)
    eager = make_train_step_for(ns.neuro_sat_apply, CFG, opt, cuda)
    st, losses = _state(opt, cuda), []
    for b, p in planned:
        st, out = eager(st, b, p)
        losses.append(out["loss"])
    mega = make_scanned_train_step_for(ns.neuro_sat_apply, CFG, opt, cuda)
    chunk, = chunk_batches(planned, STEPS, cuda)
    gst, out = mega(_state(opt, cuda), chunk)
    torch.cuda.synchronize()
    assert gst.step == st.step == STEPS
    assert torch.equal(out["loss_per_step"], torch.stack(losses))
    for a, b in zip(cuda_graphs.tree_leaves((gst.params, gst.opt_state)),
                    cuda_graphs.tree_leaves((st.params, st.opt_state)),
                    strict=True):
        assert torch.equal(a, b)


def _kernels(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()                        # warm: handles, workspaces
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,rows,first_round", [
    ("C_update", 14_080, False), ("L_update", 6_624, False),
    ("C_update", 14_080, True), ("L_update", 6_624, True)])
def test_the_counted_launches_are_the_profiled_kernels(cuda, cell, rows,
                                                       first_round):
    """One cell's forward and the gradient of its two outputs, at a 20k
    batch's rows (clauses, literals), captured as a graph: the launches
    its capture counted are the kernels, memsets and copies the profiler
    sees in a replay, and in the same call run eagerly. In NeuroSAT's
    first round h is the init row expanded and c holds no gradient."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    params = {k: v.requires_grad_()
              for k, v in ns.neuro_sat_init(gen, CFG)[cell].items()}
    f = CFG.feature_maps
    x = torch.randn((rows, params["kernel"].shape[0]), device=cuda)
    h = torch.randn((1, f), device=cuda).expand(rows, f)
    h = (h if first_round else h.contiguous()).detach().requires_grad_()
    c = torch.zeros((rows, f), device=cuda)
    if not first_round:
        c = torch.randn((rows, f), device=cuda).requires_grad_()
    x.requires_grad_()
    wrt = [x, h, *params.values()] + ([] if first_round else [c])
    grads = []

    def fn(static, generator):
        xs, hs, cs, gh, gc = static
        h_new, (_, c_new) = lstm.lstm_apply(params, xs, (hs, cs))
        grads[:] = torch.autograd.grad((h_new, c_new), wrt, (gh, gc))

    static = (x, h, c, torch.ones((rows, f), device=cuda),
              torch.full((rows, f), 0.5, device=cuda))
    graph = cuda_graphs.CapturedGraph(fn, static, cuda, with_generator=False)
    counted = graph.counts[lstm.FAMILY]
    assert counted["cells"] == 1
    replayed = _kernels(graph.replay)
    eager = _kernels(lambda: fn(static, None))
    assert counted["launches"] == len(replayed), replayed
    assert counted["launches"] == len(eager), eager


@pytest.mark.cuda
def test_a_replay_is_credited_once(cuda):
    """The warm-up and the capture count nothing; each call's one replay
    credits one chunk's cells and launches."""
    opt = adabelief(learning_rate=3e-4, eps=1e-8, clip_gradients=True)
    mega = make_scanned_train_step_for(ns.neuro_sat_apply, CFG, opt, cuda)
    chunk, = chunk_batches(_planned(cuda), STEPS, cuda)
    state = _state(opt, cuda)
    moved = []
    for _ in range(2):
        before = tracing.counters()
        state, _ = mega(state, chunk)
        moved.append(tracing.changes_since(before)[lstm.FAMILY])
    assert moved[0] == moved[1]
    assert moved[0]["cells"] == STEPS * 2 * CFG.rounds
    # every step of the chunk has the same shapes, so the same launches
    assert moved[0]["launches"] > 0 and moved[0]["launches"] % STEPS == 0

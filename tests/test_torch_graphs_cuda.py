"""CUDA graphs on the card: graphed train chunks and graphed inference
rounds against their eager counterparts, bit for bit, with the same kernel
launch counts; the plain segment sums in one fixed order.

Needs an NVIDIA card and nvcc; skips elsewhere. This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_graphs_cuda.py
"""

import numpy as np
import pytest
import torch

from diffusionsat_torch import cuda_graphs
from diffusionsat_torch.graph import dense_batch as tdb
from diffusionsat_torch.graph.batch import BucketSpec, build_batch
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.models.query_sat_dense import query_sat_dense_apply
from diffusionsat_torch.ops import graph_ops, segsum
from diffusionsat_torch.train.adabelief import adabelief
from diffusionsat_torch.train.loop import (
    TrainState,
    make_scanned_train_step_for,
    make_train_step_for,
    stack_batches,
)

SMALL = dict(feature_maps=32, query_maps=16, logit_maps=4, train_rounds=3,
             test_rounds=6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _flat(seed, n_formulas=12):
    rng = np.random.default_rng(seed)
    formulas = []
    for _ in range(n_formulas):
        n = int(rng.integers(5, 12))
        formulas.append((n, [
            [int(v) if rng.random() < 0.5 else -int(v)
             for v in rng.choice(n, size=3, replace=False) + 1]
            for _ in range(4 * n)]))
    sols = [rng.integers(0, 2, size=n).tolist() for n, _ in formulas]
    return build_batch(formulas, BucketSpec(256, 1024, 4096, 16),
                       solutions=sols)


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _state(cfg, opt, dev):
    p = tqs.query_sat_init(_gen(dev, 0), cfg)
    return TrainState(params=p, opt_state=opt.init(p), step=0,
                      generator=_gen(dev, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("block_bf16", [False, True])
def test_graphed_chunk_equals_eager_steps_bit_for_bit(cuda, block_bf16):
    cfg = tqs.QuerySATConfig(**SMALL, block_bf16=block_bf16)
    opt = adabelief(learning_rate=1e-3)
    batches = [b.to(cuda) for b in
               tdb.densify_batches([_flat(s) for s in range(4)])]
    step = make_train_step_for(query_sat_dense_apply, cfg, opt, cuda)
    eager = _state(cfg, opt, cuda)
    losses = []
    for b in batches:
        eager, out = step(eager, b)
        losses.append(out["loss"])
    mega = make_scanned_train_step_for(query_sat_dense_apply, cfg, opt, cuda)
    graphed, out = mega(_state(cfg, opt, cuda), stack_batches(batches))
    assert graphed.step == 4
    assert torch.equal(torch.stack(losses), out["loss_per_step"])
    for a, b in zip(cuda_graphs.tree_leaves((eager.params, eager.opt_state)),
                    cuda_graphs.tree_leaves((graphed.params,
                                             graphed.opt_state))):
        assert torch.equal(a, b)
    assert torch.equal(eager.generator.get_state(),
                       graphed.generator.get_state())
    # a second chunk replays the graph on the state it handed back
    again, _ = mega(graphed, stack_batches(batches))
    for b in batches:
        eager, _ = step(eager, b)
    for a, b in zip(cuda_graphs.tree_leaves(eager.params),
                    cuda_graphs.tree_leaves(again.params)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_graphed_rounds_equal_eager_rounds(cuda, layout):
    cfg = tqs.QuerySATConfig(**SMALL)
    params = tqs.query_sat_init(_gen(cuda, 0), cfg)
    flat = _flat(7)
    if layout == "flat":
        batch, apply = flat.to(cuda), tqs.query_sat_apply
        kw = {"plans": segsum.build_batch_plans(flat, pad=True).to(cuda)}
    else:
        batch = tdb.densify_batches_quantized([flat])[0].to(cuda)
        apply, kw = query_sat_dense_apply, {}
    outs, launches = {}, {}
    for mode in ("eager", "graph"):
        segsum.reset_launch_counts()
        g = _gen(cuda, 3)
        if mode == "eager":
            with cuda_graphs.eager():
                out = apply(params, cfg, batch, g, device=cuda, **kw)
        else:
            out = apply(params, cfg, batch, g, device=cuda, **kw)
        torch.cuda.synchronize()
        outs[mode] = (out, g.get_state())
        launches[mode] = dict(segsum.LAUNCHES)
    for a, b in zip(cuda_graphs.tree_leaves(outs["eager"]),
                    cuda_graphs.tree_leaves(outs["graph"])):
        assert torch.equal(a, b)
    assert launches["eager"] == launches["graph"]
    if layout == "flat":
        assert launches["graph"]["lit_to_clause"] > 0
    cuda_graphs.clear_round_graphs()


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [3000, 166, 1])
def test_plain_segment_sums_are_deterministic(cuda, segments):
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(np.sort(rng.integers(
        0, segments, 100_000)).astype(np.int32)).to(cuda)
    data = torch.randn((100_000, 64), generator=_gen(cuda, 0), device=cuda)
    a = graph_ops.segment_sum(data, ids, segments)
    b = graph_ops.segment_sum(data, ids, segments)
    assert torch.equal(a, b)
    # the blocks sum the right rows: in f64 the order leaves ~1e-16
    wide = data.double()
    got = graph_ops.segment_sum(wide, ids, segments)
    want = torch.zeros((segments, 64), dtype=torch.float64,
                       device=cuda).index_add_(0, ids.long(), wide)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-9)

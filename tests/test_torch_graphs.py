"""Graphed round loops and graphed train chunks, their buffers on the CPU;
padded plans; the fixed-order segment sums.

The CUDA graphs themselves exist only on the card (`tests/
test_torch_graphs_cuda.py`). On the CPU, `cuda_graphs.CapturedGraph`
captures nothing and each "replay" calls the captured function on the
static buffers, so with the graphs switched on here (`graphs_enabled`
patched) the tests run the same buffer plumbing the card runs: the copies
of ctx, carry and chunk into the buffers, the generator lent to the graph
and handed back, the early-exit flag between replays, the state written
back in place. Each graphed path must equal its eager path bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import anf_batch_pair, anf_items, batch_pair
from _torch_parity import random_formulas
from diffusionsat_torch import cuda_graphs
from diffusionsat_torch.diffusion.sampler import make_diffusion_chain
from diffusionsat_torch.graph import dense_batch as tdb
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.models.anf_sat import (
    ANFSATConfig,
    anf_sat_apply,
    anf_sat_init,
)
from diffusionsat_torch.models.query_sat_dense import query_sat_dense_apply
from diffusionsat_torch.ops import graph_ops, segsum
from diffusionsat_torch.train import adabelief as tab
from diffusionsat_torch.train import loop as tloop

SMALL = dict(feature_maps=16, query_maps=8, logit_maps=4, test_rounds=5,
             train_rounds=2)


@pytest.fixture
def graphed(monkeypatch):
    """Switch the graph paths on for CPU tensors (no capture there)."""
    cuda_graphs.clear_round_graphs()
    monkeypatch.setattr(cuda_graphs, "graphs_enabled", lambda dev: True)
    yield
    cuda_graphs.clear_round_graphs()


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _flat(seed=1, n=5):
    return batch_pair(*random_formulas(seed, n_formulas=n))[1]


def _assert_outputs_equal(a, b):
    la, lb = cuda_graphs.tree_leaves(a), cuda_graphs.tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _both(monkeypatch, run):
    """run() eagerly, then with the graphs on (twice: a captured graph is
    reused by the second call)."""
    eager = run()
    cuda_graphs.clear_round_graphs()
    monkeypatch.setattr(cuda_graphs, "graphs_enabled", lambda dev: True)
    try:
        first = run()
        again = run()
        assert len(cuda_graphs._ROUND_GRAPHS) == 1
    finally:
        cuda_graphs.clear_round_graphs()
    return eager, first, again


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("layout", ["flat", "flat_plans", "dense",
                                    "dense_bf16"])
def test_graphed_rounds_equal_eager_rounds(layout, early_exit, monkeypatch):
    tb = _flat()
    cfg = tqs.QuerySATConfig(**SMALL, block_bf16=layout == "dense_bf16")
    params = tqs.query_sat_init(_gen(0), cfg)
    plans = segsum.build_batch_plans(tb, pad=True) \
        if layout == "flat_plans" else None
    if layout.startswith("dense"):
        tb = tdb.densify_batches_quantized([tb])[0]
        apply = query_sat_dense_apply
    else:
        apply = tqs.query_sat_apply

    def run():
        g = _gen(3)
        kw = {} if plans is None else {"plans": plans}
        out = apply(params, cfg, tb, g, early_exit=early_exit,
                    device="cpu", **kw)
        return out, g.get_state()

    eager, first, again = _both(monkeypatch, run)
    _assert_outputs_equal(eager, first)
    _assert_outputs_equal(eager, again)


def test_graphed_rounds_take_injected_noise(monkeypatch):
    tb = _flat(seed=4)
    cfg = tqs.QuerySATConfig(**SMALL)
    params = tqs.query_sat_init(_gen(0), cfg)
    noise = torch.randn((5, tb.V, 4), generator=_gen(9))

    def run():
        return tqs.query_sat_apply(params, cfg, tb, _gen(3),
                                   round_noise=noise, device="cpu")

    eager, first, again = _both(monkeypatch, run)
    _assert_outputs_equal(eager, first)
    # another draw of noise through the same graph gives other logits
    other = torch.randn((5, tb.V, 4), generator=_gen(10))
    cuda_graphs.clear_round_graphs()
    monkeypatch.setattr(cuda_graphs, "graphs_enabled", lambda dev: True)
    moved = tqs.query_sat_apply(params, cfg, tb, _gen(3), round_noise=other,
                                device="cpu")
    assert not torch.equal(moved[0], eager[0])


@pytest.mark.parametrize("supervised", [False, True])
def test_graphed_anf_rounds_equal_eager_rounds(supervised, monkeypatch):
    _, tb = anf_batch_pair(anf_items(seed=2, n=3))
    cfg = ANFSATConfig(feature_maps=16, query_maps=16, test_rounds=4)
    params = anf_sat_init(_gen(0), cfg)
    plans = segsum.build_anf_plans(tb, pad=True)
    labels = tb.solutions if supervised else None

    def run():
        g = _gen(5)
        out = anf_sat_apply(params, cfg, tb, g, training=False,
                            labels=labels, plans=plans, device="cpu")
        return out, g.get_state()

    eager, first, again = _both(monkeypatch, run)
    _assert_outputs_equal(eager, first)
    _assert_outputs_equal(eager, again)


def test_graphed_sampler_chain_equals_eager(monkeypatch):
    tb = batch_pair(*random_formulas(6, n_formulas=3))[1]
    cfg = tqs.QuerySATConfig(**SMALL)
    params = tqs.query_sat_init(_gen(0), cfg)
    plans = segsum.build_batch_plans(tb, pad=True)
    chain = make_diffusion_chain(cfg, diffusion_steps=3, test_rounds=4)

    def run():
        g = _gen(8)
        return chain(params, tb, g, plans=plans), g.get_state()

    eager, first, again = _both(monkeypatch, run)
    _assert_outputs_equal(eager, first)
    _assert_outputs_equal(eager, again)


def test_one_round_graph_serves_every_batch_of_a_bucket(monkeypatch):
    """Padded plans give the batches of one bucket one shape, so one graph
    serves them all, and each result equals the eager one."""
    cfg = tqs.QuerySATConfig(**SMALL)
    params = tqs.query_sat_init(_gen(0), cfg)
    batches = [_flat(seed=s) for s in (1, 2, 3)]

    def run():
        return [tqs.query_sat_apply(
            params, cfg, b, _gen(1), plans=segsum.build_batch_plans(
                b, pad=True), device="cpu")[0] for b in batches]

    want = run()
    cuda_graphs.clear_round_graphs()
    monkeypatch.setattr(cuda_graphs, "graphs_enabled", lambda dev: True)
    got = run()
    assert len(cuda_graphs._ROUND_GRAPHS) == 1
    cuda_graphs.clear_round_graphs()
    for a, b in zip(want, got, strict=True):
        assert torch.equal(a, b)


def test_graphed_train_chunk_equals_eager_steps(graphed):
    cfg = tqs.QuerySATConfig(**SMALL)
    opt = tab.adabelief(learning_rate=1e-2)
    flats = [_flat(seed=s, n=4) for s in (1, 2, 3)]
    batches = tdb.densify_batches(flats)

    def state():
        params = tqs.query_sat_init(_gen(0), cfg)
        return tloop.TrainState(params, opt.init(params), 0, _gen(1))

    mega = tloop.make_scanned_train_step_for(query_sat_dense_apply, cfg,
                                             opt, "cpu")
    s0 = state()
    before = [t.clone() for t in cuda_graphs.tree_leaves(s0.params)]
    chunk = tloop.stack_batches(batches)
    s1, out1 = mega(s0, chunk)
    # the caller's state is left as it was; the new one holds the buffers
    for a, b in zip(before, cuda_graphs.tree_leaves(s0.params)):
        assert torch.equal(a, b)
    s2, out2 = mega(s1, chunk)
    assert s2.step == 6
    # the state handed back is the graph's own: written in place
    assert all(a is b for a, b in zip(cuda_graphs.tree_leaves(s1.params),
                                      cuda_graphs.tree_leaves(s2.params)))

    step = tloop.make_train_step_for(query_sat_dense_apply, cfg, opt, "cpu")
    e = state()
    losses = []
    for _ in range(2):
        for b in batches:
            e, o = step(e, b)
            losses.append(float(o["loss"]))
    assert out1["loss_per_step"].tolist() + out2["loss_per_step"].tolist() \
        == losses
    _assert_outputs_equal((e.params, e.opt_state), (s2.params, s2.opt_state))
    assert torch.equal(e.generator.get_state(), s2.generator.get_state())


# -- padded plans -----------------------------------------------------------


def test_padded_plans_give_the_unpadded_sums():
    tb = _flat(seed=7)
    plain, padded = (segsum.build_batch_plans(tb, pad=p) for p in
                     (False, True))
    x = torch.randn((2 * tb.V, 6), generator=_gen(0))
    y = torch.randn((tb.C, 6), generator=_gen(1))
    for name, inp in (("lit_to_clause", x), ("clause_to_lit", y)):
        a, b = getattr(plain, name), getattr(padded, name)
        assert b.gather.shape[0] == tb.E > a.gather.shape[0]
        assert torch.equal(a.row_ptr, b.row_ptr)
        assert torch.equal(segsum.segsum_plain(inp, a),
                           segsum.segsum_plain(inp, b))
        assert torch.equal(segsum.gather_segsum(inp, a),
                           segsum.gather_segsum(inp, b))
    xr = x.clone().requires_grad_(True)
    segsum.plan_lit_to_clause(xr, padded).square().sum().backward()
    xp = x.clone().requires_grad_(True)
    segsum.plan_lit_to_clause(xp, plain).square().sum().backward()
    assert torch.equal(xr.grad, xp.grad)


def test_padded_anf_plans_stack_across_a_bucket():
    pairs = [anf_batch_pair(anf_items(seed=s, n=3))[1] for s in (0, 1, 2)]
    padded = [segsum.build_anf_plans(b, pad=True) for b in pairs]
    stacked = tloop.stack_batches(padded)
    assert stacked.node_to_clause.gather.shape == (3, pairs[0].E)
    assert stacked.and_to_var.gather.shape == (3, 2 * pairs[0].A)
    for b, p in zip(pairs, padded):
        q = segsum.build_anf_plans(b)
        x = torch.randn((b.n_value_nodes, 5), generator=_gen(2))
        c = torch.randn((b.C, 5), generator=_gen(3))
        a = torch.randn((b.A, 5), generator=_gen(4))
        assert torch.equal(segsum.plan_node_to_clause(x, p),
                           segsum.plan_node_to_clause(x, q))
        assert torch.equal(segsum.plan_clause_to_node(c, p),
                           segsum.plan_clause_to_node(c, q))
        assert torch.equal(segsum.plan_and_to_var(a, p),
                           segsum.plan_and_to_var(a, q))
    with pytest.raises(ValueError, match="capacity"):
        padded[0].node_to_clause.padded(3)


# -- the fixed-order segment sums ------------------------------------------


@pytest.mark.parametrize("F", [None, 1, 7])
def test_segment_sum_equals_index_add_bit_for_bit(F):
    rng = np.random.default_rng(F or 0)
    n, m = 500, 60
    ids = torch.from_numpy(np.sort(rng.integers(0, m - 5, n)).astype(
        np.int32))
    shape = (n,) if F is None else (n, F)
    data = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    want = torch.zeros((m,) + shape[1:]).index_add_(0, ids, data)
    got = graph_ops.segment_sum(data, ids, m)
    assert torch.equal(got, want)
    # its backward is the gather of the cotangent
    d = data.clone().requires_grad_(True)
    graph_ops.segment_sum(d, ids, m).backward(torch.ones_like(want))
    assert torch.equal(d.grad, torch.ones_like(data))


@pytest.mark.parametrize("rows,segments", [(1000, 7), (997, 300), (50, 60),
                                           (16, 1), (33, 3)])
def test_blocked_segment_sum_of_the_card(rows, segments):
    """The card's route (blocks of rows, then the blocks of a segment) sums
    the same rows as `index_add_`, empty segments included."""
    rng = np.random.default_rng(rows)
    ids = torch.from_numpy(np.sort(rng.integers(0, segments, rows)).astype(
        np.int32))
    data = torch.from_numpy(rng.standard_normal((rows, 5)))
    want = torch.zeros((segments, 5), dtype=data.dtype).index_add_(0, ids,
                                                                   data)
    got = graph_ops._sorted_sum(data, ids, segments, blocked=True)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_segsum_plain_is_the_kernels_plan_order():
    tb = _flat(seed=9)
    plan = segsum.build_batch_plans(tb).lit_to_clause
    x = torch.randn((2 * tb.V, 8), generator=_gen(6))
    got = segsum.segsum_plain(x, plan)
    rp = plan.row_ptr.tolist()
    for s in range(plan.num_segments):
        acc = torch.zeros(8)
        for e in range(rp[s], rp[s + 1]):
            acc = acc + x[plan.gather[e]]
        assert torch.equal(got[s], acc)


def test_tree_helpers_keep_structure_and_reject_mixed_stacks():
    tb = _flat()
    sig = cuda_graphs.tree_signature(tb)
    assert cuda_graphs.tree_signature(
        cuda_graphs.tree_map(torch.clone, tb)) == sig
    st = cuda_graphs.stack_trees([tb, tb])
    assert cuda_graphs.stack_length(st) == 2
    back = cuda_graphs.index_tree(st, 1)
    assert dataclasses.asdict(back).keys() == dataclasses.asdict(tb).keys()
    assert torch.equal(back.edge_lit_c, tb.edge_lit_c)
    with pytest.raises(ValueError):
        cuda_graphs.stack_trees([{"a": 1}, {"a": 2}])

"""Port vs TPU package: the planned literal-clause SpMM pair.

The TPU package's Pallas kernel runs in interpret mode off-TPU (as in
tests/test_pallas_segsum.py); the port's wrapper runs `segsum_plain` for
CPU tensors. Tolerance: f32 summation order, rtol 1e-5.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import batch_pair, np_of, random_formulas
from diffusionsat_tpu.ops import pallas_segsum as jseg
from diffusionsat_torch.ops import graph_ops
from diffusionsat_torch.ops.segsum import (
    SegsumPlan,
    build_batch_plans,
    build_segsum_plan,
    gather_segsum,
    plan_clause_to_lit,
    plan_lit_to_clause,
    segsum_plain,
)

TOL = dict(rtol=1e-5, atol=1e-5)
# small tiles so the TPU plans span several tiles
TILES = dict(tile_edges=64, window=32)


def _pair(seed, n_formulas=4):
    formulas, sols = random_formulas(seed, n_formulas=n_formulas)
    return batch_pair(formulas, sols)


def _jax_slots(local_ids, mask, base, gather):
    """{segment: Counter(source rows)} over the valid slots of a TPU plan."""
    local_ids, mask, base, gather = map(np.asarray,
                                        (local_ids, mask, base, gather))
    T, TE = local_ids.shape
    out = {}
    for t in range(T):
        for i in range(TE):
            if mask[t, i] > 0:
                s = int(base[t] + local_ids[t, i])
                out.setdefault(s, Counter())[int(gather[t * TE + i])] += 1
    return out


def _csr_slots(plan: SegsumPlan):
    rp, g = np_of(plan.row_ptr), np_of(plan.gather)
    return {s: Counter(g[rp[s]:rp[s + 1]].tolist())
            for s in range(plan.num_segments) if rp[s + 1] > rp[s]}


@pytest.mark.parametrize("seed", range(3))
def test_csr_plan_has_same_edges_as_tpu_plan(seed):
    jb, tb = _pair(seed)
    jp = jseg.build_batch_plans(jb, **TILES)
    assert jp is not None
    tp = build_batch_plans(tb)
    assert _csr_slots(tp.lit_to_clause) == _jax_slots(
        jp.c_local_ids, jp.c_mask, jp.c_base, jp.c_gather)
    assert _csr_slots(tp.clause_to_lit) == _jax_slots(
        jp.l_local_ids, jp.l_mask, jp.l_base, jp.l_gather)
    assert tp.lit_to_clause.num_segments == jb.C
    assert tp.clause_to_lit.num_segments == 2 * jb.V
    assert tp.lit_to_clause.row_ptr.dtype == torch.int32
    assert tp.lit_to_clause.gather.dtype == torch.int32


@pytest.mark.parametrize("seed", range(2))
def test_gather_segsum_matches_tpu_kernel(seed):
    jb, tb = _pair(seed)
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(2 * jb.V, 8)).astype(np.float32)
    jplan = jseg.build_segsum_plan(jb.edge_clause_c, jb.edge_mask_c,
                                   num_segments=jb.C, **TILES)
    want = np.asarray(jseg.gather_segsum(jnp.asarray(src),
                                         jnp.asarray(jb.edge_lit_c), jplan))
    plan = build_batch_plans(tb).lit_to_clause
    got = gather_segsum(torch.from_numpy(src), plan)
    np.testing.assert_allclose(np_of(got), want, **TOL)
    np.testing.assert_allclose(np_of(segsum_plain(torch.from_numpy(src),
                                                  plan)), want, **TOL)
    # padding clauses are empty segments and come out 0
    assert np.all(np_of(got)[int(tb.n_clauses):] == 0)


@pytest.mark.parametrize("seed", range(3))
def test_planned_pair_forward_and_backward_match_tpu(seed):
    jb, tb = _pair(seed, n_formulas=2 + seed)
    jp = jseg.build_batch_plans(jb, **TILES)
    tp = build_batch_plans(tb)
    rng = np.random.default_rng(10 + seed)
    F = 6
    x_lit = rng.normal(size=(2 * jb.V, F)).astype(np.float32)
    x_cl = rng.normal(size=(jb.C, F)).astype(np.float32)
    g_cl = rng.normal(size=(jb.C, F)).astype(np.float32)
    g_lit = rng.normal(size=(2 * jb.V, F)).astype(np.float32)

    for jfn, tfn, x, g in (
            (jseg.plan_lit_to_clause, plan_lit_to_clause, x_lit, g_cl),
            (jseg.plan_clause_to_lit, plan_clause_to_lit, x_cl, g_lit)):
        jout, vjp = jax.vjp(lambda a: jfn(a, jp), jnp.asarray(x))
        (jgrad,) = vjp(jnp.asarray(g))
        xt = torch.from_numpy(x).requires_grad_(True)
        tout = tfn(xt, tp)
        tout.backward(torch.from_numpy(g))
        np.testing.assert_allclose(np_of(tout), np.asarray(jout), **TOL)
        np.testing.assert_allclose(np_of(xt.grad), np.asarray(jgrad), **TOL)


def test_planned_pair_matches_graph_ops_and_takes_column_slices():
    _, tb = _pair(4)
    tp = build_batch_plans(tb)
    x = torch.randn(2 * tb.V, 10, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(plan_lit_to_clause(x, tp),
                               graph_ops.lit_to_clause(tb, x), **TOL)
    wide = torch.randn(tb.C, 12, generator=torch.Generator().manual_seed(1))
    sliced = wide[:, :5]   # row stride 12, as the model's clause_data slice
    torch.testing.assert_close(plan_clause_to_lit(sliced, tp),
                               graph_ops.clause_to_lit(tb, sliced), **TOL)


def test_plan_drops_masked_edges_and_keeps_their_order():
    seg = np.array([0, 0, 1, 1, 1, 3])
    src = np.array([5, 2, 4, 4, 1, 0])
    mask = np.array([1, 1, 0, 1, 1, 1], np.float32)
    plan = build_segsum_plan("lit_to_clause", seg, src, mask,
                             num_segments=5, num_sources=6)
    assert np_of(plan.row_ptr).tolist() == [0, 2, 4, 4, 5, 5]
    assert np_of(plan.gather).tolist() == [5, 2, 4, 1, 0]


@pytest.mark.parametrize("seg,src,err", [
    ([1, 0], [0, 0], "sorted"),
    ([0, 7], [0, 0], "segment id"),
    ([0, 1], [0, 9], "source row"),
])
def test_plan_rejects_bad_input(seg, src, err):
    with pytest.raises(ValueError, match=err):
        build_segsum_plan("lit_to_clause", np.array(seg), np.array(src),
                          np.ones(2), num_segments=4, num_sources=3)


def test_wrapper_checks_input():
    plan = build_segsum_plan("lit_to_clause", np.array([0, 1]),
                             np.array([0, 2]), np.ones(2), 2, 3)
    with pytest.raises(TypeError):
        gather_segsum(torch.zeros(3, 4, dtype=torch.float64), plan)
    with pytest.raises(ValueError):
        gather_segsum(torch.zeros(4, 4), plan)
    with pytest.raises(ValueError):
        gather_segsum(torch.zeros(4, 3).t(), plan)
    # a device that is neither the CPU nor CUDA has no path
    with pytest.raises(ValueError):
        gather_segsum(torch.zeros(3, 4, device="meta"), plan.to("meta"))


@pytest.mark.parametrize("cotangent", ["transposed", "expanded", "row_slice",
                                       "column_slice"])
def test_backward_takes_the_cotangents_autograd_hands_over(cotangent):
    """Autograd hands the pair's backward expanded and sliced cotangents
    (from `variables_loss[:V]`, `clause_data[:, :Q]`, a `sum()`); each must
    give the gradient of the plain version."""
    _, tb = _pair(11)
    plans = build_batch_plans(tb)
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.normal(size=(2 * tb.V, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, tb.C)).astype(np.float32))

    def loss_of(out):
        if cotangent == "transposed":       # cotangent with column stride C
            return (out.t() * w).sum()
        if cotangent == "expanded":         # cotangent of stride (0, 0)
            return out.sum()
        if cotangent == "row_slice":
            return (out[: tb.C // 2] ** 2).sum() - out[tb.C // 2:].sum()
        return (out[:, :3] ** 2).sum()

    grads = []
    for fn in (lambda x: plan_lit_to_clause(x, plans),
               lambda x: segsum_plain(x, plans.lit_to_clause)):
        x = x0.clone().requires_grad_(True)
        loss_of(fn(x)).backward()
        grads.append(x.grad)
    np.testing.assert_allclose(np_of(grads[0]), np_of(grads[1]), **TOL)


def test_backward_is_skipped_when_no_gradient_is_asked():
    from diffusionsat_torch.ops.segsum import _PlannedSpMM
    _, tb = _pair(12)
    plans = build_batch_plans(tb)
    x = torch.ones((2 * tb.V, 4))
    out = plan_lit_to_clause(x, plans)
    assert not out.requires_grad       # nothing to differentiate

    class Ctx:
        needs_input_grad = (False, False, False)
        bwd = None                     # would raise if it were launched
    assert _PlannedSpMM.backward(Ctx, torch.ones((tb.C, 4))) == (
        None, None, None)

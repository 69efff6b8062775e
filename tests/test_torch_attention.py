"""Port vs TPU package: sparse graph attention over the incidence edges.

The per-edge dot, the per-clause edge softmax, the additive attention (the
one AttentionSAT uses), the dot-product and the sigmoid attention, on the
same numpy-seeded formulas and inputs, with the TPU package's parameters
carried across. Each layer's sum of edge rows into literals runs without
plans (the rows put in literal order, then the plain sorted segment sum)
and through the edge plan of `BatchPlans` (the kernel's plain version on
CPU tensors). The TPU package sums those rows by a scatter over unsorted
literal ids, in another order.

Tolerances (f32): values to 1e-5 absolute and relative; input gradients
to 1e-4 of their largest entry. The plain and the planned port paths
agree bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import batch_pair, np_of, random_formulas, torch_params
from diffusionsat_tpu.nn import attention as jatt
from diffusionsat_torch.nn import attention as tatt
from diffusionsat_torch.ops import segsum
from diffusionsat_torch.ops.segsum import build_batch_plans

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-4
DQ, DM, HIDDEN = 6, 5, 8


@pytest.fixture(scope="module")
def batches():
    return batch_pair(*random_formulas(6, n_formulas=4))


def _inputs(jb, seed=0, dm=DM):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2 * jb.V, DQ)).astype(np.float32)
    m = rng.normal(size=(jb.C, dm)).astype(np.float32)
    return q, m


def test_edge_dot_and_softmax_equal_the_tpu_package(batches):
    jb, tb = batches
    a = np.random.default_rng(1).normal(size=(2 * jb.V, 4)).astype(
        np.float32)
    b = np.random.default_rng(2).normal(size=(jb.C, 4)).astype(np.float32)
    jd = jatt.edge_dot(jnp.asarray(a), jnp.asarray(b), jb, 0.5)
    td = tatt.edge_dot(torch.from_numpy(a), torch.from_numpy(b), tb, 0.5)
    np.testing.assert_allclose(np_of(td), np.asarray(jd), **TOL)
    js = np.asarray(jatt.edge_softmax_by_clause(jd, jb))
    ts = np_of(tatt.edge_softmax_by_clause(td, tb))
    np.testing.assert_allclose(ts, js, **TOL)
    # each real clause's weights sum to 1, masked edges weigh 0
    mask = np_of(tb.edge_mask_c) > 0
    assert (ts[~mask] == 0).all()
    per_clause = np.bincount(np_of(tb.edge_clause_c)[mask], ts[mask],
                             minlength=tb.C)
    real = np_of(tb.clause_mask) > 0
    np.testing.assert_allclose(per_clause[real], 1.0, rtol=1e-6)


def _layer(kind, jb):
    """(TPU-package init, apply, port apply kwargs) of one layer."""
    if kind == "additive":
        params = jatt.additive_attention_init(jax.random.key(0), HIDDEN,
                                              DQ, DM)
        return params, (lambda p, q, m, b: jatt.additive_attention_apply(
            p, q, m, b, hidden=HIDDEN)), \
            (lambda p, q, m, b, plans: tatt.additive_attention_apply(
                p, q, m, b, hidden=HIDDEN, plans=plans))
    if kind == "dot":
        params = jatt.dot_attention_init(jax.random.key(1), HIDDEN, HIDDEN,
                                         DQ, DM)
        return params, (lambda p, q, m, b: jatt.dot_attention_apply(
            p, q, m, b, hidden=HIDDEN)), \
            (lambda p, q, m, b, plans: tatt.dot_attention_apply(
                p, q, m, b, hidden=HIDDEN, plans=plans))
    params = jatt.sigmoid_attention_init(jax.random.key(2), HIDDEN, DQ,
                                         HIDDEN)
    return params, (lambda p, q, m, b: jatt.sigmoid_attention_apply(
        p, q, m, b, hidden=HIDDEN)), \
        (lambda p, q, m, b, plans: tatt.sigmoid_attention_apply(
            p, q, m, b, hidden=HIDDEN, plans=plans))


@pytest.mark.parametrize("planned", [False, True], ids=["plain", "plans"])
@pytest.mark.parametrize("kind", ["additive", "dot", "sigmoid"])
def test_attention_layer_equals_the_tpu_package(kind, planned, batches):
    """Output and the gradients wrt both inputs."""
    jb, tb = batches
    q, m = _inputs(jb, dm=HIDDEN if kind == "sigmoid" else DM)
    jparams, japply, tapply = _layer(kind, jb)
    plans = build_batch_plans(tb, edges=True) if planned else None
    want = np.asarray(japply(jparams, jnp.asarray(q), jnp.asarray(m), jb))
    tq = torch.from_numpy(q).requires_grad_(True)
    tm = torch.from_numpy(m).requires_grad_(True)
    got = tapply(torch_params(jparams), tq, tm, tb, plans)
    np.testing.assert_allclose(np_of(got), want, **TOL)

    w = np.random.default_rng(9).normal(size=want.shape).astype(np.float32)
    jgq, jgm = jax.grad(lambda a, b: jnp.sum(japply(jparams, a, b, jb) * w),
                        argnums=(0, 1))(jnp.asarray(q), jnp.asarray(m))
    tgq, tgm = torch.autograd.grad(torch.sum(got * torch.from_numpy(w)),
                                   (tq, tm))
    for t, j in ((tgq, jgq), (tgm, jgm)):
        j = np.asarray(j)
        assert np.abs(np_of(t) - j).max() <= GRAD_TOL * np.abs(j).max()


def test_edge_plan_equals_the_plain_sum_and_its_backward(batches):
    """`plan_edge_to_lit` against the plain path on random edge rows (the
    masked ones zero), padded and unpadded, forward and backward; its
    backward is the `lit_to_edge` plan."""
    _, tb = batches
    rng = np.random.default_rng(4)
    rows = rng.normal(size=(tb.E, 7)).astype(np.float32) * \
        np_of(tb.edge_mask_c)[:, None]
    want = tatt.edge_rows_to_lit(torch.from_numpy(rows), tb)
    calls = []
    orig = segsum.gather_segsum

    def counting(x, plan):
        calls.append(plan.name)
        return orig(x, plan)

    for pad in (False, True):
        plans = build_batch_plans(tb, pad=pad, edges=True)
        x = torch.from_numpy(rows).requires_grad_(True)
        segsum.gather_segsum = counting
        try:
            got = tatt.edge_rows_to_lit(x, tb, plans)
            g = torch.from_numpy(rng.normal(size=tuple(got.shape)).astype(
                np.float32))
            grad, = torch.autograd.grad(got, x, g)
        finally:
            segsum.gather_segsum = orig
        assert torch.equal(got, want)
        lit = np_of(tb.edge_lit_c).astype(np.int64)
        np.testing.assert_array_equal(
            np_of(grad), np_of(g)[lit] * np_of(tb.edge_mask_c)[:, None])
    assert calls == ["edge_to_lit", "lit_to_edge"] * 2


def test_edge_plan_needs_the_batch_plans(batches):
    _, tb = batches
    plans = build_batch_plans(tb, edges=True)
    bare = segsum.BatchPlans(plans.lit_to_clause, plans.clause_to_lit)
    for without in (bare, build_batch_plans(tb)):
        with pytest.raises(TypeError, match="edge plans"):
            segsum.plan_edge_to_lit(torch.zeros((tb.E, 2)), without)

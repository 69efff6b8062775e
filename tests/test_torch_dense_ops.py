"""Port vs TPU package: every function of `ops/dense_ops.py` on the same
dense blocks and the same numpy-seeded inputs, at rtol = atol = 1e-6 (one
f32 op chain each; the TPU package's incidence products run at HIGHEST
precision, its default). The closed-form query gradient is also held
against `torch.autograd`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import batch_pair, np_of, random_formulas
from diffusionsat_tpu.graph import dense_batch as jdb
from diffusionsat_tpu.ops import dense_ops as jops
from diffusionsat_torch.graph import dense_batch as tdb
from diffusionsat_torch.ops import dense_ops as tops

TOL = dict(rtol=1e-6, atol=1e-6)


def _dense_pair(seed, n_formulas=4):
    jb, tb = batch_pair(*random_formulas(seed, n_formulas=n_formulas))
    dims = jdb.dense_dims_for([jb])
    return jdb.dense_from_flat(jb, *dims), tdb.dense_from_flat(tb, *dims)


def _both(name, jd, td, x, **kw):
    want = getattr(jops, name)(jnp.asarray(x), jd, **kw)
    got = getattr(tops, name)(torch.from_numpy(x), td, **kw)
    return want, got


def _close(got, want):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
        return
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(np_of(got), np.asarray(want), **TOL)


def test_incidence_products_and_degrees():
    jd, td = _dense_pair(0)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(jd.G, 2 * jd.Vg, 5)).astype(np.float32)
    y = rng.normal(size=(jd.G, jd.Cg, 5)).astype(np.float32)
    _close(tops.lit_to_clause(td, torch.from_numpy(x)),
           jops.lit_to_clause(jd, jnp.asarray(x)))
    _close(tops.clause_to_lit(td, torch.from_numpy(y)),
           jops.clause_to_lit(jd, jnp.asarray(y)))
    _close(tops.literal_degrees(td), jops.literal_degrees(jd))
    _close(tops.clause_degrees(td), jops.clause_degrees(jd))
    _close(tops.var_graph_sum(td, torch.from_numpy(x[:, :jd.Vg])),
           jops.var_graph_sum(jd, jnp.asarray(x[:, :jd.Vg])))
    _close(tops.clause_graph_sum(td, torch.from_numpy(y)),
           jops.clause_graph_sum(jd, jnp.asarray(y)))
    _close(tops.literal_concat(torch.from_numpy(x[:, :jd.Vg])),
           jops.literal_concat(jnp.asarray(x[:, :jd.Vg])))


@pytest.mark.parametrize("name,nodes", [("pair_norm_vars", "Vg"),
                                        ("pair_norm_clauses", "Cg")])
def test_pair_norms(name, nodes):
    jd, td = _dense_pair(1)
    x = np.random.default_rng(1).normal(
        size=(jd.G, getattr(jd, nodes), 6)).astype(np.float32)
    _close(*_both(name, jd, td, x)[::-1])


@pytest.mark.parametrize("name,kw", [
    ("softplus_loss", {}), ("softplus_loss", {"power": 2.0}),
    ("softplus_loss_and_grad", {}), ("softplus_mixed_loss", {}),
    ("linear_loss", {}), ("clause_sat_indicator", {}), ("is_batch_sat", {}),
    ("is_graph_sat", {})])
def test_losses_and_sat_checks(name, kw):
    jd, td = _dense_pair(2, n_formulas=5)
    logits = (2 * np.random.default_rng(2).normal(
        size=(jd.G, jd.Vg, 3))).astype(np.float32)
    want, got = _both(name, jd, td, logits, **kw)
    _close(got, want)


def test_sat_checks_on_true_solutions():
    """A satisfying assignment per graph: every real graph reads SAT, the
    batch reads SAT, and padded graphs read 0."""
    from diffusionsat_tpu.sat.solvers import solve

    formulas, _ = random_formulas(3, n_formulas=3, clause_ratio=2)
    sols = []
    for n, clauses in formulas:
        ok, model = solve(clauses, n)
        assert ok
        sols.append([1 if v > 0 else 0 for v in model])
    jb, tb = batch_pair(formulas, sols)
    dims = jdb.dense_dims_for([jb])
    jd, td = jdb.dense_from_flat(jb, *dims), tdb.dense_from_flat(tb, *dims)
    logits = ((np_of(td.solutions) * 2 - 1) * 10.0)[..., None].astype(
        np.float32)
    for name in ("is_batch_sat", "is_graph_sat"):
        want, got = _both(name, jd, td, logits)
        _close(got, want)
    assert float(tops.is_batch_sat(torch.from_numpy(logits), td)) == 1.0
    gs = np_of(tops.is_graph_sat(torch.from_numpy(logits), td))[:, 0]
    np.testing.assert_array_equal(gs, np_of(td.graph_mask))


def test_closed_form_gradient_matches_autograd():
    _, td = _dense_pair(4)
    q = torch.from_numpy(np.random.default_rng(4).normal(
        size=(td.G, td.Vg, 8)).astype(np.float32)).requires_grad_()
    loss = tops.softplus_loss(q, td)
    (want,) = torch.autograd.grad(loss.sum(), q)
    got_loss, got_grad = tops.softplus_loss_and_grad(q.detach(), td)
    np.testing.assert_allclose(np_of(got_grad), np_of(want), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(np_of(got_loss), np_of(loss), rtol=1e-6,
                               atol=1e-7)

    # second order: a gradient taken through the closed form equals one
    # taken through nested autograd, to summation order
    def outer(closed):
        x = q.detach().clone().requires_grad_()
        if closed:
            _, g = tops.softplus_loss_and_grad(x, td)
        else:
            (g,) = torch.autograd.grad(tops.softplus_loss(x, td).sum(), x,
                                       create_graph=True)
        return torch.autograd.grad(torch.sin(g).sum(), x)[0]

    np.testing.assert_allclose(np_of(outer(True)), np_of(outer(False)),
                               rtol=1e-3, atol=5e-5)

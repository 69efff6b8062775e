"""Port vs TPU package: the parameter gradients of the other models' loss.

Each model's training loss (3 rounds, width 16, the TPU package's initial
parameters and, for QuerySATLit and AttentionSAT, its per-round noise)
is differentiated by `jax.grad` in the TPU package and by autograd in the
port, through the plans (the kernel's plain version on CPU tensors).
QuerySATLit and AttentionSAT take the query gradient with a nested
`jax.grad` there and in closed form here, so the port's outer backward
differentiates first-order ops where the TPU package differentiates a
gradient.

Tolerance: every gradient tensor to 1e-4 of its own largest entry,
floored at a hundredth of the largest gradient of all; 1e-3 for NeuroCore
and SimpleNeuroSAT, whose standardized states are ill-conditioned in f32
(test_torch_models.py says how far).
"""

import numpy as np
import pytest
import torch

import jax

from _torch_parity import (
    MODELS,
    MOMENTS_MODELS,
    batch_pair,
    model_configs,
    random_formulas,
    replay_round_noise,
    rounds_of,
    torch_params,
)
from diffusionsat_torch.losses import sat as tsat
from diffusionsat_torch.ops.segsum import build_batch_plans
from diffusionsat_torch.train import loop
from diffusionsat_torch.train.checkpoint import _flatten_params

GRAD_TOL = 1e-4
MOMENTS_GRAD_TOL = 1e-3


@pytest.fixture(scope="module")
def batches():
    return batch_pair(*random_formulas(4, n_formulas=4))


def _grads(name, batches, seed=0):
    jcfg, tcfg, (jinit, _), (japply, tapply) = model_configs(name)
    jb, tb = batches
    jparams = jinit(jax.random.key(seed), jcfg)
    key = jax.random.key(seed + 11)
    jloss, jgrads = jax.value_and_grad(
        lambda p: japply(p, jcfg, jb, key, training=True)[1])(jparams)
    noise = replay_round_noise(name, key, rounds_of(jcfg, True), jb.V)
    tree, leaves, spec = loop._grad_leaves(torch_params(jparams))
    tloss = tapply(tree, tcfg, tb, None, training=True,
                   plans=build_batch_plans(
                       tb, edges=loop.uses_edge_plans(tapply)),
                   device="cpu", **noise)[1]
    tgrads, _ = loop._grads_of(tloss, leaves, spec)
    return (float(jloss), _flatten_params(jax.tree.map(np.asarray, jgrads))), \
        (float(tloss.detach()), _flatten_params(tgrads))


@pytest.mark.parametrize("name", MODELS)
def test_parameter_gradients_equal_the_tpu_package(name, batches):
    (jloss, jg), (tloss, tg) = _grads(name, batches)
    moments = name in MOMENTS_MODELS
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4 if moments else 1e-5)
    assert set(tg) == set(jg)
    floor = max(np.abs(v).max() for v in jg.values()) / 100
    tol = MOMENTS_GRAD_TOL if moments else GRAD_TOL
    for path, want in jg.items():
        got = tg[path]
        assert got.shape == want.shape, path
        scale = max(np.abs(want).max(), floor)
        err = np.abs(got - want).max()
        assert err <= tol * scale, (path, err, scale)


def test_closed_form_query_gradient_equals_the_nested_one(batches):
    """The closed-form query gradient of QuerySATLit and AttentionSAT,
    differentiated by autograd, equals autograd of autograd (the nested
    form, as the TPU package takes it) through the planned sums, whose
    backward is itself differentiable: the second derivative the outer
    backward needs is the same."""
    _, tb = batches
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(tb.V, 6)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(tb.V, 6)).astype(np.float32))
    plans = build_batch_plans(tb)

    q1 = q.clone().requires_grad_(True)
    _, g1 = tsat.softplus_loss_and_grad(q1, tb, plans=plans)
    second1, = torch.autograd.grad(torch.sum(g1 * w), q1)

    q2 = q.clone().requires_grad_(True)
    loss = torch.sum(tsat.softplus_loss(q2, tb, plans=plans))
    g2, = torch.autograd.grad(loss, q2, create_graph=True)
    second2, = torch.autograd.grad(torch.sum(g2 * w), q2)

    torch.testing.assert_close(g1, g2, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(second1, second2, rtol=1e-4, atol=1e-6)

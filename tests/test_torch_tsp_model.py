"""Port vs TPU package: the TSP model, its layers and its losses.

The TPU package's params (from its own init) are carried onto torch; the
same numpy-seeded inputs go through both packages at width 8-16, 2-3
rounds and P = 8. Layer outputs, logits and losses must agree to f32
round-off (rtol = atol = 1e-5), and parameter gradients to 1e-4 of each
tensor's largest entry (floored at a hundredth of the largest of all):
both cores, supervised and unsupervised with the subtour cuts, and the
`fast_inaccurate` penalty. The model draws no random numbers at its
settings, so nothing is injected.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

import jax
import jax.numpy as jnp

from _torch_parity import np_of, torch_params
from diffusionsat_tpu.tsp import data as jdata
from diffusionsat_tpu.tsp import layers as jlayers
from diffusionsat_tpu.tsp import loss as jloss
from diffusionsat_tpu.tsp import model as jmodel
from diffusionsat_torch.tsp import layers as tlayers
from diffusionsat_torch.tsp import loss as tloss
from diffusionsat_torch.tsp import model as tmodel

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_SHARE = 1e-4


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _batch(n_lo=6, n_hi=8, size=3, seed=0):
    return next(jdata.EuclideanTSP(min_node_count=n_lo, max_node_count=n_hi,
                                   padded_size=8, train_size=size,
                                   seed=seed).batches("train", size))


def _close(got, want, **tol):
    np.testing.assert_allclose(np_of(got), np.asarray(want), **(tol or TOL))


def test_dense_gnn_matches():
    jp = jlayers.dense_gnn_init(jax.random.key(1), 8)
    # a nonzero ReZero weight, so that the candidate path shows
    jp["candidate_weight"] = jnp.asarray(_x((8,), 5))
    x, mask = _x((2, 8, 8, 8), 1), (_x((2, 8, 8), 2) > 0).astype(np.float32)
    want = jlayers.dense_gnn_apply(jp, jnp.asarray(x), jnp.asarray(mask), 8)
    got = tlayers.dense_gnn_apply(torch_params(jp), torch.from_numpy(x),
                                  torch.from_numpy(mask), 8)
    _close(got, want)


def test_switch_unit_and_benes_block_match():
    jp = jlayers.benes_block_init(jax.random.key(2), 4)
    x = _x((2, 64, 4), 3)
    tp = torch_params(jp)
    _close(tlayers.switch_unit_apply(tp["forward"], torch.from_numpy(x)),
           jlayers.switch_unit_apply(jp["forward"], jnp.asarray(x)))
    _close(tlayers.benes_block_apply(tp, torch.from_numpy(x)),
           jlayers.benes_block_apply(jp, jnp.asarray(x)))


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_shuffle_and_z_order_indices_equal(n):
    np.testing.assert_array_equal(tlayers._z_order_indices(n),
                                  jlayers._z_order_indices(n))
    for left in (True, False):
        np.testing.assert_array_equal(
            tlayers._shuffle_indices(n * n, left),
            jlayers._shuffle_indices(n * n, left))


def test_matrix_se_matches_and_needs_a_power_of_two():
    jp = jlayers.matrix_se_init(jax.random.key(3), 4, block_count=2)
    x = _x((2, 8, 8, 4), 4)
    _close(tlayers.matrix_se_apply(torch_params(jp), torch.from_numpy(x)),
           jlayers.matrix_se_apply(jp, jnp.asarray(x)))
    with pytest.raises(ValueError, match="power-of-2"):
        tlayers.matrix_se_apply(torch_params(jp),
                                torch.zeros((1, 6, 6, 4)))


def test_erf_gelu_would_drift_from_the_tpu_package(monkeypatch):
    """The switch unit's GELU is JAX's default tanh approximation: with
    the exact erf form the MatrixSE output leaves the tolerance."""
    jp = jlayers.matrix_se_init(jax.random.key(3), 4)
    x = _x((2, 8, 8, 4), 4)
    want = np.asarray(jlayers.matrix_se_apply(jp, jnp.asarray(x)))
    tp = torch_params(jp)
    _close(tlayers.matrix_se_apply(tp, torch.from_numpy(x)), want)
    exact = F.gelu
    monkeypatch.setattr(tlayers.F, "gelu",
                        lambda t, approximate="none": exact(t))
    erf = np_of(tlayers.matrix_se_apply(tp, torch.from_numpy(x)))
    assert not np.allclose(erf, want, **TOL)
    assert np.abs(erf - want).max() > 1e-4


def _configs(matrix_se, supervised, **kw):
    kw = {**dict(feature_maps=12 if matrix_se else 16, rounds=3,
                 use_matrix_se=matrix_se, supervised=supervised,
                 n_vertices_prior=8), **kw}
    return jmodel.TSPMatrixSEConfig(**kw), tmodel.TSPMatrixSEConfig(**kw)


def _share(a, b, floor):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), floor,
                                            1e-30)


def _assert_grads(tgrads, jgrads):
    got = [np_of(g) for g in pytree.tree_leaves(tgrads)]
    want = [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    assert len(got) == len(want)
    floor = max(float(np.abs(w).max()) for w in want) / 100
    assert floor > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _share(g, w, floor) <= GRAD_SHARE


def _grads(loss, leaves):
    # the first Dense before a layer norm has no bias: its gradient is 0
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, leaves)]


def _leaves(params):
    leaves = [t.detach().requires_grad_(True)
              for t in pytree.tree_leaves(params)]
    return pytree.tree_unflatten(leaves, pytree.tree_structure(params)), \
        leaves


@pytest.mark.parametrize("matrix_se", [False, True], ids=["dense_gnn",
                                                          "matrix_se"])
@pytest.mark.parametrize("supervised", [False, True],
                         ids=["unsupervised_cuts", "supervised"])
def test_model_logits_losses_and_gradients_match(matrix_se, supervised):
    jcfg, tcfg = _configs(matrix_se, supervised)
    jparams = jmodel.tsp_matrix_se_init(jax.random.key(0), jcfg)
    batch = _batch()
    adj, labels = batch["adj_matrix"], batch["labels"]

    def jfn(p):
        logits, total, last = jmodel.tsp_matrix_se_apply(
            p, jcfg, jnp.asarray(adj), jnp.asarray(labels),
            jax.random.key(1))
        return total, (logits, last)

    (jtotal, (jlogits, jlast)), jgrads = jax.jit(jax.value_and_grad(
        jfn, has_aux=True))(jparams)
    tree, leaves = _leaves(torch_params(jparams))
    logits, total, last = tmodel.tsp_matrix_se_apply(
        tree, tcfg, torch.from_numpy(adj), torch.from_numpy(labels),
        device="cpu")
    grads = _grads(total, leaves)
    assert logits.shape == (3, 8, 8, 1)
    _close(logits.detach(), jlogits)
    _close(total.detach(), jtotal)
    _close(last.detach(), jlast)
    _assert_grads(pytree.tree_unflatten(list(grads),
                                        pytree.tree_structure(tree)), jgrads)
    # inference: the same logits, no loss
    logits_i, total_i, _ = tmodel.tsp_matrix_se_apply(
        tree, tcfg, torch.from_numpy(adj), torch.from_numpy(labels),
        training=False, device="cpu")
    torch.testing.assert_close(logits_i, logits)
    assert total_i == 0.0


@pytest.mark.parametrize("matrix_se", [False, True], ids=["dense_gnn",
                                                          "matrix_se"])
def test_fast_inaccurate_loss_and_gradients_match(matrix_se):
    """The pairwise penalty in place of the cuts (no host call), on the
    model's logits: the loss and the parameter gradients through it."""
    jcfg, tcfg = _configs(matrix_se, False, rounds=2)
    jparams = jmodel.tsp_matrix_se_init(jax.random.key(4), jcfg)
    batch = _batch(seed=1)
    adj, labels = batch["adj_matrix"], batch["labels"]

    def jfn(p):
        logits = jmodel.tsp_matrix_se_apply(
            p, jcfg, jnp.asarray(adj), jnp.asarray(labels),
            jax.random.key(1), training=False)[0]
        return jloss.tsp_loss(logits, jnp.asarray(adj), fast_inaccurate=True)

    jval, jgrads = jax.jit(jax.value_and_grad(jfn))(jparams)
    tree, leaves = _leaves(torch_params(jparams))
    logits = tmodel.tsp_matrix_se_apply(
        tree, tcfg, torch.from_numpy(adj), torch.from_numpy(labels),
        training=False, device="cpu")[0]
    val = tloss.tsp_loss(logits, torch.from_numpy(adj),
                         fast_inaccurate=True)
    grads = _grads(val, leaves)
    _close(val.detach(), jval)
    _assert_grads(pytree.tree_unflatten(list(grads),
                                        pytree.tree_structure(tree)), jgrads)


@pytest.mark.parametrize("fast", [False, True])
def test_losses_on_logits_match(fast):
    """The losses alone on random logits, with padding: values and the
    gradient with respect to the logits; the cut path's cut count is not
    zero."""
    batch = next(jdata.AsymmetricTSP(min_node_count=4, max_node_count=8,
                                     padded_size=8, train_size=4
                                     ).batches("train", 4))
    adj, labels = batch["adj_matrix"], batch["labels"]
    # 2-cycles (0 1), (2 3), ...: the normalized predictions leave cuts
    # of weight under 1 between them
    pairs = np.arange(8)[:, None] // 2 == np.arange(8)[None, :] // 2
    logits = _x((4, 8, 8), 6) - 3.0 + 6.0 * pairs
    jgrad_fn = jax.value_and_grad(lambda x: jloss.tsp_loss(
        x, jnp.asarray(adj), labels=jnp.asarray(labels), supervised=True,
        fast_inaccurate=fast))
    jval, jgrad = jgrad_fn(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    val = tloss.tsp_loss(x, torch.from_numpy(adj),
                         labels=torch.from_numpy(labels), supervised=True,
                         fast_inaccurate=fast)
    (grad,) = torch.autograd.grad(val, [x])
    _close(val.detach(), jval)
    # padded rows divide by a sum near 1e-6: entries reach 1e6, held to
    # the share of the largest
    assert _share(np_of(grad), np.asarray(jgrad), 0.0) <= GRAD_SHARE
    if not fast:
        without_cuts = tloss.tsp_unsupervised_loss(
            x.detach(), torch.from_numpy(adj), max_cut_pairs=0)
        with_cuts = float(val.detach()) - float(tloss.tsp_supervised_loss(
            x.detach(), torch.from_numpy(labels)))
        assert with_cuts > float(without_cuts) + 1e-4
    np.testing.assert_array_equal(np_of(tloss.inverse_identity(8)),
                                  np.asarray(jloss.inverse_identity(8)))


def test_logistic_noise_from_a_generator():
    """`sample_logistic` draws from the generator it is given (the TPU
    package from a key): the same seed gives the same draws, and the
    draws are standard logistic."""
    a = tloss.sample_logistic(torch.Generator().manual_seed(0), (200, 100))
    b = tloss.sample_logistic(torch.Generator().manual_seed(0), (200, 100))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert abs(float(a.mean())) < 0.05
    assert abs(float(a.var()) - np.pi ** 2 / 3) < 0.15
    adj = torch.from_numpy(_batch()["adj_matrix"])
    logits = torch.from_numpy(_x((3, 8, 8), 7))
    plain = tloss.tsp_unsupervised_loss(logits, adj, fast_inaccurate=True)
    noisy = tloss.tsp_unsupervised_loss(
        logits, adj, torch.Generator().manual_seed(0), noise=1.0,
        fast_inaccurate=True)
    assert float(noisy) != float(plain)
    torch.testing.assert_close(tloss.tsp_unsupervised_loss(
        logits, adj, None, noise=1.0, fast_inaccurate=True), plain)


def test_params_tree_round_trips_through_npz(tmp_path):
    """MatrixSE's params nest a list of blocks: the npz format carries it
    both ways, and the TPU package reads the port's file."""
    from diffusionsat_tpu.train.checkpoint import load_params as jload
    from diffusionsat_torch.train.checkpoint import (
        export_params,
        load_params,
        params_from_numpy,
        params_to_numpy,
    )

    _, tcfg = _configs(True, False, block_count=2)
    params = tmodel.tsp_matrix_se_init(torch.Generator().manual_seed(0),
                                       tcfg)
    assert isinstance(params["graph_layer"]["blocks"], list)
    export_params(params, tmp_path / "tsp.npz", meta={"model": "tsp"})
    tree, meta = load_params(tmp_path / "tsp.npz")
    back = params_from_numpy(tree, "cpu")
    assert pytree.tree_structure(back) == pytree.tree_structure(params)
    for a, b in zip(pytree.tree_leaves(back), pytree.tree_leaves(params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    jtree, jmeta = jload(tmp_path / "tsp.npz")
    assert jmeta == meta
    want = jax.tree.leaves(params_to_numpy(params))
    for a, b in zip(jax.tree.leaves(jtree), want):
        np.testing.assert_array_equal(a, b)
    jcfg = jmodel.TSPMatrixSEConfig(**{k: getattr(tcfg, k) for k in (
        "feature_maps", "block_count", "rounds", "use_matrix_se")})
    jinit = jmodel.tsp_matrix_se_init(jax.random.key(0), jcfg)
    assert jax.tree.map(np.shape, jinit) == jax.tree.map(np.shape, jtree)

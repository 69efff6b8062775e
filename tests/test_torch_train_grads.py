"""Port vs TPU package: training loss and parameter gradients.

`query_sat_apply(training=True)` and `query_sat_dense_apply(training=True)`
against `jax.value_and_grad` of the TPU package's functions, on the same
numpy-seeded formulas, params, labels, noise scale and noisy input, with the
per-round noise zeroed. With plans the TPU package runs its Pallas kernel in
interpret mode and the port its plain segmented sum (CPU tensors).

Tolerances. f32: loss rtol 1e-4; every gradient tensor to 1e-4 of its own
largest entry, floored at a hundredth of the largest gradient of all (a few
recurrent rounds of f32 summation-order differences).
`compute_dtype=bfloat16` (operands cast per product, f32 elsewhere) meets
loss rtol 1e-4 and gradients to 2e-2 of the tensor's largest entry.

`block_bf16` keeps bf16 recurrent states. One round (states not yet fed
back) matches the TPU package at loss rtol 1e-5 and gradients to 2e-2 of the
tensor's largest entry. From the second round on the two packages' states
differ by one bf16 ulp in about a tenth of the entries (the TPU package's
compiler evaluates the bf16 blend chain with other intermediate roundings),
and this small random model amplifies that: over 3 rounds the loss agrees to
rtol 5e-3 and the whole gradient to 0.3 in relative L2 norm, against the TPU
package's block_bf16 and against the port's own f32 alike (the TPU package's
block_bf16 lies as far from its own f32).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    batch_pair,
    dense_vars_from_flat,
    np_of,
    random_formulas,
    torch_params,
)
from diffusionsat_tpu.graph import dense_batch as jdb
from diffusionsat_tpu.models import query_sat as jqs
from diffusionsat_tpu.models.query_sat_dense import (
    query_sat_dense_apply as jdense,
)
from diffusionsat_tpu.ops import pallas_segsum as jseg
from diffusionsat_torch.graph import dense_batch as tdb
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.models.query_sat_dense import (
    query_sat_dense_apply as tdense,
)
from diffusionsat_torch.ops import dense_ops
from diffusionsat_torch.ops.segsum import build_batch_plans

SMALL = dict(feature_maps=16, query_maps=8, logit_maps=4, train_rounds=3,
             debug_zero_noise=True)
F32 = dict(loss=1e-4, grad=1e-4)
BF16_OPERANDS = dict(loss=1e-4, grad=2e-2)
BF16_ONE_ROUND = dict(loss=1e-5, grad=2e-2)
BF16_STATES = dict(loss=5e-3, grad_l2=0.3)
TILES = dict(tile_edges=64, window=32)
NOISE_SCALE = 0.37


def _setup(seed=1, n_formulas=5, **kw):
    kw = dict(SMALL, **kw)
    jkw = dict(kw)
    if jkw.get("compute_dtype") is torch.bfloat16:
        jkw["compute_dtype"] = jnp.bfloat16
    jcfg, tcfg = jqs.QuerySATConfig(**jkw), tqs.QuerySATConfig(**kw)
    jparams = jqs.query_sat_init(jax.random.key(seed), jcfg)
    jb, tb = batch_pair(*random_formulas(seed, n_formulas=n_formulas))
    dims = jdb.dense_dims_for([jb])
    jd, td = jdb.dense_from_flat(jb, *dims), tdb.dense_from_flat(tb, *dims)
    rng = np.random.default_rng(seed + 100)
    labels = rng.integers(0, 2, size=jb.V).astype(np.int32)
    noisy = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=jb.V)]
    return jcfg, tcfg, jparams, (jb, tb, jd, td), labels, noisy


def _inputs(layout, batches, labels, noisy):
    jb, tb, jd, td = batches
    if layout == "dense":
        labels = dense_vars_from_flat(labels, tb, td)
        noisy = dense_vars_from_flat(noisy, tb, td)
    return labels, noisy


def _jax_loss_grads(jcfg, jparams, batch, labels, noisy, layout, plans=None):
    def loss_fn(p):
        common = dict(training=True, labels=jnp.asarray(labels),
                      noise_scale=jnp.float32(NOISE_SCALE),
                      noisy_num=jnp.asarray(noisy))
        if layout == "dense":
            out = jdense(p, jcfg, batch, jax.random.key(0), **common)
        else:
            out = jqs.query_sat_apply(p, jcfg, batch, jax.random.key(0),
                                      plans=plans, **common)
        return out[1], out[2]
    (loss, steps), grads = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
    return float(loss), int(steps), jax.tree.map(np.asarray, grads)


def _torch_loss_grads(tcfg, tparams, batch, labels, noisy, layout,
                      plans=None):
    leaves = [p.requires_grad_(True) for p in jax.tree.leaves(tparams)]
    common = dict(training=True, labels=torch.from_numpy(labels),
                  noise_scale=NOISE_SCALE, noisy_num=torch.from_numpy(noisy),
                  device="cpu")
    if layout == "dense":
        out = tdense(tparams, tcfg, batch, None, **common)
    else:
        out = tqs.query_sat_apply(tparams, tcfg, batch, None, plans=plans,
                                  **common)
    loss = out[1]
    assert loss.requires_grad
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), int(out[2]), [np_of(g) for g in grads]


def _assert_grads_close(got, want, tol, what=""):
    want = jax.tree.leaves(want)
    got = jax.tree.leaves(got)
    assert len(got) == len(want)
    # a bias in front of a pair norm has gradient zero but for round-off, so
    # a tensor's scale is floored at a hundredth of the largest gradient
    floor = 1e-2 * max(float(np.abs(w).max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == np.float32
        scale = max(float(np.abs(w).max()), floor)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale,
                                   err_msg=f"{what} grad tensor {i}")
    assert any(float(np.abs(w).max()) > 0 for w in want)


def _both(layout, with_plans=False, seed=1, **kw):
    jcfg, tcfg, jparams, batches, labels, noisy = _setup(seed, **kw)
    jb, tb, jd, td = batches
    labels, noisy = _inputs(layout, batches, labels, noisy)
    jbatch, tbatch = (jd, td) if layout == "dense" else (jb, tb)
    jplans = jseg.build_batch_plans(jb, **TILES) if with_plans else None
    tplans = build_batch_plans(tb) if with_plans else None
    j = _jax_loss_grads(jcfg, jparams, jbatch, labels, noisy, layout, jplans)
    t = _torch_loss_grads(tcfg, torch_params(jparams), tbatch, labels, noisy,
                          layout, tplans)
    return j, t


def _assert_match(j, t, tol):
    (jloss, jsteps, jgrads), (tloss, tsteps, tgrads) = j, t
    np.testing.assert_allclose(tloss, jloss, rtol=tol["loss"])
    assert tsteps == jsteps
    _assert_grads_close(tgrads, jgrads, tol["grad"])


@pytest.mark.parametrize("with_plans", [False, True],
                         ids=["plain", "plans"])
@pytest.mark.parametrize("mode", ["supervised", "mixed"])
def test_flat_loss_and_grads_match(mode, with_plans):
    _assert_match(*_both("flat", with_plans,
                         supervised=mode == "supervised"), F32)


@pytest.mark.parametrize("mode", ["supervised", "mixed", "linear"])
def test_dense_loss_and_grads_match(mode):
    _assert_match(*_both("dense", supervised=mode == "supervised",
                         use_linear_loss=mode == "linear"), F32)


def test_training_defaults_to_train_rounds_and_masks_after_solving():
    """`rounds` follows `train_rounds` when training, and a batch solved
    early exits only by masking (equal `steps` in both packages)."""
    j, t = _both("flat", True, seed=3, n_formulas=2, train_rounds=5)
    _assert_match(j, t, F32)
    assert t[1] <= 4


def _port_grads(layout, with_plans=False, seed=1, **kw):
    _, tcfg, jparams, batches, labels, noisy = _setup(seed, **kw)
    _, tb, _, td = batches
    labels, noisy = _inputs(layout, batches, labels, noisy)
    plans = build_batch_plans(tb) if with_plans else None
    return _torch_loss_grads(tcfg, torch_params(jparams),
                             td if layout == "dense" else tb, labels, noisy,
                             layout, plans)


def test_flat_equals_dense():
    flat, dense = _port_grads("flat", True), _port_grads("dense")
    np.testing.assert_allclose(dense[0], flat[0], rtol=1e-4)
    assert dense[1] == flat[1]
    _assert_grads_close(dense[2], flat[2], 1e-4)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_remat_modes_equal_none(layout, remat):
    base = _port_grads(layout, layout == "flat")
    got = _port_grads(layout, layout == "flat", remat=remat)
    np.testing.assert_allclose(got[0], base[0], rtol=1e-6)
    assert got[1] == base[1]
    _assert_grads_close(got[2], base[2], 1e-6, remat)


def test_remat_full_replays_the_round_noise():
    """The per-round noise is drawn outside the checkpointed body, so the
    recomputed rounds see the noise of the first pass: gradients equal those
    of `remat="none"` from the same generator state."""
    outs = []
    for remat in ("none", "full"):
        _, tcfg, jparams, (_, tb, _, _), labels, noisy = _setup(
            debug_zero_noise=False, remat=remat)
        tparams = torch_params(jparams)
        leaves = [p.requires_grad_(True) for p in jax.tree.leaves(tparams)]
        out = tqs.query_sat_apply(
            tparams, tcfg, tb, torch.Generator().manual_seed(5),
            training=True, labels=torch.from_numpy(labels),
            noise_scale=NOISE_SCALE, noisy_num=torch.from_numpy(noisy),
            device="cpu")
        outs.append([float(out[1].detach())] + [np_of(g) for g in
                                       torch.autograd.grad(out[1], leaves)])
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-6)
    _assert_grads_close(outs[1][1:], outs[0][1:], 1e-6)


def _rel_l2(got, want):
    got = np.concatenate([g.ravel() for g in jax.tree.leaves(got)])
    want = np.concatenate([w.ravel() for w in jax.tree.leaves(want)])
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("layout,with_plans", [("dense", False),
                                               ("flat", True)])
def test_compute_dtype_matches(layout, with_plans):
    j, t = _both(layout, with_plans, compute_dtype=torch.bfloat16)
    _assert_match(j, t, BF16_OPERANDS)
    f32 = _port_grads(layout, with_plans)
    assert t[0] != f32[0] and _rel_l2(t[2], f32[2]) < 0.3


def test_block_bf16_one_round_matches():
    j, t = _both("dense", block_bf16=True, train_rounds=1)
    _assert_match(j, t, BF16_ONE_ROUND)


def test_block_bf16_three_rounds_within_tolerance():
    j, t = _both("dense", block_bf16=True)
    f32 = _port_grads("dense")
    tol = BF16_STATES
    np.testing.assert_allclose(t[0], j[0], rtol=tol["loss"])
    np.testing.assert_allclose(t[0], f32[0], rtol=tol["loss"])
    assert t[1] == j[1]
    assert _rel_l2(t[2], j[2]) < tol["grad_l2"]
    assert 0 < _rel_l2(t[2], f32[2]) < tol["grad_l2"]


def test_block_bf16_grads_reach_f32_master_params():
    _, tcfg, jparams, (_, _, _, td), labels, noisy = _setup(block_bf16=True)
    tparams = torch_params(jparams)
    labels, noisy = (dense_vars_from_flat(x, _setup()[3][1], td)
                     for x in (labels, noisy))
    _, _, grads = _torch_loss_grads(tcfg, tparams, td, labels, noisy, "dense")
    for p, g in zip(jax.tree.leaves(tparams), grads):
        assert p.dtype == torch.float32 and g.dtype == np.float32
        assert np.isfinite(g).all()
    # the flat model has no block-bf16 flow: the flag leaves it in f32
    a = _port_grads("flat", block_bf16=True)
    b = _port_grads("flat")
    assert a[0] == b[0]


@pytest.mark.parametrize("mode,loss_tol,grad_tol", [
    ("high", 1e-4, 2e-2), ("default", 1e-3, 1e-1)])
def test_incidence_precision_modes_against_highest(mode, loss_tol, grad_tol,
                                                   monkeypatch):
    """`high` rounds the feature operand of the two incidence products to
    TF32 (2^-11 relative), `default` to bf16 (2^-9). Over 3 rounds the loss
    stays within the stated rtol of `highest` and the whole gradient within
    the stated relative L2 distance, and both differ from it."""
    base = _port_grads("dense")
    monkeypatch.setattr(dense_ops, "INCIDENCE_PRECISION", mode)
    got = _port_grads("dense")
    np.testing.assert_allclose(got[0], base[0], rtol=loss_tol)
    assert 0 < _rel_l2(got[2], base[2]) < grad_tol
    assert got[0] != base[0]
    monkeypatch.setattr(dense_ops, "INCIDENCE_PRECISION", "bf16x3")
    with pytest.raises(ValueError, match="INCIDENCE_PRECISION"):
        _port_grads("dense")


def test_incidence_products_keep_integers_exact():
    _, _, _, (_, _, _, td), _, _ = _setup()
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 5, size=(td.G, 2 * td.Vg, 3)).astype(np.float32))
    want = dense_ops.lit_to_clause(td, x)
    for mode in ("high", "default"):
        dense_ops.INCIDENCE_PRECISION = mode
        try:
            assert torch.equal(dense_ops.lit_to_clause(td, x), want)
            assert torch.equal(
                dense_ops.clause_to_lit(td, want),
                torch.einsum("gcl,gcf->glf", td.incidence, want))
        finally:
            dense_ops.INCIDENCE_PRECISION = "highest"
    bf = dataclasses.replace(td, incidence=td.incidence.to(torch.bfloat16))
    out = dense_ops.lit_to_clause(bf, x)      # bf16 incidence, f32 features
    assert out.dtype == torch.float32 and torch.equal(out, want)
    out = dense_ops.lit_to_clause(bf, x.to(torch.bfloat16))
    assert out.dtype == torch.float32 and torch.equal(out, want)

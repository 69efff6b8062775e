"""Port vs TPU package: AdaBelief and the cosine schedule.

The same params and gradients (numpy, seeded) go through the TPU package's
optax transformation and the port's class for 10 updates, which crosses the
RAdam gate (it opens at update 6 with beta2 = 0.999). Params, `m` and `v`
agree to rtol 1e-6 (atol 1e-9 for values near zero).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

# the packages' `train/__init__` may re-export a function of the same name
jab = importlib.import_module("diffusionsat_tpu.train.adabelief")
tab = importlib.import_module("diffusionsat_torch.train.adabelief")
from diffusionsat_torch.train.checkpoint import (
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_from_numpy,
    params_to_numpy,
)

TOL = dict(rtol=1e-6, atol=1e-9)
N_UPDATES = 10


def _tree(rng, scale=1.0):
    return {"a": {"w": [rng.normal(size=(5, 7)).astype(np.float32) * scale,
                        rng.normal(size=(7, 3)).astype(np.float32) * scale],
                  "b": [rng.normal(size=(7,)).astype(np.float32) * scale,
                        np.zeros((3,), np.float32)]},
            "c": {"w": [rng.normal(size=(4, 4)).astype(np.float32) * scale],
                  "b": [rng.normal(size=(4,)).astype(np.float32) * scale]}}


def _assert_trees_close(t_tree, j_tree, what):
    t_leaves = jax.tree.leaves(params_to_numpy(t_tree))
    j_leaves = jax.tree.leaves(jax.tree.map(np.asarray, j_tree))
    assert len(t_leaves) == len(j_leaves)
    for i, (a, b) in enumerate(zip(t_leaves, j_leaves)):
        np.testing.assert_allclose(a, b, err_msg=f"{what}[{i}]", **TOL)


@pytest.mark.parametrize("grad_scale,clipped", [(50.0, True), (1e-3, False)],
                         ids=["clip_triggered", "clip_idle"])
@pytest.mark.parametrize("kw", [
    dict(), dict(weight_decay=0.01), dict(rectify=False),
    dict(clip_gradients=False),
], ids=["default", "weight_decay", "no_rectify", "no_clip"])
def test_updates_match_across_the_radam_gate(kw, grad_scale, clipped):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    lr = dict(initial_lr=1e-2, decay_steps=7, alpha=0.5)
    jopt = jab.adabelief(jab.cosine_decay_schedule(**lr), **kw)
    topt = tab.adabelief(learning_rate=tab.cosine_decay_schedule(**lr), **kw)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tparams = params_from_numpy(params, "cpu")
    tstate = topt.init(tparams)
    saw_clip = False
    for step in range(N_UPDATES):
        grads = _tree(rng, grad_scale)
        # the clip threshold is sqrt(sum(v) / (1 - b2^t)) * 3 + 1e-2
        _, _, v = opt_state_to_numpy(tstate)
        for g, vv in zip(jax.tree.leaves(grads), jax.tree.leaves(v)):
            thr = np.sqrt(vv.sum() / (1 - 0.999 ** (step + 1))) * 3 + 1e-2
            saw_clip |= bool(np.sqrt((g ** 2).sum()) > thr)
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads),
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tparams, tstate = topt.update(params_from_numpy(grads, "cpu"),
                                      tstate, tparams)
        assert int(tstate.count) == int(jstate.count) == step + 1
        _assert_trees_close(tparams, jparams, f"params@{step}")
        _assert_trees_close(tstate.m, jstate.m, f"m@{step}")
        _assert_trees_close(tstate.v, jstate.v, f"v@{step}")
        for leaf in jax.tree.leaves(params_to_numpy(tparams)):
            assert np.isfinite(leaf).all()   # the masked NaN stayed out
    assert saw_clip == clipped


def test_gate_opens_at_update_six():
    """With beta2 = 0.999 the SMA reads about 4.996 at t = 5 (gate shut, the
    update is the bias-corrected momentum) and 5.99 at t = 6."""
    b2 = np.float32(0.999)
    sma_inf = 2.0 / (1.0 - 0.999) - 1.0
    sma = [np.float32(sma_inf - 2.0 * np.float32(t) * b2 ** np.float32(t) /
                      (np.float32(1.0) - b2 ** np.float32(t)))
           for t in (5, 6)]
    assert sma[0] < 5.0 <= sma[1]
    p = {"w": [np.ones((3,), np.float32)]}
    g = {"w": [np.full((3,), 1e-3, np.float32)]}
    topt = tab.adabelief(learning_rate=1.0, clip_gradients=False)
    tparams = params_from_numpy(p, "cpu")
    state = topt.init(tparams)
    steps = []
    for _ in range(7):
        new, state = topt.update(params_from_numpy(g, "cpu"), state, tparams)
        steps.append(float((tparams["w"][0] - new["w"][0])[0]))
    # shut: step = lr * m_hat = 1e-3; open: the rectified adaptive step
    # (1 - 0.999 in f32 carries about 1e-5 of rounding)
    np.testing.assert_allclose(steps[:5], 1e-3, rtol=1e-4)
    assert abs(steps[5] - 1e-3) > 1e-4 and abs(steps[6] - 1e-3) > 1e-4


def test_update_is_functional_and_carries_state_through_numpy():
    rng = np.random.default_rng(1)
    params = params_from_numpy(_tree(rng), "cpu")
    before = [p.clone() for p in jax.tree.leaves(params)]
    opt = tab.adabelief()
    s0 = opt.init(params)
    grads = params_from_numpy(_tree(rng), "cpu")
    p1, s1 = opt.update(grads, s0, params)
    for a, b in zip(jax.tree.leaves(params), before):
        assert torch.equal(a, b)
    assert int(s0.count) == 0 and float(s0.m["a"]["w"][0].abs().sum()) == 0
    # state -> numpy -> state gives the same next update
    s1b = opt_state_from_numpy(*opt_state_to_numpy(s1), device="cpu")
    p2, s2 = opt.update(grads, s1, p1)
    p2b, s2b = opt.update(grads, s1b, p1)
    for a, b in zip(jax.tree.leaves(p2), jax.tree.leaves(p2b)):
        assert torch.equal(a, b)
    assert int(s2b.count) == 2


@pytest.mark.parametrize("count", [0, 1, 3500, 7000, 9000])
def test_cosine_decay_schedule(count):
    kw = dict(initial_lr=1e-3, decay_steps=7000, alpha=0.5)
    want = float(jab.cosine_decay_schedule(**kw)(jnp.asarray(count)))
    got = float(tab.cosine_decay_schedule(**kw)(
        torch.tensor(count, dtype=torch.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if count >= 7000:
        np.testing.assert_allclose(got, 5e-4, rtol=1e-6)
    assert float(tab.cosine_decay_schedule(**kw)(count)) == got


def test_gradient_accumulator_matches():
    rng = np.random.default_rng(2)
    params = _tree(rng)
    jopt = jab.gradient_accumulator(jab.adabelief(1e-2), 3)
    topt = tab.gradient_accumulator(tab.adabelief(learning_rate=1e-2), 3)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tparams = params_from_numpy(params, "cpu")
    tstate = topt.init(tparams)
    for step in range(7):
        grads = _tree(rng)
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads),
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tparams, tstate = topt.update(params_from_numpy(grads, "cpu"),
                                      tstate, tparams)
        _assert_trees_close(tparams, jparams, f"params@{step}")

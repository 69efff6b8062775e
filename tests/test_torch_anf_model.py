"""Port vs TPU package: the ANF losses and the ANFSAT model.

The same numpy-seeded ANF systems and params go through both packages; the
per-round query noise is the TPU package's own draws, replayed into the
port (`round_noise`). The port runs its three aggregation routes: plain
(`index_add_`), planned (`ANFPlans`: the segsum kernel's plain version on
the CPU) and tiled (tile products); the TPU package runs its flat segment
sums, or its tiles at full f32.

Tolerances: the losses' values 1e-5 (f32 sums in another order);
`anf_sat_apply`'s logits and loss 1e-4 over 2-3 recurrent rounds; one
training-mode gradient to 1e-4 of each tensor's largest entry (floored at a
hundredth of the largest gradient of all). The accuracy metric's values are
identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    anf_batch_pair,
    anf_items,
    jax_anf_round_noise,
    np_of,
    torch_params,
)
from diffusionsat_tpu.losses import anf as janf
from diffusionsat_tpu.models import anf_sat as jmodel
from diffusionsat_tpu.ops import tiled_ops as jtiled
from diffusionsat_tpu.train.metrics import ANFAccuracy as JANFAccuracy
from diffusionsat_torch.losses import anf as tanf
from diffusionsat_torch.models import anf_sat as tmodel
from diffusionsat_torch.ops import tiled_ops as ttiled
from diffusionsat_torch.ops.segsum import build_anf_plans
from diffusionsat_torch.train.checkpoint import load_params, params_like
from diffusionsat_torch.train.metrics import ANFAccuracy as TANFAccuracy

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = 1e-4
SMALL = dict(feature_maps=16, query_maps=16, train_rounds=3, test_rounds=2)
FLAGSHIP = "pretrained/anf_sat_sha1_r17_130k.npz"


@pytest.fixture(autouse=True)
def _f32_tiles(monkeypatch):
    # both packages' tile products at full f32 (the bf16 operand setting
    # is held in test_torch_tiled_ops.py)
    monkeypatch.setattr(jtiled, "TILE_PRECISION", jax.lax.Precision.HIGHEST)
    monkeypatch.setattr(ttiled, "TILE_PRECISION", "highest")


def _pair(seed=0, n=4):
    return anf_batch_pair(anf_items(seed, n))


def _routes(tb):
    """kwargs of the port's three aggregation routes."""
    return {"plain": {}, "planned": {"plans": build_anf_plans(tb)},
            "tiled": {"tiles": ttiled.build_anf_tiles(tb, tc=16, tl=32,
                                                      pad_tiles=4)}}


def _logits(shape, seed):
    return np.random.default_rng(seed).normal(
        scale=1.5, size=shape).astype(np.float32)


@pytest.mark.parametrize("route", ["plain", "planned"])
def test_anf_value_real_matches(route):
    jb, tb = _pair(1)
    x = _logits((jb.V, 3), 2)
    jv, ja1, ja2 = janf.anf_value_real(jnp.asarray(x), jb)
    kw = _routes(tb)[route]
    tv, ta1, ta2 = tanf.anf_value_real(torch.from_numpy(x), tb,
                                       plans=kw.get("plans"))
    np.testing.assert_allclose(np_of(tv), np.asarray(jv), **LOSS_TOL)
    # tanh of the two libraries differs in the last bit
    np.testing.assert_allclose(np_of(ta1), np.asarray(ja1), **LOSS_TOL)
    np.testing.assert_allclose(np_of(ta2), np.asarray(ja2), **LOSS_TOL)


@pytest.mark.parametrize("route", ["plain", "planned", "tiled"])
@pytest.mark.parametrize("use_norm", [False, True])
def test_anf_value_cplx_matches(route, use_norm):
    jb, tb = _pair(3)
    x = _logits((jb.V, 8), 4)
    kw = _routes(tb)[route]
    jtiles = None
    if route == "tiled":
        jtiles = jtiled.build_anf_tiles(jb, tc=16, tl=32, pad_tiles=4)
    jr, ji, _, _ = janf.anf_value_cplx(jnp.asarray(x), jb, use_norm=use_norm,
                                       tiles=jtiles)
    tr, ti, _, _ = tanf.anf_value_cplx(torch.from_numpy(x), tb,
                                       use_norm=use_norm, **kw)
    np.testing.assert_allclose(np_of(tr), np.asarray(jr), **LOSS_TOL)
    np.testing.assert_allclose(np_of(ti), np.asarray(ji), **LOSS_TOL)


@pytest.mark.parametrize("route", ["plain", "planned"])
def test_return_messages_cplx_matches(route):
    jb, tb = _pair(5)
    y = _logits((jb.C, 6), 6)
    want = janf.return_messages_cplx(jb, jnp.asarray(y))
    got = tanf.return_messages_cplx(tb, torch.from_numpy(y),
                                    plans=_routes(tb)[route].get("plans"))
    np.testing.assert_allclose(np_of(got), np.asarray(want), **LOSS_TOL)


@pytest.mark.parametrize("route", ["plain", "planned"])
def test_is_graph_sat_anf_matches(route):
    items = anf_items(7, 5)
    jb, tb = anf_batch_pair(items)
    sol = np_of(tb.solutions)
    # the witness solves every system; flip one bit of graph 1 and 3
    bits = sol.copy()
    vg = np_of(tb.var_graph)
    for g in (1, 3):
        bits[np.flatnonzero(vg == g)[0]] ^= 1
    for b in (sol, bits):
        logits = np.where(b == 1, -3.0, 3.0).astype(np.float32)[:, None]
        want = np.asarray(janf.is_graph_sat_anf(jnp.asarray(logits), jb))
        got = np_of(tanf.is_graph_sat_anf(
            torch.from_numpy(logits), tb,
            plans=_routes(tb)[route].get("plans")))
        np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert want[:5, 0].tolist() != [1.0] * 5


def _jax_run(jparams, cfg, jb, key, training, labels=None, tiles=None,
             rounds=None):
    return jmodel.anf_sat_apply(jparams, cfg, jb, key, training=training,
                                labels=labels, tiles=tiles, rounds=rounds)


@pytest.mark.parametrize("route", ["plain", "planned", "tiled"])
@pytest.mark.parametrize("supervised", [True, False])
def test_anf_sat_apply_matches(route, supervised):
    jb, tb = _pair(8, 5)
    jcfg = jmodel.ANFSATConfig(**SMALL, free_input_upweight=4.0)
    tcfg = tmodel.ANFSATConfig(**SMALL, free_input_upweight=4.0)
    jparams = jmodel.anf_sat_init(jax.random.key(0), jcfg)
    params = torch_params(jparams)
    key = jax.random.key(3)
    noise = jax_anf_round_noise(key, jcfg.test_rounds, jb.V)
    kw = _routes(tb)[route]
    jtiles = jtiled.build_anf_tiles(jb, tc=16, tl=32, pad_tiles=4) \
        if route == "tiled" else None
    labels = jb.solutions if supervised else None
    jl, jloss, jsteps, _ = _jax_run(jparams, jcfg, jb, key, False,
                                    labels=labels, tiles=jtiles)
    tl, tloss, tsteps, _ = tmodel.anf_sat_apply(
        params, tcfg, tb, training=False, round_noise=noise, device="cpu",
        labels=None if labels is None else torch.from_numpy(
            np.asarray(labels)), **kw)
    np.testing.assert_allclose(np_of(tl), np.asarray(jl), **MODEL_TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), **MODEL_TOL)
    assert int(tsteps) == int(jsteps)


def _leaves(tree):
    """The params tree's tensors in one fixed order: each module's kernels
    and biases, and the bare `zero_var` row."""
    out = []
    for name in sorted(tree):
        m = tree[name]
        out.extend(m["w"] + m["b"] if isinstance(m, dict) else [m])
    return out


def _grad_err(got, want):
    top = max(np.abs(w).max() for w in want)
    return max(np.abs(g - w).max() / max(np.abs(w).max(), 1e-2 * top)
               for g, w in zip(got, want))


@pytest.mark.parametrize("route", ["planned", "tiled"])
def test_training_gradient_matches(route):
    jb, tb = _pair(9, 5)
    jcfg = jmodel.ANFSATConfig(**SMALL, free_input_upweight=3.0)
    tcfg = tmodel.ANFSATConfig(**SMALL, free_input_upweight=3.0)
    jparams = jmodel.anf_sat_init(jax.random.key(1), jcfg)
    key = jax.random.key(5)
    jtiles = jtiled.build_anf_tiles(jb, tc=16, tl=32, pad_tiles=4) \
        if route == "tiled" else None

    def jloss_fn(p):
        return _jax_run(p, jcfg, jb, key, True, labels=jb.solutions,
                        tiles=jtiles)[1]

    jloss, jgrads = jax.value_and_grad(jloss_fn)(jparams)
    params = torch_params(jparams)
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    noise = jax_anf_round_noise(key, jcfg.train_rounds, jb.V)
    _, tloss, _, _ = tmodel.anf_sat_apply(
        params, tcfg, tb, training=True, labels=tb.solutions,
        round_noise=noise, device="cpu", **_routes(tb)[route])
    tgrads = torch.autograd.grad(tloss, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-4)
    want = [np.asarray(g) for g in _leaves(jgrads)]
    # grad_mlp is part of the tree but no round uses it: no gradient
    got = [np.zeros_like(w) if g is None else np_of(g)
           for g, w in zip(tgrads, want)]
    assert _grad_err(got, want) < GRAD_TOL


def test_tiled_and_planned_training_losses_agree():
    """The two training layouts from one batch, params and noise: the same
    loss at f32 tiles."""
    _, tb = _pair(10, 4)
    cfg = tmodel.ANFSATConfig(**SMALL)
    params = tmodel.anf_sat_init(torch.Generator().manual_seed(0), cfg)
    noise = torch.from_numpy(np.random.default_rng(0).normal(
        size=(cfg.train_rounds, tb.V, 4)).astype(np.float32))
    losses = [float(tmodel.anf_sat_apply(
        params, cfg, tb, training=True, labels=tb.solutions,
        round_noise=noise, device="cpu", **kw)[1])
        for kw in _routes(tb).values()]
    np.testing.assert_allclose(losses, losses[0], rtol=1e-5)


def test_flagship_full_width_matches():
    """The r17 flagship's params at full width (128 / 128 maps), loaded in
    the init's module order, on one small SHA-1 batch for 2 rounds."""
    from diffusionsat_tpu.data.sha_anf import Sha1AnfInstances
    from diffusionsat_tpu.train.checkpoint import restore_model_params

    items = list(Sha1AnfInstances(rounds=2, min_free_bits=4, max_free_bits=6,
                                  train_size=2, seed=0).train_generator())
    jb, tb = anf_batch_pair(items, max_vars=2048, max_ands=2048,
                            max_clauses=2048, max_edges=8192, max_graphs=2)
    jcfg = jmodel.ANFSATConfig(test_rounds=2)
    jparams = restore_model_params(FLAGSHIP, jmodel.anf_sat_init, jcfg)
    tcfg = tmodel.ANFSATConfig(test_rounds=2)
    tree, meta = load_params(FLAGSHIP)
    assert meta["model"] == "anf_sat"
    template = tmodel.anf_sat_init(torch.Generator().manual_seed(0), tcfg)
    params = params_like(template, torch_params(tree))
    assert list(params) == list(template)
    key = jax.random.key(2)
    jl, jloss, _, _ = _jax_run(jparams, jcfg, jb, key, False)
    tl, tloss, _, _ = tmodel.anf_sat_apply(
        params, tcfg, tb, training=False, device="cpu",
        round_noise=jax_anf_round_noise(key, 2, jb.V),
        plans=build_anf_plans(tb))
    np.testing.assert_allclose(np_of(tl), np.asarray(jl), **MODEL_TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), **MODEL_TOL)


def test_anf_accuracy_metric_identical():
    items = anf_items(11, 5)
    jb, tb = anf_batch_pair(items)
    rng = np.random.default_rng(12)
    sol = np_of(tb.solutions)
    jm, tm = JANFAccuracy(), TANFAccuracy()
    for flip in (0.0, 0.02, 0.3):
        bits = sol ^ (rng.random(sol.shape) < flip)
        pred = np.where(bits == 1, 2.0, -2.0).astype(np.float32)
        jm.update_state({"prediction": jnp.asarray(pred)}, jb)
        tm.update_state({"prediction": torch.from_numpy(pred)}, tb)
    want, got = jm.get_values(), tm.get_values()
    assert got == want
    assert 0.0 < want["total_accuracy"] < 1.0
    assert "free_input_accuracy" in want


def test_config_and_init_mirror_the_tpu_package():
    jcfg, tcfg = jmodel.ANFSATConfig(), tmodel.ANFSATConfig()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert jcfg.mlp_configs().keys() == tcfg.mlp_configs().keys()
    for k, (m, d) in jcfg.mlp_configs().items():
        tm, td = tcfg.mlp_configs()[k]
        assert (m.layer_count, m.hidden, m.out, d) == \
            (tm.layer_count, tm.hidden, tm.out, td)
    jp = jmodel.anf_sat_init(jax.random.key(0), jcfg)
    tp = tmodel.anf_sat_init(torch.Generator().manual_seed(0), tcfg)
    assert list(jp) == list(tp)
    assert jax.tree.map(np.shape, jp) == jax.tree.map(
        lambda t: tuple(t.shape), tp, is_leaf=lambda t: isinstance(
            t, torch.Tensor))
    np.testing.assert_array_equal(np_of(tmodel._zero_state(5, 8, "cpu")),
                                  np.asarray(jmodel._zero_state(5, 8)))


def test_anf_plans_split_the_constant_node():
    """The plans hold every membership edge but the constant node's, whose
    per-clause count rides beside them; both directions and their
    gradients equal the whole sums (1e-5)."""
    from diffusionsat_tpu.data.sha_anf import Sha1AnfInstances
    from diffusionsat_torch.ops import segsum

    items = list(Sha1AnfInstances(rounds=3, min_free_bits=6, max_free_bits=8,
                                  train_size=2, seed=3).train_generator())
    _, tb = anf_batch_pair(items, max_vars=512, max_ands=512,
                           max_clauses=512, max_edges=2048, max_graphs=2)
    plans = build_anf_plans(tb)
    em = np_of(tb.edge_mask_c) > 0
    const = em & (np_of(tb.edge_node_c) == 0)
    assert const.sum() > 0
    np.testing.assert_array_equal(
        np_of(plans.const_count),
        np.bincount(np_of(tb.edge_clause_c)[const], minlength=tb.C))
    assert plans.node_to_clause.gather.shape[0] == em.sum() - const.sum()
    assert int(plans.clause_to_node.row_ptr[1]) == 0
    rng = np.random.default_rng(4)
    for fn, whole, n_in in (
            (segsum.plan_node_to_clause, tanf.seg_to_clause, tb.n_value_nodes),
            (segsum.plan_clause_to_node, tanf.seg_to_nodes, tb.C)):
        w = torch.from_numpy(rng.normal(size=(n_in, 5)).astype(np.float32))
        grads = []
        for f in (lambda x: fn(x, plans), lambda x: whole(x, tb)):
            x = w.clone().requires_grad_(True)
            out = f(x)
            (out * torch.arange(out.shape[0])[:, None].float().cos()
             ).sum().backward()
            grads.append((out.detach(), x.grad))
        np.testing.assert_allclose(np_of(grads[0][0]), np_of(grads[1][0]),
                                   **LOSS_TOL)
        np.testing.assert_allclose(np_of(grads[0][1]), np_of(grads[1][1]),
                                   **LOSS_TOL)

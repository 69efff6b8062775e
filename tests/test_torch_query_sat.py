"""Port vs TPU package: QuerySAT inference (`query_sat_apply`).

Every draw is pinned: labels, noise scale and noisy input are injected,
and the per-round noise is either zeroed (`debug_zero_noise`) or replayed
from the TPU package's key schedule. The TPU package's planned path runs
its Pallas kernel in interpret mode. Logits match at rtol 1e-4 (four or
more recurrent rounds of f32 summation-order differences) and `steps` are
equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    batch_pair,
    load_cnf_clauses,
    np_of,
    random_formulas,
    torch_params,
)
from diffusionsat_tpu.diffusion.schedule import construct_training_input
from diffusionsat_tpu.models import query_sat as jqs
from diffusionsat_tpu.ops.pallas_segsum import build_batch_plans as jplans
from diffusionsat_tpu.sat.solvers import solve
from diffusionsat_tpu.train.checkpoint import load_params
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.ops.segsum import build_batch_plans as tplans

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(feature_maps=16, query_maps=8, logit_maps=4, test_rounds=4)
MLK64 = "pretrained/query_sat_3sat_diffusion_mlk64.npz"


def _cfgs(**kw):
    return jqs.QuerySATConfig(**kw), tqs.QuerySATConfig(**kw)


def _run_both(jparams, kw, jb, tb, *, labels, noise_scale, noisy,
              early_exit, with_plans, rounds=None, key=None,
              round_noise=None):
    jcfg, tcfg = _cfgs(**kw)
    jp = jplans(jb, tile_edges=256, window=128) if with_plans else None
    tp = tplans(tb) if with_plans else None
    jout = jqs.query_sat_apply(
        jparams, jcfg, jb, key if key is not None else jax.random.key(0),
        training=False, labels=jnp.asarray(labels),
        noise_scale=jnp.float32(noise_scale), noisy_num=jnp.asarray(noisy),
        rounds=rounds, early_exit=early_exit, plans=jp)
    tout = tqs.query_sat_apply(
        torch_params(jparams), tcfg, tb, None, labels=torch.from_numpy(labels),
        noise_scale=noise_scale, noisy_num=torch.from_numpy(noisy),
        rounds=rounds, early_exit=early_exit, plans=tp,
        round_noise=round_noise, device="cpu")
    return jout, tout


def _assert_match(jout, tout):
    (jl, jloss, jsteps, jaux), (tl, tloss, tsteps, taux) = jout, tout
    np.testing.assert_allclose(np_of(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(np_of(taux["logits_all_heads"]),
                               np.asarray(jaux["logits_all_heads"]), **TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    assert int(tsteps) == int(jsteps)
    assert bool(taux["solved"]) == bool(jaux["solved"])


def _small_inputs(seed, V):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, size=V).astype(np.int32)
    noisy = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=V)]
    return labels, noisy


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("with_plans", [False, True])
def test_small_config_matches(early_exit, with_plans):
    kw = dict(SMALL, debug_zero_noise=True)
    jparams = jqs.query_sat_init(jax.random.key(0), _cfgs(**kw)[0])
    formulas, sols = random_formulas(1, n_formulas=4)
    jb, tb = batch_pair(formulas, sols)
    labels, noisy = _small_inputs(2, jb.V)
    _assert_match(*_run_both(jparams, kw, jb, tb, labels=labels,
                             noise_scale=0.37, noisy=noisy,
                             early_exit=early_exit, with_plans=with_plans))


@pytest.mark.parametrize("loss", ["mixed", "linear"])
def test_small_unsupervised_matches(loss):
    kw = dict(SMALL, debug_zero_noise=True, supervised=False,
              use_linear_loss=loss == "linear")
    jparams = jqs.query_sat_init(jax.random.key(3), _cfgs(**kw)[0])
    formulas, sols = random_formulas(4, n_formulas=3)
    jb, tb = batch_pair(formulas, sols)
    labels, noisy = _small_inputs(5, jb.V)
    _assert_match(*_run_both(jparams, kw, jb, tb, labels=labels,
                             noise_scale=0.6, noisy=noisy, early_exit=False,
                             with_plans=True))


def test_predict_mode_draws_replayed_from_tpu_key_schedule():
    """Predict mode with per-round noise: the TPU package draws noise
    scale, labels, noisy input and the per-round noise from one key; the
    port takes the same numbers injected."""
    kw = dict(SMALL)
    jcfg, tcfg = _cfgs(**kw)
    jparams = jqs.query_sat_init(jax.random.key(1), jcfg)
    formulas, sols = random_formulas(6, n_formulas=3)
    jb, tb = batch_pair(formulas, sols)
    key = jax.random.key(42)
    jl, jloss, jsteps, jaux = jqs.query_sat_apply(jparams, jcfg, jb, key,
                                                  training=False)
    k_noise, k_labels, k_input, key_loop = jax.random.split(key, 4)
    ns = jax.random.uniform(k_noise, ())
    labels = jax.random.randint(k_labels, (jb.V,), 0, 2, dtype=jnp.int32)
    noisy = construct_training_input(k_input, labels, ns)
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key_loop, r), (jb.V, 4), jnp.float32))
        for r in range(jcfg.test_rounds)])
    tl, tloss, tsteps, taux = tqs.query_sat_apply(
        torch_params(jparams), tcfg, tb, None,
        labels=torch.from_numpy(np.array(labels)),
        noise_scale=float(ns), noisy_num=torch.from_numpy(np.array(noisy)),
        round_noise=torch.from_numpy(noise), device="cpu")
    _assert_match((jl, jloss, jsteps, jaux), (tl, tloss, tsteps, taux))


@pytest.fixture(scope="module")
def mlk64():
    params, meta = load_params(MLK64)
    return params, meta["config"]


def _uf20_batch_and_solutions(names):
    formulas, sols = [], []
    for name in names:
        n, clauses = load_cnf_clauses(f"satlib/{name}")
        ok, model = solve(clauses, n)
        assert ok
        formulas.append((n, clauses))
        sols.append([1 if v > 0 else 0 for v in model])
    jb, tb = batch_pair(formulas, sols, max_vars=64, max_clauses=384,
                        max_edges=1024, max_graphs=4)
    return jb, tb, np.asarray(jb.solutions)


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("with_plans", [False, True])
@pytest.mark.parametrize("regime", ["hinted", "solving"])
def test_mlk64_full_width_matches(mlk64, regime, early_exit, with_plans):
    params, config = mlk64
    kw = {k: v for k, v in config.items()
          if k in {f.name for f in dataclasses.fields(tqs.QuerySATConfig)}}
    kw.update(debug_zero_noise=True, test_rounds=6)
    jb, tb, sol = _uf20_batch_and_solutions(
        ["uf20-synth-1.cnf", "uf20-synth-2.cnf", "uf20-synth-3.cnf"])
    if regime == "hinted":
        # a low-noise view of true solutions: the batch is satisfied
        # within the first rounds, so the early exit fires
        labels = sol.astype(np.int32)
        noisy = np.eye(2, dtype=np.float32)[sol]
        ns = 0.1
    else:
        labels, noisy = _small_inputs(7, jb.V)
        ns = 1.0
    jout, tout = _run_both(params, kw, jb, tb, labels=labels,
                           noise_scale=ns, noisy=noisy,
                           early_exit=early_exit, with_plans=with_plans)
    _assert_match(jout, tout)
    if regime == "hinted":
        assert bool(tout[3]["solved"])


def test_rounds_after_solving_are_no_ops(mlk64):
    """With no exploration noise, rounds run after the batch is solved are
    masked no-ops: the early-exit loop and the fixed-count loop agree
    bit for bit."""
    params, config = mlk64
    cfg = tqs.QuerySATConfig.from_meta(config, debug_zero_noise=True,
                                       test_rounds=8)
    _, tb, sol = _uf20_batch_and_solutions(["uf20-synth-4.cnf"])
    tparams = torch_params(params)
    common = dict(labels=torch.from_numpy(sol.astype(np.int32)),
                  noise_scale=0.1,
                  noisy_num=torch.from_numpy(
                      np.eye(2, dtype=np.float32)[sol]),
                  plans=tplans(tb), device="cpu")
    outs = [tqs.query_sat_apply(tparams, cfg, tb, None, early_exit=e,
                                **common) for e in (True, False)]
    assert bool(outs[0][3]["solved"]) and int(outs[0][2]) < 7
    for out in outs[1:]:
        assert torch.equal(out[0], outs[0][0])
        assert torch.equal(out[1], outs[0][1])
        assert int(out[2]) == int(outs[0][2])
        for k in ("logits_all_heads", "variables_state", "clause_state"):
            assert torch.equal(out[3][k], outs[0][3][k])


@pytest.mark.parametrize("mode", [
    dict(training=True), dict(group="one rank"), dict(halo={}),
    dict(cfg=dict(block_bf16=True)), dict(cfg=dict(remat="full")),
    dict(cfg=dict(compute_dtype=torch.bfloat16)),
])
def test_unported_modes_raise(mode):
    """Every mode of the TPU package's apply runs in the port. Sharded
    execution (the TPU package's `axis_name`, the port's process `group`)
    on a group of one rank equals the unsharded run bit for bit; a halo
    view without its group raises (tests/test_torch_parallel*.py hold the
    sharded numbers). The training modes that raised before the training
    slice run (their numbers are held in test_torch_train_grads.py)."""
    cfg = tqs.QuerySATConfig(**SMALL, **mode.pop("cfg", {}))
    params = tqs.query_sat_init(torch.Generator().manual_seed(0), cfg)
    formulas, sols = random_formulas(0, n_formulas=2)
    _, tb = batch_pair(formulas, sols)
    if "halo" in mode:
        with pytest.raises(ValueError, match="process group"):
            tqs.query_sat_apply(params, cfg, tb, None, device="cpu", **mode)
        return
    if "group" in mode:
        import torch.distributed as dist

        from diffusionsat_torch.parallel.mesh import free_port
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
            world_size=1, rank=0)
        try:
            outs = [tqs.query_sat_apply(
                params, cfg, tb, torch.Generator().manual_seed(1),
                device="cpu", group=group)
                for group in (None, dist.new_group([0]))]
        finally:
            dist.destroy_process_group()
        for a, b in zip(outs[0][:3], outs[1][:3]):
            assert torch.equal(a, b)
        return
    if mode.get("training"):
        for leaf in jax.tree.leaves(params):
            leaf.requires_grad_(True)
    out = tqs.query_sat_apply(params, cfg, tb, torch.Generator().manual_seed(1),
                              device="cpu", **mode)
    assert torch.isfinite(out[1]) and out[0].shape == (tb.V, 1)
    assert out[1].requires_grad == bool(mode.get("training"))
    with pytest.raises(ValueError, match="float32"):
        tqs.query_sat_apply(params, dataclasses.replace(
            cfg, dtype=torch.bfloat16), tb, None, device="cpu")


def test_predict_mode_runs_from_a_generator():
    cfg = tqs.QuerySATConfig(**SMALL)
    g = torch.Generator().manual_seed(0)
    params = tqs.query_sat_init(g, cfg)
    formulas, sols = random_formulas(2, n_formulas=3)
    _, tb = batch_pair(formulas, sols)
    a = tqs.query_sat_apply(params, cfg, tb, torch.Generator().manual_seed(5),
                            device="cpu")
    b = tqs.query_sat_apply(params, cfg, tb, torch.Generator().manual_seed(5),
                            device="cpu")
    assert a[0].shape == (tb.V, 1) and torch.isfinite(a[0]).all()
    assert torch.equal(a[0], b[0])

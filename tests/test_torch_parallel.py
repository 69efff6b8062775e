"""The port's data parallelism against the TPU package's, on gloo ranks on
the CPU.

One world of 4 ranks is started for the module; every rank runs the cases
of `_torch_parallel_ranks.py`, which import torch and the port only, and
hands back numpy. This process then computes the reference values and
compares:

- the DP step (dense, flat with kernel plans, ANF with `ANFPlans`, flat
  with a label bank): loss and every gradient against the mean of the
  port's single-device gradients with the same draws, to 1e-5 of each
  tensor's largest entry, and against the mean of the single-device
  `jax.grad`s to 1e-4 (the two packages sum in other f32 orders: a single
  device lies up to 1.1e-5 of a tensor's largest entry from JAX here,
  and tests/test_torch_train_grads.py holds it at 1e-4); the params after
  two AdaBelief steps equal on every rank;
- the sharded SpMM against JAX's `make_sharded_spmm` on 8 devices;
- the sharded sampler chain: every rank's bits and solved flags equal bit
  for bit to the chain run alone.

The last bias of `update_gate` has a true gradient of zero and is held to
the tolerance times the largest gradient entry of all tensors
(`_torch_parity.round_off_leaf`). The clause-sharded and halo steps are in
tests/test_torch_parallel_halo.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionsat_tpu.graph import dense_batch as jdense
from diffusionsat_tpu.models import anf_sat as janf
from diffusionsat_tpu.models import query_sat as jqs
from diffusionsat_tpu.models.query_sat_dense import query_sat_dense_apply
from diffusionsat_tpu.ops.graph_ops import clause_to_lit, lit_to_clause
from diffusionsat_tpu.parallel import graph_partition as jgp
from diffusionsat_tpu.parallel.mesh import make_mesh
from diffusionsat_torch.diffusion.sampler import make_diffusion_chain
from diffusionsat_torch.graph import dense_batch as tdense
from diffusionsat_torch.models import anf_sat as tanf
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.models.query_sat_dense import (
    query_sat_dense_apply as tquery_sat_dense_apply,
)
from diffusionsat_torch.parallel.mesh import launch
from diffusionsat_torch.train.checkpoint import params_from_numpy

import _torch_parallel_ranks as ranks
from _torch_parallel_ranks import BUCKET, random_formulas, strip
from _torch_parity import (
    anf_batch_pair,
    anf_items,
    assert_grads_close,
    batch_pair,
    jax_anf_round_noise,
    leaf_names,
    np_tree,
)

SMALL = dict(feature_maps=8, query_maps=8, train_rounds=3, test_rounds=3)
# the DP step against JAX's gradients (see the docstring)
JAX_DP_GRAD_TOL = 1e-4
SEED = 11


def dp_flat_batches(bank=False):
    pairs = []
    for i in range(4):
        formulas, sols = random_formulas(20 + i, n_graphs=3)
        if bank:
            rng = np.random.default_rng(30 + i)
            sols = [[s] + [rng.integers(0, 2, len(s)).tolist()
                           for _ in range(2)] for s in sols]
        pairs.append(batch_pair(formulas, sols, **BUCKET))
    return pairs


def noisy(rng, shape):
    return np.eye(2, dtype=np.float32)[rng.integers(0, 2, shape)]


def world_inputs():
    """Every case of the 4-rank world, and what the parent needs to check
    it."""
    rng = np.random.default_rng(0)
    jcfg = jqs.QuerySATConfig(**SMALL, debug_zero_noise=True)
    tcfg = tqs.QuerySATConfig(**SMALL, debug_zero_noise=True)
    jparams = jqs.query_sat_init(jax.random.key(0), jcfg)
    cases, checks = [], []

    # -- DP: flat (plans), dense, flat with a label bank, ANF
    flat = dp_flat_batches()
    draws = [dict(noise_scale=float(rng.uniform()),
                  noisy_num=noisy(rng, tb.V)) for _, tb in flat]
    cases.append(("dp", dict(apply="flat", cfg=tcfg, params=np_tree(jparams),
                             batches=[strip(tb) for _, tb in flat],
                             draws=draws, seed=SEED)))
    checks.append(("dp_flat", dict(jcfg=jcfg, jparams=jparams,
                                   jbatches=[jb for jb, _ in flat],
                                   draws=draws, apply=jqs.query_sat_apply,
                                   tcfg=tcfg, tbatches=[tb for _, tb in flat],
                                   tapply=tqs.query_sat_apply)))
    dense = [(jdense.densify_batches([jb])[0],
              tdense.densify_batches([tb])[0]) for jb, tb in flat]
    ddraws = [dict(noise_scale=float(rng.uniform()),
                   noisy_num=noisy(rng, (td.G, td.Vg))) for _, td in dense]
    cases.append(("dp", dict(apply="dense", cfg=tcfg,
                             params=np_tree(jparams),
                             batches=[strip(td) for _, td in dense],
                             draws=ddraws, seed=SEED)))
    checks.append(("dp_dense", dict(jcfg=jcfg, jparams=jparams,
                                    jbatches=[jd for jd, _ in dense],
                                    draws=ddraws,
                                    apply=query_sat_dense_apply, tcfg=tcfg,
                                    tbatches=[td for _, td in dense],
                                    tapply=tquery_sat_dense_apply)))
    bank = dp_flat_batches(bank=True)
    bdraws = [dict(noise_scale=float(rng.uniform()),
                   noisy_num=noisy(rng, tb.V)) for _, tb in bank]
    cases.append(("dp", dict(apply="flat", cfg=tcfg, params=np_tree(jparams),
                             batches=[strip(tb) for _, tb in bank],
                             draws=bdraws, seed=SEED)))
    checks.append(("dp_bank", dict(jcfg=jcfg, jparams=jparams,
                                   jbatches=[jb for jb, _ in bank],
                                   draws=bdraws, apply=jqs.query_sat_apply,
                                   tcfg=tcfg, tbatches=[tb for _, tb in bank],
                                   tapply=tqs.query_sat_apply)))
    acfg = dict(feature_maps=16, query_maps=16, train_rounds=2,
                test_rounds=2)
    jacfg, tacfg = janf.ANFSATConfig(**acfg), tanf.ANFSATConfig(**acfg)
    japarams = janf.anf_sat_init(jax.random.key(29), jacfg)
    anf = [anf_batch_pair(anf_items(seed=40 + i, n=3)) for i in range(4)]
    akeys = [jax.random.key(50 + i) for i in range(4)]
    adraws = [dict(round_noise=jax_anf_round_noise(
        k, jacfg.train_rounds, tb.V).numpy()) for k, (_, tb) in
        zip(akeys, anf)]
    cases.append(("dp", dict(apply="anf", cfg=tacfg,
                             params=np_tree(japarams),
                             batches=[strip(tb) for _, tb in anf],
                             draws=adraws, seed=SEED)))
    checks.append(("dp_anf", dict(jcfg=jacfg, jparams=japarams,
                                  jbatches=[jb for jb, _ in anf],
                                  keys=akeys, apply=janf.anf_sat_apply,
                                  draws=adraws, tcfg=tacfg,
                                  tbatches=[tb for _, tb in anf],
                                  tapply=tanf.anf_sat_apply)))

    # -- the sharded SpMM, 4 shards (JAX's on 8)
    sp_formulas, sp_sols = random_formulas(42, n_graphs=3)
    jsb, tsb = batch_pair(sp_formulas, sp_sols, **dict(BUCKET, max_graphs=4))
    lit_feats = rng.normal(size=(2 * tsb.V, 16)).astype(np.float32)
    clause_feats = rng.normal(size=(tsb.C, 16)).astype(np.float32)
    cases.append(("sharded_spmm", dict(batch=strip(tsb), lit_feats=lit_feats,
                                       clause_feats=clause_feats)))
    checks.append(("sharded_spmm", dict(jbatch=jsb, lit_feats=lit_feats,
                                        clause_feats=clause_feats)))

    # -- the sharded sampler chain
    chain_kw = dict(diffusion_steps=3, test_rounds=2, freeze_sat=False)
    ccfg = tqs.QuerySATConfig(**SMALL)
    chain_batches = [strip(tb) for _, tb in flat]
    cases.append(("chain", dict(cfg=ccfg, params=np_tree(jparams),
                                chain_kw=chain_kw, batches=chain_batches,
                                seeds=[23 + i for i in range(4)])))
    checks.append(("chain", dict(cfg=ccfg, params=np_tree(jparams),
                                 chain_kw=chain_kw, batches=chain_batches,
                                 seeds=[23 + i for i in range(4)])))
    return cases, checks


@pytest.fixture(scope="module")
def world4():
    cases, checks = world_inputs()
    results = launch(ranks.run_cases, 4, "gloo", None, cases)
    return cases, checks, results


def case_results(world4, name, index=0):
    cases, checks, results = world4
    at = [i for i, (n, _) in enumerate(checks) if n == name][index]
    return cases[at][1], checks[at][1], [r[at] for r in results]


# -- data parallelism ------------------------------------------------------


def jax_dp_reference(chk, labels=None):
    """Mean loss and mean gradients of single-device `jax.grad`s."""
    apply, jcfg = chk["apply"], chk["jcfg"]

    def loss_fn(p, jb, key, kw):
        return apply(p, jcfg, jb, key, training=True, **kw)[1]

    vg = jax.jit(jax.value_and_grad(loss_fn))
    losses, grads = [], []
    for i, jb in enumerate(chk["jbatches"]):
        if "keys" in chk:
            key, kw = chk["keys"][i], dict(labels=jb.solutions)
        else:
            d = chk["draws"][i]
            lab = jb.solutions if labels is None else jnp.asarray(labels[i])
            key = jax.random.key(0)
            kw = dict(labels=lab, noise_scale=jnp.float32(d["noise_scale"]),
                      noisy_num=jnp.asarray(d["noisy_num"]))
        loss, g = vg(chk["jparams"], jb, key, kw)
        losses.append(float(loss))
        grads.append([np.asarray(x) for x in jax.tree.leaves(g)])
    return (float(np.mean(losses)),
            [np.mean([g[i] for g in grads], axis=0)
             for i in range(len(grads[0]))])


def port_dp_reference(chk, labels=None):
    """Mean loss and mean gradients of the port's single-device steps on
    the CPU (flat batches with their plans), with the same draws."""
    from diffusionsat_torch.train.loop import (
        _grad_leaves,
        _grads_of,
        build_plans,
    )

    params = params_from_numpy(np_tree(chk["jparams"]), "cpu")
    losses, grads = [], []
    for i, tb in enumerate(chk["tbatches"]):
        kw = {k: torch.as_tensor(v) if not isinstance(v, float) else v
              for k, v in chk["draws"][i].items()}
        kw["labels"] = tb.solutions if labels is None else \
            torch.from_numpy(labels[i])
        plans = build_plans(tb)
        if plans is not None:
            kw["plans"] = plans
        tree, leaves, spec = _grad_leaves(params)
        loss = chk["tapply"](tree, chk["tcfg"], tb, None, training=True,
                             device="cpu", **kw)[1]
        losses.append(float(loss.detach()))
        grads.append([g.numpy() for g in _grads_of(loss, leaves, spec)[1]])
    return (float(np.mean(losses)),
            [np.mean([g[i] for g in grads], axis=0)
             for i in range(len(grads[0]))])


@pytest.mark.parametrize("name", ["dp_flat", "dp_dense", "dp_bank",
                                  "dp_anf"])
def test_dp_step_is_the_mean_of_single_device_gradients(world4, name):
    _, chk, res = case_results(world4, name)
    labels = [r["labels"] for r in res] if name == "dp_bank" else None
    if labels is not None:
        # each rank drew its own rows from its own generator
        assert any(not np.array_equal(lab, res[0]["labels"])
                   for lab in labels[1:])
    loss, grads = port_dp_reference(chk, labels)
    jloss, jgrads = jax_dp_reference(chk, labels)
    names = leaf_names(chk["jparams"])
    for r in res:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        assert_grads_close(r["grads"], grads, names)
        np.testing.assert_allclose(r["loss"], jloss, rtol=1e-5)
        assert_grads_close(r["grads"], jgrads, names, JAX_DP_GRAD_TOL)
        np.testing.assert_allclose(
            r["gradnorm"], np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                                       for g in grads)), rtol=1e-5)
        assert r["transport"] == "gloo"


@pytest.mark.parametrize("name", ["dp_flat", "dp_dense", "dp_bank",
                                  "dp_anf"])
def test_dp_params_stay_replicated(world4, name):
    _, _, res = case_results(world4, name)
    assert len({r["hash"] for r in res}) == 1
    for r in res:
        assert np.all(np.isfinite(r["losses"])) and r["losses"] == \
            res[0]["losses"]


def test_rank_generators_differ_by_rank_and_step():
    from diffusionsat_torch.parallel.dp import rank_generator
    draws = {(r, s): torch.rand(4, generator=rank_generator(3, r, s, "cpu"))
             for r in range(3) for s in range(2)}
    vals = [tuple(v.tolist()) for v in draws.values()]
    assert len(set(vals)) == len(vals)
    again = torch.rand(4, generator=rank_generator(3, 1, 1, "cpu"))
    assert torch.equal(again, draws[(1, 1)])


# -- the sharded SpMM ------------------------------------------------------


def test_sharded_spmm_matches_the_tpu_packages(world4):
    _, chk, res = case_results(world4, "sharded_spmm")
    jb = chk["jbatch"]
    mesh = make_mesh(n_data=1, n_graph=8, devices=jax.devices()[:8])
    sharded = jgp.place_sharded_batch(jgp.shard_batch_by_clause(jb, 8), mesh)
    l2c, c2l = jgp.make_sharded_spmm(mesh, jb.V, jb.C, 8)
    want_c = np.asarray(l2c(jnp.asarray(chk["lit_feats"]),
                            sharded.edge_lit_c, sharded.edge_clause_c,
                            sharded.edge_mask_c))
    want_l = np.asarray(c2l(jnp.asarray(chk["clause_feats"]),
                            sharded.edge_lit_c, sharded.edge_clause_c,
                            sharded.edge_mask_c))
    np.testing.assert_allclose(
        want_c, np.asarray(lit_to_clause(jb, jnp.asarray(chk["lit_feats"]))),
        rtol=1e-5, atol=1e-5)
    got_c = np.concatenate([r["clauses"] for r in res])
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5, atol=1e-5)
    for r in res:
        np.testing.assert_allclose(r["literals"], want_l, rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(
        want_l, np.asarray(clause_to_lit(jb, jnp.asarray(
            chk["clause_feats"]))), rtol=1e-5, atol=1e-5)


# -- the sharded sampler chain ---------------------------------------------


def test_sharded_chain_equals_each_ranks_chain_alone(world4):
    _, chk, res = case_results(world4, "chain")
    assert all(r is None for r in res[1:])
    params = params_from_numpy(chk["params"], "cpu")
    chain = make_diffusion_chain(chk["cfg"], **chk["chain_kw"])
    got = res[0]
    for i, (batch, seed) in enumerate(zip(chk["batches"], chk["seeds"])):
        bits, solved, _ = chain(params, batch,
                                torch.Generator().manual_seed(seed))
        np.testing.assert_array_equal(got["bits"][i], bits.numpy())
        np.testing.assert_array_equal(got["solved"][i], solved.numpy())


def test_launch_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1"):
        launch(ranks.fail_on_rank, 2, "gloo", None, 1)


def test_sharded_apply_needs_a_group_for_its_halo():
    cfg = tqs.QuerySATConfig(**SMALL)
    params = tqs.query_sat_init(torch.Generator().manual_seed(0), cfg)
    _, tb = batch_pair(*random_formulas(5), **BUCKET)
    with pytest.raises(ValueError, match="process group"):
        tqs.query_sat_apply(params, cfg, tb, None, device="cpu", halo=object())
    # linear_loss trains on clause shards, but not under a halo (as in the
    # TPU package)
    with pytest.raises(NotImplementedError, match="linear_loss"):
        tqs.query_sat_apply(params, dataclasses.replace(
            cfg, supervised=False, use_linear_loss=True), tb, None,
            device="cpu", halo=object(), group=object())

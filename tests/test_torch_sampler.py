"""Port vs TPU package: the flat and dense reverse-diffusion chains and the
sampler.

The TPU package's chain draws from one key; the test replays its key
schedule (rounding uniforms, predict-mode labels, per-round noise, final
Bernoulli uniforms) and injects the same numbers into the port, which must
then produce the same final bits, solved flags and freeze steps.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    ASSETS,
    assert_batches_equal,
    batch_pair,
    DENSE_FIELDS,
    FIELDS,
    load_cnf_clauses,
    np_of,
    torch_params,
)
from diffusionsat_tpu.diffusion import sampler as jsam
from diffusionsat_tpu.models import query_sat as jqs
from diffusionsat_tpu.ops.pallas_segsum import build_batch_plans as jplans
from diffusionsat_tpu.sat.cnf import CNF as JCNF
from diffusionsat_tpu.train.checkpoint import load_params
from diffusionsat_torch import sample as tsample
from diffusionsat_torch.diffusion import sampler as tsam
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.ops.segsum import build_batch_plans as tplans
from diffusionsat_torch.sat.cnf import CNF, VariableAssignment

MLK64 = "pretrained/query_sat_3sat_diffusion_mlk64.npz"


def _replay_draws(key, N, V, rounds, final_sample):
    """The numbers the TPU package's chain draws from `key`. `V` is the
    variable shape: an int (flat) or (G, Vg) (dense)."""
    V = (V,) if isinstance(V, int) else tuple(V)
    u, labels, noise = [], [], []
    for _ in range(N):
        key, k_round, k_model = jax.random.split(key, 3)
        u.append(np.asarray(jax.random.uniform(k_round, V + (1,))))
        _, k_labels, _, key_loop = jax.random.split(k_model, 4)
        labels.append(np.asarray(jax.random.randint(
            k_labels, V, 0, 2, dtype=jnp.int32)))
        noise.append(np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(key_loop, r), V + (4,), jnp.float32))
            for r in range(rounds)]))
    draws = dict(rounding_uniforms=torch.from_numpy(np.stack(u)),
                 labels=torch.from_numpy(np.stack(labels)),
                 round_noise=torch.from_numpy(np.stack(noise)))
    if final_sample:
        _, k_fin = jax.random.split(key)
        draws["final_uniforms"] = torch.from_numpy(
            np.array(jax.random.uniform(k_fin, V)))
    return draws


def _chains_agree(jparams, cfg_kw, formulas, chain_kw, with_plans, seed,
                  bucket):
    jcfg = jqs.QuerySATConfig(**cfg_kw)
    tcfg = tqs.QuerySATConfig(**cfg_kw)
    sols = [[0] * n for n, _ in formulas]
    jb, tb = batch_pair(formulas, sols, **bucket)
    key = jax.random.key(seed)
    jp = jplans(jb, tile_edges=256, window=128) if with_plans else None
    jbits, jsolved, jfixed = jsam.make_diffusion_chain(jcfg, **chain_kw)(
        jparams, jb, key, jp)
    draws = _replay_draws(key, chain_kw["diffusion_steps"], jb.V,
                          chain_kw["test_rounds"],
                          chain_kw.get("final_sample", False))
    tbits, tsolved, tfixed = tsam.make_diffusion_chain(tcfg, **chain_kw)(
        torch_params(jparams), tb, None, tplans(tb) if with_plans else None,
        **draws)
    np.testing.assert_array_equal(np_of(tbits), np.asarray(jbits))
    np.testing.assert_array_equal(np_of(tsolved), np.asarray(jsolved))
    np.testing.assert_array_equal(np_of(tfixed), np.asarray(jfixed))
    return np_of(tbits), np_of(tsolved)


SMALL_BUCKET = dict(max_vars=64, max_clauses=384, max_edges=1024,
                    max_graphs=4)


def _dense_chains_agree(jparams, cfg_kw, formulas, chain_kw, seed):
    """Both packages' dense chains on the densified batch of `formulas`:
    equal bits, solved flags and freeze steps."""
    from diffusionsat_tpu.graph.dense_batch import (
        densify_batches_quantized as jdensify,
    )
    from diffusionsat_torch.graph.dense_batch import densify_batches_quantized

    sols = [[0] * n for n, _ in formulas]
    jb, tb = batch_pair(formulas, sols, **SMALL_BUCKET)
    (jd,), (td,) = jdensify([jb], g_quantum=4), \
        densify_batches_quantized([tb], g_quantum=4)
    assert_batches_equal(jd, td, DENSE_FIELDS)
    key = jax.random.key(seed)
    jout = jsam.make_dense_diffusion_chain(
        jqs.QuerySATConfig(**cfg_kw), **chain_kw)(jparams, jd, key)
    draws = _replay_draws(key, chain_kw["diffusion_steps"], (jd.G, jd.Vg),
                          chain_kw["test_rounds"],
                          chain_kw.get("final_sample", False))
    tout = tsam.make_dense_diffusion_chain(
        tqs.QuerySATConfig(**cfg_kw), **chain_kw)(
            torch_params(jparams), td, None, **draws)
    for got, want in zip(tout, jout):
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_array_equal(np_of(got), np.asarray(want))
    return np_of(tout[0]), np_of(tout[1])


@pytest.mark.parametrize("chain_kw", [
    dict(diffusion_steps=1, test_rounds=3),
    dict(diffusion_steps=4, test_rounds=3),
    dict(diffusion_steps=4, test_rounds=2, final_sample=True,
         temperature=0.7, freeze_from=2),
    dict(diffusion_steps=4, test_rounds=2, freeze_sat=False,
         self_supervised=True, use_baseline_sampling=False),
])
def test_small_dense_chain_bits_equal(chain_kw):
    cfg_kw = dict(feature_maps=16, query_maps=8, logit_maps=4)
    jparams = jqs.query_sat_init(jax.random.key(2), jqs.QuerySATConfig(
        **cfg_kw))
    formulas = [load_cnf_clauses(f"satlib/uf20-synth-{i}.cnf")
                for i in (1, 2)]
    _dense_chains_agree(jparams, cfg_kw, formulas, chain_kw, seed=3)


def test_mlk64_dense_chain_bits_equal():
    params, meta = load_params(MLK64)
    names = {f.name for f in dataclasses.fields(tqs.QuerySATConfig)}
    cfg_kw = {k: v for k, v in meta["config"].items() if k in names}
    formula = load_cnf_clauses("satlib/uf20-synth-1.cnf")
    _, solved = _dense_chains_agree(
        params, cfg_kw, [formula] * 3,
        dict(diffusion_steps=4, test_rounds=4), seed=0)
    assert solved[:3].sum() >= 1   # the flagship solves uf20 in 4 steps


@pytest.mark.parametrize("chain_kw,with_plans", [
    (dict(diffusion_steps=1, test_rounds=3), False),
    (dict(diffusion_steps=4, test_rounds=3), True),
    (dict(diffusion_steps=4, test_rounds=2, final_sample=True,
          temperature=0.7, freeze_from=2), False),
    (dict(diffusion_steps=4, test_rounds=2, freeze_sat=False,
          self_supervised=True, use_baseline_sampling=False), True),
])
def test_small_chain_bits_equal(chain_kw, with_plans):
    cfg_kw = dict(feature_maps=16, query_maps=8, logit_maps=4)
    jparams = jqs.query_sat_init(jax.random.key(2), jqs.QuerySATConfig(
        **cfg_kw))
    formulas = [load_cnf_clauses(f"satlib/uf20-synth-{i}.cnf")
                for i in (1, 2)]
    _chains_agree(jparams, cfg_kw, formulas, chain_kw, with_plans, seed=3,
                  bucket=SMALL_BUCKET)


def test_mlk64_chain_bits_equal():
    params, meta = load_params(MLK64)
    names = {f.name for f in dataclasses.fields(tqs.QuerySATConfig)}
    cfg_kw = {k: v for k, v in meta["config"].items() if k in names}
    formula = load_cnf_clauses("satlib/uf20-synth-1.cnf")
    bits, solved = _chains_agree(
        params, cfg_kw, [formula] * 3,
        dict(diffusion_steps=4, test_rounds=4), True, seed=0,
        bucket=SMALL_BUCKET)
    assert solved[:3].sum() >= 1   # the flagship solves uf20 in 4 steps


def _flagship_params():
    tree, meta = load_params(MLK64)
    return torch_params(tree), tqs.QuerySATConfig.from_meta(
        meta["config"], test_rounds=32)


def test_sampler_batch_and_bucket_equal_tpu_sampler():
    path = f"{ASSETS}/primes/primes_3599_61x59.cnf"
    jcfg = jqs.QuerySATConfig(feature_maps=8, query_maps=8)
    jparams = jqs.query_sat_init(jax.random.key(0), jcfg)
    js = jsam.DiffusionSampler(jparams, jcfg, JCNF.load(path), dense=False)
    ts = tsam.DiffusionSampler(
        torch_params(jparams), tqs.QuerySATConfig(feature_maps=8,
                                                  query_maps=8),
        CNF.load(path), device="cpu")
    assert ts.graphs_per_batch == js.graphs_per_batch == 15
    assert dataclasses.astuple(ts.bucket) == (
        js.bucket.max_vars, js.bucket.max_clauses, js.bucket.max_edges,
        js.bucket.max_graphs) == (2048, 7552, 20992, 15)
    assert_batches_equal(js.batch, ts.batch)
    assert ts.plans.lit_to_clause.num_segments == 7552


def test_sampler_counts_only_satisfying_samples():
    cnf = CNF(n_vars=4, clauses=[[1, 2], [-1, 3], [2, 4], [-3, -4, 1]])
    cfg = tqs.QuerySATConfig(feature_maps=8, query_maps=8, test_rounds=2)
    params = tqs.query_sat_init(torch.Generator().manual_seed(1), cfg)
    sampler = tsam.DiffusionSampler(params, cfg, cnf, diffusion_steps=3,
                                    test_rounds=2, graphs_per_batch=6,
                                    seed=2, dense=False, device="cpu")
    counts = sampler.samples(4, max_batches=3)
    assert 0.0 <= sampler.success_rate <= 1.0
    for sol in counts:
        asgn = VariableAssignment(4, cnf.clauses())
        asgn.assign_all_from_int(sol)
        assert asgn.satisfiable()
    # the default picks the layout as the TPU package does: a formula this
    # small runs on the dense chain, with the same check of every sample
    dense = tsam.DiffusionSampler(params, cfg, cnf, diffusion_steps=3,
                                  test_rounds=2, graphs_per_batch=6, seed=2,
                                  device="cpu")
    assert dense.dense and dense.plans is None
    for sol in dense.samples(4, max_batches=3):
        asgn = VariableAssignment(4, cnf.clauses())
        asgn.assign_all_from_int(sol)
        assert asgn.satisfiable()


def _chain_cnf(n_vars, n_clauses):
    """A satisfiable formula of the given size (implication chains)."""
    clauses = [[-(i % (n_vars - 1) + 1), i % (n_vars - 1) + 2]
               for i in range(n_clauses)]
    return n_vars, clauses


@pytest.mark.parametrize("n_vars,n_clauses,want_dense", [
    (128, 576, True), (129, 576, False), (128, 577, False), (20, 91, True)])
def test_auto_layout_choice_equals_tpu_sampler(n_vars, n_clauses,
                                               want_dense):
    from diffusionsat_tpu.graph.dense_batch import DenseSatBatch as JDense
    from diffusionsat_torch.graph.dense_batch import DenseSatBatch

    n, clauses = _chain_cnf(n_vars, n_clauses)
    jcfg = jqs.QuerySATConfig(feature_maps=8, query_maps=8)
    jparams = jqs.query_sat_init(jax.random.key(0), jcfg)
    kw = dict(graphs_per_batch=None if want_dense and n_vars == 20 else 3)
    js = jsam.DiffusionSampler(jparams, jcfg, JCNF(n_vars=n, clauses=clauses),
                               **kw)
    ts = tsam.DiffusionSampler(
        torch_params(jparams), tqs.QuerySATConfig(feature_maps=8,
                                                  query_maps=8),
        CNF(n_vars=n, clauses=clauses), device="cpu", **kw)
    assert ts.dense == js.dense == want_dense
    assert ts.graphs_per_batch == js.graphs_per_batch
    assert isinstance(ts.batch, DenseSatBatch) == isinstance(js.batch, JDense)
    assert_batches_equal(js.batch, ts.batch,
                         DENSE_FIELDS if want_dense else FIELDS)
    if want_dense and n_vars == 20:
        assert ts.graphs_per_batch == 256 and ts.batch.G == 256


def test_freeze_regimes_set_fixed_steps():
    # tautologies: every assignment satisfies, so freezing fires at the
    # first permitted step
    cnf = CNF(n_vars=3, clauses=[[1, -1], [2, -2], [3, -3]])
    cfg = tqs.QuerySATConfig(feature_maps=8, query_maps=8, test_rounds=2)
    params = tqs.query_sat_init(torch.Generator().manual_seed(0), cfg)
    fixed = {}
    for name, kw in (("early", {}), ("late", {"freeze_from": 4}),
                     ("off", {"freeze_sat": False})):
        s = tsam.DiffusionSampler(params, cfg, cnf, diffusion_steps=6,
                                  test_rounds=2, graphs_per_batch=4,
                                  dense=False, device="cpu", **kw)
        _, _, fixed[name] = s.chain(s.params, s.batch, s.generator, s.plans)
    nv = 12
    assert torch.all(fixed["early"][:nv] == 0)
    assert torch.all(fixed["late"][:nv] == 4)
    assert torch.all(fixed["off"] == -1)


def test_flagship_sampler_on_uf20():
    _flagship_samples_satisfy(dense=False)


def test_flagship_dense_sampler_on_uf20():
    _flagship_samples_satisfy(dense=None)


def _flagship_samples_satisfy(dense):
    params, cfg = _flagship_params()
    cnf = CNF.load(f"{ASSETS}/satlib/uf20-synth-1.cnf")
    sampler = tsam.DiffusionSampler(params, cfg, cnf, diffusion_steps=4,
                                    test_rounds=4, graphs_per_batch=8,
                                    dense=dense, device="cpu")
    assert sampler.dense == (dense is None)
    counts = sampler.samples(8, max_batches=1)
    assert sum(counts.values()) >= 1
    for sol in counts:
        asgn = VariableAssignment(20, cnf.clauses())
        asgn.assign_all_from_int(sol)
        assert asgn.satisfiable()


def test_cli_samples_on_cpu(tmp_path, capsys):
    out = tmp_path / "counts.json"
    tsample.main(["--dimacs", f"{ASSETS}/satlib/uf20-synth-2.cnf",
                  "--model_ckpt", MLK64, "--n_samples", "5",
                  "--diffusion_steps", "2", "--test_rounds", "2",
                  "--device", "cpu", "--out", str(out)])
    printed = capsys.readouterr().out
    assert "success rate" in printed and "dense reverse chain" in printed
    counts = json.loads(out.read_text())
    cnf = CNF.load(f"{ASSETS}/satlib/uf20-synth-2.cnf")
    for sol in counts:
        asgn = VariableAssignment(20, cnf.clauses())
        asgn.assign_all_from_int(int(sol))
        assert asgn.satisfiable()
    # Metropolis refinement: the same number of samples, each still a model
    refined = tmp_path / "refined.json"
    tsample.main(["--dimacs", f"{ASSETS}/satlib/uf20-synth-2.cnf",
                  "--model_ckpt", MLK64, "--n_samples", "5",
                  "--diffusion_steps", "2", "--test_rounds", "2",
                  "--refine", "mh", "--mh_steps", "50", "--device", "cpu",
                  "--out", str(refined)])
    after = json.loads(refined.read_text())
    assert sum(after.values()) == sum(counts.values())
    for sol in after:
        asgn = VariableAssignment(20, cnf.clauses())
        asgn.assign_all_from_int(int(sol))
        assert asgn.satisfiable()

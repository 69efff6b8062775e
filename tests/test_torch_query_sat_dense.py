"""Port vs TPU package: QuerySAT on dense blocks (`query_sat_dense_apply`).

Every draw is pinned: labels, noise scale and noisy input are injected, and
the per-round noise is zeroed (`debug_zero_noise`) or replayed from the TPU
package's key schedule. Logits match at rtol = atol = 1e-4 (four or more
recurrent rounds of f32 summation-order differences) and `steps` are equal.
The port's dense model is also held against its own flat model and against
the TF reference goldens.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    batch_pair,
    dense_vars_from_flat,
    flat_vars_from_dense,
    load_cnf_clauses,
    np_of,
    random_formulas,
    torch_params,
)
from diffusionsat_tpu.diffusion.schedule import construct_training_input
from diffusionsat_tpu.graph import dense_batch as jdb
from diffusionsat_tpu.models import query_sat as jqs
from diffusionsat_tpu.models.query_sat_dense import (
    query_sat_dense_apply as japply,
)
from diffusionsat_tpu.sat.solvers import solve
from diffusionsat_tpu.train.checkpoint import load_params
from diffusionsat_torch.graph import dense_batch as tdb
from diffusionsat_torch.graph.batch import BucketSpec, build_batch
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.models.query_sat_dense import (
    query_sat_dense_apply as tapply,
)
from diffusionsat_torch.ops.segsum import build_batch_plans
from diffusionsat_torch.train.checkpoint import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(feature_maps=16, query_maps=8, logit_maps=4, test_rounds=4)
MLK64 = "pretrained/query_sat_3sat_diffusion_mlk64.npz"
PARITY = Path(__file__).parent.parent / "parity"


def _cfgs(**kw):
    return jqs.QuerySATConfig(**kw), tqs.QuerySATConfig(**kw)


def _dense_pair(formulas, sols, **bucket):
    jb, tb = batch_pair(formulas, sols, **bucket)
    dims = jdb.dense_dims_for([jb])
    return (jb, tb, jdb.dense_from_flat(jb, *dims),
            tdb.dense_from_flat(tb, *dims))


def _inputs(seed, G, Vg):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, size=(G, Vg)).astype(np.int32)
    noisy = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=(G, Vg))]
    return labels, noisy


def _run_both(jparams, kw, jd, td, *, labels, noise_scale, noisy,
              early_exit, rounds=None):
    jcfg, tcfg = _cfgs(**kw)
    jout = japply(jparams, jcfg, jd, jax.random.key(0), training=False,
                  labels=jnp.asarray(labels),
                  noise_scale=jnp.float32(noise_scale),
                  noisy_num=jnp.asarray(noisy), rounds=rounds,
                  early_exit=early_exit)
    tout = tapply(torch_params(jparams), tcfg, td, None,
                  labels=torch.from_numpy(labels), noise_scale=noise_scale,
                  noisy_num=torch.from_numpy(noisy), rounds=rounds,
                  early_exit=early_exit, device="cpu")
    return jout, tout


def _assert_match(jout, tout):
    (jl, jloss, jsteps, jaux), (tl, tloss, tsteps, taux) = jout, tout
    # all heads first: the per-graph head pick can flip on a near tie
    np.testing.assert_allclose(np_of(taux["logits_all_heads"]),
                               np.asarray(jaux["logits_all_heads"]), **TOL)
    assert tuple(tl.shape) == np.shape(jl)
    np.testing.assert_allclose(np_of(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    assert int(tsteps) == int(jsteps)
    assert bool(taux["solved"]) == bool(jaux["solved"])
    for k in ("variables_state", "clause_state"):
        np.testing.assert_allclose(np_of(taux[k]), np.asarray(jaux[k]), **TOL)


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("mode", ["supervised", "mixed", "linear"])
def test_small_config_matches(mode, early_exit):
    kw = dict(SMALL, debug_zero_noise=True,
              supervised=mode == "supervised",
              use_linear_loss=mode == "linear")
    jparams = jqs.query_sat_init(jax.random.key(0), _cfgs(**kw)[0])
    _, _, jd, td = _dense_pair(*random_formulas(1, n_formulas=5))
    labels, noisy = _inputs(2, jd.G, jd.Vg)
    _assert_match(*_run_both(jparams, kw, jd, td, labels=labels,
                             noise_scale=0.37, noisy=noisy,
                             early_exit=early_exit, rounds=6))


def test_predict_mode_draws_replayed_from_tpu_key_schedule():
    """Predict mode with per-round noise: the TPU package draws noise
    scale, labels, noisy input and the per-round noise from one key; the
    port takes the same numbers injected."""
    jcfg, tcfg = _cfgs(**SMALL)
    jparams = jqs.query_sat_init(jax.random.key(1), jcfg)
    _, _, jd, td = _dense_pair(*random_formulas(6, n_formulas=3))
    key = jax.random.key(42)
    jout = japply(jparams, jcfg, jd, key, training=False)
    k_noise, k_labels, k_input, key_loop = jax.random.split(key, 4)
    ns = jax.random.uniform(k_noise, ())
    shape = (jd.G, jd.Vg)
    labels = jax.random.randint(k_labels, shape, 0, 2, dtype=jnp.int32)
    noisy = construct_training_input(k_input, labels, ns)
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key_loop, r), shape + (4,), jnp.float32))
        for r in range(jcfg.test_rounds)])
    tout = tapply(torch_params(jparams), tcfg, td, None,
                  labels=torch.from_numpy(np.array(labels)),
                  noise_scale=float(ns),
                  noisy_num=torch.from_numpy(np.array(noisy)),
                  round_noise=torch.from_numpy(noise), device="cpu")
    _assert_match(jout, tout)


@pytest.mark.parametrize("layout", ["dense", "flat"])
def test_collect_round_stats_match(layout):
    kw = dict(SMALL, debug_zero_noise=True, collect_round_stats=True)
    jcfg, tcfg = _cfgs(**kw)
    jparams = jqs.query_sat_init(jax.random.key(2), jcfg)
    jb, tb, jd, td = _dense_pair(*random_formulas(3, n_formulas=4))
    if layout == "dense":
        labels, noisy = _inputs(4, jd.G, jd.Vg)
        jout, tout = _run_both(jparams, kw, jd, td, labels=labels,
                               noise_scale=0.5, noisy=noisy,
                               early_exit=False)
    else:
        rng = np.random.default_rng(4)
        labels = rng.integers(0, 2, size=jb.V).astype(np.int32)
        noisy = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=jb.V)]
        jout = jqs.query_sat_apply(
            jparams, jcfg, jb, jax.random.key(0), training=False,
            labels=jnp.asarray(labels), noise_scale=jnp.float32(0.5),
            noisy_num=jnp.asarray(noisy))
        tout = tqs.query_sat_apply(
            torch_params(jparams), tcfg, tb, None,
            labels=torch.from_numpy(labels), noise_scale=0.5,
            noisy_num=torch.from_numpy(noisy), device="cpu")
    jstats, tstats = jout[3]["round_stats"], tout[3]["round_stats"]
    assert set(tstats) == set(jstats) and len(jstats) == 7
    for k, want in jstats.items():
        assert tuple(tstats[k].shape) == (4,)
        np.testing.assert_allclose(np_of(tstats[k]), np.asarray(want), **TOL)
    # the early-exit loop collects none, as in the TPU package
    apply, batch = (tapply, td) if layout == "dense" else \
        (tqs.query_sat_apply, tb)
    out = apply(torch_params(jparams), tcfg, batch,
                torch.Generator().manual_seed(0), early_exit=True,
                device="cpu")
    assert "round_stats" not in out[3]


@pytest.mark.parametrize("noise", ["zero", "injected"])
@pytest.mark.parametrize("supervised", [True, False])
def test_port_dense_equals_port_flat(supervised, noise):
    """The port's two layouts on the same formulas, inputs mapped through
    the per-graph variable offsets. All-head logits at rtol 1e-3 as the TPU
    package's own flat-vs-dense test allows."""
    kw = dict(SMALL, supervised=supervised, debug_zero_noise=noise == "zero")
    cfg = tqs.QuerySATConfig(**kw)
    params = tqs.query_sat_init(torch.Generator().manual_seed(3), cfg)
    _, tb, _, td = _dense_pair(*random_formulas(7, n_formulas=5))
    rng = np.random.default_rng(8)
    labels_d, noisy_d = _inputs(9, td.G, td.Vg)
    noise_d = rng.normal(size=(4, td.G, td.Vg, 4)).astype(np.float32)
    noise_f = np.stack([flat_vars_from_dense(n, tb) for n in noise_d])
    flat = tqs.query_sat_apply(
        params, cfg, tb, None,
        labels=torch.from_numpy(flat_vars_from_dense(labels_d, tb)),
        noise_scale=0.37,
        noisy_num=torch.from_numpy(flat_vars_from_dense(noisy_d, tb)),
        round_noise=torch.from_numpy(noise_f),
        plans=build_batch_plans(tb), device="cpu")
    dense = tapply(params, cfg, td, None, labels=torch.from_numpy(labels_d),
                   noise_scale=0.37, noisy_num=torch.from_numpy(noisy_d),
                   round_noise=torch.from_numpy(noise_d), device="cpu")
    mask = np_of(td.var_mask)[..., None]
    want = dense_vars_from_flat(np_of(flat[3]["logits_all_heads"]), tb, td)
    np.testing.assert_allclose(np_of(dense[3]["logits_all_heads"]) * mask,
                               want, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np_of(dense[0]) * mask,
                               dense_vars_from_flat(np_of(flat[0]), tb, td),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(dense[1]), float(flat[1]), rtol=2e-4,
                               atol=1e-5)
    assert int(dense[2]) == int(flat[2])


def _tf_golden_setup():
    g = np.load(PARITY / "tf_goldens.npz")
    formulas = []
    for line in (PARITY / "tf_goldens_formulas.txt").read_text().splitlines():
        n, cls = line.split("|", 1)
        formulas.append((int(n), ast.literal_eval(cls)))
    n_edges = sum(len(c) for _, cls in formulas for c in cls)
    flat = build_batch(formulas, BucketSpec(
        max_vars=int(g["n_vars"]), max_clauses=int(g["n_clauses"]),
        max_edges=n_edges, max_graphs=len(formulas)))
    tree = {}
    for key in g.files:
        if key.startswith("w/"):
            _, name, idx, kind = key.split("/")
            d = tree.setdefault(name, {"w": {}, "b": {}})
            d["w" if kind == "kernel" else "b"][int(idx)] = g[key]
    tree = {name: {k: [d[k][i] for i in sorted(d[k])] for k in ("w", "b")}
            for name, d in tree.items()}
    return g, flat, params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("supervised", [True, False])
@pytest.mark.parametrize("rounds", [1, 2, 4, 32])
def test_densified_tf_goldens(supervised, rounds):
    """The TF reference's recorded outputs on fixed tiny formulas, replayed
    through the port's dense model on the densified batch; the bounds are
    those of the TPU package's own golden test."""
    g, flat, params = _tf_golden_setup()
    (dense,) = tdb.densify_batches([flat])
    tag = f"{'sup' if supervised else 'unsup'}/r{rounds}"
    cfg = tqs.QuerySATConfig(feature_maps=16, query_maps=16,
                             test_rounds=rounds, supervised=supervised,
                             debug_zero_noise=True)
    labels = dense_vars_from_flat(g["labels"], flat, dense)
    noisy = dense_vars_from_flat(g["noisy_num"], flat, dense)
    out, loss, steps, aux = tapply(
        params, cfg, dense, None, labels=torch.from_numpy(labels),
        noise_scale=float(g["noise_scale"]),
        noisy_num=torch.from_numpy(noisy), device="cpu")
    np.testing.assert_allclose(flat_vars_from_dense(np_of(out), flat),
                               g[f"{tag}/out_logits"], rtol=1e-5, atol=1e-6)
    ref_loss = float(g[f"{tag}/loss"])
    assert abs(float(loss) - ref_loss) <= 1e-5 * max(abs(ref_loss), 1.0)
    assert int(steps) == int(g[f"{tag}/steps"])
    s_rtol, s_atol = (1e-4, 1e-5) if rounds <= 4 else (1e-3, 1e-4)
    np.testing.assert_allclose(
        flat_vars_from_dense(np_of(aux["variables_state"]), flat),
        g[f"{tag}/variables_state"], rtol=s_rtol, atol=s_atol)


@pytest.mark.parametrize("regime", ["hinted", "solving"])
def test_mlk64_full_width_matches(regime):
    params, meta = load_params(MLK64)
    names = {f.name for f in dataclasses.fields(tqs.QuerySATConfig)}
    kw = {k: v for k, v in meta["config"].items() if k in names}
    kw.update(debug_zero_noise=True, test_rounds=2)
    formulas, sols = [], []
    for i in (1, 2, 3):
        n, clauses = load_cnf_clauses(f"satlib/uf20-synth-{i}.cnf")
        ok, model = solve(clauses, n)
        assert ok
        formulas.append((n, clauses))
        sols.append([1 if v > 0 else 0 for v in model])
    _, _, jd, td = _dense_pair(formulas, sols, max_vars=64, max_clauses=384,
                               max_edges=1024, max_graphs=4)
    if regime == "hinted":   # a low-noise view of true solutions
        labels = np_of(td.solutions)
        noisy, ns = np.eye(2, dtype=np.float32)[labels], 0.1
    else:
        (labels, noisy), ns = _inputs(7, jd.G, jd.Vg), 1.0
    jout, tout = _run_both(params, kw, jd, td, labels=labels, noise_scale=ns,
                           noisy=noisy, early_exit=True)
    _assert_match(jout, tout)


@pytest.mark.parametrize("mode", [
    dict(training=True), dict(cfg=dict(block_bf16=True)),
    dict(cfg=dict(remat="full")),
    dict(cfg=dict(compute_dtype=torch.bfloat16)),
])
def test_training_modes_raise(mode):
    """The training modes raised before the training slice; now they run
    (their numbers are held in test_torch_train_grads.py) and only an
    unknown `remat` raises."""
    cfg = tqs.QuerySATConfig(**SMALL, **mode.pop("cfg", {}))
    params = tqs.query_sat_init(torch.Generator().manual_seed(0), cfg)
    _, _, _, td = _dense_pair(*random_formulas(0, n_formulas=2))
    if mode.get("training"):
        for leaf in jax.tree.leaves(params):
            leaf.requires_grad_(True)
    out = tapply(params, cfg, td, torch.Generator().manual_seed(1),
                 device="cpu", **mode)
    assert torch.isfinite(out[1]) and out[0].shape == (td.G, td.Vg, 1)
    assert out[1].requires_grad == bool(mode.get("training"))
    want = torch.bfloat16 if cfg.block_bf16 else torch.float32
    assert out[3]["variables_state"].dtype == want
    assert out[3]["logits_all_heads"].dtype == torch.float32
    with pytest.raises(ValueError, match="remat"):
        tapply(params, dataclasses.replace(cfg, remat="some"), td, None,
               device="cpu")


def test_predict_mode_runs_from_a_generator():
    cfg = tqs.QuerySATConfig(**SMALL)
    params = tqs.query_sat_init(torch.Generator().manual_seed(0), cfg)
    _, _, _, td = _dense_pair(*random_formulas(2, n_formulas=3))
    a, b = (tapply(params, cfg, td, torch.Generator().manual_seed(5),
                   device="cpu") for _ in range(2))
    assert a[0].shape == (td.G, td.Vg, 1) and torch.isfinite(a[0]).all()
    assert torch.equal(a[0], b[0])

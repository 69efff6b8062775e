"""Shared inputs for the port's parity tests: the same numpy-seeded
formulas and params go through the TPU package and the torch port.

Importing this module also gives the test process one torch intra-op
thread, and the processes its tests start the same (`OMP_NUM_THREADS`,
unless it is set; spawned ranks set their own share). Every test process
imports it while it collects the suite. Under six xdist workers, torch's
default of a thread per core in each of them oversubscribed an 8-core
host, and the suite ran about ten times slower than with one thread each."""

import dataclasses
import os

import numpy as np
import torch

import jax

from diffusionsat_tpu.graph.batch import BucketSpec as JBucketSpec
from diffusionsat_tpu.graph.batch import build_batch as jbuild_batch
from diffusionsat_torch.graph.batch import BucketSpec, SatBatch, build_batch
from diffusionsat_torch.graph.dense_batch import DenseSatBatch
from diffusionsat_torch.train.checkpoint import params_from_numpy

ASSETS = "diffusionsat_tpu/data/assets"
FIELDS = [f.name for f in dataclasses.fields(SatBatch)]
DENSE_FIELDS = [f.name for f in dataclasses.fields(DenseSatBatch)]

os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))


def random_formulas(seed, n_formulas=4, lo=4, hi=10, clause_ratio=3):
    rng = np.random.default_rng(seed)
    formulas, sols = [], []
    for _ in range(n_formulas):
        n = int(rng.integers(lo, hi))
        clauses = [[int(v) if rng.random() < 0.5 else -int(v)
                    for v in (rng.choice(n, size=3, replace=False) + 1)]
                   for _ in range(clause_ratio * n)]
        formulas.append((n, clauses))
        sols.append(rng.integers(0, 2, size=n).tolist())
    return formulas, sols


def batch_pair(formulas, solutions=None, max_vars=64, max_clauses=128,
               max_edges=512, max_graphs=8):
    """(TPU-package SatBatch, port SatBatch) of the same formulas."""
    kw = dict(max_vars=max_vars, max_clauses=max_clauses,
              max_edges=max_edges, max_graphs=max_graphs)
    return (jbuild_batch(formulas, JBucketSpec(**kw), solutions=solutions),
            build_batch(formulas, BucketSpec(**kw), solutions=solutions))


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def torch_params(jax_params):
    """Carry a TPU-package params tree onto CPU torch tensors."""
    return params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu")


def load_cnf_clauses(name):
    from diffusionsat_torch.sat.cnf import CNF
    cnf = CNF.load(f"{ASSETS}/{name}")
    return cnf.number_of_vars(), cnf.clauses()


def assert_batches_equal(jb, tb, fields=FIELDS):
    """Every field equal in value, dtype and shape (flat or dense batch)."""
    for name in fields:
        a, b = getattr(jb, name), getattr(tb, name)
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        assert isinstance(b, torch.Tensor), name
        a, b = np.asarray(a), np_of(b)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    dims = "G Vg Cg" if fields is DENSE_FIELDS else "V C E G"
    for d in dims.split():
        assert getattr(jb, d) == getattr(tb, d), d


def var_offsets(flat):
    """(offsets [n+1], n_vars [n]) of the real graphs of a flat batch."""
    nv = np_of(flat.n_vars_per_graph).astype(np.int64)[:int(flat.n_graphs)]
    return np.concatenate([[0], np.cumsum(nv)]), nv


def dense_vars_from_flat(x_flat, flat, dense):
    """[V, ...] -> [G, Vg, ...] on real rows (zeros elsewhere)."""
    off, nv = var_offsets(flat)
    out = np.zeros((dense.G, dense.Vg) + x_flat.shape[1:], x_flat.dtype)
    for g in range(len(nv)):
        out[g, :nv[g]] = x_flat[off[g]:off[g + 1]]
    return out


def flat_vars_from_dense(x_dense, flat):
    """[G, Vg, ...] -> [V, ...] real rows (zeros elsewhere)."""
    off, nv = var_offsets(flat)
    out = np.zeros((flat.V,) + x_dense.shape[2:], x_dense.dtype)
    for g in range(len(nv)):
        out[off[g]:off[g + 1]] = x_dense[g, :nv[g]]
    return out


# -- ANF ------------------------------------------------------------------

ANF_BUCKET = dict(max_vars=96, max_ands=160, max_clauses=96, max_edges=512,
                  max_graphs=6)


def anf_items(seed=0, n=4, min_vars=4, max_vars=12):
    """(n_vars, equations, witness) of `n` random ANF systems (the port's
    copy of the generator; the TPU package's gives the same)."""
    from diffusionsat_torch.data.anf import RandomAnfInstances
    gen = RandomAnfInstances(min_vars=min_vars, max_vars=max_vars,
                             train_size=n, seed=seed).train_generator()
    return list(gen)


def anf_batch_pair(items, **bucket):
    """(TPU-package ANFBatch, port ANFBatch) of the same systems."""
    from diffusionsat_tpu.graph import anf_batch as jab
    from diffusionsat_torch.graph import anf_batch as tab
    kw = dict(ANF_BUCKET, **bucket)
    systems = [(n, eqs) for n, eqs, _ in items]
    sols = [bits[:n] for n, _, bits in items]
    return (jab.build_anf_batch(systems, jab.ANFBucket(**kw),
                                solutions=sols),
            tab.build_anf_batch(systems, tab.ANFBucket(**kw),
                                solutions=sols))


def jax_anf_round_noise(key, rounds, V):
    """The per-round query noise the TPU package's `anf_sat_apply` draws
    from `key`, as a [rounds, V, 4] torch tensor."""
    keys = jax.random.split(key, rounds)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.normal(k, (V, 4))) for k in keys]))


# -- the other model family ------------------------------------------------

WIDTHS = dict(feature_maps=16, query_maps=8, train_rounds=3, test_rounds=4,
              rounds=3)
MODELS = ("neuro_sat", "neurocore", "simple_neurosat", "simple_neuro_sat",
          "query_sat_lit", "attention_sat")
# standardize each feature over rows that start out equal: ill-conditioned
# in f32 (tests/test_torch_models.py)
MOMENTS_MODELS = ("neurocore", "simple_neurosat", "simple_neuro_sat")


def model_configs(name, **kw):
    """(TPU-package config, port config, init, apply pairs) of `name`."""
    from diffusionsat_tpu.registry import MODEL_REGISTRY as JREG
    from diffusionsat_torch.registry import MODEL_REGISTRY as TREG

    jcls, jinit, japply = JREG.resolve(name)
    tcls, tinit, tapply = TREG.resolve(name)
    fields = {f.name for f in dataclasses.fields(jcls)}
    widths = {k: v for k, v in dict(WIDTHS, **kw).items() if k in fields}
    return jcls(**widths), tcls(**widths), (jinit, tinit), (japply, tapply)


def replay_round_noise(name, key, rounds, V):
    """The port's `round_noise` for the draws the TPU package's model makes
    from `key`: normal [V, 4] (QuerySATLit) or [2V, 4] (AttentionSAT) from
    each of `split(key, rounds)`."""
    rows = {"query_sat_lit": V, "attention_sat": 2 * V}.get(name)
    if rows is None:
        return {}
    keys = jax.random.split(key, rounds)
    return {"round_noise": torch.from_numpy(np.stack(
        [np.asarray(jax.random.normal(k, (rows, 4))) for k in keys]))}


def rounds_of(cfg, training):
    if hasattr(cfg, "rounds"):
        return cfg.rounds
    return cfg.train_rounds if training else cfg.test_rounds


# -- multi-device ---------------------------------------------------------

GRAD_TOL = 1e-5


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def leaf_names(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def round_off_leaf(names):
    """QuerySAT's and ANFSAT's last `update_gate` bias: it feeds the
    variables' PairNorm, which subtracts each graph's mean, so its true
    gradient is zero and both packages compute f32 round-off."""
    return max(n for n in names if n.startswith("['update_gate']['b']"))


def assert_grads_close(got, want, names, tol=GRAD_TOL):
    """Every gradient within `tol` of its tensor's largest entry (the
    round-off leaf within `tol` of the largest entry of all tensors)."""
    want = [np.asarray(w) for w in want]
    top = max(np.abs(w).max() for w in want)
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        scale = top if name == round_off_leaf(names) else np.abs(w).max()
        err = np.abs(np.asarray(g) - w).max()
        assert err <= tol * scale, (name, err, scale)

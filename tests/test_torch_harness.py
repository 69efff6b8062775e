"""Port vs TPU package: the evaluation harness and the noise sweep.

The same batches and the flagship's params go through both packages. The
harness draws its randomness from keys in the TPU package and from
generators in the port; here every draw of the TPU package's key schedule
(noise level, labels, noisy input, round noise) is replayed and injected
into the port's predict steps, so the sweeps, the invariance readings and
the cactus flags must agree to 1e-5. Batches transformed for the
invariance test get plans of their own edges, which sum as `index_add_`
over the new edges does (on the card: `test_torch_harness_cuda.py`).
"""

import csv
import dataclasses
import itertools
import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    assert_batches_equal,
    batch_pair,
    np_of,
    random_formulas,
    torch_params,
)
from diffusionsat_tpu.diffusion.schedule import construct_training_input
from diffusionsat_tpu.evaluation import harness as jh
from diffusionsat_tpu.evaluation import noise_sweep as jns
from diffusionsat_tpu.models import query_sat as jqs
from diffusionsat_tpu.sat.solvers import solve
from diffusionsat_tpu.train.checkpoint import load_params
from diffusionsat_torch.evaluation import harness as th
from diffusionsat_torch.evaluation import noise_sweep as tns
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.ops import segsum
from diffusionsat_torch.train import loop as tloop

TOL = dict(rtol=1e-5, atol=1e-5)
MLK64 = "pretrained/query_sat_3sat_diffusion_mlk64.npz"
ROUNDS = 3


@pytest.fixture(scope="module")
def flagship():
    tree, meta = load_params(MLK64)
    jcfg = jqs.QuerySATConfig(**dict(meta["config"], test_rounds=ROUNDS))
    tcfg = tqs.QuerySATConfig.from_meta(meta["config"], test_rounds=ROUNDS)
    return jax.tree.map(jnp.asarray, tree), torch_params(tree), jcfg, tcfg


def _solved(seed, n_formulas=5, lo=4, hi=10):
    formulas, _ = random_formulas(seed, n_formulas=n_formulas, lo=lo, hi=hi,
                                  clause_ratio=2)
    sols = []
    for n, clauses in formulas:
        ok, model = solve(clauses, n)
        assert ok
        sols.append([1 if v > 0 else 0 for v in model])
    return formulas, sols


@pytest.fixture(scope="module")
def batches():
    pairs = [batch_pair(*_solved(s)) for s in (1, 2, 3)]
    return [j for j, _ in pairs], [t for _, t in pairs]


def _replay(key, V, rounds):
    """Every draw of one `query_sat_apply` call in predict mode from
    `key`: the noise level, the labels, the noisy input, the round noise."""
    k_noise, k_labels, k_input, key_loop = jax.random.split(key, 4)
    noise_scale = jax.random.uniform(k_noise, ())
    labels = jax.random.randint(k_labels, (V,), 0, 2, dtype=jnp.int32)
    noisy = construct_training_input(k_input, labels, noise_scale)
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key_loop, r), (V, 4), jnp.float32))
        for r in range(rounds)])
    return dict(noise_scale=float(noise_scale),
                labels=torch.from_numpy(np.array(labels)),
                noisy_num=torch.from_numpy(np.array(noisy)),
                round_noise=torch.from_numpy(noise))


def _metric_key(i):
    """The key `evaluate_metrics` hands the predict step of its i-th
    batch."""
    key = jax.random.key(0)
    for _ in range(i + 1):
        key, sub = jax.random.split(key)
    return sub


def _inject(monkeypatch, key_of):
    """Replace the port's predict steps (in the loop and in the harness)
    by ones that take their draws from the TPU package's key schedule:
    `key_of(i)` is the key of the i-th call of a predict step."""
    real = tloop.make_predict_step

    def make(cfg, *args, **kw):
        calls = itertools.count()
        step = real(cfg, *args, **kw)

        def predict(params, batch, generator, plans=None):
            draws = _replay(key_of(next(calls)), batch.V, cfg.test_rounds)
            return step(params, batch, None, plans=plans, draws=[draws])
        return predict

    monkeypatch.setattr(tloop, "make_predict_step", make)
    monkeypatch.setattr(th, "make_predict_step", make)


def _close(got: dict, want: dict, skip=("elapsed",)):
    assert set(got) == set(want)
    for k in want:
        if k not in skip:
            np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


# -- host transforms -------------------------------------------------------

def test_extract_formulas_and_transforms_equal(batches):
    jbs, tbs = batches
    for i, (jb, tb) in enumerate(zip(jbs, tbs)):
        assert th.extract_formulas(tb) == jh.extract_formulas(jb)
        assert_batches_equal(jh.permute_batch_variables(jb, seed=i),
                             th.permute_batch_variables(tb, seed=i))
        assert_batches_equal(jh.invert_batch_polarity(jb),
                             th.invert_batch_polarity(tb))
    formulas, _ = _solved(1)
    assert th.extract_formulas(tbs[0]) == [(n, c) for n, c in formulas]


@pytest.mark.parametrize("transform", ["permute", "invert"])
def test_plans_follow_the_transform(batches, transform):
    """Plans built from a transformed batch sum its new edges: the planned
    sums equal `index_add_` over the transformed batch's edge lists, and
    differ from the original batch's."""
    _, tbs = batches
    b = tbs[0]
    new = th.permute_batch_variables(b, seed=3) if transform == "permute" \
        else th.invert_batch_polarity(b)
    plans = tloop.build_plans(new, pad=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2 * new.V, 6)).astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (new.C, 6)).astype(np.float32))

    def index_add(src, idx_src, idx_dst, mask, n_out):
        vals = src[idx_src.long()] * mask[:, None]
        return torch.zeros((n_out, src.shape[1])).index_add_(
            0, idx_dst.long(), vals)

    want_c = index_add(x, new.edge_lit_c, new.edge_clause_c,
                       new.edge_mask_c, new.C)
    want_l = index_add(y, new.edge_clause_l, new.edge_lit_l,
                       new.edge_mask_l, 2 * new.V)
    torch.testing.assert_close(
        segsum.gather_segsum(x, plans.lit_to_clause), want_c, **TOL)
    torch.testing.assert_close(
        segsum.gather_segsum(y, plans.clause_to_lit), want_l, **TOL)
    old = tloop.build_plans(b, pad=True)
    assert not torch.allclose(segsum.gather_segsum(x, old.lit_to_clause),
                              want_c)


# -- sweeps, invariance and cactus, draws injected -------------------------

def test_round_generalization_equal(flagship, batches, monkeypatch,
                                    tmp_path):
    jp, tp, jcfg, tcfg = flagship
    jbs, tbs = batches
    want = jh.evaluate_round_generalization(
        jp, lambda r: dataclasses.replace(jcfg, test_rounds=r), jbs,
        tmp_path / "j.txt", rounds_list=[2, 4])
    _inject(monkeypatch, _metric_key)
    got = th.evaluate_round_generalization(
        tp, lambda r: dataclasses.replace(tcfg, test_rounds=r), tbs,
        tmp_path / "t.txt", rounds_list=[2, 4], device="cpu")
    assert list(got) == list(want) == [2, 4]
    for r in want:
        _close(got[r], want[r])
    assert sum(want[r]["total_accuracy"] for r in want) > 0
    lines = (tmp_path / "t.txt").read_text().splitlines()
    assert [ln.split(":")[0] for ln in lines] == \
        [ln.split(":")[0] for ln in (tmp_path / "j.txt").read_text()
         .splitlines()] == ["test_rounds=2", "test_rounds=4"]


def test_variable_generalization_equal(flagship, monkeypatch, tmp_path):
    from diffusionsat_tpu.data import datasets as jds
    from diffusionsat_tpu.data import generators as jgen
    from diffusionsat_tpu.graph.batch import BucketSpec as JBucketSpec
    from diffusionsat_torch.data import datasets as tds
    from diffusionsat_torch.data import generators as tgen
    from diffusionsat_torch.graph.batch import BucketSpec

    jp, tp, jcfg, tcfg = flagship

    def maker(gen, ds, bucket, root):
        def make(min_v, max_v, n):
            inst = gen.DiffusionSatInstances(gen.SAT3Instances(
                min_vars=min_v, max_vars=max_v, train_size=1, test_size=n,
                seed=0), use_unigen=False, seed=0)
            extra = {"gen_workers": 1} if ds is jds else {"gen_shards": 1}
            return ds.SatDataset(inst, bucket.for_node_budget(1000),
                                 cache_dir=tmp_path / root,
                                 name=f"vargen_{min_v}", **extra).test_data()
        return make

    kw = dict(lower=5, upper=9, step=3, test_size=4)
    want = jh.evaluate_variable_generalization(
        jp, jcfg, maker(jgen, jds, JBucketSpec, "j"), tmp_path / "j.txt",
        **kw)
    _inject(monkeypatch, _metric_key)
    got = th.evaluate_variable_generalization(
        tp, tcfg, maker(tgen, tds, BucketSpec, "t"), tmp_path / "t.txt",
        device="cpu", **kw)
    assert list(got) == list(want) == [5, 8]
    for v in want:
        _close(got[v], want[v])


def test_invariance_equal(flagship, batches, monkeypatch):
    jp, tp, jcfg, tcfg = flagship
    jbs, tbs = batches
    want = jh.test_invariance(jp, jcfg, jbs, steps=3)
    # batch i's three runs each draw from key(i)
    _inject(monkeypatch, lambda i: jax.random.key(i // 3))
    got = th.test_invariance(tp, tcfg, tbs, steps=3, device="cpu")
    _close(got, want)
    assert set(got) == {"original", "permuted", "inverted"}


def test_cactus_equal_but_for_time(flagship, batches, monkeypatch, tmp_path):
    jp, tp, jcfg, tcfg = flagship
    jbs, tbs = batches
    want = jh.make_cactus(jp, jcfg, jbs, tmp_path / "j.csv", warmup_steps=1)
    _inject(monkeypatch, jax.random.key)
    got = th.make_cactus(tp, tcfg, tbs, tmp_path / "t.csv", warmup_steps=1,
                         device="cpu")
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert len(got) == sum(int(b.n_graphs) for b in tbs[1:])
    with open(tmp_path / "t.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["var_count", "solved", "time"]
    assert [r[:2] for r in rows[1:]] == [[str(a), str(b)] for a, b, _ in want]


def test_batch_generalization_and_classic_solver_run(flagship, tmp_path):
    _, tp, _, tcfg = flagship
    from diffusionsat_torch.graph.batch import BucketSpec, build_batch

    formulas, sols = _solved(4)

    def make(budget):
        return [build_batch(formulas, BucketSpec.for_node_budget(budget),
                            solutions=sols)]

    out = th.evaluate_batch_generalization(
        tp, tcfg, make, tmp_path / "b.txt", sizes=[600, 900], device="cpu")
    assert list(out) == [600, 900] and all(t > 0 for t in out.values())
    lines = (tmp_path / "b.txt").read_text().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "max_nodes_per_batch=600", "max_nodes_per_batch=900"]
    assert all("warm" in ln for ln in lines)
    t = th.evaluate_classic_solver(iter([make(600)[0]] * 3), steps=2)
    assert t > 0.0


# -- the noise sweep ----------------------------------------------------------

def test_noise_sweep_equal(flagship, batches, monkeypatch, tmp_path):
    jp, tp, jcfg, tcfg = flagship
    jbs, tbs = batches
    want = jns.noise_sweep(jp, jcfg, jbs, steps=4,
                           out_prefix=tmp_path / "j", key=jax.random.key(5))
    keys = []
    key = jax.random.key(5)
    for _ in range(4):
        key, sub = jax.random.split(key)
        keys.append(sub)
    real = tns.query_sat_apply
    calls = itertools.count()

    def apply(params, cfg, batch, generator, **kw):
        _, _, k_input, key_loop = jax.random.split(keys[next(calls)], 4)
        noisy = construct_training_input(
            k_input, jnp.asarray(np_of(kw["labels"])),
            jnp.float32(kw["noise_scale"]))
        noise = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(key_loop, r), (batch.V, 4), jnp.float32))
            for r in range(cfg.test_rounds)])
        return real(params, cfg, batch, generator,
                    noisy_num=torch.from_numpy(np.array(noisy)),
                    round_noise=torch.from_numpy(noise), **kw)

    monkeypatch.setattr(tns, "query_sat_apply", apply)
    got = tns.noise_sweep(tp, tcfg, tbs, steps=4, out_prefix=tmp_path / "t",
                          device="cpu")
    assert got["noise"] == want["noise"] == [0.0, 0.25, 0.5, 0.75]
    for k in ("loss", "accuracy", "total_accuracy"):
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    assert (tmp_path / "t_noise_sweep.json").exists()


def test_noise_sweep_plots_only_when_matplotlib_imports(flagship, batches,
                                                       monkeypatch, tmp_path):
    _, tp, _, tcfg = flagship
    _, tbs = batches
    cfg = dataclasses.replace(tcfg, test_rounds=1)
    tns.noise_sweep(tp, cfg, tbs, steps=2, out_prefix=tmp_path / "a",
                    device="cpu")
    assert (tmp_path / "a_noise_sweep.png").exists()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    curve = tns.noise_sweep(tp, cfg, tbs, steps=2,
                            out_prefix=tmp_path / "b", device="cpu")
    with open(tmp_path / "b_noise_sweep.json") as f:
        assert json.load(f) == curve
    assert not (tmp_path / "b_noise_sweep.png").exists()


def test_count_histogram_cross_entropy_equal():
    rng = np.random.default_rng(0)
    for _ in range(5):
        a = {f"s{i}": int(v) for i, v in enumerate(rng.integers(0, 9, 12))}
        b = {f"s{i}": int(v) for i, v in enumerate(rng.integers(0, 9, 7))}
        assert tns.count_histogram_cross_entropy(a, b) == pytest.approx(
            jns.count_histogram_cross_entropy(a, b), rel=1e-12)

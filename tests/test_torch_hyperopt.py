"""Port vs TPU package: the TPE sampler and the hyperparameter search.

Suggestions of both samplers equal the TPU package's for the same seed and
observations, `--resume_from` replays a study equally, and one tiny trial
gives the TPU package's losses and score: every draw of its key schedule
(per train step the noise level, the noisy input and the round noise; per
eval batch also the labels) is replayed and injected into the port's
apply, to f32 round-off (losses rtol 1e-4, the score exactly).
"""

import itertools
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hyperopt as jhyperopt
from _torch_parity import assert_batches_equal, torch_params
from diffusionsat_tpu.data.datasets import SatDataset as JSatDataset
from diffusionsat_tpu.data.generators import (
    DiffusionSatInstances as JDiffusionSatInstances,
)
from diffusionsat_tpu.data.generators import SAT3Instances as JSAT3Instances
from diffusionsat_tpu.diffusion.schedule import construct_training_input
from diffusionsat_tpu.graph.batch import BucketSpec as JBucketSpec
from diffusionsat_tpu.models import query_sat as jqs
from diffusionsat_tpu.train import tpe as jtpe
from diffusionsat_torch import hyperopt as thyperopt
from diffusionsat_torch.data.datasets import SatDataset
from diffusionsat_torch.data.generators import (
    DiffusionSatInstances,
    SAT3Instances,
)
from diffusionsat_torch.graph.batch import BucketSpec
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.ops import segsum
from diffusionsat_torch.train import tpe as ttpe

SPACE_ARGS = {
    "lr": ("LogUniform", (1e-5, 1e-1)),
    "beta": ("Uniform", (0.0, 1.0)),
    "layers": ("IntUniform", (1, 6)),
    "width": ("Choice", ([16, 32, 64, 128],)),
}


def _space(mod):
    return {k: getattr(mod, cls)(*args) for k, (cls, args) in
            SPACE_ARGS.items()}


def _objective(hp):
    v = -((math.log10(hp["lr"]) + 3.0) ** 2)
    v -= 4.0 * (hp["beta"] - 0.7) ** 2
    v -= 0.3 * (hp["layers"] - 3) ** 2
    return v - {16: 0.6, 32: 0.2, 64: 0.0, 128: 0.4}[hp["width"]]


@pytest.mark.parametrize("sampler", ["TPESampler", "RandomSampler"])
@pytest.mark.parametrize("seed", [0, 3])
def test_suggestions_equal(sampler, seed):
    kw = {"n_startup": 5} if sampler == "TPESampler" else {}
    j = getattr(jtpe, sampler)(_space(jtpe), seed=seed, **kw)
    t = getattr(ttpe, sampler)(_space(ttpe), seed=seed, **kw)
    for _ in range(30):
        hj, ht = j.suggest(), t.suggest()
        assert ht == hj
        assert [type(v) for v in ht.values()] == \
            [type(v) for v in hj.values()]
        j.observe(hj, _objective(hj))
        t.observe(ht, _objective(ht))
    assert t.best == j.best


def test_hyperopt_space_equals_the_tpu_packages():
    assert thyperopt.SPACE.keys() == jhyperopt.SPACE.keys()
    for k, dim in thyperopt.SPACE.items():
        assert type(dim).__name__ == type(jhyperopt.SPACE[k]).__name__
        assert vars(dim) == vars(jhyperopt.SPACE[k])


def _study(n, seed=5):
    """n finished trials' records, as the script writes them."""
    s = ttpe.RandomSampler(thyperopt.SPACE, seed=seed)
    rng = np.random.default_rng(seed)
    return [{"trial": i, "accuracy": float(rng.random()), **s.suggest()}
            for i in range(n)]


@pytest.mark.parametrize("sampler", ["tpe", "random"])
def test_resume_replays_equally(sampler, tmp_path, monkeypatch, capsys):
    """Both scripts resume 10 trials of a file and take 3 more: the new
    trials' records (scored by one fake objective) and the best equal."""
    prior = tmp_path / "prior.jsonl"
    prior.write_text("".join(json.dumps(r) + "\n" for r in _study(10)))

    def fake(hp, dataset, steps, seed, **kw):
        return round(1 / (1 + abs(math.log10(hp["learning_rate"]) + 3.3) +
                          abs(hp["beta_1"] - 0.7)), 6) + seed * 1e-4

    monkeypatch.setattr(jhyperopt, "run_trial", fake)
    monkeypatch.setattr(thyperopt, "run_trial", fake)
    outs = {}
    for name, mod, extra in (("jax", jhyperopt, []),
                             ("torch", thyperopt, ["--device", "cpu"])):
        out = tmp_path / f"{name}.jsonl"
        mod.main(["--trials", "13", "--sampler", sampler, "--resume_from",
                  str(prior), "--out", str(out), "--seed", "2"] + extra)
        outs[name] = (out.read_text(), capsys.readouterr().out)
    assert outs["torch"] == outs["jax"]
    recs = [json.loads(ln) for ln in outs["torch"][0].splitlines()]
    assert [r["trial"] for r in recs] == [10, 11, 12]
    assert "resumed 10 completed trials" in outs["torch"][1]


# -- one tiny trial, the key schedule replayed ---------------------------

HP = {"learning_rate": 3e-3, "beta_1": 0.8, "variables_update_layers": 2,
      "output_layers": 2, "query_layers": 2, "clauses_update_layers": 2,
      "feature_maps": 16, "query_maps": 16, "update_scale": 1.8,
      "output_scale": 1.0, "clauses_scale": 1.6, "query_scale": 1.2}
STEPS = 3
DATA = dict(min_vars=3, max_vars=8, train_size=24, test_size=12, seed=4)
BUDGET = 300


def _datasets(tmp_path):
    """The same tiny split in both packages, generated in one stream."""
    jds = JSatDataset(
        JDiffusionSatInstances(JSAT3Instances(**DATA), use_unigen=True,
                               seed=4),
        JBucketSpec.for_node_budget(BUDGET), cache_dir=tmp_path / "j",
        name="hyperopt_3_8", gen_workers=1)
    tds = SatDataset(
        DiffusionSatInstances(SAT3Instances(**DATA), use_unigen=True,
                              seed=4),
        BucketSpec.for_node_budget(BUDGET), cache_dir=tmp_path / "t",
        name="hyperopt_3_8", gen_shards=1, gen_workers=1)
    for split in ("train_data", "test_data"):
        jb, tb = getattr(jds, split)(), getattr(tds, split)()
        assert len(jb) == len(tb) > 1
        for a, b in zip(jb, tb):
            assert_batches_equal(a, b)
    return jds, tds


def _train_draws(key, batch, rounds):
    k_noise, _, k_input, key_loop = jax.random.split(key, 4)
    ns = jax.random.uniform(k_noise, ())
    labels = jnp.asarray(batch.solutions.numpy())
    noisy = construct_training_input(k_input, labels, ns)
    return dict(noise_scale=float(ns),
                noisy_num=torch.from_numpy(np.array(noisy)),
                round_noise=_round_noise(key_loop, batch.V, rounds))


def _round_noise(key_loop, V, rounds):
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key_loop, r), (V, 4), jnp.float32))
        for r in range(rounds)]))


def _eval_draws(key, batch, rounds):
    k_noise, k_labels, k_input, key_loop = jax.random.split(key, 4)
    ns = jax.random.uniform(k_noise, ())
    labels = jax.random.randint(k_labels, (batch.V,), 0, 2, dtype=jnp.int32)
    noisy = construct_training_input(k_input, labels, ns)
    return dict(noise_scale=float(ns),
                labels=torch.from_numpy(np.array(labels)),
                noisy_num=torch.from_numpy(np.array(noisy)),
                round_noise=_round_noise(key_loop, batch.V, rounds))


def test_one_trial_equals_the_tpu_packages(tmp_path, monkeypatch):
    jds, tds = _datasets(tmp_path)

    # the TPU package's trial, its losses recorded
    jlosses = []
    real_step = jhyperopt.make_train_step

    def recording(cfg, opt):
        step = real_step(cfg, opt)

        def run(state, batch):
            state, out = step(state, batch)
            jlosses.append(float(out["loss"]))
            return state, out
        return run

    monkeypatch.setattr(jhyperopt, "make_train_step", recording)
    # the eval's metric, recording its per-variable accuracy too
    seen = {}
    for name, mod in (("jax", jhyperopt), ("torch", thyperopt)):
        class Recording(mod.SATAccuracy):
            def get_values(self, reset_state=True, name=name):
                seen[name] = super().get_values(reset_state)
                return seen[name]
        monkeypatch.setattr(mod, "SATAccuracy", Recording)
    want = jhyperopt.run_trial(HP, jds, STEPS, seed=1)

    # the port's, every draw taken from the TPU package's key schedule
    train_keys, eval_keys = [], []
    key = jax.random.key(2)          # the trial's state key: seed + 1
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        train_keys.append(sub)
    key = jax.random.key(2)          # the eval's key
    for _ in range(thyperopt.EVAL_BATCHES):
        key, sub = jax.random.split(key)
        eval_keys.append(sub)
    calls = {True: itertools.count(), False: itertools.count()}

    def apply(params, cfg, batch, generator=None, training=False,
              labels=None, plans=None, device="cuda", **kw):
        i = next(calls[training])
        draws = _train_draws(train_keys[i], batch, cfg.train_rounds) \
            if training else _eval_draws(eval_keys[i], batch,
                                         cfg.test_rounds)
        if training:
            assert torch.equal(labels, batch.solutions)
        else:
            assert labels is None
        return tqs.query_sat_apply(params, cfg, batch, generator, training,
                                   plans=plans, device=device,
                                   **{"labels": labels, **kw, **draws})

    def init(generator, cfg):
        # the TPU package's init of the trial's seed, carried over
        jcfg = jqs.QuerySATConfig(**{f: getattr(cfg, f) for f in (
            "feature_maps", "query_maps", "update_layers", "output_layers",
            "query_layers", "clauses_layers", "update_scale", "output_scale",
            "clauses_scale", "query_scale")})
        assert generator.initial_seed() == 1
        return torch_params(jqs.query_sat_init(jax.random.key(1), jcfg))

    monkeypatch.setattr(thyperopt, "query_sat_apply", apply)
    monkeypatch.setattr(thyperopt, "query_sat_init", init)
    train, test = thyperopt.plan_dataset(tds, "cpu")
    cfg, state, losses = thyperopt.train_trial(HP, train, STEPS, seed=1,
                                               device="cpu")
    got = thyperopt.score_trial(state.params, cfg, test, "cpu")
    np.testing.assert_allclose([float(x) for x in losses], jlosses,
                               rtol=1e-4)
    # untrained, the tiny model solves no formula: the per-variable
    # accuracy of the same eval shows the predictions agree
    assert got == want == seen["torch"]["total_accuracy"]
    np.testing.assert_allclose(seen["torch"]["accuracy"],
                               seen["jax"]["accuracy"], rtol=1e-6)
    assert 0.3 < seen["torch"]["accuracy"] < 0.9
    assert next(calls[True]) == STEPS
    assert next(calls[False]) == min(thyperopt.EVAL_BATCHES, len(test))
    # the same trial through `run_trial`, its data planned inside
    calls = {True: itertools.count(), False: itertools.count()}
    assert thyperopt.run_trial(HP, tds, STEPS, seed=1, device="cpu") == want


def test_trial_runs_every_sum_on_the_planned_pair(tmp_path, monkeypatch):
    """Each trial's literal-clause sums go through the kernel's wrapper:
    4 calls a round each way in a train step and 2 in an eval round, as
    `chip_smoke.hyperopt_launches` reckons (on the CPU the wrapper runs
    the plain version; the calls are counted here)."""
    from chip_smoke import hyperopt_launches

    _, tds = _datasets(tmp_path)
    calls = {}
    real = segsum.gather_segsum

    def counting(x, plan):
        calls[plan.name] = calls.get(plan.name, 0) + 1
        return real(x, plan)

    monkeypatch.setattr(segsum, "gather_segsum", counting)
    train, test = thyperopt.plan_dataset(tds, "cpu")
    cfg, state, _ = thyperopt.train_trial(HP, train, 2, seed=0,
                                          device="cpu")
    assert calls == hyperopt_launches(cfg, 2, 0)
    calls.clear()
    thyperopt.score_trial(state.params, cfg, test, "cpu")
    n_eval = min(thyperopt.EVAL_BATCHES, len(test))
    assert calls == hyperopt_launches(cfg, 0, n_eval)

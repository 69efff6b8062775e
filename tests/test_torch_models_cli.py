"""`python -m diffusionsat_torch.main --model <name>` on the CPU for every
model of the other family, and the harness modes that fail with them in
the TPU package failing the same way in the port.

`main` trains the model it names and evaluates it with its own apply
(`--evaluate`). The harness modes (`--test_invariance`, `--make_cactus`
and the three generalization sweeps) run QuerySAT's apply with the
model's config and params in the TPU package, and fail there with an
`AttributeError` (the config lacks a field QuerySAT reads); so do the
port's. `--test_classic_solver` runs no model and works with any.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from _torch_parity import batch_pair, random_formulas
from diffusionsat_tpu.evaluation import harness as jharness
from diffusionsat_tpu.registry import MODEL_REGISTRY as JREG
from diffusionsat_torch import main as tmain
from diffusionsat_torch.evaluation import harness as tharness
from diffusionsat_torch.registry import MODEL_REGISTRY as TREG

TINY = ["--device", "cpu", "--train_size", "40", "--test_size", "12",
        "--min_vars", "4", "--max_vars", "10", "--train_rounds", "2",
        "--test_rounds", "2", "--feature_maps", "16", "--query_maps", "8",
        "--eval_every", "2", "--ckpt_every", "2", "--gen_workers", "1",
        "--max_nodes_per_batch", "300"]
NAMES = ("neuro_sat", "neurocore", "simple_neurosat", "simple_neuro_sat",
         "query_sat_lit", "attention_sat")
FAILING_MODES = ("test_invariance", "make_cactus", "evaluate_round_gen",
                 "evaluate_batch_gen", "evaluate_variable_gen")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("dc")


@pytest.mark.parametrize("name", NAMES)
def test_main_trains_and_evaluates_the_model(name, data_dir, tmp_path,
                                             capsys):
    """Two steps, `--evaluate` and `--test_classic_solver`, then a restore
    from the checkpoint that takes one more step: the params tree (LSTM
    cells, 0-d scales, the attention's MLPs) survives the round trip."""
    argv = TINY + ["--model", name, "--data_dir", str(data_dir),
                   "--train_dir", str(tmp_path / "runs")]
    res = tmain.main(argv + ["--train_steps", "2", "--evaluate",
                             "--test_classic_solver"])
    run_dir = Path(res["run_dir"])
    assert run_dir.name.startswith(f"{name}_3-sat_")
    assert res["state"].step == 2
    assert 0.0 <= res["evaluate"]["total_accuracy"] <= 1.0
    assert res["evaluate"]["mean_steps"] >= 1
    assert res["test_classic_solver"] > 0
    log = [json.loads(x) for x in
           (run_dir / "train_log.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in log if "loss" in r]
    assert losses and np.isfinite(losses).all()
    assert "[evaluate]" in capsys.readouterr().out

    cfg_cls, init, _ = TREG.resolve(name)
    fresh = init(torch.Generator().manual_seed(0), _config(cfg_cls))
    assert _shapes(res["state"].params) == _shapes(fresh)
    res2 = tmain.main(argv + ["--train_steps", "3", "--restore",
                              str(run_dir / "ckpt")])
    assert res2["state"].step == 3
    assert _shapes(res2["state"].params) == _shapes(fresh)


def _config(cfg_cls):
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    return cfg_cls(**{k: v for k, v in dict(
        feature_maps=16, query_maps=8, train_rounds=2, test_rounds=2
    ).items() if k in fields})


def _shapes(tree):
    from diffusionsat_torch.train.checkpoint import _flatten_params
    return {k: v.shape for k, v in _flatten_params(tree).items()}


@pytest.mark.parametrize("name", NAMES)
def test_main_harness_mode_fails_as_in_the_tpu_package(name, data_dir,
                                                       tmp_path):
    with pytest.raises(AttributeError, match="has no attribute"):
        tmain.main(TINY + ["--model", name, "--train_steps", "0",
                           "--test_invariance", "--data_dir", str(data_dir),
                           "--train_dir", str(tmp_path / "runs")])


@pytest.fixture(scope="module")
def batches():
    return batch_pair(*random_formulas(7, n_formulas=3))


def _modes(harness, params, cfg, batch, out, **dev):
    fields = {f.name for f in dataclasses.fields(cfg)}

    def for_rounds(r):
        return dataclasses.replace(cfg, test_rounds=r) \
            if "test_rounds" in fields else cfg

    return {
        "test_invariance": lambda: harness.test_invariance(
            params, cfg, [batch], steps=1, **dev),
        "make_cactus": lambda: harness.make_cactus(
            params, cfg, [batch], out / "c.csv", warmup_steps=0, **dev),
        "evaluate_round_gen": lambda: harness.evaluate_round_generalization(
            params, for_rounds, [batch], out / "r.txt", rounds_list=[2],
            **dev),
        "evaluate_batch_gen": lambda: harness.evaluate_batch_generalization(
            params, cfg, lambda b: [batch], out / "b.txt", sizes=[300],
            **dev),
        "evaluate_variable_gen":
            lambda: harness.evaluate_variable_generalization(
                params, cfg, lambda lo, hi, n: [batch], out / "v.txt",
                lower=10, upper=20, step=10, **dev),
    }


@pytest.mark.parametrize("mode", FAILING_MODES)
@pytest.mark.parametrize("name", NAMES)
def test_harness_mode_fails_in_both_packages(name, mode, batches, tmp_path):
    """Each harness mode with each model: an AttributeError in the TPU
    package and in the port (a fault of the reference, kept)."""
    jb, tb = batches
    jcls, jinit, _ = JREG.resolve(name)
    tcls, tinit, _ = TREG.resolve(name)
    jcfg, tcfg = _config(jcls), _config(tcls)
    jparams = jinit(jax.random.key(0), jcfg)
    tparams = tinit(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(AttributeError, match="has no attribute"):
        _modes(jharness, jparams, jcfg, jb, tmp_path)[mode]()
    with pytest.raises(AttributeError, match="has no attribute"):
        _modes(tharness, tparams, tcfg, tb, tmp_path, device="cpu")[mode]()

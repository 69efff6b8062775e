"""The ANF entry points on the CPU, at a tiny size: `python -m
diffusionsat_torch.anf_training` (both layouts: the loss falls, a restore
continues the run, the exported params load in either package) and `python
-m diffusionsat_torch.anf_eval` with every option (the same output keys as
the TPU package's script on the same split and params, and the same
per-variable accuracy: the split and the params are identical, only the
query noise is drawn from another generator)."""

import argparse
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from diffusionsat_torch import anf_eval, anf_training
from diffusionsat_torch.models.anf_sat import (
    ANFSATConfig,
    anf_sat_apply,
    anf_sat_init,
)
from diffusionsat_torch.train.checkpoint import restore_model_params

DATA = ["--rounds", "3", "--min_free_bits", "4", "--max_free_bits", "8",
        "--max_vars", "256", "--max_ands", "256", "--max_clauses", "256",
        "--max_edges", "1024", "--max_graphs", "4"]
TINY = DATA + ["--train_size", "12", "--test_size", "8", "--feature_maps",
               "16", "--train_rounds", "2", "--test_rounds", "2",
               "--device", "cpu"]


def _loss_on(params, batch, cfg):
    noise = torch.from_numpy(np.random.default_rng(0).normal(
        size=(cfg.train_rounds, batch.V, 4)).astype(np.float32))
    return float(anf_sat_apply(params, cfg, batch, training=False,
                               labels=batch.solutions, rounds=2,
                               round_noise=noise, device="cpu")[1])


@pytest.mark.parametrize("tiled", ["1", "0"])
def test_training_script_learns_restores_and_exports(tiled, tmp_path,
                                                     monkeypatch):
    from diffusionsat_tpu.models import anf_sat as jmodel
    from diffusionsat_tpu.train.checkpoint import (
        restore_model_params as jrestore,
    )

    monkeypatch.setenv("DSAT_ANF_TILED", tiled)
    argv = TINY + ["--data_dir", str(tmp_path / "dc"), "--train_dir",
                   str(tmp_path / "runs"), "--eval_every", "12", "--lr",
                   "1e-2"]
    final = anf_training.main(argv + ["--train_steps", "24"])
    run_dir = tmp_path / "runs" / final.pop("run_dir").split("/")[-1]
    assert set(final) == {"accuracy", "total_accuracy",
                          "free_input_accuracy"}
    log = [json.loads(ln) for ln in
           (run_dir / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log if "accuracy" in r] == [12, 24]
    assert sorted(p.name for p in (run_dir / "ckpt").iterdir()) == \
        ["ckpt_24.npz"]

    # the loss of the trained params lies below the init's on a batch
    cfg = ANFSATConfig(feature_maps=16, query_maps=16, train_rounds=2)
    ds = anf_eval.build_anf_dataset(argparse.Namespace(
        rounds=3, min_free_bits=4, max_free_bits=8, train_size=12,
        test_size=8, seed=0, max_vars=256, max_ands=256, max_clauses=256,
        max_edges=1024, max_graphs=4, data_dir=str(tmp_path / "dc")))
    batch = ds.train_data()[0]
    init = anf_sat_init(torch.Generator().manual_seed(0), cfg)
    trained = restore_model_params(run_dir / "params.npz", anf_sat_init,
                                   cfg, "cpu")
    assert _loss_on(trained, batch, cfg) < 0.98 * _loss_on(init, batch, cfg)
    # the checkpoint directory holds the same params
    from_ckpt = restore_model_params(run_dir / "ckpt", anf_sat_init, cfg,
                                     "cpu")
    for a, b in zip(jax.tree.leaves(trained), jax.tree.leaves(from_ckpt)):
        assert torch.equal(a, b)

    # the TPU package reads the exported params
    jparams = jrestore(str(run_dir / "params.npz"), jmodel.anf_sat_init,
                       jmodel.ANFSATConfig(feature_maps=16, query_maps=16))
    jinit = jmodel.anf_sat_init(jax.random.key(0), jmodel.ANFSATConfig(
        feature_maps=16, query_maps=16))
    assert jax.tree.map(np.shape, jparams) == jax.tree.map(np.shape, jinit)

    # a restore continues the run from its newest checkpoint
    final2 = anf_training.main(argv + ["--train_steps", "28", "--restore",
                                       str(run_dir / "ckpt"), "--label",
                                       "resumed"])
    log2 = [json.loads(ln) for ln in (
        tmp_path / "runs" / final2["run_dir"].split("/")[-1] /
        "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log2 if "steps_per_sec" in r] == [28]


def test_training_script_mega_steps_raise(tmp_path, capsys):
    """`--mega_steps` raised until the scanned step was ported; it now runs
    chunks of N steps over the padded plans (tiles off, with the TPU
    package's warning) and stops at the budget exactly."""
    final = anf_training.main(TINY + [
        "--mega_steps", "4", "--train_steps", "10", "--data_dir",
        str(tmp_path / "dc"), "--train_dir", str(tmp_path / "runs")])
    out = capsys.readouterr().out
    assert "DSAT_ANF_TILED ignored with --mega_steps > 1" in out
    assert "mega-steps:" in out
    ckpts = (Path(final["run_dir"]) / "ckpt").iterdir()
    assert sorted(int(p.stem.split("_")[1]) for p in ckpts)[-1] == 10
    with np.load(Path(final["run_dir"]) / "ckpt" / "ckpt_10.npz") as z:
        assert int(z["step"]) == 10 and int(z["count"]) == 10


def test_eval_script_matches_the_tpu_packages_keys(tmp_path, monkeypatch):
    from diffusionsat_tpu.models import anf_sat as jmodel
    from diffusionsat_tpu.train.checkpoint import export_params

    import anf_eval as jeval

    ckpt = tmp_path / "tiny.npz"
    jcfg = jmodel.ANFSATConfig(feature_maps=16, query_maps=16)
    export_params(jmodel.anf_sat_init(jax.random.key(0), jcfg), ckpt,
                  meta={"model": "anf_sat"})
    opts = ["--tries", "2", "--cdcl_completion", "--marginalize_seeds", "2",
            "--ckpt", str(ckpt), "--feature_maps", "16", "--test_rounds",
            "2", "--test_size", "8"] + DATA
    monkeypatch.chdir(tmp_path)         # the TPU package's cache directory
    want = jeval.main(opts + ["--dump_marginals", str(tmp_path / "j.npz"),
                              "--out", str(tmp_path / "j.json")])
    # the port reads the cache the TPU package wrote
    got = anf_eval.main(opts + [
        "--dump_marginals", str(tmp_path / "t.npz"), "--out",
        str(tmp_path / "t.json"), "--device", "cpu", "--data_dir",
        str(tmp_path / "data_cache")])
    assert set(got) == set(want)
    assert json.loads((tmp_path / "t.json").read_text()).keys() == \
        json.loads((tmp_path / "j.json").read_text()).keys()
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in t.files:
            assert t[k].shape == j[k].shape, k
    # an untrained model: no system is solved by rounding, and completion
    # is host code on identical inputs
    assert got["tries"] == 2 and got["marginalize_seeds"] == 2
    assert 0.0 <= got["completion_systems_solved"] <= 1.0
    assert abs(got["accuracy"] - want["accuracy"]) < 0.1

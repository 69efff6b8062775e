"""`python -m diffusionsat_torch.main` on the CPU, and the training
script's k-SAT split, against the TPU package's scripts."""

import csv
import importlib
import json
from pathlib import Path

import numpy as np
import pytest

from _torch_parity import assert_batches_equal
from diffusionsat_torch import diffusion_training as tdt
from diffusionsat_torch import export_pretrained
from diffusionsat_torch import main as tmain
from diffusionsat_torch.config import parse_config as tparse
from diffusionsat_torch.ops import segsum
from diffusionsat_torch.train.checkpoint import load_params as tload

TINY = ["--device", "cpu", "--train_size", "60", "--test_size", "90",
        "--min_vars", "4", "--max_vars", "12", "--train_rounds", "2",
        "--test_rounds", "2", "--feature_maps", "16", "--query_maps", "8",
        "--eval_every", "2", "--ckpt_every", "2", "--gen_workers", "1",
        "--max_nodes_per_batch", "400"]
ALL_FLAGS = ["--evaluate", "--evaluate_round_gen", "--evaluate_variable_gen",
             "--evaluate_batch_gen", "--test_invariance",
             "--test_classic_solver", "--make_cactus"]


def test_flags_and_sweep_lists_are_the_tpu_packages():
    jmain = importlib.import_module("main")
    assert tmain.EVAL_FLAGS == jmain.EVAL_FLAGS
    argv = ["--evaluate", "-make_cactus", "--train_steps", "3",
            "test_invariance", "--task", "splot"]
    assert tmain.split_eval_flags(argv) == jmain.split_eval_flags(argv)
    # the TPU package's lists (its main.py passes them inline)
    assert tmain.ROUND_GEN_ROUNDS == (16, 32, 64, 128, 256, 512, 1024, 2048,
                                      4096)
    assert tmain.BATCH_GEN_BUDGETS == tuple(range(3000, 24000, 1000))
    assert tmain.VARIABLE_GEN_COUNTS == range(10, 100, 10)


def test_main_trains_and_runs_every_eval_mode(tmp_path, capsys):
    argv = TINY + ["--train_steps", "4", "--data_dir", str(tmp_path / "dc"),
                   "--train_dir", str(tmp_path / "runs")] + ALL_FLAGS
    segsum.reset_launch_counts()
    res = tmain.main(argv, round_gen_rounds=(2, 4),
                     batch_gen_budgets=(400, 600),
                     variable_gen_counts=range(5, 9, 3))
    out = capsys.readouterr().out
    run_dir = Path(res["run_dir"])
    assert res["state"].step == 4
    assert set(res["seconds"]) == {"train", *tmain.EVAL_FLAGS}
    for mark in ("[evaluate]", "[invariance]", "[classic solver]",
                 "[cactus] written"):
        assert mark in out
    assert 0.0 <= res["evaluate"]["total_accuracy"] <= 1.0
    assert set(res["test_invariance"]) == {"original", "permuted",
                                           "inverted"}
    assert res["test_classic_solver"] > 0
    assert list(res["evaluate_round_gen"]) == [2, 4]
    assert list(res["evaluate_batch_gen"]) == [400, 600]
    assert list(res["evaluate_variable_gen"]) == [5, 8]
    for name in ("gen_steps_result.txt", "gen_batch_size_results.txt",
                 "gen_variables_size_result.txt", "train_log.jsonl"):
        assert (run_dir / name).read_text()
    with open(run_dir / "query_sat_cactus.csv") as f:
        rows = list(csv.reader(f))
    n_graphs = [int(b.n_graphs) for b in tmain.SatDataset(
        tmain.build_instances(tparse(argv[:-len(ALL_FLAGS)])),
        tmain.BucketSpec.for_node_budget(400), cache_dir=tmp_path / "dc",
        name="3-sat_4_12_60").test_data()]
    assert len(n_graphs) > 10
    # one row per test graph after the 10 warm-up batches
    assert rows[0] == ["var_count", "solved", "time"]
    assert len(rows) - 1 == sum(n_graphs[10:]) == len(res["make_cactus"])
    log = [json.loads(x) for x in
           (run_dir / "train_log.jsonl").read_text().splitlines()]
    assert any("total_accuracy" in r for r in log)
    assert np.isfinite([r["loss"] for r in log if "loss" in r]).all()
    # on the CPU the wrappers run the plain version
    assert segsum.LAUNCHES == {"lit_to_clause": 0, "clause_to_lit": 0}

    # --restore continues from the newest checkpoint of the directory
    ckpt = run_dir / "ckpt"
    res2 = tmain.main(TINY + ["--train_steps", "6", "--data_dir",
                              str(tmp_path / "dc"), "--train_dir",
                              str(tmp_path / "runs2"), "--restore",
                              str(ckpt)])
    assert "Restored from step 4" in capsys.readouterr().out
    assert res2["state"].step == 6

    # the checkpoint exports to a params file both packages read
    meta = export_pretrained.main(["--ckpt", str(ckpt), "--feature_maps",
                                   "16", "--query_maps", "8", "--out",
                                   str(tmp_path / "p.npz"), "--note", "x"])
    jload = importlib.import_module(
        "diffusionsat_tpu.train.checkpoint").load_params
    jtree, jmeta = jload(tmp_path / "p.npz")
    ttree, tmeta = tload(tmp_path / "p.npz")
    assert jmeta == tmeta == meta
    assert (meta["model"], meta["step"], meta["note"]) == ("query_sat", 6,
                                                           "x")
    assert meta["config"]["feature_maps"] == 16
    np.testing.assert_array_equal(
        np.asarray(jtree["lit_mlp"]["w"][0]),
        res2["state"].params["lit_mlp"]["w"][0].numpy())
    np.testing.assert_array_equal(jtree["lit_mlp"]["w"][0],
                                  ttree["lit_mlp"]["w"][0])


@pytest.mark.parametrize("task", ["kcolor", "primes"])
def test_main_trains_a_registry_task(task, tmp_path):
    extra = ["--max_vars", "200", "--max_nodes_per_batch", "2000"] \
        if task == "primes" else []
    res = tmain.main(TINY + ["--task", task, "--train_steps", "2",
                             "--use_unigen", "false", "--data_dir",
                             str(tmp_path / "dc"), "--train_dir",
                             str(tmp_path / "runs")] + extra)
    assert res["state"].step == 2
    assert Path(res["run_dir"]).name.startswith(f"query_sat_{task}_")


def test_unported_model_raises_naming_its_item(tmp_path):
    """The model once unported trains: `--model neuro_sat` trains NeuroSAT
    (its LSTM cells and messages), not QuerySAT;
    tests/test_torch_models_cli.py runs every model."""
    res = tmain.main(TINY + ["--model", "neuro_sat", "--train_steps", "1",
                             "--data_dir", str(tmp_path / "dc"),
                             "--train_dir", str(tmp_path / "runs")])
    assert res["state"].step == 1
    assert set(res["state"].params) == {"L_init", "C_init", "L_update",
                                        "C_update", "LC_msg", "CL_msg",
                                        "L_vote"}


def test_training_ksat_split_equals_the_tpu_package(tmp_path):
    """`--use_hard_3sat false`: the training script's k-SAT dataset, under
    the TPU package's cache name, batch for batch."""
    jdt = importlib.import_module("diffusion_training")
    jconfig = importlib.import_module("diffusionsat_tpu.config")
    argv = ["--use_hard_3sat", "false", "--train_size", "14",
            "--test_size", "4", "--max_vars", "10", "--max_nodes_per_batch",
            "1000", "--data_dir", str(tmp_path)]
    jds = jdt.build_dataset(jconfig.parse_config(argv))
    tds = tdt.build_dataset(tparse(argv))
    assert tds.name == jds.name == "diffusion_ksat_3_10_14"
    # two generator shards in both (the TPU package ties their number to
    # its worker processes)
    jds.gen_workers, tds.gen_shards, tds.gen_workers = 2, 2, 1
    tds.cache_dir = tmp_path / "t"
    jb, tb = list(jds.train_data()), list(tds.train_data())
    assert len(tb) == len(jb) > 0
    for a, b in zip(jb, tb):
        assert_batches_equal(a, b)
    assert sum(int(b.n_graphs) for b in tb) == 14

"""`python -m diffusionsat_torch.diffusion_training --device cpu
--n_devices 4`: four gloo ranks on the CPU, against the TPU package's
script with `--n_devices 4` on its virtual CPU devices, on the same cached
split (the two packages read each other's cache)."""

import importlib
import json
import math
from pathlib import Path

import pytest

from diffusionsat_torch import diffusion_training

TINY = ["--train_steps", "4", "--train_size", "200", "--test_size", "20",
        "--train_rounds", "2", "--test_rounds", "2", "--feature_maps", "16",
        "--query_maps", "8", "--logit_maps", "4", "--eval_every", "2",
        "--ckpt_every", "2", "--max_nodes_per_batch", "600",
        "--n_devices", "4", "--mega_steps", "4"]
# the lines both scripts print about the data and its DP stream
PREFIXES = ("train batches:", "WARNING: --mega_steps", "hybrid dispatch:",
            "dense layout shapes", "WARNING: hybrid stream under DP",
            "data-parallel over", "stacked_stream:")


def stream_lines(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if ln.startswith(PREFIXES)]


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("dc")


def test_dp_training_prints_the_tpu_scripts_lines_and_trains(
        split_dir, tmp_path, capfd, monkeypatch):
    # a small dense cutoff: a hybrid stream, which DP cuts to its majority
    monkeypatch.setenv("DSAT_DENSE_MAX_VARS", "12")
    final = diffusion_training.main(TINY + [
        "--device", "cpu", "--gen_workers", "1", "--data_dir",
        str(split_dir), "--train_dir", str(tmp_path / "port")])
    port_out = capfd.readouterr().out
    jdt = importlib.import_module("diffusion_training")
    jdt.main(TINY + ["--data_dir", str(split_dir), "--train_dir",
                     str(tmp_path / "jax")])
    jax_out = capfd.readouterr().out
    lines = stream_lines(port_out)
    assert lines == stream_lines(jax_out)
    assert any(ln.startswith("WARNING: hybrid stream") for ln in lines)
    assert any(ln.startswith("stacked_stream:") for ln in lines)
    assert "data-parallel over 4 devices" in lines
    # rank 0 alone writes its run; the other ranks print nothing
    (run_dir,) = (tmp_path / "port").iterdir()
    assert Path(final["run_dir"]) == run_dir
    assert port_out.count("[final]") == 1
    assert port_out.count("[eval @ 2]") == 1
    log = [json.loads(ln) for ln in
           (run_dir / "train_log.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in log if "loss" in r]
    assert losses and all(math.isfinite(x) for x in losses)
    assert [r["step"] for r in log if "accuracy" in r] == [2, 4]
    for name in ("config.json", "params.npz", "tb"):
        assert (run_dir / name).exists(), name
    assert sorted(p.name for p in (run_dir / "ckpt").iterdir()) == \
        ["ckpt_2.npz", "ckpt_4.npz"]
    assert math.isfinite(final["diag_loss"])


def test_dp_training_restores_on_every_rank(split_dir, tmp_path, capfd):
    """A flat run on 2 ranks, then a second one that restores its
    checkpoint on every rank and trains two steps more."""
    argv = TINY + ["--device", "cpu", "--gen_workers", "1", "--dense",
                   "false", "--n_devices", "2", "--data_dir", str(split_dir)]
    first = diffusion_training.main(argv + ["--train_dir",
                                            str(tmp_path / "a")])
    ckpt = Path(first["run_dir"]) / "ckpt"
    # the later --train_steps wins
    second = diffusion_training.main(argv + [
        "--train_steps", "6", "--train_dir", str(tmp_path / "b"),
        "--restore", str(ckpt)])
    out = capfd.readouterr().out
    assert out.count("Restored from step 4") == 1
    log = [json.loads(ln) for ln in (Path(second["run_dir"]) /
                                     "train_log.jsonl").read_text()
           .splitlines()]
    assert [r["step"] for r in log if "steps_per_sec" in r] == [6]
    assert sorted(p.name for p in ckpt.iterdir())[-1] == "ckpt_6.npz"


def test_dp_training_needs_a_card_per_rank_on_cuda(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        diffusion_training.main(TINY + ["--data_dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())

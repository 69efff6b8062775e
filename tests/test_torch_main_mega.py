"""`python -m diffusionsat_torch.main --mega_steps N` on the CPU: NeuroSAT
trains in whole chunks of N planned flat batches (`train/loop.
chunk_batches`), a call a chunk, with evals and checkpoints every
`.. // N` calls, the last chunk cut at `--train_steps`, and a restore; a
model whose graphed chunk no card test holds equal to its eager steps
trains one step a call, with a warning; `--mega_steps 0` is the eager
loop. The graph paths are switched on here (`graphs_enabled` patched), so
each "replay" runs the buffer plumbing the card runs (no capture on the
CPU). The card's graphs: `tests/test_torch_main_mega_cuda.py`.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusionsat_torch import cuda_graphs
from diffusionsat_torch import main as tmain
from diffusionsat_torch.graph.batch import BucketSpec, build_batch
from diffusionsat_torch.train import loop as tloop

TINY = ["--device", "cpu", "--train_size", "60", "--test_size", "12",
        "--min_vars", "4", "--max_vars", "10", "--feature_maps", "16",
        "--gen_workers", "1", "--max_nodes_per_batch", "300"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("dc")


@pytest.fixture
def graphed(monkeypatch):
    monkeypatch.setattr(cuda_graphs, "graphs_enabled", lambda dev: True)


@pytest.fixture
def calls(monkeypatch):
    """Each train-step call's budget, by the kind of step main made."""
    seen = {"scanned": [], "eager": 0}

    def scanned(*a, **kw):
        mega = orig_scanned(*a, **kw)

        def counted(state, stacked, max_steps=None):
            seen["scanned"].append(
                (cuda_graphs.stack_length(stacked[0]), max_steps))
            return mega(state, stacked, max_steps=max_steps)
        return counted

    def eager(*a, **kw):
        step = orig_eager(*a, **kw)

        def counted(*b, **k):
            seen["eager"] += 1
            return step(*b, **k)
        return counted

    orig_scanned = tmain.make_scanned_train_step_for
    orig_eager = tmain.make_train_step_for
    monkeypatch.setattr(tmain, "make_scanned_train_step_for", scanned)
    monkeypatch.setattr(tmain, "make_train_step_for", eager)
    return seen


def _argv(data_dir, tmp_path, *extra):
    return TINY + ["--data_dir", str(data_dir), "--train_dir",
                   str(tmp_path / "runs"), *extra]


def _planned(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        fs = [(5, [[int(v) * (1 if rng.random() < 0.5 else -1)
                    for v in rng.choice(5, 3, replace=False) + 1]
                   for _ in range(20)])]
        out.append(build_batch(fs, BucketSpec(64, 128, 512, 4)))
    return tloop.plan_batches(out, "cpu")


def test_chunk_batches_keeps_whole_chunks_in_order():
    planned = _planned(10)
    chunks = tloop.chunk_batches(planned, 4, "cpu")
    assert len(chunks) == 2
    for c, chunk in enumerate(chunks):
        batch, plans = chunk
        assert cuda_graphs.stack_length(batch) == 4
        for r in range(4):
            b, p = planned[4 * c + r]
            row = cuda_graphs.index_tree(chunk, r)
            for x, y in zip(cuda_graphs.tree_leaves((b, p)),
                            cuda_graphs.tree_leaves(row), strict=True):
                assert torch.equal(x, y)
    with pytest.raises(ValueError, match="no chunk of 11 steps"):
        tloop.chunk_batches(planned, 11, "cpu")


def test_main_trains_neurosat_in_graphed_chunks(data_dir, tmp_path, graphed,
                                                calls, capsys):
    res = tmain.main(_argv(data_dir, tmp_path, "--model", "neuro_sat",
                           "--mega_steps", "4", "--train_steps", "10",
                           "--eval_every", "8", "--ckpt_every", "8"))
    out = capsys.readouterr().out
    found = re.search(r"mega-steps: (\d+) chunks of 4 steps \((\d+) "
                      r"batches left out\)", out)
    assert int(found[1]) >= 2 and 0 <= int(found[2]) < 4
    assert "WARNING" not in out
    # 4 + 4 + the last chunk cut at --train_steps
    assert calls["scanned"] == [(4, 10), (4, 6), (4, 2)]
    assert calls["eager"] == 0
    assert res["state"].step == 10
    run_dir = Path(res["run_dir"])
    log = [json.loads(x) for x in
           (run_dir / "train_log.jsonl").read_text().splitlines()]
    # evals and checkpoints every 8 // 4 = 2 calls, and the final save
    assert [r["step"] for r in log if "total_accuracy" in r] == [8]
    assert np.isfinite([r["loss"] for r in log if "loss" in r]).all()
    assert sorted(p.name for p in (run_dir / "ckpt").iterdir()) == \
        ["ckpt_10.npz", "ckpt_8.npz"]

    calls["scanned"].clear()
    res2 = tmain.main(_argv(data_dir, tmp_path, "--model", "neuro_sat",
                            "--mega_steps", "4", "--train_steps", "13",
                            "--restore", str(run_dir / "ckpt")))
    assert "Restored from step 10" in capsys.readouterr().out
    assert calls["scanned"] == [(4, 3)]
    assert res2["state"].step == 13


def test_a_model_left_eager_warns_and_steps_once_a_call(data_dir, tmp_path,
                                                        calls, capsys):
    res = tmain.main(_argv(data_dir, tmp_path, "--model", "neurocore",
                           "--mega_steps", "4", "--train_steps", "3"))
    out = capsys.readouterr().out
    assert "WARNING: --mega_steps" in out and "neurocore" in out
    assert calls["scanned"] == [] and calls["eager"] == 3
    assert res["state"].step == 3


def test_mega_steps_0_is_the_eager_loop(data_dir, tmp_path, calls, capsys):
    res = tmain.main(_argv(data_dir, tmp_path, "--model", "neuro_sat",
                           "--train_steps", "2"))
    assert "mega-steps" not in capsys.readouterr().out
    assert calls["scanned"] == [] and calls["eager"] == 2
    assert res["state"].step == 2

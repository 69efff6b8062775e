"""Every QuerySAT `--model_ckpt` of the port takes a training run's
checkpoint directory as well as a portable `.npz` params file, as the TPU
package's CLIs do: the flagship's params written into a `CheckpointManager`
directory give exactly the results of the same params read from the `.npz`,
entry point by entry point, on the same seeds."""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusionsat_torch import (
    diffusion_evaluation,
    measure_bank_freq,
    sample,
    solve_eval,
    uniformity_benchmark,
)
from diffusionsat_torch.diffusion.sampler import DiffusionSampler
from diffusionsat_torch.models.query_sat import QuerySATConfig, query_sat_init
from diffusionsat_torch.train.adabelief import adabelief
from diffusionsat_torch.train.checkpoint import (
    CheckpointManager,
    load_model,
    load_params,
    params_from_numpy,
)
from diffusionsat_torch.train.loop import TrainState

REPO = Path(__file__).resolve().parent.parent
MLK64 = REPO / "pretrained" / "query_sat_3sat_diffusion_mlk64.npz"
UF20 = REPO / "diffusionsat_tpu" / "data" / "assets" / "satlib" / \
    "uf20-synth-1.cnf"
CHAIN = ["--diffusion_steps", "2", "--test_rounds", "2", "--device", "cpu"]
# 5 variables, 4 solutions: the exact-uniform comparison stays small
SMALL_CNF = "p cnf 5 4\n1 2 0\n-1 3 0\n-3 4 5 0\n-2 -4 0\n"


def _save_dir(directory: Path, params, step: int = 7) -> Path:
    CheckpointManager(directory).save(TrainState(
        params=params, opt_state=adabelief().init(params), step=step,
        generator=None))
    return directory


@pytest.fixture(scope="module")
def forms(tmp_path_factory):
    """The flagship's params as a checkpoint directory and as its `.npz`,
    and one data directory that both forms' runs share."""
    root = tmp_path_factory.mktemp("ckpt_dirs")
    tree, _meta = load_params(MLK64)
    ckpt = _save_dir(root / "run" / "ckpt", params_from_numpy(tree, "cpu"))
    (root / "small.cnf").write_text(SMALL_CNF)
    return {"dir": str(ckpt), "npz": str(MLK64)}, root


def _quiet(fn, *args):
    """`fn(*args)` and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = fn(*args)
    return got, out.getvalue()


def _untimed(node):
    """`node` without its wall-clock readings and its params' path."""
    if isinstance(node, dict):
        return {k: _untimed(v) for k, v in node.items()
                if k not in ("elapsed_s", "ms_per_distinct", "eval_seconds",
                             "wall_s", "model_ckpt")}
    return node


def run_sample(ckpt, root, work):
    _got, printed = _quiet(sample.main, [
        "--dimacs", str(UF20), "--model_ckpt", ckpt, "--n_samples", "5",
        "--out", str(work / "s.json"), *CHAIN])
    return json.loads((work / "s.json").read_text()), printed


def run_solve_eval(ckpt, root, work):
    res, _ = _quiet(solve_eval.main, [
        "--model_ckpt", ckpt, "--train_size", "40", "--test_size", "12",
        "--max_vars", "10", "--max_batches", "1", "--gen_workers", "1",
        "--data_dir", str(root / "data"), "--test_rounds", "2", "--device",
        "cpu"])
    return _untimed(res)


def run_diffusion_evaluation(ckpt, root, work):
    record, _ = _quiet(diffusion_evaluation.main, [
        "--dimacs", str(root / "small.cnf"), "--model_ckpt", ckpt, "--k",
        "2", "--benchmarks_file", str(work / "b.jsonl"), *CHAIN])
    return _untimed(record)


def run_uniformity_benchmark(ckpt, root, work):
    out = work / "u.jsonl"
    summary, _ = _quiet(uniformity_benchmark.main, [
        "--model_ckpt", ckpt, "--n_formulas", "1", "--k", "1",
        "--variants", "diffusion_nofreeze", "--out", str(out), *CHAIN])
    records = [_untimed(json.loads(ln))
               for ln in out.read_text().splitlines()]
    return summary, records


def run_measure_bank_freq(ckpt, root, work):
    out = work / "f.npz"
    agg, _ = _quiet(measure_bank_freq.main, [
        "--model_ckpt", ckpt, "--chains", "2", "--chunk", "1",
        "--train_size", "12", "--label_samples", "3", "--max_batches", "1",
        "--data_dir", str(root / "data"), "--gen_workers", "1", "--out",
        str(out), *CHAIN])
    with np.load(out) as z:
        table = {k: z[k] for k in z.files if k != "model_ckpt"}
    return _untimed(agg), table


def run_from_checkpoint(ckpt, root, work):
    sampler = DiffusionSampler.from_checkpoint(
        ckpt, str(UF20), cfg=QuerySATConfig(test_rounds=2), device="cpu",
        diffusion_steps=2, test_rounds=2, seed=3)
    counts, _ = _quiet(sampler.samples, 4)
    params = {k: v.numpy() for k, v in _leaves(sampler.params, "")}
    return counts, sampler.success_rate, params


def _leaves(node, prefix):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, node


def _assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("run", [
    run_sample, run_solve_eval, run_diffusion_evaluation,
    run_uniformity_benchmark, run_measure_bank_freq, run_from_checkpoint],
    ids=lambda f: f.__name__[4:])
def test_ckpt_dir_equals_npz(forms, run, tmp_path):
    paths, root = forms
    got = {}
    for form, ckpt in paths.items():
        work = tmp_path / form
        work.mkdir()
        got[form] = run(ckpt, root, work)
    _assert_same(got["dir"], got["npz"])


@pytest.mark.parametrize("made", [True, False], ids=["empty", "missing"])
def test_dir_without_checkpoint_raises_and_is_not_made(tmp_path, made):
    path = tmp_path / "ckpt"
    if made:
        path.mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_model(path, "cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        DiffusionSampler.from_checkpoint(str(path), str(UF20), device="cpu")
    assert path.exists() == made
    assert not made or not list(path.iterdir())


def test_dir_of_other_widths_raises_unless_asked_for_them(tmp_path):
    narrow = QuerySATConfig(feature_maps=16, query_maps=16, logit_maps=4)
    params = query_sat_init(torch.Generator().manual_seed(1), narrow)
    ckpt = _save_dir(tmp_path / "ckpt", params, step=3)
    with pytest.raises(ValueError, match="params shape"):
        load_model(ckpt, "cpu")
    got, cfg = load_model(ckpt, "cpu", feature_maps=16, query_maps=16,
                          logit_maps=4, test_rounds=2)
    assert (cfg.feature_maps, cfg.logit_maps, cfg.test_rounds) == (16, 4, 2)
    want = dict(_leaves(params, ""))
    for key, leaf in _leaves(got, ""):
        assert torch.equal(leaf, want[key]), key

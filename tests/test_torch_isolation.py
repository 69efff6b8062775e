"""The port stands alone: it imports nothing of JAX or of the TPU package,
and its entry points refuse to run without CUDA unless asked for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "diffusionsat_torch"
SMOKE = REPO / "chip_smoke.py"
FORBIDDEN = ("jax", "flax", "orbax", "diffusionsat_tpu")
ASSETS = REPO / "diffusionsat_tpu" / "data" / "assets"


def _port_modules():
    return sorted(
        "diffusionsat_torch." + ".".join(
            p.relative_to(PORT).with_suffix("").parts).replace(
                ".__init__", "")
        for p in PORT.rglob("*.py")) + ["diffusionsat_torch"]


def test_every_module_imports_with_jax_blocked():
    code = "\n".join([
        "import importlib, importlib.util, sys",
        *(f"sys.modules[{m!r}] = None" for m in FORBIDDEN),
        *(f"importlib.import_module({m!r})" for m in _port_modules()),
        f"spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{str(SMOKE)!r})",
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        f"leaked = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None]",
        "assert not leaked, leaked",
        "print('ok')",
    ])
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [SMOKE],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import(path):
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


def test_no_port_file_names_the_tpu_stack():
    for path in sorted(PORT.rglob("*")):
        if path.suffix not in (".py", ".cu", ".cuh", ".h", ".cpp"):
            continue
        text = path.read_text().lower()
        for word in FORBIDDEN:
            assert word not in text, f"{path.relative_to(REPO)} names {word}"


def test_entry_points_need_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    from diffusionsat_torch.device import resolve_device
    from diffusionsat_torch.diffusion.sampler import DiffusionSampler
    from diffusionsat_torch.graph.batch import BucketSpec, build_batch
    from diffusionsat_torch.graph.dense_batch import densify_batches
    from diffusionsat_torch.models.query_sat_dense import (
        query_sat_dense_apply,
    )
    from diffusionsat_torch.diffusion_evaluation import main as de_main
    from diffusionsat_torch.measure_bank_freq import main as freq_main
    from diffusionsat_torch.solve_eval import main as eval_main
    from diffusionsat_torch.uniformity_benchmark import main as battery_main
    from diffusionsat_torch.train.adabelief import adabelief
    from diffusionsat_torch.train.checkpoint import opt_state_from_numpy
    from diffusionsat_torch.train.loop import (
        evaluate_metrics,
        make_diagnostics_step,
        make_planned_train_step,
        make_predict_step,
        make_selfsupervised_train_step,
        make_train_step,
        make_train_step_for,
        plan_batches,
    )
    from diffusionsat_torch.models.query_sat import (
        QuerySATConfig,
        query_sat_apply,
        query_sat_init,
    )
    from diffusionsat_torch.sample import main
    from diffusionsat_torch.sat.cnf import CNF
    from diffusionsat_torch.train.checkpoint import (
        params_from_numpy,
        restore_model_params,
    )
    from diffusionsat_torch.anf_eval import main as anf_eval_main
    from diffusionsat_torch.main import main as generic_main
    from diffusionsat_torch.evaluation import harness
    from diffusionsat_torch.evaluation.noise_sweep import noise_sweep
    from diffusionsat_torch.anf_training import main as anf_train_main
    from diffusionsat_torch.data.anf import RandomAnfInstances
    from diffusionsat_torch.graph.anf_batch import ANFBucket, build_anf_batch
    from diffusionsat_torch.models.anf_sat import (
        ANFSATConfig,
        anf_sat_apply,
        anf_sat_init,
    )
    from diffusionsat_torch import hyperopt
    from diffusionsat_torch.anf_error_structure import main as structure_main
    from diffusionsat_torch.tsp.model import (
        TSPMatrixSEConfig,
        tsp_matrix_se_apply,
        tsp_matrix_se_init,
    )

    cfg = QuerySATConfig(feature_maps=8, query_maps=8, test_rounds=1)
    params = query_sat_init(torch.Generator().manual_seed(0), cfg)
    cnf = CNF(n_vars=3, clauses=[[1, 2], [-1, 3]])
    batch = build_batch([(3, cnf.clauses())], BucketSpec(8, 8, 16, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        query_sat_apply(params, cfg, batch)
    (dense,) = densify_batches([batch])
    ckpt = str(REPO / "pretrained" / "query_sat_3sat_diffusion_mlk64.npz")
    anf_ckpt = str(REPO / "pretrained" / "anf_sat_sha1_r17.npz")
    anf_cfg = ANFSATConfig(feature_maps=8, query_maps=8, test_rounds=1)
    anf_params = anf_sat_init(torch.Generator().manual_seed(0), anf_cfg)
    anf_items = list(RandomAnfInstances(train_size=2).train_generator())
    anf_batch = build_anf_batch([(n, e) for n, e, _ in anf_items],
                                ANFBucket(64, 64, 64, 256, 2))
    tsp_cfg = TSPMatrixSEConfig(feature_maps=4, rounds=1)
    tsp_params = tsp_matrix_se_init(torch.Generator().manual_seed(0),
                                    tsp_cfg)
    tsp_adj = torch.ones((1, 4, 4))
    hp = hyperopt.TPESampler(hyperopt.SPACE).suggest()
    for call in (
            lambda: query_sat_dense_apply(params, cfg, dense),
            lambda: DiffusionSampler(params, cfg, cnf, dense=False),
            lambda: DiffusionSampler(params, cfg, cnf),
            lambda: make_predict_step(cfg),
            lambda: make_train_step(cfg, adabelief()),
            lambda: make_train_step_for(query_sat_dense_apply, cfg,
                                        adabelief()),
            lambda: make_planned_train_step(cfg, adabelief()),
            lambda: make_selfsupervised_train_step(cfg, adabelief()),
            lambda: make_diagnostics_step(cfg),
            lambda: query_sat_apply(params, cfg, batch, training=True),
            lambda: opt_state_from_numpy(0, {}, {}),
            lambda: plan_batches([batch]),
            lambda: evaluate_metrics(params, cfg, [batch], [], None),
            lambda: eval_main(["--model_ckpt", ckpt, "--data_dir",
                               str(tmp_path)]),
            lambda: battery_main(["--model_ckpt", ckpt, "--n_formulas", "1",
                                  "--out", str(tmp_path / "b.jsonl")]),
            lambda: de_main(["--dimacs", str(ASSETS / "satlib" /
                                             "uf20-synth-1.cnf"),
                             "--model_ckpt", ckpt, "--benchmarks_file",
                             str(tmp_path / "b.jsonl")]),
            lambda: freq_main(["--model_ckpt", ckpt, "--data_dir",
                               str(tmp_path), "--out",
                               str(tmp_path / "f.npz")]),
            lambda: anf_sat_apply(anf_params, anf_cfg, anf_batch),
            lambda: restore_model_params(anf_ckpt, anf_sat_init, anf_cfg),
            lambda: anf_eval_main(["--ckpt", anf_ckpt, "--data_dir",
                                   str(tmp_path)]),
            lambda: anf_train_main(["--data_dir", str(tmp_path),
                                    "--train_dir", str(tmp_path)]),
            lambda: generic_main(["--data_dir", str(tmp_path),
                                  "--train_dir", str(tmp_path),
                                  "--evaluate"]),
            lambda: noise_sweep(params, cfg, [batch], steps=1),
            lambda: harness.test_invariance(params, cfg, [batch], steps=1),
            lambda: harness.make_cactus(params, cfg, [batch],
                                        tmp_path / "c.csv"),
            lambda: harness.evaluate_round_generalization(
                params, lambda r: cfg, [batch], tmp_path / "r.txt"),
            lambda: tsp_matrix_se_apply(tsp_params, tsp_cfg, tsp_adj,
                                        tsp_adj),
            lambda: hyperopt.main(["--data_dir", str(tmp_path), "--out",
                                   str(tmp_path / "h.jsonl"), "--trials",
                                   "1"]),
            lambda: hyperopt.run_trial(hp, None, 1, 0),
            lambda: hyperopt.train_trial(hp, None, 1, 0),
            lambda: hyperopt.score_trial(params, cfg, []),
            lambda: structure_main(["--ckpt", anf_ckpt, "--data_dir",
                                    str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not list(tmp_path.iterdir())    # refused before any data work
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": [params["lit_mlp"]["w"][0].numpy()]})
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--dimacs", str(ASSETS / "satlib" / "uf20-synth-1.cnf"),
              "--model_ckpt", ckpt])
    # the same calls run when the CPU is asked for
    assert resolve_device("cpu").type == "cpu"
    out = query_sat_apply(params, cfg, batch, device="cpu")
    assert out[0].shape == (8, 1)
    DiffusionSampler(params, cfg, cnf, dense=False, device="cpu")
    assert DiffusionSampler(params, cfg, cnf, device="cpu").dense
    assert query_sat_dense_apply(params, cfg, dense, device="cpu")[0].shape \
        == (dense.G, dense.Vg, 1)
    assert evaluate_metrics(params, cfg, plan_batches([batch], "cpu"), [],
                            None, device="cpu") == {}
    assert anf_sat_apply(anf_params, anf_cfg, anf_batch, training=False,
                         device="cpu")[0].shape == (64, 1)
    assert tsp_matrix_se_apply(tsp_params, tsp_cfg, tsp_adj, tsp_adj,
                               device="cpu")[0].shape == (1, 4, 4, 1)


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(SMOKE.read_text())
    for script, cwd in ((SMOKE, REPO), (lone, tmp_path)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout

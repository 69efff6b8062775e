"""The training script, in-process at a tiny size on the CPU, in both
layouts, and its configuration against the TPU package's."""

import dataclasses
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusionsat_tpu import config as jconfig
from diffusionsat_torch import config as tconfig
from diffusionsat_torch import diffusion_training
from diffusionsat_torch.ops import dense_ops, segsum

jckpt = importlib.import_module("diffusionsat_tpu.train.checkpoint")
tckpt = importlib.import_module("diffusionsat_torch.train.checkpoint")

TINY = ["--train_steps", "6", "--train_size", "60", "--test_size", "20",
        "--train_rounds", "2", "--test_rounds", "2", "--feature_maps", "16",
        "--query_maps", "8", "--logit_maps", "4", "--device", "cpu",
        "--eval_every", "3", "--ckpt_every", "4", "--gen_workers", "1",
        "--max_nodes_per_batch", "1500"]


def test_defaults_equal_the_tpu_packages_field_by_field():
    jdef, tdef = jconfig.RunConfig(), tconfig.parse_config([])
    jfields = [f.name for f in dataclasses.fields(jconfig.RunConfig)]
    tfields = [f.name for f in dataclasses.fields(tconfig.RunConfig)]
    assert tfields[:len(jfields)] == jfields
    assert tfields[len(jfields):] == ["device", "gen_workers"]
    for name in jfields:
        assert getattr(tdef, name) == getattr(jdef, name), name
    assert tdef.device == "cuda"
    # the flags parse as the TPU package's do
    argv = ["--train_steps", "12", "--dense", "false", "--noise_skew", "2.5",
            "--label", "x", "--restore", "some/dir"]
    jcfg, tcfg = jconfig.parse_config(argv), tconfig.parse_config(argv)
    for name in jfields:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tcfg.run_dir().name.startswith("query_sat_3-sat_x_")


def test_a_run_in_the_same_second_takes_a_directory_of_its_own(
        tmp_path, monkeypatch):
    """Two runs started within one second do not share a run directory
    (the second would append to the first's train log)."""
    monkeypatch.setattr(tconfig.time, "strftime",
                        lambda fmt: "20260101_000000")
    cfg = tconfig.parse_config(["--train_dir", str(tmp_path)])
    first = cfg.run_dir()
    assert first.name == "query_sat_3-sat_20260101_000000"
    first.mkdir()
    second = cfg.run_dir()
    assert second.name == "query_sat_3-sat_20260101_000000-1"
    second.mkdir()
    assert cfg.run_dir().name == "query_sat_3-sat_20260101_000000-2"


@pytest.mark.parametrize("argv,item", [
    (["--model", "neuro_sat"], "item 4"),
    # k-SAT (--use_hard_3sat false) and the registry's tasks are ported
    (["--model", "neurocore"], "item 4"),
    (["--model", "query_sat_lit"], "item 4"),
    (["--model", "attention_sat"], "item 4"),
    (["--n_devices", "2"], "item 7"),
    # --mega_steps no longer raises: with another unported option it is
    # that option's item that the error names
    (["--mega_steps", "8", "--n_devices", "2"], "item 7"),
    (["--label_samples", "4", "--model", "simple_neurosat"], "item 4"),
])
def test_unported_options_raise_naming_their_item(argv, item, tmp_path):
    """The options of the ROADMAP items that raised are ported: the models
    of Queue 1 item 4 pass the check, as the TPU package's script takes
    every registered name (`test_model_flag_names_the_run_and_trains_query_sat`
    trains under each), and so does item 7's `--n_devices`
    (tests/test_torch_parallel_cli.py trains under it), whose refusal of
    the self-supervised step comes, as in the TPU package's script, before
    anything is written."""
    diffusion_training._check_ported(tconfig.parse_config(argv))
    if item == "item 7":
        with pytest.raises(SystemExit, match="self_supervised"):
            diffusion_training.main(argv + [
                "--self_supervised", "true", "--device", "cpu",
                "--data_dir", str(tmp_path)])
        assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("argv", [
    ["--model", "neuro_sat"],
    ["--model", "neurocore"],
    ["--model", "query_sat_lit"],
    ["--model", "attention_sat"],
    ["--label_samples", "4", "--model", "simple_neurosat"],
])
def test_model_flag_names_the_run_and_trains_query_sat(argv, tmp_path):
    """As in the TPU package, the training script reads `--model` only to
    name the run directory: whatever model it names, it trains QuerySAT
    (the exported params are QuerySAT's tree)."""
    from diffusionsat_torch.models.query_sat import QuerySATConfig

    args = TINY + argv + ["--train_steps", "2", "--eval_every", "2",
                          "--data_dir", str(tmp_path / "dc"),
                          "--train_dir", str(tmp_path / "runs")]
    final = diffusion_training.main(args)
    run_dir = Path(final["run_dir"])
    name = argv[-1]
    assert run_dir.name.startswith(f"{name}_3-sat_")
    # the same name as the TPU package's but for the time stamp (its
    # config has no --device and --gen_workers)
    jname = jconfig.parse_config(
        [a for i, a in enumerate(args) if a not in ("--device", "cpu",
                                                    "--gen_workers")
         and args[i - 1] != "--gen_workers"]).run_dir().name
    assert run_dir.name.rsplit("_", 2)[0] == jname.rsplit("_", 2)[0]
    tree, meta = tckpt.load_params(run_dir / "params.npz")
    assert set(tree) == set(QuerySATConfig().mlp_configs())
    assert meta["model"] == "query_sat" and meta["step"] == 2


def test_tiled_flat_backend_raises(monkeypatch, tmp_path, capsys):
    """DSAT_FLAT_BACKEND=tiled runs: the over-cutoff batches (a small
    DSAT_DENSE_MAX_VARS forces some) train through their tiles, beside the
    dense ones. A backend the port does not have still raises."""
    from diffusionsat_torch.ops import tiled_ops

    monkeypatch.setenv("DSAT_FLAT_BACKEND", "xla")
    with pytest.raises(NotImplementedError, match="tiled"):
        diffusion_training.main(["--device", "cpu", "--data_dir",
                                 str(tmp_path)])
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("DSAT_FLAT_BACKEND", "tiled")
    monkeypatch.setenv("DSAT_DENSE_MAX_VARS", "20")
    calls = []
    pair = segsum.tiled_lit_to_clause

    def spy(x, ti, *args, **kw):
        calls.append(ti.n_real_tiles)
        return pair(x, ti, *args, **kw)

    monkeypatch.setattr(segsum, "tiled_lit_to_clause", spy)
    segsum.reset_launch_counts()
    final = diffusion_training.main(TINY + [
        "--data_dir", str(tmp_path / "dc"), "--train_dir",
        str(tmp_path / "runs"), "--train_steps", "12"])
    out = capsys.readouterr().out
    assert "flat backend: tiles for" in out and "hybrid dispatch" in out
    assert calls and min(calls) > 0
    assert tiled_ops.TILE_PRECISION == "default"
    assert np.isfinite(final["diag_loss"])
    assert segsum.LAUNCHES == {"lit_to_clause": 0, "clause_to_lit": 0}


@pytest.mark.parametrize("layout", ["dense", "flat"])
def test_training_script_trains_evals_checkpoints_and_exports(layout, tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(dense_ops, "INCIDENCE_PRECISION", "highest")
    argv = TINY + ["--data_dir", str(tmp_path / "dc"), "--train_dir",
                   str(tmp_path / "runs"), "--label", layout,
                   "--dense", "true" if layout == "dense" else "false"]
    segsum.reset_launch_counts()
    modes_seen = set()
    product = dense_ops._incidence_product

    def spy(*args, **kw):
        modes_seen.add(dense_ops.INCIDENCE_PRECISION)
        return product(*args, **kw)

    monkeypatch.setattr(dense_ops, "_incidence_product", spy)
    final = diffusion_training.main(argv)
    run_dir = Path(final["run_dir"])
    assert run_dir.parent == tmp_path / "runs"
    assert 0.0 <= final["total_accuracy"] <= 1.0
    assert np.isfinite(final["diag_loss"])
    assert len(final["round/logit_loss"]) == 2
    # on the CPU the wrapper runs the plain version: no kernel launch
    assert segsum.LAUNCHES == {"lit_to_clause": 0, "clause_to_lit": 0}
    # the script's default, bf16 operands, held for the run and no longer
    assert modes_seen == ({"default"} if layout == "dense" else set())
    assert dense_ops.INCIDENCE_PRECISION == "highest"

    cfg = json.loads((run_dir / "config.json").read_text())
    assert cfg["train_steps"] == 6 and cfg["dense"] == (layout == "dense")
    recs = [json.loads(line) for line in
            (run_dir / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "total_accuracy" in r] == [3, 6]
    train_recs = [r for r in recs if "steps_per_sec" in r]
    assert train_recs[-1]["step"] == 6 and np.isfinite(train_recs[-1]["loss"])
    assert sorted(p.name for p in (run_dir / "ckpt").iterdir()) == [
        "ckpt_4.npz", "ckpt_6.npz"]

    # the exported params: read by the TPU package's loader, equal to the
    # last checkpoint's
    jtree, meta = jckpt.load_params(run_dir / "params.npz")
    assert meta["step"] == 6 and meta["config"]["feature_maps"] == 16
    assert meta["config"]["block_bf16"] is True
    with np.load(run_dir / "ckpt" / "ckpt_6.npz") as z:
        np.testing.assert_array_equal(z["params/lit_mlp/w/0"],
                                      jtree["lit_mlp"]["w"][0])
        assert int(z["step"]) == 6 and int(z["count"]) == 6

    # a second run restores from that directory and has nothing left to do
    # but the final eval; a longer budget trains on from step 6
    more = [a for a in argv]
    more[more.index("--train_steps") + 1] = "8"
    final2 = diffusion_training.main(more + ["--restore",
                                             str(run_dir / "ckpt")])
    assert "ckpt_8.npz" in {p.name for p in (run_dir / "ckpt").iterdir()}
    recs2 = [json.loads(line) for line in (
        Path(final2["run_dir"]) / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs2 if "steps_per_sec" in r] == [8]

    # warm start from the exported file
    final3 = diffusion_training.main(
        argv + ["--init_npz", str(run_dir / "params.npz"),
                "--train_steps", "2"])
    assert np.isfinite(final3["diag_loss"])


def test_training_script_self_supervised_and_f32_blocks(tmp_path, monkeypatch):
    monkeypatch.setenv("DSAT_BLOCK_BF16", "0")
    monkeypatch.setattr(dense_ops, "INCIDENCE_PRECISION", "highest")
    final = diffusion_training.main(
        TINY + ["--data_dir", str(tmp_path / "dc"), "--train_dir",
                str(tmp_path / "runs"), "--self_supervised", "true",
                "--incidence_precision", "highest", "--train_steps", "3"])
    _, meta = tckpt.load_params(Path(final["run_dir"]) / "params.npz")
    assert meta["config"]["block_bf16"] is False and meta["step"] == 3


def test_training_script_flat_self_supervised_runs_with_plans(tmp_path,
                                                              monkeypatch):
    """The flat self-conditioning run hands every batch's plans to the
    model: no aggregation of the run takes the unplanned route."""
    from diffusionsat_torch.models import query_sat as tqs

    calls = {"planned": 0}
    planned = tqs.plan_lit_to_clause

    def counting(x, plans):
        calls["planned"] += 1
        return planned(x, plans)

    def unplanned(*args, **kw):
        raise AssertionError("a flat step ran without plans")

    monkeypatch.setattr(tqs, "plan_lit_to_clause", counting)
    monkeypatch.setattr(tqs, "lit_to_clause", unplanned)
    monkeypatch.setattr(tqs, "clause_to_lit", unplanned)
    final = diffusion_training.main(
        TINY + ["--data_dir", str(tmp_path / "dc"), "--train_dir",
                str(tmp_path / "runs"), "--dense", "false",
                "--self_supervised", "true", "--train_steps", "3"])
    assert np.isfinite(final["diag_loss"])
    # 3 steps of two 2-round passes, one aggregation of this kind a round
    assert calls["planned"] >= 3 * 2 * 2


def test_training_script_refuses_without_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        diffusion_training.main(["--data_dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())    # refused before any data work


def test_training_script_hybrid_dispatch_and_dense_fallback(tmp_path, monkeypatch,
                                                   capsys):
    """Batches over the size cutoff stay flat and train on the planned step
    beside the dense ones; when no batch fits, the script says so and takes
    the flat path."""
    monkeypatch.setattr(dense_ops, "INCIDENCE_PRECISION", "highest")
    argv = TINY + ["--data_dir", str(tmp_path / "dc"), "--train_dir",
                   str(tmp_path / "runs"), "--max_nodes_per_batch", "600",
                   "--max_vars", "10", "--train_steps", "4"]
    monkeypatch.setenv("DSAT_DENSE_MAX_VARS", "9")
    final = diffusion_training.main(argv)
    out = capsys.readouterr().out
    assert "hybrid dispatch:" in out and np.isfinite(final["diag_loss"])
    monkeypatch.setenv("DSAT_DENSE_MAX_VARS", "2")
    final = diffusion_training.main(argv)
    out = capsys.readouterr().out
    assert "dense layout unavailable (no batch fits the dense block " \
        "tables); flat path" in out
    assert np.isfinite(final["diag_loss"])


def test_warm_start_from_a_file_the_tpu_package_wrote(tmp_path, monkeypatch):
    """The repo's pretrained files list their modules sorted, not in the
    init's order; the optimizer state pairs leaves with params by position,
    so the warm params must take the init's order (before, the first step
    raised on a shape mismatch, or paired equal shapes wrongly)."""
    import jax

    from diffusionsat_tpu.models import query_sat as jqs

    monkeypatch.setattr(dense_ops, "INCIDENCE_PRECISION", "highest")
    jcfg = jqs.QuerySATConfig(feature_maps=16, query_maps=8, logit_maps=4)
    warm_file = tmp_path / "tpu.npz"
    jtree = jqs.query_sat_init(jax.random.key(3), jcfg)
    jckpt.export_params(dict(sorted(jtree.items())), warm_file)
    assert list(tckpt.load_params(
        "pretrained/query_sat_3sat_diffusion_mlk64_iso45.npz")[0]) == \
        sorted(jtree)
    warm, _ = tckpt.load_params(warm_file)
    from diffusionsat_torch.models import query_sat as tqs
    init = tqs.query_sat_init(torch.Generator().manual_seed(0),
                              tqs.QuerySATConfig(feature_maps=16,
                                                 query_maps=8, logit_maps=4))
    assert list(warm) != list(init)          # another module order
    final = diffusion_training.main(
        TINY + ["--data_dir", str(tmp_path / "dc"), "--train_dir",
                str(tmp_path / "runs"), "--init_npz", str(warm_file),
                "--train_steps", "2"])
    assert np.isfinite(final["diag_loss"])
    got, _ = tckpt.load_params(Path(final["run_dir"]) / "params.npz")
    for m in warm:   # two small steps away from the warm params
        for a, b in zip(got[m]["w"], warm[m]["w"]):
            assert np.abs(a - b).max() < 0.02, m
    reordered = tckpt.params_like(init, tckpt.params_from_numpy(warm, "cpu"))
    assert list(reordered) == list(init)
    with pytest.raises(ValueError, match="shape"):
        tckpt.params_like(init, {m: {k: [x[:1] for x in v]
                                     for k, v in mod.items()}
                                 for m, mod in reordered.items()})

"""The training path on the card: what the CPU tests cannot reach.

Needs an NVIDIA card and nvcc; skips elsewhere. This file imports no JAX, so
it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_train_cuda.py
"""

import numpy as np
import pytest
import torch

from diffusionsat_torch.graph import dense_batch as tdb
from diffusionsat_torch.graph.batch import (
    BucketSpec,
    attach_label_isolation,
    build_batch,
)
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.models.query_sat_dense import query_sat_dense_apply
from diffusionsat_torch.ops import segsum
from diffusionsat_torch.train.adabelief import adabelief
from diffusionsat_torch.train.checkpoint import CheckpointManager
from diffusionsat_torch.train.loop import (
    TrainState,
    make_diagnostics_step,
    make_planned_train_step,
    make_selfsupervised_train_step,
    make_train_step,
    make_train_step_for,
)

SMALL = dict(feature_maps=32, query_maps=16, logit_maps=4, train_rounds=3,
             test_rounds=3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bank_batch(K=4, n_formulas=12, seed=0):
    rng = np.random.default_rng(seed)
    formulas, banks = [], []
    for _ in range(n_formulas):
        n = int(rng.integers(5, 12))
        formulas.append((n, [
            [int(v) if rng.random() < 0.5 else -int(v)
             for v in rng.choice(n, size=3, replace=False) + 1]
            for _ in range(3 * n)]))
        banks.append(rng.integers(0, 2, size=(K, n)).tolist())
    return build_batch(formulas, BucketSpec(256, 512, 2048, 16),
                       solutions=banks)


def _state(cfg, dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    params = tqs.query_sat_init(g, cfg)
    opt = adabelief(learning_rate=1e-2)
    g2 = torch.Generator(device=dev)
    g2.manual_seed(seed + 1)
    return opt, TrainState(params=params, opt_state=opt.init(params), step=0,
                           generator=g2)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_flat_step_with_bank_and_isolation_runs_the_kernel(cuda, remat):
    cfg = tqs.QuerySATConfig(**SMALL, remat=remat, label_isolation_alpha=0.5)
    batch = attach_label_isolation(_bank_batch())
    plans = segsum.build_batch_plans(batch).to(cuda)
    opt, state = _state(cfg, cuda)
    step = make_planned_train_step(cfg, opt, cuda)
    segsum.reset_launch_counts()
    state, out = step(state, batch.to(cuda), plans)
    torch.cuda.synchronize()
    assert torch.isfinite(out["loss"]) and out["loss"].device.type == "cuda"
    assert torch.isfinite(out["gradnorm"]) and float(out["gradnorm"]) > 0
    # 2 + 2 launches a round forward, as many backward, and the recomputed
    # forward of a checkpointed round on top
    per_way = 4 * cfg.train_rounds
    want = per_way if remat == "none" else per_way + 2 * cfg.train_rounds
    assert segsum.LAUNCHES == {"lit_to_clause": want, "clause_to_lit": want}


@pytest.mark.cuda
@pytest.mark.parametrize("plans_given", [True, False])
@pytest.mark.parametrize("kind", ["train", "selfsup", "diagnostics"])
def test_every_flat_step_runs_the_kernel_forward_and_backward(cuda, kind,
                                                             plans_given):
    """No flat step takes the plain aggregations on the card: with the
    batch's plans or with a bare batch (plans built in the call), each pass
    launches the kernel 2 + 2 times a round forward and as often backward.
    The self-supervised step makes two passes."""
    cfg = tqs.QuerySATConfig(**SMALL)
    batch = _bank_batch()
    plans = segsum.build_batch_plans(batch).to(cuda) if plans_given else None
    opt, state = _state(cfg, cuda)
    batch = batch.to(cuda)
    segsum.reset_launch_counts()
    if kind == "train":
        _, out = make_train_step(cfg, opt, cuda)(state, batch, plans)
        loss, passes = out["loss"], 1
    elif kind == "selfsup":
        step = make_selfsupervised_train_step(cfg, opt, device=cuda)
        _, out = step(state, batch, plans)
        loss, passes = out["loss"], 2
    else:
        out = make_diagnostics_step(cfg, device=cuda)(
            state.params, batch, state.generator, plans=plans)
        loss, passes = torch.tensor(out["diag_loss"]), 1
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    want = passes * 4 * cfg.train_rounds
    assert segsum.LAUNCHES == {"lit_to_clause": want, "clause_to_lit": want}


@pytest.mark.cuda
def test_flat_self_supervised_training_script_runs_the_kernel(cuda, tmp_path):
    from diffusionsat_torch import diffusion_training

    steps, rounds = 3, 2
    segsum.reset_launch_counts()
    final = diffusion_training.main([
        "--dense", "false", "--self_supervised", "true", "--train_steps",
        str(steps), "--train_size", "60", "--test_size", "20",
        "--train_rounds", str(rounds), "--test_rounds", "2",
        "--feature_maps", "16", "--query_maps", "8", "--logit_maps", "4",
        "--eval_every", "100", "--ckpt_every", "100", "--gen_workers", "1",
        "--max_nodes_per_batch", "1500", "--data_dir", str(tmp_path / "dc"),
        "--train_dir", str(tmp_path / "runs")])
    assert np.isfinite(final["diag_loss"])
    # the steps alone: two passes of 2 + 2 launches a round each way; the
    # final eval and diagnostics add theirs
    assert min(segsum.LAUNCHES.values()) >= steps * 2 * 4 * rounds


@pytest.mark.cuda
@pytest.mark.parametrize("block_bf16", [False, True])
def test_dense_remat_equals_none_on_the_card(cuda, block_bf16):
    """The dense path has no atomics, so a recomputed round gives the same
    gradients, and so the same params, bit for bit."""
    flat = _bank_batch()
    dense = tdb.dense_from_flat(flat, *tdb.dense_dims_for([flat])).to(cuda)
    new_params = {}
    for remat in ("none", "full", "dots"):
        cfg = tqs.QuerySATConfig(**SMALL, remat=remat, block_bf16=block_bf16)
        opt, state = _state(cfg, cuda)
        step = make_train_step_for(query_sat_dense_apply, cfg, opt, cuda)
        for _ in range(2):
            state, out = step(state, dense)
        new_params[remat] = [p for m in state.params.values()
                             for k in ("w", "b") for p in m[k]]
    for remat in ("full", "dots"):
        for a, b in zip(new_params[remat], new_params["none"]):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_restored_run_continues_bit_for_bit_on_the_card(cuda, tmp_path):
    cfg = tqs.QuerySATConfig(**SMALL, block_bf16=True)
    flat = _bank_batch()
    dense = tdb.dense_from_flat(flat, *tdb.dense_dims_for([flat])).to(cuda)
    opt, state = _state(cfg, cuda)
    step = make_train_step_for(query_sat_dense_apply, cfg, opt, cuda)
    for _ in range(3):
        state, _ = step(state, dense)
    mgr = CheckpointManager(tmp_path)
    mgr.save(state)
    losses = []
    for _ in range(3):
        state, out = step(state, dense)
        losses.append(float(out["loss"]))
    _, template = _state(cfg, cuda, seed=7)
    restored = mgr.restore(template)
    assert restored.step == 3
    assert restored.opt_state.count.device.type == "cuda"
    again = []
    for _ in range(3):
        restored, out = step(restored, dense)
        again.append(float(out["loss"]))
    assert again == losses
    for a, b in zip(restored.params["clause_mlp"]["w"],
                    state.params["clause_mlp"]["w"]):
        assert torch.equal(a, b)

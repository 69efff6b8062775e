"""Training with label banks and a measured logit table, port vs TPU package.

One train step on a K-row bank whose selection logits are composed from
isolation (alpha 0.45) and a frequency table gives the TPU package's new
params: its key schedule is replayed, the label-row draw included (Gumbel
draw from the key the step splits off for it). The training script runs end
to end with a table measured by the port's own `measure_bank_freq`.
"""

import functools
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import batch_pair, random_formulas, torch_params
from diffusionsat_tpu.diffusion.schedule import construct_training_input
from diffusionsat_tpu.graph import dense_batch as jdb
from diffusionsat_tpu.models import query_sat as jqs
from diffusionsat_tpu.models.query_sat_dense import (
    query_sat_dense_apply as jdense,
)
from diffusionsat_tpu.ops import pallas_segsum as jseg
from diffusionsat_tpu.uniformity import reweight as jrw
from diffusionsat_torch import diffusion_training, measure_bank_freq
from diffusionsat_torch.graph import dense_batch as tdb
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.models.query_sat_dense import (
    query_sat_dense_apply as tdense,
)
from diffusionsat_torch.ops import dense_ops
from diffusionsat_torch.ops.segsum import build_batch_plans
from diffusionsat_torch.train.checkpoint import export_params, params_to_numpy
from diffusionsat_torch.uniformity import reweight as trw

jab = importlib.import_module("diffusionsat_tpu.train.adabelief")
tab = importlib.import_module("diffusionsat_torch.train.adabelief")
jloop = importlib.import_module("diffusionsat_tpu.train.loop")
tloop = importlib.import_module("diffusionsat_torch.train.loop")

K = 6
# the step reads the composed logits with isolation_alpha = 1.0, as the
# training script sets it once a table is attached
SMALL = dict(feature_maps=16, query_maps=8, logit_maps=4, train_rounds=3,
             test_rounds=3, debug_zero_noise=True, label_isolation_alpha=1.0)


def _weighted_pair(seed=1):
    """A flat batch pair with a K-row bank, composed logits attached from a
    table over it (iso_alpha 0.45, beta 1)."""
    formulas, _ = random_formulas(seed, n_formulas=5)
    rng = np.random.default_rng(seed)
    banks = [rng.integers(0, 2, size=(3, n))[rng.integers(0, 3, size=K)]
             .tolist() for n, _ in formulas]
    jb, tb = batch_pair(formulas, banks)
    counts = rng.integers(0, 20, size=(K, int(tb.n_graphs)))
    table = {"neglog_0": trw.finalize_counts(tb, counts),
             "fingerprint_0": np.str_(trw.batch_fingerprint(tb)),
             "content_fingerprint_0": np.str_(trw.content_fingerprint(tb))}
    jbs, tbs = [jb], [tb]
    assert jrw.attach_logit_table(jbs, table, 0.45, 1.0) == 1
    assert trw.attach_logit_table(tbs, table, 0.45, 1.0) == 1
    return jbs[0], tbs[0]


@pytest.mark.parametrize("layout", ["flat_plans", "dense"])
def test_step_with_bank_and_table_gives_the_tpu_packages_params(
        layout, monkeypatch):
    jcfg, tcfg = jqs.QuerySATConfig(**SMALL), tqs.QuerySATConfig(**SMALL)
    jparams = jqs.query_sat_init(jax.random.key(0), jcfg)
    jb, tb = _weighted_pair()
    if layout == "dense":
        dims = jdb.dense_dims_for([jb])
        jb, tb = jdb.dense_from_flat(jb, *dims), tdb.dense_from_flat(tb,
                                                                     *dims)
    lr = dict(initial_lr=1e-2, decay_steps=100, alpha=0.5)
    jopt = jab.adabelief(jab.cosine_decay_schedule(**lr))
    topt = tab.adabelief(learning_rate=tab.cosine_decay_schedule(**lr))
    key = jax.random.key(7)
    jstate = jloop.TrainState(params=jparams, opt_state=jopt.init(jparams),
                              step=jnp.zeros((), jnp.int32), key=key)
    if layout == "dense":
        jnew, jout = jloop.make_train_step_for(jdense, jcfg, jopt)(jstate, jb)
    else:
        jnew, jout = jloop.make_planned_train_step(jcfg, jopt)(
            jstate, jb, jseg.build_batch_plans(jb, tile_edges=64, window=32))

    # the TPU package's draws of this step: the label row from the key
    # split off for it, then the noise level and noisy input of the model
    _, subkey, k_label = jax.random.split(key, 3)
    G = jb.graph_mask.shape[0]
    gum = jax.random.gumbel(k_label, (K, G))
    kg = np.asarray(jnp.argmax(jb.label_isolation_k + gum, axis=0))
    if layout != "dense":        # the padding segment's extra entry
        kg = np.concatenate([kg, np.zeros(1, kg.dtype)])
    labels = jloop._select_labels(jb, k_label, isolation_alpha=1.0)
    k_noise, _, k_input, _ = jax.random.split(subkey, 4)
    ns = jax.random.uniform(k_noise, ())
    noisy = construct_training_input(k_input, labels, ns)
    inject = dict(noise_scale=float(ns),
                  noisy_num=torch.from_numpy(np.array(noisy)))
    drawn = []

    def replayed(batch, generator, isolation_alpha=0.0):
        drawn.append(isolation_alpha)
        return torch.from_numpy(kg.astype(np.int64))

    monkeypatch.setattr(tloop, "draw_label_rows", replayed)
    tparams = torch_params(jparams)
    tstate = tloop.TrainState(params=tparams, opt_state=topt.init(tparams),
                              step=0, generator=torch.Generator())
    if layout == "dense":
        tnew, tout = tloop.make_train_step_for(
            functools.partial(tdense, **inject), tcfg, topt, "cpu")(
            tstate, tb)
    else:
        tnew, tout = tloop.make_planned_train_step_for(
            functools.partial(tqs.query_sat_apply, **inject), tcfg, topt,
            device="cpu")(tstate, tb, build_batch_plans(tb))
    assert drawn == [1.0]
    np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]),
                               rtol=1e-5)
    old = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    got = jax.tree.leaves(params_to_numpy(tnew.params))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jnew.params))
    moved = max(float(np.abs(w - o).max()) for o, w in zip(old, want))
    assert moved > 1e-5
    for o, g, w in zip(old, got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(g - o, w - o, rtol=0, atol=1e-3 * moved)


def test_training_script_with_bank_and_measured_table(tmp_path, monkeypatch,
                                                      capsys):
    """`--label_samples 4 --label_isolation_alpha 0.45 --label_logit_table`
    on the CPU, with the table from the port's own measurement of the same
    cache."""
    monkeypatch.setattr(dense_ops, "INCIDENCE_PRECISION", "highest")
    cfg = tqs.QuerySATConfig(feature_maps=16, query_maps=8, logit_maps=4)
    ckpt = tmp_path / "tiny.npz"
    export_params(tqs.query_sat_init(torch.Generator().manual_seed(0), cfg),
                  ckpt, meta={"model": "query_sat", "config": {
                      "feature_maps": 16, "query_maps": 8,
                      "logit_maps": 4}})
    data = ["--train_size", "12", "--label_samples", "4", "--data_dir",
            str(tmp_path / "dc")]
    table = tmp_path / "freq.npz"
    measure_bank_freq.main(data + [
        "--model_ckpt", str(ckpt), "--chains", "2", "--diffusion_steps", "2",
        "--test_rounds", "2", "--gen_workers", "1", "--device", "cpu",
        "--out", str(table)])
    argv = data + ["--train_steps", "3", "--test_size", "8",
                   "--train_rounds", "2", "--test_rounds", "2",
                   "--feature_maps", "16", "--query_maps", "8",
                   "--logit_maps", "4", "--device", "cpu", "--eval_every",
                   "3", "--ckpt_every", "3", "--gen_workers", "1",
                   "--train_dir", str(tmp_path / "runs"),
                   "--label_isolation_alpha", "0.45"]
    final = diffusion_training.main(argv + ["--label_logit_table",
                                            str(table)])
    assert "label logits attached: 1/1 batches measured" in \
        capsys.readouterr().out
    assert np.isfinite(final["diag_loss"])
    run_dir = Path(final["run_dir"])
    recs = [json.loads(line) for line in
            (run_dir / "train_log.jsonl").read_text().splitlines()]
    assert np.isfinite([r["loss"] for r in recs if "loss" in r]).all()
    with np.load(run_dir / "params.npz") as z:
        meta = json.loads(str(z["__meta__"]))
    # the composed logits are read with isolation_alpha = 1.0
    assert meta["config"]["label_isolation_alpha"] == 1.0
    # a table without a bank, or measured on another cache, is refused
    bankless = list(argv)
    bankless[bankless.index("--label_samples") + 1] = "1"
    with pytest.raises(SystemExit, match="multi-label bank"):
        diffusion_training.main(bankless + ["--label_logit_table",
                                            str(table)])
    with np.load(table) as z:
        wrong = dict(z, content_fingerprint_0=np.str_("0" * 16))
    np.savez(tmp_path / "wrong.npz", **wrong)
    with pytest.raises(ValueError, match="content_fingerprint mismatch"):
        diffusion_training.main(argv + ["--label_logit_table",
                                        str(tmp_path / "wrong.npz")])

"""The bank-frequency measurement: its counting body against the TPU
package's, and the script end to end on the CPU with a tiny cache."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import batch_pair, np_of, random_formulas
from diffusionsat_tpu.data import datasets as jds
from diffusionsat_tpu.graph import dense_batch as jdb
from diffusionsat_tpu.uniformity import reweight as jrw
from diffusionsat_torch import measure_bank_freq as mbf
from diffusionsat_torch.graph import dense_batch as tdb
from diffusionsat_torch.models.query_sat import (
    QuerySATConfig,
    query_sat_init,
)
from diffusionsat_torch.train.checkpoint import export_params

K = 5


def _tpu_measure_body(bits, solved, batch):
    """The body of the TPU package's `measure_chunk`
    (`measure_bank_freq.py:102-110`) for one chain."""
    sk = batch.solutions_k
    vmask = batch.var_mask[None] < 0.5
    gmask = batch.graph_mask > 0.5
    eq = (bits[None] == sk) | vmask
    match = eq.all(-1) & gmask[None]
    srow = (solved > 0.5) & gmask
    return (match.astype(jnp.int32), srow.astype(jnp.int32),
            (srow & ~match.any(0)).astype(jnp.int32))


@pytest.mark.parametrize("seed", range(3))
def test_counting_body_equals_the_tpu_packages(seed):
    rng = np.random.default_rng(seed)
    formulas, _ = random_formulas(seed, n_formulas=5)
    banks = [rng.integers(0, 2, size=(K, n)).tolist() for n, _ in formulas]
    jflat, tflat = batch_pair(formulas, banks)
    dims = jdb.dense_dims_for([jflat])
    jd, td = jdb.dense_from_flat(jflat, *dims), tdb.dense_from_flat(tflat,
                                                                    *dims)
    sk = np.asarray(jd.solutions_k)
    G, Vg = jd.G, jd.Vg
    # every graph gets a bank row, a row with one bit flipped, or noise;
    # padded variables hold junk that the mask must ignore
    bits = rng.integers(0, 2, size=(G, Vg)).astype(np.int32)
    for g, (n, _) in enumerate(formulas):
        kind = g % 3
        if kind < 2:
            bits[g, :n] = sk[rng.integers(0, K), g, :n]
            if kind == 1:
                bits[g, 0] ^= 1
    solved = rng.integers(0, 2, size=G).astype(np.float32)
    want = _tpu_measure_body(jnp.asarray(bits), jnp.asarray(solved), jd)
    got = mbf.count_chain(torch.from_numpy(bits), torch.from_numpy(solved),
                          td)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.int32
        np.testing.assert_array_equal(np_of(g_), np.asarray(w_))
    assert int(got[0].sum()) >= 2      # some rows matched


def test_chain_generators_are_seeded_per_batch_and_chain():
    draws = {(b, c): torch.rand(4, generator=mbf.chain_generator(
        0, b, c, torch.device("cpu"))) for b in range(2) for c in range(2)}
    assert len({tuple(v.tolist()) for v in draws.values()}) == 4
    again = torch.rand(4, generator=mbf.chain_generator(
        0, 1, 0, torch.device("cpu")))
    assert torch.equal(again, draws[(1, 0)])


def test_script_end_to_end_and_resume_refuses_other_settings(tmp_path,
                                                             capsys):
    cfg = QuerySATConfig(feature_maps=16, query_maps=16, logit_maps=4)
    ckpt = tmp_path / "tiny.npz"
    export_params(query_sat_init(torch.Generator().manual_seed(0), cfg),
                  ckpt, meta={"model": "query_sat", "config": {
                      "feature_maps": 16, "query_maps": 16,
                      "logit_maps": 4}})
    out = tmp_path / "freq.npz"
    argv = ["--model_ckpt", str(ckpt), "--chains", "2", "--chunk", "1",
            "--diffusion_steps", "2", "--test_rounds", "2", "--train_size",
            "12", "--label_samples", str(K), "--max_batches", "1",
            "--data_dir", str(tmp_path / "dc"), "--gen_workers", "1",
            "--device", "cpu", "--out", str(out)]
    agg = mbf.main(argv)
    assert agg["batches"] == 1 and agg["graphs"] == 12
    assert agg["samples"] == 24 and 0 <= agg["sat"] <= 24
    assert "FREQ_MEASURE" in capsys.readouterr().out
    with np.load(out) as z:
        table = dict(z)
    tpu_keys = {f"{k}_0" for k in ("counts", "sat", "outside",
                                   "fingerprint", "neglog")} | {
        "n_chains", "n_batches", "model_ckpt"}
    assert set(table) == tpu_keys | {"content_fingerprint_0"}
    assert table["counts_0"].shape == (K, 12)
    assert table["counts_0"].dtype == np.int32
    assert table["neglog_0"].dtype == np.float32
    assert int(table["n_chains"]) == 2
    assert (table["counts_0"] <= 2).all() and (table["sat_0"] <= 2).all()

    # the TPU package attaches the port's table to its own read of the
    # port's cache
    (cache,) = (tmp_path / "dc").glob("*_k5_train_*.npz")
    jbatches = jds._load_batches(cache)
    assert jrw.attach_logit_table(jbatches, table, 0.45, 1.0) == 1

    # a resume with the same settings reuses the part
    again = mbf.main(argv)
    assert again == dict(agg, wall_s=again["wall_s"])
    # a resume with other settings refuses it
    for flag, value in (("--chains", "3"), ("--test_rounds", "3"),
                        ("--seed", "1")):
        with pytest.raises(SystemExit, match=flag.lstrip("-")):
            mbf.main(_with(argv, flag, value))
    with pytest.raises(SystemExit, match="label_samples"):
        mbf.main(_with(argv, "--label_samples", "1"))


def _with(argv, flag, value):
    """`argv` with `flag` set to `value`."""
    if flag not in argv:
        return argv + [flag, value]
    out = list(argv)
    out[out.index(flag) + 1] = value
    return out

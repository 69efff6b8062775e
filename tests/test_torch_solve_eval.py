"""Port vs TPU package: the solving eval (`train/metrics.py`, the predict
step and `evaluate_metrics` of `train/loop.py`, and the CLI).

Metrics get the same predictions in both packages. The predict step gets
every draw of the TPU package's key schedule injected, one set per try, and
must return the same prediction to 1e-4 (three recurrent rounds). The flat
and the dense layout of the port must give the same metrics on the same
split when their inputs are the same numbers mapped through the layouts.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (
    batch_pair,
    dense_vars_from_flat,
    np_of,
    random_formulas,
    torch_params,
)
from diffusionsat_tpu.diffusion.schedule import construct_training_input
from diffusionsat_tpu.models import query_sat as jqs
from diffusionsat_tpu.sat.solvers import solve
from diffusionsat_tpu.train import loop as jloop
from diffusionsat_tpu.train import metrics as jmet
from diffusionsat_tpu.train.checkpoint import load_params
from diffusionsat_torch import solve_eval
from diffusionsat_torch.graph.dense_batch import (
    DenseSatBatch,
    densify_batches_quantized,
)
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.models.query_sat_dense import query_sat_dense_apply
from diffusionsat_torch.ops import segsum
from diffusionsat_torch.train import loop as tloop
from diffusionsat_torch.train import metrics as tmet

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(feature_maps=16, query_maps=8, logit_maps=4, test_rounds=3)
MLK64 = "pretrained/query_sat_3sat_diffusion_mlk64.npz"


def _solved_formulas(seed, n_formulas=5):
    formulas, _ = random_formulas(seed, n_formulas=n_formulas,
                                  clause_ratio=2)
    sols = []
    for n, clauses in formulas:
        ok, model = solve(clauses, n)
        assert ok
        sols.append([1 if v > 0 else 0 for v in model])
    return formulas, sols


def _half_right_predictions(tb, seed):
    """Logits that solve some graphs and miss others."""
    rng = np.random.default_rng(seed)
    sol = np_of(tb.solutions) * 2.0 - 1.0
    wrong = np_of(tb.var_graph) % 2 == 1          # odd graphs: flip a few
    flip = np.where(wrong & (rng.random(tb.V) < 0.4), -1.0, 1.0)
    return (sol * flip * rng.uniform(0.5, 3.0, tb.V)).astype(np.float32)


def test_metrics_equal_on_the_same_predictions():
    jb, tb = batch_pair(*_solved_formulas(0))
    (td,) = densify_batches_quantized([tb])
    pred = _half_right_predictions(tb, 1)
    jacc, jsolved = jmet.sat_accuracy(jnp.asarray(pred), jb)
    for batch, p in ((tb, pred), (tb, pred[:, None]),
                     (td, dense_vars_from_flat(pred, tb, td))):
        acc, solved = tmet.sat_accuracy(torch.from_numpy(p), batch)
        assert acc == pytest.approx(jacc, abs=1e-7)
        np.testing.assert_array_equal(solved, jsolved)
    assert 0 < jsolved.sum() < len(jsolved)

    jm, tm, dm = jmet.SATAccuracy(), tmet.SATAccuracy(), tmet.SATAccuracy()
    js, ts = jmet.StepStatistics(), tmet.StepStatistics()
    for seed, steps in ((2, 3), (3, 63), (4, 9)):
        pred = _half_right_predictions(tb, seed)
        jm.update_state({"prediction": jnp.asarray(pred)}, jb)
        tm.update_state({"prediction": torch.from_numpy(pred)}, tb)
        dm.update_state({"prediction": torch.from_numpy(
            dense_vars_from_flat(pred, tb, td))}, td)
        js.update_state({"steps_taken": jnp.int32(steps)}, jb)
        ts.update_state({"steps_taken": torch.tensor(steps)}, tb)
    want = jm.get_values()
    for m in (tm, dm):
        got = m.get_values()
        assert got == pytest.approx(want, abs=1e-7) and set(got) == set(want)
        assert m.get_values() == {"accuracy": 0.0, "total_accuracy": 0.0}
    assert ts.get_values() == js.get_values() == {"mean_steps": 26,
                                                  "median_steps": 10}


def test_metric_sinks(tmp_path, capsys):
    _, tb = batch_pair(*_solved_formulas(0))
    m = tmet.SATAccuracy()
    m.update_state({"prediction": torch.from_numpy(
        _half_right_predictions(tb, 1))}, tb)
    m.log_in_stdout(step=7, reset_state=False)
    assert capsys.readouterr().out.startswith("[step 7] accuracy=")
    m.log_in_file(str(tmp_path / "log.jsonl"), step=7)
    rec = json.loads((tmp_path / "log.jsonl").read_text())
    assert rec["step"] == 7 and 0 < rec["total_accuracy"] < 1


def _replay_try(key, V, rounds):
    """The draws of one `query_sat_apply` call at noise 1.0 from `key`."""
    _, k_labels, k_input, key_loop = jax.random.split(key, 4)
    labels = jax.random.randint(k_labels, (V,), 0, 2, dtype=jnp.int32)
    noisy = construct_training_input(k_input, labels, jnp.float32(1.0))
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key_loop, r), (V, 4), jnp.float32))
        for r in range(rounds)])
    return dict(labels=torch.from_numpy(np.array(labels)),
                noisy_num=torch.from_numpy(np.array(noisy)),
                round_noise=torch.from_numpy(noise))


@pytest.mark.parametrize("tries", [1, 3])
def test_predict_step_matches_with_draws_pinned(tries):
    jcfg, tcfg = jqs.QuerySATConfig(**SMALL), tqs.QuerySATConfig(**SMALL)
    jparams = jqs.query_sat_init(jax.random.key(0), jcfg)
    jb, tb = batch_pair(*_solved_formulas(5, n_formulas=4))
    key = jax.random.key(11)
    want = jloop.make_predict_step(jcfg, prediction_tries=tries,
                                   noise_scale=1.0)(jparams, jb, key)
    if tries == 1:
        keys = [key]
    else:
        keys = []
        for _ in range(tries):
            key, sub = jax.random.split(key)
            keys.append(sub)
    draws = [_replay_try(k, jb.V, SMALL["test_rounds"]) for k in keys]
    segsum.reset_launch_counts()
    got = tloop.make_predict_step(
        tcfg, prediction_tries=tries, noise_scale=1.0, device="cpu")(
            torch_params(jparams), tb, None, draws=draws)
    assert tuple(got["prediction"].shape) == (tb.V,)
    np.testing.assert_allclose(np_of(got["prediction"]),
                               np.asarray(want["prediction"]), **TOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               **TOL)
    assert int(got["steps_taken"]) == int(want["steps_taken"])
    assert sum(segsum.LAUNCHES.values()) == 0     # CPU: the plain version
    with pytest.raises(ValueError, match="sets of draws"):
        tloop.make_predict_step(tcfg, prediction_tries=tries + 1,
                                device="cpu")(torch_params(jparams), tb,
                                              None, draws=draws)


def test_multi_try_keeps_the_first_solving_try():
    """Tries that solve different graphs: each graph keeps the logits of
    the first try that solved it, unsolved graphs the last try's."""
    # unit clauses: each formula has one model, so a flipped assignment
    # fails it
    formulas = [(3, [[1], [2], [3]]), (2, [[1], [-2]]),
                (4, [[-1], [2], [3], [4]])]
    _, tb = batch_pair(formulas, [[1, 1, 1], [1, 0], [0, 1, 1, 1]])
    (td,) = densify_batches_quantized([tb])
    sol = np_of(tb.solutions) * 2.0 - 1.0
    g = np_of(tb.var_graph)
    # try 0 solves graph 0, try 1 graphs 0 and 1, nobody graph 2
    tries = [np.where(g == 0, 1, -1) * sol * 1.0,
             np.where(g <= 1, 1, -1) * sol * 2.0,
             -sol * 3.0]
    want = np.where(g == 0, tries[0], np.where(g == 1, tries[1], tries[2]))
    want = np.where(g < 3, want, 0.0)

    for batch, conv in ((tb, lambda x: x),
                        (td, lambda x: dense_vars_from_flat(x, tb, td))):
        calls = iter(tries)

        def fake_apply(params, cfg, b, generator, training, device):
            logits = torch.from_numpy(conv(next(calls).astype(np.float32)))
            return logits[..., None], torch.zeros(()), torch.tensor(2), {}

        out = tloop.make_predict_step(None, fake_apply, prediction_tries=3,
                                      device="cpu")(None, batch, None)
        mask = np_of(batch.var_mask)
        np.testing.assert_array_equal(np_of(out["prediction"]) * mask,
                                      conv(want.astype(np.float32)))


@pytest.fixture(scope="module")
def split40(tmp_path_factory):
    data_dir = tmp_path_factory.mktemp("cache")
    ds = solve_eval.build_dataset(100, 40, 3, 12, seed=2, data_dir=data_dir,
                                  gen_workers=1)
    return data_dir, list(ds.test_data())


def test_evaluate_metrics_flat_equals_dense(split40):
    """Both layouts see each graph's true solution at low noise and no
    exploration noise, so they are the same computation; the flagship then
    solves the split in both."""
    _, batches = split40
    assert sum(int(b.n_graphs) for b in batches) == 40
    tree, meta = load_params(MLK64)
    params = torch_params(tree)
    cfg = tqs.QuerySATConfig.from_meta(meta["config"], debug_zero_noise=True,
                                       test_rounds=6)

    def hinted(apply_fn):
        def apply(params, cfg, batch, generator, training, **kw):
            onehot = torch.nn.functional.one_hot(batch.solutions.long(), 2)
            return apply_fn(params, cfg, batch, generator, training,
                            labels=batch.solutions,
                            noisy_num=onehot.to(torch.float32), **kw)
        return apply

    common = dict(noise_scale=0.1, device="cpu")
    metrics = lambda: [tmet.SATAccuracy(), tmet.StepStatistics()]  # noqa
    flat = tloop.evaluate_metrics(
        params, cfg, tloop.plan_batches(batches, "cpu"), metrics(), None,
        apply_fn=hinted(tqs.query_sat_apply), **common)
    dense_batches = densify_batches_quantized(batches)
    assert all(isinstance(b, DenseSatBatch) for b in dense_batches)
    dense = tloop.evaluate_metrics(
        params, cfg, dense_batches, metrics(), None,
        apply_fn=hinted(query_sat_dense_apply), **common)
    assert flat == pytest.approx(dense, abs=1e-6)
    assert flat["total_accuracy"] == 1.0 and flat["mean_steps"] < 6
    one = tloop.evaluate_metrics(
        params, cfg, batches, metrics(), None, max_batches=1,
        apply_fn=hinted(tqs.query_sat_apply), **common)
    assert one["total_accuracy"] == 1.0


@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_cli_runs_on_cpu(split40, layout, tmp_path, capsys):
    data_dir, batches = split40
    out = tmp_path / "eval.json"
    res = solve_eval.main([
        "--model_ckpt", MLK64, "--train_size", "100", "--test_size", "40",
        "--max_vars", "12", "--seed", "2", "--test_rounds", "8", "--tries",
        "2", "--layout", layout, "--device", "cpu", "--data_dir",
        str(data_dir), "--gen_workers", "1", "--out", str(out)])
    printed = capsys.readouterr().out
    assert f"test batches: {len(batches)}" in printed
    assert json.loads(out.read_text()) == res
    with open("SOLVE_EVAL_MLK64.json") as f:
        record = json.load(f)
    assert set(record) <= set(res)
    assert (res["noise"], res["test_rounds"], res["tries"]) == (1.0, 8, 2)
    assert res["n_test_batches"] == len(batches) and res["layout"] == layout
    assert res["mean_steps"] == 8 and 0.3 < res["total_accuracy"] <= 1.0
    assert 0.5 < res["accuracy"] <= 1.0


def test_cli_refuses_unported_cache_variant(capsys):
    # every bank size K >= 1 names a cache; nothing else does
    with pytest.raises(SystemExit):
        solve_eval.main(["--model_ckpt", MLK64, "--label_samples", "0",
                         "--device", "cpu"])
    assert "--label_samples must be at least 1" in capsys.readouterr().err

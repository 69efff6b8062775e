"""Many train steps per call: the scanned step, `stack_batches`, the
drivers' chunking and the step accounting of `train`.

On the CPU the port's scanned step runs its N eager steps one after the
other (the plain version of the CUDA graph the card replays). It is held
bit for bit against N calls of the eager step, and against the TPU
package's `lax.scan` step with the TPU package's draws replayed, to that
package's own mega-step tolerances (losses rtol 1e-5, params atol 1e-6,
`tests/test_mega_step.py`).
"""

import dataclasses
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import batch_pair, np_of, random_formulas, torch_params
from diffusionsat_tpu.diffusion.schedule import construct_training_input
from diffusionsat_tpu.graph import dense_batch as jdb
from diffusionsat_tpu.models import query_sat as jqs
from diffusionsat_tpu.models.query_sat_dense import (
    query_sat_dense_apply as jdense,
)
from diffusionsat_torch import diffusion_training
from diffusionsat_torch.graph import dense_batch as tdb
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.models.anf_sat import (
    ANFSATConfig,
    anf_sat_apply,
    anf_sat_init,
)
from diffusionsat_torch.models.query_sat_dense import (
    query_sat_dense_apply as tdense,
)

jab = importlib.import_module("diffusionsat_tpu.train.adabelief")
jloop = importlib.import_module("diffusionsat_tpu.train.loop")
tab = importlib.import_module("diffusionsat_torch.train.adabelief")
tloop = importlib.import_module("diffusionsat_torch.train.loop")

SMALL = dict(feature_maps=16, query_maps=8, logit_maps=4, train_rounds=2,
             test_rounds=2)
DIMS = (8, 12, 40)   # G, Vg, Cg of every test chunk


def _batch_pairs(n, seed=0, bank=False):
    """n (TPU-package, port) dense batch pairs of one block shape."""
    out = []
    for i in range(n):
        formulas, sols = random_formulas(seed + i, n_formulas=4, lo=4,
                                         hi=10)
        if bank:
            rng = np.random.default_rng(seed + i)
            sols = [rng.integers(0, 2, size=(4, f[0])).tolist()
                    for f in formulas]
        jb, tb = batch_pair(formulas, sols)
        out.append((jdb.dense_from_flat(jb, *DIMS),
                    tdb.dense_from_flat(tb, *DIMS)))
    return out


def _state(cfg, opt, seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    params = tqs.query_sat_init(g, cfg)
    gen = torch.Generator()
    gen.manual_seed(seed + 1)
    return tloop.TrainState(params=params, opt_state=opt.init(params),
                            step=0, generator=gen)


def _leaves(state):
    return [t.clone() for t in jax.tree.leaves((state.params,
                                                state.opt_state))]


@pytest.mark.parametrize("kind", ["f32", "block_bf16", "bank_isolation"])
def test_scanned_step_equals_n_eager_steps(kind):
    cfg = tqs.QuerySATConfig(
        **SMALL, block_bf16=kind == "block_bf16",
        label_isolation_alpha=0.45 if kind == "bank_isolation" else 0.0)
    opt = tab.adabelief(learning_rate=1e-2)
    batches = [t for _, t in _batch_pairs(3, bank=kind == "bank_isolation")]
    if kind == "bank_isolation":
        assert batches[0].solutions_k is not None
        iso = torch.rand((4, DIMS[0]), generator=torch.Generator()
                         .manual_seed(5))
        batches = [dataclasses.replace(b, label_isolation_k=iso)
                   for b in batches]

    step = tloop.make_train_step_for(tdense, cfg, opt, "cpu")
    a = _state(cfg, opt)
    losses = []
    for b in batches:
        a, out = step(a, b)
        losses.append(float(out["loss"]))

    mega = tloop.make_scanned_train_step_for(tdense, cfg, opt, "cpu")
    b0 = _state(cfg, opt)
    b1, mout = mega(b0, tloop.stack_batches(batches))
    assert b1.step == a.step == 3
    assert mout["loss_per_step"].tolist() == losses
    assert float(mout["loss"]) == float(torch.tensor(losses).mean())
    assert int(mout["steps_taken"]) == int(out["steps_taken"])
    for x, y in zip(_leaves(a), _leaves(b1), strict=True):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b1.generator.get_state())


def test_scanned_step_cut_to_max_steps():
    cfg = tqs.QuerySATConfig(**SMALL)
    opt = tab.adabelief(learning_rate=1e-2)
    batches = [t for _, t in _batch_pairs(3)]
    mega = tloop.make_scanned_train_step_for(tdense, cfg, opt, "cpu")
    full, _ = mega(_state(cfg, opt), tloop.stack_batches(batches[:2]))
    cut, out = mega(_state(cfg, opt), tloop.stack_batches(batches),
                    max_steps=2)
    assert cut.step == full.step == 2 and out["loss_per_step"].shape == (2,)
    for x, y in zip(_leaves(full), _leaves(cut), strict=True):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        mega(_state(cfg, opt), tloop.stack_batches(batches), max_steps=0)


def test_scanned_step_matches_the_tpu_packages():
    pairs = _batch_pairs(3, seed=4)
    kw = dict(SMALL, debug_zero_noise=True)
    jcfg, tcfg = jqs.QuerySATConfig(**kw), tqs.QuerySATConfig(**kw)
    jparams = jqs.query_sat_init(jax.random.key(0), jcfg)
    lr = dict(initial_lr=1e-2, decay_steps=100, alpha=0.5)
    jopt = jab.adabelief(jab.cosine_decay_schedule(**lr))
    topt = tab.adabelief(learning_rate=tab.cosine_decay_schedule(**lr))
    key = jax.random.key(7)
    jstate = jloop.TrainState(params=jparams, opt_state=jopt.init(jparams),
                              step=jnp.zeros((), jnp.int32), key=key)
    jmega = jloop.make_scanned_train_step_for(jdense, jcfg, jopt)
    jnew, jout = jmega(jstate, jloop.stack_batches([j for j, _ in pairs]))

    # the TPU package's draws of each step, replayed from its key schedule
    draws = []
    for jb, _ in pairs:
        key, subkey = jax.random.split(key)
        k_noise, _, k_input, _ = jax.random.split(subkey, 4)
        ns = jax.random.uniform(k_noise, ())
        noisy = construct_training_input(k_input, jb.solutions, ns)
        draws.append(dict(noise_scale=float(ns),
                          noisy_num=torch.from_numpy(np.array(noisy))))
    it = iter(draws)

    def apply(params, cfg, batch, generator=None, training=False,
              labels=None, device="cpu"):
        return tdense(params, cfg, batch, generator, training=training,
                      labels=labels, device=device, **next(it))

    tparams = torch_params(jparams)
    tstate = tloop.TrainState(params=tparams, opt_state=topt.init(tparams),
                              step=0, generator=torch.Generator())
    tmega = tloop.make_scanned_train_step_for(apply, tcfg, topt, "cpu")
    tnew, tout = tmega(tstate, tloop.stack_batches([t for _, t in pairs]))

    assert tnew.step == int(jnew.step) == 3
    assert int(tnew.opt_state.count) == 3
    np.testing.assert_allclose(np_of(tout["loss_per_step"]),
                               np.asarray(jout["loss_per_step"]), rtol=1e-5)
    np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]),
                               rtol=1e-5)
    assert int(tout["steps_taken"]) == int(jout["steps_taken"])
    for g, w in zip(jax.tree.leaves(jax.tree.map(np_of, tnew.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jnew.params)),
                    strict=True):
        np.testing.assert_allclose(g, w, atol=1e-6)


@pytest.mark.parametrize("bank", [False, True])
def test_stack_batches_matches_the_tpu_packages(bank):
    pairs = _batch_pairs(3, seed=2, bank=bank)
    js = jloop.stack_batches([j for j, _ in pairs])
    ts = tloop.stack_batches([t for _, t in pairs])
    for f in dataclasses.fields(ts):
        a, b = getattr(js, f.name), getattr(ts, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
            continue
        a, b = np.asarray(a), np_of(b)
        assert a.shape == b.shape and a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert (ts.solutions_k is None) == (not bank)
    # an optional field set in one batch and not in another does not stack
    other = dataclasses.replace(
        pairs[1][1],
        solutions_k=None if bank else pairs[1][1].solutions[None])
    with pytest.raises(ValueError):
        tloop.stack_batches([pairs[0][1], other])


def _jax_driver_chunks(batches, n):
    """The TPU package's driver loop (diffusion_training.py:242-253)."""
    groups: dict = {}
    for b in batches:
        k = (b.G, b.Vg, b.Cg, b.solutions_k is not None,
             getattr(b, "label_isolation_k", None) is not None)
        groups.setdefault(k, []).append(b)
    return [jloop.stack_batches(bs[i:i + n]) for bs in groups.values()
            for i in range(0, len(bs), n)]


def test_dense_chunks_group_as_the_tpu_driver():
    """Batches of three block shapes, interleaved: chunks of at most 3 per
    shape group, groups in order of first appearance."""
    flats = []
    for i in range(8):
        formulas, sols = random_formulas(10 + i, n_formulas=3 + i % 3)
        flats.append(batch_pair(formulas, sols))
    dims = [(4, 12, 40), (8, 12, 40), (8, 16, 48)]
    jbs = [jdb.dense_from_flat(j, *dims[i % 3]) for i, (j, _) in
           enumerate(flats)]
    tbs = [tdb.dense_from_flat(t, *dims[i % 3]) for i, (_, t) in
           enumerate(flats)]
    want = _jax_driver_chunks(jbs, 3)
    got = diffusion_training._mega_chunks(tbs, 3)
    assert [np.asarray(w.incidence).shape for w in want] == \
        [tuple(g.incidence.shape) for g in got]
    assert [g.incidence.shape[0] for g in got] == [3, 3, 2]
    for w, g in zip(want, got, strict=True):
        np.testing.assert_array_equal(np.asarray(w.incidence),
                                      np_of(g.incidence))
        np.testing.assert_array_equal(np.asarray(w.solutions),
                                      np_of(g.solutions))


# -- the step accounting of `train` -----------------------------------------


class _JState:
    def __init__(self, step):
        self.step = step


def _runs(lengths, target, log_every=2, eval_every=2, ckpt_every=3):
    """The TPU package's `train` and the port's over chunks of `lengths`
    steps (a fake step that advances the step count by its chunk)."""
    recs = {"jax": {"eval": [], "ckpt": []}, "port": {"eval": [], "ckpt": []}}

    def jstep(state, n):
        return _JState(state.step + n), {"loss": jnp.float32(n)}

    def tstep(state, n, max_steps=None):
        n = n if max_steps is None else min(n, max_steps)
        return state.replace(step=state.step + n), \
            {"loss": torch.tensor(float(n))}

    out = {}
    for name, fn, st in (
            ("jax", jloop.train, _JState(0)),
            ("port", tloop.train, tloop.TrainState({}, None, 0, None))):
        r = recs[name]
        final = fn(st, jstep if name == "jax" else tstep, iter(lengths),
                   steps=len(lengths), log_every=log_every,
                   target_step=target,
                   eval_fn=lambda s, r=r: r["eval"].append(s.step) or {},
                   eval_every=eval_every,
                   checkpoint_fn=lambda s, r=r: r["ckpt"].append(s.step),
                   ckpt_every=ckpt_every)
        out[name] = int(final.step)
    return out, recs


def test_train_counts_chunk_steps_as_the_tpu_package():
    # chunks of 3, 3, 2, 3, 1, 3, 3 steps; the budget falls on a log
    # boundary (call 6), so both stop there with the same records, but for
    # the last call's eval and checkpoint, which the TPU package skips (it
    # breaks at the log boundary) and the port keeps
    lengths = [3, 3, 2, 3, 1, 3, 3]
    final, recs = _runs(lengths, target=15)
    assert final == {"jax": 15, "port": 15}
    assert recs["jax"] == {"eval": [6, 11], "ckpt": [8]}
    assert recs["port"] == {"eval": [6, 11, 15], "ckpt": [8, 15]}


def test_train_cuts_the_last_chunk_at_the_budget():
    """Inside a chunk the TPU package overshoots (it checks at log
    boundaries); the port stops at the budget exactly and takes the same
    records up to it."""
    lengths = [3, 3, 2, 3, 1, 3, 3]
    final, recs = _runs(lengths, target=13, log_every=100)
    assert final == {"jax": 18, "port": 13}
    assert recs["jax"] == {"eval": [6, 11, 15], "ckpt": [8, 15]}
    assert recs["port"] == {"eval": [6, 11, 13], "ckpt": [8, 13]}


# -- the drivers ------------------------------------------------------------

DIFF_TINY = ["--train_size", "300", "--test_size", "20", "--train_rounds",
             "2", "--test_rounds", "2", "--feature_maps", "16",
             "--query_maps", "8", "--logit_maps", "4", "--device", "cpu",
             "--gen_workers", "1", "--max_nodes_per_batch", "400"]


def _spy_chunks(monkeypatch, module):
    """Record the steps each call of the driver's scanned step takes."""
    taken = []
    make = module.make_scanned_train_step_for

    def spy(*a, **k):
        mega = make(*a, **k)

        def step(state, stacked, max_steps=None):
            new, out = mega(state, stacked, max_steps=max_steps)
            taken.append(new.step - state.step)
            return new, out
        return step

    monkeypatch.setattr(module, "make_scanned_train_step_for", spy)
    return taken


def _eval_steps_by_the_tpu_rule(taken, every_calls):
    steps = np.cumsum(taken)
    return [int(s) for i, s in enumerate(steps) if (i + 1) % every_calls == 0]


def test_training_script_mega_steps_take_exactly_train_steps(tmp_path,
                                                             monkeypatch,
                                                             capsys):
    taken = _spy_chunks(monkeypatch, diffusion_training)
    final = diffusion_training.main(DIFF_TINY + [
        "--train_steps", "10", "--eval_every", "3", "--ckpt_every", "6",
        "--mega_steps", "3", "--data_dir", str(tmp_path / "dc"),
        "--train_dir", str(tmp_path / "runs")])
    out = capsys.readouterr().out
    assert "mega-steps:" in out and "WARNING" not in out
    assert sum(taken) == 10 and max(taken) == 3 and taken[-1] >= 1
    run_dir = Path(final["run_dir"])
    recs = [json.loads(line) for line in
            (run_dir / "train_log.jsonl").read_text().splitlines()]
    # evals every eval_every // 3 calls, checkpoints every 6 // 3 calls
    assert [r["step"] for r in recs if "total_accuracy" in r] == \
        _eval_steps_by_the_tpu_rule(taken, 1)
    # the three newest are kept (--ckpt_count 3); the final save is 10
    want_ckpt = sorted(set(_eval_steps_by_the_tpu_rule(taken, 2) +
                           [10]))[-3:]
    assert sorted(int(p.stem.split("_")[1]) for p in
                  (run_dir / "ckpt").iterdir()) == want_ckpt
    with np.load(run_dir / "ckpt" / "ckpt_10.npz") as z:
        assert int(z["step"]) == 10 and int(z["count"]) == 10


def test_mega_steps_on_a_flat_stream_warn_and_run_one_step_a_call(
        tmp_path, capsys):
    final = diffusion_training.main(DIFF_TINY + [
        "--train_steps", "4", "--eval_every", "4", "--ckpt_every", "4",
        "--mega_steps", "3", "--dense", "false", "--data_dir",
        str(tmp_path / "dc"), "--train_dir", str(tmp_path / "runs")])
    assert "WARNING: --mega_steps needs a dense-only" in \
        capsys.readouterr().out
    recs = [json.loads(line) for line in (
        Path(final["run_dir"]) / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "total_accuracy" in r] == [4]


def test_anf_scanned_step_on_padded_plans_equals_eager_steps():
    from _torch_parity import anf_batch_pair, anf_items
    batches = [anf_batch_pair(anf_items(seed=s, n=3))[1] for s in range(3)]
    cfg = ANFSATConfig(feature_maps=16, query_maps=16, train_rounds=2)
    opt = tab.adabelief(learning_rate=1e-2)

    def state():
        g = torch.Generator()
        g.manual_seed(0)
        params = anf_sat_init(g, cfg)
        gen = torch.Generator()
        gen.manual_seed(3)
        return tloop.TrainState(params, opt.init(params), 0, gen)

    step = tloop.make_planned_train_step_for(anf_sat_apply, cfg, opt,
                                             device="cpu")
    a = state()
    for b in batches:
        a, _ = step(a, b, tloop.build_plans(b))
    mega = tloop.make_scanned_train_step_for(anf_sat_apply, cfg, opt, "cpu")
    chunk = tloop.stack_batches([(b, tloop.build_plans(b, pad=True))
                                 for b in batches])
    m, _ = mega(state(), chunk)
    assert m.step == 3
    for x, y in zip(_leaves(a), _leaves(m), strict=True):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="padded plans"):
        mega(state(), chunk[0])

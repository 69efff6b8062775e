"""Port vs TPU package: params files and training checkpoints.

`export_params` of either package is read by `load_params` of the other with
equal arrays and meta; the port's `CheckpointManager` saves, restores and
prunes, and a restored run's next steps equal the uninterrupted run's bit for
bit (params, moments and the generator's stream).
"""

import importlib

import numpy as np
import pytest
import torch

import jax

from _torch_parity import random_formulas
from diffusionsat_tpu.models import query_sat as jqs
from diffusionsat_torch.graph import dense_batch as tdb
from diffusionsat_torch.graph.batch import BucketSpec, build_batch
from diffusionsat_torch.models import query_sat as tqs
from diffusionsat_torch.models.query_sat_dense import query_sat_dense_apply
from diffusionsat_torch.ops.segsum import build_batch_plans

jckpt = importlib.import_module("diffusionsat_tpu.train.checkpoint")
tckpt = importlib.import_module("diffusionsat_torch.train.checkpoint")
tab = importlib.import_module("diffusionsat_torch.train.adabelief")
tloop = importlib.import_module("diffusionsat_torch.train.loop")

SMALL = dict(feature_maps=16, query_maps=8, logit_maps=4, train_rounds=2,
             test_rounds=2)


def _assert_trees_equal(a, b):
    a, b = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_export_is_read_by_the_tpu_package_and_back(tmp_path):
    cfg = tqs.QuerySATConfig(**SMALL)
    params = tqs.query_sat_init(torch.Generator().manual_seed(0), cfg)
    meta = {"model": "query_sat", "config": {"feature_maps": 16}, "step": 3}
    path = tmp_path / "port.npz"
    tckpt.export_params(params, path, meta=meta)
    jtree, jmeta = jckpt.load_params(path)
    assert jmeta == meta
    assert set(jtree) == set(params)
    _assert_trees_equal(jtree, tckpt.params_to_numpy(params))
    # the same keys, in the TPU package's layout
    with np.load(path) as z:
        port_keys = sorted(z.files)
    jparams = jqs.query_sat_init(jax.random.key(0), jqs.QuerySATConfig(**SMALL))
    jpath = tmp_path / "tpu.npz"
    jckpt.export_params(jparams, jpath, meta=meta)
    with np.load(jpath) as z:
        assert sorted(z.files) == port_keys
    ttree, tmeta = tckpt.load_params(jpath)
    assert tmeta == meta
    _assert_trees_equal(ttree, jax.tree.map(np.asarray, jparams))
    # numpy -> torch -> numpy is the identity
    _assert_trees_equal(
        tckpt.params_to_numpy(tckpt.params_from_numpy(ttree, "cpu")), ttree)


def _state(seed=0):
    cfg = tqs.QuerySATConfig(**SMALL)
    params = tqs.query_sat_init(torch.Generator().manual_seed(seed), cfg)
    opt = tab.adabelief(learning_rate=tab.cosine_decay_schedule(1e-2, 50))
    return cfg, opt, tloop.TrainState(
        params=params, opt_state=opt.init(params), step=0,
        generator=torch.Generator().manual_seed(seed + 1))


def _batch():
    formulas, sols = random_formulas(5, n_formulas=4)
    return build_batch(formulas, BucketSpec(64, 128, 512, 8), solutions=sols)


@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_restored_run_continues_bit_for_bit(tmp_path, layout):
    cfg, opt, state = _state()
    flat = _batch()
    if layout == "flat":
        planned = tloop.make_planned_train_step(cfg, opt, "cpu")
        plans = build_batch_plans(flat)
        step = lambda s: planned(s, flat, plans)  # noqa: E731
    else:
        dense = tdb.dense_from_flat(flat, *tdb.dense_dims_for([flat]))
        ds = tloop.make_train_step_for(query_sat_dense_apply, cfg, opt, "cpu")
        step = lambda s: ds(s, dense)  # noqa: E731
    mgr = tckpt.CheckpointManager(tmp_path / "ckpt")
    assert mgr.restore(state) is None and mgr.latest_step() is None
    for _ in range(3):
        state, _ = step(state)
    mgr.save(state)
    losses = []
    for _ in range(3):           # the uninterrupted run
        state, out = step(state)
        losses.append(float(out["loss"]))

    _, _, template = _state(seed=9)     # other params, another stream
    restored = tckpt.CheckpointManager(tmp_path / "ckpt").restore(template)
    assert restored.step == 3 and int(restored.opt_state.count) == 3
    again = []
    for _ in range(3):
        restored, out = step(restored)
        again.append(float(out["loss"]))
    assert again == losses
    assert restored.step == state.step == 6
    for a, b in zip(jax.tree.leaves(restored.params),
                    jax.tree.leaves(state.params)):
        assert torch.equal(a, b)
    for name in ("m", "v"):
        for a, b in zip(jax.tree.leaves(getattr(restored.opt_state, name)),
                        jax.tree.leaves(getattr(state.opt_state, name))):
            assert torch.equal(a, b)
    assert torch.equal(restored.generator.get_state(),
                       state.generator.get_state())


def test_manager_keeps_the_newest_and_restores_the_latest(tmp_path):
    _, _, state = _state()
    mgr = tckpt.CheckpointManager(tmp_path, max_to_keep=2)
    for step in (5, 10, 15, 20):
        mgr.save(state.replace(step=step))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_15.npz", "ckpt_20.npz"]
    assert mgr.latest_step() == 20
    assert mgr.restore(state).step == 20
    # the opt state rides through numpy unchanged
    count, m, v = tckpt.opt_state_to_numpy(state.opt_state)
    back = tckpt.opt_state_from_numpy(count, m, v, "cpu")
    assert int(back.count) == 0 and back.count.dtype == torch.int32
    _assert_trees_equal(tckpt.params_to_numpy(back.m), m)
    # a state without a generator saves and restores too
    mgr.save(state.replace(step=25, generator=None))
    assert mgr.restore(state.replace(generator=None)).generator is None

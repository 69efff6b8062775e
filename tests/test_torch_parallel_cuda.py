"""The multi-device collectives on the card: what the CPU tests cannot
reach.

Needs an NVIDIA card and nvcc; skips elsewhere. Two ranks: NCCL, one card
each, when two cards are visible; else gloo, both on one card, every
collective staged through the host. This file imports no JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_parallel_cuda.py
"""

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from diffusionsat_torch.models.query_sat import QuerySATConfig, query_sat_init
from diffusionsat_torch.parallel.mesh import launch

import _torch_parallel_ranks as ranks

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 2
    if torch.cuda.device_count() >= n:
        backend, devices = "nccl", None
    else:
        backend, devices = "gloo", ["cuda:0"] * n
    batch = ranks.random_batch(1)
    rng = np.random.default_rng(0)
    partials = rng.normal(size=(n, 2 * batch.V, 5)).astype(np.float32)
    cfg = QuerySATConfig(feature_maps=32, query_maps=16, logit_maps=4,
                         train_rounds=3, test_rounds=3)
    params = pytree.tree_map(lambda t: t.numpy(), query_sat_init(
        torch.Generator().manual_seed(0), cfg))
    inp = dict(batch=ranks.strip(batch), partials=partials, cfg=cfg,
               params=params,
               dp_batches=[ranks.strip(ranks.random_batch(s, 3))
                           for s in (7, 8)])
    res = launch(ranks.collectives_case, n, backend, devices, inp)
    return backend, inp, res


def test_transport_is_named(world):
    backend, _, res = world
    want = "nccl" if backend == "nccl" else "gloo-host"
    assert {r["transport"] for r in res} == {want}


def test_all_reduce_sum_and_its_transpose(world):
    _, _, res = world
    for r in res:
        y, gx = r["all_reduce"]
        np.testing.assert_array_equal(y, np.full((3, 2), 3.0))
        # the cotangents (rank + 1) summed over the ranks
        np.testing.assert_array_equal(gx, np.full((3, 2), 3.0))


def test_all_to_all_and_its_transpose(world):
    _, _, res = world
    n = len(res)
    for me, r in enumerate(res):
        y, gx = r["all_to_all"]
        # block s came from rank s, which sent its block `me`
        np.testing.assert_array_equal(
            y[:, 0], [me + 10 * s for s in range(n)])
        # the cotangent of the block sent to rank t is t's weight of it
        np.testing.assert_array_equal(gx[:, 0], [me + 1] * n)


def test_min_gather_and_bucket(world):
    _, _, res = world
    assert all(r["min"] == 0.0 for r in res)
    np.testing.assert_array_equal(res[0]["gather"], [[0, 0], [1, 1]])
    assert all(r["gather"] is None for r in res[1:])
    for r in res:
        np.testing.assert_array_equal(r["bucket"][0], [0.5, 0.5])
        np.testing.assert_array_equal(r["bucket"][1], [[1.0, 1.0, 1.0]])


def test_halo_exchange_through_the_kernel(world):
    """The exchange equals its plain arithmetic (send rows gathered, the
    shared rows added) and launches the kernel once each way."""
    from diffusionsat_torch.parallel.halo import build_halo_plan

    _, inp, res = world
    n = len(res)
    plan = build_halo_plan(inp["batch"], n)
    for s, r in enumerate(res):
        idx = plan.send_idx[s].reshape(-1).numpy()
        mask = plan.send_mask[s].reshape(-1).numpy()
        want = inp["partials"][s].copy()
        for t in range(n):
            rows = plan.send_idx[t, s].numpy()
            m = plan.send_mask[t, s].numpy() > 0
            want[rows[m]] += inp["partials"][t][rows[m]]
        np.testing.assert_allclose(r["halo"], want, rtol=1e-6, atol=1e-6)
        assert r["halo_launches"]["halo_send"] == 1
        assert r["halo_launches"]["halo_recv"] == 1
        assert idx.shape == mask.shape


def test_dp_step_on_the_card(world):
    _, inp, res = world
    assert len({r["dp"]["hash"] for r in res}) == 1
    for r in res:
        assert np.isfinite(r["dp"]["loss"])
        # 3 rounds: 2 each way a round forward, 2 backward
        assert r["dp"]["launches"]["lit_to_clause"] == 12
        assert r["dp"]["launches"]["clause_to_lit"] == 12

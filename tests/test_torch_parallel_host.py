"""The multi-device slice's host code against the TPU package's: the DP
stream's groups and order, the clause shards, the local batches and the
halo plans, array for array. No process group is started here."""

import itertools

import numpy as np
import pytest
import torch

from diffusionsat_tpu.graph import dense_batch as jdense
from diffusionsat_tpu.parallel import dp as jdp
from diffusionsat_tpu.parallel import graph_partition as jgp
from diffusionsat_tpu.parallel import halo as jhalo
from diffusionsat_torch.graph import dense_batch as tdense
from diffusionsat_torch.ops import segsum
from diffusionsat_torch.ops.graph_ops import clause_to_lit, literal_degrees
from diffusionsat_torch.parallel import dp as tdp
from diffusionsat_torch.parallel import graph_partition as tgp
from diffusionsat_torch.parallel import halo as thalo

from _torch_parallel_ranks import BUCKET, random_formulas
from _torch_parity import DENSE_FIELDS, assert_batches_equal, batch_pair, np_of


def halo_pair(seed, n_graphs=6):
    formulas, sols = random_formulas(seed, n_graphs)
    return batch_pair(formulas, sols, **BUCKET)


def mixed_batches():
    """Ten batches of two shapes (two buckets) in an interleaved order,
    as (TPU-package list, port list)."""
    jb, tb = [], []
    for i in range(10):
        formulas, sols = random_formulas(100 + i, n_graphs=3)
        big = i % 3 == 0
        j, t = batch_pair(formulas, sols, max_vars=64 if big else 32,
                          max_clauses=128 if big else 96,
                          max_edges=512 if big else 384, max_graphs=4)
        jb.append(j)
        tb.append(t)
    return jb, tb


@pytest.mark.parametrize("n_devices,seed", [(2, 0), (3, 5), (4, 1)])
def test_stacked_stream_groups_order_and_message(n_devices, seed, capsys):
    """The same groups in the same order over several passes, and the
    same printed count of dropped remainders (the big shape holds 4
    batches, the small one 6)."""
    jb, tb = mixed_batches()
    jgroups = list(itertools.islice(jdp.stacked_stream(jb, n_devices,
                                                       seed=seed), 12))
    jout = capsys.readouterr().out
    tgroups = list(itertools.islice(tdp.stacked_stream(tb, n_devices,
                                                       seed=seed), 12))
    tout = capsys.readouterr().out
    assert tout == jout
    assert ("dropped" in tout) == (n_devices != 2)
    for jg, tg in zip(jgroups, tgroups, strict=True):
        assert_batches_equal(jg, tg)


def test_stacked_stream_of_dense_batches_and_take():
    jb, tb = mixed_batches()
    jd, td = jdense.densify_batches(jb), tdense.densify_batches(tb)
    jgroups = list(itertools.islice(jdp.stacked_stream(jd, 2, seed=3), 8))
    rows = list(itertools.islice(tdp.stacked_stream(
        td, 2, seed=3, take=lambda g: (g, np_of(g.var_mask).sum())), 8))
    for jg, (tg, _) in zip(jgroups, rows, strict=True):
        assert_batches_equal(jg, tg, DENSE_FIELDS)
    with pytest.raises(ValueError, match="no shape group"):
        tdp.stacked_stream(tb[:1], 2).__next__()


def test_stack_batches_is_the_loops():
    from diffusionsat_torch.train import loop
    assert tdp.stack_batches is loop.stack_batches


@pytest.mark.parametrize("seed,n_shards", [(42, 8), (5, 4), (1, 2)])
def test_shard_batch_by_clause_equals_the_tpu_packages(seed, n_shards):
    jb, tb = halo_pair(seed, n_graphs=3 if seed == 42 else 6)
    assert_batches_equal(jgp.shard_batch_by_clause(jb, n_shards),
                         tgp.shard_batch_by_clause(tb, n_shards))


@pytest.mark.parametrize("seed,n_shards", [(5, 4), (5, 8), (1, 2)])
def test_build_local_batches_equals_the_tpu_packages(seed, n_shards):
    jb, tb = halo_pair(seed)
    assert_batches_equal(jgp.build_local_batches(jb, n_shards),
                         tgp.build_local_batches(tb, n_shards))


def test_uneven_clause_split_raises():
    _, tb = halo_pair(5)
    for fn in (tgp.shard_batch_by_clause, tgp.build_local_batches,
               thalo.build_halo_plan):
        with pytest.raises(ValueError, match="shards"):
            fn(tb, 3)


@pytest.mark.parametrize("seed,n_shards", [(0, 4), (5, 4), (5, 8), (1, 2)])
def test_build_halo_plan_equals_the_tpu_packages(seed, n_shards):
    jb, tb = halo_pair(seed)
    jp, tp = jhalo.build_halo_plan(jb, n_shards), \
        thalo.build_halo_plan(tb, n_shards)
    for name in ("owner_mask", "send_idx", "send_mask"):
        a, b = np.asarray(getattr(jp, name)), np_of(getattr(tp, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (tp.halo_rows, tp.n_shards) == (jp.halo_rows, jp.n_shards)
    assert tp.literal_rows == 2 * tb.V
    # cut-proportional, and every real graph owned once (test_halo.py)
    if n_shards == 4:
        assert 0 < tp.halo_rows < 2 * tb.V // 2
    om, gm = np_of(tp.owner_mask), np_of(tb.graph_mask)
    np.testing.assert_array_equal(om.sum(axis=0)[gm > 0], 1.0)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_halo_view_plans_are_the_masked_gather_and_its_transpose(n_shards):
    _, tb = halo_pair(5)
    plan = thalo.build_halo_plan(tb, n_shards)
    x = torch.randn((2 * tb.V, 3), generator=torch.Generator().manual_seed(0))
    for s in range(n_shards):
        view = plan.view(s)
        idx = plan.send_idx[s].reshape(-1).long()
        mask = plan.send_mask[s].reshape(-1, 1)
        sent = segsum.gather_segsum(x, view.send)
        torch.testing.assert_close(sent, x[idx] * mask, rtol=0, atol=0)
        back = segsum.gather_segsum(sent, view.recv)
        want = torch.zeros_like(x).index_add_(0, idx, x[idx] * mask)
        torch.testing.assert_close(back, want)
        assert view.owner_mask.shape == (tb.G,)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_local_batches_sum_to_the_whole(n_shards):
    """A shard's literal side is sorted by literal (kernel plans), its
    degrees and clause -> literal sums over the shards add up to the whole
    batch's, through the plain path and through the plans."""
    _, tb = halo_pair(5)
    stacked = tgp.build_local_batches(tb, n_shards)
    c_per = tb.C // n_shards
    x = torch.randn((tb.C, 4), generator=torch.Generator().manual_seed(1))
    want = clause_to_lit(tb, x)
    total = torch.zeros_like(want)
    degrees = torch.zeros_like(literal_degrees(tb))
    for s in range(n_shards):
        local = tgp.local_batch(stacked, s)
        assert bool(torch.all(local.edge_lit_l[1:] >= local.edge_lit_l[:-1]))
        xs = x[s * c_per:(s + 1) * c_per]
        plain = clause_to_lit(local, xs)
        planned = segsum.plan_clause_to_lit(
            xs, segsum.build_batch_plans(local))
        torch.testing.assert_close(planned, plain)
        total += plain
        degrees += literal_degrees(local)
    torch.testing.assert_close(total, want)
    torch.testing.assert_close(degrees, literal_degrees(tb))


def test_comm_bytes_per_round_is_the_dry_runs_accounting():
    """The halo against the full all-reduce, as the TPU package's dry run
    reckons them (`__graft_entry__.py`): 2 exchanges a round of [2V, Q] f32
    aggregates."""
    _, tb = halo_pair(3)
    plan = thalo.build_halo_plan(tb, 4)
    got = thalo.comm_bytes_per_round(plan, 16)
    halo_rows_per_shard = float(np.max(np.sum(np_of(plan.send_mask),
                                              axis=(1, 2))))
    assert got["halo"] == 2 * halo_rows_per_shard * 16 * 4
    assert got["all_reduce"] == 2 * 2 * (4 - 1) / 4 * (2 * tb.V) * 16 * 4
    assert got["halo_rows"] == plan.halo_rows and \
        got["literal_rows"] == 2 * tb.V

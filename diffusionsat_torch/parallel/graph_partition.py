"""Clause-partitioned graph parallelism over the mesh's "graph" groups.

Counterpart of the TPU package's `parallel/graph_partition.py`, for one
formula batch too large for one device (SURVEY.md §5.7): the clauses and
their incident edges are split across the ranks of a graph group, the
literal side stays replicated. Per message-passing round:

- literal -> clause: every rank sums its replicated literal rows into its
  own clauses, with no communication;
- clause -> literal: every rank sums its clauses into a partial [2V, F]
  literal aggregate, and one all-reduce over the group completes it.

- `shard_batch_by_clause` and `build_local_batches`: host numpy, equal to
  the TPU package's arrays;
- `local_batch`: rank s's shard of `build_local_batches`' stack as a batch
  of its own, its literal-side edges sorted by literal (the stack keeps
  them clause-sorted, as the TPU package's does, whose clause -> literal
  sum there is unsorted) so that the shard has kernel plans;
- `make_sharded_spmm`: the sharded SpMM pair on the segsum kernel;
- `make_gp_train_step`: the clause-sharded train step. The TPU package
  leaves this step to GSPMD, which has no torch counterpart: here it is
  the model's sharded hooks (`query_sat_apply(..., group=...)`) on the
  rank's local batch with its per-shard kernel plans.

The gradient rule. The collectives differentiate as their true transposes
(`parallel/comm.py`), every rank holds the whole (replicated) loss L, and
each rank differentiates its 1/n share of it. The sum over the group of
the ranks' parameter gradients is then the single-device gradient, which
the step applies on every rank. The model hands every rank's copy of the
variable state the copies' mean cotangent once a round
(`comm.balance_copies`): the sum is the same, and no copy's share can
grow through the rounds until f32 rounding swamps the sum.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils import _pytree as pytree

from diffusionsat_torch import cuda_graphs
from diffusionsat_torch.graph.batch import SatBatch
from diffusionsat_torch.models.query_sat import query_sat_apply
from diffusionsat_torch.ops.segsum import (
    BatchPlans,
    build_batch_plans,
    build_segsum_plan,
    plan_clause_to_lit,
    plan_lit_to_clause,
)
from diffusionsat_torch.parallel.comm import (
    all_reduce_sum,
    group_size,
    sum_bucket,
)
from diffusionsat_torch.parallel.mesh import Mesh
from diffusionsat_torch.train.loop import (
    TrainState,
    _global_norm,
    _grad_leaves,
    _grads_of,
    _select_labels,
)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _shard_edges(batch: SatBatch, n_shards: int):
    """(clauses per shard, per shard (literal ids, local clause ids,
    mask)): each shard's valid clause-sorted edges, padded to the largest
    shard's count rounded up to 128 with the last literal and the last
    local clause."""
    C = batch.C
    if C % n_shards:
        raise ValueError(f"{C} clauses do not split into {n_shards} shards:"
                         " pad clauses to a multiple of the shard count")
    c_per = C // n_shards
    el, ec = _np(batch.edge_lit_c), _np(batch.edge_clause_c)
    em = _np(batch.edge_mask_c)
    groups = [np.where((ec // c_per == s) & (em > 0))[0]
              for s in range(n_shards)]
    e_per = -(-max((len(g) for g in groups), default=1) // 128) * 128
    out = []
    for s, idx in enumerate(groups):
        n = len(idx)
        lel = np.full(e_per, 2 * batch.V - 1, dtype=np.int32)
        lec = np.full(e_per, c_per - 1, dtype=np.int32)
        lem = np.zeros(e_per, dtype=np.float32)
        lel[:n] = el[idx]
        lec[:n] = ec[idx] - s * c_per
        lem[:n] = 1.0
        out.append((lel, lec, lem))
    return c_per, out


def shard_batch_by_clause(batch: SatBatch, n_shards: int) -> SatBatch:
    """The batch with its clause-sorted edge arrays re-laid so that they
    split evenly into `n_shards` blocks: block s holds the valid edges of
    clauses [s C/n, (s+1) C/n) with local clause ids, padded to a common
    length (a multiple of 128). Every other field is kept."""
    _, shards = _shard_edges(batch, n_shards)
    el, ec, em = (torch.from_numpy(np.concatenate([sh[i] for sh in shards]))
                  for i in range(3))
    return dataclasses.replace(batch, edge_lit_c=el, edge_clause_c=ec,
                               edge_mask_c=em)


def build_local_batches(batch: SatBatch, n_shards: int) -> SatBatch:
    """The batch split into `n_shards` clause shards, stacked on a new
    leading axis (host tensors): per shard the clause rows and their edges
    (local clause ids; both edge orderings hold the local clause-sorted
    edges, `edge_perm_l` the identity); variable and graph arrays
    replicated, per-graph clause counts global."""
    c_per, shards = _shard_edges(batch, n_shards)
    locals_ = []
    for s, (lel, lec, lem) in enumerate(shards):
        sl = slice(s * c_per, (s + 1) * c_per)
        edges = {k: torch.from_numpy(v) for k, v in (
            ("edge_lit_c", lel), ("edge_clause_c", lec), ("edge_mask_c", lem),
            ("edge_lit_l", lel.copy()), ("edge_clause_l", lec.copy()),
            ("edge_mask_l", lem.copy()),
            ("edge_perm_l", np.arange(len(lel), dtype=np.int32)))}
        locals_.append(dataclasses.replace(
            batch, clause_mask=batch.clause_mask[sl],
            clause_graph=batch.clause_graph[sl], **edges))
    return cuda_graphs.stack_trees(
        [cuda_graphs.tree_map(lambda t: t.cpu(), b) for b in locals_])


def local_batch(stacked: SatBatch, shard: int) -> SatBatch:
    """Shard `shard` of `build_local_batches`' stack as a SatBatch of its
    own, its literal-sorted edge ordering sorted by literal (stable, so
    each literal's edges keep their clause order)."""
    b = cuda_graphs.index_tree(stacked, shard)
    lit = _np(b.edge_lit_c)
    order = np.argsort(lit, kind="stable")
    take = torch.from_numpy(order)
    return dataclasses.replace(
        b, edge_lit_l=b.edge_lit_c[take].contiguous(),
        edge_clause_l=b.edge_clause_c[take].contiguous(),
        edge_mask_l=b.edge_mask_c[take].contiguous(),
        edge_perm_l=torch.from_numpy(order.astype(np.int32)))


def shard_plans(edge_lit, edge_clause, edge_mask, V: int,
                c_per: int) -> BatchPlans:
    """The kernel plans of one clause shard's edges (clause-sorted, local
    clause ids): lit -> clause into its `c_per` clauses, and clause -> lit
    into all 2V literals."""
    el, ec, em = _np(edge_lit), _np(edge_clause), _np(edge_mask)
    order = np.argsort(el, kind="stable")
    return BatchPlans(
        build_segsum_plan("lit_to_clause", ec, el, em, num_segments=c_per,
                          num_sources=2 * V),
        build_segsum_plan("clause_to_lit", el[order], ec[order], em[order],
                          num_segments=2 * V, num_sources=c_per))


def make_sharded_spmm(mesh: Mesh, V: int, C: int, n_shards: int):
    """(lit_to_clause, clause_to_lit) over the mesh's graph group, each
    taking this rank's block of `shard_batch_by_clause`'s edge arrays:

    - lit_to_clause(lit_feats [2V, F] replicated, edges) -> this rank's
      clause rows [C/n, F];
    - clause_to_lit(clause_feats [C/n, F], edges) -> [2V, F] replicated (one
      all-reduce).

    Both run on the segsum kernel over the shard's plans (built on the
    host at each call)."""
    if group_size(mesh.graph_group) != n_shards:
        raise ValueError(f"{n_shards} shards on a graph group of "
                         f"{group_size(mesh.graph_group)}")
    c_per = C // n_shards

    def plans_of(edge_lit, edge_clause, edge_mask):
        return shard_plans(edge_lit, edge_clause, edge_mask, V,
                           c_per).to(mesh.device)

    def lit_to_clause(lit_feats, edge_lit, edge_clause, edge_mask):
        return plan_lit_to_clause(lit_feats,
                                  plans_of(edge_lit, edge_clause, edge_mask))

    def clause_to_lit(clause_feats, edge_lit, edge_clause, edge_mask):
        partial = plan_clause_to_lit(
            clause_feats, plans_of(edge_lit, edge_clause, edge_mask))
        return all_reduce_sum(partial, mesh.graph_group)

    return lit_to_clause, clause_to_lit


def make_gp_train_step(cfg, optimizer, mesh: Mesh, halo=None):
    """The clause-sharded QuerySAT train step over the mesh's graph group:
    step(state, local, plans=None, **draws) with `local` this rank's
    `local_batch` and `plans` its kernel plans (built here when none are
    passed). `halo` (this rank's `halo.HaloView`) completes the literal
    aggregates by the halo exchange instead of the all-reduce.

    Every rank draws from `state.generator`, which the ranks hold alike
    and advance alike (the literal state is replicated, so are the
    labels, the noise level and the per-round noise); `draws` (`labels`,
    `noise_scale`, `noisy_num`, `round_noise`) replace them. Each rank
    differentiates 1/n of the replicated loss and the parameter gradients
    are summed over the group (one all-reduce of one bucket): the
    single-device gradient. Returns (state, {"loss", "steps_taken",
    "gradnorm"})."""
    dev = mesh.device
    group = mesh.graph_group
    n = group_size(group)
    iso_alpha = float(getattr(cfg, "label_isolation_alpha", 0.0))
    if halo is not None:
        halo = halo.to(dev)

    def train_step(state: TrainState, local: SatBatch, plans=None,
                   **draws):
        if plans is None:
            plans = build_batch_plans(local)
        local = local.to(dev)
        kw = dict(draws)
        if "labels" not in kw:
            kw["labels"] = _select_labels(local, state.generator, iso_alpha)
        params, leaves, spec = _grad_leaves(state.params)
        _, loss, steps, _ = query_sat_apply(
            params, cfg, local, state.generator, training=True,
            plans=plans.to(dev), group=group, halo=halo, device=dev, **kw)
        _, grad_list = _grads_of(loss / n, leaves, spec)
        grad_list = sum_bucket(grad_list, group)
        grads = pytree.tree_unflatten(grad_list, spec)
        new_params, opt_state = optimizer.update(grads, state.opt_state,
                                                 state.params)
        new_state = TrainState(params=new_params, opt_state=opt_state,
                               step=state.step + 1,
                               generator=state.generator)
        return new_state, {"loss": loss.detach(), "steps_taken": steps,
                           "gradnorm": _global_norm(grad_list)}

    return train_step


def place_local_batch(stacked: SatBatch, mesh: Mesh):
    """This rank's shard of `build_local_batches`' stack and its kernel
    plans, placed on its device once: the graph group's rank s takes shard
    s."""
    local = local_batch(stacked, mesh.graph_index)
    plans = build_batch_plans(local)
    return local.to(mesh.device), plans.to(mesh.device)

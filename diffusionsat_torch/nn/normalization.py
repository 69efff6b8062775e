"""Graph-aware normalization layers (pure functions, no parameters).

Counterpart of the TPU package's `nn/normalization.py`: PairNorm subtracts
the per-graph mean and rescales each node by the rms over its feature axis;
the neighbour norms subtract the two-hop neighbour mean instead, through a
lit -> clause -> lit round trip (on the segsum kernel with `plans`); and
`edge_dropout` drops incidence edges.
"""

from __future__ import annotations

import dataclasses

import torch

from diffusionsat_torch.graph.batch import SatBatch
from diffusionsat_torch.ops.graph_ops import (
    clause_segment_sum,
    graph_gather_clauses,
    graph_gather_vars,
    var_segment_sum,
)
from diffusionsat_torch.ops.segsum import BatchPlans, aggregations


def layer_norm(x: torch.Tensor, axis: int | tuple = 1, epsilon: float = 1e-6,
               subtract_mean: bool = False,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """RMS-style LayerNorm."""
    if subtract_mean:
        x = x - torch.mean(x, dim=axis, keepdim=True)
        if bias is not None:
            x = x + bias
    variance = torch.mean(torch.square(x), dim=axis, keepdim=True)
    return x * torch.rsqrt(variance + epsilon)


def _pair_norm(x, mean_per_node, epsilon):
    x = x - mean_per_node
    variance = torch.mean(torch.square(x), dim=1, keepdim=True)
    return x * torch.rsqrt(variance + epsilon)


def pair_norm_vars(x: torch.Tensor, batch: SatBatch, epsilon: float = 1e-6
                   ) -> torch.Tensor:
    """PairNorm over variable nodes: subtract each variable's graph mean,
    then rms-normalize over the feature axis."""
    sums = var_segment_sum(batch, x * batch.var_mask[:, None])
    counts = torch.clamp(batch.n_vars_per_graph, min=1.0)[:, None]
    mean = graph_gather_vars(batch, sums / counts)
    return _pair_norm(x, mean, epsilon)


def pair_norm_clauses(x: torch.Tensor, batch: SatBatch,
                      epsilon: float = 1e-6, group=None) -> torch.Tensor:
    """PairNorm over clause nodes. For a clause shard (`group`) the
    per-graph sums are completed over the group; the batch's per-graph
    clause counts are the global ones."""
    sums = clause_segment_sum(batch, x * batch.clause_mask[:, None], group)
    counts = torch.clamp(batch.n_clauses_per_graph, min=1.0)[:, None]
    mean = graph_gather_clauses(batch, sums / counts)
    return _pair_norm(x, mean, epsilon)


def _round_trip(batch: SatBatch, x: torch.Tensor, plans: BatchPlans | None,
                from_literals: bool) -> torch.Tensor:
    """lit -> clause -> lit ([2V, F]) or clause -> lit -> clause ([C, F])."""
    l2c, c2l = aggregations(batch, plans)
    return c2l(l2c(x)) if from_literals else l2c(c2l(x))


def _subtract_neighbor_mean(x, summed_deg, epsilon):
    """x minus the neighbour sum over the degree (the last column of
    `summed_deg`, floored at 2), rms-normalized over the feature axis."""
    mean = summed_deg[:, :-1] / torch.clamp(summed_deg[:, -1:], min=2.0)
    out = x - mean
    variance = torch.mean(torch.square(out), dim=1, keepdim=True)
    return out * torch.rsqrt(variance + epsilon)


def variables_neighbor_norm(variables: torch.Tensor, batch: SatBatch,
                            epsilon: float = 1e-6,
                            plans: BatchPlans | None = None) -> torch.Tensor:
    """Subtract the two-hop neighbour mean from variable states [V, F],
    then rms-normalize: a lit -> clause -> lit round trip with a ones
    column counting the degree."""
    V = batch.V
    literals = torch.cat([variables, variables], dim=0)
    ones = torch.ones((literals.shape[0], 1), dtype=literals.dtype,
                      device=literals.device)
    lit_new = _round_trip(batch, torch.cat([literals, ones], dim=1), plans,
                          from_literals=True)
    return _subtract_neighbor_mean(variables, lit_new[:V] + lit_new[V:],
                                   epsilon)


def clauses_neighbor_norm(clauses: torch.Tensor, batch: SatBatch,
                          epsilon: float = 1e-6,
                          plans: BatchPlans | None = None) -> torch.Tensor:
    """The clause-side counterpart over clause states [C, F]."""
    ones = torch.ones((clauses.shape[0], 1), dtype=clauses.dtype,
                      device=clauses.device)
    clause_new = _round_trip(batch, torch.cat([clauses, ones], dim=1),
                             plans, from_literals=False)
    return _subtract_neighbor_mean(clauses, clause_new, epsilon)


def edge_dropout(batch: SatBatch, keep: torch.Tensor) -> SatBatch:
    """Drop incidence edges: `keep` [E] (1.0 keep, 0.0 drop, in the
    clause-sorted edge order, e.g. a Bernoulli(1 - rate) draw) zeroes the
    edge masks of both orderings consistently, the literal-sorted one
    through `edge_perm_l`. Plans built from the returned batch
    (`build_batch_plans`) drop the same edges."""
    keep = keep.to(batch.edge_mask_c.dtype)
    keep_l = keep.index_select(0, batch.edge_perm_l.long())
    return dataclasses.replace(batch, edge_mask_c=batch.edge_mask_c * keep,
                               edge_mask_l=batch.edge_mask_l * keep_l)

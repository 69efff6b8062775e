"""Sparse graph attention over the literal-clause incidence edges.

Counterpart of the TPU package's `nn/attention.py`: the per-edge dot of
endpoint features, the per-clause softmax of edge scores, and the
additive, dot-product and sigmoid attention layers (AttentionSAT uses the
additive one). Edges are in the clause-sorted order throughout.

Each layer ends in a sum of per-edge rows into their literals. With `plans`
(ops/segsum.BatchPlans) that sum runs on the segsum kernel over the edge
plan (`plan_edge_to_lit`); without, the rows are put in the literal-sorted
order (`edge_perm_l`) and summed by the plain sorted segment sum. The TPU
package sums them in edge order (a scatter over unsorted literal ids), so
the order of the terms differs from it: the values agree to f32 rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from diffusionsat_torch.graph.batch import SatBatch
from diffusionsat_torch.nn.mlp import MLPConfig, mlp_apply, mlp_init
from diffusionsat_torch.ops.graph_ops import gather_rows, segment_sum
from diffusionsat_torch.ops.segsum import BatchPlans, plan_edge_to_lit


def edge_dot(a_lit: torch.Tensor, b_clause: torch.Tensor, batch: SatBatch,
             scale: float = 1.0) -> torch.Tensor:
    """Per-edge dot product of literal-side and clause-side features [E]."""
    a_e = gather_rows(a_lit, batch.edge_lit_c)
    b_e = gather_rows(b_clause, batch.edge_clause_c)
    return torch.sum(a_e * b_e, dim=-1) * scale * batch.edge_mask_c


def edge_softmax_by_clause(scores: torch.Tensor, batch: SatBatch
                           ) -> torch.Tensor:
    """Softmax of edge scores [E] within each clause; masked edges get 0.
    The clause maximum is subtracted without a gradient: the softmax does
    not depend on it."""
    neg_inf = torch.finfo(scores.dtype).min
    masked = torch.where(batch.edge_mask_c > 0, scores, neg_inf)
    bounds = torch.arange(batch.C + 1, dtype=batch.edge_clause_c.dtype,
                          device=scores.device)
    offsets = torch.searchsorted(batch.edge_clause_c, bounds)
    seg_max = torch.segment_reduce(masked.detach(), "max", offsets=offsets,
                                   unsafe=True)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    clause = batch.edge_clause_c.long()
    ex = torch.exp(masked - seg_max.index_select(0, clause)) * \
        batch.edge_mask_c
    denom = segment_sum(ex, batch.edge_clause_c, batch.C)
    return ex / torch.clamp(denom.index_select(0, clause), min=1e-20)


def edge_rows_to_lit(rows_e: torch.Tensor, batch: SatBatch,
                     plans: BatchPlans | None = None) -> torch.Tensor:
    """Sum per-edge rows [E, F] (clause-sorted order) into their literals:
    [2V, F]. A masked edge's row must be zero: the plain path adds it and
    the plan drops it."""
    if plans is not None:
        return plan_edge_to_lit(rows_e, plans)
    by_lit = gather_rows(rows_e, batch.edge_perm_l)
    return segment_sum(by_lit, batch.edge_lit_l, 2 * batch.V)


def _edge_weighted_clause_to_lit(weights_e: torch.Tensor,
                                 values: torch.Tensor, batch: SatBatch,
                                 plans: BatchPlans | None = None
                                 ) -> torch.Tensor:
    """Sum over edges into literals of weight_e * values[clause]: [2V, F]."""
    v_e = gather_rows(values, batch.edge_clause_c) * weights_e[:, None]
    return edge_rows_to_lit(v_e, batch, plans)


# ---------------------------------------------------------------------------
# Additive attention


def _additive_cfgs(hidden: int, heads: int) -> tuple[MLPConfig, MLPConfig]:
    return (MLPConfig(3, hidden, heads, do_layer_norm=True),
            MLPConfig(3, hidden, hidden, do_layer_norm=True))


def additive_attention_init(generator: torch.Generator, hidden_maps: int,
                            query_dim: int, memory_dim: int, heads: int = 1
                            ) -> dict:
    pre_cfg, mem_cfg = _additive_cfgs(hidden_maps, heads)
    return {
        "pre_process": mlp_init(generator, pre_cfg, query_dim + memory_dim),
        "memory_mlp": mlp_init(generator, mem_cfg, memory_dim),
    }


def additive_attention_apply(params: dict, query: torch.Tensor,
                             memory: torch.Tensor, batch: SatBatch,
                             hidden: int, heads: int = 1,
                             plans: BatchPlans | None = None
                             ) -> torch.Tensor:
    """query: [2V, dq] literal side; memory: [C, dm] clause side.
    Returns [2V, heads * hidden]."""
    pre_cfg, mem_cfg = _additive_cfgs(hidden, heads)
    q_e = gather_rows(query, batch.edge_lit_c)
    k_e = gather_rows(memory, batch.edge_clause_c)
    units = torch.tanh(mlp_apply(params["pre_process"], pre_cfg,
                                 torch.cat([q_e, k_e], dim=-1)))
    units = units * batch.edge_mask_c[:, None]
    mem = mlp_apply(params["memory_mlp"], mem_cfg, memory)
    return torch.cat([_edge_weighted_clause_to_lit(units[:, h], mem, batch,
                                                   plans)
                      for h in range(heads)], dim=-1)


# ---------------------------------------------------------------------------
# Scaled dot-product attention


def dot_attention_init(generator: torch.Generator, hidden_nmaps: int,
                       output_nmaps: int, query_dim: int, memory_dim: int,
                       heads: int = 4) -> dict:
    def one(i, o):
        return mlp_init(generator, MLPConfig(1, o, o), i)
    return {
        "query_layer": one(query_dim, hidden_nmaps),
        "key_layer": one(memory_dim, hidden_nmaps),
        "value_layer": one(memory_dim, output_nmaps),
        "output_weight": one(output_nmaps, output_nmaps),
    }


def dot_attention_apply(params: dict, query: torch.Tensor,
                        memory: torch.Tensor, batch: SatBatch, hidden: int,
                        heads: int = 4, plans: BatchPlans | None = None
                        ) -> torch.Tensor:
    """Multi-head dot attention: scores per edge, softmax per clause,
    aggregation per literal. query [2V, dq], memory [C, dm] -> [2V, out]."""
    def dense(p, x):
        # the TPU package's leaky_relu here takes its default slope, 0.01
        return F.leaky_relu(x @ p["w"][0] + p["b"][0], negative_slope=0.01)

    q = dense(params["query_layer"], query)
    k = dense(params["key_layer"], memory)
    v = dense(params["value_layer"], memory)
    q_h = torch.chunk(q, heads, dim=-1)
    k_h = torch.chunk(k, heads, dim=-1)
    v_h = torch.chunk(v, heads, dim=-1)
    scale = 1.0 / torch.sqrt(torch.tensor(hidden // heads,
                                          dtype=torch.float32))
    results = []
    for i in range(heads):
        scores = edge_dot(q_h[i], k_h[i], batch, scale)
        coef = edge_softmax_by_clause(scores, batch)
        results.append(_edge_weighted_clause_to_lit(coef, v_h[i], batch,
                                                    plans))
    p = params["output_weight"]
    return torch.cat(results, dim=-1) @ p["w"][0] + p["b"][0]


# ---------------------------------------------------------------------------
# Sigmoid attention


def sigmoid_attention_init(generator: torch.Generator, hidden_maps: int,
                           query_dim: int, memory_dim: int) -> dict:
    cfg = MLPConfig(3, hidden_maps, hidden_maps, do_layer_norm=True)
    return {"unit_mlp": mlp_init(generator, cfg, query_dim + memory_dim)}


def sigmoid_attention_apply(params: dict, query: torch.Tensor,
                            memory: torch.Tensor, batch: SatBatch,
                            hidden: int, plans: BatchPlans | None = None
                            ) -> torch.Tensor:
    """Per-edge sigmoid gates on the clause rows, summed into literals:
    query [2V, dq], memory [C, hidden] -> [2V, hidden]."""
    cfg = MLPConfig(3, hidden, hidden, do_layer_norm=True)
    q_e = gather_rows(query, batch.edge_lit_c)
    k_e = gather_rows(memory, batch.edge_clause_c)
    weights = torch.sigmoid(mlp_apply(params["unit_mlp"], cfg,
                                      torch.cat([q_e, k_e], dim=-1)))
    return edge_rows_to_lit(k_e * weights * batch.edge_mask_c[:, None],
                            batch, plans)

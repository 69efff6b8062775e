"""Differentiable ANF (XOR of AND-terms) equation losses.

Counterpart of the TPU package's `losses/anf.py` (reference `loss/anf.py`):
equations are evaluated in a +/-1 encoding ("zero" -> +1, "one" -> -1)
where XOR is multiplication. The per-clause product is computed in
log-magnitude + sign-parity form (`anf_value_real`) or by complex
angle/log-length accumulation (`anf_value_cplx`). The membership sums run
in one of three ways:

- `plans` (ops/segsum.ANFPlans): the hand-written CUDA segsum kernel on the
  card (its plain version on the CPU);
- `tiles` (ops/tiled_ops.TiledIncidence, `anf_value_cplx` only): the tile
  products, at full f32, since these sums feed exp and cos;
- neither: gathers and fixed-order segment sums.

The two sums of a value (log magnitudes and signs; angles and log lengths)
share one aggregation of their concatenated columns.
"""

from __future__ import annotations

import torch

from diffusionsat_torch.graph.anf_batch import ANFBatch
from diffusionsat_torch.ops.graph_ops import (
    clause_segment_sum,
    gather_rows,
    segment_sum,
)
from diffusionsat_torch.ops.segsum import (
    ANFPlans,
    plan_clause_to_node,
    plan_node_to_clause,
)
from diffusionsat_torch.ops.tiled_ops import (
    TiledIncidence,
    tiled_lit_to_clause,
)


def seg_to_clause(x_nodes: torch.Tensor, batch: ANFBatch,
                  plans: ANFPlans | None = None) -> torch.Tensor:
    """Sum node features over each clause's members: [1+V+A, F] -> [C, F]."""
    if plans is not None:
        return plan_node_to_clause(x_nodes, plans)
    g = gather_rows(x_nodes, batch.edge_node_c) * \
        batch.edge_mask_c[:, None]
    return segment_sum(g, batch.edge_clause_c, batch.C)


def seg_to_nodes(x_clauses: torch.Tensor, batch: ANFBatch,
                 plans: ANFPlans | None = None) -> torch.Tensor:
    """Sum clause features over each node's clauses: [C, F] -> [1+V+A, F]."""
    if plans is not None:
        return plan_clause_to_node(x_clauses, plans)
    g = gather_rows(x_clauses, batch.edge_clause_n) * \
        batch.edge_mask_n[:, None]
    return segment_sum(g, batch.edge_node_n, batch.n_value_nodes)


def node_degrees(batch: ANFBatch) -> torch.Tensor:
    """[1+V+A, 1] clause count of every value node (an exact integer sum)."""
    return segment_sum(batch.edge_mask_n, batch.edge_node_n,
                        batch.n_value_nodes)[:, None]


def clause_degrees(batch: ANFBatch) -> torch.Tensor:
    """[C, 1] member count of every clause."""
    return segment_sum(batch.edge_mask_c, batch.edge_clause_c,
                        batch.C)[:, None]


def _sum_pair(a: torch.Tensor, b: torch.Tensor, batch: ANFBatch,
              plans: ANFPlans | None, tiles: TiledIncidence | None = None):
    """Clause sums of two [N, K] node arrays through one aggregation."""
    both = torch.cat([a, b], dim=-1)
    if tiles is not None:
        s = tiled_lit_to_clause(both, tiles, precision="highest")
    else:
        s = seg_to_clause(both, batch, plans)
    return torch.split(s, a.shape[-1], dim=-1)


def real_and(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """AND in the +/-1 encoding."""
    val = (1 - x) * (1 - y) / 4
    return 1 - 2 * val


def anf_value_real(logits: torch.Tensor, batch: ANFBatch,
                   plans: ANFPlans | None = None):
    """Per-clause product of member values via log-|.| + sign parity.
    Returns (clause_value [C, K], ands1, ands2). Padded clauses evaluate
    to +1 (zero loss downstream)."""
    n_maps = logits.shape[-1]
    one = -torch.ones((1, n_maps), dtype=logits.dtype, device=logits.device)
    values = torch.cat([one, torch.tanh(logits)], dim=0)       # [1+V, K]
    ands1 = gather_rows(values, batch.and1)                 # [A, K]
    ands2 = gather_rows(values, batch.and2)
    values_ands = torch.cat([values, real_and(ands1, ands2)], dim=0)
    log_val = torch.log(torch.abs(values_ands) + 1e-16)
    signs = (1 - torch.sign(values_ands)) / 2
    sum_logs, sum_signs = _sum_pair(log_val, signs, batch, plans)
    sum_signs = 1 - 2 * torch.remainder(sum_signs, 2)
    return torch.exp(sum_logs) * sum_signs, ands1, ands2


def cplx_normalize(x: torch.Tensor) -> torch.Tensor:
    """Clamp complex magnitude to <= 1 (real halves, then imaginary)."""
    x_real, x_im = torch.chunk(x, 2, dim=-1)
    inv_len = torch.rsqrt(torch.square(x_real) + torch.square(x_im) + 1e-6)
    inv_len = torch.clamp(inv_len, max=1.0)
    return torch.cat([x_real * inv_len, x_im * inv_len], dim=-1)


def cplx_and(a: torch.Tensor, b: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex-valued AND."""
    a_real, a_im = torch.chunk(a, 2, dim=-1)
    b_real, b_im = torch.chunk(b, 2, dim=-1)
    a1_real = (1 - a_real) / 2
    b1_real = (1 - b_real) / 2
    a1_im = -a_im / 2
    b1_im = -b_im / 2
    re = a1_real * b1_real
    im = a1_real * b1_im + a1_im * b1_real
    return 1 - 2 * re, -2 * im


def anf_value_cplx(logits: torch.Tensor, batch: ANFBatch,
                   use_norm: bool = False,
                   tiles: TiledIncidence | None = None,
                   plans: ANFPlans | None = None):
    """Complex per-clause evaluation via angle/log-length accumulation.

    logits: [V, 2K] (real halves then imaginary halves). Returns
    (clause_real [C, K], clause_im [C, K], ands1, ands2).
    """
    n_maps = logits.shape[-1] // 2
    dev = logits.device
    one = torch.cat([-torch.ones((1, n_maps), device=dev),
                     torch.zeros((1, n_maps), device=dev)], dim=-1)
    values = torch.tanh(logits)
    if use_norm:
        values = cplx_normalize(values)
    values = torch.cat([one, values], dim=0)                   # [1+V, 2K]
    ands1 = gather_rows(values, batch.and1)
    ands2 = gather_rows(values, batch.and2)
    and_real0, and_im0 = cplx_and(ands1, ands2)
    val_real, val_im = torch.chunk(values, 2, dim=-1)
    and_real = torch.cat([val_real, and_real0], dim=0)         # [1+V+A, K]
    and_im = torch.cat([val_im, and_im0], dim=0)
    angle = torch.atan2(and_im, and_real)
    log_len = 0.5 * torch.log(torch.square(and_real) +
                              torch.square(and_im) + 1e-16)
    sum_angles, sum_len = _sum_pair(angle, log_len, batch, plans, tiles)
    clause_real = torch.exp(sum_len) * torch.cos(sum_angles)
    clause_im = torch.exp(sum_len) * torch.sin(sum_angles)
    return clause_real, clause_im, ands1, ands2


def return_messages_cplx(batch: ANFBatch, loss_to_vars: torch.Tensor,
                         plans: ANFPlans | None = None) -> torch.Tensor:
    """Clause->node complex message aggregation: per-node product of clause
    messages in angle/log-length form, length averaged by node degree."""
    val_real, val_im = torch.chunk(loss_to_vars, 2, dim=-1)
    angle = torch.atan2(val_im, val_real)
    log_len = torch.log(torch.square(val_real) + torch.square(val_im) +
                        1e-16)
    sums = seg_to_nodes(torch.cat([angle, log_len], dim=-1), batch, plans)
    sum_angles, sum_len = torch.split(sums, angle.shape[-1], dim=-1)
    sum_len = sum_len / torch.clamp(node_degrees(batch), min=1.0)
    exp_len = torch.exp(sum_len)
    return torch.cat([exp_len * torch.cos(sum_angles),
                      exp_len * torch.sin(sum_angles)], dim=-1)


def is_graph_sat_anf(logits: torch.Tensor, batch: ANFBatch,
                     plans: ANFPlans | None = None) -> torch.Tensor:
    """[G, K] per-graph solved indicator: every equation of the graph
    evaluates to its target parity under the rounded assignment. Bit
    convention of the model: bit 1 -> strongly negative logit."""
    if logits.dim() == 1:
        logits = logits[:, None]
    hard = torch.where(torch.sigmoid(logits) > 0.5, -10.0, 10.0)
    cv, _, _ = anf_value_real(hard, batch, plans)          # padding -> +1
    ok_in_g = clause_segment_sum(batch, (cv > 0.5).to(torch.float32))
    total = batch.n_clauses_per_graph[:, None]
    return torch.clamp(ok_in_g + 1 - total, 0.0, 1.0) * \
        batch.graph_mask[:, None]

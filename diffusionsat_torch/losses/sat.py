"""Differentiable unsupervised CNF satisfiability losses.

Counterpart of the TPU package's `losses/sat.py` for the functions the
QuerySAT paths need. Padded clauses and edges are masked so they
contribute exactly 0. Losses take `logits` of shape [V] or [V, K] (K
parallel logit heads) and return per-clause [C, K] or scalars.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from diffusionsat_torch.graph.batch import SatBatch
from diffusionsat_torch.ops.graph_ops import (
    clause_segment_sum,
    clause_to_lit,
    lit_to_clause,
)
from diffusionsat_torch.ops.segsum import (
    BatchPlans,
    plan_clause_to_lit,
    plan_lit_to_clause,
)


def _as_2d(logits: torch.Tensor) -> torch.Tensor:
    return logits[:, None] if logits.dim() == 1 else logits


def literal_concat(x: torch.Tensor) -> torch.Tensor:
    """[V, K] -> [2V, K] literal layout: positive rows then negated rows."""
    return torch.cat([x, -x], dim=0)


def softplus_loss(logits: torch.Tensor, batch: SatBatch, power: float = 1.0
                  ) -> torch.Tensor:
    """Per-clause loss in [0, 1]: exp(-sum softplus(+/-logit)); 0 when
    satisfied strongly. Padded clauses return 0."""
    logits = _as_2d(logits)
    literals = F.softplus(literal_concat(logits))
    clauses_val = torch.exp(-lit_to_clause(batch, literals) * power)
    return clauses_val * batch.clause_mask[:, None]


def softplus_loss_and_grad(logits: torch.Tensor, batch: SatBatch,
                           plans: BatchPlans | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(softplus_loss per clause, gradient of its sum wrt logits) in closed
    form:

        d/dx_v sum_c exp(-S_c) = sum_{edges (lit,c) of v}
            -exp(-S_c) * sigmoid(+/-x_v) * (+/-1)

    i.e. one clause->literal aggregation of the clause values weighted by
    the literal sigmoid. With `plans` both aggregations run on the segsum
    kernel.
    """
    logits = _as_2d(logits)
    literals = literal_concat(logits)
    sp = F.softplus(literals)
    if plans is not None:
        clauses_val = torch.exp(-plan_lit_to_clause(sp, plans))
        clauses_val = clauses_val * batch.clause_mask[:, None]
        back = plan_clause_to_lit(clauses_val, plans)
    else:
        clauses_val = torch.exp(-lit_to_clause(batch, sp))
        clauses_val = clauses_val * batch.clause_mask[:, None]
        back = clause_to_lit(batch, clauses_val)              # [2V, K]
    per_lit = -back * torch.sigmoid(literals)                 # d softplus
    V = batch.V
    grad = per_lit[:V] - per_lit[V:]                          # +/- signs
    return clauses_val, grad


def softplus_mixed_loss(logits: torch.Tensor, batch: SatBatch,
                        eps: float = 1e-8) -> torch.Tensor:
    """linear * log loss product."""
    v = softplus_loss(logits, batch)
    # log(1 + eps) rounded through f32, as the TPU package computes it
    log_one = torch.log(torch.full((), 1 + eps, dtype=v.dtype,
                                   device=v.device))
    log_clauses = -(torch.log(1 - v + eps) - log_one)
    return v * log_clauses


def linear_loss(logits: torch.Tensor, batch: SatBatch) -> torch.Tensor:
    """Scalar linear loss: sum of relu(1 - clause true-literal mass) plus a
    binarization penalty sum(p^2 (p-1)^2)."""
    logits = _as_2d(logits)
    probs = torch.sigmoid(logits)
    literals = torch.cat([probs, 1 - probs], dim=0)
    clauses_val = lit_to_clause(batch, literals)
    clauses_val = torch.relu(1 - clauses_val) * batch.clause_mask[:, None]
    literal_loss = torch.sum(
        torch.square(probs) * torch.square(probs - 1) *
        batch.var_mask[:, None])
    return torch.sum(clauses_val) + literal_loss


def clause_sat_indicator(logits: torch.Tensor, batch: SatBatch
                         ) -> torch.Tensor:
    """[C, K] 1.0 where the rounded assignment satisfies the clause."""
    logits = _as_2d(logits)
    variables = torch.round(torch.sigmoid(logits))
    literals = torch.cat([variables, 1 - variables], dim=0)
    return torch.clamp(lit_to_clause(batch, literals), 0.0, 1.0)


def is_batch_sat(logits: torch.Tensor, batch: SatBatch) -> torch.Tensor:
    """0-d 1.0 iff every real clause is satisfied by the rounded assignment.
    Padded clauses count as satisfied."""
    sat = clause_sat_indicator(logits, batch)
    sat = torch.where(batch.clause_mask[:, None] > 0, sat, 1.0)
    return torch.min(sat)


def is_graph_sat(logits: torch.Tensor, batch: SatBatch) -> torch.Tensor:
    """[G, K] per-graph SAT indicator."""
    sat = clause_sat_indicator(logits, batch)               # [C, K]
    sat_in_g = clause_segment_sum(batch, sat)               # [G, K]
    total_in_g = batch.n_clauses_per_graph[:, None]
    return torch.clamp(sat_in_g + 1 - total_in_g, 0.0, 1.0) * \
        batch.graph_mask[:, None]

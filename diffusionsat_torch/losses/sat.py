"""Differentiable unsupervised CNF satisfiability losses.

Counterpart of the TPU package's `losses/sat.py`, every function of it.
Padded clauses and edges are masked so they contribute exactly 0. Losses
take `logits` of shape [V] or [V, K] (K parallel logit heads) and return
per-clause [C, K] or scalars.

A loss that aggregates literal values into clauses takes `plans`
(ops/segsum.BatchPlans): with them the aggregation runs on the segsum
kernel, and the plan drops the masked edges; without them it runs the
plain gather and segment sum of `ops/graph_ops.py`, which zeroes them.
Either way it sums literal-layout values ([2V, ...], positive rows then
negated ones), where the TPU package gathers some of them per edge.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from diffusionsat_torch.graph.batch import SatBatch
from diffusionsat_torch.ops.graph_ops import (
    clause_segment_sum,
    clause_to_lit,
    complete_literals,
    lit_to_clause,
)
from diffusionsat_torch.parallel.comm import all_reduce_min
from diffusionsat_torch.ops.segsum import (
    BatchPlans,
    aggregations,
    plan_clause_to_lit,
    plan_lit_to_clause,
)


def _as_2d(logits: torch.Tensor) -> torch.Tensor:
    return logits[:, None] if logits.dim() == 1 else logits


def literal_concat(x: torch.Tensor) -> torch.Tensor:
    """[V, K] -> [2V, K] literal layout: positive rows then negated rows."""
    return torch.cat([x, -x], dim=0)


def _l2c(batch: SatBatch, literals: torch.Tensor,
         plans: BatchPlans | None) -> torch.Tensor:
    """lit->clause sum [2V, F] -> [C, F], on the kernel with `plans`."""
    return aggregations(batch, plans)[0](literals)


def _log_one(eps: float, like: torch.Tensor) -> torch.Tensor:
    """log(1 + eps) rounded through f32, as the TPU package computes it."""
    return torch.log(torch.full((), 1 + eps, dtype=like.dtype,
                                device=like.device))


def softplus_loss(logits: torch.Tensor, batch: SatBatch, power: float = 1.0,
                  plans: BatchPlans | None = None) -> torch.Tensor:
    """Per-clause loss in [0, 1]: exp(-sum softplus(+/-logit)); 0 when
    satisfied strongly. Padded clauses return 0."""
    logits = _as_2d(logits)
    literals = F.softplus(literal_concat(logits))
    clauses_val = torch.exp(-_l2c(batch, literals, plans) * power)
    return clauses_val * batch.clause_mask[:, None]


def softplus_loss_and_grad(logits: torch.Tensor, batch: SatBatch,
                           plans: BatchPlans | None = None, group=None,
                           halo=None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(softplus_loss per clause, gradient of its sum wrt logits) in closed
    form:

        d/dx_v sum_c exp(-S_c) = sum_{edges (lit,c) of v}
            -exp(-S_c) * sigmoid(+/-x_v) * (+/-1)

    i.e. one clause->literal aggregation of the clause values weighted by
    the literal sigmoid. With `plans` both aggregations run on the segsum
    kernel. For a clause shard (`group`, and a `halo` view or none) the
    clause -> literal sum is completed over the group, after the planned
    per-shard sum too.
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
    back = complete_literals(back, group, halo)
    per_lit = -back * torch.sigmoid(literals)                 # d softplus
    V = batch.V
    grad = per_lit[:V] - per_lit[V:]                          # +/- signs
    return clauses_val, grad


def softplus_log_loss(logits: torch.Tensor, batch: SatBatch,
                      eps: float = 1e-8, plans: BatchPlans | None = None
                      ) -> torch.Tensor:
    """-log(1 - softplus_loss) per clause."""
    v = softplus_loss(logits, batch, plans=plans)
    return -(torch.log(1 - v + eps) - _log_one(eps, v))


def softplus_log_square_loss(logits: torch.Tensor, batch: SatBatch,
                             eps: float = 1e-8,
                             plans: BatchPlans | None = None
                             ) -> torch.Tensor:
    """Square of the log loss."""
    return torch.square(softplus_log_loss(logits, batch, eps, plans))


def softplus_square_loss(logits: torch.Tensor, batch: SatBatch,
                         plans: BatchPlans | None = None) -> torch.Tensor:
    """Square of softplus_loss."""
    return torch.square(softplus_loss(logits, batch, plans=plans))


def softplus_mixed_loss(logits: torch.Tensor, batch: SatBatch,
                        eps: float = 1e-8, plans: BatchPlans | None = None
                        ) -> torch.Tensor:
    """linear * log loss product."""
    v = softplus_loss(logits, batch, plans=plans)
    log_clauses = -(torch.log(1 - v + eps) - _log_one(eps, v))
    return v * log_clauses


def linear_clause_loss(logits: torch.Tensor, batch: SatBatch
                       ) -> torch.Tensor:
    """The clause term of `linear_loss`: the sum over the clauses of
    relu(1 - clause true-literal mass). On a clause shard it is the
    shard's part of the sum."""
    probs = torch.sigmoid(_as_2d(logits))
    literals = torch.cat([probs, 1 - probs], dim=0)
    clauses_val = lit_to_clause(batch, literals)
    clauses_val = torch.relu(1 - clauses_val) * batch.clause_mask[:, None]
    return torch.sum(clauses_val)


def linear_literal_loss(logits: torch.Tensor, batch: SatBatch
                        ) -> torch.Tensor:
    """The literal term of `linear_loss`: the binarization penalty
    sum(p^2 (p-1)^2) over the real variables (whole on every clause
    shard)."""
    probs = torch.sigmoid(_as_2d(logits))
    return torch.sum(torch.square(probs) * torch.square(probs - 1) *
                     batch.var_mask[:, None])


def linear_loss(logits: torch.Tensor, batch: SatBatch) -> torch.Tensor:
    """Scalar linear loss: sum of relu(1 - clause true-literal mass) plus a
    binarization penalty sum(p^2 (p-1)^2)."""
    return linear_clause_loss(logits, batch) + \
        linear_literal_loss(logits, batch)


def _edge_signs(batch: SatBatch) -> torch.Tensor:
    """+1 for positive-literal edges, -1 for negated (clause-sorted order)."""
    return torch.where(batch.edge_lit_c < batch.V, 1.0, -1.0)


def _edge_var(batch: SatBatch) -> torch.Tensor:
    """Variable index of each edge (clause-sorted order)."""
    return torch.where(batch.edge_lit_c < batch.V, batch.edge_lit_c,
                       batch.edge_lit_c - batch.V)


def _clause_prod_unsat(probs: torch.Tensor, batch: SatBatch,
                       plans: BatchPlans | None = None) -> torch.Tensor:
    """Per-clause product of per-literal 'unsat' probabilities: (1-p) for
    positive literals, p for negated. [V, K] -> [C, K].

    The product is exp of a sum of logs, with the exactly-zero factors
    counted beside it (a clause with one is 0): both sums in one
    lit->clause aggregation of literal-layout values. A masked edge
    contributes log 1 = 0 and no zero factor."""
    K = probs.shape[1]
    unsat = torch.cat([1.0 - probs, probs], dim=0)          # [2V, K]
    summed = _l2c(batch, torch.cat(
        [torch.log(torch.clamp(unsat, min=1e-30)),
         (unsat <= 0).to(unsat.dtype)], dim=1), plans)
    prod = torch.exp(summed[:, :K])
    return torch.where(summed[:, K:] > 0, 0.0, prod)


def sigmoid_log_loss(logits: torch.Tensor, batch: SatBatch,
                     eps: float = 1e-8, plans: BatchPlans | None = None
                     ) -> torch.Tensor:
    """-log(1 - prod of unsat-literal probabilities) per clause. Padded
    clauses return 0."""
    probs = torch.sigmoid(_as_2d(logits))
    varsum = _clause_prod_unsat(probs, batch, plans)
    loss = -(torch.log(1 - varsum + eps) - _log_one(eps, varsum))
    return loss * batch.clause_mask[:, None]


def unsat_clause_count(logits: torch.Tensor, batch: SatBatch,
                       plans: BatchPlans | None = None) -> torch.Tensor:
    """Number of unsatisfied clauses under the rounded assignment (0-d)."""
    probs = torch.round(torch.sigmoid(_as_2d(logits)))
    varsum = _clause_prod_unsat(probs, batch, plans)
    return torch.sum(varsum * batch.clause_mask[:, None])


def max_clauses_loss(logits: torch.Tensor, batch: SatBatch,
                     temp: float = 1.0, plans: BatchPlans | None = None
                     ) -> torch.Tensor:
    """Per-clause softmax-weighted literal value: the literal value is p
    for positive, (1-p) for negated; returns softmax_avg(v/temp) per clause
    (0 for a padded clause)."""
    probs = torch.sigmoid(_as_2d(logits))
    K = probs.shape[1]
    v = torch.cat([probs, 1.0 - probs], dim=0) / temp         # [2V, K]
    w = torch.exp(v)
    summed = _l2c(batch, torch.cat([w * v, w], dim=1), plans)
    return summed[:, :K] / torch.clamp(summed[:, K:], min=1e-20)


def min_max_loss(logits: torch.Tensor, batch: SatBatch, temp: float = 1.0,
                 plans: BatchPlans | None = None) -> torch.Tensor:
    """Softmin over clauses of max_clauses_loss, then a step-function
    transform (0-d)."""
    clauses = torch.mean(max_clauses_loss(logits, batch, temp, plans),
                         dim=-1)
    w = torch.exp(-clauses / temp) * batch.clause_mask
    min_value = torch.sum(w * clauses) / torch.clamp(torch.sum(w),
                                                     min=1e-20)
    skm = torch.pow(1 - min_value, 10)
    return skm / (skm + torch.pow(min_value, 10))


def log_max_loss(logits: torch.Tensor, batch: SatBatch, temp: float = 1.0,
                 plans: BatchPlans | None = None) -> torch.Tensor:
    """Per-clause step-function loss [C]."""
    clauses = torch.mean(max_clauses_loss(logits, batch, temp, plans),
                         dim=-1)
    skm = torch.pow(1 - clauses, 10)
    return (skm / (skm + torch.pow(clauses, 10))) * batch.clause_mask


def clause_sat_indicator(logits: torch.Tensor, batch: SatBatch,
                         plans: BatchPlans | None = None) -> torch.Tensor:
    """[C, K] 1.0 where the rounded assignment satisfies the clause."""
    logits = _as_2d(logits)
    variables = torch.round(torch.sigmoid(logits))
    literals = torch.cat([variables, 1 - variables], dim=0)
    return torch.clamp(_l2c(batch, literals, plans), 0.0, 1.0)


def is_batch_sat(logits: torch.Tensor, batch: SatBatch,
                 plans: BatchPlans | None = None,
                 group=None) -> torch.Tensor:
    """0-d 1.0 iff every real clause is satisfied by the rounded assignment
    (of every clause shard of `group`). Padded clauses count as
    satisfied."""
    sat = clause_sat_indicator(logits, batch, plans)
    sat = torch.where(batch.clause_mask[:, None] > 0, sat, 1.0)
    out = torch.min(sat)
    if group is not None:
        out = all_reduce_min(out, group)
    return out


def is_graph_sat(logits: torch.Tensor, batch: SatBatch,
                 group=None) -> torch.Tensor:
    """[G, K] per-graph SAT indicator (over every clause shard of
    `group`)."""
    sat = clause_sat_indicator(logits, batch)               # [C, K]
    sat_in_g = clause_segment_sum(batch, sat, group)        # [G, K]
    total_in_g = batch.n_clauses_per_graph[:, None]
    return torch.clamp(sat_in_g + 1 - total_in_g, 0.0, 1.0) * \
        batch.graph_mask[:, None]

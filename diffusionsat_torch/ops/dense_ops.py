"""Batched dense graph ops and SAT losses over DenseSatBatch blocks.

Counterpart of the TPU package's `ops/dense_ops.py`. Semantics match
`ops/graph_ops.py` and `losses/sat.py`; the representation is per-graph
dense incidence, so every aggregation is a batched matrix product or a
masked axis reduction: no gathers and no segment ops. The incidence
products are library products, as the TPU package leaves them to its
compiler, and always return f32: `torch.einsum` for f32 operands, and
`ops/lowp.bmm_f32acc` for bf16 ones.

`INCIDENCE_PRECISION` is the module knob for these two products only; the
training script sets it (`--incidence_precision`) for the length of a run
through `incidence_precision(mode)`, which restores the value it found.
The process-wide TF32 switch (`device.py` turns it off) is never touched:

- "highest": full f32, the counterpart of that package's HIGHEST.
- "high": that package's three-pass bf16 has no twin on this card; the
  nearest mode it offers is TF32. The feature operand is rounded to TF32
  (10 mantissa bits) and the product accumulates in f32, which is the
  value a TF32 tensor-core product gives. The incidence's small integers
  are exact. The backward is not rounded.
- "default": bf16 operands with f32 accumulation. Exact for the
  incidence; the features round to 8 mantissa bits, the features'
  gradients too (they are returned in the features' type).

Under the block-bf16 flow both operands arrive as bf16 and every mode
computes the same bf16 product with f32 accumulation. A bf16 incidence
with f32 features (the query gradient, the SAT check) is promoted to f32
and then follows the mode.

`bmm_f32acc` upcasts its operands to f32 only on the CPU. On the card the
forward is a bf16 tensor-core product with an f32 result, and the
backward multiplies the f32 cotangent with the bf16 incidence on tensor
cores, the cotangent cut exactly into three bf16 parts
(`ops/split_mm.py`): no f32 copy of a bf16 operand is made.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from diffusionsat_torch.graph.dense_batch import DenseSatBatch
from diffusionsat_torch.ops.lowp import bmm_f32acc

INCIDENCE_PRECISION = "highest"
PRECISIONS = ("highest", "high", "default")


@contextlib.contextmanager
def incidence_precision(mode: str):
    """`INCIDENCE_PRECISION` set to `mode` inside the block and put back to
    what it was on the way out."""
    global INCIDENCE_PRECISION
    if mode not in PRECISIONS:
        raise ValueError(f"INCIDENCE_PRECISION must be one of {PRECISIONS}, "
                         f"got {mode!r}")
    before, INCIDENCE_PRECISION = INCIDENCE_PRECISION, mode
    try:
        yield
    finally:
        INCIDENCE_PRECISION = before


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits (to nearest, ties away
    from zero in magnitude), with a straight-through gradient."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x.detach())


def _incidence_product(inc: torch.Tensor, x: torch.Tensor, to_lit: bool
                       ) -> torch.Tensor:
    mode = INCIDENCE_PRECISION
    if mode not in PRECISIONS:
        raise ValueError(f"INCIDENCE_PRECISION must be one of {PRECISIONS}, "
                         f"got {mode!r}")
    bf = torch.bfloat16
    if mode == "default" or (inc.dtype == bf and x.dtype == bf):
        a = inc.to(bf)
        return bmm_f32acc(a.transpose(1, 2) if to_lit else a, x.to(bf))
    if inc.dtype != torch.float32 or x.dtype != torch.float32:
        inc, x = inc.float(), x.float()
    if mode == "high":
        x = _round_tf32(x)
    return torch.einsum("gcl,gcf->glf" if to_lit else "gcl,glf->gcf", inc, x)


def lit_to_clause(batch: DenseSatBatch, lit_features: torch.Tensor
                  ) -> torch.Tensor:
    """[G, 2Vg, F] -> [G, Cg, F]: out[g,c] = sum_l inc[g,c,l] * x[g,l]."""
    return _incidence_product(batch.incidence, lit_features, to_lit=False)


def clause_to_lit(batch: DenseSatBatch, clause_features: torch.Tensor
                  ) -> torch.Tensor:
    """[G, Cg, F] -> [G, 2Vg, F]: the transpose aggregation."""
    return _incidence_product(batch.incidence, clause_features, to_lit=True)


def literal_degrees(batch: DenseSatBatch) -> torch.Tensor:
    """[G, 2Vg, 1] clause count per literal."""
    return torch.sum(batch.incidence, dim=1)[..., None]


def clause_degrees(batch: DenseSatBatch) -> torch.Tensor:
    """[G, Cg, 1] literal count per clause."""
    return torch.sum(batch.incidence, dim=2)[..., None]


def var_graph_sum(batch: DenseSatBatch, var_features: torch.Tensor
                  ) -> torch.Tensor:
    """Per-graph masked sum over variables: [G, Vg, F] -> [G, F]."""
    return torch.sum(var_features * batch.var_mask[..., None], dim=1)


def clause_graph_sum(batch: DenseSatBatch, clause_features: torch.Tensor
                     ) -> torch.Tensor:
    """Per-graph masked sum over clauses: [G, Cg, F] -> [G, F]."""
    return torch.sum(clause_features * batch.clause_mask[..., None], dim=1)


def _pair_norm(x: torch.Tensor, mean: torch.Tensor, epsilon: float
               ) -> torch.Tensor:
    x = x - mean
    variance = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(variance + epsilon)


def pair_norm_vars(x: torch.Tensor, batch: DenseSatBatch,
                   epsilon: float = 1e-6) -> torch.Tensor:
    """PairNorm over variable nodes: subtract the graph mean, rms over
    features. [G, Vg, F]."""
    counts = torch.clamp(batch.n_vars_per_graph, min=1.0)[:, None, None]
    mean = torch.sum(x * batch.var_mask[..., None], dim=1,
                     keepdim=True) / counts
    return _pair_norm(x, mean, epsilon)


def pair_norm_clauses(x: torch.Tensor, batch: DenseSatBatch,
                      epsilon: float = 1e-6) -> torch.Tensor:
    """PairNorm over clause nodes. [G, Cg, F]."""
    counts = torch.clamp(batch.n_clauses_per_graph, min=1.0)[:, None, None]
    mean = torch.sum(x * batch.clause_mask[..., None], dim=1,
                     keepdim=True) / counts
    return _pair_norm(x, mean, epsilon)


# --- losses (dense forms of losses/sat.py) --------------------------------


def literal_concat(x: torch.Tensor) -> torch.Tensor:
    """[G, Vg, K] -> [G, 2Vg, K]: positive rows then negated rows."""
    return torch.cat([x, -x], dim=1)


def softplus_loss(logits: torch.Tensor, batch: DenseSatBatch,
                  power: float = 1.0) -> torch.Tensor:
    """Per-clause exp(-sum softplus(+/-logit)) loss, 0 on padded clauses."""
    literals = F.softplus(literal_concat(logits))
    clauses_val = torch.exp(-lit_to_clause(batch, literals) * power)
    return clauses_val * batch.clause_mask[..., None]


def softplus_loss_and_grad(logits: torch.Tensor, batch: DenseSatBatch
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(per-clause softplus loss, closed-form d(sum loss)/d logits): the
    dense form of `losses.sat.softplus_loss_and_grad`."""
    literals = literal_concat(logits)
    sp = F.softplus(literals)
    clauses_val = torch.exp(-lit_to_clause(batch, sp))
    clauses_val = clauses_val * batch.clause_mask[..., None]
    back = clause_to_lit(batch, clauses_val)
    per_lit = -back * torch.sigmoid(literals)
    Vg = batch.Vg
    grad = per_lit[:, :Vg] - per_lit[:, Vg:]
    return clauses_val, grad


def softplus_mixed_loss(logits: torch.Tensor, batch: DenseSatBatch,
                        eps: float = 1e-8) -> torch.Tensor:
    """linear * log loss product."""
    v = softplus_loss(logits, batch)
    # log(1 + eps) rounded through f32, as the TPU package computes it
    log_one = torch.log(torch.full((), 1 + eps, dtype=v.dtype,
                                   device=v.device))
    log_clauses = -(torch.log(1 - v + eps) - log_one)
    return v * log_clauses


def linear_loss(logits: torch.Tensor, batch: DenseSatBatch) -> torch.Tensor:
    """Scalar linear loss: sum of relu(1 - clause true-literal mass) plus a
    binarization penalty sum(p^2 (p-1)^2)."""
    probs = torch.sigmoid(logits)
    literals = torch.cat([probs, 1 - probs], dim=1)
    clauses_val = lit_to_clause(batch, literals)
    clauses_val = torch.relu(1 - clauses_val) * batch.clause_mask[..., None]
    literal_loss = torch.sum(torch.square(probs) * torch.square(probs - 1) *
                             batch.var_mask[..., None])
    return torch.sum(clauses_val) + literal_loss


def clause_sat_indicator(logits: torch.Tensor, batch: DenseSatBatch
                         ) -> torch.Tensor:
    """[G, Cg, K] 1.0 where the rounded assignment satisfies the clause."""
    variables = torch.round(torch.sigmoid(logits))
    literals = torch.cat([variables, 1 - variables], dim=1)
    return torch.clamp(lit_to_clause(batch, literals), 0.0, 1.0)


def is_batch_sat(logits: torch.Tensor, batch: DenseSatBatch) -> torch.Tensor:
    """0-d 1.0 iff every real clause is satisfied; padded clauses count as
    satisfied."""
    sat = clause_sat_indicator(logits, batch)
    sat = torch.where(batch.clause_mask[..., None] > 0, sat, 1.0)
    return torch.min(sat)


def is_graph_sat(logits: torch.Tensor, batch: DenseSatBatch) -> torch.Tensor:
    """[G, K] per-graph SAT indicator."""
    sat = clause_sat_indicator(logits, batch)
    sat_in_g = clause_graph_sum(batch, sat)
    total = batch.n_clauses_per_graph[:, None]
    return torch.clamp(sat_in_g + 1 - total, 0.0, 1.0) * \
        batch.graph_mask[:, None]

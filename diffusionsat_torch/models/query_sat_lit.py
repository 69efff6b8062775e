"""QuerySATLit: the QuerySAT variant on literal states.

Counterpart of the TPU package's `models/query_sat_lit.py`: zero-state
literal and clause embeddings, the query gradient of the clause loss,
clause and literal MLP updates with PairNorm and a 0.1 residual, the sqrt
per-graph softplus_mixed logit loss, and a supervised self-training
cross-entropy once the batch is solved.

- The query gradient is taken in closed form
  (`losses.sat.softplus_loss_and_grad`), whose values equal the TPU
  package's nested gradient; the outer backward then differentiates
  first-order ops, through the kernel on the card.
- The per-round noise ([V, 4] a round) is drawn from `generator` before
  the loop, or injected as `round_noise` ([rounds, V, 4]).
- The round loop runs every round and exits early only by masking. With
  `plans` (ops/segsum.BatchPlans) every literal-clause aggregation, the
  losses' included, runs on the segsum kernel, and so do their backwards.
"""

from __future__ import annotations

import dataclasses

import torch

from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.graph.batch import SatBatch
from diffusionsat_torch.losses.sat import (
    softplus_loss_and_grad,
    softplus_mixed_loss,
    unsat_clause_count,
)
from diffusionsat_torch.models.query_sat import _blend, params_to
from diffusionsat_torch.nn.mlp import MLPConfig, mlp_apply, mlp_init
from diffusionsat_torch.nn.normalization import pair_norm_clauses
from diffusionsat_torch.ops.graph_ops import (
    clause_segment_sum,
    graph_gather_vars,
    var_segment_sum,
)
from diffusionsat_torch.ops.segsum import BatchPlans, aggregations


@dataclasses.dataclass(frozen=True)
class QuerySATLitConfig:
    feature_maps: int = 128
    query_maps: int = 32
    msg_layers: int = 3
    vote_layers: int = 3
    train_rounds: int = 32
    test_rounds: int = 64
    add_gradient: bool = True
    use_message_passing: bool = False

    def mlp_configs(self):
        f, q = self.feature_maps, self.query_maps
        c_in = (2 * f + q) if self.use_message_passing else (f + q)
        l_in = (f + 2 * q) if self.add_gradient else (f + q)
        return {
            "clauses_update": (MLPConfig(self.vote_layers, f * 3, f + q),
                               c_in),
            "literals_update": (MLPConfig(self.vote_layers, f * 2, f), l_in),
            "literals_output": (MLPConfig(self.vote_layers, f, 1), 2 * f),
            "literals_query": (MLPConfig(self.msg_layers, q * 2, q),
                               2 * f + 4),
        }


def query_sat_lit_init(generator: torch.Generator, cfg: QuerySATLitConfig
                       ) -> dict:
    """Random params on the generator's device."""
    return {name: mlp_init(generator, mcfg, in_dim)
            for name, (mcfg, in_dim) in cfg.mlp_configs().items()}


def _zero_state(n_units: int, n_features: int, device: torch.device,
                stddev: float = 0.25) -> torch.Tensor:
    """One-hot minus uniform, scaled: the initial state of every row."""
    onehot = torch.zeros((n_units, n_features), device=device)
    onehot[:, 0] = 1.0
    onehot = onehot - 1.0 / n_features
    return onehot * torch.sqrt(torch.tensor(
        n_features, dtype=torch.float32, device=device)) * stddev


def _pair_norm_literals(x: torch.Tensor, batch: SatBatch, eps: float = 1e-6
                        ) -> torch.Tensor:
    """PairNorm over the 2V literal rows with per-graph means over both
    polarities. The TPU package sums the rows over the doubled graph ids
    in one scatter; here each half is summed over `var_graph` (sorted) and
    the two sums added."""
    V = batch.V
    mask = batch.var_mask[:, None]
    sums = var_segment_sum(batch, x[:V] * mask) + \
        var_segment_sum(batch, x[V:] * mask)
    counts = torch.clamp(batch.n_vars_per_graph * 2, min=1.0)[:, None]
    mean_v = graph_gather_vars(batch, sums / counts)
    x = x - torch.cat([mean_v, mean_v], dim=0)
    variance = torch.mean(torch.square(x), dim=1, keepdim=True)
    return x * torch.rsqrt(variance + eps)


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                   var_mask: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid cross-entropy over the real variables (0-d)."""
    ce = torch.clamp(logits, min=0) - logits * labels + \
        torch.log1p(torch.exp(-torch.abs(logits)))
    return torch.sum(ce * var_mask[:, None]) / \
        torch.clamp(torch.sum(var_mask), min=1.0)


def draw_round_noise(generator: torch.Generator | None, rounds: int,
                     rows: int, device: torch.device) -> torch.Tensor:
    """[rounds, rows, 4] standard normal draws, one [rows, 4] a round."""
    return torch.randn((rounds, rows, 4), generator=generator, device=device)


def query_sat_lit_apply(params: dict, cfg: QuerySATLitConfig,
                        batch: SatBatch,
                        generator: torch.Generator | None = None,
                        training: bool = False, rounds: int | None = None,
                        plans: BatchPlans | None = None,
                        round_noise: torch.Tensor | None = None,
                        device: str | torch.device = "cuda"):
    """Run the rounds (`cfg.train_rounds` when training, else
    `cfg.test_rounds`). Returns (logits [V, 1] of the last active round,
    loss, steps_taken, {"solved"}). `round_noise` ([rounds, V, 4])
    replaces the per-round draws from `generator`."""
    dev = resolve_device(device)
    if rounds is None:
        rounds = cfg.train_rounds if training else cfg.test_rounds
    with torch.set_grad_enabled(training):
        batch = batch.to(dev)
        params = params_to(params, dev)
        if plans is not None:
            plans = plans.to(dev)
        if round_noise is None:
            round_noise = draw_round_noise(generator, rounds, batch.V, dev)
        return _query_sat_lit_apply(params, cfg, batch, rounds, plans,
                                    round_noise.to(dev), dev)


def _query_sat_lit_apply(params, cfg, batch, rounds, plans, round_noise,
                         dev):
    mcfgs = cfg.mlp_configs()
    V, Q = batch.V, cfg.query_maps
    l2c, c2l = aggregations(batch, plans)

    def mlp(name, x):
        return mlp_apply(params[name], mcfgs[name][0], x)

    literals = _zero_state(2 * V, cfg.feature_maps, dev)
    clause_state = _zero_state(batch.C, cfg.feature_maps, dev)
    last_logits = torch.zeros((V, 1), device=dev)
    loss_sum = torch.zeros((), device=dev)
    sup_loss = torch.zeros((), device=dev)
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for r in range(rounds):
        v1 = torch.cat([literals[:V], literals[V:], round_noise[r]], dim=-1)
        query = mlp("literals_query", v1)
        clauses_loss, var_grad = softplus_loss_and_grad(query, batch,
                                                        plans=plans)
        literals_grad = torch.cat([var_grad, -var_grad], dim=0)

        if cfg.use_message_passing:
            clause_unit = torch.cat(
                [clause_state, l2c(literals), clauses_loss], dim=-1)
        else:
            clause_unit = torch.cat([clause_state, clauses_loss], dim=-1)
        clause_data = mlp("clauses_update", clause_unit)

        new_clause_value = pair_norm_clauses(clause_data[:, Q:], batch) * 0.25
        new_clause_state = new_clause_value + 0.1 * clause_state

        literals_loss = c2l(clause_data[:, :Q])
        if cfg.add_gradient:
            unit = torch.cat([literals, literals_grad, literals_loss], dim=-1)
        else:
            unit = torch.cat([literals, literals_loss], dim=-1)
        new_literals = _pair_norm_literals(mlp("literals_update", unit),
                                           batch) * 0.25
        new_literals = new_literals + 0.1 * literals

        logits = mlp("literals_output", torch.cat(
            [new_literals[:V], new_literals[V:]], dim=-1))

        per_clause_loss = softplus_mixed_loss(logits, batch, plans=plans)
        per_graph_loss = clause_segment_sum(batch, per_clause_loss)
        masked_pgl = torch.where(batch.graph_mask[:, None] > 0,
                                 per_graph_loss + 1e-6, 0.0)
        logit_loss = torch.sum(torch.sqrt(masked_pgl))

        n_unsat = unsat_clause_count(logits, batch, plans)
        sat_now = (logit_loss < 0.5) & (n_unsat == 0)

        active = ~done
        newly_done = active & sat_now
        # supervised self-training: the previous logits against the
        # assignment that solved the batch
        labels = torch.round(torch.sigmoid(logits))
        sup_loss = torch.where(
            newly_done, _cross_entropy(last_logits, labels, batch.var_mask),
            sup_loss)

        loss_sum = loss_sum + torch.where(active, logit_loss, 0.0)
        steps = steps + active.to(torch.int32)
        last_logits = torch.where(active, logits, last_logits)

        cont = active & ~sat_now
        literals = torch.where(cont, _blend(new_literals), torch.where(
            newly_done, new_literals, literals))
        clause_state = torch.where(cont, _blend(new_clause_state),
                                   torch.where(newly_done, new_clause_state,
                                               clause_state))
        done = done | sat_now

    loss = loss_sum / float(rounds) + sup_loss
    steps_taken = torch.clamp(steps - 1, min=0)
    return last_logits, loss, steps_taken, {"solved": done}

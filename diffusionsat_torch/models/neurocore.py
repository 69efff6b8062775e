"""NeuroCore and SimpleNeuroSAT: tied-weight literal/clause update models.

Counterpart of the TPU package's `models/neurocore.py`. Both use relu6
MLPs, per-feature moment normalization over the node axis, learned init
and message scales, and the sqrt per-graph softplus_mixed loss averaged
over the rounds. SimpleNeuroSAT (`use_query=True`) keeps variable-space
states and feeds the differentiable clause loss of a query MLP's output
into the clause update; its diagnostics forward (`diagnostics=True`)
returns the query statistics at rounds 0, 16 and the last active one, and
the per-round agreement of the rounded queries.

`moments_normalize` averages over every row, padding included, so the
results depend on the batch's bucket. The round loop runs every round and
exits early only by masking. With `plans` (ops/segsum.BatchPlans) every
literal-clause aggregation, the losses' and the SAT check's included, runs
on the segsum kernel, and so do their backwards.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.graph.batch import SatBatch
from diffusionsat_torch.losses.sat import (
    is_batch_sat,
    softplus_loss,
    softplus_mixed_loss,
)
from diffusionsat_torch.models.neuro_sat import flip
from diffusionsat_torch.models.query_sat import _blend, params_to
from diffusionsat_torch.nn.mlp import MLPConfig, mlp_apply, mlp_init
from diffusionsat_torch.ops.graph_ops import clause_segment_sum
from diffusionsat_torch.ops.segsum import BatchPlans, aggregations


def moments_normalize(x: torch.Tensor, axis: int = 0, eps: float = 1e-6
                      ) -> torch.Tensor:
    """Standardize by the mean and variance over the node axis (every row,
    padding included)."""
    mean = torch.mean(x, dim=axis, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axis, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


@dataclasses.dataclass(frozen=True)
class NeuroCoreConfig:
    feature_maps: int = 128
    train_rounds: int = 32
    test_rounds: int = 64
    n_update_layers: int = 2
    n_score_layers: int = 2
    # True -> SimpleNeuroSAT: variable-space states + query mechanism
    use_query: bool = False
    # return the per-round query diagnostics through aux (SimpleNeuroSAT
    # only): meant for a separate diagnostics forward
    diagnostics: bool = False

    def mlp_configs(self):
        f = self.feature_maps
        if self.use_query:
            l_in = 3 * f       # [L, CL_pos, CL_neg]
            # [C, clauses_loss (f columns of the query), LC_msgs (f // 2
            # columns: the literals are the feature halves of L)]
            c_in = f + f + f // 2
        else:
            l_in = 3 * f       # [L, CL_msgs, flip(L)]
            c_in = 2 * f       # [C, LC_msgs]
        cfgs = {
            "L_updates": (MLPConfig(self.n_update_layers + 1, 3 * f, f,
                                    activation="relu6"), l_in),
            "C_updates": (MLPConfig(self.n_update_layers + 1, 2 * f, f,
                                    activation="relu6"), c_in),
            "V_score": (MLPConfig(self.n_score_layers + 1, 2 * f, 1,
                                  activation="relu6"),
                        2 * f if not self.use_query else f),
        }
        if self.use_query:
            cfgs["variables_query"] = (
                MLPConfig(self.n_update_layers + 1, f, f), f)
        return cfgs


def neurocore_init(generator: torch.Generator, cfg: NeuroCoreConfig
                   ) -> dict:
    """Random params on the generator's device; the four scales are 0-d."""
    f, dev = cfg.feature_maps, generator.device
    params = {
        "L_init_scale": torch.tensor(1.0 / math.sqrt(f), device=dev),
        "C_init_scale": torch.tensor(1.0 / math.sqrt(f), device=dev),
        "LC_scale": torch.tensor(0.1, device=dev),
        "CL_scale": torch.tensor(0.1, device=dev),
    }
    for name, (mcfg, in_dim) in cfg.mlp_configs().items():
        params[name] = mlp_init(generator, mcfg, in_dim)
    return params


def _query_stats(query: torch.Tensor, logits: torch.Tensor,
                 batch: SatBatch, l2c, c2l) -> dict:
    """How well the query MLP's rounded output agrees with the current
    logits, and what fraction of clauses the rounded query satisfies
    (0-d tensors, padding masked)."""
    vmask = batch.var_mask[:, None]                       # [V, 1]
    n_vars = torch.clamp(torch.sum(batch.var_mask), min=1.0)
    n_clauses = torch.clamp(torch.sum(batch.clause_mask), min=1.0)

    current_labels = torch.round(torch.sigmoid(logits))   # [V, 1]
    round_query = torch.round(torch.sigmoid(query))       # [V, f]
    match = (current_labels == round_query).to(torch.float32) * vmask

    # per-variable clause-occurrence counts (pos + neg literal degrees)
    lit_deg = c2l(torch.ones((batch.C, 1), device=query.device))  # [2V, 1]
    V = batch.V
    vars_count = lit_deg[:V] + lit_deg[V:]                # [V, 1]

    denom = n_vars * match.shape[-1]
    sig_q = torch.sigmoid(query) * vmask
    not_match = (1.0 - match) * vmask
    stats = {
        "query_logits_match": torch.sum(match) / denom,
        "vars_in_clauses_matched": torch.sum(vars_count * match) / denom,
        "vars_in_clauses_not_matched":
            torch.sum(vars_count * not_match) / denom,
        "matching_mean": torch.sum(sig_q * match) / denom,
        "not_matching_mean": torch.sum(sig_q * not_match) / denom,
    }
    lit = torch.cat([round_query, 1.0 - round_query], dim=0)
    sat_c = torch.clamp(l2c(lit), 0.0, 1.0) * batch.clause_mask[:, None]
    stats["sat_clauses"] = torch.sum(sat_c) / (n_clauses * lit.shape[-1])
    return stats


def neurocore_apply(params: dict, cfg: NeuroCoreConfig, batch: SatBatch,
                    generator: torch.Generator | None = None,
                    training: bool = False, rounds: int | None = None,
                    plans: BatchPlans | None = None,
                    device: str | torch.device = "cuda"):
    """Run the rounds (`cfg.train_rounds` when training, else
    `cfg.test_rounds`). Returns (logits [V, 1] of the last active round,
    loss, steps_taken, aux); aux holds "solved", and with
    `cfg.diagnostics` (SimpleNeuroSAT) "query_stats" and "queries_diff".
    Draws nothing; `generator` is there for the common apply contract."""
    dev = resolve_device(device)
    if rounds is None:
        rounds = cfg.train_rounds if training else cfg.test_rounds
    with torch.set_grad_enabled(training):
        batch = batch.to(dev)
        params = params_to(params, dev)
        if plans is not None:
            plans = plans.to(dev)
        return _neurocore_apply(params, cfg, batch, rounds, plans, dev)


def _neurocore_apply(params, cfg, batch, rounds, plans, dev):
    mcfgs = cfg.mlp_configs()
    V, f = batch.V, cfg.feature_maps
    l2c, c2l = aggregations(batch, plans)
    diag = cfg.use_query and cfg.diagnostics

    def mlp(name, x):
        return mlp_apply(params[name], mcfgs[name][0], x)

    L = torch.ones((V if cfg.use_query else 2 * V, f), device=dev) * \
        params["L_init_scale"]
    C = torch.ones((batch.C, f), device=dev) * params["C_init_scale"]
    last_logits = torch.zeros((V, 1), device=dev)
    loss_sum = torch.zeros((), device=dev)
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    prev_q = torch.zeros((V, f), device=dev)
    ys: list[dict] = []
    for _ in range(rounds):
        if cfg.use_query:
            lit1, lit2 = torch.chunk(L, 2, dim=1)
            LC_msgs = l2c(torch.cat([lit1, lit2], dim=0)) * \
                params["LC_scale"]
            query = mlp("variables_query", L)
            clauses_loss = softplus_loss(query, batch, plans=plans)
            C_new = moments_normalize(mlp("C_updates", torch.cat(
                [C, clauses_loss, LC_msgs], dim=-1)))
            CL_msgs = c2l(C_new) * params["CL_scale"]
            L_new = moments_normalize(mlp("L_updates", torch.cat(
                [L, CL_msgs[:V], CL_msgs[V:]], dim=-1)))
            logits = mlp("V_score", L_new)
        else:
            LC_msgs = l2c(L) * params["LC_scale"]
            C_new = moments_normalize(mlp("C_updates", torch.cat(
                [C, LC_msgs], dim=-1)))
            CL_msgs = c2l(C_new) * params["CL_scale"]
            L_new = moments_normalize(mlp("L_updates", torch.cat(
                [L, CL_msgs, flip(L, V)], dim=-1)))
            v, v_n = torch.chunk(L_new, 2, dim=0)
            logits = mlp("V_score", torch.cat([v, v_n], dim=-1))

        sat_now = is_batch_sat(logits, batch, plans) >= 1.0
        active = ~done
        # the loss of the round that satisfies the batch is not accumulated
        accumulate = active & ~sat_now

        per_clause_loss = softplus_mixed_loss(logits, batch, plans=plans)
        per_graph_loss = clause_segment_sum(batch, per_clause_loss)
        masked_pgl = torch.where(batch.graph_mask[:, None] > 0,
                                 per_graph_loss + 1e-6, 0.0)
        round_loss = torch.sum(torch.sqrt(masked_pgl))

        L = torch.where(active, L_new, L)
        C = torch.where(active, C_new, C)
        last_logits = torch.where(active, logits, last_logits)
        loss_sum = loss_sum + torch.where(accumulate, round_loss, 0.0)
        steps = steps + active.to(torch.int32)
        if cfg.use_query:   # SimpleNeuroSAT's stop-gradient blend
            L = torch.where(accumulate, _blend(L), L)
            C = torch.where(accumulate, _blend(C), C)
        done = done | sat_now
        if diag:
            # the fraction of rounded query bits unchanged since the last
            # round
            same = torch.round(torch.sigmoid(query)) == \
                torch.round(torch.sigmoid(prev_q))
            n_active = torch.clamp(torch.sum(batch.var_mask), min=1.0)
            row = _query_stats(query, logits, batch, l2c, c2l)
            row["queries_diff"] = torch.sum(
                same.to(torch.float32) * batch.var_mask[:, None]) / \
                (n_active * query.shape[-1])
            ys.append(row)
            prev_q = query

    loss = loss_sum / float(rounds)
    steps_taken = torch.clamp(steps - 1, min=0)
    aux = {"solved": done}
    if diag:
        stacked = {k: torch.stack([r[k] for r in ys]) for k in ys[0]}
        at = {"0": 0, "16": min(16, rounds - 1), "last": steps_taken.long()}
        aux["query_stats"] = {
            name: {k: v[i] for k, v in stacked.items()
                   if k != "queries_diff"} for name, i in at.items()}
        aux["queries_diff"] = stacked["queries_diff"]
    return last_logits, loss, steps_taken, aux


# SimpleNeuroSAT is NeuroCore with the query mechanism on: a registry entry
# of its own
@dataclasses.dataclass(frozen=True)
class SimpleNeuroSATConfig(NeuroCoreConfig):
    use_query: bool = True


simple_neurosat_init = neurocore_init
simple_neurosat_apply = neurocore_apply


def simple_neurosat_config(**kw) -> NeuroCoreConfig:
    """A NeuroCore config with the query mechanism on: SimpleNeuroSAT's."""
    return NeuroCoreConfig(use_query=True, **kw)

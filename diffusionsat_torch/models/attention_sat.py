"""AttentionSAT: literal states with additive graph attention.

Counterpart of the TPU package's `models/attention_sat.py`: the query
gradient feature, per-edge additive attention from clause units into
literal units, a layer norm, the softplus_log loss averaged over the
active rounds, and a supervised self-training cross-entropy once the
batch is solved.

- The query gradient is taken in closed form
  (`losses.sat.softplus_loss_and_grad`), whose values equal the TPU
  package's nested gradient.
- The per-round noise ([2V, 4] a round) is drawn from `generator` before
  the loop, or injected as `round_noise` ([rounds, 2V, 4]).
- The round loop runs every round and exits early only by masking. With
  `plans` (ops/segsum.BatchPlans) every literal-clause aggregation, the
  attention's edge -> literal sum (`plan_edge_to_lit`) and the losses'
  included, runs on the segsum kernel, and so do their backwards.
"""

from __future__ import annotations

import dataclasses

import torch

from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.graph.batch import SatBatch
from diffusionsat_torch.losses.sat import (
    softplus_log_loss,
    softplus_loss_and_grad,
    unsat_clause_count,
)
from diffusionsat_torch.models.neuro_sat import flip
from diffusionsat_torch.models.query_sat import _blend, params_to
from diffusionsat_torch.models.query_sat_lit import (
    _cross_entropy,
    _zero_state,
    draw_round_noise,
)
from diffusionsat_torch.nn.attention import (
    additive_attention_apply,
    additive_attention_init,
)
from diffusionsat_torch.nn.mlp import MLPConfig, mlp_apply, mlp_init
from diffusionsat_torch.nn.normalization import layer_norm
from diffusionsat_torch.ops.segsum import BatchPlans, aggregations


@dataclasses.dataclass(frozen=True)
class AttentionSATConfig:
    feature_maps: int = 256
    msg_layers: int = 3
    vote_layers: int = 3
    rounds: int = 16
    query_maps: int = 64

    def dims(self):
        # the query gradient [V, q] is split in half and restacked to
        # [2V, q // 2]
        f, q = self.feature_maps, self.query_maps
        lit_unit = f + q // 2 + q     # [l_output, literals_grad, literals_loss]
        clause_unit = f + q // 2 + q  # [clauses_full, clauses_gradient, clauses_loss]
        return lit_unit, clause_unit

    def mlp_configs(self):
        f = self.feature_maps
        lit_unit, _ = self.dims()
        return {
            "literals_mlp": (MLPConfig(self.msg_layers, f, f,
                                       do_layer_norm=True), lit_unit + f),
            "variables_query": (MLPConfig(self.msg_layers, f, self.query_maps,
                                          do_layer_norm=True), 2 * (f + 4)),
            "output_layer": (MLPConfig(self.vote_layers, f, 1,
                                       do_layer_norm=True), 2 * f),
        }


def attention_sat_init(generator: torch.Generator, cfg: AttentionSATConfig
                       ) -> dict:
    """Random params on the generator's device."""
    params = {name: mlp_init(generator, mcfg, in_dim)
              for name, (mcfg, in_dim) in cfg.mlp_configs().items()}
    lit_unit, clause_unit = cfg.dims()
    params["attention_l"] = additive_attention_init(
        generator, cfg.feature_maps, query_dim=lit_unit,
        memory_dim=clause_unit)
    params["lit_norm_bias"] = torch.zeros((cfg.feature_maps,),
                                          device=generator.device)
    return params


def attention_sat_apply(params: dict, cfg: AttentionSATConfig,
                        batch: SatBatch,
                        generator: torch.Generator | None = None,
                        training: bool = False, rounds: int | None = None,
                        plans: BatchPlans | None = None,
                        round_noise: torch.Tensor | None = None,
                        device: str | torch.device = "cuda"):
    """Run `rounds` (default `cfg.rounds`) rounds. Returns (logits [V, 1]
    of the last active round, loss, steps_taken, {"solved"}).
    `round_noise` ([rounds, 2V, 4]) replaces the per-round draws from
    `generator`."""
    dev = resolve_device(device)
    rounds = rounds or cfg.rounds
    with torch.set_grad_enabled(training):
        batch = batch.to(dev)
        params = params_to(params, dev)
        if plans is not None:
            plans = plans.to(dev)
        if round_noise is None:
            round_noise = draw_round_noise(generator, rounds, 2 * batch.V,
                                           dev)
        return _attention_sat_apply(params, cfg, batch, rounds, plans,
                                    round_noise.to(dev), dev)


# the attention's edge -> literal sum reads the edge plans: callers that
# plan batches for this model build them (train/loop.uses_edge_plans)
attention_sat_apply.uses_edge_plans = True


def _attention_sat_apply(params, cfg, batch, rounds, plans, round_noise,
                         dev):
    mcfgs = cfg.mlp_configs()
    V = batch.V
    l2c, c2l = aggregations(batch, plans)

    def mlp(name, x):
        return mlp_apply(params[name], mcfgs[name][0], x)

    l_output = _zero_state(2 * V, cfg.feature_maps, dev)
    last_logits = torch.zeros((V, 1), device=dev)
    loss_sum = torch.zeros((), device=dev)
    loss_cnt = torch.zeros((), device=dev)
    sup_loss = torch.zeros((), device=dev)
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for r in range(rounds):
        lits = torch.cat([l_output, round_noise[r]], dim=-1)
        query = mlp("variables_query", torch.cat([lits[:V], lits[V:]],
                                                 dim=1))
        clauses_loss, var_grad = softplus_loss_and_grad(query, batch,
                                                        plans=plans)
        g1, g2 = torch.chunk(var_grad, 2, dim=1)
        literals_grad = torch.cat([g1, g2], dim=0)

        literals_unit = torch.cat(
            [l_output, literals_grad, c2l(clauses_loss)], dim=-1)
        clauses_unit = torch.cat(
            [l2c(l_output), l2c(literals_grad), clauses_loss], dim=-1)

        new_literals = additive_attention_apply(
            params["attention_l"], literals_unit, clauses_unit, batch,
            hidden=cfg.feature_maps, plans=plans)

        l_new = mlp("literals_mlp", torch.cat(
            [literals_unit, flip(new_literals, V)], dim=-1))
        l_new = layer_norm(l_new, axis=0, subtract_mean=True,
                           bias=params["lit_norm_bias"])
        logits = mlp("output_layer", torch.cat([l_new[:V], l_new[V:]],
                                               dim=1)) * 0.25

        round_loss = torch.sum(softplus_log_loss(logits, batch,
                                                 plans=plans))
        n_unsat = unsat_clause_count(logits, batch, plans)
        sat_now = (round_loss < 0.5) & (n_unsat == 0)

        active = ~done
        newly_done = active & sat_now
        labels = torch.round(torch.sigmoid(logits))
        sup_loss = torch.where(
            newly_done, _cross_entropy(logits, labels, batch.var_mask),
            sup_loss)

        loss_sum = loss_sum + torch.where(active, round_loss, 0.0)
        loss_cnt = loss_cnt + active.to(torch.float32)
        steps = steps + active.to(torch.int32)
        last_logits = torch.where(active, logits, last_logits)

        cont = active & ~sat_now
        l_output = torch.where(cont, _blend(l_new), torch.where(
            newly_done, l_new, l_output))
        done = done | sat_now

    loss = loss_sum / torch.clamp(loss_cnt, min=1.0) + sup_loss
    steps_taken = torch.clamp(steps - 1, min=0)
    return last_logits, loss, steps_taken, {"solved": done}

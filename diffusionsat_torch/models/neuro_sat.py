"""NeuroSAT: LSTM message passing over the literal-clause graph.

Counterpart of the TPU package's `models/neuro_sat.py`: learned literal
and clause init embeddings, MLP messages through the incidence graph, LSTM
updates of both node kinds, the literal flip, a vote MLP, and an
unsupervised softplus_log_square loss summed over the rounds.

The round loop runs every round and exits early only by masking: once the
rounded assignment satisfies the batch (and the round's loss is under
0.5), states, logits and losses freeze. Shapes stay static and the loop
reads nothing back to the host. With `plans` (ops/segsum.BatchPlans) every
literal-clause aggregation, the losses' included, runs on the segsum
kernel, and so do their backwards.
"""

from __future__ import annotations

import dataclasses

import torch

from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.graph.batch import SatBatch
from diffusionsat_torch.losses.sat import (
    softplus_log_square_loss,
    unsat_clause_count,
)
from diffusionsat_torch.models.query_sat import params_to
from diffusionsat_torch.nn.lstm import lstm_apply, lstm_init
from diffusionsat_torch.nn.mlp import MLPConfig, mlp_apply, mlp_init
from diffusionsat_torch.ops.segsum import BatchPlans, aggregations


@dataclasses.dataclass(frozen=True)
class NeuroSATConfig:
    feature_maps: int = 256
    msg_layers: int = 3
    vote_layers: int = 3
    rounds: int = 32

    def mlp_configs(self):
        f = self.feature_maps
        return {
            "LC_msg": (MLPConfig(self.msg_layers, f, f), f),
            "CL_msg": (MLPConfig(self.msg_layers, f, f), f),
            "L_vote": (MLPConfig(self.vote_layers, f * 2, 1), f * 2),
        }


def neuro_sat_init(generator: torch.Generator, cfg: NeuroSATConfig) -> dict:
    """Random params on the generator's device."""
    f, dev = cfg.feature_maps, generator.device
    params = {
        "L_init": torch.randn((1, f), generator=generator, device=dev) * 0.05,
        "C_init": torch.randn((1, f), generator=generator, device=dev) * 0.05,
        "L_update": lstm_init(generator, 2 * f, f),
        "C_update": lstm_init(generator, f, f),
    }
    for name, (mcfg, in_dim) in cfg.mlp_configs().items():
        params[name] = mlp_init(generator, mcfg, in_dim)
    return params


def flip(literals: torch.Tensor, n_vars: int) -> torch.Tensor:
    """Swap the positive and negated literal blocks."""
    return torch.cat([literals[n_vars:], literals[:n_vars]], dim=0)


def neuro_sat_apply(params: dict, cfg: NeuroSATConfig, batch: SatBatch,
                    generator: torch.Generator | None = None,
                    training: bool = False, rounds: int | None = None,
                    plans: BatchPlans | None = None,
                    device: str | torch.device = "cuda"):
    """Run `rounds` (default `cfg.rounds`) rounds. Returns (logits [V, 1]
    of the vote on the last literal state, loss, steps_taken,
    {"solved"}). Draws nothing; `generator` is there for the common apply
    contract. `training=True` records the autograd graph."""
    dev = resolve_device(device)
    with torch.set_grad_enabled(training):
        batch = batch.to(dev)
        params = params_to(params, dev)
        if plans is not None:
            plans = plans.to(dev)
        return _neuro_sat_apply(params, cfg, batch, rounds or cfg.rounds,
                                plans, dev)


def _neuro_sat_apply(params, cfg, batch, rounds, plans, dev):
    mcfgs = cfg.mlp_configs()
    V, f = batch.V, cfg.feature_maps
    l2c, c2l = aggregations(batch, plans)
    # filled on the device, so that a CUDA graph can capture the step
    denom = torch.sqrt(torch.full((), f, dtype=torch.float32, device=dev))

    def vote(literals):
        variables = torch.cat([literals[:V], literals[V:]], dim=1)
        return mlp_apply(params["L_vote"], mcfgs["L_vote"][0], variables)

    l_state = ((params["L_init"] / denom).expand(2 * V, f),
               torch.zeros((2 * V, f), device=dev))
    c_state = ((params["C_init"] / denom).expand(batch.C, f),
               torch.zeros((batch.C, f), device=dev))
    loss_sum = torch.zeros((), device=dev)
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(rounds):
        LC_pre = mlp_apply(params["LC_msg"], mcfgs["LC_msg"][0], l_state[0])
        _, c_new = lstm_apply(params["C_update"], l2c(LC_pre), c_state)
        CL_pre = mlp_apply(params["CL_msg"], mcfgs["CL_msg"][0], c_new[0])
        l_in = torch.cat([c2l(CL_pre), flip(l_state[0], V)], dim=1)
        _, l_new = lstm_apply(params["L_update"], l_in, l_state)
        logits = vote(l_new[0])

        logits_loss = torch.sum(softplus_log_square_loss(logits, batch,
                                                         plans=plans))
        n_unsat = unsat_clause_count(logits, batch, plans)
        sat_now = (logits_loss < 0.5) & (n_unsat == 0)

        active = ~done
        l_state = tuple(torch.where(active, n, o)
                        for o, n in zip(l_state, l_new))
        c_state = tuple(torch.where(active, n, o)
                        for o, n in zip(c_state, c_new))
        loss_sum = loss_sum + torch.where(active, logits_loss, 0.0)
        steps = steps + active.to(torch.int32)
        done = done | sat_now

    # the final vote from the last literal state
    logits = vote(l_state[0])
    steps_taken = torch.clamp(steps - 1, min=0)
    loss = loss_sum / torch.clamp(steps_taken.to(torch.float32), min=1.0)
    return logits, loss, steps_taken, {"solved": done}

"""QuerySAT on the dense per-graph block layout, in inference mode.

Counterpart of the TPU package's `models/query_sat_dense.py`: the same
algorithm as `models/query_sat.py` (recurrent query loop, closed-form query
gradient, 8 logit heads, diffusion conditioning, masked early exit) over
`DenseSatBatch` blocks. Every aggregation is a batched matrix product or a
masked axis reduction (`ops/dense_ops.py`).

Parameters are shared with the flat model: the MLPs act on the last axis
only, so one params tree (`query_sat_init`, or a `.npz` file read by
`train.checkpoint`) serves both layouts.
"""

from __future__ import annotations

import torch

from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.diffusion.schedule import (
    add_t_emb,
    construct_training_input,
    diffusion_kl_loss,
)
from diffusionsat_torch.graph.dense_batch import DenseSatBatch
from diffusionsat_torch.models.query_sat import (
    QuerySATConfig,
    _check_ported,
    _head_weighted_loss,
    _round_stats,
    _stack_round_stats,
    params_to,
    query_sat_init,  # noqa: F401  re-export: params are layout-independent
)
from diffusionsat_torch.nn.mlp import mlp_apply
from diffusionsat_torch.ops import dense_ops as dops


def _prepare_noisy_labels(batch: DenseSatBatch, labels: torch.Tensor,
                          noise_scale: torch.Tensor,
                          noisy_num: torch.Tensor | None,
                          denoised_num: torch.Tensor | None,
                          generator: torch.Generator | None) -> torch.Tensor:
    """[G, Vg, 5] input channels."""
    dev = batch.device
    if noisy_num is None:
        noisy = construct_training_input(labels, noise_scale, generator)
    else:
        noisy = noisy_num.to(device=dev, dtype=torch.float32)
    noisy = add_t_emb(noisy, noise_scale)
    if denoised_num is None:
        den = torch.zeros((batch.G, batch.Vg, 2), device=dev)
    else:
        den = torch.cat([denoised_num, 1 - denoised_num], dim=-1)
    return torch.cat([noisy, den], dim=-1)


@torch.no_grad()
def query_sat_dense_apply(params: dict, cfg: QuerySATConfig,
                          batch: DenseSatBatch,
                          generator: torch.Generator | None = None,
                          training: bool = False,
                          labels: torch.Tensor | None = None,
                          noise_scale: torch.Tensor | float | None = None,
                          noisy_num: torch.Tensor | None = None,
                          denoised_num: torch.Tensor | None = None,
                          rounds: int | None = None,
                          early_exit: bool = False,
                          round_noise: torch.Tensor | None = None,
                          device: str | torch.device = "cuda"):
    """Returns (out_logits [G, Vg, 1], loss, steps, aux): the dense-layout
    counterpart of `query_sat_apply`, with the same contract.

    `labels`: [G, Vg] 0/1 bits. All shapes are [G, nodes, features].
    `round_noise` ([rounds, G, Vg, 4]) replaces the per-round exploration
    noise draws. `generator` must live on `device`.
    """
    _check_ported(cfg, training, None, None)
    dev = resolve_device(device)
    batch = batch.to(dev)
    params = params_to(params, dev)
    mcfgs = cfg.mlp_configs()
    G, Vg, Cg = batch.G, batch.Vg, batch.Cg
    K, Q = cfg.logit_maps, cfg.query_maps
    if rounds is None:
        rounds = cfg.test_rounds

    if noise_scale is None:
        noise_scale = torch.rand((), generator=generator, device=dev)
        if cfg.noise_skew != 1.0:
            noise_scale = torch.pow(noise_scale, 1.0 / cfg.noise_skew)
    noise_scale = torch.as_tensor(noise_scale, dtype=torch.float32,
                                  device=dev)
    if labels is None:
        labels = torch.randint(0, 2, (G, Vg), generator=generator,
                               device=dev, dtype=torch.int32)
    labels = labels.to(dev)
    if round_noise is not None:
        round_noise = round_noise.to(device=dev, dtype=torch.float32)
        if round_noise.shape[0] < rounds:
            raise ValueError(f"round_noise holds {round_noise.shape[0]} "
                             f"rounds, need {rounds}")

    noisy_labels = _prepare_noisy_labels(batch, labels, noise_scale,
                                         noisy_num, denoised_num, generator)

    # degree weights
    lit_degree = dops.literal_degrees(batch)                  # [G, 2Vg, 1]
    degree_weight = torch.rsqrt(torch.clamp(lit_degree, min=1.0))
    var_degree_weight = 4.0 * torch.rsqrt(
        torch.clamp(lit_degree[:, :Vg] + lit_degree[:, Vg:], min=1.0))
    rev_degree_weight = torch.rsqrt(
        torch.clamp(dops.clause_degrees(batch), min=1.0))     # [G, Cg, 1]

    nvg = batch.n_vars_per_graph
    inv_var_counts = torch.where(nvg > 0, 1.0 / torch.clamp(nvg, min=1.0),
                                 0.0)
    smoothed_labels = labels.to(torch.float32)[..., None].expand(G, Vg, K)

    def round_body(carry, step_idx):
        (variables, clause_state, last_logits, best_map_vars, loss_sum,
         loss_count, steps, done) = carry

        if cfg.debug_zero_noise:
            noise4 = torch.zeros((G, Vg, 4), device=dev)
        elif round_noise is not None:
            noise4 = round_noise[step_idx]
        else:
            noise4 = torch.randn((G, Vg, 4), generator=generator, device=dev)
        v1 = torch.cat([variables, noise4, noisy_labels], dim=-1)

        # query and the closed-form gradient of the clause loss wrt it
        query = mlp_apply(params["variables_query"],
                          mcfgs["variables_query"][0], v1)
        clauses_loss, grads = dops.softplus_loss_and_grad(query, batch)
        variables_grad = grads * var_degree_weight
        clauses_loss = clauses_loss * 4.0

        # clause update
        if cfg.use_message_passing:
            var_msg = mlp_apply(params["lit_mlp"], mcfgs["lit_mlp"][0], v1)
            lit1, lit2 = torch.split(var_msg, var_msg.shape[-1] // 2, dim=-1)
            literals = torch.cat([lit1, lit2], dim=1)         # [G, 2Vg, Q]
            clause_messages = dops.lit_to_clause(batch, literals) * \
                rev_degree_weight
            clause_unit = torch.cat(
                [clause_state, clause_messages, clauses_loss], dim=-1)
        else:
            clause_unit = torch.cat([clause_state, clauses_loss], dim=-1)
        clause_data = mlp_apply(params["clause_mlp"],
                                mcfgs["clause_mlp"][0], clause_unit)

        variables_loss_all = clause_data[..., :Q]
        new_clause_value = dops.pair_norm_clauses(clause_data[..., Q:],
                                                  batch) * 0.25
        new_clause_state = new_clause_value + 0.1 * clause_state

        # variable update
        variables_loss = dops.clause_to_lit(batch, variables_loss_all) * \
            degree_weight
        unit = torch.cat([variables_grad, v1, variables_loss[:, :Vg],
                          variables_loss[:, Vg:]], dim=-1)
        new_variables = mlp_apply(params["update_gate"],
                                  mcfgs["update_gate"][0], unit)
        new_variables = dops.pair_norm_vars(new_variables, batch) * 0.25
        new_variables = new_variables + 0.1 * variables

        # logits and per-graph loss
        logits = mlp_apply(params["variables_output"],
                           mcfgs["variables_output"][0], new_variables)
        if cfg.supervised:
            per_var_loss = diffusion_kl_loss(smoothed_labels, logits,
                                             noise_scale)
            per_var_loss = per_var_loss * batch.var_mask[..., None]
            per_graph_loss = torch.sum(per_var_loss, dim=1) * \
                inv_var_counts[:, None]                       # [G, K]
        elif cfg.use_linear_loss:
            per_graph_loss = torch.zeros((G, K), device=dev) + \
                dops.linear_loss(logits, batch) / torch.clamp(
                    batch.graph_mask.sum(), min=1.0) / K
            per_graph_loss = per_graph_loss * batch.graph_mask[:, None]
        else:
            per_clause_loss = dops.softplus_mixed_loss(logits, batch)
            per_graph_loss = dops.clause_graph_sum(batch, per_clause_loss)
            per_graph_loss = torch.sqrt(per_graph_loss + 1e-6) - \
                torch.sqrt(torch.tensor(1e-6, device=dev))

        logit_loss = _head_weighted_loss(per_graph_loss, K)

        # best head per graph, broadcast to variables
        best_map = torch.argmin(per_graph_loss, dim=-1).to(torch.int32)
        new_best_vars = best_map[:, None].expand(G, Vg)
        out_logits = torch.gather(logits, 2, new_best_vars.long()[..., None])
        sat = dops.is_batch_sat(out_logits, batch) >= 1.0

        # early exit by masking: the loss of the round that satisfies the
        # batch is accumulated, but the 0.2/0.8 blend is skipped
        newly_done = sat & ~done
        active = ~done
        upd_logits = torch.where(active, logits, last_logits)
        upd_best = torch.where(active, new_best_vars, best_map_vars)
        loss_sum = loss_sum + torch.where(active, logit_loss, 0.0)
        loss_count = loss_count + active.to(torch.float32)
        steps = steps + active.to(torch.int32)

        # the TPU package blends stop_gradient(x) * 0.2 + x * 0.8; the
        # same expression keeps the same f32 rounding
        blend_v = new_variables.detach() * 0.2 + new_variables * 0.8
        blend_c = new_clause_state.detach() * 0.2 + new_clause_state * 0.8
        cont = active & ~newly_done
        upd_variables = torch.where(
            cont, blend_v, torch.where(newly_done, new_variables, variables))
        upd_clause_state = torch.where(
            cont, blend_c,
            torch.where(newly_done, new_clause_state, clause_state))
        if collect:
            round_stats.append(_round_stats(
                logit_loss, query, variables_grad, new_variables,
                new_clause_state, logits, sat))
        return (upd_variables, upd_clause_state, upd_logits, upd_best,
                loss_sum, loss_count, steps, done | sat)

    carry = (
        torch.ones((G, Vg, cfg.feature_maps), device=dev),    # variables
        torch.ones((G, Cg, cfg.feature_maps), device=dev),    # clause state
        torch.zeros((G, Vg, K), device=dev),                  # last logits
        torch.zeros((G, Vg), dtype=torch.int32, device=dev),  # best head
        torch.zeros((), device=dev),                          # loss sum
        torch.zeros((), device=dev),                          # loss count
        torch.zeros((), dtype=torch.int32, device=dev),       # steps taken
        torch.zeros((), dtype=torch.bool, device=dev),        # done flag
    )
    collect = cfg.collect_round_stats and not early_exit
    round_stats: list[dict] = []
    for step_idx in range(rounds):
        carry = round_body(carry, step_idx)
        # reading the flag is a host sync; the early-exit loop pays it
        # after every round so that no round runs once the batch is solved
        if early_exit and bool(carry[-1]):
            break
    (variables, clause_state, last_logits, best_map_vars, loss_sum,
     loss_count, steps, done) = carry

    loss = loss_sum / torch.clamp(loss_count, min=1.0)
    out_logits = torch.gather(last_logits, 2,
                              best_map_vars.long()[..., None])
    # the 0-based loop index at exit (= executed rounds - 1)
    steps_taken = torch.clamp(steps - 1, min=0)
    aux = {
        "logits_all_heads": last_logits,
        "solved": done,
        "variables_state": variables,
        "clause_state": clause_state,
    }
    if round_stats:
        aux["round_stats"] = _stack_round_stats(round_stats)
    return out_logits, loss, steps_taken, aux

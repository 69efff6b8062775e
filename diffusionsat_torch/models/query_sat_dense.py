"""QuerySAT on the dense per-graph block layout, for inference and training.

Counterpart of the TPU package's `models/query_sat_dense.py`: the same
algorithm as `models/query_sat.py` (recurrent query loop, closed-form query
gradient, 8 logit heads, diffusion conditioning, masked early exit) over
`DenseSatBatch` blocks. Every aggregation is a batched matrix product or a
masked axis reduction (`ops/dense_ops.py`).

`cfg.block_bf16` is the block-level bf16 flow: params and incidence are
cast once, outside the round loop; recurrent states and hidden activations
flow bf16 and every product accumulates in f32; degree weights, pair norms,
the loss chain and the head weighting stay f32. Gradients reach the f32
master params through the cast.

Parameters are shared with the flat model: the MLPs act on the last axis
only, so one params tree (`query_sat_init`, or a `.npz` file read by
`train.checkpoint`) serves both layouts. In inference on the card each
round is a CUDA graph, replayed (`cuda_graphs.run_rounds`), as in the flat
model.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

from diffusionsat_torch import cuda_graphs
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
    _blend,
    _head_weighted_loss,
    _round_stats,
    _stack_round_stats,
    params_to,
    remat_body,
    query_sat_init,  # noqa: F401  re-export: params are layout-independent
)
from diffusionsat_torch.nn.mlp import mlp_apply
from diffusionsat_torch.ops import dense_ops as dops
from diffusionsat_torch.ops.lowp import weak


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
    noise draws. `generator` must live on `device`. `training=True`
    records the autograd graph and defaults `rounds` to `cfg.train_rounds`.
    """
    _check_ported(cfg, None, None)
    with torch.set_grad_enabled(training):
        return _query_sat_dense_apply(
            params, cfg, batch, generator, training, labels, noise_scale,
            noisy_num, denoised_num, rounds, early_exit, round_noise, device)


def _query_sat_dense_apply(params, cfg, batch, generator, training, labels,
                           noise_scale, noisy_num, denoised_num, rounds,
                           early_exit, round_noise, device):
    dev = resolve_device(device)
    batch = batch.to(dev)
    params = params_to(params, dev)
    mcfgs = cfg.mlp_configs()
    G, Vg, Cg = batch.G, batch.Vg, batch.Cg
    K, Q = cfg.logit_maps, cfg.query_maps
    if rounds is None:
        rounds = cfg.train_rounds if training else cfg.test_rounds
    cdt = cfg.compute_dtype

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

    # block-level bf16: params and incidence are cast once here, not inside
    # every round
    state_dt = torch.bfloat16 if cfg.block_bf16 else torch.float32
    if cfg.block_bf16:
        c = lambda t: t.to(torch.bfloat16)  # noqa: E731
        params = pytree.tree_map(c, params)
        batch = dataclasses.replace(batch, incidence=c(batch.incidence))
        noisy_labels = c(noisy_labels)
    else:
        c = lambda t: t  # noqa: E731

    def draw_noise(step_idx, gen=generator):
        if cfg.debug_zero_noise:
            return torch.zeros((G, Vg, 4), dtype=state_dt, device=dev)
        if round_noise is not None:
            return round_noise[step_idx].to(state_dt)
        return torch.randn((G, Vg, 4), generator=gen,
                           device=dev).to(state_dt)

    # every tensor a round reads besides its carry: a graphed round loop
    # copies these into its buffers
    ctx = dict(params=params, batch=batch, noisy_labels=noisy_labels,
               degree_weight=degree_weight,
               var_degree_weight=var_degree_weight,
               rev_degree_weight=rev_degree_weight,
               inv_var_counts=inv_var_counts,
               smoothed_labels=smoothed_labels, noise_scale=noise_scale)

    def make_round(ctx):
        params, batch = ctx["params"], ctx["batch"]
        noisy_labels, noise_scale = ctx["noisy_labels"], ctx["noise_scale"]
        degree_weight = ctx["degree_weight"]
        var_degree_weight = ctx["var_degree_weight"]
        rev_degree_weight = ctx["rev_degree_weight"]
        inv_var_counts = ctx["inv_var_counts"]
        smoothed_labels = ctx["smoothed_labels"]

        def round_body(carry, noise4):
            (variables, clause_state, last_logits, best_map_vars, loss_sum,
             loss_count, steps, done) = carry
            v1 = torch.cat([variables, noise4, noisy_labels], dim=-1)

            # query and the closed-form gradient of the clause loss wrt it
            query = mlp_apply(params["variables_query"],
                              mcfgs["variables_query"][0], v1, compute_dtype=cdt)
            clauses_loss, grads = dops.softplus_loss_and_grad(query, batch)
            variables_grad = grads * var_degree_weight
            clauses_loss = clauses_loss * 4.0

            # clause update
            if cfg.use_message_passing:
                var_msg = mlp_apply(params["lit_mlp"], mcfgs["lit_mlp"][0], v1,
                                    compute_dtype=cdt)
                lit1, lit2 = torch.split(var_msg, var_msg.shape[-1] // 2, dim=-1)
                literals = torch.cat([lit1, lit2], dim=1)         # [G, 2Vg, Q]
                clause_messages = dops.lit_to_clause(batch, c(literals)) * \
                    rev_degree_weight
                clause_unit = torch.cat(
                    [clause_state, c(clause_messages), c(clauses_loss)], dim=-1)
            else:
                clause_unit = torch.cat([clause_state, c(clauses_loss)], dim=-1)
            clause_data = mlp_apply(params["clause_mlp"],
                                    mcfgs["clause_mlp"][0], clause_unit,
                                    compute_dtype=cdt)

            variables_loss_all = clause_data[..., :Q]
            new_clause_value = dops.pair_norm_clauses(clause_data[..., Q:],
                                                      batch) * 0.25
            new_clause_state = c(new_clause_value + weak(0.1, clause_state) * clause_state.float())

            # variable update
            variables_loss = dops.clause_to_lit(batch, c(variables_loss_all)) * \
                degree_weight
            unit = torch.cat([c(variables_grad), v1, c(variables_loss[:, :Vg]),
                              c(variables_loss[:, Vg:])], dim=-1)
            new_variables = mlp_apply(params["update_gate"],
                                      mcfgs["update_gate"][0], unit,
                                      compute_dtype=cdt)
            new_variables = dops.pair_norm_vars(new_variables, batch) * 0.25
            new_variables = c(new_variables + weak(0.1, variables) * variables.float())

            # logits and per-graph loss
            logits = mlp_apply(params["variables_output"],
                               mcfgs["variables_output"][0], new_variables,
                               compute_dtype=cdt)
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
                    torch.sqrt(torch.full((), 1e-6, device=dev))

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

            # the TPU package blends stop_gradient(x) * 0.2 + x * 0.8, its
            # constants weak-typed: in the state's type
            blend_v = _blend(new_variables)
            blend_c = _blend(new_clause_state)
            cont = active & ~newly_done
            upd_variables = torch.where(
                cont, blend_v, torch.where(newly_done, new_variables, variables))
            upd_clause_state = torch.where(
                cont, blend_c,
                torch.where(newly_done, new_clause_state, clause_state))
            stats = _round_stats(
                logit_loss, query, variables_grad, new_variables,
                new_clause_state, logits, sat) if collect else None
            return (upd_variables, upd_clause_state, upd_logits, upd_best,
                    loss_sum, loss_count, steps, done | sat), stats
        return round_body

    carry = (
        torch.ones((G, Vg, cfg.feature_maps), dtype=state_dt, device=dev),
        torch.ones((G, Cg, cfg.feature_maps), dtype=state_dt, device=dev),
        torch.zeros((G, Vg, K), device=dev),                  # last logits
        torch.zeros((G, Vg), dtype=torch.int32, device=dev),  # best head
        torch.zeros((), device=dev),                          # loss sum
        torch.zeros((), device=dev),                          # loss count
        torch.zeros((), dtype=torch.int32, device=dev),       # steps taken
        torch.zeros((), dtype=torch.bool, device=dev),        # done flag
    )
    # training always runs the fixed-count loop: it exits early only by
    # masking
    early_exit = early_exit and not training
    collect = cfg.collect_round_stats and not early_exit
    round_stats: list[dict] = []
    if not training and not collect and rounds > 0 and \
            cuda_graphs.graphs_enabled(dev):
        # one CUDA graph of the round, replayed `rounds` times; the
        # early-exit flag is read between replays
        def make_step(ctx):
            round_body = make_round(ctx)

            def step(carry, gen, noise):
                noise = draw_noise(None, gen) if noise is None else \
                    noise.to(state_dt)
                return round_body(carry, noise)[0]
            return step

        carry = cuda_graphs.run_rounds(
            make_step, ("query_sat_dense", cfg, str(dev)), ctx, carry,
            rounds, generator,
            None if cfg.debug_zero_noise else round_noise, early_exit)
    else:
        body = remat_body(cfg, training, make_round(ctx))
        for step_idx in range(rounds):
            carry, stats = body(carry, draw_noise(step_idx))
            if collect:
                round_stats.append(stats)
            # reading the flag is a host sync; the early-exit loop pays it
            # after every round so that no round runs once the batch is
            # solved
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

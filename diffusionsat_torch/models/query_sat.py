"""QuerySAT, the DiffusionSAT core model, for inference and training.

Counterpart of the TPU package's `models/query_sat.py`: the same explicit
params tree and the same recurrent round, run as a Python loop of eager
PyTorch ops. With `training=True` the loop records the autograd graph (the
caller differentiates the returned loss wrt the params), runs
`cfg.train_rounds` rounds and exits early only by masking.

- The query gradient of the clause loss is computed in closed form
  (`losses.sat.softplus_loss_and_grad`).
- The SAT early exit is carry masking: once the rounded assignment
  satisfies the whole batch, state, logits and losses freeze, so any round
  run after that is a no-op on every output. The early-exit loop reads the
  `done` flag (a host sync) after every round and stops once it is set.
- Random draws (noise scale, predict-mode labels, per-round exploration
  noise) come from an explicit `torch.Generator`, or are injected
  (`noise_scale=`, `labels=`, `noisy_num=`, `round_noise=`).
- With `plans` (ops/segsum.BatchPlans) the four literal-clause
  aggregations of a round run on the hand-written CUDA kernel, and so do
  their backwards (each direction's backward is the other direction).
- In inference on the card each round is a CUDA graph, captured once per
  shape and replayed (`cuda_graphs.run_rounds`; `DSAT_EAGER=1` runs the
  eager loop): the round reads its carry and a `ctx` of every other tensor
  it needs, which the graph keeps in buffers.
- `cfg.remat` trades memory for recomputation in training: "full"
  checkpoints each round, "dots" keeps the matrix products' outputs and
  recomputes the rest. The per-round noise is drawn outside the round body
  and passed in, so a recomputed round sees the same noise.
- With a process `group` the batch is one clause shard of a formula batch
  (`parallel/graph_partition.py`): clause-side work is local, and the
  literal aggregates, per-graph clause sums and the SAT check are
  completed over the group where the TPU package puts its collectives,
  after the planned per-shard sums too. With a `halo` view
  (`parallel/halo.py`) the literal aggregates exchange only the rows the
  shards share, and the supervised per-graph losses are owner-masked
  before one small all-reduce. Every rank then holds the whole loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree
from torch.utils import checkpoint as torch_checkpoint

from diffusionsat_torch import cuda_graphs
from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.diffusion.schedule import (
    add_t_emb,
    construct_training_input,
    diffusion_kl_loss,
)
from diffusionsat_torch.graph.batch import SatBatch
from diffusionsat_torch.losses.sat import (
    is_batch_sat,
    linear_clause_loss,
    linear_literal_loss,
    softplus_loss_and_grad,
    softplus_mixed_loss,
)
from diffusionsat_torch.nn.mlp import MLPConfig, mlp_apply, mlp_init
from diffusionsat_torch.nn.normalization import (
    pair_norm_clauses,
    pair_norm_vars,
)
from diffusionsat_torch.ops.graph_ops import (
    clause_degrees,
    clause_segment_sum,
    clause_to_lit,
    complete_literals,
    graph_gather_vars,
    lit_to_clause,
    literal_degrees,
    var_segment_sum,
)
from diffusionsat_torch.ops.lowp import weak
from diffusionsat_torch.parallel.comm import all_reduce_sum, balance_copies
from diffusionsat_torch.ops.segsum import (
    BatchPlans,
    plan_clause_to_lit,
    plan_lit_to_clause,
)


@dataclasses.dataclass(frozen=True)
class QuerySATConfig:
    """Architecture knobs, with the TPU package's field names and defaults.

    `compute_dtype` (a torch dtype) casts the MLP products' operands per
    call; `block_bf16` is read by the dense model only; `remat` is "none",
    "full" or "dots". States are float32 (`dtype` keeps its default).
    """
    feature_maps: int = 128
    query_maps: int = 128
    msg_layers: int = 3
    train_rounds: int = 32
    test_rounds: int = 64
    logit_maps: int = 8
    supervised: bool = True
    use_message_passing: bool = True
    use_linear_loss: bool = False
    update_layers: int = 3
    output_layers: int = 2
    query_layers: int = 2
    clauses_layers: int = 2
    update_scale: float = 1.8
    output_scale: float = 1.0
    clauses_scale: float = 1.6
    query_scale: float = 1.2
    dtype: Any = torch.float32
    compute_dtype: Any = None
    block_bf16: bool = False
    remat: str = "none"
    # zero the per-round exploration noise (deterministic given the other
    # injected inputs)
    debug_zero_noise: bool = False
    label_isolation_alpha: float = 0.0
    noise_skew: float = 1.0
    collect_round_stats: bool = False

    @property
    def label_channels(self) -> int:
        return 5

    def mlp_configs(self) -> dict[str, tuple[MLPConfig, int]]:
        f, q = self.feature_maps, self.query_maps
        v1_dim = f + 4 + self.label_channels
        return {
            "update_gate": (
                MLPConfig(self.update_layers, int(f * self.update_scale), f),
                q + v1_dim + 2 * q),
            "variables_output": (
                MLPConfig(self.output_layers, int(f * self.output_scale),
                          self.logit_maps), f),
            "variables_query": (
                MLPConfig(self.query_layers, int(q * self.query_scale), q),
                v1_dim),
            "clause_mlp": (
                MLPConfig(self.clauses_layers, int(f * self.clauses_scale),
                          f + q), f + 2 * q),
            "lit_mlp": (MLPConfig(self.msg_layers, q * 4, q * 2), v1_dim),
        }

    @classmethod
    def from_meta(cls, config: dict, **overrides) -> "QuerySATConfig":
        """Config from a params file's `meta["config"]` record; keys this
        class does not know (or keeps at its default) are skipped."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in config.items() if k in names and k not in
              ("dtype", "compute_dtype")}
        kw.update(overrides)
        return cls(**kw)


def _check_ported(cfg: QuerySATConfig, group, halo):
    if halo is not None and group is None:
        raise ValueError("a halo view needs the process group of its shards")
    if halo is not None and not cfg.supervised and cfg.use_linear_loss:
        # as in the TPU package: the halo step owner-masks its per-graph
        # losses, and linear_loss's literal regularizer has no owner
        raise NotImplementedError(
            "halo execution supports supervised and clause-partitioned "
            "unsupervised losses; linear_loss is not owner-maskable")
    if cfg.dtype != torch.float32:
        raise ValueError("states are float32; the reduced-precision modes "
                         "are block_bf16 and compute_dtype")
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none, full or dots, got "
                         f"{cfg.remat!r}")


# the outputs that remat="dots" keeps: every matrix product of the round
_DOT_OPS = ("mm", "bmm", "addmm", "baddbmm")


def remat_body(cfg: QuerySATConfig, training: bool, body):
    """`body` wrapped as `cfg.remat` asks (training only)."""
    if not training or cfg.remat == "none":
        return body
    kw = {}
    if cfg.remat == "dots":
        ops = [getattr(torch.ops.aten, n).default for n in _DOT_OPS]
        kw["context_fn"] = lambda: \
            torch_checkpoint.create_selective_checkpoint_contexts(ops)

    def wrapped(*args):
        # the round's noise is drawn outside the body, so the recompute
        # needs no saved RNG state (and a CUDA graph capture may not read
        # it)
        return torch_checkpoint.checkpoint(body, *args, use_reentrant=False,
                                           preserve_rng_state=False, **kw)
    return wrapped


def _round_stats(logit_loss, query, variables_grad, new_variables,
                 new_clause_state, logits, sat) -> dict:
    """In-model summaries of one round (`collect_round_stats`)."""
    return {
        "logit_loss": logit_loss,
        "query_mean_abs": torch.mean(torch.abs(query)),
        "grad_mean_abs": torch.mean(torch.abs(variables_grad)),
        "var_state_rms": torch.sqrt(torch.mean(torch.square(new_variables))),
        "clause_state_rms": torch.sqrt(
            torch.mean(torch.square(new_clause_state))),
        "logits_mean_abs": torch.mean(torch.abs(logits)),
        "batch_sat": sat.to(torch.float32),
    }


def _stack_round_stats(rows: list[dict]) -> dict:
    """Per-round summaries as one [rounds] tensor per key."""
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def query_sat_init(generator: torch.Generator, cfg: QuerySATConfig) -> dict:
    """Random glorot params on the generator's device."""
    return {name: mlp_init(generator, mcfg, in_dim)
            for name, (mcfg, in_dim) in cfg.mlp_configs().items()}


def params_to(params: Any, device: torch.device) -> Any:
    """The params tree with every tensor on `device`."""
    return pytree.tree_map(lambda t: t.to(device), params)


def _blend(x: torch.Tensor) -> torch.Tensor:
    """stop_gradient(x) * 0.2 + x * 0.8 with the constants in x's type, as
    the TPU package's weak-typed constants are."""
    return x.detach() * weak(0.2, x) + x * weak(0.8, x)


def _head_weighted_loss(per_graph_loss: torch.Tensor, logit_maps: int
                        ) -> torch.Tensor:
    """Sorted-descending head costs."""
    costs = torch.square(torch.arange(1, logit_maps + 1, dtype=torch.float32,
                                      device=per_graph_loss.device))
    ordered = torch.sort(per_graph_loss, dim=-1, descending=True).values
    return torch.sum(ordered * costs) / torch.sum(costs)


def _prepare_noisy_labels(cfg: QuerySATConfig, batch: SatBatch,
                          labels: torch.Tensor, noise_scale: torch.Tensor,
                          noisy_num: torch.Tensor | None,
                          denoised_num: torch.Tensor | None,
                          generator: torch.Generator | None) -> torch.Tensor:
    """Model input channels from labels and noise. Returns [V, 5]."""
    if noisy_num is None:
        noisy = construct_training_input(labels, noise_scale, generator)
    else:
        noisy = noisy_num.to(device=batch.device, dtype=torch.float32)
    noisy = add_t_emb(noisy, noise_scale)
    if denoised_num is None:
        den = torch.zeros((batch.V, 2), device=batch.device)
    else:
        den = torch.cat([denoised_num, 1 - denoised_num], dim=-1)
    return torch.cat([noisy, den], dim=-1)


def query_sat_apply(params: dict, cfg: QuerySATConfig, batch: SatBatch,
                    generator: torch.Generator | None = None,
                    training: bool = False,
                    labels: torch.Tensor | None = None,
                    noise_scale: torch.Tensor | float | None = None,
                    noisy_num: torch.Tensor | None = None,
                    denoised_num: torch.Tensor | None = None,
                    rounds: int | None = None,
                    early_exit: bool = False,
                    plans: BatchPlans | None = None,
                    round_noise: torch.Tensor | None = None,
                    group=None,
                    halo=None,
                    device: str | torch.device = "cuda"):
    """Run the recurrent loop. Returns (out_logits [V,1], loss, steps, aux).

    `labels` are per-variable 0/1 bits; if None, random bits are drawn
    (predict mode: they feed only the supervised loss that picks the best
    head). `noise_scale` defaults to a uniform draw. `round_noise`
    ([rounds, V, 4]) replaces the per-round exploration noise draws.
    `generator` must live on `device`. The batch, plans and params are
    moved to `device` (a no-op when they are there already). With
    `cfg.collect_round_stats` the fixed-count loop also returns per-round
    summaries as `aux["round_stats"]` (the early-exit loop does not).

    `training=True` records the autograd graph, whatever the caller's grad
    mode; inference records none. `rounds` defaults to `cfg.train_rounds`
    when training and to `cfg.test_rounds` otherwise.

    `group` (a process group) runs the batch as a clause shard, `halo` (a
    `parallel/halo.HaloView` of this rank) with the halo exchange; every
    rank of the group must make the same draws (the same generator state,
    or the same injected inputs). A sharded loop runs eagerly.
    """
    _check_ported(cfg, group, halo)
    with torch.set_grad_enabled(training):
        return _query_sat_apply(
            params, cfg, batch, generator, training, labels, noise_scale,
            noisy_num, denoised_num, rounds, early_exit, plans, round_noise,
            group, halo, device)


def _query_sat_apply(params, cfg, batch, generator, training, labels,
                     noise_scale, noisy_num, denoised_num, rounds, early_exit,
                     plans, round_noise, group, halo, device):
    dev = resolve_device(device)
    batch = batch.to(dev)
    params = params_to(params, dev)
    if plans is not None:
        plans = plans.to(dev)
    if halo is not None:
        halo = halo.to(dev)
    mcfgs = cfg.mlp_configs()
    V = batch.V
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
        labels = torch.randint(0, 2, (V,), generator=generator, device=dev,
                               dtype=torch.int32)
    labels = labels.to(dev)
    if round_noise is not None:
        round_noise = round_noise.to(device=dev, dtype=torch.float32)
        if round_noise.shape[0] < rounds:
            raise ValueError(f"round_noise holds {round_noise.shape[0]} "
                             f"rounds, need {rounds}")

    noisy_labels = _prepare_noisy_labels(cfg, batch, labels, noise_scale,
                                         noisy_num, denoised_num, generator)

    # degree weights
    lit_degree = literal_degrees(batch, group)                 # [2V, 1]
    degree_weight = torch.rsqrt(torch.clamp(lit_degree, min=1.0))
    var_degree_weight = 4.0 * torch.rsqrt(
        torch.clamp(lit_degree[:V] + lit_degree[V:], min=1.0))  # [V, 1]
    rev_degree_weight = torch.rsqrt(
        torch.clamp(clause_degrees(batch), min=1.0))            # [C, 1]

    # per-graph normalized membership weights for the supervised loss
    nvg = batch.n_vars_per_graph
    inv_var_counts = torch.where(nvg > 0, 1.0 / torch.clamp(nvg, min=1.0),
                                 0.0)
    smoothed_labels = labels.to(torch.float32)[:, None].expand(V, K)

    # every tensor a round reads besides its carry: a graphed round loop
    # copies these into its buffers
    ctx = dict(params=params, batch=batch, plans=plans,
               noisy_labels=noisy_labels, degree_weight=degree_weight,
               var_degree_weight=var_degree_weight,
               rev_degree_weight=rev_degree_weight,
               inv_var_counts=inv_var_counts,
               smoothed_labels=smoothed_labels, noise_scale=noise_scale)

    def draw_noise(step_idx, gen=generator):
        if cfg.debug_zero_noise:
            return torch.zeros((V, 4), device=dev)
        if round_noise is not None:
            return round_noise[step_idx]
        return torch.randn((V, 4), generator=gen, device=dev)

    def make_round(ctx):
        params, batch, plans = ctx["params"], ctx["batch"], ctx["plans"]
        noisy_labels, noise_scale = ctx["noisy_labels"], ctx["noise_scale"]
        degree_weight = ctx["degree_weight"]
        var_degree_weight = ctx["var_degree_weight"]
        rev_degree_weight = ctx["rev_degree_weight"]
        inv_var_counts = ctx["inv_var_counts"]
        smoothed_labels = ctx["smoothed_labels"]

        def l2c(x):
            if plans is not None:
                return plan_lit_to_clause(x, plans)
            return lit_to_clause(batch, x)

        def c2l(x):
            if plans is not None:
                x = plan_clause_to_lit(x, plans)
            else:
                x = clause_to_lit(batch, x)
            return complete_literals(x, group, halo)

        def round_body(carry, noise4):
            (variables, clause_state, last_logits, best_map_vars, loss_sum,
             loss_count, steps, done) = carry
            if group is not None:
                # every rank's copy of the state gets the copies' mean
                # cotangent (parallel/comm.balance_copies)
                variables = halo.balance_copies(variables, group) \
                    if halo is not None else balance_copies(variables, group)
            v1 = torch.cat([variables, noise4, noisy_labels], dim=-1)

            # query and the closed-form gradient of the clause loss wrt it:
            # first-order ops, which the outer backward differentiates through
            query = mlp_apply(params["variables_query"],
                              mcfgs["variables_query"][0], v1, compute_dtype=cdt)
            clauses_loss, grads = softplus_loss_and_grad(
                query, batch, plans=plans, group=group, halo=halo)
            variables_grad = grads * var_degree_weight
            clauses_loss = clauses_loss * 4.0

            # clause update
            if cfg.use_message_passing:
                var_msg = mlp_apply(params["lit_mlp"], mcfgs["lit_mlp"][0], v1,
                                    compute_dtype=cdt)
                lit1, lit2 = torch.split(var_msg, var_msg.shape[1] // 2, dim=1)
                literals = torch.cat([lit1, lit2], dim=0)          # [2V, Q]
                clause_messages = l2c(literals) * rev_degree_weight
                clause_unit = torch.cat(
                    [clause_state, clause_messages, clauses_loss], dim=-1)
            else:
                clause_unit = torch.cat([clause_state, clauses_loss], dim=-1)
            clause_data = mlp_apply(params["clause_mlp"],
                                    mcfgs["clause_mlp"][0], clause_unit,
                                    compute_dtype=cdt)

            variables_loss_all = clause_data[:, :Q]
            new_clause_value = pair_norm_clauses(
                clause_data[:, Q:], batch, group=group) * 0.25
            new_clause_state = new_clause_value + weak(0.1, clause_state) * clause_state.float()

            # variable update
            variables_loss = c2l(variables_loss_all) * degree_weight
            unit = torch.cat([variables_grad, v1, variables_loss[:V],
                              variables_loss[V:]], dim=-1)
            new_variables = mlp_apply(params["update_gate"],
                                      mcfgs["update_gate"][0], unit,
                                      compute_dtype=cdt)
            new_variables = pair_norm_vars(new_variables, batch) * 0.25
            new_variables = new_variables + weak(0.1, variables) * variables.float()

            # logits and per-graph loss
            logits = mlp_apply(params["variables_output"],
                               mcfgs["variables_output"][0], new_variables,
                               compute_dtype=cdt)
            if cfg.supervised:
                per_var_loss = diffusion_kl_loss(smoothed_labels, logits,
                                                 noise_scale)
                per_var_loss = per_var_loss * batch.var_mask[:, None]
                per_graph_loss = var_segment_sum(batch, per_var_loss) * \
                    inv_var_counts[:, None]
                if halo is not None:
                    # a graph's loss holds only on its owner shard (the
                    # others may miss rows outside their closure)
                    per_graph_loss = all_reduce_sum(
                        per_graph_loss * halo.owner_mask[:, None], group)
            elif cfg.use_linear_loss:
                # a scalar loss, spread evenly over the real graphs and heads.
                # On a clause shard the clause term is completed over the
                # group; the literal term is whole on every rank, and enters
                # the gradient once as every replicated term does (each rank
                # differentiates 1/n of the loss)
                clause_term = linear_clause_loss(logits, batch)
                if group is not None:
                    clause_term = all_reduce_sum(clause_term, group)
                per_graph_loss = torch.zeros((batch.G, K), device=dev) + \
                    (clause_term + linear_literal_loss(logits, batch)) / \
                    torch.clamp(batch.graph_mask.sum(), min=1.0) / K
                per_graph_loss = per_graph_loss * batch.graph_mask[:, None]
            else:
                per_clause_loss = softplus_mixed_loss(logits, batch)
                per_graph_loss = clause_segment_sum(batch, per_clause_loss,
                                                    group)
                per_graph_loss = torch.sqrt(per_graph_loss + 1e-6) - \
                    torch.sqrt(torch.full((), 1e-6, device=dev))

            logit_loss = _head_weighted_loss(per_graph_loss, K)

            # best head per graph, broadcast to variables
            best_map = torch.argmin(per_graph_loss, dim=-1).to(torch.float32)
            new_best_vars = graph_gather_vars(
                batch, best_map[:, None])[:, 0].to(torch.int32)
            out_logits = torch.gather(logits, 1, new_best_vars.long()[:, None])
            sat = is_batch_sat(out_logits, batch, group=group) >= 1.0

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
        torch.ones((V, cfg.feature_maps), device=dev),        # variables
        torch.ones((batch.C, cfg.feature_maps), device=dev),  # clause state
        torch.zeros((V, K), device=dev),                      # last logits
        torch.zeros((V,), dtype=torch.int32, device=dev),     # best head
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
    if not training and not collect and rounds > 0 and group is None and \
            cuda_graphs.graphs_enabled(dev):
        # one CUDA graph of the round, replayed `rounds` times
        def make_step(ctx):
            round_body = make_round(ctx)

            def step(carry, gen, noise):
                if noise is None:
                    noise = draw_noise(None, gen)
                return round_body(carry, noise)[0]
            return step

        carry = cuda_graphs.run_rounds(
            make_step, ("query_sat", cfg, str(dev)), ctx, carry, rounds,
            generator, None if cfg.debug_zero_noise else round_noise,
            early_exit)
    else:
        body = remat_body(cfg, training, make_round(ctx))
        for step_idx in range(rounds):
            carry, stats = body(carry, draw_noise(step_idx))
            if collect:
                round_stats.append(stats)
            if early_exit and bool(carry[-1]):
                break
    (variables, clause_state, last_logits, best_map_vars, loss_sum,
     loss_count, steps, done) = carry

    loss = loss_sum / torch.clamp(loss_count, min=1.0)
    out_logits = torch.gather(last_logits, 1, best_map_vars.long()[:, None])
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

"""ANFSAT: a GNN over ANF (XOR of AND-pairs) equation systems.

Counterpart of the TPU package's `models/anf_sat.py` (reference
`model/anf_sat.py:12-279`), run as a Python loop of eager PyTorch ops:
complex-valued query clause evaluation, var/AND-node messages into clauses,
a clause MLP with PairNorm, an AND-node MLP whose output is added back to
both operand variables, and a supervised cross-entropy (optionally
upweighting the free message-bit inputs) or the unsupervised
(1 - clause_real)^2 loss.

The membership sums of a round (node -> clause for the messages and the
query's value sums, clause -> node for the replies) and the AND -> variable
scatter run one of three ways:

- `plans` (ops/segsum.ANFPlans): the hand-written CUDA segsum kernel on the
  card, forward and backward (its plain version for CPU tensors);
- `tiles` (ops/tiled_ops.TiledIncidence): the tile products for the
  membership sums (the value sums at full f32), a fixed-order segment sum
  for the AND scatter;
- neither: gathers and fixed-order segment sums.

Every sum takes one fixed order (no atomics): the AND scatter without
plans sums each variable's operand slots in an order sorted once a batch,
so two runs of a step agree bit for bit on the card.

In inference on the card each round is a CUDA graph, replayed
(`cuda_graphs.run_rounds`). With `training=True` every round is recomputed in the backward
(`torch.utils.checkpoint`), as the TPU package checkpoints its round body;
the per-round noise is drawn outside the round and passed in, so the
recomputed round sees the same noise. `round_noise` ([rounds, V, 4])
replaces the draws, so that tests replay another package's noise.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import checkpoint as torch_checkpoint

from diffusionsat_torch import cuda_graphs
from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.graph.anf_batch import ANFBatch
from diffusionsat_torch.losses.anf import (
    anf_value_cplx,
    clause_degrees,
    node_degrees,
    seg_to_clause,
    seg_to_nodes,
)
from diffusionsat_torch.models.query_sat import params_to
from diffusionsat_torch.nn.mlp import MLPConfig, mlp_apply, mlp_init
from diffusionsat_torch.nn.normalization import (
    pair_norm_clauses,
    pair_norm_vars,
)
from diffusionsat_torch.ops.graph_ops import (
    clause_segment_sum,
    gather_rows,
    segment_sum,
)
from diffusionsat_torch.ops.segsum import ANFPlans, plan_and_to_var
from diffusionsat_torch.ops.tiled_ops import (
    TiledIncidence,
    tiled_clause_to_lit,
    tiled_lit_to_clause,
)


@dataclasses.dataclass(frozen=True)
class ANFSATConfig:
    """Architecture knobs, with the TPU package's field names and
    defaults."""
    feature_maps: int = 128
    query_maps: int = 128
    msg_layers: int = 2
    vote_layers: int = 2
    train_rounds: int = 16
    test_rounds: int = 32
    supervised: bool = True
    use_message_passing: bool = True
    use_query: bool = True
    # CE weight multiplier on free message-bit input vars
    # (batch.free_input_mask): their accuracy is the systems-solved
    # bottleneck of input-anchored completion (sat/anf_completion.py)
    free_input_upweight: float = 1.0
    update_scale: float = 2.0
    output_scale: float = 1.0
    clauses_scale: float = 2.0
    query_scale: float = 3.0

    def mlp_configs(self) -> dict[str, tuple[MLPConfig, int]]:
        f, q = self.feature_maps, self.query_maps
        clause_in = f
        if self.use_message_passing:
            clause_in += q
        if self.use_query:
            # the q query columns are q/2 real + q/2 imaginary halves
            # (anf_value_cplx), so the [real, imag] concat is q wide
            clause_in += q
        return {
            "update_gate": (MLPConfig(self.msg_layers,
                                      int(f * self.update_scale), f), f + q),
            "variables_output": (MLPConfig(self.vote_layers,
                                           int(f * self.output_scale), 1), f),
            "variables_query": (MLPConfig(self.vote_layers,
                                          int(q * self.query_scale), q),
                                f + 4),
            "clause_mlp": (MLPConfig(self.msg_layers,
                                     int(f * self.update_scale), f + q),
                           clause_in),
            "grad_mlp": (MLPConfig(self.msg_layers,
                                   int(f * self.clauses_scale), q), q),
            "ands_mlp": (MLPConfig(self.msg_layers,
                                   int(f * self.clauses_scale), q),
                         2 * f + q),
            "var2ands_mlp": (MLPConfig(self.msg_layers,
                                       int(f * self.clauses_scale), q),
                             2 * f),
            "var2clause_mlp": (MLPConfig(self.msg_layers,
                                         int(f * self.clauses_scale), q), f),
        }

    @classmethod
    def from_meta(cls, config: dict, **overrides) -> "ANFSATConfig":
        """Config from a params file's `meta["config"]` record; keys this
        class does not know are skipped."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in config.items() if k in names}
        kw.update(overrides)
        return cls(**kw)


def anf_sat_init(generator: torch.Generator, cfg: ANFSATConfig) -> dict:
    """Random glorot params on the generator's device (`grad_mlp` is part
    of the tree, as in the TPU package and the pretrained files, though no
    round uses it)."""
    params = {name: mlp_init(generator, mcfg, in_dim)
              for name, (mcfg, in_dim) in cfg.mlp_configs().items()}
    params["zero_var"] = torch.full((1, cfg.query_maps), 0.02,
                                    device=generator.device)
    return params


def _zero_state(n_units: int, n_features: int, device: torch.device,
                stddev: float = 0.25) -> torch.Tensor:
    onehot = torch.zeros((n_units, n_features), device=device)
    onehot[:, 0] = 1.0
    onehot = onehot - 1.0 / n_features
    return onehot * torch.sqrt(torch.full((), float(n_features),
                                          device=device)) * stddev


def and_operand_slots(a1_var: torch.Tensor, a2_var: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The 2A operand slots of the AND nodes sorted by variable, once a
    batch, for `scatter_ands`: (the AND node of each slot, its variable).
    The sort is stable, so a variable's slots keep the order of the AND
    nodes' first operands, then of their second ones."""
    ops = torch.cat([a1_var, a2_var])
    order = torch.argsort(ops, stable=True)
    return torch.remainder(order, a1_var.shape[0]), ops.index_select(0, order)


def scatter_ands(ands_value: torch.Tensor,
                 slots: tuple[torch.Tensor, torch.Tensor],
                 num_vars: int) -> torch.Tensor:
    """Each AND node's row [A, F] added to both of its operand variables:
    [A, F] -> [V, F], each variable's slots summed in the order of
    `and_operand_slots` (no atomics), its backward a gather."""
    src, var = slots
    return segment_sum(gather_rows(ands_value, src), var, num_vars)


def anf_sat_apply(params: dict, cfg: ANFSATConfig, batch: ANFBatch,
                  generator: torch.Generator | None = None,
                  training: bool = True,
                  labels: torch.Tensor | None = None,
                  rounds: int | None = None,
                  tiles: TiledIncidence | None = None,
                  plans: ANFPlans | None = None,
                  round_noise: torch.Tensor | None = None,
                  device: str | torch.device = "cuda"):
    """Run the recurrent loop. Returns (last_logits [V, 1], loss, steps, {}).

    `labels` ([V] bits) select the supervised loss; without them (or with
    `cfg.supervised` False) the unsupervised loss is computed. `rounds`
    defaults to `cfg.train_rounds` when training and `cfg.test_rounds`
    otherwise. `training=True` records the autograd graph whatever the
    caller's grad mode, and recomputes each round in the backward;
    inference records none. The batch, params, plans and tiles are moved to
    `device`; `generator` must live there.
    """
    if plans is not None and tiles is not None:
        raise ValueError("pass plans or tiles, not both")
    with torch.set_grad_enabled(training):
        return _anf_sat_apply(params, cfg, batch, generator, training,
                              labels, rounds, tiles, plans, round_noise,
                              device)


def _anf_sat_apply(params, cfg, batch, generator, training, labels, rounds,
                   tiles, plans, round_noise, device):
    dev = resolve_device(device)
    batch = batch.to(dev)
    params = params_to(params, dev)
    plans = None if plans is None else plans.to(dev)
    tiles = None if tiles is None else tiles.to(dev)
    mcfgs = cfg.mlp_configs()
    V, Q = batch.V, cfg.query_maps
    if rounds is None:
        rounds = cfg.train_rounds if training else cfg.test_rounds
    if round_noise is not None:
        round_noise = round_noise.to(device=dev, dtype=torch.float32)
        if round_noise.shape[0] < rounds:
            raise ValueError(f"round_noise holds {round_noise.shape[0]} "
                             f"rounds, need {rounds}")

    degree_weight = torch.rsqrt(torch.clamp(node_degrees(batch), min=1.0))
    clause_degree_weight = torch.rsqrt(
        torch.clamp(clause_degrees(batch), min=1.0))

    # AND operand variable rows, 0-based into [V] (operands are never the
    # constant in the generated systems; clamped anyway)
    a1_var = torch.clamp(batch.and1 - 1, min=0)
    a2_var = torch.clamp(batch.and2 - 1, min=0)
    and_slots = and_operand_slots(a1_var, a2_var)

    supervised = cfg.supervised and labels is not None
    smoothed = ce_w = None
    if supervised:
        smoothed = 0.5 * 0.1 + labels.to(dev, torch.float32)[:, None] * 0.9
        ce_w = batch.var_mask
        if cfg.free_input_upweight != 1.0 and \
                batch.free_input_mask is not None:
            ce_w = ce_w * (1.0 + (cfg.free_input_upweight - 1.0) *
                           batch.free_input_mask)

    # every tensor a round reads besides its carry: a graphed round loop
    # copies these into its buffers
    ctx = dict(params=params, batch=batch, plans=plans, tiles=tiles,
               degree_weight=degree_weight,
               clause_degree_weight=clause_degree_weight, a1_var=a1_var,
               a2_var=a2_var, and_slots=and_slots, smoothed=smoothed,
               ce_w=ce_w)

    def make_round(ctx):
        params, batch = ctx["params"], ctx["batch"]
        plans, tiles = ctx["plans"], ctx["tiles"]
        degree_weight = ctx["degree_weight"]
        clause_degree_weight = ctx["clause_degree_weight"]
        a1_var, a2_var = ctx["a1_var"], ctx["a2_var"]
        and_slots = ctx["and_slots"]
        smoothed, ce_w = ctx["smoothed"], ctx["ce_w"]

        if tiles is not None:
            def to_clauses(x_nodes):
                return tiled_lit_to_clause(x_nodes, tiles)

            def to_nodes(x_clauses):
                return tiled_clause_to_lit(x_clauses, tiles)
        else:
            def to_clauses(x_nodes):
                return seg_to_clause(x_nodes, batch, plans)

            def to_nodes(x_clauses):
                return seg_to_nodes(x_clauses, batch, plans)

        def ands_to_vars(ands_value):
            if plans is not None:
                return plan_and_to_var(ands_value, plans)
            return scatter_ands(ands_value, and_slots, V)

        def round_body(variables, clause_state, loss_sum, noise4):
            if cfg.use_query:
                v1 = torch.cat([variables, noise4], dim=-1)
                query = mlp_apply(params["variables_query"],
                                  mcfgs["variables_query"][0], v1)
                clauses_real, clauses_im, _, _ = anf_value_cplx(
                    query, batch, tiles=tiles, plans=plans)
                query_msg = torch.cat([clauses_real, clauses_im], dim=-1)

            ands1 = gather_rows(variables, a1_var)          # [A, f]
            ands2 = gather_rows(variables, a2_var)

            if cfg.use_message_passing:
                ands_data = mlp_apply(params["var2ands_mlp"],
                                      mcfgs["var2ands_mlp"][0],
                                      torch.cat([ands1, ands2], dim=-1))
                var_data = mlp_apply(params["var2clause_mlp"],
                                     mcfgs["var2clause_mlp"][0], variables)
                node_data = torch.cat([params["zero_var"], var_data, ands_data],
                                      dim=0)
                clause_messages = to_clauses(node_data) * clause_degree_weight
                parts = [clause_state, clause_messages]
                if cfg.use_query:
                    parts.append(query_msg)
                clause_unit = torch.cat(parts, dim=-1)
            else:
                clause_unit = torch.cat([clause_state, query_msg], dim=-1)
            clause_data = mlp_apply(params["clause_mlp"], mcfgs["clause_mlp"][0],
                                    clause_unit)

            loss_to_vars = clause_data[:, :Q]
            new_clause_value = pair_norm_clauses(clause_data[:, Q:], batch) * 0.25
            clause_state = new_clause_value + 0.1 * clause_state

            # clause -> node replies: the variable rows and the AND-node rows
            nodes_loss = to_nodes(loss_to_vars) * degree_weight
            variables_loss = nodes_loss[1:V + 1]
            ands_loss = nodes_loss[1 + V:]
            ands_value = mlp_apply(params["ands_mlp"], mcfgs["ands_mlp"][0],
                                   torch.cat([ands1, ands2, ands_loss], dim=-1))
            ands_value = ands_value * batch.and_mask[:, None]
            # each AND node's value goes back to both operand variables
            variables_loss = variables_loss + ands_to_vars(ands_value)

            new_variables = mlp_apply(params["update_gate"],
                                      mcfgs["update_gate"][0],
                                      torch.cat([variables, variables_loss],
                                                dim=-1))
            new_variables = pair_norm_vars(new_variables, batch) * 0.25
            variables = new_variables + 0.1 * variables

            logits = mlp_apply(params["variables_output"],
                               mcfgs["variables_output"][0], variables)
            if supervised:
                ce = torch.relu(logits) - logits * smoothed + \
                    torch.log1p(torch.exp(-torch.abs(logits)))
                logit_loss = torch.sum(ce * ce_w[:, None]) / \
                    torch.clamp(torch.sum(ce_w), min=1.0)
            else:
                neg2 = torch.cat([-logits, torch.zeros_like(logits)], dim=-1)
                clauses_real, _, _, _ = anf_value_cplx(
                    neg2, batch, use_norm=True, tiles=tiles, plans=plans)
                per_clause_loss = torch.square(1 - clauses_real) * \
                    batch.clause_mask[:, None]
                per_graph_loss = clause_segment_sum(batch, per_clause_loss)
                masked = torch.where(batch.graph_mask[:, None] > 0,
                                     per_graph_loss + 1e-6, 0.0)
                logit_loss = torch.sum(torch.sqrt(masked))

            # the TPU package blends stop_gradient(x) * 0.2 + x * 0.8
            variables = variables.detach() * 0.2 + variables * 0.8
            clause_state = clause_state.detach() * 0.2 + clause_state * 0.8
            return variables, clause_state, loss_sum + logit_loss, logits
        return round_body

    round_body = make_round(ctx)
    body = round_body
    if training:
        def body(*args):
            # the noise is drawn outside the body: the recompute needs
            # no saved RNG state
            return torch_checkpoint.checkpoint(round_body, *args,
                                               use_reentrant=False,
                                               preserve_rng_state=False)

    def draw_noise(t, gen=generator):
        if not cfg.use_query:
            return None
        if round_noise is not None:
            return round_noise[t]
        return torch.randn((V, 4), generator=gen, device=dev)

    variables = _zero_state(V, cfg.feature_maps, dev)
    clause_state = _zero_state(batch.C, cfg.feature_maps, dev)
    loss_sum = torch.zeros((), device=dev)
    logits = torch.zeros((V, 1), device=dev)
    if not training and rounds > 0 and cuda_graphs.graphs_enabled(dev):
        # one CUDA graph of the round, replayed `rounds` times
        def make_step(ctx):
            round_body = make_round(ctx)

            def step(carry, gen, noise):
                if noise is None:
                    noise = draw_noise(None, gen)
                return round_body(*carry[:3], noise)
            return step

        variables, clause_state, loss_sum, logits = cuda_graphs.run_rounds(
            make_step, ("anf_sat", cfg, str(dev)), ctx,
            (variables, clause_state, loss_sum, logits), rounds, generator,
            round_noise if cfg.use_query else None)
    else:
        for t in range(rounds):
            variables, clause_state, loss_sum, logits = body(
                variables, clause_state, loss_sum, draw_noise(t))
    loss = loss_sum / float(rounds)
    steps = torch.full((), rounds - 1, dtype=torch.int32, device=dev)
    return logits, loss, steps, {}

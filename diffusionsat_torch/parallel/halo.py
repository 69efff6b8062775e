"""Cut-proportional halo exchange for clause-partitioned execution.

Counterpart of the TPU package's `parallel/halo.py` (the SURVEY §5.7
design). It replaces the full [2V, F] all-reduce of a round's literal
aggregates (`parallel/graph_partition.py`) with boundary-only traffic:

- clause shard s needs correct literal aggregates only on the literal
  closure R_s of its graphs (all literals of every graph with a clause in
  s: PairNorm couples a graph's variables);
- with the packer's graph-contiguous clause layout, R_s and R_t (s != t)
  share only the literals of graphs that straddle the s/t boundary;
- per round, each rank sends those shared rows of its partial aggregate to
  the rank that shares them (one all-to-all) and adds what it receives.

`build_halo_plan` is host numpy, its arrays equal to the TPU package's.
A rank's `HaloView` carries its row of the plan as two kernel plans: the
gather of its shared rows into the send buffer ([n x B] segments of at
most one literal each) and its transpose, the add of the received rows
into their literals. So `halo_exchange` is two launches of the segsum
kernel around the all-to-all, and the add sums in one fixed order. Each
plan is the other's backward, and the all-to-all's backward is an
all-to-all: the exchange is differentiable under the outer training
gradient.

`make_halo_gp_train_step` is the clause-sharded step with the halo
exchange. Per-graph supervised losses are owner-masked and all-reduced
(a [G, K] exchange), so every graph's loss counts once and every rank
holds the whole loss; the gradient rule of `graph_partition.py` then
gives the single-device gradient. The TPU package's step sums the ranks'
gradients of the whole loss instead, which is n_shards times the
single-device gradient (ROADMAP.md, faults of the reference).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diffusionsat_torch.graph.batch import SatBatch
from diffusionsat_torch.ops.segsum import (
    SegsumPlan,
    _PlannedSpMM,
    build_segsum_plan,
)
from diffusionsat_torch.parallel.comm import all_to_all, group_size
from diffusionsat_torch.parallel.graph_partition import make_gp_train_step
from diffusionsat_torch.parallel.mesh import Mesh


@dataclasses.dataclass
class HaloPlan:
    """Stacked per-shard halo metadata (leading axis = shard), on the
    host."""
    owner_mask: torch.Tensor  # [n, G] f32: 1 where this shard owns the graph
    send_idx: torch.Tensor    # [n, n, B] int32 symmetric shared-row ids
    send_mask: torch.Tensor   # [n, n, B] f32
    halo_rows: int = 0
    n_shards: int = 1
    literal_rows: int = 0     # 2V

    def view(self, shard: int) -> "HaloView":
        """Shard `shard`'s view: its owner mask and its send and receive
        plans (host tensors). The padding slots (mask 0) are in neither
        plan."""
        idx = self.send_idx[shard].numpy().reshape(-1).astype(np.int64)
        mask = self.send_mask[shard].numpy().reshape(-1)
        slots = np.arange(idx.shape[0])
        order = np.argsort(idx, kind="stable")
        send = build_segsum_plan("halo_send", slots, idx, mask,
                                 num_segments=slots.shape[0],
                                 num_sources=self.literal_rows)
        recv = build_segsum_plan("halo_recv", idx[order], slots[order],
                                 mask[order], num_segments=self.literal_rows,
                                 num_sources=slots.shape[0])
        # the shards that hold each variable's row complete: this one and
        # every shard it shares the row with
        V = self.literal_rows // 2
        shared = idx[(mask > 0) & (idx < V)]
        copies = 1.0 + np.bincount(shared, minlength=V).astype(np.float32)
        return HaloView(owner_mask=self.owner_mask[shard], send=send,
                        recv=recv, n_shards=self.n_shards,
                        var_copies=torch.from_numpy(copies))


@dataclasses.dataclass
class HaloView:
    """One rank's row of a `HaloPlan`: what `query_sat_apply(...,
    halo=...)` and `halo_exchange` read."""
    owner_mask: torch.Tensor   # [G] f32
    send: SegsumPlan           # [n B] send slots <- literal rows
    recv: SegsumPlan           # [2V] literal rows <- received slots
    n_shards: int
    var_copies: torch.Tensor   # [V] f32: shards holding each variable row

    def to(self, device: str | torch.device) -> "HaloView":
        return dataclasses.replace(
            self, owner_mask=self.owner_mask.to(device),
            send=self.send.to(device), recv=self.recv.to(device),
            var_copies=self.var_copies.to(device))

    def exchange(self, partial: torch.Tensor, group) -> torch.Tensor:
        return halo_exchange(partial, self, group)

    def balance_copies(self, x: torch.Tensor, group) -> torch.Tensor:
        """`x` [V, F], a variable-side state whose rows are complete on
        every shard that holds them: the identity, whose backward hands
        each complete copy of a row the mean of those copies' cotangents
        (the halo's counterpart of `comm.balance_copies`; the rows a
        shard does not hold get no cotangent there)."""
        return _BalanceHalo.apply(x, self, group)


def build_halo_plan(batch: SatBatch, n_shards: int) -> HaloPlan:
    """Host-side halo plan from the full flat batch.

    Graph g is owned by the shard holding its first clause. R_s is the
    literal closure of shard s's graphs; send_idx[s, t] lists
    sorted(R_s & R_t) (the same from both ends), padded with the dummy row
    2V-1 under mask 0."""
    C, V, G = batch.C, batch.V, batch.G
    if C % n_shards:
        raise ValueError(f"{C} clauses do not split into {n_shards} shards:"
                         " pad clauses to a multiple of the shard count")
    c_per = C // n_shards
    clause_graph = batch.clause_graph.numpy()
    nv = batch.n_vars_per_graph.numpy().astype(np.int64)
    v_off = np.concatenate([[0], np.cumsum(nv)])

    def graph_literals(g: int) -> np.ndarray:
        vs = np.arange(v_off[g], v_off[g + 1], dtype=np.int64)
        return np.concatenate([vs, vs + V])

    owner = np.full(G, -1, dtype=np.int64)
    shard_graphs: list[set] = [set() for _ in range(n_shards)]
    for s in range(n_shards):
        for g in np.unique(clause_graph[s * c_per:(s + 1) * c_per]):
            if g >= G:  # the padding segment
                continue
            shard_graphs[s].add(int(g))
            if owner[g] < 0:
                owner[g] = s
    owner_mask = np.zeros((n_shards, G), np.float32)
    for g in range(G):
        if owner[g] >= 0:
            owner_mask[owner[g], g] = 1.0

    R = []
    for s in range(n_shards):
        lits = ([graph_literals(g) for g in sorted(shard_graphs[s])]
                or [np.zeros(0, np.int64)])
        R.append(np.unique(np.concatenate(lits)))

    pair_rows: dict[tuple[int, int], np.ndarray] = {}
    B = 8
    for s in range(n_shards):
        for t in range(s + 1, n_shards):
            rows = np.intersect1d(R[s], R[t])
            pair_rows[(s, t)] = rows
            B = max(B, len(rows))
    B = -(-B // 8) * 8

    send_idx = np.full((n_shards, n_shards, B), 2 * V - 1, np.int32)
    send_mask = np.zeros((n_shards, n_shards, B), np.float32)
    for (s, t), rows in pair_rows.items():
        k = len(rows)
        send_idx[s, t, :k] = rows
        send_idx[t, s, :k] = rows
        send_mask[s, t, :k] = 1.0
        send_mask[t, s, :k] = 1.0
    halo_rows = int(max((send_mask[s].sum() for s in range(n_shards)),
                        default=0))
    return HaloPlan(owner_mask=torch.from_numpy(owner_mask),
                    send_idx=torch.from_numpy(send_idx),
                    send_mask=torch.from_numpy(send_mask),
                    halo_rows=halo_rows, n_shards=n_shards,
                    literal_rows=2 * V)


class _BalanceHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, view, group):
        ctx.view, ctx.group = view, group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # the shared rows' cotangents summed over their shards (the
        # exchange on the positive-literal rows), over the copies
        lit = torch.cat([grad, torch.zeros_like(grad)]).contiguous()
        total = halo_exchange(lit, ctx.view, ctx.group)[:grad.shape[0]]
        return total / ctx.view.var_copies[:, None], None, None


def halo_exchange(partial: torch.Tensor, view: HaloView,
                  group) -> torch.Tensor:
    """Complete a local partial literal aggregate [2V, F] on its halo rows:
    gather the rows shared with each other shard (kernel), exchange them
    (all-to-all), add what arrives into its literal rows (kernel). The rows
    outside this shard's closure stay partial by design."""
    n = view.n_shards
    if group_size(group) != n:
        raise ValueError(f"a {n}-shard halo view on a group of "
                         f"{group_size(group)}")
    buf = _PlannedSpMM.apply(partial, view.send, view.recv)   # [n B, F]
    recv = all_to_all(buf.view(n, -1, partial.shape[1]), group)
    return partial + _PlannedSpMM.apply(
        recv.reshape(buf.shape), view.recv, view.send)


def make_halo_gp_train_step(cfg, optimizer, mesh: Mesh, plan: HaloPlan):
    """The clause-sharded QuerySAT train step with halo-exchange
    collectives: `graph_partition.make_gp_train_step` with this rank's
    view of `plan` (the graph group's rank s holds shard s). The two
    [2V, Q] literal aggregations of a round exchange only the shard's
    shared rows; the per-graph losses are owner-masked and all-reduced.
    Its gradient is the single-device gradient."""
    if plan.n_shards != mesh.n_graph:
        raise ValueError(f"a {plan.n_shards}-shard plan on a graph group "
                         f"of {mesh.n_graph}")
    return make_gp_train_step(cfg, optimizer, mesh,
                              halo=plan.view(mesh.graph_index))


def comm_bytes_per_round(plan: HaloPlan, width: int) -> dict:
    """The bytes one rank sends a round for the round's two [2V, width]
    f32 literal aggregations: the ring all-reduce of the whole aggregate
    (2 (n-1)/n of it) against the halo exchange of the rank's shared rows
    (its largest row count, `plan.halo_rows`)."""
    n = plan.n_shards
    all_reduce = 2 * 2 * (n - 1) / n * plan.literal_rows * width * 4
    halo = 2 * plan.halo_rows * width * 4
    return {"all_reduce": all_reduce, "halo": halo,
            "halo_rows": plan.halo_rows, "literal_rows": plan.literal_rows}

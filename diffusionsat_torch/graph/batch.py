"""Static-shape batched literal-clause graph container.

The same padded layout as the TPU package's `graph/batch.py`, with the
arrays held as torch tensors:

- literals are rows `0..V-1` (positive) and `V..2V-1` (negative), with the
  *padded* variable count V as the negation offset;
- the incidence is kept as two edge orderings of the same edge set:
  clause-sorted (for literal->clause aggregation) and literal-sorted (for
  clause->literal aggregation);
- graph membership is the `var_graph`/`clause_graph` segment-id vectors;
  padding elements point at a dedicated dummy segment G.

`BucketSpec` and `build_batch` are numpy host code; `build_batch` returns a
`SatBatch` of CPU tensors with the TPU package's field names, dtypes and
padding conventions, and `SatBatch.to(device)` moves it to the card.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static padded sizes of one batch bucket."""
    max_vars: int
    max_clauses: int
    max_edges: int
    max_graphs: int

    @classmethod
    def for_node_budget(cls, max_nodes_per_batch: int,
                        mean_clause_len: float = 3.2,
                        max_graphs: int = 512) -> "BucketSpec":
        """Derive padded sizes from the packing node budget (2V + C <=
        budget), sized for threshold 3-SAT-like clause/variable mixes."""
        max_vars = _round_up(max(max_nodes_per_batch // 4, 128), 128)
        max_clauses = _round_up(max(int(max_nodes_per_batch * 0.75), 128),
                                128)
        max_edges = _round_up(int(max_clauses * mean_clause_len), 512)
        return cls(max_vars=max_vars, max_clauses=max_clauses,
                   max_edges=max_edges, max_graphs=max_graphs)


@dataclasses.dataclass
class SatBatch:
    """One packed batch of CNF formulas as padded tensors.

    Shapes: V vars, C clauses, E edges, G graphs. The literal index space
    has size 2V (positive then negative). Padding rows carry zero masks and
    point at segment id G (graphs) or at the last clause/literal (edges).
    """
    # clause-sorted edge ordering (for literal -> clause segment sums)
    edge_lit_c: torch.Tensor     # [E] int32, literal id in [0, 2V)
    edge_clause_c: torch.Tensor  # [E] int32, sorted ascending
    edge_mask_c: torch.Tensor    # [E] f32
    # literal-sorted edge ordering (for clause -> literal segment sums)
    edge_lit_l: torch.Tensor     # [E] int32, sorted ascending
    edge_clause_l: torch.Tensor  # [E] int32
    edge_mask_l: torch.Tensor    # [E] f32
    # permutation: literal-order position j = clause-order position perm[j]
    edge_perm_l: torch.Tensor    # [E] int32
    # node masks and graph membership
    var_mask: torch.Tensor       # [V] f32
    clause_mask: torch.Tensor    # [C] f32
    var_graph: torch.Tensor      # [V] int32 in [0, G]; G = padding segment
    clause_graph: torch.Tensor   # [C] int32 in [0, G]
    graph_mask: torch.Tensor     # [G] f32
    n_vars_per_graph: torch.Tensor    # [G] f32
    n_clauses_per_graph: torch.Tensor  # [G] f32
    # labels
    solutions: torch.Tensor      # [V] int32 solution bit per variable (0 pad)
    # actual (unpadded) counts
    n_vars: torch.Tensor         # [] int32
    n_clauses: torch.Tensor      # [] int32
    n_graphs: torch.Tensor       # [] int32
    # optional [K, V] int32 bank of K solution samples (row 0 == solutions)
    solutions_k: torch.Tensor | None = None
    # optional [K, G] f32 per-bank-row isolation scores
    label_isolation_k: torch.Tensor | None = None

    @property
    def V(self) -> int:
        return self.var_mask.shape[0]

    @property
    def C(self) -> int:
        return self.clause_mask.shape[0]

    @property
    def E(self) -> int:
        return self.edge_lit_c.shape[0]

    @property
    def G(self) -> int:
        return self.graph_mask.shape[0]

    @property
    def device(self) -> torch.device:
        return self.var_mask.device

    def to(self, device: str | torch.device) -> "SatBatch":
        """A copy with every tensor on `device` (tensors already there are
        shared, not copied)."""
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self)}
        return SatBatch(**{k: None if v is None else v.to(device)
                           for k, v in fields.items()})


def build_batch(formulas: Sequence[tuple[int, Sequence[Sequence[int]]]],
                bucket: BucketSpec,
                solutions: Sequence[Sequence[int]] | None = None,
                ) -> SatBatch:
    """Pack formulas [(n_vars, clauses), ...] into one padded SatBatch.

    Variables of consecutive formulas are shifted into one index space.
    `solutions[i]` is a 0/1 bit list of length n_vars_i, or a [K, n_vars_i]
    nested list of K solution samples (rows cycle if a formula supplies
    fewer than the batch-wide K); with K > 1 the batch carries a
    `solutions_k` bank and `solutions` holds row 0. Raises if the bucket is
    too small.
    """
    V, C, E, G = (bucket.max_vars, bucket.max_clauses, bucket.max_edges,
                  bucket.max_graphs)
    n_graphs = len(formulas)
    if n_graphs > G:
        raise ValueError(f"{n_graphs} formulas > bucket max_graphs {G}")

    var_graph = np.full(V, G, dtype=np.int32)
    clause_graph = np.full(C, G, dtype=np.int32)
    n_vars_per_graph = np.zeros(G, dtype=np.float32)
    n_clauses_per_graph = np.zeros(G, dtype=np.float32)
    sol = np.zeros(V, dtype=np.int32)
    K = 1
    sol_arrs: list[np.ndarray] = []
    if solutions is not None:
        sol_arrs = [np.asarray(s, dtype=np.int32) for s in solutions]
        K = max((a.shape[0] if a.ndim == 2 else 1) for a in sol_arrs) \
            if sol_arrs else 1
    sol_k = np.zeros((K, V), dtype=np.int32) if K > 1 else None

    edge_lit: list[int] = []
    edge_clause: list[int] = []

    v_off = 0
    c_off = 0
    for g, (n_vars, clauses) in enumerate(formulas):
        n_cl = len(clauses)
        if v_off + n_vars > V or c_off + n_cl > C:
            raise ValueError("bucket too small for batch (vars/clauses)")
        var_graph[v_off:v_off + n_vars] = g
        clause_graph[c_off:c_off + n_cl] = g
        n_vars_per_graph[g] = n_vars
        n_clauses_per_graph[g] = n_cl
        if solutions is not None:
            bits = np.atleast_2d(sol_arrs[g])      # [k_g, n_vars]
            if bits.shape[1] != n_vars:
                raise ValueError("solution length mismatch")
            sol[v_off:v_off + n_vars] = bits[0]
            if sol_k is not None:
                rows = bits[np.arange(K) % bits.shape[0]]
                sol_k[:, v_off:v_off + n_vars] = rows
        for ci, clause in enumerate(clauses):
            for lit in clause:
                v = abs(lit) - 1 + v_off
                edge_lit.append(v if lit > 0 else V + v)
                edge_clause.append(c_off + ci)
        v_off += n_vars
        c_off += n_cl

    n_edges = len(edge_lit)
    if n_edges > E:
        raise ValueError(f"{n_edges} edges > bucket max_edges {E}")

    el = np.asarray(edge_lit, dtype=np.int32)
    ec = np.asarray(edge_clause, dtype=np.int32)

    # clause-sorted ordering (the builder emits clause-major already, but
    # sort to be safe) and literal-sorted ordering
    order_c = np.argsort(ec, kind="stable")
    order_l = np.argsort(el[order_c], kind="stable")

    def _pad(a: np.ndarray, size: int, fill: int) -> np.ndarray:
        out = np.full(size, fill, dtype=np.int32)
        out[:len(a)] = a
        return out

    # padding edges point at the last clause / last literal row with mask 0
    edge_lit_c = _pad(el[order_c], E, 2 * V - 1)
    edge_clause_c = _pad(ec[order_c], E, C - 1)
    edge_lit_l = _pad(el[order_c][order_l], E, 2 * V - 1)
    edge_clause_l = _pad(ec[order_c][order_l], E, C - 1)
    edge_perm_l = np.arange(E, dtype=np.int32)
    edge_perm_l[:n_edges] = order_l
    emask = np.zeros(E, dtype=np.float32)
    emask[:n_edges] = 1.0

    var_mask = np.zeros(V, dtype=np.float32)
    var_mask[:v_off] = 1.0
    clause_mask = np.zeros(C, dtype=np.float32)
    clause_mask[:c_off] = 1.0
    graph_mask = np.zeros(G, dtype=np.float32)
    graph_mask[:n_graphs] = 1.0

    t = torch.from_numpy
    return SatBatch(
        edge_lit_c=t(edge_lit_c),
        edge_clause_c=t(edge_clause_c),
        edge_mask_c=t(emask),
        edge_lit_l=t(edge_lit_l),
        edge_clause_l=t(edge_clause_l),
        edge_mask_l=t(emask.copy()),
        edge_perm_l=t(edge_perm_l),
        var_mask=t(var_mask),
        clause_mask=t(clause_mask),
        var_graph=t(var_graph),
        clause_graph=t(clause_graph),
        graph_mask=t(graph_mask),
        n_vars_per_graph=t(n_vars_per_graph),
        n_clauses_per_graph=t(n_clauses_per_graph),
        solutions=t(sol),
        n_vars=torch.tensor(v_off, dtype=torch.int32),
        n_clauses=torch.tensor(c_off, dtype=torch.int32),
        n_graphs=torch.tensor(n_graphs, dtype=torch.int32),
        solutions_k=None if sol_k is None else t(sol_k),
    )


def attach_label_isolation(batch: SatBatch) -> SatBatch:
    """Per-bank-row isolation scores for weighted label selection.

    For each graph, every `solutions_k` row gets its mean Hamming distance
    (fraction of differing bits over the graph's vars) to the other K-1
    rows, z-scored within the graph. The bank rows are uniform solution
    draws, so the distance to the bank estimates the distance to a random
    solution. Host-side numpy; a batch without a bank comes back as it is.
    """
    if batch.solutions_k is None:
        return batch
    sk = batch.solutions_k.detach().cpu().numpy()      # [K, V]
    K = sk.shape[0]
    var_graph = batch.var_graph.detach().cpu().numpy()
    G = batch.graph_mask.shape[0]
    iso = np.zeros((K, G), np.float32)
    if K > 1:
        for g in range(int(batch.n_graphs)):
            rows = sk[:, var_graph == g]                # [K, n_vars_g]
            if rows.shape[1] == 0:
                continue
            d = (rows[:, None, :] != rows[None, :, :]).mean(-1)
            dbar = d.sum(1) / (K - 1)
            std = dbar.std()
            if std > 1e-9:
                iso[:, g] = (dbar - dbar.mean()) / std
    return dataclasses.replace(
        batch, label_isolation_k=torch.from_numpy(iso).to(batch.device))

"""Static-shape batched ANF (XOR of AND-terms) equation systems.

Counterpart of the TPU package's `graph/anf_batch.py`, with the arrays held
as torch tensors. The node index space is [0] = constant one, [1..V] =
variables, [V+1..V+A] = AND-pair nodes; the sparse (1+V+A) x C membership
matrix is kept as masked edge lists in two orders, clause-sorted (node ->
clause sums) and node-sorted (clause -> node sums). An equation (clause) is
the XOR of its member nodes.

`build_anf_batch` is numpy host code and returns an `ANFBatch` of CPU
tensors with that package's field names, dtypes and padding conventions;
`ANFBatch.to(device)` moves it to the card.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

Term = tuple  # () = const 1, (i,) = var i (1-based), (i, j) = AND pair


@dataclasses.dataclass(frozen=True)
class ANFBucket:
    """Static padded sizes of one ANF batch."""
    max_vars: int
    max_ands: int
    max_clauses: int
    max_edges: int
    max_graphs: int


@dataclasses.dataclass
class ANFBatch:
    """One packed batch of ANF systems as padded tensors (V vars, A AND
    nodes, C clauses, E membership edges, G graphs)."""
    # AND-pair definitions: operand node ids in [0, V] (0 = const one)
    and1: torch.Tensor          # [A] int32
    and2: torch.Tensor          # [A] int32
    and_mask: torch.Tensor      # [A] f32
    # node -> clause membership edges (node ids in [0, 1+V+A))
    edge_node_c: torch.Tensor   # [E] int32
    edge_clause_c: torch.Tensor  # [E] int32, sorted
    edge_mask_c: torch.Tensor   # [E] f32
    edge_node_n: torch.Tensor   # [E] int32, sorted by node
    edge_clause_n: torch.Tensor  # [E] int32
    edge_mask_n: torch.Tensor   # [E] f32
    # structure masks
    var_mask: torch.Tensor      # [V] f32
    clause_mask: torch.Tensor   # [C] f32
    var_graph: torch.Tensor     # [V] int32 (padding -> G)
    clause_graph: torch.Tensor  # [C] int32 (padding -> G)
    graph_mask: torch.Tensor    # [G] f32
    n_vars_per_graph: torch.Tensor     # [G] f32
    n_clauses_per_graph: torch.Tensor  # [G] f32
    solutions: torch.Tensor     # [V] int32
    n_vars: torch.Tensor        # [] int32
    n_clauses: torch.Tensor     # [] int32
    n_graphs: torch.Tensor      # [] int32
    # 1.0 on free message-bit input vars (no equation defines them: the
    # circuit's true degrees of freedom, sat/anf_completion.free_inputs_of);
    # the supervised CE can upweight these rows. Optional, so that caches
    # written before the field existed still load.
    free_input_mask: torch.Tensor | None = None  # [V] f32

    @property
    def V(self) -> int:
        return self.var_mask.shape[0]

    @property
    def A(self) -> int:
        return self.and1.shape[0]

    @property
    def C(self) -> int:
        return self.clause_mask.shape[0]

    @property
    def E(self) -> int:
        return self.edge_node_c.shape[0]

    @property
    def G(self) -> int:
        return self.graph_mask.shape[0]

    @property
    def n_value_nodes(self) -> int:
        """1 (const) + V (vars) + A (and nodes)."""
        return 1 + self.V + self.A

    @property
    def device(self) -> torch.device:
        return self.var_mask.device

    def to(self, device: str | torch.device) -> "ANFBatch":
        """A copy with every tensor on `device` (tensors already there are
        shared, not copied)."""
        return ANFBatch(**{f.name: None if getattr(self, f.name) is None
                           else getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)})


def build_anf_batch(systems: Sequence[tuple[int, Sequence[Sequence[Term]]]],
                    bucket: ANFBucket,
                    solutions: Sequence[Sequence[int]] | None = None
                    ) -> ANFBatch:
    """Pack ANF systems [(n_vars, equations)] into one padded ANFBatch of
    CPU tensors.

    Each equation is a list of terms; duplicate AND pairs within a system
    share one AND node. Raises ValueError when the bucket is too small.
    """
    V, A, C, E, G = (bucket.max_vars, bucket.max_ands, bucket.max_clauses,
                     bucket.max_edges, bucket.max_graphs)
    n_graphs = len(systems)
    if n_graphs > G:
        raise ValueError(f"{n_graphs} systems > bucket max_graphs {G}")

    and1 = np.zeros(A, dtype=np.int32)
    and2 = np.zeros(A, dtype=np.int32)
    and_mask = np.zeros(A, dtype=np.float32)
    var_graph = np.full(V, G, dtype=np.int32)
    clause_graph = np.full(C, G, dtype=np.int32)
    nvpg = np.zeros(G, dtype=np.float32)
    ncpg = np.zeros(G, dtype=np.float32)
    sols = np.zeros(V, dtype=np.int32)
    free_mask = np.zeros(V, dtype=np.float32)

    edge_node: list[int] = []
    edge_clause: list[int] = []

    v_off = 0
    c_off = 0
    a_off = 0
    for g, (n_vars, equations) in enumerate(systems):
        pair_to_node: dict[tuple[int, int], int] = {}
        if v_off + n_vars > V or c_off + len(equations) > C:
            raise ValueError("ANF bucket too small")
        var_graph[v_off:v_off + n_vars] = g
        clause_graph[c_off:c_off + len(equations)] = g
        nvpg[g] = n_vars
        ncpg[g] = len(equations)
        if solutions is not None:
            sols[v_off:v_off + n_vars] = np.asarray(solutions[g],
                                                    dtype=np.int32)

        def node_of(term: Term) -> int:
            nonlocal a_off
            if len(term) == 0:
                return 0  # constant one
            if len(term) == 1:
                return 1 + v_off + (term[0] - 1)
            key = (min(term), max(term))
            if key not in pair_to_node:
                if a_off >= A:
                    raise ValueError("ANF bucket too small (ands)")
                and1[a_off] = 1 + v_off + (key[0] - 1)
                and2[a_off] = 1 + v_off + (key[1] - 1)
                and_mask[a_off] = 1.0
                pair_to_node[key] = 1 + V + a_off
                a_off += 1
            return pair_to_node[key]

        for ci, eq in enumerate(equations):
            for term in eq:
                edge_node.append(node_of(tuple(term)))
                edge_clause.append(c_off + ci)

        # free message-bit inputs: the SHA circuit is feed-forward, so every
        # equation's largest var id is the gate output it defines; a var
        # that is no equation's largest is a free input
        defined: set[int] = set()
        for eq in equations:
            vs = [v for term in eq for v in term]
            if vs:
                defined.add(max(vs))
        for v in range(1, n_vars + 1):
            if v not in defined:
                free_mask[v_off + v - 1] = 1.0
        v_off += n_vars
        c_off += len(equations)

    n_edges = len(edge_node)
    if n_edges > E:
        raise ValueError(f"{n_edges} edges > bucket max_edges {E}")

    en = np.asarray(edge_node, dtype=np.int32)
    ec = np.asarray(edge_clause, dtype=np.int32)
    order_c = np.argsort(ec, kind="stable")
    order_n = np.argsort(en[order_c], kind="stable")

    def pad(a, size, fill):
        out = np.full(size, fill, dtype=np.int32)
        out[:len(a)] = a
        return out

    emask = np.zeros(E, dtype=np.float32)
    emask[:n_edges] = 1.0
    var_mask = np.zeros(V, dtype=np.float32)
    var_mask[:v_off] = 1.0
    clause_mask = np.zeros(C, dtype=np.float32)
    clause_mask[:c_off] = 1.0
    graph_mask = np.zeros(G, dtype=np.float32)
    graph_mask[:n_graphs] = 1.0

    t = torch.from_numpy
    # padding edges point at the last node and the last clause, mask 0
    return ANFBatch(
        and1=t(and1), and2=t(and2), and_mask=t(and_mask),
        edge_node_c=t(pad(en[order_c], E, V + A)),
        edge_clause_c=t(pad(ec[order_c], E, C - 1)),
        edge_mask_c=t(emask),
        edge_node_n=t(pad(en[order_c][order_n], E, V + A)),
        edge_clause_n=t(pad(ec[order_c][order_n], E, C - 1)),
        edge_mask_n=t(emask.copy()),
        var_mask=t(var_mask), clause_mask=t(clause_mask),
        var_graph=t(var_graph), clause_graph=t(clause_graph),
        graph_mask=t(graph_mask), n_vars_per_graph=t(nvpg),
        n_clauses_per_graph=t(ncpg), solutions=t(sols),
        n_vars=torch.tensor(v_off, dtype=torch.int32),
        n_clauses=torch.tensor(c_off, dtype=torch.int32),
        n_graphs=torch.tensor(n_graphs, dtype=torch.int32),
        free_input_mask=t(free_mask))


def evaluate_anf(systems, solutions) -> list[bool]:
    """Host-side ground truth: each equation (with any constant folded in as
    the const-one term) must XOR to 0, the encoding under which a clause's
    value is +1 and its loss (1 - clauses_real)^2 vanishes."""
    out = []
    for (n_vars, equations), bits in zip(systems, solutions):
        ok = True
        for eq in equations:
            acc = 0
            for term in eq:
                if len(term) == 0:
                    val = 1
                elif len(term) == 1:
                    val = bits[term[0] - 1]
                else:
                    val = bits[term[0] - 1] & bits[term[1] - 1]
                acc ^= val
            if acc != 0:
                ok = False
                break
        out.append(ok)
    return out

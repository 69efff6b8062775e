"""Dense per-graph block batch layout.

The same padded layout as the TPU package's `graph/dense_batch.py`, held as
torch tensors. The flat edge-list layout (`graph/batch.py`) serves any
graph size; for the small formulas of the flagship workload (3-30
variables) every graph is instead padded to a fixed `[Cg, 2*Vg]` incidence
matrix (columns 0..Vg-1 = positive literals, Vg..2Vg-1 = negative), so both
literal-clause aggregations become one batched matrix product each and
pair norms, per-graph losses and SAT checks become masked reductions over
the node axis.

Re-blocking is numpy host code; `DenseSatBatch.to(device)` moves the result
to the card. Model parameters do not depend on the layout.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from diffusionsat_torch.graph.batch import SatBatch, _round_up


@dataclasses.dataclass
class DenseSatBatch:
    """A batch of G formulas as dense per-graph blocks (all padded)."""
    incidence: torch.Tensor          # [G, Cg, 2*Vg] f32 0/1 (k if repeated lit)
    var_mask: torch.Tensor           # [G, Vg] f32
    clause_mask: torch.Tensor        # [G, Cg] f32
    graph_mask: torch.Tensor         # [G] f32
    n_vars_per_graph: torch.Tensor   # [G] f32
    n_clauses_per_graph: torch.Tensor  # [G] f32
    solutions: torch.Tensor          # [G, Vg] int32
    n_vars: torch.Tensor             # [] int32 total real vars
    n_clauses: torch.Tensor          # [] int32
    n_graphs: torch.Tensor           # [] int32
    # optional multi-label bank [K, G, Vg] int32 (see SatBatch.solutions_k)
    solutions_k: torch.Tensor | None = None
    # optional per-bank-row isolation scores [K, G] f32
    label_isolation_k: torch.Tensor | None = None

    @property
    def G(self) -> int:
        return self.graph_mask.shape[0]

    @property
    def Vg(self) -> int:
        return self.var_mask.shape[1]

    @property
    def Cg(self) -> int:
        return self.clause_mask.shape[1]

    @property
    def device(self) -> torch.device:
        return self.var_mask.device

    def to(self, device: str | torch.device) -> "DenseSatBatch":
        """A copy with every tensor on `device` (tensors already there are
        shared, not copied)."""
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self)}
        return DenseSatBatch(**{k: None if v is None else v.to(device)
                                for k, v in fields.items()})


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def dense_dims_for(batches, pad_graphs: int = 4, pad_nodes: int = 8
                   ) -> tuple[int, int, int]:
    """Static (G, Vg, Cg) covering every flat batch in `batches`."""
    G = Vg = Cg = 1
    for b in batches:
        G = max(G, int(b.n_graphs))
        Vg = max(Vg, int(np.max(_np(b.n_vars_per_graph), initial=1)))
        Cg = max(Cg, int(np.max(_np(b.n_clauses_per_graph), initial=1)))
    return (_round_up(G, pad_graphs), _round_up(Vg, pad_nodes),
            _round_up(Cg, pad_nodes))


def dense_from_flat(b: SatBatch, G: int, Vg: int, Cg: int) -> DenseSatBatch:
    """Re-block a flat edge-list batch into dense per-graph incidence.

    Host-side numpy; the result holds CPU tensors. Requires every graph to
    fit (n_vars <= Vg, n_clauses <= Cg, n_graphs <= G)."""
    nb_graphs = int(b.n_graphs)
    nv = _np(b.n_vars_per_graph).astype(np.int64)[:nb_graphs]
    nc = _np(b.n_clauses_per_graph).astype(np.int64)[:nb_graphs]
    if nb_graphs > G or (len(nv) and nv.max() > Vg) or \
            (len(nc) and nc.max() > Cg):
        raise ValueError(
            f"batch ({nb_graphs} graphs, {nv.max(initial=0)} vars, "
            f"{nc.max(initial=0)} clauses) exceeds dense dims "
            f"({G}, {Vg}, {Cg})")
    v_off = np.concatenate([[0], np.cumsum(nv)])
    c_off = np.concatenate([[0], np.cumsum(nc)])

    em = _np(b.edge_mask_c) > 0
    lit = _np(b.edge_lit_c)[em].astype(np.int64)
    cl = _np(b.edge_clause_c)[em].astype(np.int64)
    V = b.V
    var = np.where(lit < V, lit, lit - V)
    neg = (lit >= V).astype(np.int64)
    g_e = _np(b.clause_graph)[cl].astype(np.int64)
    local_c = cl - c_off[g_e]
    local_v = var - v_off[g_e]
    col = local_v + neg * Vg

    inc = np.zeros((G, Cg, 2 * Vg), np.float32)
    # repeated literals in a clause accumulate, matching the flat
    # edge-list segment-sum semantics exactly
    np.add.at(inc, (g_e, local_c, col), 1.0)

    var_mask = np.zeros((G, Vg), np.float32)
    clause_mask = np.zeros((G, Cg), np.float32)
    sol = np.zeros((G, Vg), np.int32)
    flat_sol = _np(b.solutions)
    flat_sol_k = None if b.solutions_k is None else _np(b.solutions_k)
    sol_k = None if flat_sol_k is None else \
        np.zeros((flat_sol_k.shape[0], G, Vg), np.int32)
    iso_k = None
    if b.label_isolation_k is not None:
        flat_iso = _np(b.label_isolation_k)
        iso_k = np.zeros((flat_iso.shape[0], G), np.float32)
        iso_k[:, :nb_graphs] = flat_iso[:, :nb_graphs]
    for g in range(nb_graphs):
        var_mask[g, :nv[g]] = 1.0
        clause_mask[g, :nc[g]] = 1.0
        sol[g, :nv[g]] = flat_sol[v_off[g]:v_off[g + 1]]
        if sol_k is not None:
            sol_k[:, g, :nv[g]] = flat_sol_k[:, v_off[g]:v_off[g + 1]]

    graph_mask = np.zeros(G, np.float32)
    graph_mask[:nb_graphs] = 1.0
    nvg = np.zeros(G, np.float32)
    nvg[:nb_graphs] = nv
    ncg = np.zeros(G, np.float32)
    ncg[:nb_graphs] = nc

    t = torch.from_numpy
    return DenseSatBatch(
        incidence=t(inc), var_mask=t(var_mask), clause_mask=t(clause_mask),
        graph_mask=t(graph_mask), n_vars_per_graph=t(nvg),
        n_clauses_per_graph=t(ncg), solutions=t(sol),
        n_vars=torch.tensor(int(nv.sum()), dtype=torch.int32),
        n_clauses=torch.tensor(int(nc.sum()), dtype=torch.int32),
        n_graphs=torch.tensor(nb_graphs, dtype=torch.int32),
        solutions_k=None if sol_k is None else t(sol_k),
        label_isolation_k=None if iso_k is None else t(iso_k))


def densify_batches(batches, pad_graphs: int = 4, pad_nodes: int = 8
                    ) -> list[DenseSatBatch]:
    """Convert a list of flat batches to dense blocks with shared static
    dims."""
    G, Vg, Cg = dense_dims_for(batches, pad_graphs, pad_nodes)
    return [dense_from_flat(b, G, Vg, Cg) for b in batches]


# quantization levels for per-batch dense dims: (Vg, Cg) pairs sized for
# threshold 3-SAT (m ~ 4.3n)
_DIM_LEVELS = ((8, 48), (12, 64), (16, 80), (20, 96), (24, 112),
               (28, 128), (32, 144), (48, 224), (64, 288), (96, 448),
               (128, 576))

# finer grid (step-2 vars, clause dim snapped to the threshold ratio
# 4.258n + 58.26 n^(-2/3) rounded up to 8); the default. The environment
# variable DSAT_FINE_BLOCKS=0 selects the coarse table.
_FINE_DIM_LEVELS = tuple(
    (v, int(-(-(4.258 * v + 58.26 * v ** (-2.0 / 3.0)) // 8) * 8))
    for v in range(6, 33, 2)) + ((48, 224), (64, 288), (96, 448),
                                 (128, 576))


def densify_batches_quantized(batches, g_quantum: int | None = None
                              ) -> list[DenseSatBatch]:
    """Per-batch dense dims snapped to a small set of quantized levels.

    The packer sorts instances by size (data/packing.py), so batches are
    size-homogeneous: batches of tiny graphs get small blocks instead of
    paying the global maximum's padding. The graph dim is rounded up to
    `g_quantum` per batch.
    """
    fine = os.environ.get("DSAT_FINE_BLOCKS", "1") == "1"
    table = _FINE_DIM_LEVELS if fine else _DIM_LEVELS
    if g_quantum is None:
        g_quantum = 16 if fine else 32

    def level_for(maxv: int, maxc: int) -> tuple[int, int]:
        for vg, cg in table:
            if maxv <= vg and maxc <= cg:
                return vg, cg
        # beyond the table the dense incidence would be O(Vg*Cg) per graph;
        # refuse so callers take the flat edge-list path
        raise ValueError(
            f"graph with {maxv} vars / {maxc} clauses exceeds the dense "
            f"block levels (max {table[-1]}); use the flat layout")

    out = []
    for b in batches:
        ng = int(b.n_graphs)
        maxv = int(np.max(_np(b.n_vars_per_graph), initial=1))
        maxc = int(np.max(_np(b.n_clauses_per_graph), initial=1))
        lv = level_for(maxv, maxc)
        out.append(dense_from_flat(b, _round_up(ng, g_quantum),
                                   lv[0], lv[1]))
    return out

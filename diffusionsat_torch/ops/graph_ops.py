"""Sparse graph aggregation ops over a SatBatch, in plain PyTorch.

Counterparts of the TPU package's `ops/graph_ops.py`, which that package
leaves to XLA (gather, mask, sorted segment sum); here they are
`index_select` and `index_add_`. The planned SpMM pair that runs on the
hand-written kernel is `ops/segsum.py`.
"""

from __future__ import annotations

import torch

from diffusionsat_torch.graph.batch import SatBatch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = sum of the rows of `data` whose segment id is s."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids, data)


def lit_to_clause(batch: SatBatch, lit_features: torch.Tensor
                  ) -> torch.Tensor:
    """out[c] = sum_{lit in c} x[lit]: [2V, F] -> [C, F]."""
    gathered = lit_features.index_select(0, batch.edge_lit_c)
    gathered = gathered * batch.edge_mask_c[:, None]
    return segment_sum(gathered, batch.edge_clause_c, batch.C)


def clause_to_lit(batch: SatBatch, clause_features: torch.Tensor
                  ) -> torch.Tensor:
    """out[lit] = sum_{c containing lit} x[c]: [C, F] -> [2V, F]."""
    gathered = clause_features.index_select(0, batch.edge_clause_l)
    gathered = gathered * batch.edge_mask_l[:, None]
    return segment_sum(gathered, batch.edge_lit_l, 2 * batch.V)


def literal_degrees(batch: SatBatch) -> torch.Tensor:
    """[2V, 1] count of clauses each literal appears in."""
    deg = segment_sum(batch.edge_mask_l, batch.edge_lit_l, 2 * batch.V)
    return deg[:, None]


def clause_degrees(batch: SatBatch) -> torch.Tensor:
    """[C, 1] literal count of each clause."""
    deg = segment_sum(batch.edge_mask_c, batch.edge_clause_c, batch.C)
    return deg[:, None]


def var_segment_sum(batch: SatBatch, var_features: torch.Tensor
                    ) -> torch.Tensor:
    """Per-graph sum over variables: [V, F] -> [G, F]. Padded variables land
    in the dummy segment G and are dropped."""
    out = segment_sum(var_features, batch.var_graph, batch.G + 1)
    return out[:batch.G]


def clause_segment_sum(batch: SatBatch, clause_features: torch.Tensor
                       ) -> torch.Tensor:
    """Per-graph sum over clauses: [C, F] -> [G, F]."""
    out = segment_sum(clause_features, batch.clause_graph, batch.G + 1)
    return out[:batch.G]


def _gather_graph(graph_features: torch.Tensor, ids: torch.Tensor
                  ) -> torch.Tensor:
    padded = torch.cat([graph_features,
                        torch.zeros_like(graph_features[:1])], dim=0)
    return padded.index_select(0, ids)


def graph_gather_vars(batch: SatBatch, graph_features: torch.Tensor
                      ) -> torch.Tensor:
    """Broadcast per-graph features back to variables: [G, F] -> [V, F]
    (padding variables get 0)."""
    return _gather_graph(graph_features, batch.var_graph)


def graph_gather_clauses(batch: SatBatch, graph_features: torch.Tensor
                         ) -> torch.Tensor:
    """Broadcast per-graph features back to clauses: [G, F] -> [C, F]."""
    return _gather_graph(graph_features, batch.clause_graph)

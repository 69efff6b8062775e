"""Sparse graph aggregation ops over a SatBatch, in plain PyTorch.

Counterparts of the TPU package's `ops/graph_ops.py`, which that package
leaves to XLA (gather, mask, sorted segment sum). Here every sum takes one
fixed order, on the CPU and on the card, run after run (no atomics), so
two runs of a step agree bit for bit and a CUDA graph of it equals the
eager step:

- `segment_sum` over sorted segment ids: each segment's rows in row order
  (`torch.segment_reduce`, which on the CPU equals `index_add_` bit for
  bit). On the card one thread of `segment_reduce` walks a whole segment,
  which is slow for the per-graph sums of the pair norms and losses (a
  hundred segments of a hundred rows), so there the rows are summed in
  blocks of `BLOCK_ROWS` first (a block never crosses a segment's bound),
  then the blocks of each segment. Its backward is the gather of the
  cotangent.
- `gather_rows`, `index_select` whose backward sums each source row's
  cotangents in a fixed order (a stable sort of the indices, then
  `segment_sum`) instead of `index_add_`'s atomics.

The planned SpMM pair that runs on the hand-written kernel is
`ops/segsum.py`.

Clause-sharded execution (`parallel/graph_partition.py`, `halo.py`): with
a process `group` the batch holds one shard's clauses and the literal side
whole, so the literal and per-graph sums over clauses are partial on each
rank. `clause_to_lit`, `literal_degrees` and `clause_segment_sum` then
complete them over the group where the TPU package puts its `psum`, or,
given a halo view, exchange only the literal rows the shards share
(`complete_literals`).
"""

from __future__ import annotations

import torch

from diffusionsat_torch.graph.batch import SatBatch
from diffusionsat_torch.parallel.comm import all_reduce_sum

# rows a thread sums in the first pass of a segment sum on the card
BLOCK_ROWS = 16


def _sorted_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, blocked: bool | None = None
                ) -> torch.Tensor:
    """The segment sum; `blocked` (by default on the card) sums blocks of
    rows first."""
    dev = segment_ids.device
    bounds = torch.arange(num_segments + 1, dtype=segment_ids.dtype,
                          device=dev)
    offsets = torch.searchsorted(segment_ids, bounds)
    if not (data.is_cuda if blocked is None else blocked):
        return torch.segment_reduce(data, "sum", offsets=offsets, axis=0,
                                    unsafe=True)
    # blocks: every segment start and every BLOCK_ROWS-th row start one
    rows = data.shape[0]
    starts = torch.sort(torch.cat([offsets[:-1], torch.arange(
        0, rows, BLOCK_ROWS, dtype=offsets.dtype, device=dev)])).values
    partial = torch.segment_reduce(
        data, "sum", offsets=torch.cat([starts, offsets.new_full(
            (1,), rows)]), axis=0, unsafe=True)
    return torch.segment_reduce(partial, "sum",
                                offsets=torch.searchsorted(starts, offsets),
                                axis=0, unsafe=True)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        return _sorted_sum(data, segment_ids, num_segments)

    @staticmethod
    def backward(ctx, grad):
        segment_ids, = ctx.saved_tensors
        return grad.index_select(0, segment_ids), None, None


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = sum of the rows of `data` whose segment id is s.

    The ids must be sorted ascending, as every batch's are (padding points
    at the last segment): each segment's rows are then contiguous."""
    return _SegmentSum.apply(data, segment_ids, num_segments)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index):
        ctx.save_for_backward(index)
        ctx.rows = x.shape[0]
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        index, = ctx.saved_tensors
        order = torch.argsort(index, stable=True)
        return segment_sum(grad.index_select(0, order),
                           index.index_select(0, order), ctx.rows), None


def gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x[index] along the rows, its backward summed in a fixed order (on
    the CPU the order of `index_select`'s own backward)."""
    return _GatherRows.apply(x, index)


def lit_to_clause(batch: SatBatch, lit_features: torch.Tensor
                  ) -> torch.Tensor:
    """out[c] = sum_{lit in c} x[lit]: [2V, F] -> [C, F]."""
    gathered = gather_rows(lit_features, batch.edge_lit_c)
    gathered = gathered * batch.edge_mask_c[:, None]
    return segment_sum(gathered, batch.edge_clause_c, batch.C)


def complete_literals(partial: torch.Tensor, group=None,
                      halo=None) -> torch.Tensor:
    """A clause shard's partial literal aggregate [2V, F] completed over
    `group`: summed whole on every rank, or, with a halo view
    (parallel/halo.HaloView), summed on the rows this shard shares with
    others (the rows outside its closure stay partial). Without a group it
    is returned as it is."""
    if group is None:
        return partial
    if halo is not None:
        return halo.exchange(partial, group)
    return all_reduce_sum(partial, group)


def clause_to_lit(batch: SatBatch, clause_features: torch.Tensor,
                  group=None, halo=None) -> torch.Tensor:
    """out[lit] = sum_{c containing lit} x[c]: [C, F] -> [2V, F];
    completed over `group` (`complete_literals`) for a clause shard."""
    gathered = gather_rows(clause_features, batch.edge_clause_l)
    gathered = gathered * batch.edge_mask_l[:, None]
    return complete_literals(
        segment_sum(gathered, batch.edge_lit_l, 2 * batch.V), group, halo)


def literal_degrees(batch: SatBatch, group=None) -> torch.Tensor:
    """[2V, 1] count of clauses each literal appears in (summed over
    `group` for a clause shard)."""
    deg = segment_sum(batch.edge_mask_l, batch.edge_lit_l, 2 * batch.V)
    if group is not None:
        deg = all_reduce_sum(deg, group)
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


def clause_segment_sum(batch: SatBatch, clause_features: torch.Tensor,
                       group=None) -> torch.Tensor:
    """Per-graph sum over clauses: [C, F] -> [G, F] (summed over `group`
    for a clause shard)."""
    out = segment_sum(clause_features, batch.clause_graph, batch.G + 1)
    if group is not None:
        out = all_reduce_sum(out, group)
    return out[:batch.G]


def _gather_graph(graph_features: torch.Tensor, ids: torch.Tensor
                  ) -> torch.Tensor:
    padded = torch.cat([graph_features,
                        torch.zeros_like(graph_features[:1])], dim=0)
    return gather_rows(padded, ids)


def graph_gather_vars(batch: SatBatch, graph_features: torch.Tensor
                      ) -> torch.Tensor:
    """Broadcast per-graph features back to variables: [G, F] -> [V, F]
    (padding variables get 0)."""
    return _gather_graph(graph_features, batch.var_graph)


def graph_gather_clauses(batch: SatBatch, graph_features: torch.Tensor
                         ) -> torch.Tensor:
    """Broadcast per-graph features back to clauses: [G, F] -> [C, F]."""
    return _gather_graph(graph_features, batch.clause_graph)

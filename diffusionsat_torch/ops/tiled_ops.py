"""Block-sparse tiled incidence SpMM: the flat aggregations as batched
products over the non-empty tiles of the incidence.

Counterpart of the TPU package's `ops/tiled_ops.py`, which runs there as a
batched matrix product plus a tile-level segment sum, both left to its
compiler (no Pallas kernel). Here they are torch ops: `torch.bmm` over the
tile list and a sum of the tile products into their row (or column)
blocks over offsets built with the tiles (`torch.segment_reduce`), the
gathers' backwards summed the same way: no atomics, one fixed order, so
two runs agree bit for bit on the card. A big sparse incidence (CNF
clause x literal, ANF clause x value node) is cut into [tc, tl] blocks,
and only the blocks that hold an edge are kept.

- `build_tiled_from_edges` / `build_tiled_incidence` / `build_anf_tiles`:
  host-side (numpy) tile builds, returning CPU tensors. The real tiles are
  the TPU package's, bit for bit. Its padding tiles (all-zero blocks that
  round the tile count up to `pad_tiles`) point at row block 0 after the
  ascending real tiles, so `row_blk` is unsorted there although that
  package tells its segment sum it is sorted. Here they point at the last
  row block, so `row_blk` stays sorted; a zero block adds nothing wherever
  it points. The offsets of each row block's tiles, the tiles in column
  order (a stable sort) and the offsets of each column block's are built
  with the tiles, once, for the block sums.
- `tiled_lit_to_clause` / `tiled_clause_to_lit`: the pair, differentiable
  through autograd (the backward of each is the other's arithmetic).

`TILE_PRECISION` picks the operands of the tile products, as the TPU
package's `TILE_PRECISION` does (its default is bf16 operands with f32
accumulation):

- "default": bf16 operands with f32 accumulation (`ops/lowp.py`). The
  blocks hold small integer edge multiplicities, exact in bf16; the
  features round to 8 mantissa bits.
- "highest": full f32 (TF32 stays off on the card).

A call may pass `precision=` to override the module setting; the ANF value
sums pass "highest", since they feed exp and cos.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from diffusionsat_torch.ops.lowp import bmm_f32acc

TILE_PRECISION = "default"
PRECISIONS = ("highest", "default")


@contextlib.contextmanager
def tile_precision(mode: str):
    """`TILE_PRECISION` set to `mode` inside the block and put back to what
    it was on the way out."""
    global TILE_PRECISION
    if mode not in PRECISIONS:
        raise ValueError(f"TILE_PRECISION must be one of {PRECISIONS}, "
                         f"got {mode!r}")
    before, TILE_PRECISION = TILE_PRECISION, mode
    try:
        yield
    finally:
        TILE_PRECISION = before


@dataclasses.dataclass
class TiledIncidence:
    """Non-empty [tc, tl] tiles of one batch's row x column incidence (rows:
    clauses; columns: literals of a CNF batch, value nodes of an ANF
    batch)."""
    blocks: torch.Tensor   # [T, tc, tl] f32 edge multiplicities
    row_blk: torch.Tensor  # [T] int32 row-block index, sorted ascending
    col_blk: torch.Tensor  # [T] int32 column-block index
    row_offsets: torch.Tensor  # [n_row_blocks + 1] int64 tile offsets
    col_perm: torch.Tensor     # [T] int64 tiles in stable col_blk order
    col_offsets: torch.Tensor  # [n_col_blocks + 1] int64, into col_perm
    tc: int
    tl: int
    n_row_blocks: int
    n_col_blocks: int
    num_clauses: int       # rows: the batch's padded C
    num_literals: int      # columns: 2V (CNF) or 1 + V + A (ANF)
    n_real_tiles: int      # tiles that hold an edge; the rest are padding

    @property
    def n_tiles(self) -> int:
        return self.blocks.shape[0]

    def to(self, device: str | torch.device) -> "TiledIncidence":
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in (
                "blocks", "row_blk", "col_blk", "row_offsets", "col_perm",
                "col_offsets")})


def tile_orders(row_blk: np.ndarray, col_blk: np.ndarray, n_row_blocks: int,
                n_col_blocks: int) -> dict[str, torch.Tensor]:
    """The block sums' orders of a tile list whose `row_blk` is sorted: the
    offsets of each row block's tiles, the tiles sorted by column block
    (stable) and the offsets of each column block's tiles in that order."""
    col_perm = np.argsort(col_blk, kind="stable")
    return dict(
        row_offsets=torch.from_numpy(np.searchsorted(
            row_blk, np.arange(n_row_blocks + 1)).astype(np.int64)),
        col_perm=torch.from_numpy(col_perm.astype(np.int64)),
        col_offsets=torch.from_numpy(np.searchsorted(
            col_blk[col_perm], np.arange(n_col_blocks + 1)).astype(
                np.int64)))


def build_tiled_from_edges(rows, cols, n_rows: int, n_cols: int,
                           tc: int = 128, tl: int = 128,
                           pad_tiles: int = 64) -> TiledIncidence:
    """Tile a (row, col) incidence edge list (already masked; duplicate
    edges accumulate). Only tiles holding at least one edge are kept; the
    tile count is rounded up to a multiple of `pad_tiles` with zero blocks
    at the last row block."""
    r = np.asarray(rows).astype(np.int64)
    c = np.asarray(cols).astype(np.int64)
    n_rows, n_cols = int(n_rows), int(n_cols)
    n_rb = -(-n_rows // tc)
    n_cb = -(-n_cols // tl)

    tile_id = (r // tc) * n_cb + c // tl
    order = np.argsort(tile_id, kind="stable")
    tile_id, r, c = tile_id[order], r[order], c[order]
    uniq = np.unique(tile_id)
    T = len(uniq)
    Tp = max(-(-T // pad_tiles) * pad_tiles, pad_tiles)

    blocks = np.zeros((Tp, tc, tl), np.float32)
    # edge -> (tile, local row, local col); repeated edges accumulate, as
    # the flat segment sums count them
    np.add.at(blocks, (np.searchsorted(uniq, tile_id), r % tc, c % tl), 1.0)

    row_blk = np.full(Tp, max(n_rb - 1, 0), np.int32)
    col_blk = np.zeros(Tp, np.int32)
    row_blk[:T] = (uniq // n_cb).astype(np.int32)
    col_blk[:T] = (uniq % n_cb).astype(np.int32)
    return TiledIncidence(
        blocks=torch.from_numpy(blocks), row_blk=torch.from_numpy(row_blk),
        col_blk=torch.from_numpy(col_blk),
        **tile_orders(row_blk, col_blk, n_rb, n_cb), tc=tc, tl=tl,
        n_row_blocks=n_rb,
        n_col_blocks=n_cb, num_clauses=n_rows, num_literals=n_cols,
        n_real_tiles=T)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def build_tiled_incidence(batch, tc: int = 128, tl: int = 128,
                          pad_tiles: int = 64) -> TiledIncidence:
    """Tiles of a SatBatch's clause x literal incidence (host side)."""
    em = _np(batch.edge_mask_c) > 0
    return build_tiled_from_edges(
        _np(batch.edge_clause_c)[em], _np(batch.edge_lit_c)[em],
        batch.C, 2 * batch.V, tc=tc, tl=tl, pad_tiles=pad_tiles)


def build_anf_tiles(batch, tc: int = 128, tl: int = 128,
                    pad_tiles: int = 64) -> TiledIncidence:
    """Tiles of an ANFBatch's clause x value-node membership incidence (rows
    = clauses, columns = the 1 + V + A value nodes). They serve both
    directions of the ANF model's membership sums and the value sums of
    `anf_value_cplx`."""
    em = _np(batch.edge_mask_c) > 0
    return build_tiled_from_edges(
        _np(batch.edge_clause_c)[em], _np(batch.edge_node_c)[em],
        batch.C, batch.n_value_nodes, tc=tc, tl=tl, pad_tiles=pad_tiles)


def _tile_product(blocks: torch.Tensor, g: torch.Tensor, transpose: bool,
                  precision: str | None) -> torch.Tensor:
    mode = precision or TILE_PRECISION
    if mode not in PRECISIONS:
        raise ValueError(f"tile precision must be one of {PRECISIONS}, "
                         f"got {mode!r}")
    a = blocks.transpose(1, 2) if transpose else blocks
    if mode == "default":
        return bmm_f32acc(a.to(torch.bfloat16), g.to(torch.bfloat16))
    return torch.bmm(a, g.float())


class _BlockSum(torch.autograd.Function):
    """out[b] = the sum of the rows of `data` (one a tile) whose block id
    `ids` is b, in the order `order` lists them (tile order when None),
    over the block offsets `offsets` into that order: one fixed order.
    Its backward hands each tile its block's cotangent (`_BlockGather`)."""

    @staticmethod
    def forward(ctx, data, ids, order, offsets):
        ctx.save_for_backward(ids, order, offsets)
        rows = data if order is None else data.index_select(0, order)
        return torch.segment_reduce(rows, "sum", offsets=offsets, axis=0,
                                    unsafe=True)

    @staticmethod
    def backward(ctx, grad):
        ids, order, offsets = ctx.saved_tensors
        return _BlockGather.apply(grad, ids, order, offsets), None, None, \
            None


class _BlockGather(torch.autograd.Function):
    """xb[ids]: each tile's block row; its backward sums each block's tile
    cotangents in the fixed order of `_BlockSum`."""

    @staticmethod
    def forward(ctx, xb, ids, order, offsets):
        ctx.save_for_backward(ids, order, offsets)
        return xb.index_select(0, ids)

    @staticmethod
    def backward(ctx, grad):
        ids, order, offsets = ctx.saved_tensors
        return _BlockSum.apply(grad, ids, order, offsets), None, None, None


def tiled_lit_to_clause(x: torch.Tensor, ti: TiledIncidence,
                        precision: str | None = None) -> torch.Tensor:
    """[num_literals, F] column features -> [num_clauses, F] row sums via
    the tile products."""
    Fd = x.shape[1]
    pad = ti.n_col_blocks * ti.tl - x.shape[0]
    xb = F.pad(x, (0, 0, 0, pad)).reshape(ti.n_col_blocks, ti.tl * Fd)
    g = _BlockGather.apply(xb, ti.col_blk, ti.col_perm, ti.col_offsets)
    prod = _tile_product(ti.blocks, g.reshape(-1, ti.tl, Fd), False,
                         precision)                          # [T, tc, F]
    out = _BlockSum.apply(prod.reshape(-1, ti.tc * Fd), ti.row_blk, None,
                          ti.row_offsets)
    return out.reshape(ti.n_row_blocks * ti.tc, Fd)[:ti.num_clauses]


def tiled_clause_to_lit(y: torch.Tensor, ti: TiledIncidence,
                        precision: str | None = None) -> torch.Tensor:
    """[num_clauses, F] row features -> [num_literals, F] column sums (the
    transpose SpMM)."""
    Fd = y.shape[1]
    pad = ti.n_row_blocks * ti.tc - y.shape[0]
    yb = F.pad(y, (0, 0, 0, pad)).reshape(ti.n_row_blocks, ti.tc * Fd)
    g = _BlockGather.apply(yb, ti.row_blk, None, ti.row_offsets)
    prod = _tile_product(ti.blocks, g.reshape(-1, ti.tc, Fd), True,
                         precision)                          # [T, tl, F]
    out = _BlockSum.apply(prod.reshape(-1, ti.tl * Fd), ti.col_blk,
                          ti.col_perm, ti.col_offsets)
    return out.reshape(ti.n_col_blocks * ti.tl, Fd)[:ti.num_literals]

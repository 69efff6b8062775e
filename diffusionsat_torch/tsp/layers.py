"""Dense-matrix TSP layers: DenseGNN and MatrixSE (a 2-D Benes network).

Counterpart of the TPU package's `tsp/layers.py`, over explicit parameter
dicts: the full-graph GNN step over a [B, N, N, F] edge tensor with a
ReZero residual, and Matrix Shuffle-Exchange (Z-order flatten, Benes
blocks of quaternary switch units with shared weights, quaternary
shuffles between the switch layers). Every MLP normalizes over the two
node axes, padded positions included, as the TPU package's does. The
switch unit's GELU is the tanh approximation, the TPU package's.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from diffusionsat_torch.nn.mlp import MLPConfig, mlp_apply, mlp_init
from diffusionsat_torch.nn.normalization import layer_norm


def _inv_sigmoid(y: float) -> float:
    return math.log(y / (1 - y))


def _uniform(generator: torch.Generator, shape, limit: float
             ) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (2 * limit) - limit


# ---------------------------------------------------------------------------
# DenseGNN


def _gnn_cfgs(feature_maps: int) -> tuple[MLPConfig, MLPConfig]:
    h = feature_maps * 2
    return (MLPConfig(3, h, feature_maps, do_layer_norm=True,
                      norm_axis=(1, 2)),
            MLPConfig(3, h * 2, feature_maps, do_layer_norm=True,
                      norm_axis=(1, 2)))


def dense_gnn_init(generator: torch.Generator, feature_maps: int) -> dict:
    in_cfg, edge_cfg = _gnn_cfgs(feature_maps)
    dev = generator.device
    return {
        "incoming_edge_mlp": mlp_init(generator, in_cfg, feature_maps),
        "outgoing_edge_mlp": mlp_init(generator, in_cfg, feature_maps),
        "edge_mlp": mlp_init(generator, edge_cfg, feature_maps * 5),
        "prev_weight": torch.full((feature_maps,), _inv_sigmoid(0.5),
                                  device=dev),
        "candidate_weight": torch.zeros((feature_maps,), device=dev),
    }


def dense_gnn_apply(params: dict, x: torch.Tensor, mask: torch.Tensor,
                    feature_maps: int) -> torch.Tensor:
    """x: [B, N, N, F]; mask: [B, N, N] (1 = real edge)."""
    b, n = x.shape[0], x.shape[1]
    sqrt_n = math.sqrt(n)
    m = mask[..., None]
    in_cfg, edge_cfg = _gnn_cfgs(feature_maps)

    incoming = mlp_apply(params["incoming_edge_mlp"], in_cfg, x * m)
    outgoing = mlp_apply(params["outgoing_edge_mlp"], in_cfg, x * m)
    incoming_state = torch.sum(incoming * m, dim=1) / sqrt_n  # [B, N, F]
    outgoing_state = torch.sum(outgoing * m, dim=2) / sqrt_n
    vertex_state = torch.cat([incoming_state, outgoing_state], dim=-1)

    f2 = vertex_state.shape[-1]
    tile_in = vertex_state[:, None, :, :].expand(b, n, n, f2)
    tile_out = vertex_state[:, :, None, :].expand(b, n, n, f2)
    edge_unit = torch.cat([x, tile_in, tile_out], dim=-1)
    candidate = mlp_apply(params["edge_mlp"], edge_cfg, edge_unit)

    return x * torch.sigmoid(params["prev_weight"]) + \
        candidate * params["candidate_weight"]


# ---------------------------------------------------------------------------
# MatrixSE: Z-order + quaternary shuffles (host index builders)


def _z_order_indices(n: int) -> np.ndarray:
    """Z-order-curve readout of an n x n index matrix."""
    def rec(x, y, length):
        if length == 1:
            return [x * n + y]
        mid = length // 2
        return (rec(x, y, mid) + rec(x, y + mid, mid) +
                rec(x + mid, y, mid) + rec(x + mid, y + mid, mid))
    return np.asarray(rec(0, 0, n), dtype=np.int32)


def _quaternary_digits(max_value: int) -> int:
    return max(1, math.ceil(math.log(max_value + 1, 4)))


def _qrol(x: int, digits: int, level: int) -> int:
    """Quaternary cyclic left shift of the digit string (`level` unused,
    as in the TPU package)."""
    mask = (1 << (2 * digits)) - 1
    top = (x >> (2 * (digits - 1))) & 3
    return ((x << 2) & mask) | top


def _qror(x: int, digits: int, level: int) -> int:
    low = x & 3
    return (x >> 2) | (low << (2 * (digits - 1)))


def _shuffle_indices(length: int, left: bool) -> np.ndarray:
    digits = _quaternary_digits(length - 1)
    fn = _qrol if left else _qror
    return np.asarray([fn(i, digits, 0) for i in range(length)],
                      dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _device_indices(kind: str, size: int, device: str) -> torch.Tensor:
    """An index vector built once per (kind, size, device): the shuffles
    of a length-`size` sequence ("forward", "reverse"), or the Z-order of
    a `size` x `size` matrix and its inverse ("z", "z_inv")."""
    if kind == "forward":
        idx = _shuffle_indices(size, left=False)
    elif kind == "reverse":
        idx = _shuffle_indices(size, left=True)
    else:
        z = _z_order_indices(size)
        idx = z
        if kind == "z_inv":
            idx = np.empty(size * size, dtype=np.int32)
            idx[z] = np.arange(size * size)
    return torch.from_numpy(idx.astype(np.int64)).to(device)


def switch_unit_init(generator: torch.Generator, num_units: int,
                     channel_count: int = 4) -> dict:
    reshaped = num_units * channel_count
    dev = generator.device
    residual_weight = 0.9
    scale_init = math.log(residual_weight / (1 - residual_weight))
    limit1 = math.sqrt(6.0 / (reshaped + reshaped * 2))
    limit2 = math.sqrt(6.0 / (reshaped * 2 + reshaped))
    return {
        "residual_scale": torch.full((reshaped,), scale_init, device=dev),
        "linear_one": _uniform(generator, (reshaped, reshaped * 2), limit1),
        "linear_two_w": _uniform(generator, (reshaped * 2, reshaped),
                                 limit2),
        "linear_two_b": torch.zeros((reshaped,), device=dev),
        "norm_bias": torch.zeros((reshaped * 2,), device=dev),
    }


def switch_unit_apply(params: dict, x: torch.Tensor, channel_count: int = 4
                      ) -> torch.Tensor:
    """Quaternary switch unit. x: [B, L, U] -> groups of 4 positions
    processed jointly."""
    b, length, units = x.shape
    reshaped = units * channel_count
    candidate_weight = math.sqrt(1 - 0.9 ** 2) * 0.25
    h = x.reshape(b, length // channel_count, reshaped)
    first = h @ params["linear_one"]
    norm = layer_norm(first, axis=-1, subtract_mean=True,
                      bias=params["norm_bias"])
    gelu = F.gelu(norm, approximate="tanh")
    second = gelu @ params["linear_two_w"] + params["linear_two_b"]
    residual_scale = torch.sigmoid(params["residual_scale"])
    out = residual_scale * h + second * candidate_weight
    return out.reshape(b, length, units)


def benes_block_init(generator: torch.Generator, num_units: int) -> dict:
    return {
        "forward": switch_unit_init(generator, num_units),
        "reverse": switch_unit_init(generator, num_units),
        "middle": switch_unit_init(generator, num_units),
    }


def benes_block_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Benes block: floor(log2(L - 1)) forward-shuffled and as many
    reverse-shuffled switch layers with shared weights, then the middle
    unit."""
    length = x.shape[1]
    level_count = int(math.floor(math.log2(length - 1)))
    dev = str(x.device)
    fwd_idx = _device_indices("forward", length, dev)
    rev_idx = _device_indices("reverse", length, dev)
    h = x
    for _ in range(level_count):
        h = switch_unit_apply(params["forward"], h)
        h = h.index_select(1, fwd_idx)
    for _ in range(level_count):
        h = switch_unit_apply(params["reverse"], h)
        h = h.index_select(1, rev_idx)
    return switch_unit_apply(params["middle"], h)


def matrix_se_init(generator: torch.Generator, num_units: int,
                   block_count: int = 1) -> dict:
    return {"blocks": [benes_block_init(generator, num_units)
                       for _ in range(block_count)]}


def matrix_se_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [B, N, N, F] with N a power of 2 (N * N a power of 4)."""
    b, n, _, f = x.shape
    if n < 2 or n & (n - 1):
        raise ValueError(f"MatrixSE needs a power-of-2 node count, got {n}")
    dev = str(x.device)
    h = x.reshape(b, n * n, f)
    h = h.index_select(1, _device_indices("z", n, dev))
    for block in params["blocks"]:
        h = benes_block_apply(block, h)
    h = h.index_select(1, _device_indices("z_inv", n, dev))
    return h.reshape(b, n, n, f)

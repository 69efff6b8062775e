"""TSPMatrixSE: the dense-matrix TSP model (DenseGNN or MatrixSE core).

Counterpart of the TPU package's `tsp/model.py`: the normalized distance
matrix in, a recurrent graph layer, per-edge logits with a 1/(n-1) prior
bias, and the unsupervised (or supervised CE) tour loss summed over the
rounds. Eager PyTorch: the unsupervised loss calls the host subtour finder
once a round, which no CUDA graph can capture.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.nn.mlp import MLPConfig, mlp_apply, mlp_init
from diffusionsat_torch.tsp import PADDING_VALUE
from diffusionsat_torch.tsp.layers import (
    dense_gnn_apply,
    dense_gnn_init,
    matrix_se_apply,
    matrix_se_init,
)
from diffusionsat_torch.tsp.loss import inverse_identity, tsp_loss


@dataclasses.dataclass(frozen=True)
class TSPMatrixSEConfig:
    feature_maps: int = 64
    block_count: int = 1
    rounds: int = 16
    use_matrix_se: bool = False
    n_vertices_prior: int = 16
    supervised: bool = False

    def logits_cfg(self):
        return MLPConfig(2, self.feature_maps, 1, do_layer_norm=True,
                         norm_axis=(1, 2))


def tsp_matrix_se_init(generator: torch.Generator, cfg: TSPMatrixSEConfig
                       ) -> dict:
    """Random params on the generator's device."""
    dev = generator.device
    limit = math.sqrt(6.0 / (1 + cfg.feature_maps))
    u = torch.rand((1, cfg.feature_maps), generator=generator, device=dev)
    params = {
        "input_layer_w": u * (2 * limit) - limit,
        "input_layer_b": torch.zeros((cfg.feature_maps,), device=dev),
        "logits_layer": mlp_init(generator, cfg.logits_cfg(),
                                 cfg.feature_maps),
    }
    if cfg.use_matrix_se:
        params["graph_layer"] = matrix_se_init(generator, cfg.feature_maps,
                                               cfg.block_count)
    else:
        params["graph_layer"] = dense_gnn_init(generator, cfg.feature_maps)
    return params


def tsp_matrix_se_apply(params: dict, cfg: TSPMatrixSEConfig,
                        adj_matrix: torch.Tensor, labels: torch.Tensor,
                        generator: torch.Generator | None = None,
                        training: bool = True,
                        device: str | torch.device = "cuda"):
    """adj_matrix: [B, P, P] distances (PADDING_VALUE-padded); labels:
    [B, P, P] optimal-tour edges or PADDING_VALUE. Returns (logits
    [B, P, P, 1], total_loss, last_loss); the losses are 0.0 unless
    `training`. The inputs are moved to `device`; the caller's grad mode
    holds. `generator` is handed to the loss, which draws from it only when
    it adds noise (never at the model's settings)."""
    dev = resolve_device(device)
    adj_matrix = adj_matrix.to(dev)
    labels = labels.to(dev)
    p = adj_matrix.shape[1]
    mask = (labels != PADDING_VALUE).to(torch.float32) * \
        inverse_identity(p, dev)

    adj_sq = torch.mean(torch.square(adj_matrix * mask), dim=(1, 2),
                        keepdim=True)
    inputs_norm = adj_matrix * mask * torch.rsqrt(adj_sq + 1e-6)
    state = (inputs_norm[..., None] @ params["input_layer_w"] +
             params["input_layer_b"]) * 0.25

    logit_bias = math.log(1.0 / (cfg.n_vertices_prior - 1) /
                          (1 - 1.0 / (cfg.n_vertices_prior - 1)))

    total_loss = 0.0
    last_loss = 0.0
    logits = torch.zeros((adj_matrix.shape[0], p, p, 1), device=dev)
    for _ in range(cfg.rounds):
        if cfg.use_matrix_se:
            state = matrix_se_apply(params["graph_layer"], state)
        else:
            state = dense_gnn_apply(params["graph_layer"], state, mask,
                                    cfg.feature_maps)
        logits = mlp_apply(params["logits_layer"], cfg.logits_cfg(),
                           state) + logit_bias
        if training:
            loss = tsp_loss(logits, adj_matrix, labels=labels,
                            generator=generator,
                            supervised=cfg.supervised,
                            unsupervised=not cfg.supervised)
            total_loss = total_loss + loss
            last_loss = loss
    return logits, total_loss, last_loss

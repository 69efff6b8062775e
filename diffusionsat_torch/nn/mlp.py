"""MLP over explicit parameter dicts.

Counterpart of the TPU package's `nn/mlp.py`: a Dense stack with
leaky_relu (alpha 0.2) hidden activations and a linear output, params as
`{"w": [kernels], "b": [biases]}` with kernels in [in, out] layout, so
that one `.npz` file serves both packages. Initialization follows Keras
Dense defaults: glorot_uniform kernels, zero biases.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from diffusionsat_torch.ops.lowp import linear_f32acc


def leaky_gelu(x: torch.Tensor) -> torch.Tensor:
    sg = torch.sigmoid(1.702 * x)
    return x * (0.8 * sg + 0.2)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """tf.nn.leaky_relu default (alpha=0.2), the reference MLP activation."""
    return F.leaky_relu(x, negative_slope=0.2)


class MLPConfig(NamedTuple):
    layer_count: int
    hidden: int
    out: int
    activation: str = "leaky_relu"  # hidden activation
    out_activation: str | None = None
    init_zero: bool = False
    out_bias: float | None = None
    # LayerNorm (no-bias first Dense + norm + activation) after the first
    # hidden layer
    do_layer_norm: bool = False
    norm_axis: int = 0


_ACTS = {
    "leaky_relu": leaky_relu,
    "leaky_gelu": leaky_gelu,
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    None: lambda x: x,
}


def _glorot(generator: torch.Generator, fan_in: int, fan_out: int,
            device: torch.device) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand((fan_in, fan_out), generator=generator, device=device)
    return u * (2 * limit) - limit


def mlp_init(generator: torch.Generator, cfg: MLPConfig, in_dim: int
             ) -> dict:
    """Create {'w': [kernels...], 'b': [biases...]} for the Dense stack on
    the generator's device."""
    device = generator.device
    dims = [in_dim] + [cfg.hidden] * (cfg.layer_count - 1) + [cfg.out]
    ws, bs = [], []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        last = i == len(dims) - 2
        if last and cfg.init_zero:
            ws.append(torch.zeros((d_in, d_out), device=device))
        else:
            ws.append(_glorot(generator, d_in, d_out, device))
        bias_val = cfg.out_bias if (last and cfg.out_bias is not None) \
            else 0.0
        bs.append(torch.full((d_out,), bias_val, device=device))
    params = {"w": ws, "b": bs}
    if cfg.do_layer_norm and cfg.layer_count > 1:
        params["norm_bias"] = torch.zeros((cfg.hidden,), device=device)
    return params


def mlp_apply(params: dict, cfg: MLPConfig, x: torch.Tensor,
              compute_dtype=None) -> torch.Tensor:
    """Apply the Dense stack. With `compute_dtype` (e.g. torch.bfloat16) the
    operands of every product are cast down per call while accumulation and
    activations stay float32.

    The block-bf16 flow is another mode: a bf16 input (with bf16 params,
    cast once by the caller) runs bf16 products with f32 accumulation;
    hidden activations are written back as bf16 and the last layer's
    output stays f32 for the loss chain. Unlike `compute_dtype` it adds no
    per-call operand casts. The layer-norm path computes in f32.
    """
    from diffusionsat_torch.nn.normalization import layer_norm

    act = _ACTS[cfg.activation]
    out_act = _ACTS[cfg.out_activation]
    n = len(params["w"])
    bf_flow = compute_dtype is None and x.dtype == torch.bfloat16

    def dot(a, w):
        if compute_dtype is not None:
            a = a.to(compute_dtype)
            w = w.to(compute_dtype)
        if a.dtype == torch.float32 and w.dtype == torch.float32:
            return a @ w
        return linear_f32acc(a, w)

    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        last = i == n - 1
        if cfg.do_layer_norm and not last:
            # Dense (bias only for i>0) -> LayerNorm after the first hidden
            # layer -> activation
            x = dot(x, w)
            if i > 0:
                x = x + b
            if i == 0:
                x = layer_norm(x, axis=cfg.norm_axis, subtract_mean=True,
                               bias=params["norm_bias"])
            x = act(x)
        else:
            x = dot(x, w) + b
            x = out_act(x) if last else act(x)
            if bf_flow and not last:
                x = x.to(torch.bfloat16)
    return x

"""Minimal LSTM cell with Keras LSTMCell semantics.

Counterpart of the TPU package's `nn/lstm.py`, used by NeuroSAT's literal
and clause updates: glorot-uniform input kernel, orthogonal recurrent
kernel, zero bias with unit forget-gate bias, gate order i, f, c, o. Params
are `{"kernel": [in, 4h], "recurrent": [h, 4h], "bias": [4h]}`, the TPU
package's tree.
"""

from __future__ import annotations

import math

import torch


def _orthogonal(generator: torch.Generator, n: int, m: int) -> torch.Tensor:
    a = torch.randn((max(n, m), min(n, m)), generator=generator,
                    device=generator.device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return q[:n, :m] if n >= m else q[:m, :n].T


def lstm_init(generator: torch.Generator, in_dim: int, hidden: int) -> dict:
    """Random params on the generator's device."""
    limit = math.sqrt(6.0 / (in_dim + 4 * hidden))
    kernel = torch.rand((in_dim, 4 * hidden), generator=generator,
                        device=generator.device) * (2 * limit) - limit
    recurrent = _orthogonal(generator, hidden, 4 * hidden).contiguous()
    bias = torch.zeros(4 * hidden, device=generator.device)
    bias[hidden:2 * hidden] = 1.0                       # forget gate
    return {"kernel": kernel, "recurrent": recurrent, "bias": bias}


def lstm_apply(params: dict, x: torch.Tensor,
               state: tuple[torch.Tensor, torch.Tensor]
               ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """state = (h, c); returns (h_new, (h_new, c_new))."""
    h, c = state
    z = x @ params["kernel"] + h @ params["recurrent"] + params["bias"]
    hid = h.shape[-1]
    i = torch.sigmoid(z[..., :hid])
    f = torch.sigmoid(z[..., hid:2 * hid])
    g = torch.tanh(z[..., 2 * hid:3 * hid])
    o = torch.sigmoid(z[..., 3 * hid:])
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, (h_new, c_new)

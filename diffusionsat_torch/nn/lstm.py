"""Minimal LSTM cell with Keras LSTMCell semantics.

Counterpart of the TPU package's `nn/lstm.py`, used by NeuroSAT's literal
and clause updates: glorot-uniform input kernel, orthogonal recurrent
kernel, zero bias with unit forget-gate bias, gate order i, f, c, o. Params
are `{"kernel": [in, 4h], "recurrent": [h, 4h], "bias": [4h]}`, the TPU
package's tree.

Each cell is counted in the `lstm` family of `tracing.py`'s counters:
`cells`, one a forward call; and, where a CUDA graph is being captured,
`launches`: the nodes (kernels, memsets, copies) that the cell's forward
and its backward add to the graph, read from the graph itself
(`cuda_graphs.capture_nodes`), so each replay runs that many. The backward
is counted from autograd's entry into the cell's last op to its exit from
the first: autograd runs the ready node created last first, so a cell's
backward runs as one block. Eager calls and the CPU count no launches.
"""

from __future__ import annotations

import math

import torch

from diffusionsat_torch import cuda_graphs, tracing

FAMILY = "lstm"
COUNTS = tracing.family(FAMILY, ("cells", "launches"))


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
    COUNTS["cells"] += 1
    stream = cuda_graphs.capturing_stream(x.device)
    if stream is not None:
        nodes = cuda_graphs.capture_nodes(stream)
    xk = x @ params["kernel"]
    z = xk + h @ params["recurrent"] + params["bias"]
    hid = h.shape[-1]
    i = torch.sigmoid(z[..., :hid])
    f = torch.sigmoid(z[..., hid:2 * hid])
    g = torch.tanh(z[..., 2 * hid:3 * hid])
    o = torch.sigmoid(z[..., 3 * hid:])
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    if stream is not None:
        COUNTS["launches"] += cuda_graphs.capture_nodes(stream) - nodes
        if h_new.grad_fn is not None and xk.grad_fn is not None:
            _count_backward(stream, h_new.grad_fn, xk.grad_fn)
    return h_new, (h_new, c_new)


def _count_backward(stream: int, first, last) -> None:
    """Count into `launches` the graph nodes added from autograd's entry
    into `first` (the cell's last op) to its exit from `last` (its first)."""
    start = []

    def enter(grad_outputs):
        start.append(cuda_graphs.capture_nodes(stream))

    def leave(grad_inputs, grad_outputs):
        if start and start[-1] is not None:
            now = cuda_graphs.capture_nodes(stream)
            if now is not None:
                COUNTS["launches"] += now - start.pop()

    first.register_prehook(enter)
    last.register_hook(leave)

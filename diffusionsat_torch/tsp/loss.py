"""TSP losses: supervised edge CE and the unsupervised tour loss.

Counterpart of the TPU package's `tsp/loss.py`: in- and out-degree
penalties, the normalized tour length, and subtour-elimination cuts fed
back from the native finder as (cut id, flat edge index) pairs. The finder
runs on the host: each unsupervised loss copies the detached, normalized
predictions to the host once (a device sync), and sums the cut weights on
the device with the fixed-order gather and segment sum of
`ops/graph_ops.py`, so a step on the card repeats bit for bit.
`fast_inaccurate=True` replaces the cuts by a pairwise penalty and makes
no host call.
"""

from __future__ import annotations

import numpy as np
import torch

from diffusionsat_torch.ops.graph_ops import gather_rows, segment_sum
from diffusionsat_torch.tsp import PADDING_VALUE
from diffusionsat_torch.tsp.subtours import subtour_pairs


def inverse_identity(size: int, device: str | torch.device = "cpu"
                     ) -> torch.Tensor:
    return torch.ones((size, size), device=device) - \
        torch.eye(size, device=device)


def sample_logistic(generator: torch.Generator, shape, eps: float = 1e-20,
                    device: str | torch.device | None = None
                    ) -> torch.Tensor:
    """Standard logistic noise drawn from `generator` (on its device unless
    `device` is given)."""
    dev = generator.device if device is None else device
    u = torch.rand(shape, generator=generator, device=dev)
    u = eps + u * ((1 - eps) - eps)
    return torch.log(u / (1 - u))


def subtour_cost(preds: torch.Tensor, adjacency_matrix: torch.Tensor,
                 max_cut_pairs: int) -> torch.Tensor:
    """Sum over the violated cuts the host finder returns of
    (1 - the cut's predicted weight)^2, divided by the batch size."""
    b = preds.shape[0]
    pairs = subtour_pairs(preds, adjacency_matrix, max_cut_pairs)
    if len(pairs) == 0:
        return preds.new_zeros(())
    cut_ids = pairs[:, 0]
    n_cuts = int(cut_ids[-1]) + 1          # ids ascend from the finder
    dev = preds.device
    has_cut = torch.from_numpy(np.bincount(cut_ids, minlength=n_cuts) > 0
                               ).to(dev)
    cut = torch.from_numpy(np.ascontiguousarray(cut_ids)).to(dev)
    edge = torch.from_numpy(np.ascontiguousarray(pairs[:, 1])).to(dev)
    edge_vals = gather_rows(preds.reshape(-1, 1), edge)
    cut_weight = segment_sum(edge_vals, cut, n_cuts)[:, 0]
    return torch.sum(torch.where(has_cut, torch.square(1 - cut_weight),
                                 0.0)) / b


def tsp_unsupervised_loss(predictions: torch.Tensor,
                          adjacency_matrix: torch.Tensor,
                          generator: torch.Generator | None = None,
                          noise: float = 0.0,
                          fast_inaccurate: bool = False,
                          max_cut_pairs: int | None = None) -> torch.Tensor:
    """predictions: [B, P, P] logits; adjacency: [B, P, P] distances with
    PADDING_VALUE marking padding. Without `fast_inaccurate`, the cuts are
    those of the first `max_cut_pairs` pairs the finder emits (default
    16 B P), as in the TPU package."""
    b, p = predictions.shape[0], predictions.shape[1]
    dev = predictions.device
    inv = inverse_identity(p, dev)
    mask = (adjacency_matrix != PADDING_VALUE).to(torch.float32) * inv

    if noise > 0 and generator is not None:
        predictions = predictions + sample_logistic(
            generator, predictions.shape, device=dev) * noise
    preds = torch.sigmoid(predictions) * inv

    cost_incoming = torch.mean(torch.square(
        1 - torch.sum(preds * mask, dim=1)))
    cost_outgoing = torch.mean(torch.square(
        1 - torch.sum(preds * mask, dim=2)))
    preds = preds / (torch.sum(preds * mask, dim=1, keepdim=True) + 1e-6)
    preds = preds / (torch.sum(preds * mask, dim=2, keepdim=True) + 1e-6)

    if fast_inaccurate:
        sum_rev = preds + preds.transpose(1, 2)
        cost_subtours = torch.sum(torch.square(torch.relu(sum_rev - 1))) / b
    else:
        if max_cut_pairs is None:
            max_cut_pairs = 16 * b * p
        cost_subtours = subtour_cost(preds, adjacency_matrix, max_cut_pairs)

    adj_sq = torch.mean(torch.square(adjacency_matrix * mask), dim=(1, 2),
                        keepdim=True)
    adj_norm = adjacency_matrix * mask * torch.rsqrt(adj_sq + 1e-6)
    cost_length = torch.mean(preds * adj_norm * mask)

    return (cost_length * 5 + cost_incoming + cost_outgoing +
            cost_subtours * 0.05) / p


def tsp_supervised_loss(predictions: torch.Tensor, labels: torch.Tensor
                        ) -> torch.Tensor:
    """Per-edge sigmoid CE against the optimal-tour edge labels."""
    p = predictions.shape[1]
    mask = (labels != PADDING_VALUE).to(torch.float32) * \
        inverse_identity(p, predictions.device)
    logits = predictions
    lbl = torch.clamp(labels, 0.0, 1.0)
    ce = torch.relu(logits) - logits * lbl + \
        torch.log1p(torch.exp(-torch.abs(logits)))
    ce = ce * mask
    item_loss = torch.sum(ce, dim=(1, 2)) / torch.clamp(
        torch.sum(mask, dim=(1, 2)), min=1.0)
    return torch.mean(item_loss)


def tsp_loss(predictions, adjacency_matrix, labels=None, generator=None,
             noise=0.0, fast_inaccurate=False, supervised=False,
             unsupervised=True):
    """The combined loss. `predictions` may carry a trailing singleton
    feature axis."""
    if predictions.dim() == 4:
        predictions = predictions[..., 0]
    loss = 0.0
    if supervised:
        loss += tsp_supervised_loss(predictions, labels)
    if unsupervised:
        loss += tsp_unsupervised_loss(predictions, adjacency_matrix,
                                      generator, noise, fast_inaccurate)
    return loss

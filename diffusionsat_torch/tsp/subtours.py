"""Violated-subtour-cut finder, native C++ through ctypes.

Counterpart of the TPU package's `tsp/subtours.py`: greedy edge addition
with component tracking (union-find for symmetric, Tarjan SCC for
asymmetric instances) in `dsat_tsp_subtours` of `sat/native/solver.cpp`,
emitting (cut id, flat edge index) pairs with the cut ids ascending. The
TPU package wraps the call in a host callback of its jit; here it is a plain
host call on a CPU copy of the predictions (`subtour_pairs`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from diffusionsat_torch.tsp import PADDING_VALUE
from diffusionsat_torch.tsp.data import tsp_lib


def find_subtours(predictions: np.ndarray, adjacency: np.ndarray,
                  symmetric: bool = True,
                  padding_value: float = PADDING_VALUE) -> np.ndarray:
    """Host call. predictions/adjacency: [B, P, P] float32.
    Returns int64 [n_pairs, 2] of (cut_id, flat_edge_index)."""
    preds = np.ascontiguousarray(predictions, dtype=np.float32)
    adj = np.ascontiguousarray(adjacency, dtype=np.float32)
    b, p, _ = preds.shape
    max_pairs = max(16 * b * p, 1024)
    lib = tsp_lib()
    if lib is None:
        raise RuntimeError("the native solver library could not be built")
    for _ in range(4):
        out = np.zeros((max_pairs, 2), dtype=np.int64)
        n = lib.dsat_tsp_subtours(
            b, p, preds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            adj.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            padding_value, 1 if symmetric else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), max_pairs)
        if n <= max_pairs:
            return out[:n]
        max_pairs = int(n)
    raise RuntimeError("subtour buffer retry exhausted")


def subtour_pairs(predictions: torch.Tensor, adjacency: torch.Tensor,
                  max_pairs: int, symmetric: bool = True) -> np.ndarray:
    """The cut pairs of detached predictions ([B, P, P], any device; copied
    to the host, which waits for the device), truncated to the first
    `max_pairs` as the TPU package's fixed-size callback buffer truncates
    them: int64 [n, 2], n <= max_pairs."""
    pairs = find_subtours(predictions.detach().cpu().numpy(),
                          adjacency.detach().cpu().numpy(),
                          symmetric=symmetric)
    return pairs[:max_pairs]

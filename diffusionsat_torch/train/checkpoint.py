"""Portable `.npz` params files, read into the port's parameter tree.

One file serves both packages: `load_params` reads the TPU package's
`export_params` format (flattened `a/b/0` keys plus a JSON `__meta__`
record) into nested dicts and lists of numpy arrays, the same tree that
package builds, and `params_from_numpy` carries that tree onto torch
tensors. Dense kernels keep their [in, out] layout; the port computes
`x @ w + b`.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch


def _unflatten_params(flat: dict[str, np.ndarray]) -> Any:
    nested: dict = {}
    for path, arr in flat.items():
        node = nested
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr

    def finalize(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [finalize(node[k]) for k in sorted(node, key=int)]
        return {k: finalize(v) for k, v in node.items()}

    return finalize(nested)


def load_params(path: str | Path) -> tuple[Any, dict]:
    """Load `(params, meta)` from an `.npz` params file."""
    path = Path(path)
    if path.suffix != ".npz":
        raise ValueError(f"{path}: only .npz params files are supported")
    with np.load(path) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    return _unflatten_params(flat), meta


def params_from_numpy(tree: Any, device: str | torch.device = "cuda") -> Any:
    """Carry a params tree (nested dicts/lists of numpy arrays, as
    `load_params` returns) onto torch tensors on `device`, keeping every
    shape and dtype. The flat and the dense QuerySAT share one tree (the
    MLPs act on the last axis only), so the dense model needs no case of
    its own here."""
    from diffusionsat_torch.device import resolve_device

    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return conv(tree)

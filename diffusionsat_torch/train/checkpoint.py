"""Portable `.npz` params files and training checkpoints.

One params file serves both packages: `export_params` writes and
`load_params` reads the TPU package's format (flattened `a/b/0` keys plus
a JSON `__meta__` record) as nested dicts and lists of numpy arrays, the
same tree that package builds; `params_from_numpy` / `params_to_numpy`
carry that tree onto torch tensors and back. Dense kernels keep their
[in, out] layout; the port computes `x @ w + b`.

`CheckpointManager` keeps the newest `max_to_keep` training states of a
run, one `.npz` per step holding the params, the optimizer's moments and
count, the step and the generator's state, so that a restored run
continues bit-identically on the same device. (The TPU package's own
checkpoint directories are another format and are not read here; params
travel between the packages as `export_params` files.)
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from diffusionsat_torch.train.adabelief import AdaBeliefState
from diffusionsat_torch.train.loop import TrainState


def _flatten_params(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_params(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten_params(v, f"{prefix}{i}/"))
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[prefix[:-1]] = np.asarray(tree)
    return out


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


def export_params(params: Any, path: str | Path,
                  meta: dict | None = None) -> None:
    """Write a params tree (torch tensors or numpy arrays) to one portable
    compressed `.npz` file: the distribution format for pretrained models,
    which `load_params` of either package restores without an optimizer
    template and without knowing the tree's structure up front. Supports
    dict/list/tuple nesting with array leaves (tuples come back as lists);
    dict keys must not be all-digit strings."""
    np.savez_compressed(Path(path),
                        __meta__=np.asarray(json.dumps(meta or {})),
                        **_flatten_params(params))


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


def params_like(template: Any, tree: Any) -> Any:
    """`tree` with the dict order of `template`, the same keys and leaf
    shapes checked. A params file lists its modules in its writer's order
    (sorted, when the TPU package wrote it), and the optimizer pairs
    params with its state by position, so warm-started params must take
    the order of the params the state was made for."""
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            raise ValueError(f"params keys {sorted(tree)} differ from "
                             f"{sorted(template)}")
        return {k: params_like(template[k], tree[k]) for k in template}
    if isinstance(template, (list, tuple)):
        if len(tree) != len(template):
            raise ValueError("params lists differ in length")
        return [params_like(a, b) for a, b in zip(template, tree)]
    if tuple(template.shape) != tuple(tree.shape):
        raise ValueError(f"params shape {tuple(tree.shape)} differs from "
                         f"{tuple(template.shape)}")
    return tree


def load_model(path: str | Path, device: str | torch.device = "cuda",
               **cfg_kw) -> tuple[Any, Any]:
    """`(params on device, QuerySATConfig)` of a QuerySAT model, from an
    `.npz` params file or from a `CheckpointManager` directory (its newest
    checkpoint), as every `--model_ckpt` flag takes them. An `.npz` file's
    config takes the widths its metadata records (`cfg_kw`'s, else the
    defaults, where it records none); a directory records none, so its
    config is `QuerySATConfig(**cfg_kw)` and a checkpoint of other widths
    raises `params_like`'s shape error."""
    from diffusionsat_torch.models.query_sat import (
        QuerySATConfig,
        query_sat_init,
    )

    if not str(path).endswith(".npz"):
        cfg = QuerySATConfig(**cfg_kw)
        return restore_model_params(path, query_sat_init, cfg, device), cfg
    tree, meta = load_params(path)
    recorded = meta.get("config", {})
    widths = {k: recorded[k] for k in ("feature_maps", "query_maps",
                                       "logit_maps") if k in recorded}
    return params_from_numpy(tree, device), QuerySATConfig(
        **{**cfg_kw, **widths})


def restore_model_params(model_ckpt: str | Path, init_fn, cfg,
                         device: str | torch.device = "cuda") -> Any:
    """Model params from a portable `.npz` params file or from a
    `CheckpointManager` directory, on `device`, in the module order of
    `init_fn(generator, cfg)`'s tree (the counterpart of the TPU package's
    `restore_model_params`; its own checkpoint directories are another
    format). A path that is no directory, or a directory that holds no
    checkpoint, raises FileNotFoundError; reading never creates it."""
    from diffusionsat_torch.device import resolve_device
    from diffusionsat_torch.train.adabelief import adabelief

    dev = resolve_device(device)
    is_npz = str(model_ckpt).endswith(".npz")
    if not is_npz and not Path(model_ckpt).is_dir():
        raise FileNotFoundError(f"no checkpoint in {model_ckpt}")
    template = init_fn(torch.Generator(device=dev).manual_seed(0), cfg)
    if is_npz:
        tree, _meta = load_params(model_ckpt)
        return params_like(template, params_from_numpy(tree, dev))
    restored = CheckpointManager(model_ckpt).restore(TrainState(
        params=template, opt_state=adabelief().init(template), step=0,
        generator=None))
    if restored is None:
        raise FileNotFoundError(f"no checkpoint in {model_ckpt}")
    return params_like(template, restored.params)


def params_to_numpy(tree: Any) -> Any:
    """The inverse of `params_from_numpy`: torch leaves to numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def opt_state_from_numpy(count, m: Any, v: Any,
                         device: str | torch.device = "cuda"
                         ) -> AdaBeliefState:
    """An AdaBelief state from numpy: the step count and the two moment
    trees (shaped like the params)."""
    from diffusionsat_torch.device import resolve_device

    dev = resolve_device(device)
    return AdaBeliefState(
        count=torch.tensor(int(count), dtype=torch.int32, device=dev),
        m=params_from_numpy(m, dev), v=params_from_numpy(v, dev))


def opt_state_to_numpy(state: AdaBeliefState) -> tuple[np.ndarray, Any, Any]:
    """(count, m, v) of an AdaBelief state as numpy."""
    return (state.count.detach().cpu().numpy(), params_to_numpy(state.m),
            params_to_numpy(state.v))


class CheckpointManager:
    """`save(state)` writes `ckpt_<step>.npz` into `directory` and prunes
    all but the newest `max_to_keep`; `restore(template)` loads the newest
    one onto the template's device and into its generator."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _steps(self) -> list[int]:
        return sorted(int(p.stem.split("_")[1])
                      for p in self.directory.glob("ckpt_*.npz"))

    def _path(self, step: int) -> Path:
        return self.directory / f"ckpt_{step}.npz"

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState) -> None:
        count, m, v = opt_state_to_numpy(state.opt_state)
        arrays = {"step": np.asarray(state.step), "count": count,
                  **_flatten_params(state.params, "params/"),
                  **_flatten_params(m, "m/"), **_flatten_params(v, "v/")}
        if state.generator is not None:
            arrays["generator"] = state.generator.get_state().numpy()
        # written under another name first: a reader never sees half a file
        tmp = self.directory / f"tmp_{state.step}.npz"
        np.savez(tmp, **arrays)
        tmp.replace(self._path(state.step))
        for step in self._steps()[:-self.max_to_keep]:
            self._path(step).unlink()

    def restore(self, template: TrainState) -> TrainState | None:
        """The newest checkpoint as a TrainState like `template` (same
        device, the template's generator set to the saved state), or None
        when the directory holds none."""
        step = self.latest_step()
        if step is None:
            return None
        with np.load(self._path(step)) as z:
            flat = {k: z[k] for k in z.files}
        dev = template.opt_state.count.device
        trees = {name: _unflatten_params(
            {k[len(name) + 1:]: a for k, a in flat.items()
             if k.startswith(name + "/")}) for name in ("params", "m", "v")}
        generator = template.generator
        if generator is not None and "generator" in flat:
            generator.set_state(torch.from_numpy(flat["generator"]))
        return TrainState(
            params=params_from_numpy(trees["params"], dev),
            opt_state=opt_state_from_numpy(flat["count"], trees["m"],
                                           trees["v"], dev),
            step=int(flat["step"]), generator=generator)

    def close(self):
        pass

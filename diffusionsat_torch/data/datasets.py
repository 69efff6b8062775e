"""Packed-batch dataset with on-disk caching.

Counterpart of the TPU package's `data/datasets.py`: generator -> greedy
bucket packing -> one compressed .npz of padded batches per split -> an
iterator of `SatBatch`es. The cache schema and the file names are that
package's, so either package reads a cache the other wrote.

The number of generator shards decides which instances a split holds (every
shard draws from its own seed), so it is an argument of the data here
(`gen_shards`), apart from the number of processes that generate them
(`gen_workers`). The TPU package ties both to the host's core count, capped
at 16; `gen_shards` defaults to that cap.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import random
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from diffusionsat_torch.data.generators import SatInstances
from diffusionsat_torch.data.packing import pack_instances
from diffusionsat_torch.graph.batch import BucketSpec, SatBatch, build_batch

Instance = tuple[int, list[list[int]], list[int] | None]

_FIELDS = tuple(SatBatch.__dataclass_fields__)
_OPTIONAL_FIELDS = ("solutions_k", "label_isolation_k")


def diffusion_3sat_name(min_vars: int, max_vars: int, train_size: int,
                        label_samples: int = 1, hard_3sat: bool = True
                        ) -> str:
    """The cache name the TPU package's training script gives its diffusion
    dataset: threshold 3-SAT, or k-SAT with `hard_3sat=False`; a K-row
    label bank (K > 1) is another schema and adds `_k{K}`."""
    kind = "3sat" if hard_3sat else "ksat"
    name = f"diffusion_{kind}_{min_vars}_{max_vars}_{train_size}"
    if label_samples > 1:
        name += f"_k{label_samples}"
    return name


def _save_batches(path: Path, batches: list[SatBatch]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for i, b in enumerate(batches):
        for name in _FIELDS:
            val = getattr(b, name)
            if val is None:  # optional fields skip when unset
                continue
            arrays[f"{i}/{name}"] = val.detach().cpu().numpy()
    np.savez_compressed(path, n=np.asarray(len(batches)), **arrays)


def _load_batches(path: Path) -> list[SatBatch]:
    out = []
    with np.load(path) as data:
        for i in range(int(data["n"])):
            kwargs = {}
            for f in _FIELDS:
                key = f"{i}/{f}"
                if key in data:
                    kwargs[f] = torch.from_numpy(np.array(data[key]))
                elif f == "edge_perm_l":  # older cache schema
                    E = len(data[f"{i}/edge_lit_l"])
                    kwargs[f] = torch.arange(E, dtype=torch.int32)
                elif f in _OPTIONAL_FIELDS:
                    kwargs[f] = None
                else:
                    raise KeyError(key)
            out.append(SatBatch(**kwargs))
    return out


def _gen_for_mode(instances, mode: str):
    if mode == "train":
        return instances.train_generator()
    if mode == "validation" and hasattr(instances, "validation_generator"):
        return instances.validation_generator()
    return instances.test_generator()


def _run_shard(args):
    shard, mode = args
    return list(_gen_for_mode(shard, mode))


def _generate_instances(instances: SatInstances, mode: str,
                        shards: int = 16, workers: int | None = None
                        ) -> list[Instance]:
    """Generate the instance list: `shards` seed-split copies of the
    generator (when it can split), run in up to `workers` processes and
    joined in shard order. `workers=None` takes the host's cores."""
    parts = instances.split(shards) if shards > 1 else None
    if not parts or len(parts) <= 1:
        return list(_gen_for_mode(instances, mode))
    if workers is None:
        workers = os.cpu_count() or 1
    workers = min(workers, len(parts))
    jobs = [(s, mode) for s in parts]
    out: list[Instance] = []
    if workers <= 1:
        for job in jobs:
            out.extend(_run_shard(job))
        return out
    # spawn, not fork: the parent may already hold threads
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        for part in pool.map(_run_shard, jobs):
            out.extend(part)
    return out


class PackedBatches:
    """A list of cached SatBatches with train-style iteration."""

    def __init__(self, batches: list[SatBatch], seed: int = 0):
        self.batches = batches
        self.seed = seed

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self) -> Iterator[SatBatch]:
        return iter(self.batches)

    def repeat_shuffled(self) -> Iterator[SatBatch]:
        """Infinite shuffled stream."""
        rng = random.Random(self.seed)
        while True:
            order = list(range(len(self.batches)))
            rng.shuffle(order)
            for i in order:
                yield self.batches[i]


class SatDataset:
    """Generator + bucket -> cached packed batches of CPU tensors, one
    cache file per (name, bucket, split)."""

    def __init__(self, instances: SatInstances, bucket: BucketSpec,
                 cache_dir: str | Path = "data_cache",
                 name: str | None = None, force_data_gen: bool = False,
                 seed: int = 0, gen_shards: int = 16,
                 gen_workers: int | None = None):
        self.instances = instances
        self.bucket = bucket
        self.cache_dir = Path(cache_dir)
        self.name = name or type(instances).__name__
        self.force_data_gen = force_data_gen
        self.seed = seed
        self.gen_shards = gen_shards
        self.gen_workers = gen_workers

    def _cache_path(self, mode: str) -> Path:
        key = json.dumps({
            "bucket": [self.bucket.max_vars, self.bucket.max_clauses,
                       self.bucket.max_edges, self.bucket.max_graphs],
            "name": self.name,
            "mode": mode,
        }, sort_keys=True)
        h = hashlib.sha256(key.encode()).hexdigest()[:16]
        return self.cache_dir / f"{self.name}_{mode}_{h}.npz"

    def _materialize(self, mode: str) -> PackedBatches:
        path = self._cache_path(mode)
        if path.exists() and not self.force_data_gen:
            return PackedBatches(_load_batches(path), seed=self.seed)
        instances = _generate_instances(self.instances, mode,
                                        shards=self.gen_shards,
                                        workers=self.gen_workers)
        packed = pack_instances(instances, self.bucket, seed=self.seed)
        batches = []
        for group in packed:
            formulas = [(n, cl) for n, cl, _ in group]
            sols = [s if s is not None else [0] * n for n, _, s in group]
            batches.append(build_batch(formulas, self.bucket, solutions=sols))
        _save_batches(path, batches)
        return PackedBatches(batches, seed=self.seed)

    def train_data(self) -> PackedBatches:
        return self._materialize("train")

    def validation_data(self) -> PackedBatches:
        """Validation split; generators without a dedicated validation
        stream fall back to the test generator."""
        gen = getattr(self.instances, "validation_generator", None)
        return self._materialize("validation" if gen else "test")

    def test_data(self) -> PackedBatches:
        return self._materialize("test")

"""Packed ANF-batch dataset with on-disk caching.

Counterpart of the TPU package's `data/anf_datasets.py`: instances ->
greedy packing against the ANF bucket -> one compressed .npz of padded
batches per split. The cache file names and the npz schema (`"{i}/{field}"`
and `n`) are that package's, so either package reads a cache the other
wrote; a cache written before `free_input_mask` existed loads it as None.
"""

from __future__ import annotations

import hashlib
import json
import random
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from diffusionsat_torch.graph.anf_batch import (
    ANFBatch,
    ANFBucket,
    build_anf_batch,
)

_FIELDS = tuple(ANFBatch.__dataclass_fields__)


def pack_anf_instances(instances, bucket: ANFBucket, seed: int = 0,
                       shuffle_batches: bool = True) -> list[list]:
    """Greedy packing against the ANF bucket limits (vars / ands / clauses /
    edges / graphs): instances sorted by vars + clauses, cut where the next
    one would overflow, then the batch order shuffled by `random.Random`
    (`seed`). Instances larger than the bucket are dropped."""
    def size_of(item):
        n_vars, equations, _ = item
        n_eq = len(equations)
        n_edges = sum(len(eq) for eq in equations)
        ands = len({(min(t), max(t)) for eq in equations for t in eq
                    if len(t) == 2})
        return n_vars, ands, n_eq, n_edges

    sized = [(size_of(it), it) for it in instances]
    sized = [(s, it) for s, it in sized
             if s[0] <= bucket.max_vars and s[1] <= bucket.max_ands
             and s[2] <= bucket.max_clauses and s[3] <= bucket.max_edges]
    sized.sort(key=lambda x: x[0][0] + x[0][2])

    batches = []
    cur, cv, ca, cc, ce = [], 0, 0, 0, 0
    for (v, a, c, e), it in sized:
        if cur and (cv + v > bucket.max_vars or ca + a > bucket.max_ands
                    or cc + c > bucket.max_clauses
                    or ce + e > bucket.max_edges
                    or len(cur) >= bucket.max_graphs):
            batches.append(cur)
            cur, cv, ca, cc, ce = [], 0, 0, 0, 0
        cur.append(it)
        cv += v
        ca += a
        cc += c
        ce += e
    if cur:
        batches.append(cur)
    if shuffle_batches:
        random.Random(seed).shuffle(batches)
    return batches


def _save_batches(path: Path, batches: list[ANFBatch]) -> None:
    """Write batches in the cache schema: `n` and `"{i}/{field}"` for every
    field that is set."""
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for i, b in enumerate(batches):
        for f in _FIELDS:
            val = getattr(b, f)
            if val is not None:
                arrays[f"{i}/{f}"] = val.detach().cpu().numpy()
    np.savez_compressed(path, n=np.asarray(len(batches)), **arrays)


def _load_batches(path: Path) -> list[ANFBatch]:
    """Read a cache written by `_save_batches` (or by the TPU package)
    as ANFBatches of CPU tensors; fields a cache lacks load as None."""
    with np.load(path) as data:
        return [ANFBatch(**{f: (torch.from_numpy(np.array(data[f"{i}/{f}"]))
                                if f"{i}/{f}" in data else None)
                            for f in _FIELDS})
                for i in range(int(data["n"]))]


class AnfDataset:
    """Packed, cached ANF batches of an instance stream (any object with
    `train_generator()` and `test_generator()` yielding (n_vars, equations,
    witness))."""

    def __init__(self, instances, bucket: ANFBucket,
                 cache_dir: str | Path = "data_cache",
                 name: str | None = None, force_data_gen: bool = False,
                 seed: int = 0):
        self.instances = instances
        self.bucket = bucket
        self.cache_dir = Path(cache_dir)
        self.name = name or type(instances).__name__
        self.force_data_gen = force_data_gen
        self.seed = seed

    def _cache_path(self, mode: str) -> Path:
        key = json.dumps([self.bucket.max_vars, self.bucket.max_ands,
                          self.bucket.max_clauses, self.bucket.max_edges,
                          self.bucket.max_graphs, self.name, mode])
        h = hashlib.sha256(key.encode()).hexdigest()[:16]
        return self.cache_dir / f"anf_{self.name}_{mode}_{h}.npz"

    def _materialize(self, mode: str) -> list[ANFBatch]:
        path = self._cache_path(mode)
        if path.exists() and not self.force_data_gen:
            return _load_batches(path)
        gen = (self.instances.train_generator() if mode == "train"
               else self.instances.test_generator())
        groups = pack_anf_instances(list(gen), self.bucket, seed=self.seed)
        batches = [build_anf_batch([(n, eqs) for n, eqs, _ in group],
                                   self.bucket,
                                   solutions=[wit[:n] for n, _, wit in group])
                   for group in groups]
        _save_batches(path, batches)
        return batches

    def train_data(self) -> list[ANFBatch]:
        return self._materialize("train")

    def test_data(self) -> list[ANFBatch]:
        return self._materialize("test")

    def repeat_shuffled(self, batches) -> Iterator:
        """Endless stream over `batches`, reshuffled every pass by
        `random.Random(seed)`, the TPU package's order."""
        rng = random.Random(self.seed)
        while True:
            order = list(range(len(batches)))
            rng.shuffle(order)
            for i in order:
                yield batches[i]

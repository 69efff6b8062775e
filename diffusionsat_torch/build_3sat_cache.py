"""Build the diffusion flagship's 3-SAT dataset cache (host only, no device
contact).

    python -m diffusionsat_torch.build_3sat_cache [--label_samples K] \
        [--force] [--data_dir DIR]

Counterpart of the TPU package's root `build_3sat_cache.py`: the threshold
3-SAT set of 3-30 variables, 60000 training and 2000 test instances packed
under a 20000-node budget, in that package's cache format and under its
file names, so that either package's `diffusion_training --train_size
60000` and `solve_eval` read it. K > 1 builds the multi-label variant (K
uniform solution samples per instance, cache name suffix `_k{K}`) of the
posterior-training flagship (`diffusion_training --label_samples K`).
"""

from __future__ import annotations

import argparse
import time

from diffusionsat_torch.config import RunConfig
from diffusionsat_torch.data.datasets import PackedBatches
from diffusionsat_torch.diffusion_training import build_dataset


def build(cfg: RunConfig) -> tuple[PackedBatches, PackedBatches]:
    """Generate (or read back) the training and the test split of
    `build_dataset(cfg)` into `cfg.data_dir`, printing each split's time."""
    ds = build_dataset(cfg)
    t0 = time.time()
    tr = ds.train_data()
    print(f"train batches: {len(tr)} in {time.time() - t0:.0f}s", flush=True)
    t0 = time.time()
    te = ds.test_data()
    print(f"test ok in {time.time() - t0:.0f}s", flush=True)
    return tr, te


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--label_samples", type=int, default=1)
    p.add_argument("--force", action="store_true",
                   help="regenerate even when the cache files exist")
    p.add_argument("--data_dir", default="data_cache")
    args = p.parse_args(argv)
    cfg = RunConfig(train_size=60000, test_size=2000, min_vars=3,
                    max_vars=30, max_nodes_per_batch=20000,
                    label_samples=args.label_samples,
                    data_dir=args.data_dir, force_data_gen=args.force)
    return build(cfg)


if __name__ == "__main__":
    main()

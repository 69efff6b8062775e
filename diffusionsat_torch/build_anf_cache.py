"""Build the ANF flagship dataset cache (host only, no device contact).

    python -m diffusionsat_torch.build_anf_cache [--force] [--data_dir DIR]

Counterpart of the TPU package's root `build_anf_cache.py`: the 17-round
SHA-1 ANF set with 2-20 free bits, 8000 training and 256 test systems, in
that package's cache format and under its file names, so that either
package's `anf_eval` and `anf_training` (with `--train_size 8000`) read it.
"""

from __future__ import annotations

import argparse
import time

from diffusionsat_torch.data.anf_datasets import AnfDataset
from diffusionsat_torch.data.sha_anf import Sha1AnfInstances
from diffusionsat_torch.graph.anf_batch import ANFBucket


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--force", action="store_true",
                   help="regenerate even when the cache files exist")
    p.add_argument("--data_dir", default="data_cache")
    args = p.parse_args(argv)
    inst = Sha1AnfInstances(rounds=17, min_free_bits=2, max_free_bits=20,
                            train_size=8000, test_size=256, seed=0)
    bucket = ANFBucket(max_vars=8192, max_ands=16384, max_clauses=8704,
                       max_edges=32768, max_graphs=8)
    ds = AnfDataset(inst, bucket, cache_dir=args.data_dir,
                    name="sha1anf_r17_fb2_20_8000", seed=0,
                    force_data_gen=args.force)
    t0 = time.time()
    tr = ds.train_data()
    print(f"train batches: {len(tr)} in {time.time() - t0:.0f}s", flush=True)
    t0 = time.time()
    te = ds.test_data()
    print(f"test batches: {len(te)} in {time.time() - t0:.0f}s", flush=True)
    return len(tr), len(te)


if __name__ == "__main__":
    main()

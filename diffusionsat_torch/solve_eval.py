"""Solving eval: noise pinned at 1.0 over the whole held-out test split.

    python -m diffusionsat_torch.solve_eval \
        --model_ckpt <ckpt dir | .npz> \
        [--layout flat|dense] [--device cuda] [--out SOLVE_EVAL.json]

Counterpart of the TPU package's root `solve_eval.py`. It pins the
diffusion conditioning noise (1.0 = pure solving: no label signal reaches
the model), runs the test split of the threshold 3-SAT dataset and reports
the fraction of graphs fully solved (`total_accuracy`). `--model_ckpt`
takes a training run's `ckpt/` directory (its newest checkpoint, at the
`QuerySATConfig` defaults' widths) or a portable `.npz` params file, such
as `pretrained/query_sat_3sat_diffusion_mlk64.npz`.

The split is generated at first use by the native solver and cached under
`--data_dir` in the TPU package's cache format and file name. It is a draw
of 16 generator shards whatever the host's core count (`data/datasets.py`).
The flat layout (that package's choice for this eval) runs the
literal-clause aggregations on the segsum kernel; `--layout dense` runs the
same batches re-blocked for the dense model.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from diffusionsat_torch.data.datasets import SatDataset, diffusion_3sat_name
from diffusionsat_torch.data.generators import (
    DiffusionSatInstances,
    SAT3Instances,
)
from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.graph.batch import BucketSpec
from diffusionsat_torch.graph.dense_batch import densify_batches_quantized
from diffusionsat_torch.models.query_sat import query_sat_apply
from diffusionsat_torch.models.query_sat_dense import query_sat_dense_apply
from diffusionsat_torch.train.checkpoint import load_model
from diffusionsat_torch.train.loop import evaluate_metrics, plan_batches
from diffusionsat_torch.train.metrics import SATAccuracy, StepStatistics

# the training runs' node budget per packed batch
MAX_NODES_PER_BATCH = 20_000


def build_dataset(train_size: int, test_size: int, min_vars: int,
                  max_vars: int, seed: int, data_dir: str = "data_cache",
                  gen_workers: int | None = None,
                  label_samples: int = 1) -> SatDataset:
    """The threshold 3-SAT dataset of the training runs, under the cache
    name the TPU package's training script gives it (with `_k{K}` for a
    K-row label bank)."""
    base = SAT3Instances(min_vars=min_vars, max_vars=max_vars,
                         train_size=train_size, test_size=test_size,
                         seed=seed)
    instances = DiffusionSatInstances(base, seed=seed,
                                      n_label_samples=label_samples)
    bucket = BucketSpec.for_node_budget(MAX_NODES_PER_BATCH)
    name = diffusion_3sat_name(min_vars, max_vars, train_size, label_samples)
    return SatDataset(instances, bucket, cache_dir=data_dir, name=name,
                      seed=seed, gen_workers=gen_workers)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_ckpt", required=True,
                   help="<ckpt dir | .npz>: a training run's "
                        "checkpoint directory or a portable params file")
    p.add_argument("--train_size", type=int, default=60000,
                   help="must match the training run so the cached "
                        "dataset (and its test split) is reused")
    p.add_argument("--test_size", type=int, default=2000)
    p.add_argument("--min_vars", type=int, default=3)
    p.add_argument("--max_vars", type=int, default=30)
    p.add_argument("--label_samples", type=int, default=1,
                   help="match the training run's cache variant")
    p.add_argument("--noise", type=float, default=1.0)
    p.add_argument("--test_rounds", type=int, default=64)
    p.add_argument("--max_batches", type=int, default=0,
                   help="0 = the whole test split")
    p.add_argument("--tries", type=int, default=1,
                   help="multi-try predict: re-run with fresh randomness, "
                        "keep each graph's first solving attempt")
    p.add_argument("--out", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--layout", choices=["flat", "dense"], default="flat")
    p.add_argument("--device", default="cuda")
    p.add_argument("--data_dir", default="data_cache")
    p.add_argument("--gen_workers", type=int, default=None,
                   help="processes that generate a missing split "
                        "(default: the host's cores); the split does not "
                        "depend on it")
    args = p.parse_args(argv)
    if args.label_samples < 1:
        p.error("--label_samples must be at least 1")
    dev = resolve_device(args.device)

    test_data = build_dataset(args.train_size, args.test_size, args.min_vars,
                              args.max_vars, args.seed, args.data_dir,
                              args.gen_workers,
                              args.label_samples).test_data()
    print(f"test batches: {len(test_data)}", flush=True)

    params, model_cfg = load_model(args.model_ckpt, dev,
                                   test_rounds=args.test_rounds)

    batches = list(test_data)
    if args.layout == "dense":
        batches = densify_batches_quantized(batches)
        apply_fn = query_sat_dense_apply
    else:
        apply_fn = query_sat_apply
    # one-time device placement, with the flat batches' kernel plans
    planned = plan_batches(batches, dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(args.seed + 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    vals = evaluate_metrics(
        params, model_cfg, planned, [SATAccuracy(), StepStatistics()],
        generator, max_batches=(args.max_batches or None),
        apply_fn=apply_fn, noise_scale=args.noise,
        prediction_tries=args.tries, device=dev)
    # the metrics read every prediction back, so the device is idle here
    eval_seconds = time.perf_counter() - t0
    result = {"model_ckpt": args.model_ckpt, "noise": args.noise,
              "test_rounds": args.test_rounds, "tries": args.tries,
              "n_test_batches": len(batches), **vals,
              "layout": args.layout, "device": str(dev),
              "eval_seconds": eval_seconds}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()

"""Hyperparameter search over QuerySAT architecture and optimizer knobs.

    python -m diffusionsat_torch.hyperopt --trials 20 --steps_per_trial 2000 \
        [--sampler random] [--resume_from results.jsonl] [--device cpu]

Counterpart of the TPU package's root `hyperopt.py`, with its search space,
flags, JSONL records and `--resume_from`: a TPE sampler (`train/tpe.py`)
over the space, each trial a flat QuerySAT trained with AdaBelief and
scored by the solved fraction of the first 8 test batches. Every batch
carries its kernel plans (built once for all trials), so on the card each
trial's literal-clause sums run on the segsum kernel, forward and
backward. It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from diffusionsat_torch.data.datasets import PackedBatches, SatDataset
from diffusionsat_torch.data.generators import (
    DiffusionSatInstances,
    SAT3Instances,
)
from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.graph.batch import BucketSpec
from diffusionsat_torch.models.query_sat import (
    QuerySATConfig,
    query_sat_apply,
    query_sat_init,
)
from diffusionsat_torch.train.adabelief import adabelief
from diffusionsat_torch.train.loop import (
    TrainState,
    evaluate_metrics,
    make_planned_train_step_for,
    plan_batches,
)
from diffusionsat_torch.train.metrics import SATAccuracy
from diffusionsat_torch.train.tpe import (
    Choice,
    IntUniform,
    LogUniform,
    RandomSampler,
    TPESampler,
    Uniform,
)

# the search space of the TPU package's script
SPACE = {
    "learning_rate": LogUniform(10 ** -4.3, 10 ** -2.3),
    "beta_1": Uniform(0.5, 0.95),
    "variables_update_layers": IntUniform(2, 4),
    "output_layers": IntUniform(2, 4),
    "query_layers": IntUniform(2, 4),
    "clauses_update_layers": IntUniform(2, 4),
    "feature_maps": Choice([16, 32, 64]),
    "query_maps": Choice([16, 32, 64]),
    "update_scale": Choice([round(0.2 * i, 1) for i in range(1, 11)]),
    "output_scale": Choice([round(0.2 * i, 1) for i in range(1, 11)]),
    "clauses_scale": Choice([round(0.2 * i, 1) for i in range(1, 11)]),
    "query_scale": Choice([round(0.2 * i, 1) for i in range(1, 11)]),
}
EVAL_BATCHES = 8


def trial_config(hp: dict) -> QuerySATConfig:
    return QuerySATConfig(
        feature_maps=hp["feature_maps"], query_maps=hp["query_maps"],
        update_layers=hp["variables_update_layers"],
        output_layers=hp["output_layers"], query_layers=hp["query_layers"],
        clauses_layers=hp["clauses_update_layers"],
        update_scale=hp["update_scale"], output_scale=hp["output_scale"],
        clauses_scale=hp["clauses_scale"], query_scale=hp["query_scale"])


def _seeded(seed: int, dev: torch.device) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def build_dataset(min_vars: int = 3, max_vars: int = 20,
                  train_size: int = 5000, seed: int = 0,
                  max_nodes_per_batch: int = 6000,
                  data_dir: str = "data_cache",
                  gen_workers: int | None = None) -> SatDataset:
    """The search's data, under the TPU package's cache name: uniformly
    labelled threshold 3-SAT, 500 test instances, generated in up to
    `gen_workers` processes (the host's cores by default)."""
    inst = DiffusionSatInstances(
        SAT3Instances(min_vars=min_vars, max_vars=max_vars,
                      train_size=train_size, test_size=500, seed=seed),
        use_unigen=True, seed=seed)
    return SatDataset(inst, BucketSpec.for_node_budget(max_nodes_per_batch),
                      cache_dir=data_dir, name=f"hyperopt_{min_vars}_"
                                              f"{max_vars}",
                      gen_workers=gen_workers)


def plan_dataset(dataset: SatDataset, device: str | torch.device = "cuda"
                 ) -> tuple[PackedBatches, list]:
    """The training batches and the test batches on `device`, each with its
    kernel plans: the training pairs in a `PackedBatches` whose
    `repeat_shuffled` visits them in the order the TPU package's trials
    visit the batches."""
    train = dataset.train_data()
    return (PackedBatches(plan_batches(train.batches, device),
                          seed=train.seed),
            plan_batches(dataset.test_data(), device))


def train_trial(hp: dict, train: PackedBatches, steps: int, seed: int,
                device: str | torch.device = "cuda"):
    """`steps` AdaBelief steps of the trial's model from the init of seed
    `seed`, the state's generator seeded `seed + 1`, over `train`'s
    (batch, plans) pairs. Returns (cfg, state, [loss per step] as device
    scalars)."""
    dev = resolve_device(device)
    cfg = trial_config(hp)
    opt = adabelief(learning_rate=hp["learning_rate"], b1=hp["beta_1"],
                    eps=1e-8, clip_gradients=True)
    params = query_sat_init(_seeded(seed, dev), cfg)
    state = TrainState(params=params, opt_state=opt.init(params), step=0,
                       generator=_seeded(seed + 1, dev))
    train_step = make_planned_train_step_for(query_sat_apply, cfg, opt,
                                             device=dev)
    data_iter = train.repeat_shuffled()
    losses = []
    for _ in range(steps):
        state, out = train_step(state, *next(data_iter))
        losses.append(out["loss"])
    return cfg, state, losses


def score_trial(params, cfg: QuerySATConfig, test: list,
                device: str | torch.device = "cuda") -> float:
    """The solved fraction of the first 8 planned test batches, the eval's
    generator seeded 2."""
    dev = resolve_device(device)
    vals = evaluate_metrics(params, cfg, test, [SATAccuracy()],
                            _seeded(2, dev), max_batches=EVAL_BATCHES,
                            apply_fn=query_sat_apply, device=dev)
    return vals["total_accuracy"]


def run_trial(hp: dict, dataset: SatDataset, steps: int, seed: int,
              device: str | torch.device = "cuda",
              planned: tuple[PackedBatches, list] | None = None) -> float:
    """Train one trial and return its held-out solved fraction. `planned`
    is `plan_dataset(dataset, device)`, built here when not given."""
    dev = resolve_device(device)
    train, test = planned or plan_dataset(dataset, dev)
    cfg, state, _ = train_trial(hp, train, steps, seed, dev)
    return score_trial(state.params, cfg, test, dev)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--trials", type=int, default=20)
    p.add_argument("--steps_per_trial", type=int, default=2000)
    p.add_argument("--min_vars", type=int, default=3)
    p.add_argument("--max_vars", type=int, default=20)
    p.add_argument("--train_size", type=int, default=5000)
    p.add_argument("--max_nodes_per_batch", type=int, default=6000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sampler", default="tpe", choices=["tpe", "random"])
    p.add_argument("--out", default="hyperopt_results.jsonl")
    p.add_argument("--resume_from", default=None,
                   help="existing results JSONL: completed trials are fed "
                        "to the sampler as observations and trial "
                        "numbering continues after them (lets a "
                        "deadline-cut study be topped up to full size)")
    p.add_argument("--data_dir", default="data_cache")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    sampler = TPESampler(SPACE, seed=args.seed) if args.sampler == "tpe" \
        else RandomSampler(SPACE, seed=args.seed)
    start_trial = 0
    if args.resume_from and Path(args.resume_from).exists():
        with open(args.resume_from) as f:
            for line in f:
                rec = json.loads(line)
                hp = {k: rec[k] for k in SPACE if k in rec}
                if len(hp) == len(SPACE) and "accuracy" in rec:
                    sampler.observe(hp, rec["accuracy"])
                    start_trial = max(start_trial, rec.get("trial", 0) + 1)
        print(f"resumed {start_trial} completed trials from "
              f"{args.resume_from}", flush=True)
    dataset = build_dataset(args.min_vars, args.max_vars, args.train_size,
                            args.seed, args.max_nodes_per_batch,
                            args.data_dir)

    planned = None
    for trial in range(start_trial, args.trials):
        hp = sampler.suggest()
        if planned is None:     # the data of all trials, placed once
            planned = plan_dataset(dataset, dev)
        acc = run_trial(hp, dataset, args.steps_per_trial, seed=trial,
                        device=dev, planned=planned)
        sampler.observe(hp, acc)
        rec = {"trial": trial, "accuracy": acc, **hp}
        print(rec)
        with Path(args.out).open("a") as f:
            f.write(json.dumps(rec) + "\n")
    best_hp, best_acc = sampler.best
    print(f"best: acc={best_acc:.4f} {best_hp}")


if __name__ == "__main__":
    main()

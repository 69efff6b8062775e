"""Typed run configuration + argparse override.

Counterpart of the TPU package's `config.py`: the same dataclass, flags
and defaults, built from argparse, plus `--device` (the port runs on the
card unless asked for the CPU) and `--gen_workers` (processes that
generate a missing data split). `--model`, `--task` and
`--sat_solver_for_generators` take the names of the registries
(`registry.py`), as there. The training script (`diffusion_training`)
reads `--model` only to name the run directory, and trains QuerySAT
whatever it names, as the TPU package's does; `main` trains the model it
names.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

from diffusionsat_torch.registry import (
    DATASET_REGISTRY,
    MODEL_REGISTRY,
    SOLVER_REGISTRY,
)


@dataclasses.dataclass
class RunConfig:
    # diffusion training defaults
    train_steps: int = 167_000
    min_vars: int = 3
    max_vars: int = 30
    desired_multiplier_for_the_number_of_solutions: int = 10
    use_hard_3sat: bool = True
    max_nodes_per_batch: int = 20_000
    use_cosine_decay: bool = True
    learning_rate: float = 3e-4
    initial_learning_rate: float = 1e-3
    cosine_alpha: float = 0.5
    use_unigen: bool = True
    train_size: int = 100_000
    test_size: int = 10_000
    # self-conditioning training: two passes per step, the second fed the stop-gradient denoised
    # estimate of the first; loss = loss1 + 2*loss2. ~3x step cost.
    self_supervised: bool = False
    # uniform solution samples per training instance: 1 = reference parity
    # (one fixed Unigen label per instance); >1 attaches a K-row label bank
    # and the train step resamples the target per graph per step — trains
    # the denoising posterior over the solution set instead of a
    # deterministic formula->solution map (the round-2 MH chain study's
    # cross-component hitting bias)
    label_samples: int = 1

    # dirs
    data_dir: str = "data_cache"
    train_dir: str = "runs"
    ckpt_count: int = 3
    eval_every: int = 1000
    ckpt_every: int = 1000

    # task/model selection
    task: str = "3-sat"
    model: str = "query_sat"
    input_mode: str = "literals"
    sat_solver_for_generators: str = "cdcl"

    # mode flags
    restore: str | None = None
    # warm-start params from a portable pretrained .npz (export_params);
    # optimizer state and step start fresh. A checkpoint found via
    # --restore / the run dir takes priority so watchdog restarts resume
    # rather than re-warm (same semantics as anf_training --init_npz).
    init_npz: str = ""
    force_data_gen: bool = False
    eager: bool = False  # turns on autograd anomaly detection
    label: str = ""

    # model knobs
    train_rounds: int = 32
    test_rounds: int = 64
    feature_maps: int = 128
    query_maps: int = 128
    logit_maps: int = 8
    # training noise-level distribution: noise = U**(1/noise_skew); >1
    # skews draws toward high noise (see QuerySATConfig.noise_skew)
    noise_skew: float = 1.0
    # weighted label-bank selection: softmax(alpha * per-row isolation)
    # instead of uniform; counters the raw sampler's basin-volume bias
    # (see QuerySATConfig.label_isolation_alpha, UNIFORMITY_ANALYSIS.md)
    label_isolation_alpha: float = 0.0
    # closed-loop per-solution reweighting: path to a measured frequency
    # table (measure_bank_freq.py npz). Label-selection logits become
    # label_isolation_alpha * isolation + label_reweight_beta *
    # (-log freq_hat) per bank row — over-sampled solutions get fewer
    # label draws (uniformity/reweight.py; beta=1 = inverse-frequency)
    label_logit_table: str = ""
    label_reweight_beta: float = 1.0
    # train on only the first N cached batches (0 = all): keeps a
    # closed-loop fine-tune inside the measured subset of the cache
    train_batch_limit: int = 0
    # N training steps per device dispatch (one CUDA graph replay on the
    # card) on a dense-only, supervised stream; 0/1 = off
    mega_steps: int = 0

    # execution layout: dense per-graph blocks (graph/dense_batch.py) when
    # every graph fits the block dims; falls back to the flat edge-list
    # path otherwise
    dense: bool = True
    # precision of the dense incidence products: highest (true f32) |
    # high (TF32 operand rounding) | default (bf16 operands with f32
    # accumulation); see ops/dense_ops.py
    incidence_precision: str = "default"
    # data-parallel ranks started by the training script: one card each
    # on the card (NCCL), or gloo ranks on the CPU with --device cpu
    n_devices: int = 1

    seed: int = 0

    # where the port runs, and how many processes generate a missing split
    # (0 = the host's cores; the split does not depend on it)
    device: str = "cuda"
    gen_workers: int = 0

    def run_dir(self) -> Path:
        """A new directory for the run, named by the second it starts; a
        second run in the same second takes a `-<n>` suffix rather than
        writing into the first's directory."""
        stamp = time.strftime("%Y%m%d_%H%M%S")
        label = f"_{self.label}" if self.label else ""
        name = f"{self.model}_{self.task}{label}_{stamp}"
        base = Path(self.train_dir) / name
        path, n = base, 1
        while path.exists():
            path, n = base.with_name(f"{base.name}-{n}"), n + 1
        return path


# the registries' names, which the three selection flags accept
MODELS = tuple(MODEL_REGISTRY.registered_names)
TASKS = tuple(DATASET_REGISTRY.registered_names)
SOLVERS = tuple(SOLVER_REGISTRY.registered_names)


def parse_config(argv: list[str] | None = None) -> RunConfig:
    defaults = RunConfig()
    p = argparse.ArgumentParser()
    for f in dataclasses.fields(RunConfig):
        name = f"--{f.name}"
        default = getattr(defaults, f.name)
        if f.type == "bool" or isinstance(default, bool):
            p.add_argument(name, type=lambda s: s.lower() in ("1", "true"),
                           default=default)
        elif f.name == "model":
            p.add_argument(name, default=default, choices=MODELS)
        elif f.name == "task":
            p.add_argument(name, default=default, choices=TASKS)
        elif f.name == "sat_solver_for_generators":
            p.add_argument(name, default=default, choices=SOLVERS)
        else:
            typ = type(default) if default is not None else str
            p.add_argument(name, type=typ, default=default)
    args = p.parse_args(argv)
    return RunConfig(**vars(args))

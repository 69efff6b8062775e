"""Generic train/eval entry point.

    python -m diffusionsat_torch.main --model query_sat --task 3-sat \
        --train_steps 10000 [--evaluate] [--evaluate_round_gen] \
        [--evaluate_variable_gen] [--evaluate_batch_gen] \
        [--test_invariance] [--test_classic_solver] [--make_cactus]

Counterpart of the TPU package's root `main.py`, with its flags: resolve
the model and the task from the registries (`registry.py`), train the flat
model, then run the evaluation modes named by the bare flags (variable,
batch and round generalization, invariance, the classic-solver baseline,
the cactus CSV; `evaluation/harness.py`). It runs on the card unless
`--device cpu` is given.

Every batch trains and evaluates flat with its kernel plans, host-built
once per batch, so on the card the literal-clause aggregations and their
backwards go through the segsum kernel. Checkpoints are the port's own
(`train/checkpoint.CheckpointManager`): `--restore DIR` continues from the
newest one in DIR.

`--mega_steps N` (N > 1) trains chunks of N batches, one CUDA graph replay
a chunk on the card (`train/loop.make_scanned_train_step_for`), for the
models in `GRAPHED_MODELS`: those whose graphed chunk a card test holds
equal to the same eager steps bit for bit
(`tests/test_torch_main_mega_cuda.py`). The chunks are built once
(`train/loop.chunk_batches`, whole chunks only) and drawn in an order
shuffled per pass from `--seed`; evals and checkpoints come every
`.. // N` calls, and the last chunk is cut at `--train_steps`. Any other
model trains one step a call, with a warning.
"""

from __future__ import annotations

import dataclasses
import inspect
import sys
import time

import torch

from diffusionsat_torch.config import parse_config
from diffusionsat_torch.data.datasets import PackedBatches, SatDataset
from diffusionsat_torch.data.generators import (
    DiffusionSatInstances,
    KSatInstances,
    SAT3Instances,
)
from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.evaluation.harness import (
    evaluate_batch_generalization,
    evaluate_classic_solver,
    evaluate_round_generalization,
    evaluate_variable_generalization,
    make_cactus,
    test_invariance,
)
from diffusionsat_torch.graph.batch import BucketSpec
from diffusionsat_torch.registry import DATASET_REGISTRY, MODEL_REGISTRY
from diffusionsat_torch.train.adabelief import adabelief
from diffusionsat_torch.train.checkpoint import CheckpointManager
from diffusionsat_torch.train.loop import (
    TrainState,
    chunk_batches,
    evaluate_metrics,
    make_scanned_train_step_for,
    make_train_step_for,
    plan_batches,
    train,
    uses_edge_plans,
)
from diffusionsat_torch.train.metrics import SATAccuracy, StepStatistics

EVAL_FLAGS = ["evaluate", "evaluate_round_gen", "evaluate_variable_gen",
              "evaluate_batch_gen", "test_invariance", "test_classic_solver",
              "make_cactus"]

# models that train under --mega_steps: a card test holds their graphed
# chunk equal to the same eager steps bit for bit
GRAPHED_MODELS = ("neuro_sat",)

# the sweeps' lists, as the reference's main.py has them
ROUND_GEN_ROUNDS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
BATCH_GEN_BUDGETS = tuple(range(3000, 24000, 1000))
VARIABLE_GEN_COUNTS = range(10, 100, 10)


def split_eval_flags(argv):
    """(the bare eval flags as a dict of booleans, the other arguments)."""
    flags = {f: False for f in EVAL_FLAGS}
    rest = []
    for a in argv:
        name = a.lstrip("-")
        if name in flags:
            flags[name] = True
        else:
            rest.append(a)
    return flags, rest


def build_instances(cfg):
    """The task's instance stream with a diffusion label per instance. A
    registry task gets only the size arguments its class accepts, so that
    --train_size and the rest reach it and nothing else does."""
    if cfg.task == "3-sat":
        base = SAT3Instances(min_vars=cfg.min_vars, max_vars=cfg.max_vars,
                             train_size=cfg.train_size,
                             test_size=cfg.test_size, seed=cfg.seed)
    elif cfg.task == "ksat":
        base = KSatInstances(min_vars=cfg.min_vars, max_vars=cfg.max_vars,
                             train_size=cfg.train_size,
                             test_size=cfg.test_size, seed=cfg.seed)
    else:
        cls = DATASET_REGISTRY.resolve(cfg.task)
        common = {"min_vars": cfg.min_vars, "max_vars": cfg.max_vars,
                  "train_size": cfg.train_size, "test_size": cfg.test_size,
                  "seed": cfg.seed}
        try:
            accepted = set(inspect.signature(cls).parameters)
        except (TypeError, ValueError):
            accepted = set()
        base = cls(**{k: v for k, v in common.items() if k in accepted})
    return DiffusionSatInstances(base, use_unigen=cfg.use_unigen,
                                 seed=cfg.seed)


def _test_split(cfg, bucket, name, min_vars, max_vars, test_size):
    """A CDCL-labelled threshold 3-SAT test split of the sweeps."""
    inst = DiffusionSatInstances(
        SAT3Instances(min_vars=min_vars, max_vars=max_vars, train_size=1,
                      test_size=test_size, seed=cfg.seed),
        use_unigen=False, seed=cfg.seed)
    return SatDataset(inst, bucket, cache_dir=cfg.data_dir, name=name,
                      seed=cfg.seed,
                      gen_workers=cfg.gen_workers or None).test_data()


def main(argv=None, *, round_gen_rounds=ROUND_GEN_ROUNDS,
         batch_gen_budgets=BATCH_GEN_BUDGETS,
         variable_gen_counts=VARIABLE_GEN_COUNTS) -> dict:
    """Train, then run the eval modes the flags name. The keyword
    arguments are the sweeps' lists (the CLI runs the defaults); a caller
    may pass shorter ones. Returns {"state", "run_dir", "seconds"} and one
    entry per eval mode run, under its flag's name; "seconds" holds the
    host wall of the training and of each mode."""
    flags, rest = split_eval_flags(sys.argv[1:] if argv is None else argv)
    cfg = parse_config(rest)
    dev = resolve_device(cfg.device)
    if cfg.eager:
        torch.autograd.set_detect_anomaly(True)

    model_cfg_cls, model_init, model_apply = MODEL_REGISTRY.resolve(cfg.model)
    edges = uses_edge_plans(model_apply)
    field_names = {f.name for f in dataclasses.fields(model_cfg_cls)}
    model_cfg = model_cfg_cls(**{
        k: getattr(cfg, k) for k in ("feature_maps", "query_maps",
                                     "train_rounds", "test_rounds")
        if k in field_names})

    def seeded(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    optimizer = adabelief(learning_rate=cfg.learning_rate, eps=1e-8,
                          clip_gradients=True)
    params = model_init(seeded(cfg.seed), model_cfg)
    state = TrainState(params=params, opt_state=optimizer.init(params),
                       step=0, generator=seeded(cfg.seed + 1))

    run_dir = cfg.run_dir()
    run_dir.mkdir(parents=True, exist_ok=True)
    mgr = CheckpointManager(cfg.restore or run_dir / "ckpt",
                            max_to_keep=cfg.ckpt_count)
    restored = mgr.restore(state)
    if restored is not None:
        state = restored
        print(f"Restored from step {state.step}", flush=True)

    bucket = BucketSpec.for_node_budget(cfg.max_nodes_per_batch)
    dataset = SatDataset(build_instances(cfg), bucket,
                         cache_dir=cfg.data_dir,
                         name=f"{cfg.task}_{cfg.min_vars}_{cfg.max_vars}_"
                              f"{cfg.train_size}",
                         force_data_gen=cfg.force_data_gen, seed=cfg.seed,
                         gen_workers=cfg.gen_workers or None)
    test_data = dataset.test_data()

    mega = max(cfg.mega_steps, 1)
    if mega > 1 and cfg.model not in GRAPHED_MODELS:
        print(f"WARNING: --mega_steps needs a model whose graphed steps a "
              f"card test holds equal to its eager ones "
              f"({', '.join(GRAPHED_MODELS)}); ignored for {cfg.model}",
              flush=True)
        mega = 1

    seconds: dict[str, float] = {}
    t0 = time.perf_counter()
    if cfg.train_steps > state.step:
        if mega > 1:
            # chunks of `mega` planned batches, stacked on the host and
            # moved to the device once
            planned = plan_batches(dataset.train_data().batches, "cpu",
                                   edges)
            chunks = chunk_batches(planned, mega, dev)
            print(f"mega-steps: {len(chunks)} chunks of {mega} steps "
                  f"({len(planned) % mega} batches left out)", flush=True)
            train_step = make_scanned_train_step_for(
                model_apply, model_cfg, optimizer, dev)
            stream = PackedBatches(chunks, seed=cfg.seed)
        else:
            # every training batch on the device once, with its plans
            planned = plan_batches(dataset.train_data().batches, dev, edges)
            plans_of = {id(b): p for b, p in planned}
            step = make_train_step_for(model_apply, model_cfg, optimizer,
                                       dev)

            def train_step(st, batch):
                return step(st, batch, plans_of[id(batch)])

            stream = PackedBatches([b for b, _ in planned], seed=cfg.seed)
        eval_batches = plan_batches(list(test_data)[:8], dev, edges)
        # a call takes up to `mega` steps, the last cut at --train_steps;
        # evals and checkpoints come every `.. // mega` calls
        state = train(
            state, train_step, stream.repeat_shuffled(),
            steps=-(-(cfg.train_steps - state.step) // mega),
            target_step=cfg.train_steps,
            eval_fn=lambda st: evaluate_metrics(
                st.params, model_cfg, eval_batches,
                [SATAccuracy(), StepStatistics()], seeded(99),
                max_batches=8, apply_fn=model_apply, device=dev),
            eval_every=max(1, cfg.eval_every // mega), checkpoint_fn=mgr.save,
            ckpt_every=max(1, cfg.ckpt_every // mega),
            log_file=run_dir / "train_log.jsonl")
        mgr.save(state)
    seconds["train"] = time.perf_counter() - t0

    results: dict = {"state": state, "run_dir": run_dir, "seconds": seconds}

    def run_mode(mode, fn):
        t0 = time.perf_counter()
        results[mode] = fn()
        seconds[mode] = time.perf_counter() - t0
        return results[mode]

    if flags["evaluate"]:
        vals = run_mode("evaluate", lambda: evaluate_metrics(
            state.params, model_cfg, plan_batches(test_data, dev, edges),
            [SATAccuracy(), StepStatistics()], seeded(7),
            apply_fn=model_apply, device=dev))
        print(f"[evaluate] {vals}", flush=True)

    if flags["test_invariance"]:
        vals = run_mode("test_invariance", lambda: test_invariance(
            state.params, model_cfg, test_data, steps=5, device=dev))
        print(f"[invariance] {vals}", flush=True)

    if flags["test_classic_solver"]:
        t = run_mode("test_classic_solver",
                     lambda: evaluate_classic_solver(test_data, steps=10))
        print(f"[classic solver] {t:.4f}s per batch", flush=True)

    if flags["make_cactus"]:
        run_mode("make_cactus", lambda: make_cactus(
            state.params, model_cfg, test_data,
            run_dir / f"{cfg.model}_cactus.csv", device=dev))
        print(f"[cactus] written to {run_dir}", flush=True)

    if flags["evaluate_variable_gen"]:
        def make_ds(min_v, max_v, test_size):
            return _test_split(cfg, bucket, f"vargen_{min_v}_{max_v}",
                               min_v, max_v, test_size)
        counts = variable_gen_counts
        run_mode("evaluate_variable_gen", lambda: (
            evaluate_variable_generalization(
                state.params, model_cfg, make_ds,
                run_dir / "gen_variables_size_result.txt",
                lower=counts.start, upper=counts.stop, step=counts.step,
                device=dev)))

    if flags["evaluate_batch_gen"]:
        def make_ds_budget(budget):
            return _test_split(cfg, BucketSpec.for_node_budget(budget),
                               f"batchgen_{budget}", cfg.min_vars,
                               cfg.max_vars, 50)
        run_mode("evaluate_batch_gen", lambda: evaluate_batch_generalization(
            state.params, model_cfg, make_ds_budget,
            run_dir / "gen_batch_size_results.txt",
            sizes=batch_gen_budgets, device=dev))

    if flags["evaluate_round_gen"]:
        def cfg_for_rounds(r):
            return dataclasses.replace(model_cfg, test_rounds=r) \
                if "test_rounds" in field_names else model_cfg
        run_mode("evaluate_round_gen", lambda: evaluate_round_generalization(
            state.params, cfg_for_rounds, test_data,
            run_dir / "gen_steps_result.txt",
            rounds_list=list(round_gen_rounds), device=dev))

    return results


if __name__ == "__main__":
    main()

"""DiffusionSAT training entry point.

    python -m diffusionsat_torch.diffusion_training --train_steps 10000

Counterpart of the TPU package's root `diffusion_training.py`, with its
flags and defaults: QuerySAT on diffusion-labeled hard 3-SAT (NeuroSAT-style
k-SAT with `--use_hard_3sat false`), AdaBelief with cosine decay, periodic
eval, diagnostics and checkpoints. It runs on the card unless `--device
cpu` is given. As there, `--model` only names the run directory: the
script trains QuerySAT whatever model it names (`python -m
diffusionsat_torch.main --model <name>` trains the named one).

Two execution layouts:

- dense per-graph blocks (`--dense true`, the default): every batch that
  fits the block tables is re-blocked (`densify_batches_quantized`) and
  trains through `query_sat_dense_apply`, in block-level bf16 unless
  `DSAT_BLOCK_BF16=0`. Batches over the cutoff (`DSAT_DENSE_MAX_VARS`,
  128 variables) stay flat and train through the planned step beside the
  dense ones: on the segsum kernel, or, with `DSAT_FLAT_BACKEND=tiled`
  (the TPU package's default there), on the tile products of each batch's
  non-empty 128 x 128 incidence tiles (ops/tiled_ops.py);
- flat (`--dense false`): every batch trains through `query_sat_apply`
  with its `BatchPlans`, so the literal-clause aggregations and their
  backwards run on the segsum kernel.

`--mega_steps N` (N > 1) runs N optimizer steps per dispatch on a
dense-only, single-device, supervised stream, as the TPU package does: the
dense batches are grouped by shape (G, Vg, Cg and which label fields they
carry), each group is cut into stacks of at most N, and each stack is one
CUDA graph replay on the card (`train/loop.make_scanned_train_step_for`).
Other streams print the TPU package's warning and run one step a call.

`--n_devices N` (N > 1) trains data-parallel on N ranks started from this
command (`parallel/mesh.launch`): on the card one card a rank over NCCL
(fewer visible cards raise `SystemExit`), with `--device cpu` N gloo ranks
on the CPU. The data set is built once, here, before the ranks start; the
ranks read its cache. As in the TPU package's script, a hybrid dense +
flat stream keeps its majority layout, the batches are stacked N at a time
by shape (`parallel/dp.stacked_stream`, each rank taking its row onto its
device once), `--mega_steps` is ignored and `--self_supervised` is
refused. Rank 0 alone evaluates, writes the log, TensorBoard, checkpoints
and `params.npz`; the other ranks print nothing.

The run directory gets `config.json`, `train_log.jsonl`, `tb/`, `ckpt/`
and, at the end, `params.npz`, the portable params file that the samplers
and evals of both packages load.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import sys
from collections import Counter

import numpy as np
import torch

from diffusionsat_torch.config import RunConfig, parse_config
from diffusionsat_torch.data.datasets import (
    PackedBatches,
    SatDataset,
    diffusion_3sat_name,
)
from diffusionsat_torch.data.generators import (
    DiffusionSatInstances,
    KSatInstances,
    SAT3Instances,
)
from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.graph.batch import (
    BucketSpec,
    SatBatch,
    attach_label_isolation,
)
from diffusionsat_torch.graph.dense_batch import (
    DenseSatBatch,
    densify_batches_quantized,
)
from diffusionsat_torch.models.query_sat import (
    QuerySATConfig,
    query_sat_apply,
    query_sat_init,
)
from diffusionsat_torch.models.query_sat_dense import query_sat_dense_apply
from diffusionsat_torch.ops import dense_ops
from diffusionsat_torch.ops.tiled_ops import build_tiled_incidence
from diffusionsat_torch.train.adabelief import (
    adabelief,
    cosine_decay_schedule,
)
from diffusionsat_torch.train.checkpoint import (
    CheckpointManager,
    export_params,
    load_params,
    params_from_numpy,
    params_like,
)
from diffusionsat_torch.train.loop import (
    TrainState,
    evaluate_metrics,
    make_diagnostics_step,
    make_planned_train_step,
    make_scanned_train_step_for,
    make_selfsupervised_train_step,
    make_train_step_for,
    plan_batches,
    stack_batches,
    train,
)
from diffusionsat_torch.train.metrics import SATAccuracy, StepStatistics
from diffusionsat_torch.train.tb import TBWriter
from diffusionsat_torch.uniformity.reweight import attach_logit_table


def _check_ported(cfg: RunConfig) -> None:
    _flat_backend()


def _flat_backend() -> str:
    """The backend of the over-cutoff flat batches of a dense run:
    "segsum" (also read from the TPU package's name "pallas") or "tiled"."""
    backend = os.environ.get("DSAT_FLAT_BACKEND", "segsum")
    if backend not in ("segsum", "pallas", "tiled"):
        raise NotImplementedError(
            f"DSAT_FLAT_BACKEND={backend}: the flat backends are the segsum "
            "kernel (segsum, pallas) and the tiled layout (tiled)")
    return "segsum" if backend == "pallas" else backend


def build_dataset(cfg: RunConfig) -> SatDataset:
    """The training runs' dataset (threshold 3-SAT, or k-SAT with
    `--use_hard_3sat false`), under the cache name the TPU package's
    training script gives it, so either package reads the other's cache."""
    if cfg.use_hard_3sat:
        base = SAT3Instances(min_vars=cfg.min_vars, max_vars=cfg.max_vars,
                             train_size=cfg.train_size,
                             test_size=cfg.test_size, seed=cfg.seed)
    else:
        base = KSatInstances(
            min_vars=cfg.min_vars, max_vars=cfg.max_vars,
            train_size=cfg.train_size, test_size=cfg.test_size,
            desired_multiplier_for_the_number_of_solutions=(
                cfg.desired_multiplier_for_the_number_of_solutions),
            seed=cfg.seed)
    instances = DiffusionSatInstances(base, use_unigen=cfg.use_unigen,
                                      seed=cfg.seed,
                                      n_label_samples=cfg.label_samples)
    bucket = BucketSpec.for_node_budget(cfg.max_nodes_per_batch)
    name = diffusion_3sat_name(cfg.min_vars, cfg.max_vars, cfg.train_size,
                               cfg.label_samples, cfg.use_hard_3sat)
    return SatDataset(instances, bucket, cache_dir=cfg.data_dir, name=name,
                      force_data_gen=cfg.force_data_gen, seed=cfg.seed,
                      gen_workers=cfg.gen_workers or None)


def _split_dense(batches: list[SatBatch]
                 ) -> tuple[list[DenseSatBatch], list[SatBatch]]:
    """Hybrid dispatch: densify the batches that fit the block tables and
    lie below the size cutoff; the rest stay flat. Raises ValueError when
    no batch fits."""
    dense_max_vars = int(os.environ.get("DSAT_DENSE_MAX_VARS", "128"))
    dense_batches, flat_rest = [], []
    for b in batches:
        maxv = int(np.max(b.n_vars_per_graph.numpy(), initial=1))
        if dense_max_vars and maxv > dense_max_vars:
            flat_rest.append(b)
            continue
        try:
            dense_batches.extend(densify_batches_quantized([b]))
        except ValueError:
            flat_rest.append(b)
    if not dense_batches:
        raise ValueError("no batch fits the dense block tables")
    return dense_batches, flat_rest


def _shape_group(b: DenseSatBatch) -> tuple:
    """The stacking key of a dense batch: its block shape and which label
    fields it carries."""
    return (b.G, b.Vg, b.Cg, b.solutions_k is not None,
            b.label_isolation_k is not None)


def _mega_chunks(batches: list[DenseSatBatch], n: int) -> list:
    """The dense batches grouped by `_shape_group` (in order of first
    appearance) and each group cut into stacks of at most `n`, as the TPU
    package's driver chunks them."""
    groups: dict = {}
    for b in batches:
        groups.setdefault(_shape_group(b), []).append(b)
    return [stack_batches(bs[i:i + n]) for bs in groups.values()
            for i in range(0, len(bs), n)]


def main(argv=None):
    cfg = parse_config(argv)
    _check_ported(cfg)
    dev = resolve_device(cfg.device)
    if cfg.incidence_precision not in dense_ops.PRECISIONS:
        raise SystemExit(f"--incidence_precision must be one of "
                         f"{dense_ops.PRECISIONS}")
    if cfg.n_devices > 1:
        return _launch_data_parallel(cfg, dev)
    if cfg.eager:
        torch.autograd.set_detect_anomaly(True)
    # the dense incidence products take the run's precision for the length
    # of the run only
    with dense_ops.incidence_precision(cfg.incidence_precision):
        return _run(cfg, dev)


def _launch_data_parallel(cfg: RunConfig, dev: torch.device) -> dict:
    """Build the data set once, start `cfg.n_devices` ranks and return rank
    0's final record."""
    from diffusionsat_torch.parallel.mesh import launch

    if cfg.self_supervised:
        raise SystemExit("--self_supervised is single-device for now "
                         "(the DP step wraps the plain supervised loss)")
    n = cfg.n_devices
    if dev.type == "cuda":
        if torch.cuda.device_count() < n:
            raise SystemExit(
                f"--n_devices {n} but only {torch.cuda.device_count()} "
                "devices visible (pass --device cpu for N ranks on the CPU)")
        backend, devices = "nccl", None
    else:
        backend, devices = "gloo", ["cpu"] * n
    # the splits are generated (or found) here; the ranks read the cache
    dataset = build_dataset(cfg)
    dataset.train_data()
    dataset.test_data()
    del dataset
    run_dir = cfg.run_dir()
    return launch(_data_parallel_rank, n, backend, devices, cfg,
                  run_dir)[0]


def _data_parallel_rank(ctx, cfg: RunConfig, run_dir) -> dict:
    """One rank of a data-parallel run: rank 0 prints, the others are
    quiet."""
    mesh = ctx.mesh(n_data=ctx.world)
    dev = resolve_device(mesh.device)
    if cfg.eager:
        torch.autograd.set_detect_anomaly(True)
    quiet = contextlib.redirect_stdout(io.StringIO()) if ctx.rank else \
        contextlib.nullcontext()
    with quiet, dense_ops.incidence_precision(cfg.incidence_precision):
        return _run(cfg, dev, mesh, run_dir)


def _data_parallel_stream(cfg: RunConfig, model_cfg, optimizer, mesh,
                          batches: list[SatBatch]):
    """The DP step and its stream over the training batches, as the TPU
    package's script builds them: the layout's batches (a hybrid stream
    keeps its majority layout), stacked `n_devices` at a time by shape,
    each rank taking its row onto its device once (flat rows with their
    kernel plans). Returns (train_step, stream, the first batch kept)."""
    from diffusionsat_torch.parallel import dp
    from diffusionsat_torch.train.loop import build_plans

    dp_batches = list(batches)
    if cfg.mega_steps > 1:
        print("WARNING: --mega_steps needs a dense-only, "
              "single-device, supervised stream; ignored", flush=True)
    if cfg.dense:
        try:
            dense_batches, flat_rest = _split_dense(batches)
            dp_batches = dense_batches + flat_rest
            if flat_rest:
                print(f"hybrid dispatch: {len(dense_batches)} dense + "
                      f"{len(flat_rest)} flat batches (cutoff "
                      f"{os.environ.get('DSAT_DENSE_MAX_VARS', '128')} "
                      "vars)", flush=True)
            shapes = sorted({(d.G, d.Vg, d.Cg) for d in dense_batches})
            print(f"dense layout shapes (G, Vg, Cg): {shapes}", flush=True)
        except ValueError as e:
            print(f"dense layout unavailable ({e}); flat path", flush=True)
    kinds = Counter(type(b).__name__ for b in dp_batches)
    if len(kinds) > 1:
        majority = kinds.most_common(1)[0][0]
        dp_batches = [b for b in dp_batches
                      if type(b).__name__ == majority]
        print(f"WARNING: hybrid stream under DP; keeping only the "
              f"{majority} batches ({len(dp_batches)})", flush=True)
    # the DP apply follows the surviving batches' layout
    dense = isinstance(dp_batches[0], DenseSatBatch)
    step = dp.make_dp_train_step(
        model_cfg, optimizer, mesh,
        apply_fn=query_sat_dense_apply if dense else query_sat_apply)

    def take(group):
        row = dp.shard_stacked_batch(group, mesh)
        plans = build_plans(row.to("cpu"))
        return row, None if plans is None else plans.to(mesh.device)

    stream = dp.stacked_stream(dp_batches, cfg.n_devices, seed=cfg.seed,
                               take=take)
    print(f"data-parallel over {cfg.n_devices} devices", flush=True)

    def train_step(state, item):
        return step(state, *item)

    return train_step, stream, dp_batches[0]


def _run(cfg: RunConfig, dev: torch.device, mesh=None,
         run_dir=None) -> dict:
    """The run on one device, or as one rank of a data-parallel `mesh`
    (into `run_dir`, which rank 0 alone writes)."""
    root = mesh is None or mesh.rank == 0
    model_cfg = QuerySATConfig(
        feature_maps=cfg.feature_maps, query_maps=cfg.query_maps,
        train_rounds=cfg.train_rounds, test_rounds=cfg.test_rounds,
        logit_maps=cfg.logit_maps, noise_skew=cfg.noise_skew,
        label_isolation_alpha=cfg.label_isolation_alpha,
        # block-level bf16 on the dense path, on unless DSAT_BLOCK_BF16=0;
        # the flat model runs f32 regardless
        block_bf16=os.environ.get("DSAT_BLOCK_BF16", "1") == "1")

    lr = cosine_decay_schedule(cfg.initial_learning_rate, cfg.train_steps,
                               cfg.cosine_alpha) if cfg.use_cosine_decay \
        else cfg.learning_rate
    optimizer = adabelief(learning_rate=lr, eps=1e-8, clip_gradients=True)

    # materialize the dataset before touching the card: data generation is
    # pure host work
    dataset = build_dataset(cfg)
    train_data = dataset.train_data()
    test_data = dataset.test_data()
    print(f"train batches: {len(train_data)}, test batches: {len(test_data)}",
          flush=True)
    if cfg.train_batch_limit > 0:
        train_data.batches = train_data.batches[:cfg.train_batch_limit]
        print(f"train batches limited to first {len(train_data)}",
              flush=True)
    if cfg.label_logit_table:
        # closed-loop per-solution reweighting: alpha * isolation + beta *
        # (-log freq_hat) from a measured table, in the per-row logit
        # channel that the step reads with isolation_alpha = 1.0
        if cfg.label_samples <= 1:
            raise SystemExit("--label_logit_table requires a "
                             "multi-label bank (--label_samples > 1)")
        with np.load(cfg.label_logit_table) as z:
            table = dict(z)
        n_meas = attach_logit_table(train_data.batches, table,
                                    cfg.label_isolation_alpha,
                                    cfg.label_reweight_beta)
        model_cfg = dataclasses.replace(model_cfg,
                                        label_isolation_alpha=1.0)
        print(f"label logits attached: {n_meas}/{len(train_data)} batches "
              f"measured (alpha={cfg.label_isolation_alpha}, "
              f"beta={cfg.label_reweight_beta})", flush=True)
    elif cfg.label_isolation_alpha != 0.0:
        if cfg.label_samples <= 1:
            raise SystemExit("--label_isolation_alpha requires a "
                             "multi-label bank (--label_samples > 1)")
        train_data.batches = [attach_label_isolation(b)
                              for b in train_data.batches]
        print(f"label isolation attached to {len(train_data)} batches",
              flush=True)

    init_gen = torch.Generator(device=dev)
    init_gen.manual_seed(cfg.seed)
    params = query_sat_init(init_gen, model_cfg)
    generator = torch.Generator(device=dev)
    generator.manual_seed(cfg.seed + 1)
    state = TrainState(params=params, opt_state=optimizer.init(params),
                       step=0, generator=generator)

    run_dir = cfg.run_dir() if run_dir is None else run_dir
    if root:
        run_dir.mkdir(parents=True, exist_ok=True)
        (run_dir / "config.json").write_text(
            json.dumps(dataclasses.asdict(cfg), indent=1, default=str))
    ckpt_dir = cfg.restore if cfg.restore else run_dir / "ckpt"
    # every rank restores the same checkpoint; rank 0 alone writes
    mgr = CheckpointManager(ckpt_dir, max_to_keep=cfg.ckpt_count) \
        if root or cfg.restore else None
    restored = None if mgr is None else mgr.restore(state)
    if restored is not None:
        state = restored
        print(f"Restored from step {state.step}")
    elif cfg.init_npz:
        warm, meta = load_params(cfg.init_npz)
        state = state.replace(params=params_like(
            params, params_from_numpy(warm, dev)))
        print(f"Warm-started params from {cfg.init_npz} (meta: {meta})",
              flush=True)

    # Execution layout: dense per-graph blocks when the graphs fit the
    # block tables, with over-cutoff batches on the planned flat step;
    # else every batch on the planned flat step. Plans are host-built
    # before a batch moves to the device, and every batch is placed on the
    # device once.
    train_step = None
    diag_apply = query_sat_apply
    mega_chunks = None
    if mesh is not None:
        train_step, data_stream, diag_batch = _data_parallel_stream(
            cfg, model_cfg, optimizer, mesh, train_data.batches)
        dense = isinstance(diag_batch, DenseSatBatch)
        diag_apply = query_sat_dense_apply if dense else query_sat_apply
        diag_plans = None if dense else plan_batches([diag_batch], dev)[0][1]
        diag_batch = diag_batch.to(dev)
    elif cfg.dense:
        try:
            dense_batches, flat_rest = _split_dense(train_data.batches)
        except ValueError as e:
            print(f"dense layout unavailable ({e}); flat path", flush=True)
            cfg = dataclasses.replace(cfg, dense=False)
    if mesh is None and cfg.dense:
        if cfg.mega_steps > 1 and not cfg.self_supervised and not flat_rest:
            # N-step chunks of same-shape batches, stacked on the host
            mega_chunks = _mega_chunks(dense_batches, cfg.mega_steps)
            print(f"mega-steps: {len(mega_chunks)} chunks "
                  f"(<= {cfg.mega_steps} steps/dispatch, "
                  f"{len({_shape_group(b) for b in dense_batches})} shape "
                  "groups)", flush=True)
            mega_chunks = [c.to(dev) for c in mega_chunks]
        elif cfg.mega_steps > 1:
            print("WARNING: --mega_steps needs a dense-only, "
                  "single-device, supervised stream; ignored", flush=True)
        dense_batches = [b.to(dev) for b in dense_batches]
        if _flat_backend() == "tiled" and flat_rest:
            planned_rest = [(b.to(dev), build_tiled_incidence(b).to(dev))
                            for b in flat_rest]
            print(f"flat backend: tiles for {len(flat_rest)} over-cutoff "
                  "batches", flush=True)
        else:
            planned_rest = plan_batches(flat_rest, dev)
        print("train batches device-cached", flush=True)
        diag_apply = query_sat_dense_apply
        if cfg.self_supervised:
            train_step = make_selfsupervised_train_step(
                model_cfg, optimizer, apply_fn=query_sat_dense_apply,
                device=dev)
            if flat_rest:
                print(f"WARNING: self-supervised step is dense-only; "
                      f"{len(flat_rest)} over-cutoff batches excluded",
                      flush=True)
            stream_batches = dense_batches
        elif mega_chunks is not None:
            train_step = make_scanned_train_step_for(
                query_sat_dense_apply, model_cfg, optimizer, dev)
            stream_batches = mega_chunks
        else:
            dense_step = make_train_step_for(query_sat_dense_apply,
                                             model_cfg, optimizer, dev)
            planned = make_planned_train_step(model_cfg, optimizer, dev)
            plans_of = {id(b): p for b, p in planned_rest}

            def train_step(state, batch):
                if isinstance(batch, DenseSatBatch):
                    return dense_step(state, batch)
                return planned(state, batch, plans_of[id(batch)])

            stream_batches = dense_batches + [b for b, _ in planned_rest]
            if flat_rest:
                print(f"hybrid dispatch: {len(dense_batches)} dense + "
                      f"{len(flat_rest)} flat batches", flush=True)
        shapes = sorted({(d.G, d.Vg, d.Cg) for d in dense_batches})
        print(f"dense layout shapes (G, Vg, Cg): {shapes}", flush=True)
    elif mesh is None:
        if cfg.mega_steps > 1:
            print("WARNING: --mega_steps needs a dense-only, "
                  "single-device, supervised stream; ignored", flush=True)
        planned_train = plan_batches(train_data.batches, dev)
        stream_batches = [b for b, _ in planned_train]
        plans_of = {id(b): p for b, p in planned_train}
        planned = make_selfsupervised_train_step(
            model_cfg, optimizer, device=dev) if cfg.self_supervised \
            else make_planned_train_step(model_cfg, optimizer, dev)

        def train_step(state, batch):
            return planned(state, batch, plans_of[id(batch)])
    if mesh is None:
        train_stream = PackedBatches(stream_batches, seed=cfg.seed)
        data_stream = train_stream.repeat_shuffled()
        # under mega-steps the stream holds stacked chunks; diagnostics run
        # on one batch
        diag_batch = dense_batches[0] if mega_chunks is not None \
            else train_stream.batches[0]
        diag_plans = None if isinstance(diag_batch, DenseSatBatch) \
            else plans_of[id(diag_batch)]

    # periodic in-model diagnostics on a fixed train batch
    diag_fn = make_diagnostics_step(model_cfg, diag_apply, device=dev)

    # the eval batches, flat with their kernel plans, on the device once
    eval_batches = plan_batches(list(test_data)[:8], dev)

    def seeded(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def eval_fn(st):
        vals = evaluate_metrics(
            st.params, model_cfg, eval_batches,
            [SATAccuracy(), StepStatistics()], seeded(99), max_batches=8,
            device=dev)
        vals.update(diag_fn(st.params, diag_batch, seeded(123),
                            plans=diag_plans))
        return vals

    tb = None
    if root:
        tb = TBWriter(run_dir / "tb")
        tb.hparams(dataclasses.asdict(cfg))

    # with mega-steps each call advances up to `mega_div` real steps
    # (trailing partial chunks fewer, and at least one): `remaining` calls
    # always suffice, and target_step stops the loop at the real
    # optimizer-step budget, cutting the last chunk to it. Evals and
    # checkpoints come every `.. // mega_div` calls, as in the TPU package
    mega_div = cfg.mega_steps if mega_chunks is not None else 1
    remaining = max(cfg.train_steps - state.step, 0)
    state = train(
        state, train_step, data_stream, steps=remaining,
        target_step=cfg.train_steps,
        eval_fn=eval_fn if root else None,
        eval_every=max(1, cfg.eval_every // mega_div),
        checkpoint_fn=mgr.save if root else None,
        ckpt_every=max(1, cfg.ckpt_every // mega_div),
        log_file=run_dir / "train_log.jsonl" if root else None,
        tb_writer=tb)
    if not root:
        return {}
    mgr.save(state)
    final = eval_fn(state)
    tb.close()
    export_params(state.params, run_dir / "params.npz", meta={
        "model": "query_sat", "config": {
            k: v for k, v in dataclasses.asdict(model_cfg).items()
            if isinstance(v, (int, float, str, bool))},
        "step": state.step})
    final["run_dir"] = str(run_dir)
    print(f"[final] {final}")
    return final


if __name__ == "__main__":
    main(sys.argv[1:])

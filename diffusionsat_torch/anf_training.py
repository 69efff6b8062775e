"""ANFSAT training entry point: SHA-1 preimage ANF systems.

    python -m diffusionsat_torch.anf_training --rounds 17 \
        --min_free_bits 2 --max_free_bits 20 [--device cuda]

Counterpart of the TPU package's root `anf_training.py`, with its flags and
defaults: AdaBelief (constant or `--cosine` learning rate), periodic eval on
16 test batches, checkpoints every two evals, a final eval on the whole test
split, `--restore`, `--init_npz` and `--free_input_upweight`. It runs on the
card unless `--device cpu` is given.

Two execution layouts, as in that package:

- tiled (`DSAT_ANF_TILED=1`, the default): the membership sums of every
  round, and the query's value sums, run as tile products over each
  batch's non-empty 128 x 128 incidence tiles (ops/tiled_ops.py). The tiles
  are built on the host once per batch and kept on the device with the
  batches (Tp x 128 x 128 f32 a batch: about 38 MB for a 17-round batch);
- flat (`DSAT_ANF_TILED=0`): every batch trains with its kernel plans, so
  the membership sums and the AND scatter, and their backwards, run on the
  segsum kernel.

`--mega_steps N` (N > 1) cuts the batch stream into chunks of N steps, each
one CUDA graph replay on the card (`train/loop.make_scanned_train_step_for`)
over the flat layout: the plans are padded to the bucket, so every chunk of
N batches has one shape. The tiles are turned off under mega-steps, with
the TPU package's warning.

Evals run flat through the kernel. The run directory gets
`train_log.jsonl`, `ckpt/` and, at the end, `params.npz`, the portable
params file that either package's `anf_eval` reads.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import torch

from diffusionsat_torch.anf_eval import add_data_args, build_anf_dataset
from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.models.anf_sat import (
    ANFSATConfig,
    anf_sat_apply,
    anf_sat_init,
)
from diffusionsat_torch.ops.tiled_ops import build_anf_tiles
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
    build_plans,
    evaluate_metrics,
    make_planned_train_step_for,
    make_scanned_train_step_for,
    plan_batches,
    stack_batches,
    train,
)
from diffusionsat_torch.train.metrics import ANFAccuracy


def main(argv=None):
    p = argparse.ArgumentParser()
    add_data_args(p, train_size=2000, test_size=200)
    p.add_argument("--train_steps", type=int, default=1500)
    p.add_argument("--train_rounds", type=int, default=16)
    p.add_argument("--test_rounds", type=int, default=32)
    p.add_argument("--feature_maps", type=int, default=128)
    p.add_argument("--eval_every", type=int, default=250)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--cosine", action="store_true",
                   help="cosine-decay lr over train_steps")
    p.add_argument("--restore", default="",
                   help="checkpoint dir to resume from (also keeps "
                        "saving there)")
    p.add_argument("--init_npz", default="",
                   help="warm-start params from a portable .npz params "
                        "file; optimizer state and step start fresh. A "
                        "checkpoint found via --restore takes priority")
    p.add_argument("--free_input_upweight", type=float, default=1.0,
                   help="CE weight multiplier on free message-bit input "
                        "vars (the circuit's true degrees of freedom)")
    p.add_argument("--mega_steps", type=int, default=0,
                   help="N steps per device dispatch (one CUDA graph "
                        "replay on the card, flat layout); 0/1 = off")
    p.add_argument("--label", default="")
    p.add_argument("--train_dir", default="runs_anf")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    ds = build_anf_dataset(args)
    train_batches = ds.train_data()
    test_batches = ds.test_data()
    if not train_batches:
        raise SystemExit("no instance fits the bucket: raise the limits")
    if args.free_input_upweight != 1.0 and \
            train_batches[0].free_input_mask is None:
        # the cache predates the free_input_mask field; rebuild it once
        print("cache lacks free_input_mask; rebuilding", flush=True)
        ds.force_data_gen = True
        train_batches = ds.train_data()
        test_batches = ds.test_data()
        ds.force_data_gen = False
    print(f"train batches: {len(train_batches)}, "
          f"test batches: {len(test_batches)}", flush=True)

    cfg = ANFSATConfig(feature_maps=args.feature_maps,
                       query_maps=args.feature_maps,
                       train_rounds=args.train_rounds,
                       test_rounds=args.test_rounds,
                       free_input_upweight=args.free_input_upweight)
    lr = cosine_decay_schedule(initial_lr=args.lr,
                               decay_steps=args.train_steps) \
        if args.cosine else args.lr
    opt = adabelief(learning_rate=lr, clip_gradients=True)
    init_gen = torch.Generator(device=dev)
    init_gen.manual_seed(args.seed)
    params = anf_sat_init(init_gen, cfg)
    generator = torch.Generator(device=dev)
    generator.manual_seed(args.seed + 1)
    state = TrainState(params=params, opt_state=opt.init(params), step=0,
                       generator=generator)

    run_dir = Path(args.train_dir) / (
        f"anf_sat_r{args.rounds}{'_' + args.label if args.label else ''}_"
        + time.strftime("%Y%m%d_%H%M%S"))
    run_dir.mkdir(parents=True, exist_ok=True)
    ckpt_dir = Path(args.restore) if args.restore else run_dir / "ckpt"
    mgr = CheckpointManager(ckpt_dir, max_to_keep=2)
    restored = mgr.restore(state)
    if restored is not None:
        state = restored
        print(f"Restored from step {state.step}", flush=True)
    elif args.init_npz:
        warm, meta = load_params(args.init_npz)
        state = state.replace(params=params_like(
            params, params_from_numpy(warm, dev)))
        print(f"Warm-started params from {args.init_npz} (meta: {meta})",
              flush=True)

    # every batch on the device once: flat with its kernel plans, or with
    # its tiles (host-built one batch at a time, then moved); mega-steps
    # stack N batches with their padded plans into one chunk
    tiled = os.environ.get("DSAT_ANF_TILED", "1") == "1"
    mega_div = 1
    if tiled and args.mega_steps > 1:
        print("WARNING: DSAT_ANF_TILED ignored with --mega_steps > 1",
              flush=True)
        tiled = False
    if args.mega_steps > 1:
        n = args.mega_steps
        pairs = [(b, build_plans(b, pad=True)) for b in train_batches]
        train_items = [
            tuple(t.to(dev) for t in stack_batches(pairs[i:i + n]))
            for i in range(0, len(pairs), n)]
        mega_div = n
        print(f"mega-steps: {len(train_items)} chunks of <= {n} "
              f"steps/dispatch", flush=True)
    elif tiled:
        t0 = time.time()
        train_items = [(b.to(dev), build_anf_tiles(b).to(dev))
                       for b in train_batches]
        print(f"ANF tiles built for {len(train_items)} batches "
              f"({train_items[0][1].n_tiles} tiles on batch 0) in "
              f"{time.time() - t0:.0f}s", flush=True)
    else:
        train_items = plan_batches(train_batches, dev)
    test_planned = plan_batches(test_batches, dev)
    print("ANF batches device-cached", flush=True)
    if args.mega_steps > 1:
        step_fn = make_scanned_train_step_for(anf_sat_apply, cfg, opt, dev)
    else:
        planned_step = make_planned_train_step_for(
            anf_sat_apply, cfg, opt, plan_kw="tiles" if tiled else "plans",
            device=dev)

        def step_fn(st, pair):
            return planned_step(st, pair[0], pair[1])

    def eval_fn(st, max_batches=16):
        g = torch.Generator(device=dev)
        g.manual_seed(9)
        return evaluate_metrics(st.params, cfg, test_planned,
                                [ANFAccuracy()], g, max_batches=max_batches,
                                apply_fn=anf_sat_apply, device=dev)

    # a chunk advances at least one step, so `remaining` calls suffice;
    # target_step stops at the real optimizer-step budget, cutting the last
    # chunk to it. Evals and checkpoints come every `.. // mega_div` calls
    remaining = max(args.train_steps - state.step, 0)
    state = train(state, step_fn, ds.repeat_shuffled(train_items),
                  steps=remaining,
                  target_step=args.train_steps,
                  eval_fn=eval_fn,
                  eval_every=max(1, args.eval_every // mega_div),
                  checkpoint_fn=mgr.save,
                  ckpt_every=max(1, args.eval_every * 2 // mega_div),
                  log_file=run_dir / "train_log.jsonl")
    mgr.save(state)
    # the headline number: the whole held-out split, not the 16-batch
    # in-training subsample
    final = eval_fn(state, max_batches=None)
    export_params(state.params, run_dir / "params.npz", meta={
        "model": "anf_sat", "step": state.step, "config": {
            k: getattr(cfg, k) for k in (
                "feature_maps", "query_maps", "msg_layers", "vote_layers",
                "train_rounds", "test_rounds", "supervised",
                "use_message_passing", "use_query", "update_scale",
                "output_scale", "clauses_scale", "query_scale")}})
    print(f"[final full-testset] {final}")
    final["run_dir"] = str(run_dir)
    return final


if __name__ == "__main__":
    main(sys.argv[1:])

"""Definitive ANFSAT evaluation: the whole held-out SHA-1 ANF split.

    python -m diffusionsat_torch.anf_eval --ckpt pretrained/anf_sat_sha1_r17.npz \
        [--tries 4] [--marginalize_seeds 16] [--cdcl_completion] \
        [--dump_marginals m.npz] [--device cuda] [--out ANF_EVAL.json]

Counterpart of the TPU package's root `anf_eval.py`, with its flags,
defaults and output keys. It builds (or reads from `--data_dir`) the same
cached dataset as the training script, in that package's cache format and
file name, and evaluates every test batch: per-variable accuracy, free-input
accuracy and systems solved under the rounded prediction; optionally
multi-try predict, test-time marginalization over noise seeds, and
input-anchored CDCL completion on the host (`sat/anf_completion.py`). The
model runs flat, with each batch's kernel plans, so on the card its
membership sums run on the segsum kernel. It runs on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from diffusionsat_torch.data.anf_datasets import AnfDataset
from diffusionsat_torch.data.sha_anf import Sha1AnfInstances
from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.graph.anf_batch import ANFBucket
from diffusionsat_torch.losses.anf import is_graph_sat_anf
from diffusionsat_torch.models.anf_sat import (
    ANFSATConfig,
    anf_sat_apply,
    anf_sat_init,
)
from diffusionsat_torch.sat.anf_completion import (
    extract_graph_equations,
    input_anchored_complete,
)
from diffusionsat_torch.train.checkpoint import restore_model_params
from diffusionsat_torch.train.loop import evaluate_metrics, plan_batches
from diffusionsat_torch.train.metrics import ANFAccuracy


def add_data_args(p: argparse.ArgumentParser, train_size: int,
                  test_size: int) -> None:
    """The dataset and bucket flags that the ANF scripts share."""
    p.add_argument("--rounds", type=int, default=17)
    p.add_argument("--min_free_bits", type=int, default=2)
    p.add_argument("--max_free_bits", type=int, default=20)
    p.add_argument("--train_size", type=int, default=train_size)
    p.add_argument("--test_size", type=int, default=test_size)
    p.add_argument("--seed", type=int, default=0)
    # bucket sized for 17-round instances (~4k vars / ~4.1k equations);
    # two instances per batch
    p.add_argument("--max_vars", type=int, default=8192)
    p.add_argument("--max_ands", type=int, default=16384)
    p.add_argument("--max_clauses", type=int, default=8704)
    p.add_argument("--max_edges", type=int, default=32768)
    p.add_argument("--max_graphs", type=int, default=8)
    p.add_argument("--data_dir", default="data_cache")
    p.add_argument("--device", default="cuda")


def build_anf_dataset(args) -> AnfDataset:
    """The SHA-1 ANF dataset under the cache name the TPU package's ANF
    scripts give it."""
    inst = Sha1AnfInstances(
        rounds=args.rounds, min_free_bits=args.min_free_bits,
        max_free_bits=args.max_free_bits, train_size=args.train_size,
        test_size=args.test_size, seed=args.seed)
    bucket = ANFBucket(max_vars=args.max_vars, max_ands=args.max_ands,
                       max_clauses=args.max_clauses,
                       max_edges=args.max_edges, max_graphs=args.max_graphs)
    name = (f"sha1anf_r{args.rounds}_fb{args.min_free_bits}_"
            f"{args.max_free_bits}_{args.train_size}")
    return AnfDataset(inst, bucket, cache_dir=args.data_dir, name=name,
                      seed=args.seed)


def _seeded(seed: int, dev: torch.device) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True,
                   help="portable .npz params file or a checkpoint "
                        "directory of the training script")
    add_data_args(p, train_size=8000, test_size=256)
    p.add_argument("--test_rounds", type=int, default=32)
    p.add_argument("--feature_maps", type=int, default=128)
    p.add_argument("--tries", type=int, default=1,
                   help="multi-try predict: re-run with fresh randomness, "
                        "keep each system's first solving attempt")
    p.add_argument("--cdcl_completion", action="store_true",
                   help="input-anchored CDCL completion: fix the model's "
                        "predicted free message bits, release the "
                        "least-confident ones on a 0/2/4/8 ladder, "
                        "CDCL-propagate (sat/anf_completion.py)")
    p.add_argument("--marginalize_seeds", type=int, default=0,
                   help="test-time marginalization: average the predicted "
                        "bit posteriors over S noise seeds before "
                        "thresholding/anchoring; 0/1 = off. With "
                        "--cdcl_completion the anchored bits and the "
                        "confidence ladder use the marginalized posterior")
    p.add_argument("--dump_marginals", default=None,
                   help="save per-batch predicted bit posteriors (npz); "
                        "the marginalized posterior with "
                        "--marginalize_seeds")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.perf_counter()
    test_batches = build_anf_dataset(args).test_data()
    print(f"{len(test_batches)} test batches "
          f"({time.perf_counter() - t0:.1f} s to build or load)", flush=True)

    cfg = ANFSATConfig(feature_maps=args.feature_maps,
                       query_maps=args.feature_maps,
                       test_rounds=args.test_rounds)
    params = restore_model_params(args.ckpt, anf_sat_init, cfg, dev)
    # one-time device placement, each batch with its kernel plans
    planned = plan_batches(test_batches, dev)

    t0 = time.perf_counter()
    vals = evaluate_metrics(params, cfg, planned, [ANFAccuracy()],
                            _seeded(9, dev), apply_fn=anf_sat_apply,
                            prediction_tries=args.tries,
                            graph_sat_fn=is_graph_sat_anf, device=dev)
    vals["tries"] = args.tries
    print(f"evaluated in {time.perf_counter() - t0:.1f} s", flush=True)

    @torch.no_grad()
    def head_of(batch, plans, generator):
        logits = anf_sat_apply(params, cfg, batch, generator,
                               training=False, plans=plans, device=dev)[0]
        return logits[:, 0].cpu().numpy()

    marg_probs = None
    if args.marginalize_seeds > 1:
        # posterior average over S noise seeds; marginalized against
        # single-seed accuracy on the free message bits (the input prior
        # the anchored-CDCL ladder keys off)
        S = args.marginalize_seeds
        gen = _seeded(11, dev)
        marg_probs = []
        nvars = corr_m = 0
        nfree = free_m = free_1 = 0
        t0 = time.perf_counter()
        for batch, plans in planned:
            acc = first = None
            for _ in range(S):
                prob = 1.0 / (1.0 + np.exp(-head_of(batch, plans, gen)))
                if first is None:
                    first = prob
                acc = prob if acc is None else acc + prob
            p_mean = acc / S
            marg_probs.append(p_mean)
            vm = batch.var_mask.cpu().numpy() > 0
            sol = batch.solutions.cpu().numpy()
            corr = (p_mean > 0.5).astype(np.int32) == sol
            nvars += int(vm.sum())
            corr_m += int(corr[vm].sum())
            if batch.free_input_mask is not None:
                m = (batch.free_input_mask.cpu().numpy() > 0) & vm
                nfree += int(m.sum())
                free_m += int(corr[m].sum())
                free_1 += int(((first > 0.5).astype(np.int32) == sol)[m]
                              .sum())
        vals["marginalize_seeds"] = S
        vals["marg_per_var_accuracy"] = round(corr_m / max(nvars, 1), 4)
        if nfree:
            vals["marg_free_input_accuracy"] = round(free_m / nfree, 4)
            vals["single_free_input_accuracy"] = round(free_1 / nfree, 4)
        print(f"marginalized over {S} seeds in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    if args.dump_marginals:
        gen = _seeded(13, dev)
        dump = {"n_batches": np.int32(len(test_batches)),
                "marginalize_seeds": np.int32(args.marginalize_seeds),
                "rounds": np.int32(args.rounds),
                "min_free_bits": np.int32(args.min_free_bits),
                "max_free_bits": np.int32(args.max_free_bits),
                "test_size": np.int32(args.test_size),
                "seed": np.int32(args.seed)}
        for bi, (batch, plans) in enumerate(planned):
            if marg_probs is not None:
                prob = marg_probs[bi]
            else:
                prob = 1.0 / (1.0 + np.exp(-head_of(batch, plans, gen)))
            dump[f"prob_{bi}"] = prob.astype(np.float32)
        np.savez_compressed(args.dump_marginals, **dump)
        print(f"marginals dumped to {args.dump_marginals}", flush=True)

    if args.cdcl_completion:
        gen = _seeded(9, dev)
        solved = total = 0
        solved_at: dict[int, int] = {}
        t0 = time.perf_counter()
        for bi, (batch, plans) in enumerate(planned):
            if marg_probs is not None:
                prob = marg_probs[bi]
                pred = (prob > 0.5).astype(np.int8)
                # vote margin as confidence: the ladder releases the
                # least-agreed bits first
                conf = np.abs(2.0 * prob - 1.0)
            else:
                head = head_of(batch, plans, gen)
                pred = (head > 0).astype(np.int8)
                conf = np.abs(head)
            var_graph = batch.var_graph.cpu().numpy()
            geqs = extract_graph_equations(batch)
            for g in np.flatnonzero(batch.graph_mask.cpu().numpy() > 0):
                g = int(g)
                vids = np.flatnonzero(var_graph == g)
                if len(vids) == 0 or g not in geqs:
                    continue
                total += 1
                ok, spec, _ = input_anchored_complete(geqs[g], vids, pred,
                                                      conf)
                if ok:
                    solved += 1
                    solved_at[spec] = solved_at.get(spec, 0) + 1
        vals["completion_systems_solved"] = round(solved / max(total, 1), 4)
        vals["completion_solved_at_release"] = {
            str(k): v for k, v in sorted(solved_at.items())}
        print(f"completion of {total} systems in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    print(f"[full testset] {vals}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(vals, f)
    return vals


if __name__ == "__main__":
    main()

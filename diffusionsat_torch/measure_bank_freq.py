"""Measure how often the raw diffusion sampler emits each bank row of its
own training formulas: the measurement half of closed-loop per-solution
label reweighting (`uniformity/reweight.py`).

    python -m diffusionsat_torch.measure_bank_freq \
        --model_ckpt pretrained/query_sat_3sat_diffusion_mlk64_iso45.npz \
        --chains 96 --out freq_table.npz

Counterpart of the TPU package's root `measure_bank_freq.py`, with its
flags and its output keys, so either package's training reads the table.
For every cached k-bank training batch (built as
`python -m diffusionsat_torch.diffusion_training --label_samples K` builds
it) it runs the nofreeze dense reverse chain `--chains` times, one chain of
one batch at a time, and counts on the device how often each `solutions_k`
row is emitted, with one host fetch per `--chunk` chains. Chain c of batch
i draws from a `torch.Generator` seeded from (seed, i, c).

Per batch i the npz holds ``counts_i`` [K, ng] int32, ``neglog_i`` [K, ng]
f32 (the reweighting logits), ``sat_i`` / ``outside_i`` [ng] (SAT samples,
SAT samples outside the bank), ``fingerprint_i`` (the packing) and
``content_fingerprint_i`` (the bank and the formulas). Parts are written as
they finish, so an interrupted run resumes; a part made with other
measurement settings is refused.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from diffusionsat_torch.config import parse_config
from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.diffusion.sampler import make_dense_diffusion_chain
from diffusionsat_torch.diffusion_training import build_dataset
from diffusionsat_torch.graph.dense_batch import densify_batches_quantized
from diffusionsat_torch.train.checkpoint import load_model
from diffusionsat_torch.uniformity.reweight import (
    batch_fingerprint,
    content_fingerprint,
    finalize_counts,
)

# what a part must have been measured with to be reused on resume
PART_SETTINGS = ("chains", "diffusion_steps", "test_rounds", "model_ckpt",
                 "seed")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_ckpt", required=True,
                   help="<ckpt dir | .npz>: a training run's "
                        "checkpoint directory or a portable params file")
    p.add_argument("--chains", type=int, default=96,
                   help="samples per formula (one per reverse chain)")
    p.add_argument("--chunk", type=int, default=32,
                   help="chains per host fetch of the counts")
    p.add_argument("--max_batches", type=int, default=0,
                   help="measure only the first N cache batches (0=all)")
    p.add_argument("--diffusion_steps", type=int, default=32)
    p.add_argument("--test_rounds", type=int, default=32)
    p.add_argument("--train_size", type=int, default=60000)
    p.add_argument("--label_samples", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tau", type=float, default=0.5)
    p.add_argument("--out", default="freq_table.npz")
    p.add_argument("--data_dir", default="data_cache")
    p.add_argument("--gen_workers", type=int, default=0,
                   help="processes that generate a missing cache (0 = the "
                        "host's cores); the cache does not depend on it")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def chain_generator(seed: int, batch_index: int, chain: int,
                    device: torch.device) -> torch.Generator:
    """The generator of one chain: its seed mixes (seed, batch, chain), the
    counterpart of the TPU package's fold_in keys."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(
        [seed, batch_index, chain]).generate_state(1, np.uint64)[0] >> 1))
    return g


def count_chain(bits: torch.Tensor, solved: torch.Tensor, batch
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chain's counts on the device: per bank row and graph whether the
    chain's bits equal the row ([K, G] int32), whether the graph's sample
    satisfies ([G] int32), and whether it satisfies but equals no row."""
    sk = batch.solutions_k                              # [K, G, Vg]
    vmask = batch.var_mask[None] < 0.5                  # [1, G, Vg]
    gmask = batch.graph_mask > 0.5                      # [G]
    match = ((bits[None] == sk) | vmask).all(-1) & gmask[None]
    srow = (solved > 0.5) & gmask
    return (match.to(torch.int32), srow.to(torch.int32),
            (srow & ~match.any(0)).to(torch.int32))


def _settings(args) -> dict:
    return {k: getattr(args, k) for k in PART_SETTINGS}


def _check_part(part: Path, args, flat) -> None:
    """Refuse a part measured with other settings or on another cache."""
    want = dict(_settings(args), fingerprint=batch_fingerprint(flat),
                content_fingerprint=content_fingerprint(flat))
    with np.load(part) as z:
        for key, value in want.items():
            got = z[key].item() if key in z else None
            if got != value:
                raise SystemExit(
                    f"{part}: made with {key}={got!r}, this run has "
                    f"{value!r}; remove the parts or pick another --out")


def main(argv=None):
    args = parse_args(argv)
    if args.label_samples < 2:
        raise SystemExit("--label_samples must be at least 2: the table "
                         "counts the rows of a label bank")
    dev = resolve_device(args.device)

    # the k-bank training cache: pure host work, generated if missing
    cfg_run = parse_config([
        "--train_size", str(args.train_size), "--test_size", "2000",
        "--min_vars", "3", "--max_vars", "30",
        "--max_nodes_per_batch", "20000",
        "--label_samples", str(args.label_samples),
        "--data_dir", args.data_dir, "--gen_workers", str(args.gen_workers)])
    batches = build_dataset(cfg_run).train_data().batches
    n_total = len(batches)
    n_run = min(n_total, args.max_batches) if args.max_batches else n_total
    print(f"{n_total} cached batches; measuring {n_run} "
          f"x {args.chains} chains", flush=True)

    params, mcfg = load_model(args.model_ckpt, dev,
                              test_rounds=args.test_rounds)
    print("model params restored", flush=True)
    chain = make_dense_diffusion_chain(
        mcfg, diffusion_steps=args.diffusion_steps,
        test_rounds=args.test_rounds, freeze_sat=False)

    parts_dir = Path(args.out + ".parts")
    parts_dir.mkdir(exist_ok=True)
    t_start = time.time()
    for i in range(n_run):
        flat = batches[i]
        part = parts_dir / f"part_{i}.npz"
        if part.exists():
            _check_part(part, args, flat)
            continue
        dense = densify_batches_quantized([flat])[0].to(dev)
        ng = int(flat.n_graphs)
        K = flat.solutions_k.shape[0]
        counts = np.zeros((K, dense.G), np.int64)
        sat = np.zeros((dense.G,), np.int64)
        outside = np.zeros((dense.G,), np.int64)
        done = 0
        t0 = time.time()
        while done < args.chains:
            n = min(args.chunk, args.chains - done)
            c = torch.zeros((K, dense.G), dtype=torch.int32, device=dev)
            s = torch.zeros((dense.G,), dtype=torch.int32, device=dev)
            o = torch.zeros((dense.G,), dtype=torch.int32, device=dev)
            for j in range(done, done + n):
                bits, solved, _ = chain(params, dense,
                                        chain_generator(args.seed, i, j, dev))
                dc, ds, do = count_chain(bits, solved, dense)
                c += dc
                s += ds
                o += do
            # one host fetch a chunk
            counts += c.cpu().numpy()
            sat += s.cpu().numpy()
            outside += o.cpu().numpy()
            done += n
        # write to a temporary name and rename: a kill mid-write leaves no
        # corrupt part for the resume to trust
        tmp = part.parent / f"part_{i}.tmp.npz"
        np.savez_compressed(
            tmp, counts=counts[:, :ng].astype(np.int32),
            sat=sat[:ng].astype(np.int32),
            outside=outside[:ng].astype(np.int32),
            fingerprint=np.str_(batch_fingerprint(flat)),
            content_fingerprint=np.str_(content_fingerprint(flat)),
            n_chains=np.int32(args.chains),
            **{k: np.asarray(v) for k, v in _settings(args).items()})
        os.replace(tmp, part)
        sat_rate = sat[:ng].sum() / max(ng * args.chains, 1)
        print(f"batch {i + 1}/{n_run}: ng={ng} sat_rate={sat_rate:.3f} "
              f"outside={int(outside[:ng].sum())} "
              f"({time.time() - t0:.1f}s, total {time.time() - t_start:.0f}s)",
              flush=True)

    # merge the parts into one npz with counts and reweighting logits
    out = {}
    agg = {"batches": 0, "graphs": 0, "samples": 0, "sat": 0, "outside": 0}
    for i in range(n_run):
        with np.load(parts_dir / f"part_{i}.npz") as z:
            counts = z["counts"]
            out[f"counts_{i}"] = counts
            out[f"sat_{i}"] = z["sat"]
            out[f"outside_{i}"] = z["outside"]
            out[f"fingerprint_{i}"] = z["fingerprint"]
            out[f"content_fingerprint_{i}"] = z["content_fingerprint"]
            out[f"neglog_{i}"] = finalize_counts(batches[i], counts,
                                                 tau=args.tau)
            agg["batches"] += 1
            agg["graphs"] += counts.shape[1]
            agg["samples"] += counts.shape[1] * int(z["n_chains"])
            agg["sat"] += int(z["sat"].sum())
            agg["outside"] += int(z["outside"].sum())
    out["n_chains"] = np.int32(args.chains)
    out["n_batches"] = np.int32(n_run)
    out["model_ckpt"] = np.str_(args.model_ckpt)
    np.savez_compressed(args.out, **out)
    agg["sat_rate"] = round(agg["sat"] / max(agg["samples"], 1), 4)
    agg["outside_rate"] = round(agg["outside"] / max(agg["samples"], 1), 4)
    agg["wall_s"] = round(time.time() - t_start, 1)
    print("FREQ_MEASURE " + json.dumps(agg), flush=True)
    return agg


if __name__ == "__main__":
    main()

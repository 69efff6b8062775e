"""Export a training checkpoint's params to one portable `.npz` file.

    python -m diffusionsat_torch.export_pretrained --ckpt runs/.../ckpt \
        --model query_sat --out pretrained/query_sat_3sat.npz

Counterpart of the TPU package's root `export_pretrained.py`: it reads the
newest checkpoint of a port checkpoint directory
(`train/checkpoint.CheckpointManager`, as the training scripts and
`main` write it) and writes the same npz layout and `meta` record
(`model`, `step`, the model config's scalar fields, an optional `note`)
with `export_params`, so that `load_params` of either package reads the
file. Host code only: the checkpoint is restored onto the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch
from torch.utils import _pytree as pytree

from diffusionsat_torch.train.adabelief import adabelief
from diffusionsat_torch.train.checkpoint import CheckpointManager, export_params
from diffusionsat_torch.train.loop import TrainState


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True,
                   help="checkpoint directory (train/checkpoint.py)")
    p.add_argument("--model", default="query_sat",
                   choices=["query_sat", "anf_sat"])
    p.add_argument("--feature_maps", type=int, default=128)
    p.add_argument("--query_maps", type=int, default=128)
    p.add_argument("--out", required=True)
    p.add_argument("--note", default="",
                   help="free-text provenance note stored in the npz meta")
    args = p.parse_args(argv)

    if args.model == "query_sat":
        from diffusionsat_torch.models.query_sat import (
            QuerySATConfig,
            query_sat_init,
        )
        cfg = QuerySATConfig(feature_maps=args.feature_maps,
                             query_maps=args.query_maps)
        init = query_sat_init
    else:
        from diffusionsat_torch.models.anf_sat import (
            ANFSATConfig,
            anf_sat_init,
        )
        cfg = ANFSATConfig(feature_maps=args.feature_maps,
                           query_maps=args.query_maps)
        init = anf_sat_init

    params = init(torch.Generator().manual_seed(0), cfg)
    template = TrainState(params=params, opt_state=adabelief().init(params),
                          step=0, generator=None)
    restored = CheckpointManager(args.ckpt).restore(template)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint in {args.ckpt}")
    meta = {"model": args.model, "step": int(restored.step),
            "config": {f.name: getattr(cfg, f.name)
                       for f in dataclasses.fields(cfg)
                       if isinstance(getattr(cfg, f.name),
                                     (int, float, str, bool))}}
    if args.note:
        meta["note"] = args.note
    export_params(restored.params, args.out, meta=meta)
    n = sum(x.numel() for x in pytree.tree_leaves(restored.params))
    print(f"exported {n} params (step {int(restored.step)}) -> {args.out}")
    print(json.dumps(meta))
    return meta


if __name__ == "__main__":
    main()

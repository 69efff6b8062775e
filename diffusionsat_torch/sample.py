"""Draw SAT solution samples from a trained model via reverse diffusion.

    python -m diffusionsat_torch.sample --dimacs f.cnf \
        --model_ckpt runs/.../ckpt        # or a portable .npz params file

Counterpart of the TPU package's root `diffusion_sampler.py`. It reads a
training run's checkpoint directory (its newest checkpoint) or an `.npz`
params file and runs on the card (or on the CPU with `--device cpu`). The
sampler picks the layout itself: the dense block chain for a formula of at
most 128 variables and 576 clauses, the flat chain with the segsum kernel
above that. `--refine mh` runs a Metropolis chain over
the solution set from every sample on the host (`uniformity/samplers.py`
`MetropolisRefiner`).
"""

from __future__ import annotations

import argparse
import json

from diffusionsat_torch.diffusion.sampler import DiffusionSampler
from diffusionsat_torch.models.query_sat import QuerySATConfig
from diffusionsat_torch.uniformity.samplers import MetropolisRefiner


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dimacs", required=True)
    p.add_argument("--model_ckpt", required=True,
                   help="<ckpt dir | .npz>: a training run's "
                        "checkpoint directory or a portable params file")
    p.add_argument("--n_samples", type=int, default=100)
    p.add_argument("--diffusion_steps", type=int, default=32)
    p.add_argument("--test_rounds", type=int, default=32)
    p.add_argument("--feature_maps", type=int, default=128)
    p.add_argument("--query_maps", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    p.add_argument("--freeze", choices=["early", "late", "off"],
                   default="early",
                   help="SAT-freeze regime inside the reverse chain: "
                        "'early' = pin a graph the moment its prediction "
                        "satisfies, 'late' = freeze only in the last "
                        "quarter of the chain, 'off' = never freeze")
    p.add_argument("--refine", choices=["off", "mh"], default="off",
                   help="'mh' = Metropolis refinement over the solution set "
                        "(uniform stationary distribution per connected "
                        "component)")
    p.add_argument("--mh_steps", type=int, default=None,
                   help="MH chain length (default 20 * n_vars)")
    args = p.parse_args(argv)

    cfg = QuerySATConfig(feature_maps=args.feature_maps,
                         query_maps=args.query_maps,
                         test_rounds=args.test_rounds)
    sampler = DiffusionSampler.from_checkpoint(
        args.model_ckpt, args.dimacs, cfg=cfg, device=args.device,
        diffusion_steps=args.diffusion_steps,
        test_rounds=args.test_rounds, seed=args.seed,
        freeze_sat=args.freeze != "off",
        freeze_from=(args.diffusion_steps * 3 // 4
                     if args.freeze == "late" else 0))
    print(f"running the {'dense' if sampler.dense else 'flat'} reverse "
          f"chain ({sampler.graphs_per_batch} copies a batch)")
    counts = sampler.samples(args.n_samples)
    if args.refine == "mh":
        counts = MetropolisRefiner(sampler.cnf, None,
                                   n_steps=args.mh_steps).refine(counts)
    print(f"success rate: {sampler.success_rate:.4f}")
    print(f"{len(counts)} distinct solutions over "
          f"{sum(counts.values())} SAT samples")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({str(k): v for k, v in counts.items()}, f)
    else:
        for k, v in sorted(counts.items(), key=lambda kv: -kv[1])[:20]:
            print(f"  {k}: {v}")


if __name__ == "__main__":
    main()

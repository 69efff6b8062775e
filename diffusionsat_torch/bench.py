"""Training throughput of QuerySAT on one card: the repo's speed figure.

    python -m diffusionsat_torch.bench

Counterpart of the TPU package's root `bench.py`. It prints ONE JSON line:
message-passing edge throughput (M forward edge-traversals per second)
over the whole train step at the reference's workload: threshold 3-SAT
packed size-sorted to the 20 000-node budget (6 batches, cycled like a
training epoch), 128 feature / 128 query maps, 32 rounds, on the dense
per-graph blocks with quantized block dims (the flagship driver's layout),
the incidence products with bf16 operands.

Environment, as in the TPU package: `DSAT_MEGA_STEPS` (default 8: each
batch stacked with itself 8 times, 8 steps a CUDA graph replay, variant
`dense_mega8`; 0 or 1 runs the eager step, variant `dense`),
`DSAT_BLOCK_BF16` (default 1; 0 benches f32 states), `DSAT_BENCH_NODES`
(20000), `DSAT_BENCH_WINDOWS` (5), `DSAT_BENCH_MAXGRAPHS`.

The step time is the median of the windows (each 4 passes over the
batches, ended by a device sync), `mde_pct` half their relative range.
The device's busy share is the sum of the kernel times of one call (8
steps, or one eager step) under `torch.profiler` over the median wall of
the same call timed without it; peak memory counts the graphs' capture.
The matmul accounting (`_mlp_row_macs`, `_matmul_macs`, `_useful_macs`) is
the TPU package's; the peak is the H100's f32 rate outside the tensor
cores, 67 TFLOP/s, the rate of the f32 products with TF32 off. The
block-bf16 products run on bf16 tensor cores (`ops/lowp.py`), so their
share of that peak overstates their share of the card's. The card's name and power
limit (`nvidia-smi`) are part of the line. `--device cpu` runs the same
loop on the CPU, for tests at small widths: it times the CPU, not a card,
and measures no busy share.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from diffusionsat_torch.data.bench_workloads import (
    threshold_3sat_batch,
    threshold_3sat_batches_sorted,
)
from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.graph.batch import BucketSpec
from diffusionsat_torch.graph.dense_batch import densify_batches_quantized
from diffusionsat_torch.models.query_sat import QuerySATConfig, query_sat_init
from diffusionsat_torch.models.query_sat_dense import query_sat_dense_apply
from diffusionsat_torch.ops import dense_ops
from diffusionsat_torch.ops import segsum
from diffusionsat_torch.train.adabelief import adabelief
from diffusionsat_torch.train.loop import (
    TrainState,
    make_planned_train_step,
    make_scanned_train_step_for,
    make_train_step_for,
    stack_batches,
)

# H100 SXM, f32 outside the tensor cores (NVIDIA's data sheet, at 700 W)
H100_F32_FLOPS = 67e12
PEAK_BASIS = ("f32 without tensor cores, 67 TFLOP/s (H100 SXM): TF32 is "
              "off; block-bf16 products run on bf16 tensor cores")
# the TPU package's fixed estimate of the reference's step rate on a T4
BASELINE_EDGES_PER_SEC = 1.0e7


def _mlp_row_macs(cfg):
    """Per-round matmul MACs per (var row, clause row), shared by the
    padded and the useful-work accountings."""
    f, q, h = cfg.feature_maps, cfg.query_maps, cfg.logit_maps
    v1 = f + 4 + cfg.label_channels
    var_macs = sum({
        "query": v1 * int(q * cfg.query_scale) + int(q * cfg.query_scale) * q,
        "lit": v1 * 4 * q + (4 * q) ** 2 // 4 + 4 * q * 2 * q,
        "update": (q + v1 + 2 * q) * int(f * cfg.update_scale)
        + int(f * cfg.update_scale) ** 2
        + int(f * cfg.update_scale) * f,
        "out": f * int(f * cfg.output_scale) + int(f * cfg.output_scale) * h,
    }.values())
    clause_macs = (f + 2 * q) * int(f * cfg.clauses_scale) \
        + int(f * cfg.clauses_scale) ** 2 \
        + int(f * cfg.clauses_scale) * (f + q)
    return var_macs, clause_macs


def _matmul_macs(cfg, G, Vg, Cg):
    """Per-round matmul MACs of one dense block shape, padding included."""
    q = cfg.query_maps
    var_macs, clause_macs = _mlp_row_macs(cfg)
    einsum_macs = 4 * G * Cg * 2 * Vg * q
    return G * Vg * var_macs + G * Cg * clause_macs + einsum_macs


def _useful_macs(cfg, n_vars, n_clauses, n_edges):
    """Per-round useful matmul MACs: MLP rows at the real variable and
    clause counts, and q MACs per real edge in each of the 4 incidence
    products."""
    q = cfg.query_maps
    var_macs, clause_macs = _mlp_row_macs(cfg)
    einsum_macs = 4 * n_edges * q
    return n_vars * var_macs + n_clauses * clause_macs + einsum_macs


def card_line() -> str | None:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0]


def busy_seconds(prof) -> float:
    """The sum of the CUDA kernels' device times in a profile, from the
    profiler's raw events (`key_averages` first builds the host's event
    tree: seconds for the 10^5 kernels of a graphed call)."""
    from torch.autograd import DeviceType

    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e9


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--feature_maps", type=int, default=128)
    p.add_argument("--query_maps", type=int, default=128)
    p.add_argument("--rounds", type=int, default=32)
    p.add_argument("--cycles", type=int, default=4,
                   help="passes over the batches in one window")
    p.add_argument("--n_batches", type=int, default=6)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    node_budget = int(os.environ.get("DSAT_BENCH_NODES", "20000"))
    max_graphs = int(os.environ.get("DSAT_BENCH_MAXGRAPHS",
                                    str(max(512, node_budget // 40))))
    n_windows = int(os.environ.get("DSAT_BENCH_WINDOWS", "5"))
    mega_n = int(os.environ.get("DSAT_MEGA_STEPS", "8"))
    rng = np.random.default_rng(0)
    packed = threshold_3sat_batches_sorted(rng, node_budget, args.n_batches,
                                           max_graphs=max_graphs)

    cfg = QuerySATConfig(
        feature_maps=args.feature_maps, query_maps=args.query_maps,
        train_rounds=args.rounds,
        block_bf16=os.environ.get("DSAT_BLOCK_BF16", "1") == "1")
    init_gen = torch.Generator(device=dev)
    init_gen.manual_seed(0)
    params = query_sat_init(init_gen, cfg)
    opt = adabelief(learning_rate=1e-3)
    generator = torch.Generator(device=dev)
    generator.manual_seed(1)
    state = TrainState(params=params, opt_state=opt.init(params), step=0,
                       generator=generator)

    variant, denses = "dense", None
    try:
        denses = densify_batches_quantized([b for b, _ in packed])
        train_step = make_train_step_for(query_sat_dense_apply, cfg, opt,
                                         dev)
        bench_batches = [d.to(dev) for d in denses]
        edge_counts = [e for _, e in packed]
    except ValueError:
        variant = "flat"
        bucket = BucketSpec.for_node_budget(node_budget,
                                            max_graphs=max_graphs)
        batch, real_edges = threshold_3sat_batch(rng, node_budget,
                                                 bucket=bucket)
        planned = make_planned_train_step(cfg, opt, dev)
        plans = segsum.build_batch_plans(batch).to(dev)

        def train_step(st, b):
            return planned(st, b, plans)

        bench_batches = [batch.to(dev)]
        edge_counts = [real_edges]

    steps_per_call = 1
    if mega_n > 1 and variant == "dense":
        train_step = make_scanned_train_step_for(query_sat_dense_apply, cfg,
                                                 opt, dev)
        bench_batches = [stack_batches([d] * mega_n).to(dev)
                         for d in denses]
        steps_per_call = mega_n
        variant = f"dense_mega{mega_n}"

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def window():
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(args.cycles):
            for b in bench_batches:
                state, out = train_step(state, b)
        float(out["loss"])
        sync()
        return time.perf_counter() - t0

    def one_call():
        nonlocal state
        t0 = time.perf_counter()
        state, _ = train_step(state, bench_batches[0])
        sync()
        return time.perf_counter() - t0

    with dense_ops.incidence_precision("default"):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        # warm-up: the first pass captures the graphs, the second runs them
        for _ in range(2):
            for b in bench_batches:
                state, out = train_step(state, b)
            float(out["loss"])
        sync()
        n_steps = args.cycles * len(bench_batches) * steps_per_call
        window_dts = [window() / n_steps for _ in range(n_windows)]
        busy_share = None
        if dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            wall = float(np.median([one_call() for _ in range(3)]))
            # device activity only: the host side of a call's thousands
            # of small ops is not read, and recording it costs seconds
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                one_call()
            busy_share = busy_seconds(prof) / wall
    dt = float(np.median(window_dts))

    rounds = cfg.train_rounds
    # each round moves every edge 2x (lit->clause, clause->lit) forward;
    # count forward message-passing edge traversals only
    edges_per_step = sum(edge_counts) / len(edge_counts) * 2 * rounds
    edges_per_sec = edges_per_step / dt
    dense = variant.startswith("dense")
    out = {
        "metric": "train_edge_throughput",
        "value": round(edges_per_sec / 1e6, 3),
        "unit": "M edge-traversals/s/chip",
        "vs_baseline": round(edges_per_sec / BASELINE_EDGES_PER_SEC, 3),
        "step_time_ms": round(dt * 1e3, 3),
        "window_ms": [round(d * 1e3, 3) for d in window_dts],
        "best_window_ms": round(min(window_dts) * 1e3, 3),
        "window_protocol": f"median-of-{len(window_dts)}",
        "mde_pct": round(100 * (max(window_dts) - min(window_dts))
                         / (2 * dt), 2),
        "variant": variant,
        "block_bf16": cfg.block_bf16,
        "packing": "size-sorted" if dense else "mixed",
        "edges": int(sum(edge_counts) / len(edge_counts)),
        "vars": int(np.mean([int(b.n_vars) for b, _ in packed])),
        "clauses": int(np.mean([int(b.n_clauses) for b, _ in packed])),
        "graphs": int(np.mean([int(b.n_graphs) for b, _ in packed])),
        "rounds": rounds,
        "feature_maps": cfg.feature_maps,
        "query_maps": cfg.query_maps,
        "busy_share": busy_share,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "card": card_line() if dev.type == "cuda" else None,
        "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if dev.type == "cuda" else None),
    }
    if dense:
        out["shapes"] = sorted({(d.G, d.Vg, d.Cg) for d in denses})
        # padded FLOPs: what the products execute, zero rows included
        macs = sum(_matmul_macs(cfg, d.G, d.Vg, d.Cg) for d in denses) \
            / len(denses)
        flops_per_step = macs * 2 * rounds * 3  # forward + ~2x backward
        out["matmul_tflops_per_step"] = round(flops_per_step / 1e12, 4)
        out["sustained_tflops"] = round(flops_per_step / dt / 1e12, 3)
        out["matmul_peak_basis"] = PEAK_BASIS
        out["pct_matmul_peak"] = round(
            100 * flops_per_step / dt / H100_F32_FLOPS, 2)
    # speed of light: useful work only, over the same peak
    useful_macs = float(np.mean([
        _useful_macs(cfg, int(b.n_vars), int(b.n_clauses), e)
        for b, e in packed]))
    useful_flops_per_step = useful_macs * 2 * rounds * 3
    sol_s = useful_flops_per_step / H100_F32_FLOPS
    out["useful_tflops_per_step"] = round(useful_flops_per_step / 1e12, 5)
    out["sol_ms_per_step"] = round(sol_s * 1e3, 4)
    out["pct_of_sol"] = round(100 * sol_s / dt, 3)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])

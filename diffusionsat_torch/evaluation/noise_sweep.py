"""Noise-level sweep diagnostic: run the model at fixed noise scales
t/steps over test batches, recording loss / accuracy / solved-fraction
curves.

Counterpart of the TPU package's `evaluation/noise_sweep.py` (the
reference's `plot_curve`). The curves go to a JSON file always, and to a
PNG when matplotlib imports (it is imported only then, in the function
that plots).
"""

from __future__ import annotations

import itertools
import json
from pathlib import Path

import numpy as np
import torch

from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.models.query_sat import query_sat_apply
from diffusionsat_torch.train.loop import plan_batches
from diffusionsat_torch.train.metrics import sat_accuracy


def _plot(curve: dict, path: str) -> None:
    """The three curves as a PNG at `path`; nothing when matplotlib is
    missing."""
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(12, 3))
    for ax, k in zip(axes, ["loss", "accuracy", "total_accuracy"]):
        ax.plot(curve["noise"], curve[k])
        ax.set_xlabel("noise scale")
        ax.set_title(k)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def noise_sweep(params, cfg, batches, steps: int = 20,
                out_prefix: str | Path | None = None,
                generator: torch.Generator | None = None,
                device: str | torch.device = "cuda") -> dict:
    """Returns {"noise": [...], "loss": [...], "accuracy": [...],
    "total_accuracy": [...]}: step t runs the model on the next batch
    (cycling over the first `steps`) with labels = its stored solutions at
    the fixed noise scale t / steps, through the batch's kernel plans.
    `generator` (on the device; seeded 0 when None) draws the noisy input
    and the round noise."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    planned = plan_batches(itertools.islice(batches, steps), dev)
    it = itertools.cycle(planned)
    curve = {"noise": [], "loss": [], "accuracy": [], "total_accuracy": []}
    for t in range(steps):
        noise_scale = t / steps
        batch, plans = next(it)
        logits, loss, _, _ = query_sat_apply(
            params, cfg, batch, generator, training=False,
            labels=batch.solutions, noise_scale=noise_scale, plans=plans,
            device=dev)
        acc, solved = sat_accuracy(logits[:, 0], batch)
        curve["noise"].append(noise_scale)
        curve["loss"].append(float(loss))
        curve["accuracy"].append(acc)
        curve["total_accuracy"].append(float(np.mean(solved)))

    if out_prefix is not None:
        with open(f"{out_prefix}_noise_sweep.json", "w") as f:
            json.dump(curve, f)
        _plot(curve, f"{out_prefix}_noise_sweep.png")
    return curve


def count_histogram_cross_entropy(counts_a: dict, counts_b: dict,
                                  bins: int = 10, max_count: int = 7
                                  ) -> float:
    """Cross-entropy between binned count histograms: per-solution sample
    counts in `bins` buckets up to `max_count`, normalized, cross-entropy
    of a against b."""
    def hist(counts):
        vals = np.asarray(list(counts.values()), dtype=np.float64)
        h, _ = np.histogram(np.clip(vals, 0, max_count), bins=bins,
                            range=(0, max_count))
        h = h.astype(np.float64)
        return h / max(h.sum(), 1.0)

    pa, pb = hist(counts_a), hist(counts_b)
    eps = 1e-12
    return float(-np.sum(pa * np.log(pb + eps)))

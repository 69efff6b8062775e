"""Reverse-diffusion SAT solution sampler.

Counterpart of the TPU package's `diffusion/sampler.py`
(`make_diffusion_chain`, `make_dense_diffusion_chain` and
`DiffusionSampler`). The reverse chain (randomized rounding, model
denoise, categorical posterior step, per-graph freezing) runs as a Python
loop of eager ops on the device; host code packs the batch and counts the
satisfying samples. Small formulas run on the dense block chain, all others
on the flat chain with the segsum kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from diffusionsat_torch.device import resolve_device
from diffusionsat_torch.diffusion.schedule import (
    randomized_rounding,
    reverse_distribution_step_theoretic,
)
from diffusionsat_torch.graph.batch import BucketSpec, SatBatch, build_batch
from diffusionsat_torch.graph.dense_batch import (
    DenseSatBatch,
    densify_batches_quantized,
)
from diffusionsat_torch.losses.sat import is_graph_sat
from diffusionsat_torch.models.query_sat import (
    QuerySATConfig,
    params_to,
    query_sat_apply,
)
from diffusionsat_torch.models.query_sat_dense import query_sat_dense_apply
from diffusionsat_torch.ops import dense_ops
from diffusionsat_torch.ops.graph_ops import graph_gather_vars
from diffusionsat_torch.ops.segsum import BatchPlans, build_batch_plans
from diffusionsat_torch.sat.cnf import CNF, VariableAssignment


def make_diffusion_chain(cfg: QuerySATConfig, diffusion_steps: int = 32,
                         use_baseline_sampling: bool = True,
                         self_supervised: bool = False,
                         test_rounds: int = 32,
                         freeze_sat: bool = True,
                         freeze_from: int = 0,
                         final_sample: bool = False,
                         temperature: float = 1.0):
    """Build the full reverse chain.

    Returns chain(params, batch, generator, plans=None, **draws) ->
    (bits [V] int32, solved_graphs [G], fixed_step [V]). Per step t: noise
    1-t/N, randomized rounding, model denoise, theoretic posterior step,
    and freezing of graphs whose rounded prediction already satisfies them
    (from step `freeze_from` on). `temperature` rescales the denoiser
    logits; `final_sample` draws the final unfrozen bits from
    Bernoulli(predictions) instead of rounding.

    The optional draws replace the generator's: `rounding_uniforms`
    [N, V, 1], `labels` [N, V] (the model's predict-mode labels),
    `round_noise` [N, test_rounds, V, 4] and `final_uniforms` [V].
    """
    N = diffusion_steps

    @torch.no_grad()
    def chain(params, batch: SatBatch, generator: torch.Generator | None,
              plans: BatchPlans | None = None,
              rounding_uniforms: torch.Tensor | None = None,
              labels: torch.Tensor | None = None,
              round_noise: torch.Tensor | None = None,
              final_uniforms: torch.Tensor | None = None):
        dev = batch.device
        V = batch.V
        x = torch.full((V, 2), 0.5, device=dev)
        fixed_mask = torch.zeros((V,), device=dev)
        fixed_bits = torch.zeros((V,), device=dev)
        fixed_step = torch.full((V,), -1, dtype=torch.int32, device=dev)
        predictions = torch.full((V,), 0.5, device=dev)

        for t in range(N):
            noise_scale = 1.0 - torch.tensor(t, dtype=torch.float32,
                                             device=dev) / N
            x_noisy = randomized_rounding(
                x, generator,
                None if rounding_uniforms is None else rounding_uniforms[t])
            if use_baseline_sampling:
                x = x_noisy

            denoised = predictions[:, None] if self_supervised else None
            # early exit: the batch is many copies of one formula, so the
            # whole batch often satisfies at once and the tail rounds skip
            logits, _, _, _ = query_sat_apply(
                params, cfg, batch, generator, training=False,
                labels=None if labels is None else labels[t],
                noise_scale=noise_scale, noisy_num=x_noisy,
                denoised_num=denoised, rounds=test_rounds, early_exit=True,
                plans=plans,
                round_noise=None if round_noise is None else round_noise[t],
                device=dev)
            predictions = torch.sigmoid(logits[:, 0] / temperature)   # [V]

            x = reverse_distribution_step_theoretic(
                x, torch.stack([1 - predictions, predictions], dim=1),
                noise_scale, 1.0 / N)

            # per-graph freeze: graphs whose rounded prediction is SAT get
            # their bits pinned at this step
            if freeze_sat and t >= freeze_from:
                pred_bits = torch.round(predictions)
                sat_g = is_graph_sat(logits, batch)[:, 0]              # [G]
                sat_v = graph_gather_vars(batch, sat_g[:, None])[:, 0]
                newly = (sat_v > 0.5) & (fixed_mask < 0.5)
                fixed_bits = torch.where(newly, pred_bits, fixed_bits)
                fixed_step = torch.where(
                    newly, torch.tensor(t, dtype=torch.int32, device=dev),
                    fixed_step)
                fixed_mask = torch.maximum(fixed_mask,
                                           newly.to(fixed_mask.dtype))

        if final_sample:
            u = final_uniforms if final_uniforms is not None else \
                torch.rand((V,), generator=generator, device=dev)
            free_bits = (u.to(dev) < predictions).to(torch.float32)
        else:
            free_bits = torch.round(predictions)
        final_bits = torch.where(fixed_mask > 0.5, fixed_bits,
                                 free_bits).to(torch.int32)
        # solved graphs under the final assignment
        final_logits = (final_bits.to(torch.float32) * 2 - 1)[:, None] * 10.0
        solved = is_graph_sat(final_logits, batch)[:, 0]
        return final_bits, solved, fixed_step

    return chain


def make_dense_diffusion_chain(cfg: QuerySATConfig,
                               diffusion_steps: int = 32,
                               use_baseline_sampling: bool = True,
                               self_supervised: bool = False,
                               test_rounds: int = 32,
                               freeze_sat: bool = True,
                               freeze_from: int = 0,
                               final_sample: bool = False,
                               temperature: float = 1.0):
    """Dense-block variant of the reverse chain: the sampler batch is G
    copies of one small formula as `DenseSatBatch` blocks. Same semantics
    as `make_diffusion_chain`; shapes are [G, Vg, ...].

    Returns chain(params, batch, generator, **draws) -> (bits [G, Vg] int32,
    solved_graphs [G], fixed_step [G, Vg]). The optional draws replace the
    generator's: `rounding_uniforms` [N, G, Vg, 1], `labels` [N, G, Vg],
    `round_noise` [N, test_rounds, G, Vg, 4] and `final_uniforms` [G, Vg].
    """
    N = diffusion_steps

    @torch.no_grad()
    def chain(params, batch: DenseSatBatch,
              generator: torch.Generator | None,
              rounding_uniforms: torch.Tensor | None = None,
              labels: torch.Tensor | None = None,
              round_noise: torch.Tensor | None = None,
              final_uniforms: torch.Tensor | None = None):
        dev = batch.device
        G, Vg = batch.G, batch.Vg
        x = torch.full((G, Vg, 2), 0.5, device=dev)
        fixed_mask = torch.zeros((G, Vg), device=dev)
        fixed_bits = torch.zeros((G, Vg), device=dev)
        fixed_step = torch.full((G, Vg), -1, dtype=torch.int32, device=dev)
        predictions = torch.full((G, Vg), 0.5, device=dev)

        for t in range(N):
            noise_scale = 1.0 - torch.tensor(t, dtype=torch.float32,
                                             device=dev) / N
            x_noisy = randomized_rounding(
                x, generator,
                None if rounding_uniforms is None else rounding_uniforms[t])
            if use_baseline_sampling:
                x = x_noisy

            denoised = predictions[..., None] if self_supervised else None
            logits, _, _, _ = query_sat_dense_apply(
                params, cfg, batch, generator, training=False,
                labels=None if labels is None else labels[t],
                noise_scale=noise_scale, noisy_num=x_noisy,
                denoised_num=denoised, rounds=test_rounds, early_exit=True,
                round_noise=None if round_noise is None else round_noise[t],
                device=dev)
            predictions = torch.sigmoid(logits[..., 0] / temperature)

            x = reverse_distribution_step_theoretic(
                x, torch.stack([1 - predictions, predictions], dim=-1),
                noise_scale, 1.0 / N)

            if freeze_sat and t >= freeze_from:
                pred_bits = torch.round(predictions)
                sat_g = dense_ops.is_graph_sat(logits, batch)[:, 0]    # [G]
                sat_v = sat_g[:, None].expand(G, Vg)
                newly = (sat_v > 0.5) & (fixed_mask < 0.5)
                fixed_bits = torch.where(newly, pred_bits, fixed_bits)
                fixed_step = torch.where(
                    newly, torch.tensor(t, dtype=torch.int32, device=dev),
                    fixed_step)
                fixed_mask = torch.maximum(fixed_mask,
                                           newly.to(fixed_mask.dtype))

        if final_sample:
            u = final_uniforms if final_uniforms is not None else \
                torch.rand((G, Vg), generator=generator, device=dev)
            free_bits = (u.to(dev) < predictions).to(torch.float32)
        else:
            free_bits = torch.round(predictions)
        final_bits = torch.where(fixed_mask > 0.5, fixed_bits,
                                 free_bits).to(torch.int32)
        final_logits = (final_bits.to(torch.float32) * 2 - 1
                        )[..., None] * 10.0
        solved = dense_ops.is_graph_sat(final_logits, batch)[:, 0]
        return final_bits, solved, fixed_step

    return chain


class DiffusionSampler:
    """Sample SAT solutions of one formula via reverse diffusion.

    `samples(n)` returns {solution_int: count} over satisfying samples,
    drawing batches of the formula repeated `graphs_per_batch` times until
    n SAT samples accumulate; it stops early when the SAT rate drops below
    0.5%.

    `dense=None` picks the layout as the TPU package does: the dense block
    chain for a formula of at most 128 variables and 576 clauses (256
    copies a batch), the flat chain above that. On the flat chain the
    literal-clause aggregations run on the segsum kernel.
    """

    def __init__(self, params: Any, cfg: QuerySATConfig, cnf: CNF,
                 bucket: BucketSpec | None = None,
                 diffusion_steps: int = 32, test_rounds: int = 32,
                 graphs_per_batch: int | None = None,
                 use_baseline_sampling: bool = True,
                 self_supervised: bool = False, seed: int = 0,
                 dense: bool | None = None, freeze_sat: bool = True,
                 freeze_from: int = 0, final_sample: bool = False,
                 temperature: float = 1.0,
                 device: str | torch.device = "cuda"):
        self.n_vars = cnf.number_of_vars()
        self.clauses = cnf.clauses()
        if dense is None:
            dense = self.n_vars <= 128 and len(self.clauses) <= 576
        self.dense = dense
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.cfg = cfg
        self.cnf = cnf
        n_cells = sum(len(c) for c in self.clauses)
        if graphs_per_batch is None:
            if dense:
                # a fixed batch of copies: with the quantized block dims,
                # formulas of similar size share one batch shape
                graphs_per_batch = 256
            else:
                graphs_per_batch = max(1, min(128,
                                              2000 // max(self.n_vars, 1)))
        if bucket is None:
            g = graphs_per_batch
            bucket = BucketSpec(
                max_vars=-(-self.n_vars * g // 128) * 128,
                max_clauses=-(-len(self.clauses) * g // 128) * 128,
                max_edges=-(-n_cells * g // 512) * 512,
                max_graphs=g)
        self.graphs_per_batch = min(graphs_per_batch, bucket.max_graphs)
        self.bucket = bucket
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        formulas = [(self.n_vars, self.clauses)] * self.graphs_per_batch
        sols = [[0] * self.n_vars] * self.graphs_per_batch
        flat = build_batch(formulas, self.bucket, solutions=sols)
        chain_kw = dict(
            diffusion_steps=diffusion_steps,
            use_baseline_sampling=use_baseline_sampling,
            self_supervised=self_supervised, test_rounds=test_rounds,
            freeze_sat=freeze_sat, freeze_from=freeze_from,
            final_sample=final_sample, temperature=temperature)
        if self.dense:
            self.plans = None
            self.batch = densify_batches_quantized([flat])[0].to(self.device)
            self.chain = make_dense_diffusion_chain(cfg, **chain_kw)
        else:
            self.plans = build_batch_plans(flat).to(self.device)
            self.batch = flat.to(self.device)
            self.chain = make_diffusion_chain(cfg, **chain_kw)

    @classmethod
    def from_checkpoint(cls, model_path: str, dimacs_filename: str,
                        cfg: QuerySATConfig | None = None,
                        device: str | torch.device = "cuda", **kwargs
                        ) -> "DiffusionSampler":
        """Restore the newest checkpoint of a training run's checkpoint
        directory, or a portable `.npz` params file (whose recorded widths
        win over `cfg`'s), and sample the given DIMACS formula."""
        from diffusionsat_torch.train.checkpoint import load_model

        cfg = cfg or QuerySATConfig(test_rounds=32)
        params, cfg = load_model(model_path, device,
                                 **dataclasses.asdict(cfg))
        return cls(params, cfg, CNF.load(dimacs_filename), device=device,
                   **kwargs)

    def samples(self, n_samples: int, max_batches: int = 10_000
                ) -> dict[int, int]:
        counts: dict[int, int] = {}
        total = 0
        sat_total = 0
        needed = n_samples
        for _ in range(max_batches):
            if needed <= 0:
                break
            if total > 0 and sat_total / total < 0.005:
                print("too many unsat samples; stopping diffusion")
                break
            if self.dense:
                bits, _solved, _ = self.chain(self.params, self.batch,
                                              self.generator)
            else:
                bits, _solved, _ = self.chain(self.params, self.batch,
                                              self.generator, self.plans)
            bits = bits.cpu().numpy()
            for g in range(self.graphs_per_batch):
                if self.dense:
                    row = bits[g, :self.n_vars]
                else:
                    lo = g * self.n_vars
                    row = bits[lo:lo + self.n_vars]
                total += 1
                asgn = VariableAssignment(self.n_vars, self.clauses)
                asgn.assign_all(row.astype(bool))
                if asgn.satisfiable():
                    sat_total += 1
                    k = int(asgn)
                    counts[k] = counts.get(k, 0) + 1
                    needed -= 1
                    if needed <= 0:
                        break
        self.success_rate = sat_total / max(total, 1)
        return counts

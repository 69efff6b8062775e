"""Evaluation metrics over flat and dense batches.

Counterpart of the TPU package's `train/metrics.py`, every metric of it:
each accumulates over `update_state(model_output, batch)` calls and
can log to stdout or a JSON-lines file. `model_output["prediction"]` holds
the chosen head's logits, [V] for a `SatBatch` and [G, Vg] for a
`DenseSatBatch`.
"""

from __future__ import annotations

import json
from abc import ABC, abstractmethod
from pathlib import Path
from statistics import mean, median_high

import numpy as np
import torch

from diffusionsat_torch.graph.batch import SatBatch
from diffusionsat_torch.graph.dense_batch import DenseSatBatch
from diffusionsat_torch.losses.sat import is_graph_sat
from diffusionsat_torch.ops import dense_ops


class Metric(ABC):
    """update/log contract."""

    @abstractmethod
    def update_state(self, model_output: dict,
                     batch: SatBatch | DenseSatBatch) -> None:
        ...

    @abstractmethod
    def get_values(self, reset_state: bool = True) -> dict:
        ...

    def reset_state(self) -> None:
        ...

    def log_in_stdout(self, step: int | None = None, reset_state=True):
        vals = self.get_values(reset_state)
        prefix = f"[step {step}] " if step is not None else ""
        print(prefix + " ".join(f"{k}={v:.4f}" for k, v in vals.items()))

    def log_in_file(self, file: str, step: int | None = None,
                    reset_state=True):
        vals = self.get_values(reset_state)
        rec = {"step": step, **{k: float(v) for k, v in vals.items()}}
        with Path(file).open("a") as f:
            f.write(json.dumps(rec) + "\n")


def sat_accuracy(predictions: torch.Tensor, batch: SatBatch | DenseSatBatch
                 ) -> tuple[float, np.ndarray]:
    """(per-variable accuracy vs stored solutions, per-graph solved bools
    of the real graphs). The SAT check runs on the batch's device; the
    bit comparison on the host."""
    dense = isinstance(batch, DenseSatBatch)
    node_dims = 2 if dense else 1
    logits = predictions if predictions.dim() == node_dims + 1 \
        else predictions[..., None]
    logits = logits.to(batch.device)
    logits_np = logits.detach().cpu().numpy()
    pred_bits = np.round(1.0 / (1.0 + np.exp(-logits_np)))
    sols = batch.solutions.cpu().numpy()
    var_mask = batch.var_mask.cpu().numpy()
    n_vars = max(var_mask.sum(), 1.0)
    acc = float((np.equal(pred_bits[..., 0], sols) * var_mask).sum() / n_vars)
    graph_sat = dense_ops.is_graph_sat if dense else is_graph_sat
    solved = graph_sat(logits, batch)[:, 0].cpu().numpy()
    graph_mask = batch.graph_mask.cpu().numpy() > 0
    return acc, solved[graph_mask] > 0.5


class SATAccuracy(Metric):
    """Mean per-variable accuracy + fraction of fully solved graphs."""

    def __init__(self) -> None:
        self.accs: list[float] = []
        self.solved: list[np.ndarray] = []

    def update_state(self, model_output, batch):
        acc, solved = sat_accuracy(model_output["prediction"], batch)
        self.accs.append(acc)
        self.solved.append(solved)

    def get_values(self, reset_state=True):
        accs, solved = self.accs, self.solved
        out = {
            "accuracy": float(np.mean(accs)) if accs else 0.0,
            "total_accuracy": float(np.concatenate(solved).mean())
            if solved else 0.0,
        }
        if reset_state:
            self.reset_state()
        return out

    def reset_state(self):
        self.accs, self.solved = [], []


class EmptyMetric(Metric):
    """A metric that reads nothing: the eval list of a model without one."""

    def update_state(self, model_output, batch):
        pass

    def get_values(self, reset_state=True):
        return {}


class SATAccuracySolver(Metric):
    """Solver-backed cross-check of `SATAccuracy` on flat batches: per
    graph, the formula is re-extracted from the batch, the rounded
    prediction is checked against it, and its bits are compared with a
    model the native CDCL solver finds. An independent implementation of
    the same metric, as the TPU package keeps it."""

    def __init__(self) -> None:
        self.accs: list[float] = []
        self.correct: list[int] = []

    def update_state(self, model_output, batch):
        from diffusionsat_torch.evaluation.harness import extract_formulas
        from diffusionsat_torch.sat.cnf import check_assignment
        from diffusionsat_torch.sat.solvers import solve

        logits = torch.as_tensor(
            model_output["prediction"]).detach().cpu().numpy()
        pred_bits = (1.0 / (1.0 + np.exp(-logits)) > 0.5).astype(int)
        off = 0
        for n_vars, clauses in extract_formulas(batch):
            bits = pred_bits[off:off + n_vars].tolist()
            off += n_vars
            self.correct.append(1 if check_assignment(clauses, bits) else 0)
            ok, model = solve(clauses, n_vars)
            if not ok:
                raise ValueError("a dataset instance is unsatisfiable")
            model_bits = [1 if lit > 0 else 0 for lit in model]
            eq = sum(int(a == b) for a, b in zip(bits, model_bits))
            self.accs.append(eq / max(n_vars, 1))

    def get_values(self, reset_state=True):
        out = {
            "accuracy": float(np.mean(self.accs)) if self.accs else 0.0,
            "total_accuracy": float(np.mean(self.correct))
            if self.correct else 0.0,
        }
        if reset_state:
            self.reset_state()
        return out

    def reset_state(self):
        self.accs, self.correct = [], []


class ANFAccuracy(Metric):
    """Per-variable accuracy, free-input accuracy and systems solved on ANF
    batches (reference `ANFAccuracyTF`, metrics/anf_metrics.py:5-66): a
    graph counts as solved when every equation evaluates to its target
    parity under the rounded prediction. The equation check runs on the
    batch's device (plain segment sums); the bit comparisons on the host."""

    def __init__(self) -> None:
        self.accs: list[float] = []
        self.solved: list[float] = []
        self.free_accs: list[float] = []

    def update_state(self, model_output, batch):
        from diffusionsat_torch.losses.anf import anf_value_real

        logits = model_output["prediction"]
        logits = logits[:, None] if logits.dim() == 1 else logits
        head = logits[:, 0].detach().cpu().numpy()
        sols = batch.solutions.cpu().numpy()
        var_mask = batch.var_mask.cpu().numpy()
        pred_bits = (1.0 / (1.0 + np.exp(-head)) > 0.5).astype(int)
        n = max(var_mask.sum(), 1.0)
        self.accs.append(float(((pred_bits == sols) * var_mask).sum() / n))

        # free message-bit input accuracy: the solving bottleneck of
        # input-anchored completion
        if batch.free_input_mask is not None:
            fim = batch.free_input_mask.cpu().numpy() * var_mask
            if fim.sum() > 0:
                self.free_accs.append(
                    float(((pred_bits == sols) * fim).sum() / fim.sum()))

        # clause values under the rounded prediction: bit b -> logits +-10
        hard = torch.from_numpy(
            np.where(pred_bits == 1, -10.0, 10.0).astype(np.float32))
        cv, _, _ = anf_value_real(hard[:, None].to(batch.device), batch)
        clause_ok = (cv[:, 0] > 0.5).cpu().numpy()
        clause_graph = batch.clause_graph.cpu().numpy()
        for g in np.flatnonzero(batch.graph_mask.cpu().numpy() > 0):
            idx = clause_graph == g
            if idx.any():
                self.solved.append(float(clause_ok[idx].all()))

    def get_values(self, reset_state=True):
        out = {
            "accuracy": float(np.mean(self.accs)) if self.accs else 0.0,
            "total_accuracy": float(np.mean(self.solved))
            if self.solved else 0.0,
        }
        if self.free_accs:
            out["free_input_accuracy"] = float(np.mean(self.free_accs))
        if reset_state:
            self.reset_state()
        return out

    def reset_state(self):
        self.accs, self.solved, self.free_accs = [], [], []


class StepStatistics(Metric):
    """Mean/median rounds taken."""

    def __init__(self) -> None:
        self.steps: list[int] = []

    def update_state(self, model_output, batch):
        self.steps.append(int(model_output["steps_taken"]) + 1)

    def get_values(self, reset_state=True):
        out = {
            "mean_steps": mean(self.steps) if self.steps else 0.0,
            "median_steps": median_high(self.steps) if self.steps else 0.0,
        }
        if reset_state:
            self.reset_state()
        return out

    def reset_state(self):
        self.steps = []

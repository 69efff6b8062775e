"""TensorBoard sink for scalars, histograms and hyperparameters.

Wraps `torch.utils.tensorboard` behind a no-op fallback, so training never
depends on the tensorboard package being installed. JSONL stays the
primary log; TensorBoard adds browsable curves per run directory.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping


class TBWriter:
    """Minimal scalar/histogram/hparams sink; silently no-ops when the
    tensorboard writer is unavailable."""

    def __init__(self, log_dir: str | Path):
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._w = SummaryWriter(log_dir=str(log_dir))
        except Exception:
            self._w = None

    def scalars(self, step: int, values: Mapping[str, Any]) -> None:
        if self._w is None:
            return
        for k, v in values.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self._w.add_scalar(k, float(v), global_step=step)
            elif isinstance(v, (list, tuple)) and v and \
                    all(isinstance(x, (int, float)) for x in v):
                # per-round curves (train/loop.make_diagnostics_step)
                # become one scalar tag per round index
                for i, x in enumerate(v):
                    self._w.add_scalar(f"{k}/round_{i:02d}", float(x),
                                       global_step=step)

    def histogram(self, step: int, name: str, values) -> None:
        if self._w is None:
            return
        import numpy as np
        self._w.add_histogram(name, np.asarray(values), global_step=step)

    def hparams(self, params: Mapping[str, Any]) -> None:
        """Record run hyperparameters."""
        if self._w is None:
            return
        clean = {k: (v if isinstance(v, (int, float, str, bool)) else str(v))
                 for k, v in params.items()}
        self._w.add_text("hparams", "\n".join(
            f"- **{k}**: {v}" for k, v in sorted(clean.items())))

    def flush(self) -> None:
        if self._w is not None:
            self._w.flush()

    def close(self) -> None:
        if self._w is not None:
            self._w.close()

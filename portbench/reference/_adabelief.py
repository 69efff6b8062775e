"""AdaBelief as the program's training steps apply it, in plain PyTorch.

The update of `diffusionsat_torch/train/adabelief.py` at commit ca3446b,
written leaf by leaf over a dict of named tensors: per-tensor adaptive
clipping by sqrt(sum(v) / (1 - b2^t)) * 3 + 0.01 before the moments, epsilon
folded into the belief accumulator every step, and RAdam rectification
behind an SMA threshold of 5 (shut for the first five updates, where the
step is the bias-corrected first moment). Used by the references only.
"""

from __future__ import annotations

import math

import torch


class AdaBelief:
    def __init__(self, learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 clip_multiplier=3.0, clip_epsilon=1e-2, sma_threshold=5.0):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.clip_multiplier = clip_multiplier
        self.clip_epsilon = clip_epsilon
        self.sma_threshold = sma_threshold

    def init(self, leaves: dict) -> dict:
        return {"t": 0, "m": {k: torch.zeros_like(v) for k, v in
                              leaves.items()},
                "v": {k: torch.zeros_like(v) for k, v in leaves.items()}}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, leaves: dict):
        """Returns (new leaves, new state, the gradients after clipping)."""
        b1, b2, eps = self.b1, self.b2, self.eps
        t = state["t"] + 1
        b1p, b2p = b1 ** t, b2 ** t
        sma_inf = 2.0 / (1.0 - b2) - 1.0
        sma_t = sma_inf - 2.0 * t * b2p / (1.0 - b2p)
        gate = sma_t >= self.sma_threshold
        r_t = math.sqrt((sma_t - 4.0) / (sma_inf - 4.0) * (sma_t - 2.0) /
                        (sma_inf - 2.0) * sma_inf / sma_t) if gate else 0.0
        new, m_out, v_out, taken = {}, {}, {}, {}
        for k, p in leaves.items():
            g, m, v = grads[k], state["m"][k], state["v"][k]
            clip = math.sqrt(float(v.sum()) / (1.0 - b2p)) * \
                self.clip_multiplier + self.clip_epsilon
            norm = float(torch.linalg.vector_norm(g))
            if norm > clip:
                g = g * (clip / max(norm, 1e-30))
            taken[k] = g
            m = m * b1 + g * (1 - b1)
            v = v * b2 + (g - m) ** 2 * (1 - b2) + eps
            m_corr = m / (1 - b1p)
            v_corr = torch.sqrt(v / (1 - b2p)) + eps
            step = m_corr * r_t / v_corr if gate else m_corr
            new[k] = p - self.lr * step
            m_out[k], v_out[k] = m, v
        return new, {"t": t, "m": m_out, "v": v_out}, taken

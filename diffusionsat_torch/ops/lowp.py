"""Matrix products of reduced-precision operands with f32 accumulation.

The TPU package asks its compiler for an f32 result of bf16 operands
(`preferred_element_type=float32`). `torch.matmul` of two bf16 tensors
rounds its result to bf16, so the products here upcast the operands
instead: a product of two bf16 values is exact in f32, so the f32 product
of the upcast operands is the f32-accumulated result, on the CPU and on
the card alike (TF32 is off). The operands are saved for the backward as
they came (bf16), and each gradient is computed in f32 and then cast to
its operand's type, which is what the cast's own backward would do.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def weak(value: float, like: torch.Tensor) -> float:
    """A Python constant as the TPU package's weak-typed constants meet a
    tensor: rounded to the tensor's type first. `x * 0.1` on a bf16 `x`
    multiplies by bf16(0.1) = 0.10009765625 there, and by the f32 value
    0.1 in eager PyTorch. A product of two bf16 values is exact in f32;
    where the TPU package's compiler keeps such a product in f32 (its
    excess precision: `y_f32 + 0.1 * x_bf16`), write
    `y + weak(0.1, x) * x.float()`; where it rounds it (the bf16 blend),
    `x * weak(0.2, x)`. For f32 tensors it changes nothing."""
    return _rounded(float(value), like.dtype)


class _LinearF32Acc(torch.autograd.Function):
    """x [..., K] @ w [K, N] -> f32 [..., N]."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(x.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.matmul(g, w.float().t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            x2 = x.reshape(-1, x.shape[-1]).float()
            gw = torch.matmul(x2.t(), g.reshape(-1, g.shape[-1])).to(w.dtype)
        return gx, gw


class _BmmF32Acc(torch.autograd.Function):
    """a [G, M, K] @ b [G, K, N] -> f32 [G, M, N]."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb


def linear_f32acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`x @ w` for operands of any float types, accumulated and returned in
    f32. Operands of unequal types are promoted, as the TPU package's
    product promotes them."""
    return _LinearF32Acc.apply(x, w)


def bmm_f32acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched `a @ b`, accumulated and returned in f32."""
    return _BmmF32Acc.apply(a, b)

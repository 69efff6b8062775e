"""Matrix products of bf16 operands with f32 accumulation.

The TPU package asks its compiler for an f32 result of bf16 operands
(`preferred_element_type=float32`): each product of two bf16 values is
exact in f32, and the products sum in f32. Its transpose rule multiplies
the f32 cotangent with the other bf16 operand in f32. The operands are
saved for the backward as they came (bf16), and each gradient is returned
in its operand's type, which is what the cast's own backward would do.

The route is chosen from what a call sees, and each product launched is
counted under it in the `lowp` family of `tracing.py`'s counters:

- `plain`, CPU tensors: the operands are upcast to f32 and multiplied in
  f32 (`torch.matmul` of two bf16 tensors would round its result to bf16);
  operands of unequal types are promoted, as the TPU package's product
  promotes them. This is the plain version of the two below.
- `tensor_core`, the forward on the card: both operands bf16, a bf16
  tensor-core GEMM with an f32 result (`torch.mm` / `torch.bmm` with
  `out_dtype=torch.float32`). No operand is copied.
- `split`, the backward on the card: the f32 cotangent with a bf16
  operand through `ops/split_mm.py`'s kernel, which cuts the f32 operand
  in registers into three bf16 parts that sum to it exactly and writes
  the gradient in its operand's type. Nothing is rounded below f32: no
  TF32, no bf16 cast of the cotangent.

A CUDA input that neither takes (an f32 or f16 operand in the forward)
raises; nothing falls back.
"""

from __future__ import annotations

import functools

import torch

from diffusionsat_torch import tracing
from diffusionsat_torch.ops.split_mm import split_mm

# products launched, by route
ROUTE_FAMILY = "lowp"
ROUTES = tracing.family(ROUTE_FAMILY, ("tensor_core", "split", "plain"))


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


def _on_card(*operands: torch.Tensor) -> bool:
    """False for CPU operands (the plain route); True for two bf16 CUDA
    operands; raises on anything else."""
    devices = {t.device.type for t in operands}
    if devices == {"cpu"}:
        return False
    if devices != {"cuda"}:
        raise ValueError("the f32-accumulating products run on the CPU or "
                         f"on CUDA, got operands on {sorted(devices)}")
    if any(t.dtype != torch.bfloat16 for t in operands):
        raise TypeError("on CUDA the f32-accumulating products take bf16 "
                        "operands, got "
                        f"{', '.join(str(t.dtype) for t in operands)}")
    return True


class _LinearF32Acc(torch.autograd.Function):
    """x [..., K] @ w [K, N] -> f32 [..., N]."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if not _on_card(x, w):
            ROUTES["plain"] += 1
            return torch.matmul(x.float(), w.float())
        ROUTES["tensor_core"] += 1
        out = torch.mm(x.reshape(-1, x.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if g.device.type == "cpu":
            if ctx.needs_input_grad[0]:
                ROUTES["plain"] += 1
                gx = torch.matmul(g, w.float().t()).to(x.dtype)
            if ctx.needs_input_grad[1]:
                ROUTES["plain"] += 1
                x2 = x.reshape(-1, x.shape[-1]).float()
                gw = torch.matmul(x2.t(), g.reshape(-1, g.shape[-1])
                                  ).to(w.dtype)
            return gx, gw
        g2 = g.reshape(-1, g.shape[-1])
        if ctx.needs_input_grad[0]:
            ROUTES["split"] += 1
            gx = split_mm(g2, w.t(), x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            ROUTES["split"] += 1
            gw = split_mm(x.reshape(-1, x.shape[-1]).t(), g2, w.dtype)
        return gx, gw


class _BmmF32Acc(torch.autograd.Function):
    """a [G, M, K] @ b [G, K, N] -> f32 [G, M, N]."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if not _on_card(a, b):
            ROUTES["plain"] += 1
            return torch.bmm(a.float(), b.float())
        ROUTES["tensor_core"] += 1
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if g.device.type == "cpu":
            if ctx.needs_input_grad[0]:
                ROUTES["plain"] += 1
                ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
            if ctx.needs_input_grad[1]:
                ROUTES["plain"] += 1
                gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
            return ga, gb
        if ctx.needs_input_grad[0]:
            ROUTES["split"] += 1
            ga = split_mm(g, b.transpose(1, 2), a.dtype)
        if ctx.needs_input_grad[1]:
            ROUTES["split"] += 1
            gb = split_mm(a.transpose(1, 2), g, b.dtype)
        return ga, gb


def linear_f32acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`x @ w`, accumulated and returned in f32: bf16 operands on the
    card, any float types on the CPU (unequal types promoted)."""
    return _LinearF32Acc.apply(x, w)


def bmm_f32acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched `a @ b`, accumulated and returned in f32, on the routes of
    `linear_f32acc`."""
    return _BmmF32Acc.apply(a, b)

"""Products of the lower precisions the controls compute in, emulated
exactly on any device: operands rounded to the narrower format, sums
kept in float32, as the card's TF32 and fp8 tensor-core products do."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def exact_float32() -> None:
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product of a and b rounded to float32, in float32."""
    return torch.matmul(a.float(), b.float())


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa (nearest, ties away from zero)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(tf32(a), tf32(b))


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8_e4m3fn with one scale for the whole tensor."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8Linear(torch.autograd.Function):
    """h W^T + b with every product of forward and backward on fp8
    operands."""

    @staticmethod
    def forward(ctx, h, W, b):
        ctx.save_for_backward(h, W)
        return torch.matmul(fp8(h), fp8(W).t()) + b

    @staticmethod
    def backward(ctx, g):
        h, W = ctx.saved_tensors
        gq = fp8(g)
        return (torch.matmul(gq, fp8(W)), torch.matmul(gq.t(), fp8(h)), g.sum(0))


def fp8_linear(h, W, b):
    return _Fp8Linear.apply(h, W, b)


def fp32_linear(h, W, b):
    return torch.matmul(h, W.t()) + b

"""RMS normalization (crabml primitives/rms_norm.rs semantics, batched) and
phi2's LayerNorm.

Counterpart of crabml_tpu/ops/norm.py::rms_norm and ::layer_norm: the
computation runs in float32 whatever the input dtype, and the result is cast
back."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """x * w / sqrt(mean(x^2) + eps) over the last axis, in float32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf / torch.sqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * w (+ b) over the last axis, in float32
    (var the mean of the centred squares): phi2's norm, which mean-subtracts
    as its checkpoints and llama.cpp do."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    out = xc / torch.sqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)

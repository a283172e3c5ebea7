"""RMS normalization (crabml primitives/rms_norm.rs semantics, batched) and
phi2's LayerNorm, over the last axis.

Counterpart of crabml_tpu/ops/norm.py::rms_norm and ::layer_norm: the
computation runs in float32 whatever the input dtype, and the result is cast
back. The JAX functions are plain jnp; on the card both take csrc/norm.cu
(see its note), which sums each row in one order whatever the number of
rows, so a row's norm has the same bits alone, in a batch or in a prefill
chunk. The plain versions run the tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """x * w / sqrt(mean(x^2) + eps) over the last axis, in float32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf / torch.sqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float,
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


def _norm(name: str, x: torch.Tensor, weight: torch.Tensor, eps: float, bias,
          center: bool) -> torch.Tensor:
    n = x.shape[-1]
    _build.require(x.dtype in (torch.bfloat16, torch.float32),
                   f"{name}: x {x.dtype} (bf16 or f32)")
    _build.require(weight.dim() >= 1 and tuple(weight.shape) == tuple(x.shape[x.dim()
                                                                               - weight.dim():]),
                   f"{name}: weight {tuple(weight.shape)} is not the trailing shape of x "
                   f"{tuple(x.shape)}")
    _build.require(bias is None or tuple(bias.shape) == (n,),
                   f"{name}: bias {None if bias is None else tuple(bias.shape)} for rows of {n}")
    for t in (weight, bias):
        _build.require(t is None or t.device == x.device, f"{name}: weight and bias on x's device")
    x = x.contiguous()
    w = weight.float().contiguous()
    b = None if bias is None else bias.float().contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // n if n else 0
    if rows == 0:
        return out
    lib, fn = _build.entry("norm", "row_norm", _I, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float,
                           _I, _P)
    _build.launches[name] += 1
    err = fn(int(x.dtype == torch.bfloat16), x.data_ptr(), w.data_ptr(),
             None if b is None else b.data_ptr(), out.data_ptr(), rows, n, w.numel() // n,
             float(eps), int(center), _build.stream_ptr(x))
    _build.check(lib, err, name)
    return out


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Kernel wrapper; plain version for CPU tensors. `weight` is the
    trailing shape of x: (D,), or qwen3's per-head (heads, head_dim)."""
    if not x.is_cuda:
        return rms_norm_plain(x, weight, eps)
    return _norm("rms_norm", x, weight, eps, None, False)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel wrapper; plain version for CPU tensors."""
    if not x.is_cuda:
        return layer_norm_plain(x, weight, eps, bias)
    return _norm("layer_norm", x, weight, eps, bias, True)

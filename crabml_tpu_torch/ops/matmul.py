"""Quantized matmul dispatch and the embedding gather.

Counterpart of crabml_tpu/ops/matmul.py under its headline backend `w4a8`:
Q4_K weights in kernel layout go to the CUDA matmuls (ops/cuda/gemm_quant.py
routes by row count and by whether the weight carries W8 prefill planes), and
F32/F16 weights, which the JAX package leaves to XLA's dense product, take
torch.matmul.
"""

from __future__ import annotations

import torch

from ..quant.qtensor import QTensor, dequantize
from .cuda.gemm_quant import qmatmul_q4k


def qmatmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (..., k) @ W^T -> (..., m) in x's dtype."""
    if qt.kernel_layout:
        return qmatmul_q4k(x, qt)
    return torch.matmul(x, dequantize(qt, x.dtype).t())


def embedding_lookup(qt: QTensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Gather the token rows of the packed planes, then dequantize only them
    (tokens (B, T) -> (B, T, k))."""
    flat = tokens.reshape(-1)
    rows = QTensor(qt.kind, (flat.numel(), qt.k),
                   {n: p.index_select(0, flat) for n, p in qt.planes.items()})
    return dequantize(rows, dtype).reshape(*tokens.shape, qt.k)

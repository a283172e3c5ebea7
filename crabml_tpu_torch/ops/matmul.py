"""Quantized matmul dispatch and the embedding gather.

Counterpart of crabml_tpu/ops/matmul.py under its headline backend `w4a8`:
Q4_K, Q5_K, Q6_K, Q8_0, Q4_0, Q3_K, Q2_K, Q5_0, Q4_1, Q5_1 and Q8_1 weights
in kernel layout go to the CUDA matmuls (ops/cuda/gemm_quant.py routes by row
count, by scheme and by whether the weight carries W8 prefill planes), and
F32/F16 weights, which the JAX package leaves to XLA's dense product, take
torch.matmul. Dispatch is per weight, so the mixed kinds of a llama.cpp _K_M,
Q2_K or imatrix Q4_0 / Q5_0 file need nothing here.
"""

from __future__ import annotations

import torch

from ..quant.qtensor import QTensor, dequantize
from .cuda.gemm_quant import qmatmul_quant


def qmatmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (..., k) @ W^T -> (..., m) in x's dtype."""
    if qt.kernel_layout:
        return qmatmul_quant(x, qt)
    return dense_matmul(x, qt)


def dense_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The one product that takes no kernel of the port: torch.matmul on the
    dequantized weight (F32 and F16 weights, and expert stacks without
    kernel planes in models/forward.py's moe_ffn_plain; a quantized one only
    if it was left in canonical planes, which no loader does). x (..., k)
    against W (m, k) -> (..., m); x (R, k) or (E, R, k) against a stack
    (E, m, k) -> (E, R, m)."""
    return torch.matmul(x, dequantize(qt, x.dtype).transpose(-1, -2))


def embedding_lookup(qt: QTensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Gather the token rows of the packed planes, then dequantize only them
    (tokens (B, T) -> (B, T, k))."""
    flat = tokens.reshape(-1)
    rows = QTensor(qt.kind, (flat.numel(), qt.k),
                   {n: p.index_select(0, flat) for n, p in qt.planes.items()})
    return dequantize(rows, dtype).reshape(*tokens.shape, qt.k)

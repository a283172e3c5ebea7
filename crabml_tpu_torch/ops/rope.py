"""Rotary position embeddings, llama (interleaved) and neox (split) modes.

Counterpart of crabml_tpu/ops/rope.py, with ggml's pairing and frequency
semantics: llama mode rotates adjacent pairs (2i, 2i+1), neox mode rotates
(i, i + rope_dim/2) within the first rope_dim dims, theta_i = pos *
base^(-2i/rope_dim), and a tail beyond rope_dim passes through. Angles and
the rotation are computed in float32 and cast back. The rope scalings
(linear, llama3.1 rope_freqs, YaRN) are not ported yet: the Runner refuses
models that use them.

The forward computes the angles once per call (`rope_angles`) and rotates
every layer's q and k with them (`rotate`). The frequencies are computed once
per (rope_dim, base, device) and kept, so a captured decode step allocates
and copies nothing for them.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def inv_freq(rope_dim: int, base: float, device: torch.device) -> torch.Tensor:
    """base^(-2i/rope_dim) for i < rope_dim/2, float32 on `device`, computed
    there (the same bits as before it was kept)."""
    i = torch.arange(rope_dim // 2, dtype=torch.float32, device=device)
    return torch.tensor(base, dtype=torch.float32) ** (-2.0 * i / rope_dim)


def rope_angles(positions: torch.Tensor, rope_dim: int, base: float = 10000.0):
    """(B, T) positions -> cos, sin of shape (B, T, 1, rope_dim//2), float32."""
    theta = positions.float()[..., None] * inv_freq(rope_dim, float(base), positions.device)
    return torch.cos(theta)[:, :, None], torch.sin(theta)[:, :, None]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, mode: str) -> torch.Tensor:
    """x (B, T, H, head_dim) rotated by the angles of `rope_angles`."""
    rope_dim = 2 * cos.shape[-1]
    xf = x.float()
    if mode == "llama":
        xr = xf[..., :rope_dim].reshape(*xf.shape[:-1], rope_dim // 2, 2)
        x0, x1 = xr[..., 0], xr[..., 1]
        rot = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
        rot = rot.reshape(*xf.shape[:-1], rope_dim)
    elif mode == "neox":
        half = rope_dim // 2
        x0, x1 = xf[..., :half], xf[..., half:rope_dim]
        rot = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    else:
        raise ValueError(f"unknown rope mode {mode!r}")
    if rope_dim < x.shape[-1]:
        rot = torch.cat([rot, xf[..., rope_dim:]], dim=-1)
    return rot.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, rope_dim: int, mode: str,
               base: float = 10000.0) -> torch.Tensor:
    """x: (B, T, H, head_dim); positions: (B, T) absolute positions."""
    return rotate(x, *rope_angles(positions, rope_dim, base), mode)

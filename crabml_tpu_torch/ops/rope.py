"""Rotary position embeddings, llama (interleaved) and neox (split) modes,
with the rope scalings of the GGUF families.

Counterpart of crabml_tpu/ops/rope.py, with ggml's pairing and frequency
semantics: llama mode rotates adjacent pairs (2i, 2i+1), neox mode rotates
(i, i + rope_dim/2) within the first rope_dim dims, theta_i = pos *
base^(-2i/rope_dim), and a tail beyond rope_dim passes through. Angles and
the rotation are computed in float32 and cast back. The scalings:

- per-frequency divisors of base^(-2i/rope_dim): llama3.1's
  `rope_freqs.weight` tensor, or YaRN's NTK-by-parts blend
  (`yarn_freq_factors`), which models.weights synthesizes at load;
- a position scale, 1/factor for "linear" scaling;
- YaRN's magnitude `mscale` (`yarn_mscale`), which multiplies cos and sin.

The forward computes the angles once per call (`rope_angles`) and rotates
every layer's q and k with them (`rotate`). The frequencies are computed
once per model and kept: models.weights.load_weights stores them, divided
where the model has divisors, with the weights (`rope_inv_freq`). So a
captured decode step reads them from the device and allocates and copies
nothing for them.
"""

from __future__ import annotations

import numpy as np
import torch


def inv_freq(rope_dim: int, base: float, device: torch.device) -> torch.Tensor:
    """base^(-2i/rope_dim) for i < rope_dim/2, float32 on `device`, computed
    there."""
    i = torch.arange(rope_dim // 2, dtype=torch.float32, device=device)
    return torch.tensor(base, dtype=torch.float32) ** (-2.0 * i / rope_dim)


def scaled_inv_freq(rope_dim: int, base: float, freq_factors: torch.Tensor | None,
                    device) -> torch.Tensor:
    """inv_freq divided by the per-frequency divisors `freq_factors`
    (rope_dim/2,) where a model has them, in float32 on `device`."""
    inv = inv_freq(rope_dim, float(base), torch.device(device))
    if freq_factors is None:
        return inv
    return inv / freq_factors.to(device=inv.device, dtype=torch.float32)


def rope_angles(positions: torch.Tensor, inv: torch.Tensor, pos_scale: float = 1.0,
                mscale: float = 1.0):
    """(B, T) positions and the frequencies `inv` (rope_dim/2,) -> cos, sin of
    shape (B, T, 1, rope_dim//2), float32: theta = (pos * pos_scale) * inv,
    and both times `mscale` where it is not 1."""
    pos = positions.float()
    if pos_scale != 1.0:
        pos = pos * pos_scale
    theta = pos[..., None] * inv
    cos, sin = torch.cos(theta), torch.sin(theta)
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    return cos[:, :, None], sin[:, :, None]


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
               base: float = 10000.0, freq_factors: torch.Tensor | None = None,
               pos_scale: float = 1.0, mscale: float = 1.0) -> torch.Tensor:
    """x: (B, T, H, head_dim); positions: (B, T) absolute positions; the
    scalings as crabml_tpu/ops/rope.py::apply_rope takes them."""
    inv = scaled_inv_freq(rope_dim, base, freq_factors, positions.device)
    return rotate(x, *rope_angles(positions, inv, pos_scale, mscale), mode)


def yarn_freq_factors(rope_dim: int, base: float, factor: float, orig_ctx: int,
                      beta_fast: float = 32.0, beta_slow: float = 1.0) -> np.ndarray:
    """YaRN's NTK-by-parts interpolation as per-frequency divisors
    (rope_dim/2,) float32, computed once at load (llama.cpp's rope_yarn
    corr_dims): the frequencies that turn many times inside the original
    context keep their value (divisor 1), the slow ones are divided by
    `factor`, and a linear ramp over the pair index between the beta_fast and
    beta_slow correction dims blends the two frequencies linearly, so the
    divisor is the reciprocal of that blend."""
    def corr_dim(n_rot):
        return rope_dim * np.log(orig_ctx / (n_rot * 2 * np.pi)) / (2 * np.log(base))

    low = max(np.floor(corr_dim(beta_fast)), 0.0)
    high = min(np.ceil(corr_dim(beta_slow)), rope_dim - 1.0)
    pair = np.arange(rope_dim // 2, dtype=np.float32)
    ramp = np.clip((pair - low) / max(high - low, 1e-3), 0.0, 1.0)
    return (1.0 / ((1.0 - ramp) + ramp / factor)).astype(np.float32)


def yarn_mscale(factor: float, attn_factor: float = 1.0) -> float:
    """YaRN's attention magnitude: attn_factor * (1 + 0.1 ln(factor))."""
    if factor <= 1.0:
        return float(attn_factor)
    return float(attn_factor * (1.0 + 0.1 * np.log(factor)))

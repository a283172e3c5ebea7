"""RMS normalization (crabml primitives/rms_norm.rs semantics, batched) and
phi2's LayerNorm.

Counterpart of crabml_tpu/ops/norm.py::rms_norm and ::layer_norm: the
computation runs in float32 whatever the input dtype, and the result is cast
back. On the card both take the kernel of csrc/norm.cu; the wrappers and
their plain versions are in ops/cuda/norm.py."""

from __future__ import annotations

from .cuda.norm import layer_norm, rms_norm

__all__ = ["layer_norm", "rms_norm"]

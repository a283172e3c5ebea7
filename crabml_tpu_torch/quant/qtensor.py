"""Torch weight planes: the port's counterpart of quant/planar.py and
quant/jnp_dequant.py in the JAX package.

A `QTensor` holds one (m, k) weight, or a stack (E, m, k) of a layer's
experts with a leading expert axis on every plane, as named torch planes:

- F32 / F16: a dense `w` plane.
- Q4_K, canonical planes (`to_planar`), the same names and contents as the
  JAX package's planar layout: `qs` u8 (m, k/2) in ggml nibble order (per
  64-element chunk, byte j holds element j in its low nibble and j+32 in its
  high nibble), `sc`, `mn` u8 (m, k/32) (the 6-bit get_scale_min_k4 fields),
  `d`, `dmin` f32 (m, k/256).
- Q4_K, kernel planes (`to_kernel_layout`): `qs` unchanged, with the
  superblock scales folded into `dsub = d*sc` and `msub = -dmin*mn`, one per
  32 elements, so w = val*dsub + msub. Rows stay in natural order: the CUDA
  kernels index them directly.
- W8 prefill planes, optional beside the kernel planes (attached by
  ops/cuda/gemm_quant.py::augment_w8): `w8` i8 (m, kpad8), k contiguous and
  zero-padded to a multiple of 512, and `dw` f32 (m, kpad8/512), one scale per
  (row, 512-chunk).

`dequantize` is the plain torch dequant, bit-exact in float32 against
quant/codecs.py::dequantize. Every function here runs on whatever device its
tensors lie on; loading a 7B file repacks on the card this way.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..errors import UnsupportedError
from ..gguf.constants import GGMLType, GGML_BLOCK_SIZES, QK_K


@dataclass
class QTensor:
    """A quantized (or dense) weight as torch planes; `shape` is the logical
    row-major dense shape, (m, k) or (E, m, k) for stacked experts."""

    kind: GGMLType
    shape: tuple[int, ...]
    planes: dict[str, torch.Tensor] = field(default_factory=dict)

    @property
    def m(self) -> int:
        return self.shape[-2]

    @property
    def k(self) -> int:
        return self.shape[-1]

    @property
    def stacked(self) -> bool:
        return len(self.shape) == 3

    @property
    def kernel_layout(self) -> bool:
        return "dsub" in self.planes


def _u8(raw, device) -> torch.Tensor:
    """Packed payload (numpy view of the file or bytes) -> u8 tensor."""
    a = np.frombuffer(raw, np.uint8) if isinstance(raw, (bytes, bytearray)) else raw
    return torch.from_numpy(np.array(a, dtype=np.uint8).reshape(-1)).to(device)


def _k4_scale_min(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """get_scale_min_k4 for all 8 sub-blocks: (nb, 12) u8 -> (nb, 8), (nb, 8)."""
    sc = torch.cat([q[:, 0:4] & 63, (q[:, 8:12] & 0xF) | ((q[:, 0:4] >> 6) << 4)], 1)
    mn = torch.cat([q[:, 4:8] & 63, (q[:, 8:12] >> 4) | ((q[:, 4:8] >> 6) << 4)], 1)
    return sc, mn


def to_planar(typ: GGMLType, raw, shape, device="cpu") -> QTensor:
    """Packed ggml payload -> canonical planes on `device`. A 3-D shape
    (E, m, k), the GGUF form of a layer's experts, gives a stacked QTensor."""
    m = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    k = int(shape[-1])
    if typ in (GGMLType.F32, GGMLType.F16):
        dt = torch.float32 if typ == GGMLType.F32 else torch.float16
        planes = {"w": _u8(raw, device).view(dt).reshape(m, k)}
    elif typ == GGMLType.Q4_K:
        b = _u8(raw, device).reshape(-1, GGML_BLOCK_SIZES[typ][1])  # (nb, 144)
        dd = b[:, 0:4].contiguous().view(torch.float16).float()  # (nb, 2): d, dmin
        sc, mn = _k4_scale_min(b[:, 4:16])
        planes = {
            "qs": b[:, 16:144].reshape(m, k // 2),
            "sc": sc.reshape(m, k // 32),
            "mn": mn.reshape(m, k // 32),
            "d": dd[:, 0].reshape(m, k // QK_K).contiguous(),
            "dmin": dd[:, 1].reshape(m, k // QK_K).contiguous(),
        }
    else:
        raise UnsupportedError(
            f"{typ.name} weights: this port handles F32, F16 and Q4_K")
    if len(shape) != 3:
        return QTensor(typ, (m, k), planes)
    E = int(shape[0])
    return QTensor(typ, (E, m // E, k),
                   {n: p.reshape(E, m // E, p.shape[-1]) for n, p in planes.items()})


def nibbles(qs: torch.Tensor) -> torch.Tensor:
    """(..., m, k/2) u8 in 64-chunk nibble order -> (..., m, k) values 0..15 (u8)."""
    lead = qs.shape[:-1]
    q = qs.reshape(*lead, -1, 32)
    return torch.cat([q & 0xF, q >> 4], dim=-1).reshape(*lead, -1)


def _folded_scales(qt: QTensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dsub, -msub) in float32 from canonical planes: d*sc and dmin*mn."""
    p = qt.planes
    dl = p["d"].repeat_interleave(8, dim=-1) * p["sc"].float()
    ml = p["dmin"].repeat_interleave(8, dim=-1) * p["mn"].float()
    return dl, ml


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Planes -> dense `qt.shape` in `dtype`, computed in float32."""
    p = qt.planes
    if "w" in p:
        return p["w"].to(dtype)
    q = nibbles(p["qs"]).float().reshape(*qt.shape[:-1], qt.k // 32, 32)
    if qt.kernel_layout:
        w = q * p["dsub"].float()[..., None] + p["msub"].float()[..., None]
    else:
        dl, ml = _folded_scales(qt)
        w = q * dl[..., None] - ml[..., None]
    return w.reshape(qt.shape).to(dtype)


def to_kernel_layout(qt: QTensor, scale_dtype=torch.float32) -> QTensor:
    """Canonical Q4_K planes -> kernel planes {qs, dsub, msub}; other kinds
    are returned as they are (they take the dense matmul)."""
    if qt.kind != GGMLType.Q4_K or qt.kernel_layout:
        return qt
    dl, ml = _folded_scales(qt)
    return QTensor(qt.kind, qt.shape, {
        "qs": qt.planes["qs"].contiguous(),
        "dsub": dl.to(scale_dtype),
        "msub": (-ml).to(scale_dtype),
    })


def cat_rows(qts: list[QTensor]) -> QTensor:
    """Concatenate QTensors of one kind along m (load-time q|k|v and gate|up
    fusion; stacked experts fuse expert by expert)."""
    planes = {n: torch.cat([q.planes[n] for q in qts], -2) for n in qts[0].planes}
    shape = (*qts[0].shape[:-2], sum(q.m for q in qts), qts[0].k)
    return QTensor(qts[0].kind, shape, planes)


def plane_of(qt: QTensor, e: int) -> QTensor:
    """Expert `e` of a stacked QTensor as a 2-D one (views, no copy)."""
    return QTensor(qt.kind, qt.shape[1:], {n: p[e] for n, p in qt.planes.items()})

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
- Q8_0, canonical planes: `qs` i8 (m, k) and `d` f32 (m, k/32); kernel
  planes `qs` unchanged and `dsub` = d, one per 32, so w = qs*dsub.
- Q6_K, canonical planes: `ql` u8 (m, k/2) and `qh` u8 (m, k/4) in ggml
  order, `sc` i8 (m, k/16), `d` f32 (m, k/256); kernel planes `ql`, `qh`
  unchanged and `dsub` = d*sc, one per 16, so w = (val - 32)*dsub. The bit
  order is per 128-element half, not per 64-element chunk: byte j of the
  half's 64 `ql` bytes holds element j in its low nibble and j + 64 in its
  high nibble, and bits 2s, 2s + 1 of byte j of its 32 `qh` bytes are the
  top two bits of element 32s + j (`q6k_values`).
- Q5_K, canonical planes: Q4_K's (`qs` in the same per-64 nibble order,
  `sc`, `mn`, `d`, `dmin`) and `qh` u8 (m, k/8) in ggml order: bit b of
  byte l of a superblock's 32 `qh` bytes is the top bit of element 32b + l
  (`q5k_values`). Kernel planes `qs`, `qh` unchanged and Q4_K's `dsub` =
  d*sc, `msub` = -dmin*mn, one per 32, so w = val*dsub + msub, val 0..31.
- Q4_0, canonical planes: `qs` u8 (m, k/2) in ggml's per-32 order (byte j of
  a 32-element block holds element j in its low nibble and j + 16 in its
  high nibble) and `d` f32 (m, k/32). Kernel planes: `qs` reordered at load
  into Q4_K's per-64 order (byte j of a 64-element chunk holds element j low
  and j + 32 high), so both CUDA kernels unpack it as they unpack Q4_K, and
  `dsub` = d, one per 32, so w = (val - 8)*dsub.
- Q4_1, canonical planes: Q4_0's `qs` and `d`, and `mn` f32 (m, k/32), the
  block's float minimum m, so w = val*d + m. Kernel planes: Q4_K's, `qs`
  reordered into the per-64 order as Q4_0's, `dsub` = d and `msub` = m, so
  both CUDA kernels run it as Q4_K (the same function: val*dsub + msub).
- Q5_0, canonical planes: `qs` and `d` as Q4_0's and `qh` u8 (m, k/8), each
  block's little-endian u32 of fifth bits (bit j of the k-long bit string is
  the top bit of element j). Kernel planes: `qs` in the per-64 order, `qh`
  moved into Q5_K's per-superblock order (`qh_to_q5k_order`) and `dsub` = d,
  so w = (val - 16)*dsub, val 0..31.
- Q5_1, canonical planes: Q5_0's and `mn`; kernel planes Q5_K's (`qs`,
  `qh`, `dsub` = d, `msub` = m), so both kernels run it as Q5_K.
- Q8_1, canonical planes: Q8_0's (`qs` i8 after ggml's d and s, `d`; the
  block sum s is not needed); kernel planes Q8_0's, and Q8_0's kernels.
- Q2_K, canonical planes: `qs` u8 (m, k/4), the 2-bit values in Q6_K's
  `qh` order (bits 2s, 2s + 1 of byte j of a 128-element half's 32 bytes are
  element 32s + j, `q2_values`), `sc`, `mn` u8 (m, k/16) (the two 4-bit
  fields of ggml's scale byte), `d`, `dmin` f32 (m, k/256). Kernel planes:
  `qs` unchanged, `scm` u8 (m, k/16), ggml's own byte (sc in the low nibble,
  mn in the high one), and `d`, `dmin` f32 unchanged: the kernels form the
  group scale d*sc and minimum -dmin*mn in float32, exactly (an f16 value
  times a 4-bit one), so w = val*dsub + msub, val 0..3.
- Q3_K, canonical planes: `qs` u8 (m, k/4) in Q2_K's order, `hb` u8 (m, k/8)
  in Q5_K's `qh` order (bit b of byte l of a superblock's 32 bytes is the
  third bit of element 32b + l, `q3k_values`), `sc` i8 (m, k/16) with ggml's
  -32 applied, `d` f32 (m, k/256). The kernel planes are these planes as
  they are: w = (val - 4)*d*sc, val 0..7, the scale formed in float32.
- Rows that are not whole 256-element superblocks (a legacy kind's k is any
  multiple of 32: stories15M's 288 and 768): the kernel
  planes of Q8_0, Q8_1, Q4_0, Q4_1, Q5_0 and Q5_1 are zero-padded to
  `kernel_k(k)`, the next multiple of 256, with zero values and zero scales
  and minima, so the padded tail adds nothing to a product (the JAX
  package's `repack` rule). The QTensor keeps its logical shape; `plane_k`
  reads the planes' depth, and `dequantize` drops the tail.
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
import torch.nn.functional as F

from ..errors import UnsupportedError
from ..gguf.constants import GGMLType, GGML_BLOCK_SIZES, QK_K


# the kinds that have kernel planes and CUDA matmuls
KERNEL_KINDS = (GGMLType.Q4_K, GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q5_K, GGMLType.Q4_0,
                GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q5_0, GGMLType.Q4_1, GGMLType.Q5_1,
                GGMLType.Q8_1)
# the kind whose kernel planes and CUDA forms each kind runs: Q4_1, Q5_1 and
# Q8_1 have exactly Q4_K's, Q5_K's and Q8_0's planes in kernel layout, and
# those forms compute exactly their functions
FORM_KIND = {k: k for k in KERNEL_KINDS} | {GGMLType.Q4_1: GGMLType.Q4_K,
                                            GGMLType.Q5_1: GGMLType.Q5_K,
                                            GGMLType.Q8_1: GGMLType.Q8_0}
# ggml's 32-element blocks of nibbles (Q5's with a fifth-bit word): their
# per-32 orders are reordered at load, and their offsets (or float minimum m)
LEGACY_KINDS = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1)
_LEGACY_OFFSET = {GGMLType.Q4_0: 8, GGMLType.Q5_0: 16}
# the kinds of 32-element blocks, whose rows may end inside a superblock: their
# kernel planes are zero-padded to kernel_k(k)
PADDED_KINDS = (GGMLType.Q8_0, GGMLType.Q8_1, *LEGACY_KINDS)


def kernel_k(k: int) -> int:
    """The depth of a weight's kernel planes: k rounded up to whole 256-element
    superblocks (the k step of every CUDA matmul)."""
    return -(-k // QK_K) * QK_K


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
    def plane_k(self) -> int:
        """The depth the planes hold: `kernel_k(k)` for kernel planes of a
        PADDED_KINDS weight (zero-padded), else k."""
        if self.kind in PADDED_KINDS and "dsub" in self.planes:
            return self.planes["dsub"].shape[-1] * 32
        return self.k

    @property
    def kernel_layout(self) -> bool:
        """Whether the planes are the CUDA kernels' (Q3_K's canonical planes are)."""
        return "dsub" in self.planes or "scm" in self.planes or self.kind == GGMLType.Q3_K


def _u8(raw, device) -> torch.Tensor:
    """Packed payload (numpy view of the file or bytes) -> u8 tensor."""
    a = np.frombuffer(raw, np.uint8) if isinstance(raw, (bytes, bytearray)) else raw
    return torch.from_numpy(np.array(a, dtype=np.uint8).reshape(-1)).to(device)


def _k4_scale_min(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """get_scale_min_k4 for all 8 sub-blocks: (nb, 12) u8 -> (nb, 8), (nb, 8)."""
    sc = torch.cat([q[:, 0:4] & 63, (q[:, 8:12] & 0xF) | ((q[:, 0:4] >> 6) << 4)], 1)
    mn = torch.cat([q[:, 4:8] & 63, (q[:, 8:12] >> 4) | ((q[:, 4:8] >> 6) << 4)], 1)
    return sc, mn


def _q3k_scales(s: torch.Tensor) -> torch.Tensor:
    """Q3_K's 12-byte scale field (nb, 12) u8 -> its 16 6-bit scales less 32,
    (nb, 16) i8: scale j takes its low four bits from byte j (j < 8) or the
    high nibble of byte j - 8, and its top two from bits 2 (j // 4) of byte
    8 + j % 4 (quant/codecs.py::_q3k_scales)."""
    lo = torch.cat([s[:, 0:8] & 0xF, s[:, 0:8] >> 4], 1)
    hi = torch.cat([(s[:, 8:12] >> sh) & 3 for sh in (0, 2, 4, 6)], 1)
    return ((lo | (hi << 4)).to(torch.int16) - 32).to(torch.int8)


def to_planar(typ: GGMLType, raw, shape, device="cpu") -> QTensor:
    """Packed ggml payload -> canonical planes on `device`. A 3-D shape
    (E, m, k), the GGUF form of a layer's experts, gives a stacked QTensor."""
    m = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    k = int(shape[-1])
    if typ in (GGMLType.F32, GGMLType.F16):
        dt = torch.float32 if typ == GGMLType.F32 else torch.float16
        planes = {"w": _u8(raw, device).view(dt).reshape(m, k)}
    elif typ in (GGMLType.Q8_0, GGMLType.Q8_1):
        b = _u8(raw, device).reshape(-1, GGML_BLOCK_SIZES[typ][1])  # (nb, 34) or (nb, 36)
        planes = {
            "qs": b[:, -32:].contiguous().view(torch.int8).reshape(m, k),
            "d": b[:, 0:2].contiguous().view(torch.float16).float().reshape(m, k // 32),
        }
    elif typ == GGMLType.Q6_K:
        b = _u8(raw, device).reshape(-1, GGML_BLOCK_SIZES[typ][1])  # (nb, 210)
        planes = {
            "ql": b[:, 0:128].reshape(m, k // 2),
            "qh": b[:, 128:192].reshape(m, k // 4),
            "sc": b[:, 192:208].contiguous().view(torch.int8).reshape(m, k // 16),
            "d": b[:, 208:210].contiguous().view(torch.float16).float().reshape(m, k // QK_K),
        }
    elif typ in LEGACY_KINDS:
        b = _u8(raw, device).reshape(-1, GGML_BLOCK_SIZES[typ][1])  # (nb, 18 / 20 / 22 / 24)
        planes = {"qs": b[:, -16:].reshape(m, k // 2),
                  "d": b[:, 0:2].contiguous().view(torch.float16).float().reshape(m, k // 32)}
        if typ in (GGMLType.Q4_1, GGMLType.Q5_1):  # the float minimum m follows d
            planes["mn"] = b[:, 2:4].contiguous().view(torch.float16).float().reshape(m, k // 32)
        if typ in (GGMLType.Q5_0, GGMLType.Q5_1):  # the four qh bytes precede the nibbles
            planes["qh"] = b[:, -20:-16].reshape(m, k // 8)
    elif typ in (GGMLType.Q2_K, GGMLType.Q3_K) and k % QK_K:
        raise UnsupportedError(
            f"{typ.name} weight of shape {tuple(shape)}: rows of 256-element superblocks only")
    elif typ == GGMLType.Q2_K:
        b = _u8(raw, device).reshape(-1, GGML_BLOCK_SIZES[typ][1])  # (nb, 84)
        dd = b[:, 80:84].contiguous().view(torch.float16).float()  # (nb, 2): d, dmin
        planes = {
            "qs": b[:, 16:80].reshape(m, k // 4),
            "sc": (b[:, 0:16] & 0xF).reshape(m, k // 16),
            "mn": (b[:, 0:16] >> 4).reshape(m, k // 16),
            "d": dd[:, 0].reshape(m, k // QK_K).contiguous(),
            "dmin": dd[:, 1].reshape(m, k // QK_K).contiguous(),
        }
    elif typ == GGMLType.Q3_K:
        b = _u8(raw, device).reshape(-1, GGML_BLOCK_SIZES[typ][1])  # (nb, 110)
        planes = {
            "qs": b[:, 32:96].reshape(m, k // 4),
            "hb": b[:, 0:32].reshape(m, k // 8),
            "sc": _q3k_scales(b[:, 96:108]).reshape(m, k // 16),
            "d": b[:, 108:110].contiguous().view(torch.float16).float().reshape(m, k // QK_K),
        }
    elif typ in (GGMLType.Q4_K, GGMLType.Q5_K):
        b = _u8(raw, device).reshape(-1, GGML_BLOCK_SIZES[typ][1])  # (nb, 144) or (nb, 176)
        dd = b[:, 0:4].contiguous().view(torch.float16).float()  # (nb, 2): d, dmin
        sc, mn = _k4_scale_min(b[:, 4:16])
        planes = {
            "qs": b[:, -128:].reshape(m, k // 2),
            "sc": sc.reshape(m, k // 32),
            "mn": mn.reshape(m, k // 32),
            "d": dd[:, 0].reshape(m, k // QK_K).contiguous(),
            "dmin": dd[:, 1].reshape(m, k // QK_K).contiguous(),
        }
        if typ == GGMLType.Q5_K:
            planes["qh"] = b[:, 16:48].reshape(m, k // 8)
    else:
        raise UnsupportedError(
            f"{typ.name} weights: this port handles F32, F16, Q8_0, Q8_1, Q4_0, Q4_1, Q5_0, Q5_1, "
            "Q2_K, Q3_K, Q4_K, Q5_K and Q6_K")
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


def _bit_plane(qh: torch.Tensor) -> torch.Tensor:
    """(..., m, k/8) u8 in ggml's Q5_K qh order (bit b of byte l of a
    superblock's 32 bytes belongs to element 32b + l) -> (..., m, k) bits."""
    lead = qh.shape[:-1]
    h = qh.reshape(*lead, -1, 1, 32)
    return torch.cat([(h >> b) & 1 for b in range(8)], dim=-2).reshape(*lead, -1)


def q5k_values(qs: torch.Tensor, qh: torch.Tensor) -> torch.Tensor:
    """(..., m, k/2) qs in 64-chunk nibble order and (..., m, k/8) qh in
    ggml's Q5_K order -> (..., m, k) values 0..31 (u8)."""
    return nibbles(qs) | (_bit_plane(qh) << 4)


def q2_values(qs: torch.Tensor) -> torch.Tensor:
    """(..., m, k/4) u8 in ggml's 2-bit order (byte l of a 128-element half's
    32 bytes holds elements l, l + 32, l + 64, l + 96 at shifts 0, 2, 4, 6:
    Q2_K's and Q3_K's qs, Q6_K's qh) -> (..., m, k) values 0..3 (u8)."""
    lead = qs.shape[:-1]
    q = qs.reshape(*lead, -1, 1, 32)
    return torch.cat([(q >> s) & 3 for s in (0, 2, 4, 6)], dim=-2).reshape(*lead, -1)


def q3k_values(qs: torch.Tensor, hb: torch.Tensor) -> torch.Tensor:
    """(..., m, k/4) qs in the 2-bit order and (..., m, k/8) hb in the Q5_K
    qh order -> (..., m, k) values 0..7 (u8), 4 above the signed weight."""
    return q2_values(qs) | (_bit_plane(hb) << 2)


def q4_0_values(qs: torch.Tensor) -> torch.Tensor:
    """(..., m, k/2) qs in ggml's per-32 Q4_0 order -> (..., m, k) values
    0..15 (u8), 8 above the signed weight."""
    lead = qs.shape[:-1]
    q = qs.reshape(*lead, -1, 16)
    return torch.cat([q & 0xF, q >> 4], dim=-1).reshape(*lead, -1)


def _le_bits(qh: torch.Tensor) -> torch.Tensor:
    """(..., m, k/8) u8, a little-endian bit string (Q5_0's and Q5_1's qh:
    bit j of byte i is element 8i + j) -> (..., m, k) bits."""
    lead = qh.shape[:-1]
    return torch.stack([(qh >> b) & 1 for b in range(8)], dim=-1).reshape(*lead, -1)


def q5_0_values(qs: torch.Tensor, qh: torch.Tensor) -> torch.Tensor:
    """(..., m, k/2) qs in ggml's per-32 order and (..., m, k/8) qh as ggml
    keeps it (Q5_0 and Q5_1) -> (..., m, k) values 0..31 (u8); Q5_0's are 16
    above the signed weight."""
    return q4_0_values(qs) | (_le_bits(qh) << 4)


def qh_to_q5k_order(qh: torch.Tensor) -> torch.Tensor:
    """Q5_0's / Q5_1's (..., m, k/8) qh (a little-endian bit string) ->
    the same bits in Q5_K's per-superblock order (bit b of byte l of a
    superblock's 32 bytes is element 32b + l), the inverse of `_bit_plane`;
    k % 256 == 0."""
    lead = qh.shape[:-1]
    bits = _le_bits(qh).reshape(*lead, -1, 8, 32)  # (.., superblock, b, l)
    out = torch.zeros(*lead, bits.shape[-3], 32, dtype=torch.uint8, device=qh.device)
    for b in range(8):
        out |= bits[..., b, :] << b
    return out.reshape(*lead, -1)


def nibble_pack(vals: torch.Tensor) -> torch.Tensor:
    """(..., m, k) values 0..15 -> (..., m, k/2) u8 in 64-chunk nibble
    order, the inverse of `nibbles`."""
    lead = vals.shape[:-1]
    v = vals.to(torch.uint8).reshape(*lead, -1, 2, 32)
    return (v[..., 0, :] | (v[..., 1, :] << 4)).reshape(*lead, -1)


def q6k_values(ql: torch.Tensor, qh: torch.Tensor) -> torch.Tensor:
    """(..., m, k/2) ql and (..., m, k/4) qh in ggml's Q6_K order -> (..., m, k)
    values 0..63 (u8), 32 above the signed weight."""
    lead = ql.shape[:-1]
    lo = ql.reshape(*lead, -1, 1, 64)
    lo = torch.cat([lo & 0xF, lo >> 4], dim=-2).reshape(*lead, -1)  # per half: 2 x 64
    return lo | (q2_values(qh) << 4)


def _folded_scales(qt: QTensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dsub, -msub) in float32 from canonical planes: d*sc and dmin*mn."""
    p = qt.planes
    dl = p["d"].repeat_interleave(8, dim=-1) * p["sc"].float()
    ml = p["dmin"].repeat_interleave(8, dim=-1) * p["mn"].float()
    return dl, ml


def _dsub(qt: QTensor, per: int) -> torch.Tensor:
    """The float32 scale of every `per`-element group: dsub as stored in
    kernel planes, else folded from the canonical d (times sc for Q6_K)."""
    p = qt.planes
    if qt.kernel_layout:
        return p["dsub"].float()
    if "sc" not in p:
        return p["d"]
    return p["d"].repeat_interleave(QK_K // per, dim=-1) * p["sc"].float()


def k16_scales(kind: GGMLType, p: dict) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Q2_K / Q3_K, canonical or kernel planes `p` -> (dsub, msub) in float32,
    one per 16 elements: d*sc and -dmin*mn for Q2_K, d*sc and None for Q3_K
    (its offset is the caller's). Both products are exact."""
    d = p["d"].repeat_interleave(QK_K // 16, dim=-1)
    if kind == GGMLType.Q3_K:
        return d * p["sc"].float(), None
    sc, mn = (p["scm"] & 0xF, p["scm"] >> 4) if "scm" in p else (p["sc"], p["mn"])
    return d * sc.float(), -(p["dmin"].repeat_interleave(QK_K // 16, dim=-1) * mn.float())


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Planes -> dense `qt.shape` in `dtype`, computed in float32 (a padded
    tail of kernel planes dropped)."""
    if qt.plane_k != qt.k:
        full = QTensor(qt.kind, (*qt.shape[:-1], qt.plane_k), qt.planes)
        return dequantize(full, dtype)[..., :qt.k].contiguous()
    p = qt.planes
    if "w" in p:
        return p["w"].to(dtype)
    if qt.kind in (GGMLType.Q8_0, GGMLType.Q8_1):
        w = p["qs"].float().reshape(*qt.shape[:-1], qt.k // 32, 32) * _dsub(qt, 32)[..., None]
        return w.reshape(qt.shape).to(dtype)
    if qt.kind == GGMLType.Q6_K:
        q = (q6k_values(p["ql"], p["qh"]).float() - 32).reshape(*qt.shape[:-1], qt.k // 16, 16)
        return (q * _dsub(qt, 16)[..., None]).reshape(qt.shape).to(dtype)
    if qt.kind in LEGACY_KINDS:
        if qt.kernel_layout:
            vals = nibbles(p["qs"]) if "qh" not in p else q5k_values(p["qs"], p["qh"])
            d, mn = p["dsub"].float(), p.get("msub")
        else:
            vals = q4_0_values(p["qs"]) if "qh" not in p else q5_0_values(p["qs"], p["qh"])
            d, mn = p["d"], p.get("mn")
        q = vals.float().reshape(*qt.shape[:-1], qt.k // 32, 32)
        if mn is None:  # Q4_0, Q5_0: (val - offset) * d
            q = q - _LEGACY_OFFSET[qt.kind]
            return (q * d[..., None]).reshape(qt.shape).to(dtype)
        # Q4_1, Q5_1: q*d + m as two roundings, as the codec computes it
        w = q * d[..., None]
        return (w + mn.float()[..., None]).reshape(qt.shape).to(dtype)
    if qt.kind in (GGMLType.Q2_K, GGMLType.Q3_K):
        dl, ml = k16_scales(qt.kind, p)
        if ml is None:  # Q3_K: (val - 4) * d*sc
            q = q3k_values(p["qs"], p["hb"]).float() - 4
            w = q.reshape(*qt.shape[:-1], qt.k // 16, 16) * dl[..., None]
        else:
            q = q2_values(p["qs"]).float().reshape(*qt.shape[:-1], qt.k // 16, 16)
            w = q * dl[..., None] + ml[..., None]
        return w.reshape(qt.shape).to(dtype)
    vals = q5k_values(p["qs"], p["qh"]) if qt.kind == GGMLType.Q5_K else nibbles(p["qs"])
    q = vals.float().reshape(*qt.shape[:-1], qt.k // 32, 32)
    if qt.kernel_layout:
        w = q * p["dsub"].float()[..., None] + p["msub"].float()[..., None]
    else:
        dl, ml = _folded_scales(qt)
        w = q * dl[..., None] - ml[..., None]
    return w.reshape(qt.shape).to(dtype)


def to_kernel_layout(qt: QTensor, scale_dtype=torch.float32) -> QTensor:
    """Canonical planes -> kernel planes: {qs, dsub, msub} for Q4_K and
    Q4_1, {qs, qh, dsub, msub} for Q5_K and Q5_1, {qs, qh, dsub} for Q5_0,
    {qs, dsub} for Q8_0, Q8_1 and Q4_0 (the legacy kinds' nibbles reordered
    into the per-64 order, their qh into Q5_K's), {ql, qh, dsub} for Q6_K,
    the float32 scale rounded once to `scale_dtype`; {qs, scm, d, dmin} for
    Q2_K and Q3_K's own planes, whose scales stay exact whatever
    `scale_dtype`. F32 and F16 are returned as they are (they take the dense
    matmul). The PADDED_KINDS take any k that is a multiple of 32 (every
    row a GGUF can hold in them): their planes are zero-padded to
    `kernel_k(k)`, values, scales and minima, so the tail adds nothing."""
    p = qt.planes
    if qt.kind == GGMLType.Q3_K or (qt.kind == GGMLType.Q2_K and not qt.kernel_layout):
        if qt.k % QK_K:
            raise UnsupportedError(
                f"{qt.kind.name} weight of shape {qt.shape}: rows of 256-element superblocks only")
        if qt.kind == GGMLType.Q3_K:
            planes = {n: p[n].contiguous() for n in ("qs", "hb", "sc", "d")}
        else:
            planes = {"qs": p["qs"].contiguous(), "scm": p["sc"] | (p["mn"] << 4),
                      "d": p["d"].contiguous(), "dmin": p["dmin"].contiguous()}
        return QTensor(qt.kind, qt.shape, planes)
    if qt.kind not in KERNEL_KINDS or qt.kernel_layout:
        return qt
    if qt.kind in PADDED_KINDS:
        if qt.k % 32:
            raise UnsupportedError(
                f"{qt.kind.name} weight of shape {qt.shape}: rows of 32-element blocks only")
        pad = kernel_k(qt.k) - qt.k

        def padded(a, per):  # the last axis zero-padded to kernel_k(k) / per
            return F.pad(a, (0, pad // per)).contiguous() if pad else a.contiguous()

        if qt.kind in (GGMLType.Q8_0, GGMLType.Q8_1):
            return QTensor(qt.kind, qt.shape, {"qs": padded(p["qs"], 1),
                                               "dsub": padded(_dsub(qt, 32).to(scale_dtype), 32)})
        planes = {"qs": nibble_pack(padded(q4_0_values(p["qs"]), 1))}
        if "qh" in p:
            planes["qh"] = qh_to_q5k_order(padded(p["qh"], 8))
        planes["dsub"] = padded(p["d"].to(scale_dtype), 32)
        if "mn" in p:
            planes["msub"] = padded(p["mn"].to(scale_dtype), 32)
        return QTensor(qt.kind, qt.shape, planes)
    if qt.kind == GGMLType.Q6_K:
        return QTensor(qt.kind, qt.shape, {"ql": p["ql"].contiguous(), "qh": p["qh"].contiguous(),
                                           "dsub": _dsub(qt, 16).to(scale_dtype)})
    dl, ml = _folded_scales(qt)
    planes = {"qs": p["qs"].contiguous()}
    if qt.kind == GGMLType.Q5_K:
        planes["qh"] = p["qh"].contiguous()
    return QTensor(qt.kind, qt.shape, {**planes, "dsub": dl.to(scale_dtype),
                                       "msub": (-ml).to(scale_dtype)})


def cat_rows(qts: list[QTensor]) -> QTensor:
    """Concatenate QTensors of one kind along m (load-time q|k|v and gate|up
    fusion; stacked experts fuse expert by expert)."""
    planes = {n: torch.cat([q.planes[n] for q in qts], -2) for n in qts[0].planes}
    shape = (*qts[0].shape[:-2], sum(q.m for q in qts), qts[0].k)
    return QTensor(qts[0].kind, shape, planes)


def plane_of(qt: QTensor, e: int) -> QTensor:
    """Expert `e` of a stacked QTensor as a 2-D one (views, no copy)."""
    return QTensor(qt.kind, qt.shape[1:], {n: p[e] for n, p in qt.planes.items()})

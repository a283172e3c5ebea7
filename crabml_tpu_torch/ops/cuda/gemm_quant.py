"""Q4_K quantized matmuls: `qmm_q4k` (prefill rows), `qmm_w4a8` (decode
rows), `qmm_w8` (prefill rows on the W8 planes) and the grouped forms
`qmm_q4k_grouped` / `qmm_w8_grouped` (rows sorted by expert, each segment
against its own expert's planes), with `quantize_activation`, the W8 planes
(`w8_planes_from_weights`, `augment_w8`) and the row routing of the JAX
package.

Counterpart of crabml_tpu/ops/pallas/gemm_quant.py: `_qmm_kernel` becomes
csrc/qmm_q4k.cu (launchers `_run` and `_run_grouped`), `_qmm_w4a8_kernel`
becomes csrc/qmm_w4a8.cu and `_qmm_w8_kernel` becomes csrc/qmm_w8.cu
(launchers `_run_w8` and `_run_grouped_w8`); each source holds its note on
what bounds it on the H100 and how the design answers it. All take the port's
own weight layout (quant/qtensor.py kernel planes), not the TPU's m-tiled one.

Routing keeps the TPU's structure, by the row count padded up to a multiple
of 8: at most `W4A8_MAX_ROWS` rows take the int8-activation kernel, at least
`W8_MIN_ROWS` take the W8 kernel where the weight carries W8 planes, and
everything between takes the bf16 dequant kernel. Both values were tuned on a
TPU v5e and stand until the card's own sweep sets them.

On a CPU tensor each wrapper computes its plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. It never falls back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...gguf.constants import GGMLType
from ...quant.qtensor import QTensor, dequantize, nibbles, plane_of
from . import _build

W4A8_MAX_ROWS = 16  # TPU-tuned (v5e decode_loop sweep); to be set on the card
W8_MIN_ROWS = 256  # TPU-tuned as well: padded rows from which the W8 planes take over
W8_KSC = 512  # k elements per W8 scale chunk
ROW_PAD = 8  # the routing counts rows padded up to this (the JAX package's B_PAD)
GROUP = 32  # Q4_K scale group: one dsub/msub per 32 elements

_P = ctypes.c_void_p
_I = ctypes.c_int


def quantize_activation(x2: torch.Tensor):
    """Per-(row, 32-group) symmetric int8 activations.

    x2 (B, K) in the compute dtype -> xq i8 (B, K), dx f32 (B, K/32) scales,
    sx f32 (B, K/32) = dx * sum(xq) per group. Rounds half to even
    (torch.round), as jnp.round does in the JAX package."""
    B, K = x2.shape
    xg = x2.float().reshape(B, K // GROUP, GROUP)
    amax = xg.abs().amax(dim=-1)
    # divide by a tensor: on CUDA, PyTorch turns division by a Python scalar
    # into a multiply by its reciprocal, which rounds differently from the
    # kernel's (and JAX's) true division and can flip an int8 value
    dx = amax / torch.full_like(amax, 127.0)
    inv = torch.where(dx > 0, 1.0 / torch.clamp(dx, min=1e-30), torch.zeros_like(dx))
    xq = torch.clamp(torch.round(xg * inv[..., None]), -127, 127).to(torch.int8)
    sx = dx * xq.float().sum(-1)
    return xq.reshape(B, K), dx, sx


def qmm_q4k_plain(x2, qs, dsub, msub) -> torch.Tensor:
    """Plain version of qmm_q4k: w = val*dsub + msub in float32, rounded to
    x2's dtype, then x2 @ w^T with float32 accumulation -> (rows, m) f32."""
    m = qs.shape[0]
    w = (nibbles(qs).float().reshape(m, -1, GROUP) * dsub.float()[..., None]
         + msub.float()[..., None]).reshape(m, -1)
    return x2.float() @ w.to(x2.dtype).float().t()


def qmm_w4a8_plain(x2, qs, dsub, msub, plane=None) -> torch.Tensor:
    """Plain version of qmm_w4a8: quantize_activation, exact integer group
    dots (float32 holds them exactly: |sum| < 2^24), then dsub*dx per group
    plus msub*sx -> (rows, m) f32. With `plane` (rows,) the planes are stacks
    (E, m, ...) and row b multiplies plane[b]: the planes are gathered per
    row, with no value read on the host."""
    xq, dx, sx = quantize_activation(x2)
    B, K = xq.shape
    m = qs.shape[-2]
    G = K // GROUP
    if plane is not None:
        plane = plane.long()
        vals = nibbles(qs[plane]).float().reshape(B, m, G, GROUP)
        ig = torch.einsum("bgi,bmgi->bmg", xq.float().reshape(B, G, GROUP), vals)
        out = (ig * dx[:, None, :] * dsub[plane].float()).sum(-1)
        return out + torch.einsum("bg,bmg->bm", sx, msub[plane].float())
    vals = nibbles(qs).float().reshape(m, G, GROUP).permute(1, 2, 0)  # (G, 32, m)
    xg = xq.float().reshape(B, G, GROUP).permute(1, 0, 2)  # (G, B, 32)
    ig = torch.bmm(xg, vals).permute(1, 2, 0)  # (B, m, G) integer dots
    out = (ig * dx[:, None, :] * dsub.float()[None]).sum(-1)
    return out + sx @ msub.float().t()


def w8_planes_from_weights(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """(..., m, k) exact float32 weights -> {"w8": i8 (..., m, kpad8), "dw":
    f32 (..., m, kpad8/512)}: symmetric int8 per (row, W8_KSC-deep k chunk),
    k zero-padded up to a multiple of W8_KSC.

    The numbers are those of the JAX package's w8_planes_from_weights bit for
    bit: the scale is a true division by 127 (by a tensor: on CUDA, PyTorch
    turns division by a Python scalar into a multiply by its reciprocal),
    while the quantization multiplies by the scale's reciprocal and rounds
    half to even."""
    k = w.shape[-1]
    S8 = -(-k // W8_KSC)
    if S8 * W8_KSC != k:
        w = F.pad(w, (0, S8 * W8_KSC - k))
    wc = w.reshape(*w.shape[:-1], S8, W8_KSC)
    amax = wc.abs().amax(dim=-1)
    s8 = amax / torch.full_like(amax, 127.0)
    inv = torch.where(s8 > 0, 1.0 / torch.clamp(s8, min=1e-30), torch.zeros_like(s8))
    w8 = torch.clamp(torch.round(wc * inv[..., None]), -127, 127).to(torch.int8)
    return {"w8": w8.reshape(*w.shape[:-1], S8 * W8_KSC), "dw": s8}


def w8_eligible(qt: QTensor) -> bool:
    """Whether augment_w8 attaches planes: a Q4_K kernel-layout matmul whose
    row count is a multiple of 256 (per expert for a stack)."""
    return qt.kind == GGMLType.Q4_K and qt.kernel_layout and qt.m % 256 == 0


def augment_w8(qt: QTensor) -> QTensor:
    """Attach the W8 prefill planes, computed from the exact float32 values
    of the kernel planes (val*dsub + msub with the scale planes as stored,
    already rounded to their dtype). Returns `qt` itself when it is not
    eligible or already augmented. A stack is done expert by expert, which
    bounds the float32 scratch to one expert's weights."""
    if not w8_eligible(qt) or "w8" in qt.planes:
        return qt
    if qt.stacked:
        per = [w8_planes_from_weights(dequantize(plane_of(qt, e))) for e in range(qt.shape[0])]
        new = {n: torch.stack([d[n] for d in per]) for n in ("w8", "dw")}
    else:
        new = w8_planes_from_weights(dequantize(qt))
    return QTensor(qt.kind, qt.shape, {**qt.planes, **new})


def qmm_w8_plain(x2, w8, dw) -> torch.Tensor:
    """Plain version of qmm_w8: x2 rounded to bfloat16, then per k chunk the
    float32 product with the int8 weights, times the (row, chunk) scale,
    added chunk by chunk -> (rows, m) f32. x2's k zero-pads to the planes'."""
    m, kpad = w8.shape
    S8 = dw.shape[1]
    ksc = kpad // S8
    xb = x2.to(torch.bfloat16).float()
    if xb.shape[1] != kpad:
        xb = F.pad(xb, (0, kpad - xb.shape[1]))
    out = torch.zeros(x2.shape[0], m, dtype=torch.float32, device=x2.device)
    for c in range(S8):
        part = xb[:, c * ksc:(c + 1) * ksc] @ w8[:, c * ksc:(c + 1) * ksc].float().t()
        out += part * dw[:, c]
    return out


def _grouped_plain(xs, offsets, one) -> torch.Tensor:
    """Rows [offsets[e], offsets[e+1]) of xs through `one(rows, e)`, the
    plain matmul against plane e; an empty segment costs nothing."""
    cuts = offsets.tolist()
    return torch.cat([one(xs[lo:hi], e) for e, (lo, hi) in enumerate(zip(cuts, cuts[1:]))
                      if hi > lo])


def qmm_q4k_grouped_plain(xs, qs, dsub, msub, offsets) -> torch.Tensor:
    """Plain version of qmm_q4k_grouped: qmm_q4k_plain per segment of the
    sorted rows against its own plane -> (rows, m) f32."""
    return _grouped_plain(xs, offsets, lambda r, e: qmm_q4k_plain(r, qs[e], dsub[e], msub[e]))


def qmm_w8_grouped_plain(xs, w8, dw, offsets) -> torch.Tensor:
    """Plain version of qmm_w8_grouped: qmm_w8_plain per segment."""
    return _grouped_plain(xs, offsets, lambda r, e: qmm_w8_plain(r, w8[e], dw[e]))


def _lib_q4k():
    return _build.entry("qmm_q4k", "qmm_q4k_bf16", _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)


def _lib_q4k_grouped():
    return _build.entry("qmm_q4k", "qmm_q4k_grouped_bf16", _P, _P, _P, _P, _P, _I, _P, _I,
                        _I, _I, _I, _P)


def _lib_w4a8():
    return _build.entry("qmm_w4a8", "qmm_w4a8_bf16", _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _P, _I, _I, _I, _P)


def _lib_w8():
    return _build.entry("qmm_w8", "qmm_w8_bf16", _P, _P, _P, _P, _I, _I, _I, _I, _P)


def _lib_w8_grouped():
    return _build.entry("qmm_w8", "qmm_w8_grouped_bf16", _P, _P, _P, _P, _I, _P, _I, _I, _I,
                        _I, _P)


def _check_weight(qt: QTensor, k: int, device: torch.device, stacked: bool = False):
    p = qt.planes
    _build.require(qt.kind == GGMLType.Q4_K and qt.kernel_layout,
                   f"{qt.kind.name}: the CUDA matmuls take Q4_K kernel planes")
    _build.require(qt.stacked == stacked,
                   f"weight of shape {qt.shape}: expected {'a stack of planes' if stacked else 'one plane'}")
    _build.require(qt.k == k and k % 256 == 0, f"k={k} vs weight {qt.shape}")
    lead = qt.shape[:-1]
    _build.require(p["qs"].shape == (*lead, k // 2)
                   and p["dsub"].shape == p["msub"].shape == (*lead, k // GROUP),
                   f"weight planes do not match the shape {qt.shape}")
    _build.require(p["dsub"].dtype == torch.bfloat16 and p["msub"].dtype == torch.bfloat16,
                   "the CUDA matmuls take bfloat16 scale planes")
    for t in (p["qs"], p["dsub"], p["msub"]):
        _build.require(t.device == device and t.is_contiguous(),
                       "weight planes must be contiguous on the activations' card")


def _check_w8(qt: QTensor, k: int, device: torch.device, stacked: bool = False):
    """Checks the W8 planes of `qt`; returns their padded k."""
    p = qt.planes
    _build.require("w8" in p and "dw" in p, "this weight carries no W8 planes")
    _build.require(qt.stacked == stacked,
                   f"weight of shape {qt.shape}: expected {'a stack of planes' if stacked else 'one plane'}")
    kpad = -(-k // W8_KSC) * W8_KSC
    lead = qt.shape[:-1]
    _build.require(qt.k == k and p["w8"].shape == (*lead, kpad)
                   and p["dw"].shape == (*lead, kpad // W8_KSC),
                   f"W8 planes do not match k={k} and the shape {qt.shape}")
    _build.require(p["w8"].dtype == torch.int8 and p["dw"].dtype == torch.float32,
                   "the W8 planes are int8 weights and float32 scales")
    for t in (p["w8"], p["dw"]):
        _build.require(t.device == device and t.is_contiguous(),
                       "weight planes must be contiguous on the activations' card")
    return kpad


def _check_offsets(offsets: torch.Tensor, qt: QTensor, device: torch.device):
    _build.require(offsets.dtype == torch.int32 and offsets.shape == (qt.shape[0] + 1,)
                   and offsets.device == device and offsets.is_contiguous(),
                   "offsets: one int32 per plane and one more, on the activations' card")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _out_bf16(out_dtype: torch.dtype) -> int:
    _build.require(out_dtype in (torch.float32, torch.bfloat16),
                   f"the CUDA matmuls write float32 or bfloat16, not {out_dtype}")
    return int(out_dtype == torch.bfloat16)


def qmm_q4k(x2: torch.Tensor, qt: QTensor, out_dtype=torch.float32) -> torch.Tensor:
    """x2 (rows, k) @ W^T -> (rows, m) through the dequant kernel; float32
    sums, rounded once to `out_dtype`."""
    p = qt.planes
    if not x2.is_cuda:
        return qmm_q4k_plain(x2, p["qs"], p["dsub"], p["msub"]).to(out_dtype)
    rows, k = x2.shape
    _check_weight(qt, k, x2.device)
    _build.require(x2.dtype == torch.bfloat16, f"qmm_q4k takes bfloat16 activations, got {x2.dtype}")
    out_bf16 = _out_bf16(out_dtype)
    x2 = _aligned(x2)
    out = torch.empty(rows, qt.m, dtype=out_dtype, device=x2.device)
    lib, fn = _lib_q4k()
    _build.launches["qmm_q4k"] += 1
    err = fn(x2.data_ptr(), p["qs"].data_ptr(), p["dsub"].data_ptr(), p["msub"].data_ptr(),
             out.data_ptr(), out_bf16, rows, qt.m, k, _build.stream_ptr(x2))
    _build.check(lib, err, "qmm_q4k")
    return out


def qmm_w4a8(x2: torch.Tensor, qt: QTensor, out_dtype=torch.float32,
             plane: torch.Tensor | None = None) -> torch.Tensor:
    """x2 (rows <= 16, k) @ W^T -> (rows, m): activations quantize to int8
    per 32-group inside the launch, then the int8 x 4-bit kernel; float32
    sums, rounded once to `out_dtype`. With `plane` (rows,) int32, `qt` is a
    stack (E, m, k) and row b multiplies plane[b], read on the device."""
    p = qt.planes
    if not x2.is_cuda:
        return qmm_w4a8_plain(x2, p["qs"], p["dsub"], p["msub"], plane).to(out_dtype)
    rows, k = x2.shape
    _check_weight(qt, k, x2.device, stacked=plane is not None)
    if plane is not None:
        _build.require(plane.dtype == torch.int32 and plane.shape == (rows,)
                       and plane.device == x2.device and plane.is_contiguous(),
                       "plane: one int32 per row, on the activations' card")
    _build.require(1 <= rows <= W4A8_MAX_ROWS, f"qmm_w4a8 takes 1..{W4A8_MAX_ROWS} rows, got {rows}")
    _build.require(x2.dtype == torch.bfloat16, f"qmm_w4a8 takes bfloat16 activations, got {x2.dtype}")
    out_bf16 = _out_bf16(out_dtype)
    x2 = _aligned(x2)
    dev = x2.device
    xq = torch.empty(rows, k, dtype=torch.int8, device=dev)
    dx = torch.empty(rows, k // GROUP, dtype=torch.float32, device=dev)
    sx = torch.empty_like(dx)
    out = torch.empty(rows, qt.m, dtype=out_dtype, device=dev)
    lib, fn = _lib_w4a8()
    _build.launches["qmm_w4a8"] += 1
    err = fn(x2.data_ptr(), xq.data_ptr(), dx.data_ptr(), sx.data_ptr(), p["qs"].data_ptr(),
             p["dsub"].data_ptr(), p["msub"].data_ptr(), out.data_ptr(), out_bf16,
             None if plane is None else plane.data_ptr(), rows, qt.m, k, _build.stream_ptr(x2))
    _build.check(lib, err, "qmm_w4a8")
    return out


def _pad_k(x2: torch.Tensor, kpad: int) -> torch.Tensor:
    return x2 if x2.shape[1] == kpad else F.pad(x2, (0, kpad - x2.shape[1]))


def qmm_w8(x2: torch.Tensor, qt: QTensor, out_dtype=torch.float32) -> torch.Tensor:
    """x2 (rows, k) @ W^T -> (rows, m) through the W8 planes of `qt`: per
    512-chunk the bf16 product in float32, times the chunk's scale; float32
    sums, rounded once to `out_dtype`."""
    p = qt.planes
    if not x2.is_cuda:
        return qmm_w8_plain(x2, p["w8"], p["dw"]).to(out_dtype)
    rows, k = x2.shape
    kpad = _check_w8(qt, k, x2.device)
    _build.require(x2.dtype == torch.bfloat16, f"qmm_w8 takes bfloat16 activations, got {x2.dtype}")
    out_bf16 = _out_bf16(out_dtype)
    x2 = _aligned(_pad_k(x2, kpad))
    out = torch.empty(rows, qt.m, dtype=out_dtype, device=x2.device)
    lib, fn = _lib_w8()
    _build.launches["qmm_w8"] += 1
    err = fn(x2.data_ptr(), p["w8"].data_ptr(), p["dw"].data_ptr(), out.data_ptr(), out_bf16,
             rows, qt.m, kpad, _build.stream_ptr(x2))
    _build.check(lib, err, "qmm_w8")
    return out


def qmm_q4k_grouped(xs: torch.Tensor, qt: QTensor, offsets: torch.Tensor,
                    out_dtype=torch.float32) -> torch.Tensor:
    """Grouped qmm_q4k: xs (rows, k) sorted by plane, `qt` a stack (E, m, k),
    offsets (E + 1,) int32 with each plane's first row (offsets[E] == rows).
    Rows [offsets[e], offsets[e+1]) multiply plane e -> (rows, m). The kernel
    reads the offsets on the device; a segment may be empty or ragged."""
    p = qt.planes
    if not xs.is_cuda:
        return qmm_q4k_grouped_plain(xs, p["qs"], p["dsub"], p["msub"], offsets).to(out_dtype)
    rows, k = xs.shape
    _check_weight(qt, k, xs.device, stacked=True)
    _check_offsets(offsets, qt, xs.device)
    _build.require(xs.dtype == torch.bfloat16,
                   f"qmm_q4k_grouped takes bfloat16 activations, got {xs.dtype}")
    out_bf16 = _out_bf16(out_dtype)
    xs = _aligned(xs)
    out = torch.empty(rows, qt.m, dtype=out_dtype, device=xs.device)
    lib, fn = _lib_q4k_grouped()
    _build.launches["qmm_q4k_grouped"] += 1
    err = fn(xs.data_ptr(), p["qs"].data_ptr(), p["dsub"].data_ptr(), p["msub"].data_ptr(),
             out.data_ptr(), out_bf16, offsets.data_ptr(), qt.shape[0], rows, qt.m, k,
             _build.stream_ptr(xs))
    _build.check(lib, err, "qmm_q4k_grouped")
    return out


def qmm_w8_grouped(xs: torch.Tensor, qt: QTensor, offsets: torch.Tensor,
                   out_dtype=torch.float32) -> torch.Tensor:
    """Grouped qmm_w8: as qmm_q4k_grouped on the W8 planes of the stack."""
    p = qt.planes
    if not xs.is_cuda:
        return qmm_w8_grouped_plain(xs, p["w8"], p["dw"], offsets).to(out_dtype)
    rows, k = xs.shape
    kpad = _check_w8(qt, k, xs.device, stacked=True)
    _check_offsets(offsets, qt, xs.device)
    _build.require(xs.dtype == torch.bfloat16,
                   f"qmm_w8_grouped takes bfloat16 activations, got {xs.dtype}")
    out_bf16 = _out_bf16(out_dtype)
    xs = _aligned(_pad_k(xs, kpad))
    out = torch.empty(rows, qt.m, dtype=out_dtype, device=xs.device)
    lib, fn = _lib_w8_grouped()
    _build.launches["qmm_w8_grouped"] += 1
    err = fn(xs.data_ptr(), p["w8"].data_ptr(), p["dw"].data_ptr(), out.data_ptr(), out_bf16,
             offsets.data_ptr(), qt.shape[0], rows, qt.m, kpad, _build.stream_ptr(xs))
    _build.check(lib, err, "qmm_w8_grouped")
    return out


def qmatmul_grouped(xs: torch.Tensor, qt: QTensor, offsets: torch.Tensor,
                    w8: bool) -> torch.Tensor:
    """Grouped matmul over expert-sorted rows in xs's dtype: through the W8
    planes when `w8` and the stack carries them, else through the Q4_K
    dequant kernel. (The JAX package's qmatmul_grouped tests its padded row
    count against W8_MIN_ROWS; the caller decides here, see models/forward.py.)"""
    if w8 and "w8" in qt.planes:
        return qmm_w8_grouped(xs, qt, offsets, xs.dtype)
    return qmm_q4k_grouped(xs, qt, offsets, xs.dtype)


def route(rows: int, has_w8: bool) -> str:
    """The kernel the JAX package's qmatmul_pallas picks under its `w4a8`
    backend: by the row count padded up to a multiple of 8, so the W8 planes
    take over from 249 real rows."""
    padded = -(-rows // ROW_PAD) * ROW_PAD
    if padded <= W4A8_MAX_ROWS:
        return "qmm_w4a8"
    if has_w8 and padded >= W8_MIN_ROWS:
        return "qmm_w8"
    return "qmm_q4k"


def qmatmul_q4k(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (..., k) @ W^T -> (..., m) in x's dtype, routed by row count and by
    whether `qt` carries W8 planes (`route`). The kernels write x's dtype
    themselves, so no cast follows them.

    Activations quantize from x already in the compute dtype, as the JAX
    package's qmatmul_pallas does (gemm_quant.py:941,959)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, qt.k)
    kernel = route(x2.shape[0], "w8" in qt.planes)
    if kernel == "qmm_w4a8":
        out = qmm_w4a8(x2, qt, x.dtype)
    elif kernel == "qmm_w8":
        out = qmm_w8(x2, qt, x.dtype)
    else:
        out = qmm_q4k(x2, qt, x.dtype)
    return out.reshape(*lead, qt.m)

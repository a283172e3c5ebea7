"""Quantized matmuls: `qmm_q4k`, `qmm_q5k`, `qmm_q6k`, `qmm_q8_0`,
`qmm_q4_0`, `qmm_q5_0`, `qmm_q3k`, `qmm_q2k` (prefill rows, one per weight
scheme, made by `_dequant_form`), their grouped forms
`qmm_<scheme>_grouped` (rows sorted by expert, each segment against its own
expert's planes, made by `_grouped_form`), `qmm_w4a8` (decode rows, every
scheme, with a plane per row for a stack of experts), `qmm_w8` (prefill rows
on the W8 planes) and its grouped form `qmm_w8_grouped`, with
`quantize_activation`, the W8 planes (`w8_planes_from_weights`,
`augment_w8`) and the row routing of the JAX package.

Counterpart of crabml_tpu/ops/pallas/gemm_quant.py: `_qmm_kernel` becomes
csrc/qmm_q4k.cu, csrc/qmm_q5k.cu, csrc/qmm_q6k.cu, csrc/qmm_q8_0.cu,
csrc/qmm_q4_0.cu, csrc/qmm_q5_0.cu, csrc/qmm_q3k.cu and csrc/qmm_q2k.cu, one
weight source of a tile loop each (qmm_q5k, qmm_q6k, qmm_q3k and qmm_q2k on
csrc/qmm_ws.cuh's warp-specialized loop, its launch shape `qmm_ws_plan`; the
others on csrc/qmm_pipe.cuh), with a dense and a grouped entry
(launchers `_run` and `_run_grouped`), `_qmm_w4a8_kernel` becomes
csrc/qmm_w4a8.cu with a form per scheme, each with its plane-per-row form
(`_run_w4a8` with `stacked`; its launch shape is `w4a8_plan`) and
`_qmm_w8_kernel` becomes csrc/qmm_w8.cu (launchers `_run_w8` and
`_run_grouped_w8`); each source holds its note on what bounds it on the H100
and how the design answers it. All take the port's own weight layout
(quant/qtensor.py kernel planes), not the TPU's m-tiled one.
The int8-activation forms quantize x per scale group of the scheme, as the
JAX package does (`scheme.gr`): 16 for Q6_K, Q3_K and Q2_K, 32 for the others.

The eleven schemes of the JAX package take eight sets of forms: Q4_1, Q5_1
and Q8_1 weights have, in kernel layout, exactly the planes of Q4_K, Q5_K
and Q8_0 (quant/qtensor.py), and those forms compute exactly their
functions, so each runs the forms of its `FORM_KIND`, counted under their
names. Every table below is keyed by the form's own kind; the entry points
(the wrappers, `qmatmul_grouped`, `route`, `w4a8_plan`) take a weight of any
kind to its form through FORM_KIND.

Routing keeps the TPU's structure, by the row count padded up to a multiple
of 8: at most `W4A8_MAX_ROWS` rows take the int8-activation kernel, at least
`W8_MIN_ROWS` take the W8 kernel where the weight carries W8 planes, and
everything between takes the scheme's bf16 dequant kernel. Both values were
tuned on a TPU v5e and stand until the card's own sweep sets them.

Under float32 compute (x float32, the weights loaded with float32 dsub /
msub planes) the dense dequant forms take csrc/qmm_f32.cu, a tensor-core
matmul on exactly dequantized float32 weights in three TF32 passes (the JAX
kernel's out_dtype float32 path, Precision.HIGHEST; `tf32_split` and
`qmm_f32_split_plain` model its arithmetic, `qmm_f32_plan` its launch),
counted as `<form>_f32`, and so do the grouped dequant forms (the grouped
entries of the same source, counted as `<form>_grouped.f32`); qmm_w4a8
takes its `_f32` entries (float32 x into the
quantizer, float32 scale planes), counted as `<form>[.planes].f32`; qmm_w8
and qmm_w8_grouped round float32 x to bfloat16 and write float32, as the JAX
package does (gemm_quant.py:967, :896-903).

A legacy weight whose rows are not whole 256-element superblocks (k = 288 in
stories15M) holds kernel planes zero-padded to `kernel_k(k)` with zero
scales (quant/qtensor.py, the JAX package's `repack` rule). Each wrapper
takes x of depth k or of the planes' depth and zero-pads it to the planes'
(`_fit_k`; qmm_w8 to its W8 planes' depth), so every form runs on the
padded planes as on any other and the tail adds nothing; the padded bytes
are read.

On a CPU tensor each wrapper computes its plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. It never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...gguf.constants import GGMLType
from ...quant.qtensor import (FORM_KIND, KERNEL_KINDS, QTensor, dequantize, k16_scales, nibbles,
                               plane_of, q2_values, q3k_values, q5k_values, q6k_values)
from . import _build

W4A8_MAX_ROWS = 16  # TPU-tuned (v5e decode_loop sweep); to be set on the card
W8_MIN_ROWS = 256  # TPU-tuned as well: padded rows from which the W8 planes take over
W8_KSC = 512  # k elements per W8 scale chunk
ROW_PAD = 8  # the routing counts rows padded up to this (the JAX package's B_PAD)
GROUP = 32  # Q4_K scale group: one dsub/msub per 32 elements
# elements a scale of each form: 16 for the per-16 schemes, 32 for the others
SCHEME_GROUP = {k: 16 if k in (GGMLType.Q6_K, GGMLType.Q3_K, GGMLType.Q2_K) else 32
                for k in KERNEL_KINDS if FORM_KIND[k] == k}
W4A8_COLS = 16  # output columns of a qmm_w4a8 block: the M of one mma tile
W4A8_WARPS = 4  # warps of a block; they split k by superblock
W4A8_SB = 256  # k depth of one ring stage: a Q4_K superblock, 8 scale groups

_P = ctypes.c_void_p
_I = ctypes.c_int


def quantize_activation(x2: torch.Tensor, group: int = GROUP):
    """Per-(row, `group`) symmetric int8 activations.

    x2 (B, K) in the compute dtype -> xq i8 (B, K), dx f32 (B, K/group)
    scales, sx f32 (B, K/group) = dx * sum(xq) per group. Rounds half to
    even (torch.round), as jnp.round does in the JAX package."""
    B, K = x2.shape
    xg = x2.float().reshape(B, K // group, group)
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


def qmm_q5k_plain(x2, qs, qh, dsub, msub) -> torch.Tensor:
    """Plain version of qmm_q5k: Q4_K's, with the 5-bit values 0..31."""
    m = qs.shape[0]
    w = (q5k_values(qs, qh).float().reshape(m, -1, GROUP) * dsub.float()[..., None]
         + msub.float()[..., None]).reshape(m, -1)
    return x2.float() @ w.to(x2.dtype).float().t()


def qmm_q4_0_plain(x2, qs, dsub) -> torch.Tensor:
    """Plain version of qmm_q4_0: w = (val - 8)*dsub in float32 (exact with a
    bf16 scale: at most 12 significant bits; `qs` in the kernel planes'
    per-64 order), rounded to x2's dtype, then x2 @ w^T with float32
    accumulation -> (rows, m) f32."""
    m = qs.shape[0]
    w = ((nibbles(qs).float() - 8).reshape(m, -1, 32) * dsub.float()[..., None]).reshape(m, -1)
    return x2.float() @ w.to(x2.dtype).float().t()


def qmm_q5_0_plain(x2, qs, qh, dsub) -> torch.Tensor:
    """Plain version of qmm_q5_0: w = (val - 16)*dsub in float32 (exact with
    a bf16 scale: at most 13 significant bits; `qs` in the per-64 order and
    `qh` in Q5_K's, val 0..31), rounded to x2's dtype, then x2 @ w^T with
    float32 accumulation -> (rows, m) f32."""
    m = qs.shape[0]
    w = ((q5k_values(qs, qh).float() - 16).reshape(m, -1, 32)
         * dsub.float()[..., None]).reshape(m, -1)
    return x2.float() @ w.to(x2.dtype).float().t()


def qmm_q8_0_plain(x2, qs, dsub) -> torch.Tensor:
    """Plain version of qmm_q8_0: w = qs*dsub in float32 (exact: an int8
    times a bf16 scale has at most 15 significant bits), rounded to x2's
    dtype, then x2 @ w^T with float32 accumulation -> (rows, m) f32."""
    m = qs.shape[0]
    w = (qs.float().reshape(m, -1, 32) * dsub.float()[..., None]).reshape(m, -1)
    return x2.float() @ w.to(x2.dtype).float().t()


def qmm_q6k_plain(x2, ql, qh, dsub) -> torch.Tensor:
    """Plain version of qmm_q6k: w = (val - 32)*dsub in float32 (exact with a
    bf16 scale: at most 14 significant bits), rounded to x2's dtype, then
    x2 @ w^T with float32 accumulation -> (rows, m) f32."""
    m = ql.shape[0]
    q = q6k_values(ql, qh).float() - 32
    w = (q.reshape(m, -1, 16) * dsub.float()[..., None]).reshape(m, -1)
    return x2.float() @ w.to(x2.dtype).float().t()


def qmm_q2k_plain(x2, qs, scm, d, dmin) -> torch.Tensor:
    """Plain version of qmm_q2k: w = val*dsub + msub in float32, dsub = d*sc
    and msub = -dmin*mn per 16 elements (both exact, and so is val*dsub),
    rounded to x2's dtype, then x2 @ w^T with float32 accumulation -> (rows,
    m) f32."""
    w = dequantize(QTensor(GGMLType.Q2_K, (qs.shape[0], qs.shape[1] * 4),
                           {"qs": qs, "scm": scm, "d": d, "dmin": dmin}))
    return x2.float() @ w.to(x2.dtype).float().t()


def qmm_q3k_plain(x2, qs, hb, sc, d) -> torch.Tensor:
    """Plain version of qmm_q3k: w = (val - 4)*d*sc in float32 (exact: at most
    20 significant bits), rounded to x2's dtype, then x2 @ w^T with float32
    accumulation -> (rows, m) f32."""
    w = dequantize(QTensor(GGMLType.Q3_K, (qs.shape[0], qs.shape[1] * 4),
                           {"qs": qs, "hb": hb, "sc": sc, "d": d}))
    return x2.float() @ w.to(x2.dtype).float().t()


def _w4a8_dense_plain(x2, vals, dsub, msub, group) -> torch.Tensor:
    """quantize_activation at `group`, exact integer group dots of xq with
    the integer weight values `vals` (float32 holds the dots exactly: |sum| <
    2^24), then dsub*dx per group, plus msub*sx where the scheme has a
    minimum -> (rows, m) f32. `vals` (m, k) and its scales are one plane for
    every row, or (rows, m, k) and (rows, m, groups) a plane per row (the
    plane form, gathered by `_rows`)."""
    xq, dx, sx = quantize_activation(x2, group)
    B, K = xq.shape
    m = vals.shape[-2]
    G = K // group
    if vals.dim() == 3:
        # group by group, so that only one group's values exist as float32
        # at a time (a whole stack of rows' planes would be gigabytes)
        xg = xq.float().reshape(B, G, group, 1)
        igt = torch.empty(B, G, m, dtype=torch.float32, device=x2.device)
        for g in range(G):
            igt[:, g] = torch.bmm(vals[:, :, g * group:(g + 1) * group].float(), xg[:, g])[..., 0]
        out = (igt.permute(0, 2, 1) * dx[:, None, :] * dsub.float()).sum(-1)
        return out if msub is None else out + torch.einsum("bg,bmg->bm", sx, msub.float())
    v = vals.float().reshape(m, G, group).permute(1, 2, 0)  # (G, group, m)
    xg = xq.float().reshape(B, G, group).permute(1, 0, 2)  # (G, B, group)
    ig = torch.bmm(xg, v).permute(1, 2, 0)  # (B, m, G) integer dots
    out = (ig * dx[:, None, :] * dsub.float()[None]).sum(-1)
    return out if msub is None else out + sx @ msub.float().t()


def _rows(plane, *planes):
    """The planes as they are, or with `plane` (rows,) each stack (E, m, ...)
    gathered to its row's plane (rows, m, ...), by a device-side index: no
    value is read on the host."""
    if plane is None:
        return planes
    idx = plane.long()
    return tuple(p[idx] for p in planes)


def qmm_w4a8_q8_0_plain(x2, qs, dsub, plane=None) -> torch.Tensor:
    """Plain version of qmm_w4a8 on Q8_0 planes: the int8 weights as they
    are, activations per 32-group, no minimum term -> (rows, m) f32. With
    `plane` (rows,) the planes are stacks (E, m, ...) and row b multiplies
    plane[b] (as for every form below)."""
    qs, dsub = _rows(plane, qs, dsub)
    return _w4a8_dense_plain(x2, qs, dsub, None, 32)


def qmm_w4a8_q6k_plain(x2, ql, qh, dsub, plane=None) -> torch.Tensor:
    """Plain version of qmm_w4a8 on Q6_K planes: the 6-bit values 0..63,
    activations per 16-group, and the offset as a minimum msub = -32*dsub
    (exact) times sx -> (rows, m) f32."""
    ql, qh, dsub = _rows(plane, ql, qh, dsub)
    return _w4a8_dense_plain(x2, q6k_values(ql, qh), dsub, -32.0 * dsub.float(), 16)


def qmm_w4a8_q5k_plain(x2, qs, qh, dsub, msub, plane=None) -> torch.Tensor:
    """Plain version of qmm_w4a8 on Q5_K planes: Q4_K's with the 5-bit
    values 0..31 -> (rows, m) f32."""
    qs, qh, dsub, msub = _rows(plane, qs, qh, dsub, msub)
    return _w4a8_dense_plain(x2, q5k_values(qs, qh), dsub, msub, 32)


def qmm_w4a8_q4_0_plain(x2, qs, dsub, plane=None) -> torch.Tensor:
    """Plain version of qmm_w4a8 on Q4_0 planes: the nibbles 0..15,
    activations per 32-group, and the offset as a minimum msub = -8*dsub
    (exact) times sx -> (rows, m) f32."""
    qs, dsub = _rows(plane, qs, dsub)
    return _w4a8_dense_plain(x2, nibbles(qs), dsub, -8.0 * dsub.float(), 32)


def qmm_w4a8_q5_0_plain(x2, qs, qh, dsub, plane=None) -> torch.Tensor:
    """Plain version of qmm_w4a8 on Q5_0 planes: the 5-bit values 0..31,
    activations per 32-group, and the offset as a minimum msub = -16*dsub
    (exact) times sx -> (rows, m) f32."""
    qs, qh, dsub = _rows(plane, qs, qh, dsub)
    return _w4a8_dense_plain(x2, q5k_values(qs, qh), dsub, -16.0 * dsub.float(), 32)


def qmm_w4a8_q2k_plain(x2, qs, scm, d, dmin, plane=None) -> torch.Tensor:
    """Plain version of qmm_w4a8 on Q2_K planes: the 2-bit values 0..3,
    activations per 16-group, dsub = d*sc and the minimum msub = -dmin*mn
    (exact) times sx -> (rows, m) f32."""
    qs, scm, d, dmin = _rows(plane, qs, scm, d, dmin)
    dsub, msub = k16_scales(GGMLType.Q2_K, {"scm": scm, "d": d, "dmin": dmin})
    return _w4a8_dense_plain(x2, q2_values(qs), dsub, msub, 16)


def qmm_w4a8_q3k_plain(x2, qs, hb, sc, d, plane=None) -> torch.Tensor:
    """Plain version of qmm_w4a8 on Q3_K planes: the 3-bit values 0..7,
    activations per 16-group, dsub = d*sc (signed) and the offset as a
    minimum msub = -4*dsub (exact) times sx -> (rows, m) f32."""
    qs, hb, sc, d = _rows(plane, qs, hb, sc, d)
    dsub, _ = k16_scales(GGMLType.Q3_K, {"sc": sc, "d": d})
    return _w4a8_dense_plain(x2, q3k_values(qs, hb), dsub, -4.0 * dsub, 16)


def qmm_w4a8_plain(x2, qs, dsub, msub, plane=None) -> torch.Tensor:
    """Plain version of qmm_w4a8 (Q4_K): quantize_activation, exact integer
    group dots, then dsub*dx per group plus msub*sx -> (rows, m) f32."""
    qs, dsub, msub = _rows(plane, qs, dsub, msub)
    return _w4a8_dense_plain(x2, nibbles(qs), dsub, msub, GROUP)


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
    """Whether augment_w8 attaches planes: a kernel-layout matmul (of any
    kernel kind, as the JAX augment_w8 takes every scheme) whose row count
    is a multiple of 256 (per expert for a stack)."""
    return qt.kind in KERNEL_KINDS and qt.kernel_layout and qt.m % 256 == 0


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


def qmm_q8_0_grouped_plain(xs, qs, dsub, offsets) -> torch.Tensor:
    """Plain version of qmm_q8_0_grouped: qmm_q8_0_plain per segment."""
    return _grouped_plain(xs, offsets, lambda r, e: qmm_q8_0_plain(r, qs[e], dsub[e]))


def qmm_q6k_grouped_plain(xs, ql, qh, dsub, offsets) -> torch.Tensor:
    """Plain version of qmm_q6k_grouped: qmm_q6k_plain per segment."""
    return _grouped_plain(xs, offsets, lambda r, e: qmm_q6k_plain(r, ql[e], qh[e], dsub[e]))


def qmm_q5k_grouped_plain(xs, qs, qh, dsub, msub, offsets) -> torch.Tensor:
    """Plain version of qmm_q5k_grouped: qmm_q5k_plain per segment."""
    return _grouped_plain(xs, offsets,
                          lambda r, e: qmm_q5k_plain(r, qs[e], qh[e], dsub[e], msub[e]))


def qmm_q5_0_grouped_plain(xs, qs, qh, dsub, offsets) -> torch.Tensor:
    """Plain version of qmm_q5_0_grouped: qmm_q5_0_plain per segment."""
    return _grouped_plain(xs, offsets, lambda r, e: qmm_q5_0_plain(r, qs[e], qh[e], dsub[e]))


def qmm_q4_0_grouped_plain(xs, qs, dsub, offsets) -> torch.Tensor:
    """Plain version of qmm_q4_0_grouped: qmm_q4_0_plain per segment."""
    return _grouped_plain(xs, offsets, lambda r, e: qmm_q4_0_plain(r, qs[e], dsub[e]))


def qmm_q3k_grouped_plain(xs, qs, hb, sc, d, offsets) -> torch.Tensor:
    """Plain version of qmm_q3k_grouped: qmm_q3k_plain per segment."""
    return _grouped_plain(xs, offsets, lambda r, e: qmm_q3k_plain(r, qs[e], hb[e], sc[e], d[e]))


def qmm_q2k_grouped_plain(xs, qs, scm, d, dmin, offsets) -> torch.Tensor:
    """Plain version of qmm_q2k_grouped: qmm_q2k_plain per segment."""
    return _grouped_plain(xs, offsets,
                          lambda r, e: qmm_q2k_plain(r, qs[e], scm[e], d[e], dmin[e]))


def _lib_dequant_f32(kind: GGMLType, grouped: bool = False):
    """The float32 entry of a scheme in csrc/qmm_f32.cu: qmm_<form>_f32 (x,
    the weight planes in _KERNEL_PLANES order, out, M, N, K, the plan's
    tile_rows, stream), or with `grouped` qmm_<form>_grouped_f32 (the same
    with offsets and the plane count after out)."""
    planes = [_P] * (2 + len(_KERNEL_PLANES[kind]))
    if grouped:
        return _build.entry("qmm_f32", f"{GROUPED_FORMS[kind]}_f32", *planes, _P, _I, _I, _I, _I,
                            _I, _P)
    return _build.entry("qmm_f32", DEQUANT_F32_FORMS[kind], *planes, _I, _I, _I, _I, _P)


def _lib_dequant(kind: GGMLType, grouped: bool = False):
    """The dequant entry of a scheme in csrc/<form>.cu: <form>_bf16 (x, the
    weight planes in _KERNEL_PLANES order, out, out_bf16, M, N, K, stream),
    or with `grouped` <form>_grouped_bf16 (the same with offsets and the
    plane count after out_bf16). The forms on csrc/qmm_ws.cuh (WS_FORMS)
    take the plan's tile_rows before the stream."""
    name = DEQUANT_FORMS[kind]
    planes = [_P] * (2 + len(_KERNEL_PLANES[kind]))
    plan = (_I,) if kind in WS_FORMS else ()
    if grouped:
        return _build.entry(name, f"{name}_grouped_bf16", *planes, _I, _P, _I, _I, _I, _I, *plan,
                            _P)
    return _build.entry(name, f"{name}_bf16", *planes, _I, _I, _I, _I, *plan, _P)


def _ws_args(kind: GGMLType, rows: int, m: int, n_planes: int = 0) -> tuple:
    """The launch plan's argument of a form on csrc/qmm_ws.cuh (tile_rows),
    or none for the forms on qmm_pipe.cuh."""
    return (qmm_ws_plan(rows, m, n_planes).tile_rows,) if kind in WS_FORMS else ()


def _lib_w4a8(kind: GGMLType, f32: bool = False):
    """The int8-activation entry of a scheme (qmm_w4a8_bf16 for Q4_K,
    qmm_w4a8_<scheme>_bf16 for the others; `f32`: the `_f32` entry, float32
    x and scale planes): x, the quantizer's scratch, the weight planes in
    _KERNEL_PLANES order, out, out_bf16, plane_idx, B, N, K, the grid,
    x_rows, stream."""
    entry = f"{W4A8_FORMS[kind]}_{'f32' if f32 else 'bf16'}"
    return _build.entry("qmm_w4a8", entry, *[_P] * (4 + len(_KERNEL_PLANES[kind]) + 1), _I, _P,
                        _I, _I, _I, _I, _I, _I, _P)


def _lib_w8():
    return _build.entry("qmm_w8", "qmm_w8_bf16", _P, _P, _P, _P, _I, _I, _I, _I, _P)


def _lib_w8_grouped():
    return _build.entry("qmm_w8", "qmm_w8_grouped_bf16", _P, _P, _P, _P, _I, _P, _I, _I, _I,
                        _I, _P)


@dataclass(frozen=True)
class W4A8Plan:
    """Shape of one qmm_w4a8 matmul launch (csrc/qmm_w4a8.cu). Block (x, y)
    owns output columns x*16 .. x*16+15, and row y alone in the plane form
    (all rows otherwise); warp w of it takes the superblocks (256-deep k
    steps) in `k_slices[w]` through its own ring of `stages` stages, each
    holding the 16 columns' weights and `x_rows` rows of x. The kernel takes
    `grid` and `x_rows`; `stages` and `smem_bytes` mirror the ring that the
    source derives from `x_rows`, and `k_slices` its warps' loop."""
    grid: tuple[int, int]  # (column tiles, row blocks)
    x_rows: int  # rows of x a stage holds: 1, 8 or 16
    n_tiles: int  # mma n8 tiles: x_rows over 8, rounded up
    stages: int
    k_slices: tuple[tuple[int, ...], ...]  # per warp, its superblocks in order
    smem_bytes: int  # the rings of the block's warps (dynamic shared memory)
    planes: bool  # one row a block, with that row's plane
    group: int  # k elements of a scale group: one mma k step (32, or 16: Q6_K, Q3_K, Q2_K)


# per scheme, one ring stage's bytes (csrc/qmm_w4a8.cu's scheme traits): the
# 16 columns' weights of a superblock, their scales, and per row of x its
# scales beside the 256 int8 values: dx and sx a group (dx alone for Q8_0)
_W4A8_STAGE = {
    GGMLType.Q4_K: (W4A8_COLS * W4A8_SB // 2, 2 * W4A8_COLS * 8 * 2, 2 * 8 * 4),
    GGMLType.Q8_0: (W4A8_COLS * W4A8_SB, W4A8_COLS * 8 * 2, 8 * 4),
    GGMLType.Q6_K: (W4A8_COLS * W4A8_SB * 3 // 4, W4A8_COLS * 16 * 2, 2 * 16 * 4),
    GGMLType.Q5_K: (W4A8_COLS * W4A8_SB // 2 + W4A8_COLS * W4A8_SB // 8, 2 * W4A8_COLS * 8 * 2,
                    2 * 8 * 4),
    GGMLType.Q4_0: (W4A8_COLS * W4A8_SB // 2, W4A8_COLS * 8 * 2, 2 * 8 * 4),
    GGMLType.Q3_K: (W4A8_COLS * W4A8_SB // 4 + W4A8_COLS * W4A8_SB // 8, W4A8_COLS * (16 + 4),
                    2 * 16 * 4),
    GGMLType.Q2_K: (W4A8_COLS * W4A8_SB // 4, W4A8_COLS * (16 + 2 * 4), 2 * 16 * 4),
    GGMLType.Q5_0: (W4A8_COLS * W4A8_SB // 2 + W4A8_COLS * W4A8_SB // 8, W4A8_COLS * 8 * 2,
                    2 * 8 * 4),
}
_SMEM_PER_SM = 228 * 1024  # H100: shared memory an SM holds, 1 KB of it reserved a block


def w4a8_stage_bytes(x_rows: int, kind: GGMLType = GGMLType.Q4_K, f32: bool = False) -> int:
    """One ring stage: the 16 columns' weights of a superblock (Q4_K and
    Q4_0: 2 KB of nibbles; Q5_K and Q5_0: 2.5 KB of nibbles | qh; Q8_0: 4 KB
    of int8; Q6_K: 3 KB of ql | qh; Q3_K: 1.5 KB of qs | hb; Q2_K: 1 KB of
    qs) and their scales (Q4_K and Q5_K: dsub and msub, 512 B; Q8_0, Q4_0
    and Q5_0: 256 B; Q6_K: 16 groups, 512 B; Q3_K: 16 sc bytes and a float32
    d a column, 320 B; Q2_K: 16 scm bytes and float32 d and dmin, 384 B),
    then per row of x its int8 values (256 B) and scales; a kind that runs
    another's form (FORM_KIND) has that form's stage. `f32`: the float32
    form, whose dsub / msub are twice as wide (Q3_K's and Q2_K's scales
    are the same either way)."""
    form = FORM_KIND[kind]
    w, sc, xs = _W4A8_STAGE[form]
    if f32 and form not in (GGMLType.Q3_K, GGMLType.Q2_K):
        sc *= 2
    return w + sc + x_rows * (W4A8_SB + xs)


def w4a8_stages(x_rows: int, kind: GGMLType = GGMLType.Q4_K, f32: bool = False) -> int:
    """Ring depth, as csrc/qmm_w4a8.cu's `stages_of`: the most stages, up to
    four, with which two blocks (the rings, the warps' partial sums and the
    reserved kilobyte each) still share an SM."""
    red = W4A8_WARPS * 4 * -(-x_rows // 8) * 32 * 4
    for stages in (4, 3):
        if 2 * (W4A8_WARPS * stages * w4a8_stage_bytes(x_rows, kind, f32) + red + 1024) \
                <= _SMEM_PER_SM:
            return stages
    return 2


@functools.lru_cache(maxsize=None)
def w4a8_plan(rows: int, m: int, k: int, planes: bool = False,
              kind: GGMLType = GGMLType.Q4_K, f32: bool = False) -> W4A8Plan:
    """The launch for `rows` (1..16) activation rows against an (m, k)
    weight of scheme `kind`, or against a row's own plane of a stack when
    `planes`; `f32`: the float32 form. A function of the shapes alone: it
    reads nothing on the device, so a CUDA graph can capture the launch.
    Memoized: the decode step asks for the same few plans at every call. A
    kind that runs another's form (FORM_KIND) has that form's plan."""
    per_block = 1 if planes else rows
    x_rows = 1 if per_block == 1 else 8 if per_block <= 8 else 16
    n_tiles = -(-x_rows // 8)
    stages = w4a8_stages(x_rows, kind, f32)
    nsb = k // W4A8_SB
    return W4A8Plan(
        grid=(-(-m // W4A8_COLS), rows if planes else 1), x_rows=x_rows, n_tiles=n_tiles,
        stages=stages,
        k_slices=tuple(tuple(range(w, nsb, W4A8_WARPS)) for w in range(W4A8_WARPS)),
        smem_bytes=W4A8_WARPS * stages * w4a8_stage_bytes(x_rows, kind, f32), planes=planes,
        group=SCHEME_GROUP[FORM_KIND[kind]])


def w4a8_block_reads(plan: W4A8Plan, bx: int, by: int, rows: int, m: int,
                     plane_idx: tuple[int, ...] | None = None) -> dict:
    """What block (bx, by) of `plan` reads and writes, as csrc/qmm_w4a8.cu's
    copy predicates and store decide it (this is their mirror, for the
    tests): `rows` the activation rows it loads and writes, `columns` the
    weight rows of its plane, `stack_rows` the same rows counted through the
    stack (plane * m + column: every plane a scheme reads, scales included,
    is read at these rows of a stack (E, m, ...); with `plane_idx` the plane
    form's row `by` takes plane plane_idx[by]), `groups` per warp the scale
    groups (`plan.group` elements each) it sums."""
    real = range(by, by + 1) if plan.planes else range(rows)
    col0 = bx * W4A8_COLS
    columns = range(col0, min(col0 + W4A8_COLS, m))
    wrow0 = plane_idx[by] * m if plan.planes and plane_idx is not None else 0
    per = W4A8_SB // plan.group
    return {
        "rows": real, "columns": columns,
        "stack_rows": range(wrow0 + columns.start, wrow0 + columns.stop),
        "groups": [[sb * per + g for sb in ks for g in range(per)] for ks in plan.k_slices],
    }


H100_SMS = 132  # streaming multiprocessors of the H100
F32_BW = 128  # weight rows (output columns) of a csrc/qmm_f32.cu block
F32_TILE_ROWS = (128, 96, 64, 32, 16)  # the rows of x a tile may hold, widest first
F32_STAGES = 3  # the x ring's depth (32-deep k steps)
# What a block's k step costs beside its tile's own rows, in rows of x: the
# weights' loads, conversion and split and the step's barrier do not shrink
# with the tile. Fitted to the tile sweep of tools/qmm_ablation.py f32 on the
# H100 (PERF.md): a block's time went as 125 + its wgmma width.
F32_STEP_ROWS = 125


@dataclass(frozen=True)
class F32Plan:
    """Shape of one csrc/qmm_f32.cu launch. Block (x, y) owns weight rows
    y*128 .. y*128+127 and row tile x: `tile_rows` rows of x (dense: rows
    x*tile_rows..; grouped: the x-th tile numbered through the segments,
    `qmm_f32_tiles`). The kernel takes `tile_rows`; `grid`, `stages` and
    `smem_bytes` mirror what the source derives (a slot of the ring holds a
    128-row x tile's hi and lo parts, 32 float32 of k each; beside the ring
    lie two 128 x 36 float32 weight exchange tiles and the 128 x 132 float32
    total of the chunks' sums)."""
    tile_rows: int
    grid: tuple[int, int]  # (row tiles, weight tiles); grouped: row tiles for the worst case
    blocks: int  # dense row tiles x weight tiles: the blocks a dense launch fills
    stages: int
    smem_bytes: int


def f32_wgmma_width(rows: int) -> int:
    """The wgmma N a csrc/qmm_f32.cu tile of `rows` rows takes: 16, 32, 64,
    96 or 128, the least that holds them."""
    return next(n for n in (16, 32, 64, 96, 128) if n >= rows)


def f32_plan_cost(rows: int, m: int, tile: int) -> int:
    """The time of a dense launch with `tile`-row tiles, in units of one
    k step of one row: whole waves of blocks over the H100's SMs (one block
    an SM: its registers), each as long as its widest tile's wgmma width plus
    F32_STEP_ROWS."""
    blocks = -(-rows // tile) * -(-m // F32_BW)
    return -(-blocks // H100_SMS) * (F32_STEP_ROWS + f32_wgmma_width(min(tile, rows)))


@functools.lru_cache(maxsize=None)
def qmm_f32_plan(rows: int, m: int, n_planes: int = 0) -> F32Plan:
    """The launch for `rows` float32 activation rows against an m-row
    weight (or, with `n_planes` > 0, a stack of that many): the tile in
    F32_TILE_ROWS of least `f32_plan_cost` (every tile runs the same k
    steps), the wider one of a tie. A function of the shapes alone: it reads
    nothing on the device, so a CUDA graph can capture the launch. A grouped
    launch sizes its grid for the worst case (each segment may end in a short
    tile); its tile is chosen by the dense count."""
    cols = -(-m // F32_BW)
    tile = min(F32_TILE_ROWS, key=lambda t: (f32_plan_cost(rows, m, t), -t))
    row_tiles = -(-rows // tile) + n_planes
    smem = F32_STAGES * 2 * 128 * 32 * 4 + 2 * F32_BW * 36 * 4 + 128 * (F32_BW + 4) * 4 + 1024
    return F32Plan(tile_rows=tile, grid=(row_tiles, cols), blocks=-(-rows // tile) * cols,
                   stages=F32_STAGES, smem_bytes=smem)


def qmm_f32_tiles(plan: F32Plan, rows: int, offsets=None) -> list:
    """The rows each block row of `plan` takes, as csrc/qmm_f32.cu finds
    them (qmm_tiles.cuh::find_tile, cut to the plan's tile): per blockIdx.x,
    (first row, one past the last, plane), or None for a block with no tile
    (the grouped grid is sized for the worst case). Dense when `offsets` is
    None, else grouped over the segments of `offsets` (n_planes + 1 ints)."""
    return _find_tiles(plan.tile_rows, plan.grid[0], rows, offsets)


def _find_tiles(tr: int, count: int, rows: int, offsets=None) -> list:
    """csrc/qmm_tiles.cuh::find_tile for blockIdx.x 0..count-1 and tiles of
    `tr` rows, each cut to tr rows: (first row, one past the last, plane) or
    None."""
    out = []
    for t in range(count):
        if offsets is None:
            found = (t * tr, rows, 0) if t * tr < rows else None
        else:
            found = None
            for e in range(len(offsets) - 1):
                lo, hi = int(offsets[e]), int(offsets[e + 1])
                nt = -(-(hi - lo) // tr)
                if t < nt:
                    found = (lo + t * tr, hi, e)
                    break
                t -= nt
        out.append(None if found is None else (found[0], min(found[1], found[0] + tr), found[2]))
    return out


# csrc/qmm_ws.cuh, the warp-specialized loop of qmm_q5k, qmm_q6k, qmm_q3k and
# qmm_q2k (dense and grouped): a block is a producer and two consumer
# warpgroups, 128 weight rows (64 a consumer) by a tile of up to 256 rows of x
WS_FORMS = (GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.Q3_K, GGMLType.Q2_K)
WS_WIDTHS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256)  # the wgmma widths of a tile
WS_TILE_ROWS = (256, 192, 128, 96, 64, 48, 32, 24, 16, 8)  # tile heights a plan may pick
WS_BW = 128  # weight rows a block
WS_SMEM_MAX = 232_448  # the H100's shared memory a block
# The cost model's two constants, in rows of x: what a k step costs beside its
# tile's own rows (the weights' conversion and the slots' waits do not shrink
# with the tile), and what each row tile of a column costs beyond the first
# (its blocks convert the same weights again). Fitted to the tile sweep of
# tools/qmm_ablation.py ws on the H100, 22 shapes of Q5_K and Q3_K (PERF.md):
# the most shapes whose pick ran within 3% of their fastest, then the least
# worst miss, then least squares of the log times. The sweep of Q6_K and Q2_K
# at the same shapes keeps them: one pair serves the four forms, each pick
# within 3% of the fastest but at 189 rows of wo (Q3_K 3.7%, Q6_K 3.2%).
WS_STEP_ROWS = 192
WS_TILE_COST = 24
# per form: (bytes a step slot holds beside the x tile, bytes a superblock
# slot), as each source declares them
_WS_SLOTS = {GGMLType.Q5_K: (0, 128 * 192), GGMLType.Q6_K: (0, 128 * 112),
             GGMLType.Q3_K: (0, 15 * 1024), GGMLType.Q2_K: (0, 11 * 1024)}
# per form: the k steps a superblock slot holds (SB_STEPS): a 256-deep
# superblock, or Q6_K's 128-element half, the unit of its bit order
_WS_SLOT_STEPS = {GGMLType.Q5_K: 4, GGMLType.Q6_K: 2, GGMLType.Q3_K: 4, GGMLType.Q2_K: 4}
WS_MAX_STAGES, WS_MAX_SB = 16, 6  # the barriers' room


@dataclass(frozen=True)
class WSPlan:
    """Shape of one csrc/qmm_ws.cuh launch. Block (x, y) owns weight rows
    y*128 .. y*128+127 and row tile x: `tile_rows` rows of x (dense: rows
    x*tile_rows..; grouped: the x-th tile numbered through the segments,
    `qmm_ws_tiles`). The kernel takes `tile_rows`."""
    tile_rows: int
    grid: tuple[int, int]  # (row tiles, weight tiles); grouped: row tiles for the worst case
    blocks: int  # dense row tiles x weight tiles: the blocks a dense launch fills
    width: int  # the wgmma N of a whole tile


def ws_width(rows: int) -> int:
    """The wgmma N a csrc/qmm_ws.cuh tile of `rows` rows takes: the least of
    WS_WIDTHS that holds them."""
    return next(n for n in WS_WIDTHS if n >= rows)


def ws_plan_cost(rows: int, m: int, tile: int) -> int:
    """The time of a dense launch with `tile`-row tiles, in units of one k
    step of one row: whole waves of blocks over the H100's SMs (one block an
    SM: its registers), each as long as its widest tile's wgmma width plus
    WS_STEP_ROWS, and WS_TILE_COST for each row tile."""
    tiles = -(-rows // tile)
    waves = -(-(tiles * -(-m // WS_BW)) // H100_SMS)
    return waves * (WS_STEP_ROWS + ws_width(min(tile, rows))) + WS_TILE_COST * tiles


@functools.lru_cache(maxsize=None)
def qmm_ws_plan(rows: int, m: int, n_planes: int = 0) -> WSPlan:
    """The launch for `rows` bf16 activation rows against an m-row weight
    (or, with `n_planes` > 0, a stack of that many) on csrc/qmm_ws.cuh: the
    tile height in WS_TILE_ROWS of least `ws_plan_cost`; of a tie, the one
    whose tiles are widest (fewer conversions of each weight), then the lower
    (a tile taller than the rows only makes the ring's slots larger). A
    function of the shapes alone: it reads nothing on the device, so a CUDA
    graph can capture the launch. A grouped launch sizes its grid for the
    worst case (each segment may end in a short tile); its tile is chosen by
    the dense count."""
    tile = min(WS_TILE_ROWS,
               key=lambda t: (ws_plan_cost(rows, m, t), -ws_width(min(t, rows)), t))
    cols = -(-m // WS_BW)
    return WSPlan(tile_rows=tile, grid=(-(-rows // tile) + n_planes, cols),
                  blocks=-(-rows // tile) * cols, width=ws_width(min(tile, rows)))


def qmm_ws_tiles(plan: WSPlan, rows: int, offsets=None) -> list:
    """The rows each block row of `plan` takes, as csrc/qmm_ws.cuh finds them
    (qmm_tiles.cuh::find_tile): per blockIdx.x, (first row, one past the
    last, plane), or None (the grouped grid is sized for the worst case)."""
    return _find_tiles(plan.tile_rows, plan.grid[0], rows, offsets)


def qmm_ws_ring(kind: GGMLType, tile_rows: int) -> tuple[int, int, int]:
    """(stages, superblock slots, shared memory bytes in use) of
    csrc/qmm_ws.cuh's rings for the form of `kind` at a tile of `tile_rows`
    rows, as qws::ring_shape derives them: the most stages, up to 16, of the
    tile's x boxes (`ws_x_box` rows each) and the source's step bytes, beside
    stages / SB_STEPS + 2 superblock slots (up to 6; SB_STEPS 4, Q6_K's 2),
    within the block's shared memory less 512 bytes of barriers and 1,024 of
    alignment. The block asks for all of it."""
    step, sb = _WS_SLOTS[FORM_KIND[kind]]
    sb_steps = _WS_SLOT_STEPS[FORM_KIND[kind]]
    box = ws_x_box(tile_rows)
    stage = -(-tile_rows // box) * box * 64 * 2 + step
    room = WS_SMEM_MAX - 1024 - 512
    for stages in range(WS_MAX_STAGES, 2, -1):
        slots = min(WS_MAX_SB, stages // sb_steps + 2)
        if stages * stage + slots * sb <= room:
            break
    return stages, slots, stages * stage + slots * sb + 512 + 1024


def ws_x_box(tile_rows: int) -> int:
    """The rows of x a TMA box holds at a tile of `tile_rows` rows
    (qws::x_box): the tile's height up to 64."""
    return min(tile_rows, 64)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of csrc/wgmma.cuh's tf32_split, used by tests and
    chip_smoke.py: float32 x -> (hi, lo), hi = x rounded to TF32 (to nearest,
    ties away from zero, as cvt.rna.tf32.f32 rounds finite values: the 13 low
    bits clear), lo = x - hi (exact in float32) rounded the same way; |x - hi
    - lo| <= 2^-22 |x| for normal x."""
    def rna(v):  # on the magnitude's bits; infinities and NaNs pass as they are
        bits = v.contiguous().view(torch.int32)
        mag = bits & 0x7FFFFFFF
        mag = torch.where(mag < 0x7F800000, (mag + 0x1000) & 0x7FFFE000, mag)
        return ((bits & -0x80000000) | mag).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def qmm_f32_split_plain(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The arithmetic of csrc/qmm_f32.cu on the CPU, for tests and
    chip_smoke.py: x2 (rows, k) float32 @ w^T for exact float32 weights w (m,
    k), both split by `tf32_split`, in three passes: w_lo x_hi + w_hi x_lo +
    w_hi x_hi (each TF32 product exact in float32, sums in float32); the
    dropped w_lo x_lo is ~2^-22 of each product -> (rows, m) f32."""
    xh, xl = tf32_split(x2)
    wh, wl = tf32_split(w)
    return xh @ wl.t() + xl @ wh.t() + xh @ wh.t()


def qmm_f32_grouped_split_plain(xs: torch.Tensor, w: torch.Tensor,
                                offsets: torch.Tensor) -> torch.Tensor:
    """qmm_f32_split_plain per segment [offsets[e], offsets[e+1]) of the
    sorted rows against plane e of the exact float32 stack w (E, m, k)."""
    return _grouped_plain(xs, offsets, lambda r, e: qmm_f32_split_plain(r, w[e]))


# per scheme, its kernel planes: name -> (k elements a plane element, dtype)
_KERNEL_PLANES = {
    GGMLType.Q4_K: {"qs": (2, torch.uint8), "dsub": (32, torch.bfloat16),
                    "msub": (32, torch.bfloat16)},
    GGMLType.Q8_0: {"qs": (1, torch.int8), "dsub": (32, torch.bfloat16)},
    GGMLType.Q6_K: {"ql": (2, torch.uint8), "qh": (4, torch.uint8),
                    "dsub": (16, torch.bfloat16)},
    GGMLType.Q5_K: {"qs": (2, torch.uint8), "qh": (8, torch.uint8), "dsub": (32, torch.bfloat16),
                    "msub": (32, torch.bfloat16)},
    GGMLType.Q4_0: {"qs": (2, torch.uint8), "dsub": (32, torch.bfloat16)},
    GGMLType.Q3_K: {"qs": (4, torch.uint8), "hb": (8, torch.uint8), "sc": (16, torch.int8),
                    "d": (256, torch.float32)},
    GGMLType.Q2_K: {"qs": (4, torch.uint8), "scm": (16, torch.uint8), "d": (256, torch.float32),
                    "dmin": (256, torch.float32)},
    GGMLType.Q5_0: {"qs": (2, torch.uint8), "qh": (8, torch.uint8), "dsub": (32, torch.bfloat16)},
}


def _fit_k(x2: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x2 (rows, k) zero-padded to the depth of `qt`'s kernel planes
    (`plane_k`: past k where a legacy weight's rows end inside a superblock);
    x2 of that depth passes as it is."""
    _build.require(x2.shape[-1] in (qt.k, qt.plane_k),
                   f"x of depth {x2.shape[-1]} for a weight of shape {qt.shape}")
    return _pad_k(x2, qt.plane_k)


def _check_weight(qt: QTensor, k: int, device: torch.device, stacked: bool = False,
                  form: GGMLType = GGMLType.Q4_K, scale_dtype=torch.bfloat16):
    """Checks that `qt` holds the kernel planes of the form `form` (a weight
    of any kind that runs it: Q4_1 weights run Q4_K's forms) for a k-deep
    product (k = the planes' depth, whole superblocks: a padded legacy
    weight's `plane_k`), its dsub / msub planes in `scale_dtype` (the
    float32 forms take float32 ones); returns them in the order the C
    entries take them."""
    p = qt.planes
    _build.require(FORM_KIND.get(qt.kind) == form and qt.kernel_layout,
                   f"{qt.kind.name}: this matmul takes {form.name} kernel planes")
    _build.require(qt.stacked == stacked,
                   f"weight of shape {qt.shape}: expected {'a stack of planes' if stacked else 'one plane'}")
    _build.require(qt.plane_k == k and k % 256 == 0, f"k={k} vs weight {qt.shape}")
    lead = qt.shape[:-1]
    spec = {n: (per, scale_dtype if n in ("dsub", "msub") else dt)
            for n, (per, dt) in _KERNEL_PLANES[form].items()}
    _build.require(all(n in p and p[n].shape == (*lead, k // per) for n, (per, _) in spec.items()),
                   f"weight planes do not match the shape {qt.shape}")
    _build.require(all(p[n].dtype == dt for n, (_, dt) in spec.items()),
                   "the CUDA matmuls take " + ", ".join(f"{dt} {n}" for n, (_, dt) in spec.items()))
    planes = [p[n] for n in spec]
    for t in planes:
        _build.require(t.device == device and t.is_contiguous(),
                       "weight planes must be contiguous on the activations' card")
    return planes


def _check_w8(qt: QTensor, k: int, device: torch.device, stacked: bool = False):
    """Checks the W8 planes of `qt`; returns their padded k."""
    p = qt.planes
    _build.require("w8" in p and "dw" in p, "this weight carries no W8 planes")
    _build.require(qt.stacked == stacked,
                   f"weight of shape {qt.shape}: expected {'a stack of planes' if stacked else 'one plane'}")
    kpad = -(-qt.k // W8_KSC) * W8_KSC
    lead = qt.shape[:-1]
    _build.require(k in (qt.k, qt.plane_k) and k <= kpad and p["w8"].shape == (*lead, kpad)
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


def _dequant_matmul_f32(kind: GGMLType, x2: torch.Tensor, qt: QTensor, out_dtype) -> torch.Tensor:
    """Launch the float32 dequant kernel of scheme `kind` (csrc/qmm_f32.cu)."""
    name = DEQUANT_F32_FORMS[kind]
    rows, k = x2.shape
    planes = _check_weight(qt, k, x2.device, form=kind, scale_dtype=torch.float32)
    _build.require(out_dtype == torch.float32, f"{name} writes float32, not {out_dtype}")
    _build.require(all(t.data_ptr() % 16 == 0 for t in planes),
                   f"{name} reads the weight planes 16 bytes at a time: align them to 16")
    x2 = _aligned(x2)
    out = torch.empty(rows, qt.m, dtype=torch.float32, device=x2.device)
    lib, fn = _lib_dequant_f32(kind)
    _build.launches[name] += 1
    err = fn(x2.data_ptr(), *(t.data_ptr() for t in planes), out.data_ptr(), rows, qt.m, k,
             qmm_f32_plan(rows, qt.m).tile_rows, _build.stream_ptr(x2))
    _build.check(lib, err, name)
    return out


def _dequant_matmul(kind: GGMLType, x2: torch.Tensor, qt: QTensor, out_dtype) -> torch.Tensor:
    """Launch the dense dequant kernel of scheme `kind` on the card: the
    float32 form for float32 x, else the bfloat16 one."""
    if x2.dtype == torch.float32:
        return _dequant_matmul_f32(kind, x2, qt, out_dtype)
    name = DEQUANT_FORMS[kind]
    rows, k = x2.shape
    planes = _check_weight(qt, k, x2.device, form=kind)
    _build.require(x2.dtype == torch.bfloat16,
                   f"{name} takes bfloat16 or float32 activations, got {x2.dtype}")
    _build.require(all(t.data_ptr() % 16 == 0 for t in planes),
                   f"{name} copies the weight planes 16 bytes at a time: align them to 16")
    out_bf16 = _out_bf16(out_dtype)
    x2 = _aligned(x2)
    out = torch.empty(rows, qt.m, dtype=out_dtype, device=x2.device)
    lib, fn = _lib_dequant(kind)
    _build.launches[name] += 1
    err = fn(x2.data_ptr(), *(t.data_ptr() for t in planes), out.data_ptr(), out_bf16, rows,
             qt.m, k, *_ws_args(kind, rows, qt.m), _build.stream_ptr(x2))
    _build.check(lib, err, name)
    return out


# the dequant kernel of each form: its wrapper, launch counter and source
DEQUANT_FORMS = {GGMLType.Q4_K: "qmm_q4k", GGMLType.Q8_0: "qmm_q8_0", GGMLType.Q6_K: "qmm_q6k",
                 GGMLType.Q5_K: "qmm_q5k", GGMLType.Q4_0: "qmm_q4_0", GGMLType.Q3_K: "qmm_q3k",
                 GGMLType.Q2_K: "qmm_q2k", GGMLType.Q5_0: "qmm_q5_0"}
# the float32 dequant kernel of each form (csrc/qmm_f32.cu): its entry and launch counter
DEQUANT_F32_FORMS = {kind: f"{name}_f32" for kind, name in DEQUANT_FORMS.items()}


def _dequant_form(kind: GGMLType):
    """The wrapper of `kind`'s dequant kernel, named as DEQUANT_FORMS says:
    (x2 (rows, k), qt, out_dtype=float32) -> x2 @ W^T (rows, m), float32 sums
    rounded once to `out_dtype`, for a weight of any kind whose FORM_KIND is
    `kind`; float32 x (with float32 scale planes) takes the float32 form,
    float32 out. On a CPU tensor it computes the plain version
    (`<name>_plain`, on the planes in _KERNEL_PLANES order), which for
    float32 x is the float32 form's."""
    name = DEQUANT_FORMS[kind]

    def wrapper(x2: torch.Tensor, qt: QTensor, out_dtype=torch.float32) -> torch.Tensor:
        x2 = _fit_k(x2, qt)
        if not x2.is_cuda:
            plain = globals()[f"{name}_plain"]
            return plain(x2, *(qt.planes[n] for n in _KERNEL_PLANES[kind])).to(out_dtype)
        return _dequant_matmul(kind, x2, qt, out_dtype)

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = (f"x2 (rows, k) @ W^T -> (rows, m) through the {kind.name} dequant kernel; "
                       "float32 sums, rounded once to `out_dtype`.")
    return wrapper


qmm_q4k = _dequant_form(GGMLType.Q4_K)
qmm_q8_0 = _dequant_form(GGMLType.Q8_0)
qmm_q6k = _dequant_form(GGMLType.Q6_K)
qmm_q5k = _dequant_form(GGMLType.Q5_K)
qmm_q4_0 = _dequant_form(GGMLType.Q4_0)
qmm_q5_0 = _dequant_form(GGMLType.Q5_0)
qmm_q3k = _dequant_form(GGMLType.Q3_K)
qmm_q2k = _dequant_form(GGMLType.Q2_K)


# the int8-activation form of each form kind: its launch counter, and with
# "_plain" its plain version (taking the planes in _KERNEL_PLANES order)
W4A8_FORMS = {GGMLType.Q4_K: "qmm_w4a8", GGMLType.Q8_0: "qmm_w4a8_q8_0",
              GGMLType.Q6_K: "qmm_w4a8_q6k", GGMLType.Q5_K: "qmm_w4a8_q5k",
              GGMLType.Q4_0: "qmm_w4a8_q4_0", GGMLType.Q3_K: "qmm_w4a8_q3k",
              GGMLType.Q2_K: "qmm_w4a8_q2k", GGMLType.Q5_0: "qmm_w4a8_q5_0"}


def qmm_w4a8(x2: torch.Tensor, qt: QTensor, out_dtype=torch.float32,
             plane: torch.Tensor | None = None) -> torch.Tensor:
    """x2 (rows <= 16, k) @ W^T -> (rows, m), W of any kernel-layout scheme:
    activations quantize to int8 per scale group of the scheme (32, or 16
    for Q6_K, Q3_K and Q2_K) in a first kernel, chained to the scheme's
    integer matmul by programmatic dependent launch; float32 sums, rounded once to
    `out_dtype`. With `plane` (rows,) int32, `qt` is a stack (E, m, k) and
    row b multiplies plane[b], read on the device. The launch is
    `w4a8_plan`'s; each form counts its launches under its `W4A8_FORMS`
    name, and those of the plane form under that name + ".planes". Float32
    x takes the float32 form (the quantizer on float32 x, float32 dsub /
    msub planes, float32 out), counted with ".f32" after that."""
    kind = FORM_KIND.get(qt.kind)
    x2 = _fit_k(x2, qt)
    if not x2.is_cuda:
        plain = globals()[f"{W4A8_FORMS[kind]}_plain"]
        return plain(x2, *(qt.planes[n] for n in _KERNEL_PLANES[kind]),
                     plane=plane).to(out_dtype)
    rows, k = x2.shape
    _build.require(kind in W4A8_FORMS,
                   f"{qt.kind.name}: qmm_w4a8 takes "
                   + ", ".join(f.name for f in FORM_KIND) + " planes")
    _build.require(x2.dtype in (torch.bfloat16, torch.float32),
                   f"qmm_w4a8 takes bfloat16 or float32 activations, got {x2.dtype}")
    f32 = x2.dtype == torch.float32
    planes = _check_weight(qt, k, x2.device, stacked=plane is not None, form=kind,
                           scale_dtype=x2.dtype)
    if plane is not None:
        _build.require(plane.dtype == torch.int32 and plane.shape == (rows,)
                       and plane.device == x2.device and plane.is_contiguous(),
                       "plane: one int32 per row, on the activations' card")
    _build.require(1 <= rows <= W4A8_MAX_ROWS, f"qmm_w4a8 takes 1..{W4A8_MAX_ROWS} rows, got {rows}")
    _build.require(not f32 or out_dtype == torch.float32,
                   f"qmm_w4a8's float32 form writes float32, not {out_dtype}")
    _build.require(all(t.data_ptr() % 16 == 0 for t in planes),
                   "qmm_w4a8 copies the weight planes 16 bytes at a time: align them to 16")
    out_bf16 = _out_bf16(out_dtype)
    x2 = _aligned(x2)
    dev = x2.device
    xq = torch.empty(rows, k, dtype=torch.int8, device=dev)
    dx = torch.empty(rows, k // SCHEME_GROUP[kind], dtype=torch.float32, device=dev)
    sx = torch.empty_like(dx)
    out = torch.empty(rows, qt.m, dtype=out_dtype, device=dev)
    plan = w4a8_plan(rows, qt.m, k, planes=plane is not None, kind=kind, f32=f32)
    name = W4A8_FORMS[kind] + ("" if plane is None else ".planes") + (".f32" if f32 else "")
    lib, fn = _lib_w4a8(kind, f32)
    _build.launches[name] += 1
    err = fn(x2.data_ptr(), xq.data_ptr(), dx.data_ptr(), sx.data_ptr(),
             *(t.data_ptr() for t in planes), out.data_ptr(), out_bf16,
             None if plane is None else plane.data_ptr(), rows, qt.m, k, *plan.grid,
             plan.x_rows, _build.stream_ptr(x2))
    _build.check(lib, err, name)
    return out


def _pad_k(x2: torch.Tensor, kpad: int) -> torch.Tensor:
    return x2 if x2.shape[1] == kpad else F.pad(x2, (0, kpad - x2.shape[1]))


def qmm_w8(x2: torch.Tensor, qt: QTensor, out_dtype=torch.float32) -> torch.Tensor:
    """x2 (rows, k) @ W^T -> (rows, m) through the W8 planes of `qt`: per
    512-chunk the bf16 product in float32, times the chunk's scale; float32
    sums, rounded once to `out_dtype`. Float32 x is rounded to bfloat16
    first, as the JAX package rounds it (gemm_quant.py:967)."""
    p = qt.planes
    if not x2.is_cuda:
        return qmm_w8_plain(x2, p["w8"], p["dw"]).to(out_dtype)
    rows, k = x2.shape
    kpad = _check_w8(qt, k, x2.device)
    _build.require(x2.dtype in (torch.bfloat16, torch.float32),
                   f"qmm_w8 takes bfloat16 or float32 activations, got {x2.dtype}")
    x2 = x2.to(torch.bfloat16)
    out_bf16 = _out_bf16(out_dtype)
    x2 = _aligned(_pad_k(x2, kpad))
    out = torch.empty(rows, qt.m, dtype=out_dtype, device=x2.device)
    lib, fn = _lib_w8()
    _build.launches["qmm_w8"] += 1
    err = fn(x2.data_ptr(), p["w8"].data_ptr(), p["dw"].data_ptr(), out.data_ptr(), out_bf16,
             rows, qt.m, kpad, _build.stream_ptr(x2))
    _build.check(lib, err, "qmm_w8")
    return out


# the grouped dequant kernel of each form: its wrapper, launch counter and,
# with "_plain", its plain version
GROUPED_FORMS = {kind: f"{name}_grouped" for kind, name in DEQUANT_FORMS.items()}


def _grouped_form(kind: GGMLType):
    """The wrapper of `kind`'s grouped dequant kernel, named as GROUPED_FORMS
    says: (xs (rows, k) sorted by plane, qt a stack (E, m, k), offsets (E +
    1,) int32 with each plane's first row (offsets[E] == rows), out_dtype)
    -> (rows, m): rows [offsets[e], offsets[e+1]) multiply plane e. The
    kernel reads the offsets on the device; a segment may be empty or
    ragged. Float32 xs (with float32 scale planes) takes the float32 form
    of csrc/qmm_f32.cu, float32 out, counted as `<name>.f32`. On a CPU
    tensor it computes the plain version, which for float32 xs is the
    float32 form's."""
    name = GROUPED_FORMS[kind]

    def wrapper(xs: torch.Tensor, qt: QTensor, offsets: torch.Tensor,
                out_dtype=torch.float32) -> torch.Tensor:
        xs = _fit_k(xs, qt)
        if not xs.is_cuda:
            plain = globals()[f"{name}_plain"]
            return plain(xs, *(qt.planes[n] for n in _KERNEL_PLANES[kind]),
                         offsets).to(out_dtype)
        rows, k = xs.shape
        _build.require(xs.dtype in (torch.bfloat16, torch.float32),
                       f"{name} takes bfloat16 or float32 activations, got {xs.dtype}")
        f32 = xs.dtype == torch.float32
        planes = _check_weight(qt, k, xs.device, stacked=True, form=kind, scale_dtype=xs.dtype)
        _check_offsets(offsets, qt, xs.device)
        _build.require(not f32 or out_dtype == torch.float32,
                       f"{name}'s float32 form writes float32, not {out_dtype}")
        _build.require(all(t.data_ptr() % 16 == 0 for t in planes),
                       f"{name} copies the weight planes 16 bytes at a time: align them to 16")
        out_bf16 = _out_bf16(out_dtype)
        xs = _aligned(xs)
        out = torch.empty(rows, qt.m, dtype=out_dtype, device=xs.device)
        counter = f"{name}.f32" if f32 else name
        _build.launches[counter] += 1
        if f32:
            lib, fn = _lib_dequant_f32(kind, grouped=True)
            err = fn(xs.data_ptr(), *(t.data_ptr() for t in planes), out.data_ptr(),
                     offsets.data_ptr(), qt.shape[0], rows, qt.m, k,
                     qmm_f32_plan(rows, qt.m, qt.shape[0]).tile_rows, _build.stream_ptr(xs))
        else:
            lib, fn = _lib_dequant(kind, grouped=True)
            err = fn(xs.data_ptr(), *(t.data_ptr() for t in planes), out.data_ptr(), out_bf16,
                     offsets.data_ptr(), qt.shape[0], rows, qt.m, k,
                     *_ws_args(kind, rows, qt.m, qt.shape[0]), _build.stream_ptr(xs))
        _build.check(lib, err, counter)
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = (f"Grouped {DEQUANT_FORMS[kind]}: xs sorted by plane, each segment "
                       f"[offsets[e], offsets[e+1]) against plane e of a {kind.name} stack.")
    return wrapper


qmm_q4k_grouped = _grouped_form(GGMLType.Q4_K)
qmm_q8_0_grouped = _grouped_form(GGMLType.Q8_0)
qmm_q6k_grouped = _grouped_form(GGMLType.Q6_K)
qmm_q5k_grouped = _grouped_form(GGMLType.Q5_K)
qmm_q4_0_grouped = _grouped_form(GGMLType.Q4_0)
qmm_q5_0_grouped = _grouped_form(GGMLType.Q5_0)
qmm_q3k_grouped = _grouped_form(GGMLType.Q3_K)
qmm_q2k_grouped = _grouped_form(GGMLType.Q2_K)


def qmm_w8_grouped(xs: torch.Tensor, qt: QTensor, offsets: torch.Tensor,
                   out_dtype=torch.float32) -> torch.Tensor:
    """Grouped qmm_w8: as qmm_q4k_grouped on the W8 planes of the stack.
    Float32 xs is rounded to bfloat16 first, as the JAX package's
    qmatmul_grouped rounds it (gemm_quant.py:896-903)."""
    p = qt.planes
    if not xs.is_cuda:
        return qmm_w8_grouped_plain(xs, p["w8"], p["dw"], offsets).to(out_dtype)
    rows, k = xs.shape
    kpad = _check_w8(qt, k, xs.device, stacked=True)
    _check_offsets(offsets, qt, xs.device)
    _build.require(xs.dtype in (torch.bfloat16, torch.float32),
                   f"qmm_w8_grouped takes bfloat16 or float32 activations, got {xs.dtype}")
    out_bf16 = _out_bf16(out_dtype)
    xs = _aligned(_pad_k(xs.to(torch.bfloat16), kpad))
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
    planes when `w8` and the stack carries them (float32 xs rounded to
    bfloat16 there, float32 out), else through the grouped dequant kernel of
    the stack's scheme, its float32 form for float32 xs. (The JAX package's
    qmatmul_grouped tests its padded row count against W8_MIN_ROWS; the
    caller decides here, see models/forward.py.)"""
    if w8 and "w8" in qt.planes:
        return qmm_w8_grouped(xs, qt, offsets, xs.dtype)
    return globals()[GROUPED_FORMS[FORM_KIND[qt.kind]]](xs, qt, offsets, xs.dtype)


def route(rows: int, has_w8: bool, kind: GGMLType = GGMLType.Q4_K) -> str:
    """The kernel the JAX package's qmatmul_pallas picks under its `w4a8`
    backend: by the row count padded up to a multiple of 8, so the W8 planes
    take over from 249 real rows. Returns the wrapper's name: qmm_w4a8
    (every scheme), qmm_w8, or the scheme's dequant kernel."""
    padded = -(-rows // ROW_PAD) * ROW_PAD
    if padded <= W4A8_MAX_ROWS:
        return "qmm_w4a8"
    if has_w8 and padded >= W8_MIN_ROWS:
        return "qmm_w8"
    return DEQUANT_FORMS[FORM_KIND[kind]]


def qmatmul_quant(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (..., k) @ W^T -> (..., m) in x's dtype for a kernel-layout weight
    (any of KERNEL_KINDS), routed by row count, by whether `qt` carries W8
    planes and by its scheme (`route`). The kernels write x's dtype
    themselves, so no cast follows them.

    Activations quantize from x already in the compute dtype, as the JAX
    package's qmatmul_pallas does (gemm_quant.py:941,959)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, qt.k)
    wrapper = globals()[route(x2.shape[0], "w8" in qt.planes, qt.kind)]
    return wrapper(x2, qt, x.dtype).reshape(*lead, qt.m)

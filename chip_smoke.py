#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (crabml_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py    # needs one CUDA card; takes no arguments

It runs every phase, each of which fails the run (exit code 1) when a check
fails:

1. build: every csrc/*.cu kernel compiles with nvcc for sm_90a (one process
   per source, all started together) and loads through ctypes.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the 7B main path and of 8-slot serving (every form of the
   decode-attention kernel: dense and paged, bfloat16 and int8, softcap,
   window, the step's keys in the cache or in their own block) and of the
   Mixtral path (the W8 matmul at a 512-row chunk; the grouped Q4_K and W8
   matmuls on 1,024 (row, slot) pairs over 8 experts, one of them empty and
   the segments ragged; the int8-activation matmul with a plane per row),
   with the tolerance printed;
   the kernel's time (CUDA events, L2 flushed before each launch), the plain
   version's, one PyTorch library call's computing the same function, and
   the least time the card could take (bytes over 3.35 TB/s or operations
   over the peak rate of their type, whichever is larger).
3. forward: the 7B shape cut to 2 layers, the same weights loaded twice:
   the card (kernels, bfloat16) against the CPU (plain versions, float32)
   for a 16-token prompt and one decode step.
4. serving forward: the same 2-layer model, one paged decode tick over 8
   slots at ragged positions, the card (kernels, bfloat16 and int8 pools)
   against the CPU (plain versions, float32).
5. main: a synthetic 7B Q4_K GGUF, `Runner(path)` on the card in bfloat16,
   a ~700-token prompt (two prefill chunks) and 128 greedy tokens, twice:
   both runs must give the same tokens.
6. serving, full width and depth: `PagedServingEngine(runner, n_slots=8,
   n_pages=256, seq_len=4096)`, 16 requests at once (8 share a 256-token
   prefix, 4 are sampled), drained; then a second engine with the same seed,
   which must give the same tokens; a profiled window of 16 ticks; and the
   HTTP daemon on 127.0.0.1 answering four completions (one streamed),
   /health and /metrics.
7. dense and int8, at 8 layers (an earlier-style path at smaller depth, so
   that the whole run stays well inside its time limit): `ServingEngine(
   n_slots=8, kv_dtype=int8)` and `PagedServingEngine(..., int8 pool)` on 8
   requests each, twice each: done and deterministic.
8. MoE forward and MoE paged tick: phases 3 and 4 at the Mixtral-8x7B widths
   (8 experts, 2 per token) cut to 2 layers, with the W8 planes on the card.
9. MoE: a synthetic Mixtral-8x7B Q4_K GGUF cut to 8 of 32 layers, context
   4096; `Runner(path)`, whose default must attach every W8 plane; the
   ~700-token prompt and 128 greedy tokens, twice, identical; the same file
   with `prefill_w8=False`, prefill only, in turns with the W8 runner; then
   16 requests through an 8-slot `PagedServingEngine`, twice, identical.
The 7B main path's prefill also runs both ways (phase 5), since the Runner's
default now attaches the W8 planes there too.
Each of the paths 5, 6, 7 and 9 is driven with the kernels' launch counters
set to 0 just before it and read just after it; a kernel of a path that was
never launched there fails the run.

The last three lines are `gpu: <name>, <power limit>` as nvidia-smi reports
them, the `kernels` JSON object, and {"ok": true, "device": {...}}. Without a
CUDA card, or outside a checkout of the repository, the script prints no
result and exits 1. Longer output (the
full report, nvcc's register and spill counts) goes to chiprun_out/.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CARD = "cuda"
OUT_DIR = ROOT / "chiprun_out"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}  # dense tensor-core rates, per second
L2_FLUSH_BYTES = 256 << 20  # > the 50 MB L2: each timed launch finds it cold
HOLD_CYCLES = 100_000_000  # ~50 ms of spinning at the H100's ~2 GHz clock

# main-path shapes of the repo's 7b configuration (Mistral-7B widths)
DIM, FFN, HEADS, KV_HEADS, HEAD_DIM, VOCAB, CTX = 4096, 14336, 32, 8, 128, 32000, 4096
PREFILL_CHUNK = 512
PROMPT_SENTENCE = "Once upon a time there was a cat. "
PROMPT_REPEATS = 14  # ~700 tokens with the synthetic vocab: two prefill chunks
DECODE_STEPS = 128
PROFILE_STEPS = 16

# name -> (source, the TPU kernel it replaces, the driven path that must launch it)
_DA = "crabml_tpu/ops/pallas/decode_attention.py"
KERNEL_SOURCES = {
    "qmm_q4k": ("crabml_tpu_torch/csrc/qmm_q4k.cu", "crabml_tpu/ops/pallas/gemm_quant.py:123",
                "main"),
    "qmm_w4a8": ("crabml_tpu_torch/csrc/qmm_w4a8.cu", "crabml_tpu/ops/pallas/gemm_quant.py:190",
                 "main"),
    "decode_attention": ("crabml_tpu_torch/csrc/decode_attention.cu", f"{_DA}:39",
                         "dense_int8"),
    "flash_attention": ("crabml_tpu_torch/csrc/flash_attention.cu",
                        "crabml_tpu/ops/pallas/flash_attention.py:37", "main"),
    "decode_attention_fused": ("crabml_tpu_torch/csrc/decode_attention.cu", f"{_DA}:316",
                               "main"),
    "paged_decode_attention": ("crabml_tpu_torch/csrc/paged_decode_attention.cu", f"{_DA}:39",
                               "serving"),
    "paged_decode_attention_fused": ("crabml_tpu_torch/csrc/paged_decode_attention.cu",
                                     f"{_DA}:316", "serving"),
    "qmm_w8": ("crabml_tpu_torch/csrc/qmm_w8.cu", "crabml_tpu/ops/pallas/gemm_quant.py:540",
               "main"),
    "qmm_q4k_grouped": ("crabml_tpu_torch/csrc/qmm_q4k.cu",
                        "crabml_tpu/ops/pallas/gemm_quant.py:836", "moe_q4k"),
    "qmm_w8_grouped": ("crabml_tpu_torch/csrc/qmm_w8.cu",
                       "crabml_tpu/ops/pallas/gemm_quant.py:870", "moe"),
}
SERVING_SLOTS, SERVING_PAGES, SERVING_MAX_TOKENS = 8, 256, 64
SERVING_PREFIX = 256  # tokens that 8 of the 16 requests share
# prompt lengths: unique prompts, and the tails after the shared prefix; tails
# of at most 4 tokens (16 query rows a kv head) take the block-table kernel
# after a prefix-cache hit
UNIQUE_LENGTHS = (64, 100, 150, 230, 320, 450, 600, 700)
SHARED_TAILS = (30, 1, 4, 8, 60, 100, 200, 444)
DENSE_LAYERS = 8
MOE_LAYERS = 8  # of Mixtral-8x7B's 32: with the W8 planes the full depth does not fit beside the pools
# the MoE paged tick's contexts: short, because the CPU reference dequantizes
# every expert a prefill uses to float32 (one prompt of 40 tokens uses them all)
MOE_TICK_LENGTHS = (1, 2, 3, 4, 5, 6, 8, 40)
PROFILE_PROMPTS = (100, 200, 300, 400, 500, 600, 700, 800)  # the profiled ticks' contexts


class CheckFailed(Exception):
    pass


def fail(msg: str):
    raise CheckFailed(msg)


def gpu_tag() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi unavailable"


TAG = ""


def say(msg: str):
    print(f"[{TAG}] {msg}", flush=True)


def bound_ms(nbytes: float, ops: float, op_type: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Device time of a callable: the median over CUDA events around each of
    `iters` calls, with a 256 MB write before each so L2 is cold, as it is on
    the main path where every matmul reads other weights. A spin on the card
    holds it while the host enqueues every call, so no host delay falls
    between two events."""

    def __init__(self, torch, iters: int = 10):
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(self.iters)]
        torch.cuda._sleep(HOLD_CYCLES)
        for a, b in events:
            self.flush.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in events)


# ---------------------------------------------------------------------------
# phase 2: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def q4k_weight(m: int, k: int, seed: int, device):
    """A random Q4_K (m, k) weight in the port's kernel layout, bf16 scales."""
    import numpy as np
    import torch

    from crabml_tpu_torch.gguf.constants import GGMLType
    from crabml_tpu_torch.quant.qtensor import to_kernel_layout, to_planar
    from crabml_tpu_torch.tools.synth_gguf import q4k_blocks

    blocks = q4k_blocks(np.random.default_rng(seed), m * k, 1.0 / math.sqrt(k))
    return to_kernel_layout(to_planar(GGMLType.Q4_K, blocks, (m, k), device), torch.bfloat16)


def check_matmul(timer, name: str, rows: int, m: int, k: int, seed: int) -> dict:
    import torch

    from crabml_tpu_torch.ops.cuda import gemm_quant
    from crabml_tpu_torch.quant.qtensor import dequantize

    qt = q4k_weight(m, k, seed, "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, k, generator=g, device="cuda").to(torch.bfloat16)
    p = qt.planes
    wrapper = getattr(gemm_quant, name)
    if name == "qmm_q4k":
        plain = lambda: gemm_quant.qmm_q4k_plain(x, p["qs"], p["dsub"], p["msub"])  # noqa: E731
        # bf16 x bf16 products are exact in float32 and the dequant rounds
        # the same way on both sides: only the order of float32 sums differs
        tol, why = 1e-4, "float32 sums in another order"
        op_type = "bf16"
    else:
        plain = lambda: gemm_quant.qmm_w4a8_plain(x, p["qs"], p["dsub"], p["msub"])  # noqa: E731
        # identical int8 activations and exact integer group dots; the
        # per-group float32 scaling is summed in another order
        tol, why = 1e-4, "same int8 activations, float32 group sums in another order"
        op_type = "int8"
    # the main path's form: bfloat16 out, the float32 sums rounded once
    kernel = lambda: wrapper(x, qt, torch.bfloat16)  # noqa: E731
    w_bf16 = dequantize(qt, torch.bfloat16)
    return _matmul_record(
        timer, name, f"{rows}x{k} @ ({m}x{k})^T", kernel, plain,
        lambda: torch.matmul(x, w_bf16.t()), "torch.matmul(bf16)", wrapper(x, qt), plain(),
        kernel(), tol, why,
        x.numel() * 2 + sum(t.numel() * t.element_size() for t in p.values()) + rows * m * 2,
        2.0 * rows * m * k, op_type)


def _plane_bytes(qt, names, planes=None) -> int:
    """Bytes of the named planes of `qt`; of a stack, only the experts in `planes`."""
    total = 0
    for n in names:
        t = qt.planes[n]
        total += t[0].numel() * t.element_size() * len(planes) if planes is not None \
            else t.numel() * t.element_size()
    return total


def _matmul_record(timer, name, shape, kernel, plain, library, lib_name, got32, want, got_bf16,
                   tol, why, nbytes, ops, op_type) -> dict:
    """Compare, time and report one matmul check (the shared tail of the
    checks below)."""
    import torch

    torch.cuda.synchronize()
    err = (got32 - want).abs().max().item()
    ref = want.abs().max().item()
    rounded_once = torch.equal(got_bf16, got32.to(torch.bfloat16))
    ok = math.isfinite(err) and err <= tol * ref and rounded_once
    b_ms, b_by = bound_ms(nbytes, ops, op_type)
    rec = {
        "shape": shape, "max_abs_err": err, "max_abs_ref": ref,
        "tolerance": f"float32 out: max_abs_err <= {tol} * max|ref| ({why}); "
                     "bfloat16 out (timed): equal to the float32 out rounded once",
        "bf16_out_rounded_once": rounded_once, "ok": ok,
        "ms": timer(kernel), "plain_ms": timer(plain), "library_ms": timer(library),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    say(f"{name} {shape}: max_abs_err {err:.3e} (max|ref| {ref:.3e}, {rec['tolerance']}) "
        f"{'ok' if ok else 'FAILED'}; {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
        f"{lib_name} {rec['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return rec


def check_w8(timer, rows: int, m: int, k: int, seed: int) -> dict:
    """qmm_w8 at a 512-row prefill chunk of the 7B and Mixtral widths."""
    import torch

    from crabml_tpu_torch.ops.cuda import gemm_quant
    from crabml_tpu_torch.quant.qtensor import dequantize

    qt = gemm_quant.augment_w8(q4k_weight(m, k, seed, "cuda"))
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, k, generator=g, device="cuda").to(torch.bfloat16)
    p = qt.planes
    w_bf16 = dequantize(qt, torch.bfloat16)
    return _matmul_record(
        timer, "qmm_w8", f"{rows}x{k} @ ({m}x{k})^T",
        lambda: gemm_quant.qmm_w8(x, qt, torch.bfloat16),
        lambda: gemm_quant.qmm_w8_plain(x, p["w8"], p["dw"]),
        lambda: torch.matmul(x, w_bf16.t()), "torch.matmul(bf16)",
        gemm_quant.qmm_w8(x, qt), gemm_quant.qmm_w8_plain(x, p["w8"], p["dw"]),
        gemm_quant.qmm_w8(x, qt, torch.bfloat16),
        # the same int8 planes and bf16 x, exact products: only the order of
        # the float32 sums inside a 512-chunk differs
        1e-4, "same int8 planes, float32 sums in another order",
        x.numel() * 2 + _plane_bytes(qt, ("w8", "dw")) + rows * m * 2, 2.0 * rows * m * k, "bf16")


# the Mixtral prefill shape: a 512-token chunk is 1,024 (row, slot) pairs over
# 8 experts; a skewed routing with expert 0 empty and ragged segments
MOE_EXPERTS, MOE_USED = 8, 2
GROUPED_COUNTS = (0, 300, 37, 200, 128, 64, 195, 100)


def q4k_stack(E: int, m: int, k: int, seed: int, w8: bool):
    """A random stack (E, m, k) of Q4_K experts in kernel layout, bf16 scales."""
    import numpy as np
    import torch

    from crabml_tpu_torch.gguf.constants import GGMLType
    from crabml_tpu_torch.ops.cuda.gemm_quant import augment_w8
    from crabml_tpu_torch.quant.qtensor import to_kernel_layout, to_planar
    from crabml_tpu_torch.tools.synth_gguf import q4k_blocks

    blocks = q4k_blocks(np.random.default_rng(seed), E * m * k, 1.0 / math.sqrt(k))
    qt = to_kernel_layout(to_planar(GGMLType.Q4_K, blocks, (E, m, k), "cuda"), torch.bfloat16)
    return augment_w8(qt) if w8 else qt


def check_grouped(timer, name: str, m: int, k: int, seed: int) -> dict:
    """qmm_q4k_grouped / qmm_w8_grouped on 1,024 sorted pairs. The bound
    counts the planes of the experts that have rows, read once."""
    import numpy as np
    import torch

    from crabml_tpu_torch.ops.cuda import gemm_quant
    from crabml_tpu_torch.quant.qtensor import dequantize

    w8 = name == "qmm_w8_grouped"
    qt = q4k_stack(MOE_EXPERTS, m, k, seed, w8)
    rows = sum(GROUPED_COUNTS)
    cuts = np.concatenate([[0], np.cumsum(GROUPED_COUNTS)])
    offsets = torch.tensor(cuts, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = torch.randn(rows, k, generator=g, device="cuda").to(torch.bfloat16)
    p = qt.planes
    wrapper = getattr(gemm_quant, name)
    if w8:
        plain = lambda: gemm_quant.qmm_w8_grouped_plain(xs, p["w8"], p["dw"], offsets)  # noqa: E731
        names, why = ("w8", "dw"), "same int8 planes, float32 sums in another order"
    else:
        plain = lambda: gemm_quant.qmm_q4k_grouped_plain(  # noqa: E731
            xs, p["qs"], p["dsub"], p["msub"], offsets)
        names, why = ("qs", "dsub", "msub"), "float32 sums in another order"
    w_bf16 = dequantize(qt, torch.bfloat16)
    segs = [(e, int(lo), int(hi)) for e, (lo, hi) in enumerate(zip(cuts, cuts[1:])) if hi > lo]

    def library():  # a loop of torch.matmul over the experts' segments
        return torch.cat([torch.matmul(xs[lo:hi], w_bf16[e].t()) for e, lo, hi in segs])

    used = [e for e, _, _ in segs]
    rec = _matmul_record(
        timer, name, f"{rows} pairs {list(GROUPED_COUNTS)} x{k} @ ({MOE_EXPERTS}x{m}x{k})^T",
        lambda: wrapper(xs, qt, offsets, torch.bfloat16), plain, library,
        "torch.matmul(bf16) per segment", wrapper(xs, qt, offsets), plain(),
        wrapper(xs, qt, offsets, torch.bfloat16), 1e-4, why,
        xs.numel() * 2 + _plane_bytes(qt, names, used) + rows * m * 2, 2.0 * rows * m * k, "bf16")
    del w_bf16
    return rec


def check_w4a8_planes(timer, rows: int, m: int, k: int, seed: int) -> dict:
    """qmm_w4a8 with a plane per row (the MoE decode form): the bound counts
    each distinct selected plane once."""
    import torch

    from crabml_tpu_torch.ops.cuda import gemm_quant
    from crabml_tpu_torch.quant.qtensor import dequantize

    qt = q4k_stack(MOE_EXPERTS, m, k, seed, False)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, k, generator=g, device="cuda").to(torch.bfloat16)
    plane = torch.randint(0, MOE_EXPERTS, (rows,), generator=g, device="cuda").to(torch.int32)
    p = qt.planes
    distinct = sorted(set(plane.tolist()))
    w_rows = dequantize(qt, torch.bfloat16)[plane.long()].transpose(1, 2).contiguous()
    plain = lambda: gemm_quant.qmm_w4a8_plain(x, p["qs"], p["dsub"], p["msub"], plane)  # noqa: E731
    rec = _matmul_record(
        timer, "qmm_w4a8", f"{rows}x{k} @ plane-per-row of ({MOE_EXPERTS}x{m}x{k})^T, "
        f"{len(distinct)} distinct planes",
        lambda: gemm_quant.qmm_w4a8(x, qt, torch.bfloat16, plane), plain,
        lambda: torch.bmm(x[:, None], w_rows), "torch.bmm(bf16, planes gathered beforehand)",
        gemm_quant.qmm_w4a8(x, qt, plane=plane), plain(),
        gemm_quant.qmm_w4a8(x, qt, torch.bfloat16, plane),
        1e-4, "same int8 activations, float32 group sums in another order",
        x.numel() * 2 + _plane_bytes(qt, ("qs", "dsub", "msub"), distinct) + rows * m * 2,
        2.0 * rows * m * k, "int8")
    del w_rows
    return rec


def _sdpa(q, k_cache, v_cache, pos: int, T: int):
    """One torch.nn.functional.scaled_dot_product_attention call over the
    live keys with the same causal bounds (the library yardstick)."""
    import torch
    import torch.nn.functional as F

    n = pos + T
    qh = q.transpose(1, 2)  # (B, H, T, hd)
    k, v = k_cache[:, :, :n], v_cache[:, :, :n]
    row = pos + torch.arange(T, device=q.device)[:, None]
    mask = torch.arange(n, device=q.device)[None, :] <= row
    return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask, enable_gqa=True)


def check_attention(timer, name: str, T: int, pos: int, seed: int) -> dict:
    import torch

    from crabml_tpu_torch.ops.cuda import decode_attention as da
    from crabml_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    B, S = 1, CTX
    q = torch.randn(B, T, HEADS, HEAD_DIM, generator=g, device="cuda").to(torch.bfloat16)
    kc = torch.randn(B, KV_HEADS, S, HEAD_DIM, generator=g, device="cuda").to(torch.bfloat16)
    vc = torch.randn(B, KV_HEADS, S, HEAD_DIM, generator=g, device="cuda").to(torch.bfloat16)
    posv = torch.tensor([pos], dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(HEAD_DIM)
    if name == "decode_attention_fused":  # the step's keys from their own block
        kn, vn = (c[:, :, pos : pos + T].contiguous() for c in (kc, vc))
        kernel = lambda: da.decode_attention_fused(  # noqa: E731
            q, kc[None], vc[None], 0, posv, scale, kn, vn)
    else:
        wrapper = da.decode_attention if name == "decode_attention" else fa.flash_attention
        kernel = lambda: wrapper(q, kc, vc, posv, scale)  # noqa: E731
    plain = lambda: fa.flash_attention_plain(q, kc, vc, posv, scale)  # noqa: E731
    library = lambda: _sdpa(q, kc, vc, pos, T)  # noqa: E731
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    # float32 softmax on both sides; each output rounds to bfloat16 once,
    # so the two may differ by one bf16 unit (2^-8 relative) of the value
    tol = 2.0 ** -7
    ok = math.isfinite(err) and err <= tol * ref
    n_keys = pos + T
    qo_bytes = 2 * B * T * HEADS * HEAD_DIM * 2  # q read and out written, bf16
    kv_bytes = 2 * B * KV_HEADS * n_keys * HEAD_DIM * 2  # live keys and values
    pairs = sum(pos + t + 1 for t in range(T))  # causal (query, key) pairs per head
    b_ms, b_by = bound_ms(qo_bytes + kv_bytes, 4.0 * B * HEADS * HEAD_DIM * pairs, "bf16")
    rec = {
        "shape": f"B={B} T={T} pos={pos} H={HEADS} KV={KV_HEADS} hd={HEAD_DIM} S={S}",
        "max_abs_err": err, "max_abs_ref": ref,
        "tolerance": f"max_abs_err <= 2^-7 * max|ref| (one bfloat16 rounding of the output)",
        "ok": ok, "ms": timer(kernel), "plain_ms": timer(plain), "library_ms": timer(library),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    say(f"{name} {rec['shape']}: max_abs_err {err:.3e} (max|ref| {ref:.3e}, "
        f"{rec['tolerance']}) {'ok' if ok else 'FAILED'}; {rec['ms']:.4f} ms, "
        f"plain {rec['plain_ms']:.4f} ms, sdpa {rec['library_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    return rec


def check_decode_form(timer, form: str, kv: str, T: int, seed: int, softcap: float = 0.0,
                      window: int = 0) -> tuple[str, dict]:
    """One form of the decode-attention kernel at the serving shape: 8
    sequences, 32 q / 8 kv heads, head dim 128, prefixes ragged from 1 to
    ~1,000 tokens. form: dense | dense_fused | paged | paged_fused (fused: the
    step's keys come in their own block); kv: bf16 | int8. The paged forms
    read a 256-page pool through a shuffled block table."""
    import torch
    import torch.nn.functional as F

    from crabml_tpu_torch.models.forward import q8_vec
    from crabml_tpu_torch.ops.cuda import decode_attention as da
    from crabml_tpu_torch.ops.cuda import paged_decode_attention as pa

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    B, KV, hd, PAGE = SERVING_SLOTS, KV_HEADS, HEAD_DIM, pa.PAGE
    prefix = [1, 37, 128, 255, 400, 640, 900, 1000]
    max_pages = 9  # room for 1000 + 8 tokens
    S = max_pages * PAGE
    fused, paged = form.endswith("fused"), form.startswith("paged")
    scale = 1.0 / math.sqrt(hd)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    q = rand(B, T, HEADS, hd).to(torch.bfloat16)
    posv = torch.tensor(prefix, dtype=torch.int32, device=dev)
    n_pool = SERVING_PAGES if paged else B * max_pages
    k, v = rand(n_pool, KV, PAGE, hd), rand(n_pool, KV, PAGE, hd)
    kn, vn = rand(B, KV, T, hd), rand(B, KV, T, hd)
    ks = vs = ksn = vsn = None
    if kv == "int8":
        (k, ks), (v, vs), (kn, ksn), (vn, vsn) = (q8_vec(a) for a in (k, v, kn, vn))
    else:
        k, v, kn, vn = (a.to(torch.bfloat16) for a in (k, v, kn, vn))
    perm = torch.randperm(SERVING_PAGES - 1, generator=torch.Generator().manual_seed(seed))
    table = (perm[: B * max_pages] + 1).reshape(B, max_pages).to(dev, torch.int32)
    for b, p in enumerate(prefix):  # unused entries are 0, the scratch page
        table[b, -(-(p + T) // PAGE):] = 0
    if not paged:  # the same rows as a dense cache (B, KV, S, hd)
        k, v, ks, vs = (None if a is None else
                        a.reshape(B, max_pages, KV, PAGE, -1).transpose(1, 2)
                        .reshape(B, KV, S, -1).contiguous() for a in (k, v, ks, vs))
    at = posv.long()[:, None] + torch.arange(T, device=dev)[None]  # (B, T)
    if not fused:  # the cache holds the step's tokens: write them first
        news = ((k, kn), (v, vn), (ks, ksn), (vs, vsn))
        for cache, new in news:
            if cache is None:
                continue
            if paged:
                cache[table.long().gather(1, at // PAGE), :, at % PAGE] = new.transpose(1, 2)
            else:
                cache[torch.arange(B, device=dev)[:, None], :, at] = new.transpose(1, 2)
    kw = dict(softcap=softcap, local_window=window)
    stack = lambda a: None if a is None else a[None]  # noqa: E731  (one layer, stacked)
    if form == "paged_fused":
        name = "paged_decode_attention_fused"
        kernel = lambda: pa.paged_decode_attention_fused(  # noqa: E731
            q, stack(k), stack(v), table, 0, posv, scale, kn, vn, stack(ks), stack(vs),
            ksn, vsn, **kw)
        plain = lambda: pa.paged_decode_attention_plain(  # noqa: E731
            q, k, v, table, posv, scale, ks, vs, softcap, window, kn, vn, ksn, vsn)
    elif form == "paged":
        name = "paged_decode_attention"
        kernel = lambda: pa.paged_decode_attention(  # noqa: E731
            q, k, v, table, posv + T, scale, ks, vs, **kw)
        plain = lambda: pa.paged_decode_attention_plain(  # noqa: E731
            q, k, v, table, posv, scale, ks, vs, softcap, window)
    elif form == "dense_fused":
        name = "decode_attention_fused"
        kernel = lambda: da.decode_attention_fused(  # noqa: E731
            q, stack(k), stack(v), 0, posv, scale, kn, vn, stack(ks), stack(vs), ksn, vsn, **kw)
        plain = lambda: da.decode_attention_plain(  # noqa: E731
            q, k, v, posv, scale, ks, vs, softcap, window, kn, vn, ksn, vsn)
    else:
        name = "decode_attention"
        kernel = lambda: da.decode_attention(q, k, v, posv, scale, ks, vs, **kw)  # noqa: E731
        plain = lambda: da.decode_attention_plain(  # noqa: E731
            q, k, v, posv, scale, ks, vs, softcap, window)

    # the library yardstick: one SDPA call over a dense bfloat16 copy of the
    # same keys (the gather and the dequantization are not timed). SDPA has
    # no softcap, so that case has no library time.
    library = None
    if not softcap:
        n_max = max(prefix) + T
        kd = da.dequantize_kv(pa.gather_pages(k, table) if paged else k, None if ks is None else (
            pa.gather_pages(ks, table) if paged else ks))
        vd = da.dequantize_kv(pa.gather_pages(v, table) if paged else v, None if vs is None else (
            pa.gather_pages(vs, table) if paged else vs))
        kd, vd = kd[:, :, :n_max].clone(), vd[:, :, :n_max].clone()
        if fused:
            rows = torch.arange(B, device=dev)[:, None]
            kd[rows, :, at] = da.dequantize_kv(kn, ksn).transpose(1, 2)
            vd[rows, :, at] = da.dequantize_kv(vn, vsn).transpose(1, 2)
        kd, vd = kd.to(torch.bfloat16), vd.to(torch.bfloat16)
        col = torch.arange(n_max, device=dev)[None, None, :]
        mask = col <= at[:, :, None]
        if window:
            mask &= col > at[:, :, None] - window
        mask = mask[:, None]  # (B, 1, T, n_max)
        qh = q.transpose(1, 2)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qh, kd, vd, attn_mask=mask, scale=scale, enable_gqa=True)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    tol = 2.0 ** -7  # one bfloat16 rounding of the output; int8 dequantizes exactly on both sides
    ok = math.isfinite(err) and err <= tol * ref
    # the bytes this run's data needs: q and out, and each live key and value
    # (from the earliest row's window start on) with its scale, read once
    row_bytes = hd * (1 if kv == "int8" else 2) + (4 if kv == "int8" else 0)
    live = sum(p + T - (max(p + 1 - window, 0) if window else 0) for p in prefix)
    pairs = sum(min(p + t + 1, window) if window else p + t + 1 for p in prefix for t in range(T))
    nbytes = 2 * B * T * HEADS * hd * 2 + 2 * KV * live * row_bytes
    b_ms, b_by = bound_ms(nbytes, 4.0 * HEADS * hd * pairs, "bf16")
    rec = {
        "shape": f"{form} {kv} B={B} T={T} prefixes {prefix[0]}..{prefix[-1]} H={HEADS} "
                 f"KV={KV} hd={hd}" + (f" pool={SERVING_PAGES} pages, shuffled table" if paged
                                       else f" S={S}")
                 + (f" softcap={softcap:g}" if softcap else "") + (f" window={window}" if window else ""),
        "max_abs_err": err, "max_abs_ref": ref,
        "tolerance": "max_abs_err <= 2^-7 * max|ref| (one bfloat16 rounding of the output)",
        "ok": ok, "ms": timer(kernel), "plain_ms": timer(plain),
        "library_ms": timer(library) if library else None,
        "bound_ms": b_ms, "bound_by": b_by, "live_kv_bytes": 2 * KV * live * row_bytes,
    }
    lib = f"{rec['library_ms']:.4f} ms" if library else "none (no softcap in SDPA)"
    say(f"{name} {rec['shape']}: max_abs_err {err:.3e} (max|ref| {ref:.3e}, {rec['tolerance']}) "
        f"{'ok' if ok else 'FAILED'}; {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
        f"sdpa over a dense copy (gather not timed) {lib}, bound {b_ms:.4f} ms ({b_by})")
    return name, rec


def phase_kernels() -> dict[str, list[dict]]:
    import torch

    timer = Timer(torch)
    qkv_m = (HEADS + 2 * KV_HEADS) * HEAD_DIM
    checks = {
        "qmm_q4k": [check_matmul(timer, "qmm_q4k", PREFILL_CHUNK, qkv_m, DIM, 1),
                    check_matmul(timer, "qmm_q4k", PREFILL_CHUNK, DIM, FFN, 2)],
        "qmm_w4a8": [check_matmul(timer, "qmm_w4a8", 1, qkv_m, DIM, 3),
                     check_matmul(timer, "qmm_w4a8", 1, DIM, FFN, 4),
                     check_matmul(timer, "qmm_w4a8", 1, VOCAB, DIM, 5)],
        "decode_attention": [check_attention(timer, "decode_attention", 1, 1000, 6)],
        "decode_attention_fused": [check_attention(timer, "decode_attention_fused", 1, 1000, 6)],
        "flash_attention": [check_attention(timer, "flash_attention", PREFILL_CHUNK, 0, 7),
                            check_attention(timer, "flash_attention", PREFILL_CHUNK,
                                            PREFILL_CHUNK, 8)],
    }
    # every form of the decode kernel at the 8-slot serving shape; the first
    # record of a name is the one the kernels line reports
    forms = [("paged_fused", "bf16", 1, 0.0, 0), ("paged_fused", "int8", 1, 0.0, 0),
             ("paged_fused", "bf16", 4, 0.0, 0), ("paged_fused", "int8", 4, 0.0, 0),
             ("paged_fused", "bf16", 1, 50.0, 0), ("paged_fused", "bf16", 1, 0.0, 256),
             ("paged", "bf16", 1, 0.0, 0), ("paged", "int8", 1, 0.0, 0),
             ("paged", "bf16", 4, 0.0, 0), ("paged", "int8", 4, 0.0, 256),
             ("dense_fused", "int8", 1, 0.0, 0), ("dense_fused", "bf16", 1, 0.0, 0),
             ("dense_fused", "int8", 4, 50.0, 0),
             ("dense", "int8", 1, 0.0, 0), ("dense", "bf16", 4, 0.0, 256)]
    for i, (form, kv, T, softcap, window) in enumerate(forms):
        name, rec = check_decode_form(timer, form, kv, T, 20 + i, softcap, window)
        checks.setdefault(name, []).append(rec)
    # the W8 planes at a 512-row chunk, and the Mixtral forms: the experts'
    # fused gate|up (4096 -> 2 x 14336) and down (14336 -> 4096)
    checks["qmm_w8"] = [check_w8(timer, PREFILL_CHUNK, qkv_m, DIM, 40),
                        check_w8(timer, PREFILL_CHUNK, DIM, FFN, 41)]
    for name in ("qmm_q4k_grouped", "qmm_w8_grouped"):
        checks[name] = [check_grouped(timer, name, 2 * FFN, DIM, 42),
                        check_grouped(timer, name, DIM, FFN, 43)]
        torch.cuda.empty_cache()
    checks["qmm_w4a8"] += [check_w4a8_planes(timer, 1, 2 * FFN, DIM, 44),
                           check_w4a8_planes(timer, 8, 2 * FFN, DIM, 45),
                           check_w4a8_planes(timer, 8, DIM, FFN, 46)]
    del timer
    torch.cuda.empty_cache()
    return checks


# ---------------------------------------------------------------------------
# phase 3: the whole forward at full width, 2 layers, card against CPU
# ---------------------------------------------------------------------------

def phase_forward(tmp: Path, model: str = "7b", seed: int = 11, n_prompt: int = 16,
                  w8: bool = False, min_share: float = 1.0) -> dict:
    """`model` cut to 2 layers: a prompt of `n_prompt` tokens and one decode
    step, the card (kernels, bfloat16, with the W8 prefill planes when `w8`)
    against the CPU (plain versions, float32, Q4_K planes only)."""
    import numpy as np
    import torch

    from crabml_tpu_torch.gguf.reader import GGUFFile
    from crabml_tpu_torch.models.config import config_from_gguf
    from crabml_tpu_torch.models.forward import KVCache, forward
    from crabml_tpu_torch.models.weights import augment_w8_weights, load_weights
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    path = build_synth_gguf(str(tmp / f"synth-{model}-2layers.gguf"), model, seed=seed, layers=2)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    tokens = np.random.default_rng(seed + 1).integers(3, cfg.vocab_size, (1, n_prompt + 1))
    runs = {}
    for dev, dt in ((CARD, torch.bfloat16), ("cpu", torch.float32)):
        w = load_weights(gf, cfg, dev, dt)
        if w8 and dev == CARD:
            w = augment_w8_weights(w)
        cache = KVCache.create(cfg, 1, 512, dt, dev)
        outs = []
        for toks, p in ((tokens[:, :n_prompt], 0), (tokens[:, n_prompt:], n_prompt)):
            logits = forward(w, cache, torch.from_numpy(toks).to(dev), torch.tensor([p]), cfg, dt)
            outs.append(logits.float().cpu())
        runs[dev] = outs
        del w, cache
    torch.cuda.empty_cache()
    # bfloat16 weights, activations and cache against float32 through two
    # layers and the lm_head: each bf16 rounding adds ~2^-9 relative; the W8
    # planes' requantization (max|w|/254 per 512-chunk) is smaller than that.
    # A mixture of experts adds a discrete step: a token whose second and
    # third router logits lie within a bfloat16 rounding of each other picks
    # another expert on the card than in float32, and its logits then differ
    # as between two models. So the error is taken token by token, and
    # `min_share` of the tokens must meet the tolerance (all of them for a
    # dense model).
    tol = 5e-2
    rec = {"tolerance": f"max|card - cpu| <= {tol} * max|cpu| for {min_share:.0%} of the tokens "
                        "(bfloat16 against float32"
                        + ("; W8 planes on the card only)" if w8 else ")")}
    ok = True
    for i, what in enumerate((f"prefill {n_prompt} tokens", "decode step")):
        card, cpu = runs[CARD][i], runs["cpu"][i]
        finite = bool(torch.isfinite(card).all())
        per_token = (card - cpu).abs().amax(dim=-1).reshape(-1) / cpu.abs().max()
        rel, median = per_token.max().item(), per_token.median().item()
        share = (per_token <= tol).float().mean().item()
        top_agree = float((card[0, -1].argmax() == cpu[0, -1].argmax()).item())
        rec[what] = {"rel_err": rel, "median_token_rel_err": median, "share_within": share,
                     "finite": finite, "last_argmax_agrees": top_agree}
        good = finite and share >= min_share
        ok &= good
        say(f"forward {model} widths, 2 layers, {what}: rel err max {rel:.3e}, median token "
            f"{median:.3e}, {share:.1%} of the tokens within ({rec['tolerance']}), finite "
            f"{finite} {'ok' if good else 'FAILED'}")
    rec["ok"] = ok
    os.remove(path)
    return rec


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def _decode_bound(runner, pos: int) -> tuple[float, float]:
    """Least ms per decode token: the port's Q4_K weight planes (decode reads
    no W8 plane), the embedding row and the live KV cache read once, over
    3.35 TB/s; and the same with the GGUF's own Q4_K bytes (144 per 256
    weights) for the matmuls. Of a layer's experts a token reads the K it was
    routed to: K/E of the stacks' bytes, and the whole router."""
    w = runner.weights
    cfg = runner.cfg
    share = {"wgu_exps": cfg.n_experts_used / max(cfg.n_experts, 1),
             "ffn_down_exps": cfg.n_experts_used / max(cfg.n_experts, 1)}
    mats = [(w["output"], 1.0)] + [
        (lw[n], share.get(n, 1.0)) for lw in w["layers"]
        for n in ("wqkv", "wo", "wgu", "ffn_down", "wgu_exps", "ffn_down_exps") if n in lw]
    port = sum(f * _plane_bytes(q, ("qs", "dsub", "msub")) for q, f in mats)
    port += sum(lw["ffn_gate_inp"].numel() * 2 for lw in w["layers"] if "ffn_gate_inp" in lw)
    gguf = sum(f * math.prod(q.shape) // 256 * 144 for q, f in mats)
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * pos * cfg.head_dim * runner.cache.k.element_size()
    row = DIM // 256 * 144
    return ((port + kv + row) / HBM_BYTES_PER_S * 1e3, (gguf + kv + row) / HBM_BYTES_PER_S * 1e3)


def _prefill_only(runner, prompt: str) -> float:
    """Prefill tok/s of one warm run."""
    import torch

    runner.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.prefill(prompt)
    torch.cuda.synchronize()
    return len(runner.tokenizer.encode(prompt, bos=True)) / (time.perf_counter() - t0)


def _prefill_w8_against_q4k(path: str, runner, prompt: str, what: str) -> dict:
    """The same file loaded once more with prefill_w8=False: its prefill
    against the W8 runner's, in turns inside this one run (W8, Q4_K, Q4_K,
    W8), and the kernels the Q4_K prefill launched."""
    import torch

    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.runtime.runner import Runner

    plain = Runner(path, prefill_w8=False)
    if plain.prefill_w8 or not runner.prefill_w8:
        fail(f"{what}: prefill_w8 is {runner.prefill_w8} by default and {plain.prefill_w8} when off")
    _prefill_only(plain, prompt)  # warm
    _build.launches.clear()
    rates = {"w8": [_prefill_only(runner, prompt)], "q4k": [_prefill_only(plain, prompt)]}
    launches = {k: v for k, v in _build.launches.items() if k.startswith("qmm")}
    _build.launches.clear()
    rates["q4k"].append(_prefill_only(plain, prompt))
    launches_q4k = {k: v for k, v in _build.launches.items()}
    rates["w8"].append(_prefill_only(runner, prompt))
    say(f"{what} prefill, W8 planes against Q4_K only (tok/s, in turns): W8 "
        f"{rates['w8'][0]:.1f} and {rates['w8'][1]:.1f}, Q4_K {rates['q4k'][0]:.1f} and "
        f"{rates['q4k'][1]:.1f}; matmul launches of one W8 and one Q4_K prefill {launches}")
    del plain
    torch.cuda.empty_cache()
    return {"prefill_tok_s": rates, "launches": launches_q4k}


def _one_run(runner, prompt: str, launches) -> dict:
    import torch

    runner.reset()
    runner.metrics.reset()
    before = dict(launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, first = runner.prefill(prompt)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    after_prefill = dict(launches)
    pieces = list(runner.generate(first, steps=DECODE_STEPS))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_prompt = runner.metrics.counts["prefill_tokens"]
    n_decoded = runner.metrics.counts["tokens"]
    return {
        "prompt_tokens": n_prompt, "generated": len(pieces), "decoded_steps": n_decoded,
        "text": "".join(pieces), "tokens": list(runner.generated),
        "prefill_s": t1 - t0, "decode_s": t2 - t1,
        "prefill_tok_s": n_prompt / (t1 - t0), "decode_tok_s": n_decoded / (t2 - t1),
        "decode_ms_per_token": (t2 - t1) / n_decoded * 1e3,
        "launches_prefill": {k: v - before.get(k, 0) for k, v in after_prefill.items()},
        "launches_decode": {k: launches[k] - after_prefill.get(k, 0) for k in launches},
        "end_pos": runner.pos,
    }


def _profile_decode(runner, prompt: str, ms_per_token: float) -> dict:
    """Device time per decode token from a torch.profiler window of
    PROFILE_STEPS tokens: kernel time by name, launches per token, and the
    idle share of the card against the unprofiled ms per token."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runner.reset()
    _, _, first = runner.prefill(prompt)
    runner.metrics.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in runner.generate(first, steps=PROFILE_STEPS + 1):
            pass
        torch.cuda.synchronize()
    steps = runner.metrics.counts["tokens"]
    by_name: dict[str, float] = {}
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            n += 1
    if not by_name:
        say("decode profile: the profiler saw no device time (not measured)")
        return {"measured": False}
    busy = sum(by_name.values()) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    rec = {
        "measured": True, "steps": steps, "device_ms_per_token": busy,
        "device_launches_per_token": n / steps,
        "idle_share": 1.0 - busy / ms_per_token,
        "top_kernels_ms_per_token": {k[:80]: v / steps for k, v in top},
    }
    say(f"decode profile ({steps} tokens): device busy {busy:.3f} ms/token of "
        f"{ms_per_token:.3f} ms/token unprofiled (idle share {rec['idle_share']:.3f}), "
        f"{rec['device_launches_per_token']:.0f} device launches/token")
    for k, v in rec["top_kernels_ms_per_token"].items():
        say(f"  {v:.4f} ms/token  {k}")
    return rec


def phase_main(tmp: Path):
    """Phase 5 -> (record, the Runner, the GGUF's path): the serving phase
    goes on with the same loaded model."""
    import torch

    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.runtime.runner import Runner
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    t0 = time.perf_counter()
    path = build_synth_gguf(str(tmp / "synth-7b.gguf"), "7b", seed=0)
    synth_s = time.perf_counter() - t0
    say(f"synthetic 7B Q4_K GGUF: {os.path.getsize(path) / 1e9:.3f} GB in {synth_s:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    runner = Runner(path)  # the defaults: cuda, bfloat16, the model's 4096-token context
    load_s = runner.metrics.times_ns["load"] / 1e9
    w8_s = runner.metrics.times_ns.get("load.w8_augment", 0) / 1e9
    if not runner.prefill_w8:
        fail("the 7B Runner's default left the W8 prefill planes off")
    prompt = PROMPT_SENTENCE * PROMPT_REPEATS
    n_prompt = len(runner.tokenizer.encode(prompt, bos=True))
    if not PREFILL_CHUNK < n_prompt <= 2 * PREFILL_CHUNK:
        fail(f"prompt of {n_prompt} tokens is not two prefill chunks")

    _build.launches.clear()  # counts from here on are the main path's
    first = _one_run(runner, prompt, _build.launches)
    launches = dict(_build.launches)
    second = _one_run(runner, prompt, _build.launches)

    profile = _profile_decode(runner, prompt, second["decode_ms_per_token"])

    if first["tokens"] != second["tokens"]:
        fail("the two greedy runs gave different tokens")
    if len(first["tokens"]) != DECODE_STEPS:
        fail(f"generated {len(first['tokens'])} tokens, expected {DECODE_STEPS} (EOS?)")
    vocab = runner.cfg.vocab_size
    if not all(0 <= t < vocab for t in first["tokens"]):
        fail("token id out of range")
    n = first["end_pos"]
    finite = bool(torch.isfinite(runner.cache.k[:, :, :, :n]).all()
                  and torch.isfinite(runner.cache.v[:, :, :, :n]).all())
    if not finite:
        fail("NaN or inf in the KV cache")
    for name, (_, _, path_of) in KERNEL_SOURCES.items():
        if path_of == "main" and launches.get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the main path")
    bound_port, bound_gguf = _decode_bound(runner, n)
    chunks = math.ceil(n_prompt / PREFILL_CHUNK)
    peak = torch.cuda.max_memory_allocated()
    w8_q4k = _prefill_w8_against_q4k(path, runner, prompt, "7B")
    rec = {
        "load_s": load_s, "load_w8_augment_s": w8_s, "synth_s": synth_s,
        "prompt_tokens": n_prompt, "prefill_chunks": chunks, "prefill_w8_against_q4k": w8_q4k,
        "runs": [{k: v for k, v in r.items() if k not in ("text", "tokens")}
                 for r in (first, second)],
        "tokens_identical": True, "first_tokens": first["tokens"][:16],
        "decode_bound_ms_port_layout": bound_port, "decode_bound_ms_gguf_bytes": bound_gguf,
        "max_memory_allocated": peak,
        "launches": launches, "decode_profile": profile,
        "launches_per_decode_token": {k: v / first["decoded_steps"]
                                      for k, v in first["launches_decode"].items()},
        "launches_per_prefill_chunk": {k: v / chunks
                                       for k, v in first["launches_prefill"].items()},
    }
    for i, r in enumerate((first, second)):
        say(f"main path run {i + 1}: prompt {r['prompt_tokens']} tokens in {chunks} chunks, "
            f"prefill {r['prefill_tok_s']:.1f} tok/s ({r['prefill_s'] * 1e3:.1f} ms); "
            f"decode {r['decoded_steps']} steps "
            f"{r['decode_tok_s']:.2f} tok/s = {r['decode_ms_per_token']:.3f} ms/token "
            f"(bound {bound_port:.3f} ms port layout, {bound_gguf:.3f} ms GGUF bytes)")
    say(f"main path: load {load_s:.2f} s ({w8_s:.2f} s of it the W8 planes), max_memory_allocated "
        f"{rec['max_memory_allocated'] / 2**30:.2f} GiB, 128 greedy tokens identical in both "
        f"runs, launches {launches}")
    return rec, runner, path


# ---------------------------------------------------------------------------
# phase 4: one paged decode tick at full width, 2 layers, card against CPU
# ---------------------------------------------------------------------------

def phase_serving_forward(tmp: Path, model: str = "7b", seed: int = 13,
                          lengths=(1, 17, 77, 128, 130, 200, 256, 300),  # ragged, two on a page boundary
                          kvs=("compute", "int8"), w8: bool = False) -> dict:
    """`model` cut to 2 layers: one paged decode tick over 8 slots prefilled
    to `lengths`, the card against the CPU as in phase_forward."""
    import numpy as np
    import torch

    from crabml_tpu_torch.gguf.reader import GGUFFile
    from crabml_tpu_torch.models.config import config_from_gguf
    from crabml_tpu_torch.models.weights import augment_w8_weights, load_weights
    from crabml_tpu_torch.ops.cuda.paged_decode_attention import PAGE
    from crabml_tpu_torch.serving.paged import (PagedKVCache, paged_decode_step,
                                                paged_prefill_chunk)
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    path = build_synth_gguf(str(tmp / f"synth-{model}-2layers-paged.gguf"), model, seed=seed,
                            layers=2)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    rng = np.random.default_rng(seed + 1)
    lengths = list(lengths)
    prompts = [rng.integers(3, cfg.vocab_size, n) for n in lengths]
    step_tokens = rng.integers(3, cfg.vocab_size, len(lengths))
    pages = np.random.default_rng(seed + 2).permutation(np.arange(1, 64))  # scattered through the pool
    max_pages = 4
    table = np.zeros((len(lengths), max_pages), np.int32)
    for b, n in enumerate(lengths):
        need = n // PAGE + 1  # the pages of n prompt tokens and the tick's one
        table[b, :need] = pages[b * max_pages: b * max_pages + need]
    logits = {}
    for dev, dt in ((CARD, torch.bfloat16), ("cpu", torch.float32)):
        w = load_weights(gf, cfg, dev, dt)
        if w8 and dev == CARD:
            w = augment_w8_weights(w)
        for kv in kvs:
            cache = PagedKVCache.create(cfg, 64, len(lengths), max_pages,
                                        torch.int8 if kv == "int8" else dt, dev)
            for b, toks in enumerate(prompts):
                paged_prefill_chunk(w, cache, torch.from_numpy(toks[None]).to(dev), 0,
                                    table[b].tolist(), cfg, dt)
            cache.table.copy_(torch.from_numpy(table))
            out = paged_decode_step(w, cache, torch.from_numpy(step_tokens).to(dev),
                                    torch.tensor(lengths, dtype=torch.int32), cfg, dt)
            logits[dev, kv] = out.float().cpu()
            del cache
        del w
    torch.cuda.empty_cache()
    # as the dense forward check: bfloat16 weights, activations and pool
    # against float32 through two layers and the lm_head. The int8 pool adds a
    # rounding step of 2^-7 of each k/v vector's largest element on both
    # sides (the card quantizes bfloat16 vectors, the CPU float32 ones), of
    # the size of the bfloat16 roundings, so the same bound holds.
    tol = 5e-2
    rec = {"tolerance": f"max|card - cpu| <= {tol} * max|cpu| (bfloat16 against float32; the "
                        "int8 pool quantizes on both sides)", "lengths": lengths}
    ok = True
    for kv in kvs:
        card, cpu = logits[CARD, kv], logits["cpu", kv]
        finite = bool(torch.isfinite(card).all())
        rel = ((card - cpu).abs().max() / cpu.abs().max()).item()
        good = finite and rel <= tol and card.shape == (len(lengths), cfg.vocab_size)
        ok &= good
        rec[kv] = {"rel_err": rel, "finite": finite}
        say(f"paged decode tick, {model} widths, 2 layers, 8 slots at {lengths}, "
            f"{'int8' if kv == 'int8' else 'bfloat16'} pool: rel err {rel:.3e} "
            f"({rec['tolerance']}), finite {finite} {'ok' if good else 'FAILED'}")
    rec["ok"] = ok
    os.remove(path)
    return rec


# ---------------------------------------------------------------------------
# phases 6 and 7: the serving engines and the daemon
# ---------------------------------------------------------------------------

def _serving_requests(runner, seed: int):
    """The 16 requests of the serving run, in queue order: seven unique
    prompts and one with the shared prefix go first (it registers the
    prefix's pages), then the eighth unique one and the seven others that
    share the prefix, which hit the prefix cache as slots open. 12 are greedy
    and 4 sample at temperature 0.8 / top-p 0.9."""
    import numpy as np

    from crabml_tpu_torch.serving import Request

    rng = np.random.default_rng(seed)
    vocab, bos = runner.cfg.vocab_size, runner.tokenizer.bos_token

    def toks(n):
        return rng.integers(259, vocab, n).tolist()

    prefix = [bos] + toks(SERVING_PREFIX - 1)
    unique = [[bos] + toks(n - 1) for n in UNIQUE_LENGTHS]
    shared = [prefix + toks(n) for n in SHARED_TAILS]
    order = unique[:7] + shared[:1] + unique[7:] + shared[1:]
    reqs = []
    for i, p in enumerate(order):
        sampled = i % 4 == 3
        reqs.append(Request(prompt="", prompt_tokens=p, max_tokens=SERVING_MAX_TOKENS,
                            temperature=0.8 if sampled else 0.0, topp=0.9))
    return reqs


def _drain(engine, reqs) -> dict:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.drain(max_steps=20000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        n = len(r.output_tokens)
        if r.finish_reason == "length":
            if n != r.max_tokens:
                fail(f"request {r.request_id}: finished by length with {n} tokens")
        elif r.finish_reason != "stop" or n >= r.max_tokens:
            fail(f"request {r.request_id}: finish_reason {r.finish_reason!r} with {n} tokens")
    vocab = engine.cfg.vocab_size
    if not all(0 <= t < vocab for r in reqs for t in r.output_tokens):
        fail("token id out of range")
    n_out = sum(len(r.output_tokens) for r in reqs)
    return {
        "requests": len(reqs), "wall_s": wall, "output_tokens": n_out,
        "prompt_tokens": sum(len(r.prompt_tokens) for r in reqs),
        "prefill_tokens_computed": engine.prefill_tokens, "ticks": engine.steps,
        "finish_reasons": sorted(r.finish_reason for r in reqs),
        "aggregate_tok_s": n_out / wall,
        "ttft_s": {"p50": engine.ttft_hist.quantile(0.5), "p99": engine.ttft_hist.quantile(0.99)},
        "e2e_s": {"p50": engine.e2e_hist.quantile(0.5), "p99": engine.e2e_hist.quantile(0.99)},
    }


def _profile_ticks(engine, seed: int) -> dict:
    """Device time per decode tick with every slot active, from a
    torch.profiler window of PROFILE_STEPS ticks (the method of
    _profile_decode), against the unprofiled time of as many ticks."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from crabml_tpu_torch.serving import Request

    rng = np.random.default_rng(seed)
    vocab = engine.cfg.vocab_size
    reqs = [engine.submit(Request(prompt="", prompt_tokens=rng.integers(259, vocab, n).tolist(),
                                  max_tokens=8 * PROFILE_STEPS, logit_bias=((2, -1e4),)))
            for n in PROFILE_PROMPTS]
    while engine._prefilling or not engine.pending.empty():
        engine.step()
    if len(engine._active()) != engine.n_slots:
        fail("profile window: not every slot is decoding")
    for _ in range(4):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        engine.step()
    torch.cuda.synchronize()
    ms_per_tick = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            engine.step()
        torch.cuda.synchronize()
    positions = engine.pos.tolist()
    for r in reqs:
        engine.cancel(r)
    engine.drain(max_steps=100)
    by_name: dict[str, float] = {}
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            n += 1
    rec = {"ms_per_tick": ms_per_tick, "slots": engine.n_slots, "positions": positions,
           "tok_s_at_8_slots": engine.n_slots / ms_per_tick * 1e3}
    if not by_name:
        say("serving profile: the profiler saw no device time (not measured)")
        return {**rec, "measured": False}
    busy = sum(by_name.values()) / PROFILE_STEPS
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    rec.update(measured=True, device_ms_per_tick=busy, device_launches_per_tick=n / PROFILE_STEPS,
               idle_share=1.0 - busy / ms_per_tick,
               top_kernels_ms_per_tick={k[:80]: v / PROFILE_STEPS for k, v in top})
    say(f"serving profile ({PROFILE_STEPS} ticks, 8 slots at positions {positions}): "
        f"{ms_per_tick:.3f} ms/tick unprofiled = {rec['tok_s_at_8_slots']:.1f} tok/s, device busy "
        f"{busy:.3f} ms/tick (idle share {rec['idle_share']:.3f}), "
        f"{rec['device_launches_per_tick']:.0f} device launches/tick")
    for k, v in rec["top_kernels_ms_per_tick"].items():
        say(f"  {v:.4f} ms/tick  {k}")
    return rec


def _http(port: int, method: str, path: str, payload=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request(method, path, body=None if payload is None else json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read().decode()
    conn.close()
    return resp.status, data


def phase_daemon(engine) -> dict:
    """The HTTP daemon over `engine` on 127.0.0.1 and a free port: four
    completions at once (one streamed), /health, /metrics, clean shutdown."""
    import threading

    from crabml_tpu_torch.serving import http as serving_http

    server = serving_http.make_server(engine, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=serving_http.serve, args=(engine,),
                              kwargs={"server": server}, daemon=True)
    thread.start()
    results: dict[int, tuple] = {}
    prompts = ["Once upon a time", "The cat sat on the", "In a hole in the ground", "Call me"]

    def post(i):
        payload = {"prompt": prompts[i], "max_tokens": 16, "stream": i == 3,
                   "stream_options": {"include_usage": True}}
        results[i] = _http(port, "POST", "/v1/completions", payload)

    try:
        t0 = time.perf_counter()
        posts = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in posts:
            t.start()
        for t in posts:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        if len(results) != 4:
            fail("daemon: a POST did not return")
        for i in range(3):
            status, data = results[i]
            out = json.loads(data)
            n_prompt = len(engine.tokenizer.encode(prompts[i], bos=True))
            n_out = out["usage"]["completion_tokens"]
            choice = out["choices"][0]
            if (status != 200 or out["usage"]["prompt_tokens"] != n_prompt
                    or out["usage"]["total_tokens"] != n_prompt + n_out
                    or not (n_out == 16 and choice["finish_reason"] == "length"
                            or n_out < 16 and choice["finish_reason"] == "stop")):
                fail(f"daemon: POST {i} answered {status} {data[:200]}")
        status, data = results[3]
        events = [ln[6:] for ln in data.splitlines() if ln.startswith("data: ")]
        if status != 200 or not events or events[-1] != "[DONE]":
            fail(f"daemon: the SSE stream answered {status} and ended in {events[-1:]}")
        usage = json.loads(events[-2])["usage"]
        if not 0 < usage["completion_tokens"] <= 16:
            fail(f"daemon: the SSE stream's usage is {usage}")
        status, data = _http(port, "GET", "/health")
        health = json.loads(data)
        if status != 200 or health["status"] != "ok" or health["slots_total"] != engine.n_slots:
            fail(f"daemon: /health answered {status} {data[:200]}")
        status, metrics = _http(port, "GET", "/metrics")
        if status != 200 or "crabml_requests_completed_total" not in metrics:
            fail(f"daemon: /metrics answered {status}")
    finally:
        server.shutdown()
        thread.join(timeout=60)
    if thread.is_alive():
        fail("daemon: the server thread did not stop")
    say(f"daemon on 127.0.0.1:{port}: 4 POSTs to /v1/completions (one streamed, "
        f"{len(events) - 2} text events then usage and [DONE]) in {wall:.2f} s, /health and "
        "/metrics answered, shut down cleanly")
    return {"port": port, "wall_s": wall, "health": health, "sse_events": len(events)}


def _say_run(what: str, r: dict):
    say(f"{what}: {r['requests']} requests, {r['prompt_tokens']} prompt tokens "
        f"({r['prefill_tokens_computed']} computed), {r['output_tokens']} output tokens in "
        f"{r['ticks']} ticks and {r['wall_s']:.2f} s = {r['aggregate_tok_s']:.1f} tok/s aggregate "
        f"(prefill included); TTFT p50 {r['ttft_s']['p50']:.3f} s p99 {r['ttft_s']['p99']:.3f} s; "
        f"end to end p50 {r['e2e_s']['p50']:.3f} s p99 {r['e2e_s']['p99']:.3f} s; "
        f"finished {r['finish_reasons'].count('length')} by length, "
        f"{r['finish_reasons'].count('stop')} by EOS")


def phase_serving(runner) -> dict:
    """Phase 6: the paged engine at full width and depth, bfloat16 pool."""
    import torch

    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.serving import PagedServingEngine

    def engine():
        return PagedServingEngine(runner, n_slots=SERVING_SLOTS, n_pages=SERVING_PAGES,
                                  seq_len=CTX, seed=7)

    torch.cuda.reset_peak_memory_stats()
    eng = engine()
    pages_at_start = eng.pages_free()
    pool_bytes = sum(t.numel() * t.element_size() for t in (eng.cache.k, eng.cache.v))
    reqs = _serving_requests(runner, seed=21)
    _build.launches.clear()  # counts from here on are the serving path's
    first = _drain(eng, reqs)
    launches = dict(_build.launches)
    first["launches"] = launches
    first["launches_per_tick"] = {k: v / eng.steps for k, v in launches.items()}
    _say_run("serving, 7B Q4_K, 32 layers, 8 slots, 256-page bfloat16 pool", first)
    if eng.pages_free() != pages_at_start:
        fail(f"pages_free {eng.pages_free()} after the run, {pages_at_start} before")
    if any(eng._owned) or (eng._table != 0).any():
        fail("a finished slot still owns pages")
    if eng.prefix_hits < 1 or first["prefill_tokens_computed"] >= first["prompt_tokens"]:
        fail(f"prefix cache: {eng.prefix_hits} hits, {first['prefill_tokens_computed']} of "
             f"{first['prompt_tokens']} prompt tokens computed")
    first.update(prefix_hits=eng.prefix_hits, prefix_tokens_reused=eng.prefix_tokens_reused,
                 preemptions=eng.preemptions, pool_bytes=pool_bytes,
                 max_memory_allocated=torch.cuda.max_memory_allocated())
    finite = bool(torch.isfinite(eng.cache.k.float()).all() and torch.isfinite(eng.cache.v.float()).all())
    if not finite:
        fail("NaN or inf in the page pool")
    say(f"serving: pages back to {pages_at_start}, prefix cache {eng.prefix_hits} hits "
        f"({eng.prefix_tokens_reused} tokens reused), {eng.preemptions} preemptions, pool "
        f"{pool_bytes / 1e9:.2f} GB, max_memory_allocated "
        f"{first['max_memory_allocated'] / 2**30:.2f} GiB, launches {launches}")
    for name in ("paged_decode_attention_fused", "paged_decode_attention", "qmm_w4a8",
                 "qmm_q4k", "flash_attention"):
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the serving path")
    tokens = [list(r.output_tokens) for r in reqs]
    del eng
    torch.cuda.empty_cache()

    eng = engine()  # the same seed: the same tokens, sampled requests included
    again = _serving_requests(runner, seed=21)
    second = _drain(eng, again)
    _say_run("serving, second engine with the same seed", second)
    if [list(r.output_tokens) for r in again] != tokens:
        fail("the second engine with the same seed gave other tokens")
    say("serving: all 16 requests gave the same tokens in both engines")
    profile = _profile_ticks(eng, seed=22)
    daemon = phase_daemon(eng)
    del eng
    torch.cuda.empty_cache()
    return {"first": first, "second": second, "tokens_identical": True, "profile": profile,
            "daemon": daemon}


def phase_dense_int8(tmp: Path) -> dict:
    """Phase 7: the dense engine with an int8 cache and the paged engine with
    an int8 pool, at 8 layers of the 7B width."""
    import numpy as np
    import torch

    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.runtime.runner import Runner
    from crabml_tpu_torch.serving import PagedServingEngine, Request, ServingEngine
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    path = build_synth_gguf(str(tmp / "synth-7b-8layers.gguf"), "7b", seed=5, layers=DENSE_LAYERS)
    runner = Runner(path, seq_len=2048)
    vocab = runner.cfg.vocab_size

    def requests():
        # a 256-token prefix shared by three requests; 260 tokens is one dense
        # chunk of 256 and one of 4, which takes the decode kernel's unfused form
        rng = np.random.default_rng(31)
        prefix = [1] + rng.integers(259, vocab, 255).tolist()
        prompts = [prefix + rng.integers(259, vocab, 4).tolist()]
        prompts += [[1] + rng.integers(259, vocab, n - 1).tolist() for n in (40, 130, 300, 520)]
        prompts += [prefix + rng.integers(259, vocab, n).tolist() for n in (2, 70)]
        prompts += [[1] + rng.integers(259, vocab, 89).tolist()]
        return [Request(prompt="", prompt_tokens=p, max_tokens=32,
                        temperature=0.8 if i == 5 else 0.0) for i, p in enumerate(prompts)]

    rec = {"layers": DENSE_LAYERS}
    launches = {}
    for name, make in (
        ("dense int8", lambda: ServingEngine(runner, n_slots=SERVING_SLOTS, seq_len=2048,
                                             kv_dtype=torch.int8, seed=9)),
        ("paged int8", lambda: PagedServingEngine(runner, n_slots=4, n_pages=64, seq_len=2048,
                                                  kv_dtype=torch.int8, seed=9)),
    ):
        _build.launches.clear()
        eng = make()
        reqs = requests()
        first = _drain(eng, reqs)
        launches[name] = first["launches"] = dict(_build.launches)
        _say_run(f"{name} KV, 7B widths, {DENSE_LAYERS} layers (an earlier-style path at "
                 "smaller depth)", first)
        if eng.cache.k.dtype != torch.int8 or eng.cache.k_scale is None:
            fail(f"{name}: the cache is not int8")
        eng2 = make()
        again = requests()
        _drain(eng2, again)
        if [r.output_tokens for r in again] != [r.output_tokens for r in reqs]:
            fail(f"{name}: a second engine with the same seed gave other tokens")
        rec[name] = first
        del eng, eng2
    want = {"dense int8": ("decode_attention_fused", "decode_attention", "flash_attention"),
            "paged int8": ("paged_decode_attention_fused", "paged_decode_attention",
                           "flash_attention")}
    for name, kernels in want.items():
        for k in kernels:
            if launches[name].get(k, 0) <= 0:
                fail(f"{name}: kernel {k} was never launched")
    say(f"dense and paged int8 passes: done, deterministic; launches {launches}")
    rec["launches"] = launches["dense int8"]
    del runner
    os.remove(path)
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 8: the Mixtral mixture-of-experts path
# ---------------------------------------------------------------------------

def phase_moe(tmp: Path) -> dict:
    """Mixtral-8x7B widths (hidden 4096, intermediate 14336, 32/8 heads, 8
    experts, 2 per token, vocab 32000, rope theta 1e6), the depth cut to
    MOE_LAYERS of 32 and the context to 4096: `Runner(path)` with its default
    prefill_w8, which must come out on, a ~700-token prompt and 128 greedy
    tokens twice; the same file with prefill_w8=False, prefill only; and a
    drain of 16 requests through an 8-slot PagedServingEngine, twice."""
    import torch

    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.runtime.runner import Runner
    from crabml_tpu_torch.serving import PagedServingEngine
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    t0 = time.perf_counter()
    path = build_synth_gguf(str(tmp / "synth-mixtral.gguf"), "mixtral-8x7b", seed=3,
                            layers=MOE_LAYERS)
    synth_s = time.perf_counter() - t0
    say(f"synthetic Mixtral-8x7B Q4_K GGUF, {MOE_LAYERS} of 32 layers, context 4096: "
        f"{os.path.getsize(path) / 1e9:.3f} GB in {synth_s:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    runner = Runner(path)
    cfg = runner.cfg
    if (cfg.n_experts, cfg.n_experts_used, cfg.embedding_dim, cfg.hidden_dim) != (8, 2, DIM, FFN):
        fail(f"not the Mixtral-8x7B widths: {cfg}")
    if not runner.prefill_w8:
        fail("the Mixtral Runner's default left the W8 prefill planes off")
    lw = runner.weights["layers"][0]
    if not all("w8" in lw[n].planes for n in ("wqkv", "wo", "wgu_exps", "ffn_down_exps")) \
            or "w8" not in runner.weights["output"].planes:
        fail("the W8 planes are not fully on")
    load_s = runner.metrics.times_ns["load"] / 1e9
    w8_s = runner.metrics.times_ns["load.w8_augment"] / 1e9
    prompt = PROMPT_SENTENCE * PROMPT_REPEATS
    n_prompt = len(runner.tokenizer.encode(prompt, bos=True))

    _build.launches.clear()  # counts from here on are the MoE path's
    first = _one_run(runner, prompt, _build.launches)
    launches = dict(_build.launches)
    second = _one_run(runner, prompt, _build.launches)
    if first["tokens"] != second["tokens"]:
        fail("MoE: the two greedy runs gave different tokens")
    if len(first["tokens"]) != DECODE_STEPS:
        fail(f"MoE: generated {len(first['tokens'])} tokens, expected {DECODE_STEPS} (EOS?)")
    n = first["end_pos"]
    if not bool(torch.isfinite(runner.cache.k[:, :, :, :n]).all()
                and torch.isfinite(runner.cache.v[:, :, :, :n]).all()):
        fail("MoE: NaN or inf in the KV cache")
    for name in ("qmm_w8", "qmm_w8_grouped", "qmm_w4a8", "qmm_q4k", "flash_attention",
                 "decode_attention_fused"):
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the MoE path")
    profile = _profile_decode(runner, prompt, second["decode_ms_per_token"])
    bound_port, bound_gguf = _decode_bound(runner, n)
    chunks = math.ceil(n_prompt / PREFILL_CHUNK)
    peak = torch.cuda.max_memory_allocated()
    for i, r in enumerate((first, second)):
        say(f"MoE path run {i + 1}: prompt {r['prompt_tokens']} tokens in {chunks} chunks, "
            f"prefill {r['prefill_tok_s']:.1f} tok/s ({r['prefill_s'] * 1e3:.1f} ms); decode "
            f"{r['decoded_steps']} steps {r['decode_tok_s']:.2f} tok/s = "
            f"{r['decode_ms_per_token']:.3f} ms/token (bound {bound_port:.3f} ms port layout, "
            f"{bound_gguf:.3f} ms GGUF bytes, the experts counted at 2 of 8)")
    say(f"MoE path: load {load_s:.2f} s ({w8_s:.2f} s of it the W8 planes), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB, 128 greedy tokens identical in both "
        f"runs, launches {launches}")

    w8_q4k = _prefill_w8_against_q4k(path, runner, prompt, f"Mixtral ({MOE_LAYERS} layers)")
    if w8_q4k["launches"].get("qmm_q4k_grouped", 0) <= 0 or w8_q4k["launches"].get("qmm_w8", 0) \
            or w8_q4k["launches"].get("qmm_w8_grouped", 0):
        fail(f"the Q4_K-only MoE prefill launched {w8_q4k['launches']}")

    def engine():
        return PagedServingEngine(runner, n_slots=SERVING_SLOTS, n_pages=SERVING_PAGES,
                                  seq_len=CTX, seed=7)

    eng = engine()
    pages_at_start = eng.pages_free()
    reqs = _serving_requests(runner, seed=23)
    _build.launches.clear()
    serving = _drain(eng, reqs)
    serving["launches"] = dict(_build.launches)
    _say_run(f"serving, Mixtral widths, {MOE_LAYERS} layers, 8 slots, 256-page bfloat16 pool",
             serving)
    if eng.pages_free() != pages_at_start or any(eng._owned):
        fail(f"MoE serving: pages_free {eng.pages_free()} after the run, {pages_at_start} before")
    for name in ("qmm_w4a8", "qmm_w8_grouped", "paged_decode_attention_fused"):
        if serving["launches"].get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the MoE serving path")
    tokens = [list(r.output_tokens) for r in reqs]
    del eng
    eng = engine()
    again = _serving_requests(runner, seed=23)
    _drain(eng, again)
    if [list(r.output_tokens) for r in again] != tokens:
        fail("MoE serving: the second engine with the same seed gave other tokens")
    say(f"MoE serving: pages back to {pages_at_start}, all 16 requests gave the same tokens in "
        f"both engines, launches {serving['launches']}")
    del eng, runner
    os.remove(path)
    torch.cuda.empty_cache()
    return {
        "layers": MOE_LAYERS, "synth_s": synth_s, "load_s": load_s, "load_w8_augment_s": w8_s,
        "prompt_tokens": n_prompt, "prefill_chunks": chunks,
        "runs": [{k: v for k, v in r.items() if k not in ("text", "tokens")}
                 for r in (first, second)],
        "tokens_identical": True, "first_tokens": first["tokens"][:16],
        "decode_bound_ms_port_layout": bound_port, "decode_bound_ms_gguf_bytes": bound_gguf,
        "max_memory_allocated": peak, "launches": launches, "decode_profile": profile,
        "launches_per_decode_token": {k: v / first["decoded_steps"]
                                      for k, v in first["launches_decode"].items()},
        "launches_per_prefill_chunk": {k: v / chunks
                                       for k, v in first["launches_prefill"].items()},
        "prefill_w8_against_q4k": w8_q4k, "serving": serving,
    }


# ---------------------------------------------------------------------------

def kernels_line(checks: dict, paths: dict) -> dict:
    """`paths`: {driven path: its record}; each kernel reports the launches
    of the path that KERNEL_SOURCES names for it."""
    out = []
    for name, (src, replaces, path) in KERNEL_SOURCES.items():
        recs = checks[name]
        head = recs[0]
        main = paths["main"]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": paths[path]["launches"][name], "launches_on": path,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "at": head["shape"],
            "launches_per_decode_token": main["launches_per_decode_token"].get(name, 0),
            "launches_per_prefill_chunk": main["launches_per_prefill_chunk"].get(name, 0),
            "launches_per_serving_tick": paths["serving"]["launches_per_tick"].get(name, 0),
            "launches_per_moe_decode_token": paths["moe"]["launches_per_decode_token"].get(name, 0),
            "launches_per_moe_prefill_chunk":
                paths["moe"]["launches_per_prefill_chunk"].get(name, 0),
        }
        entry["all_shapes"] = [{k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                                    "bound_ms", "bound_by", "max_abs_err")}
                               for r in recs]
        out.append(entry)
    return {"kernels": out}


def main() -> int:
    if len(sys.argv) > 1:
        print("chip_smoke.py takes no arguments: it runs every phase", file=sys.stderr)
        return 2
    if not (ROOT / "crabml_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(crabml_tpu_torch/ not found beside it)", file=sys.stderr)
        return 1
    try:
        import torch
    except ImportError:
        print("chip_smoke.py: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card; the port's smoke run needs one", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 references stay float32
    torch.backends.cudnn.allow_tf32 = False

    global TAG
    TAG = gpu_tag()
    say(f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    from crabml_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name in libs:
        _build.library(name)
    say(f"built {len(libs)} kernel libraries with nvcc for sm_90a in {build_s:.2f} s")
    OUT_DIR.mkdir(exist_ok=True)
    ptxas = {name: _build.build_log(name) for name in libs}
    (OUT_DIR / "ptxas.txt").write_text(
        "\n".join(f"== {n}\n{log}" for n, log in ptxas.items()))
    for name, log in ptxas.items():
        used = [ln.split(":", 1)[-1].strip() for ln in log.splitlines() if "Used" in ln]
        spills = [ln.strip() for ln in log.splitlines() if re.search(r"[1-9]\d* bytes spill", ln)]
        say(f"ptxas {name}: {'; '.join(used)}" + (f"; SPILLS: {spills}" if spills else ""))

    report = {"device": torch.cuda.get_device_name(0), "gpu": TAG, "build_s": build_s,
              "torch": torch.__version__, "cuda": torch.version.cuda}
    failures = []
    tmp = Path(tempfile.mkdtemp(prefix="crabml_chip_smoke_"))
    try:
        checks = report["kernels"] = phase_kernels()
        failures += [f"{n} {r['shape']}" for n, rs in checks.items() for r in rs if not r["ok"]]
        report["forward"] = phase_forward(tmp)
        if not report["forward"]["ok"]:
            failures.append("forward check")
        report["serving_forward"] = phase_serving_forward(tmp)
        if not report["serving_forward"]["ok"]:
            failures.append("serving forward check")
        main_rec, runner, gguf = phase_main(tmp)
        report["main"] = main_rec
        serving = report["serving"] = phase_serving(runner)
        del runner
        os.remove(gguf)
        torch.cuda.empty_cache()
        dense = report["dense_int8"] = phase_dense_int8(tmp)
        report["moe_forward"] = phase_forward(tmp, "mixtral-8x7b", seed=16, n_prompt=300, w8=True,
                                              min_share=0.9)
        if not report["moe_forward"]["ok"]:
            failures.append("MoE forward check")
        report["moe_serving_forward"] = phase_serving_forward(
            tmp, "mixtral-8x7b", seed=18, lengths=MOE_TICK_LENGTHS, kvs=("compute",), w8=True)
        if not report["moe_serving_forward"]["ok"]:
            failures.append("MoE serving forward check")
        moe = report["moe"] = phase_moe(tmp)
    except CheckFailed as e:
        failures.append(str(e))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))

    if failures:
        for f in failures:
            say(f"FAILED: {f}")
        return 1
    print(f"gpu: {TAG}")
    print(json.dumps(kernels_line(checks, {
        "main": main_rec, "serving": serving["first"], "dense_int8": dense, "moe": moe,
        "moe_q4k": moe["prefill_w8_against_q4k"]})))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   window, the step's keys in the cache or in their own block), with the
   tolerance printed;
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
Each of the paths 5, 6 and 7 is driven with the kernels' launch counters set
to 0 just before it and read just after it; a kernel of a path that was never
launched there fails the run.

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
}
SERVING_SLOTS, SERVING_PAGES, SERVING_MAX_TOKENS = 8, 256, 64
SERVING_PREFIX = 256  # tokens that 8 of the 16 requests share
# prompt lengths: unique prompts, and the tails after the shared prefix; tails
# of at most 4 tokens (16 query rows a kv head) take the block-table kernel
# after a prefix-cache hit
UNIQUE_LENGTHS = (64, 100, 150, 230, 320, 450, 600, 700)
SHARED_TAILS = (30, 1, 4, 8, 60, 100, 200, 444)
DENSE_LAYERS = 8
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
    got32, want, got = wrapper(x, qt), plain(), kernel()
    torch.cuda.synchronize()
    err = (got32 - want).abs().max().item()
    ref = want.abs().max().item()
    rounded_once = torch.equal(got, got32.to(torch.bfloat16))
    ok = math.isfinite(err) and err <= tol * ref and rounded_once
    w_bf16 = dequantize(qt, torch.bfloat16)
    library = lambda: torch.matmul(x, w_bf16.t())  # noqa: E731
    nbytes = x.numel() * 2 + sum(t.numel() * t.element_size() for t in p.values()) + rows * m * 2
    b_ms, b_by = bound_ms(nbytes, 2.0 * rows * m * k, op_type)
    rec = {
        "shape": f"{rows}x{k} @ ({m}x{k})^T", "max_abs_err": err, "max_abs_ref": ref,
        "tolerance": f"float32 out: max_abs_err <= {tol} * max|ref| ({why}); "
                     "bfloat16 out (timed): equal to the float32 out rounded once",
        "bf16_out_rounded_once": rounded_once, "ok": ok,
        "ms": timer(kernel), "plain_ms": timer(plain), "library_ms": timer(library),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    del w_bf16
    say(f"{name} {rec['shape']}: max_abs_err {err:.3e} (max|ref| {ref:.3e}, "
        f"{rec['tolerance']}) {'ok' if ok else 'FAILED'}; {rec['ms']:.4f} ms, "
        f"plain {rec['plain_ms']:.4f} ms, torch.matmul(bf16) {rec['library_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
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
    del timer
    torch.cuda.empty_cache()
    return checks


# ---------------------------------------------------------------------------
# phase 3: the whole forward at full width, 2 layers, card against CPU
# ---------------------------------------------------------------------------

def phase_forward(tmp: Path) -> dict:
    import numpy as np
    import torch

    from crabml_tpu_torch.gguf.reader import GGUFFile
    from crabml_tpu_torch.models.config import config_from_gguf
    from crabml_tpu_torch.models.forward import KVCache, forward
    from crabml_tpu_torch.models.weights import load_weights
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    path = build_synth_gguf(str(tmp / "synth-7b-2layers.gguf"), "7b", seed=11, layers=2)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    tokens = np.random.default_rng(12).integers(3, cfg.vocab_size, (1, 17))
    runs = {}
    for dev, dt in ((CARD, torch.bfloat16), ("cpu", torch.float32)):
        w = load_weights(gf, cfg, dev, dt)
        cache = KVCache.create(cfg, 1, 64, dt, dev)
        outs = []
        for toks, p in ((tokens[:, :16], 0), (tokens[:, 16:], 16)):
            logits = forward(w, cache, torch.from_numpy(toks).to(dev), torch.tensor([p]), cfg, dt)
            outs.append(logits.float().cpu())
        runs[dev] = outs
        del w, cache
    torch.cuda.empty_cache()
    # bfloat16 weights, activations and cache against float32 through two
    # layers and the lm_head: each bf16 rounding adds ~2^-9 relative
    tol = 5e-2
    rec = {"tolerance": f"max|card - cpu| <= {tol} * max|cpu| (bfloat16 against float32)"}
    ok = True
    for i, what in enumerate(("prefill 16 tokens", "decode step")):
        card, cpu = runs[CARD][i], runs["cpu"][i]
        finite = bool(torch.isfinite(card).all())
        rel = ((card - cpu).abs().max() / cpu.abs().max()).item()
        top_agree = float((card[0, -1].argmax() == cpu[0, -1].argmax()).item())
        rec[what] = {"rel_err": rel, "finite": finite, "last_argmax_agrees": top_agree}
        good = finite and rel <= tol
        ok &= good
        say(f"forward 7b widths, 2 layers, {what}: rel err {rel:.3e} "
            f"({rec['tolerance']}), finite {finite} {'ok' if good else 'FAILED'}")
    rec["ok"] = ok
    os.remove(path)
    return rec


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def _decode_bound(runner, pos: int) -> tuple[float, float]:
    """Least ms per decode token: the port's weight planes, the embedding
    row and the live KV cache read once, over 3.35 TB/s; and the same with
    the GGUF's own Q4_K bytes (144 per 256 weights) for the matmuls."""
    w = runner.weights
    mats = [w["output"]] + [lw[n] for lw in w["layers"] for n in ("wqkv", "wo", "wgu", "ffn_down")]
    port = sum(t.numel() * t.element_size() for q in mats for t in q.planes.values())
    gguf = sum(q.m * q.k // 256 * 144 for q in mats)
    cfg = runner.cfg
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * pos * cfg.head_dim * runner.cache.k.element_size()
    row = DIM // 256 * 144
    return ((port + kv + row) / HBM_BYTES_PER_S * 1e3, (gguf + kv + row) / HBM_BYTES_PER_S * 1e3)


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
    rec = {
        "load_s": load_s, "synth_s": synth_s, "prompt_tokens": n_prompt, "prefill_chunks": chunks,
        "runs": [{k: v for k, v in r.items() if k not in ("text", "tokens")}
                 for r in (first, second)],
        "tokens_identical": True, "first_tokens": first["tokens"][:16],
        "decode_bound_ms_port_layout": bound_port, "decode_bound_ms_gguf_bytes": bound_gguf,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
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
    say(f"main path: load {load_s:.2f} s, max_memory_allocated "
        f"{rec['max_memory_allocated'] / 2**30:.2f} GiB, 128 greedy tokens identical in both "
        f"runs, launches {launches}")
    return rec, runner, path


# ---------------------------------------------------------------------------
# phase 4: one paged decode tick at full width, 2 layers, card against CPU
# ---------------------------------------------------------------------------

def phase_serving_forward(tmp: Path) -> dict:
    import numpy as np
    import torch

    from crabml_tpu_torch.gguf.reader import GGUFFile
    from crabml_tpu_torch.models.config import config_from_gguf
    from crabml_tpu_torch.models.weights import load_weights
    from crabml_tpu_torch.ops.cuda.paged_decode_attention import PAGE
    from crabml_tpu_torch.serving.paged import (PagedKVCache, paged_decode_step,
                                                paged_prefill_chunk)
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    path = build_synth_gguf(str(tmp / "synth-7b-2layers-paged.gguf"), "7b", seed=13, layers=2)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    rng = np.random.default_rng(14)
    lengths = [1, 17, 77, 128, 130, 200, 256, 300]  # ragged, two on a page boundary
    prompts = [rng.integers(3, cfg.vocab_size, n) for n in lengths]
    step_tokens = rng.integers(3, cfg.vocab_size, len(lengths))
    pages = np.random.default_rng(15).permutation(np.arange(1, 64))  # scattered through the pool
    max_pages = 4
    table = np.zeros((len(lengths), max_pages), np.int32)
    for b, n in enumerate(lengths):
        need = n // PAGE + 1  # the pages of n prompt tokens and the tick's one
        table[b, :need] = pages[b * max_pages: b * max_pages + need]
    logits = {}
    for dev, dt in ((CARD, torch.bfloat16), ("cpu", torch.float32)):
        w = load_weights(gf, cfg, dev, dt)
        for kv in ("compute", "int8"):
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
    for kv in ("compute", "int8"):
        card, cpu = logits[CARD, kv], logits["cpu", kv]
        finite = bool(torch.isfinite(card).all())
        rel = ((card - cpu).abs().max() / cpu.abs().max()).item()
        good = finite and rel <= tol and card.shape == (len(lengths), cfg.vocab_size)
        ok &= good
        rec[kv] = {"rel_err": rel, "finite": finite}
        say(f"paged decode tick, 7b widths, 2 layers, 8 slots at {lengths}, "
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
    print(json.dumps(kernels_line(checks, {"main": main_rec, "serving": serving["first"],
                                           "dense_int8": dense})))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

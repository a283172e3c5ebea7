"""Time the Q4_K tile loop with one piece of its work changed at a time.

Each variant is csrc/qmm_q4k.cu and the headers it includes with one edit:
the tensor-core products, the nibble conversion or the x tile's copies
removed, the scales copied every step (4 bytes a row) instead of every
fourth (16 bytes a row), or a ring of 5 or 8 stages instead of 6. A variant
without a piece computes wrong numbers on purpose: its time says what that
piece costs inside the loop, which no counter on the card can say here.
Every variant builds with the port's nvcc flags into crabml_tpu_torch/_build/,
and each time is the median of ten launches between CUDA events, the L2
cache flushed before each, at the 7B prefill shapes; the error against
qmm_q4k_plain is printed beside it.

    python -m crabml_tpu_torch.tools.qmm_ablation    # needs one CUDA card

With the argument `q5_0` it times csrc/qmm_q5_0.cu's two exact conversions
instead, at the same shapes on Q5_0 planes: as committed (the bf16 pair 128
+ val, one HSUB2 of 144 and one HMUL2 by the scale pair) and with an FFMA a
weight ((128 + val) * d + (-144 d) in float32, exact, then rounded to bf16
in pairs, as the Q4_K and Q5_K sources convert); both give the plain
version's numbers bit for bit.

With the argument `f32` it times csrc/qmm_f32.cu's Q4_K form (float32 x,
float32 scale planes) as committed and with one piece changed: the tensor
cores' products removed, one TF32 pass (hi x hi) instead of three, the
weights not loaded or converted, x not split (a variant without a piece
computes wrong numbers on purpose), or the accumulator restarted every
1,024 elements of k instead of 256; and the committed source at each tile
height the plan could pick (128, 96, 64, 32, 16 rows of x), at the 7B's shapes
and at 100 and 17 rows of q|k|v and 256 rows against a 1536 x 512 weight.

With the argument `ws` it times csrc/qmm_ws.cuh, the warp-specialized loop of
qmm_q5k, qmm_q6k, qmm_q3k and qmm_q2k (and their grouped forms; `ws q6_k
q2_k` times only the forms named), as committed at the launch
plan's tile (`qmm_ws_plan`) and with one piece changed: the tensor cores'
products removed or the weights not converted (wrong numbers on purpose),
one wgmma group in flight instead of two, a barrier over both consumer
warpgroups at every k step (the coupling the producer split removes), a
ring of at most 4 steps instead of 16, and Q3_K's scale bytes converted
through the float bits of 2^23 + 128 + sc instead of I2F (exact either way);
then the committed source at every tile
height of WS_TILE_ROWS, the sweep the plan's cost model is fitted to. Shapes: 17, 24, 37, 189, 512 and 1,024 rows
of the 7B q|k|v (4096 -> 6144), 189 and 512 rows of wo (4096 -> 4096) and of
gate|up (4096 -> 28672), 512 rows of down (14336 -> 4096), and the grouped
form on chip_smoke.py's 1,024 (row, slot) pairs of the Mixtral gate|up stack
(8 x 28672 x 4096).

Prints the card and its power limit, then one JSON line a shape.
"""

from __future__ import annotations

import ctypes
import json
import math
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..ops.cuda import _build, gemm_quant
from ..quant.qtensor import to_kernel_layout, to_planar
from .synth_gguf import q4k_blocks, q5_0_blocks

_MMA = """            wg::Mma<NX>::template rs<0>(acc, use[kk], wg::desc128(smem_s + slot * SB + kk * 32),
                                        !(first && kk == 0));"""
_CONV = """                a[m >> 1][2 * (m & 1) + h] =
                    wg::pack_bf16(__fmaf_rn(nib_f32(u0, 0x4B00000Fu), dl, ml),
                                  __fmaf_rn(nib_f32(u1, 0x4B00000Fu), dl, ml));
                a[2 + (m >> 1)][2 * (m & 1) + h] =
                    wg::pack_bf16(__fmaf_rn(nib_f32(u0, 0x4B0000F0u), dh, mh),
                                  __fmaf_rn(nib_f32(u1, 0x4B0000F0u), dh, mh));"""
_SC_STEPS = "static constexpr int SC_STEPS = 4;"
_SC_COPY = "wg::cp_async16(sc_dst + slot, sc + k0 / 32, ok);"
_CP_ASYNC4 = """__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n" ::"r"(dst), "l"(src),
                 "r"(pred ? 4 : 0) : "memory");
}
"""
_STAGES = "constexpr int STAGES = 6;"
_XCOPY = "                wg::cp_async16(xs + xdst + i * 4096, xsrc[i] + k0, (xok >> i) & 1);"

# name -> [(file, text, replacement)]
VARIANTS = {
    "committed": [],
    "no_tensor_cores": [("qmm_pipe.cuh", _MMA, "            acc[kk] += __uint_as_float("
                         "use[kk][0] ^ use[kk][1] ^ use[kk][2] ^ use[kk][3]);")],
    "no_conversion": [("qmm_q4k.cu", _CONV, "                a[m >> 1][2 * (m & 1) + h] = u0;\n"
                       "                a[2 + (m >> 1)][2 * (m & 1) + h] = u1;")],
    "no_x_copies": [("qmm_pipe.cuh", _XCOPY, "                (void)0;")],
    # the step's 4 bytes a row every step, through L1 (cp.async.cg takes 16
    # bytes only): the staging this loop had before the scale ring
    "scales_every_step": [
        ("qmm_q4k.cu", _SC_STEPS, "static constexpr int SC_STEPS = 1;"),
        ("qmm_q4k.cu", _SC_COPY, _SC_COPY.replace("wg::cp_async16(", "cp_async4(")),
        ("qmm_q4k.cu", "namespace {\n", "namespace {\n" + _CP_ASYNC4)],
    # the ring of x / nibble tiles one stage shorter or two longer
    "stages_5": [("qmm_pipe.cuh", _STAGES, "constexpr int STAGES = 5;")],
    "stages_8": [("qmm_pipe.cuh", _STAGES, "constexpr int STAGES = 8;")],
}
_Q50_CONV = """                const __nv_bfloat162 wl =
                    __hmul2(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo), b2), dl);
                const __nv_bfloat162 wh =
                    __hmul2(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi), b2), dh);
                a[m >> 1][2 * (m & 1) + h] = *reinterpret_cast<const uint32_t*>(&wl);
                a[2 + (m >> 1)][2 * (m & 1) + h] = *reinterpret_cast<const uint32_t*>(&wh);"""
_Q50_FFMA = """                const float fl = __uint_as_float(dp << 16);
                const float fh = __uint_as_float(dp & 0xFFFF0000u);
                a[m >> 1][2 * (m & 1) + h] = wg::pack_bf16(
                    __fmaf_rn(__uint_as_float(lo << 16), fl, -144.0f * fl),
                    __fmaf_rn(__uint_as_float(lo & 0xFFFF0000u), fl, -144.0f * fl));
                a[2 + (m >> 1)][2 * (m & 1) + h] = wg::pack_bf16(
                    __fmaf_rn(__uint_as_float(hi << 16), fh, -144.0f * fh),
                    __fmaf_rn(__uint_as_float(hi & 0xFFFF0000u), fh, -144.0f * fh));"""
Q50_VARIANTS = {"committed": [], "ffma": [("qmm_q5_0.cu", _Q50_CONV, _Q50_FFMA)]}
_F32_MMA = """            wg::Tf32<NX>::rs(acc, ulo[s], wg::desc128(xs + 32 * s),
                             !(it % CHUNK_STEPS == 0 && s == 0));
            wg::Tf32<NX>::rs(acc, uhi[s], wg::desc128(xs + X_BYTES + 32 * s), 1);
            wg::Tf32<NX>::rs(acc, uhi[s], wg::desc128(xs + 32 * s), 1);"""
_F32_CONVERT = "        S::convert(raw, it * BK + 16 * wh, w);"
F32_VARIANTS = {
    "committed": [],
    "no_tensor_cores": [("qmm_f32.cu", _F32_MMA, "            acc[s] += __uint_as_float("
                         "ulo[s][0] ^ ulo[s][1] ^ uhi[s][2] ^ uhi[s][3]);")],
    "one_pass": [("qmm_f32.cu", _F32_MMA,
                  "            wg::Tf32<NX>::rs(acc, uhi[s], wg::desc128(xs + 32 * s),\n"
                  "                             !(it % CHUNK_STEPS == 0 && s == 0));")],
    "no_weights": [("qmm_f32.cu", _F32_CONVERT,
                    "#pragma unroll\n        for (int i = 0; i < 16; ++i) w[i] = (float)(i + wh);")],
    "no_x_split": [("qmm_f32.cu", "            split(it + 1);\n", ""),
                   ("qmm_f32.cu", "    split(0);\n", "")],
    "chunks_of_1024": [("qmm_f32.cu", "constexpr int CHUNK_STEPS = 256 / BK;",
                        "constexpr int CHUNK_STEPS = 1024 / BK;")],
}
F32_TILES = (128, 96, 64, 32, 16)

_WS_MMA = """            wg::Mma<NX>::template rs<0>(acc, use[kk], wg::desc128(xs + kk * 32),
                                        !(it == 0 && kk == 0));"""
_WS_WAIT = ("        wg::wait<1>();  // the previous step's products are done: its slot and "
            "fragments are free")
_Q5K_PACK = """                a[m >> 1][2 * (m & 1) + h] =
                    wg::pack_bf16(__fmaf_rn(val_f32(__byte_perm(lo, 0x4B000000u, sel0)), dl, ml),
                                  __fmaf_rn(val_f32(__byte_perm(lo, 0x4B000000u, sel1)), dl, ml));
                a[2 + (m >> 1)][2 * (m & 1) + h] =
                    wg::pack_bf16(__fmaf_rn(val_f32(__byte_perm(hi, 0x4B000000u, sel0)), dh, mh),
                                  __fmaf_rn(val_f32(__byte_perm(hi, 0x4B000000u, sel1)), dh, mh));"""
_K16_PACK = """                    a[kk][2 * hf + h] =
                        Q3 ? wg::pack_bf16(__fmul_rn(v0, dl[kk]), __fmul_rn(v1, dl[kk]))
                           : wg::pack_bf16(__fmaf_rn(v0, dl[kk], ml[kk]),
                                           __fmaf_rn(v1, dl[kk], ml[kk]));"""
_K16_SCALE = "                    dl[kk] = __fmul_rn(dd[h], (float)(int8_t)sb);"
_Q6K_PACK = """                    const __nv_bfloat162 w =
                        __hmul2(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&full), b2), d2);
                    a[kk][2 * hf + h] = *reinterpret_cast<const uint32_t*>(&w);"""
_WS_COMMON = {
    "committed": [],
    "no_tensor_cores": [("qmm_ws.cuh", _WS_MMA, "            acc[kk] += __uint_as_float("
                         "use[kk][0] ^ use[kk][1] ^ use[kk][2] ^ use[kk][3]);")],
    "one_group_in_flight": [("qmm_ws.cuh", _WS_WAIT, _WS_WAIT.replace("<1>", "<0>"))],
    "consumer_barrier_every_step": [("qmm_ws.cuh", _WS_WAIT,
                                     _WS_WAIT + "\n        wg::bar_sync(1, 256);")],
    "ring_of_4": [("qmm_ws.cuh", "constexpr int MAX_STAGES = 16,", "constexpr int MAX_STAGES = 4,")],
}
# form -> (source, entry stem, its plane names, variants)
WS_FORMS = {
    "q5_k": ("qmm_q5k.cu", "qmm_q5k", ("qs", "qh", "dsub", "msub"), {
        **_WS_COMMON,
        "no_conversion": [("qmm_q5k.cu", _Q5K_PACK,
                           "                a[m >> 1][2 * (m & 1) + h] = lo;\n"
                           "                a[2 + (m >> 1)][2 * (m & 1) + h] = hi;")]}),
    "q3_k": ("qmm_q3k.cu", "qmm_q3k", ("qs", "hb", "sc", "d"), {
        **_WS_COMMON,
        "no_conversion": [("qmm_k16.cuh", _K16_PACK, "                    a[kk][2 * hf + h] = v;")],
        "float_bit_scales": [("qmm_k16.cuh", _K16_SCALE, """                    dl[kk] = __fmul_rn(dd[h],
                                       __fsub_rn(__uint_as_float(0x4B000000u | (sb ^ 0x80u)),
                                                 8388736.0f));""")]}),
    "q6_k": ("qmm_q6k.cu", "qmm_q6k", ("ql", "qh", "dsub"), {
        **_WS_COMMON,
        "no_conversion": [("qmm_q6k.cu", _Q6K_PACK, "                    a[kk][2 * hf + h] = v;")]}),
    "q2_k": ("qmm_q2k.cu", "qmm_q2k", ("qs", "scm", "d", "dmin"), {
        **_WS_COMMON,
        "no_conversion": [("qmm_k16.cuh", _K16_PACK, "                    a[kk][2 * hf + h] = v;")]}),
}
WS_SHAPES = ((17, 6144, 4096), (24, 6144, 4096), (37, 6144, 4096), (189, 6144, 4096),
             (512, 6144, 4096), (1024, 6144, 4096), (189, 4096, 4096), (512, 4096, 4096),
             (189, 28672, 4096), (512, 28672, 4096), (512, 4096, 14336))

# (rows, columns, k): the fused q|k|v and the down projection of a 512-row
# chunk, and the 189-row chunk
SHAPES = ((512, 6144, 4096), (512, 4096, 14336), (189, 6144, 4096))
F32_SHAPES = SHAPES + ((100, 6144, 4096), (17, 6144, 4096), (256, 1536, 512))


def build(variants: dict, source: str = "qmm_q4k.cu", entry: str = "qmm_q4k_bf16",
          argtypes=(ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)) -> dict:
    """{variant: its C entry}, each `variants[name]` = [(file, text, replacement)]
    applied to a copy of csrc/<source> and the headers, built in parallel."""
    root = _build.BUILD_DIR / "ablation" / Path(source).stem
    procs = {}
    for name, edits in variants.items():
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for src in [*_build.CSRC.glob("*.cuh"), _build.CSRC / source]:
            shutil.copy(src, d / src.name)
        for fname, old, new in edits:
            text = (d / fname).read_text()
            if old not in text:
                raise RuntimeError(f"variant {name}: {fname} no longer holds the text it edits")
            (d / fname).write_text(text.replace(old, new))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(d / "lib.so"),
               str(d / source)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    entries = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(root / name / "lib.so")), entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def device_ms(fn, flush: torch.Tensor, iters: int = 10) -> float:
    """Median ms between CUDA events, L2 flushed before each launch; a spin
    holds the card while the host enqueues them."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda._sleep(100_000_000)
    for a, b in events:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def f32_main(flush: torch.Tensor) -> int:
    """The `f32` mode: csrc/qmm_f32.cu's variants, and its tile heights."""
    entries = build(F32_VARIANTS, "qmm_f32.cu", "qmm_q4k_f32",
                    (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
    torch.backends.cuda.matmul.allow_tf32 = False
    for rows, m, k in F32_SHAPES:
        blocks = q4k_blocks(np.random.default_rng(m + k), m * k, 1.0 / math.sqrt(k))
        qt = to_kernel_layout(to_planar(GGMLType.Q4_K, blocks, (m, k), "cuda"), torch.float32)
        planes = [qt.planes[n] for n in ("qs", "dsub", "msub")]
        x = torch.randn(rows, k, device="cuda")
        want = gemm_quant.qmm_q4k_plain(x, *planes)
        out = torch.empty(rows, m, dtype=torch.float32, device="cuda")
        plan = gemm_quant.qmm_f32_plan(rows, m)
        line = {"shape": f"{rows}x{k} @ ({m}x{k})^T", "scheme": "Q4_K float32",
                "plan_tile_rows": plan.tile_rows}
        runs = [(name, fn, plan.tile_rows) for name, fn in entries.items()]
        runs += [(f"committed_tile_{t}", entries["committed"], t) for t in F32_TILES
                 if t != plan.tile_rows]
        for name, fn, tile in runs:
            def launch(fn=fn, tile=tile):
                err = fn(x.data_ptr(), *(t.data_ptr() for t in planes), out.data_ptr(), rows, m,
                         k, tile, _build.stream_ptr(x))
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            ms = device_ms(launch, flush)
            rel = ((out - want).abs().max() / want.abs().max()).item()
            line[name] = {"ms": ms, "rel_err": rel}
        print(json.dumps(line), flush=True)
    return 0


def ws_main(flush: torch.Tensor, forms=tuple(WS_FORMS)) -> int:
    """The `ws` mode: csrc/qmm_ws.cuh's variants, and its tile sweep, for
    the forms named (WS_FORMS' keys)."""
    from .synth_gguf import SCHEMES

    MOE_COUNTS = (0, 300, 37, 200, 128, 64, 195, 100)  # chip_smoke.py's GROUPED_COUNTS
    for form in forms:
        source, stem, names, variants = WS_FORMS[form]
        ptrs = (ctypes.c_void_p,) * (2 + len(names))  # x, the planes, out
        args = ptrs + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
        gargs = ptrs + (ctypes.c_int, ctypes.c_void_p) + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
        dense = build(variants, source, f"{stem}_bf16", args)
        grouped = build({"committed": []}, source, f"{stem}_grouped_bf16", gargs)["committed"]
        kind, blocks = SCHEMES[form]
        plain = getattr(gemm_quant, f"{stem}_plain")
        shapes = [(r, m, k, None) for r, m, k in WS_SHAPES] + [(sum(MOE_COUNTS), 28672, 4096,
                                                                MOE_COUNTS)]
        for rows, m, k, counts in shapes:
            E = 1 if counts is None else len(counts)
            rng = np.random.default_rng(m + k + E)
            raw = blocks(rng, E * m * k, 1.0 / math.sqrt(k))
            shape = (m, k) if counts is None else (E, m, k)
            qt = to_kernel_layout(to_planar(kind, raw, shape, "cuda"), torch.bfloat16)
            planes = [qt.planes[n] for n in names]
            x = torch.randn(rows, k, device="cuda").to(torch.bfloat16)
            out = torch.empty(rows, m, dtype=torch.bfloat16, device="cuda")
            if counts is None:
                want = plain(x, *planes)
                plan = gemm_quant.qmm_ws_plan(rows, m)
                label = f"{rows}x{k} @ ({m}x{k})^T"
            else:
                off = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32,
                                   device="cuda")
                want = getattr(gemm_quant, f"{stem}_grouped_plain")(x, *planes, off)
                plan = gemm_quant.qmm_ws_plan(rows, m, E)
                label = f"grouped {rows} pairs {list(counts)} x{k} @ ({E}x{m}x{k})^T"
            line = {"shape": label, "scheme": kind.name, "plan_tile_rows": plan.tile_rows}
            runs = [] if counts is not None else [(n, fn, plan.tile_rows)
                                                  for n, fn in dense.items()]
            runs += [(f"tile_{t}", None, t) for t in gemm_quant.WS_TILE_ROWS
                     if t < rows or t == gemm_quant.ws_width(min(rows, 256))]
            for name, fn, tile in runs:
                def launch(fn=fn, tile=tile):
                    if counts is None:
                        err = (fn or dense["committed"])(
                            x.data_ptr(), *(t.data_ptr() for t in planes), out.data_ptr(), 1,
                            rows, m, k, tile, _build.stream_ptr(x))
                    else:
                        err = grouped(x.data_ptr(), *(t.data_ptr() for t in planes),
                                      out.data_ptr(), 1, off.data_ptr(), E, rows, m, k, tile,
                                      _build.stream_ptr(x))
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                ms = device_ms(launch, flush)
                rel = ((out.float() - want).abs().max() / want.abs().max()).item()
                line[name] = {"ms": ms, "rel_err": rel}
            print(json.dumps(line), flush=True)
            del qt, planes, want
            torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ws = argv[:1] == ["ws"] and set(argv[1:]) <= set(WS_FORMS)
    if argv not in ([], ["q5_0"], ["f32"]) and not ws:
        print("usage: python -m crabml_tpu_torch.tools.qmm_ablation [q5_0 | f32 | ws [FORM ...]]"
              f" (FORM: {' '.join(WS_FORMS)})")
        return 2
    if not torch.cuda.is_available():
        print("qmm_ablation: needs a CUDA card")
        return 1
    tag = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"gpu: {tag}")
    if argv == ["f32"]:
        return f32_main(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    if ws:
        return ws_main(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"),
                       tuple(argv[1:]) or tuple(WS_FORMS))
    q50 = argv == ["q5_0"]
    kind, blocks_of, names = ((GGMLType.Q5_0, q5_0_blocks, ("qs", "qh", "dsub")) if q50 else
                              (GGMLType.Q4_K, q4k_blocks, ("qs", "dsub", "msub")))
    entries = (build(Q50_VARIANTS, "qmm_q5_0.cu", "qmm_q5_0_bf16") if q50 else build(VARIANTS))
    plain = gemm_quant.qmm_q5_0_plain if q50 else gemm_quant.qmm_q4k_plain
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for rows, m, k in SHAPES:
        blocks = blocks_of(np.random.default_rng(m + k), m * k, 1.0 / math.sqrt(k))
        qt = to_kernel_layout(to_planar(kind, blocks, (m, k), "cuda"), torch.bfloat16)
        planes = [qt.planes[n] for n in names]
        x = torch.randn(rows, k, device="cuda").to(torch.bfloat16)
        want = plain(x, *planes)
        out = torch.empty(rows, m, dtype=torch.bfloat16, device="cuda")
        line = {"shape": f"{rows}x{k} @ ({m}x{k})^T", "scheme": kind.name}
        for name, fn in entries.items():
            def launch(fn=fn):
                err = fn(x.data_ptr(), *(t.data_ptr() for t in planes), out.data_ptr(), 1, rows,
                         m, k, _build.stream_ptr(x))
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            ms = device_ms(launch, flush)
            rel = ((out.float() - want).abs().max() / want.abs().max()).item()
            line[name] = {"ms": ms, "rel_err": rel}
            if q50:  # the same bf16 weights through the same loop: the same output
                first = out.clone() if name == "committed" else first
                line[name]["equals_committed"] = torch.equal(out, first)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

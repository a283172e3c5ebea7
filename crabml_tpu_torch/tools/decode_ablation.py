"""Time the decode-attention loop with one piece of its work changed at a time.

Each variant is csrc/decode_attention.cu (the dense entry) and the headers it
includes with one edit to csrc/decode_core.cuh: every block returning right
after it read pos (the launch and that read alone), returning once its K and
V have landed (no arithmetic), returning before the merge of the chunks, the
tensor-core products replaced by a register xor, K and V waited for as one
copy group, or chunks of 64 keys (four warps) instead of 128 (eight). A
variant without a piece computes wrong numbers on purpose: its time says
what that piece costs, which no counter on the card can say here. Every
variant builds with the port's nvcc flags into crabml_tpu_torch/_build/
(qmm_ablation.build), and each time is the median of ten launches between
CUDA events, the L2 cache flushed before each, at the fused form's shapes:
B=1 (the 7B main path's step) at pos 1000 and 4000 of a 4,096-token cache,
and 8 sequences at prefixes 1..1000 with 1 and 4 new tokens; 32 q / 8 kv
heads, head dim 128, bfloat16. The error against decode_attention_plain is
printed beside it.

    python -m crabml_tpu_torch.tools.decode_ablation    # needs one CUDA card

Prints the card and its power limit, then one JSON line a shape.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess

import torch

from ..ops.cuda import _build
from ..ops.cuda.decode_attention import decode_attention_plain
from .qmm_ablation import build, device_ms

_WAIT_K = "        wg::cp_async_wait<1>();  // Q and K (this thread's copies)\n"
_MERGE = "    __syncthreads();\n    int* last"
_MMA_S = ("            mma16816(acc[0], a, bq[0], bq[1]);\n"
          "            mma16816(acc[1], a, bq[2], bq[3]);")
_MMA_O = ("                    mma16816(acc[2 * dg], a, bv[0], bv[1]);\n"
          "                    mma16816(acc[2 * dg + 1], a, bv[2], bv[3]);")
_CORE = "decode_core.cuh"

# name -> [(file, text, replacement)]
VARIANTS = {
    "committed": [],
    "exit_after_pos": [(_CORE, "    if (c < kr.c0 || c >= kr.c1) {", "    if (c >= 0) {")],
    "loads_only": [(_CORE, _WAIT_K, "    wg::cp_async_wait<0>();\n    __syncthreads();\n"
                                    "    if (n_live > 0) return;\n" + _WAIT_K)],
    "no_merge": [(_CORE, _MERGE, "    if (n_live > 0) return;\n" + _MERGE)],
    "no_tensor_cores": [
        (_CORE, _MMA_S, "            acc[0][0] += __uint_as_float(a[0] ^ bq[0] ^ bq[1]);\n"
                        "            acc[1][0] += __uint_as_float(a[1] ^ bq[2] ^ bq[3]);"),
        (_CORE, _MMA_O, "                    acc[2 * dg][0] += __uint_as_float(a[0] ^ bv[0] ^ bv[1]);\n"
                        "                    acc[2 * dg + 1][0] += "
                        "__uint_as_float(a[1] ^ bv[2] ^ bv[3]);")],
    "one_copy_group": [(_CORE, _WAIT_K, "    wg::cp_async_wait<0>();\n")],
    "chunk_64": [(_CORE, "constexpr int CHUNK = 128;", "constexpr int CHUNK = 64;"),
                 (_CORE, "constexpr int NW = 8;", "constexpr int NW = 4;")],
}
CHUNK_KEYS = {"chunk_64": 64}  # keys a chunk where not 128
# (B, T, prefixes, cache length)
SHAPES = ((1, 1, (1000,), 4096), (1, 1, (4000,), 4096),
          (8, 1, (1, 37, 128, 255, 400, 640, 900, 1000), 1152),
          (8, 4, (1, 37, 128, 255, 400, 640, 900, 1000), 1152))
HEADS, KV_HEADS, HD = 32, 8, 128
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ARGTYPES = [_I, _I] + [_P] * 15 + [_I] * 7 + [_F, _F, _I, _I, _P]


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_ablation: needs a CUDA card")
        return 1
    tag = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"gpu: {tag}")
    entries = build(VARIANTS, "decode_attention.cu", "decode_attention", ARGTYPES)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    scale = 1.0 / math.sqrt(HD)
    for B, T, prefixes, S in SHAPES:
        def rand(*shape):
            return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

        q, k, v = rand(B, T, HEADS, HD), rand(B, KV_HEADS, S, HD), rand(B, KV_HEADS, S, HD)
        kn, vn = rand(B, KV_HEADS, T, HD), rand(B, KV_HEADS, T, HD)
        pos = torch.tensor(prefixes, dtype=torch.int32, device="cuda")
        want = decode_attention_plain(q, k, v, pos, scale, k_new=kn, v_new=vn).float()
        line = {"shape": f"B={B} T={T} prefixes {prefixes[0]}..{prefixes[-1]} S={S}"}
        for name, fn in entries.items():
            n = -(-(S + T) // CHUNK_KEYS.get(name, 128))
            rows = T * HEADS // KV_HEADS
            part_m = torch.empty(B, KV_HEADS, n, rows, device="cuda")
            part_l = torch.empty_like(part_m)
            part_acc = torch.empty(B, KV_HEADS, n, rows, HD, device="cuda")
            ticket = torch.zeros(B * KV_HEADS, dtype=torch.int32, device="cuda")
            out = torch.zeros_like(q)

            def launch(fn=fn, n=n):
                err = fn(0, 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
                         kn.data_ptr(), vn.data_ptr(), None, None, pos.data_ptr(),
                         part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
                         ticket.data_ptr(), out.data_ptr(), B, KV_HEADS, S, T,
                         HEADS // KV_HEADS, n, HD, scale, 0.0, 0, 0, _build.stream_ptr(q))
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            ms = device_ms(launch, flush)
            got = out.reshape(B, T, HEADS * HD).float()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            line[name] = {"ms": ms, "rel_err": rel}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

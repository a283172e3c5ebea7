#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (crabml_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py    # needs one CUDA card; takes no arguments

It runs every phase, each of which fails the run (exit code 1) when a check
fails:

1. build: every csrc/*.cu kernel compiles with nvcc for sm_90a (one process
   per source, all started together) and loads through ctypes.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the 7B main path (the flash kernel at a first and a second
   512-token chunk, the second also with a softcap and with a sliding
   window, and at the ragged 189-token chunk; the Q4_K and W8 matmuls at
   189, 512 and 1,024 rows; the int8-activation matmul at every 7B decode
   projection at 1 and 8 rows, and at 16 rows) and of 8-slot serving
   (every form of the decode-attention kernel: dense and paged, bfloat16 and
   int8, softcap, window, the step's keys in the cache or in their own
   block) and of the
   Mixtral path (the grouped Q4_K and W8 matmuls on 1,024 (row, slot) pairs
   over 8 experts, one of them empty and the segments ragged; the
   int8-activation matmul with a plane per row; the fused decode form at B=1
   also at pos 4000 of the 4,096-token cache) and the experts' forms of the
   Q8_0, Q6_K, Q5_K, Q4_0, Q3_K, Q2_K and Q5_0 schemes (each grouped dequant
   form on the same 1,024 pairs, each plane form at 1 and 8 rows, on gate|up
   and down stacks of 8 distinct experts), and the Q4_K, Q5_K and Q8_0 forms
   on planes converted from Q4_1, Q5_1 and Q8_1 blocks (dense, int8
   activations at 1, 8 and 16 rows, grouped, planes on experts 1-7), with
   the tolerance printed (the schemes' weights and stacks give each block
   a scale, and minimum, of its own, and every plane of each expert
   differs from expert 0's: `check_varied`);
   and (PR 15) every attention form at gemma2's head dim 256 (16 / 8 heads,
   an 8,192-row cache: flash at 512-token chunks at pos 0 and 512, at 189
   tokens, and at pos 4,096 with the window of 4,096 and the softcap 50; the
   fused dense form at pos 4,700, plain and with window and softcap; the
   unfused one at the path's 4-token tail; the paged forms at the 8-slot
   serving shape, bfloat16 and int8), and every attention form at
   Qwen2-7B's 28 q heads over 4 kv heads (7 a kv head: flash at 512-token
   chunks at pos 0 and 512 and at 189 tokens; the fused dense form at pos
   1000, the unfused one at T=2; the paged forms at the serving shape),
   and (PR 17) every attention form at Phi-3-mini's head dim 96 and phi-2's
   80 (32 / 32 heads: flash in bfloat16 and float32 at 512-token chunks at
   pos 0 and 512 and at 189 tokens; the fused and unfused dense forms at B=1
   T=1 at pos 1000; the four forms at the serving shape, bfloat16 and int8;
   flash and the fused form at head dim 128 with phi-2's heads, against
   which the kernels' zero-padding of hd 80 to 128 lanes is costed),
   and the Q6_K dequant and int8-activation forms at Phi-3-mini's
   32,064-row lm_head (189 rows and 1 row: 250.5 weight tiles of 128),
   and the norm kernel (csrc/norm.cu: RMSNorm at the 7B's 1, 8 and 512 rows
   in bfloat16 and float32 and at Qwen3-8B's per-head q|k norm, phi2's
   LayerNorm at 1 and 512 rows), each also batch invariant (its first 1, 2
   and 8 rows alone give the bits they have in the whole call),
   the kernel's time (CUDA events, L2 flushed before each launch), the plain
   version's, one PyTorch library call's computing the same function, and
   the least time the card could take (bytes over 3.35 TB/s or operations
   over the peak rate of their type, whichever is larger).
3. forward: the 7B shape cut to 2 layers (the schemes', Qwen3-8B's,
   Gemma-7B's and the Mixtral widths' forwards below to 1 since PR 22, for
   time), the same weights loaded twice:
   the card (kernels, bfloat16) against the CPU (plain versions, float32)
   for a 16-token prompt and one decode step.
4. serving forward: the same model at 1 layer, one paged decode tick over 8
   slots at ragged positions, the card (kernels, bfloat16 and int8 pools)
   against the CPU (plain versions, float32).
5. main: a synthetic 7B Q4_K GGUF, `Runner(path)` on the card in bfloat16,
   a ~700-token prompt (two prefill chunks) and 128 greedy tokens, twice,
   each decode step a replay of the captured CUDA graph of the step: both
   runs must give the same tokens; then the graphed decode at tick 1 and
   tick 8 against the eager step (models.forward.decode_step called
   directly, one token read a step) in turns, every run with the same
   tokens, and a profiled window of each (device time, launches and idle
   share per 7B decode token).
6. serving, full width and depth: `PagedServingEngine(runner, n_slots=8,
   n_pages=256, seq_len=4096)`, 16 requests at once (8 share a 256-token
   prefix, 4 are sampled), drained; then a second engine with the same seed,
   which must give the same tokens; a profiled window of 16 ticks (and 16
   more run as two step(8)); and the HTTP daemon on 127.0.0.1 answering four
   completions (one streamed), /health and /metrics. Every tick is a replay
   of the engine's captured graph.
7. dense and int8, at 8 layers (an earlier-style path at smaller depth, so
   that the whole run stays well inside its time limit): `ServingEngine(
   n_slots=8, kv_dtype=int8)` and `PagedServingEngine(..., int8 pool)` on 8
   requests each, twice each: done and deterministic.
8. MoE forward and MoE paged tick: phases 3 and 4 at the Mixtral-8x7B widths
   (8 experts, 2 per token) cut to 1 layer (2 until PR 22), with the W8
   planes on the card.
9. MoE: a synthetic Mixtral-8x7B GGUF in llama.cpp's Q4_K_M layout for 8
   experts (`mixtral-q4_k_m`: Q4_K q and gate|up experts, Q8_0 k and v, Q5_K
   attn_output, the down experts in Q6_K in layers 2 and 3, Q4_K in 0 and 1,
   a Q6_K output) cut to 4 of 32 layers, context 4096;
   `Runner(path)`, whose default must attach every W8 plane; the
   ~700-token prompt and 128 greedy tokens, twice through the graph and once
   through the eager step, identical; the same file
   with `prefill_w8=False`, prefill only (the grouped Q4_K and Q6_K forms),
   in turns with the W8 runner (the report says which route wins); then
   16 requests through an 8-slot `PagedServingEngine`, twice, identical.
   Then Mixtral-8x7B widths at 1 layer in llama.cpp's Q5_K_M and Q2_K
   8-expert layouts and in uniform Q8_0 and Q4_0 (`mixtral-q5_k_m`,
   `mixtral-q2_k`, `mixtral-q8_0`, `mixtral-q4_0`), and llama.cpp's Q5_0
   file type for 8 experts (`mixtral-q5_0`: Q5_0 experts, q and attn_output,
   Q8_0 k and v, a Q6_K output): phase 3 on the file (a 40-token prompt;
   both sides bfloat16, the card without W8 planes), `Runner(path)` with the W8 planes, 32 greedy
   tokens through the graph equal to the eager step's (`mixtral-q5_0` with a
   profiled window: the plane form's time by shape), and the prefill without
   W8 planes (each kind's grouped form).
10. Q8_0, Q6_K, Q5_K, Q4_0, Q3_K, Q2_K, Q5_0, Q4_1, Q5_1 and Q8_1, and
   llama.cpp's mixed and legacy layouts: phase 3 for each scheme and for a
   Q4_K_M file (1 layer since PR 22, card against CPU), then the 7B widths,
   each cut to 2 of 32 layers (the imatrix Q5_0 file to 8), with every
   matrix in Q8_0 (`7b-q8_0`), in Q6_K (`7b-q6_k`), as a Q5_K_M file
   (`7b-q5_k_m`: Q5_K layers, attn_v and ffn_down in Q6_K where
   use_more_bits holds, a Q6_K output), in Q4_0 (`7b-q4_0`), as a Q3_K_M
   file (`7b-q3_k_m`: Q3_K q, k and gate|up, Q5_K / Q4_K attn_v and
   ffn_down, Q4_K attn_output, a Q6_K output), as a llama.cpp Q2_K file
   (`7b-q2_k`: Q2_K q, k and gate|up, Q4_K attn_v, Q3_K attn_output and
   ffn_down, a Q6_K output), as a Q5_0 file made with an importance matrix
   (`7b-q5_0`: Q5_0 matrices, layer 0's ffn_down in Q5_1, a Q6_K output) and
   as a Q4_1 file (`7b-q4_1`: Q4_1 matrices on the Q4_K forms, a Q6_K
   output): `Runner(path)`, whose default must attach the
   W8 planes (a file under the default's 1 GiB floor asks for them); the
   ~700-token prompt and 128
   greedy tokens through the graph, equal to the eager step's; the same file
   with `prefill_w8=False`, prefill only, in turns with the W8 runner; then
   the 16 requests through an 8-slot `PagedServingEngine`. The graphed
   decode runs twice (the capture, then the cached graph) and once eagerly,
   all with the same tokens, and no matmul of the path may take torch.matmul
   on dequantized weights (ops/matmul.py::dense_matmul, counted); a profiled
   window of the graphed step follows, with the int8-activation matmul's
   time by form and shape. Phase
   2 holds each scheme's dequant kernel (512 and 189 rows of qkv, 512 of
   down; the four forms on csrc/qmm_ws.cuh, Q5_K, Q6_K, Q3_K and Q2_K, also
   1,024, 37 and 17 rows of qkv and 189 of wo, every tile height giving the
   same bits and every grouped segment the dense launch's) and
   int8-activation form (every 7B decode projection at 1 and 8 rows, and 16
   rows of qkv) against its plain version.
11. gemma2 (PR 15): Gemma-2-9B's widths (hidden 3584, 16 q / 8 kv heads of
   head dim 256, so 4,096 q rows; vocab 256000, context 8192; the window of
   4,096 on even layers, softcaps 50 / 30, GELU, post-norms, a tied Q6_K
   embedding) in llama.cpp's Q4_K_M layout at 4 of 42 layers (`gemma2-9b`):
   `Runner(path)` with its default W8 planes, a 4,612-token prompt (nine
   512-token chunks, past the window, and a 4-token tail through the
   unfused decode form), 128 greedy tokens graphed at tick 1 (twice) and
   tick 8 and eagerly, identical; a profiled window; prefill with and
   without W8 planes in turns; the 16-request paged drain (pages returned,
   a prefix hit); the dense `ServingEngine` on the prompt and a short
   request, prefilling in the Runner's 512-token chunks, whose 32 greedy
   tokens are the Runner's; no matmul through torch.matmul; then the 2-layer
   forward on a gemma2 file, card bfloat16 against CPU float32
   (`forward_gemma2`).
12. qwen2 and the other families: Qwen2-7B's widths (hidden 3584,
   intermediate 18944, 28 q heads over 4 kv heads of head dim 128, q / k / v
   biases, vocab 152064, rope theta 1e6, context cut to 4096) in llama.cpp's
   Q4_K_M layout at 4 of 28 layers (`qwen2-7b`): phase 11's runs on the
   ~700-token prompt, whose 512- and 189-token chunks take flash at 7 q
   heads a kv head, the 16-request drain on the decode forms at 7 query rows,
   the dense engine against the Runner, and its 2-layer forward
   (`forward_qwen2`); then Qwen3-8B and Gemma-7B at their published widths
   at 1 layer (2 until PR 22; phase 3: `forward_qwen3-8b`,
   `forward_gemma-7b`), and Llama-3.1-8B at 2 layers with its rope_freqs
   divisors (`llama31-8b`: phase 3, then 32 greedy tokens through the
   captured step equal to the eager step's).
13. phi3 and phi2 (PR 17): Phi-3-mini-4k-instruct's widths (hidden 3072,
   intermediate 8192, 32 / 32 heads of head dim 96, vocab 32064, context
   4096; fused attn_qkv, Q5_K under Q4_K_M, and gate|up) at 4 of its 32
   layers (`phi3-mini`) and
   phi-2's (hidden 2560, intermediate 10240, 32 heads of head dim 80, the
   rotary over 32 of them, vocab 51200, context
   2048, LayerNorm, the parallel residual and every bias) at 4 of 32 layers
   (`phi2`), both in llama.cpp's Q4_K_M layout: phase 11's runs on the
   ~700-token prompt (flash at head dims 96 and 80, the decode forms at
   both), the drain, the dense engine, and each family's 2-layer forward.
14. float32: the 7B Q4_K file of phase 5 at its 32 layers in float32
   (`7b-f32`): `Runner(compute_dtype=torch.float32, kv_dtype=torch.bfloat16,
   prefill_w8=False)`, the ~700-token prompt (its 512- and 189-row chunks
   through the float32 dequant form) and 128 greedy tokens graphed at tick 1
   and tick 8 and eagerly, identical, and a profiled window; the 16-request
   drain of an 8-slot PagedServingEngine with a float32 pool (pages back) and
   the HTTP daemon over it; the dense ServingEngine, whose greedy tokens are
   the Runner's; then the same with `kv_dtype=torch.int8, prefill_w8=True`
   (the 512-row chunk on the W8 planes, x rounded to bfloat16); then the CLI
   in a subprocess (`--dtype f32 --kv-dtype bf16 --seq-len 2048 --seed 1
   -v`). Gemma-2-9B's widths at 2 layers in float32 (`gemma2-9b-f32`): the
   4,612-token prompt and 128 tokens as above, over a bfloat16 cache, so
   that decode runs float32 q over a bfloat16 cache at head dim 256 and the
   256,000-row Q6_K lm_head takes the float32 forms. The forwards of the 7B
   and of gemma2 (2 layers) and of each scheme with forms of its own (1
   layer; phases 3, 10, 11) also run the card in float32 against the CPU's
   float32, on a 40-token
   prompt (the dequant forms), each scheme's float32 forms counted there.
   Phase 2 holds each float32 form (the dequant form at 512 and 189 rows,
   Q4_K's, Q6_K's and Q2_K's also at 1 and 17, each also against the
   three-pass model of its TF32 arithmetic; the int8-activation form at 1, 8
   and 16 rows), the decode forms in float32 at head dim 256 and over a
   cache of another dtype, and flash in float32 at the 7B's head dim 128
   against their plain versions.
15. float32 mixtures of experts and head dim 16: each Mixtral file
   of phase 9's other layouts also runs its forward on the card in float32
   (the grouped float32 form of every expert kind, the float32 plane
   forms) against a float32 CPU run, and reports how many of its tokens the
   card's bfloat16 run keeps within 5e-2 of its float32 one. Then
   `mixtral-q4_k_m-f32`: Mixtral-8x7B's widths in llama.cpp's 8-expert
   Q4_K_M layout at 2 of 32 layers in float32 over a bfloat16 cache: the
   card-against-CPU float32 forward; `Runner(compute_dtype=torch.float32,
   kv_dtype=torch.bfloat16, prefill_w8=False)` on the ~700-token prompt
   (the grouped float32 Q4_K and Q6_K forms) and 32 greedy tokens graphed
   at tick 1 and 8 and eagerly, identical; the same file with the W8 planes
   (the grouped W8 form on x rounded to bfloat16) in turns with it; the
   16-request drain with a float32 pool, pages back. Then `hf_goldens`: the
   four committed HF fixtures (tests/fixtures/, head dim 16) on the card in
   float32 through the Runner, the 16-token prompt and the decode step
   captured in a graph against transformers' logits at 5e-4, and both
   engines' greedy tokens equal to the Runner's. Phase 2 holds the eight
   grouped float32 forms at the Mixtral shapes (gate|up also on segments
   with an empty and a one-row one; each also against its three-pass model)
   and flash at head dim 16 in both dtypes against their plain versions.
16. speculative decoding, on phase 5's 7B file and Runner, K = 4:
   the plain graphed run's ~700-token prompt and 128 greedy tokens, then
   `Runner(path, speculative=4)` (prompt lookup), `Runner(path,
   draft_model=<the 7B widths at 2 layers, another seed>)` and the target
   as its own draft (its acceptance must be near all), each with its ms per
   emitted token, tokens per round and share of drafts accepted beside the
   plain run's, the decode kernels and not flash carrying every verify (T =
   5 at G = 4: 20 query rows a kv head); phase 6's 16 requests through an
   8-slot PagedServingEngine with speculative=4, and the dense
   ServingEngine with speculative=4 at step(1) and step(8), against their
   plain tokens. A token that differs from plain greedy decode (a verify
   row and a decode step may sum in another order; the paged verify's 40
   rows take the dequant matmul where the tick's 8 take int8 activations)
   is held to a near tie (`_hold_to_tie`) and reported. Phase 2 holds every
   decode form past 16 query rows against its plain version (the 7B
   verify, T = 8 at G = 7, the 8-slot paged verify in bfloat16 and int8,
   head dims 256 in both dtypes and 96).
17. stories: the reference's own models at their published widths,
   full depth and vocabulary: stories15M (288 / 768, 6 layers of 6 heads of
   head dim 48, vocab 32000, context 256) in F32, Q8_0 and Q4_0 (BASELINE.json's
   configs #1 and #2; rows of 288 and 768, the legacy kinds' kernel planes
   zero-padded to whole superblocks) and stories260K (64 / 172, 5 layers of 8
   q heads of head dim 8 over 4 kv heads, vocab 512) in F32: each file's
   forward against the CPU's (phase 3's gates, bfloat16 and float32);
   `Runner(path)` in bfloat16 and in float32 on "captain america" for 100
   greedy tokens, graphed twice and eagerly, identical, flash carrying every
   attention (hd 48 and 8 are not decode head dims: no decode form may
   launch) and the scheme's dequant and int8-activation forms every matmul of
   a quantized file; both engines' greedy tokens equal to the Runner's, and a
   16-request paged drain; the HTTP daemon on the stories260K file, three
   POSTs at once, each text the Runner's; the CLI on the stories15M F32
   file, its text the Runner's. Phase 2 holds flash at a head dim of each class below a tile
   width (8, 24 with window and softcap, 48, 72, 104, 200, 248) in both
   dtypes, and the Q8_0, Q4_0 and Q5_0 forms, qmm_w8 and Q8_0's float32
   forms at stories15M's k = 288, against their plain versions.
Float32 flash takes both products on the tensor cores in three TF32 passes:
phase 2 holds each of its checks against the exact plain version and against
the plain model of its arithmetic (`flash_attention_split_plain`), both at
1e-4 of max|out|, bounds it at 495 / 3 TFLOP/s (the CUDA cores' FFMA bound
beside it), adds the 7B's last chunk (T 512 at pos 3,584: 4,096 keys in a
row's sums), gemma2's at pos 4,096 with its window of 4,096 and softcap 50
over an 8,192-row cache, and Qwen2-7B's G = 7 at the ragged chunk, and checks
the kernel's launch plan (`flash_f32_layout`) against
ops/cuda/flash_attention.py's `flash_f32_plan` at every head dim.
The 7B main path's prefill also runs both ways (phase 5), since the Runner's
default now attaches the W8 planes there too.
Each phase prints its seconds, and the report keeps them (`phase_s`).
Each of the paths 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16 and 17 is driven
with the kernels' launch counters set to 0 just before it and read just
after it; a kernel of a path that was
never launched there fails the run. A replay of a captured graph counts the
launches its capture recorded (ops/cuda/_build.py), so the graphed paths
count as the eager ones did.

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
# dense tensor-core rates, and float32 on the CUDA cores, per second; a
# float32 product in three TF32 passes (csrc/qmm_f32.cu) at a third of TF32's
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32x3": 495e12 / 3}
L2_FLUSH_BYTES = 256 << 20  # > the 50 MB L2: each timed launch finds it cold
# the spin that holds the card while the host queues ten timed calls: at
# least 10.1 ms at the H100's 1.98 GHz top clock, ten times what a kernel's
# ten calls take to queue (Timer reports the longest queueing)
HOLD_CYCLES, SPIN_HZ = 20_000_000, 1.98e9

# main-path shapes of the repo's 7b configuration (Mistral-7B widths)
DIM, FFN, HEADS, KV_HEADS, HEAD_DIM, VOCAB, CTX = 4096, 14336, 32, 8, 128, 32000, 4096
PREFILL_CHUNK = 512
RAGGED_CHUNK = 189  # the ~700-token prompt's second chunk
PROMPT_SENTENCE = "Once upon a time there was a cat. "
PROMPT_REPEATS = 14  # ~700 tokens with the synthetic vocab: two prefill chunks
DECODE_STEPS = 128
DENSE_ENGINE_TOKENS = 32  # a family's dense-engine request, held to the Runner's tokens
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
                        "crabml_tpu/ops/pallas/gemm_quant.py:836", "moe-dequant"),
    "qmm_w8_grouped": ("crabml_tpu_torch/csrc/qmm_w8.cu",
                       "crabml_tpu/ops/pallas/gemm_quant.py:870", "moe"),
    "qmm_q8_0": ("crabml_tpu_torch/csrc/qmm_q8_0.cu", "crabml_tpu/ops/pallas/gemm_quant.py:123",
                 "7b-q8_0"),
    "qmm_q6k": ("crabml_tpu_torch/csrc/qmm_q6k.cu", "crabml_tpu/ops/pallas/gemm_quant.py:123",
                "7b-q6_k"),
    "qmm_w4a8_q8_0": ("crabml_tpu_torch/csrc/qmm_w4a8.cu",
                      "crabml_tpu/ops/pallas/gemm_quant.py:190", "7b-q8_0"),
    "qmm_w4a8_q6k": ("crabml_tpu_torch/csrc/qmm_w4a8.cu",
                     "crabml_tpu/ops/pallas/gemm_quant.py:190", "7b-q6_k"),
    "qmm_q5k": ("crabml_tpu_torch/csrc/qmm_q5k.cu", "crabml_tpu/ops/pallas/gemm_quant.py:123",
                "7b-q5_k_m"),
    "qmm_q4_0": ("crabml_tpu_torch/csrc/qmm_q4_0.cu", "crabml_tpu/ops/pallas/gemm_quant.py:123",
                 "7b-q4_0"),
    "qmm_w4a8_q5k": ("crabml_tpu_torch/csrc/qmm_w4a8.cu",
                     "crabml_tpu/ops/pallas/gemm_quant.py:190", "7b-q5_k_m"),
    "qmm_w4a8_q4_0": ("crabml_tpu_torch/csrc/qmm_w4a8.cu",
                      "crabml_tpu/ops/pallas/gemm_quant.py:190", "7b-q4_0"),
    "qmm_q3k": ("crabml_tpu_torch/csrc/qmm_q3k.cu", "crabml_tpu/ops/pallas/gemm_quant.py:123",
                "7b-q3_k_m"),
    "qmm_q2k": ("crabml_tpu_torch/csrc/qmm_q2k.cu", "crabml_tpu/ops/pallas/gemm_quant.py:123",
                "7b-q2_k"),
    "qmm_w4a8_q3k": ("crabml_tpu_torch/csrc/qmm_w4a8.cu",
                     "crabml_tpu/ops/pallas/gemm_quant.py:190", "7b-q3_k_m"),
    "qmm_w4a8_q2k": ("crabml_tpu_torch/csrc/qmm_w4a8.cu",
                     "crabml_tpu/ops/pallas/gemm_quant.py:190", "7b-q2_k"),
    "qmm_q5_0": ("crabml_tpu_torch/csrc/qmm_q5_0.cu", "crabml_tpu/ops/pallas/gemm_quant.py:123",
                 "7b-q5_0"),
    "qmm_w4a8_q5_0": ("crabml_tpu_torch/csrc/qmm_w4a8.cu",
                      "crabml_tpu/ops/pallas/gemm_quant.py:190", "7b-q5_0"),
    # no Pallas kernel: the JAX norms are plain jnp (csrc/norm.cu's note says why
    # the port has a kernel of its own); every model's RMS norms, phi2's LayerNorm
    "rms_norm": ("crabml_tpu_torch/csrc/norm.cu", "crabml_tpu/ops/norm.py:27", "main"),
    "layer_norm": ("crabml_tpu_torch/csrc/norm.cu", "crabml_tpu/ops/norm.py:8", "phi2"),
}
# the experts' forms: the grouped dequant kernel of each scheme (the
# second entry of its source, launched by the prefill of the Runner without
# W8 planes), and the plane-per-row form of qmm_w4a8 for each (Q4_K's
# counted apart from its dense form since then), on the Mixtral path of each
# kind: the main MoE path's Q4_K_M file holds Q4_K and Q6_K experts
MOE_PATH_OF = {"q4_k": "moe", "q6_k": "moe", "q5_k": "mixtral-q5_k_m", "q3_k": "mixtral-q2_k",
               "q2_k": "mixtral-q2_k", "q8_0": "mixtral-q8_0", "q4_0": "mixtral-q4_0",
               "q5_0": "mixtral-q5_0"}
_FORM = {"q4_k": "q4k", "q8_0": "q8_0", "q6_k": "q6k", "q5_k": "q5k", "q4_0": "q4_0",
         "q3_k": "q3k", "q2_k": "q2k", "q5_0": "q5_0"}


def _expert_forms() -> dict:
    out = {}
    for scheme, path in MOE_PATH_OF.items():
        form = _FORM[scheme]
        if scheme != "q4_k":  # qmm_q4k_grouped is above
            out[f"qmm_{form}_grouped"] = (f"crabml_tpu_torch/csrc/qmm_{form}.cu",
                                          "crabml_tpu/ops/pallas/gemm_quant.py:836",
                                          f"{path}-dequant")
        out["qmm_w4a8" + ("" if scheme == "q4_k" else f"_{form}") + ".planes"] = (
            "crabml_tpu_torch/csrc/qmm_w4a8.cu", "crabml_tpu/ops/pallas/gemm_quant.py:190", path)
    return out


KERNEL_SOURCES.update(_expert_forms())
# the float32 forms: each form's dequant kernel in csrc/qmm_f32.cu and its
# int8-activation form on float32 x and scale planes, on the float32 path of
# its kind: Q4_K's the 7B one, Q6_K's the gemma2 one (its lm_head and Q6_K
# layers), the others the float32 forward (phase_forward) of their scheme
F32_PATH_OF = {"q4_k": "7b-f32", "q6_k": "gemma2-9b-f32"}


def _f32_forms() -> dict:
    out = {}
    for scheme, form in _FORM.items():
        path = F32_PATH_OF.get(scheme, f"forward_{scheme}")
        out[f"qmm_{form}_f32"] = ("crabml_tpu_torch/csrc/qmm_f32.cu",
                                  "crabml_tpu/ops/pallas/gemm_quant.py:123", path)
        out["qmm_w4a8" + ("" if scheme == "q4_k" else f"_{form}") + ".f32"] = (
            "crabml_tpu_torch/csrc/qmm_w4a8.cu", "crabml_tpu/ops/pallas/gemm_quant.py:190", path)
    return out


KERNEL_SOURCES.update(_f32_forms())
# the float32 grouped forms (csrc/qmm_f32.cu's grouped entries, counted as
# `<form>_grouped.f32`): Q4_K's and Q6_K's on the prefill of mixtral-q4_k_m-f32
# without W8 planes, the others in the float32 forward on the card of their
# Mixtral file (phase_moe_scheme's `<what>-forward`)
F32_GROUPED_PATH_OF = {"q4_k": "mixtral-q4_k_m-f32", "q6_k": "mixtral-q4_k_m-f32",
                       "q5_k": "mixtral-q5_k_m-forward", "q3_k": "mixtral-q2_k-forward",
                       "q2_k": "mixtral-q2_k-forward", "q8_0": "mixtral-q8_0-forward",
                       "q4_0": "mixtral-q4_0-forward", "q5_0": "mixtral-q5_0-forward"}
KERNEL_SOURCES.update({f"qmm_{_FORM[scheme]}_grouped.f32": (
    "crabml_tpu_torch/csrc/qmm_f32.cu", "crabml_tpu/ops/pallas/gemm_quant.py:836", path)
    for scheme, path in F32_GROUPED_PATH_OF.items()})
# the Mixtral paths of the other layouts, 1 of 32 layers each (cut from 2 for the
# script's time: one layer runs every form of the file's kinds): (name, scheme,
# mix, seed): llama.cpp's Q5_K_M (Q5_K gate|up, Q6_K down: use_more_bits holds in
# layer 0 of 1) and Q2_K (Q2_K gate|up, Q3_K down) 8-expert layouts, uniform Q8_0
# and Q4_0, and llama.cpp's Q5_0 file type for 8 experts (Q5_0 experts, Q8_0 k and v)
MOE_SCHEME_PATHS = (("mixtral-q5_k_m", "q5_k", "k_m", 91), ("mixtral-q2_k", "q2_k", "q2_k", 92),
                    ("mixtral-q8_0", "q8_0", None, 93), ("mixtral-q4_0", "q4_0", None, 94),
                    ("mixtral-q5_0", "q5_0", "legacy", 95))
MOE_SCHEME_LAYERS = 1
# the prompt of their card-against-CPU forwards: 40 tokens (80 (row, slot) pairs) take every
# expert and the grouped forms; the CPU's all-experts mix in bfloat16 and float32 is the
# slowest part of these paths
MOE_SCHEME_PROMPT = 40
MOE_SCHEME_STEPS = 32
# the short Mixtral paths whose graphed step is profiled (the plane form's
# time by shape; the main MoE path profiles Q4_K's and Q6_K's): a profile
# costs ~8 s a path
MOE_PROFILED = ("mixtral-q5_0",)
# the paths of the other schemes: (name, scheme, layers of the 7B shape's 32,
# seed, mix); 7b-q5_k_m is llama.cpp's Q5_K_M layout (tools/synth_gguf.py --mix
# k_m: attn_v and ffn_down in Q6_K in 16 of the 32 layers, a Q6_K output),
# 7b-q3_k_m its Q3_K_M layout (--scheme q3_k --mix k_m) and 7b-q2_k its Q2_K
# file type (--mix q2_k)
# (at 2 layers, for time; a _K_M layout
# keeps Q6_K layers at 2: use_more_bits holds in layer 1);
# 7b-q5_0 is llama.cpp's Q5_0 file type made with an importance matrix (--mix
# imatrix: Q5_0 matrices, layer 0's ffn_down in Q5_1, a Q6_K output: 8 layers,
# since the imatrix rule puts Q5_1 in layers i < n / 8) and 7b-q4_1 its Q4_1
# file type (--mix legacy: Q4_1 matrices, a Q6_K output)
SCHEME_PATHS = (("7b-q8_0", "q8_0", 2, 61, None), ("7b-q6_k", "q6_k", 2, 62, None),
                ("7b-q5_k_m", "q5_k", 2, 63, "k_m"), ("7b-q4_0", "q4_0", 2, 64, None),
                ("7b-q3_k_m", "q3_k", 2, 65, "k_m"), ("7b-q2_k", "q2_k", 2, 66, "q2_k"),
                ("7b-q5_0", "q5_0", 8, 67, "imatrix"), ("7b-q4_1", "q4_1", 2, 68, "legacy"))
# the schemes of phase kernels' checks (each with forms of its own) and of
# the forward checks (with the schemes that run the Q4_K, Q5_K and
# Q8_0 forms, REUSED_SCHEMES, whose kernel checks are those forms on their
# planes)
KERNEL_SCHEMES = ("q8_0", "q6_k", "q5_k", "q4_0", "q3_k", "q2_k", "q5_0")
REUSED_SCHEMES = ("q4_1", "q5_1", "q8_1")
SERVING_SLOTS, SERVING_PAGES, SERVING_MAX_TOKENS = 8, 256, 64
# speculative decoding: the draft length (the JAX package's default, crabml_tpu/cli.py) and
# the draft model's depth (the 7B widths at 2 layers, another seed)
SPEC_K, SPEC_DRAFT_LAYERS = 4, 2
SPEC_DRAFT_STEPS = 32  # greedy tokens of the two-model runs (the lookup run takes DECODE_STEPS)
SERVING_PREFIX = 256  # tokens that 8 of the 16 requests share
# prompt lengths: unique prompts, and the tails after the shared prefix; tails
# of at most 4 tokens (16 query rows a kv head) take the block-table kernel
# after a prefix-cache hit
UNIQUE_LENGTHS = (64, 100, 150, 230, 320, 450, 600, 700)
SHARED_TAILS = (30, 1, 4, 8, 60, 100, 200, 444)
DENSE_LAYERS = 8
# the card's float32 forward against the CPU's, of max|logit|: the prompt
# through the dequant forms, the same exact float32 weights on both sides,
# float32 sums in another order (1e-4); the decode step through the
# int8-activation forms, whose codes come from activations that differ in the
# order of float32 sums only, so a value on a rounding edge takes the next
# code on one side and moves a 2-layer model's logits as far as the
# bfloat16 forward's gate allows (5e-2; on an H100, 1.67e-2 at most, on the
# Q8_0 file, and 6.4e-7 where no code moved)
F32_FORWARD_TOL = {"prefill": 1e-4, "decode step": 5e-2}
# the prompt of the forwards that run the card in float32: more than
# 16 tokens, so that its chunk takes the dequant form
F32_FORWARD_PROMPT = 40
# the paged tick's card-against-CPU checks (the 7B's and Mixtral's): one layer
# covers every kernel and the block table; the CPU side, which gathers each
# decode row's expert planes and dequantizes them, took 37 and 51 s at 2 (PR 15)
SERVING_FORWARD_LAYERS = 1
# the card-against-CPU forwards of each scheme, of the q4_k_m mix, of Qwen3-8B and
# Gemma-7B and of the Mixtral widths (W8 planes): 1 layer since PR 22 (2 before),
# for the script's time; one layer runs every form of a layer (a _K_M mix keeps
# its Q6_K layer: use_more_bits holds in layer 0 of 1)
CUT_FORWARD_LAYERS = 1
# of Mixtral-8x7B's 32 (cut for the script's time): with the W8 planes the full depth does
# not fit beside the pools; at 4, use_more_bits puts the down experts of layers 2 and 3 in
# Q6_K, of 0 and 1 in Q4_K
MOE_LAYERS = 4
# the MoE paged tick's contexts, 4 slots (the CPU reference's plane-per-row product costs in
# proportion): short, because the CPU reference dequantizes every expert a prefill uses to
# float32 (one prompt of 40 tokens uses them all)
MOE_TICK_LENGTHS = (1, 4, 8, 40)
PROFILE_PROMPTS = (100, 200, 300, 400, 500, 600, 700, 800)  # the profiled ticks' contexts
QKV_M = (HEADS + 2 * KV_HEADS) * HEAD_DIM
# the gemma2 path: google/gemma-2-9b's widths (tools/synth_gguf.py "gemma2-9b": 16 q / 8 kv
# heads of head dim 256 over a 3584-wide embedding, vocab 256000, context 8192, window 4096
# on even layers, softcaps 50 / 30) in llama.cpp's Q4_K_M layout, 4 of its 42 layers
G2_DIM, G2_HEADS, G2_KV, G2_HD, G2_VOCAB, G2_CTX = 3584, 16, 8, 256, 256000, 8192
G2_WINDOW, G2_SOFTCAP, G2_LAYERS = 4096, 50.0, 4
G2_ATTN = (G2_HEADS, G2_KV, G2_HD, G2_CTX)  # the attention checks' dims
# its prompt: nine 512-token chunks past the window and a 4-token tail, which
# takes the unfused decode form (4 tokens x 2 q heads a kv head: 8 rows)
G2_PROMPT_TOKENS = 9 * PREFILL_CHUNK + 4
G2_KERNELS = ("flash_attention", "decode_attention", "decode_attention_fused", "qmm_w8",
              "qmm_w4a8", "qmm_w4a8_q6k")
# the qwen2 path: Qwen/Qwen2-7B's widths (tools/synth_gguf.py "qwen2-7b": 28 q heads
# over 4 kv heads, so 7 a kv head, at head dim 128; hidden 3584, intermediate 18944, vocab
# 152064, rope theta 1e6, q / k / v biases), the context cut to 4096, in llama.cpp's Q4_K_M
# layout, 4 of its 28 layers; its ~700-token prompt's chunks of 512 and 189
# tokens take flash at G = 7, its decode step and the drain's ticks the decode forms at 7 query
# rows
Q2_DIM, Q2_HEADS, Q2_KV, Q2_LAYERS = 3584, 28, 4, 4
Q2_ATTN = (Q2_HEADS, Q2_KV, HEAD_DIM, CTX)
Q2_KERNELS = ("flash_attention", "decode_attention_fused", "qmm_w8", "qmm_w4a8", "qmm_w4a8_q6k")
# the other families at their published widths, 1 layer each (phase_forward); Llama-3.1-8B
# also decodes FAMILY_STEPS greedy tokens graphed against eager (its rope divisors)
FAMILY_FORWARDS = (("qwen3-8b", 171), ("gemma-7b", 172))
# the phi paths (tools/synth_gguf.py "phi3-mini": microsoft/Phi-3-mini-4k-instruct, 32 / 32
# heads of head dim 96 over a 3072-wide embedding, intermediate 8192, vocab 32064, context
# 4096, at 4 of its 32 layers; "phi2": microsoft/phi-2, 32 heads of head dim 80 over 2560, the
# rotary over 32 dims, intermediate 10240, vocab 51200, context 2048, at 4 of 32 layers), both
# in llama.cpp's Q4_K_M layout (attn_qkv Q5_K); the ~700-token prompt's chunks take flash at
# head dims 96 and 80, the decode step and the drain's ticks the decode forms at them
P3_DIM, P3_HEADS, P3_HD, P3_VOCAB, P3_LAYERS = 3072, 32, 96, 32064, 4
P2_DIM, P2_HEADS, P2_HD, P2_ROPE, P2_VOCAB, P2_CTX, P2_LAYERS = 2560, 32, 80, 32, 51200, 2048, 4
PHI_ATTN = {"phi3-mini": (P3_HEADS, P3_HEADS, P3_HD, CTX),
            "phi2": (P2_HEADS, P2_HEADS, P2_HD, P2_CTX)}
PHI_KERNELS = ("flash_attention", "decode_attention_fused", "qmm_w8", "qmm_w4a8",
               "qmm_w4a8_q5k", "qmm_w4a8_q6k")
Q3_VOCAB = 151936  # Qwen3-8B's lm_head rows
# the committed HF fixtures (tests/fixtures/<family>-tiny-f32.gguf, transformers' logits in
# <family>-tiny-golden.npz): 4 q heads over 2 kv heads of head dim 16, context 128
HF_FAMILIES = ("gemma2", "qwen3", "phi3", "mixtral")
HF_ATTN = (4, 2, 16, 128)
HF_TOL = 5e-4  # tests/test_family_goldens.py's rtol = atol
HF_STEPS = 8  # greedy tokens of each engine request, held to the Runner's
FAMILY_STEPS = 32
# the reference's own models (crabml's testdata, karpathy's llama2.c checkpoints), at
# their published widths, full depth and vocabulary (tools/synth_gguf.py): stories15M
# (288 / 768, 6 layers of 6 heads of head dim 48, vocab 32000, context 256) in F32, Q8_0
# and Q4_0 (BASELINE.json's configs #1 and #2: rows of 288 and 768, the legacy kinds'
# planes padded to whole superblocks), and stories260K (64 / 172, 5 layers of 8 q heads
# of head dim 8 over 4 kv heads, vocab 512, context 512) in F32: (model, scheme, seed)
STORIES = (("stories15m", "f32", 301), ("stories15m", "q8_0", 302), ("stories15m", "q4_0", 303),
           ("stories260k", "f32", 304))
STORIES_PROMPT = "captain america"  # BASELINE.json's config #1
STORIES_STEPS = 100
STORIES_ENGINE_PROMPTS = (STORIES_PROMPT, "once upon a time there was a cat", "x")
STORIES_ENGINE_TOKENS = 32
STORIES_DRAIN_LENGTHS = (8, 16, 30, 50, 80, 100, 150, 190) * 2  # 16 requests, 64 tokens each
S15_DIM, S15_FFN, S15_VOCAB, S15_CTX = 288, 768, 32000, 256
S15_ATTN = (6, 6, 48, S15_CTX)
S260_ATTN = (8, 4, 8, 512)
# qmm_w4a8's checks (rows, m, k, planes, seed), also timed by tools/w4a8_turns.py:
# every projection of the 7B decode step at one row and at the 8-slot tick's
# 8 rows (qkv, wo, gate|up, down, lm_head), a 16-row tail, and Mixtral's
# experts with a plane per row
W4A8_SHAPES = (
    [(1, m, k, False, seed) for m, k, seed in ((QKV_M, DIM, 3), (DIM, FFN, 4), (VOCAB, DIM, 5),
                                               (DIM, DIM, 51), (2 * FFN, DIM, 52))]
    + [(SERVING_SLOTS, m, k, False, 53 + i)
       for i, (m, k) in enumerate(((QKV_M, DIM), (DIM, DIM), (2 * FFN, DIM), (DIM, FFN),
                                   (VOCAB, DIM)))]
    + [(2 * SERVING_SLOTS, QKV_M, DIM, False, 58)]
    + [(1, 2 * FFN, DIM, True, 44), (8, 2 * FFN, DIM, True, 45), (8, DIM, FFN, True, 46),
       (1, DIM, FFN, True, 59)])


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
    between two events. A callable of many small launches (a plain version)
    can fill the launch queue during the spin and then waits on the card;
    `max_queue_ms` and `outlasted` (timings whose queueing outlasted the
    spin) say how often that happened. With `by_read` L2 is emptied by a sum
    over the same 256 MB instead: no dirty lines are left for the timed call
    to write back."""

    def __init__(self, torch, iters: int = 10):
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        self.max_queue_ms, self.outlasted = 0.0, 0

    def __call__(self, fn, by_read: bool = False) -> float:
        torch = self.torch
        fn()
        fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(self.iters)]
        sums = torch.empty(self.iters, dtype=torch.int64, device="cuda")
        torch.cuda._sleep(HOLD_CYCLES)
        t0 = time.perf_counter()
        for i, (a, b) in enumerate(events):
            if by_read:
                torch.sum(self.flush, dim=0, out=sums[i])
            else:
                self.flush.zero_()
            a.record()
            fn()
            b.record()
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        self.max_queue_ms = max(self.max_queue_ms, queued * 1e3)
        self.outlasted += queued * SPIN_HZ >= HOLD_CYCLES
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


def scheme_weight(scheme: str, m: int, k: int, seed: int, device, scale_dtype=None):
    """A random (m, k) weight of `scheme` (tools/synth_gguf.py's blocks, each
    block's scales varied) in the port's kernel layout, bf16 scales (or
    `scale_dtype`'s: float32 under float32 compute)."""
    import numpy as np
    import torch

    from crabml_tpu_torch.quant.qtensor import to_kernel_layout, to_planar
    from crabml_tpu_torch.tools.synth_gguf import SCHEMES, vary_scales

    kind, blocks = SCHEMES[scheme]
    rng = np.random.default_rng(seed)
    raw = vary_scales(kind, blocks(rng, m * k, 1.0 / math.sqrt(k)), rng)
    return check_varied(to_kernel_layout(to_planar(kind, raw, (m, k), device),
                                         scale_dtype or torch.bfloat16))


def check_varied(qt):
    """`qt`, after failing unless every plane of it varies where a form could
    read the wrong part: of a stack, each plane of every expert differs from
    expert 0's, values and scales alike; of one weight, no plane holds one
    value throughout. Then a form that read another row's, block's or
    expert's scales (or values) gives other numbers than its plain version."""
    import torch

    for n, t in qt.planes.items():
        if len(qt.shape) == 3:
            same = [e for e in range(1, t.shape[0]) if torch.equal(t[0], t[e])]
            if same:
                fail(f"{qt.kind.name} stack: plane {n} of experts {same} equals expert 0's")
        elif bool((t == t.reshape(-1)[0]).all()):
            fail(f"{qt.kind.name} weight: plane {n} holds one value throughout")
    return qt


def _on_planes(qt) -> str:
    """The label of a check on another kind's planes than its form's own
    (Q4_1 weights on the Q4_K forms): "Q4_1 planes: ", else nothing."""
    from crabml_tpu_torch.quant.qtensor import FORM_KIND

    return "" if FORM_KIND[qt.kind] == qt.kind else f"{qt.kind.name} planes: "


def check_scheme_matmul(timer, scheme: str, form: str, rows: int, m: int, k: int,
                        seed: int, qt=None) -> tuple[str, dict]:
    """A scheme's form (KERNEL_SCHEMES, or the form that a REUSED_SCHEMES
    kind runs, on that kind's planes) of the dequant kernel (`form`
    "dequant") or of the int8-activation kernel ("w4a8") against its plain
    version, on `qt` or on scheme_weight(scheme, m, k, seed)."""
    import torch

    from crabml_tpu_torch.ops.cuda import gemm_quant
    from crabml_tpu_torch.quant.qtensor import FORM_KIND, dequantize

    if qt is None:
        qt = scheme_weight(scheme, m, k, seed, "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, k, generator=g, device="cuda").to(torch.bfloat16)
    xp = _padded_x(x, qt)
    p = qt.planes
    # in the plain versions' order
    planes = [p[n] for n in gemm_quant._KERNEL_PLANES[FORM_KIND[qt.kind]]]
    if form == "dequant":
        name = gemm_quant.DEQUANT_FORMS[FORM_KIND[qt.kind]]
        wrapper = getattr(gemm_quant, name)
        tol, why = 1e-4, "the same bf16 weights, float32 sums in another order"
        op_type = "bf16"
    else:
        name = gemm_quant.W4A8_FORMS[FORM_KIND[qt.kind]]
        wrapper = gemm_quant.qmm_w4a8
        tol, why = 1e-4, "same int8 activations, float32 group sums in another order"
        op_type = "int8"
    plain_fn = getattr(gemm_quant, f"{name}_plain")
    plain = lambda: plain_fn(xp, *planes)  # noqa: E731
    kernel = lambda: wrapper(x, qt, torch.bfloat16)  # noqa: E731
    w_bf16 = dequantize(qt, torch.bfloat16)
    rec = _matmul_record(
        timer, name, f"{_on_planes(qt)}{rows}x{k} @ ({m}x{k})^T", kernel, plain,
        lambda: torch.matmul(x, w_bf16.t()), "torch.matmul(bf16)", wrapper(x, qt), plain(),
        kernel(), tol, why, x.numel() * 2 + _weight_bytes(qt) + rows * m * 2,
        2.0 * rows * m * k, op_type)
    return name, rec


def check_f32_matmul(timer, scheme: str, form: str, rows: int, m: int, k: int, seed: int,
                     qt=None) -> tuple[str, dict]:
    """A scheme's float32 form under float32 compute, on float32 x and a
    weight with float32 scale planes (`qt`, or scheme_weight's): the dequant
    form of csrc/qmm_f32.cu (`form` "dequant") or the int8-activation form
    ("w4a8"), against its plain version; the library yardstick is
    torch.matmul in float32 (TF32 off) on the dequantized weight. Only float32
    comes out. The dequant form is also held against the three-pass model
    of its arithmetic (`qmm_f32_split_plain`) at the same tolerance, and
    bound by operations at TF32's rate over three (its FFMA bound, 67
    TFLOP/s, reported beside)."""
    import torch

    from crabml_tpu_torch.ops.cuda import gemm_quant
    from crabml_tpu_torch.quant.qtensor import FORM_KIND, dequantize

    if qt is None:
        qt = scheme_weight(scheme, m, k, seed, "cuda", torch.float32)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, k, generator=g, device="cuda")
    xp = _padded_x(x, qt)
    kind = FORM_KIND[qt.kind]
    planes = [qt.planes[n] for n in gemm_quant._KERNEL_PLANES[kind]]
    if form == "dequant":
        name = gemm_quant.DEQUANT_F32_FORMS[kind]
        wrapper = getattr(gemm_quant, gemm_quant.DEQUANT_FORMS[kind])
        plain_fn = getattr(gemm_quant, f"{gemm_quant.DEQUANT_FORMS[kind]}_plain")
        # the same exact float32 weights in three TF32 passes: each product
        # within ~3 * 2^-22 of the exact one, float32 sums in another order
        tol, why, op_type = 1e-5, ("the same float32 weights, products in three TF32 passes, "
                                   "float32 sums in another order"), "tf32x3"
    else:
        name = gemm_quant.W4A8_FORMS[kind] + ".f32"
        wrapper = gemm_quant.qmm_w4a8
        plain_fn = getattr(gemm_quant, f"{gemm_quant.W4A8_FORMS[kind]}_plain")
        tol, why = 1e-4, "same int8 activations, float32 group sums in another order"
        op_type = "int8"
    kernel = lambda: wrapper(x, qt)  # noqa: E731
    plain = lambda: plain_fn(xp, *planes)  # noqa: E731
    w32 = dequantize(qt)
    got = kernel()
    extra = None if form != "dequant" else _split_model_record(
        got, gemm_quant.qmm_f32_split_plain(x, w32), tol, 2.0 * rows * m * k)
    rec = _matmul_record(
        timer, name, f"{_on_planes(qt)}{rows}x{k} @ ({m}x{k})^T float32", kernel, plain,
        lambda: torch.matmul(x, w32.t()), "torch.matmul(f32, TF32 off)", got, plain(), None,
        tol, why, x.numel() * 4 + _weight_bytes(qt) + rows * m * 4, 2.0 * rows * m * k, op_type,
        extra)
    return name, rec


def _split_model_record(got, model, tol: float, ops: float) -> dict:
    """A float32 tensor-core kernel (the dequant matmul, flash) against the
    three-pass model of its arithmetic (`qmm_f32_split_plain`,
    `flash_attention_split_plain`: the same TF32 parts, exact products,
    float32 sums), held at `tol` of max|model|; and its FFMA bound."""
    import torch

    torch.cuda.synchronize()
    err = (got - model).abs().max().item()
    ref = model.abs().max().item()
    return {"split_model_max_abs_err": err,
            "split_model_ok": math.isfinite(err) and err <= tol * ref,
            "bound_ffma_ms": bound_ms(0, ops, "f32")[0]}


def _padded_x(x, qt):
    """x (rows, k) zero-padded to the depth of `qt`'s kernel planes: a legacy
    weight whose rows are not whole 256-element superblocks holds planes
    padded with zero scales (quant/qtensor.py), which the plain versions take
    as they are; the wrappers pad x themselves."""
    import torch.nn.functional as F

    return F.pad(x, (0, qt.plane_k - x.shape[1])) if qt.plane_k != x.shape[1] else x


def _weight_bytes(qt) -> int:
    """The bytes a product must read of `qt`'s planes: those of its k
    columns, not of a padded tail (which the kernels read, at plane_k / k
    the bytes: 1.78x at stories15M's k = 288)."""
    return sum(t.numel() * t.element_size() for t in qt.planes.values()) * qt.k // qt.plane_k


def _plane_bytes(qt, names, planes=None) -> int:
    """Bytes of the named planes of `qt`; of a stack, only the experts in `planes`."""
    total = 0
    for n in names:
        t = qt.planes[n]
        total += t[0].numel() * t.element_size() * len(planes) if planes is not None \
            else t.numel() * t.element_size()
    return total


def _matmul_record(timer, name, shape, kernel, plain, library, lib_name, got32, want, got_bf16,
                   tol, why, nbytes, ops, op_type, extra: dict | None = None) -> dict:
    """Compare, time and report one matmul check (the shared tail of the
    checks below); `extra`: the float32 form's comparison with its
    three-pass model (`_split_model_record`), which must hold too."""
    import torch

    torch.cuda.synchronize()
    err = (got32 - want).abs().max().item()
    ref = want.abs().max().item()
    # the float32 forms write float32 only (got_bf16 None)
    rounded_once = got_bf16 is None or torch.equal(got_bf16, got32.to(torch.bfloat16))
    ok = math.isfinite(err) and err <= tol * ref and rounded_once
    ok = ok and (extra is None or extra["split_model_ok"])
    b_ms, b_by = bound_ms(nbytes, ops, op_type)
    rec = {
        "shape": shape, "max_abs_err": err, "max_abs_ref": ref,
        "tolerance": f"float32 out: max_abs_err <= {tol} * max|ref| ({why})"
                     + ("" if got_bf16 is None else
                        "; bfloat16 out (timed): equal to the float32 out rounded once"),
        "bf16_out_rounded_once": rounded_once, "ok": ok,
        "ms": timer(kernel), "plain_ms": timer(plain), "library_ms": timer(library),
        "bound_ms": b_ms, "bound_by": b_by, **(extra or {}),
    }
    model = "" if extra is None else (
        f", three-pass model max_abs_err {extra['split_model_max_abs_err']:.3e}, "
        f"FFMA bound {extra['bound_ffma_ms']:.4f} ms")
    say(f"{name} {shape}: max_abs_err {err:.3e} (max|ref| {ref:.3e}, {rec['tolerance']}) "
        f"{'ok' if ok else 'FAILED'}; {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
        f"{lib_name} {rec['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}){model}")
    return rec


def check_w8(timer, rows: int, m: int, k: int, seed: int, qt=None) -> dict:
    """qmm_w8 at a prefill chunk's rows of the 7B and Mixtral widths (on the
    W8 planes of a Q4_K weight, or of `qt`)."""
    import torch

    from crabml_tpu_torch.gguf.constants import GGMLType
    from crabml_tpu_torch.ops.cuda import gemm_quant
    from crabml_tpu_torch.quant.qtensor import dequantize

    qt = gemm_quant.augment_w8(qt if qt is not None else q4k_weight(m, k, seed, "cuda"))
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, k, generator=g, device="cuda").to(torch.bfloat16)
    p = qt.planes
    w_bf16 = dequantize(qt, torch.bfloat16)
    label = "" if qt.kind == GGMLType.Q4_K else f"W8 planes of a {qt.kind.name} weight: "
    return _matmul_record(
        timer, "qmm_w8", f"{label}{rows}x{k} @ ({m}x{k})^T",
        lambda: gemm_quant.qmm_w8(x, qt, torch.bfloat16),
        lambda: gemm_quant.qmm_w8_plain(x, p["w8"], p["dw"]),
        lambda: torch.matmul(x, w_bf16.t()), "torch.matmul(bf16)",
        gemm_quant.qmm_w8(x, qt), gemm_quant.qmm_w8_plain(x, p["w8"], p["dw"]),
        gemm_quant.qmm_w8(x, qt, torch.bfloat16),
        # the same int8 planes and bf16 x, exact products: only the order of
        # the float32 sums inside a 512-chunk differs
        1e-4, "same int8 planes, float32 sums in another order",
        x.numel() * 2 + _plane_bytes(qt, ("w8", "dw")) * k // p["w8"].shape[-1] + rows * m * 2,
        2.0 * rows * m * k, "bf16")


# the dequant forms on csrc/qmm_ws.cuh also at the other row counts whose tile
# heights its plan tells apart (qmm_ws_plan: 1,024 rows in 256-row tiles on
# two waves, 37 rows in one 48-row tile, 17 in one 24-row tile) and at wo (189
# rows: 64-row tiles), beside the shapes every scheme's form is held at
WS_SHAPES = {s: ((2 * PREFILL_CHUNK, QKV_M, DIM), (37, QKV_M, DIM), (17, QKV_M, DIM),
                 (RAGGED_CHUNK, DIM, DIM)) for s in ("q5_k", "q6_k", "q3_k", "q2_k")}

# the Mixtral prefill shape: a 512-token chunk is 1,024 (row, slot) pairs over
# 8 experts; a skewed routing with expert 0 empty and ragged segments
MOE_EXPERTS, MOE_USED = 8, 2
GROUPED_COUNTS = (0, 300, 37, 200, 128, 64, 195, 100)
# the float32 grouped forms also on segments with an empty and a one-row one
EDGE_COUNTS = (0, 1, 300, 37, 200, 128, 64, 294)


def scheme_stack(scheme: str, E: int, m: int, k: int, seed: int, w8: bool = False):
    """A random stack (E, m, k) of distinct `scheme` experts (tools/
    synth_gguf.py's blocks, each block's scales varied) in kernel layout,
    bf16 scales (`float32_scales` turns them to float32)."""
    import numpy as np
    import torch

    from crabml_tpu_torch.ops.cuda.gemm_quant import augment_w8
    from crabml_tpu_torch.quant.qtensor import to_kernel_layout, to_planar
    from crabml_tpu_torch.tools.synth_gguf import SCHEMES, vary_scales

    kind, blocks = SCHEMES[scheme]
    rng = np.random.default_rng(seed)
    raw = vary_scales(kind, blocks(rng, E * m * k, 1.0 / math.sqrt(k)), rng)
    qt = check_varied(to_kernel_layout(to_planar(kind, raw, (E, m, k), "cuda"), torch.bfloat16))
    return augment_w8(qt) if w8 else qt


def q4k_stack(E: int, m: int, k: int, seed: int, w8: bool):
    """A random stack (E, m, k) of Q4_K experts in kernel layout, bf16 scales."""
    return scheme_stack("q4_k", E, m, k, seed, w8)


def float32_scales(qt):
    """`qt` with its dsub / msub planes in float32, as the Runner loads a
    weight under float32 compute (the same values: a bfloat16 scale is exact
    in float32)."""
    from crabml_tpu_torch.quant.qtensor import QTensor

    return QTensor(qt.kind, qt.shape, {n: t.float() if n in ("dsub", "msub") else t
                                       for n, t in qt.planes.items()})


def check_grouped(timer, name: str, m: int, k: int, seed: int, qt=None,
                  f32: bool = False, counts=GROUPED_COUNTS) -> dict:
    """qmm_w8_grouped, or a scheme's grouped dequant form (qmm_q4k_grouped,
    qmm_q6k_grouped, ... on the stack `qt`), on 1,024 sorted pairs (segments
    of `counts` rows). The bound counts the planes of the experts that have
    rows, read once. `f32`: the float32 form (csrc/qmm_f32.cu) on float32 x
    and `qt` with float32 scale planes, float32 out, held at
    check_f32_matmul's 1e-5, also against its three-pass model, and bound by
    operations at TF32's rate over three; the library yardstick is float32
    torch.matmul (TF32 off) per segment."""
    import numpy as np
    import torch

    from crabml_tpu_torch.ops.cuda import gemm_quant
    from crabml_tpu_torch.quant.qtensor import FORM_KIND, dequantize

    w8 = name == "qmm_w8_grouped"
    if qt is None:
        qt = q4k_stack(MOE_EXPERTS, m, k, seed, w8)
    rows = sum(counts)
    cuts = np.concatenate([[0], np.cumsum(counts)])
    offsets = torch.tensor(cuts, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = torch.randn(rows, k, generator=g, device="cuda")
    if not f32:
        xs = xs.to(torch.bfloat16)
    p = qt.planes
    wrapper = getattr(gemm_quant, name)
    if w8:
        plain = lambda: gemm_quant.qmm_w8_grouped_plain(xs, p["w8"], p["dw"], offsets)  # noqa: E731
        names, why = ("w8", "dw"), "same int8 planes, float32 sums in another order"
    else:
        names = tuple(gemm_quant._KERNEL_PLANES[FORM_KIND[qt.kind]])
        plain_fn = getattr(gemm_quant, f"{name}_plain")
        plain = lambda: plain_fn(xs, *(p[n] for n in names), offsets)  # noqa: E731
        why = f"the same {'float32' if f32 else 'bf16'} weights, float32 sums in another order"
    w = dequantize(qt) if f32 else dequantize(qt, torch.bfloat16)
    segs = [(e, int(lo), int(hi)) for e, (lo, hi) in enumerate(zip(cuts, cuts[1:])) if hi > lo]

    def library():  # a loop of torch.matmul over the experts' segments
        return torch.cat([torch.matmul(xs[lo:hi], w[e].t()) for e, lo, hi in segs])

    used = [e for e, _, _ in segs]
    shape = f"{_on_planes(qt)}{rows} pairs {list(counts)} x{k} @ ({MOE_EXPERTS}x{m}x{k})^T"
    if f32:
        got = wrapper(xs, qt, offsets)
        extra = _split_model_record(
            got, gemm_quant.qmm_f32_grouped_split_plain(xs, w, offsets), 1e-5, 2.0 * rows * m * k)
        rec = _matmul_record(
            timer, f"{name}.f32", shape + " float32", lambda: wrapper(xs, qt, offsets), plain,
            library, "torch.matmul(f32, TF32 off) per segment", got, plain(), None, 1e-5,
            why.replace("weights,", "weights, products in three TF32 passes,"),
            xs.numel() * 4 + _plane_bytes(qt, names, used) + rows * m * 4, 2.0 * rows * m * k,
            "tf32x3", extra)
    else:
        rec = _matmul_record(
            timer, name, shape, lambda: wrapper(xs, qt, offsets, torch.bfloat16), plain, library,
            "torch.matmul(bf16) per segment", wrapper(xs, qt, offsets), plain(),
            wrapper(xs, qt, offsets, torch.bfloat16), 1e-4, why,
            xs.numel() * 2 + _plane_bytes(qt, names, used) + rows * m * 2, 2.0 * rows * m * k,
            "bf16")
    del w
    return rec


# the experts of the plane-per-row checks: never expert 0 (a form that read
# expert 0's planes, or one of its scale planes, would pass on it), 6 distinct of 8
PLANE_ROWS = (6, 1, 3, 3, 7, 2, 5, 1)


def check_w4a8_planes(timer, rows: int, m: int, k: int, seed: int, qt=None) -> tuple[str, dict]:
    """qmm_w4a8 with a plane per row (the MoE decode form) on a random Q4_K
    stack, or on the stack `qt` of any scheme: the bound counts each distinct
    selected plane once. Returns the form's counter name and its record."""
    import torch

    from crabml_tpu_torch.ops.cuda import gemm_quant
    from crabml_tpu_torch.quant.qtensor import FORM_KIND, dequantize

    if qt is None:
        qt = q4k_stack(MOE_EXPERTS, m, k, seed, False)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, k, generator=g, device="cuda").to(torch.bfloat16)
    plane = torch.tensor(PLANE_ROWS[:rows], device="cuda", dtype=torch.int32)
    p = qt.planes
    names = tuple(gemm_quant._KERNEL_PLANES[FORM_KIND[qt.kind]])
    form = gemm_quant.W4A8_FORMS[FORM_KIND[qt.kind]]
    plain_fn = getattr(gemm_quant, f"{form}_plain")
    distinct = sorted(set(PLANE_ROWS[:rows]))
    w_rows = dequantize(qt, torch.bfloat16)[plane.long()].transpose(1, 2).contiguous()
    plain = lambda: plain_fn(x, *(p[n] for n in names), plane=plane)  # noqa: E731
    rec = _matmul_record(
        timer, f"{form}.planes", f"{_on_planes(qt)}{rows}x{k} @ plane-per-row of "
        f"({MOE_EXPERTS}x{m}x{k})^T, {len(distinct)} distinct planes",
        lambda: gemm_quant.qmm_w4a8(x, qt, torch.bfloat16, plane), plain,
        lambda: torch.bmm(x[:, None], w_rows), "torch.bmm(bf16, planes gathered beforehand)",
        gemm_quant.qmm_w4a8(x, qt, plane=plane), plain(),
        gemm_quant.qmm_w4a8(x, qt, torch.bfloat16, plane),
        1e-4, "same int8 activations, float32 group sums in another order",
        x.numel() * 2 + _plane_bytes(qt, names, distinct) + rows * m * 2,
        2.0 * rows * m * k, "int8")
    del w_rows
    return f"{form}.planes", rec


def _sdpa(q, k_cache, v_cache, pos: int, T: int, window: int = 0):
    """One torch.nn.functional.scaled_dot_product_attention call over the
    live keys with the same causal bounds and the same sliding window in its
    mask (the library yardstick)."""
    import torch
    import torch.nn.functional as F

    n = pos + T
    qh = q.transpose(1, 2)  # (B, H, T, hd)
    k, v = k_cache[:, :, :n], v_cache[:, :, :n]
    row = pos + torch.arange(T, device=q.device)[:, None]
    col = torch.arange(n, device=q.device)[None, :]
    mask = col <= row
    if window:
        mask = mask & (col > row - window)
    return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask, enable_gqa=True)


def check_attention(timer, name: str, T: int, pos: int, seed: int, softcap: float = 0.0,
                    window: int = 0, dims=(HEADS, KV_HEADS, HEAD_DIM, CTX),
                    dtype: str = "bf16") -> dict:
    """One sequence (B=1) of T new tokens at `pos` through `name` (the flash
    kernel, or a dense decode form), `dims` = (q heads, kv heads, head dim,
    cache rows): the 7B's by default, G2_ATTN for gemma2; q and the cache in
    `dtype`, bf16 or f32."""
    import torch

    from crabml_tpu_torch.ops.cuda import decode_attention as da
    from crabml_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    H, KV, hd, S = dims
    B = 1
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    q = torch.randn(B, T, H, hd, generator=g, device="cuda").to(tdt)
    kc = torch.randn(B, KV, S, hd, generator=g, device="cuda").to(tdt)
    vc = torch.randn(B, KV, S, hd, generator=g, device="cuda").to(tdt)
    posv = torch.tensor([pos], dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(hd)
    kw = dict(softcap=softcap, local_window=window)
    if name == "decode_attention_fused":  # the step's keys from their own block
        kn, vn = (c[:, :, pos : pos + T].contiguous() for c in (kc, vc))
        kernel = lambda: da.decode_attention_fused(  # noqa: E731
            q, kc[None], vc[None], 0, posv, scale, kn, vn, **kw)
    elif name == "decode_attention":
        kernel = lambda: da.decode_attention(q, kc, vc, posv, scale, **kw)  # noqa: E731
    else:
        kernel = lambda: fa.flash_attention(q, kc, vc, posv, scale, softcap, window)  # noqa: E731
    plain = lambda: fa.flash_attention_plain(q, kc, vc, posv, scale, softcap, window)  # noqa: E731
    # SDPA has no softcap: no library time for that form
    library = None if softcap else lambda: _sdpa(q, kc, vc, pos, T, window)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    # float32 softmax on both sides; each output rounds to bfloat16 once,
    # so the two may differ by one bf16 unit (2^-8 relative) of the value.
    # The flash kernel also rounds the probabilities to bfloat16 for its
    # second product: errors of 2^-9 a key that average out over a row.
    # float32: the kernel's fast exp and its other order of sums
    tol = 1e-4 if dtype == "f32" else 2.0 ** -7
    ok = math.isfinite(err) and err <= tol * ref
    # what this run's mask needs: the keys some row sees, read once, and the
    # live (query, key) pairs
    first_key = max(0, pos - window + 1) if window else 0
    n_keys = pos + T - first_key
    size = q.element_size()
    qo_bytes = 2 * B * T * H * hd * size  # q read and out written
    kv_bytes = 2 * B * KV * n_keys * hd * size  # live keys and values
    pairs = sum(min(pos + t + 1, window or pos + t + 1) for t in range(T))  # per head
    ops = 4.0 * B * H * hd * pairs
    # float32 flash: both products in three TF32 passes on the tensor cores
    tc_f32 = dtype == "f32" and name == "flash_attention"
    b_ms, b_by = bound_ms(qo_bytes + kv_bytes, ops, "tf32x3" if tc_f32 else dtype)
    form = (f" softcap={softcap:g}" if softcap else "") + (f" window={window}" if window else "")
    rec = {
        "shape": f"B={B} T={T} pos={pos} H={H} KV={KV} hd={hd} S={S}{form}"
                 + (" float32" if dtype == "f32" else ""),
        "max_abs_err": err, "max_abs_ref": ref,
        "tolerance": ("max_abs_err <= 1e-4 * max|ref| (three TF32 passes: the dropped lo x lo "
                      "terms, the tensor cores' accumulation, fast exp2)" if tc_f32 else
                      "max_abs_err <= 1e-4 * max|ref| (fast exp, another order of sums)")
                     if dtype == "f32" else
                     "max_abs_err <= 2^-7 * max|ref| (one bfloat16 rounding of the output)",
    }
    if tc_f32:  # the kernel against the plain model of its arithmetic too, at the same gate
        model = fa.flash_attention_split_plain(q, kc, vc, posv, scale, softcap, window)
        rec.update(_split_model_record(got, model, tol, ops))
        ok = ok and rec["split_model_ok"]
        del model
    rec.update({"ok": ok, "ms": timer(kernel), "plain_ms": timer(plain),
                "library_ms": timer(library) if library else None,
                "bound_ms": b_ms, "bound_by": b_by})
    lib = f"{rec['library_ms']:.4f} ms" if library else "none (no softcap in SDPA)"
    split = (f"; against the three-pass model {rec['split_model_max_abs_err']:.3e}, FFMA bound "
             f"{rec['bound_ffma_ms']:.4f} ms" if tc_f32 else "")
    say(f"{name} {rec['shape']}: max_abs_err {err:.3e} (max|ref| {ref:.3e}, "
        f"{rec['tolerance']}) {'ok' if ok else 'FAILED'}; {rec['ms']:.4f} ms, "
        f"plain {rec['plain_ms']:.4f} ms, sdpa {lib}, bound {b_ms:.4f} ms ({b_by}){split}")
    return rec


def check_decode_form(timer, form: str, kv: str, T: int, seed: int, softcap: float = 0.0,
                      window: int = 0, dims=(HEADS, KV_HEADS, HEAD_DIM),
                      q_dtype: str = "bf16") -> tuple[str, dict]:
    """One form of the decode-attention kernel at the serving shape: 8
    sequences, `dims` = (q heads, kv heads, head dim) (the 7B's 32 / 8 / 128
    by default; gemma2's 16 / 8 / 256), prefixes ragged from 1 to ~1,000
    tokens. form: dense | dense_fused | paged | paged_fused (fused: the
    step's keys come in their own block); kv: bf16 | f32 | int8; q in
    `q_dtype` (bf16 | f32: float32 compute, and with another cache dtype the
    mixed forms). The paged forms read a 256-page pool through a shuffled
    block table."""
    import torch
    import torch.nn.functional as F

    from crabml_tpu_torch.models.forward import q8_vec
    from crabml_tpu_torch.ops.cuda import decode_attention as da
    from crabml_tpu_torch.ops.cuda import paged_decode_attention as pa

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    H, KV, hd = dims
    B, PAGE = SERVING_SLOTS, pa.PAGE
    prefix = [1, 37, 128, 255, 400, 640, 900, 1000]
    max_pages = 9  # room for 1000 + 8 tokens
    S = max_pages * PAGE
    fused, paged = form.endswith("fused"), form.startswith("paged")
    scale = 1.0 / math.sqrt(hd)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    qdt = torch.float32 if q_dtype == "f32" else torch.bfloat16
    q = rand(B, T, H, hd).to(qdt)
    posv = torch.tensor(prefix, dtype=torch.int32, device=dev)
    n_pool = SERVING_PAGES if paged else B * max_pages
    k, v = rand(n_pool, KV, PAGE, hd), rand(n_pool, KV, PAGE, hd)
    kn, vn = rand(B, KV, T, hd), rand(B, KV, T, hd)
    ks = vs = ksn = vsn = None
    if kv == "int8":
        (k, ks), (v, vs), (kn, ksn), (vn, vsn) = (q8_vec(a) for a in (k, v, kn, vn))
    else:
        kdt = torch.float32 if kv == "f32" else torch.bfloat16
        k, v, kn, vn = (a.to(kdt) for a in (k, v, kn, vn))
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
        lengths = posv + T
        kernel = lambda: pa.paged_decode_attention(  # noqa: E731
            q, k, v, table, lengths, scale, ks, vs, **kw)
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
        kd, vd = kd.to(qdt), vd.to(qdt)
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
    # bfloat16 out: one bfloat16 rounding of the output (int8 dequantizes exactly on
    # both sides); float32 out: the kernel's fast exp and its other order of sums
    tol = 1e-4 if q_dtype == "f32" else 2.0 ** -7
    ok = math.isfinite(err) and err <= tol * ref
    # the bytes this run's data needs: q and out, and each live key and value
    # (from the earliest row's window start on) with its scale, read once
    row_bytes = hd * {"int8": 1, "bf16": 2, "f32": 4}[kv] + (4 if kv == "int8" else 0)
    live = sum(p + T - (max(p + 1 - window, 0) if window else 0) for p in prefix)
    pairs = sum(min(p + t + 1, window) if window else p + t + 1 for p in prefix for t in range(T))
    nbytes = 2 * B * T * H * hd * q.element_size() + 2 * KV * live * row_bytes
    # bfloat16 on both sides takes the tensor cores; float32 anywhere, FFMA
    op_type = "f32" if "f32" in (q_dtype, kv) else "bf16"
    b_ms, b_by = bound_ms(nbytes, 4.0 * H * hd * pairs, op_type)
    rec = {
        "shape": f"{form} q {q_dtype} kv {kv} B={B} T={T} prefixes {prefix[0]}..{prefix[-1]} "
                 f"H={H} KV={KV} hd={hd}" + (f" pool={SERVING_PAGES} pages, shuffled table" if paged
                                       else f" S={S}")
                 + (f" softcap={softcap:g}" if softcap else "") + (f" window={window}" if window else ""),
        "max_abs_err": err, "max_abs_ref": ref,
        "tolerance": "max_abs_err <= 1e-4 * max|ref| (fast exp, another order of sums)"
                     if q_dtype == "f32" else
                     "max_abs_err <= 2^-7 * max|ref| (one bfloat16 rounding of the output)",
        "ok": ok, "ms": timer(kernel), "plain_ms": timer(plain),
        "library_ms": timer(library) if library else None,
        "bound_ms": b_ms, "bound_by": b_by, "live_kv_bytes": 2 * KV * live * row_bytes,
    }
    lib = f"{rec['library_ms']:.4f} ms" if library else "none (no softcap in SDPA)"
    say(f"{name} {rec['shape']}: max_abs_err {err:.3e} (max|ref| {ref:.3e}, {rec['tolerance']}) "
        f"{'ok' if ok else 'FAILED'}; {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
        f"sdpa over a dense copy (gather not timed) {lib}, bound {b_ms:.4f} ms ({b_by})")
    return name, rec


def decode_checks(timer) -> dict[str, list[dict]]:
    """Every decode-attention form: B=1 at the main path's shape (T=1 at pos
    1000 of the 4,096-token cache, and the fused form at pos 4000, the long
    context's bytes), then each form at the 8-slot serving shape. The first
    record of a name is the one the kernels line reports."""
    checks = {
        "decode_attention": [check_attention(timer, "decode_attention", 1, 1000, 6)],
        "decode_attention_fused": [check_attention(timer, "decode_attention_fused", 1, 1000, 6),
                                   check_attention(timer, "decode_attention_fused", 1, 4000, 12)],
    }
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
    return checks


def g2_attention_checks(timer) -> dict[str, list[dict]]:
    """Every attention form at gemma2's head dim 256 (16 q / 8 kv heads,
    Gemma-2-9B's 8,192-row cache): the flash kernel at a first and a second
    512-token chunk, the 189-token ragged chunk, and a 512-token chunk at pos
    4,096 with the window of 4,096 (its first 4,096 - 511 keys dropped per
    row, whole tiles skipped) and the softcap 50; the fused dense form at B=1
    T=1 at pos 4,700, plain and with window and softcap; the unfused dense
    form at the path's 4-token tail; the paged forms at the 8-slot serving
    shape, bfloat16 and int8 (the fused bfloat16 one also with window and
    softcap)."""
    checks: dict[str, list[dict]] = {}

    def add(name, rec):
        checks.setdefault(name, []).append(rec)

    for T, pos, seed, cap, win in ((PREFILL_CHUNK, 0, 150, 0.0, 0),
                                   (PREFILL_CHUNK, PREFILL_CHUNK, 151, 0.0, 0),
                                   (RAGGED_CHUNK, PREFILL_CHUNK, 152, 0.0, 0),
                                   (PREFILL_CHUNK, G2_WINDOW, 153, G2_SOFTCAP, G2_WINDOW)):
        add("flash_attention", check_attention(timer, "flash_attention", T, pos, seed, cap, win,
                                               dims=G2_ATTN))
    for seed, cap, win in ((154, 0.0, 0), (155, G2_SOFTCAP, G2_WINDOW)):
        add("decode_attention_fused", check_attention(timer, "decode_attention_fused", 1, 4700,
                                                      seed, cap, win, dims=G2_ATTN))
    add("decode_attention", check_attention(timer, "decode_attention", 4, 9 * PREFILL_CHUNK, 156,
                                            0.0, G2_WINDOW, dims=G2_ATTN))
    for i, (form, kv, cap, win) in enumerate((
            ("paged_fused", "bf16", 0.0, 0), ("paged_fused", "int8", 0.0, 0),
            ("paged_fused", "bf16", G2_SOFTCAP, 256), ("paged", "bf16", 0.0, 0),
            ("paged", "int8", 0.0, 0))):
        add(*check_decode_form(timer, form, kv, 1, 157 + i, cap, win, dims=G2_ATTN[:3]))
    return checks


def q2_attention_checks(timer) -> dict[str, list[dict]]:
    """Every attention form at Qwen2-7B's 28 q heads over 4 kv heads (G = 7,
    head dim 128, a 4,096-row cache): flash, whose warpgroups then hold 9
    tokens of 7 heads and one padding row, at a first and a second 512-token
    chunk and the 189-token ragged chunk; the fused dense form at B=1 T=1 at
    pos 1000 (7 query rows) and the unfused one at T=2 (14); the paged forms
    at the 8-slot serving shape, bfloat16 and int8."""
    checks: dict[str, list[dict]] = {}

    def add(name, rec):
        checks.setdefault(name, []).append(rec)

    for T, pos, seed in ((PREFILL_CHUNK, 0, 180), (PREFILL_CHUNK, PREFILL_CHUNK, 181),
                         (RAGGED_CHUNK, PREFILL_CHUNK, 182)):
        add("flash_attention", check_attention(timer, "flash_attention", T, pos, seed,
                                               dims=Q2_ATTN))
    add("decode_attention_fused", check_attention(timer, "decode_attention_fused", 1, 1000, 183,
                                                  dims=Q2_ATTN))
    add("decode_attention", check_attention(timer, "decode_attention", 2, 1000, 184,
                                            dims=Q2_ATTN))
    for i, (form, kv) in enumerate((("paged_fused", "bf16"), ("paged_fused", "int8"),
                                    ("paged", "bf16"), ("paged", "int8"))):
        add(*check_decode_form(timer, form, kv, 1, 185 + i, dims=Q2_ATTN[:3]))
    return checks


def phi_attention_checks(timer) -> dict[str, list[dict]]:
    """Every attention form at Phi-3-mini's head dim 96 and phi-2's 80 (32 q
    heads over 32 kv heads; a 4,096- and a 2,048-row cache), on the 128
    kernels' tiles: flash in bfloat16 and in float32 at a first and a second
    512-token chunk and the 189-token ragged chunk; the fused and unfused
    dense forms at B=1 T=1 at pos 1000; the four forms at the 8-slot serving
    shape, bfloat16 and int8. Then flash at the three chunks and the fused
    dense form at pos 1000 at head dim 128 with phi-2's heads, against
    which the kernels' zero-padding of hd 80 to 128 lanes is costed."""
    checks: dict[str, list[dict]] = {}

    def add(name, rec):
        checks.setdefault(name, []).append(rec)

    for i, (what, dims) in enumerate(PHI_ATTN.items()):
        seed = 200 + 20 * i
        for dtype in ("bf16", "f32"):
            for j, (T, pos) in enumerate(((PREFILL_CHUNK, 0), (PREFILL_CHUNK, PREFILL_CHUNK),
                                          (RAGGED_CHUNK, PREFILL_CHUNK))):
                add("flash_attention", check_attention(timer, "flash_attention", T, pos,
                                                       seed + j, dims=dims, dtype=dtype))
        for j, name in enumerate(("decode_attention_fused", "decode_attention")):
            add(name, check_attention(timer, name, 1, 1000, seed + 3 + j, dims=dims))
        for j, (form, kv) in enumerate((("paged_fused", "bf16"), ("paged_fused", "int8"),
                                        ("paged", "bf16"), ("paged", "int8"),
                                        ("dense_fused", "bf16"), ("dense_fused", "int8"),
                                        ("dense", "bf16"), ("dense", "int8"))):
            add(*check_decode_form(timer, form, kv, 1, seed + 5 + j, dims=dims[:3]))
    padded = (P2_HEADS, P2_HEADS, 128, P2_CTX)
    for j, (T, pos) in enumerate(((PREFILL_CHUNK, 0), (PREFILL_CHUNK, PREFILL_CHUNK),
                                  (RAGGED_CHUNK, PREFILL_CHUNK))):
        add("flash_attention", check_attention(timer, "flash_attention", T, pos, 245 + j,
                                               dims=padded))
    add("decode_attention_fused", check_attention(timer, "decode_attention_fused", 1, 1000, 248,
                                                  dims=padded))
    return checks


def check_norm(timer, kind: str, rows: int, n: int, dtype: str, seed: int,
               qk_heads: int = 0) -> dict:
    """csrc/norm.cu (`kind` "rms" or "layer") at `rows` rows of `n` in
    `dtype` against its plain version, with qwen3's per-head weight
    (qk_heads rows, x then (tokens, qk_heads, n)) where given; and batch
    invariance: the first token alone, the first two and the first eight
    give the bits they have in the whole call.

    The library time is torch.nn.functional's rms_norm / layer_norm, the
    same function (rms_norm with a bfloat16 x beside float32 weights takes
    its unfused form, and warns so); layer_norm refuses that pair, so on
    bfloat16 x it takes the weights rounded to bfloat16; qwen3's per-head
    weight (one row a head) is rms_norm without a weight and one multiply,
    since rms_norm's weight spans the normalized shape only."""
    import warnings

    import torch

    from crabml_tpu_torch.ops.cuda import norm

    g = torch.Generator(device="cuda").manual_seed(seed)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    x = (torch.randn(rows, n, generator=g, device="cuda") * 3 + 0.5).to(tdt)
    w = torch.randn(*((qk_heads, n) if qk_heads else (n,)), generator=g, device="cuda")
    b = torch.randn(n, generator=g, device="cuda") if kind == "layer" else None
    if qk_heads:
        x = x.reshape(rows // qk_heads, qk_heads, n)
    eps = 1e-5
    F = torch.nn.functional
    warnings.filterwarnings("ignore", message="Mismatch dtype between input and weight")
    if kind == "rms":
        run = lambda t: norm.rms_norm(t, w, eps)  # noqa: E731
        plain = lambda: norm.rms_norm_plain(x, w, eps)  # noqa: E731
        if qk_heads:
            library = lambda: F.rms_norm(x, (n,), eps=eps) * w  # noqa: E731
        else:
            library = lambda: F.rms_norm(x, (n,), w, eps)  # noqa: E731
    else:
        run = lambda t: norm.layer_norm(t, w, eps, b)  # noqa: E731
        plain = lambda: norm.layer_norm_plain(x, w, eps, b)  # noqa: E731
        wl, bl = w.to(tdt), b.to(tdt)
        library = lambda: F.layer_norm(x, (n,), wl, bl, eps)  # noqa: E731
    got, want = run(x), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    # float32: the same arithmetic, the row's sum in another order with the
    # squares in fma; bfloat16: both round that float32 value once
    tol = 2e-6 if dtype == "f32" else 2.0 ** -7
    # the first 1, 2 and 8 rows (tokens of qk_heads rows) alone
    invariant = all(torch.equal(run(x[:t]), got[:t]) for t in (1, 2, 8) if t <= x.shape[0])
    ok = math.isfinite(err) and err <= tol * ref and invariant
    size = x.element_size()
    nbytes = 2 * rows * n * size + w.numel() * 4 + (n * 4 if b is not None else 0)
    b_ms, b_by = bound_ms(nbytes, (7.0 if kind == "layer" else 5.0) * rows * n, "f32")
    rec = {
        "shape": f"{kind} rows={rows} n={n}" + (f" heads={qk_heads}" if qk_heads else "")
                 + (" float32" if dtype == "f32" else " bfloat16"),
        "max_abs_err": err, "max_abs_ref": ref, "batch_invariant": invariant,
        "tolerance": ("max_abs_err <= 2e-6 * max|ref| (another order of the row's sum, fma)"
                      if dtype == "f32" else
                      "max_abs_err <= 2^-7 * max|ref| (one bfloat16 rounding of the output)"),
        "ok": ok, "ms": timer(lambda: run(x)), "plain_ms": timer(plain),
        "library_ms": timer(library), "bound_ms": b_ms, "bound_by": b_by,
    }
    lib = f"{rec['library_ms']:.4f} ms"
    say(f"{kind}_norm {rec['shape']}: max_abs_err {err:.3e} (max|ref| {ref:.3e}, "
        f"{rec['tolerance']}), batch invariant {invariant}, {'ok' if ok else 'FAILED'}; "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library {lib}, "
        f"bound {b_ms:.4f} ms ({b_by})")
    return rec


def norm_checks(timer) -> dict[str, list[dict]]:
    """The norm kernel at its paths' shapes: the 7B's decode row, the 8-slot
    tick and a 512-row prefill chunk, in bfloat16 and float32; Qwen3-8B's
    per-head q|k norm (40 heads of 128 over a 512-token chunk); phi2's
    LayerNorm at 2560 (a row, a chunk)."""
    recs = {"rms_norm": [], "layer_norm": []}
    for i, dtype in enumerate(("bf16", "f32")):
        for rows in (1, SERVING_SLOTS, PREFILL_CHUNK):
            recs["rms_norm"].append(check_norm(timer, "rms", rows, DIM, dtype, 300 + i + rows))
        recs["layer_norm"] += [check_norm(timer, "layer", rows, P2_DIM, dtype, 310 + i + rows)
                               for rows in (1, PREFILL_CHUNK)]
    recs["rms_norm"].append(check_norm(timer, "rms", PREFILL_CHUNK * 40, HEAD_DIM, "bf16", 320,
                                       qk_heads=40))
    return recs


def check_f32_flash_plan() -> None:
    """The float32 flash kernel's plan as csrc/flash_attention.cu compiles it
    (its flash_f32_layout entry) is ops/cuda/flash_attention.py's
    flash_f32_plan, at every head dim, with one warpgroup a block and with
    two where the tile width takes them."""
    import ctypes

    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.ops.cuda import flash_attention as fa

    fn = _build.library("flash_attention").flash_f32_layout
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    for hd in fa.HEAD_DIMS:
        for T in (16, 4096):
            plan = fa.flash_f32_plan(hd, T, 4, KV_HEADS)
            got = (ctypes.c_int * 6)()
            want = [plan.tile_width, plan.keys, plan.warpgroups, plan.stages, plan.smem_bytes,
                    plan.rows_per_block]
            if fn(hd, plan.warpgroups, got) != 0 or list(got) != want:
                fail(f"flash_f32_layout at hd {hd}, {plan.warpgroups} warpgroups: {list(got)}, "
                     f"flash_f32_plan {want}")
    say(f"flash_f32_plan = the kernel's F32Plan at all {len(fa.HEAD_DIMS)} head dims")


def check_ws_plan() -> None:
    """The rings of csrc/qmm_ws.cuh (qmm_q5k, qmm_q6k, qmm_q3k, qmm_q2k) as
    each source compiles them (its <form>_ws_layout entry) are
    ops/cuda/gemm_quant.py's qmm_ws_ring, at every tile height the plan may
    pick."""
    import ctypes

    from crabml_tpu_torch.ops.cuda import _build, gemm_quant

    for kind in gemm_quant.WS_FORMS:
        name = gemm_quant.DEQUANT_FORMS[kind]
        fn = getattr(_build.library(name), f"{name}_ws_layout")
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        for tile in gemm_quant.WS_TILE_ROWS:
            got = (ctypes.c_int * 3)()
            want = list(gemm_quant.qmm_ws_ring(kind, tile))
            if fn(tile, got) != 0 or list(got) != want:
                fail(f"{name}_ws_layout at {tile} rows: {list(got)}, qmm_ws_ring {want}")
    say(f"qmm_ws_ring = the kernels' rings of {len(gemm_quant.WS_FORMS)} forms at all "
        f"{len(gemm_quant.WS_TILE_ROWS)} tile heights")


def check_ws_bits() -> None:
    """Each form on csrc/qmm_ws.cuh gives the same bits whatever its launch:
    300 rows of x against a 200-row weight at every tile height of
    WS_TILE_ROWS through the C entry equal the plan's launch; its first 1,
    17 and 37 rows alone equal those rows of it; and every segment of a
    grouped launch on EDGE_COUNTS (an empty and a one-row segment; 8
    distinct experts) equals the dense launch on its expert's plane. Each
    output is one wgmma chain over k, whatever the tile."""
    import torch

    from crabml_tpu_torch.ops.cuda import _build, gemm_quant
    from crabml_tpu_torch.quant.qtensor import plane_of

    rows, m, k = 300, 200, 512
    for i, kind in enumerate(gemm_quant.WS_FORMS):
        name, scheme = gemm_quant.DEQUANT_FORMS[kind], kind.name.lower()
        qt = scheme_weight(scheme, m, k, 300 + i, "cuda")
        g = torch.Generator(device="cuda").manual_seed(310 + i)
        x = torch.randn(rows, k, generator=g, device="cuda").to(torch.bfloat16)
        fn = getattr(gemm_quant, name)
        ref = fn(x, qt)
        entry = gemm_quant._lib_dequant(kind)[1]
        planes = [qt.planes[n] for n in gemm_quant._KERNEL_PLANES[kind]]
        for tile in gemm_quant.WS_TILE_ROWS:
            out = torch.empty(rows, m, dtype=torch.float32, device="cuda")
            err = entry(x.data_ptr(), *(t.data_ptr() for t in planes), out.data_ptr(), 0, rows,
                        m, k, tile, _build.stream_ptr(x))
            torch.cuda.synchronize()
            if err != 0 or not torch.equal(out, ref):
                fail(f"{name} at {tile}-row tiles: error {err}, or other bits than its plan's")
        for r in (1, 17, 37):
            if not torch.equal(fn(x[:r].contiguous(), qt), ref[:r]):
                fail(f"{name}: {r} rows alone give other bits than in a launch of {rows}")
        stack = scheme_stack(scheme, MOE_EXPERTS, m, k, 320 + i)
        cuts = [0]
        for n in EDGE_COUNTS:
            cuts.append(cuts[-1] + n)
        xs = torch.randn(cuts[-1], k, generator=g, device="cuda").to(torch.bfloat16)
        got = getattr(gemm_quant, gemm_quant.GROUPED_FORMS[kind])(
            xs, stack, torch.tensor(cuts, dtype=torch.int32, device="cuda"))
        for e, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
            if hi > lo and not torch.equal(fn(xs[lo:hi], plane_of(stack, e)), got[lo:hi]):
                fail(f"{name}_grouped: segment {e} ({hi - lo} rows) differs from the dense "
                     "launch on its plane")
        del qt, stack
    torch.cuda.empty_cache()
    say(f"qmm_ws forms bit-equal at every tile height, alone and per grouped segment: "
        f"{', '.join(gemm_quant.DEQUANT_FORMS[k] for k in gemm_quant.WS_FORMS)}")


def f32_checks(timer) -> dict[str, list[dict]]:
    """The float32 forms and the decode forms in float32 and over a cache of
    another dtype. Each scheme's float32 dequant form at a 512-row and at the
    ragged 189-row chunk of the 7B qkv (and Q4_K's at a 512-row chunk of
    down; Q4_K's, Q6_K's and Q2_K's also at 1 and 17 rows of qkv), its float32
    int8-activation form at 1, 8 and 16 rows of qkv, Q4_K's also at every
    other 7B decode projection at one row; then the decode forms with float32
    q at gemma2's head dim 256 (one tile for K, then V) over a float32,
    bfloat16 or int8 cache and at the 7B's 128 over a bfloat16 or int8 one,
    bfloat16 q over a float32 cache, and the flash kernel in float32 at head
    dim 256 and at the 7B's 128 (the 7b-f32 path's prefill: 512-token chunks
    at pos 0 and 512 and the 189-token chunk; the path converts the bfloat16
    cache's live keys to float32 before the launch)."""
    import torch

    checks: dict[str, list[dict]] = {}

    def add(name, rec):
        checks.setdefault(name, []).append(rec)

    for i, scheme in enumerate(("q4_k",) + KERNEL_SCHEMES):
        seed = 300 + 4 * i
        shapes = [(PREFILL_CHUNK, QKV_M, DIM), (RAGGED_CHUNK, QKV_M, DIM)]
        if scheme == "q4_k":
            shapes.append((PREFILL_CHUNK, DIM, FFN))
        if scheme in ("q4_k", "q6_k", "q2_k"):
            shapes += [(1, QKV_M, DIM), (17, QKV_M, DIM)]
        for rows, m, k in shapes:
            add(*check_f32_matmul(timer, scheme, "dequant", rows, m, k, seed))
        qt = scheme_weight(scheme, QKV_M, DIM, seed + 2, "cuda", torch.float32)
        for rows in (1, SERVING_SLOTS, 2 * SERVING_SLOTS):
            add(*check_f32_matmul(timer, scheme, "w4a8", rows, QKV_M, DIM, seed + 2, qt))
        del qt
        if scheme == "q4_k":
            for j, (m, k) in enumerate(((DIM, DIM), (2 * FFN, DIM), (DIM, FFN), (VOCAB, DIM))):
                add(*check_f32_matmul(timer, scheme, "w4a8", 1, m, k, seed + 3 + j))
        torch.cuda.empty_cache()
    # decode: gemma2's main-path step (B=1, pos 4,700, window and softcap) in float32
    add("decode_attention_fused", check_attention(timer, "decode_attention_fused", 1, 4700, 320,
                                                  G2_SOFTCAP, G2_WINDOW, dims=G2_ATTN,
                                                  dtype="f32"))
    add("flash_attention", check_attention(timer, "flash_attention", PREFILL_CHUNK, PREFILL_CHUNK,
                                           321, G2_SOFTCAP, 0, dims=G2_ATTN, dtype="f32"))
    for i, (T, pos) in enumerate(((PREFILL_CHUNK, 0), (PREFILL_CHUNK, PREFILL_CHUNK),
                                  (RAGGED_CHUNK, PREFILL_CHUNK))):
        add("flash_attention", check_attention(timer, "flash_attention", T, pos, 322 + i,
                                               dtype="f32"))
    # the longest sums the float32 paths give one row: the 7B's last chunk
    # (4,096 keys), gemma2's window of 4,096 at pos 4,096 with its softcap;
    # and Qwen2-7B's G = 7 at the ragged chunk
    add("flash_attention", check_attention(timer, "flash_attention", PREFILL_CHUNK,
                                           CTX - PREFILL_CHUNK, 325, dtype="f32"))
    add("flash_attention", check_attention(timer, "flash_attention", PREFILL_CHUNK, G2_WINDOW,
                                           326, G2_SOFTCAP, G2_WINDOW, dims=G2_ATTN, dtype="f32"))
    add("flash_attention", check_attention(timer, "flash_attention", RAGGED_CHUNK, PREFILL_CHUNK,
                                           327, dims=Q2_ATTN, dtype="f32"))
    for i, (form, q, kv, dims) in enumerate((
            ("dense_fused", "f32", "f32", G2_ATTN[:3]), ("paged_fused", "f32", "f32", G2_ATTN[:3]),
            ("paged", "f32", "f32", G2_ATTN[:3]), ("dense", "f32", "f32", G2_ATTN[:3]),
            ("dense_fused", "f32", "bf16", G2_ATTN[:3]),
            ("paged_fused", "f32", "int8", G2_ATTN[:3]),
            ("dense_fused", "f32", "bf16", (HEADS, KV_HEADS, HEAD_DIM)),
            ("paged_fused", "f32", "bf16", (HEADS, KV_HEADS, HEAD_DIM)),
            ("dense_fused", "f32", "int8", (HEADS, KV_HEADS, HEAD_DIM)),
            ("paged", "bf16", "f32", (HEADS, KV_HEADS, HEAD_DIM)))):
        add(*check_decode_form(timer, form, kv, 1, 330 + i, dims=dims, q_dtype=q))
    return checks


def hd16_attention_checks(timer) -> dict[str, list[dict]]:
    """Flash at head dim 16 (the committed HF fixtures), in bfloat16 and in
    float32: the fixtures' shapes (B=1, 4 q heads over 2 kv heads, their
    128-row context: the 16-token prompt at pos 0 and the decode step's one
    token at pos 15), and a 512-token chunk at pos 512 at the 7B's 32 / 8
    heads, plain and with the window 256 and the softcap 50."""
    checks: dict[str, list[dict]] = {"flash_attention": []}
    for i, dtype in enumerate(("bf16", "f32")):
        seed = 400 + 10 * i
        for j, (T, pos, cap, win, dims) in enumerate((
                (16, 0, 0.0, 0, HF_ATTN), (1, 15, 0.0, 0, HF_ATTN),
                (PREFILL_CHUNK, PREFILL_CHUNK, 0.0, 0, (HEADS, KV_HEADS, 16, CTX)),
                (PREFILL_CHUNK, PREFILL_CHUNK, 50.0, 256, (HEADS, KV_HEADS, 16, CTX)))):
            checks["flash_attention"].append(check_attention(
                timer, "flash_attention", T, pos, seed + j, cap, win, dims=dims, dtype=dtype))
    return checks


def spec_attention_checks(timer) -> dict[str, list[dict]]:
    """The decode forms past 16 query rows a kv head, at the speculative
    verify's shapes (row tiles of 16): the 7B's K = 4 verify (B=1, T=5 at
    G=4, 20 rows, at pos 1000 of the 4,096-row cache) in the unfused form
    that models.forward.verify_step takes and in the fused one; Qwen2-7B's
    widest (T=8 at G=7, 56 rows); the 8-slot paged verify (T=5) over a
    bfloat16 and an int8 pool, and its fused form; T=5 at G=4 at head dim
    256 (32 / 8 heads), in bfloat16 and in float32 (K and V in one tile),
    and at head dim 96."""
    checks: dict[str, list[dict]] = {}

    def add(name, rec):
        checks.setdefault(name, []).append(rec)

    T = SPEC_K + 1
    for name, seed in (("decode_attention", 500), ("decode_attention_fused", 501)):
        add(name, check_attention(timer, name, T, 1000, seed))
    add("decode_attention", check_attention(timer, "decode_attention", 8, 1000, 502,
                                            dims=Q2_ATTN))
    for i, (form, kv, t, dims, q) in enumerate((
            ("paged", "bf16", T, None, "bf16"), ("paged", "int8", T, None, "bf16"),
            ("paged_fused", "bf16", T, None, "bf16"), ("paged", "bf16", 8, Q2_ATTN[:3], "bf16"),
            ("dense", "bf16", T, (HEADS, KV_HEADS, 256), "bf16"),
            ("dense", "f32", T, (HEADS, KV_HEADS, 256), "f32"),
            ("dense_fused", "int8", T, (HEADS, KV_HEADS, 256), "bf16"),
            ("dense", "bf16", T, (HEADS, KV_HEADS, 96), "bf16"))):
        add(*check_decode_form(timer, form, kv, t, 510 + i, dims=dims or (HEADS, KV_HEADS,
                                                                           HEAD_DIM), q_dtype=q))
    return checks


def stories_checks(timer) -> dict[str, list[dict]]:
    """The forms the TinyStories models take, in bfloat16 and float32: flash
    at head dims that are not one of the tile widths, one of each class of
    lanes a tile row holds past the head dim (8 and 48 on 64-wide tiles at
    their models' shapes: a whole context as one prompt and the last decode
    step, over the whole cache; 24 with the window 256 and the softcap 50,
    72, 104, 200 and 248 at the 7B's 32 / 8 heads and a 512-token chunk at
    pos 512); then, at stories15M's k = 288 (planes padded to 512 with zero
    scales), the Q8_0, Q4_0 and Q5_0 dequant forms at a 256-token prompt of
    gate|up (1,536 rows), their int8-activation forms at one decode row of
    q|k|v (864 rows) and of the 32,000-row lm_head, qmm_w8 on a Q4_0
    weight's W8 planes, and Q8_0's float32 forms."""
    checks: dict[str, list[dict]] = {}

    def add(name, rec):
        checks.setdefault(name, []).append(rec)

    for i, dtype in enumerate(("bf16", "f32")):
        seed = 600 + 20 * i
        for j, (T, pos, cap, win, dims) in enumerate((
                (S15_CTX, 0, 0.0, 0, S15_ATTN), (1, S15_CTX - 1, 0.0, 0, S15_ATTN),
                (S260_ATTN[3], 0, 0.0, 0, S260_ATTN), (1, S260_ATTN[3] - 1, 0.0, 0, S260_ATTN),
                (PREFILL_CHUNK, PREFILL_CHUNK, 50.0, 256, (HEADS, KV_HEADS, 24, CTX)),
                *((PREFILL_CHUNK, PREFILL_CHUNK, 0.0, 0, (HEADS, KV_HEADS, hd, CTX))
                  for hd in (72, 104, 200, 248)))):
            add("flash_attention", check_attention(timer, "flash_attention", T, pos, seed + j,
                                                   cap, win, dims=dims, dtype=dtype))
    for i, scheme in enumerate(("q8_0", "q4_0", "q5_0")):
        seed = 640 + 4 * i
        add(*check_scheme_matmul(timer, scheme, "dequant", S15_CTX, 2 * S15_FFN, S15_DIM, seed))
        for m in (3 * S15_DIM, S15_VOCAB):
            add(*check_scheme_matmul(timer, scheme, "w4a8", 1, m, S15_DIM, seed + 1))
    add("qmm_w8", check_w8(timer, S15_CTX, 2 * S15_FFN, S15_DIM, 652,
                           scheme_weight("q4_0", 2 * S15_FFN, S15_DIM, 652, "cuda")))
    add(*check_f32_matmul(timer, "q8_0", "dequant", S15_CTX, 2 * S15_FFN, S15_DIM, 653))
    add(*check_f32_matmul(timer, "q8_0", "w4a8", 1, 3 * S15_DIM, S15_DIM, 654))
    return checks


def phase_kernels() -> dict[str, list[dict]]:
    import torch

    from crabml_tpu_torch.ops.cuda import gemm_quant
    from crabml_tpu_torch.quant.qtensor import FORM_KIND

    timer = Timer(torch)
    checks = {
        # the two 512-row chunks' shapes; the 189-row chunk that the main
        # path sends to qmm_q4k (245 padded rows < W8_MIN_ROWS); 1,024 rows
        "qmm_q4k": [check_matmul(timer, "qmm_q4k", PREFILL_CHUNK, QKV_M, DIM, 1),
                    check_matmul(timer, "qmm_q4k", PREFILL_CHUNK, DIM, FFN, 2),
                    check_matmul(timer, "qmm_q4k", RAGGED_CHUNK, QKV_M, DIM, 49),
                    check_matmul(timer, "qmm_q4k", 2 * PREFILL_CHUNK, QKV_M, DIM, 50)],
        "qmm_w4a8": [check_matmul(timer, "qmm_w4a8", rows, m, k, seed)
                     for rows, m, k, planes, seed in W4A8_SHAPES if not planes],
        # a first and a second 512-token chunk; the second with the softcap
        # and with a sliding window; the main path's ragged second chunk
        "flash_attention": [check_attention(timer, "flash_attention", PREFILL_CHUNK, 0, 7),
                            check_attention(timer, "flash_attention", PREFILL_CHUNK,
                                            PREFILL_CHUNK, 8),
                            check_attention(timer, "flash_attention", PREFILL_CHUNK,
                                            PREFILL_CHUNK, 9, softcap=50.0),
                            check_attention(timer, "flash_attention", PREFILL_CHUNK,
                                            PREFILL_CHUNK, 10, window=256),
                            check_attention(timer, "flash_attention", RAGGED_CHUNK,
                                            PREFILL_CHUNK, 11)],
    }
    # Qwen3-8B's lm_head, 151,936 rows (593.5 x 256: no W8 planes), at the ragged
    # chunk through the dequant kernel and at one decode row
    checks["qmm_q4k"].append(check_matmul(timer, "qmm_q4k", RAGGED_CHUNK, Q3_VOCAB, DIM, 190))
    checks["qmm_w4a8"].append(check_matmul(timer, "qmm_w4a8", 1, Q3_VOCAB, DIM, 191))
    checks.update(decode_checks(timer))
    for name, recs in g2_attention_checks(timer).items():  # head dim 256, after the 7B's
        checks[name] += recs
    for name, recs in q2_attention_checks(timer).items():  # G = 7, after those
        checks[name] += recs
    for name, recs in phi_attention_checks(timer).items():  # head dims 96 and 80, after those
        checks[name] += recs
    check_f32_flash_plan()
    check_ws_plan()
    check_ws_bits()
    for name, recs in f32_checks(timer).items():  # float32, after the bfloat16 forms' checks
        checks.setdefault(name, []).extend(recs)
    for name, recs in hd16_attention_checks(timer).items():  # head dim 16, after those
        checks[name] += recs
    for name, recs in spec_attention_checks(timer).items():  # past 16 rows, after those
        checks[name] += recs
    # the W8 planes at a 512-row chunk, and the Mixtral forms: the experts'
    # fused gate|up (4096 -> 2 x 14336) and down (14336 -> 4096)
    checks["qmm_w8"] = [check_w8(timer, PREFILL_CHUNK, QKV_M, DIM, 40),
                        check_w8(timer, PREFILL_CHUNK, DIM, FFN, 41),
                        check_w8(timer, RAGGED_CHUNK, QKV_M, DIM, 47),
                        check_w8(timer, 2 * PREFILL_CHUNK, QKV_M, DIM, 48)]
    for name in ("qmm_q4k_grouped", "qmm_w8_grouped"):
        checks[name] = [check_grouped(timer, name, 2 * FFN, DIM, 42),
                        check_grouped(timer, name, DIM, FFN, 43)]
        torch.cuda.empty_cache()
    # the bf16 grouped dequant form also on an empty and a one-row segment
    checks["qmm_q4k_grouped"].append(check_grouped(timer, "qmm_q4k_grouped", 2 * FFN, DIM, 42,
                                                   counts=EDGE_COUNTS))
    torch.cuda.empty_cache()
    # the float32 grouped forms at the same shapes: Q4_K's here, the other
    # schemes' beside their bfloat16 forms below, on the same stacks with
    # their scale planes in float32
    for m, k, seed in ((2 * FFN, DIM, 42), (DIM, FFN, 43)):
        qt = float32_scales(q4k_stack(MOE_EXPERTS, m, k, seed, False))
        checks.setdefault("qmm_q4k_grouped.f32", []).append(
            check_grouped(timer, "qmm_q4k_grouped", m, k, seed, qt, f32=True))
        if m == 2 * FFN:  # an empty and a one-row segment
            checks["qmm_q4k_grouped.f32"].append(check_grouped(
                timer, "qmm_q4k_grouped", m, k, seed, qt, f32=True, counts=EDGE_COUNTS))
        del qt
        torch.cuda.empty_cache()
    for rows, m, k, planes, seed in W4A8_SHAPES:
        if planes:
            name, rec = check_w4a8_planes(timer, rows, m, k, seed)
            checks.setdefault(name, []).append(rec)
    # the other schemes' experts' forms at the Mixtral shapes: the grouped
    # dequant form on the 1,024 pairs of a 512-token chunk, and the plane
    # form at 1 and 8 rows (the decode step and the 8-slot tick), on the
    # experts' gate|up and down stacks, 8 distinct random experts each
    for i, scheme in enumerate(KERNEL_SCHEMES):
        for m, k in ((2 * FFN, DIM), (DIM, FFN)):
            seed = 100 + 4 * i + (m == DIM)
            qt = scheme_stack(scheme, MOE_EXPERTS, m, k, seed)
            name = f"qmm_{_FORM[scheme]}_grouped"
            checks.setdefault(name, []).append(check_grouped(timer, name, m, k, seed, qt))
            if m == 2 * FFN:  # an empty and a one-row segment
                checks[name].append(check_grouped(timer, name, m, k, seed, qt,
                                                  counts=EDGE_COUNTS))
            checks.setdefault(f"{name}.f32", []).append(
                check_grouped(timer, name, m, k, seed, float32_scales(qt), f32=True))
            if m == 2 * FFN:
                checks[f"{name}.f32"].append(check_grouped(
                    timer, name, m, k, seed, float32_scales(qt), f32=True, counts=EDGE_COUNTS))
            for rows in (1, SERVING_SLOTS):
                name, rec = check_w4a8_planes(timer, rows, m, k, seed + rows, qt)
                checks.setdefault(name, []).append(rec)
            del qt
            torch.cuda.empty_cache()
    # the other schemes' forms: the dequant kernel at a 512-row chunk of qkv,
    # the ragged 189-row chunk and a 512-row chunk of down; the int8-activation
    # form at every 7B decode projection, at one row and at the 8-slot tick,
    # and the 16-row qkv tail
    for i, scheme in enumerate(KERNEL_SCHEMES):
        seed = 70 + 4 * i
        for rows, m, k in ((PREFILL_CHUNK, QKV_M, DIM), (RAGGED_CHUNK, QKV_M, DIM),
                           (PREFILL_CHUNK, DIM, FFN)) + WS_SHAPES.get(scheme, ()):
            name, rec = check_scheme_matmul(timer, scheme, "dequant", rows, m, k, seed)
            checks.setdefault(name, []).append(rec)
        # one weight a shape for both row counts
        decode = {(m, k): scheme_weight(scheme, m, k, seed + 2, "cuda")
                  for m, k in ((QKV_M, DIM), (DIM, DIM), (2 * FFN, DIM), (DIM, FFN), (VOCAB, DIM))}
        for rows in (1, SERVING_SLOTS):
            for (m, k), qt in decode.items():
                name, rec = check_scheme_matmul(timer, scheme, "w4a8", rows, m, k, seed + 2, qt)
                checks.setdefault(name, []).append(rec)
        del decode
        name, rec = check_scheme_matmul(timer, scheme, "w4a8", 2 * SERVING_SLOTS, QKV_M, DIM,
                                        seed + 3)
        checks[name].append(rec)
        torch.cuda.empty_cache()
    # the kinds that run the Q4_K, Q5_K and Q8_0 forms, on planes converted from
    # their own blocks: the dequant form at a 512-row chunk of qkv, the
    # int8-activation form at 1, 8 and 16 rows of it, the grouped form on the
    # 1,024 pairs of gate|up and the plane form at 1 and 8 rows on experts 1-7
    for i, scheme in enumerate(REUSED_SCHEMES):
        seed = 130 + 4 * i
        name, rec = check_scheme_matmul(timer, scheme, "dequant", PREFILL_CHUNK, QKV_M, DIM, seed)
        checks[name].append(rec)
        if scheme == "q5_1":  # csrc/qmm_ws.cuh's 96-row tiles on Q5_1 planes
            name, rec = check_scheme_matmul(timer, scheme, "dequant", RAGGED_CHUNK, QKV_M, DIM,
                                            seed)
            checks[name].append(rec)
        for rows in (1, SERVING_SLOTS, 2 * SERVING_SLOTS):
            name, rec = check_scheme_matmul(timer, scheme, "w4a8", rows, QKV_M, DIM, seed + 1)
            checks[name].append(rec)
        qt = scheme_stack(scheme, MOE_EXPERTS, 2 * FFN, DIM, seed + 2)
        name = gemm_quant.GROUPED_FORMS[FORM_KIND[qt.kind]]
        checks[name].append(check_grouped(timer, name, 2 * FFN, DIM, seed + 2, qt))
        for rows in (1, SERVING_SLOTS):
            name, rec = check_w4a8_planes(timer, rows, 2 * FFN, DIM, seed + 3, qt)
            checks[name].append(rec)
        del qt
        torch.cuda.empty_cache()
    # Phi-3-mini's lm_head, 32,064 rows (250.5 weight tiles of 128: the last
    # tile half empty; no W8 planes at 64 mod 256) in Q6_K, at the ragged
    # 189-row chunk through the dequant kernel and at one decode row
    for form, rows, seed in (("dequant", RAGGED_CHUNK, 240), ("w4a8", 1, 241)):
        name, rec = check_scheme_matmul(timer, "q6_k", form, rows, P3_VOCAB, P3_DIM, seed)
        checks[name].append(rec)
    torch.cuda.empty_cache()
    for name, recs in stories_checks(timer).items():  # the TinyStories forms, after all others
        checks.setdefault(name, []).extend(recs)
    checks.update(norm_checks(timer))
    torch.cuda.empty_cache()
    say(f"timer: the longest queueing of {timer.iters} timed calls {timer.max_queue_ms:.2f} ms "
        f"(the spin: {HOLD_CYCLES / SPIN_HZ * 1e3:.1f} ms or more); {timer.outlasted} timings "
        "queued for longer than the spin")
    del timer
    torch.cuda.empty_cache()
    return checks


# ---------------------------------------------------------------------------
# phase 3: the whole forward at full width, 2 layers, card against CPU
# ---------------------------------------------------------------------------

def phase_forward(tmp: Path, model: str = "7b", seed: int = 11, n_prompt: int = 16,
                  w8: bool = False, min_share: float = 1.0, scheme: str = "q4_k",
                  mix: str | None = None, path: str | None = None,
                  cpu_dtype=None, card_weights=None, f32_card: bool = False,
                  bf16_card: bool = True, layers: int = 2) -> dict:
    """`model` cut to `layers` layers (or the layers of the file at `path`),
    every matrix in `scheme` (with `mix` "k_m", llama.cpp's _K_M layout: the
    last layer's attn_v and ffn_down and the output in Q6_K): a prompt of
    `n_prompt` tokens and one decode step, the card
    (kernels, bfloat16, with the W8 prefill planes when `w8`) against the CPU
    (plain versions, float32 unless `cpu_dtype` says otherwise, the scheme's
    planes only). `path`: such a file written already (kept);
    `card_weights`: its weights loaded on the card already, bfloat16 without
    W8 planes (a Runner's with prefill_w8=False). `f32_card`: the card also
    runs the forward in float32 (float32 scale planes and cache, the float32
    forms), held to the CPU's float32 at F32_FORWARD_TOL (a float32 CPU run
    of its own where `cpu_dtype` is bfloat16), and the share of tokens of the
    card's bfloat16 run within 5e-2 of its float32 one is reported; the
    record's "launches" are that run's. `bf16_card` False: no bfloat16 card
    run (then `f32_card`)."""
    import numpy as np
    import torch

    from crabml_tpu_torch.gguf.reader import GGUFFile
    from crabml_tpu_torch.models.config import config_from_gguf
    from crabml_tpu_torch.models.forward import KVCache, forward
    from crabml_tpu_torch.models.weights import augment_w8_weights, load_weights
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    own = path is None
    if own:
        path = build_synth_gguf(str(tmp / f"synth-{model}-{scheme}-{mix}-{layers}layers.gguf"),
                                model, seed=seed, layers=layers, scheme=scheme, mix=mix)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    tokens = np.random.default_rng(seed + 1).integers(3, cfg.vocab_size, (1, n_prompt + 1))
    from crabml_tpu_torch.ops.cuda import _build

    runs = {}
    cpu_dtype = cpu_dtype or torch.float32
    sides = ([(CARD, torch.bfloat16)] * bf16_card + [("cpu", cpu_dtype)]
             + [("f32", torch.float32)] * f32_card
             + [("cpu32", torch.float32)] * (f32_card and cpu_dtype != torch.float32))
    f32_launches = {}
    ref32 = "cpu32" if cpu_dtype != torch.float32 else "cpu"  # the float32 CPU side
    routes, kept = {}, None  # the decode step's routing per side; the float32 CPU model
    for dev, dt in sides:
        on = {"f32": CARD, "cpu32": "cpu"}.get(dev, dev)
        w = card_weights if dev == CARD and card_weights is not None \
            else load_weights(gf, cfg, on, dt)
        if w8 and dev == CARD:
            w = augment_w8_weights(w)
        cache = KVCache.create(cfg, 1, 512, dt, on)
        before = dict(_build.launches)
        outs = []
        for toks, p in ((tokens[:, :n_prompt], 0), (tokens[:, n_prompt:], n_prompt)):
            with _routing() as routes[dev]:
                logits = forward(w, cache, torch.from_numpy(toks).to(on), torch.tensor([p]), cfg,
                                 dt)
            outs.append(logits.float().cpu())
        if dev == "f32":
            f32_launches = {k: n - before.get(k, 0) for k, n in _build.launches.items()
                            if n != before.get(k, 0)}
        runs[dev] = outs
        if f32_card and cfg.n_experts and dev == ref32:
            kept = (w, cache)
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
    # dense model). With a bfloat16 CPU side the two differ only in the order
    # of float32 sums: the kernels against their plain versions.
    tol = 5e-2
    against = "bfloat16 on both" if cpu_dtype == torch.bfloat16 else "bfloat16 against float32"
    rec = {"tolerance": f"max|card - cpu| <= {tol} * max|cpu| for {min_share:.0%} of the tokens "
                        f"({against}" + ("; W8 planes on the card only)" if w8 else ")")}
    ok = True
    for i, what in enumerate((f"prefill {n_prompt} tokens", "decode step") if bf16_card else ()):
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
        say(f"forward {model} widths, {scheme}{' ' + mix if mix else ''}, {cfg.n_layers} "
            f"layer(s), {what}: "
            f"rel err max {rel:.3e}, "
            f"median token "
            f"{median:.3e}, {share:.1%} of the tokens within ({rec['tolerance']}), finite "
            f"{finite} {'ok' if good else 'FAILED'}")
    if f32_card:
        # float32 on both sides: the same exact weights; the decode step's int8
        # activations come from activations that differ in the order of sums only
        f32 = rec["float32"] = {
            "tolerance": f"max|card - cpu| <= {F32_FORWARD_TOL['prefill']} (prefill), "
                         f"{F32_FORWARD_TOL['decode step']} (decode step) * max|cpu| (float32 on "
                         "both; the decode step's int8 codes may round otherwise at an edge)",
            "launches": f32_launches}
        for i, what in enumerate((f"prefill {n_prompt} tokens", "decode step")):
            card, cpu = runs["f32"][i], runs[ref32][i]
            rel = ((card - cpu).abs().max() / cpu.abs().max()).item()
            good = bool(torch.isfinite(card).all()) \
                and rel <= F32_FORWARD_TOL["decode step" if i else "prefill"]
            f32[what] = {"rel_err": rel, "ok": good}
            if i and kept is not None and not good:
                # a mixture of experts: the step taken with the card's experts where the
                # CPU's own routing lies within a near tie (_rerouted)
                f32[what]["rerouted"] = rr = _rerouted(kept, cfg, tokens[:, n_prompt:], n_prompt,
                                                       routes["f32"], routes[ref32], card)
                good = rr["ok"]
                f32[what]["ok"] = good
                say(f"forward {model} widths, {scheme}, float32 decode step: experts differ "
                    f"in {rr['layers']}; {rr['why']}")
            if bf16_card:  # how far bfloat16 itself moves this file's tokens, on the card
                per = (runs[CARD][i] - card).abs().amax(dim=-1).reshape(-1) / card.abs().max()
                f32[what]["card_bf16_share_within_5e-2"] = (per <= 5e-2).float().mean().item()
            ok &= good
            say(f"forward {model} widths, {scheme}{' ' + mix if mix else ''}, float32 on the "
                f"card against the CPU, {what}: rel err {rel:.3e} ({f32['tolerance']}) "
                f"{'ok' if good else 'FAILED'}"
                + (" (held with the card's experts, above)" if "rerouted" in f32[what] else "")
                + (f"; the card's bfloat16 run within 5e-2 of its float32 one on "
                   f"{f32[what]['card_bf16_share_within_5e-2']:.1%} of the tokens"
                   if bf16_card else ""))
        rec["launches"] = f32_launches
        say(f"forward {model} float32 launches: {f32_launches}")
    rec["ok"] = ok
    if own:
        os.remove(path)
    return rec


class _routing:
    """Records, as a list, each call of models.forward.moe_route in the
    block: (the experts it chose (R, K), its float32 router logits (R, E))."""

    def __enter__(self):
        from crabml_tpu_torch.models import forward as fmod

        self.orig, calls = fmod.moe_route, []

        def recorded(lw, h, cfg):
            topi, topw = self.orig(lw, h, cfg)
            calls.append((topi, (h @ lw["ffn_gate_inp"].t()).float()))
            return topi, topw

        fmod.moe_route = recorded
        return calls

    def __exit__(self, *exc):
        from crabml_tpu_torch.models import forward as fmod

        fmod.moe_route = self.orig


def _rerouted(kept, cfg, toks, pos: int, card_routes, cpu_routes, card) -> dict:
    """A mixture of experts' float32 decode step off the CPU's by more than
    F32_FORWARD_TOL: the step's int8 activation codes round otherwise at an
    edge on the two sides, which moves the next layer's router
    logits by up to ~1e-2, and where two experts' logits lie closer than
    that the card may route the token to the other one, a discrete step.
    Held to its cause: every layer whose experts differ must be such a near
    tie (the CPU's logit of each expert only the card chose lies within the
    two sides' largest router-logit difference of that layer below the
    CPU's logit of each expert only it chose), and the CPU's step taken with
    the card's experts in every layer (their weights from the CPU's own
    logits) must be within the tolerance."""
    import torch

    from crabml_tpu_torch.models import forward as fmod

    tol = F32_FORWARD_TOL["decode step"]
    layers, ties = [], True
    for l, ((ti_c, lg_c), (ti_p, lg_p)) in enumerate(zip(card_routes, cpu_routes)):
        c, p = set(ti_c[0].tolist()), set(ti_p[0].tolist())
        if c == p:
            continue
        diff = (lg_c.cpu() - lg_p).abs().max().item()
        row = lg_p[0]
        gap = min(row[e].item() for e in p - c) - max(row[e].item() for e in c - p)
        layers.append({"layer": l, "card": sorted(c), "cpu": sorted(p), "cpu_logit_gap": gap,
                       "router_logit_diff": diff})
        ties &= gap <= diff
    forced = iter([ti.cpu() for ti, _ in card_routes])

    def route(lw, h, cfg):
        topi = next(forced)
        logits = (h @ lw["ffn_gate_inp"].t()).float()
        return topi, torch.softmax(torch.gather(logits, 1, topi), dim=-1)

    w, cache = kept
    orig, fmod.moe_route = fmod.moe_route, route
    try:
        again = fmod.forward(w, cache, torch.from_numpy(toks), torch.tensor([pos]), cfg,
                             torch.float32).float()
    finally:
        fmod.moe_route = orig
    rel = ((card - again).abs().max() / again.abs().max()).item()
    ok = bool(layers) and ties and rel <= tol
    why = (f"each a near tie: {ties} ({[(d['cpu_logit_gap'], d['router_logit_diff']) for d in layers]}"
           f" as (the CPU's logit gap, the router logits' card-vs-CPU difference)); the CPU's "
           f"step with the card's experts: rel err {rel:.3e} (<= {tol}) {'ok' if ok else 'FAILED'}")
    return {"layers": layers, "near_ties": ties, "rel_err_card_experts": rel, "ok": ok,
            "why": why}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def _bytes_per_weight(kind) -> float:
    """A GGUF block's bytes over its weights (Q4_K 144 / 256)."""
    from crabml_tpu_torch.gguf.constants import GGML_BLOCK_SIZES

    n, nbytes = GGML_BLOCK_SIZES[kind]
    return nbytes / n


def _decode_bound(runner, pos: int) -> tuple[float, float]:
    """Least ms per decode token: the port's weight planes (decode reads no
    W8 plane), the embedding row and the live KV cache read once, over
    3.35 TB/s; and the same with the GGUF's own bytes (Q4_K: 144 per 256
    weights) for the matmuls. Every matrix of every layer counts, fused or
    not (a _K_M file keeps q, k and v apart where attn_v is Q6_K). Of a
    layer's experts a token reads the K it was routed to: K/E of the stacks'
    bytes, and the whole router. A layer with a sliding window reads the
    last `window` keys of the cache (gemma2's even layers), every other
    layer all `pos`."""
    from crabml_tpu_torch.models.forward import layer_window
    from crabml_tpu_torch.quant.qtensor import QTensor

    w = runner.weights
    cfg = runner.cfg
    used = cfg.n_experts_used / max(cfg.n_experts, 1)
    share = {n: used for n in ("wgu_exps", "ffn_gate_exps", "ffn_up_exps", "ffn_down_exps")}
    mats = [(w["output"], 1.0)] + [
        (q, share.get(n, 1.0)) for lw in w["layers"] for n, q in lw.items()
        if isinstance(q, QTensor)]
    port = sum(f * _plane_bytes(q, [n for n in q.planes if n not in ("w8", "dw")])
               for q, f in mats)
    port += sum(lw["ffn_gate_inp"].numel() * 2 for lw in w["layers"] if "ffn_gate_inp" in lw)
    gguf = sum(f * math.prod(q.shape) * _bytes_per_weight(q.kind) for q, f in mats)
    keys = sum(min(pos, layer_window(cfg, l) or pos) for l in range(cfg.n_layers))
    kv = 2 * keys * cfg.n_kv_heads * cfg.head_dim * runner.cache.k.element_size()
    row = cfg.embedding_dim * _bytes_per_weight(w["token_embed"].kind)
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


def _prefill_w8_against_q4k(path: str, runner, prompt: str, what: str, plain=None) -> dict:
    """The same file loaded once more with prefill_w8=False (or `plain`, such
    a Runner already loaded): its prefill against the W8 runner's, in turns
    inside this one run (W8, dequant, dequant, W8), and the kernels the
    dequant-only prefill launched (the scheme's dequant kernel: qmm_q4k for a
    Q4_K file)."""
    import torch

    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.runtime.runner import Runner

    plain = plain or Runner(path, prefill_w8=False)
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
    ratio = statistics.mean(rates["w8"]) / statistics.mean(rates["q4k"])
    wins = "w8" if ratio >= 1.0 else "q4k"
    say(f"{what} prefill, W8 planes against the dequant kernel only (tok/s, in turns): W8 "
        f"{rates['w8'][0]:.1f} and {rates['w8'][1]:.1f}, dequant {rates['q4k'][0]:.1f} and "
        f"{rates['q4k'][1]:.1f}: the {'W8 planes win' if wins == 'w8' else 'dequant route wins'}"
        f" ({ratio:.3f}x of dequant only); matmul launches of one W8 and one dequant prefill "
        f"{launches}")
    del plain
    torch.cuda.empty_cache()
    return {"prefill_tok_s": rates, "w8_over_q4k": ratio, "wins": wins, "launches": launches_q4k}


def _eager_decode(runner, first: int, steps: int) -> list[int]:
    """The decode step run eagerly, as the port ran it before the graph:
    models.forward.decode_step and the Runner's sampler once a token, the
    token read back to the host after each. Tokens after `first`."""
    import torch

    from crabml_tpu_torch.models.forward import decode_step

    tok = torch.tensor([[first]], device=CARD)
    out = []
    for _ in range(steps):
        pos = torch.tensor([runner.pos], dtype=torch.int32, device=CARD)
        logits = decode_step(runner.weights, runner.cache, tok, pos, runner.cfg,
                             runner.compute_dtype)
        tok = runner.sampler.sample(logits, runner.generator)[:, None]
        out.append(int(tok[0, 0]))
        runner.pos += 1
    return out


def _one_run(runner, prompt: str, launches, mode=1, steps: int = DECODE_STEPS) -> dict:
    """Prefill `prompt` and decode `steps` - 1 tokens: `mode` the tick of
    Runner.generate (the captured graph, replayed) or "eager"
    (_eager_decode)."""
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
    if mode == "eager":
        tokens = [first] + _eager_decode(runner, first, steps - 1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        n_decoded, text = steps - 1, None
    else:
        pieces = list(runner.generate(first, steps=steps, tick=mode))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tokens, n_decoded, text = list(runner.generated), runner.metrics.counts["tokens"], \
            "".join(pieces)
    n_prompt = runner.metrics.counts["prefill_tokens"]
    return {
        "mode": f"tick {mode}" if mode != "eager" else "eager",
        "prompt_tokens": n_prompt, "generated": len(tokens), "decoded_steps": n_decoded,
        "text": text, "tokens": tokens,
        "prefill_s": t1 - t0, "decode_s": t2 - t1,
        "prefill_tok_s": n_prompt / (t1 - t0), "decode_tok_s": n_decoded / (t2 - t1),
        "decode_ms_per_token": (t2 - t1) / n_decoded * 1e3,
        "launches_prefill": {k: v - before.get(k, 0) for k, v in after_prefill.items()},
        "launches_decode": {k: launches[k] - after_prefill.get(k, 0) for k in launches},
        "end_pos": runner.pos,
    }


def _profile_decode(runner, prompt: str, ms_per_token: float, mode=1) -> dict:
    """Device time per decode token from a torch.profiler window of
    PROFILE_STEPS tokens (`mode` as in _one_run): kernel time by name,
    launches per token, and the idle share of the card against the
    unprofiled ms per token. Kernels replayed from a CUDA graph count like
    launched ones."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    w4a8_calls = _w4a8_calls(runner)
    runner.reset()
    _, _, first = runner.prefill(prompt)
    runner.metrics.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if mode == "eager":
            _eager_decode(runner, first, PROFILE_STEPS)
        else:
            for _ in runner.generate(first, steps=PROFILE_STEPS + 1, tick=mode):
                pass
        torch.cuda.synchronize()
    steps = PROFILE_STEPS
    by_name: dict[str, float] = {}
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            n += 1
    what = "eager" if mode == "eager" else f"graphed, tick {mode}"
    if not by_name:
        say(f"decode profile ({what}): the profiler saw no device time (not measured)")
        return {"measured": False, "mode": what}
    device = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    busy = sum(by_name.values()) / steps
    span = (max(e.time_range.end for e in device) - device[0].time_range.start) / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    calls = {k: sum(1 for e in device if e.name == k) for k, _ in top}
    rec = {
        "measured": True, "mode": what, "steps": steps, "device_ms_per_token": busy,
        "device_launches_per_token": n / steps, "wall_ms_per_token": ms_per_token,
        "idle_share": 1.0 - busy / ms_per_token,
        # first kernel's start to last kernel's end: busy + the gaps between kernels
        "device_span_ms_per_token": span,
        "top_kernels_ms_per_token": {k[:80]: v / steps for k, v in top},
        "top_kernels_calls_per_token": {k[:80]: c / steps for k, c in calls.items()},
        "qmm_w4a8_us_by_shape": _w4a8_by_shape(device, w4a8_calls),
    }
    say(f"decode profile ({what}, {steps} tokens): device busy {busy:.3f} ms/token of "
        f"{ms_per_token:.3f} ms/token unprofiled (idle share {rec['idle_share']:.3f}), span of "
        f"the device's work {span:.3f} ms/token, {rec['device_launches_per_token']:.0f} device "
        f"launches/token")
    for k, v in rec["top_kernels_ms_per_token"].items():
        say(f"  {v:.4f} ms/token in {rec['top_kernels_calls_per_token'][k]:.0f} calls  {k}")
    if rec["qmm_w4a8_us_by_shape"]:
        say("  qmm_w4a8 inside the step, mean µs a call: " + ", ".join(
            f"{k} {v:.2f}" for k, v in rec["qmm_w4a8_us_by_shape"].items()))
    return rec


def _w4a8_calls(runner) -> list[str]:
    """The int8-activation matmuls of one decode step in launch order, each
    as "<form> <rows>x<m>x<k>" ("<form>.planes <rows>x<m>x<k>" for the plane
    form of a mixture of experts): qmm_w4a8 wrapped, where the dense matmuls
    (gemm_quant) and the experts (models.forward) call it, around one eager
    step at the runner's position (the captured graph replays the same
    launches in the same order). Its kernels count among the launches like
    any eager step's."""
    import torch

    from crabml_tpu_torch.models import forward as fwd
    from crabml_tpu_torch.ops.cuda import gemm_quant
    from crabml_tpu_torch.quant.qtensor import FORM_KIND

    calls = []
    wrapped = gemm_quant.qmm_w4a8

    def logged(x2, qt, out_dtype=torch.float32, plane=None):
        form = gemm_quant.W4A8_FORMS[FORM_KIND[qt.kind]] + ("" if plane is None else ".planes")
        calls.append(f"{form} {x2.shape[0]}x{qt.m}x{qt.k}")
        return wrapped(x2, qt, out_dtype, plane)

    gemm_quant.qmm_w4a8 = fwd.qmm_w4a8 = logged
    try:
        pos = torch.tensor([runner.pos], dtype=torch.int32, device=CARD)
        fwd.decode_step(runner.weights, runner.cache,
                        torch.ones((1, 1), dtype=torch.long, device=CARD), pos, runner.cfg,
                        runner.compute_dtype)
    finally:
        gemm_quant.qmm_w4a8 = fwd.qmm_w4a8 = wrapped
    return calls


def _w4a8_by_shape(device_events, calls: list[str]) -> dict:
    """Mean µs of the int8-activation matmul kernel a call, by form and
    shape (a key of `calls`, one step's calls in launch order), and of its
    quantizer, in a decode step. The window's matmul kernels are
    its steps' calls in turn, but the window may cut calls at either end: of
    the alignments that leave the cut calls at the ends, the one is taken
    under which each key's calls share one kernel and their times spread
    least, and a cut call is missing from its key's mean ("calls_cut" says
    how many). A mixture of experts' plane calls are keyed apart from the
    dense ones ("<form>.planes ...")."""
    if not calls:
        return {}
    mm = [e for e in device_events if "::qmm_w4a8_kernel<" in e.name]
    quant = [e for e in device_events if "::quantize_kernel<" in e.name]
    cut = -len(mm) % len(calls)
    best = None
    for start in range(cut + 1):  # calls cut before the window's first kernel
        by_key: dict[str, list] = {}
        for i, e in enumerate(mm):
            by_key.setdefault(calls[(i + start) % len(calls)], []).append(e)
        if any(len({e.name for e in v}) > 1 for v in by_key.values()):
            continue
        us = {k: [e.time_range.elapsed_us() for e in v] for k, v in by_key.items()}
        spread = sum((t / statistics.mean(v) - 1) ** 2 for v in us.values() for t in v)
        if best is None or spread < best[0]:
            best = (spread, us)
    if best is None:
        return {}
    rec = {k: statistics.mean(v) for k, v in best[1].items()}
    if quant:
        rec["quantizer"] = statistics.mean(e.time_range.elapsed_us() for e in quant)
    rec["calls_cut"] = cut
    return rec


class DenseMatmuls:
    """Around a path's runs: every product that took torch.matmul on a
    dequantized weight (ops/matmul.py::dense_matmul: a matrix's, or an
    expert stack's through models/forward.py's moe_ffn_plain) instead of a
    kernel, as "<kind> <shape>"; `calls` must stay empty where every matrix
    is quantized."""

    def __enter__(self):
        from crabml_tpu_torch.ops import matmul as mm

        self.calls, self.orig = [], mm.dense_matmul

        def counted(x, qt):
            self.calls.append(f"{qt.kind.name} {tuple(qt.shape)}")
            return self.orig(x, qt)

        mm.dense_matmul = counted
        return self

    def __exit__(self, *exc):
        from crabml_tpu_torch.ops import matmul as mm

        mm.dense_matmul = self.orig


def _graph_against_eager(runner, prompt: str, graphed: dict, what: str) -> dict:
    """The graphed decode against the eager step in turns (eager, tick 1,
    tick 8, tick 8, tick 1, eager): the greedy tokens must be the same in
    every run (the same kernels, a deterministic merge); wall ms/token of
    each, and a profile of each mode."""
    import torch

    from crabml_tpu_torch.ops.cuda import _build

    runs = {"eager": [], 1: [], 8: []}
    for mode in ("eager", 1, 8, 8, 1, "eager"):
        r = _one_run(runner, prompt, _build.launches, mode)
        if r["tokens"] != graphed["tokens"]:
            fail(f"{what}: the {r['mode']} decode gave other tokens than the graphed run")
        runs[mode].append(r["decode_ms_per_token"])
    rec = {"wall_ms_per_token": {str(k): v for k, v in runs.items()}, "tokens_identical": True}
    rec["profiles"] = {str(m): _profile_decode(runner, prompt, statistics.mean(runs[m]), m)
                       for m in ("eager", 1, 8)}
    say(f"{what} decode, in turns (ms/token): eager {runs['eager'][0]:.3f} / "
        f"{runs['eager'][1]:.3f}, graphed tick 1 {runs[1][0]:.3f} / {runs[1][1]:.3f}, tick 8 "
        f"{runs[8][0]:.3f} / {runs[8][1]:.3f}; greedy tokens identical in all six runs")
    torch.cuda.synchronize()
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
    first = _one_run(runner, prompt, _build.launches)  # captures the decode step's graph
    launches = dict(_build.launches)
    second = _one_run(runner, prompt, _build.launches)  # replays the cached graph
    if first["tokens"] != second["tokens"]:
        fail("the two greedy runs gave different tokens")
    turns = _graph_against_eager(runner, prompt, first, "7B")
    profile = turns["profiles"]["1"]
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
        "launches": launches, "decode_profile": profile, "graph_against_eager": turns,
        # from the second run: the first also ran the step once eagerly to warm it up
        "launches_per_decode_token": {k: v / second["decoded_steps"]
                                      for k, v in second["launches_decode"].items()},
        "launches_per_prefill_chunk": {k: v / chunks
                                       for k, v in first["launches_prefill"].items()},
    }
    for i, r in enumerate((first, second)):
        say(f"main path run {i + 1} (graphed, tick 1): prompt {r['prompt_tokens']} tokens in "
            f"{chunks} chunks, prefill {r['prefill_tok_s']:.1f} tok/s "
            f"({r['prefill_s'] * 1e3:.1f} ms); "
            f"decode {r['decoded_steps']} steps "
            f"{r['decode_tok_s']:.2f} tok/s = {r['decode_ms_per_token']:.3f} ms/token "
            f"(bound {bound_port:.3f} ms port layout, {bound_gguf:.3f} ms GGUF bytes)")
    say(f"main path: load {load_s:.2f} s ({w8_s:.2f} s of it the W8 planes), max_memory_allocated "
        f"{rec['max_memory_allocated'] / 2**30:.2f} GiB, 128 greedy tokens identical in both "
        f"runs, launches {launches}")
    per_token = rec["launches_per_decode_token"]
    device = (f"{profile['device_launches_per_token']:.0f} device launches (profile)"
              if profile["measured"] else "device launches not measured")
    say(f"launches per 7B decode token: {device}; wrapper launches "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(per_token.items()) if v))
    return rec, runner, path


# ---------------------------------------------------------------------------
# phase 4: one paged decode tick at full width, 1 layer, card against CPU
# ---------------------------------------------------------------------------

def phase_serving_forward(tmp: Path, model: str = "7b", seed: int = 13,
                          lengths=(1, 17, 77, 128, 130, 200, 256, 300),  # ragged, two on a page boundary
                          kvs=("compute", "int8"), w8: bool = False) -> dict:
    """`model` cut to SERVING_FORWARD_LAYERS layers: one paged decode tick
    over 8 slots prefilled to `lengths`, the card against the CPU as in
    phase_forward."""
    import numpy as np
    import torch

    from crabml_tpu_torch.gguf.reader import GGUFFile
    from crabml_tpu_torch.models.config import config_from_gguf
    from crabml_tpu_torch.models.weights import augment_w8_weights, load_weights
    from crabml_tpu_torch.ops.cuda.paged_decode_attention import PAGE
    from crabml_tpu_torch.serving.paged import (PagedKVCache, paged_decode_step,
                                                paged_prefill_chunk)
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    path = build_synth_gguf(str(tmp / f"synth-{model}-paged.gguf"), model, seed=seed,
                            layers=SERVING_FORWARD_LAYERS)
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
                                    torch.tensor(lengths, dtype=torch.int32, device=dev), cfg, dt)
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
        say(f"paged decode tick, {model} widths, {SERVING_FORWARD_LAYERS} layer(s), 8 slots at "
            f"{lengths}, "
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
    _profile_decode), against the unprofiled time of as many ticks, one
    step(1) a tick; and the time a tick when step(8) replays eight of them
    before it reads the tokens."""
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
    steps_before = engine.steps
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS // 8):
        engine.step(8)  # 8 replays of the tick, then one read
    torch.cuda.synchronize()
    ms_per_tick_8 = (time.perf_counter() - t0) / (engine.steps - steps_before) * 1e3
    if engine.steps - steps_before != PROFILE_STEPS:
        fail(f"step(8) ran {engine.steps - steps_before} ticks in {PROFILE_STEPS // 8} steps")
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
    rec = {"ms_per_tick": ms_per_tick, "ms_per_tick_at_step_8": ms_per_tick_8,
           "slots": engine.n_slots, "positions": positions,
           "tok_s_at_8_slots": engine.n_slots / ms_per_tick * 1e3}
    if not by_name:
        say("serving profile: the profiler saw no device time (not measured)")
        return {**rec, "measured": False}
    busy = sum(by_name.values()) / PROFILE_STEPS
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    rec.update(measured=True, device_ms_per_tick=busy, device_launches_per_tick=n / PROFILE_STEPS,
               idle_share=1.0 - busy / ms_per_tick,
               top_kernels_ms_per_tick={k[:80]: v / PROFILE_STEPS for k, v in top})
    say(f"serving profile ({PROFILE_STEPS} graphed ticks, 8 slots at positions {positions}): "
        f"{ms_per_tick:.3f} ms/tick unprofiled = {rec['tok_s_at_8_slots']:.1f} tok/s "
        f"({ms_per_tick_8:.3f} ms/tick at step(8)), device busy "
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
            "daemon": daemon, "tokens": tokens}


def _hold_to_tie(weights, cfg, dtype, kv_dtype, prompt: list[int], plain: list[int],
                 spec: list[int], i: int, copies: int) -> dict:
    """Hold the first token i where a speculative run left plain greedy
    decode to its cause, a near tie: the cache of `copies` copies of the
    sequence (so that the verify's rows take the run's matmul route) is
    prefilled with the prompt and plain[:i-1] in PREFILL_CHUNK chunks (the
    tokens the run decoded one a step are taken as a prompt, whose matmul
    route may differ: the hold's state is the run's to within that); then
    the plain step's logits for token i and the
    verify's (plain[i-1] and the speculative run's next K tokens as drafts)
    at the same position are taken. It is a near tie when the step's logits
    of the two tokens lie within the largest difference between the
    verify's logits and the step's of each other: the verify may order
    them otherwise. (On the paged drain the verify's 40 rows take the
    dequant matmul in bfloat16 where the tick's 8 take int8 activations;
    their logits differ by up to ~0.2 at 7B on an H100.)"""
    import torch

    from crabml_tpu_torch.models.forward import KVCache, decode_step, forward, verify_step

    K = SPEC_K
    ctx = list(prompt) + plain[: i - 1]
    cache = KVCache.create(cfg, copies, len(ctx) + K + 1, kv_dtype, CARD)
    toks = torch.tensor([ctx] * copies, device=CARD)
    for c in range(0, len(ctx), PREFILL_CHUNK):
        forward(weights, cache, toks[:, c:c + PREFILL_CHUNK], torch.full((copies,), c), cfg, dtype)
    pos = torch.full((copies,), len(ctx), dtype=torch.int32, device=CARD)
    cur = plain[i - 1]
    step = decode_step(weights, cache, torch.full((copies, 1), cur, device=CARD), pos, cfg,
                       dtype)[0].float()
    drafts = (spec[i:i + K] + [0] * K)[:K]
    seq = torch.tensor([[cur] + drafts] * copies, device=CARD)
    verify = verify_step(weights, cache, seq, pos, cfg, dtype)[0, 0].float()
    diff = (verify - step).abs().max().item()
    gap = abs(step[plain[i]] - step[spec[i]]).item()
    return {"index": i, "plain": plain[i], "speculative": spec[i],
            "step_argmax": int(step.argmax()), "verify_argmax": int(verify.argmax()),
            "step_logit_gap": gap, "verify_vs_step_max_diff": diff, "ok": gap <= diff}


def _held(what: str, weights, cfg, dtype, kv_dtype, prompt, plain, spec, copies: int) -> dict:
    """None when the speculative tokens are the plain ones; else the first
    difference held to a near tie (_hold_to_tie), reported, and failed when
    it is not one. Tokens after it follow another history and are not
    compared."""
    i = next((j for j, (a, b) in enumerate(zip(plain, spec)) if a != b), None)
    if i is None and len(spec) >= len(plain):
        return None
    if i is None or i == 0:
        fail(f"{what}: {len(spec)} speculative tokens against {len(plain)} plain ones, "
             f"first difference at {i}")
    hold = _hold_to_tie(weights, cfg, dtype, kv_dtype, prompt, plain, spec, i, copies)
    say(f"{what}: token {i} differs from plain greedy decode ({hold['speculative']} for "
        f"{hold['plain']}): their step logits {hold['step_logit_gap']:.4f} apart, the verify's "
        f"logits within {hold['verify_vs_step_max_diff']:.4f} of the step's (argmax step "
        f"{hold['step_argmax']}, verify {hold['verify_argmax']}): "
        f"{'a near tie' if hold['ok'] else 'NOT a near tie'}")
    if not hold["ok"]:
        fail(f"{what}: token {i} differs from plain greedy decode and is not a near tie: {hold}")
    return hold


def _spec_stats(r: dict, counts: dict) -> dict:
    """ms per emitted token, tokens per round and the share of drafts
    accepted, from a speculative run's record and its Runner's counters."""
    rounds, toks = counts.get("spec_rounds", 0), counts.get("spec_tokens", 0)
    return {"decode_ms_per_token": r["decode_ms_per_token"], "rounds": rounds,
            "tokens_per_round": toks / rounds if rounds else 0.0,
            "acceptance": (toks - rounds) / (SPEC_K * rounds) if rounds else 0.0,
            "decoded_steps": r["decoded_steps"]}


def phase_speculative(tmp: Path, runner, gguf: str, serving: dict) -> dict:
    """Speculative decoding on the 7B file of phase 5, K = SPEC_K: the plain
    graphed Runner's ~700-token prompt and 128 greedy tokens (the baseline),
    then `Runner(path, speculative=4)` (prompt lookup), `Runner(path,
    draft_model=<the 7B widths at 2 layers, another seed>)` and the target
    as its own draft (every draft accepted), each against the plain tokens;
    the decode kernels, not flash, carry each verify (T = 5 at G = 4). Then
    the 16 requests of phase 6 through an 8-slot PagedServingEngine with
    speculative=4, the greedy ones against phase 6's tokens, and the dense
    ServingEngine with speculative=4 on the prompt and a short request at
    step(1) (a verify a step) and step(8) (eight rounds a step), against
    the Runner's tokens. A token that differs from plain greedy decode is
    held to a near tie (_held) and reported."""
    import torch

    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.runtime.runner import Runner
    from crabml_tpu_torch.serving import PagedServingEngine, Request, ServingEngine
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    prompt = PROMPT_SENTENCE * PROMPT_REPEATS
    prompt_ids = runner.tokenizer.encode(prompt, bos=True)
    args = (runner.weights, runner.cfg, runner.compute_dtype, runner.kv_dtype, prompt_ids)
    _build.launches.clear()  # counts from here on are the speculative path's
    plain = _one_run(runner, prompt, _build.launches)  # the cached graph, tick 1
    want = plain["tokens"]
    draft = build_synth_gguf(str(tmp / "synth-7b-draft.gguf"), "7b", seed=3,
                             layers=SPEC_DRAFT_LAYERS)
    rec = {"k": SPEC_K, "draft_layers": SPEC_DRAFT_LAYERS,
           "plain": {"decode_ms_per_token": plain["decode_ms_per_token"],
                     "decoded_steps": plain["decoded_steps"]}}
    for what, kw, steps in (("lookup", dict(speculative=SPEC_K), DECODE_STEPS),
                            ("draft", dict(draft_model=draft), SPEC_DRAFT_STEPS),
                            ("oracle", dict(draft_model=gguf), SPEC_DRAFT_STEPS)):
        spec = Runner(gguf, **kw)
        if spec.speculative != SPEC_K:
            fail(f"speculative {what}: K = {spec.speculative}")
        r = _one_run(spec, prompt, _build.launches, steps=steps)
        stats = _spec_stats(r, spec.metrics.counts)
        stats["held"] = _held(f"speculative {what}", *args, want[:steps], r["tokens"], 1)
        dec = r["launches_decode"]
        stats["launches_decode"] = dec
        if dec.get("decode_attention", 0) <= 0 or dec.get("flash_attention", 0):
            fail(f"speculative {what}: the verifies launched {dec}: the decode kernel must "
                 "carry them, not flash")
        if stats["rounds"] <= 0:
            fail(f"speculative {what}: no speculative round ran")
        say(f"speculative {what} (K={SPEC_K}): {stats['decoded_steps']} tokens, "
            f"{stats['decode_ms_per_token']:.3f} ms/token (plain graphed "
            f"{plain['decode_ms_per_token']:.3f}), {stats['rounds']} rounds, "
            f"{stats['tokens_per_round']:.2f} tokens a round, drafts accepted "
            f"{stats['acceptance']:.1%}, tokens {'= plain greedy' if not stats['held'] else 'held'}")
        rec[what] = stats
        del spec
        torch.cuda.empty_cache()
    if rec["oracle"]["acceptance"] < 0.9:
        fail(f"speculative oracle: the target as its own draft accepted "
             f"{rec['oracle']['acceptance']:.1%} of its drafts")
    os.remove(draft)

    # the paged engine on phase 6's requests; the greedy ones against its tokens
    eng = PagedServingEngine(runner, n_slots=SERVING_SLOTS, n_pages=SERVING_PAGES, seq_len=CTX,
                             seed=7, speculative=SPEC_K)
    reqs = _serving_requests(runner, seed=21)
    _build.launches.clear()
    paged = _drain(eng, reqs)
    paged["launches"] = dict(_build.launches)
    paged.update(spec_ticks=eng.spec_ticks, spec_tokens=eng.spec_tokens)
    _say_run(f"speculative serving (K={SPEC_K}), 7B, 8 slots, 256-page pool", paged)
    held = []
    for r, plain_toks in zip(reqs, serving["tokens"]):
        if r.temperature == 0.0:
            h = _held(f"speculative paged request {r.request_id}", *args[:4], r.prompt_tokens,
                      plain_toks, list(r.output_tokens), SERVING_SLOTS)
            held += [h] if h else []
    paged["held"] = held
    if eng.spec_ticks <= 0 or paged["launches"].get("paged_decode_attention", 0) <= 0:
        fail(f"speculative paged serving: {eng.spec_ticks} verify steps, launches "
             f"{paged['launches']}")
    say(f"speculative paged serving: {eng.spec_ticks} verify steps gave {eng.spec_tokens} "
        f"greedy tokens; greedy requests = plain but {len(held)} held to near ties")
    rec["paged"] = paged
    del eng

    # the dense engine: a verify a step, then eight rounds a step
    short = _serving_requests(runner, seed=21)[0].prompt_tokens
    for multi in (1, 8):
        eng = ServingEngine(runner, n_slots=2, seq_len=runner.seq_len,
                            prefill_chunk=PREFILL_CHUNK, seed=7, speculative=SPEC_K)
        same = Request(prompt=prompt, max_tokens=DENSE_ENGINE_TOKENS)
        other = Request(prompt="", prompt_tokens=short, max_tokens=DENSE_ENGINE_TOKENS)
        _build.launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for q in (same, other):
            eng.submit(q)
        while any(eng.slots) or not eng.pending.empty():
            eng.step(multi)
        torch.cuda.synchronize()
        dense = {"wall_s": time.perf_counter() - t0, "launches": dict(_build.launches),
                 "spec_ticks": eng.spec_ticks, "spec_tokens": eng.spec_tokens}
        dense["held"] = _held(f"speculative dense engine step({multi})", *args, want[:32],
                              list(same.output_tokens), 2)
        if eng.spec_ticks <= 0 or dense["launches"].get("decode_attention", 0) <= 0:
            fail(f"speculative dense engine step({multi}): {eng.spec_ticks} rounds, launches "
                 f"{dense['launches']}")
        say(f"speculative dense engine step({multi}): {eng.spec_ticks} rounds, "
            f"{eng.spec_tokens} greedy tokens in {dense['wall_s']:.2f} s, the prompt's tokens "
            f"{'= the Runner' if not dense['held'] else 'held'}")
        rec[f"dense_step{multi}"] = dense
        del eng
    torch.cuda.empty_cache()
    rec["launches"] = rec["paged"]["launches"]
    return rec


def phase_dense_int8(tmp: Path) -> dict:
    """Phase 7: the dense engine with an int8 cache and the paged engine with
    an int8 pool, at DENSE_LAYERS layers of the 7B width."""
    import numpy as np
    import torch

    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.runtime.runner import Runner
    from crabml_tpu_torch.serving import PagedServingEngine, Request, ServingEngine
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    path = build_synth_gguf(str(tmp / f"synth-7b-{DENSE_LAYERS}layers.gguf"), "7b", seed=5,
                            layers=DENSE_LAYERS)
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
    experts, 2 per token, vocab 32000, rope theta 1e6) in llama.cpp's Q4_K_M
    layout for 8 experts (`mixtral-q4_k_m`: Q4_K q and gate|up experts, Q8_0
    k and v, Q5_K attn_output, the down experts in Q6_K where use_more_bits
    holds, layers 0, 3, 6 and 7 of 8, Q4_K elsewhere, a Q6_K output), the
    depth cut to MOE_LAYERS of 32 and the context to 4096: `Runner(path)`
    with its default prefill_w8, which must come out on, a ~700-token prompt
    and 128 greedy tokens twice; the same file with prefill_w8=False,
    prefill only (the grouped Q4_K and Q6_K forms); and a drain of 16
    requests through an 8-slot PagedServingEngine, twice."""
    import torch

    from crabml_tpu_torch.gguf.constants import GGMLType
    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.runtime.runner import Runner
    from crabml_tpu_torch.serving import PagedServingEngine
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf, mix_kind

    t0 = time.perf_counter()
    path = build_synth_gguf(str(tmp / "synth-mixtral-q4_k_m.gguf"), "mixtral-8x7b", seed=3,
                            layers=MOE_LAYERS, scheme="q4_k", mix="k_m")
    synth_s = time.perf_counter() - t0
    say(f"synthetic Mixtral-8x7B Q4_K_M GGUF (llama.cpp's 8-expert layout), {MOE_LAYERS} of 32 "
        f"layers, context 4096: {os.path.getsize(path) / 1e9:.3f} GB in {synth_s:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    runner = Runner(path)
    cfg = runner.cfg
    if (cfg.n_experts, cfg.n_experts_used, cfg.embedding_dim, cfg.hidden_dim) != (8, 2, DIM, FFN):
        fail(f"not the Mixtral-8x7B widths: {cfg}")
    if not runner.prefill_w8:
        fail("the Mixtral Runner's default left the W8 prefill planes off")
    layers = runner.weights["layers"]
    down = [lw["ffn_down_exps"].kind for lw in layers]
    want = [GGMLType[mix_kind("ffn_down", i, MOE_LAYERS, "q4_k", "k_m", HEADS // KV_HEADS,
                              MOE_EXPERTS).upper()] for i in range(MOE_LAYERS)]
    kinds = {n: q.kind.name for n, q in layers[0].items() if hasattr(q, "planes")}
    if down != want or kinds != {"wq": "Q4_K", "wk": "Q8_0", "wv": "Q8_0", "wo": "Q5_K",
                                 "wgu_exps": "Q4_K", "ffn_down_exps": down[0].name}:
        fail(f"mixtral-q4_k_m: layer 0 holds {kinds}, the down experts {down}")
    mats = [q for lw in layers for q in lw.values() if hasattr(q, "planes")]
    if not all("w8" in q.planes for q in mats) or "w8" not in runner.weights["output"].planes:
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
    eager = _one_run(runner, prompt, _build.launches, "eager")
    if eager["tokens"] != first["tokens"]:
        fail("MoE: the eager decode gave other tokens than the graphed runs")
    if len(first["tokens"]) != DECODE_STEPS:
        fail(f"MoE: generated {len(first['tokens'])} tokens, expected {DECODE_STEPS} (EOS?)")
    n = first["end_pos"]
    if not bool(torch.isfinite(runner.cache.k[:, :, :, :n]).all()
                and torch.isfinite(runner.cache.v[:, :, :, :n]).all()):
        fail("MoE: NaN or inf in the KV cache")
    for name in ("qmm_w8", "qmm_w8_grouped", "qmm_w4a8", "qmm_w4a8.planes", "qmm_w4a8_q6k.planes",
                 "qmm_w4a8_q8_0", "qmm_w4a8_q5k", "qmm_q4k", "flash_attention",
                 "decode_attention_fused"):
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the MoE path")
    profile = _profile_decode(runner, prompt, second["decode_ms_per_token"])
    bound_port, bound_gguf = _decode_bound(runner, n)
    chunks = math.ceil(n_prompt / PREFILL_CHUNK)
    peak = torch.cuda.max_memory_allocated()
    for i, r in enumerate((first, second, eager)):
        say(f"MoE path run {i + 1} ({'graphed, tick 1' if i < 2 else 'eager'}): prompt "
            f"{r['prompt_tokens']} tokens in {chunks} chunks, prefill "
            f"{r['prefill_tok_s']:.1f} tok/s ({r['prefill_s'] * 1e3:.1f} ms); decode "
            f"{r['decoded_steps']} steps {r['decode_tok_s']:.2f} tok/s = "
            f"{r['decode_ms_per_token']:.3f} ms/token (bound {bound_port:.3f} ms port layout, "
            f"{bound_gguf:.3f} ms GGUF bytes, the experts counted at 2 of 8)")
    say(f"MoE path: load {load_s:.2f} s ({w8_s:.2f} s of it the W8 planes), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB, 128 greedy tokens identical in the "
        f"two graphed runs and the eager one, launches {launches}")

    w8_q4k = _prefill_w8_against_q4k(path, runner, prompt, f"Mixtral ({MOE_LAYERS} layers)")
    if w8_q4k["launches"].get("qmm_q4k_grouped", 0) <= 0 \
            or w8_q4k["launches"].get("qmm_q6k_grouped", 0) <= 0 \
            or w8_q4k["launches"].get("qmm_w8", 0) or w8_q4k["launches"].get("qmm_w8_grouped", 0):
        fail(f"the dequant-only MoE prefill launched {w8_q4k['launches']}")

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
    for name in ("qmm_w4a8", "qmm_w4a8.planes", "qmm_w4a8_q6k.planes", "qmm_w8_grouped",
                 "paged_decode_attention_fused"):
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
        "file": "mixtral-q4_k_m", "down_expert_kinds": [k.name for k in down],
        "layers": MOE_LAYERS, "synth_s": synth_s, "load_s": load_s, "load_w8_augment_s": w8_s,
        "prompt_tokens": n_prompt, "prefill_chunks": chunks,
        "runs": [{k: v for k, v in r.items() if k not in ("text", "tokens")}
                 for r in (first, second, eager)],
        "tokens_identical": True, "first_tokens": first["tokens"][:16],
        "decode_bound_ms_port_layout": bound_port, "decode_bound_ms_gguf_bytes": bound_gguf,
        "max_memory_allocated": peak, "launches": launches, "decode_profile": profile,
        "launches_per_decode_token": {k: v / second["decoded_steps"]
                                      for k, v in second["launches_decode"].items()},
        "launches_per_prefill_chunk": {k: v / chunks
                                       for k, v in first["launches_prefill"].items()},
        "prefill_w8_against_q4k": w8_q4k, "serving": serving,
    }


def phase_moe_scheme(tmp: Path, what: str, scheme: str, mix: str | None, seed: int) -> dict:
    """Mixtral-8x7B widths cut to MOE_SCHEME_LAYERS of 32 layers, every
    matrix in `scheme` (with a `mix`, llama.cpp's 8-expert layout over it):
    the card-against-CPU forward on the file (phase 3, both sides bfloat16;
    the card without W8 planes, so its prefill takes the grouped dequant
    forms and its decode step the plane forms; and the card in float32
    against the CPU in float32, the float32 forms); `Runner(path)` with the W8 planes (its default,
    or asked for under the default's 1 GiB floor), the ~700-token prompt and
    MOE_SCHEME_STEPS greedy tokens through the graph (the capture, then the
    cached graph) and the eager step, all identical; the same file with
    prefill_w8=False, prefill only, in turns (the grouped dequant forms of
    the file's expert kinds, and no W8 kernel)."""
    import torch

    from crabml_tpu_torch.gguf.reader import GGUFFile
    from crabml_tpu_torch.ops.cuda import _build, gemm_quant
    from crabml_tpu_torch.quant.qtensor import FORM_KIND
    from crabml_tpu_torch.runtime.runner import Runner
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    t0 = time.perf_counter()
    path = build_synth_gguf(str(tmp / f"synth-{what}.gguf"), "mixtral-8x7b", seed=seed,
                            layers=MOE_SCHEME_LAYERS, scheme=scheme, mix=mix)
    synth_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    experts = sorted({ti.typ for ti in GGUFFile(path).tensor_infos if len(ti.shape) == 3},
                     key=lambda k: k.name)
    say(f"synthetic Mixtral-8x7B {scheme}{' ' + mix + ' mix' if mix else ''} GGUF, "
        f"{MOE_SCHEME_LAYERS} of 32 layers: {size / 1e9:.3f} GB in {synth_s:.2f} s, experts in "
        f"{[k.name for k in experts]}")
    # against the plain versions in bfloat16: on these files bfloat16 itself
    # moves 28-31% of the prompt's tokens more than 5e-2 off float32, on the
    # CPU as on the card (measured on an H100: the plain versions in bfloat16
    # against float32 on the Q8_0 and Q5_K_M files), where the kernels meet
    # the plain bfloat16 run on 98-100% of them
    plain = Runner(path, prefill_w8=False)  # the card side here, the dequant prefill below
    fwd = phase_forward(tmp, "mixtral-8x7b", seed=seed, n_prompt=MOE_SCHEME_PROMPT, min_share=0.9,
                        scheme=scheme, mix=mix, path=path, cpu_dtype=torch.bfloat16,
                        card_weights=plain.weights, f32_card=True)
    w8_default = size >= 1 << 30
    runner = Runner(path) if w8_default else Runner(path, prefill_w8=True)
    mats = [q for lw in runner.weights["layers"] for q in lw.values() if hasattr(q, "planes")]
    if not runner.prefill_w8 or not all("w8" in q.planes for q in mats):
        fail(f"{what}: the Runner left the W8 prefill planes off")
    kinds = sorted({q.kind.name for q in mats} | {runner.weights["output"].kind.name})
    prompt = PROMPT_SENTENCE * PROMPT_REPEATS
    _build.launches.clear()  # counts from here on are this path's
    with DenseMatmuls() as dense:
        capture = _one_run(runner, prompt, _build.launches, 1, MOE_SCHEME_STEPS)
        launches = dict(_build.launches)
        graphed = _one_run(runner, prompt, _build.launches, 1, MOE_SCHEME_STEPS)
        eager = _one_run(runner, prompt, _build.launches, "eager", MOE_SCHEME_STEPS)
    if dense.calls:
        fail(f"{what}: {len(dense.calls)} matmuls took torch.matmul on dequantized weights: "
             f"{sorted(set(dense.calls))}")
    if not capture["tokens"] == graphed["tokens"] == eager["tokens"]:
        fail(f"{what}: the graphed decode gave other tokens than the eager step")
    if len(graphed["tokens"]) != MOE_SCHEME_STEPS:
        fail(f"{what}: generated {len(graphed['tokens'])} tokens, expected {MOE_SCHEME_STEPS}")
    planes = [gemm_quant.W4A8_FORMS[FORM_KIND[k]] + ".planes" for k in experts]
    for name in planes + ["qmm_w8_grouped", "qmm_w8", "flash_attention",
                          "decode_attention_fused"]:
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the {what} path")
    n = graphed["end_pos"]
    bound_port, bound_gguf = _decode_bound(runner, n)
    for r, how in ((capture, "graphed, the run that captures"), (graphed, "graphed"),
                   (eager, "eager")):
        say(f"{what} path ({how}): prompt {r['prompt_tokens']} tokens, prefill "
            f"{r['prefill_tok_s']:.1f} tok/s; decode {r['decoded_steps']} steps "
            f"{r['decode_tok_s']:.2f} tok/s = {r['decode_ms_per_token']:.3f} ms/token (bound "
            f"{bound_port:.3f} ms port layout, {bound_gguf:.3f} ms GGUF bytes)")
    say(f"{what} path: matrices in {kinds}, {MOE_SCHEME_STEPS} greedy tokens of both graphed "
        f"runs equal to the eager step's, no matmul through torch.matmul, launches {launches}")
    profile = (_profile_decode(runner, prompt, graphed["decode_ms_per_token"])
               if what in MOE_PROFILED else None)
    w8_dequant = _prefill_w8_against_q4k(path, runner, prompt, what, plain)
    grouped = [gemm_quant.GROUPED_FORMS[FORM_KIND[k]] for k in experts]
    if any(w8_dequant["launches"].get(g, 0) <= 0 for g in grouped) \
            or w8_dequant["launches"].get("qmm_w8", 0) \
            or w8_dequant["launches"].get("qmm_w8_grouped", 0):
        fail(f"{what}: the dequant-only prefill launched {w8_dequant['launches']}")
    chunks = math.ceil(capture["prompt_tokens"] / PREFILL_CHUNK)
    del runner, plain
    os.remove(path)
    torch.cuda.empty_cache()
    return {
        "scheme": scheme, "mix": mix, "layers": MOE_SCHEME_LAYERS, "gguf_bytes": size,
        "expert_kinds": [k.name for k in experts], "kinds": kinds, "synth_s": synth_s,
        "forward": fwd, "dense_matmuls": len(dense.calls), "decode_profile": profile,
        "w8": "the Runner's default" if w8_default else "prefill_w8=True (under 1 GiB)",
        "runs": [{k: v for k, v in r.items() if k not in ("text", "tokens")}
                 for r in (capture, graphed, eager)],
        "graph_equals_eager": True, "first_tokens": graphed["tokens"][:16],
        "decode_bound_ms_port_layout": bound_port, "decode_bound_ms_gguf_bytes": bound_gguf,
        "launches": launches,
        "launches_per_decode_token": {k: v / graphed["decoded_steps"]
                                      for k, v in graphed["launches_decode"].items()},
        "launches_per_prefill_chunk": {k: v / chunks
                                       for k, v in graphed["launches_prefill"].items()},
        "prefill_w8_against_dequant": w8_dequant,
    }


# ---------------------------------------------------------------------------
# phase 10: the other schemes' paths (Q8_0, Q6_K, Q5_K_M, Q4_0)
# ---------------------------------------------------------------------------

def phase_scheme(tmp: Path, what: str, scheme: str, layers: int, seed: int,
                 mix: str | None = None) -> dict:
    """The 7B widths with every matrix in `scheme` (with a `mix`, one of
    llama.cpp's mixed layouts over it, tools/synth_gguf.py), `layers` of 32:
    `Runner(path)` with its default prefill_w8, which must come out on (a
    file under the default's 1 GiB floor asks for the planes), the ~700-token
    prompt and 128 greedy tokens through the graph, equal to the eager
    step's; the same file with prefill_w8=False, prefill only, in turns; and
    the 16 requests through an 8-slot PagedServingEngine."""
    import torch

    from crabml_tpu_torch.gguf.constants import GGMLType
    from crabml_tpu_torch.gguf.reader import GGUFFile
    from crabml_tpu_torch.ops.cuda import _build, gemm_quant
    from crabml_tpu_torch.quant.qtensor import FORM_KIND
    from crabml_tpu_torch.runtime.runner import Runner
    from crabml_tpu_torch.serving import PagedServingEngine
    from crabml_tpu_torch.tools.synth_gguf import SCHEMES, build_synth_gguf

    kind = SCHEMES[scheme][0]
    t0 = time.perf_counter()
    path = build_synth_gguf(str(tmp / f"synth-{what}.gguf"), "7b", seed=seed, layers=layers,
                            scheme=scheme, mix=mix)
    synth_s = time.perf_counter() - t0
    # the kinds of the path's matmuls: the file's 2-D tensors but the embedding
    kinds = {ti.typ for ti in GGUFFile(path).tensor_infos
             if len(ti.shape) == 2 and ti.name != "token_embd.weight"}
    size = os.path.getsize(path)
    say(f"synthetic 7B {kind.name}{' ' + mix + ' mix' if mix else ''} GGUF, {layers} of 32 "
        f"layers: {size / 1e9:.3f} GB in {synth_s:.2f} s, matrices in "
        f"{sorted(k.name for k in kinds)}")
    torch.cuda.reset_peak_memory_stats()
    # the Runner's default attaches the W8 planes to files of 1 GiB and more
    # (runtime/runner.py::_auto_w8_budget); a smaller file asks for them
    w8_default = size >= 1 << 30
    runner = Runner(path) if w8_default else Runner(path, prefill_w8=True)
    mats = [q for lw in runner.weights["layers"] for q in lw.values() if hasattr(q, "planes")]
    mats.append(runner.weights["output"])
    if {q.kind for q in mats} != kinds or not all(q.kernel_layout for q in mats):
        fail(f"{what}: the matrices are not {sorted(k.name for k in kinds)} kernel planes")
    if not runner.prefill_w8 or not all("w8" in q.planes for q in mats):
        fail(f"{what}: the Runner left the W8 prefill planes off "
             f"({'by default' if w8_default else 'with prefill_w8=True'})")
    unfused = sum("wqkv" not in lw for lw in runner.weights["layers"])
    load_s = runner.metrics.times_ns["load"] / 1e9
    w8_s = runner.metrics.times_ns.get("load.w8_augment", 0) / 1e9
    prompt = PROMPT_SENTENCE * PROMPT_REPEATS
    n_prompt = len(runner.tokenizer.encode(prompt, bos=True))

    _build.launches.clear()  # counts from here on are this path's
    with DenseMatmuls() as dense:
        capture = _one_run(runner, prompt, _build.launches)  # captures the decode step's graph
        launches = dict(_build.launches)
        graphed = _one_run(runner, prompt, _build.launches)  # replays the cached graph
        eager = _one_run(runner, prompt, _build.launches, "eager")
    if dense.calls:
        fail(f"{what}: {len(dense.calls)} matmuls took torch.matmul on dequantized weights: "
             f"{sorted(set(dense.calls))}")
    if not capture["tokens"] == graphed["tokens"] == eager["tokens"]:
        fail(f"{what}: the graphed decode gave other tokens than the eager step")
    if len(graphed["tokens"]) != DECODE_STEPS:
        fail(f"{what}: generated {len(graphed['tokens'])} tokens, expected {DECODE_STEPS} (EOS?)")
    n = graphed["end_pos"]
    if not bool(torch.isfinite(runner.cache.k[:, :, :, :n]).all()
                and torch.isfinite(runner.cache.v[:, :, :, :n]).all()):
        fail(f"{what}: NaN or inf in the KV cache")
    dequant = gemm_quant.DEQUANT_FORMS[FORM_KIND[kind]]
    for name in ([gemm_quant.DEQUANT_FORMS[FORM_KIND[k]] for k in kinds]
                 + [gemm_quant.W4A8_FORMS[FORM_KIND[k]] for k in kinds]
                 + ["qmm_w8", "flash_attention", "decode_attention_fused"]):
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the {what} path")
    if all(FORM_KIND[k] != GGMLType.Q4_K for k in kinds) \
            and (launches.get("qmm_q4k", 0) or launches.get("qmm_w4a8", 0)):
        fail(f"{what}: a Q4_K form was launched, and no matrix runs it: {launches}")
    bound_port, bound_gguf = _decode_bound(runner, n)
    chunks = math.ceil(n_prompt / PREFILL_CHUNK)
    profile = _profile_decode(runner, prompt, graphed["decode_ms_per_token"])
    for r, how in ((capture, "graphed, the run that captures"), (graphed, "graphed"),
                   (eager, "eager")):
        say(f"{what} path ({how}): prompt {r['prompt_tokens']} tokens in {chunks} "
            f"chunks, prefill {r['prefill_tok_s']:.1f} tok/s ({r['prefill_s'] * 1e3:.1f} ms); "
            f"decode {r['decoded_steps']} steps {r['decode_tok_s']:.2f} tok/s = "
            f"{r['decode_ms_per_token']:.3f} ms/token (bound {bound_port:.3f} ms port layout, "
            f"{bound_gguf:.3f} ms GGUF bytes)")
    say(f"{what} path: load {load_s:.2f} s ({w8_s:.2f} s of it the W8 planes), {unfused} "
        f"layers with q, k, v apart, 128 greedy tokens of both graphed runs equal to the eager "
        f"step's, no matmul through torch.matmul, launches {launches}")
    w8_dequant = _prefill_w8_against_q4k(path, runner, prompt, what)
    if w8_dequant["launches"].get(dequant, 0) <= 0 or w8_dequant["launches"].get("qmm_w8", 0):
        fail(f"{what}: the dequant-only prefill launched {w8_dequant['launches']}")

    eng = PagedServingEngine(runner, n_slots=SERVING_SLOTS, n_pages=SERVING_PAGES, seq_len=CTX,
                             seed=7)
    pages_at_start = eng.pages_free()
    reqs = _serving_requests(runner, seed=25)
    _build.launches.clear()
    serving = _drain(eng, reqs)
    serving["launches"] = dict(_build.launches)
    serving["launches_per_tick"] = {k: v / eng.steps for k, v in serving["launches"].items()}
    _say_run(f"serving, {what}, {layers} layers, 8 slots, 256-page bfloat16 pool", serving)
    if eng.pages_free() != pages_at_start or any(eng._owned):
        fail(f"{what} serving: pages_free {eng.pages_free()} after the run, "
             f"{pages_at_start} before")
    for name in (gemm_quant.W4A8_FORMS[FORM_KIND[kind]], "paged_decode_attention_fused"):
        if serving["launches"].get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the {what} serving path")
    peak = torch.cuda.max_memory_allocated()
    del eng, runner
    os.remove(path)
    torch.cuda.empty_cache()
    return {
        "scheme": scheme, "mix": mix, "layers": layers, "unfused_qkv_layers": unfused,
        "kinds": sorted(k.name for k in kinds), "gguf_bytes": size,
        "w8": "the Runner's default" if w8_default else "prefill_w8=True (under 1 GiB)",
        "synth_s": synth_s, "load_s": load_s,
        "load_w8_augment_s": w8_s, "prompt_tokens": n_prompt, "prefill_chunks": chunks,
        "runs": [{k: v for k, v in r.items() if k not in ("text", "tokens")}
                 for r in (capture, graphed, eager)],
        "graph_equals_eager": True, "first_tokens": graphed["tokens"][:16],
        "decode_profile": profile,
        "decode_bound_ms_port_layout": bound_port, "decode_bound_ms_gguf_bytes": bound_gguf,
        "max_memory_allocated": peak, "launches": launches, "dense_matmuls": len(dense.calls),
        "launches_per_decode_token": {k: v / graphed["decoded_steps"]
                                      for k, v in graphed["launches_decode"].items()},
        "launches_per_prefill_chunk": {k: v / chunks
                                       for k, v in graphed["launches_prefill"].items()},
        "prefill_w8_against_dequant": w8_dequant, "serving": serving,
    }


# ---------------------------------------------------------------------------
# phase 11: gemma2 at the widths of Gemma-2-9B
# ---------------------------------------------------------------------------

def _g2_prompt(tokenizer) -> str:
    """A prompt of exactly G2_PROMPT_TOKENS tokens, BOS included: the story
    sentence repeated, cut to the longest prefix of at most that many tokens,
    then padded with single-byte tokens (the synthetic vocab spells text in
    bytes)."""
    def n(text):
        return len(tokenizer.encode(text, bos=True))

    text = PROMPT_SENTENCE * (G2_PROMPT_TOKENS // 8)
    lo, hi = 0, len(text)  # the longest prefix of <= G2_PROMPT_TOKENS tokens
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if n(text[:mid]) <= G2_PROMPT_TOKENS else (lo, mid - 1)
    text = text[:lo].rstrip()
    while n(text) < G2_PROMPT_TOKENS:
        text += "a"
    if n(text) != G2_PROMPT_TOKENS:
        fail(f"gemma2 prompt: {n(text)} tokens, wanted {G2_PROMPT_TOKENS}")
    return text


def _g2_check(runner, graphed: dict):
    """gemma2-9b's config, and a prompt that crossed the window."""
    cfg = runner.cfg
    got = (cfg.architecture, cfg.head_dim, cfg.n_heads * cfg.head_dim, cfg.embedding_dim,
           cfg.sliding_window, cfg.alternating_window, cfg.attn_logit_softcap,
           cfg.final_logit_softcap, cfg.attn_scale)
    if got != ("gemma2", G2_HD, G2_HEADS * G2_HD, G2_DIM, G2_WINDOW, True, G2_SOFTCAP, 30.0,
               1.0 / 16):
        fail(f"gemma2-9b: config {got}")
    if graphed["prompt_tokens"] != G2_PROMPT_TOKENS or graphed["end_pos"] <= G2_WINDOW:
        fail(f"gemma2-9b: prompt {graphed['prompt_tokens']} tokens, end {graphed['end_pos']}: "
             "the window not crossed")


def _q2_check(runner, graphed: dict):
    """qwen2-7b's config (7 q heads a kv head, the biases loaded), and a
    prompt of two chunks, each through flash at G = 7."""
    cfg = runner.cfg
    got = (cfg.architecture, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.embedding_dim,
           cfg.rope_base, all(lw["bqkv"].shape == ((Q2_HEADS + 2 * Q2_KV) * HEAD_DIM,)
                              for lw in runner.weights["layers"]))
    if got != ("qwen2", Q2_HEADS, Q2_KV, HEAD_DIM, Q2_DIM, 1e6, True):
        fail(f"qwen2-7b: config {got}")
    if not PREFILL_CHUNK < graphed["prompt_tokens"] <= 2 * PREFILL_CHUNK:
        fail(f"qwen2-7b: prompt of {graphed['prompt_tokens']} tokens is not two prefill chunks")


def _p3_check(runner, graphed: dict):
    """phi3-mini's config (32 / 32 heads of head dim 96, the file's fused
    q|k|v and gate|up kept whole, q|k|v in Q5_K), and a prompt of two
    chunks, each through flash at head dim 96."""
    cfg = runner.cfg
    lw = runner.weights["layers"][0]
    got = (cfg.architecture, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.embedding_dim,
           cfg.vocab_size, "wgu" in lw and "wq" not in lw, lw["wqkv"].kind.name)
    if got != ("phi3", P3_HEADS, P3_HEADS, P3_HD, P3_DIM, P3_VOCAB, True, "Q5_K"):
        fail(f"phi3-mini: config {got}")
    if not PREFILL_CHUNK < graphed["prompt_tokens"] <= 2 * PREFILL_CHUNK:
        fail(f"phi3-mini: prompt of {graphed['prompt_tokens']} tokens is not two prefill chunks")


def _p2_check(runner, graphed: dict):
    """phi2's config (32 heads of head dim 80, the rotary over 32, LayerNorm,
    the parallel residual, a gateless FFN, every bias loaded), and a prompt
    of two chunks through flash at head dim 80."""
    cfg = runner.cfg
    w = runner.weights
    biases = ("bqkv", "bo", "ffn_up_b", "ffn_down_b", "attn_norm_b")
    got = (cfg.architecture, cfg.n_heads, cfg.head_dim, cfg.effective_rope_dim,
           cfg.embedding_dim, cfg.full_layer_norm, cfg.parallel_residual, cfg.no_ffn_gate,
           all(all(n in lw for n in biases) for lw in w["layers"]),
           "output_b" in w and "final_norm_b" in w, tuple(w["rope_inv_freq"].shape))
    if got != ("phi2", P2_HEADS, P2_HD, P2_ROPE, P2_DIM, True, True, True, True, True,
               (P2_ROPE // 2,)):
        fail(f"phi2: config {got}")
    if not PREFILL_CHUNK < graphed["prompt_tokens"] <= 2 * PREFILL_CHUNK:
        fail(f"phi2: prompt of {graphed['prompt_tokens']} tokens is not two prefill chunks")


def phase_family(tmp: Path, what: str, layers: int, seed: int, prompt_of, check,
                 kernels: tuple[str, ...], serving_seed: int) -> dict:
    """The synthetic `what` (tools/synth_gguf.py's shape of that name) in
    llama.cpp's Q4_K_M layout (attn_v and ffn_down Q6_K where use_more_bits
    holds, a Q6_K output or tied embedding), `layers` of its depth:
    `Runner(path)` with its default W8 planes (asked for under its 1 GiB
    floor), the prompt
    `prompt_of(tokenizer)` and 128 greedy tokens graphed at tick 1 (the
    capture, then the cached graph), at tick 8 and eagerly, all the same; a
    profiled window of the graphed step; the prefill with and without W8
    planes in turns; the 16 requests through an 8-slot
    PagedServingEngine (pages returned, a prefix hit; the requests drawn from
    `serving_seed`); and the dense ServingEngine, prefilling in 512-token
    chunks, on the prompt and a short request, whose greedy tokens are the
    Runner's. `check(runner, the graphed run)` holds the model's
    config and prompt; `kernels` must each be launched by the runs. No
    matmul may take torch.matmul."""
    import torch

    from crabml_tpu_torch.gguf.reader import GGUFFile
    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.runtime.runner import Runner
    from crabml_tpu_torch.serving import PagedServingEngine, Request, ServingEngine
    from crabml_tpu_torch.tools.synth_gguf import MODEL_SHAPES, build_synth_gguf

    t0 = time.perf_counter()
    path = build_synth_gguf(str(tmp / f"synth-{what}.gguf"), what, seed=seed, layers=layers,
                            scheme="q4_k", mix="k_m")
    synth_s = time.perf_counter() - t0
    kinds = sorted({ti.typ.name for ti in GGUFFile(path).tensor_infos if len(ti.shape) == 2})
    size = os.path.getsize(path)
    say(f"synthetic {what} Q4_K_M GGUF, {layers} of {MODEL_SHAPES[what][2]} layers: "
        f"{size / 1e9:.3f} GB in {synth_s:.2f} s, matrices in {kinds}")
    torch.cuda.reset_peak_memory_stats()
    # the defaults: cuda, bfloat16, the model's context; a file under the
    # default's 1 GiB floor for the W8 planes (phi2 and phi3-mini at 4 layers) asks for them
    w8_default = size >= 1 << 30
    runner = Runner(path) if w8_default else Runner(path, prefill_w8=True)
    if not runner.prefill_w8:
        fail(f"{what}: the Runner's default left the W8 prefill planes off")
    load_s = runner.metrics.times_ns["load"] / 1e9
    w8_s = runner.metrics.times_ns.get("load.w8_augment", 0) / 1e9
    prompt = prompt_of(runner.tokenizer)

    _build.launches.clear()  # counts from here on are this path's
    with DenseMatmuls() as dense:
        capture = _one_run(runner, prompt, _build.launches)  # captures the decode step's graph
        launches = dict(_build.launches)
        graphed = _one_run(runner, prompt, _build.launches)  # replays the cached graph
        tick8 = _one_run(runner, prompt, _build.launches, 8)
        eager = _one_run(runner, prompt, _build.launches, "eager")
    if dense.calls:
        fail(f"{what}: {len(dense.calls)} matmuls took torch.matmul on dequantized weights: "
             f"{sorted(set(dense.calls))}")
    if not capture["tokens"] == graphed["tokens"] == tick8["tokens"] == eager["tokens"]:
        fail(f"{what}: the graphed decode (tick 1, tick 8) and the eager step gave other tokens")
    if len(graphed["tokens"]) != DECODE_STEPS:
        fail(f"{what}: generated {len(graphed['tokens'])} tokens, expected {DECODE_STEPS} (EOS?)")
    check(runner, graphed)
    n = graphed["end_pos"]
    if not bool(torch.isfinite(runner.cache.k[:, :, :, :n]).all()
                and torch.isfinite(runner.cache.v[:, :, :, :n]).all()):
        fail(f"{what}: NaN or inf in the KV cache")
    for name in kernels:
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the {what} path")
    bound_port, bound_gguf = _decode_bound(runner, n)
    profile = _profile_decode(runner, prompt, graphed["decode_ms_per_token"])
    chunks = math.ceil(graphed["prompt_tokens"] / PREFILL_CHUNK)
    for r, how in ((capture, "graphed, the run that captures"), (graphed, "graphed"),
                   (tick8, "graphed, tick 8"), (eager, "eager")):
        say(f"{what} path ({how}): prompt {r['prompt_tokens']} tokens in {chunks} chunks, "
            f"prefill {r['prefill_tok_s']:.1f} tok/s ({r['prefill_s'] * 1e3:.1f} ms); decode "
            f"{r['decoded_steps']} steps to pos {r['end_pos']} {r['decode_tok_s']:.2f} tok/s = "
            f"{r['decode_ms_per_token']:.3f} ms/token (bound {bound_port:.3f} ms port layout, "
            f"{bound_gguf:.3f} ms GGUF bytes, the live KV included)")
    say(f"{what} path: load {load_s:.2f} s ({w8_s:.2f} s of it the W8 planes), 128 greedy "
        f"tokens of the graphed runs at tick 1 and 8 equal to the eager step's, no matmul "
        f"through torch.matmul, launches {launches}")
    w8_dequant = _prefill_w8_against_q4k(path, runner, prompt, what)
    if w8_dequant["launches"].get("qmm_q4k", 0) <= 0 or w8_dequant["launches"].get("qmm_q6k", 0) \
            <= 0 or w8_dequant["launches"].get("qmm_w8", 0):
        fail(f"{what}: the dequant-only prefill launched {w8_dequant['launches']}")

    eng = PagedServingEngine(runner, n_slots=SERVING_SLOTS, n_pages=SERVING_PAGES, seq_len=CTX,
                             seed=7)
    pages_at_start = eng.pages_free()
    reqs = _serving_requests(runner, seed=serving_seed)
    _build.launches.clear()
    with DenseMatmuls() as dense_serving:
        serving = _drain(eng, reqs)
    serving["launches"] = dict(_build.launches)
    serving["launches_per_tick"] = {k: v / eng.steps for k, v in serving["launches"].items()}
    _say_run(f"serving, {what}, {layers} layers, 8 slots, 256-page bfloat16 pool", serving)
    if eng.pages_free() != pages_at_start or any(eng._owned):
        fail(f"{what} serving: pages_free {eng.pages_free()} after the run, "
             f"{pages_at_start} before")
    if eng.prefix_hits < 1 or dense_serving.calls:
        fail(f"{what} serving: {eng.prefix_hits} prefix hits, {len(dense_serving.calls)} "
             "matmuls through torch.matmul")
    for name in ("paged_decode_attention_fused", "paged_decode_attention", "flash_attention",
                 "qmm_w4a8"):
        if serving["launches"].get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the {what} serving path")
    serving.update(prefix_hits=eng.prefix_hits, prefix_tokens_reused=eng.prefix_tokens_reused)
    del eng

    # the dense engine on the same runner, prefilling in the Runner's chunks:
    # the Runner's prompt beside a short one gives the Runner's greedy tokens
    dense_eng = ServingEngine(runner, n_slots=2, seq_len=runner.seq_len,
                              prefill_chunk=PREFILL_CHUNK, seed=7)
    same = Request(prompt=prompt, max_tokens=DENSE_ENGINE_TOKENS)
    short = Request(prompt="", max_tokens=DENSE_ENGINE_TOKENS,
                    prompt_tokens=_serving_requests(runner, seed=serving_seed)[0].prompt_tokens)
    _build.launches.clear()
    with DenseMatmuls() as dense_engine_mm:
        dense_serving = _drain(dense_eng, [same, short])
    dense_serving["launches"] = dict(_build.launches)
    _say_run(f"dense serving, {what}, {layers} layers, 2 slots", dense_serving)
    if same.output_tokens != graphed["tokens"][:DENSE_ENGINE_TOKENS] or dense_engine_mm.calls:
        fail(f"{what} dense serving: {same.output_tokens[:8]}... against the Runner's "
             f"{graphed['tokens'][:8]}..., {len(dense_engine_mm.calls)} matmuls through "
             "torch.matmul")
    for name in ("decode_attention_fused", "flash_attention", "qmm_w4a8"):
        if dense_serving["launches"].get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the {what} dense serving path")
    dense_serving["tokens_equal_runner"] = True
    peak = torch.cuda.max_memory_allocated()
    del dense_eng, runner
    os.remove(path)
    torch.cuda.empty_cache()
    return {
        "layers": layers, "kinds": kinds, "gguf_bytes": size, "synth_s": synth_s,
        "w8": "the Runner's default" if w8_default else "prefill_w8=True (under 1 GiB)",
        "load_s": load_s, "load_w8_augment_s": w8_s, "prompt_tokens": graphed["prompt_tokens"],
        "prefill_chunks": chunks, "end_pos": n,
        "runs": [{k: v for k, v in r.items() if k not in ("text", "tokens")}
                 for r in (capture, graphed, tick8, eager)],
        "graph_equals_eager": True, "first_tokens": graphed["tokens"][:16],
        "decode_profile": profile,
        "decode_bound_ms_port_layout": bound_port, "decode_bound_ms_gguf_bytes": bound_gguf,
        "max_memory_allocated": peak, "launches": launches, "dense_matmuls": len(dense.calls),
        "launches_per_decode_token": {k: v / graphed["decoded_steps"]
                                      for k, v in graphed["launches_decode"].items()},
        "launches_per_prefill_chunk": {k: v / chunks
                                       for k, v in graphed["launches_prefill"].items()},
        "prefill_w8_against_dequant": w8_dequant, "serving": serving,
        "dense_serving": dense_serving,
    }


def phase_graphed_forward(tmp: Path, model: str, seed: int) -> dict:
    """`model` at 2 layers: phase_forward (card against CPU), then
    `Runner(path)` on the card, FAMILY_STEPS greedy tokens of the prompt
    through the captured step, equal to the eager step's (llama31-8b: the
    captured step reads the rope divisors from the device)."""
    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.runtime.runner import Runner
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    path = build_synth_gguf(str(tmp / f"synth-{model}-2layers.gguf"), model, seed=seed, layers=2)
    rec = {"forward": phase_forward(tmp, model, seed=seed, path=path)}
    runner = Runner(path)
    prompt = PROMPT_SENTENCE * PROMPT_REPEATS
    _build.launches.clear()  # counts from here on are this path's
    graphed = _one_run(runner, prompt, _build.launches, steps=FAMILY_STEPS)
    launches = dict(_build.launches)
    eager = _one_run(runner, prompt, _build.launches, "eager", steps=FAMILY_STEPS)
    if graphed["tokens"] != eager["tokens"] or len(graphed["tokens"]) != FAMILY_STEPS:
        fail(f"{model}: the graphed decode gave other tokens than the eager step")
    for name in ("flash_attention", "decode_attention_fused", "qmm_w4a8", "qmm_q4k"):
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the {model} path")
    say(f"{model}, 2 layers: {FAMILY_STEPS} greedy tokens through the captured step equal to "
        f"the eager step's; graphed {graphed['decode_ms_per_token']:.3f} ms/token, eager "
        f"{eager['decode_ms_per_token']:.3f}; launches {launches}")
    del runner
    os.remove(path)
    rec.update(launches=launches, graph_equals_eager=True,
               decode_ms_per_token={"graphed": graphed["decode_ms_per_token"],
                                    "eager": eager["decode_ms_per_token"]},
               launches_per_decode_token={k: v / graphed["decoded_steps"]
                                          for k, v in graphed["launches_decode"].items()},
               launches_per_prefill_chunk={
                   k: v / math.ceil(graphed["prompt_tokens"] / PREFILL_CHUNK)
                   for k, v in graphed["launches_prefill"].items()})
    return rec


def _f32_runs(runner, prompt: str, what: str, kernels: tuple[str, ...],
              steps: int = DECODE_STEPS) -> dict:
    """The float32 Runner's path: the prompt and `steps` greedy tokens
    graphed at tick 1 (the capture, then the cached graph), at tick 8 and
    eagerly, all the same;
    `kernels` each launched, no bfloat16 matmul form launched (no form whose
    counter lacks "f32" but for qmm_w8 and qmm_w8_grouped, which take
    float32 x rounded to bfloat16), no matmul through torch.matmul, a finite
    cache."""
    import torch

    from crabml_tpu_torch.ops.cuda import _build

    _build.launches.clear()  # counts from here on are this path's
    with DenseMatmuls() as dense:
        capture = _one_run(runner, prompt, _build.launches, steps=steps)
        launches = dict(_build.launches)
        graphed = _one_run(runner, prompt, _build.launches, steps=steps)  # the cached graph
        tick8 = _one_run(runner, prompt, _build.launches, 8, steps)
        eager = _one_run(runner, prompt, _build.launches, "eager", steps)
    if dense.calls:
        fail(f"{what}: {len(dense.calls)} matmuls took torch.matmul on dequantized weights")
    if not capture["tokens"] == graphed["tokens"] == tick8["tokens"] == eager["tokens"]:
        fail(f"{what}: the graphed decode (tick 1, tick 8) and the eager step gave other tokens")
    if len(capture["tokens"]) != steps:
        fail(f"{what}: generated {len(capture['tokens'])} tokens, expected {steps}")
    n = capture["end_pos"]
    if not bool(torch.isfinite(runner.cache.k[:, :, :, :n].float()).all()
                and torch.isfinite(runner.cache.v[:, :, :, :n].float()).all()):
        fail(f"{what}: NaN or inf in the KV cache")
    for name in kernels:
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the {what} path")
    bf16_forms = sorted(k for k in launches if k.startswith("qmm") and "f32" not in k
                        and k not in ("qmm_w8", "qmm_w8_grouped"))
    if bf16_forms:
        fail(f"{what}: float32 compute launched bfloat16 matmul forms {bf16_forms}")
    bound_port, bound_gguf = _decode_bound(runner, n)
    chunks = math.ceil(capture["prompt_tokens"] / PREFILL_CHUNK)
    for r, how in ((capture, "graphed, the run that captures"), (graphed, "graphed"),
                   (tick8, "graphed, tick 8"), (eager, "eager")):
        say(f"{what} path ({how}): prompt {r['prompt_tokens']} tokens in {chunks} chunks, "
            f"prefill {r['prefill_tok_s']:.1f} tok/s ({r['prefill_s'] * 1e3:.1f} ms); decode "
            f"{r['decoded_steps']} steps to pos {r['end_pos']} {r['decode_tok_s']:.2f} tok/s = "
            f"{r['decode_ms_per_token']:.3f} ms/token (bound {bound_port:.3f} ms port layout, "
            f"{bound_gguf:.3f} ms GGUF bytes, the live KV included)")
    say(f"{what} path: {steps} greedy tokens of the graphed runs at tick 1 and 8 equal "
        f"to the eager step's, KV cache {runner.cache.k.dtype}, launches {launches}")
    return {
        "kv_dtype": str(runner.cache.k.dtype), "prefill_w8": runner.prefill_w8,
        "prompt_tokens": capture["prompt_tokens"], "end_pos": n, "launches": launches,
        "runs": [{k: v for k, v in r.items() if k not in ("text", "tokens")}
                 for r in (capture, graphed, tick8, eager)],
        "graph_equals_eager": True, "tokens": capture["tokens"],
        "decode_bound_ms_port_layout": bound_port, "decode_bound_ms_gguf_bytes": bound_gguf,
        "launches_per_decode_token": {k: v / capture["decoded_steps"]
                                      for k, v in capture["launches_decode"].items()},
        "launches_per_prefill_chunk": {k: v / chunks
                                       for k, v in capture["launches_prefill"].items()},
    }


F32_KERNELS = ("flash_attention", "decode_attention_fused", "qmm_q4k_f32", "qmm_w4a8.f32")


def phase_7b_f32(path: str) -> dict:
    """The 7B Q4_K file at its full 32 layers in float32 (`7b-f32`):
    `Runner(compute_dtype=torch.float32, kv_dtype=torch.bfloat16,
    prefill_w8=False)`, so that the 512- and 189-row chunks take the float32
    dequant form (_f32_runs), a profiled window of the graphed step; the
    16-request drain of an 8-slot PagedServingEngine with a float32 pool
    (pages back), the dense ServingEngine (float32 cache) whose greedy
    tokens are the Runner's, and the daemon over the paged engine; then
    `Runner(..., kv_dtype=torch.int8, prefill_w8=True)`: _f32_runs again,
    the 512-row chunk on the W8 planes (x rounded to bfloat16); then the
    CLI in a subprocess with --dtype f32 --kv-dtype bf16."""
    import torch

    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.runtime.runner import Runner
    from crabml_tpu_torch.serving import PagedServingEngine, Request, ServingEngine

    prompt = PROMPT_SENTENCE * PROMPT_REPEATS
    torch.cuda.reset_peak_memory_stats()
    runner = Runner(path, compute_dtype=torch.float32, kv_dtype=torch.bfloat16, prefill_w8=False)
    load_s = runner.metrics.times_ns["load"] / 1e9
    rec = _f32_runs(runner, prompt, "7b-f32", F32_KERNELS)
    rec["load_s"] = load_s
    rec["decode_profile"] = _profile_decode(runner, prompt,
                                            rec["runs"][1]["decode_ms_per_token"])

    eng = PagedServingEngine(runner, n_slots=SERVING_SLOTS, n_pages=SERVING_PAGES, seq_len=CTX,
                             seed=7)
    pages_at_start = eng.pages_free()
    _build.launches.clear()
    serving = _drain(eng, _serving_requests(runner, seed=30))
    serving["launches"] = dict(_build.launches)
    serving["launches_per_tick"] = {k: v / eng.steps for k, v in serving["launches"].items()}
    _say_run("serving, 7b-f32, 8 slots, 256-page float32 pool", serving)
    if eng.cache.k.dtype != torch.float32 or eng.pages_free() != pages_at_start \
            or any(eng._owned):
        fail(f"7b-f32 serving: pool {eng.cache.k.dtype}, pages_free {eng.pages_free()} after "
             f"the run, {pages_at_start} before")
    for name in ("paged_decode_attention_fused", "flash_attention", "qmm_w4a8.f32"):
        if serving["launches"].get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the 7b-f32 serving path")
    serving["daemon"] = phase_daemon(eng)
    rec["serving"] = serving
    del eng

    # the dense engine over the Runner's cache dtype, prefilling in its chunks:
    # the Runner's prompt beside a short one gives the Runner's greedy tokens
    dense_eng = ServingEngine(runner, n_slots=2, seq_len=runner.seq_len, kv_dtype=runner.kv_dtype,
                              prefill_chunk=PREFILL_CHUNK, seed=7)
    same = Request(prompt=prompt, max_tokens=DENSE_ENGINE_TOKENS)
    short = Request(prompt="", max_tokens=DENSE_ENGINE_TOKENS,
                    prompt_tokens=_serving_requests(runner, seed=30)[0].prompt_tokens)
    _build.launches.clear()
    dense_serving = _drain(dense_eng, [same, short])
    dense_serving["launches"] = dict(_build.launches)
    _say_run("dense serving, 7b-f32, 2 slots, bfloat16 cache", dense_serving)
    if same.output_tokens != rec["tokens"][:DENSE_ENGINE_TOKENS]:
        fail(f"7b-f32 dense serving: {same.output_tokens[:8]}... against the Runner's "
             f"{rec['tokens'][:8]}...")
    dense_serving["tokens_equal_runner"] = True
    rec["dense_serving"] = dense_serving
    del dense_eng, runner
    torch.cuda.empty_cache()

    runner = Runner(path, compute_dtype=torch.float32, kv_dtype=torch.int8, prefill_w8=True)
    if not runner.prefill_w8 or runner.cache.k.dtype != torch.int8:
        fail("7b-f32: Runner(kv_dtype=int8, prefill_w8=True) took neither")
    int8 = rec["int8_w8"] = _f32_runs(runner, prompt, "7b-f32-int8",
                                      ("qmm_w8", "qmm_q4k_f32", "qmm_w4a8.f32",
                                       "decode_attention_fused", "flash_attention"))
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del runner
    torch.cuda.empty_cache()
    say(f"7b-f32 with an int8 cache and the W8 planes: launches {int8['launches']}")

    argv = [sys.executable, "-m", "crabml_tpu_torch.cli", path, "-p", PROMPT_SENTENCE * 4,
            "-n", "32", "--dtype", "f32", "--kv-dtype", "bf16", "--seq-len", "2048", "--seed",
            "1", "-v"]
    t0 = time.perf_counter()
    out = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    tail = out.stderr.strip().splitlines()[-12:]
    if out.returncode != 0 or not re.search(r"\n\d+ tokens, [\d.]+ tokens/s", out.stderr) \
            or "prefill_tokens" not in out.stderr or "== metadata ==" not in out.stderr:
        fail(f"7b-f32 CLI: exit {out.returncode}, stderr ends {tail}")
    say(f"7b-f32 CLI ({' '.join(argv[3:])}): exit 0 in {cli_s:.1f} s; " + " | ".join(tail[:2]))
    rec["cli"] = {"argv": argv[3:], "s": cli_s, "stderr_tail": tail}
    return rec


def phase_gemma2_f32(path: str) -> dict:
    """Gemma-2-9B's widths at 2 layers in float32 (`gemma2-9b-f32`):
    `Runner(compute_dtype=torch.float32, kv_dtype=torch.bfloat16,
    prefill_w8=False)` on the 4,612-token prompt past the window (flash in
    float32 at head dim 256, the 256,000-row Q6_K lm_head through the float32
    dequant form, the 4-token tail through the unfused decode form), then
    the decode step over the bfloat16 cache at head dim 256 (float32 q over
    a bfloat16 cache, one tile for K and then V) with the window and the
    softcaps (_f32_runs)."""
    import torch

    from crabml_tpu_torch.runtime.runner import Runner

    runner = Runner(path, compute_dtype=torch.float32, kv_dtype=torch.bfloat16, prefill_w8=False)
    rec = _f32_runs(runner, _g2_prompt(runner.tokenizer), "gemma2-9b-f32",
                    ("flash_attention", "decode_attention", "decode_attention_fused",
                     "qmm_q4k_f32", "qmm_q6k_f32", "qmm_w4a8.f32", "qmm_w4a8_q6k.f32"))
    del runner
    torch.cuda.empty_cache()
    return rec


MOE_F32_LAYERS = 2  # of Mixtral-8x7B's 32: layer 0's down experts Q4_K, layer 1's Q6_K
MOE_F32_STEPS = 32
MOE_F32_KERNELS = ("flash_attention", "decode_attention_fused", "qmm_q4k_grouped.f32",
                   "qmm_q6k_grouped.f32", "qmm_w4a8.planes.f32", "qmm_w4a8_q6k.planes.f32",
                   "qmm_q4k_f32", "qmm_q8_0_f32", "qmm_q5k_f32", "qmm_w4a8.f32",
                   "qmm_w4a8_q8_0.f32", "qmm_w4a8_q5k.f32", "qmm_w4a8_q6k.f32")


def phase_moe_f32(tmp: Path) -> dict:
    """A float32 mixture of experts (`mixtral-q4_k_m-f32`): Mixtral-8x7B's
    widths in llama.cpp's 8-expert Q4_K_M layout at MOE_F32_LAYERS of 32
    layers, float32 compute over a bfloat16 cache. The card-against-CPU
    float32 forward (phase_forward, float32 on both sides: 1e-4 on the
    prefill, 5e-2 on the decode step); `Runner(compute_dtype=torch.float32,
    kv_dtype=torch.bfloat16, prefill_w8=False)` on the ~700-token prompt
    (its 512- and 189-token chunks through the grouped float32 forms of the
    Q4_K and Q6_K experts) and MOE_F32_STEPS greedy tokens graphed at tick 1
    and 8 and eagerly, identical (_f32_runs); the same file with
    prefill_w8=True, whose prefill takes the grouped W8 form on x rounded to
    bfloat16, in turns with the grouped float32 one; then the 16-request
    drain of an 8-slot PagedServingEngine with a float32 pool, pages back."""
    import torch

    from crabml_tpu_torch.gguf.constants import GGMLType
    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.runtime.runner import Runner
    from crabml_tpu_torch.serving import PagedServingEngine
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    what = "mixtral-q4_k_m-f32"
    t0 = time.perf_counter()
    path = build_synth_gguf(str(tmp / f"synth-{what}.gguf"), "mixtral-8x7b", seed=5,
                            layers=MOE_F32_LAYERS, scheme="q4_k", mix="k_m")
    synth_s = time.perf_counter() - t0
    say(f"synthetic Mixtral-8x7B Q4_K_M GGUF, {MOE_F32_LAYERS} of 32 layers: "
        f"{os.path.getsize(path) / 1e9:.3f} GB in {synth_s:.2f} s")
    fwd = phase_forward(tmp, "mixtral-8x7b", seed=5, n_prompt=F32_FORWARD_PROMPT, path=path,
                        f32_card=True, bf16_card=False)
    prompt = PROMPT_SENTENCE * PROMPT_REPEATS
    runner = Runner(path, compute_dtype=torch.float32, kv_dtype=torch.bfloat16, prefill_w8=False)
    layers = runner.weights["layers"]
    down = [lw["ffn_down_exps"].kind for lw in layers]
    if down != [GGMLType.Q4_K, GGMLType.Q6_K] or layers[0]["wgu_exps"].kind != GGMLType.Q4_K:
        fail(f"{what}: gate|up {layers[0]['wgu_exps'].kind.name}, down {[k.name for k in down]}")
    if any(t.dtype != torch.float32 for lw in layers for n in ("wgu_exps", "ffn_down_exps")
           for pn, t in lw[n].planes.items() if pn in ("dsub", "msub")):
        fail(f"{what}: an expert stack's scale planes are not float32")
    load_s = runner.metrics.times_ns["load"] / 1e9  # before the runs reset the metrics
    rec = _f32_runs(runner, prompt, what, MOE_F32_KERNELS, MOE_F32_STEPS)
    rec.update(file=what, layers=MOE_F32_LAYERS, synth_s=synth_s, forward=fwd, load_s=load_s)

    w8 = Runner(path, compute_dtype=torch.float32, kv_dtype=torch.bfloat16, prefill_w8=True)
    _prefill_only(w8, prompt)  # warm
    _build.launches.clear()
    _prefill_only(w8, prompt)
    w8_launches = {k: v for k, v in _build.launches.items() if k.startswith("qmm")}
    if w8_launches.get("qmm_w8_grouped", 0) <= 0 or any(
            k.startswith("qmm_") and k.endswith("_grouped.f32") for k in w8_launches):
        fail(f"{what}: the W8 prefill launched {w8_launches}")
    rec["prefill_w8_against_grouped_f32"] = _prefill_w8_against_q4k(path, w8, prompt, what,
                                                                    runner)
    rec["prefill_w8_launches"] = w8_launches
    launches_f32 = rec["prefill_w8_against_grouped_f32"]["launches"]
    if any(launches_f32.get(n, 0) <= 0 for n in ("qmm_q4k_grouped.f32", "qmm_q6k_grouped.f32")) \
            or launches_f32.get("qmm_w8_grouped", 0):
        fail(f"{what}: the prefill without W8 planes launched {launches_f32}")
    del w8
    torch.cuda.empty_cache()

    eng = PagedServingEngine(runner, n_slots=SERVING_SLOTS, n_pages=SERVING_PAGES, seq_len=CTX,
                             seed=7)
    pages_at_start = eng.pages_free()
    _build.launches.clear()
    serving = _drain(eng, _serving_requests(runner, seed=31))
    serving["launches"] = dict(_build.launches)
    serving["launches_per_tick"] = {k: v / eng.steps for k, v in serving["launches"].items()}
    _say_run(f"serving, {what}, 8 slots, 256-page float32 pool", serving)
    if eng.cache.k.dtype != torch.float32 or eng.pages_free() != pages_at_start \
            or any(eng._owned):
        fail(f"{what} serving: pool {eng.cache.k.dtype}, pages_free {eng.pages_free()} after "
             f"the run, {pages_at_start} before")
    for name in ("paged_decode_attention_fused", "qmm_w4a8.planes.f32", "qmm_q4k_grouped.f32"):
        if serving["launches"].get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the {what} serving path")
    rec["serving"] = serving
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del eng, runner
    os.remove(path)
    torch.cuda.empty_cache()
    return rec


def phase_hf_goldens() -> dict:
    """The four committed HF fixtures (tests/fixtures/<family>-tiny-f32.gguf,
    head dim 16, F32 weights; mixtral's a mixture of experts) on the card in
    float32 through `Runner(path, compute_dtype=torch.float32)`: the golden's
    16-token prompt at once (flash at hd 16) against transformers' logits
    (<family>-tiny-golden.npz) at rtol = atol = HF_TOL; 15 tokens, then the
    16th through the decode step captured in a CUDA graph (flash over the
    cache, masked by pos on the device) against the last row; then the
    Runner's greedy tokens on three prompts (graphed decode) equal to those
    of a PagedServingEngine (its tick through flash over the pages gathered
    through the block table) and of a ServingEngine, each of two slots."""
    import numpy as np
    import torch

    from crabml_tpu_torch.models.forward import decode_step, forward
    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.runtime.generate import StepGraph
    from crabml_tpu_torch.runtime.runner import Runner
    from crabml_tpu_torch.serving import PagedServingEngine, Request, ServingEngine

    fixtures = ROOT / "tests" / "fixtures"
    prompts = ["hello world", "a b c d e f g h i j k l m n o p q r s t", "x"]
    out = {"tolerance": f"rtol = atol = {HF_TOL} (tests/test_family_goldens.py)"}
    _build.launches.clear()  # counts from here on are this path's
    for family in HF_FAMILIES:
        gold = np.load(fixtures / f"{family}-tiny-golden.npz")
        tokens, want = gold["tokens"].tolist(), gold["logits"]
        runner = Runner(str(fixtures / f"{family}-tiny-f32.gguf"), compute_dtype=torch.float32)
        cfg = runner.cfg
        if cfg.head_dim != 16 or runner.device.type != "cuda":
            fail(f"{family}: head dim {cfg.head_dim} on {runner.device}")
        runner.reset()
        whole = forward(runner.weights, runner.cache, torch.tensor([tokens], device=CARD),
                        torch.tensor([0]), cfg, torch.float32)[0].cpu().numpy()
        runner.reset()
        runner._forward_tokens(tokens[:-1])
        tok = torch.tensor([[tokens[-1]]], device=CARD)
        pos = torch.tensor([len(tokens) - 1], dtype=torch.int32, device=CARD)
        last = torch.empty(1, cfg.vocab_size, device=CARD)
        graph = StepGraph(lambda g: last.copy_(decode_step(runner.weights, runner.cache, tok, pos,
                                                           cfg, torch.float32)),
                          torch.device(CARD))
        graph.replay()
        torch.cuda.synchronize()
        step = last[0].cpu().numpy()
        rec = {}
        for what, got, ref in (("prompt", whole, want), ("graphed decode step", step, want[-1])):
            err = float(np.abs(got - ref).max())
            ok = bool(np.isfinite(got).all() and np.allclose(got, ref, rtol=HF_TOL, atol=HF_TOL))
            rec[what] = {"max_abs_err": err, "ok": ok}
            say(f"hf golden {family} ({what}, float32 on the card): max|err| {err:.3e} against "
                f"transformers' logits (max|ref| {np.abs(ref).max():.3f}; {out['tolerance']}) "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                fail(f"hf golden {family}: the {what} is off transformers' logits by {err:.3e}")
        del graph
        greedy = []
        for p in prompts:
            runner.reset()
            _, _, first = runner.prefill(p)
            list(runner.generate(first, HF_STEPS))
            greedy.append(list(runner.generated))
        for name, eng in (("paged", PagedServingEngine(runner, n_slots=2, n_pages=8,
                                                       seq_len=runner.seq_len)),
                          ("dense", ServingEngine(runner, n_slots=2, seq_len=runner.seq_len))):
            reqs = [eng.submit(Request(prompt=p, max_tokens=HF_STEPS)) for p in prompts]
            eng.drain(max_steps=1000)
            got = [list(r.output_tokens) for r in reqs]
            if got != greedy:
                fail(f"hf golden {family}: the {name} engine gave {got}, the Runner {greedy}")
            if name == "paged" and eng.cache.k.dtype != torch.float32:
                fail(f"hf golden {family}: the paged pool is {eng.cache.k.dtype}")
            del eng
        rec["engines_equal_runner"] = True
        out[family] = rec
        del runner
        torch.cuda.empty_cache()
    out["launches"] = dict(_build.launches)
    if out["launches"].get("flash_attention", 0) <= 0 or any(
            n in out["launches"] for n in ("decode_attention", "decode_attention_fused",
                                           "paged_decode_attention",
                                           "paged_decode_attention_fused")):
        fail(f"hf goldens: launches {out['launches']} (head dim 16 takes flash only)")
    say(f"hf goldens: the four fixtures within {HF_TOL} of transformers' logits on the card, "
        f"whole and through the graphed decode step; both engines' greedy tokens the Runner's; "
        f"launches {out['launches']}")
    return out


# the kernels each TinyStories run must launch (prompt and decode): flash at every
# attention (hd 48 and 8 are not decode head dims), and a quantized file's dequant form
# (the prompt's 18 rows) and int8-activation form (every decode step), float32's own
STORIES_FORMS = {"f32": (), "q8_0": ("qmm_q8_0", "qmm_w4a8_q8_0"),
                 "q4_0": ("qmm_q4_0", "qmm_w4a8_q4_0")}
STORIES_FORBIDDEN = ("decode_attention", "decode_attention_fused", "paged_decode_attention",
                     "paged_decode_attention_fused")


def _stories_forms(scheme: str, dtype) -> tuple[str, ...]:
    import torch

    forms = STORIES_FORMS[scheme]
    if dtype == torch.float32 and forms:
        forms = (forms[0] + "_f32", forms[1] + ".f32")
    return ("flash_attention",) + forms


def _stories_runs(runner, what: str, scheme: str) -> dict:
    """STORIES_PROMPT and STORIES_STEPS greedy tokens graphed at tick 1 (the
    capture, then the cached graph) and eagerly: the same tokens, a finite
    cache, the path's kernels (STORIES_FORMS) launched, no decode-attention
    form (the decode step attends through flash at these head dims), no
    product of a quantized weight through torch.matmul."""
    import torch

    from crabml_tpu_torch.ops.cuda import _build

    _build.launches.clear()  # counts from here on are this run's
    with DenseMatmuls() as dense:
        capture = _one_run(runner, STORIES_PROMPT, _build.launches, steps=STORIES_STEPS)
        launches = dict(_build.launches)
        graphed = _one_run(runner, STORIES_PROMPT, _build.launches, steps=STORIES_STEPS)
        eager = _one_run(runner, STORIES_PROMPT, _build.launches, "eager", STORIES_STEPS)
    if scheme != "f32" and dense.calls:
        fail(f"{what}: {len(dense.calls)} matmuls took torch.matmul on dequantized weights")
    if not capture["tokens"] == graphed["tokens"] == eager["tokens"]:
        fail(f"{what}: the graphed decode and the eager step gave other tokens")
    if len(capture["tokens"]) != STORIES_STEPS:
        fail(f"{what}: generated {len(capture['tokens'])} tokens, expected {STORIES_STEPS}")
    n = capture["end_pos"]
    if not bool(torch.isfinite(runner.cache.k[:, :, :, :n].float()).all()
                and torch.isfinite(runner.cache.v[:, :, :, :n].float()).all()):
        fail(f"{what}: NaN or inf in the KV cache")
    for name in _stories_forms(scheme, runner.compute_dtype):
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the {what} path")
    if any(launches.get(name) for name in STORIES_FORBIDDEN):
        fail(f"{what}: a decode-attention form launched at head dim {runner.cfg.head_dim}")
    bound_port, bound_gguf = _decode_bound(runner, n)
    steps = capture["decoded_steps"]
    rec = {
        "prompt_tokens": capture["prompt_tokens"], "end_pos": n, "launches": launches,
        "graph_equals_eager": True, "text": capture["text"],
        "decode_ms_per_token": {"graphed (capture)": capture["decode_ms_per_token"],
                                "graphed": graphed["decode_ms_per_token"],
                                "eager": eager["decode_ms_per_token"]},
        "prefill_ms": {"graphed": graphed["prefill_s"] * 1e3, "eager": eager["prefill_s"] * 1e3},
        "launches_per_decode_token": {k: v / steps for k, v in capture["launches_decode"].items()},
        "launches_prefill": capture["launches_prefill"],
        "decode_bound_ms_port_layout": bound_port, "decode_bound_ms_gguf_bytes": bound_gguf,
    }
    say(f"{what} ({str(runner.compute_dtype)[6:]}): prompt {capture['prompt_tokens']} tokens, "
        f"{STORIES_STEPS} greedy tokens graphed (capture / cached) and eager identical; decode "
        f"{capture['decode_ms_per_token']:.3f} / {graphed['decode_ms_per_token']:.3f} / eager "
        f"{eager['decode_ms_per_token']:.3f} ms/token (bound {bound_port:.4f} ms port layout, "
        f"{bound_gguf:.4f} ms GGUF bytes); "
        f"{sum(rec['launches_per_decode_token'].values()):.1f} kernel launches a token; "
        f"launches {launches}")
    return rec


def _stories_engines(runner, what: str) -> dict:
    """Both engines' greedy tokens (two slots) on STORIES_ENGINE_PROMPTS equal
    the Runner's; then a 16-request drain through an 8-slot PagedServingEngine
    (prompts of 8 to 190 tokens, 64 tokens each, greedy), pages back."""
    import numpy as np

    from crabml_tpu_torch.serving import PagedServingEngine, Request, ServingEngine

    greedy = []
    eos = runner.tokenizer.eos_token
    for p in STORIES_ENGINE_PROMPTS:
        runner.reset()
        _, _, first = runner.prefill(p)
        list(runner.generate(first, STORIES_ENGINE_TOKENS))
        # the Runner yields the token its prefill samples even when it is EOS, where an
        # engine's request ends there with no token (later EOS ends both alike)
        greedy.append([] if first == eos else list(runner.generated))
    seq = runner.seq_len
    for name, eng in (("paged", PagedServingEngine(runner, n_slots=2, n_pages=8, seq_len=seq)),
                      ("dense", ServingEngine(runner, n_slots=2, seq_len=seq))):
        reqs = [eng.submit(Request(prompt=p, max_tokens=STORIES_ENGINE_TOKENS))
                for p in STORIES_ENGINE_PROMPTS]
        eng.drain(max_steps=1000)
        got = [list(r.output_tokens) for r in reqs]
        if got != greedy:
            fail(f"{what}: the {name} engine gave {got}, the Runner {greedy}")
        del eng
    rng = np.random.default_rng(7)
    bos = runner.tokenizer.bos_token
    reqs = [Request(prompt="", prompt_tokens=[bos] + rng.integers(
        3, runner.cfg.vocab_size, n - 1).tolist(), max_tokens=64) for n in STORIES_DRAIN_LENGTHS]
    eng = PagedServingEngine(runner, n_slots=SERVING_SLOTS, n_pages=4 * SERVING_SLOTS + 1,
                             seq_len=seq)
    free = eng.pages_free()
    drain = _drain(eng, reqs)
    if eng.pages_free() != free:
        fail(f"{what}: the drain kept {free - eng.pages_free()} pages")
    say(f"{what} engines: both engines' greedy tokens the Runner's; paged drain of "
        f"{drain['requests']} requests at {SERVING_SLOTS} slots {drain['aggregate_tok_s']:.1f} "
        f"tok/s, TTFT p50 {drain['ttft_s']['p50']:.3f} s, pages back")
    return {"engines_equal_runner": True, "drain": drain}


def _stories_daemon(path: str, runner, what: str) -> dict:
    """The HTTP daemon (`serving/http.py`, paged, its default device and
    dtype: the card, bfloat16) on `path`, 127.0.0.1 and a free port:
    STORIES_ENGINE_PROMPTS POSTed at once to /v1/completions, greedy, each
    text equal to the bfloat16 `runner`'s on the same prompt; then a clean
    shutdown."""
    import threading

    from crabml_tpu_torch.serving import http as serving_http
    from crabml_tpu_torch.tokenizer import Utf8Buf

    n = STORIES_ENGINE_TOKENS
    want = []
    for p in STORIES_ENGINE_PROMPTS:
        runner.reset()
        _, _, first = runner.prefill(p)
        list(runner.generate(first, n))
        # a request ends on a first-sampled EOS with no token (_stories_engines)
        tokens = [] if first == runner.tokenizer.eos_token else list(runner.generated)
        buf = Utf8Buf()
        want.append("".join(runner.tokenizer.decode(t, buf) for t in tokens))
    argv = [path, "--paged", "--slots", "2", "--pages", "8", "--host", "127.0.0.1",
            "--port", "0"]
    engine, args = serving_http.engine_from_args(argv)
    if engine.device.type != "cuda":
        fail(f"{what} daemon: the engine is on {engine.device}")
    server = serving_http.make_server(engine, args.host, args.port)
    port = server.server_address[1]
    thread = threading.Thread(target=serving_http.serve, args=(engine,),
                              kwargs={"server": server}, daemon=True)
    thread.start()
    results: dict[int, tuple] = {}

    def post(i):
        results[i] = _http(port, "POST", "/v1/completions",
                           {"prompt": STORIES_ENGINE_PROMPTS[i], "max_tokens": n})

    try:
        t0 = time.perf_counter()
        posts = [threading.Thread(target=post, args=(i,)) for i in range(len(want))]
        for t in posts:
            t.start()
        for t in posts:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        thread.join(timeout=60)
    if thread.is_alive():
        fail(f"{what} daemon: the server thread did not stop")
    if len(results) != len(want):
        fail(f"{what} daemon: a POST did not return")
    for i, text in enumerate(want):
        status, data = results[i]
        if status != 200 or json.loads(data)["choices"][0]["text"] != text:
            fail(f"{what} daemon: POST {i} answered {status} {data[:300]}, the Runner {text!r}")
    del engine
    say(f"{what} daemon on 127.0.0.1:{port}: {len(want)} POSTs to /v1/completions in "
        f"{wall:.2f} s, each text the bfloat16 Runner's; shut down cleanly")
    return {"argv": argv[1:], "wall_s": wall, "texts_equal_runner": True}


def phase_stories(tmp: Path) -> dict:
    """The TinyStories models (STORIES) at full depth on the card: each
    file's forward against the CPU's (phase 3's gates: bfloat16 within 5e-2
    of float32, float32 within F32_FORWARD_TOL); `Runner(path)` in bfloat16
    and in float32 (the JAX package's default), each on STORIES_PROMPT for
    STORIES_STEPS greedy tokens graphed and eagerly (_stories_runs); both
    engines against the bfloat16 Runner and a paged drain
    (_stories_engines); the daemon on the stories260K file (_stories_daemon);
    the CLI once on the stories15M F32 file, whose text must be the bfloat16
    Runner's."""
    import torch

    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.runtime.runner import Runner
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    out = {}
    total: dict[str, int] = {}
    for model, scheme, seed in STORIES:
        what = f"{model}-{scheme}"
        path = build_synth_gguf(str(tmp / f"{what}.gguf"), model, seed=seed, scheme=scheme)
        rec = out[what] = {"forward": phase_forward(tmp, model, seed=seed, path=path,
                                                    n_prompt=F32_FORWARD_PROMPT, f32_card=True,
                                                    scheme=scheme)}
        if not rec["forward"]["ok"]:
            fail(f"{what}: the card's forward is off the CPU's")
        for dtype in (torch.bfloat16, torch.float32):
            runner = Runner(path, compute_dtype=dtype)
            if runner.device.type != "cuda":
                fail(f"{what}: the Runner is on {runner.device}")
            rec[str(dtype)[6:]] = runs = _stories_runs(runner, what, scheme)
            for k, v in runs["launches"].items():
                total[k] = total.get(k, 0) + v
            if dtype == torch.bfloat16:
                _build.launches.clear()
                rec["engines"] = _stories_engines(runner, what)
                if model == "stories260k":
                    rec["daemon"] = _stories_daemon(path, runner, what)
                if any(_build.launches.get(name) for name in STORIES_FORBIDDEN):
                    fail(f"{what}: an engine's or the daemon's tick launched a "
                         "decode-attention form")
                for k, v in _build.launches.items():
                    total[k] = total.get(k, 0) + v
            del runner
            torch.cuda.empty_cache()
        if what == "stories15m-f32":
            argv = [sys.executable, "-m", "crabml_tpu_torch.cli", path, "-p", STORIES_PROMPT,
                    "-n", str(STORIES_STEPS), "-t", "0"]
            t0 = time.perf_counter()
            cli = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=600)
            want = STORIES_PROMPT + rec["bfloat16"]["text"] + "\n"
            if cli.returncode != 0 or cli.stdout != want:
                fail(f"{what} CLI: exit {cli.returncode}, stdout {cli.stdout[-200:]!r}, "
                     f"stderr {cli.stderr[-400:]!r}")
            rec["cli"] = {"argv": argv[3:], "s": time.perf_counter() - t0}
            say(f"{what} CLI ({' '.join(argv[3:])}): exit 0 in {rec['cli']['s']:.1f} s, its text "
                "the bfloat16 Runner's")
        os.remove(path)
    out["launches"] = total
    say(f"stories: launches {total}")
    return out


# ---------------------------------------------------------------------------

def kernels_line(checks: dict, paths: dict) -> dict:
    """`paths`: {driven path: its record}; each kernel reports the launches
    of the path that KERNEL_SOURCES names for it."""
    out = []
    for name, (src, replaces, path) in KERNEL_SOURCES.items():
        recs = checks[name]
        head = recs[0]
        main = paths["main"]
        own = paths[path]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": own["launches"].get(name, 0), "launches_on": path,
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
        if "launches_per_decode_token" in own and path != "main":  # the path's own rates
            entry["launches_per_decode_token"] = own["launches_per_decode_token"].get(name, 0)
            entry["launches_per_prefill_chunk"] = own["launches_per_prefill_chunk"].get(name, 0)
            entry["launches_per_serving_tick"] = \
                own.get("serving", {}).get("launches_per_tick", {}).get(name, 0)
        entry["launches_by_path"] = {p: rec["launches"][name] for p, rec in paths.items()
                                     if rec.get("launches", {}).get(name)}
        entry["all_shapes"] = [{k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                                    "bound_ms", "bound_by", "max_abs_err")}
                               for r in recs]
        out.append(entry)
    return {"kernels": out}


T0 = time.perf_counter()


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
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name in libs:
        _build.library(name)
    say(f"built {len(libs)} kernel libraries with nvcc for sm_90a in {build_s:.2f} s; by source "
        + ", ".join(f"{n} {t:.1f} s" for n, t in sorted(_build.build_seconds.items(),
                                                        key=lambda kv: -kv[1])))
    OUT_DIR.mkdir(exist_ok=True)
    ptxas = {name: _build.build_log(name) for name in libs}
    (OUT_DIR / "ptxas.txt").write_text(
        "\n".join(f"== {n}\n{log}" for n, log in ptxas.items()))
    for name, log in ptxas.items():
        used = [ln.split(":", 1)[-1].strip() for ln in log.splitlines() if "Used" in ln]
        spills = [ln.strip() for ln in log.splitlines() if re.search(r"[1-9]\d* bytes spill", ln)]
        say(f"ptxas {name}: {'; '.join(used)}" + (f"; SPILLS: {spills}" if spills else ""))

    report = {"device": torch.cuda.get_device_name(0), "gpu": TAG, "build_s": build_s,
              "build_s_by_source": dict(_build.build_seconds),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    phase_s = report["phase_s"] = {"build": build_s}

    def timed(what: str, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[what] = time.perf_counter() - t
        say(f"phase {what}: {phase_s[what]:.1f} s")
        return out

    failures = []
    tmp = Path(tempfile.mkdtemp(prefix="crabml_chip_smoke_"))
    try:
        checks = report["kernels"] = timed("kernels", phase_kernels)
        failures += [f"{n} {r['shape']}" for n, rs in checks.items() for r in rs if not r["ok"]]
        report["forward"] = timed("forward", phase_forward, tmp, n_prompt=F32_FORWARD_PROMPT,
                                  f32_card=True)
        if not report["forward"]["ok"]:
            failures.append("forward check")
        report["serving_forward"] = timed("serving_forward", phase_serving_forward, tmp)
        if not report["serving_forward"]["ok"]:
            failures.append("serving forward check")
        main_rec, runner, gguf = timed("main", phase_main, tmp)
        report["main"] = main_rec
        serving = report["serving"] = timed("serving", phase_serving, runner)
        spec = report["speculative"] = timed("speculative", phase_speculative, tmp, runner, gguf,
                                             serving)
        del runner
        torch.cuda.empty_cache()
        f32_7b = report["7b-f32"] = timed("7b-f32", phase_7b_f32, gguf)
        os.remove(gguf)
        dense = report["dense_int8"] = timed("dense_int8", phase_dense_int8, tmp)
        g2 = report["gemma2-9b"] = timed("gemma2-9b", phase_family, tmp, "gemma2-9b",
                                         G2_LAYERS, 140, _g2_prompt, _g2_check, G2_KERNELS, 26)
        g2_path = build_synth_gguf(str(tmp / "synth-gemma2-9b-2layers.gguf"), "gemma2-9b",
                                   seed=141, layers=2, scheme="q4_k", mix="k_m")
        report["forward_gemma2"] = timed("forward_gemma2", phase_forward, tmp, "gemma2-9b",
                                         seed=141, path=g2_path, n_prompt=F32_FORWARD_PROMPT,
                                         f32_card=True)
        g2_f32 = report["gemma2-9b-f32"] = timed("gemma2-9b-f32", phase_gemma2_f32, g2_path)
        os.remove(g2_path)
        q2 = report["qwen2-7b"] = timed(
            "qwen2-7b", phase_family, tmp, "qwen2-7b", Q2_LAYERS, 160,
            lambda tokenizer: PROMPT_SENTENCE * PROMPT_REPEATS, _q2_check, Q2_KERNELS, 27)
        report["forward_qwen2"] = timed("forward_qwen2", phase_forward, tmp, "qwen2-7b",
                                        seed=161, scheme="q4_k", mix="k_m")
        for model, seed in FAMILY_FORWARDS:
            report[f"forward_{model}"] = timed(f"forward_{model}", phase_forward, tmp, model,
                                               seed=seed, layers=CUT_FORWARD_LAYERS)
        p3 = report["phi3-mini"] = timed(
            "phi3-mini", phase_family, tmp, "phi3-mini", P3_LAYERS, 200,
            lambda tokenizer: PROMPT_SENTENCE * PROMPT_REPEATS, _p3_check, PHI_KERNELS, 28)
        report["forward_phi3"] = timed("forward_phi3", phase_forward, tmp, "phi3-mini",
                                       seed=201, scheme="q4_k", mix="k_m")
        p2 = report["phi2"] = timed(
            "phi2", phase_family, tmp, "phi2", P2_LAYERS, 210,
            lambda tokenizer: PROMPT_SENTENCE * PROMPT_REPEATS, _p2_check,
            PHI_KERNELS + ("layer_norm",), 29)
        report["forward_phi2"] = timed("forward_phi2", phase_forward, tmp, "phi2", seed=211,
                                       scheme="q4_k", mix="k_m")
        l31 = report["llama31-8b"] = timed("llama31-8b", phase_graphed_forward, tmp,
                                           "llama31-8b", 173)
        for name, rec in (("gemma2", report["forward_gemma2"]), ("qwen2", report["forward_qwen2"]),
                          *((m, report[f"forward_{m}"]) for m, _ in FAMILY_FORWARDS),
                          ("llama31-8b", l31["forward"]), ("phi3", report["forward_phi3"]),
                          ("phi2", report["forward_phi2"])):
            if not rec["ok"]:
                failures.append(f"{name} forward check")
        family_paths = {}
        for what, rec in (("gemma2-9b", g2), ("qwen2-7b", q2), ("phi3-mini", p3), ("phi2", p2)):
            family_paths.update({what: rec, f"{what}-dequant": rec["prefill_w8_against_dequant"],
                                 f"{what}-serving": rec["serving"],
                                 f"{what}-dense-serving": rec["dense_serving"]})
        family_paths["llama31-8b"] = l31
        family_paths.update({"7b-f32": f32_7b, "7b-f32-int8": f32_7b["int8_w8"],
                             "7b-f32-serving": f32_7b["serving"],
                             "7b-f32-dense-serving": f32_7b["dense_serving"],
                             "gemma2-9b-f32": g2_f32})
        report["moe_forward"] = timed("moe_forward", phase_forward, tmp, "mixtral-8x7b", seed=16,
                                      n_prompt=300, w8=True, min_share=0.9,
                                      layers=CUT_FORWARD_LAYERS)
        if not report["moe_forward"]["ok"]:
            failures.append("MoE forward check")
        report["moe_serving_forward"] = timed(
            "moe_serving_forward", phase_serving_forward, tmp, "mixtral-8x7b", seed=18,
            lengths=MOE_TICK_LENGTHS, kvs=("compute",), w8=True)
        if not report["moe_serving_forward"]["ok"]:
            failures.append("MoE serving forward check")
        moe = report["moe"] = timed("moe", phase_moe, tmp)
        paths = {"moe": moe, "moe-dequant": moe["prefill_w8_against_q4k"], **family_paths,
                 "speculative": spec, "speculative-dense": spec["dense_step1"]}
        for what, scheme, mix, seed in MOE_SCHEME_PATHS:
            rec = report[what] = timed(what, phase_moe_scheme, tmp, what, scheme, mix, seed)
            if not rec["forward"]["ok"]:
                failures.append(f"{what} forward check")
            paths[what] = rec
            paths[f"{what}-dequant"] = rec["prefill_w8_against_dequant"]
            paths[f"{what}-forward"] = rec["forward"]  # its float32 run's launches
        moe_f32 = report["mixtral-q4_k_m-f32"] = timed("mixtral-q4_k_m-f32", phase_moe_f32, tmp)
        if not moe_f32["forward"]["ok"]:
            failures.append("mixtral-q4_k_m-f32 forward check")
        paths["mixtral-q4_k_m-f32"] = moe_f32
        paths["hf_goldens"] = report["hf_goldens"] = timed("hf_goldens", phase_hf_goldens)
        for i, scheme in enumerate(KERNEL_SCHEMES + REUSED_SCHEMES):
            # the schemes with forms of their own also run the card in float32
            own = scheme in KERNEL_SCHEMES
            fwd = report[f"forward_{scheme}"] = timed(
                f"forward_{scheme}", phase_forward, tmp, seed=80 + i, scheme=scheme,
                n_prompt=F32_FORWARD_PROMPT if own else 16, f32_card=own,
                layers=CUT_FORWARD_LAYERS)
            if not fwd["ok"]:
                failures.append(f"{scheme} forward check")
            if own:
                paths[f"forward_{scheme}"] = fwd
        fwd = report["forward_q4_k_m"] = timed("forward_q4_k_m", phase_forward, tmp, seed=85,
                                               scheme="q4_k", mix="k_m",
                                               layers=CUT_FORWARD_LAYERS)
        if not fwd["ok"]:
            failures.append("q4_k k_m forward check")
        for what, scheme, layers, seed, mix in SCHEME_PATHS:
            paths[what] = report[what] = timed(what, phase_scheme, tmp, what, scheme, layers,
                                               seed, mix)
        paths["stories"] = report["stories"] = timed("stories", phase_stories, tmp)
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
    say(f"the script: {time.perf_counter() - T0:.1f} s, by phase "
        + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    print(json.dumps(kernels_line(checks, {
        "main": main_rec, "serving": serving["first"], "dense_int8": dense, **paths})))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Write a full-size synthetic GGUF (llama, Llama-3.1, Mixtral, qwen2, qwen3, gemma,
gemma2, phi3 or phi2 shape, random Q4_K,
Q5_K, Q6_K, Q8_0, Q4_0, Q3_K, Q2_K, Q4_1, Q5_0, Q5_1 or Q8_1 weights, or
llama.cpp's mixed _K_M, Q2_K and legacy layouts) in seconds.

No multi-GB checkpoint ships with the repo, so the port's main path runs on a
byte-valid GGUF v3 made from a seed. Every block gets random quant bytes and
an explicit finite f16 `d` (random bytes there would give f16 NaN or inf),
sized so that the weights have a standard deviation of about sigma =
1/sqrt(k) (0.02 for the embedding and the output), which keeps activations
finite through every layer:

- Q4_K (256 weights, 144 bytes): random `scales` and `qs`; with 6-bit sc, mn
  and nibbles q uniform, w = d*sc*q - dmin*mn has a standard deviation of
  about 255*d when dmin = 7.5*d, so d = sigma/255.
- Q8_0 (32 weights, 34 bytes): random int8 `qs` in -127..127 (ggml's range),
  standard deviation ~73.3, so d = sigma/73.3.
- Q6_K (256 weights, 210 bytes): random `ql`, `qh` and int8 `scales`; the
  6-bit value less 32 has a standard deviation of ~18.5 and the scale an rms
  of ~73.9, so d = sigma/1367.
- Q5_K (256 weights, 176 bytes): random `scales`, `qh` and `qs`; with 6-bit
  sc, mn and 5-bit q uniform, w = d*sc*q - dmin*mn has a standard deviation
  of about 527*d when dmin = 15.5*d (the mean of q), so d = sigma/527.
- Q4_0 (32 weights, 18 bytes): random nibbles; q - 8 has a standard
  deviation of ~4.64, so d = sigma/4.64.
- Q2_K (256 weights, 84 bytes): random `scales` and `qs`; with 4-bit sc, mn
  and 2-bit q uniform, w = d*sc*q - dmin*mn has a mean of zero when dmin =
  1.5*d (E[sc*q] = 11.25, E[mn] = 7.5) and then a standard deviation of
  about 13.87*d, so d = sigma/13.87.
- Q3_K (256 weights, 110 bytes): random `hmask`, `qs` and `scales`; the
  3-bit value less 4 (-4..3) has an rms of ~2.35 and the 6-bit scale less
  32 (-32..31) an rms of ~18.5, so d = sigma/43.34.
- Q4_1 (32 weights, 20 bytes): random nibbles, m = -7.5*d (the nibbles'
  mean), so w = d*q + m has a standard deviation of ~4.61*d: d = sigma/4.61.
- Q5_0 (32 weights, 22 bytes): random `qh` and nibbles; q - 16 (-16..15) has
  a standard deviation of ~9.23, so d = sigma/9.23.
- Q5_1 (32 weights, 24 bytes): random `qh` and nibbles, m = -15.5*d: w has a
  standard deviation of ~9.23*d, so d = sigma/9.23.
- Q8_1 (32 weights, 36 bytes): Q8_0's values and d, and ggml's block sum
  s = f16(d * sum(qs)).
- F32 and F16: normal values of standard deviation sigma (the reference's
  TinyStories files are F32).

The TinyStories shapes are the reference's own models (crabml's testdata:
tinyllamas-stories-15m and -260k, karpathy's llama2.c checkpoints):
`stories15m` (288 / 768, 6 layers, 6 heads of head dim 48, vocab 32000,
context 256) in F32, Q8_0 or Q4_0, and `stories260k` (64 / 172, 5 layers, 8
q heads of head dim 8 over 4 kv heads, vocab 512, context 512) in F32 or
F16. Their rows are not whole 256-element superblocks, so no K-quant holds
them, and FFN 172 is not whole 32-element blocks either: a scheme that
cannot hold a row raises with the reason before anything is written.

`lm_head` writes `output.weight` in another scheme than the rest: Q6_K beside
Q4_K layers is what llama.cpp's Q4_K_S and Q4_K_M files carry
(`llama_tensor_get_type` puts the output in Q6_K).

`mix` writes one of llama.cpp's mixed file types over the `scheme` layers,
as `llama_tensor_get_type` in llama.cpp's src/llama-quant.cpp picks each
tensor's type (`mix_kind`; i is the layer of n, n the file's depth after
--layers, integer division; `output.weight` is Q6_K in every mix):

- `k_m` over q4_k or q5_k (LLAMA_FTYPE_MOSTLY_Q4_K_M, Q5_K_M): `attn_v` and
  `ffn_down` are Q6_K in layer i where `use_more_bits(i, n)` holds, i < n/8
  or i >= 7n/8 or (i - n/8) % 3 == 2; the rest are in `scheme`.
- `k_m` over q3_k (LLAMA_FTYPE_MOSTLY_Q3_K_M): `attn_q`, `attn_k`,
  `ffn_gate`, `ffn_up` and `token_embd` are Q3_K; `attn_v` is Q5_K in layers
  0 and 1 (`i_attention_wv < 2`) and Q4_K after; `attn_output` is Q4_K;
  `ffn_down` is Q5_K where i < n/16 and Q4_K in every other layer (the
  rule's `arch != FALCON || use_more_bits(i, n)` holds for every llama).
- `q2_k` over q2_k (LLAMA_FTYPE_MOSTLY_Q2_K): `attn_q`, `attn_k`,
  `ffn_gate`, `ffn_up` and `token_embd` are Q2_K; `attn_v` is Q4_K where
  n_heads / n_kv_heads >= 4 (`n_gqa() >= 4`) and Q3_K otherwise;
  `attn_output` and `ffn_down` are Q3_K.
- `legacy` over q4_0, q4_1, q5_0 or q5_1 (LLAMA_FTYPE_MOSTLY_Q4_0, Q4_1,
  Q5_0, Q5_1): every matrix and `token_embd` in `scheme`.
- `imatrix` over q4_0 or q5_0 (the same file types quantized with an
  importance matrix): `legacy`, and `ffn_down` in Q4_1 (over q4_0) or Q5_1
  (over q5_0) where i < n/8 (`has_imatrix && i_layer < n_layer/8`, the
  guard of the first few ffn_down layers).

So `--scheme q4_k --mix k_m` is a Q4_K_M file, `--scheme q5_k --mix k_m` a
Q5_K_M one, `--scheme q3_k --mix k_m` a Q3_K_M one and `--scheme q2_k --mix
q2_k` a Q2_K one; each keeps q, k and v in other types in some layer, so
the port leaves them apart there.

On a mixture-of-experts shape the experts' stacks take the rule of their
dense names by their own layer (llama.cpp matches `ffn_down` in
`ffn_down_exps` and reads the layer from the tensor's name): `ffn_gate_exps`
and `ffn_up_exps` are in `scheme`, `ffn_down_exps` as `ffn_down` above. A
model of 8 experts (Mixtral-8x7B; `n_expert == 8` in llama.cpp) has two
overrides that come after each mix's own rule:

- `attn_k` and `attn_v` are Q8_0 in every layer, under every mix;
- `attn_output` is Q5_K under Q4_K_M, Q3_K_M and Q2_K (the 8-expert branch
  of its rule, in place of the dense one, which names K-quant file types
  only); Q5_K_M keeps its base Q5_K, and `legacy` and `imatrix` their
  scheme.

So an 8-expert Q4_K_M file holds Q4_K q, gate|up and embedding, Q8_0 k and
v, Q5_K attn_output and ffn_down_exps in Q6_K where use_more_bits holds (Q4_K
elsewhere); a Q2_K file Q2_K q, gate|up and embedding, Q8_0 k and v, Q5_K
attn_output and Q3_K ffn_down_exps. Other expert counts take the dense
rules. This is a reading of that rule, held by the tests to the tables
above. `--scheme` alone writes every matrix, the experts too, in the scheme,
on a mixture-of-experts shape as on a dense one. Norm weights are f32 ones and
the tokenizer is a llama-SPM vocab of specials, byte tokens and synthetic
pieces. No element is quantized one at a time: the file is random bytes
patched per block, written tensor by tensor.

A mixture-of-experts shape writes what llama.cpp writes for Mixtral: per layer
the experts as 3-D tensors `ffn_{gate,up}_exps` (E, hidden, dim) and
`ffn_down_exps` (E, dim, hidden), the router `ffn_gate_inp` (E, dim) as F32
(normal, standard deviation 1/sqrt(dim), so the router's logits spread like a
standard normal), and `llama.expert_count` / `llama.expert_used_count`.

A gemma2 shape (`gemma2-9b`: google/gemma-2-9b's config.json; `tiny-gemma2`)
writes what llama.cpp writes for Gemma 2 (`GEMMA2`): the gemma2.* metadata
with `attention.key_length` (head dim 256, so n_heads x 256 = 4096 q rows of
a 3584-wide embedding), both softcaps and the sliding window; per layer
`post_attention_norm` and `post_ffw_norm` beside the two pre-norms; and no
`output.weight`: the model is tied, so under a mix `token_embd` takes the
output's type (Q6_K), as llama_tensor_get_type does when a model has no
output tensor (`mix_kind(..., tied=True)`). Its norm weights are random in
[0.5, 1.5]: unit norms put int8 activations on exact ties that torch and
XLA break differently (tests/test_torch_schemes.py, RANDOM_NORMS).

The other families (`FAMILIES`) write what llama.cpp writes for them, at the
widths of each model's config.json: `qwen2-7b` (Qwen/Qwen2-7B: 28 q heads
over 4 kv heads, so 7 a kv head; `tiny-qwen2` the same 7 at head dim 128)
with F32 `attn_q.bias`, `attn_k.bias` and `attn_v.bias` (normal, standard
deviation 0.5); `qwen3-8b` (Qwen/Qwen3-8B) with `attention.key_length` and
the per-head `attn_q_norm` / `attn_k_norm` weights; `gemma-7b`
(google/gemma-7b: 16 heads of head dim 256 over a 3072-wide embedding,
tied, no post-norms, softcaps or window); and `llama31-8b`
(meta-llama/Llama-3.1-8B) with the `rope_freqs.weight` divisors that
llama.cpp's converter computes from its rope_scaling (type llama3, factor 8,
low / high frequency factors 1 / 4, original context 8192;
`llama3_freq_factors`) and no `rope.scaling.type`, as llama.cpp's own
files carry them. Their norm weights are random in [0.5, 1.5] as gemma2's;
the contexts are cut (Qwen2-7B's and Qwen3-8B's to 4096, Llama-3.1-8B's to
8192).

The phi shapes write what llama.cpp writes for them. `phi3-mini`
(microsoft/Phi-3-mini-4k-instruct's config.json: 3072 / 8192, 32 layers, 32
heads of head dim 96 over 32 kv heads, vocab 32064, context 4096; `tiny-phi3`
8 q heads of 96 over 4 kv heads and vocab 576, a multiple of 64 and not of
128 as Phi-3's) holds q|k|v as one `attn_qkv.weight` (rows [q | k | v]) and
gate|up as one `ffn_up.weight` (rows [gate | up]), and `rope.dimension_count`
96. `phi2` (microsoft/phi-2: 2560 / 10240, 32 layers, 32 heads of head dim
80, vocab 51200, context 2048; `tiny-phi2` 16 heads of 80) holds the fused
`attn_qkv.weight` with `attn_qkv.bias`, `attn_output.weight` / `.bias`, a
gateless `ffn_up.weight` / `.bias`, `ffn_down.weight` / `.bias`, a LayerNorm
`attn_norm.weight` / `.bias` a layer and no ffn_norm, `output_norm.bias` and
`output.bias` (every bias F32, normal with standard deviation 0.1), and
`phi2.rope.dimension_count` 32 (the rotary spans 32 of the head's 80 dims)
and `phi2.attention.layer_norm_epsilon`. Under `k_m` a fused `attn_qkv` takes
llama.cpp's own rule: Q5_K over q4_k (Q4_K_M), Q6_K over q5_k (Q5_K_M), Q4_K
over q3_k (Q3_K_M); `ffn_down` the use_more_bits rule as for llama.

Usage:
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model 7b --seed 0
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model 7b --scheme q8_0
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model 7b --lm-head q6_k
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model 7b --scheme q5_k --mix k_m
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model 7b --scheme q3_k --mix k_m
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model 7b --scheme q2_k --mix q2_k
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model mixtral-8x7b --layers 8
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model mixtral-8x7b --layers 8 \
        --scheme q4_k --mix k_m
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model 7b --scheme q5_0 --mix imatrix
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model 7b --scheme q4_1 --mix legacy
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model gemma2-9b --layers 8 \
        --scheme q4_k --mix k_m
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model qwen2-7b --layers 8 \
        --scheme q4_k --mix k_m
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model phi3-mini --scheme q4_k --mix k_m
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model phi2 --layers 8 \
        --scheme q4_k --mix k_m
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model stories15m --scheme f32
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model stories15m --scheme q4_0
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model stories260k --scheme f32
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..gguf.constants import GGML_BLOCK_SIZES, GGMLType
from ..gguf.writer import GGUFWriter

MODEL_SHAPES = {
    # (dim, hidden, layers, heads, kv_heads, vocab, ctx, experts, experts used, rope base)
    # 7b = the Mistral-7B shape of crabml_tpu/tools/synth_gguf.py
    "7b": (4096, 14336, 32, 32, 8, 32000, 4096, 0, 0, 10000.0),
    "tiny": (256, 512, 2, 2, 1, 512, 512, 0, 0, 10000.0),  # head dim 128, K-quant rows
    # mistralai/Mixtral-8x7B-v0.1 config.json, the context cut to 4096
    "mixtral-8x7b": (4096, 14336, 32, 32, 8, 32000, 4096, 8, 2, 1e6),
    # the `mixtral` shape of crabml_tpu/tools/synth_gguf.py
    "mixtral": (2048, 5632, 16, 16, 8, 32000, 4096, 8, 2, 10000.0),
    "tiny-moe": (256, 512, 2, 2, 1, 512, 512, 4, 2, 10000.0),  # head dim 128
    # tiny-moe's widths with Mixtral's 8 experts, 2 used (llama.cpp's 8-expert rule applies),
    # and 2 kv heads: k and v, Q8_0 in the 8-expert mixes, then have 256 rows, a multiple
    # of the JAX package's 256-row kernel tile, so both packages take their int8 kernels
    "tiny-moe8": (256, 512, 2, 2, 2, 512, 512, 8, 2, 10000.0),
    # google/gemma-2-9b config.json (head_dim 256, 42 layers, vocab 256000, ctx 8192)
    "gemma2-9b": (3584, 14336, 42, 16, 8, 256000, 8192, 0, 0, 10000.0),
    # head dim 256 beside a 256-wide embedding: 2 q heads are 512 wide
    "tiny-gemma2": (256, 512, 2, 2, 1, 512, 512, 0, 0, 10000.0),
    # Qwen/Qwen2-7B config.json (28 layers, 28 / 4 heads, vocab 152064), the context cut to 4096
    "qwen2-7b": (3584, 18944, 28, 28, 4, 152064, 4096, 0, 0, 1e6),
    # 7 q heads a kv head at head dim 128 beside a 256-wide embedding: 1792 q rows
    "tiny-qwen2": (256, 512, 2, 14, 2, 512, 512, 0, 0, 1e6),
    # Qwen/Qwen3-8B config.json (36 layers, head_dim 128, vocab 151936), the context cut to 4096
    "qwen3-8b": (4096, 12288, 36, 32, 8, 151936, 4096, 0, 0, 1e6),
    # google/gemma-7b config.json (28 layers, 16 / 16 heads of head_dim 256, vocab 256000)
    "gemma-7b": (3072, 24576, 28, 16, 16, 256000, 8192, 0, 0, 10000.0),
    # meta-llama/Llama-3.1-8B config.json (vocab 128256, rope_theta 500000), context cut to 8192
    "llama31-8b": (4096, 14336, 32, 32, 8, 128256, 8192, 0, 0, 500000.0),
    # microsoft/Phi-3-mini-4k-instruct config.json (head dim 96, vocab 32064, ctx 4096)
    "phi3-mini": (3072, 8192, 32, 32, 32, 32064, 4096, 0, 0, 10000.0),
    # 8 q heads of 96 over 4 kv heads (G = 2); vocab 576 = 4.5 x 128, as 32064 = 250.5 x 128
    "tiny-phi3": (768, 512, 2, 8, 4, 576, 512, 0, 0, 10000.0),
    # microsoft/phi-2 config.json (head dim 80, rotary 32 of it, vocab 51200, ctx 2048)
    "phi2": (2560, 10240, 32, 32, 32, 51200, 2048, 0, 0, 10000.0),
    # 16 heads of 80: the embedding a multiple of 256, as K-quant rows need
    "tiny-phi2": (1280, 512, 2, 16, 16, 512, 512, 0, 0, 10000.0),
    # the reference's own TinyStories models (karpathy's llama2.c, as GGUF in crabml's
    # testdata): stories15M (6 heads of 48, rows of 288 and 768: no K-quant holds them) and
    # stories260K (8 q heads of head dim 8 over 4 kv heads, FFN 172: F32 or F16 only)
    "stories15m": (288, 768, 6, 6, 6, 32000, 256, 0, 0, 10000.0),
    "stories260k": (64, 172, 5, 8, 4, 512, 512, 0, 0, 10000.0),
}
# each family's own metadata beside its shape (a shape not named here is llama):
# the architecture; the head dim where it is decoupled (attention.key_length);
# the rms epsilon; a tied output; gemma2's softcaps and its sliding window on
# even layers (gemma-2-9b: 4096 of its 8192); Llama-3.1's rope_scaling (factor,
# low and high frequency factors, original context), written as rope_freqs
_GEMMA2 = dict(arch="gemma2", head_dim=256, eps=1e-6, tied=True, attn_softcap=50.0,
               final_softcap=30.0)
FAMILIES = {
    "gemma2-9b": dict(_GEMMA2, window=4096),
    "tiny-gemma2": dict(_GEMMA2, window=24),
    "qwen2-7b": dict(arch="qwen2", eps=1e-6),
    "tiny-qwen2": dict(arch="qwen2", head_dim=128, eps=1e-6),
    "qwen3-8b": dict(arch="qwen3", head_dim=128, eps=1e-6),
    "gemma-7b": dict(arch="gemma", head_dim=256, eps=1e-6, tied=True),
    "llama31-8b": dict(arch="llama", eps=1e-5, llama3_rope=(8.0, 1.0, 4.0, 8192)),
    "phi3-mini": dict(arch="phi3", eps=1e-5, rope_dim=96),
    "tiny-phi3": dict(arch="phi3", eps=1e-5, rope_dim=96),
    "phi2": dict(arch="phi2", eps=1e-5, rope_dim=32),
    "tiny-phi2": dict(arch="phi2", eps=1e-5, rope_dim=32),
}
QKV_BIAS_SIGMA = 0.5  # qwen2's random q, k and v biases
PHI2_BIAS_SIGMA = 0.1  # phi2's random biases


def llama3_freq_factors(rope_dim: int, base: float, factor: float, low_freq_factor: float,
                        high_freq_factor: float, orig_ctx: int) -> np.ndarray:
    """The `rope_freqs.weight` divisors that llama.cpp's converter writes for
    a Llama-3.1 checkpoint (rope_scaling type "llama3"): 1 where a
    frequency's wavelength is under orig_ctx / high_freq_factor, `factor`
    where it is over orig_ctx / low_freq_factor, and between them the
    reciprocal of a smooth blend. (rope_dim/2,) float32."""
    freqs = 1.0 / (base ** (np.arange(0, rope_dim, 2, dtype=np.float32) / rope_dim))
    out = []
    for f in freqs:
        wavelen = 2 * np.pi / f
        if wavelen < orig_ctx / high_freq_factor:
            out.append(1.0)
        elif wavelen > orig_ctx / low_freq_factor:
            out.append(factor)
        else:
            smooth = (orig_ctx / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
            out.append(1.0 / ((1.0 - smooth) / factor + smooth))
    return np.asarray(out, np.float32)


def synth_tokenizer(vocab: int):
    """A llama-SPM vocab: specials + 256 byte tokens + synthetic pieces.
    Real text tokenizes via byte fallback; decode round-trips."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    tokens += [f"▁w{i}" for i in range(vocab - len(tokens))]
    scores = [0.0] * 259 + [-float(j) for j in range(vocab - 259)]
    return tokens[:vocab], scores[:vocab]


def random_blocks(rng: np.random.Generator, count: int, size: int) -> np.ndarray:
    """(count, size) u8, writable: the bytes of rng.bytes(count * size) from
    np.random.default_rng's PCG64, drawn ~4x faster. Generator.bytes takes
    its 64-bit outputs in little-endian order, so whole outputs are those
    bytes; with a half output cached, or a byte count that is not whole
    outputs, it is rng.bytes itself."""
    n = count * size
    if n % 8 or rng.bit_generator.state["has_uint32"]:
        return np.frombuffer(rng.bytes(n), np.uint8).reshape(count, size).copy()
    return rng.bit_generator.random_raw(n // 8).view(np.uint8).reshape(count, size)


def q4k_blocks(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    """n weights -> (n/256, 144) u8 Q4_K blocks with random scales and
    nibbles and fixed f16 d = sigma/255, dmin = 7.5*d."""
    blocks = random_blocks(rng, n // 256, 144)
    d = np.float16(sigma / 255.0)
    blocks[:, 0:4] = np.array([d, np.float16(7.5 * float(d))], np.float16).view(np.uint8)
    return blocks


def q8_0_blocks(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    """n weights -> (n/32, 34) u8 Q8_0 blocks with random int8 values in
    -127..127 and a fixed f16 d = sigma/73.3."""
    blocks = random_blocks(rng, n // 32, 34)
    q = blocks[:, 2:34].view(np.int8)
    np.maximum(q, -127, out=q)
    blocks[:, 0:2] = np.array([sigma / 73.3], np.float16).view(np.uint8)
    return blocks


def q6k_blocks(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    """n weights -> (n/256, 210) u8 Q6_K blocks with random ql, qh and int8
    scales and a fixed f16 d = sigma/1367."""
    blocks = random_blocks(rng, n // 256, 210)
    blocks[:, 208:210] = np.array([sigma / 1367.0], np.float16).view(np.uint8)
    return blocks


def q5k_blocks(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    """n weights -> (n/256, 176) u8 Q5_K blocks with random scales, qh and
    nibbles and fixed f16 d = sigma/527, dmin = 15.5*d."""
    blocks = random_blocks(rng, n // 256, 176)
    d = np.float16(sigma / 527.0)
    blocks[:, 0:4] = np.array([d, np.float16(15.5 * float(d))], np.float16).view(np.uint8)
    return blocks


def q4_0_blocks(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    """n weights -> (n/32, 18) u8 Q4_0 blocks with random nibbles and a fixed
    f16 d = sigma/4.64."""
    blocks = random_blocks(rng, n // 32, 18)
    blocks[:, 0:2] = np.array([sigma / 4.64], np.float16).view(np.uint8)
    return blocks


def q2k_blocks(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    """n weights -> (n/256, 84) u8 Q2_K blocks with random scales and 2-bit
    values and fixed f16 d = sigma/13.87, dmin = 1.5*d."""
    blocks = random_blocks(rng, n // 256, 84)
    d = np.float16(sigma / 13.87)
    blocks[:, 80:84] = np.array([d, np.float16(1.5 * float(d))], np.float16).view(np.uint8)
    return blocks


def q3k_blocks(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    """n weights -> (n/256, 110) u8 Q3_K blocks with random hmask, 2-bit
    values and 6-bit scales and a fixed f16 d = sigma/43.34."""
    blocks = random_blocks(rng, n // 256, 110)
    blocks[:, 108:110] = np.array([sigma / 43.34], np.float16).view(np.uint8)
    return blocks


def q4_1_blocks(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    """n weights -> (n/32, 20) u8 Q4_1 blocks with random nibbles and fixed
    f16 d = sigma/4.61, m = -7.5*d."""
    blocks = random_blocks(rng, n // 32, 20)
    d = np.float16(sigma / 4.61)
    blocks[:, 0:4] = np.array([d, np.float16(-7.5 * float(d))], np.float16).view(np.uint8)
    return blocks


def q5_0_blocks(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    """n weights -> (n/32, 22) u8 Q5_0 blocks with random qh and nibbles and
    a fixed f16 d = sigma/9.23."""
    blocks = random_blocks(rng, n // 32, 22)
    blocks[:, 0:2] = np.array([sigma / 9.23], np.float16).view(np.uint8)
    return blocks


def q5_1_blocks(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    """n weights -> (n/32, 24) u8 Q5_1 blocks with random qh and nibbles and
    fixed f16 d = sigma/9.23, m = -15.5*d."""
    blocks = random_blocks(rng, n // 32, 24)
    d = np.float16(sigma / 9.23)
    blocks[:, 0:4] = np.array([d, np.float16(-15.5 * float(d))], np.float16).view(np.uint8)
    return blocks


def f32_values(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    """n weights -> (n,) float32, normal with standard deviation sigma."""
    return rng.standard_normal(n, np.float32) * np.float32(sigma)


def f16_values(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    """n weights -> (n,) float16, normal with standard deviation sigma."""
    return f32_values(rng, n, sigma).astype(np.float16)


def q8_1_blocks(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    """n weights -> (n/32, 36) u8 Q8_1 blocks: Q8_0's random values and d,
    and the block sum s = f16(d * sum(qs))."""
    blocks = np.empty((n // 32, 36), np.uint8)
    q8 = q8_0_blocks(rng, n, sigma)
    blocks[:, 0:2] = q8[:, 0:2]
    blocks[:, 4:36] = q8[:, 2:34]
    d = float(q8[0, 0:2].view(np.float16)[0])
    s = d * q8[:, 2:34].view(np.int8).sum(axis=1, dtype=np.int64)
    blocks[:, 2:4] = s.astype(np.float16).view(np.uint8).reshape(-1, 2)
    return blocks


SCHEMES = {  # --scheme -> (GGML type, block writer)
    "q4_k": (GGMLType.Q4_K, q4k_blocks),
    "q8_0": (GGMLType.Q8_0, q8_0_blocks),
    "q6_k": (GGMLType.Q6_K, q6k_blocks),
    "q5_k": (GGMLType.Q5_K, q5k_blocks),
    "q4_0": (GGMLType.Q4_0, q4_0_blocks),
    "q3_k": (GGMLType.Q3_K, q3k_blocks),
    "q2_k": (GGMLType.Q2_K, q2k_blocks),
    "q4_1": (GGMLType.Q4_1, q4_1_blocks),
    "q5_0": (GGMLType.Q5_0, q5_0_blocks),
    "q5_1": (GGMLType.Q5_1, q5_1_blocks),
    "q8_1": (GGMLType.Q8_1, q8_1_blocks),
}
DENSE = {"f32": (GGMLType.F32, f32_values), "f16": (GGMLType.F16, f16_values)}
WRITERS = {**SCHEMES, **DENSE}  # every --scheme and --lm-head
# the byte offsets in each block of its f16 scale and minimum fields (d, and
# dmin or m), for vary_scales
SCALE_FIELDS = {
    GGMLType.Q4_K: (0, 2), GGMLType.Q8_0: (0,), GGMLType.Q6_K: (208,), GGMLType.Q5_K: (0, 2),
    GGMLType.Q4_0: (0,), GGMLType.Q3_K: (108,), GGMLType.Q2_K: (80, 82),
    GGMLType.Q4_1: (0, 2), GGMLType.Q5_0: (0,), GGMLType.Q5_1: (0, 2), GGMLType.Q8_1: (0,),
}


def vary_scales(kind: GGMLType, blocks: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The writers' `blocks` of `kind` with each f16 scale and minimum field
    of every block times a random factor of its own in [0.5, 2] (Q8_1's s
    made again from the new d), in place. The writers give every block one d
    (and m), so a kernel that read another block's, row's or expert's scale
    would give the same numbers on their blocks; on these it cannot."""
    for off in SCALE_FIELDS[kind]:
        f = blocks[:, off:off + 2].copy().view(np.float16).astype(np.float32)
        f *= np.exp2(rng.uniform(-1.0, 1.0, f.shape)).astype(np.float32)
        blocks[:, off:off + 2] = f.astype(np.float16).view(np.uint8)
    if kind == GGMLType.Q8_1:
        d = blocks[:, 0:2].copy().view(np.float16)[:, 0].astype(np.float64)
        s = d * blocks[:, 4:36].view(np.int8).sum(axis=1, dtype=np.int64)
        blocks[:, 2:4] = s.astype(np.float16).view(np.uint8).reshape(-1, 2)
    return blocks


# --mix -> the --scheme values it takes (the module docstring's tables)
MIXES = {"k_m": ("q4_k", "q5_k", "q3_k"), "q2_k": ("q2_k",),
         "legacy": ("q4_0", "q4_1", "q5_0", "q5_1"), "imatrix": ("q4_0", "q5_0")}
IMATRIX_DOWN = {"q4_0": "q4_1", "q5_0": "q5_1"}  # ffn_down of the first n/8 layers


def use_more_bits(i: int, n: int) -> bool:
    """llama.cpp's use_more_bits(i_layer, n_layers) (src/llama-quant.cpp):
    the layers whose attn_v and ffn_down a Q4_K_M / Q5_K_M file keeps in Q6_K."""
    return i < n // 8 or i >= 7 * n // 8 or (i - n // 8) % 3 == 2


def mix_kind(tensor: str, i: int, n: int, scheme: str, mix: str | None, gqa: int,
             experts: int = 0, tied: bool = False) -> str:
    """The scheme of `tensor` (attn_q, attn_k, attn_v, attn_output, ffn_gate,
    ffn_up, ffn_down, the experts' stacks under the last three names;
    token_embd and output take i = -1) of layer i of n under `mix` (the
    module docstring's tables) in a model of `experts` experts (0: dense);
    `gqa` = n_heads / n_kv_heads; a fused `attn_qkv` (phi2, phi3) takes
    llama.cpp's attn_qkv rule. The output's own rule is the caller's; a
    `tied` model (no output.weight) gives its token_embd the output's Q6_K
    under every mix."""
    if mix is not None and tied and tensor == "token_embd":
        return "q6_k"
    if mix is not None and experts == 8:
        if tensor in ("attn_k", "attn_v"):
            return "q8_0"
        if tensor == "attn_output" and mix in ("k_m", "q2_k"):
            return "q5_k"
    if mix == "imatrix" and tensor == "ffn_down" and i < n // 8:
        return IMATRIX_DOWN[scheme]
    if mix == "k_m" and tensor == "attn_qkv":  # Q4_K_M, Q5_K_M, Q3_K_M
        return {"q4_k": "q5_k", "q5_k": "q6_k", "q3_k": "q4_k"}[scheme]
    if mix == "q2_k":
        if tensor == "attn_v":
            return "q4_k" if gqa >= 4 else "q3_k"
        return "q3_k" if tensor in ("attn_output", "ffn_down") else scheme
    if mix == "k_m" and scheme == "q3_k":
        if tensor == "attn_v":
            return "q5_k" if i < 2 else "q4_k"
        if tensor == "ffn_down":
            return "q5_k" if i < n // 16 else "q4_k"
        return "q4_k" if tensor == "attn_output" else scheme
    if mix == "k_m" and tensor in ("attn_v", "ffn_down") and use_more_bits(i, n):
        return "q6_k"
    return scheme


def build_synth_gguf(path: str, model: str = "7b", seed: int = 0, layers: int | None = None,
                     verbose: bool = False, scheme: str = "q4_k",
                     lm_head: str | None = None, mix: str | None = None,
                     vocab: int | None = None) -> str:
    """Write the synthetic GGUF of shape `model` (optionally with fewer
    layers, or a smaller `vocab`) to `path`, every matrix in `scheme` but
    `output.weight`, which is in `lm_head` (default: `scheme`, or Q6_K with
    a mix), and, with a `mix`, each layer tensor in the type `mix_kind`
    gives it."""
    dim, hidden, n_layers, heads, kv_heads, n_vocab, ctx, experts, used, rope = \
        MODEL_SHAPES[model]
    n_layers = layers or n_layers
    vocab = vocab or n_vocab
    fam = FAMILIES.get(model, {})
    arch = fam.get("arch", "llama")
    hd = fam.get("head_dim", dim // heads)
    tied = fam.get("tied", False)
    if mix is not None and scheme not in MIXES.get(mix, ()):
        raise ValueError(f"mix {mix!r} over scheme {scheme!r}: "
                         + "; ".join(f"{m!r} over {', '.join(s)}" for m, s in MIXES.items()))
    lm_head = lm_head or ("q6_k" if mix else scheme)
    w = GGUFWriter()
    eps_key = "layer_norm_epsilon" if arch == "phi2" else "layer_norm_rms_epsilon"
    meta = {
        "general.architecture": arch,
        "general.name": f"synthetic-{model}-{scheme}" + (f"-{mix}" if mix else "")
                        + (f"-{lm_head}-output" if lm_head != scheme and not mix else ""),
        f"{arch}.context_length": ctx,
        f"{arch}.embedding_length": dim,
        f"{arch}.feed_forward_length": hidden,
        f"{arch}.block_count": n_layers,
        f"{arch}.attention.head_count": heads,
        f"{arch}.attention.head_count_kv": kv_heads,
        f"{arch}.attention.{eps_key}": fam.get("eps", 1e-5),
        # llama and phi files carry rope.dimension_count: elsewhere the rope spans the head dim
        **({f"{arch}.rope.dimension_count": fam.get("rope_dim", hd)}
           if arch in ("llama", "phi3", "phi2") else {}),
        f"{arch}.rope.freq_base": rope,
        "tokenizer.ggml.model": "llama",
    }
    if "head_dim" in fam:
        meta.update({f"{arch}.attention.key_length": hd, f"{arch}.attention.value_length": hd})
    if arch == "gemma2":
        meta.update({
            "gemma2.attn_logit_softcapping": fam["attn_softcap"],
            "gemma2.final_logit_softcapping": fam["final_softcap"],
            "gemma2.attention.sliding_window": fam["window"],
        })
    if experts:
        meta["llama.expert_count"] = experts
        meta["llama.expert_used_count"] = used
    for k, v in meta.items():
        w.add_metadata(k, v)
    tokens, scores = synth_tokenizer(vocab)
    w.add_metadata("tokenizer.ggml.tokens", tokens)
    w.add_metadata("tokenizer.ggml.scores", np.asarray(scores, np.float32))
    w.add_metadata("tokenizer.ggml.bos_token_id", 1)
    w.add_metadata("tokenizer.ggml.eos_token_id", 2)

    q_dim, kv_dim = heads * hd, kv_heads * hd
    counter = [0]

    def add(name, shape, sigma=None, kind=scheme):
        counter[0] += 1
        rng = np.random.default_rng([seed, counter[0]])
        n = int(np.prod(shape))
        s = sigma if sigma is not None else 1.0 / np.sqrt(shape[-1])
        typ, blocks = WRITERS[kind]
        block = GGML_BLOCK_SIZES[typ][0]
        if shape[-1] % block:  # before anything is written: no broken file
            raise ValueError(f"{model} in {kind}: {name} has rows of {shape[-1]}, which "
                             f"{typ.name}'s {block}-element blocks cannot hold")
        w.add_tensor(name, typ, shape, lambda rng=rng, n=n, s=s: blocks(rng, n, s))

    def norm(name, n):  # random in [0.5, 1.5]; llama: ones (its files' bytes as before)
        a = np.ones(n)
        if arch != "llama":
            counter[0] += 1
            a = np.random.default_rng([seed, counter[0]]).uniform(0.5, 1.5, n)
        w.add_tensor(name, GGMLType.F32, (n,), a.astype(np.float32))

    def bias(name, n, sigma=QKV_BIAS_SIGMA):  # qwen2, phi2
        counter[0] += 1
        a = np.random.default_rng([seed, counter[0]]).standard_normal(n) * sigma
        w.add_tensor(name, GGMLType.F32, (n,), a.astype(np.float32))

    def phi_layer(l, kind):
        """phi3's and phi2's tensors of layer l, as llama.cpp names them."""
        phi2 = arch == "phi2"
        add(f"blk.{l}.attn_qkv.weight", (q_dim + 2 * kv_dim, dim), kind=kind("attn_qkv"))
        add(f"blk.{l}.attn_output.weight", (dim, q_dim), kind=kind("attn_output"))
        # phi3's ffn_up holds gate|up: 2 x hidden rows
        add(f"blk.{l}.ffn_up.weight", ((1 if phi2 else 2) * hidden, dim), kind=kind("ffn_up"))
        add(f"blk.{l}.ffn_down.weight", (dim, hidden), kind=kind("ffn_down"))
        norm(f"blk.{l}.attn_norm.weight", dim)
        if not phi2:
            norm(f"blk.{l}.ffn_norm.weight", dim)
            return
        for name, n in (("attn_qkv", q_dim + 2 * kv_dim), ("attn_output", dim),
                        ("ffn_up", hidden), ("ffn_down", dim), ("attn_norm", dim)):
            bias(f"blk.{l}.{name}.bias", n, PHI2_BIAS_SIGMA)

    embd = mix_kind("token_embd", -1, n_layers, scheme, mix, heads // kv_heads, experts,
                    tied=tied)
    add("token_embd.weight", (vocab, dim), sigma=0.02, kind=embd)
    for l in range(n_layers):
        def kind(tensor, l=l):
            return mix_kind(tensor, l, n_layers, scheme, mix, heads // kv_heads, experts)

        if arch in ("phi3", "phi2"):
            phi_layer(l, kind)
            continue
        add(f"blk.{l}.attn_q.weight", (q_dim, dim), kind=kind("attn_q"))
        add(f"blk.{l}.attn_k.weight", (kv_dim, dim), kind=kind("attn_k"))
        add(f"blk.{l}.attn_v.weight", (kv_dim, dim), kind=kind("attn_v"))
        if arch == "qwen2":
            for t, n in (("q", q_dim), ("k", kv_dim), ("v", kv_dim)):
                bias(f"blk.{l}.attn_{t}.bias", n)
        if arch == "qwen3":
            norm(f"blk.{l}.attn_q_norm.weight", hd)
            norm(f"blk.{l}.attn_k_norm.weight", hd)
        add(f"blk.{l}.attn_output.weight", (dim, q_dim), kind=kind("attn_output"))
        if experts:
            counter[0] += 1
            router = np.random.default_rng([seed, counter[0]]).standard_normal((experts, dim))
            w.add_tensor(f"blk.{l}.ffn_gate_inp.weight", GGMLType.F32, (experts, dim),
                         (router / np.sqrt(dim)).astype(np.float32))
            add(f"blk.{l}.ffn_gate_exps.weight", (experts, hidden, dim), kind=kind("ffn_gate"))
            add(f"blk.{l}.ffn_up_exps.weight", (experts, hidden, dim), kind=kind("ffn_up"))
            add(f"blk.{l}.ffn_down_exps.weight", (experts, dim, hidden), kind=kind("ffn_down"))
        else:
            add(f"blk.{l}.ffn_gate.weight", (hidden, dim), kind=kind("ffn_gate"))
            add(f"blk.{l}.ffn_up.weight", (hidden, dim), kind=kind("ffn_up"))
            add(f"blk.{l}.ffn_down.weight", (dim, hidden), kind=kind("ffn_down"))
        norm(f"blk.{l}.attn_norm.weight", dim)
        norm(f"blk.{l}.ffn_norm.weight", dim)
        if arch == "gemma2":
            norm(f"blk.{l}.post_attention_norm.weight", dim)
            norm(f"blk.{l}.post_ffw_norm.weight", dim)
    norm("output_norm.weight", dim)
    if arch == "phi2":
        bias("output_norm.bias", dim, PHI2_BIAS_SIGMA)
    if "llama3_rope" in fam:
        w.add_tensor("rope_freqs.weight", GGMLType.F32, (hd // 2,),
                     llama3_freq_factors(hd, rope, *fam["llama3_rope"]))
    if not tied:  # gemma and gemma2 are tied: the lm_head is token_embd
        add("output.weight", (vocab, dim), sigma=0.02, kind=lm_head)
    if arch == "phi2":
        bias("output.bias", vocab, PHI2_BIAS_SIGMA)

    t0 = time.perf_counter()
    w.write(path)
    if verbose:
        import os

        print(f"wrote {path}: {os.path.getsize(path) / 1e9:.2f} GB in "
              f"{time.perf_counter() - t0:.1f}s")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--model", default="7b", choices=list(MODEL_SHAPES))
    ap.add_argument("--layers", type=int, default=None, help="cut the depth")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheme", default="q4_k", choices=list(WRITERS),
                    help="the quant scheme of every matrix")
    ap.add_argument("--lm-head", default=None, choices=list(WRITERS),
                    help="the scheme of output.weight (default: --scheme, q6_k with --mix); "
                         "q6_k beside q4_k layers is llama.cpp's Q4_K_M / Q4_K_S lm_head")
    ap.add_argument("--mix", default=None, choices=list(MIXES),
                    help="k_m: llama.cpp's _K_M layout over the --scheme layers (Q4_K_M and "
                         "Q5_K_M: attn_v and ffn_down in Q6_K where use_more_bits holds; Q3_K_M "
                         "over q3_k); q2_k: llama.cpp's Q2_K file type (with --scheme q2_k); "
                         "legacy: llama.cpp's Q4_0, Q4_1, Q5_0 or Q5_1 file type; imatrix: a "
                         "Q4_0 or Q5_0 file made with an importance matrix (ffn_down in Q4_1 / "
                         "Q5_1 below n/8); a Q6_K output; with 8 experts Q8_0 attn_k / attn_v "
                         "and (k_m but Q5_K_M, q2_k) a Q5_K attn_output")
    args = ap.parse_args(argv)
    build_synth_gguf(args.out, args.model, args.seed, args.layers, verbose=True,
                     scheme=args.scheme, lm_head=args.lm_head, mix=args.mix)


if __name__ == "__main__":
    main()

"""Write a full-size synthetic GGUF (llama or Mixtral shape, random Q4_K
weights) in seconds.

No multi-GB checkpoint ships with the repo, so the port's main path runs on a
byte-valid GGUF v3 made from a seed. Each Q4_K block (256 weights, 144 bytes)
gets random `scales` and `qs` bytes, and explicit finite f16 `d` and `dmin`:
random bytes there would give f16 NaN or inf. With 6-bit scales sc, mn and
nibbles q uniform, w = d*sc*q - dmin*mn has a standard deviation of about
255*d when dmin = 7.5*d, so d = sigma/255 gives weights of standard
deviation sigma = 1/sqrt(k) (0.02 for the embedding and the output), which
keeps activations finite through every layer. Norm weights are f32 ones and
the tokenizer is a llama-SPM vocab of specials, byte tokens and synthetic
pieces. No element is quantized one at a time: the file is random bytes
patched per block, written tensor by tensor.

A mixture-of-experts shape writes what llama.cpp writes for Mixtral: per layer
the experts as 3-D tensors `ffn_{gate,up}_exps` (E, hidden, dim) and
`ffn_down_exps` (E, dim, hidden), the router `ffn_gate_inp` (E, dim) as F32
(normal, standard deviation 1/sqrt(dim), so the router's logits spread like a
standard normal), and `llama.expert_count` / `llama.expert_used_count`.

Usage:
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model 7b --seed 0
    python -m crabml_tpu_torch.tools.synth_gguf out.gguf --model mixtral-8x7b --layers 8
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..gguf.constants import GGMLType
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
}


def synth_tokenizer(vocab: int):
    """A llama-SPM vocab: specials + 256 byte tokens + synthetic pieces.
    Real text tokenizes via byte fallback; decode round-trips."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    tokens += [f"▁w{i}" for i in range(vocab - len(tokens))]
    scores = [0.0] * 259 + [-float(j) for j in range(vocab - 259)]
    return tokens[:vocab], scores[:vocab]


def q4k_blocks(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    """n weights -> (n/256, 144) u8 Q4_K blocks with random scales and
    nibbles and fixed f16 d = sigma/255, dmin = 7.5*d."""
    blocks = np.frombuffer(rng.bytes(n // 256 * 144), np.uint8).reshape(-1, 144).copy()
    d = np.float16(sigma / 255.0)
    blocks[:, 0:4] = np.array([d, np.float16(7.5 * float(d))], np.float16).view(np.uint8)
    return blocks


def build_synth_gguf(path: str, model: str = "7b", seed: int = 0, layers: int | None = None,
                     verbose: bool = False) -> str:
    """Write the synthetic GGUF of shape `model` (optionally with fewer
    layers) to `path`."""
    dim, hidden, n_layers, heads, kv_heads, vocab, ctx, experts, used, rope = MODEL_SHAPES[model]
    n_layers = layers or n_layers
    w = GGUFWriter()
    meta = {
        "general.architecture": "llama",
        "general.name": f"synthetic-{model}-q4_k",
        "llama.context_length": ctx,
        "llama.embedding_length": dim,
        "llama.feed_forward_length": hidden,
        "llama.block_count": n_layers,
        "llama.attention.head_count": heads,
        "llama.attention.head_count_kv": kv_heads,
        "llama.attention.layer_norm_rms_epsilon": 1e-5,
        "llama.rope.dimension_count": dim // heads,
        "llama.rope.freq_base": rope,
        "tokenizer.ggml.model": "llama",
    }
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

    kv_dim = kv_heads * (dim // heads)
    q4k = GGMLType.Q4_K
    counter = [0]

    def add(name, shape, sigma=None):
        counter[0] += 1
        rng = np.random.default_rng([seed, counter[0]])
        n = int(np.prod(shape))
        s = sigma if sigma is not None else 1.0 / np.sqrt(shape[-1])
        w.add_tensor(name, q4k, shape, lambda rng=rng, n=n, s=s: q4k_blocks(rng, n, s))

    def ones(name, n):
        w.add_tensor(name, GGMLType.F32, (n,), np.ones(n, np.float32))

    add("token_embd.weight", (vocab, dim), sigma=0.02)
    for l in range(n_layers):
        add(f"blk.{l}.attn_q.weight", (dim, dim))
        add(f"blk.{l}.attn_k.weight", (kv_dim, dim))
        add(f"blk.{l}.attn_v.weight", (kv_dim, dim))
        add(f"blk.{l}.attn_output.weight", (dim, dim))
        if experts:
            counter[0] += 1
            router = np.random.default_rng([seed, counter[0]]).standard_normal((experts, dim))
            w.add_tensor(f"blk.{l}.ffn_gate_inp.weight", GGMLType.F32, (experts, dim),
                         (router / np.sqrt(dim)).astype(np.float32))
            add(f"blk.{l}.ffn_gate_exps.weight", (experts, hidden, dim))
            add(f"blk.{l}.ffn_up_exps.weight", (experts, hidden, dim))
            add(f"blk.{l}.ffn_down_exps.weight", (experts, dim, hidden))
        else:
            add(f"blk.{l}.ffn_gate.weight", (hidden, dim))
            add(f"blk.{l}.ffn_up.weight", (hidden, dim))
            add(f"blk.{l}.ffn_down.weight", (dim, hidden))
        ones(f"blk.{l}.attn_norm.weight", dim)
        ones(f"blk.{l}.ffn_norm.weight", dim)
    ones("output_norm.weight", dim)
    add("output.weight", (vocab, dim), sigma=0.02)

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
    args = ap.parse_args(argv)
    build_synth_gguf(args.out, args.model, args.seed, args.layers, verbose=True)


if __name__ == "__main__":
    main()

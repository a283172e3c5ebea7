"""The transformer forward pass for dense llama, in torch.

Counterpart of crabml_tpu/models/forward.py::forward (and KVCache). The JAX
version scans stacked layers inside one jit and batches the cache writes of
its fused decode path into one scatter after the scan, so that a donated cache
is updated in place. None of that mechanics is needed here: PyTorch runs
eagerly, so the port loops over per-layer weight dicts in Python and writes
each layer's new k/v into the cache in place, one indexed write per tensor.
The numbers are the same.

Per layer: rmsnorm -> fused q|k|v matmul -> rope -> cache write + attention
-> wo -> rmsnorm -> fused gate|up -> silu(gate)*up -> down; then the final
norm and the lm_head. `layer_body` holds everything but the cache traffic, so
the paged steps (serving/paged.py) share it. Attention of a few new tokens
(ops.cuda.decode_attention.decode_eligible) takes the decode kernel,
everything else the flash kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..errors import CacheError, UnsupportedError
from ..ops.cuda.decode_attention import (decode_attention, decode_attention_fused,
                                         decode_eligible)
from ..ops.cuda.flash_attention import flash_attention
from ..ops.matmul import embedding_lookup, qmatmul
from ..ops.norm import rms_norm
from ..ops.rope import rope_angles, rotate
from .config import ModelConfig

KV_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def q8_vec(a: torch.Tensor):
    """Symmetric int8 per vector of the last axis (KV quantization): scale =
    max|a| / 127, floored at 1e-12, values round(a / scale) half to even,
    clipped to +-127 -> (int8 like a, float32 scales (..., 1)). Both divisions
    are by tensors: on CUDA a division by a Python scalar becomes a multiply
    by its reciprocal and can flip an int8 value against the JAX package."""
    amax = a.abs().amax(dim=-1, keepdim=True)
    s = (amax / torch.full_like(amax, 127.0)).float().clamp_min(1e-12)
    return torch.clamp(torch.round(a.float() / s), -127, 127).to(torch.int8), s


def dequantize_like(a: torch.Tensor, scale: torch.Tensor | None, dtype) -> torch.Tensor:
    """An int8 cache view times its scales, in the compute dtype (int8 values
    are exact in bfloat16; only the scale multiply rounds)."""
    return a if scale is None else a.to(dtype) * scale.to(dtype)


@dataclass
class KVCache:
    """k, v: (L, B, n_kv_heads, S, head_dim), head-major like the JAX
    package's cache: bfloat16 or float32, or int8 with one float32 scale per
    (token, kv head) in k_scale / v_scale (L, B, KV, S, 1). forward() writes
    it in place."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @staticmethod
    def create(cfg: ModelConfig, batch: int, seq_len: int | None = None,
               dtype=torch.float32, device="cpu") -> "KVCache":
        if dtype not in KV_DTYPES:
            raise UnsupportedError(f"KV cache dtype {dtype}: the port takes float32, "
                                   "bfloat16 or int8")
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq_len or cfg.seq_len, cfg.head_dim)
        k, v = (torch.zeros(shape, dtype=dtype, device=device) for _ in range(2))
        if dtype != torch.int8:
            return KVCache(k, v)
        ks, vs = (torch.ones(shape[:-1] + (1,), dtype=torch.float32, device=device)
                  for _ in range(2))
        return KVCache(k, v, ks, vs)

    @staticmethod
    def from_numpy(k, v, k_scale=None, v_scale=None, device="cpu") -> "KVCache":
        """A cache from the arrays of a JAX-package cache (for the tests)."""
        t = [None if a is None else torch.tensor(a, device=device)
             for a in (k, v, k_scale, v_scale)]
        return KVCache(*t)

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def seq_len(self) -> int:
        return self.k.shape[3]

    def slot(self, b: int) -> "KVCache":
        """A view of one sequence's cache, batch 1: writes land in this one."""
        return KVCache(*(None if a is None else a[:, b : b + 1]
                         for a in (self.k, self.v, self.k_scale, self.v_scale)))


def _project_qkv(lw: dict, h: torch.Tensor):
    if "wqkv" in lw:
        return qmatmul(h, lw["wqkv"])
    return torch.cat([qmatmul(h, lw[n]) for n in ("wq", "wk", "wv")], dim=-1)


def _project_gate_up(lw: dict, h: torch.Tensor):
    if "wgu" in lw:
        return qmatmul(h, lw["wgu"]).chunk(2, dim=-1)
    return qmatmul(h, lw["ffn_gate"]), qmatmul(h, lw["ffn_up"])


def layer_body(lw: dict, x: torch.Tensor, cos, sin, cfg: ModelConfig, kv_io) -> torch.Tensor:
    """One transformer layer on x (B, T, D). Everything is common to the
    dense and the paged forwards except how k/v reach the cache and how
    attention reads them back: `kv_io(q, k, v)` gets the roped q (B, T, H,
    hd) and k, v (B, T, KV, hd), does its own writes and attention, and
    returns (B, T, H*hd)."""
    B, T, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    D, kvd = H * hd, KV * hd
    h = rms_norm(x, lw["attn_norm"], cfg.rms_norm_eps)
    qkv = _project_qkv(lw, h)
    # q and k heads are adjacent in the fused output: one rotation
    qk = rotate(qkv[..., : D + kvd].reshape(B, T, H + KV, hd), cos, sin, cfg.rope_mode)
    v = qkv[..., D + kvd:].reshape(B, T, KV, hd)
    attn = kv_io(qk[:, :, :H], qk[:, :, H:], v)
    x = x + qmatmul(attn.to(x.dtype), lw["wo"])
    h = rms_norm(x, lw["ffn_norm"], cfg.rms_norm_eps)
    gate, up = _project_gate_up(lw, h)
    return x + qmatmul(gate * torch.sigmoid(gate) * up, lw["ffn_down"])


def final_logits(weights: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, weights["final_norm"], cfg.rms_norm_eps)
    return qmatmul(x, weights["output"]).float()


def quantize_new(k: torch.Tensor, v: torch.Tensor, dtype):
    """The step's k, v in the cache's dtype: (k, v, k_scale, v_scale), the
    scales None for a float cache."""
    if dtype == torch.int8:
        kq, ks = q8_vec(k)
        vq, vs = q8_vec(v)
        return kq, vq, ks, vs
    return k.to(dtype), v.to(dtype), None, None


def forward(weights: dict, cache: KVCache, tokens: torch.Tensor, pos: torch.Tensor,
            cfg: ModelConfig, compute_dtype=torch.float32) -> torch.Tensor:
    """tokens (B, T) on the weights' device; pos (B,) int on the CPU: valid
    cache length per sequence. Writes the new k/v into `cache` in place and
    returns logits (B, T, vocab) float32.

    A decode step (T = 1) attends its token's k/v from their own block
    (decode_attention_fused) and writes them afterwards, as the JAX package's
    decode path does. A short chunk is written first and attended over the
    cache with a causal bound per row (decode_attention), a longer one the
    same way through the flash kernel."""
    B, T = tokens.shape
    hd = cfg.head_dim
    starts = [int(p) for p in pos]
    if max(starts) + T > cache.seq_len:
        raise CacheError(f"pos {max(starts)} + {T} tokens overruns the cache ({cache.seq_len})")
    dev = tokens.device
    pos_dev = pos.to(device=dev, dtype=torch.int32)
    positions = pos_dev[:, None] + torch.arange(T, device=dev, dtype=torch.int32)[None]
    cos, sin = rope_angles(positions, cfg.effective_rope_dim, cfg.rope_base)
    use_decode = decode_eligible(T, cfg.n_heads, cfg.n_kv_heads, hd)
    fused_kv = use_decode and T == 1
    softcap, window = cfg.attn_logit_softcap, cfg.sliding_window
    rows, cols = torch.arange(B, device=dev)[:, None], positions.long()
    n_keys = max(starts) + T
    kv_dtype = cache.k.dtype

    x = embedding_lookup(weights["token_embed"], tokens, compute_dtype)
    for l, lw in enumerate(weights["layers"]):
        k_l, v_l = cache.k[l], cache.v[l]
        ks_l = vs_l = None
        if cache.quantized:
            ks_l, vs_l = cache.k_scale[l], cache.v_scale[l]

        def write(kq, vq, ks, vs):
            k_l[rows, :, cols] = kq  # (B, T, KV, hd) at (b, :, pos[b] + t)
            v_l[rows, :, cols] = vq
            if ks is not None:
                ks_l[rows, :, cols] = ks
                vs_l[rows, :, cols] = vs

        def kv_io(q, k, v):
            kq, vq, ks, vs = quantize_new(k, v, kv_dtype)
            if fused_kv:
                tr = [None if a is None else a.transpose(1, 2) for a in (kq, vq, ks, vs)]
                attn = decode_attention_fused(
                    q, cache.k, cache.v, l, pos_dev, cfg.attn_scale, tr[0], tr[1],
                    cache.k_scale, cache.v_scale, tr[2], tr[3], softcap, window)
                write(kq, vq, ks, vs)
                return attn
            write(kq, vq, ks, vs)
            if use_decode:
                return decode_attention(q, k_l, v_l, pos_dev, cfg.attn_scale, ks_l, vs_l,
                                        softcap, window)
            if cache.quantized:  # dequantize only the live view, then attend over it
                return flash_attention(
                    q, dequantize_like(k_l[:, :, :n_keys], ks_l[:, :, :n_keys], q.dtype),
                    dequantize_like(v_l[:, :, :n_keys], vs_l[:, :, :n_keys], q.dtype),
                    pos_dev, cfg.attn_scale, softcap, window)
            return flash_attention(q, k_l, v_l, pos_dev, cfg.attn_scale, softcap, window)

        x = layer_body(lw, x, cos, sin, cfg, kv_io)
    return final_logits(weights, x, cfg)

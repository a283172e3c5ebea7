"""The transformer forward pass for llama (dense or mixture of experts),
qwen2, qwen3, gemma, gemma2, phi3 and phi2, in torch.

Counterpart of crabml_tpu/models/forward.py::forward (and KVCache). The JAX
version scans stacked layers inside one jit and batches the cache writes of
its fused decode path into one scatter after the scan, so that a donated cache
is updated in place. The port loops over per-layer weight dicts in Python and
writes each layer's new k/v into the cache in place, one indexed write per
tensor. The numbers are the same.

Per layer: rmsnorm -> fused q|k|v matmul -> rope -> cache write + attention
-> wo -> rmsnorm -> fused gate|up -> act(gate)*up -> down (or `moe_ffn`, the
Mixtral router over stacked experts); then the final norm and the lm_head.
`layer_body` holds everything but the cache traffic, so the paged steps
(serving/paged.py) share it. gemma2 adds, as the JAX package does: the
embedding scaled by sqrt(dim) rounded to the compute dtype (`embed`), an
rmsnorm on wo's and on down's outputs before each residual add, GELU (tanh)
for SiLU, the attention softcap and a sliding window on even layers only
(`layer_window`), and a softcap on the float32 logits (`final_logits`); its
q heads are H * head_dim wide, not the embedding width. gemma takes the
scale and GELU alone. qwen2 adds its q, k and v biases to the projection in
the compute dtype, and qwen3 RMS-norms each q and k head before the
rotation, as crabml_tpu/models/forward.py does. Every model's angles come
from `rope_tables`: the frequencies kept with the weights (divided by
Llama-3.1's rope_freqs or YaRN's divisors), linear scaling's position
scale and YaRN's magnitude. phi3 is llama's layer on its file's fused
q|k|v and gate|up. phi2 takes, as crabml_tpu/models/forward.py does: a
LayerNorm with a bias for both norms; the q|k|v bias, wo's bias after wo;
the parallel residual (the FFN reads the attention's normed input and the
layer returns (x + attn) + ffn); a gateless FFN, GELU(tanh)(up + b_up) @ down
+ b_down; and the lm_head's bias, added in the compute dtype before the
logits go to float32. Its rotary spans 32 of the head's 80 dims; `rotate`
passes the rest through. The cache holds the model's own head dim, 80
and 96 included: the attention kernels take them as they are, so the JAX
package's kv_lane_pad (a cache 128 wide) has no counterpart here.

The cache's dtype is its own (`KVCache.create`: float32, bfloat16 or int8,
under either compute dtype): the step's k/v are rounded or quantized to it
on the way in (`quantize_new`), the decode kernels take q and the cache in
different dtypes, and a chunk attended through flash first converts the
live view of a cache of another dtype to the compute dtype
(`dequantize_like`), as the JAX package's flash wrapper does.

`decode_step` is the T = 1 step of B sequences. It takes the positions on
the device and reads nothing back to the host, no value and no data-dependent
shape, so a CUDA graph captures it whole (runtime/generate.py replays it);
it attends the step's k/v from their own block (decode_attention_fused) and
writes them afterwards, as the JAX package's decode path does. `verify_step`
is its twin for T <= 8 tokens a sequence (a speculative verify of K + 1
tokens, runtime/speculative.py and the serving engines): also positions on
the device and no host read; the step's k/v are written first and attended
over the cache with a causal bound per row through the decode kernel (at any
number of q heads per kv head), or, at a head dim the decode kernels do not
take (16), through flash over the whole cache masked by pos, as
`decode_step` does. `forward` takes the positions on the host, checks them
against the cache and sends a single token to `decode_step` and a chunk the
decode kernels take (ops.cuda.decode_attention.decode_eligible: T <= 8) to
`verify_step`; a longer chunk is written first and attended over the live
view of the cache through the flash kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..errors import CacheError, UnsupportedError
from ..ops import matmul as ops_matmul
from ..ops.cuda.decode_attention import (decode_attention, decode_attention_fused,
                                         decode_eligible)
from ..ops.cuda.flash_attention import flash_attention
from ..ops.cuda.gemm_quant import W4A8_MAX_ROWS, qmatmul_grouped, qmm_w4a8
from ..ops.matmul import embedding_lookup, qmatmul
from ..ops.norm import layer_norm, rms_norm
from ..ops.rope import rope_angles, rotate
from ..quant.qtensor import QTensor
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
    """A cache view in the compute dtype, for the flash kernel: an int8 one
    times its scales (int8 values are exact in bfloat16; only the scale
    multiply rounds), a float one of the other dtype cast to it, as the JAX
    package's flash wrapper casts the cache to q's dtype
    (crabml_tpu/ops/pallas/flash_attention.py:195)."""
    return a.to(dtype) if scale is None else a.to(dtype) * scale.to(dtype)


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
    # the decode steps captured on this cache (runtime/generate.py::decode_loop)
    graphs: dict = field(default_factory=dict, repr=False, compare=False)

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
    """q|k|v of h, plus qwen2's biases (in the compute dtype, as loaded)."""
    if "wqkv" in lw:
        qkv = qmatmul(h, lw["wqkv"])
    else:
        qkv = torch.cat([qmatmul(h, lw[n]) for n in ("wq", "wk", "wv")], dim=-1)
    return qkv + lw["bqkv"] if "bqkv" in lw else qkv


def _project_gate_up(lw: dict, h: torch.Tensor):
    if "wgu" in lw:
        return qmatmul(h, lw["wgu"]).chunk(2, dim=-1)
    return qmatmul(h, lw["ffn_gate"]), qmatmul(h, lw["ffn_up"])


def _norm(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    """phi2's LayerNorm with its bias b, or the RMS norm (b None)."""
    if cfg.full_layer_norm:
        return layer_norm(x, w, cfg.rms_norm_eps, b)
    return rms_norm(x, w, cfg.rms_norm_eps)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


def _ffn(lw: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The dense FFN: act(gate) * up -> down, or phi2's gateless
    GELU(up + b_up) @ down + b_down, each bias in the compute dtype
    (crabml_tpu/models/forward.py::project_ffn)."""
    if cfg.no_ffn_gate:
        up = qmatmul(h, lw["ffn_up"])
        if "ffn_up_b" in lw:
            up = up + lw["ffn_up_b"]
        down = qmatmul(_gelu(up), lw["ffn_down"])
        return down + lw["ffn_down_b"] if "ffn_down_b" in lw else down
    return qmatmul(_act_mul(cfg.act, *_project_gate_up(lw, h)), lw["ffn_down"])


def _silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return gate * torch.sigmoid(gate) * up


def _act_mul(act: str, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """act(gate) * up: GELU with the tanh approximation for gemma2 (what its
    checkpoints train with; crabml_tpu/models/forward.py::_activation), else
    SiLU (models.weights.check_supported admits no other activation)."""
    if act == "gelu":
        return _gelu(gate) * up
    return _silu_mul(gate, up)


def layer_window(cfg: ModelConfig, l: int) -> int:
    """The sliding window of layer l (0 = every earlier key): gemma2 slides
    on even layers only (alternating_window), every other model on all."""
    if cfg.alternating_window and l % 2:
        return 0
    return cfg.sliding_window


def embed(weights: dict, tokens: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    """The token rows in `dtype`, times sqrt(dim) where the model scales its
    embedding (gemma): the factor is rounded to `dtype` first, as the JAX
    package rounds it (in bfloat16 sqrt(3584) is 59.75)."""
    x = embedding_lookup(weights["token_embed"], tokens, dtype)
    if cfg.scale_embedding:
        d = torch.tensor(float(cfg.embedding_dim), dtype=torch.float32)
        x = x * float(torch.sqrt(d).to(dtype))
    return x


def _expert_gate_up(lw: dict, matmul) -> torch.Tensor:
    """silu(gate) * up of the experts, `matmul(stack)` being the product with
    one stack: one call on the fused gate|up stack, or two."""
    if "wgu_exps" in lw:
        return _silu_mul(*matmul(lw["wgu_exps"]).chunk(2, dim=-1))
    return _silu_mul(matmul(lw["ffn_gate_exps"]), matmul(lw["ffn_up_exps"]))


def moe_route(lw: dict, h: torch.Tensor, cfg: ModelConfig):
    """The router: h (R, D) -> (topi (R, K) int64, topw (R, K) float32). The
    logits are computed in the compute dtype (the router weights were cast
    down at load) and then taken to float32; the softmax runs over the
    selected K only. A stable descending sort puts the lower expert first on
    a tie, as jax.lax.top_k does; torch.topk promises no order, and under
    bfloat16 two logits do tie."""
    logits = (h @ lw["ffn_gate_inp"].t()).float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    K = cfg.n_experts_used
    return idx[:, :K], torch.softmax(vals[:, :K], dim=-1)


_GROUPED_MIN_ROWS = 64  # the JAX package's: from here on its grouped kernels run


def _moe_decode_rows(lw: dict, h: torch.Tensor, topi, topw) -> torch.Tensor:
    """At most W4A8_MAX_ROWS rows: for each slot j of the top-k, one int8-
    activation matmul per stack with row b on plane topi[b, j], which the
    kernel reads on the device. No routing value reaches the host, and only
    the selected experts' planes are read. Each stack takes the form of its
    own scheme and quantizes its activations at that scheme's group, so
    gate|up and down may differ in kind (Q4_K beside Q6_K in a Q4_K_M file).

    The JAX package has three regimes here (a gather by a traced plane index
    at one row, lax.cond per expert, an all-experts mix); they exist to keep
    unselected experts unread under jit and give these numbers row by row:
    the kernel quantizes each row by itself, and an unselected expert's
    routing weight is exactly 0. The slots are summed in top-k order, as JAX
    does at one row; at more rows it sums in ascending expert order, which
    differs only in the order of a bfloat16 sum of K terms and so not at all
    for Mixtral's K = 2."""
    planes = topi.to(torch.int32).t().contiguous()  # (K, R)
    weights = topw.to(h.dtype)
    out = None
    for j in range(planes.shape[0]):
        mid = _expert_gate_up(lw, lambda qt: qmm_w4a8(h, qt, h.dtype, planes[j]))
        y = qmm_w4a8(mid, lw["ffn_down_exps"], h.dtype, planes[j]) * weights[:, j:j + 1]
        out = y if out is None else out + y
    return out


def _moe_grouped(lw: dict, h: torch.Tensor, topi, topw, cfg: ModelConfig) -> torch.Tensor:
    """More rows: the (row, slot) pairs sort stably by expert, and the grouped
    kernels multiply each expert's segment by that expert's planes only. The
    kernels read the segment offsets on the device, so nothing is padded and
    the host reads no count. Each row then gathers its K results back and
    adds them in slot order: an index_add_ would add them by atomics, in an
    order that changes from run to run.

    From _GROUPED_MIN_ROWS rows on the JAX package runs its grouped kernels,
    on the W8 planes where they are attached; below, its all-experts mix
    through the dequant kernel, which gives the numbers of the grouped
    dequant kernel here row by row (an unselected expert's weight is exactly
    0). Each stack takes the grouped kernel of its own scheme."""
    R, K, E = h.shape[0], cfg.n_experts_used, cfg.n_experts
    expert, order = torch.sort(topi.reshape(-1), stable=True)  # (R*K,) pairs by expert
    offsets = torch.searchsorted(
        expert, torch.arange(E + 1, device=h.device, dtype=expert.dtype)).to(torch.int32)
    xs = h.index_select(0, order // K)
    w8 = R >= _GROUPED_MIN_ROWS
    mid = _expert_gate_up(lw, lambda qt: qmatmul_grouped(xs, qt, offsets, w8))
    y = qmatmul_grouped(mid, lw["ffn_down_exps"], offsets, w8)  # (R*K, D), sorted order
    back = torch.empty_like(order).scatter_(0, order, torch.arange(R * K, device=h.device))
    y = y.index_select(0, back).reshape(R, K, -1) * topw.to(h.dtype)[..., None]
    out = y[:, 0]
    for j in range(1, K):
        out = out + y[:, j]
    return out


def _expert_stacks(lw: dict) -> list[QTensor]:
    return [lw[n] for n in ("wgu_exps", "ffn_gate_exps", "ffn_up_exps", "ffn_down_exps")
            if n in lw]


def moe_ffn_plain(lw: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Plain version of moe_ffn, for any weight kind: every expert computes
    every row through a dense product (ops/matmul.py's dense_matmul, looked
    up there at each call) and the results mix by routing weight, 0 for an
    unselected expert (the JAX package's _moe_all_experts)."""
    h = x.reshape(-1, x.shape[-1])
    topi, topw = moe_route(lw, h, cfg)
    route = torch.zeros(h.shape[0], cfg.n_experts, dtype=torch.float32, device=h.device)
    route.scatter_(1, topi, topw)
    mid = _expert_gate_up(lw, lambda qt: ops_matmul.dense_matmul(h, qt))
    y = ops_matmul.dense_matmul(mid, lw["ffn_down_exps"]) * route.t().to(h.dtype)[..., None]
    out = y[0]
    for e in range(1, cfg.n_experts):
        out = out + y[e]
    return out.reshape(x.shape)


def moe_ffn(lw: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The Mixtral FFN on x (..., D): softmax over the top-k of the router's
    logits, each selected expert down(silu(gate(x)) * up(x)), weighted after
    the down matmul in the compute dtype and summed there. Counterpart of
    crabml_tpu/models/forward.py::moe_ffn. Stacks of every kernel scheme
    take that scheme's kernels, each stack its own. Experts without kernel
    planes (F32 / F16 files) take the plain version, as such weights take
    torch.matmul everywhere else."""
    if not all(qt.kernel_layout for qt in _expert_stacks(lw)):
        return moe_ffn_plain(lw, x, cfg)
    h = x.reshape(-1, x.shape[-1])
    topi, topw = moe_route(lw, h, cfg)
    if h.shape[0] <= W4A8_MAX_ROWS:
        out = _moe_decode_rows(lw, h, topi, topw)
    else:
        out = _moe_grouped(lw, h, topi, topw, cfg)
    return out.reshape(x.shape)


def layer_body(lw: dict, x: torch.Tensor, cos, sin, cfg: ModelConfig, kv_io) -> torch.Tensor:
    """One transformer layer on x (B, T, D). Everything is common to the
    dense and the paged forwards except how k/v reach the cache and how
    attention reads them back: `kv_io(q, k, v)` gets the roped q (B, T, H,
    hd) and k, v (B, T, KV, hd), does its own writes and attention, and
    returns (B, T, H*hd)."""
    B, T, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qd, kvd = H * hd, KV * hd  # qd is the embedding width unless the head dim is decoupled
    eps = cfg.rms_norm_eps
    h = _norm(cfg, x, lw["attn_norm"], lw.get("attn_norm_b"))
    qkv = _project_qkv(lw, h)
    # q and k heads are adjacent in the fused output: one norm (qwen3), one rotation
    qk = qkv[..., : qd + kvd].reshape(B, T, H + KV, hd)
    if "qk_norm" in lw:
        qk = rms_norm(qk, lw["qk_norm"], eps)
    qk = rotate(qk, cos, sin, cfg.rope_mode)
    v = qkv[..., qd + kvd:].reshape(B, T, KV, hd)
    attn = kv_io(qk[:, :, :H], qk[:, :, H:], v)
    attn_out = qmatmul(attn.to(x.dtype), lw["wo"])
    if "bo" in lw:
        attn_out = attn_out + lw["bo"]
    if cfg.post_norms:  # gemma2: the block's output is normed before the residual add
        attn_out = rms_norm(attn_out, lw["post_attn_norm"], eps)
    if cfg.parallel_residual:  # phi2: the FFN reads the attention's normed input
        return x + attn_out + _ffn(lw, h, cfg)
    x = x + attn_out
    h = rms_norm(x, lw["ffn_norm"], eps)
    if cfg.n_experts:
        return x + moe_ffn(lw, h, cfg)
    down = _ffn(lw, h, cfg)
    if cfg.post_norms:
        down = rms_norm(down, lw["post_ffn_norm"], eps)
    return x + down


def rope_tables(weights: dict, positions: torch.Tensor, cfg: ModelConfig):
    """cos, sin of `positions` (B, T) for every layer of a step: the
    frequencies kept with the weights ("rope_inv_freq", models.weights), the
    positions times 1/factor under linear scaling, and YaRN's mscale on both."""
    return rope_angles(positions, weights["rope_inv_freq"], cfg.rope_pos_scale, cfg.rope_mscale)


def final_logits(weights: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm (phi2: LayerNorm with its bias), lm_head (phi2: plus its
    bias, in the compute dtype, as the JAX package adds it before the cast),
    float32 logits; capped as cap * tanh(l / cap) where the model has a
    final softcap (gemma2). The division is by a tensor: on CUDA a division
    by a Python scalar becomes a multiply by its reciprocal, which rounds
    otherwise than the JAX package's division."""
    x = _norm(cfg, x, weights["final_norm"], weights.get("final_norm_b"))
    logits = qmatmul(x, weights["output"])
    if "output_b" in weights:
        logits = logits + weights["output_b"]
    logits = logits.float()
    if cfg.final_logit_softcap:
        cap = logits.new_full((), cfg.final_logit_softcap)
        logits = cap * torch.tanh(logits / cap)
    return logits


def quantize_new(k: torch.Tensor, v: torch.Tensor, dtype):
    """The step's k, v in the cache's dtype: (k, v, k_scale, v_scale), the
    scales None for a float cache."""
    if dtype == torch.int8:
        kq, ks = q8_vec(k)
        vq, vs = q8_vec(v)
        return kq, vq, ks, vs
    return k.to(dtype), v.to(dtype), None, None


def _write_kv(cache: KVCache, l: int, rows, cols, kq, vq, ks, vs):
    """The step's k/v (B, T, KV, hd) into layer l at (b, :, cols[b, t])."""
    cache.k[l][rows, :, cols] = kq
    cache.v[l][rows, :, cols] = vq
    if ks is not None:
        cache.k_scale[l][rows, :, cols] = ks
        cache.v_scale[l][rows, :, cols] = vs


def _live(scale, n_keys: int):
    """The first n_keys rows of an int8 cache's scales; None for a float cache."""
    return None if scale is None else scale[:, :, :n_keys]


def _layer_cache(cache: KVCache, l: int):
    """Layer l's k, v and (int8) scales, the scales None for a float cache."""
    if cache.quantized:
        return cache.k[l], cache.v[l], cache.k_scale[l], cache.v_scale[l]
    return cache.k[l], cache.v[l], None, None


def decode_step(weights: dict, cache: KVCache, tokens: torch.Tensor, pos: torch.Tensor,
                cfg: ModelConfig, compute_dtype=torch.float32) -> torch.Tensor:
    """One decode step: tokens (B, 1) and pos (B,) int32, both on the weights'
    device, pos[b] the keys sequence b holds. Writes the step's k/v at pos[b]
    in place -> logits (B, V) float32. The caller checks pos[b] <
    cache.seq_len on the host; nothing here reads the device."""
    B = tokens.shape[0]
    dev = tokens.device
    positions = pos[:, None]
    cos, sin = rope_tables(weights, positions, cfg)
    rows, cols = torch.arange(B, device=dev)[:, None], positions.long()
    fused = decode_eligible(1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    softcap = cfg.attn_logit_softcap
    kv_dtype = cache.k.dtype

    x = embed(weights, tokens, cfg, compute_dtype)
    for l, lw in enumerate(weights["layers"]):
        window = layer_window(cfg, l)

        def kv_io(q, k, v):
            kq, vq, ks, vs = quantize_new(k, v, kv_dtype)
            if fused:
                tr = [None if a is None else a.transpose(1, 2) for a in (kq, vq, ks, vs)]
                attn = decode_attention_fused(
                    q, cache.k, cache.v, l, pos, cfg.attn_scale, tr[0], tr[1],
                    cache.k_scale, cache.v_scale, tr[2], tr[3], softcap, window)
                _write_kv(cache, l, rows, cols, kq, vq, ks, vs)
                return attn
            # a head layout the decode kernel does not take: the flash kernel
            # over the whole cache, masked by pos (no live length on the host)
            _write_kv(cache, l, rows, cols, kq, vq, ks, vs)
            k_l, v_l, ks_l, vs_l = _layer_cache(cache, l)
            return flash_attention(q, dequantize_like(k_l, ks_l, q.dtype),
                                   dequantize_like(v_l, vs_l, q.dtype), pos, cfg.attn_scale,
                                   softcap, window)

        x = layer_body(lw, x, cos, sin, cfg, kv_io)
    return final_logits(weights, x, cfg)[:, 0]


def verify_step(weights: dict, cache: KVCache, tokens: torch.Tensor, pos: torch.Tensor,
                cfg: ModelConfig, compute_dtype=torch.float32) -> torch.Tensor:
    """T <= MAX_T tokens of B sequences: tokens (B, T) and pos (B,) int32, both
    on the weights' device, pos[b] the keys sequence b holds. Writes the
    tokens' k/v at pos[b] .. pos[b] + T - 1 in place and attends each row
    over the cache up to its own position -> logits (B, T, V) float32. The
    caller checks pos[b] + T <= cache.seq_len on the host; nothing here reads
    the device. Counterpart of the JAX package's forward at T = K + 1 on its
    decode kernel (crabml_tpu/models/forward.py:526-536, 644-651)."""
    B, T = tokens.shape
    dev = tokens.device
    positions = pos[:, None] + torch.arange(T, device=dev, dtype=torch.int32)[None]
    cos, sin = rope_tables(weights, positions, cfg)
    use_decode = decode_eligible(T, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    softcap = cfg.attn_logit_softcap
    rows, cols = torch.arange(B, device=dev)[:, None], positions.long()
    kv_dtype = cache.k.dtype

    x = embed(weights, tokens, cfg, compute_dtype)
    for l, lw in enumerate(weights["layers"]):
        k_l, v_l, ks_l, vs_l = _layer_cache(cache, l)
        window = layer_window(cfg, l)

        def kv_io(q, k, v):
            _write_kv(cache, l, rows, cols, *quantize_new(k, v, kv_dtype))
            if use_decode:
                return decode_attention(q, k_l, v_l, pos, cfg.attn_scale, ks_l, vs_l,
                                        softcap, window)
            # a head dim the decode kernels do not take: the flash kernel over
            # the whole cache, masked by pos (no live length on the host)
            return flash_attention(q, dequantize_like(k_l, ks_l, q.dtype),
                                   dequantize_like(v_l, vs_l, q.dtype), pos, cfg.attn_scale,
                                   softcap, window)

        x = layer_body(lw, x, cos, sin, cfg, kv_io)
    return final_logits(weights, x, cfg)


def forward(weights: dict, cache: KVCache, tokens: torch.Tensor, pos: torch.Tensor,
            cfg: ModelConfig, compute_dtype=torch.float32) -> torch.Tensor:
    """tokens (B, T) on the weights' device; pos (B,) int on the CPU: valid
    cache length per sequence. Writes the new k/v into `cache` in place and
    returns logits (B, T, vocab) float32.

    One token (T = 1) is a `decode_step`, a chunk the decode kernels take a
    `verify_step`; a longer one is written first and attended over the live
    view of the cache with a causal bound per row through the flash kernel."""
    B, T = tokens.shape
    starts = [int(p) for p in pos]
    if max(starts) + T > cache.seq_len:
        raise CacheError(f"pos {max(starts)} + {T} tokens overruns the cache ({cache.seq_len})")
    dev = tokens.device
    pos_dev = pos.to(device=dev, dtype=torch.int32)
    if T == 1:
        return decode_step(weights, cache, tokens, pos_dev, cfg, compute_dtype)[:, None]
    if decode_eligible(T, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim):
        return verify_step(weights, cache, tokens, pos_dev, cfg, compute_dtype)
    positions = pos_dev[:, None] + torch.arange(T, device=dev, dtype=torch.int32)[None]
    cos, sin = rope_tables(weights, positions, cfg)
    softcap = cfg.attn_logit_softcap
    rows, cols = torch.arange(B, device=dev)[:, None], positions.long()
    n_keys = max(starts) + T
    kv_dtype = cache.k.dtype

    x = embed(weights, tokens, cfg, compute_dtype)
    for l, lw in enumerate(weights["layers"]):
        k_l, v_l, ks_l, vs_l = _layer_cache(cache, l)
        window = layer_window(cfg, l)

        def kv_io(q, k, v):
            _write_kv(cache, l, rows, cols, *quantize_new(k, v, kv_dtype))
            if cache.quantized or kv_dtype != q.dtype:  # convert only the live view
                return flash_attention(
                    q, dequantize_like(k_l[:, :, :n_keys], _live(ks_l, n_keys), q.dtype),
                    dequantize_like(v_l[:, :, :n_keys], _live(vs_l, n_keys), q.dtype),
                    pos_dev, cfg.attn_scale, softcap, window)
            return flash_attention(q, k_l, v_l, pos_dev, cfg.attn_scale, softcap, window)

        x = layer_body(lw, x, cos, sin, cfg, kv_io)
    return final_logits(weights, x, cfg)

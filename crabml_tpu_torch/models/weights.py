"""GGUF -> torch weights for llama (dense, with a Mixtral mixture of experts,
or Llama-3.1's rope divisors), qwen2, qwen3, gemma, gemma2, phi3 and phi2,
and weights carried over from the JAX package.

Counterpart of crabml_tpu/models/weights.py. The port keeps per-layer dicts
of tensors (no layer stacking: the forward loops over layers in Python):

    {"token_embed": QTensor (canonical planes, gathered per token),
     "final_norm": (D,) f32, "output": QTensor (the lm_head; a tied
     embedding gets its own copy in kernel layout),
     "layers": [{"attn_norm", "ffn_norm": (D,) f32,
                 "wqkv", "wo", "wgu", "ffn_down": QTensor}, ...]}

A gemma2 layer also holds "post_attn_norm" and "post_ffn_norm" (D,) f32; its
q projection is n_heads * head_dim wide (4096 rows of a 3584 embedding in
Gemma-2-9B), and it has no output.weight: the lm_head is the embedding. gemma
is tied the same way, without post-norms, softcaps or window. A qwen2 layer
holds its q, k and v biases as one "bqkv" (q rows + 2 kv rows,) in the
compute dtype, fused whether or not the matrices fuse (the add is per
element); a qwen3 layer its per-head q and k RMS weights as one "qk_norm"
(n_heads + n_kv_heads, head_dim) f32, the q weight on the q heads' rows and
the k weight on the kv heads', so that one norm serves the fused q|k.

A phi3 file holds q|k|v as one `attn_qkv.weight` (rows [q | k | v]) and
gate|up as one `ffn_up.weight` (rows [gate | up]): they are the port's "wqkv"
and "wgu" as they stand, so they load as one tensor each (the JAX package
splits them and fuses them again). A phi2 layer holds "wqkv" with its bias
"bqkv" (attn_qkv.bias), "wo" with "bo", a gateless "ffn_up" with "ffn_up_b"
and "ffn_down" with "ffn_down_b" (every bias in the compute dtype, as the JAX
package adds them), and "attn_norm" with its LayerNorm bias "attn_norm_b"
(f32); it has no ffn_norm (the FFN reads the attention's normed input). Its
weights dict adds "final_norm_b" (f32) and the lm_head's bias "output_b" in
the compute dtype.

"rope_inv_freq" (rope_dim/2,) f32 holds the rope frequencies divided by the
file's `rope_freqs.weight` (Llama-3.1) or by YaRN's divisors, synthesized at
load for a "yarn" file without that tensor, as the JAX package does
(ops.rope.scaled_inv_freq); the forward reads them from the device.

A mixture-of-experts layer holds, in place of "wgu" and "ffn_down", the router
"ffn_gate_inp" (E, D) in the compute dtype (the JAX forward casts it down
before the router product) and the stacked experts "wgu_exps" (E, 2*HD, D)
and "ffn_down_exps" (E, D, HD).

Q4_K, Q5_K, Q6_K, Q8_0, Q4_0, Q3_K, Q2_K, Q5_0, Q4_1, Q5_1 and Q8_1 matmul
weights take the kernel planes of quant/qtensor.py (Q4_1's, Q5_1's and
Q8_1's are Q4_K's, Q5_K's and Q8_0's, each weight keeping its own kind),
with folded scale planes in the compute dtype's width (bfloat16 scales under
bfloat16 compute, as the JAX Runner does; float32 keeps them exact; Q3_K and
Q2_K keep ggml's scale bytes and float32 d, exact either way). q|k|v and
gate|up fuse at load along the output axis, so a layer issues one matmul per
group where the group's tensors share one kind; in llama.cpp's mixed files
(_K_M, Q2_K; an imatrix Q4_0 file's Q4_1 ffn_down fuses with nothing) a
layer whose attn_v is in another type than attn_q keeps q, k and v apart, so
the layers of one file need not hold the same names. A mixture of experts
takes experts of any of these kinds (or F32 / F16), each stack in its own:
gate|up fuse expert by expert where both stacks share a kind, and down may
differ from them (llama.cpp's Q4_K_M Mixtral keeps ffn_down_exps in Q6_K in
its use_more_bits layers), so each stack takes its own kind's kernels.
`augment_w8_weights` attaches the W8 prefill planes within a byte budget.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import UnsupportedError
from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFFile
from ..quant.codecs import dequantize
from ..ops.cuda.gemm_quant import W8_KSC, augment_w8, w8_eligible
from ..ops.rope import scaled_inv_freq, yarn_freq_factors
from ..quant.qtensor import QTensor, cat_rows, to_kernel_layout, to_planar
from .config import ModelConfig

_LAYER_TENSORS = {  # port name -> GGUF tensor name pattern
    "wq": "blk.{}.attn_q.weight",
    "wk": "blk.{}.attn_k.weight",
    "wv": "blk.{}.attn_v.weight",
    "wo": "blk.{}.attn_output.weight",
}
_DENSE_FFN = {
    "ffn_gate": "blk.{}.ffn_gate.weight",
    "ffn_up": "blk.{}.ffn_up.weight",
    "ffn_down": "blk.{}.ffn_down.weight",
}
_MOE_FFN = {  # GGUF 3-D tensors (E, m, k)
    "ffn_gate_exps": "blk.{}.ffn_gate_exps.weight",
    "ffn_up_exps": "blk.{}.ffn_up_exps.weight",
    "ffn_down_exps": "blk.{}.ffn_down_exps.weight",
}
_ROUTER = "ffn_gate_inp"
_ROUTER_TENSOR = "blk.{}.ffn_gate_inp.weight"


_PHI3 = {"wqkv": "blk.{}.attn_qkv.weight", "wo": "blk.{}.attn_output.weight",
         "wgu": "blk.{}.ffn_up.weight", "ffn_down": "blk.{}.ffn_down.weight"}
_PHI2 = {"wqkv": "blk.{}.attn_qkv.weight", "wo": "blk.{}.attn_output.weight",
         "ffn_up": "blk.{}.ffn_up.weight", "ffn_down": "blk.{}.ffn_down.weight"}
# phi2's biases beside bqkv, added in the compute dtype
_PHI2_BIASES = {"bo": "blk.{}.attn_output.bias", "ffn_up_b": "blk.{}.ffn_up.bias",
                "ffn_down_b": "blk.{}.ffn_down.bias"}


def _layer_tensors(cfg: ModelConfig) -> dict[str, str]:
    if cfg.architecture == "phi3":
        return _PHI3
    if cfg.architecture == "phi2":
        return _PHI2
    return {**_LAYER_TENSORS, **(_MOE_FFN if cfg.n_experts else _DENSE_FFN)}
_LAYER_NORMS = {"attn_norm": "blk.{}.attn_norm.weight", "ffn_norm": "blk.{}.ffn_norm.weight"}
_PHI2_NORMS = {"attn_norm": "blk.{}.attn_norm.weight", "attn_norm_b": "blk.{}.attn_norm.bias"}
_POST_NORMS = {"post_attn_norm": "blk.{}.post_attention_norm.weight",  # gemma2
               "post_ffn_norm": "blk.{}.post_ffw_norm.weight"}
_QKV_BIASES = ("blk.{}.attn_q.bias", "blk.{}.attn_k.bias", "blk.{}.attn_v.bias")  # qwen2
_FUSED_QKV_BIAS = ("blk.{}.attn_qkv.bias",)  # phi2
_QK_NORMS = ("blk.{}.attn_q_norm.weight", "blk.{}.attn_k_norm.weight")  # qwen3
_ARCHITECTURES = ("llama", "qwen2", "qwen3", "gemma", "gemma2", "phi3", "phi2")


def _layer_norms(cfg: ModelConfig) -> dict[str, str]:
    if cfg.full_layer_norm:
        return _PHI2_NORMS
    return {**_LAYER_NORMS, **(_POST_NORMS if cfg.post_norms else {})}


def check_supported(cfg: ModelConfig):
    """The port runs llama (dense or with a Mixtral mixture of experts:
    softmax over the top-k of n_experts SiLU-gated experts), qwen2 (q, k and
    v biases), qwen3 (per-head q and k norms), gemma and gemma2 (softcaps, a
    sliding window on even layers, post-norms), each with a head dim that
    may be decoupled from the embedding width and any rope scaling a GGUF
    names (linear, YaRN, or Llama-3.1's rope_freqs tensor), phi3 (fused
    q|k|v and gate|up) and phi2 (LayerNorm with biases, the parallel
    residual, a gateless GELU FFN, biases on every matmul, a partial rotary);
    any other architecture raises."""
    if cfg.architecture not in _ARCHITECTURES:
        raise UnsupportedError(
            f"not ported yet: architecture {cfg.architecture!r} (the port runs "
            + ", ".join(_ARCHITECTURES) + ")")


def _attn_extras(heads: tuple[int, int], biases: list[torch.Tensor] | None,
                 qk_norms: list[torch.Tensor] | None, compute_dtype) -> dict:
    """qwen2's q, k and v biases (or phi2's one attn_qkv.bias) as one "bqkv"
    in the compute dtype (the JAX package adds them in it), and qwen3's q and
    k norm weights (head_dim,)
    as one "qk_norm" (n_heads + n_kv_heads, head_dim) f32; `heads` =
    (n_heads, n_kv_heads)."""
    out = {}
    if biases is not None:
        out["bqkv"] = torch.cat(biases).to(compute_dtype)
    if qk_norms is not None:
        qn, kn = (w.float().reshape(1, -1) for w in qk_norms)
        out["qk_norm"] = torch.cat([qn.expand(heads[0], -1), kn.expand(heads[1], -1)])
    return out


def _rope_inv_freq(cfg: ModelConfig, rope_freqs: torch.Tensor | None, device) -> torch.Tensor:
    """The model's rope frequencies: divided by the file's rope_freqs, or by
    YaRN's divisors where a "yarn" file has none (as
    crabml_tpu/models/weights.py synthesizes them at load)."""
    if rope_freqs is None and cfg.rope_scaling_type == "yarn":
        rope_freqs = torch.from_numpy(yarn_freq_factors(
            cfg.effective_rope_dim, cfg.rope_base, cfg.rope_scaling_factor,
            cfg.rope_scaling_orig_ctx or cfg.seq_len))
    return scaled_inv_freq(cfg.effective_rope_dim, cfg.rope_base, rope_freqs, device)


def _fuse(parts: list[QTensor]) -> QTensor | None:
    if len({q.kind for q in parts}) != 1 or len({frozenset(q.planes) for q in parts}) != 1:
        return None  # mixed kinds keep separate matmuls
    return cat_rows(parts)


def _layer(mats: dict[str, QTensor], others: dict[str, torch.Tensor], scale_dtype) -> dict:
    """Canonical per-layer planes -> kernel layout, with q|k|v and gate|up
    fused where the layer holds them apart (the experts' gate|up expert by
    expert); a file's own fused tensors (phi's "wqkv", phi3's "wgu") and
    phi2's gateless "ffn_up" pass as they are. `others`: the norms, biases
    and, for a mixture of experts, the router."""
    moe = "ffn_down_exps" in mats
    mats = {n: to_kernel_layout(q, scale_dtype) for n, q in mats.items()}
    out = dict(others)
    groups = ((("wq", "wk", "wv"), "wqkv"),
              (("ffn_gate_exps", "ffn_up_exps"), "wgu_exps") if moe
              else (("ffn_gate", "ffn_up"), "wgu"))
    grouped = set()
    for group, fused in groups:
        if not all(n in mats for n in group):
            continue
        grouped.update(group)
        f = _fuse([mats[n] for n in group])
        if f is not None:
            out[fused] = f
        else:
            out.update({n: mats[n] for n in group})
    out.update({n: q for n, q in mats.items() if n not in grouped})
    return out


def _scale_dtype(compute_dtype):
    return torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32


def w8_plane_bytes(qt: QTensor) -> int:
    """Device bytes augment_w8 would add to this tensor: one int8 per weight
    and one float32 scale per (row, W8_KSC-chunk)."""
    n = 1
    for d in qt.shape:
        n *= d
    return int(n * (1 + 4 / W8_KSC))


def augment_w8_weights(weights: dict, budget_bytes: int | None = None) -> dict:
    """Attach the W8 prefill planes (ops.cuda.gemm_quant.augment_w8) to the
    eligible layer matmuls and the lm_head; `token_embed` stays as it is (it
    is gathered, not multiplied). Costs 8 bits a weight of device memory.

    `budget_bytes` caps what is added: tensors augment largest first until
    the budget runs out, and the rest prefill through the Q4_K dequant
    kernel, since the matmul dispatch keys on each tensor's planes. A tensor
    name counts with all the layers that hold it, as the JAX package's
    layer-stacked tensors do: either every layer's "wgu" gains planes or
    none. None = all."""
    layers = [dict(lw) for lw in weights["layers"]]
    names = list(dict.fromkeys(n for lw in layers for n, v in lw.items()
                               if isinstance(v, QTensor) and w8_eligible(v)))
    cands = [(n, sum(w8_plane_bytes(lw[n]) for lw in layers if n in lw)) for n in names]
    if w8_eligible(weights["output"]):
        cands.append(("output", w8_plane_bytes(weights["output"])))
    cands.sort(key=lambda nc: -nc[1])  # stable: ties keep the layer dict's order
    out = dict(weights)
    spent = 0
    for name, cost in cands:
        if budget_bytes is not None and spent + cost > budget_bytes:
            continue  # keep trying smaller tensors
        spent += cost
        if name == "output":
            out["output"] = augment_w8(weights["output"])
        else:
            for lw in layers:
                if name in lw:
                    lw[name] = augment_w8(lw[name])
    out["layers"] = layers
    return out


def load_weights(gf: GGUFFile, cfg: ModelConfig, device="cpu",
                 compute_dtype=torch.float32) -> dict:
    """Read a GGUF of a ported family (a llama one dense, or Mixtral's experts
    as 3-D tensors and an F32 router) into port weights on `device`. Each
    tensor's packed bytes move to the device once and split into planes
    there."""
    check_supported(cfg)
    sdt = _scale_dtype(compute_dtype)

    def q(name):
        info = gf.get_tensor_info(name)
        if info is None:
            raise KeyError(f"tensor not found: {name}")
        return to_planar(info.typ, info.to_numpy(), info.shape, device)

    def dense(name):
        info = gf.get_tensor_info(name)
        if info is None:
            raise KeyError(f"tensor not found: {name}")
        a = dequantize(info.typ, info.to_numpy(), info.n_elems).reshape(info.shape)
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    qkv_biases = _FUSED_QKV_BIAS if cfg.fused_qkv else _QKV_BIASES
    layers = []
    for l in range(cfg.n_layers):
        mats = {n: q(f.format(l)) for n, f in _layer_tensors(cfg).items()}
        others = {n: dense(f.format(l)) for n, f in _layer_norms(cfg).items()}
        if cfg.n_experts:
            others[_ROUTER] = dense(_ROUTER_TENSOR.format(l)).to(compute_dtype)
        if cfg.ffn_bias:
            others.update({n: dense(f.format(l)).to(compute_dtype)
                           for n, f in _PHI2_BIASES.items()})
        others.update(_attn_extras(
            (cfg.n_heads, cfg.n_kv_heads),
            [dense(f.format(l)) for f in qkv_biases] if cfg.qkv_bias else None,
            [dense(f.format(l)) for f in _QK_NORMS] if cfg.qk_norm else None, compute_dtype))
        layers.append(_layer(mats, others, sdt))
    embed = q("token_embd.weight")
    out = q("output.weight") if "output.weight" in gf else embed
    rope_freqs = dense("rope_freqs.weight") if "rope_freqs.weight" in gf else None
    weights = {
        "token_embed": embed,
        "final_norm": dense("output_norm.weight"),
        "output": to_kernel_layout(out, sdt),
        "rope_inv_freq": _rope_inv_freq(cfg, rope_freqs, device),
        "layers": layers,
    }
    if "output_norm.bias" in gf:  # phi2's final LayerNorm
        weights["final_norm_b"] = dense("output_norm.bias")
    if "output.bias" in gf:  # phi2's lm_head
        weights["output_b"] = dense("output.bias").to(compute_dtype)
    return weights


def from_jax_weights(weights: dict, cfg: ModelConfig, device="cpu",
                     compute_dtype=torch.float32) -> dict:
    """Port weights from the JAX package's planar weight dict (what
    crabml_tpu.models.weights.load_weights(..., layout="planar") or
    crabml_tpu.models.synthetic.make_weights return, arrays as numpy).

    Each QTensor is read by attribute (.kind, .shape, .planes) without
    importing its class; layer-stacked planes split per layer. Every kind of
    the JAX package's planar layout whose planes the port reads carries
    across, dense and stacked: the canonical plane names and contents are
    the same (Q4_1's, Q5_0's, Q5_1's and Q8_1's too). The result
    computes from the same numbers in the port's own layout. qwen2's biases
    and qwen3's q and k norms carry across; `cfg` gives the rope frequencies,
    divided by the JAX weights' "rope_freqs" where they carry them. phi3's
    q, k, v and gate, up planes, which the JAX package splits at load, join
    again as "wqkv" and "wgu"; phi2's biases and its LayerNorm's carry
    across."""
    sdt = _scale_dtype(compute_dtype)

    def plane(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(device)

    def qt(jq, layer=None, experts=0) -> QTensor:
        if "dsub" in jq.planes:
            raise UnsupportedError("from_jax_weights takes planar (not TPU kernel) weights")
        shape = tuple(int(d) for d in (jq.shape[1:] if layer is not None else jq.shape))
        planes = {n: plane(p[layer] if layer is not None else p) for n, p in jq.planes.items()}
        if experts:  # the JAX package folds the experts into m: (E*m, k) -> (E, m, k)
            shape = (experts, shape[0] // experts, shape[1])
            planes = {n: p.reshape(*shape[:2], p.shape[-1]) for n, p in planes.items()}
        return QTensor(GGMLType(int(jq.kind)), shape, planes)

    lw = weights["layers"]
    L = lw["attn_norm"].shape[0]
    moe = _ROUTER in lw
    heads = None
    if "q_norm" in lw:  # the q and kv heads, from the q and k rows
        hd = lw["q_norm"].shape[-1]
        heads = (lw["wq"].shape[1] // hd, lw["wk"].shape[1] // hd)
    E = lw[_ROUTER].shape[1] if moe else 0
    layers = []
    for l in range(L):
        mats = {n: qt(lw[n], l) for n in _LAYER_TENSORS}
        mats.update({n: qt(lw[n], l, E) for n in (_MOE_FFN if moe else _DENSE_FFN) if n in lw})
        others = {n: plane(lw[n][l]).float()
                  for n in (*_LAYER_NORMS, *_PHI2_NORMS, *_POST_NORMS) if n in lw}
        others.update({n: plane(lw[n][l]).to(compute_dtype) for n in _PHI2_BIASES if n in lw})
        if moe:
            others[_ROUTER] = plane(lw[_ROUTER][l]).to(compute_dtype)
        others.update(_attn_extras(
            heads,
            [plane(lw[n][l]) for n in ("bq", "bk", "bv")] if "bq" in lw else None,
            [plane(lw[n][l]) for n in ("q_norm", "k_norm")] if "q_norm" in lw else None,
            compute_dtype))
        layers.append(_layer(mats, others, sdt))
    embed = qt(weights["token_embed"])
    out = weights.get("output")
    port = {
        "token_embed": embed,
        "final_norm": plane(weights["final_norm"]).float(),
        "output": to_kernel_layout(qt(out) if out is not None else embed, sdt),
        "layers": layers,
    }
    if weights.get("final_norm_b") is not None:
        port["final_norm_b"] = plane(weights["final_norm_b"]).float()
    if weights.get("output_b") is not None:
        port["output_b"] = plane(weights["output_b"]).to(compute_dtype)
    rope_freqs = weights.get("rope_freqs")
    port["rope_inv_freq"] = _rope_inv_freq(
        cfg, None if rope_freqs is None else plane(rope_freqs).float(), device)
    return port

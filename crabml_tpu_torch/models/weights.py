"""GGUF -> torch weights for llama, dense or with a Mixtral mixture of
experts, and weights carried over from the JAX package.

Counterpart of crabml_tpu/models/weights.py. The port keeps per-layer dicts
of tensors (no layer stacking: the forward loops over layers in Python):

    {"token_embed": QTensor (canonical planes, gathered per token),
     "final_norm": (D,) f32, "output": QTensor (the lm_head; a tied
     embedding gets its own copy in kernel layout),
     "layers": [{"attn_norm", "ffn_norm": (D,) f32,
                 "wqkv", "wo", "wgu", "ffn_down": QTensor}, ...]}

A mixture-of-experts layer holds, in place of "wgu" and "ffn_down", the router
"ffn_gate_inp" (E, D) in the compute dtype (the JAX forward casts it down
before the router product) and the stacked experts "wgu_exps" (E, 2*HD, D)
and "ffn_down_exps" (E, D, HD).

Q4_K matmul weights take the kernel planes of quant/qtensor.py, with scale
planes in the compute dtype's width (bfloat16 scales under bfloat16 compute,
as the JAX Runner does; float32 keeps them exact). q|k|v and gate|up fuse at
load along the output axis, so a layer issues one matmul per group.
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


def _layer_tensors(cfg: ModelConfig) -> dict[str, str]:
    return {**_LAYER_TENSORS, **(_MOE_FFN if cfg.n_experts else _DENSE_FFN)}
_LAYER_NORMS = {"attn_norm": "blk.{}.attn_norm.weight", "ffn_norm": "blk.{}.ffn_norm.weight"}


def check_supported(cfg: ModelConfig):
    """The port runs the llama architecture, dense or with a Mixtral mixture
    of experts (softmax over the top-k of n_experts SiLU-gated experts); every
    other feature raises."""
    unsupported = [
        name for name, on in (
            (f"architecture {cfg.architecture!r}", cfg.architecture != "llama"),
            (f"rope scaling {cfg.rope_scaling_type!r}", cfg.rope_scaling_type != "none"),
            ("attention logit softcap", bool(cfg.attn_logit_softcap)),
            ("final logit softcap", bool(cfg.final_logit_softcap)),
            ("sliding window", bool(cfg.sliding_window)),
            ("decoupled head dim", cfg.head_dim_override is not None),
        ) if on
    ]
    if unsupported:
        raise UnsupportedError(
            "not ported yet: " + ", ".join(unsupported)
            + " (the port runs llama-architecture models, dense or mixture of experts)")


def _fuse(parts: list[QTensor]) -> QTensor | None:
    if len({q.kind for q in parts}) != 1 or len({frozenset(q.planes) for q in parts}) != 1:
        return None  # mixed kinds keep separate matmuls
    return cat_rows(parts)


def _layer(mats: dict[str, QTensor], others: dict[str, torch.Tensor], scale_dtype) -> dict:
    """Canonical per-layer planes -> kernel layout, with q|k|v and gate|up
    fused (the experts' gate|up expert by expert). `others`: the norms and,
    for a mixture of experts, the router."""
    mats = {n: to_kernel_layout(q, scale_dtype) for n, q in mats.items()}
    out = dict(others)
    moe = "ffn_down_exps" in mats
    groups = ((("wq", "wk", "wv"), "wqkv"),
              (("ffn_gate_exps", "ffn_up_exps"), "wgu_exps") if moe
              else (("ffn_gate", "ffn_up"), "wgu"))
    for group, fused in groups:
        f = _fuse([mats[n] for n in group])
        if f is not None:
            out[fused] = f
        else:
            out.update({n: mats[n] for n in group})
    for n in ("wo", "ffn_down_exps" if moe else "ffn_down"):
        out[n] = mats[n]
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
    name counts with all its layers, as the JAX package's layer-stacked
    tensors do: either every layer's "wgu" gains planes or none. None = all."""
    layers = [dict(lw) for lw in weights["layers"]]
    names = [n for n, v in layers[0].items() if isinstance(v, QTensor) and w8_eligible(v)]
    cands = [(n, sum(w8_plane_bytes(lw[n]) for lw in layers)) for n in names]
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
                lw[name] = augment_w8(lw[name])
    out["layers"] = layers
    return out


def load_weights(gf: GGUFFile, cfg: ModelConfig, device="cpu",
                 compute_dtype=torch.float32) -> dict:
    """Read a llama GGUF (dense, or Mixtral's experts as 3-D tensors and an
    F32 router) into port weights on `device`. Each tensor's packed bytes
    move to the device once and split into planes there."""
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

    layers = []
    for l in range(cfg.n_layers):
        mats = {n: q(f.format(l)) for n, f in _layer_tensors(cfg).items()}
        others = {n: dense(f.format(l)) for n, f in _LAYER_NORMS.items()}
        if cfg.n_experts:
            others[_ROUTER] = dense(_ROUTER_TENSOR.format(l)).to(compute_dtype)
        layers.append(_layer(mats, others, sdt))
    embed = q("token_embd.weight")
    out = q("output.weight") if "output.weight" in gf else embed
    return {
        "token_embed": embed,
        "final_norm": dense("output_norm.weight"),
        "output": to_kernel_layout(out, sdt),
        "layers": layers,
    }


def from_jax_weights(weights: dict, device="cpu", compute_dtype=torch.float32) -> dict:
    """Port weights from the JAX package's planar weight dict (what
    crabml_tpu.models.weights.load_weights(..., layout="planar") or
    crabml_tpu.models.synthetic.make_weights return, arrays as numpy).

    Each QTensor is read by attribute (.kind, .shape, .planes) without
    importing its class; layer-stacked planes split per layer. The result
    computes from the same numbers in the port's own layout."""
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
    E = lw[_ROUTER].shape[1] if moe else 0
    layers = []
    for l in range(L):
        mats = {n: qt(lw[n], l) for n in _LAYER_TENSORS}
        mats.update({n: qt(lw[n], l, E) for n in (_MOE_FFN if moe else _DENSE_FFN)})
        others = {n: plane(lw[n][l]).float() for n in _LAYER_NORMS}
        if moe:
            others[_ROUTER] = plane(lw[_ROUTER][l]).to(compute_dtype)
        layers.append(_layer(mats, others, sdt))
    embed = qt(weights["token_embed"])
    out = weights.get("output")
    return {
        "token_embed": embed,
        "final_norm": plane(weights["final_norm"]).float(),
        "output": to_kernel_layout(qt(out) if out is not None else embed, sdt),
        "layers": layers,
    }

"""Model configuration from GGUF metadata.

Covers the four architectures of the reference (llama, gemma, qwen2, phi2;
crabml-llama2/src/model.rs:553-633) as one config with per-arch feature
flags, so the forward pass is a single parameterized function instead of four
near-copies.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


ARCH_FEATURES = {
    # rope mode, activation, qkv bias, parallel residual, norm bias,
    # embedding scale, tied output fallback
    "llama": dict(rope_mode="llama", act="silu"),
    "gemma": dict(rope_mode="neox", act="gelu", scale_embedding=True),
    "qwen2": dict(rope_mode="neox", act="silu", qkv_bias=True),
    "phi2": dict(
        rope_mode="neox",
        act="gelu",
        fused_qkv=True,
        qkv_bias=True,
        parallel_residual=True,
        norm_bias=True,
        full_layer_norm=True,
        attn_out_bias=True,
        ffn_bias=True,
        no_ffn_gate=True,
    ),
    # beyond the reference's four (it stops at phi2; these are the common
    # GGUF families in the wild the reference cannot load):
    # qwen3: qk RMS norms per head, decoupled head_dim, no qkv bias
    "qwen3": dict(rope_mode="neox", act="silu", qk_norm=True),
    # phi3: fused qkv (no bias) + fused gate|up in ffn_up, neox rope,
    # SiLU-gated FFN, rms norms — llama.cpp build_phi3 semantics
    "phi3": dict(rope_mode="neox", act="silu", fused_qkv=True,
                 fused_gate_up=True),
    # gemma2: post-attention/post-ffn norms, logit softcapping, sliding
    # window on alternating layers, gelu-tanh
    "gemma2": dict(
        rope_mode="neox",
        act="gelu",
        scale_embedding=True,
        post_norms=True,
        alternating_window=True,
    ),
}


@dataclass(frozen=True)
class ModelConfig:
    architecture: str
    model_name: str = ""
    chat_template: str = ""
    embedding_dim: int = 0
    hidden_dim: int = 0
    n_layers: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    vocab_size: int = 0
    seq_len: int = 0
    rms_norm_eps: float = 1e-5
    rope_dim: int | None = None
    rope_base: float = 10000.0
    head_dim_override: int | None = None  # set when heads are TP-localized

    # arch feature flags
    rope_mode: str = "llama"
    act: str = "silu"
    qkv_bias: bool = False
    fused_qkv: bool = False
    fused_gate_up: bool = False  # phi3: ffn_up holds [gate|up] rows
    parallel_residual: bool = False
    norm_bias: bool = False
    # true mean-subtracting LayerNorm instead of RMS (phi2). The
    # reference rms-norms phi2 (llama2.rs:371-375) — deviation not
    # replicated (HF + llama.cpp both mean-subtract; ops/norm.py)
    full_layer_norm: bool = False
    attn_out_bias: bool = False
    ffn_bias: bool = False
    no_ffn_gate: bool = False
    scale_embedding: bool = False
    qk_norm: bool = False  # qwen3: per-head RMS norm on q/k before rope
    post_norms: bool = False  # gemma2: post-attention/post-ffn norms
    alternating_window: bool = False  # gemma2: sliding window on even layers
    # NOTE: the reference scales phi2's q by 1/sqrt(head_dim) twice
    # (llama2.rs:414 + llama2.rs:565) — we scale exactly once, matching
    # llama.cpp's build_phi2.

    # rope scaling (llama3.1 etc.): inv_freq /= per-frequency factors from
    # the rope_freqs.weight tensor; "linear" divides positions by `factor`;
    # "yarn" folds into per-frequency divisors at load (ops.rope) plus the
    # attention-magnitude mscale below
    rope_scaling_type: str = "none"  # none | linear | yarn
    rope_scaling_factor: float = 1.0
    rope_scaling_orig_ctx: int = 0  # yarn original_context_length
    rope_attn_factor: float = 1.0  # yarn attn_factor metadata
    # mixture-of-experts (mixtral: llama arch + expert metadata)
    n_experts: int = 0  # 0 = dense FFN
    n_experts_used: int = 2  # top-k routing
    # gemma2 softcaps (0 = off) + sliding window width
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    sliding_window: int = 0
    # attention query scale override; None = 1/sqrt(head_dim). gemma2-27b
    # scales by 1/sqrt(n_embd/n_head) (=1/sqrt(144)) while head_dim=128 —
    # llama.cpp special-cases the 27b the same way.
    query_scale: float | None = None

    @property
    def rope_mscale(self) -> float:
        if self.rope_scaling_type == "yarn":
            from ..ops.rope import yarn_mscale

            return yarn_mscale(self.rope_scaling_factor, self.rope_attn_factor)
        return 1.0

    @property
    def rope_pos_scale(self) -> float:
        """What positions multiply by before the angles: 1/factor under
        "linear" rope scaling, else 1."""
        if self.rope_scaling_type == "linear":
            return 1.0 / self.rope_scaling_factor
        return 1.0

    @property
    def attn_scale(self) -> float:
        if self.query_scale is not None:
            return self.query_scale
        return float(1.0 / (self.head_dim ** 0.5))

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.embedding_dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def effective_rope_dim(self) -> int:
        return self.rope_dim if self.rope_dim is not None else self.head_dim

    def with_overrides(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


def config_from_gguf(metadata) -> ModelConfig:
    arch = metadata.get_str("general.architecture")
    if arch not in ARCH_FEATURES:
        from ..errors import UnsupportedError

        raise UnsupportedError(f"unsupported architecture {arch!r}")
    p = arch  # metadata key prefix == architecture name (model.rs:556-562)

    eps_key = (
        f"{p}.attention.layer_norm_epsilon"
        if arch == "phi2"
        else f"{p}.attention.layer_norm_rms_epsilon"
    )
    tokens = metadata.get("tokenizer.ggml.tokens")
    rope_dim = metadata.get_int(f"{p}.rope.dimension_count")
    rope_base = metadata.get_float(f"{p}.rope.freq_base", 10000.0)

    extra = {}
    # decoupled per-head size (qwen3 etc.): {arch}.attention.key_length
    key_len = metadata.get_int(f"{p}.attention.key_length", 0)
    n_heads = metadata.get_int(f"{p}.attention.head_count")
    dim = metadata.get_int(f"{p}.embedding_length")
    if key_len and key_len != dim // n_heads:
        extra["head_dim_override"] = key_len
    # rope scaling (llama3.1 linear/rope_freqs; scaling.type absent = none)
    sc_type = metadata.get_str(f"{p}.rope.scaling.type", "")
    sc_factor = metadata.get_float(f"{p}.rope.scaling.factor", 0.0)
    if sc_type == "linear" and sc_factor:
        extra["rope_scaling_type"] = "linear"
        extra["rope_scaling_factor"] = sc_factor
    elif sc_type == "yarn" and sc_factor:
        extra["rope_scaling_type"] = "yarn"
        extra["rope_scaling_factor"] = sc_factor
        extra["rope_scaling_orig_ctx"] = metadata.get_int(
            f"{p}.rope.scaling.original_context_length", 0)
        extra["rope_attn_factor"] = metadata.get_float(
            f"{p}.rope.scaling.attn_factor", 1.0)
    # gemma2 softcaps + sliding window
    cap = metadata.get_float(f"{p}.attn_logit_softcapping", 0.0)
    if cap:
        extra["attn_logit_softcap"] = cap
    fcap = metadata.get_float(f"{p}.final_logit_softcapping", 0.0)
    if fcap:
        extra["final_logit_softcap"] = fcap
    win = metadata.get_int(f"{p}.attention.sliding_window", 0)
    if win:
        extra["sliding_window"] = win
    # gemma2-27b ONLY (identified by its 46 blocks, as llama.cpp does):
    # query scale follows n_embd/n_head, not the decoupled head_dim.
    # gemma2-2b/9b also decouple head_dim but keep 1/sqrt(head_dim).
    if arch == "gemma2" and metadata.get_int(f"{p}.block_count") == 46:
        extra["query_scale"] = float(1.0 / ((dim / n_heads) ** 0.5))
    # mixtral MoE: llama arch + expert counts
    n_exp = metadata.get_int(f"{p}.expert_count", 0)
    if n_exp:
        extra["n_experts"] = n_exp
        extra["n_experts_used"] = metadata.get_int(f"{p}.expert_used_count", 2)

    return ModelConfig(
        architecture=arch,
        model_name=metadata.get_str("general.name", ""),
        chat_template=metadata.get_str("tokenizer.chat_template", ""),
        embedding_dim=dim,
        hidden_dim=metadata.get_int(f"{p}.feed_forward_length"),
        n_layers=metadata.get_int(f"{p}.block_count"),
        n_heads=n_heads,
        n_kv_heads=metadata.get_int(f"{p}.attention.head_count_kv"),
        vocab_size=len(tokens) if tokens is not None else metadata.get_int(f"{p}.vocab_size", 0),
        seq_len=metadata.get_int(f"{p}.context_length"),
        rms_norm_eps=metadata.get_float(eps_key, 1e-5),
        rope_dim=rope_dim,
        rope_base=rope_base,
        **ARCH_FEATURES[arch],
        **extra,
    )

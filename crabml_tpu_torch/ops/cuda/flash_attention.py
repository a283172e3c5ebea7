"""Causal prefill attention over one layer of the KV cache.

Counterpart of crabml_tpu/ops/pallas/flash_attention.py::flash_attention,
whose kernel `_kernel` becomes csrc/flash_attention.cu (see its note for the
bound and design). Each sequence's first new token sits at cache offset
pos[b], and row t sees keys j <= pos[b] + t. On the card every attention of
more than 8 new tokens takes this kernel: the TPU's T*S >= 1.5M cutoff
(flash_attention.py:181) was tuned on a v5e and is not carried over. The
port prefills the exact prompt length, so ragged T and S are masked in the
kernel rather than padded to power-of-two buckets.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
# rows of a warpgroup (float32: of a block): 64 // G tokens x G q heads of one kv
# group, so at most 64 q heads a kv head; where G does not divide 64 the last
# 64 % G rows are padding (G = 7: 9 tokens, 63 live rows)
ROWS_PER_BLOCK = 64
# head dims the kernel takes: every multiple of 8 up to 256, on tiles
# 64, 128 or 256 wide (the lanes past the head dim zero)
# (the JAX kernel's rule, hd % 8 == 0, which goes on to 512)
HEAD_DIMS = tuple(range(8, 257, 8))
HEAD_DIM_RULE = "a multiple of 8 up to 256"

_P = ctypes.c_void_p
_I = ctypes.c_int


def check_card_attention(cfg, device, dtype=None) -> None:
    """Raise UnsupportedError, with the reason, when `device` is a card and
    the attention of `cfg` (a ModelConfig) in compute `dtype` is one its
    kernels do not take. Every prefill chunk of more than a few tokens, and
    every attention at a head dim the decode kernels do not take, goes to
    this kernel, which takes every head dim that is a multiple of 8 up to
    256 (HEAD_DIMS: stories260K's 8, the HF fixtures' 16, stories15M's
    48, phi2's 80, ...) and up to ROWS_PER_BLOCK q heads per
    kv head (any count that divides the q heads: Qwen2-7B's 28 over 4 is
    7); both take bfloat16 and float32 at each of their head dims, over a
    cache of either (or int8). On the CPU every shape runs on the plain
    versions. `check_card_model` calls it."""
    if torch.device(device).type != "cuda":
        return
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    reasons = []
    if hd not in HEAD_DIMS:
        reasons.append(f"head dim {hd} (the flash kernel takes {HEAD_DIM_RULE})")
    if dtype not in (None, torch.bfloat16, torch.float32):
        reasons.append(f"compute dtype {dtype} (the kernels take bfloat16 or float32)")
    if H % KV:
        reasons.append(f"{H} q heads over {KV} kv heads (the kv heads must divide the q heads)")
    elif H // KV > ROWS_PER_BLOCK:
        reasons.append(f"{H} q heads over {KV} kv heads (at most {ROWS_PER_BLOCK} q heads per "
                       "kv head)")
    _build.require(not reasons, "the card's attention kernels do not take this model: "
                   + "; ".join(reasons) + "; pass device='cpu' to run it on the CPU")


def check_card_model(cfg, device, dtype) -> None:
    """What the card refuses of a model before any weight is read, with the
    reason: its attention (`check_card_attention`). Every matmul form runs
    in bfloat16 and in float32, a mixture of experts' grouped forms included.
    The Runner and both engines call it; it never falls back to a plain
    version, to bfloat16 or to the CPU."""
    check_card_attention(cfg, device, dtype)


def flash_attention_plain(q, k_cache, v_cache, pos, scale: float, softcap: float = 0.0,
                          window: int = 0) -> torch.Tensor:
    """q (B, T, H, hd); k/v_cache (B, KV, S, hd) holding this call's tokens at
    pos[b]..pos[b]+T-1; pos (B,) -> (B, T, H*hd) in q's dtype, float32 math.

    The semantics of crabml_tpu/models/forward.py::attention: `softcap`
    caps the scores as cap*tanh(s/cap), and a sliding `window` > 0 lets
    token t see only the last `window` keys up to itself."""
    B, T, H, hd = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.float().reshape(B, T, KV, G, hd)
    s = torch.einsum("btkgh,bksh->bkgts", qg, k_cache.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    col = torch.arange(S, device=q.device)
    row = pos.to(q.device).long()[:, None] + torch.arange(T, device=q.device)[None]  # (B, T)
    live = col[None, None, :] <= row[:, :, None]
    if window:
        live = live & (col[None, None, :] > row[:, :, None] - window)
    s = torch.where(live[:, None, None], s, torch.full_like(s, NEG_INF))
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s) * live[:, None, None]
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # a row that sees no key gives 0
    out = torch.einsum("bkgts,bksh->btkgh", p, v_cache.float())
    return out.reshape(B, T, H * hd).to(q.dtype)


def flash_attention(q, k_cache, v_cache, pos, scale: float, softcap: float = 0.0,
                    window: int = 0) -> torch.Tensor:
    """Kernel wrapper; plain version for CPU tensors. `softcap` (0 = none)
    and `window` (0 = every earlier key) are launch arguments, so a model
    with alternating local and global layers passes them per call."""
    if not q.is_cuda:
        return flash_attention_plain(q, k_cache, v_cache, pos, scale, softcap, window)
    _build.require(softcap >= 0 and window >= 0,
                   f"flash_attention: softcap {softcap} and window {window} must not be negative")
    B, T, H, hd = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    _build.require(H % KV == 0 and H // KV <= ROWS_PER_BLOCK,
                   f"flash_attention: H={H} KV={KV} (KV must divide H, G at most "
                   f"{ROWS_PER_BLOCK})")
    _build.require(hd in HEAD_DIMS,
                   f"flash_attention: head_dim {hd} (the kernel takes {HEAD_DIM_RULE})")
    _build.require(q.dtype in (torch.bfloat16, torch.float32)
                   and k_cache.dtype == v_cache.dtype == q.dtype,
                   f"flash_attention: q {q.dtype}, cache {k_cache.dtype} "
                   "(bf16 or f32, one dtype)")
    _build.require(k_cache.shape == v_cache.shape == (B, KV, S, hd),
                   f"flash_attention: cache {tuple(k_cache.shape)} for q {tuple(q.shape)}")
    for t in (k_cache, v_cache):
        _build.require(t.is_contiguous() and t.device == q.device,
                       "flash_attention: cache must be contiguous on q's device")
    q = q.contiguous()
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lib, fn = _build.entry("flash_attention", "flash_attention", _I, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _I, _P)
    _build.launches["flash_attention"] += 1
    err = fn(0 if q.dtype == torch.bfloat16 else 1, q.data_ptr(), k_cache.data_ptr(),
             v_cache.data_ptr(), pos.data_ptr(), out.data_ptr(), B, KV, S, T, H // KV, hd,
             float(scale), float(softcap), int(window), _build.stream_ptr(q))
    _build.check(lib, err, "flash_attention")
    return out.reshape(B, T, H * hd)

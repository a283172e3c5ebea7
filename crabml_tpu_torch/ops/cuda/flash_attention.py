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
import functools
from dataclasses import dataclass

import torch

from . import _build
from .gemm_quant import tf32_split

NEG_INF = -1e30
# rows of a warpgroup: 64 // G tokens x G q heads of one kv
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


def _live_keys(pos, T: int, S: int, window: int, device) -> torch.Tensor:
    """(B, T, S) bool: key j is seen by row t of sequence b, j <= pos[b] + t
    and, with a sliding window, j > pos[b] + t - window."""
    col = torch.arange(S, device=device)
    row = pos.to(device).long()[:, None] + torch.arange(T, device=device)[None]  # (B, T)
    live = col[None, None, :] <= row[:, :, None]
    if window:
        live = live & (col[None, None, :] > row[:, :, None] - window)
    return live


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
    live = _live_keys(pos, T, S, window, q.device)
    s = torch.where(live[:, None, None], s, torch.full_like(s, NEG_INF))
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s) * live[:, None, None]
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # a row that sees no key gives 0
    out = torch.einsum("bkgts,bksh->btkgh", p, v_cache.float())
    return out.reshape(B, T, H * hd).to(q.dtype)


def tile_width(hd: int) -> int:
    """The row width of the kernel's tiles at head dim hd (csrc/flash_attention.cu's
    tile_width): 64 up to 64, 128 up to 128, else 256."""
    return 64 if hd <= 64 else 128 if hd <= 128 else 256


SMEM_LIMIT = 232448  # dynamic shared memory a block may have on the H100
H100_SMS = 132


@dataclass(frozen=True)
class FlashF32Plan:
    """The float32 kernel's launch at one shape (csrc/flash_attention.cu's
    F32Plan and launch_f32)."""
    tile_width: int  # HP: a tile row, in floats
    keys: int  # BC: keys a tile
    warpgroups: int  # of a block, 64 stacked rows each
    stages: int  # K / V tiles in shared memory
    smem_bytes: int
    rows_per_block: int
    tokens_per_block: int  # warpgroups x 64 // G
    grid: tuple  # (token blocks, KV, B)


def flash_f32_plan(hd: int, T: int = 1, G: int = 1, KV: int = 1, B: int = 1,
                   sms: int = H100_SMS) -> FlashF32Plan:
    """The float32 kernel's plan, from the shapes alone (and the card's SM
    count `sms`). Two warpgroups a block share each key tile, unless the
    tile width is 256 (one Q tile of 128 rows would not fit beside a stage)
    or one warpgroup a block puts the grid in one wave of `sms` blocks (the
    7B's 189-token chunk: 96 blocks of one warpgroup, not 48 of two; at its
    512-token chunks 128 of two, not 256 of one: measured on the H100, PERF.md).
    Shared memory: a Q tile of the block's rows (each row 4 runs of HP / 4 +
    8 floats, and 4 more), then per stage four BC x HP float32 parts (K hi, K
    lo which first holds V as it lands, V^T hi, V^T lo), two stages where they
    fit in SMEM_LIMIT, else one; 1,024 bytes of slack to align. BC is 64 keys
    up to a tile width of 128, 32 at 256."""
    hp = tile_width(hd)
    bq = ROWS_PER_BLOCK // G
    one_wave = -(-T // bq) * KV * B <= sms
    nwg = 1 if hp == 256 or one_wave else 2
    bc = 64 if hp <= 128 else 32
    q_bytes = nwg * 64 * (4 * (hp // 4 + 8) + 4) * 4
    stage = 4 * bc * hp * 4
    stages = 2 if q_bytes + 2 * stage + 1024 <= SMEM_LIMIT else 1
    tokens = nwg * bq
    return FlashF32Plan(tile_width=hp, keys=bc, warpgroups=nwg, stages=stages,
                        smem_bytes=q_bytes + stages * stage + 1024, rows_per_block=64 * nwg,
                        tokens_per_block=tokens, grid=(-(-T // tokens), KV, B))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def key_slot(j: int) -> int:
    """The K tile row of key j in the float32 kernel: key t + 4u of each group
    of 8 at row 2t + u, so that S's accumulator pair of thread quad t holds
    keys t and t + 4, the keys of a TF32 A fragment's k8 step."""
    return (j & ~7) | ((j & 3) << 1) | ((j >> 2) & 1)


def flash_attention_split_plain(q, k_cache, v_cache, pos, scale: float, softcap: float = 0.0,
                                window: int = 0) -> torch.Tensor:
    """The arithmetic of the float32 kernel on the CPU, for tests and
    chip_smoke.py: each product in three TF32 passes (gemm_quant.tf32_split's
    parts: A_lo B_hi + A_hi B_lo + A_hi B_hi, each TF32 product exact in
    float32, float32 sums), S = q k^T first, then P (exact softmax in float32,
    as flash_attention_plain's) split the same way against v, divided by the
    row sums of the unsplit P. The kernel's key order within a tile
    (`key_slot`) changes no sum. float32 q, k, v -> (B, T, H*hd) float32."""
    B, T, H, hd = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qh, ql = (x.reshape(B, T, KV, G, hd) for x in tf32_split(q))
    kh, kl = tf32_split(k_cache)
    vh, vl = tf32_split(v_cache)
    qk = "btkgh,bksh->bkgts"
    s = (torch.einsum(qk, ql, kh) + torch.einsum(qk, qh, kl)) + torch.einsum(qk, qh, kh)
    s = s * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    live = _live_keys(pos, T, S, window, q.device)
    s = torch.where(live[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * live[:, None, None]
    ph, pl = tf32_split(p)
    pv = "bkgts,bksh->btkgh"
    o = (torch.einsum(pv, pl, vh) + torch.einsum(pv, ph, vl)) + torch.einsum(pv, ph, vh)
    den = p.sum(dim=-1).clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]  # (B, T, KV, G, 1)
    return (o / den).reshape(B, T, H * hd)


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
    f32 = q.dtype == torch.float32
    wgs = flash_f32_plan(hd, T, H // KV, KV, B, _sms(q.device.index)).warpgroups if f32 else 2
    lib, fn = _build.entry("flash_attention", "flash_attention", _I, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _I, _I, _P)
    _build.launches["flash_attention"] += 1
    err = fn(int(f32), q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
             out.data_ptr(), B, KV, S, T, H // KV, hd, float(scale), float(softcap), int(window),
             wgs, _build.stream_ptr(q))
    _build.check(lib, err, "flash_attention")
    return out.reshape(B, T, H * hd)

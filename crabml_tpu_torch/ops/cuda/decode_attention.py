"""Decode attention (T <= 8 new tokens, any number of q heads per kv head) over
one layer of the dense KV cache.

Counterpart of crabml_tpu/ops/pallas/decode_attention.py::decode_attention
(kernel `_kernel`: the cache already holds the step's tokens) and
::decode_attention_fused (kernel `_kernel_fused`: the step's k/v arrive as a
separate block and the caller writes them into the cache afterwards). Both
become csrc/decode_attention.cu, the dense instantiation of
csrc/decode_core.cuh (see its note for the bound and design). The paged forms
are in paged_decode_attention.py and share the launcher below. `plan` is the
launch's shape, from the cache's capacity alone; `block_keys` mirrors which
keys (and which table column) each block of the grid reads.

q is bfloat16 or float32; the cache is bfloat16 or float32, in q's dtype or
the other, or int8 with one float32 scale per (token, kv head) in k_scale /
v_scale (B, KV, S, 1): the kernel computes in float32 when either is float32,
as the JAX kernel does, and writes q's dtype. The head dim is 80, 96, 128 or
256 (HEAD_DIMS) for every pair. At 80 and 96 (phi2, phi3) the kernel runs on
the 128 kernel's shared-memory tiles and the cache, q, the output and the
partials keep their own width. `softcap` caps the
scores as cap*tanh(s/cap) before masking; `local_window` > 0 lets a token see
only the last `local_window` keys up to itself, and keys before the window
are never read. The T * G query rows of a kv head (G q heads per kv head)
run in row tiles of ROW_TILE: one tile up to 16 rows, four at a verify step
of 8 tokens at G = 7 or 8 (csrc/decode_core.cuh's note says why).

On a CPU tensor each wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .flash_attention import flash_attention_plain

MAX_T = 8  # widest q this path takes per step (decode, short prefill chunks)
ROW_TILE = 16  # query rows (of T * q heads per kv head) a block of the kernel takes
HEAD_DIMS = (80, 96, 128, 256)  # head dims the kernel takes, in every dtype
# the stored types, as csrc/decode_core.cuh's `dispatch` numbers them
KV_TYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}
CHUNK = 128  # keys a block takes: one page of the paged pool

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def decode_eligible(T: int, H: int, KV: int, hd: int) -> bool:
    """Whether the decode kernels take a step of T new tokens: at most MAX_T
    tokens at any number of q heads per kv head, head dim 80, 96, 128 or 256
    (crabml_tpu/ops/pallas/decode_attention.py's rule, whose kernels take
    multiples of 128). Callers send every other attention to the flash
    kernel."""
    return T <= MAX_T and H % KV == 0 and hd in HEAD_DIMS


@dataclass(frozen=True)
class Plan:
    """Shape of one decode-attention launch. Block (kv * row_tiles + tile, b,
    c) of the grid takes keys c*CHUNK .. c*CHUNK+CHUNK-1 of sequence b for
    query rows tile*ROW_TILE .. +ROW_TILE-1 of kv head kv; `part_stats` and
    `part_acc` are the float32 partials of sequences with more than one live
    chunk, `tickets` the int32 counters that find each (b, kv, tile)'s last
    block."""
    grid: tuple[int, int, int]  # (KV * row_tiles, B, n_chunks)
    n_chunks: int
    row_tiles: int  # ceil(T*G / ROW_TILE)
    part_stats: tuple[int, ...]  # (B, KV*row_tiles, n_chunks, min(T*G, ROW_TILE)): row max; sum
    part_acc: tuple[int, ...]  # (B, KV*row_tiles, n_chunks, min(T*G, ROW_TILE), hd)
    tickets: int


def plan(B: int, KV: int, span: int, T: int, G: int, hd: int = 128) -> Plan:
    """The launch for B sequences of at most `span` keys each (the cache's
    capacity, plus T when the step's keys come in their own block). It reads
    nothing on the device, so the launch never waits for the card and a CUDA
    graph can capture it; blocks past a sequence's live keys exit at once."""
    n = max(1, -(-span // CHUNK))
    rt = -(-(T * G) // ROW_TILE)
    tr = min(T * G, ROW_TILE)
    return Plan(grid=(KV * rt, B, n), n_chunks=n, row_tiles=rt, part_stats=(B, KV * rt, n, tr),
                part_acc=(B, KV * rt, n, tr, hd), tickets=B * KV * rt)


def tile_rows(tile: int, T: int, G: int) -> range:
    """The query rows r = t*G + g of row tile `tile` of a step of T tokens."""
    return range(tile * ROW_TILE, min(tile * ROW_TILE + ROW_TILE, T * G))


def block_keys(c: int, pos: int, T: int, win: int, cap: int, fused: bool, t0: int = 0) -> dict:
    """What block c of a sequence at `pos` reads for a row tile whose earliest
    row is token t0 of the step, as csrc/decode_core.cuh's `keys_of` and
    `chunk_kernel` decide it (this is their mirror, for the tests): `cached`
    and `new` the key ranges [lo, hi) it loads from the cache and from the
    step's block, `column` the table column it follows (None: no table read),
    `live` whether it works, `zeros` whether it writes the zero output of a
    sequence with no key. `cap`: keys the cache holds at most."""
    n_keys = max(pos + T, 0)
    n_cache = min(min(max(pos, 0), n_keys) if fused else n_keys, cap)
    kend = min(n_keys, n_cache + T) if fused else n_cache
    first = min(max(pos + t0 + 1 - win, 0), kend) if win > 0 else 0
    c0, c1 = first // CHUNK, -(-kend // CHUNK)
    lo, hi = max(c * CHUNK, first), min(c * CHUNK + CHUNK, kend)
    live = c0 <= c < c1
    return {
        "live": live, "zeros": c1 <= c0 and c == 0,
        "cached": (lo, min(hi, n_cache)) if live else (0, 0),
        "new": (max(lo, n_cache), hi) if live and fused else (0, 0),
        "column": c if live and c * CHUNK < n_cache else None,
    }


_tickets: dict[torch.device, torch.Tensor] = {}
_retired_tickets: list[torch.Tensor] = []  # smaller buffers a captured graph may still use


def _ticket_buffer(n: int, device: torch.device) -> torch.Tensor:
    """Persistent int32 counters, zero between launches: the kernel's last
    block of each (b, kv, row tile) resets its own. The buffer is made outside any CUDA
    graph's capture (the eager warm-up step makes it) so that it never lives
    in a graph's memory pool; one that grows keeps the old one alive for the
    graphs captured with it."""
    buf = _tickets.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"decode attention: {n} ticket counters do not exist yet; "
                               "run the step once eagerly before capturing it")
        if buf is not None:
            _retired_tickets.append(buf)
        buf = _tickets[device] = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    return buf


def dequantize_kv(a: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
    """int8 payload (..., S, hd) times its scales (..., S, 1) in float32; a
    float cache passes through."""
    return a.float() if scale is None else a.float() * scale.reshape(*a.shape[:-1], 1)


def decode_attention_plain(q, k_cache, v_cache, pos, scale: float, k_scale=None, v_scale=None,
                           softcap: float = 0.0, local_window=None, k_new=None, v_new=None,
                           ks_new=None, vs_new=None) -> torch.Tensor:
    """Plain version of every dense form. q (B, T, H, hd); cache (B, KV, S,
    hd); pos (B,) keys that precede the step. Without k_new the cache holds
    the step's keys at pos[b]..pos[b]+T-1; with k_new, v_new (B, KV, T, hd)
    they are spliced in there first. Float32 math, output in q's dtype."""
    k = dequantize_kv(k_cache, k_scale)
    v = dequantize_kv(v_cache, v_scale)
    pos = pos.to(q.device)
    if k_new is not None:
        B, T = q.shape[:2]
        pad = k.new_zeros(B, k.shape[1], T, k.shape[3])
        k, v = torch.cat([k, pad], dim=2), torch.cat([v, pad], dim=2)
        at = pos.long()[:, None] + torch.arange(T, device=q.device)[None]  # (B, T)
        rows = torch.arange(B, device=q.device)[:, None]
        k[rows, :, at] = dequantize_kv(k_new, ks_new).transpose(1, 2)
        v[rows, :, at] = dequantize_kv(v_new, vs_new).transpose(1, 2)
    return flash_attention_plain(q, k, v, pos, scale, softcap, int(local_window or 0))


def launch(entry: str, count: str, q, k, v, pos, scale: float, *, k_scale, v_scale, news,
           softcap: float, win: int, table=None, span: int, pos_bias: int = 0) -> torch.Tensor:
    """Check the inputs, launch `entry` of csrc/<entry>.cu and count it under
    `count`. k, v: one layer, (B, KV, S, hd) dense or (n_pages, KV, 128, hd)
    with `table`; news = (k_new, v_new, ks_new, vs_new) or None; `span` the
    most keys a sequence can have (sizes the grid); the kernel reads
    pos + pos_bias as each sequence's keys before the step."""
    B, T, H, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    _build.require(decode_eligible(T, H, KV, hd),
                   f"{count}: T={T} H={H} KV={KV} head_dim={hd} (need T<={MAX_T}, "
                   f"H % KV == 0, head_dim in {HEAD_DIMS})")
    quant = k.dtype == torch.int8
    _build.require(q.dtype in (torch.bfloat16, torch.float32) and k.dtype == v.dtype
                   and k.dtype in KV_TYPES,
                   f"{count}: q {q.dtype}, cache {k.dtype}/{v.dtype} "
                   "(q bf16 or f32; cache bf16, f32 or int8)")
    _build.require(quant == (k_scale is not None) == (v_scale is not None),
                   f"{count}: an int8 cache needs k_scale and v_scale, a float cache none")
    _build.require(k.shape == v.shape and k.shape[3] == hd,
                   f"{count}: cache {tuple(k.shape)} / {tuple(v.shape)} for q {tuple(q.shape)}")
    tensors = [k, v]
    if quant:
        for s in (k_scale, v_scale):
            _build.require(s.dtype == torch.float32 and s.numel() == k.numel() // hd,
                           f"{count}: scales must be float32, one per cached row")
        tensors += [k_scale, v_scale]
    ptr_new = [None] * 4
    if news is not None:
        k_new, v_new, ks_new, vs_new = news
        _build.require(k_new.shape == v_new.shape == (B, KV, T, hd)
                       and k_new.dtype == v_new.dtype == k.dtype,
                       f"{count}: new block {tuple(k_new.shape)} {k_new.dtype} "
                       f"(need {(B, KV, T, hd)} {k.dtype})")
        new_t = [k_new, v_new]
        if quant:
            _build.require(ks_new is not None and vs_new is not None
                           and ks_new.dtype == vs_new.dtype == torch.float32
                           and ks_new.numel() == vs_new.numel() == B * KV * T,
                           f"{count}: an int8 new block needs float32 ks_new, vs_new (B, KV, T, 1)")
            new_t += [ks_new, vs_new]
        new_t = [t.contiguous() for t in new_t]
        tensors += new_t
        ptr_new[: len(new_t)] = [t.data_ptr() for t in new_t]
    if table is not None:
        _build.require(table.dtype == torch.int32 and table.dim() == 2 and table.shape[0] == B,
                       f"{count}: table must be int32 (B, max_pages)")
        tensors.append(table)
    for t in tensors:
        _build.require(t.is_contiguous() and t.device == q.device,
                       f"{count}: cache, scales and table must be contiguous on q's device")
    q = q.contiguous()
    for t in [q, *tensors[:2], *([] if news is None else new_t[:2])]:  # copied 16 bytes at a time
        _build.require(t.data_ptr() % 16 == 0, f"{count}: q and cache rows must be 16-byte aligned")
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()  # no copy if already so
    pl = plan(B, KV, span, T, G, hd)
    dev = q.device
    part_m = torch.empty(pl.part_stats, dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(pl.part_acc, dtype=torch.float32, device=dev)
    ticket = _ticket_buffer(pl.tickets, dev)
    out = torch.empty_like(q)
    argtypes = [_I, _I] + [_P] * 9 + ([_P] if table is not None else []) + [_P] * 6 \
        + [_I] * 7 + [_F, _F, _I, _I, _P]
    lib, fn = _build.entry(entry, entry, *argtypes)
    args = [0 if q.dtype == torch.bfloat16 else 1, KV_TYPES[k.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, *ptr_new]
    if table is not None:
        args.append(table.data_ptr())
    args += [pos.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
             ticket.data_ptr(), out.data_ptr(), B, KV,
             table.shape[1] if table is not None else k.shape[2], T, G, pl.n_chunks, hd,
             float(scale), float(softcap), int(win), int(pos_bias), _build.stream_ptr(q)]
    _build.launches[count] += 1
    err = fn(*args)
    _build.check(lib, err, count)
    return out.reshape(B, T, H * hd)


def decode_attention(q, k_cache, v_cache, pos, scale: float, k_scale=None, v_scale=None,
                     softcap: float = 0.0, local_window=None) -> torch.Tensor:
    """q (B, T, H, hd); k_cache, v_cache one layer (B, KV, S, hd) that already
    holds the step's tokens at pos[b]..pos[b]+T-1; pos (B,) -> (B, T, H*hd).
    Row t of sequence b sees keys j <= pos[b] + t."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, pos, scale, k_scale, v_scale,
                                      softcap, local_window)
    _build.require(k_cache.dim() == 4 and k_cache.shape[0] == q.shape[0],
                   f"decode_attention: cache {tuple(k_cache.shape)} for q {tuple(q.shape)}")
    return launch("decode_attention", "decode_attention", q, k_cache, v_cache, pos, scale,
                  k_scale=k_scale, v_scale=v_scale, news=None, softcap=softcap,
                  win=int(local_window or 0), span=k_cache.shape[2])


def decode_attention_fused(q, k_cache, v_cache, layer: int, pos, scale: float, k_new, v_new,
                           k_scale=None, v_scale=None, ks_new=None, vs_new=None,
                           softcap: float = 0.0, local_window=None) -> torch.Tensor:
    """q (B, T, H, hd); k_cache, v_cache the stacked cache (L, B, KV, S, hd)
    holding pos[b] keys of layer `layer`; k_new, v_new (B, KV, T, hd) the
    step's tokens in the cache's dtype (with ks_new, vs_new (B, KV, T, 1) for
    int8), attended from their own block: the caller writes them into the
    cache afterwards. -> (B, T, H*hd)."""
    k_l, v_l = k_cache[layer], v_cache[layer]
    ks_l = None if k_scale is None else k_scale[layer]
    vs_l = None if v_scale is None else v_scale[layer]
    if not q.is_cuda:
        return decode_attention_plain(q, k_l, v_l, pos, scale, ks_l, vs_l, softcap,
                                      local_window, k_new, v_new, ks_new, vs_new)
    _build.require(k_l.dim() == 4 and k_l.shape[0] == q.shape[0],
                   f"decode_attention_fused: cache {tuple(k_cache.shape)} for q {tuple(q.shape)}")
    return launch("decode_attention", "decode_attention_fused", q, k_l, v_l, pos, scale,
                  k_scale=ks_l, v_scale=vs_l, news=(k_new, v_new, ks_new, vs_new),
                  softcap=softcap, win=int(local_window or 0), span=k_l.shape[2] + q.shape[1])

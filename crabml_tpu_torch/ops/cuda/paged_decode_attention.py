"""Decode attention (T <= 8 new tokens, any number of q heads per kv head) over
a paged KV pool, through a block table.

Counterpart of crabml_tpu/ops/pallas/decode_attention.py::
paged_decode_attention (kernel `_kernel` with paged=True: the pool already
holds the step's tokens) and ::paged_decode_attention_fused (kernel
`_kernel_fused` with paged=True: the step's k/v arrive as a separate block and
the caller writes them into the pool afterwards). Both become
csrc/paged_decode_attention.cu, the paged instantiation of
csrc/decode_core.cuh (see its note for the bound and design).

A pool is (n_pages, KV, PAGE, hd) per layer; `table` (B, max_pages) int32
names the physical page of each logical chunk of a sequence. Unused entries
are 0, the shared scratch page, and are never followed: no page is read
beyond the first ceil(keys / PAGE) entries of a row. int8 pools carry float32
scale pools (n_pages, KV, PAGE, 1).

On a CPU tensor each wrapper gathers the pages dense and computes the plain
version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .decode_attention import CHUNK, decode_attention_plain, launch

PAGE = CHUNK  # tokens per page: one block of the kernel


def gather_pages(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(n_pages, KV, PAGE, d) through table (B, n) -> dense (B, KV, n*PAGE, d)."""
    B, n = table.shape
    g = pages[table.long()]  # (B, n, KV, PAGE, d)
    return g.permute(0, 2, 1, 3, 4).reshape(B, pages.shape[1], n * PAGE, pages.shape[3])


def paged_decode_attention_plain(q, k_pages, v_pages, table, pos, scale: float, k_scale=None,
                                 v_scale=None, softcap: float = 0.0, local_window=None,
                                 k_new=None, v_new=None, ks_new=None, vs_new=None) -> torch.Tensor:
    """Plain version of both paged forms: gather each sequence's pages dense,
    then decode_attention_plain. pos (B,) keys that precede the step."""
    table = table.to(q.device)
    return decode_attention_plain(
        q, gather_pages(k_pages, table), gather_pages(v_pages, table), pos, scale,
        None if k_scale is None else gather_pages(k_scale, table),
        None if v_scale is None else gather_pages(v_scale, table),
        softcap, local_window, k_new, v_new, ks_new, vs_new)


def _check_pool(name: str, q, k_pages, table):
    _build.require(k_pages.dim() == 4 and k_pages.shape[2] == PAGE,
                   f"{name}: pool {tuple(k_pages.shape)} (need (n_pages, KV, {PAGE}, hd))")
    _build.require(table.is_cuda and table.dtype == torch.int32,
                   f"{name}: the table must be an int32 CUDA tensor")


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, scale: float,
                           k_scale=None, v_scale=None, softcap: float = 0.0,
                           local_window=None) -> torch.Tensor:
    """q (B, T, H, hd); k_pages, v_pages one layer's pool (n_pages, KV, PAGE,
    hd) that already holds the step's tokens; page_table (B, max_pages);
    lengths (B,) keys per sequence, the step's T included -> (B, T, H*hd).
    Row t sees keys j <= lengths[b] - T + t; a sequence of length 0 gives 0."""
    T = q.shape[1]
    if not q.is_cuda:
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths - T,
                                            scale, k_scale, v_scale, softcap, local_window)
    _check_pool("paged_decode_attention", q, k_pages, page_table)
    return launch("paged_decode_attention", "paged_decode_attention", q, k_pages, v_pages,
                  lengths, scale, k_scale=k_scale, v_scale=v_scale, news=None, softcap=softcap,
                  win=int(local_window or 0), table=page_table,
                  span=page_table.shape[1] * PAGE, pos_bias=-T)


def paged_decode_attention_fused(q, k_pages, v_pages, table, layer: int, pos, scale: float,
                                 k_new, v_new, k_scale=None, v_scale=None, ks_new=None,
                                 vs_new=None, softcap: float = 0.0,
                                 local_window=None) -> torch.Tensor:
    """q (B, T, H, hd); k_pages, v_pages the stacked pools (L, n_pages, KV,
    PAGE, hd) holding pos[b] keys of layer `layer` per sequence; k_new, v_new
    (B, KV, T, hd) the step's tokens in the pool's dtype (with ks_new, vs_new
    (B, KV, T, 1) for int8), attended from their own block: the caller writes
    them into the pool afterwards. -> (B, T, H*hd)."""
    k_l, v_l = k_pages[layer], v_pages[layer]
    ks_l = None if k_scale is None else k_scale[layer]
    vs_l = None if v_scale is None else v_scale[layer]
    if not q.is_cuda:
        return paged_decode_attention_plain(q, k_l, v_l, table, pos, scale, ks_l, vs_l,
                                            softcap, local_window, k_new, v_new, ks_new, vs_new)
    _check_pool("paged_decode_attention_fused", q, k_l, table)
    return launch("paged_decode_attention", "paged_decode_attention_fused", q, k_l, v_l, pos,
                  scale, k_scale=ks_l, v_scale=vs_l, news=(k_new, v_new, ks_new, vs_new),
                  softcap=softcap, win=int(local_window or 0), table=table,
                  span=table.shape[1] * PAGE + q.shape[1])

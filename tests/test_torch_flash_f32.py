"""The float32 flash kernel's arithmetic and launch plan on the CPU
(csrc/flash_attention.cu's flash_f32_kernel: Q·Kᵀ and P·V in three TF32
passes on the tensor cores).

- `flash_attention_split_plain`, the plain model of the kernel's arithmetic
  (each operand split into TF32 hi + lo, three passes, float32 sums), against
  the exact plain version and against the JAX package's flash kernel in
  float32 (Pallas in interpret mode, `force=True`), at head dims 8-256, 1, 4
  and 7 q heads a kv head, a window with a softcap, ragged T at pos > 0, and
  a row that sees no key.
- `flash_f32_plan`: shared memory within the H100's 232,448 bytes a block at
  every head dim, the tile widths of `tile_width`, and the grid covering
  every (token, head) row once.
- `key_slot`: the permutation of each tile's keys that makes S's accumulator
  pairs the A fragments of P·V.
On the card: `-k f32_tensor_core_flash` of tests/test_torch_kernels_gpu.py
and chip_smoke.py's float32 flash checks (the kernel against both plain
versions, at 4,096 keys too)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from crabml_tpu_torch.ops.cuda import flash_attention as fa

# 1e-4 of max|out| is the kernel's gate on the card (chip_smoke.py). The model
# differs from the exact float32 attention by the dropped A_lo·B_lo terms and
# the TF32 rounding of each lo part (~2^-22 of each product, summed over a
# row: ~1e-6 of max|out| at these sizes), the JAX kernel by that and its own
# order of float32 sums.
TOL = 1e-4
HEAD_DIMS = [8, 16, 48, 80, 96, 128, 256]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread, with IEEE float32 products: the suite
    runs in several worker processes at once."""
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


def _case(hd, G, pos, seed, T=37, S=128, KV=2):
    """float32 q, k, v (numpy) and pos for len(pos) sequences."""
    rng = np.random.default_rng(seed)
    B = len(pos)
    q = (rng.standard_normal((B, T, KV * G, hd)) * 2).astype(np.float32)
    k = (rng.standard_normal((B, KV, S, hd)) * 2).astype(np.float32)
    v = rng.standard_normal((B, KV, S, hd)).astype(np.float32)
    return q, k, v, np.asarray(pos, np.int32)


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _rows(plan, T: int, G: int) -> list:
    """The (token, q head of the kv group) that each row of each block of
    `plan` computes, as csrc/flash_attention.cu's float32 kernel lays them
    out: per block, per warpgroup, row r is head r // (64 // G) of token
    r % (64 // G); None for a padding row or a row past T (never stored)."""
    bq = 64 // G
    out = []
    for x in range(plan.grid[0]):
        for w in range(plan.warpgroups):
            for r in range(64):
                g, t = r // bq, x * plan.tokens_per_block + w * bq + r % bq
                out.append((t, g) if t < T and g < G else None)
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("G", [1, 4, 7])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_split_model_matches_the_exact_plain_version(hd, G):
    """Two sequences at pos 0 and 53 (ragged T = 37, a 128-row cache): the
    three-pass model within 1e-4 of max|out| of the exact float32 plain
    version, and not equal to it (the split is applied)."""
    q, k, v, pos = _torch(*_case(hd, G, [0, 53], hd * 10 + G))
    want = fa.flash_attention_plain(q, k, v, pos, hd ** -0.5)
    got = fa.flash_attention_split_plain(q, k, v, pos, hd ** -0.5)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= TOL
    assert not torch.equal(got, want)


@pytest.mark.parametrize("hd", [48, 128, 256])
def test_split_model_with_a_window_and_a_softcap(hd):
    """A 20-key window and a softcap of 30 at pos 17 and 61, T = 23: within
    1e-4 of max|out| of the exact plain version."""
    q, k, v, pos = _torch(*_case(hd, 4, [17, 61], hd + 1, T=23, S=96))
    want = fa.flash_attention_plain(q, k, v, pos, hd ** -0.5, 30.0, 20)
    got = fa.flash_attention_split_plain(q, k, v, pos, hd ** -0.5, 30.0, 20)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("hd,G,softcap,window", [
    (8, 2, 0.0, 0), (48, 1, 0.0, 0), (128, 4, 0.0, 0), (256, 2, 0.0, 0),
    (96, 7, 30.0, 100), (256, 2, 50.0, 100)])
def test_split_model_matches_pallas(hd, G, softcap, window):
    """The JAX flash kernel in float32 (interpret mode, forced past its
    size gate; its products at Precision.HIGHEST), T = 128 (the JAX kernel
    tiles T by 128), pos 37 + hd and half that: the model within 1e-4 of
    max|out|."""
    q, k, v, pos = _case(hd, G, [37 + hd, (37 + hd) // 2], 3 * hd + G, T=128, S=384)
    want = j_flash(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(pos), hd ** -0.5,
                   force=True, softcap=softcap,
                   local_window=jnp.int32(window) if window else None)
    assert want is not None
    got = fa.flash_attention_split_plain(*_torch(q, k, v, pos), hd ** -0.5, softcap, window)
    B, T, H, _ = q.shape
    assert _rel(got.numpy(), np.asarray(want).reshape(B, T, H * hd)) <= TOL


def test_a_row_that_sees_no_key_gives_zero():
    """Rows past the cache's end with a 2-key window see no key: both plain
    versions give 0 there and agree elsewhere."""
    q, k, v, pos = _torch(*_case(64, 2, [60], 7, T=8, S=64))
    want = fa.flash_attention_plain(q, k, v, pos, 0.125, 0.0, 2)
    got = fa.flash_attention_split_plain(q, k, v, pos, 0.125, 0.0, 2)
    assert torch.all(want[0, 6:] == 0) and torch.all(got[0, 6:] == 0)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= TOL


def test_the_cpu_wrapper_runs_the_exact_plain_version():
    """On CPU tensors the wrapper takes the exact plain version, not the
    split model."""
    q, k, v, pos = _torch(*_case(128, 4, [0, 9], 11))
    got = fa.flash_attention(q, k, v, pos, 128 ** -0.5)
    assert torch.equal(got, fa.flash_attention_plain(q, k, v, pos, 128 ** -0.5))


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_f32_plan_fits_a_block_at_every_head_dim(hd):
    """At every head dim the card takes, with one warpgroup a block (a short
    chunk) and with two where the width allows (the 7B's 512-token chunk
    over 8 kv heads): the tile width is `tile_width`'s (64 up to 64, 128 up
    to 128, else 256), the Q tile and the stages fit the 232,448 bytes of
    shared memory a block may have, and two stages are kept where they fit."""
    for T, KV in ((16, 1), (512, 8)):
        plan = fa.flash_f32_plan(hd, T, 4, KV)
        assert plan.tile_width == fa.tile_width(hd)
        assert plan.tile_width == (64 if hd <= 64 else 128 if hd <= 128 else 256) >= hd
        assert plan.smem_bytes <= fa.SMEM_LIMIT
        assert plan.rows_per_block == 64 * plan.warpgroups
        assert plan.warpgroups == (1 if T == 16 or plan.tile_width == 256 else 2)
        assert plan.keys == (32 if plan.tile_width == 256 else 64)
        assert plan.stages == (2 if plan.tile_width == 64 else 1)


def test_f32_plan_bytes_by_tile_width():
    """The shared memory of each width and warpgroup count, as
    csrc/flash_attention.cu's note gives it: the Q tile (rows of 4 runs of
    HP / 4 + 8 floats, and 4 more), the stages of four BC x HP float32
    parts, 1,024 bytes of slack."""
    def smem(hd, T):
        return fa.flash_f32_plan(hd, T, 4, 8).smem_bytes
    assert smem(64, 16) == 25600 + 2 * 65536 + 1024
    assert smem(64, 4096) == 51200 + 2 * 65536 + 1024
    assert smem(128, 16) == 41984 + 131072 + 1024
    assert smem(128, 512) == 83968 + 131072 + 1024
    assert smem(256, 512) == 74752 + 131072 + 1024


@pytest.mark.parametrize("T,wgs,blocks", [(512, 2, 128), (189, 1, 96), (1, 1, 8)])
def test_f32_plan_fills_the_card_in_one_wave_where_it_can(T, wgs, blocks):
    """The 7B's heads (32 / 8, hd 128) on the H100's 132 SMs: a 512-token
    chunk takes 128 blocks of two warpgroups (one warpgroup would make two
    waves of 256), the 189-token chunk 96 blocks of one (two would leave 84
    SMs idle)."""
    plan = fa.flash_f32_plan(128, T, 4, 8)
    assert plan.warpgroups == wgs
    assert plan.grid[0] * plan.grid[1] == blocks
    assert fa.flash_f32_plan(128, T, 4, 8, sms=1000).warpgroups == 1


@pytest.mark.parametrize("G", [1, 4, 7, 64])
@pytest.mark.parametrize("T", [1, 17, 189, 512])
def test_f32_grid_covers_every_row_once(T, G):
    """At each tile width's plan, every (token, q head) of a kv group is one
    row of one block, and every other row is padding (64 % G a warpgroup) or
    past T; the grid has no block without a live row."""
    for hd in (8, 128, 256):
        plan = fa.flash_f32_plan(hd, T, G, KV=3, B=2)
        assert plan.grid[1:] == (3, 2)
        rows = _rows(plan, T, G)
        assert len(rows) == plan.grid[0] * plan.rows_per_block
        live = [r for r in rows if r is not None]
        assert sorted(live) == [(t, g) for t in range(T) for g in range(G)]
        per_block = [rows[i:i + plan.rows_per_block]
                     for i in range(0, len(rows), plan.rows_per_block)]
        assert all(any(r is not None for r in blk) for blk in per_block)
        assert (64 // G) * G + 64 % G == 64


def test_key_slot_is_a_bijection_on_each_group_of_8():
    slots = [fa.key_slot(j) for j in range(64)]
    assert sorted(slots) == list(range(64))
    assert all(s // 8 == j // 8 for j, s in enumerate(slots))


def test_key_slot_turns_score_pairs_into_a_fragments():
    """Thread quad qd holds S's columns 8 j + 2 qd and 8 j + 2 qd + 1 (the
    wgmma accumulator pair); staged by key_slot, those columns are keys
    8 j + qd and 8 j + qd + 4: the k indices of a TF32 A fragment's step j
    (registers a[2 g + h] at k = 4 g + qd)."""
    key_at = {fa.key_slot(j): j for j in range(32)}
    for j in range(4):
        for qd in range(4):
            cols = (8 * j + 2 * qd, 8 * j + 2 * qd + 1)
            assert tuple(key_at[c] for c in cols) == (8 * j + qd, 8 * j + qd + 4)

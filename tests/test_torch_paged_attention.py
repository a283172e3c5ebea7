"""Port parity: the plain versions of the paged decode-attention kernels and
the KV quantizer against the JAX package (Pallas kernels in interpret mode on
the CPU), same numpy inputs from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.ops.pallas.decode_attention import paged_decode_attention as j_paged
from crabml_tpu.ops.pallas.decode_attention import paged_decode_attention_fused as j_paged_fused
from crabml_tpu.serving.paged import PagedKVCache as JPagedKVCache
from crabml_tpu.serving.paged import _q8_vec as j_q8_vec
from crabml_tpu_torch.models.forward import q8_vec
from crabml_tpu_torch.ops.cuda.paged_decode_attention import (PAGE, paged_decode_attention,
                                                              paged_decode_attention_fused)
from crabml_tpu_torch.serving.paged import PagedKVCache

B, KV, G, HD, MAX_PAGES, N_PAGES, L = 3, 2, 2, 128, 3, 12, 2
SCALE = 1.0 / np.sqrt(HD)


@pytest.fixture(autouse=True)
def _float32_products():
    """The 2e-5 tolerances assume IEEE float32 products on both sides."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(before)


def _np_q8(a):
    s = np.maximum(np.abs(a).max(-1, keepdims=True) / np.float32(127.0), np.float32(1e-12))
    return np.clip(np.rint(a / s), -127, 127).astype(np.int8), s.astype(np.float32)


def _pool(seed: int, quant: bool, T: int, prefix):
    """A stacked pool (L, n_pages, KV, PAGE, hd) of random pages, a shuffled
    block table whose unused entries are 0 (the scratch page), q and the
    step's new block. Returns numpy arrays."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, N_PAGES, KV, PAGE, HD)).astype(np.float32)
    v = rng.standard_normal((L, N_PAGES, KV, PAGE, HD)).astype(np.float32)
    q = rng.standard_normal((B, T, KV * G, HD)).astype(np.float32)
    kn = rng.standard_normal((B, KV, T, HD)).astype(np.float32)
    vn = rng.standard_normal((B, KV, T, HD)).astype(np.float32)
    perm = rng.permutation(np.arange(1, N_PAGES))[: B * MAX_PAGES].reshape(B, MAX_PAGES)
    table = np.zeros((B, MAX_PAGES), np.int32)
    for b, p in enumerate(prefix):
        n = -(-(p + T) // PAGE)
        table[b, :n] = perm[b, :n]
    ks = vs = ksn = vsn = None
    if quant:
        (k, ks), (v, vs), (kn, ksn), (vn, vsn) = (_np_q8(a) for a in (k, v, kn, vn))
    return dict(k=k, v=v, ks=ks, vs=vs, q=q, kn=kn, vn=vn, ksn=ksn, vsn=vsn, table=table,
                pos=np.asarray(prefix, np.int32))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.tensor(a)


CASES = [(quant, T, softcap, window)
         for quant in (False, True) for T in (1, 4)
         for softcap, window in ((0.0, 0), (30.0, 100))]
IDS = [f"{'int8' if qn else 'f32'}-T{T}-cap{int(c)}-win{w}" for qn, T, c, w in CASES]


@pytest.mark.parametrize("quant,T,softcap,window", CASES, ids=IDS)
def test_paged_fused_plain_matches_pallas(quant, T, softcap, window):
    """paged_decode_attention_fused: the pool holds `prefix` keys per
    sequence (one prefix is 0: only the new block; one ends on a page
    boundary), the step's keys come in their own block. Both sides start
    from one pool, built as the JAX package's PagedKVCache. Tolerance 2e-5
    absolute (float32 on both sides, another order of sums)."""
    c = _pool(40 + T, quant, T, prefix=(0, 128, 300))
    jcache = JPagedKVCache(_j(c["k"]), _j(c["v"]), _j(c["table"]), _j(c["ks"]), _j(c["vs"]))
    cache = PagedKVCache.from_numpy(*(None if a is None else np.asarray(a) for a in (
        jcache.k, jcache.v, jcache.table, jcache.k_scale, jcache.v_scale)))
    layer = 1
    want = np.asarray(j_paged_fused(
        _j(c["q"]), jcache.k, jcache.v, jcache.table, jnp.int32(layer), _j(c["pos"]), SCALE,
        k_new=_j(c["kn"]), v_new=_j(c["vn"]), k_scale=jcache.k_scale, v_scale=jcache.v_scale,
        ks_new=_j(c["ksn"]), vs_new=_j(c["vsn"]), softcap=softcap,
        local_window=jnp.int32(window) if window else None))
    got = paged_decode_attention_fused(
        _t(c["q"]), cache.k, cache.v, cache.table, layer, _t(c["pos"]), SCALE,
        _t(c["kn"]), _t(c["vn"]), cache.k_scale, cache.v_scale, _t(c["ksn"]), _t(c["vsn"]),
        softcap=softcap, local_window=window)
    assert got.shape == (B, T, KV * G * HD)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("quant,T,softcap,window", CASES, ids=IDS)
def test_paged_plain_matches_pallas(quant, T, softcap, window):
    """paged_decode_attention: the pool already holds the step's tokens and
    `lengths` counts them. Tolerance 2e-5 absolute, as above."""
    c = _pool(60 + T, quant, T, prefix=(5, 128 - T, 300))
    lengths = c["pos"] + T
    layer = 0
    want = np.asarray(j_paged(
        _j(c["q"]), _j(c["k"][layer]), _j(c["v"][layer]), _j(c["table"]), _j(lengths), SCALE,
        k_scale=None if c["ks"] is None else _j(c["ks"][layer]),
        v_scale=None if c["vs"] is None else _j(c["vs"][layer]),
        softcap=softcap, local_window=jnp.int32(window) if window else None))
    got = paged_decode_attention(
        _t(c["q"]), _t(c["k"][layer]), _t(c["v"][layer]), _t(c["table"]), _t(lengths), SCALE,
        None if c["ks"] is None else _t(c["ks"][layer]),
        None if c["vs"] is None else _t(c["vs"][layer]), softcap=softcap, local_window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_paged_length_zero_gives_zero_not_nan():
    """A sequence of length 0 (an idle slot: table row 0, the scratch page)
    sees no key: its rows are 0, and the live sequence beside it matches the
    JAX kernel within 2e-5."""
    c = _pool(7, False, 1, prefix=(0, 40, 200))
    lengths = np.asarray([0, 41, 201], np.int32)
    c["table"][0] = 0
    c["k"][0, 0] = np.nan  # nothing may read the scratch page as context
    got = paged_decode_attention(_t(c["q"]), _t(c["k"][0]), _t(c["v"][0]), _t(c["table"]),
                                 _t(lengths), SCALE).numpy()
    assert np.array_equal(got[0], np.zeros_like(got[0]))
    want = np.asarray(j_paged(_j(c["q"][1:]), _j(c["k"][0]), _j(c["v"][0]), _j(c["table"][1:]),
                              _j(lengths[1:]), SCALE))
    np.testing.assert_allclose(got[1:], want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_q8_vec_bit_exact(dtype):
    """The KV quantizer against the JAX package's: int8 values and float32
    scales bit for bit (tolerance 0), over random vectors of several
    magnitudes, an all-zero vector and exact .5 ties (round half to even)."""
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((4, 3, 64, HD)) * rng.choice([1e-3, 1.0, 40.0], (4, 3, 64, 1)))
    a = a.astype(np.float32)
    a[0, 0, 0] = 0.0
    a[0, 0, 1] = np.arange(HD, dtype=np.float32) - 63.5  # max 64.5... ties after scaling
    a[0, 0, 2] = np.linspace(-127, 127, HD, dtype=np.float32) / 2  # x.5 values at scale 0.5
    if dtype == "bfloat16":
        ja, ta = jnp.asarray(a).astype(jnp.bfloat16), torch.tensor(a).to(torch.bfloat16)
    else:
        ja, ta = jnp.asarray(a), torch.tensor(a)
    want_q, want_s = j_q8_vec(ja)
    got_q, got_s = q8_vec(ta)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert np.array_equal(got_q.numpy(), np.asarray(want_q))
    assert np.array_equal(got_s.numpy(), np.asarray(want_s, np.float32))

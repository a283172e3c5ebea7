"""Port parity: the plain versions of the two attention kernels against the
JAX Pallas kernels (interpret mode on the CPU), same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.ops.pallas.decode_attention import decode_attention_fused
from crabml_tpu.ops.pallas.flash_attention import flash_attention as jflash
from crabml_tpu_torch.models.forward import KVCache
from crabml_tpu_torch.ops.cuda.decode_attention import decode_attention
from crabml_tpu_torch.ops.cuda.flash_attention import flash_attention


@pytest.fixture(autouse=True)
def _float32_products():
    """The 2e-5 tolerances assume IEEE float32 products on both sides: pin
    torch's CPU matmul precision for the test, whatever an earlier test in
    the same process set, and put it back afterwards."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize("T", [1, 3])
def test_decode_attention_plain_matches_fused_kernel(T):
    """Tolerance 2e-5: both run float32 online/exact softmax over the same
    keys. JAX attends the new tokens from a separate block before its cache
    write; the port writes them into the cache first. The port runs first,
    on its own copies, so no buffer is shared with JAX."""
    L, B, KV, G, S, hd = 2, 2, 2, 4, 256, 128
    H = KV * G
    rng = np.random.default_rng(10 + T)
    ck = rng.standard_normal((L, B, KV, S, hd)).astype(np.float32)
    cv = rng.standard_normal((L, B, KV, S, hd)).astype(np.float32)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    kn = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    vn = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    pos = np.asarray([37, 128], np.int32)  # one prefix ends on a chunk boundary
    scale = 1.0 / np.sqrt(hd)
    layer = 1
    k_l, v_l = ck[layer].copy(), cv[layer].copy()
    for b in range(B):
        k_l[b, :, pos[b] : pos[b] + T] = kn[b]
        v_l[b, :, pos[b] : pos[b] + T] = vn[b]
    got = decode_attention(torch.tensor(q), torch.tensor(k_l), torch.tensor(v_l),
                           torch.tensor(pos), scale).numpy()
    want = np.asarray(decode_attention_fused(
        jnp.array(q), jnp.array(ck), jnp.array(cv), jnp.int32(layer),
        jnp.array(pos), scale, k_new=jnp.array(kn), v_new=jnp.array(vn)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


FLASH_CASES = [(0, 0.0, 0), (96, 0.0, 0), (0, 30.0, 0), (96, 50.0, 0), (0, 0.0, 48),
               (96, 0.0, 130), (96, 0.0, 300), (96, 20.0, 40)]
FLASH_IDS = ["fresh", "resumed"] + [f"pos{p}-cap{int(c)}-win{w}" for p, c, w in FLASH_CASES[2:]]


@pytest.mark.parametrize("pos0,softcap,window", FLASH_CASES, ids=FLASH_IDS)
def test_flash_attention_plain_matches_pallas(pos0, softcap, window):
    """Tolerance 2e-5 (float32 throughout). Ragged prompt lengths are the
    port's own business; the JAX kernel needs T % 128 == 0. The softcap and
    the sliding window (narrower than a key block, wider than one so that
    whole blocks are skipped, and wider than every prefix) against the
    Pallas kernel's own, in interpret mode."""
    B, T, S, KV, G, hd = 2, 128, 384, 2, 2, 64
    H = KV * G
    rng = np.random.default_rng(pos0 + int(softcap) + window)
    q = (rng.standard_normal((B, T, H, hd)) * (2 if softcap else 1)).astype(np.float32)
    k = (rng.standard_normal((B, KV, S, hd)) * (2 if softcap else 1)).astype(np.float32)
    v = rng.standard_normal((B, KV, S, hd)).astype(np.float32)
    pos = np.asarray([pos0, pos0 // 2], np.int32)
    scale = 1.0 / np.sqrt(hd)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos), scale, force=True, softcap=softcap,
                             local_window=jnp.int32(window) if window else None))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(pos), scale, softcap, window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 0), (0.0, 48), (20.0, 40)])
def test_attention_semantics_match_jax(softcap, window):
    """The plain version against crabml_tpu.models.forward.attention (XLA
    path, float32 at "highest"): mask, softcap and sliding window. Both
    wrappers take it on CPU tensors. Tolerance 2e-5 (float32 throughout)."""
    from crabml_tpu.models.forward import attention as jattention

    B, T, S, KV, G, hd = 2, 5, 128, 2, 2, 64
    rng = np.random.default_rng(int(softcap) + window)
    q = (rng.standard_normal((B, T, KV * G, hd)) * 2).astype(np.float32)
    k = (rng.standard_normal((B, KV, S, hd)) * 2).astype(np.float32)
    v = rng.standard_normal((B, KV, S, hd)).astype(np.float32)
    pos = np.asarray([0, 77], np.int32)
    scale = 1.0 / np.sqrt(hd)
    want = np.asarray(jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                                 T, scale, softcap=softcap, local_window=window))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
            scale, softcap, window)
    np.testing.assert_allclose(flash_attention(*args).numpy(), want, rtol=2e-5, atol=2e-5)
    got = decode_attention(*args[:5], softcap=softcap, local_window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def _np_q8(a):
    s = np.maximum(np.abs(a).max(-1, keepdims=True) / np.float32(127.0), np.float32(1e-12))
    return np.clip(np.rint(a / s), -127, 127).astype(np.int8), s.astype(np.float32)


def _dense_case(seed: int, quant: bool, T: int):
    """A stacked dense cache (L, B, KV, S, hd), q and the step's new block."""
    L, B, KV, G, S, hd = 2, 3, 2, 2, 384, 128
    rng = np.random.default_rng(seed)
    c = {n: rng.standard_normal(shape).astype(np.float32) for n, shape in (
        ("k", (L, B, KV, S, hd)), ("v", (L, B, KV, S, hd)), ("q", (B, T, KV * G, hd)),
        ("kn", (B, KV, T, hd)), ("vn", (B, KV, T, hd)))}
    c.update(ks=None, vs=None, ksn=None, vsn=None)
    if quant:
        for n in ("k", "v", "kn", "vn"):
            c[n], c[n + "s" if len(n) == 1 else n[0] + "sn"] = _np_q8(c[n])
    return c


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.tensor(a)


DECODE_CASES = [(quant, T, softcap, window)
                for quant in (False, True) for T in (1, 4)
                for softcap, window in ((0.0, 0), (30.0, 100))]
DECODE_IDS = [f"{'int8' if qn else 'f32'}-T{T}-cap{int(c)}-win{w}"
              for qn, T, c, w in DECODE_CASES]


@pytest.mark.parametrize("quant,T,softcap,window", DECODE_CASES, ids=DECODE_IDS)
def test_decode_attention_fused_forms_match_pallas(quant, T, softcap, window):
    """decode_attention_fused with an int8 cache, the softcap and the sliding
    window, T in {1, 4}: prefixes 0 (only the new block), a chunk boundary
    and a ragged one. Tolerance 2e-5 absolute (float32, another order of
    sums)."""
    from crabml_tpu_torch.ops.cuda.decode_attention import decode_attention_fused as fused

    c = _dense_case(20 + T, quant, T)
    pos = np.asarray([0, 128, 300], np.int32)
    scale, layer = 1.0 / np.sqrt(128), 1
    want = np.asarray(decode_attention_fused(
        _j(c["q"]), _j(c["k"]), _j(c["v"]), jnp.int32(layer), _j(pos), scale,
        k_new=_j(c["kn"]), v_new=_j(c["vn"]), k_scale=_j(c["ks"]), v_scale=_j(c["vs"]),
        ks_new=_j(c["ksn"]), vs_new=_j(c["vsn"]), softcap=softcap,
        local_window=jnp.int32(window) if window else None))
    cache = KVCache.from_numpy(c["k"], c["v"], c["ks"], c["vs"])  # the JAX cache's arrays
    assert cache.quantized == quant and cache.seq_len == 384
    got = fused(_t(c["q"]), cache.k, cache.v, layer, _t(pos), scale, _t(c["kn"]),
                _t(c["vn"]), cache.k_scale, cache.v_scale, _t(c["ksn"]), _t(c["vsn"]),
                softcap=softcap, local_window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("quant,T,softcap,window", DECODE_CASES, ids=DECODE_IDS)
def test_decode_attention_forms_match_pallas(quant, T, softcap, window):
    """decode_attention (the cache already holds the step's tokens) with an
    int8 cache, the softcap and the sliding window, T in {1, 4}. Tolerance
    2e-5 absolute, as above."""
    from crabml_tpu.ops.pallas.decode_attention import decode_attention as jdecode

    c = _dense_case(30 + T, quant, T)
    pos = np.asarray([0, 128 - T, 300], np.int32)
    scale, layer = 1.0 / np.sqrt(128), 0
    sl = {n: None if c[n] is None else c[n][layer] for n in ("k", "v", "ks", "vs")}
    want = np.asarray(jdecode(
        _j(c["q"]), _j(sl["k"]), _j(sl["v"]), _j(pos), scale, k_scale=_j(sl["ks"]),
        v_scale=_j(sl["vs"]), softcap=softcap,
        local_window=jnp.int32(window) if window else None))
    got = decode_attention(_t(c["q"]), _t(sl["k"]), _t(sl["v"]), _t(pos), scale, _t(sl["ks"]),
                           _t(sl["vs"]), softcap=softcap, local_window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_decode_kernels_take_up_to_eight_tokens_at_any_group():
    """The decode kernels take T <= 8 new tokens at any number of q heads per
    kv head, as the JAX package's decode kernels do
    (crabml_tpu/ops/pallas/decode_attention.py::decode_eligible): past 16
    query rows in row tiles of 16. At 4 q heads per kv head (the 7B shape) a
    verify of 5 tokens (K = 4 drafts) is eligible; 9 tokens go to flash."""
    from crabml_tpu.ops.pallas.decode_attention import MAX_T
    from crabml_tpu_torch.ops.cuda.decode_attention import decode_eligible

    assert [T for T in range(1, 10) if decode_eligible(T, 32, 8, 128)] == list(range(1, MAX_T + 1))
    assert [T for T in range(1, 10) if decode_eligible(T, 8, 8, 128)] == list(range(1, 9))
    assert not decode_eligible(1, 32, 8, 64) and not decode_eligible(1, 32, 8, 48)
    assert decode_eligible(1, 32, 8, 96) and decode_eligible(1, 32, 8, 80)  # phi3, phi2
    assert decode_eligible(1, 32, 8, 256)  # gemma2's head dim takes them too
    assert decode_eligible(1, 24, 1, 128) and decode_eligible(8, 24, 1, 128)  # 24, 192 rows
    assert not decode_eligible(1, 24, 5, 128)  # q heads not a multiple of the kv heads

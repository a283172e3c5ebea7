"""The attention kernels' plain versions at head dims 96 (phi3) and 80 (phi2)
against the JAX package.

The JAX package's flash kernel takes these head dims (any multiple of 8 up
to 512, flash_attention.py:173-178): the plain flash is held to it in
interpret mode. Its decode kernels take multiples of 128 only and return None
otherwise (decode_attention.py:794), so the four plain decode forms at 96 and
80 are held to what the JAX forward runs there instead, its XLA attention
(crabml_tpu/models/forward.py::attention) over the same keys; and, zero
padded to 128 lanes (as the JAX package's kv_lane_pad stores them, and as
the card's kernels stage them in shared memory), to the Pallas decode
kernels themselves (interpret mode), cut back to the head dim."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.models.forward import attention as j_attention
from crabml_tpu.ops.pallas.decode_attention import decode_attention as j_decode
from crabml_tpu.ops.pallas.decode_attention import decode_attention_fused as j_decode_fused
from crabml_tpu.ops.pallas.decode_attention import paged_decode_attention as j_paged
from crabml_tpu.ops.pallas.decode_attention import paged_decode_attention_fused as j_paged_fused
from crabml_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from crabml_tpu_torch.ops.cuda.decode_attention import (decode_attention, decode_attention_fused,
                                                        decode_eligible)
from crabml_tpu_torch.ops.cuda.flash_attention import flash_attention
from crabml_tpu_torch.ops.cuda.paged_decode_attention import (PAGE, paged_decode_attention,
                                                              paged_decode_attention_fused)

FORMS = ["dense", "dense_fused", "paged", "paged_fused"]
SCALE = 0.1


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _np_q8(a):
    s = np.maximum(np.abs(a).max(-1, keepdims=True) / np.float32(127.0), np.float32(1e-12))
    return np.clip(np.rint(a / s), -127, 127).astype(np.int8), s.astype(np.float32)


@pytest.mark.parametrize("hd", [96, 80])
@pytest.mark.parametrize("G,pos0,softcap,window", [(1, 0, 0.0, 0), (2, 96, 50.0, 100),
                                                   (4, 256, 0.0, 64), (7, 37, 30.0, 0)])
def test_flash_plain_matches_pallas(hd, G, pos0, softcap, window):
    """Tolerance 2e-5 (float32 throughout): ragged offsets, 1 to 7 q heads a
    kv head, the softcap and windows that drop whole key blocks. T is 128:
    the JAX kernel tiles T by 128 or 256 (flash_attention.py:184)."""
    B, T, S, KV = 2, 128, 512, 2
    rng = np.random.default_rng(hd + G + pos0)
    q = (rng.standard_normal((B, T, KV * G, hd)) * 2).astype(np.float32)
    k = (rng.standard_normal((B, KV, S, hd)) * 2).astype(np.float32)
    v = rng.standard_normal((B, KV, S, hd)).astype(np.float32)
    pos = np.asarray([pos0, pos0 // 2], np.int32)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), SCALE,
                   force=True, softcap=softcap, local_window=jnp.int32(window) if window else None)
    assert want is not None  # the JAX kernel takes head dims 96 and 80
    want = np.asarray(want)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(pos), SCALE, softcap, window)
    assert got.shape == (B, T, KV * G * hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def _case(seed, kv, T, hd, B=3, KV=2, G=2, L=2, S=384):
    """A cache of L layers with the step's keys in their own block, q, and
    (for int8) the scales; kv: f32 | bf16 | int8."""
    rng = np.random.default_rng(seed)
    c = {n: rng.standard_normal(shape).astype(np.float32) for n, shape in (
        ("k", (L, B, KV, S, hd)), ("v", (L, B, KV, S, hd)), ("q", (B, T, KV * G, hd)),
        ("kn", (B, KV, T, hd)), ("vn", (B, KV, T, hd)))}
    c.update(ks=None, vs=None, ksn=None, vsn=None)
    if kv == "int8":
        (c["k"], c["ks"]), (c["v"], c["vs"]), (c["kn"], c["ksn"]), (c["vn"], c["vsn"]) = (
            _np_q8(c[n]) for n in ("k", "v", "kn", "vn"))
    return c


def _paged(c, prefix, T):
    """The dense cache's rows as a pool of 128-row pages behind a shuffled
    table (unused entries 0, the scratch page): (k, v, ks, vs, table)."""
    L, B, KV, S = c["k"].shape[:4]
    n = S // PAGE
    perm = np.random.default_rng(7).permutation(np.arange(1, B * n + 1)).reshape(B, n)
    table = np.zeros((B, n), np.int32)
    for b, p in enumerate(prefix):
        table[b, :-(-(p + T) // PAGE)] = perm[b, :-(-(p + T) // PAGE)]
    pools = []
    for a in (c["k"], c["v"], c["ks"], c["vs"]):
        if a is None:
            pools.append(None)
            continue
        pool = np.zeros((L, B * n + 1, KV, PAGE, a.shape[-1]), a.dtype)
        rows = a.reshape(L, B, KV, n, PAGE, -1).transpose(0, 1, 3, 2, 4, 5)
        pool[:, perm.reshape(-1)] = rows.reshape(L, B * n, KV, PAGE, -1)
        pools.append(pool)
    return (*pools, table)


def _port(form, c, prefix, T, layer, softcap, window, dtype):
    """The port's `form` on case c (q and a float cache in `dtype`)."""
    fused, paged = form.endswith("fused"), form.startswith("paged")
    pos = np.asarray(prefix, np.int32)

    def cast(a):  # a float cache or block in `dtype`; int8 as it is
        t = _t(a)
        return t if t is None or t.dtype == torch.int8 else t.to(dtype)

    q = _t(c["q"]).to(dtype)
    news = [cast(c[n]) for n in ("kn", "vn")] + [_t(c[n]) for n in ("ksn", "vsn")]
    kw = dict(softcap=softcap, local_window=window)
    if paged:
        k, v, ks, vs, table = _paged(c, prefix, T)
        if fused:
            return paged_decode_attention_fused(q, cast(k), cast(v), _t(table), layer, _t(pos),
                                                SCALE, *news[:2], _t(ks), _t(vs), *news[2:],
                                                **kw)
        sl = [None if a is None else a[layer] for a in (k, v, ks, vs)]
        return paged_decode_attention(q, cast(sl[0]), cast(sl[1]), _t(table), _t(pos + T),
                                      SCALE, _t(sl[2]), _t(sl[3]), **kw)
    if fused:
        return decode_attention_fused(q, cast(c["k"]), cast(c["v"]), layer, _t(pos), SCALE,
                                      *news[:2], _t(c["ks"]), _t(c["vs"]), *news[2:], **kw)
    sl = [None if c[n] is None else c[n][layer] for n in ("k", "v", "ks", "vs")]
    return decode_attention(q, cast(sl[0]), cast(sl[1]), _t(pos), SCALE, _t(sl[2]), _t(sl[3]),
                            **kw)


def _with_step(c, prefix, T, layer):
    """The case with the step's keys (and scales) written into the cache at
    each sequence's prefix: what the unfused forms read."""
    c = {n: None if a is None else a.copy() for n, a in c.items()}
    for b, p in enumerate(prefix):
        for a, n in (("k", "kn"), ("v", "vn"), ("ks", "ksn"), ("vs", "vsn")):
            if c[a] is not None:
                c[a][layer, b, :, p:p + T] = c[n][b]
    return c


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hd", [96, 80])
@pytest.mark.parametrize("form", FORMS)
def test_decode_forms_match_xla_attention(form, hd, kv):
    """Every decode form at head dims 96 and 80 against the JAX forward's XLA
    attention over the same keys (dequantized for int8): T = 4 with the
    softcap 50 and a window of 100 keys, prefixes 0, a page edge and 300.
    float32 and int8 (which dequantizes exactly on both sides) at 2e-5
    absolute, another order of float32 sums; a bfloat16 q and cache against
    the float32 attention of the same bfloat16 values (XLA on the CPU has
    no bfloat16 product) at 2^-7 of max|out|: one rounding of the output."""
    T, softcap, window, layer = 4, 50.0, 100, 1
    fused = form.endswith("fused")
    c = _case(3 + FORMS.index(form) + hd, kv, T, hd)
    prefix = (0, 128 if fused else 128 - T, 300)
    if not fused:
        c = _with_step(c, prefix, T, layer)
    dtype = torch.bfloat16 if kv == "bf16" else torch.float32
    got = _port(form, c, prefix, T, layer, softcap, window, dtype)
    assert got.shape == (3, T, 4 * hd) and got.dtype == dtype
    # JAX: the step's keys in the cache, every row dequantized, XLA attention
    full = _with_step(c, prefix, T, layer)
    k, v = full["k"][layer], full["v"][layer]
    if kv == "int8":
        k, v = k.astype(np.float32) * full["ks"][layer], v.astype(np.float32) * full["vs"][layer]
    q = jnp.asarray(c["q"])
    k, v = jnp.asarray(k), jnp.asarray(v)
    if kv == "bf16":
        q, k, v = (a.astype(jnp.bfloat16).astype(jnp.float32) for a in (q, k, v))
    want = np.asarray(j_attention(q, k, v, jnp.asarray(prefix, jnp.int32), T, SCALE,
                                  softcap=softcap, local_window=window))
    if kv == "bf16":
        assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -7 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def _pad(a, lanes=128):
    return None if a is None else np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, lanes - a.shape[-1])])


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("hd", [96, 80])
@pytest.mark.parametrize("form", FORMS)
def test_lane_padded_forms_match_pallas_at_128(form, hd, kv):
    """q, the cache and the step's keys zero-padded to 128 lanes (what the
    JAX package's kv_lane_pad stores; the int8 scales do not move): the
    port's forms at 128 cut back to the head dim equal its forms at the head
    dim itself, and both hold at 2e-5 to the JAX Pallas decode kernels at 128
    (interpret mode), the same cut."""
    T, softcap, window, layer = 4, 50.0, 100, 1
    fused, paged = form.endswith("fused"), form.startswith("paged")
    c = _case(11 + FORMS.index(form) + hd, kv, T, hd)
    prefix = (0, 128 if fused else 128 - T, 300)
    if not fused:
        c = _with_step(c, prefix, T, layer)
    wide = {n: a if n in ("ks", "vs", "ksn", "vsn") else _pad(a) for n, a in c.items()}
    got = _port(form, wide, prefix, T, layer, softcap, window, torch.float32)
    got = got.reshape(3, T, 4, 128)[..., :hd].reshape(3, T, 4 * hd)
    narrow = _port(form, c, prefix, T, layer, softcap, window, torch.float32)
    np.testing.assert_allclose(got.numpy(), narrow.numpy(), rtol=0, atol=2e-6)
    pos = np.asarray(prefix, np.int32)
    kw = dict(softcap=softcap, local_window=jnp.int32(window))
    news = dict(k_new=_j(wide["kn"]), v_new=_j(wide["vn"]), ks_new=_j(wide["ksn"]),
                vs_new=_j(wide["vsn"]))
    if paged:
        k, v, ks, vs, table = _paged(wide, prefix, T)
        if fused:
            want = j_paged_fused(_j(wide["q"]), _j(k), _j(v), _j(table), jnp.int32(layer),
                                 _j(pos), SCALE, k_scale=_j(ks), v_scale=_j(vs), **news, **kw)
        else:
            sl = [None if a is None else a[layer] for a in (k, v, ks, vs)]
            want = j_paged(_j(wide["q"]), _j(sl[0]), _j(sl[1]), _j(table), _j(pos + T), SCALE,
                           k_scale=_j(sl[2]), v_scale=_j(sl[3]), **kw)
    elif fused:
        want = j_decode_fused(_j(wide["q"]), _j(wide["k"]), _j(wide["v"]), jnp.int32(layer),
                              _j(pos), SCALE, k_scale=_j(wide["ks"]), v_scale=_j(wide["vs"]),
                              **news, **kw)
    else:
        sl = [None if wide[n] is None else wide[n][layer] for n in ("k", "v", "ks", "vs")]
        want = j_decode(_j(wide["q"]), _j(sl[0]), _j(sl[1]), _j(pos), SCALE, k_scale=_j(sl[2]),
                        v_scale=_j(sl[3]), **kw)
    assert want is not None  # 128 lanes: the Pallas kernel takes it
    want = np.asarray(want).reshape(3, T, 4, 128)[..., :hd].reshape(3, T, 4 * hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_decode_eligible_at_hd96_and_hd80():
    """96 and 80 take the decode kernels with the same rule as 128
    (Phi-3-mini's 32 / 32 heads: up to 8 tokens, G = 1; at G = 7 too)."""
    for hd in (96, 80):
        assert [T for T in range(1, 10) if decode_eligible(T, 32, 32, hd)] == list(range(1, 9))
        assert [T for T in range(1, 10) if decode_eligible(T, 8, 4, hd)] == list(range(1, 9))
        assert [T for T in range(1, 10) if decode_eligible(T, 14, 2, hd)] == list(range(1, 9))

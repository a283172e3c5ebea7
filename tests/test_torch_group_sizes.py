"""Port parity at q-head group sizes G (q heads per kv head) that do not
divide 64: the flash kernel's plain version at G = 3, 5, 6 and 7 against the
Pallas flash kernel (interpret mode on the CPU), and the plain versions of
the four decode-attention forms at Qwen2-7B's G = 7 (T = 1 and 2, so 7 and 14
query rows a kv head) against the Pallas decode kernels. Same seeded numpy
inputs on both sides; float32 throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.ops.pallas.decode_attention import decode_attention as j_decode
from crabml_tpu.ops.pallas.decode_attention import decode_attention_fused as j_decode_fused
from crabml_tpu.ops.pallas.decode_attention import paged_decode_attention as j_paged
from crabml_tpu.ops.pallas.decode_attention import paged_decode_attention_fused as j_paged_fused
from crabml_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from crabml_tpu_torch.ops.cuda.decode_attention import (decode_attention, decode_attention_fused,
                                                        decode_eligible)
from crabml_tpu_torch.models.forward import q8_vec
from crabml_tpu_torch.ops.cuda.flash_attention import flash_attention
from crabml_tpu_torch.ops.cuda.paged_decode_attention import (PAGE, paged_decode_attention,
                                                              paged_decode_attention_fused)

HD = 128


@pytest.fixture(autouse=True)
def _float32_products():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(before)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.tensor(a)


@pytest.mark.parametrize("G,pos0,softcap,window", [(3, 0, 0.0, 0), (5, 96, 50.0, 0),
                                                   (6, 96, 0.0, 100), (7, 37, 30.0, 70)])
def test_flash_plain_matches_pallas_at_any_group(G, pos0, softcap, window):
    """Tolerance 2e-5 (float32 throughout): 2 kv heads of G q heads, a
    128-token chunk at two offsets, with the softcap and windows that drop
    whole key blocks."""
    B, T, S, KV = 2, 128, 384, 2
    rng = np.random.default_rng(40 + G)
    q = (rng.standard_normal((B, T, KV * G, HD)) * 2).astype(np.float32)
    k = (rng.standard_normal((B, KV, S, HD)) * 2).astype(np.float32)
    v = rng.standard_normal((B, KV, S, HD)).astype(np.float32)
    pos = np.asarray([pos0, pos0 // 2], np.int32)
    scale = 1.0 / np.sqrt(HD)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                              scale, force=True, softcap=softcap,
                              local_window=jnp.int32(window) if window else None))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(pos), scale, softcap, window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_decode_kernels_take_g7_up_to_eight_tokens():
    """At Qwen2-7B's 28 / 4 heads the decode kernels take T <= 8 (up to 56
    query rows, in four row tiles of 16); 9 tokens go to flash."""
    assert [T for T in range(1, 10) if decode_eligible(T, 28, 4, 128)] == list(range(1, 9))


FORMS = ["dense", "dense_fused", "paged", "paged_fused"]


def _case(seed: int, T: int, G: int, L=2, B=3, KV=2, S=384):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(shape).astype(np.float32) for n, shape in (
        ("k", (L, B, KV, S, HD)), ("v", (L, B, KV, S, HD)), ("q", (B, T, KV * G, HD)),
        ("kn", (B, KV, T, HD)), ("vn", (B, KV, T, HD)))}


def _paged(c, prefix, T, names=("k", "v")):
    """The dense cache's rows as a pool of 128-row pages behind a shuffled
    table (unused entries 0, the scratch page): (a pool for each of `names`,
    in its own dtype and width, table)."""
    L, B, KV, S = c["k"].shape[:4]
    n = S // PAGE
    perm = np.random.default_rng(7).permutation(np.arange(1, B * n + 1)).reshape(B, n)
    table = np.zeros((B, n), np.int32)
    for b, p in enumerate(prefix):
        table[b, :-(-(p + T) // PAGE)] = perm[b, :-(-(p + T) // PAGE)]
    pools = []
    for a in (c[name] for name in names):
        d = a.shape[-1]
        pool = np.zeros((L, B * n + 1, KV, PAGE, d), a.dtype)
        rows = a.reshape(L, B, KV, n, PAGE, d).transpose(0, 1, 3, 2, 4, 5)
        pool[:, perm.reshape(-1)] = rows.reshape(L, B * n, KV, PAGE, d)
        pools.append(pool)
    return (*pools, table)


@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("form", FORMS)
def test_decode_forms_match_pallas_at_g7(form, T):
    """Every decode form at 7 q heads a kv head (T * G = 7 and 14 rows of the
    kernel's 16), the softcap 30 and a window of 100 keys, prefixes 0, a page
    edge and 300. Tolerance 2e-5 absolute (float32 on both sides, another
    order of sums)."""
    G, softcap, window, scale, layer = 7, 30.0, 100, 1.0 / np.sqrt(HD), 1
    fused, paged = form.endswith("fused"), form.startswith("paged")
    c = _case(60 + 2 * FORMS.index(form) + T, T, G)
    prefix = (0, 128 if fused else 128 - T, 300)
    pos = np.asarray(prefix, np.int32)
    kw = dict(softcap=softcap, local_window=jnp.int32(window))
    if not fused:  # the cache holds the step's tokens
        for b, p in enumerate(prefix):
            c["k"][layer, b, :, p:p + T] = c["kn"][b]
            c["v"][layer, b, :, p:p + T] = c["vn"][b]
    if paged:
        k, v, table = _paged(c, prefix, T)
        if fused:
            want = j_paged_fused(_j(c["q"]), _j(k), _j(v), _j(table), jnp.int32(layer), _j(pos),
                                 scale, k_new=_j(c["kn"]), v_new=_j(c["vn"]), **kw)
            got = paged_decode_attention_fused(_t(c["q"]), _t(k), _t(v), _t(table), layer,
                                               _t(pos), scale, _t(c["kn"]), _t(c["vn"]),
                                               softcap=softcap, local_window=window)
        else:
            want = j_paged(_j(c["q"]), _j(k[layer]), _j(v[layer]), _j(table), _j(pos + T),
                           scale, **kw)
            got = paged_decode_attention(_t(c["q"]), _t(k[layer]), _t(v[layer]), _t(table),
                                         _t(pos + T), scale, softcap=softcap,
                                         local_window=window)
    elif fused:
        want = j_decode_fused(_j(c["q"]), _j(c["k"]), _j(c["v"]), jnp.int32(layer), _j(pos),
                              scale, k_new=_j(c["kn"]), v_new=_j(c["vn"]), **kw)
        got = decode_attention_fused(_t(c["q"]), _t(c["k"]), _t(c["v"]), layer, _t(pos), scale,
                                     _t(c["kn"]), _t(c["vn"]), softcap=softcap,
                                     local_window=window)
    else:
        want = j_decode(_j(c["q"]), _j(c["k"][layer]), _j(c["v"][layer]), _j(pos), scale, **kw)
        got = decode_attention(_t(c["q"]), _t(c["k"][layer]), _t(c["v"][layer]), _t(pos),
                               scale, softcap=softcap, local_window=window)
    assert got.shape == (3, T, 2 * G * HD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("T,G", [(5, 4), (8, 7)])
@pytest.mark.parametrize("form", FORMS)
def test_decode_forms_match_pallas_past_sixteen_rows(form, T, G, kv):
    """Every decode form past 16 query rows a kv head, the speculative
    verify's shapes: the 7B's K = 4 verify (T = 5 at G = 4, 20 rows) and
    Qwen2-7B's widest (T = 8 at G = 7, 56 rows), float32 and int8 storage
    (payload and scales given to both packages as they are), the softcap 30
    and a window of 100 keys, prefixes 0, a page edge and 300, against the
    JAX kernels in interpret mode, which take any number of q heads a kv
    head. Tolerance 2e-5 absolute (float32 math on both sides, int8
    dequantized exactly; another order of sums)."""
    softcap, window, scale, layer = 30.0, 100, 1.0 / np.sqrt(HD), 1
    fused, paged = form.endswith("fused"), form.startswith("paged")
    c = _case(90 + 4 * FORMS.index(form) + T + G, T, G)
    prefix = (0, 128 if fused else 128 - T, 300)
    pos = np.asarray(prefix, np.int32)
    if not fused:  # the cache holds the step's tokens
        for b, p in enumerate(prefix):
            c["k"][layer, b, :, p:p + T] = c["kn"][b]
            c["v"][layer, b, :, p:p + T] = c["vn"][b]
    names = ("k", "v")
    if kv == "int8":
        for n in ("k", "v", "kn", "vn"):
            qa, sa = q8_vec(torch.from_numpy(c[n]))
            c[n], c[n + "_s"] = qa.numpy(), sa.numpy()
        names = ("k", "v", "k_s", "v_s")
    opt = lambda n: c.get(n)  # noqa: E731 - None for a float cache
    jkw = dict(softcap=softcap, local_window=jnp.int32(window))
    pkw = dict(softcap=softcap, local_window=window)
    if paged:
        k, v, *scales, table = _paged(c, prefix, T, names)
        ks, vs = scales if scales else (None, None)
        if fused:
            want = j_paged_fused(_j(c["q"]), _j(k), _j(v), _j(table), jnp.int32(layer), _j(pos),
                                 scale, _j(c["kn"]), _j(c["vn"]), _j(ks), _j(vs),
                                 _j(opt("kn_s")), _j(opt("vn_s")), **jkw)
            got = paged_decode_attention_fused(_t(c["q"]), _t(k), _t(v), _t(table), layer,
                                               _t(pos), scale, _t(c["kn"]), _t(c["vn"]), _t(ks),
                                               _t(vs), _t(opt("kn_s")), _t(opt("vn_s")), **pkw)
        else:
            sl = [None if a is None else a[layer] for a in (ks, vs)]
            want = j_paged(_j(c["q"]), _j(k[layer]), _j(v[layer]), _j(table), _j(pos + T),
                           scale, _j(sl[0]), _j(sl[1]), **jkw)
            got = paged_decode_attention(_t(c["q"]), _t(k[layer]), _t(v[layer]), _t(table),
                                         _t(pos + T), scale, _t(sl[0]), _t(sl[1]), **pkw)
    elif fused:
        want = j_decode_fused(_j(c["q"]), _j(c["k"]), _j(c["v"]), jnp.int32(layer), _j(pos),
                              scale, _j(c["kn"]), _j(c["vn"]), _j(opt("k_s")), _j(opt("v_s")),
                              _j(opt("kn_s")), _j(opt("vn_s")), **jkw)
        got = decode_attention_fused(_t(c["q"]), _t(c["k"]), _t(c["v"]), layer, _t(pos), scale,
                                     _t(c["kn"]), _t(c["vn"]), _t(opt("k_s")), _t(opt("v_s")),
                                     _t(opt("kn_s")), _t(opt("vn_s")), **pkw)
    else:
        sl = [None if opt(n) is None else opt(n)[layer] for n in ("k_s", "v_s")]
        want = j_decode(_j(c["q"]), _j(c["k"][layer]), _j(c["v"][layer]), _j(pos), scale,
                        _j(sl[0]), _j(sl[1]), **jkw)
        got = decode_attention(_t(c["q"]), _t(c["k"][layer]), _t(c["v"][layer]), _t(pos),
                               scale, _t(sl[0]), _t(sl[1]), **pkw)
    assert want is not None  # the JAX kernels take the shape
    assert got.shape == (3, T, 2 * G * HD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)

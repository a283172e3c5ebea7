"""Float32 compute, the kernels' plain versions against the JAX package on
the CPU: each float32 plain form against the Pallas kernel in interpret
mode. The dequant kernel (`_qmm_kernel` at out_dtype float32) for the eight
weight sources, on the float32 scale planes the Runner loads under float32
compute; the int8-activation kernel on those planes, its activations from
`quantize_activation` on float32 x with the JAX package's int8 codes bit for
bit; the decode kernels (`_kernel`, `_kernel_fused`, dense and paged) with q
and the cache in different dtypes and in float32 at head dim 256.
The model, the Runner, sessions, the CLI and what the card refuses in
float32: tests/test_torch_float32_runner.py. The card's own checks of the
kernels: tests/test_torch_kernels_gpu.py's float32 section."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.ops.pallas import gemm_quant as jgemm
from crabml_tpu.ops.pallas.decode_attention import decode_attention as j_decode
from crabml_tpu.ops.pallas.decode_attention import decode_attention_fused as j_decode_fused
from crabml_tpu.ops.pallas.decode_attention import paged_decode_attention as j_paged
from crabml_tpu.ops.pallas.decode_attention import paged_decode_attention_fused as j_paged_fused
from crabml_tpu.quant.planar import to_planar as jto_planar
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.ops.cuda import gemm_quant
from crabml_tpu_torch.ops.cuda.decode_attention import decode_attention, decode_attention_fused
from crabml_tpu_torch.ops.cuda.paged_decode_attention import (PAGE, paged_decode_attention,
                                                              paged_decode_attention_fused)
from crabml_tpu_torch.quant.qtensor import FORM_KIND, to_kernel_layout, to_planar
from crabml_tpu_torch.tools.synth_gguf import SCHEMES as SYNTH
from crabml_tpu_torch.tools.synth_gguf import vary_scales

# the eight weight sources, and the three kinds that run three of them
SOURCES = (GGMLType.Q4_K, GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q5_K, GGMLType.Q4_0,
           GGMLType.Q3_K, GGMLType.Q2_K, GGMLType.Q5_0)
KINDS = pytest.mark.parametrize(
    "kind", SOURCES + (GGMLType.Q4_1, GGMLType.Q5_1, GGMLType.Q8_1),
    ids=["q4_k", "q8_0", "q6_k", "q5_k", "q4_0", "q3_k", "q2_k", "q5_0", "q4_1", "q5_1", "q8_1"])
M, K = 256, 1024


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


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _pair(kind, seed):
    """(JAX kernel-layout QTensor with float32 scales, port kernel planes
    with float32 scales) of one (M, K) weight of `kind` from the same bytes:
    random blocks, each block's scales (and minimum) its own."""
    _, blocks = next(v for v in SYNTH.values() if v[0] == kind)
    rng = np.random.default_rng(seed)
    raw = vary_scales(kind, blocks(rng, M * K, 0.05), rng).tobytes()
    jqt = jgemm.repack(jto_planar(JGGMLType(int(kind)), raw, (M, K)), np.float32)
    qt = to_kernel_layout(to_planar(kind, raw, (M, K)), torch.float32)
    return jqt, qt


def _planes(qt):
    return [qt.planes[n] for n in gemm_quant._KERNEL_PLANES[FORM_KIND[qt.kind]]]


# ---------------------------------------------------------------------------
# the matmuls
# ---------------------------------------------------------------------------

@KINDS
def test_f32_dequant_plain_matches_pallas(kind):
    """The float32 dequant form on float32 scale planes, 32 rows: tolerance
    2e-5 of max|out| (both dequantize to exact float32 weights, the JAX
    kernel's product at Precision.HIGHEST; sums in another order). The
    wrapper and the router take it for float32 x on the CPU."""
    jqt, qt = _pair(kind, 3)
    for n in ("dsub", "msub"):
        assert n not in qt.planes or qt.planes[n].dtype == torch.float32
    x = np.random.default_rng(1).standard_normal((32, K)).astype(np.float32)
    want = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x), jqt, jnp.float32, act_quant=False))
    xt = torch.from_numpy(x)
    name = gemm_quant.DEQUANT_FORMS[FORM_KIND[kind]]
    got = getattr(gemm_quant, f"{name}_plain")(xt, *_planes(qt))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 2e-5
    np.testing.assert_array_equal(getattr(gemm_quant, name)(xt, qt).numpy(), got.numpy())
    np.testing.assert_array_equal(gemm_quant.qmatmul_quant(xt, qt).numpy(), got.numpy())


@KINDS
@pytest.mark.parametrize("rows", [1, 8, 16])
def test_f32_w4a8_plain_matches_pallas(kind, rows):
    """The int8-activation form on float32 x and float32 scale planes:
    tolerance 1e-5 of max|out| (the same int8 activations, exact integer
    group dots; the TPU kernel's -128 centring and corrections round
    otherwise in float32)."""
    jqt, qt = _pair(kind, 5 + rows)
    x = np.random.default_rng(2 + rows).standard_normal((rows, K)).astype(np.float32)
    want = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x), jqt, jnp.float32, act_quant=True))
    xt = torch.from_numpy(x)
    got = getattr(gemm_quant, f"{gemm_quant.W4A8_FORMS[FORM_KIND[kind]]}_plain")(xt, *_planes(qt))
    assert _rel(got, want) <= 1e-5
    np.testing.assert_array_equal(gemm_quant.qmm_w4a8(xt, qt).numpy(), got.numpy())
    np.testing.assert_array_equal(gemm_quant.qmatmul_quant(xt, qt).numpy(), got.numpy())


@pytest.mark.parametrize("group", [32, 16])
def test_f32_quantize_activation_codes_equal_jax(group):
    """quantize_activation on float32 x gives the JAX package's int8 codes,
    scales and bsums bit for bit (inv = 1/max(dx, 1e-30), half to even),
    rows with a zero group and values on exact .5 steps included."""
    rng = np.random.default_rng(group)
    x = (rng.standard_normal((4, K)) * np.linspace(0.01, 40, K)).astype(np.float32)
    x[1, 64:96] = 0
    x[2, :group] = np.arange(group, dtype=np.float32) - group / 2  # steps of amax / 127
    xq, dx, sx = gemm_quant.quantize_activation(torch.from_numpy(x), group)
    jxq, jdx, jsx = jgemm.quantize_activation(jnp.asarray(x), group, 256)
    G = 256 // group

    def unlanes(a):  # (S, B, 128) -> (B, K / group)
        a = np.asarray(a)[..., :G]
        return a.transpose(1, 0, 2).reshape(x.shape[0], -1)

    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(dx.numpy(), unlanes(jdx))
    np.testing.assert_array_equal(sx.numpy(), unlanes(jsx))


# ---------------------------------------------------------------------------
# the decode kernels: q and the cache of different dtypes, float32 at hd 256
# ---------------------------------------------------------------------------

def _q8(a):
    s = np.maximum(np.abs(a).max(-1, keepdims=True) / np.float32(127.0), np.float32(1e-12))
    return np.clip(np.rint(a / s), -127, 127).astype(np.int8), s.astype(np.float32)


def _in(a, kind):
    """A numpy array as (torch, jax) arrays: a float32 one in `kind`'s dtype
    where that is bf16, anything else as it is (int8 values, their scales)."""
    if a is None:
        return None, None
    if a.dtype != np.float32 or kind != "bf16":
        return torch.from_numpy(a), jnp.asarray(a)
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


_PAIRS = [("f32", "bf16"), ("bf16", "f32"), ("f32", "int8"), ("f32", "f32")]


@pytest.mark.parametrize("hd", [256, 128])
@pytest.mark.parametrize("q_kind,kv", _PAIRS, ids=[f"{q}-{kv}" for q, kv in _PAIRS])
@pytest.mark.parametrize("form", ["dense", "dense_fused", "paged", "paged_fused"])
def test_decode_forms_mixed_match_pallas(form, q_kind, kv, hd):
    """Every decode form with q and the cache in the given dtypes (float32 q
    over a bfloat16 or int8 cache, bfloat16 q over a float32 one; float32 at
    head dim 256 with it), T = 4, a softcap of 50 and a window of 100 keys,
    prefixes 0, a page edge and 300: the port's plain version against the
    JAX kernel in interpret mode, which takes each pair as it is and
    computes in float32 (Precision.HIGHEST). Tolerance: 2e-5 of max|out| for
    a float32 output (another order of sums), 2^-8 (one bfloat16 rounding of
    the output) for a bfloat16 one. The output is in q's dtype."""
    T, B, KV, G, S, L, layer = 4, 3, 2, 2, 384, 2, 1
    scale, softcap, window = 1.0 / 16, 50.0, 100
    fused, paged = form.endswith("fused"), form.startswith("paged")
    rng = np.random.default_rng(hd + 10 * _PAIRS.index((q_kind, kv)))
    c = {n: rng.standard_normal(shape).astype(np.float32) for n, shape in (
        ("k", (L, B, KV, S, hd)), ("v", (L, B, KV, S, hd)), ("q", (B, T, KV * G, hd)),
        ("kn", (B, KV, T, hd)), ("vn", (B, KV, T, hd)))}
    c.update(ks=None, vs=None, ksn=None, vsn=None)
    if kv == "int8":
        (c["k"], c["ks"]), (c["v"], c["vs"]), (c["kn"], c["ksn"]), (c["vn"], c["vsn"]) = (
            _q8(c[n]) for n in ("k", "v", "kn", "vn"))
    prefix = (0, 128 if fused else 128 - T, 300)
    pos = np.asarray(prefix, np.int32)
    if not fused:  # the cache holds the step's tokens
        for b, p in enumerate(prefix):
            for a, n in (("k", "kn"), ("v", "vn"), ("ks", "ksn"), ("vs", "vsn")):
                if c[a] is not None:
                    c[a][layer, b, :, p:p + T] = c[n][b]
    if paged:  # the dense rows as 128-row pages behind a shuffled table
        n = S // PAGE
        perm = np.random.default_rng(7).permutation(np.arange(1, B * n + 1)).reshape(B, n)
        table = np.zeros((B, n), np.int32)
        for b, p in enumerate(prefix):
            table[b, :-(-(p + T) // PAGE)] = perm[b, :-(-(p + T) // PAGE)]
        for a in ("k", "v", "ks", "vs"):
            if c[a] is not None:
                pool = np.zeros((L, B * n + 1, KV, PAGE, c[a].shape[-1]), c[a].dtype)
                rows = c[a].reshape(L, B, KV, n, PAGE, -1).transpose(0, 1, 3, 2, 4, 5)
                pool[:, perm.reshape(-1)] = rows.reshape(L, B * n, KV, PAGE, -1)
                c[a] = pool
        tt, jt = torch.from_numpy(table), jnp.asarray(table)
    q, jq = _in(c["q"], q_kind)
    (k, jk), (v, jv), (kn, jkn), (vn, jvn) = (_in(c[n], kv) for n in ("k", "v", "kn", "vn"))
    (ks, jks), (vs, jvs), (ksn, jksn), (vsn, jvsn) = (_in(c[n], kv)
                                                      for n in ("ks", "vs", "ksn", "vsn"))
    kw = dict(softcap=softcap, local_window=window)
    jkw = dict(softcap=softcap, local_window=jnp.int32(window))
    if fused:
        news = dict(k_new=jkn, v_new=jvn, ks_new=jksn, vs_new=jvsn)
        if paged:
            want = j_paged_fused(jq, jk, jv, jt, jnp.int32(layer), jnp.asarray(pos), scale,
                                 k_scale=jks, v_scale=jvs, **news, **jkw)
            got = paged_decode_attention_fused(q, k, v, tt, layer, torch.from_numpy(pos), scale,
                                               kn, vn, ks, vs, ksn, vsn, **kw)
        else:
            want = j_decode_fused(jq, jk, jv, jnp.int32(layer), jnp.asarray(pos), scale,
                                  k_scale=jks, v_scale=jvs, **news, **jkw)
            got = decode_attention_fused(q, k, v, layer, torch.from_numpy(pos), scale, kn, vn,
                                         ks, vs, ksn, vsn, **kw)
    else:
        sl = [None if a is None else a[layer] for a in (k, v, ks, vs)]
        jsl = [None if a is None else a[layer] for a in (jk, jv, jks, jvs)]
        if paged:
            want = j_paged(jq, jsl[0], jsl[1], jt, jnp.asarray(pos + T), scale, k_scale=jsl[2],
                           v_scale=jsl[3], **jkw)
            got = paged_decode_attention(q, sl[0], sl[1], tt, torch.from_numpy(pos + T), scale,
                                         sl[2], sl[3], **kw)
        else:
            want = j_decode(jq, jsl[0], jsl[1], jnp.asarray(pos), scale, k_scale=jsl[2],
                            v_scale=jsl[3], **jkw)
            got = decode_attention(q, sl[0], sl[1], torch.from_numpy(pos), scale, sl[2], sl[3],
                                   **kw)
    assert got.dtype == q.dtype and got.shape == (B, T, KV * G * hd)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert _rel(got.float().numpy(), want) <= (2e-5 if q_kind == "f32" else 2.0 ** -8)

"""Port parity for gemma2: the attention kernels' plain versions at head dim
256 against the JAX Pallas kernels (interpret mode on the CPU), the committed
HF goldens, and a tiny gemma2 whose head dim (256) is decoupled from its
embedding width (256, with 2 q heads: 512 q rows) against the JAX package:
the forward under w4a8, greedy Runner tokens, both serving engines, the
embedding scale's rounding and the weights carried over from JAX. The
sliding window there (24 keys) is shorter than the prompts, so it drops
keys on the even layers and not on the odd ones."""

import os
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.gguf.reader import GGUFFile as JGGUFFile
from crabml_tpu.models.config import ARCH_FEATURES
from crabml_tpu.models.config import config_from_gguf as jconfig_from_gguf
from crabml_tpu.models.forward import KVCache as JKVCache
from crabml_tpu.models.forward import forward as jforward
from crabml_tpu.models.synthetic import tiny_config, write_synthetic_gguf
from crabml_tpu.models.weights import fuse_weights, repack_weights
from crabml_tpu.models.weights import load_weights as jload_weights
from crabml_tpu.ops import matmul as jmm
from crabml_tpu.ops.pallas import gemm_quant as jgemm
from crabml_tpu.ops.pallas.decode_attention import decode_attention as j_decode
from crabml_tpu.ops.pallas.decode_attention import decode_attention_fused as j_decode_fused
from crabml_tpu.ops.pallas.decode_attention import paged_decode_attention as j_paged
from crabml_tpu.ops.pallas.decode_attention import paged_decode_attention_fused as j_paged_fused
from crabml_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from crabml_tpu.runtime.runner import Runner as JRunner
from crabml_tpu_torch.errors import UnsupportedError
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.models.config import config_from_gguf
from crabml_tpu_torch.models.forward import KVCache, embed, forward, layer_window
from crabml_tpu_torch.models.weights import check_supported, from_jax_weights, load_weights
from crabml_tpu_torch.ops.cuda.decode_attention import (decode_attention, decode_attention_fused,
                                                        decode_eligible)
from crabml_tpu_torch.ops.cuda.flash_attention import check_card_attention, flash_attention
from crabml_tpu_torch.ops.cuda.paged_decode_attention import (PAGE, paged_decode_attention,
                                                              paged_decode_attention_fused)
from crabml_tpu_torch.runtime.runner import Runner
from crabml_tpu_torch.serving import PagedServingEngine, ServingEngine

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
HD = 256
WINDOW = 24  # the tiny model's sliding window, shorter than its prompts


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread, with IEEE float32 products: the suite
    runs in several worker processes at once, and torch's thread pool in each
    of them slows the Runner and engine tests a hundredfold."""
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


@pytest.fixture
def w4a8_backend():
    jmm.set_backend("w4a8")
    try:
        yield
    finally:
        jmm.set_backend("xla")


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.tensor(a)


def _np_q8(a):
    s = np.maximum(np.abs(a).max(-1, keepdims=True) / np.float32(127.0), np.float32(1e-12))
    return np.clip(np.rint(a / s), -127, 127).astype(np.int8), s.astype(np.float32)


# ---------------------------------------------------------------------------
# the kernels' plain versions at head dim 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos0,softcap,window", [(0, 50.0, 0), (96, 50.0, 100), (256, 0.0, 64)])
def test_flash_plain_matches_pallas_at_hd256(pos0, softcap, window):
    """Tolerance 2e-5 (float32 throughout). Gemma-2's softcap 50 and a
    window that drops whole key blocks of the later rows (100 and 64 keys at
    offsets 96 and 256), 2 q heads a kv head."""
    B, T, S, KV, G = 2, 128, 512, 1, 2
    rng = np.random.default_rng(pos0 + window)
    q = (rng.standard_normal((B, T, KV * G, HD)) * 2).astype(np.float32)
    k = (rng.standard_normal((B, KV, S, HD)) * 2).astype(np.float32)
    v = rng.standard_normal((B, KV, S, HD)).astype(np.float32)
    pos = np.asarray([pos0, pos0 // 2], np.int32)
    scale = 1.0 / 16
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                              scale, force=True, softcap=softcap,
                              local_window=jnp.int32(window) if window else None))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(pos), scale, softcap, window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def _cache(seed, quant, T, B=3, KV=2, G=2, L=2, S=384):
    rng = np.random.default_rng(seed)
    c = {n: rng.standard_normal(shape).astype(np.float32) for n, shape in (
        ("k", (L, B, KV, S, HD)), ("v", (L, B, KV, S, HD)), ("q", (B, T, KV * G, HD)),
        ("kn", (B, KV, T, HD)), ("vn", (B, KV, T, HD)))}
    c.update(ks=None, vs=None, ksn=None, vsn=None)
    if quant:
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


FORMS = ["dense", "dense_fused", "paged", "paged_fused"]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("form", FORMS)
def test_decode_forms_match_pallas_at_hd256(form, quant):
    """Every decode form at head dim 256 with the softcap 50 and a window of
    100 keys, T = 4 (an unfused form's step is in the cache, a fused one's in
    its own block), prefixes 0, a page edge and 300. Tolerance 2e-5
    absolute (float32 on both sides, another order of sums; int8 dequantizes
    exactly on both)."""
    T, softcap, window, scale, layer = 4, 50.0, 100, 1.0 / 16, 1
    fused, paged = form.endswith("fused"), form.startswith("paged")
    c = _cache(11 + 2 * FORMS.index(form) + quant, quant, T)
    prefix = (0, 128 if fused else 128 - T, 300)
    pos = np.asarray(prefix, np.int32)
    kw = dict(softcap=softcap, local_window=jnp.int32(window))
    if not fused:  # the cache holds the step's tokens
        for b, p in enumerate(prefix):
            for a, n in (("k", "kn"), ("v", "vn"), ("ks", "ksn"), ("vs", "vsn")):
                if c[a] is not None:
                    c[a][layer, b, :, p:p + T] = c[n][b]
    news = dict(k_new=_j(c["kn"]), v_new=_j(c["vn"]), ks_new=_j(c["ksn"]), vs_new=_j(c["vsn"]))
    tnews = [_t(c[n]) for n in ("kn", "vn", "ksn", "vsn")]
    if paged:
        k, v, ks, vs, table = _paged(c, prefix, T)
        if fused:
            want = j_paged_fused(_j(c["q"]), _j(k), _j(v), _j(table), jnp.int32(layer), _j(pos),
                                 scale, k_scale=_j(ks), v_scale=_j(vs), **news, **kw)
            got = paged_decode_attention_fused(
                _t(c["q"]), _t(k), _t(v), _t(table), layer, _t(pos), scale, *tnews[:2],
                _t(ks), _t(vs), *tnews[2:], softcap=softcap, local_window=window)
        else:
            sl = [None if a is None else a[layer] for a in (k, v, ks, vs)]
            want = j_paged(_j(c["q"]), _j(sl[0]), _j(sl[1]), _j(table), _j(pos + T), scale,
                           k_scale=_j(sl[2]), v_scale=_j(sl[3]), **kw)
            got = paged_decode_attention(_t(c["q"]), *map(_t, sl[:2]), _t(table), _t(pos + T),
                                         scale, *map(_t, sl[2:]), softcap=softcap,
                                         local_window=window)
    elif fused:
        want = j_decode_fused(_j(c["q"]), _j(c["k"]), _j(c["v"]), jnp.int32(layer), _j(pos),
                              scale, k_scale=_j(c["ks"]), v_scale=_j(c["vs"]), **news, **kw)
        got = decode_attention_fused(_t(c["q"]), _t(c["k"]), _t(c["v"]), layer, _t(pos), scale,
                                     *tnews[:2], _t(c["ks"]), _t(c["vs"]), *tnews[2:],
                                     softcap=softcap, local_window=window)
    else:
        sl = [None if c[n] is None else c[n][layer] for n in ("k", "v", "ks", "vs")]
        want = j_decode(_j(c["q"]), _j(sl[0]), _j(sl[1]), _j(pos), scale, k_scale=_j(sl[2]),
                        v_scale=_j(sl[3]), **kw)
        got = decode_attention(_t(c["q"]), *map(_t, sl[:2]), _t(pos), scale, *map(_t, sl[2:]),
                               softcap=softcap, local_window=window)
    assert got.shape == (3, T, 4 * HD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_decode_eligible_at_hd256():
    """Head dim 256 takes the decode kernels (gemma2's decode step goes to
    the fused form, not to flash over the whole cache), up to 8 tokens at any
    group size as at 128; 64 does not, and 96 and 80 do since phi3 and phi2
    were ported."""
    assert [T for T in range(1, 10) if decode_eligible(T, 16, 8, 256)] == list(range(1, 9))
    assert [T for T in range(1, 10) if decode_eligible(T, 32, 8, 256)] == list(range(1, 9))
    assert not decode_eligible(1, 16, 8, 64)
    assert decode_eligible(1, 16, 8, 96) and decode_eligible(1, 16, 8, 80)


# ---------------------------------------------------------------------------
# the committed HF goldens (crabml_tpu's tests/test_family_goldens.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["prompt", "decode"])
@pytest.mark.parametrize("family", ["gemma2", "mixtral", "qwen3"])
def test_family_golden(family, path):
    """The port's forward against transformers' logits at the JAX test's
    5e-4: the whole 16-token prompt at once, or 15 tokens then the last
    through the T = 1 decode step. gemma2's fixture has window 8 and softcaps
    50 / 30, so the window drops keys on layer 0 and not on layer 1; qwen3's
    norms each q and k head before the rotation."""
    gold = np.load(os.path.join(FIXDIR, f"{family}-tiny-golden.npz"))
    tokens = gold["tokens"].tolist()
    gf = GGUFFile(os.path.join(FIXDIR, f"{family}-tiny-f32.gguf"))
    cfg = config_from_gguf(gf.metadata)
    if family == "gemma2":
        assert (cfg.sliding_window, cfg.attn_logit_softcap, cfg.final_logit_softcap) == \
            (8, 50.0, 30.0) and len(tokens) > cfg.sliding_window
    w = load_weights(gf, cfg)
    cache = KVCache.create(cfg, 1, 64)
    if path == "prompt":
        got = forward(w, cache, torch.tensor([tokens]), torch.tensor([0]), cfg)[0]
        want = gold["logits"]
    else:
        forward(w, cache, torch.tensor([tokens[:-1]]), torch.tensor([0]), cfg)
        got = forward(w, cache, torch.tensor([tokens[-1:]]), torch.tensor([len(tokens) - 1]),
                      cfg)[0, 0]
        want = gold["logits"][-1]
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


def test_gemma2_golden_needs_the_alternating_window():
    """The golden tells the layer windows apart: the window on every layer,
    or on none, moves the logits well past 5e-4."""
    gold = np.load(os.path.join(FIXDIR, "gemma2-tiny-golden.npz"))
    gf = GGUFFile(os.path.join(FIXDIR, "gemma2-tiny-f32.gguf"))
    cfg = config_from_gguf(gf.metadata)
    assert [layer_window(cfg, l) for l in range(4)] == [8, 0, 8, 0]
    w = load_weights(gf, cfg)
    for other in (replace(cfg, alternating_window=False), replace(cfg, sliding_window=0)):
        got = forward(w, KVCache.create(cfg, 1, 64), torch.tensor([gold["tokens"].tolist()]),
                      torch.tensor([0]), other)[0]
        assert np.abs(got.numpy() - gold["logits"]).max() > 5e-3


# ---------------------------------------------------------------------------
# a tiny gemma2 with a decoupled head dim, against the JAX package
# ---------------------------------------------------------------------------

def _jcfg():
    feats = dict(ARCH_FEATURES["gemma2"])
    return tiny_config(architecture="gemma2", model_name="tiny-gemma2", embedding_dim=256,
                       hidden_dim=512, n_layers=2, n_heads=2, n_kv_heads=1, vocab_size=512,
                       seq_len=512, rms_norm_eps=1e-6, head_dim_override=HD,
                       attn_logit_softcap=50.0, final_logit_softcap=30.0, sliding_window=WINDOW,
                       **feats)


@pytest.fixture(scope="module")
def tiny_gemma2(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gguf") / "tiny-gemma2.gguf")
    write_synthetic_gguf(path, _jcfg(), JGGMLType.Q4_K, seed=4)
    return path


def test_tiny_gemma2_config(tiny_gemma2):
    cfg = config_from_gguf(GGUFFile(tiny_gemma2).metadata)
    check_supported(cfg)
    assert (cfg.head_dim, cfg.n_heads * cfg.head_dim, cfg.embedding_dim) == (HD, 512, 256)
    assert cfg.attn_scale == 1.0 / 16 and cfg.effective_rope_dim == HD
    assert [layer_window(cfg, l) for l in range(2)] == [WINDOW, 0]
    w = load_weights(GGUFFile(tiny_gemma2), cfg)
    lw = w["layers"][0]
    assert lw["wqkv"].shape == (512 + 2 * HD, 256) and lw["wo"].shape == (256, 512)
    assert lw["post_attn_norm"].shape == lw["post_ffn_norm"].shape == (256,)
    with pytest.raises(UnsupportedError, match="architecture 'falcon'"):
        check_supported(replace(cfg, architecture="falcon"))
    for arch in ("qwen2", "qwen3", "gemma", "phi2", "phi3"):  # every family loads
        check_supported(replace(cfg, architecture=arch, rope_scaling_type="linear"))
    for hd in (80, 96):  # phi2's and phi3's head dims: taken on a card since they were ported
        check_card_attention(replace(cfg, head_dim_override=hd), "cuda", torch.bfloat16)


def test_tiny_gemma2_forward_matches_jax_w4a8(tiny_gemma2, w4a8_backend):
    """Tolerance 2e-4 (tests/test_model.py:41): float32 on both sides, the
    same Q4_K bytes and int8 activations, sums in another order. A 40-token
    prompt (past the 24-key window: flash with the window on layer 0, none
    on layer 1), a 3-token chunk (the unfused decode form) and one decode
    step (the fused form).

    The model is tied. The JAX package keeps its embedding in planar layout
    for the gather and so runs the tied lm_head on its XLA path, a float
    product, where the port multiplies by a kernel-layout copy of the
    embedding as by any output matrix (int8 activations at <= 16 rows, ~1e-2
    off the float product here). The JAX side gets that copy as its output
    too, so both take the same route."""
    jgf = JGGUFFile(tiny_gemma2)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jk = repack_weights(fuse_weights(jload_weights(jgf, jcfg), jcfg), jcfg)
    assert jk["output"] is None
    jk = dict(jk, output=jgemm.repack(jk["token_embed"]))
    gf = GGUFFile(tiny_gemma2)
    cfg = config_from_gguf(gf.metadata)
    pw = load_weights(gf, cfg)
    tokens = np.random.default_rng(0).integers(3, cfg.vocab_size, (1, 44))
    jcache = JKVCache.create(jcfg, 1, 128)
    cache = KVCache.create(cfg, 1, 128)
    for lo, hi in ((0, 40), (40, 43), (43, 44)):
        toks = tokens[:, lo:hi]
        want, jcache = jforward(jk, jcache, jnp.asarray(toks, jnp.int32),
                                jnp.asarray([lo], jnp.int32), jcfg, jnp.float32)
        got = forward(pw, cache, torch.from_numpy(toks), torch.tensor([lo]), cfg, torch.float32)
        assert got.shape == (1, hi - lo, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


PROMPT = "the gemma cat sat on a mat"  # 27 tokens with BOS, past the window


def test_tiny_gemma2_runner_greedy_tokens_match_jax(tiny_gemma2, w4a8_backend):
    """The same 16 greedy tokens from both packages (float32 compute, the
    JAX Runner on its w4a8 backend); the decode runs past the window."""
    jr = JRunner(tiny_gemma2, backend="w4a8", compute_dtype=jnp.float32)
    want = "".join(jr.prefill_and_generate(PROMPT, 16))
    r = Runner(tiny_gemma2, compute_dtype=torch.float32, device="cpu")
    assert len(r.tokenizer.encode(PROMPT, bos=True)) > WINDOW
    got = "".join(r.prefill_and_generate(PROMPT, 16))
    assert r.metrics.counts["tokens"] == 15
    assert got == want


def test_serving_engines_match_the_runner_on_tiny_gemma2(tiny_gemma2):
    """Both engines share layer_body and take each layer's window: three
    prompts at once through two slots give the Runner's greedy text, two of
    them past the window, and the paged engine returns its pages."""
    r = Runner(tiny_gemma2, compute_dtype=torch.float32, device="cpu")
    prompts = [PROMPT, "a", "w5 w6 w7 " * 4]
    want = []
    for p in prompts:
        r.reset()
        want.append("".join(r.prefill_and_generate(p, 8)))
    dense = ServingEngine(r, n_slots=2, seq_len=256)
    assert dense.generate(prompts, max_tokens=8) == want
    paged = PagedServingEngine(r, n_slots=2, n_pages=8, seq_len=256)
    free = paged.pages_free()
    assert paged.generate(prompts, max_tokens=8) == want
    assert paged.pages_free() == free


def test_embedding_scale_rounds_like_jax_in_bf16(tiny_gemma2):
    """The embedding times sqrt(dim), the factor rounded to the compute dtype
    first: at Gemma-2-9B's 3584, bfloat16 59.75 (not 59.866). The port's
    bfloat16 rows, scaled, equal JAX's product of the same rows bit for bit
    (crabml_tpu/models/forward.py: x * sqrt(float32(D)).astype(dtype))."""
    from crabml_tpu_torch.ops.matmul import embedding_lookup

    gf = GGUFFile(tiny_gemma2)
    cfg = config_from_gguf(gf.metadata)
    w = load_weights(gf, cfg, compute_dtype=torch.bfloat16)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9)))
    rows = embedding_lookup(w["token_embed"], tokens, torch.bfloat16)
    jrows = jnp.asarray(rows.float().numpy()).astype(jnp.bfloat16)
    for dim in (256, 3584):
        got = embed(w, tokens, replace(cfg, embedding_dim=dim), torch.bfloat16)
        want = jrows * jnp.sqrt(jnp.float32(dim)).astype(jnp.bfloat16)
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32)), dim
    # the unrounded factor gives other rows: the rounding is what the test sees
    assert not torch.equal(got, (rows.float() * 3584 ** 0.5).to(torch.bfloat16))
    assert float(torch.tensor(3584.0).sqrt().to(torch.bfloat16)) == 59.75


def test_from_jax_weights_carries_the_post_norms():
    """The gemma2 fixture's planar JAX weights, carried across: the post
    norms arrive in every layer and the forward equals the GGUF-loaded one's
    (the same numbers in the same layout)."""
    path = os.path.join(FIXDIR, "gemma2-tiny-f32.gguf")
    jgf = JGGUFFile(path)
    jw = jload_weights(jgf, jconfig_from_gguf(jgf.metadata), layout="planar")
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    w = from_jax_weights(jw, cfg)
    direct = load_weights(gf, cfg)
    for lw, dw, l in zip(w["layers"], direct["layers"], range(cfg.n_layers)):
        for n in ("post_attn_norm", "post_ffn_norm"):
            assert torch.equal(lw[n], dw[n])
            np.testing.assert_array_equal(lw[n].numpy(), np.asarray(jw["layers"][n][l]))
    tokens = torch.from_numpy(np.load(os.path.join(FIXDIR, "gemma2-tiny-golden.npz"))["tokens"])[None]
    got = forward(w, KVCache.create(cfg, 1, 64), tokens, torch.tensor([0]), cfg)
    want = forward(direct, KVCache.create(cfg, 1, 64), tokens, torch.tensor([0]), cfg)
    assert torch.equal(got, want)

"""Port parity against the JAX package for phi3 and phi2: the LayerNorm,
phi2's partial rotary (32 of 80 dims), the committed HF golden of phi3, and
two tiny models from the port's writer (tools/synth_gguf.py):

- `tiny-phi3`: 8 q heads of head dim 96 over 4 kv heads (so rows t*G + g at
  G = 2), fused attn_qkv and gate|up, vocab 576 (a multiple of 64 and not of
  128, as Phi-3-mini's 32064);
- `tiny-phi2`: 16 heads of head dim 80, the rotary over 32 of them, every
  bias, LayerNorm, the parallel residual and the gateless GELU FFN.

Each is written twice: every matrix Q4_K (both packages stack its layers, so
the JAX package runs its int8-activation kernels on it) and llama.cpp's
Q4_K_M layout (attn_qkv Q5_K, layer 1's ffn_down and the output Q6_K), held
to the JAX forward on its float32 twin. The forward is held at 2e-4 in
float32 (a prompt through flash, a 3-token chunk through the decode form and
one decode step), the paged tick to the dense step, greedy Runner tokens and
both engines to JAX's, and the weights carried over from JAX."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.gguf.reader import GGUFFile as JGGUFFile
from crabml_tpu.models.config import config_from_gguf as jconfig_from_gguf
from crabml_tpu.models.forward import KVCache as JKVCache
from crabml_tpu.models.forward import forward as jforward
from crabml_tpu.models.weights import fuse_weights, repack_weights
from crabml_tpu.models.weights import load_weights as jload_weights
from crabml_tpu.ops.norm import layer_norm as jlayer_norm
from crabml_tpu.ops.pallas import gemm_quant as jgemm
from crabml_tpu.ops.rope import apply_rope as japply_rope
from crabml_tpu.quant.planar import to_planar as jto_planar
from crabml_tpu.runtime.runner import Runner as JRunner
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.models.config import config_from_gguf
from crabml_tpu_torch.models.forward import KVCache, decode_step, forward
from crabml_tpu_torch.models.weights import check_supported, from_jax_weights, load_weights
from crabml_tpu_torch.ops.cuda import gemm_quant
from crabml_tpu_torch.ops.norm import layer_norm
from crabml_tpu_torch.ops.rope import apply_rope, inv_freq
from crabml_tpu_torch.quant.qtensor import to_kernel_layout, to_planar
from crabml_tpu_torch.runtime.runner import Runner
from crabml_tpu_torch.serving import PagedServingEngine, ServingEngine
from crabml_tpu_torch.serving.paged import (PAGE, PagedKVCache, paged_decode_step,
                                            paged_prefill_chunk)
from crabml_tpu_torch.tools.synth_gguf import (build_synth_gguf, mix_kind, q4k_blocks,
                                               q6k_blocks)
# one_torch_thread (autouse) and w4a8_backend are fixtures, used by import
from torch_families_common import (CHUNKS, TOL, f32_twin, jax_scan_codes, one_torch_thread,
                                   port_step, w4a8_backend)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
MODELS = ["tiny-phi3", "tiny-phi2"]
Q4, Q5, Q6 = GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K
PROMPT = "the phi cat sat on a mat"


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dim", [64, 1280, 2560, 3072])
def test_layer_norm_matches_jax(dim, bias):
    """crabml_tpu/ops/norm.py::layer_norm in float32 and bfloat16. The same
    formula on both sides; the two means are summed in another order (XLA's
    and torch's reductions), so float32 agrees to 2e-6 at |out| up to ~10
    (a few ulps) and not bit for bit, and a bfloat16 output is equal or one
    bfloat16 rounding step apart."""
    rng = np.random.default_rng(dim)
    x = (rng.standard_normal((3, 7, dim)) * 3 + 0.5).astype(np.float32)
    w = rng.uniform(0.5, 1.5, dim).astype(np.float32)
    b = rng.standard_normal(dim).astype(np.float32) if bias else None
    jb = None if b is None else jnp.asarray(b)
    tb = None if b is None else torch.from_numpy(b)
    want = np.asarray(jlayer_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, jb))
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, tb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    wantb = np.asarray(jlayer_norm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w), 1e-5,
                                   jb).astype(jnp.float32))
    gotb = layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), 1e-5, tb)
    assert gotb.dtype == torch.bfloat16
    np.testing.assert_allclose(gotb.float().numpy(), wantb, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("rope_dim,hd", [(32, 80), (96, 96), (16, 80)])
def test_partial_rotary_matches_jax(rope_dim, hd):
    """phi2's rotary over the first 32 of 80 dims (neox pairs i, i + 16),
    the tail passed through unchanged, against crabml_tpu/ops/rope.py::
    apply_rope; tolerance 1e-5 (tests/test_torch_ops.py's)."""
    rng = np.random.default_rng(rope_dim + hd)
    x = rng.standard_normal((2, 3, 4, hd)).astype(np.float32)
    positions = np.asarray([[0, 1, 2], [700, 701, 2047]], np.int32)
    want = np.asarray(japply_rope(jnp.asarray(x), jnp.asarray(positions), rope_dim, "neox"))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(positions), rope_dim, "neox").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[..., rope_dim:], x[..., rope_dim:])
    assert np.abs(got[..., :rope_dim] - x[..., :rope_dim]).max() > 0.1


# ---------------------------------------------------------------------------
# the committed HF golden (crabml_tpu's tests/test_family_goldens.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["prompt", "decode"])
def test_phi3_golden(path):
    """The port's forward against transformers' logits on the committed
    phi3 fixture at the JAX test's 5e-4: the whole prompt at once, or all
    but the last token then the last through the T = 1 decode step. Its
    file holds the fused attn_qkv and the [gate | up] ffn_up as llama.cpp
    writes them."""
    gold = np.load(os.path.join(FIXDIR, "phi3-tiny-golden.npz"))
    tokens = gold["tokens"].tolist()
    gf = GGUFFile(os.path.join(FIXDIR, "phi3-tiny-f32.gguf"))
    cfg = config_from_gguf(gf.metadata)
    w = load_weights(gf, cfg)
    assert {"wqkv", "wgu"} <= set(w["layers"][0]) and "wq" not in w["layers"][0]
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


# ---------------------------------------------------------------------------
# the tiny models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{(model, "q4_k" | "q4_k_m" | "f32"): path}: the uniform Q4_K file,
    the Q4_K_M file and the Q4_K file's float32 twin of each tiny model."""
    d = tmp_path_factory.mktemp("phi")
    out = {}
    for model in MODELS:
        out[model, "q4_k"] = build_synth_gguf(str(d / f"{model}.gguf"), model, seed=3)
        out[model, "q4_k_m"] = build_synth_gguf(str(d / f"{model}-q4_k_m.gguf"), model, seed=3,
                                                mix="k_m")
        out[model, "f32"] = f32_twin(out[model, "q4_k"], str(d / f"{model}-f32.gguf"))
    return out


def test_mix_kind_of_a_fused_qkv():
    """llama.cpp's attn_qkv rule: Q5_K under Q4_K_M, Q6_K under Q5_K_M, Q4_K
    under Q3_K_M, the scheme elsewhere; ffn_down and the rest as for llama."""
    assert [mix_kind("attn_qkv", i, 32, "q4_k", "k_m", 1) for i in (0, 5, 31)] == ["q5_k"] * 3
    assert mix_kind("attn_qkv", 3, 32, "q5_k", "k_m", 1) == "q6_k"
    assert mix_kind("attn_qkv", 3, 32, "q3_k", "k_m", 1) == "q4_k"
    assert mix_kind("attn_qkv", 3, 32, "q2_k", "q2_k", 1) == "q2_k"
    assert mix_kind("attn_qkv", 3, 32, "q4_k", None, 1) == "q4_k"
    assert [mix_kind("ffn_down", i, 32, "q4_k", "k_m", 1) for i in (0, 4, 6, 31)] == \
        ["q6_k", "q4_k", "q6_k", "q6_k"]


@pytest.mark.parametrize("model", MODELS)
def test_tiny_phi_files_and_weights(files, model):
    """The files' metadata and tensors as llama.cpp writes them, and the
    port's weights: phi3's fused tensors kept whole, phi2's biases in the
    compute dtype, the rope frequencies from the rotary's own width."""
    gf = GGUFFile(files[model, "q4_k_m"])
    cfg = config_from_gguf(gf.metadata)
    check_supported(cfg)
    phi2 = model == "tiny-phi2"
    assert cfg.architecture == ("phi2" if phi2 else "phi3")
    assert (cfg.head_dim, cfg.effective_rope_dim) == ((80, 32) if phi2 else (96, 96))
    assert cfg.n_heads // cfg.n_kv_heads == (1 if phi2 else 2)
    assert cfg.vocab_size == (512 if phi2 else 576) and cfg.rms_norm_eps == pytest.approx(1e-5)
    kinds = {ti.name: ti.typ for ti in gf.tensor_infos}
    assert kinds["blk.0.attn_qkv.weight"] == kinds["blk.1.attn_qkv.weight"] == Q5
    assert (kinds["blk.0.ffn_down.weight"], kinds["blk.1.ffn_down.weight"]) == (Q4, Q6)
    assert kinds["output.weight"] == Q6 and kinds["token_embd.weight"] == Q4
    for dtype in (torch.float32, torch.bfloat16):
        w = load_weights(gf, cfg, compute_dtype=dtype)
        assert torch.equal(w["rope_inv_freq"], inv_freq(cfg.effective_rope_dim, 10000.0,
                                                        torch.device("cpu")))
        lw = w["layers"][0]
        q_rows = cfg.n_heads * cfg.head_dim + 2 * cfg.n_kv_heads * cfg.head_dim
        assert lw["wqkv"].shape == (q_rows, cfg.embedding_dim) and lw["wqkv"].kind == Q5
        if phi2:
            assert set(lw) == {"attn_norm", "attn_norm_b", "wqkv", "bqkv", "wo", "bo", "ffn_up",
                               "ffn_up_b", "ffn_down", "ffn_down_b"}
            for n in ("bqkv", "bo", "ffn_up_b", "ffn_down_b"):
                assert lw[n].dtype == dtype
            assert lw["attn_norm_b"].dtype == torch.float32
            assert w["final_norm_b"].dtype == torch.float32 and w["output_b"].dtype == dtype
            assert lw["ffn_up"].shape == (cfg.hidden_dim, cfg.embedding_dim)
        else:
            assert set(lw) == {"attn_norm", "ffn_norm", "wqkv", "wo", "wgu", "ffn_down"}
            assert lw["wgu"].shape == (2 * cfg.hidden_dim, cfg.embedding_dim)
            assert "output_b" not in w and "final_norm_b" not in w
        assert w["output"].kind == Q6 and w["output"].kernel_layout


def _jax_kernel_weights(path: str, vocab: int):
    """The JAX package's fused, repacked weights of a uniform Q4_K file.
    JAX's int8-activation kernels take row counts that are multiples of 256
    only (gemm_quant.py:103); tiny-phi3's 576-row lm_head gets 192 zero rows
    there (Q4_K blocks with d = 0), so that both packages multiply it with
    int8 activations, and the test reads the first 576 logits."""
    jgf = JGGUFFile(path)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jw = repack_weights(fuse_weights(jload_weights(jgf, jcfg), jcfg), jcfg)
    if vocab % 256:
        m = -(-vocab // 256) * 256
        ti = GGUFFile(path).get_tensor_info("output.weight")
        raw = np.concatenate([np.frombuffer(ti.to_numpy().tobytes(), np.uint8),
                              np.zeros((m - vocab) * jcfg.embedding_dim // 256 * 144, np.uint8)])
        jw = dict(jw, output=jgemm.repack(jto_planar(JGGMLType.Q4_K, raw,
                                                     (m, jcfg.embedding_dim))))
    return jw, jcfg


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("model", MODELS)
def test_tiny_phi_forward_matches_jax_w4a8(files, w4a8_backend, model, seed):
    """The 2-layer uniform Q4_K file against the JAX forward on its w4a8
    backend (the same Q4_K bytes, int8 activations at <= 16 rows) in
    float32: a 20-token prompt (flash at head dim 96 / 80), a 3-token chunk
    (the unfused decode form) and a decode step (the fused form). Each step
    matches JAX's at 2e-4 or, as tests/test_torch_families_q8_0.py shows for
    the Q8_0 files, differs by int8 rounding edges only: rerun with the int8
    codes of JAX's own step in place of the port's, it matches JAX's logits
    at 2e-4, at least one code was swapped, and each code it swapped is one
    step off and near an edge (x / dx within 1e-3 of n + 1/2). The codes come
    from the step as run here, through callbacks (`jax_scan_codes`), since
    JAX's op-by-op run rounds some codes otherwise than its compiled scan;
    that run's logits are the step's at 1e-5."""
    path = files[model, "q4_k"]
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    w = load_weights(gf, cfg)
    jw, jcfg = _jax_kernel_weights(path, cfg.vocab_size)
    V = cfg.vocab_size
    tokens = np.random.default_rng(seed).integers(3, V, (1, CHUNKS[-1][1]))
    jcache = JKVCache.create(jcfg, 1, 64)
    cache = KVCache.create(cfg, 1, 64)
    for lo, hi in CHUNKS:
        toks = tokens[:, lo:hi]
        before = KVCache(cache.k.clone(), cache.v.clone())
        got, quantized = port_step(w, cfg, cache, toks, lo)
        want, after = jforward(jw, jcache, jnp.asarray(toks, jnp.int32),
                               jnp.asarray([lo], jnp.int32), jcfg, jnp.float32)
        want = np.asarray(want)[..., :V]
        assert got.shape == (1, hi - lo, V)
        if np.abs(got - want).max() > TOL:
            assert hi - lo <= 16 and quantized, (lo, hi)  # an int8-activation step
            codes, logged = jax_scan_codes(jw, jcache, toks, lo, jcfg)
            np.testing.assert_allclose(logged[..., :V], want, rtol=0, atol=1e-5)
            assert len(codes) == len(quantized)
            cache = before
            got, swapped = port_step(w, cfg, cache, toks, lo, codes)
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
            assert sum(len(s[1]) for s in swapped) >= 1
            for at, ratio, mine, theirs in swapped:
                assert ((mine.int() - theirs.int()).abs() == 1).all()
                assert ((ratio - ratio.floor() - 0.5).abs() <= 1e-3).all(), ratio
        jcache = after


@pytest.mark.parametrize("model", MODELS)
def test_tiny_phi_q4_k_m_prefill_matches_jaxf32_twin(files, model):
    """The Q4_K_M file (Q5_K attn_qkv, a Q6_K ffn_down in layer 1 and a Q6_K
    output: layers the JAX package cannot stack) through the port, 32 prompt
    rows on the dequant kernels' plain versions in float32, against the JAX
    forward on the file's float32 twin at 2e-4: the port's float32 weights
    are the codec's values, so only the order of sums differs."""
    path = files[model, "q4_k_m"]
    twin = f32_twin(path, path.replace(".gguf", "-twin.gguf"))
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    w = load_weights(gf, cfg)
    jgf = JGGUFFile(twin)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jw = jload_weights(jgf, jcfg)
    tokens = np.random.default_rng(4).integers(3, cfg.vocab_size, (1, 32))
    want, _ = jforward(jw, JKVCache.create(jcfg, 1, 64), jnp.asarray(tokens, jnp.int32),
                       jnp.asarray([0], jnp.int32), jcfg, jnp.float32)
    got = forward(w, KVCache.create(cfg, 1, 64), torch.from_numpy(tokens), torch.tensor([0]),
                  cfg, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("model", MODELS)
def test_tiny_phi_f32_steps_match_jax(files, model):
    """The float32 twin, every step (prompt, chunk, decode step) at 2e-4:
    no int8 activation on either side, so no rounding edge."""
    path = files[model, "f32"]
    jgf = JGGUFFile(path)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jw = jload_weights(jgf, jcfg)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    w = load_weights(gf, cfg)
    tokens = np.random.default_rng(5).integers(3, cfg.vocab_size, (1, CHUNKS[-1][1]))
    jcache, cache = JKVCache.create(jcfg, 1, 64), KVCache.create(cfg, 1, 64)
    for lo, hi in CHUNKS:
        want, jcache = jforward(jw, jcache, jnp.asarray(tokens[:, lo:hi], jnp.int32),
                                jnp.asarray([lo], jnp.int32), jcfg, jnp.float32)
        got = forward(w, cache, torch.from_numpy(tokens[:, lo:hi]), torch.tensor([lo]), cfg,
                      torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("model", MODELS)
def test_paged_tick_matches_the_dense_step(files, model):
    """Two sequences (prompts of 9 and 20 tokens) prefilled into pool pages
    and one paged tick, against the dense forward and decode step on the
    same weights."""
    gf = GGUFFile(files[model, "q4_k"])
    cfg = config_from_gguf(gf.metadata)
    w = load_weights(gf, cfg)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, cfg.vocab_size, n) for n in (9, 20)]
    nxt = torch.tensor([5, 77])
    pool = PagedKVCache.create(cfg, 4, 2, 1, torch.float32)
    want = []
    for b, p in enumerate(prompts):
        cache = KVCache.create(cfg, 1, PAGE)
        forward(w, cache, torch.from_numpy(p[None]), torch.tensor([0]), cfg)
        want.append(decode_step(w, cache, nxt[b:b + 1, None], torch.tensor([len(p)],
                                dtype=torch.int32), cfg)[0])
        paged_prefill_chunk(w, pool, torch.from_numpy(p[None]), 0, [1 + b], cfg, torch.float32)
        pool.table[b, 0] = 1 + b
    got = paged_decode_step(w, pool, nxt, torch.tensor([9, 20], dtype=torch.int32), cfg,
                            torch.float32)
    np.testing.assert_allclose(got.numpy(), torch.stack(want).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", MODELS)
def test_runner_greedy_tokens_match_jax(files, model):
    """The same 12 greedy tokens from both Runners on the float32 twin
    (float32 compute)."""
    path = files[model, "f32"]
    want = "".join(JRunner(path, compute_dtype=jnp.float32).prefill_and_generate(PROMPT, 12))
    r = Runner(path, compute_dtype=torch.float32, device="cpu")
    got = "".join(r.prefill_and_generate(PROMPT, 12))
    assert r.metrics.counts["tokens"] == 11
    assert got == want


@pytest.mark.parametrize("model", MODELS)
def test_serving_engines_match_the_runner(files, model):
    """Both engines on the Q4_K file: three prompts through two slots give
    the Runner's greedy text, and the paged engine returns its pages."""
    r = Runner(files[model, "q4_k"], compute_dtype=torch.float32, device="cpu")
    prompts = [PROMPT, "a", "w5 w6 w7 " * 4]
    want = []
    for p in prompts:
        r.reset()
        want.append("".join(r.prefill_and_generate(p, 8)))
    assert ServingEngine(r, n_slots=2, seq_len=256).generate(prompts, max_tokens=8) == want
    paged = PagedServingEngine(r, n_slots=2, n_pages=8, seq_len=256)
    free = paged.pages_free()
    assert paged.generate(prompts, max_tokens=8) == want
    assert paged.pages_free() == free


@pytest.mark.parametrize("model", MODELS)
def test_from_jax_weights_carries_phi(files, model):
    """The JAX package's planar weights of the Q4_K file, carried across:
    phi3's split q, k, v and gate, up planes join again into the file's
    "wqkv" and "wgu" bit for bit, phi2's biases and LayerNorm weights
    arrive, and the forward equals the GGUF-loaded one's."""
    path = files[model, "q4_k"]
    jgf = JGGUFFile(path)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jw = jload_weights(jgf, jcfg, layout="planar")
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    for dtype in (torch.float32, torch.bfloat16):
        got = from_jax_weights(jw, cfg, compute_dtype=dtype)
        direct = load_weights(gf, cfg, compute_dtype=dtype)
        assert set(got) == set(direct)
        for a, b in zip(got["layers"], direct["layers"]):
            assert set(a) == set(b)
            for n in a:
                if isinstance(a[n], torch.Tensor):
                    assert a[n].dtype == b[n].dtype and torch.equal(a[n], b[n]), n
                else:
                    assert a[n].shape == b[n].shape and set(a[n].planes) == set(b[n].planes)
                    for p in a[n].planes:
                        assert torch.equal(a[n].planes[p], b[n].planes[p]), (n, p)
        for n in ("final_norm", "final_norm_b", "output_b", "rope_inv_freq"):
            assert (n in got) == (n in direct) and (n not in got or torch.equal(got[n], direct[n]))
    tokens = torch.from_numpy(np.random.default_rng(6).integers(3, cfg.vocab_size, (1, 20)))
    want = forward(direct, KVCache.create(cfg, 1, 64, torch.bfloat16), tokens, torch.tensor([0]),
                   cfg, torch.bfloat16)
    assert torch.equal(forward(got, KVCache.create(cfg, 1, 64, torch.bfloat16), tokens,
                               torch.tensor([0]), cfg, torch.bfloat16), want)


# ---------------------------------------------------------------------------
# the lm_head's 576 rows: a multiple of 64, not of 128 (Phi-3-mini's 32064)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", [Q4, Q6], ids=["q4_k", "q6_k"])
def test_plain_matmuls_hold_at_576_rows(kind):
    """The dequant and int8-activation plain versions at tiny-phi3's 576-row
    lm_head against the JAX Pallas kernels (interpret mode) on the same
    weight with 192 zero rows added (JAX's kernels take multiples of 256
    rows), its first 576 columns: 20 rows at 2e-5 of max|out| (float32
    weights and sums in another order), 1 and 8 rows at 1e-5 (the same int8
    activations)."""
    M, K, pad = 576, 768, 192
    blocks = {Q4: q4k_blocks, Q6: q6k_blocks}[kind]
    raw = blocks(np.random.default_rng(8), M * K, 0.05).tobytes()
    zero = bytes(pad * K // 256 * len(blocks(np.random.default_rng(0), 256, 1.0).tobytes()))
    jqt = jgemm.repack(jto_planar(JGGMLType(int(kind)), raw + zero, (M + pad, K)))
    qt = to_kernel_layout(to_planar(kind, raw, (M, K)))
    for rows, act_quant, tol in ((20, False, 2e-5), (1, True, 1e-5), (8, True, 1e-5)):
        x = np.random.default_rng(rows).standard_normal((rows, K)).astype(np.float32)
        want = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x), jqt, jnp.float32,
                                               act_quant=act_quant))[:, :M]
        got = gemm_quant.qmatmul_quant(torch.from_numpy(x), qt).numpy()
        assert got.shape == (rows, M)
        assert np.abs(got - want).max() / np.abs(want).max() <= tol

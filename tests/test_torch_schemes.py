"""Port parity for the Q8_0, Q6_K, Q5_K, Q4_0, Q3_K and Q2_K weights: the
planes against the codec, each plain matmul against the JAX Pallas kernel of
the same scheme (interpret mode on the CPU) and the 2-layer forward under
backend `w4a8` (greedy Runner tokens from one GGUF:
tests/test_torch_schemes_runner.py); the 2-layer forward of Q4_K layers with
a Q6_K lm_head, as llama.cpp's Q4_K_M files carry it (its Runner check is
tests/test_torch_schemes_lm_head.py); and llama.cpp's mixed Q4_K_M, Q3_K_M
and Q2_K files, whose layers differ in kind, against the JAX forward on
their float32 twins. The experts of these schemes:
tests/test_torch_moe_schemes.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.gguf.reader import GGUFFile as JGGUFFile
from crabml_tpu.models.config import config_from_gguf as jconfig_from_gguf
from crabml_tpu.models.forward import KVCache as JKVCache
from crabml_tpu.models.forward import forward as jforward
from crabml_tpu.models.synthetic import make_weights, tiny_config
from crabml_tpu.models.weights import fuse_weights, repack_weights
from crabml_tpu.models.weights import load_weights as jload_weights
from crabml_tpu.ops import matmul as jmm
from crabml_tpu.ops.pallas import gemm_quant as jgemm
from crabml_tpu.quant.codecs import quantize as jquantize
from crabml_tpu.quant.planar import to_planar as jto_planar
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.gguf.writer import GGUFWriter
from crabml_tpu_torch.models.config import ModelConfig, config_from_gguf
from crabml_tpu_torch.models.forward import KVCache, forward
from crabml_tpu_torch.models.weights import from_jax_weights, load_weights
from crabml_tpu_torch.ops.cuda import gemm_quant
from crabml_tpu_torch.quant import codecs
from crabml_tpu_torch.quant.qtensor import dequantize, to_kernel_layout, to_planar

KINDS = (GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q5_K, GGMLType.Q4_0, GGMLType.Q3_K,
         GGMLType.Q2_K)
SCHEMES = pytest.mark.parametrize("kind", KINDS,
                                  ids=["q8_0", "q6_k", "q5_k", "q4_0", "q3_k", "q2_k"])
M, K = 512, 1024
# tests/test_torch_model.py's widths: head dim 128 and a 128-aligned cache
CFG = dict(embedding_dim=512, hidden_dim=512, n_heads=4, n_kv_heads=2, n_layers=2,
           vocab_size=512, seq_len=256)
PREFILL = 32
# the kinds whose JAX decode step is compared run op by op (jax.disable_jit):
# jitted, it moves off its own op-by-op logits on the Q6_K model. On the
# Q4_0 model the op-by-op run is the one that moves: a Q4_0 embedding row
# makes layer 0's int8 activations land on exact ties (x/dx = 63.5 where
# an element is 4 and amax 8 steps of d), which a one-ulp difference in the
# op-by-op run breaks the other way (9.2e-3 in the logits); the jitted run
# and the port break them alike.
OP_BY_OP_DECODE = {GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q4_K}
# the kinds whose 2-layer models take norm weights drawn at random, as a
# checkpoint's are, instead of the random models' ones: with unit norms a
# Q3_K embedding row puts layer 0's int8 activations on exact ties (x/dx =
# 63.5 where a value is 2 and its group's largest 4: one scale per 16 for
# both), which one ulp of rms_norm's float32 sum (torch and XLA sum in other
# orders) flips: 41 of 512 values of the tested token
# (test_q3k_unit_norms_put_int8_activations_on_ties). The port then differs
# from every JAX decode by 1.4e-2, and the JAX package's own jitted,
# op-by-op and unfused-attention decodes differ from one another (by up to
# 2e-3 on the Q2_K model). With random norms the port agrees with the jitted
# and the op-by-op JAX decode alike, to 6e-6.
RANDOM_NORMS = {GGMLType.Q3_K, GGMLType.Q2_K}


@pytest.fixture
def w4a8_backend():
    jmm.set_backend("w4a8")
    try:
        yield
    finally:
        jmm.set_backend("xla")


@pytest.fixture
def fast_q6k(monkeypatch):
    """The JAX package's random models quantize each matrix with the
    codec, whose Q6_K, Q3_K and Q2_K encoders loop over blocks in Python
    (minutes for a tiny model) and whose Q5_K encoder takes seconds a matrix.
    Here their matrices in those kinds are random blocks instead (the port's
    synthetic writer, seeded from the values): valid bytes that both
    packages read alike."""
    import crabml_tpu.models.synthetic as jsynth

    from crabml_tpu_torch.tools.synth_gguf import q2k_blocks, q3k_blocks, q5k_blocks, q6k_blocks

    encode = jsynth.quantize
    fast = {JGGMLType.Q6_K: q6k_blocks, JGGMLType.Q5_K: q5k_blocks,
            JGGMLType.Q3_K: q3k_blocks, JGGMLType.Q2_K: q2k_blocks}

    def quantize(typ, x):
        if typ not in fast:
            return encode(typ, x)
        rng = np.random.default_rng(np.frombuffer(x.tobytes()[:32], np.uint32))
        return fast[typ](rng, x.size, float(x.std())).tobytes()

    monkeypatch.setattr(jsynth, "quantize", quantize)


def _raw(kind, shape, seed):
    """A matrix of `shape` in `kind`: normal weights through the codec, or
    random blocks (`_blocks`) for the kinds whose encoder is slow beyond Q6_K
    and Q5_K's tiny sizes."""
    if kind in (GGMLType.Q3_K, GGMLType.Q2_K):
        return _blocks(kind, shape, seed)
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)
    return jquantize(JGGMLType(int(kind)), w)


def _blocks(kind, shape, seed):
    """Random valid blocks of `kind` for a matrix of `shape` (synth_gguf's)."""
    from crabml_tpu_torch.tools.synth_gguf import SCHEMES as SYNTH

    _, blocks = next(v for v in SYNTH.values() if v[0] == kind)
    return blocks(np.random.default_rng(seed), int(np.prod(shape)), 0.05).tobytes()


@pytest.fixture(scope="module")
def weights():
    """{kind: (JAX kernel-layout QTensor, port kernel planes)} from the same bytes."""
    out = {}
    for kind in KINDS:
        raw = _raw(kind, (M, K), 7)
        jqt = jgemm.repack(jto_planar(JGGMLType(int(kind)), raw, (M, K)))
        out[kind] = jqt, to_kernel_layout(to_planar(kind, raw, (M, K)))
    return out


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _kernel_planes(qt):
    """The kernel planes in the order the plain versions take them."""
    return [qt.planes[n] for n in gemm_quant._KERNEL_PLANES[qt.kind]]


@SCHEMES
def test_planes_dequantize_bit_exact(kind):
    """Canonical and kernel planes (float32 scales) dequantize to the
    codec's float32 values bit for bit; a stack of experts too."""
    raw = _raw(kind, (3, 256, 512), 1)
    want = codecs.dequantize(kind, raw).reshape(3, 256, 512)
    qt = to_planar(kind, raw, (3, 256, 512))
    assert qt.shape == (3, 256, 512)
    np.testing.assert_array_equal(dequantize(qt).numpy(), want)
    np.testing.assert_array_equal(dequantize(to_kernel_layout(qt)).numpy(), want)
    names = {GGMLType.Q8_0: {"qs", "dsub"}, GGMLType.Q6_K: {"ql", "qh", "dsub"},
             GGMLType.Q5_K: {"qs", "qh", "dsub", "msub"}, GGMLType.Q4_0: {"qs", "dsub"},
             GGMLType.Q3_K: {"qs", "hb", "sc", "d"},
             GGMLType.Q2_K: {"qs", "scm", "d", "dmin"}}[kind]
    assert set(to_kernel_layout(qt).planes) == names


@SCHEMES
def test_dequant_plain_matches_pallas(weights, kind):
    """32 rows, float32: tolerance 2e-5 of max|out| (both compute the
    weights in float32 and sum in float32, in another order)."""
    jqt, qt = weights[kind]
    x = np.random.default_rng(1).standard_normal((32, K)).astype(np.float32)
    want = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x), jqt, jnp.float32, act_quant=False))
    xt = torch.from_numpy(x)
    name = gemm_quant.DEQUANT_FORMS[kind]
    got = getattr(gemm_quant, f"{name}_plain")(xt, *_kernel_planes(qt))
    wrapper = getattr(gemm_quant, name)
    assert _rel(got.numpy(), want) <= 2e-5
    # the wrapper takes the plain version for a CPU tensor, and so does the router
    np.testing.assert_array_equal(wrapper(xt, qt).numpy(), got.numpy())
    np.testing.assert_array_equal(gemm_quant.qmatmul_quant(xt, qt).numpy(), got.numpy())


@SCHEMES
@pytest.mark.parametrize("rows", [1, 8])
def test_w4a8_plain_matches_pallas(weights, kind, rows):
    """Tolerance 1e-5 of max|out|: the same int8 activations (per 16-group
    for Q6_K, 32 for the others, as the JAX kernel's scheme.gr) and exact
    integer group dots; the TPU kernel's -128 centring and offset or minimum
    correction round differently in float32 than dsub*dx*dot + msub*sx
    (msub = -32*dsub for Q6_K, -8*dsub for Q4_0)."""
    jqt, qt = weights[kind]
    x = np.random.default_rng(2 + rows).standard_normal((rows, K)).astype(np.float32)
    want = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x), jqt, jnp.float32, act_quant=True))
    xt = torch.from_numpy(x)
    plain = getattr(gemm_quant, f"{gemm_quant.W4A8_FORMS[kind]}_plain")
    got = plain(xt, *_kernel_planes(qt))
    assert _rel(got.numpy(), want) <= 1e-5
    np.testing.assert_array_equal(gemm_quant.qmm_w4a8(xt, qt).numpy(), got.numpy())
    np.testing.assert_array_equal(gemm_quant.qmatmul_quant(xt, qt).numpy(), got.numpy())


def test_quantize_activation_per_16_group():
    """Q6_K's activations: one scale per 16 elements, the int8 values
    within 127 and dx * xq within half a step of x."""
    x = torch.randn(3, 512)
    xq, dx, sx = gemm_quant.quantize_activation(x, 16)
    assert dx.shape == sx.shape == (3, 32) and xq.abs().max() <= 127
    back = xq.float().reshape(3, 32, 16) * dx[..., None]
    assert (back - x.reshape(3, 32, 16)).abs().max() <= 0.5 * dx.max() + 1e-7
    torch.testing.assert_close(sx, dx * xq.float().reshape(3, 32, 16).sum(-1))


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f: getattr(jcfg, f) for f in ModelConfig.__dataclass_fields__})


def _jax_weights(kind, lm_head):
    """make_weights in `kind`, the output matrix in `lm_head`; the norms
    drawn from U(0.5, 1.5) for the RANDOM_NORMS kinds."""
    jcfg = tiny_config(**CFG)
    jw = make_weights(jcfg, JGGMLType(int(kind)), seed=5)
    if lm_head != kind:
        shape = (jcfg.vocab_size, jcfg.embedding_dim)
        jw["output"] = jto_planar(JGGMLType(int(lm_head)), _blocks(lm_head, shape, 9), shape)
    if kind in RANDOM_NORMS:
        rng = np.random.default_rng(11)
        for n in ("attn_norm", "ffn_norm"):
            jw["layers"][n] = rng.uniform(0.5, 1.5, np.shape(jw["layers"][n])).astype(np.float32)
        jw["final_norm"] = rng.uniform(0.5, 1.5, np.shape(jw["final_norm"])).astype(np.float32)
    return jcfg, jw


def _forward_matches(kind, lm_head):
    jcfg, jw = _jax_weights(kind, lm_head)
    jk = repack_weights(fuse_weights(jw, jcfg), jcfg)
    cfg = _port_cfg(jcfg)
    pw = from_jax_weights(jw, cfg)
    assert pw["layers"][0]["wqkv"].kind == kind and pw["output"].kind == lm_head
    assert pw["output"].kernel_layout
    tokens = np.random.default_rng(0).integers(3, jcfg.vocab_size, (1, PREFILL + 1))
    jcache = JKVCache.create(jcfg, 1, jcfg.seq_len)
    cache = KVCache.create(cfg, 1, jcfg.seq_len)
    for toks, p in ((tokens[:, :PREFILL], 0), (tokens[:, PREFILL:], PREFILL)):
        with jax.disable_jit(p > 0 and kind in OP_BY_OP_DECODE):
            want, jcache = jforward(jk, jcache, jnp.asarray(toks, jnp.int32),
                                    jnp.asarray([p], jnp.int32), jcfg, jnp.float32)
        got = forward(pw, cache, torch.from_numpy(toks), torch.tensor([p]), cfg, torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@SCHEMES
def test_forward_matches_jax_w4a8(kind, w4a8_backend, fast_q6k):
    """Tolerance 2e-4 (tests/test_model.py:41), float32 on both sides: 32
    prefill rows take the scheme's dequant kernel, the decode step its
    int8-activation form. The JAX decode step runs op by op (disable_jit)
    for Q8_0 and Q6_K: on the Q6_K model its jitted logits differ from its
    own op-by-op ones by 1.4e-2, while each of its jitted matmuls alone
    equals the eager call; the port agrees with the op-by-op run to 1e-6.
    For Q5_K, Q4_0, Q3_K and Q2_K it runs jitted (OP_BY_OP_DECODE: the Q4_0
    model's exact int8 ties); the Q3_K and Q2_K models have random norm
    weights (RANDOM_NORMS)."""
    _forward_matches(kind, kind)


def test_q3k_unit_norms_put_int8_activations_on_ties(fast_q6k):
    """Why RANDOM_NORMS: with the random model's unit norms, the decode
    step's first int8 activations of a Q3_K model (attn_norm of an embedding
    row, quantized per 16) lie on exact ties, and every value on which the
    port and the JAX package's op-by-op run differ is such a tie, one step
    apart: the ulp by which torch's and XLA's float32 rms_norm differ picks
    the side."""
    from crabml_tpu.ops.norm import rms_norm as jrms_norm

    from crabml_tpu_torch.ops.matmul import embedding_lookup
    from crabml_tpu_torch.ops.norm import rms_norm

    jcfg = tiny_config(**CFG)
    jw = make_weights(jcfg, JGGMLType.Q3_K, seed=5)
    pw = from_jax_weights(jw, _port_cfg(jcfg))
    tok = np.random.default_rng(0).integers(3, jcfg.vocab_size, (1, PREFILL + 1))[:, -1:]
    x = embedding_lookup(pw["token_embed"], torch.from_numpy(tok), torch.float32)
    norm = pw["layers"][0]["attn_norm"]
    h = rms_norm(x, norm, jcfg.rms_norm_eps).reshape(1, -1)
    with jax.disable_jit():
        hj = np.asarray(jrms_norm(jnp.asarray(x.numpy()), jnp.asarray(norm.numpy()),
                                  jcfg.rms_norm_eps)).reshape(1, -1)
    assert np.abs(h.numpy() - hj).max() <= 2.5e-7  # the two norms differ by ulps
    xq, dx, _ = gemm_quant.quantize_activation(h, 16)
    xqj, _, _ = jgemm.quantize_activation(jnp.asarray(hj), 16, 512)
    ratio = (h.reshape(1, -1, 16) / dx[..., None]).reshape(1, -1)
    tie = (ratio - ratio.floor() - 0.5).abs() <= 1e-5
    differ = xq.numpy() != np.asarray(xqj)
    assert tie.sum() >= 32 and differ.any()
    assert (tie.numpy() | ~differ).all()
    assert np.abs(xq.numpy().astype(int) - np.asarray(xqj).astype(int)).max() == 1


def test_forward_q4k_with_q6k_lm_head_matches_jax(w4a8_backend):
    _forward_matches(GGMLType.Q4_K, GGMLType.Q6_K)


Q4, Q5, Q6 = GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K
Q3, Q2 = GGMLType.Q3_K, GGMLType.Q2_K
# llama.cpp's mixed layouts on the 2-layer tiny shape (2 heads, 1 kv head):
# the tensors whose type differs from the file's scheme
K_M_TINY = {"blk.1.ffn_down": Q6, "blk.1.attn_v": Q6}  # use_more_bits(1, 2)
Q3_K_M_TINY = {"blk.0.attn_v": Q5, "blk.1.attn_v": Q5, "blk.0.attn_output": Q4,
               "blk.1.attn_output": Q4, "blk.0.ffn_down": Q4, "blk.1.ffn_down": Q4}
Q2_K_TINY = {"blk.0.attn_v": Q3, "blk.1.attn_v": Q3, "blk.0.attn_output": Q3,
             "blk.1.attn_output": Q3, "blk.0.ffn_down": Q3, "blk.1.ffn_down": Q3}


def test_synth_gguf_writes_each_scheme(tmp_path):
    """tools/synth_gguf.py: every matrix in the scheme, the lm_head in its
    own; with a mix the types of llama.cpp's layout (Q4_K_M / Q5_K_M: attn_v
    and ffn_down in Q6_K where use_more_bits holds, layer 1 of 2; Q3_K_M and
    Q2_K: the tables above) and a Q6_K output; weights of standard deviation
    ~1/sqrt(k); the file loads (q|k|v and gate|up left apart in the mixed
    layer)."""
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    for scheme, lm_head, mix, kind, head, other in (
            ("q8_0", None, None, GGMLType.Q8_0, GGMLType.Q8_0, {}),
            ("q6_k", None, None, GGMLType.Q6_K, GGMLType.Q6_K, {}),
            ("q4_k", "q6_k", None, GGMLType.Q4_K, GGMLType.Q6_K, {}),
            ("q5_k", None, None, GGMLType.Q5_K, GGMLType.Q5_K, {}),
            ("q4_0", None, None, GGMLType.Q4_0, GGMLType.Q4_0, {}),
            ("q3_k", None, None, Q3, Q3, {}),
            ("q2_k", None, None, Q2, Q2, {}),
            ("q4_k", None, "k_m", GGMLType.Q4_K, GGMLType.Q6_K, K_M_TINY),
            ("q5_k", None, "k_m", GGMLType.Q5_K, GGMLType.Q6_K, K_M_TINY),
            ("q3_k", None, "k_m", Q3, Q6, Q3_K_M_TINY),
            ("q2_k", None, "q2_k", Q2, Q6, Q2_K_TINY)):
        path = build_synth_gguf(str(tmp_path / f"{scheme}-{mix}.gguf"), "tiny", seed=1,
                                scheme=scheme, lm_head=lm_head, mix=mix)
        gf = GGUFFile(path)
        for name in (f"blk.{l}.{t}" for l in (0, 1) for t in
                     ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_up", "ffn_down")):
            want = other.get(name, kind)
            assert gf.get_tensor_info(f"{name}.weight").typ == want, (scheme, mix, name)
        assert gf.get_tensor_info("token_embd.weight").typ == kind
        assert gf.get_tensor_info("output.weight").typ == head
        w = load_weights(gf, config_from_gguf(gf.metadata))
        down = dequantize(w["layers"][0]["ffn_down"])
        assert 0.9 < down.std().item() * np.sqrt(down.shape[1]) < 1.1
        assert w["output"].kind == head and w["output"].kernel_layout
        l1 = w["layers"][1]
        assert ("wqkv" in l1) == (mix is None) and ("wgu" in l1)
        assert all(q.kernel_layout for q in l1.values() if hasattr(q, "planes"))


def _f32_twin(src: str, dst: str):
    """Copy a GGUF with every tensor dequantized to F32 (the codec's values)."""
    gf = GGUFFile(src)
    w = GGUFWriter()
    for k, v in gf.metadata.as_dict().items():
        w.add_metadata(k, v, gf.metadata.value_type(k))
    for ti in gf.tensor_infos:
        vals = codecs.dequantize(ti.typ, ti.to_numpy(), ti.n_elems).astype(np.float32)
        w.add_tensor(ti.name, GGMLType.F32, ti.shape, vals)
    w.write(dst)


def _mixed_forward_matches(tmp_path, name, scheme, mix, seed, kinds):
    """The 2-layer file `--scheme scheme --mix mix` through the port, 32
    prompt rows (the dequant route), float32 with float32 scales, against the
    JAX forward on the file's F32 twin (the JAX package cannot stack layers
    of different kinds), tolerance 2e-4 (tests/test_model.py:41): the port's
    float32 weights are the codec's values exactly, so only the order of
    float32 sums differs. `kinds`: per layer, each port matrix's kind.
    Returns the loaded weights."""
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    path = build_synth_gguf(str(tmp_path / f"{name}.gguf"), "tiny", seed=seed, scheme=scheme,
                            mix=mix)
    twin = str(tmp_path / f"{name}-f32.gguf")
    _f32_twin(path, twin)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    w = load_weights(gf, cfg)
    for lw, want in zip(w["layers"], kinds):
        assert {n: lw[n].kind for n in want} == want
    jgf = JGGUFFile(twin)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jw = jload_weights(jgf, jcfg)
    tokens = np.random.default_rng(2).integers(3, cfg.vocab_size, (1, PREFILL))
    want, _ = jforward(jw, JKVCache.create(jcfg, 1, 256), jnp.asarray(tokens, jnp.int32),
                       jnp.asarray([0], jnp.int32), jcfg, jnp.float32)
    got = forward(w, KVCache.create(cfg, 1, 256), torch.from_numpy(tokens), torch.tensor([0]),
                  cfg, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    return w


def test_mixed_k_m_forward_matches_jax_f32_twin(tmp_path):
    """A 2-layer Q4_K_M file (`--scheme q4_k --mix k_m`: layer 1's attn_v and
    ffn_down and the output in Q6_K; q, k, v apart in layer 1) against the
    JAX forward on its F32 twin (`_mixed_forward_matches`)."""
    w = _mixed_forward_matches(tmp_path, "q4_k_m", "q4_k", "k_m", 6,
                               [{"wqkv": Q4, "ffn_down": Q4},
                                {"wq": Q4, "wk": Q4, "wv": Q6, "ffn_down": Q6}])
    assert {n for n in w["layers"][1]} >= {"wq", "wk", "wv"} and "wqkv" in w["layers"][0]
    assert w["output"].kind == Q6


def test_mixed_q3_k_m_forward_matches_jax_f32_twin(tmp_path):
    """A 2-layer Q3_K_M file (`--scheme q3_k --mix k_m`: Q3_K q, k, gate|up
    and embedding, Q5_K attn_v in layers 0 and 1, Q4_K attn_output and (n/16
    = 0) ffn_down, a Q6_K output; q, k, v apart in both layers) against the
    JAX forward on its F32 twin (`_mixed_forward_matches`)."""
    w = _mixed_forward_matches(tmp_path, "q3_k_m", "q3_k", "k_m", 7,
                               [{"wq": Q3, "wk": Q3, "wv": Q5, "wo": Q4, "wgu": Q3,
                                 "ffn_down": Q4}] * 2)
    assert w["token_embed"].kind == Q3 and w["output"].kind == Q6


def test_mixed_q2_k_forward_matches_jax_f32_twin(tmp_path):
    """A 2-layer llama.cpp Q2_K file (`--scheme q2_k --mix q2_k`: Q2_K q, k,
    gate|up and embedding, Q3_K attn_v (2 heads a kv head, under 4),
    attn_output and ffn_down, a Q6_K output; q, k, v apart in both layers)
    against the JAX forward on its F32 twin (`_mixed_forward_matches`)."""
    w = _mixed_forward_matches(tmp_path, "q2_k", "q2_k", "q2_k", 8,
                               [{"wq": Q2, "wk": Q2, "wv": Q3, "wo": Q3, "wgu": Q2,
                                 "ffn_down": Q3}] * 2)
    assert w["token_embed"].kind == Q2 and w["output"].kind == Q6


@pytest.mark.parametrize("mix,scheme", [("k_m", "q3_k"), ("q2_k", "q2_k"), ("k_m", "q5_k")])
def test_mix_kind_at_7b_depth(mix, scheme):
    """synth_gguf.mix_kind at the 7B shape (32 layers, 32 heads over 8 kv
    heads), the depth of the card's 7b-q3_k_m and 7b-q5_k_m paths and the 8
    layers of 7b-q2_k: Q3_K_M's attn_v is Q5_K in layers 0 and 1, its
    ffn_down Q5_K below n/16 = 2; Q2_K's attn_v is Q4_K (n_gqa 4); Q5_K_M's
    use_more_bits layers (16 of 32) take Q6_K."""
    from crabml_tpu_torch.tools.synth_gguf import mix_kind

    n = 8 if mix == "q2_k" else 32
    got = {t: [mix_kind(t, i, n, scheme, mix, 4) for i in range(n)]
           for t in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up",
                     "ffn_down")}
    if mix == "q2_k":
        want = {"attn_v": ["q4_k"] * n, "attn_output": ["q3_k"] * n, "ffn_down": ["q3_k"] * n}
    elif scheme == "q3_k":
        want = {"attn_v": ["q5_k"] * 2 + ["q4_k"] * 30, "attn_output": ["q4_k"] * n,
                "ffn_down": ["q5_k"] * 2 + ["q4_k"] * 30}
    else:
        more = ["q6_k" if i < 4 or i >= 28 or (i - 4) % 3 == 2 else "q5_k" for i in range(n)]
        want = {"attn_v": more, "attn_output": ["q5_k"] * n, "ffn_down": more}
        assert more.count("q6_k") == 16
    for t, kinds in got.items():
        assert kinds == want.get(t, [scheme] * n), t


def test_w8_planes_attach_to_a_mixed_file(tmp_path):
    """augment_w8_weights on a Q4_K_M file, whose layers hold different
    names (layer 0 a fused wqkv, layer 1 wq, wk, wv apart): each eligible
    matrix of each layer gains its W8 planes (256-row multiples: wq, not the
    128-row wk / wv), and a layer without a name is left alone."""
    from crabml_tpu_torch.models.weights import augment_w8_weights
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    path = build_synth_gguf(str(tmp_path / "q4_k_m.gguf"), "tiny", seed=6, scheme="q4_k",
                            mix="k_m")
    gf = GGUFFile(path)
    w = augment_w8_weights(load_weights(gf, config_from_gguf(gf.metadata)))
    l0, l1 = w["layers"]
    assert "wqkv" in l0 and "wq" not in l0 and "wqkv" not in l1
    assert all("w8" in l0[n].planes for n in ("wqkv", "wo", "wgu", "ffn_down"))
    assert all("w8" in l1[n].planes for n in ("wq", "wo", "wgu", "ffn_down"))
    assert not any("w8" in l1[n].planes for n in ("wk", "wv"))
    assert "w8" in w["output"].planes

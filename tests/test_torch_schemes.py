"""Port parity for the Q8_0 and Q6_K weights: the planes against the codec,
each plain matmul against the JAX Pallas kernel of the same scheme
(interpret mode on the CPU), the 2-layer forward under backend `w4a8`, and
greedy Runner tokens from one GGUF; the 2-layer forward of Q4_K layers with
a Q6_K lm_head, as llama.cpp's Q4_K_M files carry it (its Runner check is
tests/test_torch_schemes_lm_head.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.models.forward import KVCache as JKVCache
from crabml_tpu.models.forward import forward as jforward
from crabml_tpu.models.synthetic import make_weights, tiny_config, write_synthetic_gguf
from crabml_tpu.models.weights import fuse_weights, repack_weights
from crabml_tpu.ops import matmul as jmm
from crabml_tpu.ops.pallas import gemm_quant as jgemm
from crabml_tpu.quant.codecs import quantize as jquantize
from crabml_tpu.quant.planar import to_planar as jto_planar
from crabml_tpu.runtime.runner import Runner as JRunner
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.models.config import ModelConfig
from crabml_tpu_torch.models.forward import KVCache, forward
from crabml_tpu_torch.models.weights import from_jax_weights, load_weights
from crabml_tpu_torch.ops.cuda import gemm_quant
from crabml_tpu_torch.quant import codecs
from crabml_tpu_torch.quant.qtensor import dequantize, to_kernel_layout, to_planar
from crabml_tpu_torch.runtime.runner import Runner

SCHEMES = pytest.mark.parametrize("kind", [GGMLType.Q8_0, GGMLType.Q6_K], ids=["q8_0", "q6_k"])
M, K = 512, 1024
# tests/test_torch_model.py's widths: head dim 128 and a 128-aligned cache
CFG = dict(embedding_dim=512, hidden_dim=512, n_heads=4, n_kv_heads=2, n_layers=2,
           vocab_size=512, seq_len=256)
PREFILL = 32
PROMPT = "tok7 tok99 tok3 tok250 tok17"


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
    codec, whose Q6_K encoder loops over blocks in Python (minutes for a
    tiny model). Here its Q6_K matrices are random blocks instead (the
    port's synthetic writer, seeded from the values): valid Q6_K bytes that
    both packages read alike."""
    import crabml_tpu.models.synthetic as jsynth

    from crabml_tpu_torch.tools.synth_gguf import q6k_blocks

    encode = jsynth.quantize

    def quantize(typ, x):
        if typ != JGGMLType.Q6_K:
            return encode(typ, x)
        rng = np.random.default_rng(np.frombuffer(x.tobytes()[:32], np.uint32))
        return q6k_blocks(rng, x.size, float(x.std())).tobytes()

    monkeypatch.setattr(jsynth, "quantize", quantize)


def _raw(kind, shape, seed):
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
    for kind in (GGMLType.Q8_0, GGMLType.Q6_K):
        raw = _raw(kind, (M, K), 7)
        jqt = jgemm.repack(jto_planar(JGGMLType(int(kind)), raw, (M, K)))
        out[kind] = jqt, to_kernel_layout(to_planar(kind, raw, (M, K)))
    return out


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


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
    names = {GGMLType.Q8_0: {"qs", "dsub"}, GGMLType.Q6_K: {"ql", "qh", "dsub"}}[kind]
    assert set(to_kernel_layout(qt).planes) == names


@SCHEMES
def test_dequant_plain_matches_pallas(weights, kind):
    """32 rows, float32: tolerance 2e-5 of max|out| (both compute the
    weights in float32 and sum in float32, in another order)."""
    jqt, qt = weights[kind]
    x = np.random.default_rng(1).standard_normal((32, K)).astype(np.float32)
    want = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x), jqt, jnp.float32, act_quant=False))
    p = qt.planes
    xt = torch.from_numpy(x)
    if kind == GGMLType.Q8_0:
        got = gemm_quant.qmm_q8_0_plain(xt, p["qs"], p["dsub"])
        wrapper = gemm_quant.qmm_q8_0
    else:
        got = gemm_quant.qmm_q6k_plain(xt, p["ql"], p["qh"], p["dsub"])
        wrapper = gemm_quant.qmm_q6k
    assert _rel(got.numpy(), want) <= 2e-5
    # the wrapper takes the plain version for a CPU tensor, and so does the router
    np.testing.assert_array_equal(wrapper(xt, qt).numpy(), got.numpy())
    np.testing.assert_array_equal(gemm_quant.qmatmul_quant(xt, qt).numpy(), got.numpy())


@SCHEMES
@pytest.mark.parametrize("rows", [1, 8])
def test_w4a8_plain_matches_pallas(weights, kind, rows):
    """Tolerance 1e-5 of max|out|: the same int8 activations (per 16-group
    for Q6_K, 32 for Q8_0, as the JAX kernel's scheme.gr) and exact integer
    group dots; the TPU kernel's -128 centring and offset correction round
    differently in float32 than dsub*dx*dot - 32*dsub*sx."""
    jqt, qt = weights[kind]
    x = np.random.default_rng(2 + rows).standard_normal((rows, K)).astype(np.float32)
    want = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x), jqt, jnp.float32, act_quant=True))
    p = qt.planes
    xt = torch.from_numpy(x)
    if kind == GGMLType.Q8_0:
        got = gemm_quant.qmm_w4a8_q8_0_plain(xt, p["qs"], p["dsub"])
    else:
        got = gemm_quant.qmm_w4a8_q6k_plain(xt, p["ql"], p["qh"], p["dsub"])
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
    """make_weights in `kind`, the output matrix in `lm_head`."""
    jcfg = tiny_config(**CFG)
    jw = make_weights(jcfg, JGGMLType(int(kind)), seed=5)
    if lm_head != kind:
        shape = (jcfg.vocab_size, jcfg.embedding_dim)
        jw["output"] = jto_planar(JGGMLType(int(lm_head)), _blocks(lm_head, shape, 9), shape)
    return jcfg, jw


def _forward_matches(kind, lm_head):
    jcfg, jw = _jax_weights(kind, lm_head)
    jk = repack_weights(fuse_weights(jw, jcfg), jcfg)
    cfg = _port_cfg(jcfg)
    pw = from_jax_weights(jw)
    assert pw["layers"][0]["wqkv"].kind == kind and pw["output"].kind == lm_head
    assert pw["output"].kernel_layout
    tokens = np.random.default_rng(0).integers(3, jcfg.vocab_size, (1, PREFILL + 1))
    jcache = JKVCache.create(jcfg, 1, jcfg.seq_len)
    cache = KVCache.create(cfg, 1, jcfg.seq_len)
    for toks, p in ((tokens[:, :PREFILL], 0), (tokens[:, PREFILL:], PREFILL)):
        with jax.disable_jit(p > 0):
            want, jcache = jforward(jk, jcache, jnp.asarray(toks, jnp.int32),
                                    jnp.asarray([p], jnp.int32), jcfg, jnp.float32)
        got = forward(pw, cache, torch.from_numpy(toks), torch.tensor([p]), cfg, torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def _tokens_match(path):
    jr = JRunner(path, backend="w4a8", compute_dtype=jnp.float32)
    want = "".join(jr.prefill_and_generate(PROMPT, 16))
    r = Runner(path, compute_dtype=torch.float32, device="cpu")
    got = "".join(r.prefill_and_generate(PROMPT, 16))
    assert r.metrics.counts["tokens"] == 15  # prefill samples the first
    assert got == want
    return r


@SCHEMES
def test_forward_matches_jax_w4a8(kind, w4a8_backend, fast_q6k):
    """Tolerance 2e-4 (tests/test_model.py:41), float32 on both sides: 32
    prefill rows take the scheme's dequant kernel, the decode step its
    int8-activation form. The JAX decode step runs op by op (disable_jit):
    on the Q6_K model its jitted logits differ from its own op-by-op ones
    by 1.4e-2, while each of its jitted matmuls alone equals the eager call;
    the port agrees with the op-by-op run to 1e-6."""
    _forward_matches(kind, kind)


@SCHEMES
def test_runner_greedy_tokens_match_jax(tmp_path, kind, w4a8_backend, fast_q6k):
    """16 greedy tokens of one GGUF written by the JAX package, identical
    from both packages (float32 compute, backend w4a8 on the JAX side)."""
    path = str(tmp_path / f"tiny_{kind.name}.gguf")
    write_synthetic_gguf(path, tiny_config(**CFG), JGGMLType(int(kind)), seed=3)
    r = _tokens_match(path)
    lw = r.weights["layers"][0]
    assert all(lw[n].kind == kind and lw[n].kernel_layout for n in ("wqkv", "wo", "wgu"))


def test_forward_q4k_with_q6k_lm_head_matches_jax(w4a8_backend):
    _forward_matches(GGMLType.Q4_K, GGMLType.Q6_K)


def test_synth_gguf_writes_each_scheme(tmp_path):
    """tools/synth_gguf.py: every matrix in the scheme, the lm_head in its
    own; weights of standard deviation ~1/sqrt(k); the file loads."""
    from crabml_tpu_torch.models.config import config_from_gguf
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    for scheme, lm_head, kind, head in (("q8_0", None, GGMLType.Q8_0, GGMLType.Q8_0),
                                        ("q6_k", None, GGMLType.Q6_K, GGMLType.Q6_K),
                                        ("q4_k", "q6_k", GGMLType.Q4_K, GGMLType.Q6_K)):
        path = build_synth_gguf(str(tmp_path / f"{scheme}.gguf"), "tiny", seed=1,
                                scheme=scheme, lm_head=lm_head)
        gf = GGUFFile(path)
        assert gf.get_tensor_info("blk.0.ffn_down.weight").typ == kind
        assert gf.get_tensor_info("output.weight").typ == head
        w = load_weights(gf, config_from_gguf(gf.metadata))
        down = dequantize(w["layers"][0]["ffn_down"])
        assert 0.9 < down.std().item() * np.sqrt(down.shape[1]) < 1.1
        assert w["output"].kind == head and w["output"].kernel_layout

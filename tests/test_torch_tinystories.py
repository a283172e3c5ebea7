"""The reference's own TinyStories models (crabml's testdata:
tinyllamas-stories-15m in F32, Q8_0 and Q4_0, and tinyllamas-stories-260k in
F32) against the JAX package on the CPU, on synthetic files at their
published widths (tools/synth_gguf.py `stories15m`, `stories260k`).

stories15M's rows are 288 and 768 long: no K-quant holds them, and the
legacy kinds' kernel planes are zero-padded to whole 256-element
superblocks with zero scales (quant/qtensor.py, the JAX package's `repack`
rule), so every CUDA matmul takes them.

- The synthetic shapes, and the schemes that cannot hold a row.
- Files of every legacy kind at stories15M's widths load and generate on
  the CPU (Q4_0 and Q5_0 were refused at load before the planes were
  padded).
- The padded planes dequantize to the codec's values, and each plain
  matmul on them matches JAX's `qmatmul_pallas` in interpret mode on JAX's
  own `repack` (shapes its kernel takes: 1,536 and 512 rows of 288).
- The forward of each file against the JAX forward in float32: the prefill
  tight, the decode step within a stated tolerance (the routes differ, see
  `test_forward_matches_jax`) and matmul by matmul against the JAX W4A8
  kernel.

Cut to size: stories15M at 2 of its 6 layers and a vocabulary of 512 of its
32,000 (widths as published); stories260K whole. Greedy Runner tokens and the
engines: tests/test_torch_tinystories_runner.py."""

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
from crabml_tpu.quant import codecs as jcodecs
from crabml_tpu.quant.jnp_dequant import dequant_jnp
from crabml_tpu.quant.planar import QTensor as JQTensor
from crabml_tpu.quant.planar import to_planar as jto_planar
from crabml_tpu_torch.errors import UnsupportedError
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.models.config import ModelConfig, config_from_gguf
from crabml_tpu_torch.models.forward import KVCache, forward
from crabml_tpu_torch.models.weights import from_jax_weights, load_weights
from crabml_tpu_torch.ops.cuda import gemm_quant
from crabml_tpu_torch.quant.qtensor import (FORM_KIND, QTensor, dequantize, kernel_k,
                                             to_kernel_layout, to_planar)
from crabml_tpu_torch.runtime.runner import Runner
from crabml_tpu_torch.tools.synth_gguf import MODEL_SHAPES, build_synth_gguf

LEGACY = [GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q5_0, GGMLType.Q4_1, GGMLType.Q5_1,
          GGMLType.Q8_1]
KINDS = pytest.mark.parametrize("kind", LEGACY, ids=[k.name.lower() for k in LEGACY])
# (model, scheme): BASELINE.json's configs #1 and #2 and the reference's own fixture
FILES = [("stories15m", "f32"), ("stories15m", "q8_0"), ("stories15m", "q4_0"),
         ("stories260k", "f32")]
CUT = {"stories15m": dict(layers=2, vocab=512), "stories260k": {}}
PREFILL = 32


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


@pytest.fixture
def w4a8_backend():
    jmm.set_backend("w4a8")
    try:
        yield
    finally:
        jmm.set_backend("xla")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{(model, scheme): path} of the synthetic TinyStories files, cut as CUT."""
    d = tmp_path_factory.mktemp("stories")
    return {(m, s): build_synth_gguf(str(d / f"{m}-{s}.gguf"), m, seed=1, scheme=s, **CUT[m])
            for m, s in FILES}


def _raw(kind, shape, seed):
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)
    return jcodecs.quantize(JGGMLType(int(kind)), w)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_synth_writes_the_tinystories_shapes(files):
    """stories15M: 288 / 768, 6 heads of 48 (G = 1), context 256; stories260K:
    64 / 172, 8 q heads of head dim 8 over 4 kv heads, 5 layers, vocab 512,
    context 512 (tests/test_gguf.py's fixture metadata). F32 weights of
    standard deviation ~1/sqrt(k), the output.weight present."""
    want = {"stories15m": (288, 768, 6, 6, 48, 256), "stories260k": (64, 172, 8, 4, 8, 512)}
    assert MODEL_SHAPES["stories15m"] == (288, 768, 6, 6, 6, 32000, 256, 0, 0, 10000.0)
    assert MODEL_SHAPES["stories260k"] == (64, 172, 5, 8, 4, 512, 512, 0, 0, 10000.0)
    for (model, scheme), path in files.items():
        gf = GGUFFile(path)
        cfg = config_from_gguf(gf.metadata)
        assert (cfg.embedding_dim, cfg.hidden_dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                cfg.seq_len) == want[model]
        assert cfg.n_layers == (2 if model == "stories15m" else 5)
        assert cfg.vocab_size == 512 and "output.weight" in gf
        if scheme == "f32":
            ti = gf.get_tensor_info("blk.0.ffn_down.weight")
            w = np.asarray(ti.to_numpy()).view(np.float32).reshape(ti.shape)
            assert ti.typ == GGMLType.F32 and 0.9 < w.std() * np.sqrt(w.shape[1]) < 1.1


def test_synth_writes_f16_weights(tmp_path, w4a8_backend):
    """--scheme f16: every matrix F16 (the norms F32), and the port's forward
    on the file equals the JAX package's in float32 (2e-4): both widen the
    same half-precision values exactly."""
    path = build_synth_gguf(str(tmp_path / "f16.gguf"), "stories260k", seed=3, scheme="f16",
                            layers=2)
    gf = GGUFFile(path)
    assert all(ti.typ == (GGMLType.F16 if len(ti.shape) == 2 else GGMLType.F32)
               for ti in gf.tensor_infos)
    pw, cfg, jw, jcfg = _models(path)
    tokens = np.random.default_rng(4).integers(3, cfg.vocab_size, (1, 16))
    want, _ = jforward(jw, JKVCache.create(jcfg, 1, cfg.seq_len), jnp.asarray(tokens, jnp.int32),
                       jnp.asarray([0], jnp.int32), jcfg, jnp.float32)
    got = forward(pw, KVCache.create(cfg, 1, cfg.seq_len), torch.from_numpy(tokens),
                  torch.tensor([0]), cfg, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("model,scheme", [("stories260k", "q8_0"), ("stories260k", "q4_k"),
                                          ("stories15m", "q4_k"), ("stories15m", "q6_k")])
def test_synth_refuses_a_scheme_that_cannot_hold_a_row(tmp_path, model, scheme):
    """FFN 172 is not whole 32-element blocks, and 288 not whole 256-element
    superblocks: the writer raises with the reason before anything is
    written."""
    path = tmp_path / "x.gguf"
    with pytest.raises(ValueError, match="cannot hold"):
        build_synth_gguf(str(path), model, seed=1, scheme=scheme, layers=1)
    assert not path.exists()


@pytest.mark.parametrize("scheme", ["q4_0", "q5_0", "q8_0", "q4_1", "q5_1", "q8_1"])
def test_legacy_files_at_stories15m_widths_load_and_generate(tmp_path, scheme):
    """A file of each legacy kind at stories15M's widths (2 layers, vocab
    512) loads on the CPU and generates (Q4_0 and Q5_0 raised at load while
    their kernel planes needed whole 64-element chunks or superblocks):
    every matrix keeps its kind in kernel planes padded to 512 (k = 288) and
    768 (k = 768), and dequantizes to the file's values."""
    path = build_synth_gguf(str(tmp_path / f"{scheme}.gguf"), "stories15m", seed=0, layers=2,
                            scheme=scheme, vocab=512)
    r = Runner(path, compute_dtype=torch.float32, device="cpu")
    out = "".join(r.prefill_and_generate("captain america", 8))
    assert out and r.metrics.counts["tokens"] == 7
    gf = GGUFFile(path)
    lw = r.weights["layers"][0]
    for name, k in (("wqkv", 288), ("wo", 288), ("wgu", 288), ("ffn_down", 768)):
        assert lw[name].kernel_layout and lw[name].k == k and lw[name].plane_k == kernel_k(k)
    ti = gf.get_tensor_info("blk.0.ffn_down.weight")
    want = jcodecs.dequantize(JGGMLType(int(ti.typ)), ti.to_numpy()).reshape(ti.shape)
    np.testing.assert_array_equal(dequantize(lw["ffn_down"]).numpy(), want)


@KINDS
def test_padded_kernel_planes_dequantize_bit_exact(kind):
    """(1536, 288) and a stack of 3 (288, 768) in kernel planes with float32
    scales: the planes hold kernel_k(k) columns, those past k zero (values
    and scales, so the padded tail is a no-op), and dequantize to the codec's
    values bit for bit; with bfloat16 scales the values of d rounded once.
    A k that is not whole 32-element blocks is refused."""
    for shape in ((1536, 288), (3, 288, 768)):
        raw = _raw(kind, shape, 1)
        want = jcodecs.dequantize(JGGMLType(int(kind)), raw).reshape(shape)
        kt = to_kernel_layout(to_planar(kind, raw, shape))
        k = shape[-1]
        assert kt.shape == shape and kt.plane_k == kernel_k(k)
        per = {"qs": 1 if FORM_KIND[kind] == GGMLType.Q8_0 else 2, "qh": 8, "dsub": 32,
               "msub": 32}
        for n, p in kt.planes.items():
            assert p.shape[-1] == kernel_k(k) // per[n] and p.is_contiguous()
        assert not kt.planes["dsub"][..., k // 32:].any()
        np.testing.assert_array_equal(dequantize(kt).numpy(), want)
        bf = to_kernel_layout(to_planar(kind, raw, shape), torch.bfloat16)
        assert bf.plane_k == kernel_k(k) and bf.planes["dsub"].dtype == torch.bfloat16
    bad = QTensor(kind, (8, 48), {"qs": torch.zeros(8, 24, dtype=torch.uint8),
                                  "d": torch.zeros(8, 1)})
    with pytest.raises(UnsupportedError, match="32-element blocks"):
        to_kernel_layout(bad)


@pytest.fixture(scope="module")
def padded_weights():
    """{(kind, m): (JAX kernel-layout QTensor, port kernel planes)} from the
    same bytes, k = 288 (JAX's repack pads it to 512 with zero scales)."""
    out = {}
    for kind in LEGACY:
        for m in (1536, 512):
            raw = _raw(kind, (m, 288), m)
            jqt = jgemm.repack(jto_planar(JGGMLType(int(kind)), raw, (m, 288)))
            assert jqt is not None
            out[kind, m] = jqt, to_kernel_layout(to_planar(kind, raw, (m, 288)))
    return out


def _kernel_planes(qt):
    return [qt.planes[n] for n in gemm_quant._KERNEL_PLANES[FORM_KIND[qt.kind]]]


@KINDS
@pytest.mark.parametrize("m", [1536, 512])
def test_padded_dequant_plain_matches_pallas(padded_weights, kind, m):
    """32 rows of 288, float32: tolerance 2e-5 of max|out| (both compute the
    weights in float32 and sum in float32, in another order; both pad k to
    512 with zero scales). The wrapper pads x of depth 288 itself, and so
    does the router."""
    jqt, qt = padded_weights[kind, m]
    x = np.random.default_rng(1).standard_normal((32, 288)).astype(np.float32)
    want = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x), jqt, jnp.float32, act_quant=False))
    xt = torch.from_numpy(x)
    name = gemm_quant.DEQUANT_FORMS[FORM_KIND[kind]]
    got = getattr(gemm_quant, f"{name}_plain")(torch.nn.functional.pad(xt, (0, 224)),
                                               *_kernel_planes(qt))
    assert got.shape == (32, m) and _rel(got.numpy(), want) <= 2e-5
    np.testing.assert_array_equal(getattr(gemm_quant, name)(xt, qt).numpy(), got.numpy())
    np.testing.assert_array_equal(gemm_quant.qmatmul_quant(xt, qt).numpy(), got.numpy())


@KINDS
@pytest.mark.parametrize("m", [1536, 512])
@pytest.mark.parametrize("rows", [1, 8])
def test_padded_w4a8_plain_matches_pallas(padded_weights, kind, m, rows):
    """Tolerance 1e-5 of max|out|: the same int8 activations per 32-group
    (the padded groups' all-zero x gives zero codes and a zero scale in
    both), exact integer group dots, zero weight scales on the padded tail;
    the offset or minimum correction rounds differently in float32."""
    jqt, qt = padded_weights[kind, m]
    x = np.random.default_rng(2 + rows).standard_normal((rows, 288)).astype(np.float32)
    want = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x), jqt, jnp.float32, act_quant=True))
    xt = torch.from_numpy(x)
    plain = getattr(gemm_quant, f"{gemm_quant.W4A8_FORMS[FORM_KIND[kind]]}_plain")
    got = plain(torch.nn.functional.pad(xt, (0, 224)), *_kernel_planes(qt))
    assert got.shape == (rows, m) and _rel(got.numpy(), want) <= 1e-5
    np.testing.assert_array_equal(gemm_quant.qmm_w4a8(xt, qt).numpy(), got.numpy())
    np.testing.assert_array_equal(gemm_quant.qmatmul_quant(xt, qt).numpy(), got.numpy())


def test_padded_quantizer_gives_zero_codes_and_scales():
    """quantize_activation on x zero-padded from 288 to 512: the padded
    groups' codes, dx and sx are 0, not NaN, bit for bit as JAX's."""
    x = np.random.default_rng(5).standard_normal((3, 288)).astype(np.float32)
    xp = np.pad(x, ((0, 0), (0, 224)))
    xq, dx, sx = gemm_quant.quantize_activation(torch.from_numpy(xp), 32)
    jxq, jdx, jsx = (np.asarray(a) for a in jgemm.quantize_activation(jnp.asarray(xp), 32, 512))
    assert not xq[:, 288:].any() and not dx[:, 9:].any() and not sx[:, 9:].any()
    np.testing.assert_array_equal(xq.numpy(), jxq)
    # JAX's scales lie as (k steps, rows, 128 lanes), one lane a group of the step
    np.testing.assert_array_equal(dx.numpy(), jdx[0, :, :16])
    np.testing.assert_array_equal(sx.numpy(), jsx[0, :, :16])


@pytest.mark.parametrize("kind", [GGMLType.Q4_0, GGMLType.Q8_0], ids=["q4_0", "q8_0"])
def test_from_jax_weights_carries_the_padded_widths(kind):
    """from_jax_weights on the JAX package's random model at stories15M's
    widths (2 layers, vocab 512): every matrix in kernel planes padded to
    whole superblocks, dequantizing to the JAX package's dequantization of
    the same planes (wq | wk | wv fused as one)."""
    jcfg = tiny_config(embedding_dim=288, hidden_dim=768, n_heads=6, n_kv_heads=6, n_layers=2,
                       vocab_size=512, seq_len=256)
    jw = make_weights(jcfg, JGGMLType(int(kind)), seed=4)
    pw = from_jax_weights(jw, _port_cfg(jcfg))
    for l, lw in enumerate(pw["layers"]):
        assert lw["wqkv"].shape == (864, 288) and lw["wqkv"].plane_k == 512
        assert lw["ffn_down"].shape == (288, 768) and lw["ffn_down"].plane_k == 768
        parts = []
        for n in ("wq", "wk", "wv"):
            jq = jw["layers"][n]
            one = JQTensor(jq.kind, tuple(jq.shape[1:]),
                           {pn: np.asarray(p)[l] for pn, p in jq.planes.items()})
            parts.append(np.asarray(dequant_jnp(one)))
        np.testing.assert_array_equal(dequantize(lw["wqkv"]).numpy(), np.concatenate(parts))
    np.testing.assert_array_equal(dequantize(pw["output"]).numpy(),
                                  np.asarray(dequant_jnp(jw["output"])))


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f: getattr(jcfg, f) for f in ModelConfig.__dataclass_fields__})


def _models(path):
    """The port's weights (float32 scales) and the JAX Runner's weights under
    backend w4a8 (kernel layout where its kernels take the shape, fused, the
    stragglers repacked), with both configs."""
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    jgf = JGGUFFile(path)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jw = repack_weights(fuse_weights(jload_weights(jgf, jcfg, "kernel", np.float32), jcfg), jcfg)
    return load_weights(gf, cfg), cfg, jw, jcfg


# the decode step's tolerance, of max|logit|: stories15M's q|k|v (864 rows),
# wo (288) and down (288 of 768) are not whole 256-row tiles of the JAX
# kernels, so the JAX package multiplies them on its XLA path in float32,
# where the port's decode step takes int8 activations (qmm_w4a8) in every
# matmul. Int8 codes of 32-groups carry ~0.4% of a group's largest value each;
# through two layers the logits of the Q8_0 and Q4_0 files moved by up to
# 2.4% of max|logit|. Matmul by matmul the step is held at 1e-5 below.
DECODE_TOL = 5e-2


@pytest.mark.parametrize("model,scheme", FILES)
def test_forward_matches_jax(files, w4a8_backend, model, scheme):
    """Float32 on both sides: a 32-token prompt (the port's dequant forms,
    the JAX package's Pallas dequant kernel at 1,536 and 512 rows and its
    XLA path at 864 and 288; F32 files a float product on both) at 2e-4
    (tests/test_model.py:41); then one decode step, F32 files at 2e-4, the
    quantized ones at DECODE_TOL of max|logit|."""
    pw, cfg, jw, jcfg = _models(files[model, scheme])
    tokens = np.random.default_rng(0).integers(3, cfg.vocab_size, (1, PREFILL + 1))
    jcache = JKVCache.create(jcfg, 1, cfg.seq_len)
    cache = KVCache.create(cfg, 1, cfg.seq_len)
    for toks, p in ((tokens[:, :PREFILL], 0), (tokens[:, PREFILL:], PREFILL)):
        want, jcache = jforward(jw, jcache, jnp.asarray(toks, jnp.int32),
                                jnp.asarray([p], jnp.int32), jcfg, jnp.float32)
        got = forward(pw, cache, torch.from_numpy(toks), torch.tensor([p]), cfg, torch.float32)
        want = np.asarray(want)
        if p == 0 or scheme == "f32":
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
        else:
            assert np.abs(got.numpy() - want).max() <= DECODE_TOL * np.abs(want).max()


def _jax_kernel_weight(jq, l):
    """Layer l's JAX planar weight (l None: a 2-D one) with its rows
    zero-padded to a multiple of 256 (zero scales: zero rows) and repacked,
    so the JAX W4A8 kernel takes it at every stories15M shape."""
    if l is not None:
        jq = JQTensor(jq.kind, tuple(jq.shape[1:]), {n: np.asarray(p)[l]
                                                      for n, p in jq.planes.items()})
    m = jq.shape[0]
    mp = -(-m // 256) * 256
    planes = {n: np.pad(np.asarray(p), ((0, mp - m), (0, 0))) for n, p in jq.planes.items()}
    out = jgemm.repack(JQTensor(jq.kind, (mp, jq.shape[1]), planes))
    assert out is not None
    return out


@pytest.mark.parametrize("scheme", ["q8_0", "q4_0"])
def test_decode_step_matmuls_match_the_jax_w4a8_kernel(files, scheme):
    """Why DECODE_TOL, and that it hides nothing: each of the port's decode
    step matmuls (q|k|v, wo, gate|up and down of both layers, the lm_head:
    every one int8 activations on padded planes), on the port's own input,
    against the JAX W4A8 kernel in interpret mode on the same weight with
    its rows zero-padded to 256-row tiles: tolerance 1e-5 of max|out|, as
    test_padded_w4a8_plain_matches_pallas."""
    path = files["stories15m", scheme]
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    pw = load_weights(gf, cfg)
    jgf = JGGUFFile(path)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jp = fuse_weights(jload_weights(jgf, jcfg, "planar"), jcfg)
    names = {id(q): (l, n) for l, lw in enumerate(pw["layers"]) for n, q in lw.items()
             if hasattr(q, "planes")}
    names[id(pw["output"])] = (None, "output")
    tokens = np.random.default_rng(0).integers(3, cfg.vocab_size, (1, PREFILL + 1))
    cache = KVCache.create(cfg, 1, cfg.seq_len)
    forward(pw, cache, torch.from_numpy(tokens[:, :PREFILL]), torch.tensor([0]), cfg,
            torch.float32)
    seen = []
    orig = gemm_quant.qmm_w4a8

    def logged(x2, qt, out_dtype=torch.float32, plane=None):
        out = orig(x2, qt, out_dtype, plane)
        seen.append((x2.clone(), qt, out.clone()))
        return out

    gemm_quant.qmm_w4a8 = logged
    try:
        forward(pw, cache, torch.from_numpy(tokens[:, PREFILL:]), torch.tensor([PREFILL]), cfg,
                torch.float32)
    finally:
        gemm_quant.qmm_w4a8 = orig
    assert len(seen) == 4 * cfg.n_layers + 1
    for x2, qt, out in seen:
        l, n = names[id(qt)]
        jq = jp["output"] if l is None else jp["layers"][n]
        ref = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x2[:, :qt.k].numpy()),
                                              _jax_kernel_weight(jq, l), jnp.float32,
                                              act_quant=True))[:, :qt.m]
        assert _rel(out.numpy(), ref) <= 1e-5, (l, n)

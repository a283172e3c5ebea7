"""Port parity for the Q4_1, Q5_0, Q5_1 and Q8_1 weights (llama.cpp's legacy
block schemes) and for llama.cpp's legacy file layouts: the canonical planes
against the JAX package's planar ones, dequantization against the codec bit
for bit (canonical and kernel planes), each plain matmul against the JAX
Pallas kernel of the same scheme (interpret mode on the CPU), weights carried
over from the JAX package, the 2-layer forward under backend `w4a8`, and the
`legacy` and `imatrix` files of tools/synth_gguf.py against the JAX forward on
their float32 twins. The experts of these schemes:
tests/test_torch_legacy_moe.py; greedy Runner tokens:
tests/test_torch_legacy_runner.py.

Q4_1, Q5_1 and Q8_1 weights run the Q4_K, Q5_K and Q8_0 forms on their own
kernel planes (quant/qtensor.py FORM_KIND); Q5_0 has forms of its own."""

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
from crabml_tpu.quant import codecs as jcodecs
from crabml_tpu.quant.jnp_dequant import dequant_jnp
from crabml_tpu.quant.planar import QTensor as JQTensor
from crabml_tpu.quant.planar import to_planar as jto_planar
from crabml_tpu_torch.errors import UnsupportedError
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.gguf.writer import GGUFWriter
from crabml_tpu_torch.models.config import ModelConfig, config_from_gguf
from crabml_tpu_torch.models.forward import KVCache, forward
from crabml_tpu_torch.models.weights import from_jax_weights, load_weights
from crabml_tpu_torch.ops.cuda import gemm_quant
from crabml_tpu_torch.quant import codecs
from crabml_tpu_torch.quant.qtensor import (FORM_KIND, QTensor, dequantize, to_kernel_layout,
                                            to_planar)
from crabml_tpu_torch.tools.synth_gguf import SCALE_FIELDS, random_blocks, vary_scales
from crabml_tpu_torch.tools.synth_gguf import SCHEMES as SYNTH
from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf, mix_kind

Q41, Q50, Q51, Q81 = GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_1
Q40, Q6 = GGMLType.Q4_0, GGMLType.Q6_K
KINDS = pytest.mark.parametrize("kind", [Q41, Q50, Q51, Q81], ids=["q4_1", "q5_0", "q5_1", "q8_1"])
M, K = 512, 1024
# tests/test_torch_model.py's widths: head dim 128 and a 128-aligned cache
CFG = dict(embedding_dim=512, hidden_dim=512, n_heads=4, n_kv_heads=2, n_layers=2,
           vocab_size=512, seq_len=256)
PREFILL = 32
# each kind's canonical and kernel plane names
CANONICAL = {Q41: {"qs", "d", "mn"}, Q50: {"qs", "qh", "d"}, Q51: {"qs", "qh", "d", "mn"},
             Q81: {"qs", "d"}}
KERNEL = {Q41: {"qs", "dsub", "msub"}, Q50: {"qs", "qh", "dsub"},
          Q51: {"qs", "qh", "dsub", "msub"}, Q81: {"qs", "dsub"}}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: the suite runs in several worker
    processes at once, and torch's thread pool in each, spinning on small
    tensors, slows them down (tests/test_torch_moe_schemes.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def w4a8_backend():
    jmm.set_backend("w4a8")
    try:
        yield
    finally:
        jmm.set_backend("xla")


def _raw(kind, shape, seed):
    """A matrix of `shape` in `kind`: normal weights through the JAX codec
    (its legacy encoders are vectorized, fast at every size here)."""
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)
    return jcodecs.quantize(JGGMLType(int(kind)), w)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _kernel_planes(qt):
    """The kernel planes in the order the plain versions take them."""
    return [qt.planes[n] for n in gemm_quant._KERNEL_PLANES[FORM_KIND[qt.kind]]]


@KINDS
def test_planes_match_jax_and_dequantize_bit_exact(kind):
    """A stack of 3 (256, 512) matrices: the canonical planes equal the JAX
    package's planar ones (the same names and contents: Q4_1's and Q5_1's
    `mn` is the block's float minimum, Q8_1's s is read past), and the
    canonical and kernel planes (float32 scales) dequantize to the codec's
    float32 values bit for bit (Q4_1 and Q5_1 as q*d + m, two roundings)."""
    raw = _raw(kind, (3, 256, 512), 1)
    want = jcodecs.dequantize(JGGMLType(int(kind)), raw).reshape(3, 256, 512)
    np.testing.assert_array_equal(codecs.dequantize(kind, raw).reshape(3, 256, 512), want)
    qt = to_planar(kind, raw, (3, 256, 512))
    assert qt.shape == (3, 256, 512) and set(qt.planes) == CANONICAL[kind]
    jq = jto_planar(JGGMLType(int(kind)), raw, (3 * 256, 512))
    assert set(jq.planes) == set(qt.planes)
    for n, p in jq.planes.items():
        np.testing.assert_array_equal(qt.planes[n].reshape(3 * 256, -1).numpy(), np.asarray(p))
    np.testing.assert_array_equal(dequantize(qt).numpy(), want)
    kt = to_kernel_layout(qt)
    assert kt.kind == kind and kt.kernel_layout and set(kt.planes) == KERNEL[kind]
    np.testing.assert_array_equal(dequantize(kt).numpy(), want)


@KINDS
def test_kernel_planes_round_the_scales_once(kind):
    """Kernel planes with bfloat16 scales dequantize to the canonical planes'
    values with d (and m) rounded once to bfloat16: the values, their
    nibble and fifth-bit orders and the offset are unchanged."""
    raw = _raw(kind, (256, 512), 2)
    qt = to_planar(kind, raw, (256, 512))
    kt = to_kernel_layout(qt, torch.bfloat16)
    assert all(kt.planes[n].dtype == torch.bfloat16 for n in ("dsub", "msub") if n in kt.planes)
    rounded = QTensor(kind, qt.shape, {n: p.to(torch.bfloat16).float() if n in ("d", "mn") else p
                                       for n, p in qt.planes.items()})
    np.testing.assert_array_equal(dequantize(kt).numpy(), dequantize(rounded).numpy())


@pytest.mark.parametrize("kind", [Q50, Q51, Q41], ids=["q5_0", "q5_1", "q4_1"])
def test_to_kernel_layout_raises_off_its_chunks(kind):
    """Rows that are not whole 256-element superblocks (288, 96: 9 and 3
    blocks of 32) take kernel planes zero-padded to the next superblock,
    values and scales, so the fifth bits still move into Q5_K's
    per-superblock order and the nibbles into the per-64 order; they
    dequantize to the codec's values, the padded tail dropped. A row that is
    not whole 32-element blocks, which no GGUF of these kinds holds, is
    refused. (The name is the test's from when such rows raised.)"""
    k = 96 if kind == Q41 else 288
    want = jcodecs.dequantize(JGGMLType(int(kind)), _raw(kind, (8, k), 3)).reshape(8, k)
    qt = to_planar(kind, _raw(kind, (8, k), 3), (8, k))
    np.testing.assert_array_equal(dequantize(qt).numpy(), want)
    kt = to_kernel_layout(qt)
    assert kt.shape == (8, k) and kt.plane_k == -(-k // 256) * 256
    assert set(kt.planes) == KERNEL[kind]
    assert not kt.planes["dsub"][:, k // 32:].any()
    np.testing.assert_array_equal(dequantize(kt).numpy(), want)
    bad = QTensor(kind, (8, 48), {n: p[:, :p.shape[1] * 48 // k] for n, p in qt.planes.items()})
    with pytest.raises(UnsupportedError, match="32-element blocks"):
        to_kernel_layout(bad)


@pytest.fixture(scope="module")
def weights():
    """{kind: (JAX kernel-layout QTensor, port kernel planes)} from the same bytes."""
    out = {}
    for kind in (Q41, Q50, Q51, Q81):
        raw = _raw(kind, (M, K), 7)
        jqt = jgemm.repack(jto_planar(JGGMLType(int(kind)), raw, (M, K)))
        out[kind] = jqt, to_kernel_layout(to_planar(kind, raw, (M, K)))
    return out


@KINDS
def test_dequant_plain_matches_pallas(weights, kind):
    """32 rows, float32: tolerance 2e-5 of max|out| (both compute the
    weights in float32 and sum in float32, in another order). The kind runs
    its form's plain version (qmm_q4k's for Q4_1); the wrapper takes it for a
    CPU tensor, and so does the router."""
    jqt, qt = weights[kind]
    x = np.random.default_rng(1).standard_normal((32, K)).astype(np.float32)
    want = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x), jqt, jnp.float32, act_quant=False))
    xt = torch.from_numpy(x)
    name = gemm_quant.DEQUANT_FORMS[FORM_KIND[kind]]
    assert name == gemm_quant.DEQUANT_FORMS[FORM_KIND[kind]]
    got = getattr(gemm_quant, f"{name}_plain")(xt, *_kernel_planes(qt))
    assert _rel(got.numpy(), want) <= 2e-5
    np.testing.assert_array_equal(getattr(gemm_quant, name)(xt, qt).numpy(), got.numpy())
    np.testing.assert_array_equal(gemm_quant.qmatmul_quant(xt, qt).numpy(), got.numpy())


@KINDS
@pytest.mark.parametrize("rows", [1, 8])
def test_w4a8_plain_matches_pallas(weights, kind, rows):
    """Tolerance 1e-5 of max|out|: the same int8 activations per 32-group
    and exact integer group dots; the TPU kernel's -128 centring and offset
    or minimum correction round differently in float32 than dsub*dx*dot +
    msub*sx (msub = m for Q4_1 and Q5_1, -16*dsub for Q5_0, none for Q8_1)."""
    jqt, qt = weights[kind]
    x = np.random.default_rng(2 + rows).standard_normal((rows, K)).astype(np.float32)
    want = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x), jqt, jnp.float32, act_quant=True))
    xt = torch.from_numpy(x)
    plain = getattr(gemm_quant, f"{gemm_quant.W4A8_FORMS[FORM_KIND[kind]]}_plain")
    got = plain(xt, *_kernel_planes(qt))
    assert _rel(got.numpy(), want) <= 1e-5
    np.testing.assert_array_equal(gemm_quant.qmm_w4a8(xt, qt).numpy(), got.numpy())
    np.testing.assert_array_equal(gemm_quant.qmatmul_quant(xt, qt).numpy(), got.numpy())


def test_forms_of_each_kind():
    """Q4_1, Q5_1 and Q8_1 run the Q4_K, Q5_K and Q8_0 forms (dense, W4A8,
    grouped), counted under those names, with those forms' plane names and
    scale group; Q5_0 has its own."""
    for kind, form in ((Q41, GGMLType.Q4_K), (Q51, GGMLType.Q5_K), (Q81, GGMLType.Q8_0)):
        assert FORM_KIND[kind] == form
        for table in (gemm_quant.DEQUANT_FORMS, gemm_quant.W4A8_FORMS, gemm_quant.GROUPED_FORMS,
                      gemm_quant._KERNEL_PLANES, gemm_quant.SCHEME_GROUP):
            assert form in table and kind not in table  # keyed by the form alone
        assert gemm_quant.w4a8_plan(8, 256, 512, False, kind) \
            == gemm_quant.w4a8_plan(8, 256, 512, False, form)
    assert (gemm_quant.DEQUANT_FORMS[Q50], gemm_quant.W4A8_FORMS[Q50],
            gemm_quant.GROUPED_FORMS[Q50]) == ("qmm_q5_0", "qmm_w4a8_q5_0", "qmm_q5_0_grouped")
    assert list(gemm_quant._KERNEL_PLANES[Q50]) == ["qs", "qh", "dsub"]
    assert gemm_quant.SCHEME_GROUP[Q50] == 32
    assert gemm_quant.route(1, False, Q41) == "qmm_w4a8"
    assert gemm_quant.route(100, False, Q41) == "qmm_q4k"
    assert gemm_quant.route(100, False, Q50) == "qmm_q5_0"
    assert gemm_quant.route(300, True, Q51) == "qmm_w8"


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f: getattr(jcfg, f) for f in ModelConfig.__dataclass_fields__})


@KINDS
def test_from_jax_weights_carries_each_kind(kind):
    """from_jax_weights on the JAX package's random planar model of the
    kind: every matrix keeps its kind in kernel planes (float32 scales),
    and dequantizes to the JAX package's dequantization of the same planes
    (wq | wk | wv fused as one)."""
    jcfg = tiny_config(**CFG)
    jw = make_weights(jcfg, JGGMLType(int(kind)), seed=4)
    pw = from_jax_weights(jw, _port_cfg(jcfg))
    assert pw["token_embed"].kind == kind and not pw["token_embed"].kernel_layout
    assert pw["output"].kind == kind and pw["output"].kernel_layout
    for l, lw in enumerate(pw["layers"]):
        assert all(lw[n].kind == kind and lw[n].kernel_layout
                   for n in ("wqkv", "wo", "wgu", "ffn_down"))
        parts = []
        for n in ("wq", "wk", "wv"):
            jq = jw["layers"][n]
            one = JQTensor(jq.kind, tuple(jq.shape[1:]),
                           {pn: np.asarray(p)[l] for pn, p in jq.planes.items()})
            parts.append(np.asarray(dequant_jnp(one)))
        np.testing.assert_array_equal(dequantize(lw["wqkv"]).numpy(), np.concatenate(parts))
    np.testing.assert_array_equal(dequantize(pw["output"]).numpy(),
                                  np.asarray(dequant_jnp(jw["output"])))


# the kinds whose decode step is held to the JAX package matmul by matmul, on
# the port's own inputs, instead of by its logits: in the Q4_1 model's step
# one value of the lm_head's input lies 1e-4 of an int8 step from a rounding
# edge (x/dx = 12.5001 in the port, 12.49993 in both the jitted and the
# op-by-op JAX run: the two float32 paths through two layers end 4e-6 apart
# there), so the packages quantize it to neighbouring int8 values and the
# logits move by 1.1e-3 (test_q4_1_decode_lm_head_input_on_a_rounding_edge,
# ROADMAP Queue 3). The prefill is held by its logits for every kind.
EDGE_DECODE = {Q41}


def _jax_model(kind):
    jcfg = tiny_config(**CFG)
    jw = make_weights(jcfg, JGGMLType(int(kind)), seed=5)
    return jcfg, jw, repack_weights(fuse_weights(jw, jcfg), jcfg)


def _jax_layer_weight(jk, l, name):
    """The JAX package's kernel-layout weight of the port's `name` in layer l
    (None: the output)."""
    if l is None:
        return jk["output"]
    q = jk["layers"][name]
    return type(q)(q.kind, tuple(q.shape[1:]), {n: p[l] for n, p in q.planes.items()})


def _decode_inputs(pw, cfg, cache, toks, p):
    """The port's decode step with every int8-activation matmul logged as
    (its input, its weight, its output)."""
    seen = []
    orig = gemm_quant.qmm_w4a8

    def logged(x2, qt, out_dtype=torch.float32, plane=None):
        out = orig(x2, qt, out_dtype, plane)
        seen.append((x2.clone(), qt, out.clone()))
        return out

    gemm_quant.qmm_w4a8 = logged
    try:
        logits = forward(pw, cache, torch.from_numpy(toks), torch.tensor([p]), cfg, torch.float32)
    finally:
        gemm_quant.qmm_w4a8 = orig
    return logits, seen


@KINDS
def test_forward_matches_jax_w4a8(kind, w4a8_backend):
    """The 2-layer model of the kind (the JAX package's make_weights, its
    codec's encoders) through both packages, float32, tolerance 2e-4
    (tests/test_model.py:41): 32 prefill rows take the kind's dequant form,
    the decode step its int8-activation form. The JAX decode step runs
    jitted. For EDGE_DECODE (Q4_1) each of the step's nine int8-activation
    matmuls, on the port's own input, is held to the JAX kernel instead,
    tolerance 1e-5 of max|out| (test_w4a8_plain_matches_pallas's)."""
    jcfg, jw, jk = _jax_model(kind)
    cfg = _port_cfg(jcfg)
    pw = from_jax_weights(jw, cfg)
    assert pw["layers"][0]["wqkv"].kind == kind
    names = {id(q): (l, n) for l, lw in enumerate(pw["layers"]) for n, q in lw.items()
             if hasattr(q, "planes")}
    names[id(pw["output"])] = (None, "output")
    tokens = np.random.default_rng(0).integers(3, jcfg.vocab_size, (1, PREFILL + 1))
    jcache = JKVCache.create(jcfg, 1, jcfg.seq_len)
    cache = KVCache.create(cfg, 1, jcfg.seq_len)
    for toks, p in ((tokens[:, :PREFILL], 0), (tokens[:, PREFILL:], PREFILL)):
        want, jcache = jforward(jk, jcache, jnp.asarray(toks, jnp.int32),
                                jnp.asarray([p], jnp.int32), jcfg, jnp.float32)
        if p == 0 or kind not in EDGE_DECODE:
            got = forward(pw, cache, torch.from_numpy(toks), torch.tensor([p]), cfg,
                          torch.float32)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
            continue
        _, seen = _decode_inputs(pw, cfg, cache, toks, p)
        assert len(seen) == 4 * cfg.n_layers + 1
        for x2, qt, out in seen:
            jq = _jax_layer_weight(jk, *names[id(qt)])
            ref = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x2.numpy()), jq, jnp.float32,
                                                  act_quant=True))
            assert _rel(out.numpy(), ref) <= 1e-5, names[id(qt)]


def test_q4_1_decode_lm_head_input_on_a_rounding_edge(w4a8_backend):
    """Why EDGE_DECODE: the Q4_1 model's decode step reaches the lm_head with
    an input 4e-6 off the JAX package's, and of its 512 int8 activations
    exactly one differs, by one step: a value whose x/dx lies within 1e-3 of
    a step of the .5 edge, on one side in the port and on the other in JAX.
    Every other matmul of the step takes the same int8 activations from
    either input. The JAX package's jitted and op-by-op steps agree (to
    1e-5), and the port's logits differ from both by more than 2e-4."""
    jcfg, jw, jk = _jax_model(Q41)
    cfg = _port_cfg(jcfg)
    pw = from_jax_weights(jw, cfg)
    tokens = np.random.default_rng(0).integers(3, jcfg.vocab_size, (1, PREFILL + 1))
    cache = KVCache.create(cfg, 1, jcfg.seq_len)
    forward(pw, cache, torch.from_numpy(tokens[:, :PREFILL]), torch.tensor([0]), cfg,
            torch.float32)
    logits, mine = _decode_inputs(pw, cfg, cache, tokens[:, PREFILL:], PREFILL)
    jcache = JKVCache.create(jcfg, 1, jcfg.seq_len)
    _, jcache = jforward(jk, jcache, jnp.asarray(tokens[:, :PREFILL], jnp.int32),
                         jnp.asarray([0], jnp.int32), jcfg, jnp.float32)
    step = (jnp.asarray(tokens[:, PREFILL:], jnp.int32), jnp.asarray([PREFILL], jnp.int32), jcfg,
            jnp.float32)
    jitted = np.asarray(jforward(jk, jcache, *step)[0])
    theirs = []
    orig = jgemm.qmatmul_pallas

    def logged(x, qt, *a, **kw):
        if kw.get("act_quant"):
            theirs.append(np.asarray(x).reshape(-1, x.shape[-1]))
        return orig(x, qt, *a, **kw)

    jgemm.qmatmul_pallas = logged
    try:
        with jax.disable_jit():
            op_by_op = np.asarray(jforward(jk, jcache, *step)[0])
    finally:
        jgemm.qmatmul_pallas = orig
    np.testing.assert_allclose(op_by_op, jitted, rtol=0, atol=1e-5)
    assert np.abs(logits.numpy() - jitted).max() > 2e-4
    assert len(theirs) == len(mine) == 4 * cfg.n_layers + 1
    for i, ((x2, _, _), xj) in enumerate(zip(mine, theirs)):
        xq, dx, _ = gemm_quant.quantize_activation(x2, 32)
        xqj = np.asarray(jgemm.quantize_activation(jnp.asarray(xj), 32, xj.shape[1])[0])
        differ = np.nonzero(xq.numpy() != xqj)
        if i < len(mine) - 1:
            assert differ[0].size == 0, i
            continue
        assert np.abs(x2.numpy() - xj).max() <= 1e-5
        assert differ[0].size == 1
        j = differ[1][0]
        assert abs(int(xq[0, j]) - int(xqj[0, j])) == 1
        for x in (x2[0, j].item(), float(xj[0, j])):
            ratio = abs(x) / dx[0, j // 32].item()
            assert abs(ratio - np.floor(ratio) - 0.5) <= 1e-3


# ---------------------------------------------------------------------------
# llama.cpp's legacy file layouts (tools/synth_gguf.py --mix legacy / imatrix)
# ---------------------------------------------------------------------------

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


LAYOUTS = pytest.mark.parametrize("mix,scheme", [
    ("legacy", "q4_0"), ("legacy", "q4_1"), ("legacy", "q5_0"), ("legacy", "q5_1"),
    ("imatrix", "q4_0"), ("imatrix", "q5_0")])


@LAYOUTS
def test_legacy_files_forward_matches_jax_f32_twin(tmp_path, mix, scheme):
    """The `tiny` shape at 8 layers in each legacy layout (with an imatrix,
    layer 0's ffn_down (0 < 8/8) in Q4_1 / Q5_1 beside the scheme's others):
    32 prompt rows through the port (the dequant route), float32 with
    float32 scales, against the JAX forward on the file's F32 twin,
    tolerance 2e-4 (tests/test_model.py:41): the port's float32 weights are
    the codec's values exactly, so only the order of float32 sums differs.
    Every matrix keeps its file's kind in kernel planes, a Q6_K output."""
    path = build_synth_gguf(str(tmp_path / f"{mix}-{scheme}.gguf"), "tiny", seed=9, layers=8,
                            scheme=scheme, mix=mix)
    twin = str(tmp_path / "f32.gguf")
    _f32_twin(path, twin)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    w = load_weights(gf, cfg)
    kind = SYNTH[scheme][0]
    down0 = SYNTH[{"q4_0": "q4_1", "q5_0": "q5_1"}[scheme]][0] if mix == "imatrix" else kind
    for l, lw in enumerate(w["layers"]):
        assert {n: lw[n].kind for n in ("wqkv", "wo", "wgu", "ffn_down")} == {
            "wqkv": kind, "wo": kind, "wgu": kind, "ffn_down": down0 if l == 0 else kind}
        assert all(q.kernel_layout for q in lw.values() if hasattr(q, "planes"))
    assert w["token_embed"].kind == kind and w["output"].kind == Q6
    jgf = JGGUFFile(twin)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jw = jload_weights(jgf, jcfg)
    tokens = np.random.default_rng(2).integers(3, cfg.vocab_size, (1, PREFILL))
    want, _ = jforward(jw, JKVCache.create(jcfg, 1, 256), jnp.asarray(tokens, jnp.int32),
                       jnp.asarray([0], jnp.int32), jcfg, jnp.float32)
    got = forward(w, KVCache.create(cfg, 1, 256), torch.from_numpy(tokens), torch.tensor([0]),
                  cfg, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_synth_gguf_writes_each_legacy_scheme(tmp_path):
    """tools/synth_gguf.py --scheme q4_1 | q5_0 | q5_1 | q8_1: every matrix
    and the embedding in the scheme, the output too without a mix; blocks
    with a finite f16 d (and m = -7.5 d, -15.5 d; Q8_1's s = d * sum(qs));
    weights of standard deviation ~1/sqrt(k); the file loads in kernel
    planes."""
    for scheme in ("q4_1", "q5_0", "q5_1", "q8_1"):
        kind = SYNTH[scheme][0]
        path = build_synth_gguf(str(tmp_path / f"{scheme}.gguf"), "tiny", seed=1, scheme=scheme)
        gf = GGUFFile(path)
        assert all(ti.typ == kind for ti in gf.tensor_infos if len(ti.shape) == 2)
        ti = gf.get_tensor_info("blk.0.ffn_down.weight")
        b = np.asarray(ti.to_numpy()).reshape(-1, {Q41: 20, Q50: 22, Q51: 24, Q81: 36}[kind])
        d = b[:, 0:2].copy().view(np.float16).astype(np.float32)[:, 0]
        assert np.isfinite(d).all() and (d > 0).all()
        if kind in (Q41, Q51):
            m = b[:, 2:4].copy().view(np.float16).astype(np.float32)[:, 0]
            np.testing.assert_allclose(m, (-7.5 if kind == Q41 else -15.5) * d, rtol=1e-3)
        if kind == Q81:
            s = b[:, 2:4].copy().view(np.float16).astype(np.float32)[:, 0]
            qs = b[:, 4:36].view(np.int8).astype(np.float32).sum(1)
            np.testing.assert_allclose(s, (d * qs).astype(np.float16), rtol=0, atol=0)
        w = load_weights(gf, config_from_gguf(gf.metadata))
        down = dequantize(w["layers"][0]["ffn_down"])
        assert 0.9 < down.std().item() * np.sqrt(down.shape[1]) < 1.1
        assert w["output"].kind == kind and w["output"].kernel_layout


@pytest.mark.parametrize("count,size", [(1000, 34), (64, 18), (3, 22), (7, 20), (5, 144)])
def test_random_blocks_are_the_generators_bytes(count, size):
    """synth_gguf.random_blocks draws the generator's raw 64-bit outputs:
    the bytes of rng.bytes(count * size) (also where that is not whole
    outputs: then it is rng.bytes), writable, and the generator left where
    rng.bytes leaves it."""
    want_rng, rng = np.random.default_rng(7), np.random.default_rng(7)
    want = np.frombuffer(want_rng.bytes(count * size), np.uint8).reshape(count, size)
    got = random_blocks(rng, count, size)
    np.testing.assert_array_equal(got, want)
    assert got.flags.writeable and got.dtype == np.uint8
    assert rng.bytes(40) == want_rng.bytes(40)


@pytest.mark.parametrize("scheme", list(SYNTH))
def test_vary_scales_gives_each_block_its_own(scheme):
    """synth_gguf.vary_scales: each block's f16 d (and dmin or m) times a
    factor of its own in [0.5, 2], every other byte as written (Q8_1's s
    made again from the new d), the weights finite."""
    kind, blocks = SYNTH[scheme]
    raw = blocks(np.random.default_rng(3), 64 * 256, 0.05)
    got = vary_scales(kind, raw.copy(), np.random.default_rng(4))
    fields = [o for off in SCALE_FIELDS[kind] for o in (off, off + 1)]
    if kind == Q81:
        fields += [2, 3]
    rest = [c for c in range(raw.shape[1]) if c not in fields]
    np.testing.assert_array_equal(got[:, rest], raw[:, rest])
    for off in SCALE_FIELDS[kind]:
        was = raw[:, off:off + 2].copy().view(np.float16).astype(np.float64)[:, 0]
        now = got[:, off:off + 2].copy().view(np.float16).astype(np.float64)[:, 0]
        ratio = now / was
        assert ((ratio > 0.499) & (ratio < 2.002)).all()
        assert len(np.unique(now)) > len(now) // 2  # one d a block, no longer one for all
    if kind == Q81:
        d = got[:, 0:2].copy().view(np.float16).astype(np.float64)[:, 0]
        s = got[:, 2:4].copy().view(np.float16)[:, 0]
        qs = got[:, 4:36].view(np.int8).sum(1, dtype=np.int64)
        np.testing.assert_array_equal(s, (d * qs).astype(np.float16))
    w = dequantize(to_planar(kind, got, (64, 256)))
    assert torch.isfinite(w).all()


@pytest.mark.parametrize("mix,scheme", [("legacy", "q4_0"), ("legacy", "q5_1"),
                                        ("imatrix", "q4_0"), ("imatrix", "q5_0")])
@pytest.mark.parametrize("n", [32, 8])
def test_mix_kind_at_7b_depth(mix, scheme, n):
    """synth_gguf.mix_kind at the 7B shape (32 layers, 32 heads over 8 kv
    heads) and at the 8 layers of the card's 7b-q5_0 and 7b-q4_1 paths:
    every matrix in the scheme (no K-quant rule touches a legacy file type),
    and with an imatrix ffn_down in Q4_1 / Q5_1 below n/8 (layers 0-3 of 32,
    layer 0 of 8), llama.cpp's guard of the first ffn_down layers."""
    for i in range(n):
        for t in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up", "ffn_down"):
            want = scheme
            if mix == "imatrix" and t == "ffn_down" and i < n // 8:
                want = {"q4_0": "q4_1", "q5_0": "q5_1"}[scheme]
            assert mix_kind(t, i, n, scheme, mix, 4) == want, (t, i)
    downs = [mix_kind("ffn_down", i, n, scheme, mix, 4) for i in range(n)]
    assert sum(d != scheme for d in downs) == (n // 8 if mix == "imatrix" else 0)


def test_mixes_take_their_schemes_only(tmp_path):
    """`legacy` takes q4_0, q4_1, q5_0 and q5_1, `imatrix` q4_0 and q5_0
    (llama.cpp applies the guard to those two file types only); the K-quant
    mixes take no legacy scheme."""
    for mix, scheme in (("imatrix", "q4_1"), ("legacy", "q4_k"), ("k_m", "q5_0"),
                        ("legacy", "q8_0")):
        with pytest.raises(ValueError, match="mix"):
            build_synth_gguf(str(tmp_path / "x.gguf"), "tiny", scheme=scheme, mix=mix)

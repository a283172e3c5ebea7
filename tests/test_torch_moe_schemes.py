"""Port parity for mixtures of experts in the Q8_0, Q6_K, Q5_K, Q4_0, Q3_K
and Q2_K schemes and in llama.cpp's Mixtral layouts: the grouped dequant
form's and the plane-per-row int8-activation form's plain versions against
the JAX Pallas kernels (interpret mode on the CPU), the experts' planes
against the codec expert by expert, the W8 planes of a stack against the
JAX package's, `mix_kind` at 8 experts, the Runner and both engines on a
`tiny-moe8` file of every layout, and the 2-layer `tiny-moe8` forward of a
Q4_K_M and a Q2_K file against the JAX package.

Every stack holds distinct random experts (random valid blocks from the
port's synthetic writer) and rows go to experts above 0, so a form that
read expert 0's planes, or one of its scale planes, would fail."""

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
from crabml_tpu.models.forward import moe_ffn as jmoe_ffn
from crabml_tpu.models.weights import fuse_weights, repack_weights
from crabml_tpu.models.weights import load_weights as jload_weights
from crabml_tpu.ops import matmul as jmm
from crabml_tpu.ops.pallas import gemm_quant as jgemm
from crabml_tpu.quant.planar import QTensor as JQTensor
from crabml_tpu.quant.planar import stack_qtensors
from crabml_tpu.quant.planar import to_planar as jto_planar
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.gguf.writer import GGUFWriter
from crabml_tpu_torch.models import forward as port_forward
from crabml_tpu_torch.models.config import config_from_gguf
from crabml_tpu_torch.models.forward import KVCache, forward
from crabml_tpu_torch.models.weights import load_weights
from crabml_tpu_torch.ops.cuda import gemm_quant
from crabml_tpu_torch.quant import codecs
from crabml_tpu_torch.quant.qtensor import QTensor, dequantize, plane_of, to_kernel_layout, \
    to_planar
from crabml_tpu_torch.runtime.runner import Runner
from crabml_tpu_torch.serving import PagedServingEngine, ServingEngine
from crabml_tpu_torch.tools.synth_gguf import SCHEMES as SYNTH, vary_scales
from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf, mix_kind

KINDS = (GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q5_K, GGMLType.Q4_0, GGMLType.Q3_K,
         GGMLType.Q2_K)
SCHEMES = pytest.mark.parametrize("kind", KINDS,
                                  ids=["q8_0", "q6_k", "q5_k", "q4_0", "q3_k", "q2_k"])
E, M, K = 4, 256, 512
Q8, Q6, Q5, Q4, Q3, Q2 = (GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q5_K, GGMLType.Q4_K,
                          GGMLType.Q3_K, GGMLType.Q2_K)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: the suite runs in several worker
    processes at once, and torch's thread pool in each of them, spinning on
    small tensors, slows the Runner and engine tests here a hundredfold."""
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


def _blocks(kind, E, m, k, seed):
    """Random valid blocks of `kind` for E distinct (m, k) experts, each
    block's scales varied (the writer gives every block one d): (E, bytes)."""
    _, blocks = next(v for v in SYNTH.values() if v[0] == kind)
    rng = np.random.default_rng(seed)
    return vary_scales(kind, blocks(rng, E * m * k, 0.05), rng).reshape(E, -1)


def _pair(kind, seed):
    """A stack of E experts of `kind` from the same bytes: (JAX kernel-layout
    QTensor (E, M, K) with float32 scales, the port's kernel planes with
    float32 scales)."""
    raw = _blocks(kind, E, M, K, seed)
    singles = [jgemm.repack(jto_planar(JGGMLType(int(kind)), raw[e].tobytes(), (M, K)),
                            np.float32) for e in range(E)]
    jst = JQTensor(JGGMLType(int(kind)), (E, M, K),
                   {n: jnp.stack([jnp.asarray(s.planes[n]) for s in singles])
                    for n in singles[0].planes})
    st = to_kernel_layout(to_planar(kind, raw.tobytes(), (E, M, K)), torch.float32)
    for n, t in st.planes.items():  # the scales as well as the values
        assert not any(torch.equal(t[0], t[e]) for e in range(1, E)), n
    return jst, st


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _planes(qt):
    return [qt.planes[n] for n in gemm_quant._KERNEL_PLANES[qt.kind]]


@SCHEMES
def test_grouped_plain_matches_pallas(kind):
    """Rows sorted by expert, expert 0 empty, a 13-row segment (the next one
    starts mid-tile of the JAX kernel's 8-row tiles), a 1-row one: the
    plain version of qmm_<scheme>_grouped against the JAX grouped kernel of
    the scheme (`_run_grouped`), which wants every segment padded to its tile
    and one expert id a tile. Tolerance 2e-5 of max|out| in float32: the same
    float32 weights, sums in another order. The wrapper and the router take
    the plain version for a CPU tensor."""
    jst, st = _pair(kind, seed=21)
    counts, TB = (0, 13, 1, 50), 8
    rng = np.random.default_rng(22)
    xs = rng.standard_normal((sum(counts), K)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    padded, tile_expert = [], []
    for e, n in enumerate(counts):
        seg = np.zeros((-(-n // TB) * TB, K), np.float32)
        seg[:n] = xs[offsets[e]:offsets[e + 1]]
        padded.append(seg)
        tile_expert += [e] * (seg.shape[0] // TB)
    starts = np.concatenate([[0], np.cumsum([p.shape[0] for p in padded])])
    rows = np.concatenate([starts[e] + np.arange(n) for e, n in enumerate(counts)])
    called = []
    orig = jgemm._run_grouped
    jgemm._run_grouped = lambda *a, **kw: (called.append(1), orig(*a, **kw))[1]
    try:
        want = np.asarray(jgemm.qmatmul_grouped(
            jnp.asarray(np.concatenate(padded)), jst, jnp.asarray(tile_expert, jnp.int32), TB,
            jnp.float32))[rows]
    finally:
        jgemm._run_grouped = orig
    assert called
    name = gemm_quant.GROUPED_FORMS[kind]
    off = torch.from_numpy(offsets)
    got = getattr(gemm_quant, f"{name}_plain")(torch.from_numpy(xs), *_planes(st), off)
    assert got.shape == (sum(counts), M)
    assert _rel(got.numpy(), want) <= 2e-5
    np.testing.assert_array_equal(getattr(gemm_quant, name)(torch.from_numpy(xs), st, off).numpy(),
                                  got.numpy())
    routed = gemm_quant.qmatmul_grouped(torch.from_numpy(xs), st, off, w8=False)
    np.testing.assert_array_equal(routed.numpy(), got.numpy())


@SCHEMES
def test_w4a8_plane_plain_matches_pallas(kind):
    """Row b against plane[b] (experts 3, 1, 3, 2, 1): the plain version of
    the plane form against the JAX int8-activation kernel with the row's
    expert as its scalar-prefetched `layer`, row by row (as the JAX forward
    feeds one expert id). Tolerance 1e-5 of max|out|: the same int8
    activations (per 16 for Q6_K, Q3_K and Q2_K), exact integer group dots;
    the TPU kernel's -128 centring rounds otherwise in float32. The wrapper
    takes the plain version for a CPU tensor."""
    jst, st = _pair(kind, seed=31)
    plane = [3, 1, 3, 2, 1]
    x = np.random.default_rng(32).standard_normal((len(plane), K)).astype(np.float32)
    want = np.concatenate([np.asarray(jgemm.qmatmul_pallas(
        jnp.asarray(x[b:b + 1]), jst, jnp.float32, layer=jnp.int32(e), act_quant=True))
        for b, e in enumerate(plane)])
    idx = torch.tensor(plane, dtype=torch.int32)
    plain = getattr(gemm_quant, f"{gemm_quant.W4A8_FORMS[kind]}_plain")
    got = plain(torch.from_numpy(x), *_planes(st), plane=idx)
    assert _rel(got.numpy(), want) <= 1e-5
    np.testing.assert_array_equal(gemm_quant.qmm_w4a8(torch.from_numpy(x), st, plane=idx).numpy(),
                                  got.numpy())


@SCHEMES
def test_experts_load_bit_exact(tmp_path, kind):
    """A tiny-moe8 file with every matrix in the scheme: each layer's
    experts load as stacks of the scheme's kernel planes (gate|up fused
    expert by expert), and each expert dequantizes, with float32 scales, to
    the codec's float32 values of its own bytes, bit for bit."""
    scheme = next(s for s, v in SYNTH.items() if v[0] == kind)
    path = build_synth_gguf(str(tmp_path / f"{scheme}.gguf"), "tiny-moe8", seed=4, scheme=scheme)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    w = load_weights(gf, cfg)
    HD = cfg.hidden_dim
    for l, lw in enumerate(w["layers"]):
        gu, down = lw["wgu_exps"], lw["ffn_down_exps"]
        assert gu.kind == down.kind == kind and gu.kernel_layout and down.kernel_layout
        assert gu.shape == (8, 2 * HD, cfg.embedding_dim)
        want = {}
        for t in ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"):
            ti = gf.get_tensor_info(f"blk.{l}.{t}.weight")
            want[t] = codecs.dequantize(ti.typ, ti.to_numpy(), ti.n_elems).reshape(ti.shape)
        for e in range(8):
            g = dequantize(plane_of(gu, e)).numpy()
            np.testing.assert_array_equal(g[:HD], want["ffn_gate_exps"][e])
            np.testing.assert_array_equal(g[HD:], want["ffn_up_exps"][e])
            np.testing.assert_array_equal(dequantize(plane_of(down, e)).numpy(),
                                          want["ffn_down_exps"][e])


def _jax_w8_untiled(jqt):
    """The JAX package's m-tiled W8 planes in the port's layout."""
    w8, dw = np.asarray(jqt.planes["w8"]), np.asarray(jqt.planes["dw"])
    mt, kpad8, tm8 = w8.shape
    return (w8.transpose(0, 2, 1).reshape(mt * tm8, kpad8),
            dw.transpose(0, 3, 1, 2).reshape(mt * tm8, -1))


@SCHEMES
def test_augment_w8_on_a_stack(kind):
    """augment_w8 on a stack of the scheme attaches planes expert by expert,
    equal bit for bit to the JAX package's augment_w8 of each expert alone
    (float32 scales); qmm_w8_grouped's plain version then serves the stack
    as it serves a Q4_K one."""
    raw = _blocks(kind, E, M, K, seed=41)
    st = gemm_quant.augment_w8(to_kernel_layout(to_planar(kind, raw.tobytes(), (E, M, K)),
                                                torch.float32))
    assert st.planes["w8"].shape == (E, M, K) and st.planes["dw"].shape == (E, M, 1)
    for e in range(E):
        jq = jgemm.augment_w8(jgemm.repack(
            jto_planar(JGGMLType(int(kind)), raw[e].tobytes(), (M, K)), np.float32))
        w8, dw = _jax_w8_untiled(jq)
        np.testing.assert_array_equal(st.planes["w8"][e].numpy(), w8)
        np.testing.assert_array_equal(st.planes["dw"][e].numpy(), dw)
    xs = torch.randn(30, K)
    off = torch.tensor([0, 0, 10, 10, 30], dtype=torch.int32)
    got = gemm_quant.qmatmul_grouped(xs, st, off, w8=True)
    want = torch.cat([gemm_quant.qmm_w8_plain(xs[0:10], st.planes["w8"][1], st.planes["dw"][1]),
                      gemm_quant.qmm_w8_plain(xs[10:], st.planes["w8"][3], st.planes["dw"][3])])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# llama.cpp's layouts of an 8-expert model (llama_tensor_get_type,
# src/llama-quant.cpp): per mix, the types of the tensors that differ from
# the scheme, as a function of the layer i of n
def _expected(mix, scheme, i, n):
    more = i < n // 8 or i >= 7 * n // 8 or (i - n // 8) % 3 == 2  # use_more_bits
    down = {("k_m", "q4_k"): "q6_k" if more else "q4_k",
            ("k_m", "q5_k"): "q6_k" if more else "q5_k",
            ("k_m", "q3_k"): "q5_k" if i < n // 16 else "q4_k",
            ("q2_k", "q2_k"): "q3_k"}[mix, scheme]
    # attn_output: the 8-expert branch's Q5_K (Q5_K_M's base is Q5_K already)
    return {"attn_k": "q8_0", "attn_v": "q8_0", "attn_output": "q5_k", "ffn_down": down}


MIXES = pytest.mark.parametrize("mix,scheme", [("k_m", "q4_k"), ("k_m", "q5_k"),
                                               ("k_m", "q3_k"), ("q2_k", "q2_k")],
                                ids=["q4_k_m", "q5_k_m", "q3_k_m", "q2_k"])


@MIXES
def test_mix_kind_with_8_experts(mix, scheme):
    """mix_kind at Mixtral's 32 layers and 8 experts, and at the 8 layers of
    the card's mixtral-q4_k_m path: attn_k and attn_v Q8_0 in every layer,
    attn_output Q5_K, ffn_down (the experts' down stack too) by the dense
    rule of its own layer, everything else the scheme. With 4 experts the
    dense rules stand (Q2_K's attn_output stays Q3_K)."""
    for n in (32, 8):
        for i in range(n):
            want = _expected(mix, scheme, i, n)
            for t in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up",
                      "ffn_down"):
                assert mix_kind(t, i, n, scheme, mix, 4, 8) == want.get(t, scheme), (t, i, n)
    down = [mix_kind("ffn_down", i, 8, scheme, mix, 4, 8) for i in range(8)]
    if (mix, scheme) == ("k_m", "q4_k"):
        assert [i for i, d in enumerate(down) if d == "q6_k"] == [0, 3, 6, 7]
    assert mix_kind("attn_k", 0, 32, scheme, mix, 4, 4) == scheme
    if mix == "q2_k":
        assert mix_kind("attn_output", 0, 32, scheme, mix, 4, 4) == "q3_k"
    assert mix_kind("attn_k", 0, 32, scheme, None, 4, 8) == scheme  # no mix: uniform


@MIXES
def test_synth_gguf_writes_the_8_expert_layouts(tmp_path, mix, scheme):
    """tools/synth_gguf.py on the tiny-moe8 shape (2 layers): every tensor in
    the type of the table above, the experts' stacks included, a Q6_K
    output; the file loads with q, k, v apart (k and v in Q8_0) and gate|up
    fused expert by expert; the down stack keeps its own kind."""
    path = build_synth_gguf(str(tmp_path / f"{mix}-{scheme}.gguf"), "tiny-moe8", seed=2,
                            scheme=scheme, mix=mix)
    gf = GGUFFile(path)
    name = {"attn_q": "attn_q", "attn_k": "attn_k", "attn_v": "attn_v",
            "attn_output": "attn_output", "ffn_gate": "ffn_gate_exps", "ffn_up": "ffn_up_exps",
            "ffn_down": "ffn_down_exps"}
    for i in range(2):
        want = _expected(mix, scheme, i, 2)
        for t, gguf_name in name.items():
            typ = gf.get_tensor_info(f"blk.{i}.{gguf_name}.weight").typ
            assert typ == SYNTH[want.get(t, scheme)][0], (i, t)
    assert gf.get_tensor_info("output.weight").typ == Q6
    assert gf.get_tensor_info("token_embd.weight").typ == SYNTH[scheme][0]
    w = load_weights(gf, config_from_gguf(gf.metadata))
    for i, lw in enumerate(w["layers"]):
        assert "wqkv" not in lw and lw["wk"].kind == lw["wv"].kind == Q8
        assert lw["wgu_exps"].kind == SYNTH[scheme][0]
        assert lw["ffn_down_exps"].kind == SYNTH[_expected(mix, scheme, i, 2)["ffn_down"]][0]


LAYOUTS = pytest.mark.parametrize("scheme,mix", [
    ("q8_0", None), ("q6_k", None), ("q5_k", None), ("q4_0", None), ("q3_k", None),
    ("q2_k", None), ("q4_k", "k_m"), ("q2_k", "q2_k")],
    ids=["q8_0", "q6_k", "q5_k", "q4_0", "q3_k", "q2_k", "q4_k_m", "q2_k_mix"])


@LAYOUTS
def test_runner_and_engines_on_tiny_moe8(tmp_path, scheme, mix):
    """Each uniform scheme and llama.cpp's Q4_K_M and Q2_K layouts on the
    tiny-moe8 shape: the Runner's greedy text (a 75-token prompt prefills
    through the grouped forms; decode through the plane forms) equals the
    dense and the paged engine's for three prompts at once through two
    slots, and the paged engine returns its pages."""
    path = build_synth_gguf(str(tmp_path / f"{scheme}-{mix}.gguf"), "tiny-moe8", seed=5,
                            scheme=scheme, mix=mix)
    r = Runner(path, compute_dtype=torch.float32, device="cpu")
    prompts = ["hello world", "w5 w6 w7 " * 25, "a"]
    want = []
    for p in prompts:
        r.reset()
        want.append("".join(r.prefill_and_generate(p, 8)))
    assert ServingEngine(r, n_slots=2, seq_len=512).generate(prompts, max_tokens=8) == want
    paged = PagedServingEngine(r, n_slots=2, n_pages=16, seq_len=512)
    free = paged.pages_free()
    assert paged.generate(prompts, max_tokens=8) == want
    assert paged.pages_free() == free


# ---------------------------------------------------------------------------
# the 2-layer tiny-moe8 forward of llama.cpp's Mixtral layouts
# ---------------------------------------------------------------------------

PREFILL = 64  # rows of the prompt: the grouped forms (_GROUPED_MIN_ROWS)


def _random_norms(jw, pw, seed):
    """The same norm weights drawn from U(0.5, 1.5) on both sides, as a
    checkpoint's are (test_torch_schemes.py's RANDOM_NORMS: with the
    synthetic file's unit norms a Q3_K / Q2_K model puts int8 activations
    on exact ties that torch and XLA break differently)."""
    rng = np.random.default_rng(seed)
    L = len(pw["layers"])
    for n in ("attn_norm", "ffn_norm"):
        vals = rng.uniform(0.5, 1.5, np.shape(jw["layers"][n])).astype(np.float32)
        jw["layers"][n] = vals
        for l in range(L):
            pw["layers"][l][n] = torch.from_numpy(vals[l].copy())
    vals = rng.uniform(0.5, 1.5, np.shape(jw["final_norm"])).astype(np.float32)
    jw["final_norm"] = vals
    pw["final_norm"] = torch.from_numpy(vals.copy())


def test_q2_k_moe_forward_matches_jax_w4a8(tmp_path, w4a8_backend):
    """llama.cpp's Q2_K layout on tiny-moe8 (Q2_K q and gate|up experts,
    Q8_0 k and v, Q5_K attn_output, Q3_K down experts, a Q6_K output; the
    same kinds in both layers, so the JAX package loads the file as it is):
    a 64-row prefill (the grouped forms of Q2_K and Q3_K) and a decode step
    (their plane forms, Q8_0's and Q5_K's dense forms) against the JAX
    forward under backend `w4a8`, random norms on both sides (RANDOM_NORMS
    of tests/test_torch_schemes.py, for Q2_K). The prefill runs jitted; the
    decode step op by op, as tests/test_torch_schemes.py runs the JAX decode
    of its Q8_0 model (OP_BY_OP_DECODE): jitted, the JAX decode of this file
    moves 1.2e-2 off its own op-by-op logits, which the port meets to 4e-6.
    Tolerance 2e-4 (tests/test_model.py:41), float32: the same planes and
    int8 activations, sums in another order. An int8 value on the edge of a
    rounding step is the one thing the tolerance does not absorb: with seed
    8 one value of layer 1's expert input lies 2.5e-4 of a step from the
    edge, the two packages' float32 sums (5e-5 apart there) round it to
    neighbouring int8 values, and the logits move by 6e-3; this file's seed
    has no such value in the compared steps."""
    path = build_synth_gguf(str(tmp_path / "q2_k.gguf"), "tiny-moe8", seed=7, scheme="q2_k",
                            mix="q2_k")
    jgf = JGGUFFile(path)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jw = jload_weights(jgf, jcfg)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    pw = load_weights(gf, cfg)
    _random_norms(jw, pw, 12)
    jk = repack_weights(fuse_weights(jw, jcfg), jcfg)
    assert jgemm.is_repacked(jk["layers"]["ffn_down_exps"])
    lw = pw["layers"][0]
    assert (lw["wgu_exps"].kind, lw["ffn_down_exps"].kind, lw["wk"].kind, lw["wo"].kind) == (
        Q2, Q3, Q8, Q5)
    tokens = np.random.default_rng(1).integers(3, cfg.vocab_size, (1, PREFILL + 1))
    jcache = JKVCache.create(jcfg, 1, 256)
    cache = KVCache.create(cfg, 1, 256)
    for toks, p in ((tokens[:, :PREFILL], 0), (tokens[:, PREFILL:], PREFILL)):
        with jax.disable_jit(p > 0):
            want, jcache = jforward(jk, jcache, jnp.asarray(toks, jnp.int32),
                                    jnp.asarray([p], jnp.int32), jcfg, jnp.float32)
        got = forward(pw, cache, torch.from_numpy(toks), torch.tensor([p]), cfg, torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


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


def _jax_moe_layer(jgf, l, n_experts):
    """Layer l's router and expert stacks as the JAX package holds them, as
    a 1-layer stack in its kernel layout (float32 scales)."""
    def stack(name):
        ti = jgf.get_tensor_info(f"blk.{l}.{name}.weight")
        return stack_qtensors([jgemm.repack(jto_planar(ti.typ, ti.to_numpy(), ti.shape),
                                            np.float32)])

    router = jgf.get_tensor_info(f"blk.{l}.ffn_gate_inp.weight")
    lw = {n: stack(n) for n in ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps")}
    lw["ffn_gate_inp"] = np.frombuffer(router.to_numpy().tobytes(), np.float32).reshape(
        1, n_experts, -1)
    return lw


def test_q4_k_m_moe_forward_matches_jax(tmp_path, w4a8_backend):
    """llama.cpp's Q4_K_M layout on tiny-moe8: Q4_K q and gate|up experts,
    Q8_0 k and v, Q5_K attn_output, a Q6_K output, and the down experts in
    Q4_K in layer 0 and Q6_K in layer 1 (use_more_bits(1, 2)); layer 1
    mixes Q4_K gate|up with Q6_K down, which quantize their activations at
    32 and 16. The JAX package stacks layers of one kind only, so:

    - the 64-row prefill (the Q4_K and Q6_K grouped forms) against the JAX
      forward on the file's F32 twin, tolerance 2e-4: the port's float32
      weights are the codec's values exactly, only the order of float32
      sums differs;
    - the decode step (the plane forms) layer by layer: each layer's moe_ffn
      on the port's own input row against the JAX package's moe_ffn on that
      layer's stacks under backend `w4a8` (its one-row gather by expert,
      op by op: the JAX run tests/test_torch_schemes.py uses for Q4_K and
      Q6_K), tolerance 2e-4 of max|out|."""
    path = build_synth_gguf(str(tmp_path / "q4_k_m.gguf"), "tiny-moe8", seed=6, scheme="q4_k",
                            mix="k_m")
    twin = str(tmp_path / "q4_k_m-f32.gguf")
    _f32_twin(path, twin)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    pw = load_weights(gf, cfg)
    kinds = [(lw["wgu_exps"].kind, lw["ffn_down_exps"].kind) for lw in pw["layers"]]
    assert kinds == [(Q4, Q4), (Q4, Q6)]
    tjgf = JGGUFFile(twin)
    tjcfg = jconfig_from_gguf(tjgf.metadata)
    tjw = jload_weights(tjgf, tjcfg)
    tokens = np.random.default_rng(2).integers(3, cfg.vocab_size, (1, PREFILL + 1))
    cache = KVCache.create(cfg, 1, 256)
    want, _ = jforward(tjw, JKVCache.create(tjcfg, 1, 256), jnp.asarray(tokens[:, :PREFILL]),
                       jnp.asarray([0], jnp.int32), tjcfg, jnp.float32)
    got = forward(pw, cache, torch.from_numpy(tokens[:, :PREFILL]), torch.tensor([0]), cfg,
                  torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)

    seen = []
    orig = port_forward.moe_ffn

    def logged(lw, x, c):
        out = orig(lw, x, c)
        seen.append((x.detach().clone(), out.detach().clone()))
        return out

    port_forward.moe_ffn = logged
    try:
        forward(pw, cache, torch.from_numpy(tokens[:, PREFILL:]), torch.tensor([PREFILL]), cfg,
                torch.float32)
    finally:
        port_forward.moe_ffn = orig
    assert len(seen) == cfg.n_layers
    jgf = JGGUFFile(path)
    jcfg = jconfig_from_gguf(jgf.metadata)
    for l, (x, out) in enumerate(seen):
        jlw = _jax_moe_layer(jgf, l, cfg.n_experts)
        with jax.disable_jit():
            want = np.asarray(jmoe_ffn(jlw, 0, jnp.asarray(x.numpy()), jcfg, jnp.float32))
        assert _rel(out.numpy(), want) <= 2e-4, l


def test_moe_planes_carry_across_from_jax(tmp_path):
    """from_jax_weights carries the JAX package's planar experts of every
    kind in a Q2_K file (Q2_K gate|up, Q3_K down) across, bit for bit with
    the port's own loader."""
    from crabml_tpu_torch.models.weights import from_jax_weights

    path = build_synth_gguf(str(tmp_path / "q2_k.gguf"), "tiny-moe8", seed=8, scheme="q2_k",
                            mix="q2_k")
    jgf = JGGUFFile(path)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    got = from_jax_weights(jload_weights(jgf, jconfig_from_gguf(jgf.metadata)), cfg)
    want = load_weights(gf, cfg)
    for lg, lw in zip(got["layers"], want["layers"]):
        assert set(lg) == set(lw)
        for n, v in lw.items():
            if isinstance(v, QTensor):
                assert lg[n].kind == v.kind and lg[n].shape == v.shape, n
                for pn, plane in v.planes.items():
                    assert torch.equal(lg[n].planes[pn], plane), (n, pn)

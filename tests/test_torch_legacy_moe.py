"""Port parity for mixtures of experts in the Q4_1, Q5_0, Q5_1 and Q8_1
schemes and in llama.cpp's legacy 8-expert layouts: the grouped dequant
form's and the plane-per-row int8-activation form's plain versions against
the JAX Pallas kernels (interpret mode on the CPU), the experts' planes
against the codec expert by expert, the W8 planes of a stack against the JAX
package's, `mix_kind` at 8 experts, the Runner and both engines on `tiny-moe8`
files, and the 2-layer `tiny-moe8` forward of a Q5_0 file against the JAX
package.

Every stack holds distinct random experts (random valid blocks from the
port's synthetic writer) and rows go to experts above 0, so a form that read
expert 0's planes, or one of its scale planes, would fail."""

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
from crabml_tpu.models.weights import fuse_weights, repack_weights
from crabml_tpu.models.weights import load_weights as jload_weights
from crabml_tpu.ops import matmul as jmm
from crabml_tpu.ops.pallas import gemm_quant as jgemm
from crabml_tpu.quant.planar import QTensor as JQTensor
from crabml_tpu.quant.planar import to_planar as jto_planar
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.models.config import config_from_gguf
from crabml_tpu_torch.models.forward import KVCache, forward
from crabml_tpu_torch.models.weights import from_jax_weights, load_weights
from crabml_tpu_torch.ops.cuda import gemm_quant
from crabml_tpu_torch.quant import codecs
from crabml_tpu_torch.quant.qtensor import FORM_KIND, QTensor, dequantize, plane_of, \
    to_kernel_layout, to_planar
from crabml_tpu_torch.runtime.runner import Runner
from crabml_tpu_torch.serving import PagedServingEngine, ServingEngine
from crabml_tpu_torch.tools.synth_gguf import SCHEMES as SYNTH, vary_scales
from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf, mix_kind

Q41, Q50, Q51, Q81 = GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_1
Q8, Q6 = GGMLType.Q8_0, GGMLType.Q6_K
KINDS = pytest.mark.parametrize("kind", [Q41, Q50, Q51, Q81], ids=["q4_1", "q5_0", "q5_1", "q8_1"])
E, M, K = 4, 256, 512


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
    assert st.kind == kind
    for n, t in st.planes.items():  # the scales as well as the values
        assert not any(torch.equal(t[0], t[e]) for e in range(1, E)), n
    return jst, st


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _planes(qt):
    return [qt.planes[n] for n in gemm_quant._KERNEL_PLANES[FORM_KIND[qt.kind]]]


@KINDS
def test_grouped_plain_matches_pallas(kind):
    """Rows sorted by expert, expert 0 empty, a 13-row segment (the next one
    starts mid-tile of the JAX kernel's 8-row tiles), a 1-row one: the plain
    version of the kind's grouped form (qmm_q4k_grouped for Q4_1,
    qmm_q5k_grouped for Q5_1, qmm_q8_0_grouped for Q8_1, qmm_q5_0_grouped)
    against the JAX grouped kernel of the scheme, which wants every segment
    padded to its tile and one expert id a tile. Tolerance 2e-5 of max|out|
    in float32: the same float32 weights, sums in another order. The wrapper
    and the router take the plain version for a CPU tensor."""
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
    name = gemm_quant.GROUPED_FORMS[FORM_KIND[kind]]
    off = torch.from_numpy(offsets)
    got = getattr(gemm_quant, f"{name}_plain")(torch.from_numpy(xs), *_planes(st), off)
    assert got.shape == (sum(counts), M)
    assert _rel(got.numpy(), want) <= 2e-5
    np.testing.assert_array_equal(getattr(gemm_quant, name)(torch.from_numpy(xs), st, off).numpy(),
                                  got.numpy())
    routed = gemm_quant.qmatmul_grouped(torch.from_numpy(xs), st, off, w8=False)
    np.testing.assert_array_equal(routed.numpy(), got.numpy())


@KINDS
def test_w4a8_plane_plain_matches_pallas(kind):
    """Row b against plane[b] (experts 3, 1, 3, 2, 1): the plain version of
    the kind's plane form against the JAX int8-activation kernel with the
    row's expert as its scalar-prefetched `layer`, row by row. Tolerance
    1e-5 of max|out|: the same int8 activations, exact integer group dots;
    the TPU kernel's -128 centring rounds otherwise in float32. The wrapper
    takes the plain version for a CPU tensor."""
    jst, st = _pair(kind, seed=31)
    plane = [3, 1, 3, 2, 1]
    x = np.random.default_rng(32).standard_normal((len(plane), K)).astype(np.float32)
    want = np.concatenate([np.asarray(jgemm.qmatmul_pallas(
        jnp.asarray(x[b:b + 1]), jst, jnp.float32, layer=jnp.int32(e), act_quant=True))
        for b, e in enumerate(plane)])
    idx = torch.tensor(plane, dtype=torch.int32)
    plain = getattr(gemm_quant, f"{gemm_quant.W4A8_FORMS[FORM_KIND[kind]]}_plain")
    got = plain(torch.from_numpy(x), *_planes(st), plane=idx)
    assert _rel(got.numpy(), want) <= 1e-5
    np.testing.assert_array_equal(gemm_quant.qmm_w4a8(torch.from_numpy(x), st, plane=idx).numpy(),
                                  got.numpy())


@KINDS
def test_experts_load_bit_exact(tmp_path, kind):
    """A tiny-moe8 file with every matrix in the scheme: each layer's
    experts load as stacks of the kind's kernel planes (gate|up fused expert
    by expert, the kind kept), and each expert dequantizes, with float32
    scales, to the codec's float32 values of its own bytes, bit for bit."""
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


@KINDS
def test_augment_w8_on_a_stack(kind):
    """augment_w8 on a stack of the kind attaches planes expert by expert,
    equal bit for bit to the JAX package's augment_w8 of each expert alone
    (float32 scales): the W8 planes come from the kind's own weights."""
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


@pytest.mark.parametrize("mix,scheme", [("legacy", "q4_0"), ("legacy", "q4_1"),
                                        ("legacy", "q5_0"), ("legacy", "q5_1"),
                                        ("imatrix", "q4_0"), ("imatrix", "q5_0")])
def test_mix_kind_with_8_experts(mix, scheme):
    """mix_kind at Mixtral's 32 layers and 8 experts, and at the 2 layers of
    the card's mixtral-q5_0 path: attn_k and attn_v Q8_0 in every layer (the
    8-expert rule of every file type), attn_output in the scheme (its
    8-expert Q5_K rule names K-quant file types only), the experts' stacks
    in the scheme, and with an imatrix ffn_down (the down experts' stack)
    in Q4_1 / Q5_1 below n/8."""
    for n in (32, 2):
        for i in range(n):
            for t in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up",
                      "ffn_down"):
                want = "q8_0" if t in ("attn_k", "attn_v") else scheme
                if mix == "imatrix" and t == "ffn_down" and i < n // 8:
                    want = {"q4_0": "q4_1", "q5_0": "q5_1"}[scheme]
                assert mix_kind(t, i, n, scheme, mix, 4, 8) == want, (t, i, n)
    assert mix_kind("attn_k", 0, 32, scheme, mix, 4, 4) == scheme  # 4 experts: the dense rule


def test_synth_gguf_writes_the_8_expert_legacy_layout(tmp_path):
    """tools/synth_gguf.py --scheme q5_0 --mix legacy on tiny-moe8: Q5_0 q,
    attn_output, experts and embedding, Q8_0 k and v, a Q6_K output; the file
    loads with q, k, v apart and gate|up fused expert by expert, each stack
    in Q5_0."""
    path = build_synth_gguf(str(tmp_path / "q5_0.gguf"), "tiny-moe8", seed=2, scheme="q5_0",
                            mix="legacy")
    gf = GGUFFile(path)
    for i in range(2):
        for t, want in (("attn_q", Q50), ("attn_k", Q8), ("attn_v", Q8), ("attn_output", Q50),
                        ("ffn_gate_exps", Q50), ("ffn_up_exps", Q50), ("ffn_down_exps", Q50)):
            assert gf.get_tensor_info(f"blk.{i}.{t}.weight").typ == want, (i, t)
    assert gf.get_tensor_info("output.weight").typ == Q6
    assert gf.get_tensor_info("token_embd.weight").typ == Q50
    w = load_weights(gf, config_from_gguf(gf.metadata))
    for lw in w["layers"]:
        assert "wqkv" not in lw and lw["wk"].kind == lw["wv"].kind == Q8
        assert lw["wq"].kind == lw["wo"].kind == Q50
        assert lw["wgu_exps"].kind == lw["ffn_down_exps"].kind == Q50


LAYOUTS = pytest.mark.parametrize("scheme,mix", [
    ("q5_0", "legacy"), ("q4_1", "legacy"), ("q5_1", None), ("q8_1", None)],
    ids=["q5_0_legacy", "q4_1_legacy", "q5_1", "q8_1"])


@LAYOUTS
def test_runner_and_engines_on_tiny_moe8(tmp_path, scheme, mix):
    """Each legacy kind on the tiny-moe8 shape: the Runner's greedy text (a
    75-token prompt prefills through the grouped forms; decode through the
    plane forms) equals the dense and the paged engine's for three prompts at
    once through two slots, and the paged engine returns its pages."""
    path = build_synth_gguf(str(tmp_path / f"{scheme}-{mix}.gguf"), "tiny-moe8", seed=5,
                            scheme=scheme, mix=mix)
    r = Runner(path, compute_dtype=torch.float32, device="cpu")
    assert r.weights["layers"][0]["wgu_exps"].kind == SYNTH[scheme][0]
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


PREFILL = 64  # rows of the prompt: the grouped forms (forward.py _GROUPED_MIN_ROWS)


def test_q5_0_moe_forward_matches_jax_w4a8(tmp_path, w4a8_backend):
    """llama.cpp's Q5_0 file type on tiny-moe8 (Q5_0 q, attn_output and
    experts, Q8_0 k and v, a Q6_K output; the same kinds in both layers, so
    the JAX package loads the file as it is): a 64-row prefill (the grouped
    Q5_0 form) and a decode step (its plane form, the dense Q5_0, Q8_0 and
    Q6_K forms) against the JAX forward under backend `w4a8`, both jitted.
    Tolerance 2e-4 (tests/test_model.py:41), float32: the same planes and
    int8 activations, sums in another order."""
    path = build_synth_gguf(str(tmp_path / "q5_0.gguf"), "tiny-moe8", seed=7, scheme="q5_0",
                            mix="legacy")
    jgf = JGGUFFile(path)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jk = repack_weights(fuse_weights(jload_weights(jgf, jcfg), jcfg), jcfg)
    assert jgemm.is_repacked(jk["layers"]["ffn_down_exps"])
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    pw = load_weights(gf, cfg)
    lw = pw["layers"][0]
    assert (lw["wgu_exps"].kind, lw["ffn_down_exps"].kind, lw["wk"].kind, lw["wo"].kind) == (
        Q50, Q50, Q8, Q50)
    tokens = np.random.default_rng(1).integers(3, cfg.vocab_size, (1, PREFILL + 1))
    jcache = JKVCache.create(jcfg, 1, 256)
    cache = KVCache.create(cfg, 1, 256)
    for toks, p in ((tokens[:, :PREFILL], 0), (tokens[:, PREFILL:], PREFILL)):
        want, jcache = jforward(jk, jcache, jnp.asarray(toks, jnp.int32),
                                jnp.asarray([p], jnp.int32), jcfg, jnp.float32)
        got = forward(pw, cache, torch.from_numpy(toks), torch.tensor([p]), cfg, torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_moe_planes_carry_across_from_jax(tmp_path):
    """from_jax_weights carries the JAX package's planar Q5_0 experts (and
    the Q8_0 k, v, the Q6_K output) of a Q5_0 file across, bit for bit with
    the port's own loader."""
    path = build_synth_gguf(str(tmp_path / "q5_0.gguf"), "tiny-moe8", seed=8, scheme="q5_0",
                            mix="legacy")
    jgf = JGGUFFile(path)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    got = from_jax_weights(jload_weights(jgf, jconfig_from_gguf(jgf.metadata)), cfg)
    want = load_weights(gf, cfg)
    assert got["layers"][0]["wgu_exps"].kind == Q50
    for lg, lw in zip(got["layers"], want["layers"]):
        assert set(lg) == set(lw)
        for n, v in lw.items():
            if isinstance(v, QTensor):
                assert lg[n].kind == v.kind and lg[n].shape == v.shape, n
                for pn, plane in v.planes.items():
                    assert torch.equal(lg[n].planes[pn], plane), (n, pn)
    for pn, plane in want["output"].planes.items():
        assert torch.equal(got["output"].planes[pn], plane), pn

"""Port parity for the Mixtral mixture-of-experts path: the router, the
grouped matmuls' plain versions against the JAX Pallas kernels (interpret
mode on the CPU), moe_ffn in each of its row regimes with W8 planes off and
on, the whole `tiny-moe` forward, greedy Runner tokens, and both serving
engines against the Runner."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.gguf.reader import GGUFFile as JGGUFFile
from crabml_tpu.models.config import ARCH_FEATURES
from crabml_tpu.models.config import ModelConfig as JModelConfig
from crabml_tpu.models.config import config_from_gguf as jconfig_from_gguf
from crabml_tpu.models.forward import KVCache as JKVCache
from crabml_tpu.models.forward import forward as jforward
from crabml_tpu.models.forward import moe_ffn as jmoe_ffn
from crabml_tpu.models.synthetic import write_synthetic_gguf
from crabml_tpu.models.weights import augment_w8_weights as jaugment_w8_weights
from crabml_tpu.models.weights import fuse_weights, repack_weights
from crabml_tpu.models.weights import load_weights as jload_weights
from crabml_tpu.ops import matmul as jmm
from crabml_tpu.ops.pallas import gemm_quant as jgemm
from crabml_tpu.quant.codecs import quantize as jquantize
from crabml_tpu.quant.planar import QTensor as JQTensor
from crabml_tpu.quant.planar import to_planar as jto_planar
from crabml_tpu.runtime.runner import Runner as JRunner
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.models.config import ModelConfig, config_from_gguf
from crabml_tpu_torch.models.forward import (KVCache, forward, moe_ffn, moe_ffn_plain,
                                             moe_route)
from crabml_tpu_torch.models.weights import (augment_w8_weights, check_supported,
                                             from_jax_weights, load_weights)
from crabml_tpu_torch.ops.cuda import gemm_quant
from crabml_tpu_torch.quant.qtensor import QTensor, to_kernel_layout, to_planar
from crabml_tpu_torch.runtime.runner import Runner
from crabml_tpu_torch.serving import PagedServingEngine, ServingEngine
from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf


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


@pytest.fixture(scope="module")
def tiny_moe(tmp_path_factory):
    return build_synth_gguf(str(tmp_path_factory.mktemp("gguf") / "tiny-moe.gguf"), "tiny-moe",
                            seed=3)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 7, 64])
def test_router_topk_and_weights_match_jax(rows):
    """The same experts in the same order and the same float32 weights
    (softmax over the selected two only; 1e-5: each side computes its own
    float32 logits, summed in another order). Experts 1 and 4 share one weight
    row, so their logits tie exactly in every row: jax.lax.top_k puts the
    lower index first and the port's stable descending sort does the same
    (torch.topk promises no order on a tie)."""
    rng = np.random.default_rng(rows)
    E, D, K = 6, 64, 2
    router = rng.standard_normal((E, D)).astype(np.float32)
    router[4] = router[1]
    h = rng.standard_normal((rows, D)).astype(np.float32)
    h[0] = router[1]  # the tied pair wins row 0
    logits = (jnp.asarray(h) @ jnp.asarray(router).T).astype(jnp.float32)
    topv, want_i = jax.lax.top_k(logits, K)
    want_w = jax.nn.softmax(topv, axis=-1)
    cfg = ModelConfig(
        architecture="llama", model_name="r", embedding_dim=D, hidden_dim=D, n_layers=1,
        n_heads=1, n_kv_heads=1, vocab_size=8, seq_len=8, rms_norm_eps=1e-5,
        n_experts=E, n_experts_used=K)
    topi, topw = moe_route({"ffn_gate_inp": torch.from_numpy(router)}, torch.from_numpy(h), cfg)
    assert list(np.asarray(want_i[0])) == [1, 4]
    np.testing.assert_array_equal(topi.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(topw.numpy(), np.asarray(want_w), rtol=1e-5, atol=1e-6)
    assert topw.dtype == torch.float32


# ---------------------------------------------------------------------------
# the grouped matmuls
# ---------------------------------------------------------------------------

def _stacked_pair(E, m, k, seed, w8):
    """E Q4_K weights from the same bytes, stacked: (JAX kernel-layout
    QTensor (E, m, k), the port's)."""
    jsingles, planes = [], []
    for e in range(E):
        w = (np.random.default_rng([seed, e]).standard_normal((m, k)) * 0.05).astype(np.float32)
        raw = jquantize(JGGMLType.Q4_K, w)
        jq = jgemm.repack(jto_planar(JGGMLType.Q4_K, raw, (m, k)))
        jsingles.append(jgemm.augment_w8(jq) if w8 else jq)
        planes.append(to_kernel_layout(to_planar(GGMLType.Q4_K, raw, (m, k))).planes)
    jst = JQTensor(JGGMLType.Q4_K, (E, m, k),
                   {n: jnp.stack([jnp.asarray(s.planes[n]) for s in jsingles])
                    for n in jsingles[0].planes})
    st = QTensor(GGMLType.Q4_K, (E, m, k),
                 {n: torch.stack([p[n] for p in planes]) for n in planes[0]})
    return jst, gemm_quant.augment_w8(st) if w8 else st


@pytest.mark.parametrize("w8,counts", [(False, (13, 0, 40)), (True, (101, 0, 163))],
                         ids=["q4k", "w8"])
def test_grouped_plain_versions_match_pallas(w8, counts):
    """Rows sorted by expert, expert 1 empty, the other segments ragged. The
    JAX kernel wants every segment padded to its 8-row tile and one expert id
    per tile; the port takes the rows as they are and the segment offsets.
    Tolerance 1e-4 of max|out| in float32: the same planes, sums in another
    order (the W8 form needs 256 padded rows on the JAX side to engage)."""
    E, m, k, TB = 3, 256, 512, 8
    jst, st = _stacked_pair(E, m, k, seed=5, w8=w8)
    rng = np.random.default_rng(6)
    xs = rng.standard_normal((sum(counts), k)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    padded, tile_expert = [], []
    for e, n in enumerate(counts):
        n_pad = -(-n // TB) * TB
        seg = np.zeros((n_pad, k), np.float32)
        seg[:n] = xs[offsets[e]:offsets[e + 1]]
        padded.append(seg)
        tile_expert += [e] * (n_pad // TB)
    starts = np.concatenate([[0], np.cumsum([p.shape[0] for p in padded])])
    rows = np.concatenate([starts[e] + np.arange(n) for e, n in enumerate(counts)])
    called = []
    name = "_run_grouped_w8" if w8 else "_run_grouped"
    orig = getattr(jgemm, name)
    setattr(jgemm, name, lambda *a, **kw: (called.append(1), orig(*a, **kw))[1])
    try:
        want = np.asarray(jgemm.qmatmul_grouped(
            jnp.asarray(np.concatenate(padded)), jst, jnp.asarray(tile_expert, jnp.int32), TB,
            jnp.float32))[rows]
    finally:
        setattr(jgemm, name, orig)
    assert called, f"the JAX side did not take {name}"
    p = st.planes
    off = torch.from_numpy(offsets)
    if w8:
        got = gemm_quant.qmm_w8_grouped_plain(torch.from_numpy(xs), p["w8"], p["dw"], off)
        wrapped = gemm_quant.qmm_w8_grouped(torch.from_numpy(xs), st, off)
    else:
        got = gemm_quant.qmm_q4k_grouped_plain(torch.from_numpy(xs), p["qs"], p["dsub"],
                                               p["msub"], off)
        wrapped = gemm_quant.qmm_q4k_grouped(torch.from_numpy(xs), st, off)
    assert got.shape == (sum(counts), m)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
    routed = gemm_quant.qmatmul_grouped(torch.from_numpy(xs), st, off, w8=w8)
    np.testing.assert_array_equal(routed.numpy(), got.numpy())


def test_w4a8_per_row_planes_match_row_by_row():
    """Row b against plane[b] equals the one-row kernel on that plane
    (quantization is per row), within the float32 sums' other order."""
    _, st = _stacked_pair(4, 256, 512, seed=8, w8=False)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((5, 512)).astype(np.float32))
    plane = torch.tensor([3, 0, 3, 1, 2], dtype=torch.int32)
    got = gemm_quant.qmm_w4a8(x, st, plane=plane)
    p = st.planes
    for b, e in enumerate(plane.tolist()):
        want = gemm_quant.qmm_w4a8_plain(x[b:b + 1], p["qs"][e], p["dsub"][e], p["msub"][e])
        torch.testing.assert_close(got[b:b + 1], want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# moe_ffn against the JAX package, regime by regime
# ---------------------------------------------------------------------------

def _moe_model(tmp_path_factory, E, w8):
    """A 1-layer MoE model written by the JAX package's synthetic writer, read
    by both loaders: (jax cfg, jax layer weights in kernel layout, port cfg,
    port layer dict). D = HD = 256 with E = 3 keeps the W8 planes in the JAX
    package's expert view (its 256-wide W8 tile divides per expert)."""
    jcfg = JModelConfig(
        architecture="llama", model_name="syn-moe", embedding_dim=256, hidden_dim=256,
        n_layers=1, n_heads=2, n_kv_heads=1, vocab_size=512, seq_len=256, rms_norm_eps=1e-5,
        **ARCH_FEATURES["llama"], n_experts=E, n_experts_used=2)
    path = str(tmp_path_factory.mktemp("moe") / f"moe-{E}.gguf")
    write_synthetic_gguf(path, jcfg, JGGMLType.Q4_K, seed=40 + E)
    jgf = JGGUFFile(path)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jw = repack_weights(fuse_weights(jload_weights(jgf, jcfg), jcfg), jcfg)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    pw = load_weights(gf, cfg)
    if w8:
        jw, pw = jaugment_w8_weights(jw), augment_w8_weights(pw)
        assert "w8" in jw["layers"]["ffn_gate_exps"].planes
        assert "w8" in pw["layers"][0]["wgu_exps"].planes
    return jcfg, jw["layers"], cfg, pw["layers"][0]


@pytest.fixture(scope="module")
def moe_models(tmp_path_factory):
    return {(E, w8): _moe_model(tmp_path_factory, E, w8)
            for E, w8 in ((3, False), (3, True), (8, False))}


@pytest.mark.parametrize("E,w8,rows", [
    (3, False, 1), (3, False, 3), (3, False, 8), (3, False, 40), (3, False, 128),
    (3, True, 1), (3, True, 3), (3, True, 8), (3, True, 40), (3, True, 128),
    (8, False, 3),
])
def test_moe_ffn_matches_jax(moe_models, w4a8_backend, E, w8, rows):
    """float32 compute, backend w4a8 on the JAX side. One row: its gather by
    plane index; 3 rows of 8 experts: lax.cond per expert; 3 and 8 rows of 3
    experts and 40 rows: the all-experts mix (int8 activations up to 16 rows,
    the Q4_K dequant kernel above); 128 rows: the grouped kernels, on the W8
    planes when they are attached. The port's one per-row-plane mechanism and
    its grouped kernels give the same numbers row by row. Tolerance 2e-4 of
    max|out| (tests/test_model.py:41): the same planes and int8 activations,
    float32 sums in another order (3e-6 in practice). Up to 16 rows the
    down matmul quantizes silu(gate)*up, which the two sides computed with
    those other sums: a value on an int8 rounding boundary may round the
    other way and moves its row by ~6e-4 of max|out| at k = 256. So one row in
    eight may miss 2e-4, and must then meet 2e-3."""
    jcfg, jlw, cfg, lw = moe_models[E, w8]
    x = np.random.default_rng(rows).standard_normal((1, rows, 256)).astype(np.float32)
    called = []
    orig = jgemm._run_grouped_w8
    jgemm._run_grouped_w8 = lambda *a, **k: (called.append(1), orig(*a, **k))[1]
    try:
        want = np.asarray(jmoe_ffn(jlw, 0, jnp.asarray(x), jcfg, jnp.float32))
    finally:
        jgemm._run_grouped_w8 = orig
    assert bool(called) == (w8 and rows >= 64)
    got = moe_ffn(lw, torch.from_numpy(x), cfg).numpy()
    assert got.shape == x.shape
    err = np.abs(got - want)[0].max(-1) / np.abs(want).max()  # per row
    flipped = err > 2e-4
    assert flipped.sum() <= (rows // 8 if rows <= 16 else 0), err
    assert err.max() <= 2e-3


@pytest.mark.parametrize("rows,tol", [(1, 3e-2), (8, 3e-2), (40, 1e-4), (128, 1e-4)])
def test_moe_ffn_matches_its_plain_version(moe_models, rows, tol):
    """moe_ffn_plain computes every expert for every row through a dense
    float32 product. From 17 rows on moe_ffn dequantizes the same weights, so
    only the order of float32 sums differs (1e-4 of max|out|); up to 16 rows
    it quantizes the activations to int8 per 32-group, which moves the result
    by about 1% of max|out|."""
    _, _, cfg, lw = moe_models[3, False]
    x = torch.from_numpy(np.random.default_rng(rows).standard_normal((rows, 256))
                         .astype(np.float32))
    got, want = moe_ffn(lw, x, cfg), moe_ffn_plain(lw, x, cfg)
    assert (got - want).abs().max() <= tol * want.abs().max()


def test_moe_ffn_reads_no_routing_value_on_the_host(moe_models):
    """Up to 16 rows moe_ffn runs on the meta device, where tensors have no
    data: any .item(), .tolist() or Python branch on a routing value would
    raise. The expert of each row reaches the kernel as a tensor."""
    _, _, cfg, lw = moe_models[3, False]
    meta = {n: (QTensor(v.kind, v.shape, {k: p.to("meta") for k, p in v.planes.items()})
                if isinstance(v, QTensor) else v.to("meta")) for n, v in lw.items()}
    for rows in (1, 16):
        out = moe_ffn(meta, torch.empty(rows, 256, device="meta"), cfg)
        assert out.shape == (rows, 256) and out.device.type == "meta"


def test_moe_dense_expert_weights_take_the_plain_version(tmp_path):
    """F32 experts carry no kernel planes: moe_ffn is moe_ffn_plain then."""
    jcfg = JModelConfig(
        architecture="llama", model_name="syn-moe-f32", embedding_dim=64, hidden_dim=64,
        n_layers=1, n_heads=2, n_kv_heads=1, vocab_size=300, seq_len=64, rms_norm_eps=1e-5,
        **ARCH_FEATURES["llama"], n_experts=4, n_experts_used=2)
    path = str(tmp_path / "moe-f32.gguf")
    write_synthetic_gguf(path, jcfg, JGGMLType.F32, seed=1)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    lw = load_weights(gf, cfg)["layers"][0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((5, 64)).astype(np.float32))
    torch.testing.assert_close(moe_ffn(lw, x, cfg), moe_ffn_plain(lw, x, cfg), rtol=0, atol=0)
    jw = jload_weights(JGGUFFile(path), jconfig_from_gguf(JGGUFFile(path).metadata))
    want = np.asarray(jmoe_ffn(jw["layers"], 0, jnp.asarray(x.numpy()), jcfg, jnp.float32))
    np.testing.assert_allclose(moe_ffn(lw, x, cfg).numpy(), want, rtol=2e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the slice as a whole on tiny-moe
# ---------------------------------------------------------------------------

def test_load_weights_reads_the_synthetic_moe_gguf(tiny_moe):
    gf = GGUFFile(tiny_moe)
    cfg = config_from_gguf(gf.metadata)
    assert (cfg.n_experts, cfg.n_experts_used, cfg.head_dim) == (4, 2, 128)
    check_supported(cfg)
    assert gf.get_tensor_info("blk.0.ffn_gate_exps.weight").shape == (4, 512, 256)
    assert gf.get_tensor_info("blk.1.ffn_down_exps.weight").shape == (4, 256, 512)
    lw = load_weights(gf, cfg, compute_dtype=torch.bfloat16)["layers"][1]
    assert "wgu" not in lw and "ffn_down" not in lw
    assert lw["ffn_gate_inp"].shape == (4, 256) and lw["ffn_gate_inp"].dtype == torch.bfloat16
    assert lw["wgu_exps"].shape == (4, 1024, 256) and lw["wgu_exps"].stacked
    assert lw["wgu_exps"].planes["qs"].shape == (4, 1024, 128)
    assert lw["wgu_exps"].planes["dsub"].dtype == torch.bfloat16
    assert lw["ffn_down_exps"].shape == (4, 256, 512)


def test_from_jax_weights_carries_router_and_experts(tiny_moe):
    """The JAX package's planar MoE weights (experts folded into m) give the
    tensors the port's own loader gives, bit for bit."""
    jgf = JGGUFFile(tiny_moe)
    jw = jload_weights(jgf, jconfig_from_gguf(jgf.metadata))
    gf = GGUFFile(tiny_moe)
    cfg = config_from_gguf(gf.metadata)
    want = load_weights(gf, cfg)
    got = from_jax_weights(jw, cfg)
    for lg, lw in zip(got["layers"], want["layers"]):
        assert set(lg) == set(lw)
        for n, v in lw.items():
            if isinstance(v, QTensor):
                assert lg[n].shape == v.shape
                for pn, plane in v.planes.items():
                    assert torch.equal(lg[n].planes[pn], plane), (n, pn)
            else:
                assert torch.equal(lg[n], v), n


def test_tiny_moe_forward_matches_jax_w4a8(tiny_moe, w4a8_backend):
    """Tolerance 2e-4 (tests/test_model.py:41): float32 on both sides, the
    same Q4_K bytes and int8 activations, sums in another order. 32 prefill
    rows take the Q4_K dequant kernels (grouped in the port, all experts in
    JAX), the decode step the int8-activation kernel on the selected planes.

    The synthetic file's weights lie on one grid (every Q4_K block has the
    same d), so a normalized embedding row can sit exactly on an int8 rounding
    tie, which float32 sums of another order break either way; one such flip
    moves these narrow logits by ~3e-3. This file's seed has no tie in the
    compared steps (seeds 2 and 4 have one, in the first layer's q|k|v)."""
    jgf = JGGUFFile(tiny_moe)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jk = repack_weights(fuse_weights(jload_weights(jgf, jcfg), jcfg), jcfg)
    gf = GGUFFile(tiny_moe)
    cfg = config_from_gguf(gf.metadata)
    pw = load_weights(gf, cfg)
    tokens = np.random.default_rng(0).integers(3, cfg.vocab_size, (1, 33))
    jcache = JKVCache.create(jcfg, 1, 256)
    cache = KVCache.create(cfg, 1, 256)
    for toks, p in ((tokens[:, :32], 0), (tokens[:, 32:], 32)):
        want, jcache = jforward(jk, jcache, jnp.asarray(toks, jnp.int32),
                                jnp.asarray([p], jnp.int32), jcfg, jnp.float32)
        got = forward(pw, cache, torch.from_numpy(toks), torch.tensor([p]), cfg, torch.float32)
        assert got.shape == (1, toks.shape[1], cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_tiny_moe_runner_greedy_tokens_match_jax(tiny_moe, w4a8_backend):
    """The same 16 greedy tokens from both packages (float32 compute, backend
    w4a8 on the JAX side), and again after a reset."""
    prompt = "w7 w99 w3 w200 w17"
    jr = JRunner(tiny_moe, backend="w4a8", compute_dtype=jnp.float32)
    want = "".join(jr.prefill_and_generate(prompt, 16))
    r = Runner(tiny_moe, compute_dtype=torch.float32, device="cpu")
    got = "".join(r.prefill_and_generate(prompt, 16))
    assert r.metrics.counts["tokens"] == 15
    assert got == want
    r.reset()
    assert "".join(r.prefill_and_generate(prompt, 16)) == got


@pytest.mark.parametrize("w8", [False, True], ids=["q4k", "w8_planes"])
def test_serving_engines_match_the_runner_on_tiny_moe(tiny_moe, w8):
    """Neither engine needed a change for the MoE FFN: layer_body is shared.
    Three prompts at once through two slots give the Runner's greedy text,
    and the paged engine returns its pages. The 181-token prompt is one chunk
    for the Runner and for both engines, so all three take the same kernels
    for it: the grouped ones, on the W8 planes when those are attached (a
    prompt cut into other chunks would cross the 249-row line elsewhere, and
    W8 numbers differ from Q4_K numbers by the requantization)."""
    r = Runner(tiny_moe, compute_dtype=torch.float32, device="cpu", prefill_w8=w8)
    prompts = ["hello world", "w5 w6 w7 " * 12, "a"]
    want = []
    for p in prompts:
        r.reset()
        want.append("".join(r.prefill_and_generate(p, 8)))
    dense = ServingEngine(r, n_slots=2, seq_len=512)
    assert dense.generate(prompts, max_tokens=8) == want
    paged = PagedServingEngine(r, n_slots=2, n_pages=16, seq_len=512)
    free = paged.pages_free()
    assert paged.generate(prompts, max_tokens=8) == want
    assert paged.pages_free() == free


def test_runner_prefill_w8_on_tiny_moe(tiny_moe):
    """With the planes attached a 100-token prompt prefills through the
    grouped W8 form; the requantization error does not move the argmax."""
    on = Runner(tiny_moe, compute_dtype=torch.float32, device="cpu", prefill_w8=True)
    off = Runner(tiny_moe, compute_dtype=torch.float32, device="cpu")
    assert "w8" in on.weights["layers"][0]["wgu_exps"].planes
    assert "w8" not in off.weights["layers"][0]["wgu_exps"].planes
    prompt = "b" * 100
    assert on.prefill(prompt)[2] == off.prefill(prompt)[2]

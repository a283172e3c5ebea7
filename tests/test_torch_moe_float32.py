"""The float32 mixture of experts against the JAX package on the CPU (its
default compute dtype):

- The grouped dequant forms' plain versions in float32 for all eleven
  schemes against the JAX grouped kernel (`_run_grouped` at out_dtype
  float32, interpret mode), and on the exact float32 weights, never rounded
  to bfloat16; the float32 W8 route (x rounded to bfloat16, float32 out)
  against the JAX package's qmatmul_grouped on W8 planes.
- Expert stacks load with float32 scale planes under float32 compute, take
  their W8 planes in float32 runs too, and `_auto_w8_budget` counts the
  float32 scales.
- The tiny-moe and tiny-moe8 forwards and greedy Runner tokens in float32
  against the JAX package, both engines equal to the Runner.
- bfloat16 against float32 on Q8_0 tiny-moe8 files: the JAX package moves
  as large a share of the prompt's tokens past 5e-2 as the port does.
On the card: `-k "f32_grouped or moe_ffn_float32 or w8_grouped_rounds"` of
tests/test_torch_kernels_gpu.py and chip_smoke.py's `mixtral-q4_k_m-f32`."""

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
from crabml_tpu.runtime.runner import Runner as JRunner
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.models.config import config_from_gguf
from crabml_tpu_torch.models.forward import KVCache, forward
from crabml_tpu_torch.models.weights import augment_w8_weights, load_weights
from crabml_tpu_torch.ops.cuda import gemm_quant
from crabml_tpu_torch.quant.qtensor import FORM_KIND, dequantize, plane_of, to_kernel_layout, \
    to_planar
from crabml_tpu_torch.runtime import runner as runner_mod
from crabml_tpu_torch.runtime.runner import Runner
from crabml_tpu_torch.serving import PagedServingEngine, ServingEngine
from crabml_tpu_torch.tools.synth_gguf import SCHEMES as SYNTH, vary_scales
from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

ALL_KINDS = (GGMLType.Q4_K, GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q5_K, GGMLType.Q4_0,
             GGMLType.Q3_K, GGMLType.Q2_K, GGMLType.Q5_0, GGMLType.Q4_1, GGMLType.Q5_1,
             GGMLType.Q8_1)
E, M, K = 4, 256, 256
PROMPT = "w7 w99 w3 w200 w17"


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


def _pair(kind, seed):
    """E distinct (M, K) experts of `kind` from the same random blocks (each
    block's scales varied): the JAX kernel-layout stack and the port's kernel
    planes, both with float32 scales, as each package loads them under
    float32 compute."""
    _, blocks = next(v for v in SYNTH.values() if v[0] == kind)
    rng = np.random.default_rng(seed)
    raw = vary_scales(kind, blocks(rng, E * M * K, 0.05), rng).reshape(E, -1)
    singles = [jgemm.repack(jto_planar(JGGMLType(int(kind)), raw[e].tobytes(), (M, K)),
                            np.float32) for e in range(E)]
    jst = JQTensor(JGGMLType(int(kind)), (E, M, K),
                   {n: jnp.stack([jnp.asarray(s.planes[n]) for s in singles])
                    for n in singles[0].planes})
    st = to_kernel_layout(to_planar(kind, raw.tobytes(), (E, M, K)), torch.float32)
    for n, t in st.planes.items():
        assert not any(torch.equal(t[0], t[e]) for e in range(1, E)), n
        assert n not in ("dsub", "msub") or t.dtype == torch.float32
    return jst, st


def _jax_grouped(jst, xs, counts, name="_run_grouped", TB=8):
    """The JAX package's grouped matmul at compute dtype float32 on the rows
    of `xs` sorted by expert: every segment padded to its TB-row tiles, one
    expert id a tile, the padding cut away again; asserts that `name` (the
    grouped kernel's launcher) ran."""
    offsets = np.concatenate([[0], np.cumsum(counts)])
    padded, tile_expert = [], []
    for e, n in enumerate(counts):
        seg = np.zeros((-(-n // TB) * TB, xs.shape[1]), np.float32)
        seg[:n] = xs[offsets[e]:offsets[e + 1]]
        padded.append(seg)
        tile_expert += [e] * (seg.shape[0] // TB)
    starts = np.concatenate([[0], np.cumsum([p.shape[0] for p in padded])])
    rows = np.concatenate([starts[e] + np.arange(n) for e, n in enumerate(counts)])
    called = []
    orig = getattr(jgemm, name)
    setattr(jgemm, name, lambda *a, **kw: (called.append(1), orig(*a, **kw))[1])
    try:
        out = jgemm.qmatmul_grouped(jnp.asarray(np.concatenate(padded)), jst,
                                    jnp.asarray(tile_expert, jnp.int32), TB, jnp.float32)
    finally:
        setattr(jgemm, name, orig)
    assert called, f"the JAX side did not take {name}"
    assert out.dtype == jnp.float32
    return np.asarray(out)[rows]


@pytest.mark.parametrize("kind", ALL_KINDS, ids=[k.name.lower() for k in ALL_KINDS])
def test_grouped_f32_plain_matches_pallas(kind):
    """Rows sorted by expert, expert 0 empty, a 13-row segment (the next one
    starts mid-tile of the JAX kernel's 8-row tiles), a 1-row one: the
    float32 plain version of the scheme's grouped form (Q4_1, Q5_1 and Q8_1
    on the Q4_K, Q5_K and Q8_0 forms) against the JAX grouped kernel at
    out_dtype float32 (Precision.HIGHEST), tolerance 1e-5 of max|out|: the
    same float32 weights, sums in another order. Each segment equals the
    float32 product with its expert's exact float32 weights bit for bit (no
    weight is rounded to bfloat16); the wrapper and qmatmul_grouped take the
    plain version for a CPU tensor."""
    jst, st = _pair(kind, seed=21 + int(kind))
    counts = (0, 13, 1, 50)
    xs = np.random.default_rng(22).standard_normal((sum(counts), K)).astype(np.float32)
    want = _jax_grouped(jst, xs, counts)
    name = gemm_quant.GROUPED_FORMS[FORM_KIND[kind]]
    off = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32)
    x = torch.from_numpy(xs)
    got = getattr(gemm_quant, f"{name}_plain")(
        x, *(st.planes[n] for n in gemm_quant._KERNEL_PLANES[FORM_KIND[kind]]), off)
    assert got.dtype == torch.float32 and got.shape == (sum(counts), M)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    cuts = off.tolist()
    for e, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
        if hi > lo:
            assert torch.equal(got[lo:hi], x[lo:hi] @ dequantize(plane_of(st, e)).t()), e
    assert torch.equal(getattr(gemm_quant, name)(x, st, off), got)
    assert torch.equal(gemm_quant.qmatmul_grouped(x, st, off, w8=False), got)


def test_w8_grouped_f32_route_matches_jax():
    """A Q4_K stack with W8 planes, 300 float32 rows (the JAX package takes
    its W8 route from W8_MIN_ROWS padded rows): qmatmul_grouped rounds x to
    bfloat16 and writes float32, as the JAX qmatmul_grouped does
    (gemm_quant.py:896-903). Tolerance 1e-5 of max|out|: the same int8
    planes and bfloat16 x, float32 sums in another order."""
    jst, st = _pair(GGMLType.Q4_K, seed=31)
    jst = jgemm.augment_w8(jst)
    st = gemm_quant.augment_w8(st)
    counts = (101, 0, 163, 36)
    xs = np.random.default_rng(32).standard_normal((sum(counts), K)).astype(np.float32)
    want = _jax_grouped(jst, xs, counts, "_run_grouped_w8")
    off = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32)
    x = torch.from_numpy(xs)
    got = gemm_quant.qmatmul_grouped(x, st, off, w8=True)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert torch.equal(got, gemm_quant.qmm_w8_grouped(x.to(torch.bfloat16), st, off))


@pytest.mark.parametrize("scheme", ["q4_k", "q6_k", "q2_k"])
def test_experts_load_float32_scales_and_w8_planes(tmp_path, scheme):
    """Under float32 compute every expert stack loads its dsub / msub planes
    in float32 (the bfloat16 run's are bfloat16), augment_w8_weights attaches
    the experts' W8 planes, computed from the exact float32 weights, and
    `_auto_w8_budget` counts the float32 scales: their 2 extra bytes a scale
    over the file's bytes (Q2_K keeps its own scales either way)."""
    path = build_synth_gguf(str(tmp_path / f"{scheme}.gguf"), "tiny-moe8", seed=4, scheme=scheme)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    f32 = load_weights(gf, cfg, compute_dtype=torch.float32)
    bf16 = load_weights(gf, cfg, compute_dtype=torch.bfloat16)
    for lf, lb in zip(f32["layers"], bf16["layers"]):
        for n in ("wgu_exps", "ffn_down_exps"):
            for p in ("dsub", "msub"):
                if p in lf[n].planes:
                    assert lf[n].planes[p].dtype == torch.float32
                    assert lb[n].planes[p].dtype == torch.bfloat16
    aug = augment_w8_weights(f32)
    for lw in aug["layers"]:
        for n in ("wgu_exps", "ffn_down_exps"):
            qt = lw[n]
            assert qt.planes["w8"].shape[:2] == qt.shape[:2]
            want = gemm_quant.augment_w8(plane_of(qt, 3)).planes["w8"]
            assert torch.equal(qt.planes["w8"][3], want)
    extra = runner_mod._f32_scale_bytes(gf)
    assert (extra == 0) == (scheme == "q2_k")
    if extra:
        assert extra == sum(2 * t.numel() for lw in f32["layers"] for q in lw.values()
                            if hasattr(q, "planes")
                            for n, t in q.planes.items() if n in ("dsub", "msub")) \
            + sum(2 * t.numel() for n, t in f32["output"].planes.items() if n in ("dsub", "msub"))


def test_auto_w8_budget_counts_float32_scales(tmp_path, monkeypatch):
    """On a (faked) card the float32 run's budget is the bfloat16 run's less
    the float32 scales' extra bytes."""
    path = build_synth_gguf(str(tmp_path / "m.gguf"), "tiny-moe8", seed=4, scheme="q4_k")
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)

    class Props:
        total_memory = 80 << 30

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props)
    monkeypatch.setattr(runner_mod.os.path, "getsize", lambda p: 4 << 30)
    card = torch.device("cuda", 0)
    full = int(sum(t.n_elems for t in gf.tensor_infos
                   if len(t.dimensions) >= 2 and "token_embd" not in t.name) * 1.008)
    kv = 2 * cfg.n_layers * 512 * cfg.n_kv_heads * cfg.head_dim * 4
    Props.total_memory = (6 << 30) + kv + full - 1000
    assert runner_mod._auto_w8_budget(gf, cfg, 512, 4, card) == full - 1000
    assert runner_mod._auto_w8_budget(gf, cfg, 512, 4, card, torch.float32) == \
        full - 1000 - runner_mod._f32_scale_bytes(gf)


@pytest.fixture(scope="module")
def moe_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_f32")
    return {"tiny-moe": build_synth_gguf(str(d / "tiny-moe.gguf"), "tiny-moe", seed=3),
            "tiny-moe8": build_synth_gguf(str(d / "tiny-moe8.gguf"), "tiny-moe8", seed=3)}


@pytest.mark.parametrize("model", ["tiny-moe", "tiny-moe8"])
def test_moe_forward_f32_matches_jax(moe_files, model, w4a8_backend):
    """Float32 on both sides, the JAX forward under backend w4a8: a 64-row
    prefill (the grouped float32 forms: the JAX package's grouped kernels
    from _GROUPED_MIN_ROWS rows) and a decode step (the plane forms' float32
    entries). Tolerance 2e-4 (tests/test_model.py:41): the same planes and
    int8 activations, sums in another order."""
    path = moe_files[model]
    jgf = JGGUFFile(path)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jk = repack_weights(fuse_weights(jload_weights(jgf, jcfg), jcfg), jcfg)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    pw = load_weights(gf, cfg, compute_dtype=torch.float32)
    tokens = np.random.default_rng(0).integers(3, cfg.vocab_size, (1, 65))
    jcache = JKVCache.create(jcfg, 1, 256)
    cache = KVCache.create(cfg, 1, 256)
    for toks, p in ((tokens[:, :64], 0), (tokens[:, 64:], 64)):
        want, jcache = jforward(jk, jcache, jnp.asarray(toks, jnp.int32),
                                jnp.asarray([p], jnp.int32), jcfg, jnp.float32)
        got = forward(pw, cache, torch.from_numpy(toks), torch.tensor([p]), cfg, torch.float32)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("model", ["tiny-moe", "tiny-moe8"])
def test_moe_runner_f32_matches_jax_and_the_engines(moe_files, model, w4a8_backend):
    """The same 16 greedy tokens from both packages' Runners in float32
    (backend w4a8 on the JAX side) on a 181-token prompt (its prefill through
    the grouped float32 forms); then the port's Runner equals the dense and
    the paged engine (float32 pool, pages returned) on three prompts through
    two slots, the long one a single prefill chunk for all three."""
    path = moe_files[model]
    prompt = "w5 w6 w7 " * 12
    jr = JRunner(path, backend="w4a8", compute_dtype=jnp.float32)
    want = "".join(jr.prefill_and_generate(prompt, 16))
    r = Runner(path, compute_dtype=torch.float32, device="cpu")
    assert len(r.tokenizer.encode(prompt, bos=True)) == 181
    assert "".join(r.prefill_and_generate(prompt, 16)) == want
    prompts = [PROMPT, prompt, "a"]
    texts = []
    for p in prompts:
        r.reset()
        texts.append("".join(r.prefill_and_generate(p, 8)))
    assert ServingEngine(r, n_slots=2, seq_len=512).generate(prompts, max_tokens=8) == texts
    paged = PagedServingEngine(r, n_slots=2, n_pages=16, seq_len=512)
    assert paged.cache.k.dtype == torch.float32
    free = paged.pages_free()
    assert paged.generate(prompts, max_tokens=8) == texts
    assert paged.pages_free() == free


def _bf16_share(path, tokens):
    """Of each package's forward on `tokens` from pos 0, the share of tokens
    whose logits in bfloat16 lie more than 5e-2 of max|float32 logit| from
    its own float32 logits (both packages on backend w4a8's routing: the
    64-row prompt through the grouped dequant forms)."""
    jgf = JGGUFFile(path)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jk = repack_weights(fuse_weights(jload_weights(jgf, jcfg), jcfg), jcfg)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    outs = {}
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        j, _ = jforward(jk, JKVCache.create(jcfg, 1, 256, jdt), jnp.asarray(tokens, jnp.int32),
                        jnp.asarray([0], jnp.int32), jcfg, jdt)
        pw = load_weights(gf, cfg, compute_dtype=tdt)
        p = forward(pw, KVCache.create(cfg, 1, 256, tdt), torch.from_numpy(tokens),
                    torch.tensor([0]), cfg, tdt)
        outs[tdt] = (np.asarray(j, np.float32)[0], p.float().numpy()[0])
    shares = []
    for i in range(2):
        f32, bf16 = outs[torch.float32][i], outs[torch.bfloat16][i]
        per = np.abs(bf16 - f32).max(-1) / np.abs(f32).max()
        shares.append(float((per > 5e-2).mean()))
    return shares  # (JAX, port)


def test_bfloat16_moves_as_many_tokens_in_the_jax_package(tmp_path, w4a8_backend):
    """bfloat16 moved 28-31% of the 2-layer Mixtral Q8_0 / Q5_K_M prompts'
    tokens past 5e-2 of float32 in the port's plain versions, which asked
    whether the JAX package moves as many: on Q8_0 tiny-moe8 files (seeds 5, 6 and 7,
    128-token prompts), the JAX package's own bfloat16 forward moves a share
    of the same size (measured 6.5% against the port's 9.6% over the three;
    per file 2.3 / 3.1 / 14.1% against 14.1 / 1.6 / 13.3%: each comes from a
    few router near-ties that a bfloat16 rounding flips, which seed by seed
    fall in either package). The port's share is no larger than twice the
    JAX package's, and the JAX package's own is above 3%: a known
    difference of bfloat16, not a fault of the port."""
    jax_share, port_share = [], []
    for seed in (5, 6, 7):
        path = build_synth_gguf(str(tmp_path / f"q8_{seed}.gguf"), "tiny-moe8", seed=seed,
                                scheme="q8_0")
        tokens = np.random.default_rng(seed + 1).integers(3, 512, (1, 128))
        j, p = _bf16_share(path, tokens)
        jax_share.append(j)
        port_share.append(p)
    assert np.mean(jax_share) > 0.03
    assert np.mean(port_share) <= 2 * np.mean(jax_share)

"""tools/synth_gguf.py's new families, cut to tiny widths: what each file
carries (qwen2's q, k and v biases, qwen3's key_length and q / k norms,
gemma's tied output and head dim 256, Llama-3.1's rope_freqs divisors from
its rope_scaling and no rope.scaling.type), and that the port and the JAX
package compute the same prompt logits from it (every matrix Q4_K: the JAX
package stacks its layers, so a layer may not change a tensor's kind); then
the qwen2 file in llama.cpp's Q4_K_M layout (layer 1 keeps q, k and v
apart, so its biases add to the unfused products) through the Runner and
the paged engine on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.gguf.reader import GGUFFile as JGGUFFile
from crabml_tpu.models.config import config_from_gguf as jconfig_from_gguf
from crabml_tpu.models.forward import KVCache as JKVCache
from crabml_tpu.models.forward import forward as jforward
from crabml_tpu.models.weights import fuse_weights, repack_weights
from crabml_tpu.models.weights import load_weights as jload_weights
from crabml_tpu.ops import matmul as jmm
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.models.config import config_from_gguf
from crabml_tpu_torch.models.forward import KVCache, forward
from crabml_tpu_torch.models.weights import load_weights
from crabml_tpu_torch.ops.rope import inv_freq
from crabml_tpu_torch.runtime.runner import Runner
from crabml_tpu_torch.serving import PagedServingEngine, ServingEngine
from crabml_tpu_torch.tools import synth_gguf

# each family's shape at tiny widths, its FAMILIES metadata kept (None: a tiny shape of its own)
TINY = {
    "tiny-qwen2": None,  # 14 q heads over 2 kv heads (7 a kv head) of head dim 128
    "qwen3-8b": (256, 512, 2, 4, 1, 512, 512, 0, 0, 1e6),  # head dim 128
    "gemma-7b": (256, 512, 2, 2, 2, 512, 512, 0, 0, 10000.0),  # head dim 256
    "llama31-8b": (256, 512, 2, 2, 1, 512, 512, 0, 0, 500000.0),  # head dim 128
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


def _build(tmp_path, monkeypatch, model: str, mix=None) -> str:
    if TINY[model] is not None:
        monkeypatch.setitem(synth_gguf.MODEL_SHAPES, model, TINY[model])
    path = str(tmp_path / f"{model}.gguf")
    return synth_gguf.build_synth_gguf(path, model, seed=5, scheme="q4_k", mix=mix)


@pytest.mark.parametrize("model", list(TINY))
def test_synth_family_matches_jax(tmp_path, monkeypatch, model):
    """The file's family features as llama.cpp writes them, and a 20-token
    prompt through both packages at 2e-4 (float32; prompt rows take the
    dequant kernels on both sides, so no int8 activation is involved)."""
    path = _build(tmp_path, monkeypatch, model)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    fam = synth_gguf.FAMILIES[model]
    names = {ti.name for ti in gf.tensor_infos}
    assert cfg.architecture == fam["arch"]
    assert cfg.head_dim == fam.get("head_dim", cfg.embedding_dim // cfg.n_heads)
    assert ("blk.0.attn_q.bias" in names) == (fam["arch"] == "qwen2")
    assert ("blk.1.attn_k_norm.weight" in names) == (fam["arch"] == "qwen3")
    assert ("output.weight" in names) == (not fam.get("tied", False))
    assert ("rope_freqs.weight" in names) == ("llama3_rope" in fam)
    assert cfg.rope_scaling_type == "none"  # llama.cpp's Llama-3.1 files name no scaling type
    w = load_weights(gf, cfg)
    if fam["arch"] == "qwen2":
        assert cfg.n_heads // cfg.n_kv_heads == 7
        assert all(lw["bqkv"].shape == ((cfg.n_heads + 2 * cfg.n_kv_heads) * 128,)
                   for lw in w["layers"])
    want_inv = inv_freq(cfg.head_dim, float(cfg.rope_base), torch.device("cpu"))
    if "llama3_rope" in fam:  # the file's divisors, read back through the frequencies
        ff = synth_gguf.llama3_freq_factors(cfg.head_dim, cfg.rope_base, *fam["llama3_rope"])
        assert ff.max() == 8.0 and ff.min() == 1.0
        want_inv = want_inv / torch.from_numpy(ff)
    torch.testing.assert_close(w["rope_inv_freq"], want_inv, rtol=0, atol=0)

    jgf = JGGUFFile(path)
    jcfg = jconfig_from_gguf(jgf.metadata)
    jmm.set_backend("w4a8")
    try:
        jw = repack_weights(fuse_weights(jload_weights(jgf, jcfg), jcfg), jcfg)
        assert (jw["rope_freqs"] is not None) == ("llama3_rope" in fam)
        tokens = np.random.default_rng(6).integers(3, cfg.vocab_size, (1, 20))
        want, _ = jforward(jw, JKVCache.create(jcfg, 1, 64), jnp.asarray(tokens, jnp.int32),
                           jnp.zeros(1, jnp.int32), jcfg, jnp.float32)
    finally:
        jmm.set_backend("xla")
    got = forward(w, KVCache.create(cfg, 1, 64), torch.from_numpy(tokens), torch.tensor([0]),
                  cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_synth_qwen2_runner_and_engines_agree(tmp_path, monkeypatch):
    """The tiny qwen2 file (7 q heads a kv head, biases, layer 1 unfused):
    the dense and the paged engine's greedy tokens are the Runner's, on the
    CPU."""
    path = _build(tmp_path, monkeypatch, "tiny-qwen2", mix="k_m")
    prompt = "the qwen cat sat"
    r = Runner(path, compute_dtype=torch.float32, device="cpu")
    lws = r.weights["layers"]
    assert "wqkv" in lws[0] and "wq" in lws[1] and "bqkv" in lws[1]  # layer 1's attn_v: Q6_K
    want = "".join(r.prefill_and_generate(prompt, 12))
    assert ServingEngine(r, n_slots=2).generate([prompt], max_tokens=12) == [want]
    eng = PagedServingEngine(r, n_slots=2, n_pages=16)
    got = eng.generate([prompt], max_tokens=12)
    assert got[0] == want


def test_llama3_divisors_follow_the_converter_rule():
    """Llama-3.1-8B's rope_scaling (factor 8, low / high frequency factors 1
    / 4, original context 8192) at its head dim 128 and theta 500000: 1 for
    wavelengths under 2048, 8 over 8192, a monotone blend between."""
    ff = synth_gguf.llama3_freq_factors(128, 500000.0, 8.0, 1.0, 4.0, 8192)
    inv = 1.0 / 500000.0 ** (np.arange(0, 128, 2) / 128)
    wavelen = 2 * np.pi / inv
    assert ff.shape == (64,) and ff.dtype == np.float32
    assert (ff[wavelen < 2048] == 1.0).all() and (ff[wavelen > 8192] == 8.0).all()
    mid = (wavelen >= 2048) & (wavelen <= 8192)
    assert mid.any() and (np.diff(ff) >= 0).all() and ((ff[mid] > 1) & (ff[mid] < 8)).all()

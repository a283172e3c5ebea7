"""Port parity for the W8 prefill planes: the planes bit for bit, the plain
version of qmm_w8 against the JAX Pallas kernel (interpret mode on the CPU),
the row routing, and the byte budget of augment_w8_weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.ops.pallas import gemm_quant as jgemm
from crabml_tpu.quant.codecs import quantize as jquantize
from crabml_tpu.quant.planar import to_planar as jto_planar
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.models.config import config_from_gguf
from crabml_tpu_torch.models.weights import augment_w8_weights, w8_plane_bytes
from crabml_tpu_torch.ops.cuda import gemm_quant
from crabml_tpu_torch.quant.qtensor import QTensor, to_kernel_layout, to_planar
from crabml_tpu_torch.runtime import runner as runner_mod
from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf


def _pair(m, k, seed, scales="f32"):
    """One Q4_K weight from the same bytes: (JAX kernel-layout QTensor with
    W8 planes, the port's)."""
    w = (np.random.default_rng(seed).standard_normal((m, k)) * 0.05).astype(np.float32)
    raw = jquantize(JGGMLType.Q4_K, w)
    jqt = jgemm.augment_w8(jgemm.repack(
        jto_planar(JGGMLType.Q4_K, raw, (m, k)), "bf16" if scales == "bf16" else np.float32))
    sdt = torch.bfloat16 if scales == "bf16" else torch.float32
    qt = gemm_quant.augment_w8(to_kernel_layout(to_planar(GGMLType.Q4_K, raw, (m, k)), sdt))
    return jqt, qt


def _jax_planes_untiled(jqt):
    """The JAX package's m-tiled W8 planes in the port's layout: w8 (m, kpad8)
    and dw (m, S8)."""
    w8, dw = np.asarray(jqt.planes["w8"]), np.asarray(jqt.planes["dw"])
    mt, kpad8, tm8 = w8.shape
    return (w8.transpose(0, 2, 1).reshape(mt * tm8, kpad8),
            dw.transpose(0, 3, 1, 2).reshape(mt * tm8, -1))


@pytest.mark.parametrize("m,k,scales", [(512, 1024, "f32"), (512, 1024, "bf16"),
                                         (256, 768, "f32"), (1024, 1280, "bf16")])
def test_w8_planes_equal_jax_bit_for_bit(m, k, scales):
    """int8 values and float32 scales are equal, not close: the scale is a
    true division by 127, the quantization a multiply by the reciprocal and a
    round half to even, on the exact float32 values of the kernel planes (the
    scale planes as stored, bfloat16 included). k = 768 and 1280 zero-pad to
    the next multiple of 512."""
    jqt, qt = _pair(m, k, seed=m + k, scales=scales)
    want8, wantd = _jax_planes_untiled(jqt)
    assert qt.planes["w8"].dtype == torch.int8 and qt.planes["dw"].dtype == torch.float32
    assert qt.planes["w8"].shape == (m, -(-k // 512) * 512)
    np.testing.assert_array_equal(qt.planes["w8"].numpy(), want8)
    np.testing.assert_array_equal(qt.planes["dw"].numpy(), wantd)


def test_augment_w8_leaves_ineligible_tensors_alone():
    """Rows off a multiple of 256, canonical planes, dense kinds and an
    already augmented tensor come back as they are."""
    raw = jquantize(JGGMLType.Q4_K, np.ones((128, 256), np.float32))
    canonical = to_planar(GGMLType.Q4_K, raw, (128, 256))
    small = to_kernel_layout(canonical)
    dense = QTensor(GGMLType.F32, (256, 256), {"w": torch.zeros(256, 256)})
    for qt in (canonical, small, dense):
        assert gemm_quant.augment_w8(qt) is qt
    _, done = _pair(256, 512, 0)
    assert gemm_quant.augment_w8(done) is done


@pytest.mark.parametrize("rows,k", [(256, 1024), (300, 768)])
def test_qmm_w8_plain_matches_pallas(rows, k):
    """Tolerance 1e-4 of max|out|, float32 out: the same int8 planes and the
    same bfloat16 rounding of x; the products are exact in float32 and the
    sums are taken in another order. 300 rows pad to 304 on the JAX side."""
    jqt, qt = _pair(512, k, seed=rows)
    x = np.random.default_rng(rows).standard_normal((rows, k)).astype(np.float32)
    want = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x), jqt, jnp.float32))
    got = gemm_quant.qmm_w8_plain(torch.from_numpy(x), qt.planes["w8"], qt.planes["dw"])
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    # the wrapper takes the plain version for a CPU tensor, and the router takes the wrapper
    np.testing.assert_array_equal(gemm_quant.qmm_w8(torch.from_numpy(x), qt).numpy(), got.numpy())
    np.testing.assert_array_equal(
        gemm_quant.qmatmul_quant(torch.from_numpy(x), qt).numpy(), got.numpy())


@pytest.mark.parametrize("rows", [16, 17, 248, 249])
@pytest.mark.parametrize("has_w8", [False, True], ids=["q4k_only", "w8_planes"])
def test_routing_picks_the_kernel_jax_picks(monkeypatch, rows, has_w8):
    """Rows pad up to a multiple of 8 before the test against W8_MIN_ROWS, so
    the W8 planes take over from 249 real rows; at most 16 rows quantize the
    activations; the rest dequantize Q4_K."""
    jqt, qt = _pair(256, 512, seed=1)
    if not has_w8:
        jqt = type(jqt)(jqt.kind, jqt.shape,
                        {n: p for n, p in jqt.planes.items() if n not in ("w8", "dw")})
        qt = QTensor(qt.kind, qt.shape,
                     {n: p for n, p in qt.planes.items() if n not in ("w8", "dw")})
    jcalled, called = [], []
    for name in ("_run", "_run_w4a8", "_run_w8"):
        orig = getattr(jgemm, name)
        monkeypatch.setattr(jgemm, name, lambda *a, _n=name, _o=orig, **k: (
            jcalled.append(_n), _o(*a, **k))[1])
    for name in ("qmm_q4k", "qmm_w4a8", "qmm_w8"):
        orig = getattr(gemm_quant, name)
        monkeypatch.setattr(gemm_quant, name, lambda *a, _n=name, _o=orig, **k: (
            called.append(_n), _o(*a, **k))[1])
    x = np.random.default_rng(rows).standard_normal((rows, 512)).astype(np.float32)
    want = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x), jqt, jnp.float32, act_quant=True))
    got = gemm_quant.qmatmul_quant(torch.from_numpy(x), qt).numpy()
    same = {"_run": "qmm_q4k", "_run_w4a8": "qmm_w4a8", "_run_w8": "qmm_w8"}
    assert [same[n] for n in jcalled] == called == [gemm_quant.route(rows, has_w8)]
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _random_kernel_qt(shape, seed):
    n = int(np.prod(shape))
    raw = np.frombuffer(np.random.default_rng(seed).bytes(n // 256 * 144), np.uint8).copy()
    blocks = raw.reshape(-1, 144)
    blocks[:, 0:4] = np.array([1e-3, 7.5e-3], np.float16).view(np.uint8)
    return to_kernel_layout(to_planar(GGMLType.Q4_K, blocks, shape))


def test_augment_w8_weights_budget():
    """The JAX side is tests/test_model.py::test_augment_w8_budget_partial:
    everything without a budget; with one, the largest tensor first and the
    rest left alone; with none to speak of, nothing. A tensor name counts with
    all its layers."""
    layers = [{"big": _random_kernel_qt((1024, 512), l), "small": _random_kernel_qt((256, 512), l),
               "norm": torch.ones(512)} for l in range(2)]
    w = {"layers": layers, "output": _random_kernel_qt((768, 512), 9), "token_embed": None}

    full = augment_w8_weights(w)
    assert all("w8" in lw[n].planes for lw in full["layers"] for n in ("big", "small"))
    assert "w8" in full["output"].planes
    assert "w8" not in layers[0]["big"].planes  # the input is not modified

    big = 2 * w8_plane_bytes(layers[0]["big"])
    assert w8_plane_bytes(layers[0]["big"]) == int(1024 * 512 * (1 + 4 / 512))
    part = augment_w8_weights(w, budget_bytes=big + 16)
    assert all("w8" in lw["big"].planes for lw in part["layers"])
    assert not any("w8" in lw["small"].planes for lw in part["layers"])
    assert "w8" not in part["output"].planes

    # a budget too small for the largest still takes a smaller one
    skip = augment_w8_weights(w, budget_bytes=w8_plane_bytes(w["output"]) + 16)
    assert "w8" in skip["output"].planes
    assert not any("w8" in lw[n].planes for lw in skip["layers"] for n in ("big", "small"))

    none = augment_w8_weights(w, budget_bytes=8)
    assert not any("w8" in lw[n].planes for lw in none["layers"] for n in ("big", "small"))
    assert "w8" not in none["output"].planes


def test_auto_w8_budget_is_off_on_the_cpu_and_for_small_files(tmp_path, monkeypatch):
    """On the CPU the default never attaches W8 planes, so every CPU number
    stays that of the exact Q4_K path; on a card a file under 1 GiB stays off
    too, a large one gets everything when it fits, a budget when only a part
    does, and nothing without headroom."""
    path = build_synth_gguf(str(tmp_path / "tiny.gguf"), "tiny")
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert runner_mod._auto_w8_budget(gf, cfg, 512, 2, cpu) is None
    r = runner_mod.Runner(path, compute_dtype=torch.float32, device="cpu")
    assert r.prefill_w8 is False
    assert not any("w8" in v.planes for v in r.weights["layers"][0].values()
                   if isinstance(v, QTensor))
    assert "load.w8_augment" not in r.metrics.times_ns

    class Props:
        total_memory = 80 << 30

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props)
    assert runner_mod._auto_w8_budget(gf, cfg, 512, 2, card) is None  # a small file
    monkeypatch.setattr(runner_mod.os.path, "getsize", lambda p: 4 << 30)
    assert runner_mod._auto_w8_budget(gf, cfg, 512, 2, card) == -1
    full = int(sum(t.n_elems for t in gf.tensor_infos
                   if len(t.dimensions) >= 2 and "token_embd" not in t.name) * 1.008)
    kv = 2 * cfg.n_layers * 512 * cfg.n_kv_heads * cfg.head_dim * 2
    Props.total_memory = (6 << 30) + kv + full - 1000  # 1000 bytes short of everything
    assert runner_mod._auto_w8_budget(gf, cfg, 512, 2, card) == full - 1000
    Props.total_memory = 6 << 30
    assert runner_mod._auto_w8_budget(gf, cfg, 512, 2, card) is None


def test_runner_prefill_w8_attaches_planes_and_times_them(tmp_path):
    """prefill_w8=True on the CPU: every eligible matmul and the lm_head gain
    planes, the embedding does not, the augmentation is timed, and a prompt of
    249 tokens or more prefills through them to the same first token."""
    path = build_synth_gguf(str(tmp_path / "tiny.gguf"), "tiny")
    r = runner_mod.Runner(path, compute_dtype=torch.float32, device="cpu", prefill_w8=True)
    assert r.prefill_w8 is True and r.metrics.times_ns["load.w8_augment"] > 0
    lw = r.weights["layers"][0]
    assert all("w8" in lw[n].planes for n in ("wqkv", "wo", "wgu", "ffn_down"))
    assert "w8" in r.weights["output"].planes and "w8" not in r.weights["token_embed"].planes
    off = runner_mod.Runner(path, compute_dtype=torch.float32, device="cpu", prefill_w8=False)
    prompt = "a" * 300  # byte tokens: 300 rows, one chunk
    assert len(r.tokenizer.encode(prompt, bos=True)) >= 249
    assert r.prefill(prompt)[2] == off.prefill(prompt)[2]

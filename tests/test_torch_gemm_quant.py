"""Port parity: the plain versions of the two CUDA matmuls against the JAX
Pallas kernels (interpret mode on the CPU), same Q4_K bytes, same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.ops.pallas import gemm_quant as jgemm
from crabml_tpu.quant.codecs import quantize as jquantize
from crabml_tpu.quant.planar import to_planar as jto_planar
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.ops.cuda import gemm_quant
from crabml_tpu_torch.quant.qtensor import to_kernel_layout, to_planar

M, K = 512, 1024


@pytest.fixture(scope="module")
def weight():
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((M, K)) * 0.05).astype(np.float32)
    raw = jquantize(JGGMLType.Q4_K, w)
    jqt = jgemm.repack(jto_planar(JGGMLType.Q4_K, raw, (M, K)))
    qt = to_kernel_layout(to_planar(GGMLType.Q4_K, raw, (M, K)))
    return jqt, qt


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_qmm_q4k_plain_matches_pallas(weight):
    """Tolerance 2e-5 of max|out|: both compute w = val*dsub + msub in
    float32 and sum in float32, in another order."""
    jqt, qt = weight
    x = np.random.default_rng(1).standard_normal((40, K)).astype(np.float32)
    want = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x), jqt, jnp.float32, act_quant=False))
    p = qt.planes
    got = gemm_quant.qmm_q4k_plain(torch.from_numpy(x), p["qs"], p["dsub"], p["msub"])
    assert _rel(got.numpy(), want) <= 2e-5
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(gemm_quant.qmm_q4k(torch.from_numpy(x), qt).numpy(), got.numpy())


@pytest.mark.parametrize("rows", [1, 3, 8, 16])
def test_qmm_w4a8_plain_matches_pallas(weight, rows):
    """Tolerance 1e-5 of max|out|: identical int8 activations and integer
    group dots; the TPU kernel's -128 centring and offset correction round
    differently in float32 than the direct dsub*dx*dot + msub*sx. Rows: one,
    the earlier 3, the 8-slot tick and the most the kernel takes."""
    jqt, qt = weight
    x = np.random.default_rng(2).standard_normal((rows, K)).astype(np.float32)
    want = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x), jqt, jnp.float32, act_quant=True))
    p = qt.planes
    got = gemm_quant.qmm_w4a8_plain(torch.from_numpy(x), p["qs"], p["dsub"], p["msub"])
    assert _rel(got.numpy(), want) <= 1e-5
    np.testing.assert_array_equal(gemm_quant.qmm_w4a8(torch.from_numpy(x), qt).numpy(), got.numpy())


@pytest.mark.parametrize("rows", [1, 16, 17])
def test_qmatmul_routes_by_rows(weight, monkeypatch, rows):
    """<= W4A8_MAX_ROWS rows take qmm_w4a8, more take qmm_q4k."""
    _, qt = weight
    called = []
    monkeypatch.setattr(gemm_quant, "qmm_w4a8", lambda x2, q, dt: called.append("w4a8") or
                        torch.zeros(x2.shape[0], q.m, dtype=dt))
    monkeypatch.setattr(gemm_quant, "qmm_q4k", lambda x2, q, dt: called.append("q4k") or
                        torch.zeros(x2.shape[0], q.m, dtype=dt))
    out = gemm_quant.qmatmul_quant(torch.zeros(1, rows, K, dtype=torch.bfloat16), qt)
    assert out.shape == (1, rows, M) and out.dtype == torch.bfloat16
    assert called == ["w4a8" if rows <= gemm_quant.W4A8_MAX_ROWS else "q4k"]


def _finite_bf16_as_f32() -> np.ndarray:
    """Every finite bfloat16 value (subnormals and both zeros included) as float32."""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    v = bits.view(np.float32)
    return v[np.isfinite(v)]


@pytest.mark.parametrize("nib", range(16))
def test_q4k_nibble_times_bf16_scale_is_exact_in_float32(nib):
    """For every finite bf16 dsub whose product stays finite, nib * dsub in
    float32 equals the float64 product: a 4-bit integer times an 8-bit
    significand has at most 12 significant bits, and bf16 shares float32's
    exponent range. So qmm_q4k_plain's multiply-then-add rounds once, as the
    card's single FFMA (nib * d + m) does. The card forms a high nibble as
    16 * nib and multiplies it by dsub / 16: that quotient and that product
    are exact too."""
    d = _finite_bf16_as_f32()
    exact = np.float64(nib) * d.astype(np.float64)
    keep = np.abs(exact) <= np.finfo(np.float32).max
    d, exact = d[keep], exact[keep]
    prod = (torch.full((d.size,), float(nib)) * torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(prod.astype(np.float64), exact)
    d16 = d * np.float32(0.0625)
    np.testing.assert_array_equal(d16.astype(np.float64), d.astype(np.float64) / 16)
    np.testing.assert_array_equal((np.float32(16 * nib) * d16).astype(np.float64), exact)

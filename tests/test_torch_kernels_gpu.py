"""The port's CUDA kernels against their plain versions on the card, at small
and ragged shapes. Marked `gpu`: each test skips without a CUDA card.

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""

import math

import numpy as np
import pytest
import torch

from crabml_tpu_torch.errors import UnsupportedError
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.ops.cuda import _build, gemm_quant
from crabml_tpu_torch.models.forward import q8_vec
from crabml_tpu_torch.ops.cuda.decode_attention import (decode_attention, decode_attention_fused,
                                                        decode_attention_plain)
from crabml_tpu_torch.ops.cuda.flash_attention import flash_attention, flash_attention_plain
from crabml_tpu_torch.ops.cuda.paged_decode_attention import (PAGE, paged_decode_attention,
                                                              paged_decode_attention_fused,
                                                              paged_decode_attention_plain)
from crabml_tpu_torch.quant.qtensor import QTensor, to_kernel_layout, to_planar
from crabml_tpu_torch.tools.synth_gguf import q4k_blocks

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    return torch.device("cuda")


def _weight(m, k, seed):
    blocks = q4k_blocks(np.random.default_rng(seed), m * k, 1.0 / math.sqrt(k))
    return to_kernel_layout(to_planar(GGMLType.Q4_K, blocks, (m, k), "cuda"), torch.bfloat16)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("rows,m,k", [(17, 384, 512), (100, 320, 1024), (513, 256, 256)])
def test_qmm_q4k_matches_plain(cuda, rows, m, k):
    """Tolerance 1e-4 of max|out|: the same bf16 dequant, float32 sums in
    another order. Ragged rows and a column count off the 128-wide tile."""
    qt = _weight(m, k, rows)
    x = torch.randn(rows, k, device=cuda).to(torch.bfloat16)
    before = _build.launches["qmm_q4k"]
    got = gemm_quant.qmm_q4k(x, qt)
    p = qt.planes
    want = gemm_quant.qmm_q4k_plain(x, p["qs"], p["dsub"], p["msub"])
    torch.cuda.synchronize()
    assert _build.launches["qmm_q4k"] == before + 1
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("rows,m,k", [(1, 300, 768), (3, 512, 256), (16, 256, 1024),
                                       (16, 128, 14336)])
def test_qmm_w4a8_matches_plain(cuda, rows, m, k):
    """Tolerance 1e-4 of max|out|: identical int8 activations and integer
    dots, float32 group sums in another order."""
    qt = _weight(m, k, rows)
    x = torch.randn(rows, k, device=cuda).to(torch.bfloat16)
    got = gemm_quant.qmm_w4a8(x, qt)
    p = qt.planes
    want = gemm_quant.qmm_w4a8_plain(x, p["qs"], p["dsub"], p["msub"])
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-4


def test_qmm_w4a8_agrees_over_seeds(cuda):
    """50 random 16-row activations: one int8 value that rounds otherwise in
    the kernel's quantizer than in the plain one moves the output by ~4e-4
    of max|out| at this width, above the 1e-4 of float32 sums in another
    order."""
    qt = _weight(256, 1024, 16)
    p = qt.planes
    g = torch.Generator(device=cuda)
    for seed in range(50):
        x = torch.randn(16, 1024, generator=g.manual_seed(seed), device=cuda).to(torch.bfloat16)
        got = gemm_quant.qmm_w4a8(x, qt)
        want = gemm_quant.qmm_w4a8_plain(x, p["qs"], p["dsub"], p["msub"])
        assert _rel(got, want) <= 1e-4, f"seed {seed}"


@pytest.mark.parametrize("name,rows", [("qmm_q4k", 100), ("qmm_w4a8", 3)])
def test_matmul_bf16_output_is_float32_rounded(cuda, name, rows):
    """The bfloat16 epilogue rounds the same float32 sums once: bit-exact
    against the float32 output cast to bfloat16."""
    qt = _weight(320, 1024, rows)
    x = torch.randn(rows, 1024, device=cuda).to(torch.bfloat16)
    kernel = getattr(gemm_quant, name)
    got = kernel(x, qt, torch.bfloat16)
    want = kernel(x, qt, torch.float32).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_quantize_activation_kernel_matches_plain(cuda):
    """The kernel's int8 activations equal the plain ones: one weight of all
    ones per group reads sum(xq) back through the min term."""
    k = 512
    x = torch.randn(2, k, device=cuda).to(torch.bfloat16)
    x[0, :32] = 0
    ones = torch.zeros(1, k // 2, dtype=torch.uint8, device=cuda)
    qt = QTensor(GGMLType.Q4_K, (1, k), {
        "qs": ones, "dsub": torch.zeros(1, k // 32, dtype=torch.bfloat16, device=cuda),
        "msub": torch.ones(1, k // 32, dtype=torch.bfloat16, device=cuda)})
    got = gemm_quant.qmm_w4a8(x, qt)[:, 0]
    _, _, sx = gemm_quant.quantize_activation(x)
    torch.testing.assert_close(got, sx.sum(-1), rtol=1e-6, atol=1e-6)


def _stack(E, m, k, seed, w8=False):
    """E random Q4_K weights as one stack (E, m, k), bf16 scales."""
    blocks = q4k_blocks(np.random.default_rng(seed), E * m * k, 1.0 / math.sqrt(k))
    qt = to_kernel_layout(to_planar(GGMLType.Q4_K, blocks, (E, m, k), "cuda"), torch.bfloat16)
    return gemm_quant.augment_w8(qt) if w8 else qt


def _offsets(counts):
    return torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32,
                        device="cuda")


@pytest.mark.parametrize("rows,m,k", [(256, 256, 512), (300, 768, 768), (513, 256, 1280),
                                       (1, 512, 1024)])
def test_qmm_w8_matches_plain(cuda, rows, m, k):
    """Tolerance 1e-4 of max|out|: the same int8 planes and bf16 x, exact
    products, float32 sums in another order. Ragged rows, a column count off
    the 128-wide tile (it must be a multiple of 256 to carry planes), and k
    = 768 and 1280, which zero-pad to the next multiple of 512."""
    qt = gemm_quant.augment_w8(_weight(m, k, rows))
    x = torch.randn(rows, k, device=cuda).to(torch.bfloat16)
    before = _build.launches["qmm_w8"]
    got = gemm_quant.qmm_w8(x, qt)
    want = gemm_quant.qmm_w8_plain(x, qt.planes["w8"], qt.planes["dw"])
    torch.cuda.synchronize()
    assert _build.launches["qmm_w8"] == before + 1
    assert _rel(got, want) <= 1e-4
    assert torch.equal(gemm_quant.qmm_w8(x, qt, torch.bfloat16), got.to(torch.bfloat16))


def test_w8_planes_on_the_card_equal_the_cpu_planes(cuda):
    """The planes are computed where the weights lie: the card's int8 values
    and scales equal the CPU's (true division for the scale, multiply by the
    reciprocal and round half to even for the values)."""
    blocks = q4k_blocks(np.random.default_rng(3), 512 * 1280, 0.03)
    on = {}
    for dev in ("cuda", "cpu"):
        qt = to_kernel_layout(to_planar(GGMLType.Q4_K, blocks, (512, 1280), dev), torch.bfloat16)
        on[dev] = gemm_quant.augment_w8(qt).planes
    assert torch.equal(on["cuda"]["w8"].cpu(), on["cpu"]["w8"])
    assert torch.equal(on["cuda"]["dw"].cpu(), on["cpu"]["dw"])


@pytest.mark.parametrize("w8", [False, True], ids=["q4k", "w8"])
@pytest.mark.parametrize("counts", [(13, 0, 40, 64), (0, 0, 130, 1), (65, 63, 0, 0), (300,)])
def test_grouped_matmuls_match_plain(cuda, w8, counts):
    """The grouped forms at segments that are empty, shorter than a tile, one
    row over a tile and exact tiles; the first and the last expert empty; one
    expert only. Tolerance 1e-4 of max|out| as for the dense forms. Every row
    is written (the output starts as NaN)."""
    E, m, k = len(counts), 256, 768
    qt = _stack(E, m, k, sum(counts), w8)
    xs = torch.randn(sum(counts), k, device=cuda).to(torch.bfloat16)
    off = _offsets(counts)
    name = "qmm_w8_grouped" if w8 else "qmm_q4k_grouped"
    before = _build.launches[name]
    got = getattr(gemm_quant, name)(xs, qt, off)
    p = qt.planes
    if w8:
        want = gemm_quant.qmm_w8_grouped_plain(xs, p["w8"], p["dw"], off)
    else:
        want = gemm_quant.qmm_q4k_grouped_plain(xs, p["qs"], p["dsub"], p["msub"], off)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4
    assert torch.equal(getattr(gemm_quant, name)(xs, qt, off, torch.bfloat16),
                       got.to(torch.bfloat16))


@pytest.mark.parametrize("rows", [1, 2, 8, 16])
def test_qmm_w4a8_per_row_planes_match_plain(cuda, rows):
    """Row b against plane[b] of a stack, the index read on the device: 1e-4
    of max|out| against the plain version, and equal to the one-plane kernel
    on that row and plane."""
    qt = _stack(4, 320, 1024, rows)
    x = torch.randn(rows, 1024, device=cuda).to(torch.bfloat16)
    plane = torch.randint(0, 4, (rows,), device=cuda, dtype=torch.int32)
    before = _build.launches["qmm_w4a8"]
    got = gemm_quant.qmm_w4a8(x, qt, plane=plane)
    p = qt.planes
    want = gemm_quant.qmm_w4a8_plain(x, p["qs"], p["dsub"], p["msub"], plane)
    torch.cuda.synchronize()
    assert _build.launches["qmm_w4a8"] == before + 1
    assert _rel(got, want) <= 1e-4
    for b, e in enumerate(plane.tolist()):
        one = QTensor(qt.kind, qt.shape[1:], {n: t[e] for n, t in p.items()})
        assert torch.equal(gemm_quant.qmm_w4a8(x[b:b + 1], one), got[b:b + 1])


def test_moe_ffn_on_the_card_matches_its_plain_version(cuda):
    """moe_ffn through the kernels (bf16, W8 planes attached) against
    moe_ffn_plain on the same card, at 1, 8, 40 and 300 rows: int8
    activations (<= 16 rows) and the W8 requantization (>= 64 rows) each move
    the result by about 1% of max|out|, bf16 rounding by less."""
    from crabml_tpu_torch.models.config import ModelConfig
    from crabml_tpu_torch.models.forward import moe_ffn, moe_ffn_plain

    E, D, HD = 4, 512, 768
    cfg = ModelConfig(architecture="llama", model_name="m", embedding_dim=D, hidden_dim=HD,
                      n_layers=1, n_heads=4, n_kv_heads=1, vocab_size=8, seq_len=8,
                      rms_norm_eps=1e-5, n_experts=E, n_experts_used=2)
    lw = {"ffn_gate_inp": torch.randn(E, D, device=cuda).to(torch.bfloat16),
          "wgu_exps": _stack(E, 2 * HD, D, 1, w8=True),
          "ffn_down_exps": _stack(E, D, HD, 2, w8=True)}
    for rows in (1, 8, 40, 300):
        x = torch.randn(rows, D, device=cuda).to(torch.bfloat16)
        got, want = moe_ffn(lw, x, cfg), moe_ffn_plain(lw, x, cfg)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (rows, D)
        assert _rel(got, want) <= 4e-2, rows
        assert torch.equal(got, moe_ffn(lw, x, cfg))  # deterministic


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,G", [(1, 4), (3, 4), (8, 1)])
def test_decode_attention_matches_plain(cuda, dtype, T, G):
    """Tolerance: float32 softmax on both sides; one rounding of the output
    to the cache dtype (2^-7 relative for bf16); for float32, 1e-4 covers
    the kernel's fast __expf and its other order of sums."""
    B, KV, S, hd = 2, 2, 256, 128
    q = torch.randn(B, T, KV * G, hd, device=cuda).to(dtype)
    k = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    v = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    pos = torch.tensor([37, 128], dtype=torch.int32, device=cuda)
    got = decode_attention(q, k, v, pos, 1 / math.sqrt(hd))
    want = decode_attention_plain(q, k, v, pos, 1 / math.sqrt(hd))
    torch.cuda.synchronize()
    assert _rel(got, want) <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,G,hd", [(100, 4, 128), (9, 1, 64), (130, 8, 128)])
def test_flash_attention_matches_plain(cuda, dtype, T, G, hd):
    """Same tolerance as decode; ragged T and per-sequence offsets."""
    B, KV, S = 2, 2, 384
    q = torch.randn(B, T, KV * G, hd, device=cuda).to(dtype)
    k = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    v = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    pos = torch.tensor([0, 37], dtype=torch.int32, device=cuda)
    got = flash_attention(q, k, v, pos, 1 / math.sqrt(hd))
    want = flash_attention_plain(q, k, v, pos, 1 / math.sqrt(hd))
    torch.cuda.synchronize()
    assert _rel(got, want) <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4)


def _decode_case(form: str, kv: str, T: int, G: int, seed: int, softcap=0.0, window=0,
                 pos=(0, 1, 127, 128, 300, 1000)):
    """One decode-attention form against its plain version on the card, at
    ragged prefixes. form: dense | dense_fused | paged | paged_fused; kv: bf16
    | f32 | int8 (q bf16). Returns (kernel out, plain out, count name)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    qdt = torch.float32 if kv == "f32" else torch.bfloat16
    B, KV, hd, n_slot_pages = len(pos), 2, 128, 9
    S = n_slot_pages * PAGE
    fused, paged = form.endswith("fused"), form.startswith("paged")

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    q = rand(B, T, KV * G, hd).to(qdt)
    posv = torch.tensor(pos, dtype=torch.int32, device=dev)
    n_rows = 64 * PAGE if paged else B * S  # pool of 64 pages, or the dense cache
    k, v = rand(n_rows // PAGE, KV, PAGE, hd), rand(n_rows // PAGE, KV, PAGE, hd)
    kn, vn = rand(B, KV, T, hd), rand(B, KV, T, hd)
    ks = vs = ksn = vsn = None
    if kv == "int8":
        (k, ks), (v, vs), (kn, ksn), (vn, vsn) = (q8_vec(a) for a in (k, v, kn, vn))
    else:
        k, v, kn, vn = (a.to(qdt) for a in (k, v, kn, vn))
    kw = dict(softcap=softcap, local_window=window)
    if paged:
        perm = torch.randperm(63, generator=torch.Generator().manual_seed(seed))[: B * n_slot_pages]
        table = (perm + 1).reshape(B, n_slot_pages).to(dev, torch.int32)
        for b, p in enumerate(pos):  # unused entries are 0, the scratch page
            table[b, -(-(p + T) // PAGE):] = 0
        if fused:
            got = paged_decode_attention_fused(q, k[None], v[None], table, 0, posv, 0.09, kn, vn,
                                               None if ks is None else ks[None],
                                               None if vs is None else vs[None], ksn, vsn, **kw)
            want = paged_decode_attention_plain(q, k, v, table, posv, 0.09, ks, vs, softcap,
                                                window, kn, vn, ksn, vsn)
            return got, want, "paged_decode_attention_fused"
        # the pool holds the step's tokens: write them through the table first
        at = posv.long()[:, None] + torch.arange(T, device=dev)[None]
        pg = table.long().gather(1, at // PAGE)
        for pool, new in ((k, kn), (v, vn), (ks, ksn), (vs, vsn)):
            if pool is not None:
                pool[pg, :, at % PAGE] = new.transpose(1, 2)
        got = paged_decode_attention(q, k, v, table, posv + T, 0.09, ks, vs, **kw)
        want = paged_decode_attention_plain(q, k, v, table, posv, 0.09, ks, vs, softcap, window)
        return got, want, "paged_decode_attention"
    dense = [None if a is None else a.reshape(B, S // PAGE, KV, PAGE, -1).transpose(1, 2)
             .reshape(B, KV, S, -1).contiguous() for a in (k, v, ks, vs)]
    k, v, ks, vs = dense
    if fused:
        got = decode_attention_fused(q, k[None], v[None], 0, posv, 0.09, kn, vn,
                                     None if ks is None else ks[None],
                                     None if vs is None else vs[None], ksn, vsn, **kw)
        want = decode_attention_plain(q, k, v, posv, 0.09, ks, vs, softcap, window,
                                      kn, vn, ksn, vsn)
        return got, want, "decode_attention_fused"
    at = posv.long()[:, None] + torch.arange(T, device=dev)[None]
    rows = torch.arange(B, device=dev)[:, None]
    for cache, new in ((k, kn), (v, vn), (ks, ksn), (vs, vsn)):
        if cache is not None:
            cache[rows, :, at] = new.transpose(1, 2)
    got = decode_attention(q, k, v, posv, 0.09, ks, vs, **kw)
    want = decode_attention_plain(q, k, v, posv, 0.09, ks, vs, softcap, window)
    return got, want, "decode_attention"


_FORMS = ["dense", "dense_fused", "paged", "paged_fused"]


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (50.0, 0), (0.0, 100), (30.0, 70)])
@pytest.mark.parametrize("T,G", [(1, 4), (4, 4), (8, 1)])
@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_match_plain(cuda, form, kv, T, G, softcap, window):
    """Every form of the decode kernel (dense / paged, the step's keys in the
    cache or in their own block), every stored type, softcap and window, at
    prefixes 0, 1, a page boundary and ~1,000 and a shuffled table. Tolerance
    as above: 2^-7 of max|out| for a bfloat16 output (one rounding), 1e-4 for
    float32 (fast exp, another order of sums). The int8 payload dequantizes
    exactly on both sides."""
    before = dict(_build.launches)
    got, want, count = _decode_case(form, kv, T, G, seed=T * 10 + G, softcap=softcap,
                                    window=window)
    torch.cuda.synchronize()
    assert _build.launches[count] == before.get(count, 0) + 1
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= (1e-4 if kv == "f32" else 2.0 ** -7)


@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_agree_over_seeds(cuda, form):
    """20 seeds of the int8 form with T = 4 and a window of 200."""
    for seed in range(20):
        got, want, _ = _decode_case(form, "int8", 4, 4, seed, window=200,
                                    pos=(0, 5, 255, 256, 777, 1100))
        assert _rel(got, want) <= 2.0 ** -7, f"seed {seed}"


def test_paged_length_zero_rows_give_zero(cuda):
    """A sequence of length 0 (an idle slot) reads no page and writes 0."""
    q = torch.randn(2, 1, 8, 128, device=cuda).to(torch.bfloat16)
    pool = torch.full((4, 2, PAGE, 128), float("nan"), device=cuda, dtype=torch.bfloat16)
    pool[1] = 1.0
    table = torch.tensor([[0, 0], [1, 0]], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([0, 3], dtype=torch.int32, device=cuda)
    out = paged_decode_attention(q, pool, pool, table, lengths, 0.09)
    torch.cuda.synchronize()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(out[1].float(), torch.ones_like(out[1]).float())


def test_wrappers_raise_rather_than_fall_back(cuda):
    qt = _weight(256, 256, 1)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_q4k(torch.zeros(32, 256, device=cuda), qt)  # float32 x
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_w4a8(torch.zeros(17, 256, device=cuda, dtype=torch.bfloat16), qt)
    x = torch.zeros(32, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_w8(x, qt)  # no W8 planes
    stack = _stack(2, 256, 256, 1)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_q4k(x, stack)  # a stack where one plane is expected
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_q4k_grouped(x, qt, _offsets((32,)))  # one plane where a stack is
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_q4k_grouped(x, stack, _offsets((16, 16)).long())  # int64 offsets
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_w4a8(x[:2], stack, plane=torch.zeros(2, dtype=torch.int64, device=cuda))
    q = torch.zeros(1, 1, 4, 64, device=cuda)
    kv = torch.zeros(1, 2, 128, 64, device=cuda)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(UnsupportedError):
        decode_attention(q, kv, kv, pos, 0.125)  # head dim 64
    q, kv = torch.zeros(1, 1, 4, 128, device=cuda), torch.zeros(1, 2, 128, 128, device=cuda)
    with pytest.raises(UnsupportedError):
        flash_attention(q, kv, kv, pos, 0.125, softcap=30.0)
    with pytest.raises(UnsupportedError):
        flash_attention(q, kv, kv, pos, 0.125, window=64)
    with pytest.raises(UnsupportedError):
        decode_attention(q, kv.to(torch.int8), kv.to(torch.int8), pos, 0.125)  # no scales
    with pytest.raises(UnsupportedError):
        decode_attention(q, kv.to(torch.bfloat16), kv.to(torch.bfloat16), pos, 0.125)  # mixed
    with pytest.raises(UnsupportedError):
        decode_attention(q.to(torch.int8), kv.to(torch.int8), kv.to(torch.int8), pos, 0.125)
    table = torch.zeros(1, 1, dtype=torch.int64, device=cuda)
    with pytest.raises(UnsupportedError):
        paged_decode_attention(q, kv, kv, table, pos + 1, 0.125)  # int64 table
    with pytest.raises(UnsupportedError):  # pages of 64 rows
        paged_decode_attention(q, kv[:, :, :64], kv[:, :, :64], table.int(), pos + 1, 0.125)

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
from crabml_tpu_torch.quant.qtensor import (FORM_KIND, QTensor, dequantize, plane_of,
                                             to_kernel_layout, to_planar)
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


@pytest.mark.parametrize("rows,m,k", [(17, 384, 512), (100, 320, 1024), (513, 256, 256),
                                       (256, 256, 512), (300, 768, 768), (513, 256, 1280),
                                       (1, 512, 1024), (7, 256, 256), (13, 256, 768),
                                       (64, 256, 1024), (189, 512, 1536), (512, 768, 512),
                                       (1000, 256, 2048), (37, 320, 512), (130, 200, 1024),
                                       (17, 384, 14336), (189, 256, 14336)])
def test_qmm_q4k_matches_plain(cuda, rows, m, k):
    """Tolerance 1e-4 of max|out|: the same bf16 dequant, float32 sums in
    another order. Rows from 1 to 1,000 (every width of the tile loop, ragged
    last tiles), column counts off the 128-wide tile (320, 384) and off the
    8-wide store (200), k from one superblock (256) to 14,336. The bf16
    output is the float32 output rounded once, bit for bit."""
    qt = _weight(m, k, rows)
    x = torch.randn(rows, k, device=cuda).to(torch.bfloat16)
    before = _build.launches["qmm_q4k"]
    got = gemm_quant.qmm_q4k(x, qt)
    p = qt.planes
    want = gemm_quant.qmm_q4k_plain(x, p["qs"], p["dsub"], p["msub"])
    torch.cuda.synchronize()
    assert _build.launches["qmm_q4k"] == before + 1
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4
    assert torch.equal(gemm_quant.qmm_q4k(x, qt, torch.bfloat16), got.to(torch.bfloat16))


def test_qmm_q4k_converts_every_nibble_exactly(cuda):
    """Every nibble 0..15 in every byte of a 64-deep k step, in the low and
    the high half, with a dsub and an msub of their own per row and 32-group,
    one hot row of x at a time: the kernel's nibble-to-bfloat16 conversion,
    its fragment order and its choice of scale group return the plain
    version's bf16 weights exactly."""
    m, k = 256, 512
    n = torch.arange(m, device=cuda)[:, None]
    j = torch.arange(k // 2, device=cuda)[None, :]
    qs = ((n + j) % 16 | ((n + 3 * j + 5) % 16) << 4).to(torch.uint8)
    grp = torch.arange(k // 32, device=cuda)[None, :]
    dsub = (0.01 * (1 + (16 * n + grp) % 61 / 64)).to(torch.bfloat16)
    msub = (-0.05 * (1 + (3 * n + 5 * grp) % 53 / 64)).to(torch.bfloat16)
    # neighbouring groups (a step's low and high halves, one step and the next) differ
    assert (dsub[:, 1:] != dsub[:, :-1]).all() and (msub[:, 1:] != msub[:, :-1]).all()
    qt = QTensor(GGMLType.Q4_K, (m, k), {"qs": qs, "dsub": dsub, "msub": msub})
    w = dequantize(qt, torch.bfloat16)
    x = torch.eye(k, device=cuda, dtype=torch.bfloat16)  # x row i picks k = i
    got = gemm_quant.qmm_q4k(x, qt)
    want = gemm_quant.qmm_q4k_plain(x, qs, dsub, msub)
    torch.cuda.synchronize()
    assert torch.equal(want, w.t().float())
    assert torch.equal(got, want)


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


def _w8_weight(m, k, seed):
    """A Q4_K weight with W8 planes; m need not be a multiple of 256 (the
    planes are attached directly, past augment_w8's eligibility rule)."""
    qt = _weight(m, k, seed)
    planes = gemm_quant.w8_planes_from_weights(dequantize(qt))
    return QTensor(qt.kind, qt.shape, {**qt.planes, **planes})


@pytest.mark.parametrize("rows,m,k", [(256, 256, 512), (300, 768, 768), (513, 256, 1280),
                                       (1, 512, 1024), (7, 256, 512), (64, 256, 1024),
                                       (189, 512, 1536), (512, 768, 512), (1000, 256, 2048),
                                       (37, 320, 512), (130, 200, 1024)])
def test_qmm_w8_matches_plain(cuda, rows, m, k):
    """Tolerance 1e-4 of max|out|: the same int8 planes and bf16 x, exact
    products, float32 sums in another order. Rows from 1 to 1,000 (every
    width of the tile loop, ragged last tiles), column counts off the
    128-wide tile (320) and off the 8-wide store (200), and k = 768 and
    1280, which zero-pad to the next multiple of 512."""
    qt = _w8_weight(m, k, rows)
    x = torch.randn(rows, k, device=cuda).to(torch.bfloat16)
    before = _build.launches["qmm_w8"]
    got = gemm_quant.qmm_w8(x, qt)
    want = gemm_quant.qmm_w8_plain(x, qt.planes["w8"], qt.planes["dw"])
    torch.cuda.synchronize()
    assert _build.launches["qmm_w8"] == before + 1
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4
    assert torch.equal(gemm_quant.qmm_w8(x, qt, torch.bfloat16), got.to(torch.bfloat16))


def test_qmm_w8_converts_every_int8_exactly(cuda):
    """Each int8 value -127..127 in every position of a 64-deep k step, one
    hot row of x at a time: the kernel's byte-to-bfloat16 conversion and its
    fragment order return the plane itself."""
    m, k = 256, 512
    vals = (torch.arange(m * k, device=cuda) * 37 % 255 - 127).to(torch.int8).reshape(m, k)
    qt = QTensor(GGMLType.Q4_K, (m, k), {
        **_weight(m, k, 0).planes, "w8": vals,
        "dw": torch.ones(m, 1, dtype=torch.float32, device=cuda)})
    x = torch.eye(k, device=cuda, dtype=torch.bfloat16)[:128]  # x row i picks k = i
    got = gemm_quant.qmm_w8(x, qt)
    torch.cuda.synchronize()
    assert torch.equal(got, vals[:, :128].t().float())


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
@pytest.mark.parametrize("counts", [(13, 0, 40, 64), (0, 0, 130, 1), (65, 63, 0, 0), (300,),
                                    (1, 37, 0, 129), (0, 300, 0, 0), (128, 128, 8, 9)])
def test_grouped_matmuls_match_plain(cuda, w8, counts):
    """The grouped forms at segments that are empty, shorter than a tile, one
    row over a tile and exact tiles; the first and the last expert empty; one
    expert only; a 1-row and a 37-row segment; every row on one expert of
    four. Tolerance 1e-4 of max|out| as for the dense forms. Every row
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
    before = _build.launches["qmm_w4a8.planes"]
    got = gemm_quant.qmm_w4a8(x, qt, plane=plane)
    p = qt.planes
    want = gemm_quant.qmm_w4a8_plain(x, p["qs"], p["dsub"], p["msub"], plane)
    torch.cuda.synchronize()
    assert _build.launches["qmm_w4a8.planes"] == before + 1
    assert _rel(got, want) <= 1e-4
    for b, e in enumerate(plane.tolist()):
        one = QTensor(qt.kind, qt.shape[1:], {n: t[e] for n, t in p.items()})
        assert torch.equal(gemm_quant.qmm_w4a8(x[b:b + 1], one), got[b:b + 1])



def _w4a8_case(qt, x, plane=None):
    """qmm_w4a8 against its plain version (1e-4 of max|out|: identical int8
    activations and exact integer group dots, float32 group sums in another
    order); two calls bit for bit; the bf16 output the float32 one rounded
    once. Returns the float32 output."""
    p = qt.planes
    name = "qmm_w4a8" if plane is None else "qmm_w4a8.planes"  # the plane form counts apart
    before = _build.launches[name]
    got = gemm_quant.qmm_w4a8(x, qt, plane=plane)
    want = gemm_quant.qmm_w4a8_plain(x, p["qs"], p["dsub"], p["msub"], plane)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4
    assert torch.equal(gemm_quant.qmm_w4a8(x, qt, plane=plane), got)
    assert torch.equal(gemm_quant.qmm_w4a8(x, qt, torch.bfloat16, plane), got.to(torch.bfloat16))
    return got


@pytest.mark.parametrize("rows", range(1, 17))
def test_qmm_w4a8_every_row_count(cuda, rows):
    """Every row count the kernel takes (one n8 tile up to 8 rows, two from
    9), 300 columns (a ragged last 16-column tile) and k = 768 (three
    superblocks for four warps: one warp has none)."""
    _w4a8_case(_weight(300, 768, rows), torch.randn(rows, 768, device=cuda).to(torch.bfloat16))


@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("m,k", [(6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336),
                                 (32000, 4096)])
def test_qmm_w4a8_7b_shapes(cuda, rows, m, k):
    """The 7B decode projections (qkv, wo, gate|up, down, lm_head) at one
    row, the 8-slot tick's 8 and a 16-row tail."""
    _w4a8_case(_weight(m, k, rows + m), torch.randn(rows, k, device=cuda).to(torch.bfloat16))


@pytest.mark.parametrize("rows", [1, 9, 16])
def test_qmm_w4a8_ragged_columns_deep_k(cuda, rows):
    """m = 300 (not a multiple of 16) at k = 14,336: 14 superblocks a warp."""
    _w4a8_case(_weight(300, 14336, rows), torch.randn(rows, 14336, device=cuda).to(torch.bfloat16))


@pytest.mark.parametrize("rows,which", [(8, "repeated"), (8, "distinct"), (16, "mixed"),
                                        (3, "repeated")])
def test_qmm_w4a8_planes_repeated_and_distinct(cuda, rows, which):
    """The plane form with every row on one expert, each on its own, and a
    mix, at Mixtral's 8 experts with a ragged column count."""
    qt = _stack(8, 336, 1024, rows)
    plane = {"repeated": torch.full((rows,), 5), "distinct": torch.arange(rows) % 8,
             "mixed": torch.tensor([0, 7, 7, 1, 0, 3, 3, 3, 2, 6, 6, 4, 5, 0, 1, 7][:rows])}[which]
    plane = plane.to(device=cuda, dtype=torch.int32)
    got = _w4a8_case(qt, torch.randn(rows, 1024, device=cuda).to(torch.bfloat16), plane)
    if which == "repeated":  # one expert: the dense form of that plane, row by row
        one = QTensor(qt.kind, qt.shape[1:], {n: t[5] for n, t in qt.planes.items()})
        x = torch.randn(rows, 1024, device=cuda).to(torch.bfloat16)
        for b in range(rows):
            assert torch.equal(gemm_quant.qmm_w4a8(x[b:b + 1], one),
                               gemm_quant.qmm_w4a8(x, qt, plane=plane)[b:b + 1])
    assert got.shape == (rows, 336)


@pytest.mark.parametrize("planes", [False, True])
def test_qmm_w4a8_captures_in_a_cuda_graph(cuda, planes):
    """The quantizer and the matmul chained by programmatic dependent launch
    capture in a CUDA graph: a replay equals the eager call, and a replay
    after x changes in place equals the eager call on the new x."""
    rows, m, k = 8, 1024, 2048
    qt = _stack(4, m, k, 3) if planes else _weight(m, k, 3)
    plane = torch.tensor([0, 3, 3, 1, 2, 0, 1, 3], device=cuda, dtype=torch.int32) \
        if planes else None
    x = torch.randn(rows, k, device=cuda).to(torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture: build, shared-memory attribute
        gemm_quant.qmm_w4a8(x, qt, torch.bfloat16, plane)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gemm_quant.qmm_w4a8(x, qt, torch.bfloat16, plane)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, gemm_quant.qmm_w4a8(x, qt, torch.bfloat16, plane))
        x.copy_(torch.randn(rows, k, device=cuda).to(torch.bfloat16))

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
@pytest.mark.parametrize("T,G,hd,softcap,window", [
    (100, 4, 128, 0.0, 0), (9, 1, 64, 0.0, 0), (130, 8, 128, 0.0, 0),
    (100, 4, 128, 30.0, 0), (100, 4, 128, 0.0, 48), (130, 8, 128, 20.0, 70),
    (65, 4, 128, 0.0, 0), (129, 1, 64, 50.0, 100), (129, 1, 128, 0.0, 0),
    (193, 4, 64, 0.0, 150), (64, 8, 64, 0.0, 0), (257, 2, 128, 0.0, 31)])
def test_flash_attention_matches_plain(cuda, dtype, T, G, hd, softcap, window):
    """Same tolerance as decode: 2^-7 of max|out| for bfloat16 (one rounding
    of the output; the probabilities enter the second product as bfloat16,
    whose errors average out over a row's keys), 1e-4 for float32. Ragged T
    (1 mod 64), per-sequence offsets 0 and 37, head dims 64 and 128, 1 to 8
    q heads a kv head, the softcap, the sliding window (narrower and wider
    than a key tile) and both."""
    B, KV, S = 2, 2, 384
    q = torch.randn(B, T, KV * G, hd, device=cuda).to(dtype)
    k = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    v = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    pos = torch.tensor([0, 37], dtype=torch.int32, device=cuda)
    before = _build.launches["flash_attention"]
    got = flash_attention(q, k, v, pos, 1 / math.sqrt(hd), softcap, window)
    want = flash_attention_plain(q, k, v, pos, 1 / math.sqrt(hd), softcap, window)
    torch.cuda.synchronize()
    assert _build.launches["flash_attention"] == before + 1
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("window", [0, 200])
def test_flash_attention_ignores_rows_past_the_prefix(cuda, window):
    """Cache rows past pos + T hold NaN (never written): they are masked
    keys and must not reach the output. T = 189 at pos 512, the main path's
    second chunk, at the 7B's 32 / 8 heads."""
    B, T, KV, G, S, hd = 1, 189, 8, 4, 1024, 128
    q = torch.randn(B, T, KV * G, hd, device=cuda).to(torch.bfloat16)
    k = torch.randn(B, KV, S, hd, device=cuda).to(torch.bfloat16)
    v = torch.randn(B, KV, S, hd, device=cuda).to(torch.bfloat16)
    pos = torch.tensor([512], dtype=torch.int32, device=cuda)
    want = flash_attention_plain(q, k, v, pos, 0.09, 0.0, window)
    k[:, :, 512 + T:], v[:, :, 512 + T:] = float("nan"), float("nan")
    got = flash_attention(q, k, v, pos, 0.09, 0.0, window)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= 2.0 ** -7


# prefixes that cross the kernel's chunk edges (128 keys, a page) and the
# 16-key slices of its warps; every case adds the cache's last position
_POS = (0, 1, 31, 32, 127, 128, 129, 255, 256, 1000)


def _poison(cache, first, end):
    """NaN in every row of a float cache (B, KV, S, d) before first[b] and from
    end[b] on: rows the kernel must never read."""
    for b, (lo, hi) in enumerate(zip(first, end)):
        cache[b, :, :lo] = float("nan")
        cache[b, :, hi:] = float("nan")


def _poison_pool(pool, table, first, end):
    """NaN in every row of a pool (n_pages, KV, PAGE, d) that no sequence's
    keys first[b] <= j < end[b] map to through `table`: unused pages, page 0,
    and the rows of a used page outside the keys."""
    live = torch.zeros(pool.shape[0], PAGE, dtype=torch.bool)
    tab = table.cpu()
    for b, (lo, hi) in enumerate(zip(first, end)):
        j = torch.arange(lo, hi)
        live[tab[b, j // PAGE].long(), j % PAGE] = True
    pool[~live.to(pool.device)[:, None, :, None].expand(-1, pool.shape[1], -1, pool.shape[3])] = \
        float("nan")


def _decode_case(form: str, kv: str, T: int, G: int, seed: int, softcap=0.0, window=0,
                 pos=None, poison=False, hd=128, n_slot_pages=9, q_dtype=None):
    """One decode-attention form against its plain version on the card, at
    ragged prefixes (_POS and the cache's last position unless `pos` is
    given). form: dense | dense_fused | paged | paged_fused; kv: bf16 | f32 |
    int8; q in `q_dtype` (default: float32 over an f32 cache, else
    bfloat16). With `poison`, every cache row or pool row past the live
    keys (and before the window of a sequence's first row) is set to NaN
    after the plain version ran (for int8: its scales). A sequence holds at
    most `n_slot_pages` pages of keys. Returns (kernel out, plain out, count
    name)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    qdt = q_dtype or (torch.float32 if kv == "f32" else torch.bfloat16)
    kdt = torch.float32 if kv == "f32" else torch.bfloat16  # a float cache's dtype
    KV = 2
    S = n_slot_pages * PAGE
    pos = tuple(pos or (*_POS, S - T))
    B = len(pos)
    fused, paged = form.endswith("fused"), form.startswith("paged")

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    q = rand(B, T, KV * G, hd).to(qdt)
    posv = torch.tensor(pos, dtype=torch.int32, device=dev)
    n_pool = max(128, B * n_slot_pages + 1)  # pool pages: room for every slot's
    n_rows = n_pool * PAGE if paged else B * S  # pool, or the dense cache
    k, v = rand(n_rows // PAGE, KV, PAGE, hd), rand(n_rows // PAGE, KV, PAGE, hd)
    kn, vn = rand(B, KV, T, hd), rand(B, KV, T, hd)
    ks = vs = ksn = vsn = None
    if kv == "int8":
        (k, ks), (v, vs), (kn, ksn), (vn, vsn) = (q8_vec(a) for a in (k, v, kn, vn))
    else:
        k, v, kn, vn = (a.to(kdt) for a in (k, v, kn, vn))
    kw = dict(softcap=softcap, local_window=window)
    # the cache's live rows: from the first row's window start to the keys it holds
    first = [max(p + 1 - window, 0) if window else 0 for p in pos]
    end = [p if fused else p + T for p in pos]
    floats = (ks, vs) if kv == "int8" else (k, v)
    if paged:
        perm = torch.randperm(n_pool - 1, generator=torch.Generator().manual_seed(seed))
        table = (perm[: B * n_slot_pages] + 1).reshape(B, n_slot_pages).to(dev, torch.int32)
        for b, p in enumerate(pos):  # unused entries are 0, the scratch page
            table[b, -(-(p + T) // PAGE):] = 0
        if fused:
            want = paged_decode_attention_plain(q, k, v, table, posv, 0.09, ks, vs, softcap,
                                                window, kn, vn, ksn, vsn)
            for a in floats if poison else ():
                _poison_pool(a, table, first, end)
            got = paged_decode_attention_fused(q, k[None], v[None], table, 0, posv, 0.09, kn, vn,
                                               None if ks is None else ks[None],
                                               None if vs is None else vs[None], ksn, vsn, **kw)
            return got, want, "paged_decode_attention_fused"
        # the pool holds the step's tokens: write them through the table first
        at = posv.long()[:, None] + torch.arange(T, device=dev)[None]
        pg = table.long().gather(1, at // PAGE)
        for pool, new in ((k, kn), (v, vn), (ks, ksn), (vs, vsn)):
            if pool is not None:
                pool[pg, :, at % PAGE] = new.transpose(1, 2)
        want = paged_decode_attention_plain(q, k, v, table, posv, 0.09, ks, vs, softcap, window)
        for a in floats if poison else ():
            _poison_pool(a, table, first, end)
        got = paged_decode_attention(q, k, v, table, posv + T, 0.09, ks, vs, **kw)
        return got, want, "paged_decode_attention"
    dense = [None if a is None else a.reshape(B, S // PAGE, KV, PAGE, -1).transpose(1, 2)
             .reshape(B, KV, S, -1).contiguous() for a in (k, v, ks, vs)]
    k, v, ks, vs = dense
    floats = (ks, vs) if kv == "int8" else (k, v)
    if fused:
        want = decode_attention_plain(q, k, v, posv, 0.09, ks, vs, softcap, window,
                                      kn, vn, ksn, vsn)
        for a in floats if poison else ():
            _poison(a, first, end)
        got = decode_attention_fused(q, k[None], v[None], 0, posv, 0.09, kn, vn,
                                     None if ks is None else ks[None],
                                     None if vs is None else vs[None], ksn, vsn, **kw)
        return got, want, "decode_attention_fused"
    at = posv.long()[:, None] + torch.arange(T, device=dev)[None]
    rows = torch.arange(B, device=dev)[:, None]
    for cache, new in ((k, kn), (v, vn), (ks, ksn), (vs, vsn)):
        if cache is not None:
            cache[rows, :, at] = new.transpose(1, 2)
    want = decode_attention_plain(q, k, v, posv, 0.09, ks, vs, softcap, window)
    for a in floats if poison else ():
        _poison(a, first, end)
    got = decode_attention(q, k, v, posv, 0.09, ks, vs, **kw)
    return got, want, "decode_attention"


_FORMS = ["dense", "dense_fused", "paged", "paged_fused"]


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (50.0, 0), (0.0, 100), (30.0, 70)])
@pytest.mark.parametrize("T,G", [(1, 4), (4, 4), (8, 1)])
@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_match_plain(cuda, form, kv, T, G, softcap, window):
    """Every form of the decode kernel (dense / paged, the step's keys in the
    cache or in their own block), every stored type, softcap and window, at
    prefixes on both sides of every chunk edge, ~1,000 and the cache's last
    position, and a shuffled table. Tolerance: 2^-7 of max|out| for a bfloat16
    output (one rounding of the output; the probabilities enter the second
    product as bfloat16), 1e-4 for float32 (fast exp, another order of sums).
    The int8 payload dequantizes exactly on both sides."""
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


@pytest.mark.parametrize("window", [0, 200])
@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_ignore_rows_past_the_keys(cuda, form, kv, window):
    """NaN in every cache row or pool row that no row may see: past the live
    keys (for the fused forms, from the step's position on, since the step's
    keys come from their own block), before the window of a sequence's first
    row (window 200 starts inside a chunk for most prefixes), unused pages
    and the scratch page; for int8 in the scales. None reaches the output.
    Tolerances as above."""
    got, want, _ = _decode_case(form, kv, 4, 4, seed=5, window=window, poison=True)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= (1e-4 if kv == "f32" else 2.0 ** -7)


@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_are_deterministic(cuda, form):
    """Two calls on the same inputs give the same bits: the chunks of a
    sequence merge in a fixed order, whichever block arrives last."""
    one, _, _ = _decode_case(form, "bf16", 4, 4, seed=9, window=0)
    two, _, _ = _decode_case(form, "bf16", 4, 4, seed=9, window=0)
    torch.cuda.synchronize()
    assert torch.equal(one, two)


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


def test_dense_zero_key_rows_give_zero(cuda):
    """The dense form with no key before or at a row (pos = -T) reads no row
    and writes 0; the other sequence of the batch is unaffected."""
    q = torch.randn(2, 1, 8, 128, device=cuda).to(torch.bfloat16)
    cache = torch.full((2, 2, 256, 128), float("nan"), device=cuda, dtype=torch.bfloat16)
    cache[1, :, :3] = 1.0
    pos = torch.tensor([-1, 2], dtype=torch.int32, device=cuda)
    out = decode_attention(q, cache, cache, pos, 0.09)
    torch.cuda.synchronize()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(out[1].float(), torch.ones_like(out[1]).float())


def test_wrappers_raise_rather_than_fall_back(cuda):
    qt = _weight(256, 256, 1)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_q4k(torch.zeros(32, 256, device=cuda), qt)  # float32 x, bf16 scales
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
        flash_attention(q, kv, kv, pos, 0.125, window=-1)
    with pytest.raises(UnsupportedError):
        flash_attention(q, kv.to(torch.bfloat16), kv.to(torch.bfloat16), pos, 0.125)  # mixed
    with pytest.raises(UnsupportedError):  # 65 q heads a kv head: more than a block's 64 rows
        flash_attention(torch.zeros(1, 1, 130, 128, device=cuda), kv, kv, pos, 0.125)
    for hd in (12, 264):  # not a multiple of 8; past 256
        with pytest.raises(UnsupportedError):
            flash_attention(torch.zeros(1, 1, 4, hd, device=cuda),
                            torch.zeros(1, 2, 128, hd, device=cuda),
                            torch.zeros(1, 2, 128, hd, device=cuda), pos, 0.125)
    with pytest.raises(UnsupportedError):
        decode_attention(q, kv.to(torch.int8), kv.to(torch.int8), pos, 0.125)  # no scales
    with pytest.raises(UnsupportedError):
        decode_attention(q, kv.half(), kv.half(), pos, 0.125)  # a float16 cache
    with pytest.raises(UnsupportedError):
        decode_attention(q, kv, kv.to(torch.bfloat16), pos, 0.125)  # k and v of two dtypes
    with pytest.raises(UnsupportedError):
        decode_attention(q.to(torch.int8), kv.to(torch.int8), kv.to(torch.int8), pos, 0.125)
    table = torch.zeros(1, 1, dtype=torch.int64, device=cuda)
    with pytest.raises(UnsupportedError):
        paged_decode_attention(q, kv, kv, table, pos + 1, 0.125)  # int64 table
    with pytest.raises(UnsupportedError):  # pages of 64 rows
        paged_decode_attention(q, kv[:, :, :64], kv[:, :, :64], table.int(), pos + 1, 0.125)


# -- head dim 256 (gemma2) ----------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,G,pos0,softcap,window", [
    (100, 2, 0, 0.0, 0), (189, 2, 37, 50.0, 0), (512, 2, 0, 50.0, 200), (129, 1, 300, 0.0, 64),
    (65, 4, 5, 30.0, 0), (257, 8, 100, 50.0, 31), (9, 2, 383, 50.0, 300)])
def test_flash_attention_hd256_matches_plain(cuda, dtype, T, G, pos0, softcap, window):
    """Head dim 256: the bfloat16 kernel's two-stage ring (a 32 KB tile a
    stage) and its 128 output accumulators a thread, the float32 kernel's
    wider tiles. Ragged T, offsets inside and at the edge of a key tile, 1 to
    8 q heads a kv head, Gemma-2's softcap 50 and windows that skip key tiles
    (200 and 64 keys behind rows 300 and more). Tolerances as at 128."""
    B, KV, S, hd = 2, 2, 1024, 256
    q = torch.randn(B, T, KV * G, hd, device=cuda).to(dtype)
    k = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    v = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    pos = torch.tensor([pos0, pos0 // 2], dtype=torch.int32, device=cuda)
    before = _build.launches["flash_attention"]
    got = flash_attention(q, k, v, pos, 1 / 16, softcap, window)
    want = flash_attention_plain(q, k, v, pos, 1 / 16, softcap, window)
    torch.cuda.synchronize()
    assert _build.launches["flash_attention"] == before + 1
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4)
    assert torch.equal(got, flash_attention(q, k, v, pos, 1 / 16, softcap, window))


@pytest.mark.parametrize("window", [0, 4096, 200])
def test_flash_attention_hd256_ignores_rows_past_the_prefix(cuda, window):
    """Gemma-2-9B's 16 / 8 heads at head dim 256: a 512-token chunk at pos
    4,096 (the window of 4,096 drops the first tiles of every row), rows past
    pos + T and before the first row's window NaN."""
    B, T, KV, G, S, hd, p0 = 1, 512, 8, 2, 4608, 256, 4096
    q = torch.randn(B, T, KV * G, hd, device=cuda).to(torch.bfloat16)
    k = torch.randn(B, KV, S, hd, device=cuda).to(torch.bfloat16)
    v = torch.randn(B, KV, S, hd, device=cuda).to(torch.bfloat16)
    pos = torch.tensor([p0], dtype=torch.int32, device=cuda)
    want = flash_attention_plain(q, k, v, pos, 1 / 16, 50.0, window)
    k[:, :, p0 + T:], v[:, :, p0 + T:] = float("nan"), float("nan")
    if window:
        k[:, :, :p0 + 1 - window], v[:, :, :p0 + 1 - window] = float("nan"), float("nan")
    got = flash_attention(q, k, v, pos, 1 / 16, 50.0, window)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= 2.0 ** -7


_POS_256 = (0, 1, 127, 128, 129, 4095, 4096, 4097)


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (50.0, 0), (0.0, 4096), (50.0, 100)])
@pytest.mark.parametrize("T,G", [(1, 2), (4, 2), (8, 2), (2, 8)])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_hd256_match_plain(cuda, form, kv, T, G, softcap, window):
    """Every decode form at head dim 256 (each warp 32 output dims, partials
    twice as wide), bfloat16 and int8 caches, prefixes on both sides of a
    chunk edge and of Gemma-2's 4,096-key window, and the cache's last
    position (33 pages a sequence); every row no query may see is NaN.
    Tolerances as at 128."""
    before = dict(_build.launches)
    got, want, count = _decode_case(form, kv, T, G, seed=T * 10 + G + 7, softcap=softcap,
                                    window=window, pos=(*_POS_256, 33 * PAGE - T), poison=True,
                                    hd=256, n_slot_pages=33)
    torch.cuda.synchronize()
    assert _build.launches[count] == before.get(count, 0) + 1
    assert got.shape[-1] == (2 * G) * 256
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= 2.0 ** -7


@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_hd256_are_deterministic(cuda, form):
    """Two calls at head dim 256 give the same bits (the chunks merge in
    chunk order, whichever block arrives last)."""
    one, _, _ = _decode_case(form, "int8", 4, 2, seed=3, window=100, hd=256,
                             pos=(0, 129, 700, 1000))
    two, _, _ = _decode_case(form, "int8", 4, 2, seed=3, window=100, hd=256,
                             pos=(0, 129, 700, 1000))
    torch.cuda.synchronize()
    assert torch.equal(one, two)


# -- head dims 96 and 80 (phi3, phi2) ------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [96, 80])
@pytest.mark.parametrize("T,G,pos0,softcap,window", [
    (100, 1, 0, 0.0, 0), (189, 1, 512, 0.0, 0), (512, 1, 0, 50.0, 200), (129, 2, 300, 0.0, 64),
    (65, 4, 5, 30.0, 0), (257, 7, 100, 0.0, 31), (9, 2, 383, 50.0, 300)])
def test_flash_attention_hd96_matches_plain(cuda, dtype, hd, T, G, pos0, softcap, window):
    """Head dims 96 and 80 on the 128 kernel's tiles (a tile row 128 wide in
    shared memory, HD / 16 k steps for the scores, V's padding lanes never
    stored), and the float32 kernel at its own width: ragged T, Phi-3's 189
    tokens at pos 512, 1 to 7 q heads a kv head, softcaps and windows that
    skip key tiles. Tolerances as at 128; two calls give the same bits."""
    B, KV, S = 2, 2, 1024
    q = torch.randn(B, T, KV * G, hd, device=cuda).to(dtype)
    k = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    v = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    pos = torch.tensor([pos0, pos0 // 2], dtype=torch.int32, device=cuda)
    before = _build.launches["flash_attention"]
    got = flash_attention(q, k, v, pos, hd ** -0.5, softcap, window)
    want = flash_attention_plain(q, k, v, pos, hd ** -0.5, softcap, window)
    torch.cuda.synchronize()
    assert _build.launches["flash_attention"] == before + 1
    assert got.shape == (B, T, KV * G * hd)
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4)
    assert torch.equal(got, flash_attention(q, k, v, pos, hd ** -0.5, softcap, window))


@pytest.mark.parametrize("hd", [96, 80])
@pytest.mark.parametrize("window", [0, 200])
def test_flash_attention_hd96_ignores_rows_past_the_prefix(cuda, hd, window):
    """Phi-3-mini's 32 / 32 heads: the 189-token chunk at pos 512, cache rows
    past pos + T and before the first row's window NaN. A store past a
    head's hd lanes would land on the next head's first lanes."""
    B, T, KV, G, S, p0 = 1, 189, 32, 1, 1024, 512
    q = torch.randn(B, T, KV * G, hd, device=cuda).to(torch.bfloat16)
    k = torch.randn(B, KV, S, hd, device=cuda).to(torch.bfloat16)
    v = torch.randn(B, KV, S, hd, device=cuda).to(torch.bfloat16)
    pos = torch.tensor([p0], dtype=torch.int32, device=cuda)
    want = flash_attention_plain(q, k, v, pos, hd ** -0.5, 0.0, window)
    k[:, :, p0 + T:], v[:, :, p0 + T:] = float("nan"), float("nan")
    if window:
        k[:, :, :p0 + 1 - window], v[:, :, :p0 + 1 - window] = float("nan"), float("nan")
    got = flash_attention(q, k, v, pos, hd ** -0.5, 0.0, window)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= 2.0 ** -7


@pytest.mark.parametrize("hd", [96, 80])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (50.0, 0), (0.0, 100), (30.0, 70)])
@pytest.mark.parametrize("T,G", [(1, 1), (4, 2), (8, 1), (2, 7)])
@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_hd96_match_plain(cuda, form, kv, T, G, softcap, window, hd):
    """Every decode form at head dims 96 and 80 (the 128 kernel's tiles,
    partials at the true width), every stored type, the softcap and the
    window, at prefixes on both sides of every chunk edge, ~1,000 and the
    cache's last position; every row no query may see is NaN. Tolerances as
    at 128."""
    before = dict(_build.launches)
    got, want, count = _decode_case(form, kv, T, G, seed=T * 10 + G + hd, softcap=softcap,
                                    window=window, poison=True, hd=hd)
    torch.cuda.synchronize()
    assert _build.launches[count] == before.get(count, 0) + 1
    assert got.shape[-1] == (2 * G) * hd
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= (1e-4 if kv == "f32" else 2.0 ** -7)


@pytest.mark.parametrize("hd", [96, 80])
@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_hd96_are_deterministic(cuda, form, hd):
    """Two calls at head dims 96 and 80 give the same bits."""
    one, _, _ = _decode_case(form, "int8", 4, 2, seed=3, window=100, hd=hd,
                             pos=(0, 129, 700, 1000))
    two, _, _ = _decode_case(form, "int8", 4, 2, seed=3, window=100, hd=hd,
                             pos=(0, 129, 700, 1000))
    torch.cuda.synchronize()
    assert torch.equal(one, two)


@pytest.mark.parametrize("hd", [96, 80])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_hd96_replay_in_a_cuda_graph(cuda, form, kv, hd):
    """The graph replays at head dims 96 and 80, one q head a kv head (Phi-3,
    Phi-2), bit for bit the eager call's output."""
    _replay_case(cuda, form, kv, hd, 1)


# -- any count of q heads a kv head up to 64 (qwen2: 7) ------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G,T,pos0,softcap,window", [
    (3, 100, 0, 0.0, 0), (5, 189, 37, 50.0, 0), (6, 129, 300, 0.0, 64), (7, 512, 0, 30.0, 200),
    (7, 189, 512, 0.0, 0), (12, 65, 5, 50.0, 31)])
def test_flash_attention_any_group_matches_plain(cuda, dtype, hd, G, T, pos0, softcap, window):
    """G q heads a kv head that do not divide a warpgroup's 64 rows: 64 // G
    tokens of G heads and 64 % G padding rows (G = 7: 9 tokens, one padding
    row; 12: 5 tokens, four). Ragged T, offsets inside and at the edge of a
    key tile, softcaps and windows that skip key tiles, head dims 64, 128 and
    256. Tolerances as above; a second call gives the same bits."""
    B, KV, S = 2, 2, 1024
    q = torch.randn(B, T, KV * G, hd, device=cuda).to(dtype)
    k = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    v = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    pos = torch.tensor([pos0, pos0 // 2], dtype=torch.int32, device=cuda)
    scale = 1 / math.sqrt(hd)
    before = _build.launches["flash_attention"]
    got = flash_attention(q, k, v, pos, scale, softcap, window)
    want = flash_attention_plain(q, k, v, pos, scale, softcap, window)
    torch.cuda.synchronize()
    assert _build.launches["flash_attention"] == before + 1
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4)
    assert torch.equal(got, flash_attention(q, k, v, pos, scale, softcap, window))


@pytest.mark.parametrize("window", [0, 200])
def test_flash_attention_g7_ignores_rows_past_the_prefix(cuda, window):
    """Qwen2-7B's 28 / 4 heads: a 189-token chunk at pos 512, every cache row
    past pos + T NaN. Neither they nor the padding rows reach the output."""
    B, T, KV, G, S, hd = 1, 189, 4, 7, 1024, 128
    q = torch.randn(B, T, KV * G, hd, device=cuda).to(torch.bfloat16)
    k = torch.randn(B, KV, S, hd, device=cuda).to(torch.bfloat16)
    v = torch.randn(B, KV, S, hd, device=cuda).to(torch.bfloat16)
    pos = torch.tensor([512], dtype=torch.int32, device=cuda)
    want = flash_attention_plain(q, k, v, pos, 0.09, 0.0, window)
    k[:, :, 512 + T:], v[:, :, 512 + T:] = float("nan"), float("nan")
    got = flash_attention(q, k, v, pos, 0.09, 0.0, window)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= 2.0 ** -7


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 70)])
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_g7_match_plain(cuda, form, kv, T, softcap, window):
    """Every decode form at 7 q heads a kv head, T * G = 7 and 14 of the
    tile's 16 rows, at the prefixes above and the cache's last position;
    every row no query may see is NaN. Tolerances as above."""
    before = dict(_build.launches)
    got, want, count = _decode_case(form, kv, T, 7, seed=70 + T, softcap=softcap,
                                    window=window, poison=True)
    torch.cuda.synchronize()
    assert _build.launches[count] == before.get(count, 0) + 1
    assert got.shape[-1] == 2 * 7 * 128
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= (1e-4 if kv == "f32" else 2.0 ** -7)


@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_g7_replay_in_a_cuda_graph(cuda, form):
    """The graph replays of the decode forms at G = 7, bit for bit the eager
    call's output."""
    _replay_case(cuda, form, "bf16", 128, 7)


# -- past 16 query rows: the speculative verify's T * G (row tiles of 16) -----

# (T, G): the 7B's K = 4 verify (20 rows, two tiles), Qwen2-7B's widest verify
# (56 rows, four tiles, the last of 8), 3 tokens at G = 7 (21 rows: a tile of
# 5), 8 tokens at G = 8 (64 rows), 17 rows at G = 1 being impossible (T <= 8)
_WIDE = [(5, 4), (8, 7), (3, 7), (8, 8)]


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 70), (0.0, 300)])
@pytest.mark.parametrize("T,G", _WIDE)
@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_past_sixteen_rows_match_plain(cuda, form, kv, T, G, softcap, window):
    """Every decode form at T * G > 16 query rows, where each row tile of 16
    is a block of its own with partials and tickets of its own, every stored
    type, softcap and window (a later tile's window starts later: keys before
    it are never read), at the prefixes on both sides of every chunk edge and
    the cache's last position; every row no query may see is NaN.
    Tolerances as at 16 rows."""
    before = dict(_build.launches)
    got, want, count = _decode_case(form, kv, T, G, seed=100 + T * 10 + G, softcap=softcap,
                                    window=window, poison=True)
    torch.cuda.synchronize()
    assert _build.launches[count] == before.get(count, 0) + 1
    assert got.shape[-1] == 2 * G * 128
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= (1e-4 if kv == "f32" else 2.0 ** -7)


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [80, 96, 256])
@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_past_sixteen_rows_at_every_head_dim(cuda, form, kv, hd, q_dtype):
    """The 7B verify's 20 rows (T = 5, G = 4) at head dims 80, 96 and 256 in
    every (q, cache) dtype pair, with softcap and window: float32 at 256
    holds K and V in one tile (Layout::ONE_TILE), whose rows are still 16.
    Tolerance: 1e-4 when q and the cache are float32, else 2^-7."""
    pos = (0, 1, 127, 128, 129, 1000, 9 * PAGE - 5)
    got, want, _ = _decode_case(form, kv, 5, 4, seed=hd + 7, softcap=30.0, window=200, pos=pos,
                                poison=True, hd=hd, q_dtype=q_dtype)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    exact32 = kv == "f32" and q_dtype == torch.float32
    assert _rel(got, want) <= (1e-4 if exact32 else 2.0 ** -7)


@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_past_sixteen_rows_are_deterministic(cuda, form):
    """Two calls at 56 rows give the same bits: each tile's chunks merge in
    chunk order, whichever block arrives last."""
    one, _, _ = _decode_case(form, "int8", 8, 7, seed=3, window=100, pos=(0, 129, 700, 1000))
    two, _, _ = _decode_case(form, "int8", 8, 7, seed=3, window=100, pos=(0, 129, 700, 1000))
    torch.cuda.synchronize()
    assert torch.equal(one, two)


@pytest.mark.parametrize("T,G", [(5, 4), (8, 7)])
@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_past_sixteen_rows_replay_in_a_cuda_graph(cuda, form, T, G):
    """The wide forms captured once and replayed at new positions, bit for
    bit the eager call's output: the ticket buffer for the extra tiles is
    made by the eager warm-up, outside the capture."""
    _replay_case(cuda, form, "bf16", 128, G, window=300, T=T)


# -- the decode step as a CUDA graph (runtime/generate.py) --------------------

def _captured(fn):
    """fn() run once off the capture (build, shared-memory attributes, ticket
    counters), then captured -> (graph, the captured call's output)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_replay_in_a_cuda_graph(cuda, form, kv):
    """Each decode-attention form captured once and replayed with the
    positions (and the lengths of the unfused paged form) changed in place,
    at two sets of positions: bit for bit the eager call's output. The grid
    comes from the cache's capacity, so one graph serves every position."""
    _replay_case(cuda, form, kv, 128, 4)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_hd256_replay_in_a_cuda_graph(cuda, form, kv):
    """The same at head dim 256 with Gemma-2's 2 q heads a kv head, the
    softcap 50 and a window of 300 keys."""
    _replay_case(cuda, form, kv, 256, 2, softcap=50.0, window=300)


def _replay_case(cuda, form, kv, hd, G, softcap=0.0, window=0, q_dtype=torch.bfloat16, T=1):
    g = torch.Generator(device=cuda).manual_seed(4)
    B, KV, n_slot_pages = 4, 2, 9
    S = n_slot_pages * PAGE

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=cuda)

    q = rand(B, T, KV * G, hd).to(q_dtype)
    paged, fused = form.startswith("paged"), form.endswith("fused")
    shape = (B * n_slot_pages + 1, KV, PAGE, hd) if paged else (B, KV, S, hd)
    k, v, kn, vn = rand(*shape), rand(*shape), rand(B, KV, T, hd), rand(B, KV, T, hd)
    ks = vs = ksn = vsn = None
    if kv == "int8":
        (k, ks), (v, vs), (kn, ksn), (vn, vsn) = (q8_vec(a) for a in (k, v, kn, vn))
    else:
        kdt = torch.float32 if kv == "f32" else torch.bfloat16
        k, v, kn, vn = (a.to(kdt) for a in (k, v, kn, vn))
    perm = torch.randperm(B * n_slot_pages, generator=torch.Generator().manual_seed(4)) + 1
    table = perm.reshape(B, n_slot_pages).to(cuda, torch.int32)
    pos = torch.zeros(B, dtype=torch.int32, device=cuda)
    lengths = pos + 1

    def s(a):
        return None if a is None else a[None]

    kw = dict(softcap=softcap, local_window=window)

    def call():
        if form == "dense":
            return decode_attention(q, k, v, pos, 0.09, ks, vs, **kw)
        if form == "dense_fused":
            return decode_attention_fused(q, k[None], v[None], 0, pos, 0.09, kn, vn, s(ks), s(vs),
                                          ksn, vsn, **kw)
        if form == "paged":
            return paged_decode_attention(q, k, v, table, lengths, 0.09, ks, vs, **kw)
        return paged_decode_attention_fused(q, k[None], v[None], table, 0, pos, 0.09, kn, vn,
                                            s(ks), s(vs), ksn, vsn, **kw)

    graph, out = _captured(call)
    for at in ((0, 130, 511, 1000), (5, 777, S - T, 3)):
        pos.copy_(torch.tensor(at, dtype=torch.int32))
        lengths.copy_(pos + T)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, call()), at


@pytest.fixture(scope="module")
def two_layer_7b(tmp_path_factory):
    """Mistral-7B widths cut to 2 layers, bfloat16 on the card, with a cache
    prefilled by a 16-token prompt."""
    from crabml_tpu_torch.gguf.reader import GGUFFile
    from crabml_tpu_torch.models.config import config_from_gguf
    from crabml_tpu_torch.models.weights import load_weights
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    path = build_synth_gguf(str(tmp_path_factory.mktemp("gguf") / "7b2.gguf"), "7b", seed=2,
                            layers=2)
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf.metadata)
    w = load_weights(gf, cfg, "cuda", torch.bfloat16)
    prompt = torch.from_numpy(np.random.default_rng(2).integers(3, cfg.vocab_size, (1, 16)))
    return w, cfg, prompt.cuda()


def _prefilled(w, cfg, prompt):
    from crabml_tpu_torch.models.forward import KVCache, forward

    cache = KVCache.create(cfg, 1, 512, torch.bfloat16, "cuda")
    forward(w, cache, prompt, torch.tensor([0]), cfg, torch.bfloat16)
    return cache


def test_decode_step_graph_matches_eager_at_7b_width(cuda, two_layer_7b):
    """decode_step + greedy sample at 7B widths (2 layers), captured once and
    replayed 8 times, against the eager step on a second cache: the same
    kernels in the same order, so bit for bit the same logits and tokens, and
    the same cache rows."""
    from crabml_tpu_torch.models.forward import decode_step
    from crabml_tpu_torch.runtime.generate import StepGraph

    w, cfg, prompt = two_layer_7b
    eager_cache, graph_cache = _prefilled(w, cfg, prompt), _prefilled(w, cfg, prompt)
    tok = torch.tensor([7], device=cuda)
    pos = torch.tensor([16], dtype=torch.int32, device=cuda)
    logits = torch.empty(1, cfg.vocab_size, device=cuda)

    def step(_gen):
        out = decode_step(w, graph_cache, tok[:, None], pos, cfg, torch.bfloat16)
        logits.copy_(out)
        tok.copy_(out.argmax(-1))
        pos.add_(1)

    graph = StepGraph(step, cuda)
    tok.fill_(7)
    pos.fill_(16)
    t, p = torch.tensor([7], device=cuda), torch.tensor([16], dtype=torch.int32, device=cuda)
    for i in range(8):
        want = decode_step(w, eager_cache, t[:, None], p, cfg, torch.bfloat16)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(logits, want), i
        t, p = want.argmax(-1), p + 1
        assert torch.equal(tok, t), i
    assert torch.equal(graph_cache.k[:, :, :, :24], eager_cache.k[:, :, :, :24])


def test_sampled_graph_repeats_from_its_seed(cuda, two_layer_7b):
    """decode_loop at temperature 0.9 through its captured graph, three runs
    from one seed (a capture, a replay of the cached graph, a capture on
    another cache): identical tokens. The generator is registered with the
    graph, so each replay draws new numbers from it."""
    from crabml_tpu_torch.runtime.generate import decode_loop
    from crabml_tpu_torch.runtime.sampler import Sampler

    w, cfg, prompt = two_layer_7b
    gen = torch.Generator(device=cuda)
    a, b = _prefilled(w, cfg, prompt), _prefilled(w, cfg, prompt)
    runs = []
    for cache in (a, a, b):
        gen.manual_seed(5)
        runs.append(decode_loop(w, cache, [7], [16], 12, cfg, torch.bfloat16,
                                Sampler(temperature=0.9, topp=0.95), gen))
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    assert len(set(runs[0][0].tolist())) > 1


def test_replays_do_not_sync(cuda, two_layer_7b):
    """The replay loop of a captured decode step under
    torch.cuda.set_sync_debug_mode("error"): no replay waits for the card."""
    from crabml_tpu_torch.runtime import generate
    from crabml_tpu_torch.runtime.sampler import Sampler

    w, cfg, prompt = two_layer_7b
    cache = _prefilled(w, cfg, prompt)
    got = generate._captured(w, cache, 1, cfg, torch.bfloat16, Sampler(), None,
                             torch.tensor([7]), torch.tensor([16], dtype=torch.int32))
    before = _build.launches["qmm_w4a8"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got.state.count.zero_()
        got.graph.replay(8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert got.state.pos.item() == 24 and got.state.count.item() == 8
    assert _build.launches["qmm_w4a8"] - before == 8 * got.graph.launches["qmm_w4a8"] > 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engines_replay_their_ticks(cuda, two_layer_7b, paged):
    """Both engines on the card, through their captured ticks: three
    requests (greedy; greedy with a repetition penalty and logprobs; sampled)
    give the same greedy tokens at step(1) and step(4), and a graph is
    captured for each set of processors in use."""
    from crabml_tpu_torch.serving import PagedServingEngine, Request, ServingEngine

    w, cfg, _ = two_layer_7b
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in (20, 140, 9)]
    outs = []
    for multi in (1, 4):
        kw = dict(weights=w, cfg=cfg, n_slots=4, seq_len=512, compute_dtype=torch.bfloat16)
        eng = PagedServingEngine(n_pages=24, **kw) if paged else ServingEngine(**kw)
        reqs = [eng.submit(Request(prompt="", prompt_tokens=p, max_tokens=10, **extra))
                for p, extra in zip(prompts, ({}, dict(repetition_penalty=1.5, logprobs=2),
                                              dict(temperature=0.8)))]
        while any(eng.slots) or not eng.pending.empty():
            eng.step(multi)
        assert all(len(r.output_tokens) == 10 for r in reqs)
        assert len(reqs[1].output_logprobs) == 10
        assert len(eng._graphs) >= 2
        outs.append([r.output_tokens for r in reqs[:2]])
    assert outs[0] == outs[1]


def test_no_collection_during_a_capture(cuda):
    """The cyclic collector is off while a step is captured (a graph in a
    garbage reference cycle collected then would free its memory pool, a
    cudaFree that invalidates the capture) and on again after it."""
    import gc

    from crabml_tpu_torch.runtime.generate import StepGraph

    x = torch.ones(4, device=cuda)
    seen = []

    def step(_gen):
        seen.append(gc.isenabled())
        x.add_(1.0)

    StepGraph(step, cuda).replay(3)
    torch.cuda.synchronize()
    assert seen == [True, False] and gc.isenabled()
    assert x.tolist() == [5.0] * 4  # the warm-up and three replays


def test_a_failed_capture_raises(cuda):
    """A step that reads the card on the host cannot be captured: StepGraph
    raises (there is no eager fallback), and the launch counts stay."""
    from crabml_tpu_torch.runtime.generate import StepGraph

    x = torch.ones(4, device=cuda)
    before = dict(_build.launches)
    with pytest.raises(RuntimeError):
        StepGraph(lambda _gen: x.add_(x.sum().item()), cuda)
    torch.cuda.synchronize()
    assert dict(_build.launches) == before


def test_random_numbers_work_after_a_failed_capture(cuda):
    """A failed capture leaves the card's default generator and the
    generator registered with the failed graph usable: both draw after it,
    a later capture with that generator replays, and the default generator
    still draws what its seed gives."""
    from crabml_tpu_torch.runtime.generate import StepGraph

    x = torch.ones(4, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    with pytest.raises(RuntimeError):
        StepGraph(lambda g: x.add_(torch.rand(4, device=cuda, generator=g).sum().item()), cuda,
                  generator=gen)
    torch.manual_seed(3)
    a = torch.rand(8, device=cuda)
    torch.manual_seed(3)
    assert torch.equal(torch.rand(8, device=cuda), a)
    assert torch.isfinite(torch.randn(8, device=cuda, generator=gen)).all()
    out = torch.zeros(4, device=cuda)
    graph = StepGraph(lambda g: out.copy_(torch.rand(4, device=cuda, generator=g)), cuda,
                      generator=gen)
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(out, first)  # each replay draws fresh numbers
    assert torch.isfinite(torch.rand(8, device=cuda)).all()


# ---------------------------------------------------------------------------
# the Q8_0, Q6_K, Q5_K, Q4_0, Q3_K, Q2_K and Q5_0 forms: the dequant kernels
# (qmm_q8_0.cu, qmm_q6k.cu, qmm_q5k.cu, qmm_q4_0.cu, qmm_q3k.cu, qmm_q2k.cu,
# qmm_q5_0.cu) and the int8-activation forms of qmm_w4a8.cu; and the Q4_1,
# Q5_1 and Q8_1 weights, which run the Q4_K, Q5_K and Q8_0 forms on planes
# converted from their own blocks
# ---------------------------------------------------------------------------

SCHEME_KINDS = pytest.mark.parametrize(
    "kind", [GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q5_K, GGMLType.Q4_0, GGMLType.Q3_K,
             GGMLType.Q2_K, GGMLType.Q5_0, GGMLType.Q4_1, GGMLType.Q5_1, GGMLType.Q8_1],
    ids=["q8_0", "q6_k", "q5_k", "q4_0", "q3_k", "q2_k", "q5_0", "q4_1", "q5_1", "q8_1"])
# the every-value cases: each kind with a form of its own, and Q4_1 for Q4_K's
# planes (Q5_1's and Q8_1's are exactly Q5_K's and Q8_0's cases)
EVERY_VALUE_KINDS = pytest.mark.parametrize(
    "kind", [GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q5_K, GGMLType.Q4_0, GGMLType.Q3_K,
             GGMLType.Q2_K, GGMLType.Q5_0, GGMLType.Q4_1],
    ids=["q8_0", "q6_k", "q5_k", "q4_0", "q3_k", "q2_k", "q5_0", "q4_1"])
K16_KINDS = pytest.mark.parametrize("kind", [GGMLType.Q3_K, GGMLType.Q2_K], ids=["q3_k", "q2_k"])


def _x(rows, k, seed):
    """bf16 activations from a generator of their own: an earlier test's
    failed capture may leave the default generator unusable."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(rows, k, generator=g, device="cuda").to(torch.bfloat16)


def _scheme_raw(kind, n, k, seed):
    """Random blocks of `kind` for n weights (synth_gguf's), each block's
    scales varied: the writer gives every block one d."""
    from crabml_tpu_torch.tools.synth_gguf import SCHEMES, vary_scales

    _, blocks = next(v for v in SCHEMES.values() if v[0] == kind)
    rng = np.random.default_rng(seed)
    return vary_scales(kind, blocks(rng, n, 1.0 / math.sqrt(k)), rng)


def _scheme_weight(kind, m, k, seed):
    """A random (m, k) weight of `kind`, kernel planes, bf16 scales."""
    qt = to_kernel_layout(to_planar(kind, _scheme_raw(kind, m * k, k, seed), (m, k), "cuda"),
                          torch.bfloat16)
    for n, t in qt.planes.items():
        assert not (t == t.reshape(-1)[0]).all(), n
    return qt


def _plain_of(kind, name):
    """The plain version of the form `name`, on a planes dict."""
    plain = getattr(gemm_quant, f"{name}_plain")
    return lambda x, p: plain(x, *(p[n] for n in gemm_quant._KERNEL_PLANES[FORM_KIND[kind]]))


def _dequant_of(kind):
    name = gemm_quant.DEQUANT_FORMS[FORM_KIND[kind]]
    return name, _plain_of(kind, name)


def _w4a8_plain_of(kind):
    return _plain_of(kind, gemm_quant.W4A8_FORMS[FORM_KIND[kind]])


def _every_value_planes(kind, m, k, device):
    """Kernel planes of an (m, k) weight of `kind` in which every value
    (int8 -127..127 for Q8_0 and Q8_1, 6-bit 0..63 for Q6_K, 5-bit 0..31 for
    Q5_K, Q5_0 and Q5_1, nibbles for Q4_0 and Q4_1, 3-bit 0..7 for Q3_K,
    2-bit for Q2_K) stands at every k position in some row, each row and
    scale group with a scale (and Q5_K, Q5_1, Q4_1 and Q2_K a minimum) of its
    own."""
    n = torch.arange(m, device=device)[:, None]
    j2, j4, j8 = (torch.arange(k // d, device=device)[None, :] for d in (2, 4, 8))
    if kind in (GGMLType.Q3_K, GGMLType.Q2_K):
        grp = torch.arange(k // 16, device=device)[None, :]
        sbi = torch.arange(k // 256, device=device)[None, :]
        planes = {"qs": ((n + j4) % 256).to(torch.uint8),
                  "d": (0.01 * (1 + (n + sbi) % 5 / 8)).half().float()}
        if kind == GGMLType.Q3_K:  # signed scales, never 0
            v = (16 * n + grp) % 60 - 30
            planes["hb"] = ((3 * n + 7 * j8 + 1) % 256).to(torch.uint8)
            planes["sc"] = (v + (v >= 0).long()).to(torch.int8)
            assert (planes["sc"][:, 1:] != planes["sc"][:, :-1]).all()
        else:
            planes["scm"] = ((1 + (n + grp) % 15) | ((3 * n + 5 * grp) % 16) << 4).to(torch.uint8)
            planes["dmin"] = (0.005 * (1 + (2 * n + sbi) % 3 / 4)).half().float()
        return planes
    form = FORM_KIND[kind]
    if form == GGMLType.Q8_0:
        j = torch.arange(k, device=device)[None, :]
        planes = {"qs": ((n + 7 * j) % 255 - 127).to(torch.int8)}
    elif form == GGMLType.Q6_K:
        planes = {"ql": ((n + j2) % 256).to(torch.uint8),
                  "qh": ((3 * n + 7 * j4 + 1) % 256).to(torch.uint8)}
    else:
        planes = {"qs": ((n + j2) % 256).to(torch.uint8)}
        if form in (GGMLType.Q5_K, GGMLType.Q5_0):  # even qh bits follow the row's high
            # nibble, odd its low one
            planes["qh"] = ((((n >> 4) & 1) * 0x55 | (n & 1) * 0xAA) ^ ((7 * j8 + 1) % 256)).to(
                torch.uint8)
    gr = gemm_quant.SCHEME_GROUP[FORM_KIND[kind]]
    grp = torch.arange(k // gr, device=device)[None, :]
    planes["dsub"] = (0.01 * (1 + (16 * n + grp) % 61 / 64) * (1 - 2 * (grp % 3 == 2))).to(
        torch.bfloat16)
    assert (planes["dsub"][:, 1:] != planes["dsub"][:, :-1]).all()
    if form in (GGMLType.Q5_K, GGMLType.Q4_K):
        planes["msub"] = (-0.003 * (1 + (5 * n + 3 * grp) % 37 / 64)).to(torch.bfloat16)
    return planes


@SCHEME_KINDS
@pytest.mark.parametrize("rows,m,k", [(17, 384, 512), (100, 320, 1024), (513, 256, 256),
                                       (1, 512, 1024), (7, 256, 256), (189, 512, 1536),
                                       (512, 768, 512), (1000, 256, 2048), (37, 320, 512),
                                       (130, 200, 1024), (189, 256, 14336)])
def test_scheme_dequant_matmul_matches_plain(cuda, kind, rows, m, k):
    """Tolerance 1e-4 of max|out|: the same bf16 weights (the product of an
    int8, or of a 6-bit value less 32, and a bf16 scale is exact before its
    one rounding), float32 sums in another order. Rows from 1 to 1,000 (every
    width of the tile loop, ragged last tiles), columns off the 128-wide tile
    (320, 384) and off the 8-wide store (200), k from one superblock to
    14,336. The bf16 output is the float32 output rounded once."""
    qt = _scheme_weight(kind, m, k, rows)
    x = _x(rows, k, m)
    name, plain = _dequant_of(kind)
    kernel = getattr(gemm_quant, name)
    before = _build.launches[name]
    got = kernel(x, qt)
    want = plain(x, qt.planes)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4
    assert torch.equal(kernel(x, qt, torch.bfloat16), got.to(torch.bfloat16))


@EVERY_VALUE_KINDS
def test_scheme_dequant_converts_every_value_exactly(cuda, kind):
    """Every value (int8 -127..127 for Q8_0, 6-bit 0..63 for Q6_K, 5-bit
    0..31 for Q5_K, nibbles for Q4_0) at every byte and bit position of a
    superblock, each row and scale group with a scale of its own, one hot
    row of x at a time: the kernel's conversion, its fragment order (Q6_K's
    per-half and Q5_K's per-superblock qh-bit orders included) and its
    choice of scale group return the plain version's bf16 weights exactly."""
    m, k = 256, 512
    planes = _every_value_planes(kind, m, k, cuda)
    qt = QTensor(kind, (m, k), planes)
    name, plain = _dequant_of(kind)
    w = dequantize(qt, torch.bfloat16)
    x = torch.eye(k, device=cuda, dtype=torch.bfloat16)
    got = getattr(gemm_quant, name)(x, qt)
    want = plain(x, planes)
    torch.cuda.synchronize()
    assert torch.equal(want, w.t().float())
    assert torch.equal(got, want)


@SCHEME_KINDS
@pytest.mark.parametrize("rows,m,k", [(1, 300, 768), (3, 512, 256), (8, 256, 1024),
                                       (9, 336, 512), (16, 256, 1024), (16, 128, 14336),
                                       (1, 6144, 4096), (8, 4096, 14336)])
def test_scheme_w4a8_matches_plain(cuda, kind, rows, m, k):
    """Tolerance 1e-4 of max|out|: identical int8 activations (per 16-group
    for Q6_K), exact integer group dots, float32 group sums in another order.
    Every plan: 1, 8 and 16 rows a stage; columns off the 16-wide tile."""
    qt = _scheme_weight(kind, m, k, rows + m)
    x = _x(rows, k, m)
    name = gemm_quant.W4A8_FORMS[FORM_KIND[kind]]
    before = _build.launches[name]
    got = gemm_quant.qmm_w4a8(x, qt)
    want = _w4a8_plain_of(kind)(x, qt.planes)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4
    assert torch.equal(gemm_quant.qmm_w4a8(x, qt, torch.bfloat16), got.to(torch.bfloat16))
    assert torch.equal(gemm_quant.qmm_w4a8(x, qt), got)  # the same at every call


@EVERY_VALUE_KINDS
def test_scheme_w4a8_takes_every_value(cuda, kind):
    """The int8-activation form on the planes of the one-hot sweep above,
    16 one-hot rows of x a call: every value at every k position reaches
    its column with its own scale (and minimum, or offset). Tolerance 1e-4
    of max|out| per row block (the kernel's float32 epilogue rounds in
    another order than the plain version's); one step of a value is ~1e-2."""
    m, k = 256, 512
    qt = QTensor(kind, (m, k), _every_value_planes(kind, m, k, cuda))
    eye = torch.eye(k, device=cuda, dtype=torch.bfloat16)
    plain = _w4a8_plain_of(kind)
    for r0 in range(0, k, 16):
        x = eye[r0:r0 + 16]
        got = gemm_quant.qmm_w4a8(x, qt)
        want = plain(x, qt.planes)
        assert _rel(got, want) <= 1e-4, f"rows {r0}..{r0 + 15}"


@SCHEME_KINDS
def test_scheme_w4a8_agrees_over_seeds(cuda, kind):
    """30 random activations at 1..16 rows: the kernel's quantizer (at 16
    for Q6_K) rounds every int8 value as the plain one does."""
    qt = _scheme_weight(kind, 256, 1024, 16)
    g = torch.Generator(device=cuda)
    for seed in range(30):
        rows = seed % 16 + 1
        x = torch.randn(rows, 1024, generator=g.manual_seed(seed), device=cuda).to(torch.bfloat16)
        got = gemm_quant.qmm_w4a8(x, qt)
        want = _w4a8_plain_of(kind)(x, qt.planes)
        assert _rel(got, want) <= 1e-4, f"seed {seed}"


@SCHEME_KINDS
@pytest.mark.parametrize("form", ["dequant", "w4a8"])
def test_scheme_forms_replay_in_a_cuda_graph(cuda, kind, form):
    """Each new form captures in a CUDA graph (the int8-activation form with
    its chained quantizer): a replay equals the eager call bit for bit, and
    after x changes in place equals the eager call on the new x."""
    rows, m, k = (8, 1024, 2048) if form == "w4a8" else (100, 512, 1024)
    qt = _scheme_weight(kind, m, k, 3)
    fn = gemm_quant.qmm_w4a8 if form == "w4a8" else getattr(gemm_quant, _dequant_of(kind)[0])
    x = _x(rows, k, 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture: build, shared-memory attribute
        fn(x, qt, torch.bfloat16)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(x, qt, torch.bfloat16)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fn(x, qt, torch.bfloat16))
        x.copy_(_x(rows, k, 2))


def test_scheme_wrappers_raise_rather_than_fall_back(cuda):
    """Shapes and planes the new forms do not take raise on a CUDA tensor: x
    of another depth than the weight's k or its padded planes' (a Q8_0 row
    of 288, whose planes hold 512: 300 is neither; 288 itself is taken since
    the planes are padded), float32 scales, a Q6_K weight given to the Q8_0
    kernel, 17 rows to qmm_w4a8, a plane per row on one weight (the plane
    form takes a stack)."""
    x = torch.zeros(32, 300, device=cuda, dtype=torch.bfloat16)
    raw = np.zeros((256, 288 // 32, 34), np.uint8)
    q8 = to_kernel_layout(to_planar(GGMLType.Q8_0, raw, (256, 288), "cuda"), torch.bfloat16)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_q8_0(x, q8)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_w4a8(x[:1], q8)
    q6 = _scheme_weight(GGMLType.Q6_K, 256, 512, 1)
    x = torch.zeros(32, 512, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_q8_0(x, q6)
    f32 = QTensor(GGMLType.Q6_K, q6.shape, {**q6.planes, "dsub": q6.planes["dsub"].float()})
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_q6k(x, f32)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_w4a8(x[:17], q6)
    with pytest.raises(UnsupportedError, match="stack"):
        gemm_quant.qmm_w4a8(x[:2], q6, plane=torch.zeros(2, dtype=torch.int32, device=cuda))


@K16_KINDS
def test_k16_wrappers_raise_rather_than_fall_back(cuda, kind):
    """The Q3_K and Q2_K forms raise on a CUDA tensor where they do not take
    the input: a bfloat16 d plane, the weight given to another scheme's
    dequant kernel, 17 rows to qmm_w4a8, a plane per row on one weight (the
    plane form takes a stack); and a row that is not whole superblocks raises
    at load."""
    qt = _scheme_weight(kind, 256, 512, 1)
    x = torch.zeros(32, 512, device=cuda, dtype=torch.bfloat16)
    name = gemm_quant.DEQUANT_FORMS[FORM_KIND[kind]]
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_q6k(x, qt)
    bf16 = QTensor(kind, qt.shape, {**qt.planes, "d": qt.planes["d"].to(torch.bfloat16)})
    with pytest.raises(UnsupportedError):
        getattr(gemm_quant, name)(x, bf16)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_w4a8(x[:1], bf16)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_w4a8(x[:17], qt)
    with pytest.raises(UnsupportedError, match="stack"):
        gemm_quant.qmm_w4a8(x[:2], qt, plane=torch.zeros(2, dtype=torch.int32, device=cuda))
    with pytest.raises(UnsupportedError, match="superblocks"):
        to_planar(kind, np.zeros(256 * 288 // 256 * 128, np.uint8), (256, 288), "cuda")


# the 7B shapes of the card's 7b-q3_k_m and 7b-q2_k paths: the dequant forms
# at a 512-row and the ragged 189-row chunk of q and of gate|up, a 512-row
# chunk of down; the int8-activation forms at every decode projection
# (q, k|v, wo, gate|up, down, lm_head) at 1 and 8 rows, and 16 rows of q
_7B_DEQUANT = [(512, 4096, 4096), (189, 4096, 4096), (512, 28672, 4096), (189, 28672, 4096),
               (512, 4096, 14336)]
_7B_W4A8 = [(rows, m, k) for rows in (1, 8)
            for m, k in ((4096, 4096), (1024, 4096), (28672, 4096), (4096, 14336), (32000, 4096))]
_7B_W4A8 += [(16, 4096, 4096)]


@K16_KINDS
@pytest.mark.parametrize("form,rows,m,k", [("dequant", *s) for s in _7B_DEQUANT]
                         + [("w4a8", *s) for s in _7B_W4A8])
def test_k16_forms_at_7b_shapes(cuda, kind, form, rows, m, k):
    """The four new kernels against their plain versions at the 7B shapes,
    tolerance 1e-4 of max|out| (the same bf16 weights or int8 activations,
    float32 sums in another order), each call counted once."""
    qt = _scheme_weight(kind, m, k, rows + 7 * m)
    x = _x(rows, k, k + rows)
    if form == "dequant":
        name, plain = _dequant_of(kind)
        fn = getattr(gemm_quant, name)
    else:
        name, plain = gemm_quant.W4A8_FORMS[FORM_KIND[kind]], _w4a8_plain_of(kind)
        fn = gemm_quant.qmm_w4a8
    before = _build.launches[name]
    got = fn(x, qt)
    want = plain(x, qt.planes)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("kind", [GGMLType.Q5_K, GGMLType.Q4_0, GGMLType.Q5_0],
                         ids=["q5_k", "q4_0", "q5_0"])
def test_q5k_q4_0_wrappers_raise_rather_than_fall_back(cuda, kind):
    """The Q5_K, Q4_0 and Q5_0 forms raise on a CUDA tensor where they do
    not take the input: float32 scales, the weight given to another scheme's
    dequant kernel, 17 rows to qmm_w4a8, a plane per row on one weight (the
    plane form takes a stack)."""
    qt = _scheme_weight(kind, 256, 512, 1)
    x = torch.zeros(32, 512, device=cuda, dtype=torch.bfloat16)
    name = gemm_quant.DEQUANT_FORMS[FORM_KIND[kind]]
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_q4k(x, qt)
    f32 = QTensor(kind, qt.shape, {**qt.planes, "dsub": qt.planes["dsub"].float()})
    with pytest.raises(UnsupportedError):
        getattr(gemm_quant, name)(x, f32)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_w4a8(x[:17], qt)
    with pytest.raises(UnsupportedError, match="stack"):
        gemm_quant.qmm_w4a8(x[:2], qt, plane=torch.zeros(2, dtype=torch.int32, device=cuda))


# qmm_w4a8's Q4_K outputs at 1, 8 and 16 rows of the 7B qkv shape (sha256 of
# the float32 bytes, tools/w4a8_turns.py::q4k_hashes) as the source before the
# Q8_0 and Q6_K forms computed them on an H100: adding the forms left the
# Q4_K numbers as they were, bit for bit.
Q4K_W4A8_HASHES = {
    "1": "b3e5e14ab44d4eb156b06c49e16c076626a3012033a0dae45199b9ade9c7f16a",
    "8": "b42456e44a9862ec932e95aedcb8ef70e7a0486a9b401694295d712fe7dcfccd",
    "16": "b4a7e54fc4d9e52b788d89617270e350ee37d0f13fd941773e489bdc7d4a1189",
}


def test_q4k_w4a8_numbers_unchanged(cuda):
    from crabml_tpu_torch.tools.w4a8_turns import q4k_hashes

    assert q4k_hashes() == Q4K_W4A8_HASHES


# ---------------------------------------------------------------------------
# the experts' forms of the Q8_0, Q6_K, Q5_K, Q4_0, Q3_K and Q2_K schemes: the
# grouped dequant kernels (the second entry of each source) and the
# plane-per-row form of qmm_w4a8.cu. Every stack holds distinct random
# experts, and rows go to experts above 0: a kernel that read expert 0's
# planes, or one of its scale planes, would fail.
# ---------------------------------------------------------------------------

def _distinct_experts(qt):
    """Every plane of each expert of the stack `qt` differs from expert 0's,
    the scales as well as the values."""
    for n, t in qt.planes.items():
        for e in range(1, t.shape[0]):
            assert not torch.equal(t[0], t[e]), (n, e)
    return qt


def _scheme_stack(kind, E, m, k, seed):
    """E random (m, k) weights of `kind`, distinct, as one stack (E, m, k)."""
    raw = _scheme_raw(kind, E * m * k, k, seed)
    return _distinct_experts(to_kernel_layout(to_planar(kind, raw, (E, m, k), "cuda"),
                                              torch.bfloat16))


def _every_value_stack(kind, E, m, k):
    """A stack of E experts from `_every_value_planes`: expert e's planes are
    those rolled by 37 e rows, and its float planes (scales, minimums) also
    times 1 + e/8. Every value stands at every position in some row of each
    expert, and no plane of one expert is another's."""
    base = _every_value_planes(kind, m, k, "cuda")
    planes = {n: torch.stack([(t.roll(37 * e, 0).float() * (1 + e / 8)).to(t.dtype)
                              if t.is_floating_point() else t.roll(37 * e, 0)
                              for e in range(E)]) for n, t in base.items()}
    return _distinct_experts(QTensor(kind, (E, m, k), planes))


def _grouped_case(kind, qt, xs, off):
    """The grouped form against its plain version (1e-4 of max|out|: the same
    bf16 weights, float32 sums in another order), counted once; every row
    written (finite), the bf16 output the float32 one rounded once; and each
    segment equal to the dense kernel on its own plane, bit for bit."""
    name = gemm_quant.GROUPED_FORMS[FORM_KIND[kind]]
    fn = getattr(gemm_quant, name)
    plain = getattr(gemm_quant, f"{name}_plain")
    before = _build.launches[name]
    got = fn(xs, qt, off)
    want = plain(xs, *(qt.planes[n] for n in gemm_quant._KERNEL_PLANES[FORM_KIND[kind]]), off)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4
    assert torch.equal(fn(xs, qt, off, torch.bfloat16), got.to(torch.bfloat16))
    dense = getattr(gemm_quant, gemm_quant.DEQUANT_FORMS[FORM_KIND[kind]])
    cuts = off.tolist()
    for e, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
        if hi > lo:
            assert torch.equal(dense(xs[lo:hi], plane_of(qt, e)), got[lo:hi]), e
    return got


@SCHEME_KINDS
@pytest.mark.parametrize("counts", [(0, 13, 40, 64), (0, 0, 130, 1), (0, 300, 0, 0),
                                    (1, 37, 0, 129), (128, 128, 8, 9), (0, 65, 63, 0, 7, 1, 0, 200)])
def test_scheme_grouped_matches_plain(cuda, kind, counts):
    """The grouped forms at empty segments (expert 0 empty in most cases),
    segments shorter than a tile, one row over a tile and exact tiles, a
    1-row and a 37-row segment, every row on one expert above 0, and 8
    experts; 320 columns (off the 128-wide tile) and k = 768."""
    E, m, k = len(counts), 320, 768
    qt = _scheme_stack(kind, E, m, k, sum(counts) + E)
    _grouped_case(kind, qt, _x(sum(counts), k, 5), _offsets(counts))


_MIXTRAL_COUNTS = (0, 300, 37, 200, 128, 64, 195, 100)  # chip_smoke.py's GROUPED_COUNTS


@SCHEME_KINDS
@pytest.mark.parametrize("m,k", [(2 * 14336, 4096), (4096, 14336)], ids=["gate_up", "down"])
def test_scheme_grouped_at_mixtral_shapes(cuda, kind, m, k):
    """The 1,024 (row, slot) pairs of a 512-token Mixtral chunk over 8
    experts (expert 0 empty, ragged segments) at the experts' gate|up and
    down shapes."""
    qt = _scheme_stack(kind, 8, m, k, m + k)
    _grouped_case(kind, qt, _x(sum(_MIXTRAL_COUNTS), k, 7), _offsets(_MIXTRAL_COUNTS))


def _planes_case(kind, qt, x, plane):
    """The plane form against its plain version (1e-4 of max|out|), counted
    under `<form>.planes` once; two calls bit for bit; bf16 out the float32
    out rounded once; and each row equal to the dense form of its own plane
    (quantization is per row), bit for bit."""
    name = gemm_quant.W4A8_FORMS[FORM_KIND[kind]]
    plain = getattr(gemm_quant, f"{name}_plain")
    before = _build.launches[f"{name}.planes"]
    got = gemm_quant.qmm_w4a8(x, qt, plane=plane)
    names = gemm_quant._KERNEL_PLANES[FORM_KIND[kind]]
    want = plain(x, *(qt.planes[n] for n in names), plane=plane)
    torch.cuda.synchronize()
    assert _build.launches[f"{name}.planes"] == before + 1
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4
    assert torch.equal(gemm_quant.qmm_w4a8(x, qt, plane=plane), got)
    assert torch.equal(gemm_quant.qmm_w4a8(x, qt, torch.bfloat16, plane), got.to(torch.bfloat16))
    for b, e in enumerate(plane.tolist()):
        assert torch.equal(gemm_quant.qmm_w4a8(x[b:b + 1], plane_of(qt, e)), got[b:b + 1]), b
    return got


@SCHEME_KINDS
@pytest.mark.parametrize("rows,which", [(1, "last"), (2, "distinct"), (8, "distinct"),
                                        (8, "repeated"), (16, "mixed"), (3, "repeated")])
def test_scheme_w4a8_planes_match_plain(cuda, kind, rows, which):
    """The plane form of every scheme: every row on one expert above 0, each
    on its own, and a mix, over 8 experts with 336 columns (a ragged last
    16-column tile) and k = 1,024."""
    qt = _scheme_stack(kind, 8, 336, 1024, rows + 11)
    plane = {"last": torch.tensor([7]), "repeated": torch.full((rows,), 5),
             "distinct": torch.arange(1, rows + 1) % 8,
             "mixed": torch.tensor([3, 7, 7, 1, 0, 3, 3, 3, 2, 6, 6, 4, 5, 0, 1, 7])}[which]
    _planes_case(kind, qt, _x(rows, 1024, rows), plane.to(device=cuda, dtype=torch.int32))


@SCHEME_KINDS
@pytest.mark.parametrize("rows,m,k", [(1, 2 * 14336, 4096), (8, 2 * 14336, 4096),
                                       (1, 4096, 14336), (8, 4096, 14336)])
def test_scheme_w4a8_planes_at_mixtral_shapes(cuda, kind, rows, m, k):
    """The MoE decode step's matmuls: 1 and 8 rows of the experts' gate|up
    and down, a plane per row over 8 experts, expert 0 unused."""
    qt = _scheme_stack(kind, 8, m, k, m + rows)
    plane = torch.tensor([6, 1, 3, 3, 7, 2, 5, 1][:rows], device=cuda, dtype=torch.int32)
    _planes_case(kind, qt, _x(rows, k, m), plane)


@EVERY_VALUE_KINDS
def test_scheme_expert_forms_take_every_value_of_each_expert(cuda, kind):
    """Both experts' forms on a stack of every-value planes in which each
    expert has scales (and minimums) of its own: a form that offset the
    values but read another expert's scale plane, or the reverse, gives
    other numbers than its plain version and than the dense form on the
    expert's own planes (the cases' bit-for-bit row checks)."""
    E, m, k = 4, 256, 512
    qt = _every_value_stack(kind, E, m, k)
    counts = (40, 0, 100, 116)
    _grouped_case(kind, qt, _x(sum(counts), k, 13), _offsets(counts))
    plane = torch.tensor([3, 1, 2, 3, 1, 2, 2, 3, 0, 1], device=cuda, dtype=torch.int32)
    _planes_case(kind, qt, _x(len(plane), k, 14), plane)


@SCHEME_KINDS
@pytest.mark.parametrize("form", ["grouped", "planes"])
def test_scheme_expert_forms_replay_in_a_cuda_graph(cuda, kind, form):
    """Both experts' forms capture in a CUDA graph: a replay equals the eager
    call bit for bit, and after x changes in place (and, for the plane form,
    the plane index) equals the eager call on the new inputs."""
    qt = _scheme_stack(kind, 4, 512, 1024, 9)
    if form == "grouped":
        rows, off = 150, _offsets((0, 70, 1, 79))
        fn = getattr(gemm_quant, gemm_quant.GROUPED_FORMS[FORM_KIND[kind]])
        call = lambda: fn(x, qt, off, torch.bfloat16)  # noqa: E731
    else:
        rows = 8
        plane = torch.tensor([1, 3, 3, 2, 1, 1, 3, 2], device=cuda, dtype=torch.int32)
        call = lambda: gemm_quant.qmm_w4a8(x, qt, torch.bfloat16, plane)  # noqa: E731
    x = _x(rows, 1024, 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture: build, shared-memory attribute
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, call())
        x.copy_(_x(rows, 1024, 2))
        if form == "planes":
            plane.copy_(plane.flip(0))


@SCHEME_KINDS
def test_scheme_expert_wrappers_raise_rather_than_fall_back(cuda, kind):
    """The experts' forms raise on a CUDA tensor where they do not take the
    input: one weight for a stack (grouped), offsets of another length or
    dtype, another scheme's stack, float32 activations over bfloat16 scale
    planes (Q3_K's and Q2_K's scales are the same in both dtypes, so their
    float32 grouped form takes float32 activations); a plane index of
    another dtype or length, a stack for the dense form."""
    qt = _scheme_stack(kind, 4, 256, 512, 3)
    one = plane_of(qt, 1)
    other = _scheme_stack(GGMLType.Q6_K if FORM_KIND[kind] == GGMLType.Q4_K else GGMLType.Q4_K,
                          4, 256, 512, 4)
    fn = getattr(gemm_quant, gemm_quant.GROUPED_FORMS[FORM_KIND[kind]])
    xs = _x(40, 512, 3)
    off = _offsets((0, 10, 30, 0))
    with pytest.raises(UnsupportedError):
        fn(xs, one, off[:2])
    with pytest.raises(UnsupportedError):
        fn(xs, qt, off[:4])
    with pytest.raises(UnsupportedError):
        fn(xs, qt, off.long())
    with pytest.raises(UnsupportedError):
        fn(xs, other, off)
    if "dsub" in qt.planes:
        with pytest.raises(UnsupportedError):
            fn(xs.float(), qt, off)
    else:
        before = _build.launches[f"{gemm_quant.GROUPED_FORMS[FORM_KIND[kind]]}.f32"]
        assert fn(xs.float(), qt, off).dtype == torch.float32
        assert _build.launches[f"{gemm_quant.GROUPED_FORMS[FORM_KIND[kind]]}.f32"] == before + 1
    plane = torch.tensor([1, 2], device=cuda, dtype=torch.int32)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_w4a8(xs[:2], qt, plane=plane.long())
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_w4a8(xs[:2], qt, plane=plane[:1])
    with pytest.raises(UnsupportedError, match="one plane"):
        gemm_quant.qmm_w4a8(xs[:2], qt)


# ---------------------------------------------------------------------------
# float32 compute: the float32 dequant forms (csrc/qmm_f32.cu), the float32
# int8-activation forms (float32 x and scale planes), and the decode forms in
# float32 at head dim 256 and over a cache of another dtype
# ---------------------------------------------------------------------------

ALL_KINDS = pytest.mark.parametrize(
    "kind", [GGMLType.Q4_K, GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q5_K, GGMLType.Q4_0,
             GGMLType.Q3_K, GGMLType.Q2_K, GGMLType.Q5_0, GGMLType.Q4_1, GGMLType.Q5_1,
             GGMLType.Q8_1],
    ids=["q4_k", "q8_0", "q6_k", "q5_k", "q4_0", "q3_k", "q2_k", "q5_0", "q4_1", "q5_1", "q8_1"])


def _f32_weight(kind, m, k, seed):
    """A random (m, k) weight of `kind`, kernel planes with float32 scales
    (as the Runner loads them under float32 compute)."""
    qt = to_kernel_layout(to_planar(kind, _scheme_raw(kind, m * k, k, seed), (m, k), "cuda"),
                          torch.float32)
    for n in ("dsub", "msub"):
        assert n not in qt.planes or qt.planes[n].dtype == torch.float32
    return qt


def _f32_x(rows, k, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(rows, k, generator=g, device="cuda")


@ALL_KINDS
@pytest.mark.parametrize("rows,m,k", [(17, 384, 512), (100, 320, 1024), (513, 256, 256),
                                       (1, 512, 1024), (189, 512, 1536), (512, 768, 512),
                                       (64, 128, 256), (37, 200, 768), (189, 256, 14336)])
def test_f32_dequant_matmul_matches_plain(cuda, kind, rows, m, k):
    """The float32 dequant form of every kind: tolerance 1e-5 of max|out|
    (the same float32 weights, float32 sums in another order than cuBLAS's
    with TF32 off). Rows from 1 to 513 (ragged last 64-row tiles), columns off
    the 128-wide tile (200, 320, 384), k from one superblock to 14,336."""
    qt = _f32_weight(kind, m, k, rows + m)
    x = _f32_x(rows, k, m)
    name = gemm_quant.DEQUANT_F32_FORMS[FORM_KIND[kind]]
    _, plain = _dequant_of(kind)
    wrapper = getattr(gemm_quant, gemm_quant.DEQUANT_FORMS[FORM_KIND[kind]])
    before = _build.launches[name]
    got = wrapper(x, qt)
    want = plain(x, qt.planes)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-5
    assert torch.equal(wrapper(x, qt), got)  # the same at every call


@EVERY_VALUE_KINDS
def test_f32_dequant_converts_every_value_exactly(cuda, kind):
    """The one-hot sweep of the bfloat16 forms with float32 scales that use
    the low mantissa bits bfloat16 drops: one hot row of x at a time returns
    the exact float32 weights of `dequantize` (val*dsub + msub with two
    roundings, as the plain versions compute them) as the kernel's three
    TF32 passes take them, hi + lo of `tf32_split` (x's hi is 1 and its lo
    0), bit for bit."""
    m, k = 256, 512
    planes = _every_value_planes(kind, m, k, cuda)
    for n in ("dsub", "msub"):
        if n in planes:
            planes[n] = planes[n].float() * (1 + 2.0 ** -13)
    qt = QTensor(kind, (m, k), planes)
    wrapper = getattr(gemm_quant, gemm_quant.DEQUANT_FORMS[FORM_KIND[kind]])
    x = torch.eye(k, device=cuda)
    got = wrapper(x, qt)
    torch.cuda.synchronize()
    hi, lo = gemm_quant.tf32_split(dequantize(qt))
    assert torch.equal(got, (hi + lo).t())


@ALL_KINDS
@pytest.mark.parametrize("rows,m,k", [(1, 300, 768), (3, 512, 256), (8, 256, 1024),
                                       (9, 336, 512), (16, 256, 1024), (16, 128, 14336),
                                       (1, 6144, 4096), (8, 4096, 14336)])
def test_f32_w4a8_matches_plain(cuda, kind, rows, m, k):
    """The float32 int8-activation form of every kind (float32 x into the
    quantizer, float32 scale planes): tolerance 1e-4 of max|out| (identical
    int8 activations, exact integer dots, float32 group sums in another
    order); every plan (1, 8, 16 rows a stage); two calls bit for bit."""
    qt = _f32_weight(kind, m, k, rows + m)
    x = _f32_x(rows, k, m)
    name = gemm_quant.W4A8_FORMS[FORM_KIND[kind]] + ".f32"
    before = _build.launches[name]
    got = gemm_quant.qmm_w4a8(x, qt)
    want = _w4a8_plain_of(kind)(x, qt.planes)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4
    assert torch.equal(gemm_quant.qmm_w4a8(x, qt), got)


@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("kind", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q2_K],
                         ids=["q4_k", "q6_k", "q2_k"])
def test_f32_w4a8_plane_form_matches_plain(cuda, kind, rows):
    """The plane-per-row form with float32 scale planes: each row on its
    own expert of a 4-stack, some shared. Tolerance 1e-4 as above."""
    qt = to_kernel_layout(to_planar(kind, _scheme_raw(kind, 4 * 512 * 1024, 1024, 7),
                                    (4, 512, 1024), "cuda"), torch.float32)
    plane = torch.tensor([(3 * r + 1) % 4 for r in range(rows)], device=cuda, dtype=torch.int32)
    x = _f32_x(rows, 1024, 3)
    name = gemm_quant.W4A8_FORMS[FORM_KIND[kind]] + ".planes.f32"
    before = _build.launches[name]
    got = gemm_quant.qmm_w4a8(x, qt, plane=plane)
    plain = getattr(gemm_quant, gemm_quant.W4A8_FORMS[FORM_KIND[kind]] + "_plain")
    want = plain(x, *(qt.planes[n] for n in gemm_quant._KERNEL_PLANES[FORM_KIND[kind]]),
                 plane=plane)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    assert _rel(got, want) <= 1e-4


def test_f32_w4a8_int8_codes_equal_the_plain_quantizer(cuda):
    """The float32 quantizer's int8 codes, read back through a Q8_0 identity
    weight (w[n, n] = 1, dsub 1): out[r, n] = xq[r, n] * dx[r, group of n],
    so out / dx rounds back to the code. Equal to quantize_activation's on
    the same float32 x (the JAX package's, tests/test_torch_float32.py), a
    row with a zero group included."""
    k = 512
    x = _f32_x(5, k, 11) * torch.linspace(0.1, 30, k, device=cuda)
    x[2, 32:64] = 0
    qt = QTensor(GGMLType.Q8_0, (k, k), {"qs": torch.eye(k, device=cuda).to(torch.int8),
                                         "dsub": torch.ones(k, k // 32, device=cuda)})
    got = gemm_quant.qmm_w4a8(x, qt)
    xq, dx, _ = gemm_quant.quantize_activation(x)
    scale = dx.repeat_interleave(32, dim=1)
    codes = torch.where(scale > 0, torch.round(got / scale.clamp_min(1e-30)), torch.zeros_like(got))
    torch.cuda.synchronize()
    assert torch.equal(codes.to(torch.int8), xq)


def test_f32_forms_raise_rather_than_fall_back(cuda):
    """float32 x on bfloat16 scale planes, bfloat16 out of a float32 form,
    and float16 x: each refused before any launch."""
    bf = _weight(256, 512, 1)
    f32 = _f32_weight(GGMLType.Q4_K, 256, 512, 1)
    x = _f32_x(32, 512, 1)
    before = dict(_build.launches)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_q4k(x, bf)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_q4k(x, f32, torch.bfloat16)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_w4a8(x[:4], bf)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_w4a8(x[:4], f32, torch.bfloat16)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_w4a8(x[:4].to(torch.bfloat16), f32)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_q4k(x.half(), f32)
    assert dict(_build.launches) == before


def test_f32_qmm_w8_rounds_x_to_bfloat16(cuda):
    """qmm_w8 on float32 x: the bfloat16 kernel on x rounded once, as the
    JAX package rounds it; bit for bit the call on the rounded x."""
    qt = _w8_weight(256, 1024, 3)
    x = _f32_x(300, 1024, 3)
    got = gemm_quant.qmm_w8(x, qt)
    torch.cuda.synchronize()
    assert torch.equal(got, gemm_quant.qmm_w8(x.to(torch.bfloat16), qt))


_MIXED = [("f32", "f32"), ("f32", "bf16"), ("f32", "int8"), ("bf16", "f32")]


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (50.0, 100)])
@pytest.mark.parametrize("T,G", [(1, 2), (4, 2), (2, 8)])
@pytest.mark.parametrize("hd", [256, 128, 96])
@pytest.mark.parametrize("q,kv", _MIXED, ids=[f"{q}-{kv}" for q, kv in _MIXED])
@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_float32_and_mixed_match_plain(cuda, form, q, kv, hd, T, G, softcap,
                                                    window):
    """Every decode form with float32 q at head dim 256 (one tile for K and
    then V), 128 and 96, over a float32, a bfloat16 or an int8 cache, and
    bfloat16 q over a float32 cache (computed in float32, as the JAX kernel
    does); prefixes on both sides of chunk edges and the cache's last
    position; every row no query may see NaN. Tolerance 1e-4 of max|out|
    for a float32 output (fast exp, another order of sums), 2^-7 for a
    bfloat16 one (one rounding of the output)."""
    qdt = torch.float32 if q == "f32" else torch.bfloat16
    pages = 33 if hd == 256 else 9
    pos = (*_POS_256, pages * PAGE - T) if hd == 256 else None
    before = dict(_build.launches)
    got, want, count = _decode_case(form, kv, T, G, seed=hd + T * 10 + G, softcap=softcap,
                                    window=window, pos=pos, poison=True, hd=hd,
                                    n_slot_pages=pages, q_dtype=qdt)
    torch.cuda.synchronize()
    assert _build.launches[count] == before.get(count, 0) + 1
    assert got.dtype == qdt and torch.isfinite(got.float()).all()
    assert _rel(got, want) <= (1e-4 if q == "f32" else 2.0 ** -7)


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("form", _FORMS)
def test_decode_forms_float32_hd256_are_deterministic_and_replay(cuda, form, kv):
    """Float32 q at head dim 256 over each cache: two calls give the same
    bits, and a captured graph replays at other positions bit for bit."""
    one, _, _ = _decode_case(form, kv, 4, 2, seed=3, window=100, hd=256, pos=(0, 129, 700, 1000),
                             q_dtype=torch.float32)
    two, _, _ = _decode_case(form, kv, 4, 2, seed=3, window=100, hd=256, pos=(0, 129, 700, 1000),
                             q_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    _replay_case(cuda, form, kv, 256, 2, softcap=50.0, window=300, q_dtype=torch.float32)


# ---------------------------------------------------------------------------
# the float32 mixture of experts: the grouped float32 dequant forms
# (csrc/qmm_f32.cu's grouped entries) and qmm_w8_grouped on float32 x; and
# flash at head dim 16 (the committed HF fixtures)
# ---------------------------------------------------------------------------

def _f32_stack(kind, E, m, k, seed):
    """E random distinct (m, k) experts of `kind` as one stack (E, m, k),
    kernel planes with float32 scales (as the Runner loads them under
    float32 compute)."""
    return _distinct_experts(to_kernel_layout(
        to_planar(kind, _scheme_raw(kind, E * m * k, k, seed), (E, m, k), "cuda"), torch.float32))


def _f32_grouped_case(kind, qt, xs, off):
    """The float32 grouped form against its plain version (1e-5 of max|out|:
    the same float32 weights, float32 sums in another order), counted once
    under `<form>_grouped.f32`; every row written; two calls bit for bit;
    and each segment equal to the dense float32 form on its own plane, bit
    for bit (the same tile loop, the same order of sums)."""
    name = gemm_quant.GROUPED_FORMS[FORM_KIND[kind]]
    fn = getattr(gemm_quant, name)
    plain = getattr(gemm_quant, f"{name}_plain")
    before = _build.launches[f"{name}.f32"]
    got = fn(xs, qt, off)
    want = plain(xs, *(qt.planes[n] for n in gemm_quant._KERNEL_PLANES[FORM_KIND[kind]]), off)
    torch.cuda.synchronize()
    assert _build.launches[f"{name}.f32"] == before + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-5
    assert torch.equal(fn(xs, qt, off), got)
    dense = getattr(gemm_quant, gemm_quant.DEQUANT_FORMS[FORM_KIND[kind]])
    cuts = off.tolist()
    for e, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
        if hi > lo:
            assert torch.equal(dense(xs[lo:hi], plane_of(qt, e)), got[lo:hi]), e
    return got


@ALL_KINDS
@pytest.mark.parametrize("counts", [(0, 13, 40, 64), (0, 0, 130, 1), (0, 300, 0, 0),
                                    (1, 37, 0, 129), (64, 64, 8, 65), (0, 65, 63, 0, 7, 1, 0, 200)])
def test_f32_grouped_matches_plain(cuda, kind, counts):
    """The float32 grouped forms of every kind at empty segments (expert 0
    empty in most cases), segments shorter than the 64-row tile, one row
    over a tile and exact tiles, a 1-row and a 37-row segment, every row on
    one expert above 0, and 8 experts; 320 columns (off the 128-wide tile)
    and k = 768."""
    E, m, k = len(counts), 320, 768
    qt = _f32_stack(kind, E, m, k, sum(counts) + E)
    _f32_grouped_case(kind, qt, _f32_x(sum(counts), k, 5), _offsets(counts))


@pytest.mark.parametrize("kind", [GGMLType.Q4_K, GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q5_K,
                                  GGMLType.Q4_0, GGMLType.Q3_K, GGMLType.Q2_K, GGMLType.Q5_0],
                         ids=["q4_k", "q8_0", "q6_k", "q5_k", "q4_0", "q3_k", "q2_k", "q5_0"])
@pytest.mark.parametrize("m,k", [(2 * 14336, 4096), (4096, 14336)], ids=["gate_up", "down"])
def test_f32_grouped_at_mixtral_shapes(cuda, kind, m, k):
    """The 1,024 (row, slot) pairs of a 512-token Mixtral chunk over 8
    experts (expert 0 empty, ragged segments) at the experts' gate|up and
    down shapes, in float32."""
    qt = _f32_stack(kind, 8, m, k, m + k)
    _f32_grouped_case(kind, qt, _f32_x(sum(_MIXTRAL_COUNTS), k, 7), _offsets(_MIXTRAL_COUNTS))


@EVERY_VALUE_KINDS
def test_f32_grouped_takes_every_value_of_each_expert(cuda, kind):
    """A stack of the every-value planes with float32 scales that use the
    bits bfloat16 drops, each expert's own; one-hot rows of x on each
    expert's segment return that expert's exact float32 weights as the three
    TF32 passes take them (hi + lo of `tf32_split`), bit for bit: a form
    that read another expert's values or scales would not."""
    E, m, k = 4, 256, 512
    qt = _every_value_stack(kind, E, m, k)
    qt = QTensor(kind, qt.shape, {n: t.float() * (1 + 2.0 ** -13) if n in ("dsub", "msub") else t
                                  for n, t in qt.planes.items()})
    fn = getattr(gemm_quant, gemm_quant.GROUPED_FORMS[FORM_KIND[kind]])
    xs = torch.eye(k, device=cuda).repeat(E, 1)
    got = fn(xs, qt, _offsets((k,) * E))
    torch.cuda.synchronize()
    for e in range(E):
        hi, lo = gemm_quant.tf32_split(dequantize(plane_of(qt, e)))
        assert torch.equal(got[e * k:(e + 1) * k], (hi + lo).t()), e


@pytest.mark.parametrize("kind", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q2_K],
                         ids=["q4_k", "q6_k", "q2_k"])
def test_f32_grouped_replays_in_a_cuda_graph(cuda, kind):
    """The float32 grouped form captures in a CUDA graph (it reads the
    offsets on the device): a replay equals the eager call bit for bit, and
    after x and the offsets change in place equals the eager call on them."""
    qt = _f32_stack(kind, 4, 512, 1024, 9)
    fn = getattr(gemm_quant, gemm_quant.GROUPED_FORMS[FORM_KIND[kind]])
    x = _f32_x(150, 1024, 1)
    off = _offsets((0, 70, 1, 79))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(x, qt, off)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(x, qt, off)
    for new_x, new_off in ((2, (10, 60, 0, 80)), (3, (150, 0, 0, 0))):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fn(x, qt, off))
        x.copy_(_f32_x(150, 1024, new_x))
        off.copy_(_offsets(new_off))


def test_f32_grouped_forms_raise_rather_than_fall_back(cuda):
    """float32 x over a stack with bfloat16 scale planes, bfloat16 out of
    the float32 form, float16 x, offsets of another length: each refused
    before any launch."""
    bf = _scheme_stack(GGMLType.Q8_0, 4, 256, 512, 3)
    f32 = _f32_stack(GGMLType.Q8_0, 4, 256, 512, 3)
    x = _f32_x(40, 512, 3)
    off = _offsets((0, 10, 30, 0))
    before = dict(_build.launches)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_q8_0_grouped(x, bf, off)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_q8_0_grouped(x, f32, off, torch.bfloat16)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_q8_0_grouped(x.half(), f32, off)
    with pytest.raises(UnsupportedError):
        gemm_quant.qmm_q8_0_grouped(x, f32, off[:4])
    assert dict(_build.launches) == before


def test_f32_qmm_w8_grouped_rounds_x_to_bfloat16(cuda):
    """qmm_w8_grouped on float32 x: the bfloat16 kernel on x rounded once,
    float32 out, as the JAX package's qmatmul_grouped runs its W8 route;
    bit for bit the call on the rounded x; qmatmul_grouped routes float32
    x there with W8 planes and to the float32 dequant form without."""
    qt = gemm_quant.augment_w8(_f32_stack(GGMLType.Q4_K, 4, 256, 1024, 5))
    x = _f32_x(300, 1024, 3)
    off = _offsets((0, 120, 100, 80))
    got = gemm_quant.qmm_w8_grouped(x, qt, off, torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(got, gemm_quant.qmm_w8_grouped(x.to(torch.bfloat16), qt, off))
    assert torch.equal(gemm_quant.qmatmul_grouped(x, qt, off, w8=True), got)
    before = _build.launches["qmm_q4k_grouped.f32"]
    gemm_quant.qmatmul_grouped(x, qt, off, w8=False)
    assert _build.launches["qmm_q4k_grouped.f32"] == before + 1


def test_moe_ffn_float32_on_the_card_matches_its_plain_version(cuda):
    """moe_ffn in float32 on the card (a 4-expert Q4_K stack with float32
    scales): 100 rows through the grouped float32 forms and 8 through the
    plane forms' float32 entries, against the same function on the CPU
    (the plain versions). Tolerance 1e-4 of max|out| for the grouped rows
    (float32 weights on both sides, sums in another order) and 3e-2 for the
    plane rows (int8 codes of float32 activations whose sums differ in
    order may round apart at an edge)."""
    from crabml_tpu_torch.models.config import ModelConfig
    from crabml_tpu_torch.models.forward import moe_ffn

    D, HD, E = 512, 1024, 4
    cfg = ModelConfig(architecture="llama", model_name="m", embedding_dim=D, hidden_dim=HD,
                      n_layers=1, n_heads=4, n_kv_heads=4, vocab_size=256, seq_len=256,
                      rms_norm_eps=1e-5, n_experts=E, n_experts_used=2)
    g = torch.Generator().manual_seed(3)
    router = torch.randn(E, D, generator=g)
    raw = {"wgu_exps": (_scheme_raw(GGMLType.Q4_K, E * 2 * HD * D, D, 4), (E, 2 * HD, D)),
           "ffn_down_exps": (_scheme_raw(GGMLType.Q4_K, E * D * HD, HD, 5), (E, D, HD))}
    lw_cpu, lw_card = ({"ffn_gate_inp": router.to(dev),
                        **{n: to_kernel_layout(to_planar(GGMLType.Q4_K, b, shape, dev),
                                               torch.float32) for n, (b, shape) in raw.items()}}
                       for dev in ("cpu", cuda))
    for rows, tol, name in ((100, 1e-4, "qmm_q4k_grouped.f32"), (8, 3e-2, "qmm_w4a8.planes.f32")):
        x = torch.randn(rows, D, generator=g)
        before = _build.launches[name]
        got = moe_ffn(lw_card, x.to(cuda), cfg)
        torch.cuda.synchronize()
        assert _build.launches[name] > before
        assert got.dtype == torch.float32
        assert _rel(got.cpu(), moe_ffn(lw_cpu, x, cfg)) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,G,pos0,softcap,window", [
    (16, 2, 0, 0.0, 0), (16, 2, 0, 50.0, 8), (1, 2, 15, 0.0, 0), (1, 2, 15, 50.0, 8),
    (100, 1, 0, 0.0, 0), (189, 4, 512, 0.0, 0), (512, 4, 512, 0.0, 256),
    (512, 4, 512, 50.0, 256), (65, 7, 37, 30.0, 31), (9, 16, 300, 0.0, 0)])
def test_flash_attention_hd16_matches_plain(cuda, dtype, T, G, pos0, softcap, window):
    """Head dim 16 on the 64 kernel's tiles (two 16-byte chunks of a
    64-element row copied, one k16 step for the scores, P V's lanes past 16
    never stored) and in float32 at its own width: the HF fixtures' shapes
    (16 tokens at pos 0, one at pos 15, 2 q heads a kv head, their window 8
    and softcap 50), ragged T, a window that skips key tiles, G up to 16.
    Tolerances as at the other head dims; two calls give the same bits."""
    B, KV, S, hd = 2, 2, 1024, 16
    q = torch.randn(B, T, KV * G, hd, device=cuda).to(dtype)
    k = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    v = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    pos = torch.tensor([pos0, pos0 // 2], dtype=torch.int32, device=cuda)
    before = _build.launches["flash_attention"]
    got = flash_attention(q, k, v, pos, hd ** -0.5, softcap, window)
    want = flash_attention_plain(q, k, v, pos, hd ** -0.5, softcap, window)
    torch.cuda.synchronize()
    assert _build.launches["flash_attention"] == before + 1
    assert got.shape == (B, T, KV * G * hd)
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4)
    assert torch.equal(got, flash_attention(q, k, v, pos, hd ** -0.5, softcap, window))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [0, 8, 200])
def test_flash_attention_hd16_ignores_rows_past_the_prefix(cuda, dtype, window):
    """Cache rows past pos + T and before the first row's window hold NaN:
    masked keys that must not reach the output (a probability of 0 times a
    NaN is NaN). 4 / 2 heads as the fixtures; a store past a head's 16
    lanes would land on the next head's."""
    B, T, KV, G, S, p0, hd = 1, 189, 2, 2, 1024, 512, 16
    q = torch.randn(B, T, KV * G, hd, device=cuda).to(dtype)
    k = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    v = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    pos = torch.tensor([p0], dtype=torch.int32, device=cuda)
    want = flash_attention_plain(q, k, v, pos, hd ** -0.5, 0.0, window)
    k[:, :, p0 + T:], v[:, :, p0 + T:] = float("nan"), float("nan")
    if window:
        k[:, :, :p0 + 1 - window], v[:, :, :p0 + 1 - window] = float("nan"), float("nan")
    got = flash_attention(q, k, v, pos, hd ** -0.5, 0.0, window)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4)


def test_flash_attention_hd16_replays_in_a_cuda_graph(cuda):
    """The decode step at hd 16 attends through flash over the whole cache
    with pos on the device: a captured launch replays to the eager call's
    bits, and after pos and the cache change in place to the eager call on
    them."""
    B, KV, G, S, hd = 3, 2, 2, 256, 16
    q = torch.randn(B, 1, KV * G, hd, device=cuda)
    k = torch.randn(B, KV, S, hd, device=cuda)
    v = torch.randn(B, KV, S, hd, device=cuda)
    pos = torch.tensor([15, 0, 200], dtype=torch.int32, device=cuda)
    call = lambda: flash_attention(q, k, v, pos, 0.25, 50.0, 8)  # noqa: E731
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, call())
        pos.add_(1)
        k.mul_(1.5)


# -- every head dim a multiple of 8 up to 256 (stories260K's 8, stories15M's 48) --
# the head dims off the three full tile widths (64, 128, 256): each class of
# lanes a tile row holds past hd (8 to 56 on 64, 72 to 120 on 128, 136 to 248
# on 256), odd multiples of 8 (the score product's last k16 step half zeros)
ANY_HD = [8, 24, 32, 40, 48, 56, 72, 88, 104, 112, 120, 136, 152, 176, 200, 216, 240, 248]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", ANY_HD)
@pytest.mark.parametrize("T,G,pos0,softcap,window", [
    (100, 1, 0, 0.0, 0), (129, 2, 300, 0.0, 64), (9, 2, 383, 50.0, 300), (65, 7, 5, 30.0, 0),
    (1, 1, 255, 0.0, 0)])
def test_flash_attention_any_head_dim_matches_plain(cuda, dtype, hd, T, G, pos0, softcap, window):
    """Every class of head dim below its tile width: hd / 8 chunks of a row
    copied and the rest zero-filled, ceil(hd / 16) k16 score steps, output
    lanes past hd never stored; the float32 kernel at 16 * ceil(hd / 16)
    lanes. Ragged T, 1 to 7 q heads a kv head, softcaps, a window that skips
    key tiles, a decode step over the whole cache. Tolerances as at 128; two
    calls give the same bits."""
    B, KV, S = 2, 2, 512
    q = torch.randn(B, T, KV * G, hd, device=cuda).to(dtype)
    k = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    v = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    pos = torch.tensor([pos0, pos0 // 2], dtype=torch.int32, device=cuda)
    before = _build.launches["flash_attention"]
    got = flash_attention(q, k, v, pos, hd ** -0.5, softcap, window)
    want = flash_attention_plain(q, k, v, pos, hd ** -0.5, softcap, window)
    torch.cuda.synchronize()
    assert _build.launches["flash_attention"] == before + 1
    assert got.shape == (B, T, KV * G * hd)
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4)
    assert torch.equal(got, flash_attention(q, k, v, pos, hd ** -0.5, softcap, window))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [8, 24, 48, 136, 248])
@pytest.mark.parametrize("window", [0, 200])
def test_flash_attention_any_head_dim_ignores_rows_past_the_prefix(cuda, dtype, hd, window):
    """Cache rows past pos + T and before the first row's window hold NaN:
    masked keys that must not reach the output (a probability of 0 times a
    NaN is NaN). A store past a head's hd lanes would land on the next
    head's first lanes."""
    B, T, KV, G, S, p0 = 1, 189, 2, 2, 1024, 300
    q = torch.randn(B, T, KV * G, hd, device=cuda).to(dtype)
    k = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    v = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
    pos = torch.tensor([p0], dtype=torch.int32, device=cuda)
    want = flash_attention_plain(q, k, v, pos, hd ** -0.5, 0.0, window)
    k[:, :, p0 + T:], v[:, :, p0 + T:] = float("nan"), float("nan")
    if window:
        k[:, :, :p0 + 1 - window], v[:, :, :p0 + 1 - window] = float("nan"), float("nan")
    got = flash_attention(q, k, v, pos, hd ** -0.5, 0.0, window)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("hd,G", [(8, 2), (48, 1)])
def test_flash_attention_any_head_dim_replays_in_a_cuda_graph(cuda, hd, G):
    """stories260K's and stories15M's decode step attends through flash over
    the whole cache with pos on the device: a captured launch replays to
    the eager call's bits, also after pos and the cache change in place."""
    B, KV, S = 3, 2, 256
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(B, 1, KV * G, hd, device=cuda).to(dtype)
        k = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
        v = torch.randn(B, KV, S, hd, device=cuda).to(dtype)
        pos = torch.tensor([15, 0, 200], dtype=torch.int32, device=cuda)
        call = lambda: flash_attention(q, k, v, pos, hd ** -0.5)  # noqa: E731
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, call())
            pos.add_(1)
            k.mul_(1.5)


# -- legacy rows off the 256-element superblock (stories15M's 288 and 768) ---------

PADDED_KINDS = pytest.mark.parametrize(
    "kind", [GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q5_0, GGMLType.Q4_1, GGMLType.Q5_1,
             GGMLType.Q8_1], ids=["q8_0", "q4_0", "q5_0", "q4_1", "q5_1", "q8_1"])
# stories15M's matrices: q|k|v (864, 288), wo (288, 288), gate|up (1536, 288),
# down (288, 768), and a lm_head of 512 rows; 800 = 25 blocks of 32
PADDED_SHAPES = [(864, 288), (288, 288), (1536, 288), (288, 768), (512, 800)]


def _padded_weight(kind, m, k, seed, scale_dtype=torch.bfloat16):
    qt = to_kernel_layout(to_planar(kind, _scheme_raw(kind, m * k, k, seed), (m, k), "cuda"),
                          scale_dtype)
    assert qt.k == k and qt.plane_k == -(-k // 256) * 256
    return qt


def _padded_x(x, qt):
    return torch.nn.functional.pad(x, (0, qt.plane_k - qt.k))


@PADDED_KINDS
@pytest.mark.parametrize("m,k", PADDED_SHAPES)
@pytest.mark.parametrize("rows", [17, 189])
def test_padded_dequant_matmul_matches_plain(cuda, kind, m, k, rows):
    """The dequant form on planes zero-padded to whole superblocks, x of the
    weight's own depth (the wrapper pads it): tolerance 1e-4 of max|out|
    against the plain version on padded x, and within 1e-4 of the product
    with the dequantized weight of logical shape, so the padded tail adds
    nothing."""
    qt = _padded_weight(kind, m, k, rows + m)
    x = _x(rows, k, m)
    name, plain = _dequant_of(kind)
    kernel = getattr(gemm_quant, name)
    before = _build.launches[name]
    got = kernel(x, qt)
    want = plain(_padded_x(x, qt), qt.planes)
    dense = x.float() @ dequantize(qt, torch.bfloat16).float().t()
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    assert got.shape == (rows, m) and torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4 and _rel(got, dense) <= 1e-4
    assert torch.equal(kernel(_padded_x(x, qt), qt), got)
    assert torch.equal(gemm_quant.qmatmul_quant(x, qt), got.to(torch.bfloat16))


@PADDED_KINDS
@pytest.mark.parametrize("m,k", PADDED_SHAPES)
@pytest.mark.parametrize("rows", [1, 8, 16])
def test_padded_w4a8_matches_plain(cuda, kind, m, k, rows):
    """The int8-activation form on padded planes: the quantizer gives the
    all-zero groups of the padded x zero codes and a zero scale, the padded
    weights have zero scales; tolerance 1e-4 of max|out| against the plain
    version; two calls bit for bit."""
    qt = _padded_weight(kind, m, k, rows + m)
    x = _x(rows, k, m)
    name = gemm_quant.W4A8_FORMS[FORM_KIND[kind]]
    before = _build.launches[name]
    got = gemm_quant.qmm_w4a8(x, qt)
    want = _w4a8_plain_of(kind)(_padded_x(x, qt), qt.planes)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    assert got.shape == (rows, m) and torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4
    assert torch.equal(gemm_quant.qmm_w4a8(x, qt), got)
    assert torch.equal(gemm_quant.qmatmul_quant(x, qt), got.to(torch.bfloat16))


@PADDED_KINDS
@pytest.mark.parametrize("m,k", [(1536, 288), (288, 768)])
@pytest.mark.parametrize("rows", [1, 16, 189])
def test_padded_f32_forms_match_plain(cuda, kind, m, k, rows):
    """The float32 forms (csrc/qmm_f32.cu at 189 rows, qmm_w4a8's _f32 entry
    at 1 and 16) on padded planes with float32 scales: tolerances 1e-5 and
    1e-4 of max|out| as at whole superblocks."""
    qt = _padded_weight(kind, m, k, rows + m, torch.float32)
    x = _f32_x(rows, k, m)
    got = gemm_quant.qmatmul_quant(x, qt)
    xp = _padded_x(x, qt)
    if rows > gemm_quant.W4A8_MAX_ROWS:
        want, tol = _dequant_of(kind)[1](xp, qt.planes), 1e-5
    else:
        want, tol = _w4a8_plain_of(kind)(xp, qt.planes), 1e-4
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (rows, m) and torch.isfinite(got).all()
    assert _rel(got, want) <= tol


@PADDED_KINDS
@pytest.mark.parametrize("m,k", [(1536, 288), (256, 768)])
def test_padded_w8_matches_plain(cuda, kind, m, k):
    """The W8 planes of a padded weight (made from its dequantized logical
    weight, k padded to a multiple of 512) at 300 rows: x of the weight's
    depth or of its padded planes' both take them; tolerance 1e-4."""
    qt = gemm_quant.augment_w8(_padded_weight(kind, m, k, 3))
    assert "w8" in qt.planes and qt.planes["w8"].shape == (m, -(-k // 512) * 512)
    x = _x(300, k, 4)
    before = _build.launches["qmm_w8"]
    got = gemm_quant.qmm_w8(x, qt)
    want = gemm_quant.qmm_w8_plain(x, qt.planes["w8"], qt.planes["dw"])
    torch.cuda.synchronize()
    assert _build.launches["qmm_w8"] == before + 1
    assert _rel(got, want) <= 1e-4
    assert torch.equal(gemm_quant.qmm_w8(_padded_x(x, qt), qt), got)
    assert torch.equal(gemm_quant.qmatmul_quant(x, qt), got.to(torch.bfloat16))


@pytest.mark.parametrize("kind", [GGMLType.Q4_0, GGMLType.Q8_0], ids=["q4_0", "q8_0"])
def test_padded_w4a8_replays_in_a_cuda_graph(cuda, kind):
    """The decode step's padded matmul (the pad, the quantizer and the
    matmul) captured in a CUDA graph replays to the eager call's bits, also
    after x changes in place."""
    qt = _padded_weight(kind, 1536, 288, 5)
    x = _x(1, 288, 6)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gemm_quant.qmatmul_quant(x, qt)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gemm_quant.qmatmul_quant(x, qt)
    for seed in (7, 8):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, gemm_quant.qmatmul_quant(x, qt))
        x.copy_(_x(1, 288, seed))


def test_f32_tensor_core_flash_layout_matches_the_plan(cuda):
    """The float32 flash kernel's plan (csrc/flash_attention.cu's F32Plan, read
    through its flash_f32_layout entry) is ops/cuda/flash_attention.py's
    flash_f32_plan at every head dim the card takes, which the CPU tests hold
    to the shared-memory limit and the grid's rows."""
    import ctypes

    from crabml_tpu_torch.ops.cuda import flash_attention as fa

    fn = _build.library("flash_attention").flash_f32_layout
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    for hd in fa.HEAD_DIMS:
        for T in (16, 4096):  # one warpgroup a block, and two where the width allows
            p = fa.flash_f32_plan(hd, T, 4, 8)
            got = (ctypes.c_int * 6)()
            assert fn(hd, p.warpgroups, got) == 0
            assert list(got) == [p.tile_width, p.keys, p.warpgroups, p.stages, p.smem_bytes,
                                 p.rows_per_block], (hd, T)
        assert fn(hd, 2, got) != 0 if hd > 128 else fn(hd, 2, got) == 0


@pytest.mark.parametrize("hd,G,T,pos0,softcap,window", [
    (8, 2, 100, 37, 0.0, 0), (48, 1, 256, 0, 0.0, 0), (80, 1, 189, 5, 0.0, 0),
    (128, 4, 189, 512, 0.0, 0), (128, 7, 130, 37, 0.0, 0), (200, 4, 65, 300, 30.0, 100),
    (256, 2, 257, 37, 50.0, 100), (96, 64, 3, 12, 0.0, 0)])
def test_f32_tensor_core_flash_matches_the_split_model(cuda, hd, G, T, pos0, softcap, window):
    """The float32 kernel (three TF32 passes a product) within 1e-4 of
    max|out| of the exact plain version and of the plain model of its
    arithmetic (`flash_attention_split_plain`), at each tile width, G up to
    64, ragged T, windows and softcaps; two calls give the same bits."""
    from crabml_tpu_torch.ops.cuda.flash_attention import flash_attention_split_plain

    B, KV, S = 2, 2, 768  # pos + T <= S
    q = torch.randn(B, T, KV * G, hd, device=cuda)
    k = torch.randn(B, KV, S, hd, device=cuda)
    v = torch.randn(B, KV, S, hd, device=cuda)
    pos = torch.tensor([0, pos0], dtype=torch.int32, device=cuda)
    got = flash_attention(q, k, v, pos, hd ** -0.5, softcap, window)
    want = flash_attention_plain(q, k, v, pos, hd ** -0.5, softcap, window)
    model = flash_attention_split_plain(q, k, v, pos, hd ** -0.5, softcap, window)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-4
    assert _rel(got, model) <= 1e-4
    assert torch.equal(got, flash_attention(q, k, v, pos, hd ** -0.5, softcap, window))


def test_f32_tensor_core_flash_holds_4096_keys(cuda):
    """T 512 at pos 3,584 of a 4,096-row cache (the 7B's last chunk, 4 q heads
    a kv head, hd 128): a row's sums run over up to 4,096 keys, through the
    tensor cores' float32 accumulation; within 1e-4 of max|out| of the exact
    plain version."""
    q = torch.randn(1, 512, 8, 128, device=cuda)
    k = torch.randn(1, 2, 4096, 128, device=cuda)
    v = torch.randn(1, 2, 4096, 128, device=cuda)
    pos = torch.tensor([3584], dtype=torch.int32, device=cuda)
    got = flash_attention(q, k, v, pos, 128 ** -0.5)
    want = flash_attention_plain(q, k, v, pos, 128 ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4


def _norm_case(kind, rows, n, dtype, seed, qk_heads=0):
    """x (rows, n) in `dtype`, its weight ((n,), or (qk_heads, n) for a qwen3
    per-head norm) and phi2's bias, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((rows, n)) * 3 + 0.5).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((qk_heads, n) if qk_heads else n).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)) if kind == "layer" else None
    to = lambda t: None if t is None else t.cuda()  # noqa: E731
    return to(x).to(dtype), to(w), to(b)


def _apply_norm(kind, x, w, b, plain=False):
    from crabml_tpu_torch.ops.cuda import norm

    if kind == "rms":
        return (norm.rms_norm_plain if plain else norm.rms_norm)(x, w, 1e-5)
    return (norm.layer_norm_plain if plain else norm.layer_norm)(x, w, 1e-5, b)


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [4096, 2560, 288, 64, 10240])
def test_norm_is_batch_invariant(cuda, kind, dtype, n):
    """A row's norm has the same bits whatever else the call holds: alone
    (B = 1, a decode step), in a batch of 2 and 8 (the engines' ticks) and
    in a 512-row prefill chunk. torch's float32 mean reduces in an order
    that depends on the row count; csrc/norm.cu sums a row in one order
    (in registers up to 8,192 a row, from memory at 10,240)."""
    x, w, b = _norm_case(kind, 512, n, dtype, n + (dtype == torch.bfloat16))
    whole = _apply_norm(kind, x, w, b)
    for B in (1, 2, 8):
        for start in (0, 3, 511 - B + 1):
            part = _apply_norm(kind, x[start:start + B].clone(), w, b)
            assert torch.equal(part, whole[start:start + B]), (B, start)
    # (B, T, D) as the forward passes it: T = 1 against T = 512
    seq = _apply_norm(kind, x.reshape(1, 512, n), w, b)
    assert torch.equal(seq.reshape(512, n), whole)
    assert torch.equal(_apply_norm(kind, x[None, 5:6], w, b)[0], whole[5:6])


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n", [(1, 4096), (8, 4096), (512, 4096), (189, 3584),
                                    (17, 3072), (3, 2560), (40, 288), (7, 64), (2, 8),
                                    (5, 10240)])
def test_norm_matches_plain(cuda, kind, dtype, rows, n):
    """The kernel against the plain version on the same inputs: float32
    within 2e-6 of max|out| (the same arithmetic, the row's sum in another
    order and the squares fused into fma: a relative change of the variance
    of a few ulps, half as much in its root); a bfloat16 output within one
    bfloat16 ulp (at most 2^-7 of the value) of the plain one, which rounds
    the same float32 value up to those ulps, plus those ulps themselves
    (2e-6 of max|out|), which decide the rounding of a LayerNorm output that
    the bias nearly cancels."""
    x, w, b = _norm_case(kind, rows, n, dtype, 7 * rows + n)
    got = _apply_norm(kind, x, w, b)
    want = _apply_norm(kind, x, w, b, plain=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        assert _rel(got, want) <= 2e-6
    else:
        diff = (got.float() - want.float()).abs()
        ref = want.float().abs()
        assert (diff <= ref * 2.0 ** -7 + 2e-6 * ref.max()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_takes_qwen3_per_head_weights(cuda, dtype):
    """qwen3's fused q|k norm: x (B, T, H + KV, hd), a strided view of the
    q|k|v projection, and one weight row a head (row r takes weight row
    r % (H + KV)); against the plain version, and batch invariant."""
    from crabml_tpu_torch.ops.cuda import norm

    B, T, H, KV, hd = 2, 9, 8, 2, 128
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((B, T, (H + 2 * KV) * hd)).astype(np.float32))
    qkv = qkv.cuda().to(dtype)
    w = torch.from_numpy(rng.standard_normal((H + KV, hd)).astype(np.float32)).cuda()
    qk = qkv[..., : (H + KV) * hd].reshape(B, T, H + KV, hd)
    got = norm.rms_norm(qk, w, 1e-6)
    want = norm.rms_norm_plain(qk, w, 1e-6)
    assert got.shape == qk.shape
    if dtype == torch.float32:
        assert _rel(got, want) <= 2e-6
    else:
        ref = want.float().abs()
        assert ((got.float() - want.float()).abs() <= ref * 2.0 ** -7 + 2e-6 * ref.max()).all()
    assert torch.equal(norm.rms_norm(qk[1:, 4:5], w, 1e-6), got[1:, 4:5])


def test_norm_counts_and_refuses(cuda):
    """One launch a call, counted under its name; a weight that is not x's
    trailing shape and a float16 x are refused, not sent to the plain
    version."""
    from crabml_tpu_torch.ops.cuda import norm

    x = torch.randn(4, 256, device=cuda)
    w = torch.randn(256, device=cuda)
    before = dict(_build.launches)
    norm.rms_norm(x, w, 1e-5)
    norm.layer_norm(x, w, 1e-5, w)
    assert _build.launches["rms_norm"] == before.get("rms_norm", 0) + 1
    assert _build.launches["layer_norm"] == before.get("layer_norm", 0) + 1
    with pytest.raises(UnsupportedError):
        norm.rms_norm(x, torch.randn(128, device=cuda), 1e-5)
    with pytest.raises(UnsupportedError):
        norm.rms_norm(x.half(), w, 1e-5)


def test_norm_replays_in_a_cuda_graph(cuda):
    """Captured in a CUDA graph and replayed on new inputs, the kernel gives
    the eager call's bits."""
    from crabml_tpu_torch.ops.cuda import norm

    x = torch.randn(2, 4096, device=cuda)
    w = torch.randn(4096, device=cuda)
    norm.rms_norm(x, w, 1e-5)  # builds and loads the library outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = norm.rms_norm(x, w, 1e-5)
    for seed in range(3):
        x.copy_(torch.from_numpy(np.random.default_rng(seed).standard_normal((2, 4096))
                                 .astype(np.float32)))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, norm.rms_norm(x, w, 1e-5))


# ---------------------------------------------------------------------------
# csrc/qmm_ws.cuh: the warp-specialized loop of qmm_q5k, qmm_q6k, qmm_q3k and
# qmm_q2k (and the Q5_1 weights that run qmm_q5k), at the shapes whose tile
# heights its launch plan tells apart, every tile height it may pick, and rows
# whose sums do not depend on the launch they share
# ---------------------------------------------------------------------------

WS_KINDS = pytest.mark.parametrize("kind", [GGMLType.Q5_K, GGMLType.Q3_K, GGMLType.Q5_1,
                                            GGMLType.Q6_K, GGMLType.Q2_K],
                                   ids=["q5_k", "q3_k", "q5_1", "q6_k", "q2_k"])
# the four forms on the loop, each once
WS_FORMS = pytest.mark.parametrize("kind", [GGMLType.Q5_K, GGMLType.Q3_K, GGMLType.Q6_K,
                                            GGMLType.Q2_K], ids=["q5_k", "q3_k", "q6_k", "q2_k"])


@WS_KINDS
@pytest.mark.parametrize("rows,m,k", [(512, 6144, 4096), (512, 4096, 14336), (189, 6144, 4096),
                                       (1024, 6144, 4096), (17, 6144, 4096), (37, 6144, 4096),
                                       (189, 4096, 4096), (100, 320, 1280)])
def test_ws_forms_at_the_plans_shapes(cuda, kind, rows, m, k):
    """Tolerance 1e-4 of max|out|: the same bf16 weights, float32 sums in
    another order; one launch counted; the bf16 output the float32 one
    rounded once. The shapes are the 7B's q|k|v, wo and down at the rows
    whose tile heights the plan tells apart (256, 128, 96, 64, 48 and 24 rows),
    and a weight of 2.5 tiles at a depth of 5 superblocks."""
    qt = _scheme_weight(kind, m, k, rows + m)
    x = _x(rows, k, k + rows)
    name, plain = _dequant_of(kind)
    kernel = getattr(gemm_quant, name)
    before = _build.launches[name]
    got = kernel(x, qt)
    want = plain(x, qt.planes)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-4
    assert torch.equal(kernel(x, qt, torch.bfloat16), got.to(torch.bfloat16))


def _ws_entry(kind):
    """The dense C entry of a form on csrc/qmm_ws.cuh, taking any tile height."""
    return gemm_quant._lib_dequant(FORM_KIND[kind])[1]


@WS_FORMS
@pytest.mark.parametrize("tile", gemm_quant.WS_TILE_ROWS)
def test_ws_every_tile_height(cuda, kind, tile):
    """Every tile height the plan may pick, on 300 rows (whole tiles and a
    ragged last one: every wgmma width the heights lead to) and 200 columns:
    the plain version's numbers (1e-4 of max|out|), and the same bits as the
    plan's own launch (a row's sums do not depend on its tile)."""
    m, k, rows = 200, 512, 300
    qt = _scheme_weight(kind, m, k, tile)
    x = _x(rows, k, tile + 1)
    name, plain = _dequant_of(kind)
    planes = [qt.planes[n] for n in gemm_quant._KERNEL_PLANES[FORM_KIND[kind]]]
    out = torch.empty(rows, m, dtype=torch.float32, device=cuda)
    err = _ws_entry(kind)(x.data_ptr(), *(t.data_ptr() for t in planes), out.data_ptr(), 0, rows,
                          m, k, tile, _build.stream_ptr(x))
    assert err == 0
    want = plain(x, qt.planes)
    torch.cuda.synchronize()
    assert _rel(out, want) <= 1e-4
    assert torch.equal(out, getattr(gemm_quant, name)(x, qt))


@WS_FORMS
def test_ws_rows_do_not_depend_on_their_launch(cuda, kind):
    """A row's output is the same bits at 1, 17, 37, 189, 512 and 1,024 rows:
    each output element is one wgmma chain over k in order, whatever tile
    height the plan picks."""
    m, k = 6144, 4096
    qt = _scheme_weight(kind, m, k, 77)
    x = _x(1024, k, 78)
    fn = getattr(gemm_quant, gemm_quant.DEQUANT_FORMS[FORM_KIND[kind]])
    full = fn(x, qt)
    for rows in (1, 17, 37, 189, 512):
        assert torch.equal(fn(x[:rows].contiguous(), qt), full[:rows]), rows


@WS_KINDS
@pytest.mark.parametrize("m,k", [(2 * 14336, 4096), (4096, 14336)], ids=["gate_up", "down"])
def test_ws_grouped_on_edge_segments(cuda, kind, m, k):
    """The grouped form at the Mixtral experts' shapes on segments with an
    empty and a one-row one (chip_smoke.py's EDGE_COUNTS), each segment equal
    to the dense form on its plane bit for bit."""
    qt = _scheme_stack(kind, 8, m, k, m + k + 5)
    counts = (0, 1, 300, 37, 200, 128, 64, 294)
    _grouped_case(kind, qt, _x(sum(counts), k, 9), _offsets(counts))


@pytest.mark.parametrize("kind,name", [(GGMLType.Q5_K, "qmm_q5k"), (GGMLType.Q3_K, "qmm_q3k"),
                                       (GGMLType.Q6_K, "qmm_q6k"), (GGMLType.Q2_K, "qmm_q2k")],
                         ids=["q5_k", "q3_k", "q6_k", "q2_k"])
def test_ws_rings_are_the_plans(cuda, kind, name):
    """The rings each source compiles (its <form>_ws_layout entry) are
    gemm_quant.qmm_ws_ring's at every tile height; an unknown height is
    refused."""
    import ctypes

    fn = getattr(_build.library(name), f"{name}_ws_layout")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    for tile in gemm_quant.WS_TILE_ROWS:
        got = (ctypes.c_int * 3)()
        assert fn(tile, got) == 0
        assert list(got) == list(gemm_quant.qmm_ws_ring(kind, tile)), tile
    assert fn(40, (ctypes.c_int * 3)()) != 0

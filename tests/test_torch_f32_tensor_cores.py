"""The float32 dequant matmul on the tensor cores (csrc/qmm_f32.cu), on the
CPU: its arithmetic and its launch plan, held against the JAX package.

The kernel splits each float32 operand into two TF32 parts (`tf32_split`)
and takes every product in three TF32 passes; `qmm_f32_split_plain` repeats
that arithmetic in torch. Here the split's properties, the three-pass model
of every weight source against the exact plain version and against the
Pallas kernel `_qmm_kernel` at out_dtype float32 (interpret mode, as
tests/test_torch_float32.py runs it), dense at 1, 17 and 189 rows and
grouped over a stack with an empty and a one-row segment, and the launch
plan (`qmm_f32_plan`: blocks, shared memory, the grouped tile numbering).
The kernel itself against these on the card: tests/test_torch_kernels_gpu.py
and chip_smoke.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from crabml_tpu.gguf.constants import GGMLType as JGGMLType
from crabml_tpu.ops.pallas import gemm_quant as jgemm
from crabml_tpu.quant.planar import QTensor as JQTensor
from crabml_tpu.quant.planar import to_planar as jto_planar
from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.ops.cuda import gemm_quant
from crabml_tpu_torch.quant.qtensor import FORM_KIND, dequantize, to_kernel_layout, to_planar
from crabml_tpu_torch.tools.synth_gguf import SCHEMES as SYNTH
from crabml_tpu_torch.tools.synth_gguf import vary_scales

SOURCES = pytest.mark.parametrize(
    "kind", [GGMLType.Q4_K, GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q5_K, GGMLType.Q4_0,
             GGMLType.Q3_K, GGMLType.Q2_K, GGMLType.Q5_0],
    ids=["q4_k", "q8_0", "q6_k", "q5_k", "q4_0", "q3_k", "q2_k", "q5_0"])
M, K = 256, 512  # the JAX kernel's weight tile is 256 rows
E = 4
# Tolerance of the three-pass model against the exact product (and against
# the JAX kernel at Precision.HIGHEST), as chip_smoke.py holds the kernel:
# each TF32 part of an operand is rounded to nearest (|v - hi - lo| <= 2^-22
# |v|) and the dropped w_lo x_lo is ~2^-22 of a product, so each product is
# within ~3 * 2^-22 of the exact one; the float32 sums run in another order.
TOL = 1e-5


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


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _raw(kind, n, seed):
    _, blocks = next(v for v in SYNTH.values() if v[0] == kind)
    rng = np.random.default_rng(seed)
    return vary_scales(kind, blocks(rng, n, 0.05), rng)


def _planes(qt):
    return [qt.planes[n] for n in gemm_quant._KERNEL_PLANES[FORM_KIND[qt.kind]]]


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------

def _values(draw_kind):
    """Float32 values of one class: normals, large (1e30-1e38), tiny
    (1e-30-1e-6), negative ones of those magnitudes, and zeros of both
    signs. (Below ~2^-114 lo is subnormal and keeps fewer bits; no weight or
    activation of a model is that small.)"""
    def f32(v):
        return float(np.float32(v))

    mag = {"normal": st.floats(-8.0, 8.0, width=32).filter(lambda v: v == 0 or abs(v) >= 1e-30),
           "large": st.floats(f32(1e30), f32(1e38), width=32),
           "tiny": st.floats(f32(1e-30), f32(1e-6), width=32),
           "negative": st.floats(f32(-1e38), f32(-1e-30), width=32),
           "zero": st.sampled_from([0.0, -0.0])}[draw_kind]
    return st.lists(mag, min_size=1, max_size=64)


@pytest.mark.parametrize("cls", ["normal", "large", "tiny", "negative", "zero"])
@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_tf32_split_reconstructs_within_2_pow_minus_21(cls, data):
    """hi + lo is x within 2^-21 |x| (the bound is 2^-22 for the two
    roundings to nearest), and both parts are TF32 values: their 13 low
    bits are clear (hi's 10 mantissa bits, to nearest, ties away from zero,
    as cvt.rna.tf32.f32)."""
    x = torch.tensor(data.draw(_values(cls)), dtype=torch.float32)
    hi, lo = gemm_quant.tf32_split(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()


def test_tf32_split_rounds_to_nearest_ties_away():
    """cvt.rna: a tie (x = 1 + 2^-11, half a TF32 step) rounds away from
    zero, either sign; below half a step rounds down, above rounds up; lo
    takes the rest exactly when it fits TF32."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 1 + 3 * 2.0 ** -12,
                      2.0 ** 20 + 2.0 ** 9], dtype=torch.float32)
    hi, lo = gemm_quant.tf32_split(x)
    assert hi.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 1 + 2.0 ** -10,
                           2.0 ** 20 + 2.0 ** 10]
    assert lo.tolist() == [-2.0 ** -11, 2.0 ** -11, 2.0 ** -12, -2.0 ** -12, -2.0 ** 9]


# ---------------------------------------------------------------------------
# the three passes, dense and grouped, against the exact plain version and JAX
# ---------------------------------------------------------------------------

def _pair(kind, seed):
    """(JAX kernel-layout QTensor with float32 scales, the port's kernel
    planes with float32 scales) of one (M, K) weight from the same bytes."""
    raw = _raw(kind, M * K, seed).tobytes()
    jqt = jgemm.repack(jto_planar(JGGMLType(int(kind)), raw, (M, K)), np.float32)
    return jqt, to_kernel_layout(to_planar(kind, raw, (M, K)), torch.float32)


@SOURCES
@pytest.mark.parametrize("rows", [1, 17, 189])
def test_split_model_matches_exact_and_pallas(kind, rows):
    """The three-pass model of every weight source at 1, 17 and 189 rows
    against the exact plain version (qmm_<form>_plain, float32 weights and
    products) and against the Pallas `_qmm_kernel` at out_dtype float32:
    both within TOL of max|out|. The model takes the weights as the plain
    version dequantizes them (`dequantize`, bit for bit)."""
    jqt, qt = _pair(kind, 40 + rows)
    x = np.random.default_rng(rows).standard_normal((rows, K)).astype(np.float32)
    xt = torch.from_numpy(x)
    w = dequantize(qt)
    got = gemm_quant.qmm_f32_split_plain(xt, w)
    exact = getattr(gemm_quant, f"{gemm_quant.DEQUANT_FORMS[kind]}_plain")(xt, *_planes(qt))
    assert torch.equal(exact, xt @ w.t())
    want = np.asarray(jgemm.qmatmul_pallas(jnp.asarray(x), jqt, jnp.float32, act_quant=False))
    assert got.shape == (rows, M) and torch.isfinite(got).all()
    assert _rel(got, exact) <= TOL
    assert _rel(got, want) <= TOL


@SOURCES
def test_split_model_of_one_hot_rows_is_hi_plus_lo(kind):
    """One hot row of x (hi 1, lo 0) through the three passes returns each
    weight as hi + lo of its split, bit for bit: what the card's one-hot
    tests hold the kernel to."""
    _, qt = _pair(kind, 7)
    w = dequantize(qt)
    hi, lo = gemm_quant.tf32_split(w)
    assert torch.equal(gemm_quant.qmm_f32_split_plain(torch.eye(K), w), (hi + lo).t())


def _stack_pair(kind, seed):
    """A stack of E distinct experts from the same bytes: (JAX QTensor (E, M,
    K) with float32 scales, the port's kernel planes with float32 scales)."""
    raw = _raw(kind, E * M * K, seed).reshape(E, -1)
    singles = [jgemm.repack(jto_planar(JGGMLType(int(kind)), raw[e].tobytes(), (M, K)),
                            np.float32) for e in range(E)]
    jst = JQTensor(JGGMLType(int(kind)), (E, M, K),
                   {n: jnp.stack([jnp.asarray(s.planes[n]) for s in singles])
                    for n in singles[0].planes})
    return jst, to_kernel_layout(to_planar(kind, raw.tobytes(), (E, M, K)), torch.float32)


@SOURCES
def test_grouped_split_model_matches_exact_and_pallas(kind):
    """Rows sorted by expert: expert 0 empty, a 1-row segment, a 40-row and
    a 23-row one. The grouped three-pass model against the exact grouped
    plain version and against the JAX grouped kernel (`_run_grouped`, each
    segment padded to its 8-row tiles): within TOL of max|out|."""
    jst, qt = _stack_pair(kind, 60)
    counts, TB = (0, 1, 40, 23), 8
    xs = np.random.default_rng(61).standard_normal((sum(counts), K)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    padded, tile_expert = [], []
    for e, n in enumerate(counts):
        seg = np.zeros((-(-n // TB) * TB, K), np.float32)
        seg[:n] = xs[offsets[e]:offsets[e + 1]]
        padded.append(seg)
        tile_expert += [e] * (seg.shape[0] // TB)
    starts = np.concatenate([[0], np.cumsum([p.shape[0] for p in padded])])
    rows = np.concatenate([starts[e] + np.arange(n) for e, n in enumerate(counts)])
    want = np.asarray(jgemm.qmatmul_grouped(
        jnp.asarray(np.concatenate(padded)), jst, jnp.asarray(tile_expert, jnp.int32), TB,
        jnp.float32))[rows]
    off = torch.from_numpy(offsets)
    xt = torch.from_numpy(xs)
    got = gemm_quant.qmm_f32_grouped_split_plain(xt, dequantize(qt), off)
    name = gemm_quant.GROUPED_FORMS[kind]
    exact = getattr(gemm_quant, f"{name}_plain")(xt, *_planes(qt), off)
    assert got.shape == (sum(counts), M) and torch.isfinite(got).all()
    assert _rel(got, exact) <= TOL
    assert _rel(got, want) <= TOL


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

# the tile the card ran fastest at each shape, of 128, 96, 64, 32 and 16 rows
# (tools/qmm_ablation.py f32 on the H100, PERF.md)
FASTEST_TILE = [((512, 6144, 4096), 128), ((512, 4096, 14336), 128), ((189, 6144, 4096), 96),
                ((100, 6144, 4096), 64), ((17, 6144, 4096), 16), ((256, 1536, 512), 32)]


@pytest.mark.parametrize("shape,tile", FASTEST_TILE,
                         ids=["7b_chunk_qkv", "7b_chunk_down", "7b_ragged_chunk", "100_rows",
                              "17_rows", "stories15m_gate_up"])
def test_plan_picks_the_tile_the_card_ran_fastest(shape, tile):
    """At each shape of the card's tile sweep the plan picks the tile that
    ran fastest: the least whole waves of blocks (one an SM) times a block's
    cost, its wgmma width plus F32_STEP_ROWS. The 189-row chunk takes 96
    blocks of 96 rows (0.1868 ms on the card), not 96 of 128 (0.2180) nor
    144 of 64 (0.3289), though those would put a block on each of the 132
    SMs."""
    rows, m, _ = shape
    plan = gemm_quant.qmm_f32_plan(rows, m)
    assert plan.tile_rows == tile
    assert plan.blocks == -(-rows // tile) * -(-m // gemm_quant.F32_BW)
    costs = {t: gemm_quant.f32_plan_cost(rows, m, t) for t in gemm_quant.F32_TILE_ROWS}
    assert costs[tile] == min(costs.values())


def test_plan_cost_counts_waves_and_widths():
    """The cost of a launch: 192 blocks of 128-row tiles are two waves of
    (125 + 128); 96 blocks of 17 rows one wave of (125 + 32), the wgmma
    width that holds 17 rows; a wider tile than the rows costs as the rows."""
    assert gemm_quant.f32_plan_cost(512, 6144, 128) == 2 * (125 + 128)
    assert gemm_quant.f32_plan_cost(17, 6144, 128) == 125 + 32
    assert gemm_quant.f32_plan_cost(17, 6144, 16) == 125 + 16
    assert [gemm_quant.f32_wgmma_width(r) for r in (1, 16, 17, 33, 65, 97, 128)] == \
        [16, 16, 32, 64, 96, 128, 128]


@pytest.mark.parametrize("rows,m,n_planes,tile", [
    (1024, 28672, 8, 128), (1024, 4096, 8, 128), (18, 864, 0, 16), (256, 1536, 0, 32),
    (4612, 6144, 0, 128)])
def test_plan_tiles(rows, m, n_planes, tile):
    """The tiles of the other paths' shapes: Mixtral's 1,024 grouped pairs
    at gate|up and down take 128 rows (the grid sized for a short tile in
    each of 8 segments); stories15M's 18-token prompt of q|k|v 16 rows, its
    256-token one of gate|up (k = 288) 32; gemma2's 4,612-token prompt in
    one call 128."""
    plan = gemm_quant.qmm_f32_plan(rows, m, n_planes)
    assert plan.tile_rows == tile
    assert plan.grid == (-(-rows // tile) + n_planes, -(-m // 128))


def test_plan_shared_memory_fits_a_block():
    """The ring (3 stages of a 128-row x tile's hi and lo, 32 float32 of k
    each), two 128 x 36 float32 weight tiles, the 128 x 132 float32 total of
    the chunks' sums and the alignment slack: at most the 232,448 bytes a
    block may hold on the H100."""
    plan = gemm_quant.qmm_f32_plan(512, 6144)
    assert plan.stages == 3
    assert plan.smem_bytes == 3 * 2 * 128 * 32 * 4 + 2 * 128 * 36 * 4 + 128 * 132 * 4 + 1024
    assert plan.smem_bytes <= 232_448


@pytest.mark.parametrize("tile", gemm_quant.F32_TILE_ROWS)
@settings(max_examples=40, deadline=None)
@given(counts=st.lists(st.integers(0, 300), min_size=1, max_size=9))
def test_grouped_tiles_cover_every_row_once(tile, counts):
    """The grouped tile numbering (qmm_pipe.cuh::find_tile, cut to the
    plan's tile) replayed for random segments, empty ones included: every
    row lies in exactly one tile, a tile never straddles two segments and
    holds at most `tile` rows, an empty segment has none, and the worst-case
    grid leaves no tile out."""
    rows = sum(counts)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(int).tolist()
    plan = dataclasses.replace(gemm_quant.qmm_f32_plan(max(rows, 1), 256, len(counts)),
                               tile_rows=tile, grid=(-(-rows // tile) + len(counts), 2))
    tiles = gemm_quant.qmm_f32_tiles(plan, rows, offsets)
    seen = np.zeros(rows, int)
    for found in tiles:
        if found is None:
            continue
        lo, hi, e = found
        assert offsets[e] <= lo < hi <= offsets[e + 1] and hi - lo <= tile
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert sum(f is not None for f in tiles) == sum(-(-c // tile) for c in counts)


@pytest.mark.parametrize("rows", [1, 17, 189, 512])
def test_dense_tiles_cover_every_row_once(rows):
    """Dense: the plan's tiles hold consecutive runs of at most tile_rows
    rows that cover every row once, and every block of the grid has one."""
    plan = gemm_quant.qmm_f32_plan(rows, 6144)
    tiles = gemm_quant.qmm_f32_tiles(plan, rows)
    assert None not in tiles
    assert [t[0] for t in tiles] == list(range(0, rows, plan.tile_rows))
    assert all(hi - lo <= plan.tile_rows and e == 0 for lo, hi, e in tiles)
    assert tiles[-1][1] == rows


def test_cpu_wrappers_still_compute_the_exact_plain_version():
    """On a CPU tensor the float32 forms compute their exact plain versions,
    not the three-pass model: the CPU path and the tests against JAX keep
    exact float32."""
    _, qt = _pair(GGMLType.Q4_K, 3)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((17, K)).astype(np.float32))
    want = gemm_quant.qmm_q4k_plain(x, *_planes(qt))
    assert torch.equal(gemm_quant.qmm_q4k(x, qt), want)
    assert not torch.equal(gemm_quant.qmm_f32_split_plain(x, dequantize(qt)), want)

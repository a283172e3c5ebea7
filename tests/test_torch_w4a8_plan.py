"""The launch plan of the int8-activation matmul (`qmm_w4a8`), on the CPU.

`w4a8_plan` gives the grid, the n8 tiles, the ring's stages and each warp's
superblocks; `w4a8_block_reads` mirrors what each block of csrc/qmm_w4a8.cu
reads and writes. For the 7B and Mixtral decode shapes and ragged ones,
every (row, output column, 32-group) is summed by exactly one warp of one
block, no block reads a column at or past m or a row past the real ones, and
the plan is a function of the shapes alone.
"""

import inspect

import numpy as np
import pytest

from crabml_tpu_torch.gguf.constants import GGMLType
from crabml_tpu_torch.ops.cuda import gemm_quant
from crabml_tpu_torch.ops.cuda.gemm_quant import w4a8_block_reads, w4a8_plan

DIM, FFN, VOCAB, QKV = 4096, 14336, 32000, 6144
SMEM_PER_SM = 228 * 1024  # H100: shared memory an SM holds
SMEM_PER_BLOCK = 227 * 1024

CASES = (
    # the 7B decode projections: one row, the 8-slot tick, a 16-row tail
    [(r, m, k, False) for r in (1, 8)
     for m, k in ((QKV, DIM), (DIM, DIM), (2 * FFN, DIM), (DIM, FFN), (VOCAB, DIM))]
    + [(16, QKV, DIM, False)]
    # Mixtral's experts by plane: gate|up and down
    + [(1, 2 * FFN, DIM, True), (8, 2 * FFN, DIM, True), (16, 2 * FFN, DIM, True),
       (8, DIM, FFN, True)]
    # ragged: columns off the 16-wide tile, one superblock, fewer superblocks than warps
    + [(r, m, k, p) for r in (1, 3, 8, 9, 16) for m, k in ((300, 768), (100, 256))
       for p in (False, True)]
)


def _coverage(rows, m, k, planes, kind=GGMLType.Q4_K):
    plan = w4a8_plan(rows, m, k, planes, kind)
    G = k // plan.group
    count = np.zeros((rows, m, G), dtype=np.int16)
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            r = w4a8_block_reads(plan, bx, by, rows, m)
            assert r["columns"].stop <= m and r["columns"].start < m
            assert r["rows"].stop <= rows and len(r["rows"]) <= 8 * plan.n_tiles
            for groups in r["groups"]:
                count[r["rows"].start:r["rows"].stop, r["columns"].start:r["columns"].stop,
                      groups] += 1
    return plan, count


@pytest.mark.parametrize("rows,m,k,planes", CASES)
def test_every_row_column_group_is_summed_once(rows, m, k, planes):
    plan, count = _coverage(rows, m, k, planes)
    assert (count == 1).all()
    assert plan.grid == (-(-m // 16), rows if planes else 1)


@pytest.mark.parametrize("rows,m,k,planes", CASES[:11] + CASES[-4:])
def test_warps_take_disjoint_superblocks_in_order(rows, m, k, planes):
    """Each warp walks its superblocks upward; together they are each of
    k's superblocks once. A stage holds the block's rows of x (1, 8 or 16);
    four stages (three at 16 rows) fit two blocks on an SM."""
    plan = w4a8_plan(rows, m, k, planes)
    flat = sorted(sb for ks in plan.k_slices for sb in ks)
    assert flat == list(range(k // 256))
    for ks in plan.k_slices:
        assert list(ks) == sorted(ks)
    per_block = 1 if planes else rows
    assert plan.x_rows == (1 if per_block == 1 else 8 if per_block <= 8 else 16)
    assert plan.n_tiles == -(-plan.x_rows // 8)
    stage = 2048 + 512 + plan.x_rows * (256 + 64)  # nibbles, scales; x, dx, sx
    assert plan.smem_bytes == 4 * plan.stages * stage
    assert plan.stages == (4 if plan.x_rows <= 8 else 3)
    reduction = 4 * 4 * plan.n_tiles * 32 * 4  # the warps' partial sums, static shared memory
    assert plan.smem_bytes + reduction <= SMEM_PER_BLOCK
    assert 2 * (plan.smem_bytes + reduction + 1024) <= SMEM_PER_SM  # 1 KB reserved a block


def test_plan_is_a_function_of_shapes_alone():
    """Same shapes, same plan; the plan takes ints only (no tensor, so no
    value on the device is read; the scheme is an int enum), is immutable
    and hashable; `f32` (the float32 form) is a bool."""
    assert list(inspect.signature(w4a8_plan).parameters) == ["rows", "m", "k", "planes", "kind",
                                                            "f32"]
    for rows, m, k, planes in CASES:
        a, b = w4a8_plan(rows, m, k, planes), w4a8_plan(rows, m, k, planes)
        assert a == b and hash(a) == hash(b)
        assert a is b  # memoized: a decode step asks for the same plans every call
    with pytest.raises(Exception):
        a.stages = 5  # frozen


@pytest.mark.parametrize("rows", [1, 8, 9, 16])
def test_plane_form_holds_one_row_a_block(rows):
    """With planes each block row y reads only activation row y, whatever
    the row count; the dense form reads every row in each block."""
    dense = w4a8_plan(rows, 300, 768)
    plane = w4a8_plan(rows, 300, 768, planes=True)
    assert plane.n_tiles == 1 and plane.x_rows == 1 and plane.grid[1] == rows
    for y in range(rows):
        assert w4a8_block_reads(plane, 3, y, rows, 300)["rows"] == range(y, y + 1)
    assert w4a8_block_reads(dense, 3, 0, rows, 300)["rows"] == range(rows)
    assert dense.n_tiles == (2 if rows > 8 else 1)


def test_last_column_tile_stops_at_m():
    """m = 300: the 19th tile holds columns 288..299 and reads no further."""
    plan = w4a8_plan(8, 300, 768)
    assert plan.grid[0] == 19
    assert w4a8_block_reads(plan, 18, 0, 8, 300)["columns"] == range(288, 300)
    assert gemm_quant.W4A8_COLS == 16 and gemm_quant.W4A8_SB == 256


# the Q8_0, Q6_K, Q5_K, Q4_0, Q3_K, Q2_K and Q5_0 forms: dense only, at the
# 7B decode shapes and ragged ones
SCHEME_CASES = (
    [(r, m, k) for r in (1, 8, 16)
     for m, k in ((QKV, DIM), (DIM, DIM), (2 * FFN, DIM), (DIM, FFN), (VOCAB, DIM))]
    + [(r, m, k) for r in (1, 3, 9) for m, k in ((300, 768), (100, 256))])


@pytest.mark.parametrize("kind", [GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q5_K, GGMLType.Q4_0,
                                  GGMLType.Q3_K, GGMLType.Q2_K, GGMLType.Q5_0],
                         ids=["q8_0", "q6_k", "q5_k", "q4_0", "q3_k", "q2_k", "q5_0"])
@pytest.mark.parametrize("rows,m,k", SCHEME_CASES)
def test_every_row_column_group_is_summed_once_per_scheme(rows, m, k, kind):
    """As for Q4_K, with the scheme's scale group: 32 elements for Q8_0,
    Q5_K, Q4_0 and Q5_0, 16 for Q6_K, Q3_K and Q2_K (16 groups a superblock,
    one k16 integer mma each)."""
    plan, count = _coverage(rows, m, k, False, kind)
    k16 = (GGMLType.Q6_K, GGMLType.Q3_K, GGMLType.Q2_K)
    assert plan.group == (16 if kind in k16 else 32)
    assert count.shape[2] == k // plan.group and (count == 1).all()
    assert plan.grid == (-(-m // 16), 1)


@pytest.mark.parametrize("kind,stage", [
    (GGMLType.Q4_K, lambda xr: 2048 + 512 + xr * (256 + 64)),  # nibbles, dsub | msub; x, dx, sx
    (GGMLType.Q8_0, lambda xr: 4096 + 256 + xr * (256 + 32)),  # int8, dsub; x, dx
    (GGMLType.Q6_K, lambda xr: 3072 + 512 + xr * (256 + 128)),  # ql | qh, 16 dsub; x, dx, sx
    (GGMLType.Q5_K, lambda xr: 2560 + 512 + xr * (256 + 64)),  # nibbles | qh, dsub | msub
    (GGMLType.Q4_0, lambda xr: 2048 + 256 + xr * (256 + 64)),  # nibbles, dsub; x, dx, sx
    # qs | hb, 16 sc bytes and a float32 d a column; x, 16 dx and sx
    (GGMLType.Q3_K, lambda xr: 1536 + 320 + xr * (256 + 128)),
    (GGMLType.Q2_K, lambda xr: 1024 + 384 + xr * (256 + 128)),  # qs, 16 scm, d and dmin
    (GGMLType.Q5_0, lambda xr: 2560 + 256 + xr * (256 + 64)),  # nibbles | qh, dsub; x, dx, sx
    # the kinds that run another kind's form: that form's stage
    (GGMLType.Q4_1, lambda xr: 2048 + 512 + xr * (256 + 64)),
    (GGMLType.Q5_1, lambda xr: 2560 + 512 + xr * (256 + 64)),
    (GGMLType.Q8_1, lambda xr: 4096 + 256 + xr * (256 + 32)),
], ids=["q4_k", "q8_0", "q6_k", "q5_k", "q4_0", "q3_k", "q2_k", "q5_0", "q4_1", "q5_1", "q8_1"])
@pytest.mark.parametrize("x_rows", [1, 8, 16])
def test_stage_sizes_and_ring_depth_per_scheme(kind, stage, x_rows):
    """A ring stage holds a superblock of the 16 columns: Q8_0 4 KB of int8
    weights and 8 bf16 scales a column, Q6_K 3 KB of ql | qh and 16 scale
    groups a column, Q5_K 2.5 KB of nibbles | qh and Q4_K's scales, Q4_0
    2 KB of nibbles and 8 scales a column (its offset needs sx, no minimum
    plane), Q5_0 Q5_K's nibbles | qh and Q4_0's scales, Q4_1, Q5_1 and Q8_1
    the stages of the Q4_K, Q5_K and Q8_0 forms they run, Q3_K 1.5 KB of qs
    | hb, Q2_K 1 KB of qs, each with 16 scale
    bytes and a float32 d (Q2_K also dmin) a column. The ring is as deep as
    two blocks an SM allow, up to four stages: Q4_K keeps its four stages
    (three at 16 rows)."""
    plan = w4a8_plan(x_rows, DIM, FFN, False, kind)
    assert plan.x_rows == x_rows
    assert gemm_quant.w4a8_stage_bytes(x_rows, kind) == stage(x_rows)
    assert plan.smem_bytes == 4 * plan.stages * stage(x_rows)
    reduction = 4 * 4 * plan.n_tiles * 32 * 4
    assert 2 * (plan.smem_bytes + reduction + 1024) <= SMEM_PER_SM
    deeper = 4 * (plan.stages + 1) * stage(x_rows)
    assert plan.stages == 4 or 2 * (deeper + reduction + 1024) > SMEM_PER_SM
    if kind == GGMLType.Q4_K:
        assert plan.stages == (4 if x_rows <= 8 else 3)


ALL_KINDS = pytest.mark.parametrize(
    "kind", [GGMLType.Q4_K, GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q5_K, GGMLType.Q4_0,
             GGMLType.Q3_K, GGMLType.Q2_K, GGMLType.Q5_0],
    ids=["q4_k", "q8_0", "q6_k", "q5_k", "q4_0", "q3_k", "q2_k", "q5_0"])
# the plane form: Mixtral's experts (gate|up, down) at the decode step's row
# (every block row holds one row, so more rows repeat it), and ragged shapes
# up to a 16-row tail
PLANE_CASES = ([(1, 2 * FFN, DIM), (1, DIM, FFN)]
               + [(r, m, k) for r in (1, 3, 9, 16) for m, k in ((300, 768), (100, 256))])


@ALL_KINDS
@pytest.mark.parametrize("rows,m,k", PLANE_CASES)
def test_plane_form_sums_every_row_column_group_once_per_scheme(rows, m, k, kind):
    """The plane form of every scheme: one block row per activation row,
    one row of x a stage (x_rows 1, the ring of the dense one-row plan), and
    every (row, column, scale group) summed by exactly one warp of one
    block."""
    plan, count = _coverage(rows, m, k, True, kind)
    assert (count == 1).all()
    assert plan.grid == (-(-m // 16), rows) and plan.x_rows == 1 and plan.n_tiles == 1
    dense = w4a8_plan(1, m, k, False, kind)
    assert (plan.stages, plan.smem_bytes, plan.group) == (dense.stages, dense.smem_bytes,
                                                          dense.group)


@ALL_KINDS
@pytest.mark.parametrize("rows", [1, 5, 8, 16])
def test_plane_form_reads_its_rows_plane_only(rows, kind):
    """Row y's blocks read the stack's rows plane_idx[y] * m .. + m - 1 (the
    kernel's wrow0 + column, at which every plane of the scheme is read:
    values, dsub and msub, and Q3_K's / Q2_K's scale bytes, d and dmin),
    each exactly once, and no other plane's: experts above 0, repeated and
    distinct."""
    E, m, k = 8, 300, 768
    plane_idx = tuple((3 * y + 5) % 7 + 1 for y in range(rows))  # experts 1..7
    plan = w4a8_plan(rows, m, k, True, kind)
    for y in range(rows):
        read = np.zeros(E * m, dtype=np.int16)
        for bx in range(plan.grid[0]):
            r = w4a8_block_reads(plan, bx, y, rows, m, plane_idx)
            read[r["stack_rows"].start:r["stack_rows"].stop] += 1
        e = plane_idx[y]
        assert (read[e * m:(e + 1) * m] == 1).all()
        assert read.sum() == m
    dense = w4a8_block_reads(w4a8_plan(rows, m, k, False, kind), 2, 0, rows, m, plane_idx)
    assert dense["stack_rows"] == dense["columns"]  # one plane: the dense form ignores plane_idx

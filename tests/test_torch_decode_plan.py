"""The decode-attention launch plan (ops/cuda/decode_attention.py::plan) and
its mirror of what each block reads (block_keys, the host-side copy of
csrc/decode_core.cuh's keys_of): the chunks cover every key a sequence can
have, each key is read by one block of each row tile, no block follows a
table column past the table, and the plan is made without pos. Pure host
code: runs on the CPU."""

import inspect

import pytest

from crabml_tpu_torch.ops.cuda.decode_attention import (CHUNK, ROW_TILE, block_keys, plan,
                                                        tile_rows)

# (B, KV, span, T, G): the 7B main path's fused step (4,096 + 1), 8-slot
# serving over 9 pages (+1, +4), a short prefill tail, 1-key and ragged spans;
# then the verify steps past 16 query rows: the 7B's K = 4 verify (T = 5 at
# G = 4: 20 rows, two tiles), the 8-slot paged verify, Qwen2-7B's T = 8 at
# G = 7 (56 rows, four tiles), 8 tokens at G = 8 (64 rows)
_PLANS = [(1, 8, 4097, 1, 4), (8, 8, 1152 + 1, 1, 4), (8, 8, 1152 + 4, 4, 4), (2, 2, 256, 3, 4),
          (1, 1, 1, 1, 1), (3, 4, 1000, 8, 2), (8, 8, 1152, 4, 4),
          (1, 8, 4096 + 5, 5, 4), (8, 8, 1152 + 5, 5, 4), (1, 4, 4096, 8, 7), (2, 1, 300, 8, 8)]


@pytest.mark.parametrize("B,KV,span,T,G", _PLANS)
def test_plan_chunks_cover_the_span(B, KV, span, T, G):
    p = plan(B, KV, span, T, G)
    rt = -(-(T * G) // ROW_TILE)
    assert p.row_tiles == rt and p.grid == (KV * rt, B, p.n_chunks)
    assert (p.n_chunks - 1) * CHUNK < span <= p.n_chunks * CHUNK  # every key, one chunk spare at most
    tr = min(T * G, ROW_TILE)  # rows a tile's partial holds; one tile: today's (B, KV, n, T*G)
    assert p.part_stats == (B, KV * rt, p.n_chunks, tr)
    assert p.part_acc == (B, KV * rt, p.n_chunks, tr, 128)
    assert p.tickets == B * KV * rt
    # the tiles hold every row once, each at most ROW_TILE of them
    rows = [r for t in range(rt) for r in tile_rows(t, T, G)]
    assert rows == list(range(T * G)) and all(len(tile_rows(t, T, G)) <= tr for t in range(rt))


# (B, KV, span, T, G) at head dim 256: Gemma-2-9B's fused step at B=1 (8,192
# keys + 1), its 8-slot serving tick, a 4-token tail, and 2 q heads a kv head
_PLANS_256 = [(1, 8, 8192 + 1, 1, 2), (8, 8, 1152 + 1, 1, 2), (8, 8, 1152 + 4, 4, 2),
              (2, 1, 300, 8, 2), (1, 8, 8192 + 5, 5, 4)]


@pytest.mark.parametrize("B,KV,span,T,G", _PLANS_256)
def test_plan_at_head_dim_256(B, KV, span, T, G):
    """The grid does not depend on the head dim (a block a 128-key chunk at
    256 as at 128); only each chunk's partial output is twice as wide."""
    p = plan(B, KV, span, T, G, 256)
    q = plan(B, KV, span, T, G, 128)
    assert p.grid == q.grid and p.part_stats == q.part_stats and p.tickets == q.tickets
    assert p.part_acc == (*q.part_stats, 256)
    assert (p.n_chunks - 1) * CHUNK < span <= p.n_chunks * CHUNK


def test_plan_never_reads_pos():
    """The plan is a function of shapes alone: no pos argument, the same plan
    for the same shapes (so the launch never waits on the card, and a CUDA
    graph can capture it)."""
    assert "pos" not in inspect.signature(plan).parameters
    assert plan(8, 8, 1153, 1, 4) == plan(8, 8, 1153, 1, 4)


def _positions(cap, T, fused):
    """Every prefix a cache of `cap` keys can hold before a step of T (and
    the idle slot's -T of the paged form)."""
    last = cap if fused else cap - T
    return [-T, *range(0, last + 1)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("T", [1, 4, 8])
@pytest.mark.parametrize("win", [0, 1, 100, 128, 300])
def test_blocks_read_each_live_key_once(fused, T, win):
    """For every prefix of a 3-page cache, the blocks of the plan read
    exactly the keys some row sees (from the earliest row's window start to
    the last new key), each once, from the cache below pos (fused) and from
    the step's block from pos on; a sequence with no key has one block
    writing zeros."""
    cap = 3 * CHUNK
    p = plan(1, 1, cap + (T if fused else 0), T, 4)
    for pos in _positions(cap, T, fused):
        n_keys = max(pos + T, 0)
        first = max(pos + 1 - win, 0) if win else 0
        seen, zeros = [], 0
        for c in range(p.n_chunks):
            blk = block_keys(c, pos, T, win, cap, fused)
            zeros += blk["zeros"]
            cached, new = range(*blk["cached"]), range(*blk["new"])
            assert all(j < max(pos, 0) for j in cached) if fused else not new
            assert all(j >= max(pos, 0) for j in new)
            seen += [*cached, *new]
        assert sorted(seen) == list(range(first if n_keys else 0, n_keys)), pos
        assert len(seen) == len(set(seen))
        assert zeros == (n_keys == 0)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("max_pages", [1, 2, 9])
@pytest.mark.parametrize("T", [1, 4])
def test_blocks_never_follow_a_column_past_the_table(fused, max_pages, T):
    """A block reads table column c only when its chunk holds a cached key,
    and c < max_pages for every prefix the pool can hold, though the fused
    plan has one chunk past the table for the step's keys."""
    cap = max_pages * CHUNK
    p = plan(8, 8, cap + (T if fused else 0), T, 4)
    for pos in _positions(cap, T, fused):
        for win in (0, 50):
            for c in range(p.n_chunks):
                blk = block_keys(c, pos, T, win, cap, fused)
                col = blk["column"]
                if col is not None:
                    assert col == c < max_pages
                    assert blk["cached"][0] < blk["cached"][1]


@pytest.mark.parametrize("tool,table", [("decode_ablation", "VARIANTS"),
                                        ("qmm_ablation", "VARIANTS"),
                                        ("qmm_ablation", "Q50_VARIANTS")])
def test_ablation_variants_find_the_text_they_edit(tool, table):
    """Each variant of the ablation tools (tools/decode_ablation.py,
    tools/qmm_ablation.py) edits a copy of a CUDA source by replacing a
    piece of its text; on the card a variant whose text is gone raises at
    build. Every piece is still in the committed sources."""
    import importlib
    from pathlib import Path

    mod = importlib.import_module(f"crabml_tpu_torch.tools.{tool}")
    csrc = Path(mod.__file__).resolve().parents[1] / "csrc"
    edits = [e for variant in getattr(mod, table).values() for e in variant]
    assert edits
    for fname, text, _ in edits:
        assert text in (csrc / fname).read_text(), (fname, text)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("T,G", [(5, 4), (8, 7), (3, 7), (8, 8)])
@pytest.mark.parametrize("win", [0, 1, 100, 300])
def test_each_row_tile_reads_each_key_its_rows_see_once(fused, T, G, win):
    """Past 16 query rows each row tile is a block of its own: for every
    prefix of a 3-page cache, the blocks of tile i read exactly the keys from
    the window start of the tile's earliest row (token t0 = 16i // G) to the
    last new key, each once, so a later tile never reads keys before its own
    rows' windows; the rows of the tiles together are every row of the step."""
    cap = 3 * CHUNK
    p = plan(1, 1, cap + (T if fused else 0), T, G)
    assert p.row_tiles == -(-(T * G) // ROW_TILE) > 1 or T * G <= ROW_TILE
    for pos in _positions(cap, T, fused):
        n_keys = max(pos + T, 0)
        for tile in range(p.row_tiles):
            t0 = tile_rows(tile, T, G)[0] // G
            first = max(pos + t0 + 1 - win, 0) if win else 0
            seen = []
            for c in range(p.n_chunks):
                blk = block_keys(c, pos, T, win, cap, fused, t0)
                seen += [*range(*blk["cached"]), *range(*blk["new"])]
            want = list(range(min(first, n_keys) if n_keys else 0, n_keys))
            assert sorted(seen) == want and len(seen) == len(set(seen)), (pos, tile)

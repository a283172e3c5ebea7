"""Time `qmm_w4a8` and `qmm_q4k_grouped` of two checkouts of the port in
turns, on one card.

    python -m crabml_tpu_torch.tools.w4a8_turns OTHER_ROOT    # needs one CUDA card

OTHER_ROOT is another checkout of the repository (for example an earlier
commit unpacked with `git archive` into a directory that git ignores). The
turns run in the order other, this, this, other, each in a process of its
own that imports `crabml_tpu_torch` from that checkout and builds its
kernels there. Each turn times `qmm_w4a8` (bfloat16 out, as on the main
path) on the inputs of this checkout's `chip_smoke.py` checks of it
(`W4A8_SHAPES`: the dense form and the plane-per-row form of Q4_K), and
`qmm_q4k_grouped` on its grouped checks' 1,024 pairs at the experts'
gate|up and down shapes, with its `Timer`: once with L2 emptied by a write
before each launch, as `chip_smoke.py` times, and once by a read. Each turn
also hashes the float32 outputs at those shapes and `q4k_hashes`'s: the run
fails when this checkout's numbers differ from the other's.

Prints the card and its power limit, one JSON line a turn, then one JSON
line a shape with each checkout's two times and the ratio of their means.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import statistics
import subprocess
import sys
from pathlib import Path

THIS_ROOT = Path(__file__).resolve().parents[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", THIS_ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def label(cs, rows: int, m: int, k: int, planes: bool) -> str:
    w = f"plane-per-row of ({cs.MOE_EXPERTS}x{m}x{k})^T" if planes else f"({m}x{k})^T"
    return f"{rows}x{k} @ {w}"


def grouped_shapes(cs) -> list[tuple[str, int, int, int]]:
    """(label, m, k, seed) of the qmm_q4k_grouped cases: chip_smoke.py's."""
    rows = sum(cs.GROUPED_COUNTS)
    return [(f"grouped {rows} pairs x{k} @ ({cs.MOE_EXPERTS}x{m}x{k})^T", m, k, seed)
            for m, k, seed in ((2 * cs.FFN, cs.DIM, 42), (cs.DIM, cs.FFN, 43))]


def q4k_hashes() -> dict:
    """{rows: sha256 of the Q4_K qmm_w4a8's float32 output} at 1, 8 and 16
    rows of the 7B qkv shape, inputs from numpy seeds (so the same on every
    machine): tests/test_torch_kernels_gpu.py holds them as computed before
    the Q8_0 and Q6_K forms joined the source."""
    import hashlib

    import numpy as np
    import torch

    from crabml_tpu_torch.gguf.constants import GGMLType
    from crabml_tpu_torch.ops.cuda import gemm_quant
    from crabml_tpu_torch.quant.qtensor import to_kernel_layout, to_planar
    from crabml_tpu_torch.tools.synth_gguf import q4k_blocks

    out = {}
    for rows in (1, 8, 16):
        blocks = q4k_blocks(np.random.default_rng(rows), 6144 * 4096, 1 / 64)
        qt = to_kernel_layout(to_planar(GGMLType.Q4_K, blocks, (6144, 4096), "cuda"),
                              torch.bfloat16)
        x = np.random.default_rng(100 + rows).standard_normal((rows, 4096)).astype(np.float32)
        got = gemm_quant.qmm_w4a8(torch.from_numpy(x).cuda().to(torch.bfloat16), qt)
        out[str(rows)] = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
    return out


def child(root: str) -> dict:
    """One turn: `qmm_w4a8` of checkout `root` at every shape."""
    cs = _chip_smoke()
    sys.path.insert(0, root)
    import torch

    import crabml_tpu_torch
    from crabml_tpu_torch.ops.cuda import gemm_quant

    assert Path(crabml_tpu_torch.__file__).resolve().parents[1] == Path(root).resolve()
    timer = cs.Timer(torch)
    import hashlib

    times, by_read, hashes = {}, {}, {}
    # the first shape twice: a process's first timing reads slow, the second counts
    for rows, m, k, planes, seed in cs.W4A8_SHAPES[:1] + cs.W4A8_SHAPES:
        qt = (cs.q4k_stack(cs.MOE_EXPERTS, m, k, seed, False) if planes
              else cs.q4k_weight(m, k, seed, "cuda"))
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(rows, k, generator=g, device="cuda").to(torch.bfloat16)
        plane = (torch.randint(0, cs.MOE_EXPERTS, (rows,), generator=g, device="cuda")
                 .to(torch.int32) if planes else None)
        fn = lambda: gemm_quant.qmm_w4a8(x, qt, torch.bfloat16, plane)  # noqa: E731
        key = label(cs, rows, m, k, planes)
        times[key] = timer(fn)
        by_read[key] = timer(fn, by_read=True)
        out32 = gemm_quant.qmm_w4a8(x, qt, torch.float32, plane)
        hashes[key] = hashlib.sha256(out32.cpu().numpy().tobytes()).hexdigest()
        del qt
        torch.cuda.empty_cache()
    for key, m, k, seed in grouped_shapes(cs):
        qt = cs.q4k_stack(cs.MOE_EXPERTS, m, k, seed, False)
        g = torch.Generator(device="cuda").manual_seed(seed)
        xs = torch.randn(sum(cs.GROUPED_COUNTS), k, generator=g, device="cuda").to(torch.bfloat16)
        off = torch.tensor([0, *itertools.accumulate(cs.GROUPED_COUNTS)], dtype=torch.int32,
                           device="cuda")
        fn = lambda: gemm_quant.qmm_q4k_grouped(xs, qt, off, torch.bfloat16)  # noqa: E731
        times[key] = timer(fn)
        by_read[key] = timer(fn, by_read=True)
        out32 = gemm_quant.qmm_q4k_grouped(xs, qt, off, torch.float32)
        hashes[key] = hashlib.sha256(out32.cpu().numpy().tobytes()).hexdigest()
        del qt
        torch.cuda.empty_cache()
    return {"root": root, "ms": times, "ms_l2_emptied_by_read": by_read,
            "sha256": hashes, "q4k_hashes": q4k_hashes()}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    cs = _chip_smoke()
    other = str(Path(sys.argv[1]).resolve())
    print(f"gpu: {cs.gpu_tag()}", flush=True)
    turns = []
    for root in (other, str(THIS_ROOT), str(THIS_ROOT), other):
        out = subprocess.run([sys.executable, __file__, "--child", root], capture_output=True,
                             text=True, cwd=root)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    same = all(t["sha256"] == turns[0]["sha256"] and t["q4k_hashes"] == turns[0]["q4k_hashes"]
               for t in turns)
    print(json.dumps({"outputs_identical": same, "q4k_hashes": turns[0]["q4k_hashes"]}))
    keys = [label(cs, rows, m, k, planes) for rows, m, k, planes, _ in cs.W4A8_SHAPES]
    for key in keys + [key for key, *_ in grouped_shapes(cs)]:
        row = {"shape": key}
        for what in ("ms", "ms_l2_emptied_by_read"):
            o = [turns[0][what][key], turns[3][what][key]]
            t = [turns[1][what][key], turns[2][what][key]]
            row[what] = {"other": o, "this": t,
                         "this_over_other": statistics.mean(t) / statistics.mean(o)}
        print(json.dumps(row))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

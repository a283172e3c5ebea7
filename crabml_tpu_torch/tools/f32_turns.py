"""Time the float32 tensor-core kernels of two checkouts of the port in turns,
on one card: the float32 dequant matmul (csrc/qmm_f32.cu) and the float32
entry of flash attention (csrc/flash_attention.cu).

    python -m crabml_tpu_torch.tools.f32_turns OTHER_ROOT    # needs one CUDA card

OTHER_ROOT is another checkout of the repository (for example an earlier
commit unpacked with `git archive` into a directory that git ignores). The
inputs are made once, from numpy seeds, and saved (flash's q, k and v are
made on the card from a torch seed in each turn); then the turns run in the
order other, this, this, other, each in a process of its own that imports
`crabml_tpu_torch` from that checkout and builds its kernels there. Each turn
times, with `chip_smoke.py`'s `Timer` (L2 emptied by a write before each
launch):
- the float32 dequant form of every scheme at 512 and 189 rows of the 7B
  q|k|v (4096 -> 6144), Q4_K's at 512 rows of down (14336 -> 4096), the
  grouped Q4_K form on `chip_smoke.py`'s 1,024 (row, slot) pairs of the
  Mixtral gate|up stack (8 x 28672 x 4096), and Q8_0's at stories15M's 256 x
  288 @ (1536 x 288)^T (planes padded to k = 512); beside each, float32
  `torch.matmul` (TF32 off) on the dequantized weight, per segment where
  grouped;
- float32 flash at every float32 shape of `chip_smoke.py`'s checks (the
  7B's chunks, its last at 4,096 keys, gemma2's head dim 256 with its
  softcap and window, Qwen2-7B's G = 7, phi3's 96 and phi2's 80, the HF
  fixtures' 16, the TinyStories models' 48 and 8, and head dims 24, 72, 104,
  200 and 248); beside each, SDPA in float32 where there is no softcap.
Each turn also holds every output against the exact plain version
(max|out - plain| / max|plain|): the run fails when a matmul exceeds 1e-5 or
flash 1e-4 (chip_smoke.py's gates).

Prints the card and its power limit, one JSON line a turn, then one JSON
line a shape with each checkout's two times, the ratio of their means and
the library's mean.
"""

from __future__ import annotations

import importlib.util
import json
import math
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

THIS_ROOT = Path(__file__).resolve().parents[2]
TOL = {"matmul": 1e-5, "flash": 1e-4}  # chip_smoke.py's gates on the float32 forms
FORMS = ("q4_k", "q8_0", "q6_k", "q5_k", "q4_0", "q3_k", "q2_k", "q5_0")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", THIS_ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _weight(scheme: str, shape: tuple, seed: int) -> dict:
    """{kind, shape, planes}: random blocks of `scheme` (each block's scales
    varied) in the port's kernel layout with float32 scales, on the CPU."""
    import numpy as np
    import torch

    from crabml_tpu_torch.quant.qtensor import to_kernel_layout, to_planar
    from crabml_tpu_torch.tools.synth_gguf import SCHEMES, vary_scales

    kind, blocks = SCHEMES[scheme]
    rng = np.random.default_rng(seed)
    n = math.prod(shape)
    raw = vary_scales(kind, blocks(rng, n, 1.0 / math.sqrt(shape[-1])), rng)
    qt = to_kernel_layout(to_planar(kind, raw, shape, "cpu"), torch.float32)
    return {"kind": int(kind), "shape": shape, "planes": dict(qt.planes)}


def make_cases(cs) -> list[dict]:
    """The timed cases: label, weight, x (and offsets where grouped)."""
    import numpy as np
    import torch

    def x(rows, k, seed):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal((rows, k))
                                .astype(np.float32))

    qkv = (cs.QKV_M, cs.DIM)
    cases = []
    for i, scheme in enumerate(FORMS):
        w = _weight(scheme, qkv, 900 + i)
        for rows in (cs.PREFILL_CHUNK, cs.RAGGED_CHUNK):
            cases.append({"label": f"{scheme} {rows}x{cs.DIM} @ ({cs.QKV_M}x{cs.DIM})^T",
                          "w": w, "x": x(rows, cs.DIM, 910 + i + rows)})
    cases.append({"label": f"q4_k {cs.PREFILL_CHUNK}x{cs.FFN} @ ({cs.DIM}x{cs.FFN})^T",
                  "w": _weight("q4_k", (cs.DIM, cs.FFN), 920),
                  "x": x(cs.PREFILL_CHUNK, cs.FFN, 921)})
    pairs = sum(cs.GROUPED_COUNTS)
    cases.append({"label": f"q4_k grouped {pairs} pairs x{cs.DIM} @ "
                           f"({cs.MOE_EXPERTS}x{2 * cs.FFN}x{cs.DIM})^T",
                  "w": _weight("q4_k", (cs.MOE_EXPERTS, 2 * cs.FFN, cs.DIM), 922),
                  "x": x(pairs, cs.DIM, 923),
                  "offsets": [0, *np.cumsum(cs.GROUPED_COUNTS).tolist()]})
    cases.append({"label": f"q8_0 {cs.S15_CTX}x{cs.S15_DIM} @ "
                           f"({2 * cs.S15_FFN}x{cs.S15_DIM})^T (planes padded to 512)",
                  "w": _weight("q8_0", (2 * cs.S15_FFN, cs.S15_DIM), 924),
                  "x": x(cs.S15_CTX, cs.S15_DIM, 925)})
    return cases + flash_cases(cs)


def flash_cases(cs) -> list[dict]:
    """Float32 flash: label, dims (q heads, kv heads, head dim, cache rows),
    T, pos, softcap, window, and the seed of q, k and v."""
    attn7b = (cs.HEADS, cs.KV_HEADS, cs.HEAD_DIM, cs.CTX)
    chunk, ragged = cs.PREFILL_CHUNK, cs.RAGGED_CHUNK
    shapes = [(attn7b, chunk, 0, 0.0, 0), (attn7b, chunk, chunk, 0.0, 0),
              (attn7b, ragged, chunk, 0.0, 0), (attn7b, chunk, cs.CTX - chunk, 0.0, 0),
              (cs.G2_ATTN, chunk, chunk, cs.G2_SOFTCAP, 0),
              (cs.G2_ATTN, chunk, cs.G2_WINDOW, cs.G2_SOFTCAP, cs.G2_WINDOW),
              (cs.Q2_ATTN, ragged, chunk, 0.0, 0)]
    for hd in (cs.P3_HD, cs.P2_HD):
        dims = (cs.P3_HEADS, cs.P3_HEADS, hd, cs.CTX)
        shapes += [(dims, chunk, 0, 0.0, 0), (dims, chunk, chunk, 0.0, 0),
                   (dims, ragged, chunk, 0.0, 0)]
    hd16 = (cs.HEADS, cs.KV_HEADS, 16, cs.CTX)
    shapes += [(cs.HF_ATTN, 16, 0, 0.0, 0), (cs.HF_ATTN, 1, 15, 0.0, 0),
               (hd16, chunk, chunk, 0.0, 0), (hd16, chunk, chunk, 50.0, 256)]
    for dims in (cs.S15_ATTN, cs.S260_ATTN):
        shapes += [(dims, dims[3], 0, 0.0, 0), (dims, 1, dims[3] - 1, 0.0, 0)]
    shapes.append(((cs.HEADS, cs.KV_HEADS, 24, cs.CTX), chunk, chunk, 50.0, 256))
    for hd in (72, 104, 200, 248):
        shapes.append(((cs.HEADS, cs.KV_HEADS, hd, cs.CTX), chunk, chunk, 0.0, 0))
    cases = []
    for i, (dims, T, pos, cap, win) in enumerate(shapes):
        H, KV, hd, S = dims
        form = (f" softcap {cap:g}" if cap else "") + (f" window {win}" if win else "")
        cases.append({"label": f"flash f32 hd {hd}, {H} / {KV} heads, T {T} pos {pos}, "
                               f"S {S}{form}",
                      "flash": (dims, T, pos, cap, win), "seed": 930 + i})
    return cases


def _flash_turn(cs, torch, case) -> tuple:
    """(kernel, exact plain, SDPA or None) on one float32 flash case."""
    from crabml_tpu_torch.ops.cuda import flash_attention as fa

    (H, KV, hd, S), T, pos, cap, win = case["flash"]
    g = torch.Generator(device="cuda").manual_seed(case["seed"])
    q = torch.randn(1, T, H, hd, generator=g, device="cuda")
    k = torch.randn(1, KV, S, hd, generator=g, device="cuda")
    v = torch.randn(1, KV, S, hd, generator=g, device="cuda")
    posv = torch.tensor([pos], dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(hd)
    fn = lambda: fa.flash_attention(q, k, v, posv, scale, cap, win)  # noqa: E731
    want = fa.flash_attention_plain(q, k, v, posv, scale, cap, win)
    lib = None if cap else (lambda: cs._sdpa(q, k, v, pos, T, win))  # noqa: E731
    return fn, want, lib


def child(root: str, cases_path: str) -> dict:
    """One turn: the float32 forms of checkout `root` at every case."""
    cs = _chip_smoke()
    sys.path.insert(0, root)
    import torch

    import crabml_tpu_torch
    from crabml_tpu_torch.gguf.constants import GGMLType
    from crabml_tpu_torch.ops.cuda import gemm_quant
    from crabml_tpu_torch.quant.qtensor import FORM_KIND, QTensor, dequantize

    assert Path(crabml_tpu_torch.__file__).resolve().parents[1] == Path(root).resolve()
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = cs.Timer(torch)
    cases = torch.load(cases_path, weights_only=False)
    times, library, errors = {}, {}, {}
    # the first case twice: a process's first timing reads slow, the second counts
    for case in cases[:1] + cases:
        key = case["label"]
        if "flash" in case:
            fn, want, lib = _flash_turn(cs, torch, case)
            got = fn()
            torch.cuda.synchronize()
            errors[key] = ((got - want).abs().max() / want.abs().max()).item()
            times[key] = timer(fn)
            library[key] = timer(lib) if lib else None
            del got, want
            torch.cuda.empty_cache()
            continue
        w = case["w"]
        kind = GGMLType(w["kind"])
        qt = QTensor(kind, w["shape"], {n: t.cuda() for n, t in w["planes"].items()})
        xs = case["x"].cuda()
        names = gemm_quant._KERNEL_PLANES[FORM_KIND[kind]]
        w32 = dequantize(qt)
        if "offsets" in case:
            off = torch.tensor(case["offsets"], dtype=torch.int32, device="cuda")
            name = gemm_quant.GROUPED_FORMS[FORM_KIND[kind]]
            fn = lambda: getattr(gemm_quant, name)(xs, qt, off)  # noqa: E731
            want = getattr(gemm_quant, f"{name}_plain")(xs, *(qt.planes[n] for n in names), off)
            cuts = case["offsets"]
            segs = [(e, lo, hi) for e, (lo, hi) in enumerate(zip(cuts, cuts[1:])) if hi > lo]
            lib = lambda: torch.cat([torch.matmul(xs[lo:hi], w32[e].t())  # noqa: E731
                                     for e, lo, hi in segs])
        else:
            name = gemm_quant.DEQUANT_FORMS[FORM_KIND[kind]]
            fn = lambda: getattr(gemm_quant, name)(xs, qt)  # noqa: E731
            xp = cs._padded_x(xs, qt)
            want = getattr(gemm_quant, f"{name}_plain")(xp, *(qt.planes[n] for n in names))
            lib = lambda: torch.matmul(xs, w32[:, :xs.shape[1]].t())  # noqa: E731
        got = fn()
        torch.cuda.synchronize()
        errors[key] = ((got - want).abs().max() / want.abs().max()).item()
        times[key] = timer(fn)
        library[key] = timer(lib)
        del qt, w32, got, want
        torch.cuda.empty_cache()
    return {"root": root, "ms": times, "library_ms": library, "rel_err": errors}


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    cs = _chip_smoke()
    other = str(Path(sys.argv[1]).resolve())
    print(f"gpu: {cs.gpu_tag()}", flush=True)
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        cases_path = str(Path(tmp) / "cases.pt")
        cases = make_cases(cs)
        torch.save(cases, cases_path)
        labels = [c["label"] for c in cases]
        kinds = {c["label"]: "flash" if "flash" in c else "matmul" for c in cases}
        del cases
        for root in (other, str(THIS_ROOT), str(THIS_ROOT), other):
            out = subprocess.run([sys.executable, __file__, "--child", root, cases_path],
                                 capture_output=True, text=True, cwd=root)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                return 1
            turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
            print(json.dumps(turns[-1]), flush=True)
    worst = {kind: max(t["rel_err"][k] for t in turns for k in labels if kinds[k] == kind)
             for kind in TOL}
    for key in labels:
        o = [turns[0]["ms"][key], turns[3]["ms"][key]]
        t = [turns[1]["ms"][key], turns[2]["ms"][key]]
        lib = [tt["library_ms"][key] for tt in turns]
        print(json.dumps({"shape": key, "other_ms": o, "this_ms": t,
                          "this_over_other": statistics.mean(t) / statistics.mean(o),
                          "library_ms": None if None in lib else statistics.mean(lib),
                          "rel_err": {"other": turns[0]["rel_err"][key],
                                      "this": turns[1]["rel_err"][key]}}))
    print(json.dumps({"worst_rel_err": worst, "tolerance": TOL}))
    return 0 if all(worst[kind] <= TOL[kind] for kind in TOL) else 1


if __name__ == "__main__":
    sys.exit(main())

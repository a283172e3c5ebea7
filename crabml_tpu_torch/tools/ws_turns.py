"""Time the dequant forms on csrc/qmm_ws.cuh (qmm_q5k, qmm_q6k, qmm_q3k,
qmm_q2k), dense and grouped, and the prefill of a synthetic 7B file that
runs each, in two checkouts of the port in turns, on one card.

    python -m crabml_tpu_torch.tools.ws_turns OTHER_ROOT [FORM ...]   # needs one CUDA card

OTHER_ROOT is another checkout of the repository (for example an earlier
commit unpacked with `git archive` into a directory that git ignores). FORM
is q5_k, q6_k, q3_k or q2_k (all four when none is named). The inputs are
made once, from numpy seeds, and saved, and a GGUF file a form (7B widths at
LAYERS of 32 layers, from tools/synth_gguf.py: llama.cpp's Q5_K_M and Q3_K_M
layouts, every matrix Q6_K, and llama.cpp's Q2_K layout, where q, k and
gate|up are Q2_K) is written once; then the turns run in the order other,
this, this, other, each in a process of its own that imports
`crabml_tpu_torch` from that checkout and builds its kernels there. Each turn
times, with `chip_smoke.py`'s `Timer` (L2 emptied by a write before each
launch):
- each form at 512, 189, 1,024, 37 and 17 rows of the 7B q|k|v
  (4096 -> 6144), 189 rows of wo (4096 -> 4096) and 512 rows of down
  (14336 -> 4096), bfloat16 out as the prefill writes it; beside each,
  `torch.matmul` on the dequantized bf16 weight;
- their grouped forms on `chip_smoke.py`'s 1,024 (row, slot) pairs of the
  Mixtral gate|up stack (8 x 28672 x 4096) and down stack (8 x 4096 x
  14336); beside each, `torch.matmul` per segment;
and, on the host clock ending in `synchronize`, the prefill of the ~700-token
prompt (two chunks, 512 + 189) of each file through the `Runner`, with its
W8 planes (the 189-row chunk on the scheme's dequant kernel) and without
(both chunks there), the median of PREFILLS after a warm one, with the matmul
launches of one prefill; and from a torch.profiler window over one more
prefill, the card's busy time (the sum of its kernels' durations) and the
part of it in the four forms' dequant kernels: the host clock of a
prefill spreads by tens of percent from one process to the next on a shared
host, the device's times do not. Each turn also holds every kernel output against
its plain version (max|out - plain| / max|plain|): the run fails past 1e-4
(chip_smoke.py's gate on the bfloat16 dequant forms).

Prints the card and its power limit, one JSON line a turn, then one JSON line
a shape (and a prefill) with each checkout's two times, the ratio of their
means and the library's mean.
"""

from __future__ import annotations

import importlib.util
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

THIS_ROOT = Path(__file__).resolve().parents[2]
TOL = 1e-4  # chip_smoke.py's gate on the bfloat16 dequant forms
LAYERS = 8  # of the 7B's 32: the layers' matmuls, not the lm_head, take most of the time
PREFILLS = 7  # timed prefills a route, after a warm one: the host clock spreads
# form -> its file: (name, scheme, seed, llama.cpp layout)
# (Q5_K and Q3_K first: their seeds are the ones their earlier timings used)
FILES = {"q5_k": ("7b-q5_k_m", "q5_k", 163, "k_m"), "q3_k": ("7b-q3_k_m", "q3_k", 165, "k_m"),
         "q6_k": ("7b-q6_k", "q6_k", 167, None), "q2_k": ("7b-q2_k", "q2_k", 169, "q2_k")}
# the dequant kernels' sources on csrc/qmm_ws.cuh, as their kernels' names carry
# them (and the parent's: qmm_pipe.cuh's Q6KSource and qk16::Source<false>)
WS_SOURCES = ("Q5KSource", "Q6KSource", "Source<true>", "Source<false>")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", THIS_ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _weight(scheme: str, shape: tuple, seed: int) -> dict:
    """{kind, shape, planes}: random blocks of `scheme` in the port's kernel
    layout with bf16 scales, on the CPU."""
    import numpy as np
    import torch

    from crabml_tpu_torch.quant.qtensor import to_kernel_layout, to_planar
    from crabml_tpu_torch.tools.synth_gguf import SCHEMES

    kind, blocks = SCHEMES[scheme]
    raw = blocks(np.random.default_rng(seed), math.prod(shape), 1.0 / math.sqrt(shape[-1]))
    qt = to_kernel_layout(to_planar(kind, raw, shape, "cpu"), torch.bfloat16)
    return {"kind": int(kind), "shape": shape, "planes": dict(qt.planes)}


def make_cases(cs, forms) -> list[dict]:
    """The timed cases of `forms`: label, weight, x (and offsets where grouped)."""
    import numpy as np
    import torch

    def x(rows, k, seed):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal((rows, k))
                                .astype(np.float32)).to(torch.bfloat16)

    cases = []
    for scheme in forms:
        i = list(FILES).index(scheme)
        qkv = _weight(scheme, (cs.QKV_M, cs.DIM), 950 + i)
        for rows in (cs.PREFILL_CHUNK, cs.RAGGED_CHUNK, 2 * cs.PREFILL_CHUNK, 37, 17):
            cases.append({"label": f"{scheme} {rows}x{cs.DIM} @ ({cs.QKV_M}x{cs.DIM})^T",
                          "w": qkv, "x": x(rows, cs.DIM, 960 + i + rows)})
        cases.append({"label": f"{scheme} {cs.RAGGED_CHUNK}x{cs.DIM} @ ({cs.DIM}x{cs.DIM})^T",
                      "w": _weight(scheme, (cs.DIM, cs.DIM), 952 + i),
                      "x": x(cs.RAGGED_CHUNK, cs.DIM, 962 + i)})
        cases.append({"label": f"{scheme} {cs.PREFILL_CHUNK}x{cs.FFN} @ ({cs.DIM}x{cs.FFN})^T",
                      "w": _weight(scheme, (cs.DIM, cs.FFN), 954 + i),
                      "x": x(cs.PREFILL_CHUNK, cs.FFN, 964 + i)})
        pairs = sum(cs.GROUPED_COUNTS)
        offsets = [0, *np.cumsum(cs.GROUPED_COUNTS).tolist()]
        for m, k, seed in ((2 * cs.FFN, cs.DIM, 956), (cs.DIM, cs.FFN, 958)):
            cases.append({"label": f"{scheme} grouped {pairs} pairs x{k} @ "
                                   f"({cs.MOE_EXPERTS}x{m}x{k})^T",
                          "w": _weight(scheme, (cs.MOE_EXPERTS, m, k), seed + i),
                          "x": x(pairs, k, seed + 10 + i), "offsets": offsets})
    return cases


def _kernel_turn(cs, torch, case, timer) -> tuple:
    """(ms, library ms, error against the plain version) of one case."""
    from crabml_tpu_torch.gguf.constants import GGMLType
    from crabml_tpu_torch.ops.cuda import gemm_quant
    from crabml_tpu_torch.quant.qtensor import FORM_KIND, QTensor, dequantize

    w = case["w"]
    kind = GGMLType(w["kind"])
    qt = QTensor(kind, w["shape"], {n: t.cuda() for n, t in w["planes"].items()})
    xs = case["x"].cuda()
    planes = [qt.planes[n] for n in gemm_quant._KERNEL_PLANES[FORM_KIND[kind]]]
    wb = dequantize(qt, torch.bfloat16)
    if "offsets" in case:
        off = torch.tensor(case["offsets"], dtype=torch.int32, device="cuda")
        name = gemm_quant.GROUPED_FORMS[FORM_KIND[kind]]
        fn = lambda: getattr(gemm_quant, name)(xs, qt, off, torch.bfloat16)  # noqa: E731
        want = getattr(gemm_quant, f"{name}_plain")(xs, *planes, off)
        got = getattr(gemm_quant, name)(xs, qt, off)
        cuts = case["offsets"]
        segs = [(e, lo, hi) for e, (lo, hi) in enumerate(zip(cuts, cuts[1:])) if hi > lo]
        lib = lambda: torch.cat([torch.matmul(xs[lo:hi], wb[e].t())  # noqa: E731
                                 for e, lo, hi in segs])
    else:
        name = gemm_quant.DEQUANT_FORMS[FORM_KIND[kind]]
        fn = lambda: getattr(gemm_quant, name)(xs, qt, torch.bfloat16)  # noqa: E731
        want = getattr(gemm_quant, f"{name}_plain")(xs, *planes)
        got = getattr(gemm_quant, name)(xs, qt)
        lib = lambda: torch.matmul(xs, wb.t())  # noqa: E731
    torch.cuda.synchronize()
    err = ((got - want).abs().max() / want.abs().max()).item()
    out = (timer(fn), timer(lib), err)
    del qt, wb, got, want
    torch.cuda.empty_cache()
    return out


def _device_ms(torch, fn) -> tuple[float, float]:
    """(busy ms, ms of the four forms' dequant kernels) of the card in one
    call of fn, from torch.profiler's kernel events (the kernels' names carry
    their weight source: WS_SOURCES)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ms = lambda es: sum(e.time_range.elapsed_us() for e in es) / 1e3  # noqa: E731
    return ms(kernels), ms([e for e in kernels if any(w in e.name for w in WS_SOURCES)])


def _prefill_turn(cs, torch, path: str) -> dict:
    """The prefill of chip_smoke.py's prompt through a Runner with W8 planes
    and one without: ms (median of PREFILLS after a warm one), the matmul
    launches of one prefill, and the card's busy time in one more."""
    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.runtime.runner import Runner

    prompt = cs.PROMPT_SENTENCE * cs.PROMPT_REPEATS
    out = {}
    for w8 in (True, False):
        runner = Runner(path, prefill_w8=w8)
        runner.reset()
        runner.prefill(prompt)
        torch.cuda.synchronize()
        ms = []
        for _ in range(PREFILLS):
            runner.reset()
            _build.launches.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.prefill(prompt)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        runner.reset()
        busy, dequant = _device_ms(torch, lambda: runner.prefill(prompt))
        out["w8" if w8 else "no_w8"] = {
            "ms": statistics.median(ms), "tokens": len(runner.tokenizer.encode(prompt, bos=True)),
            "launches": {k: v for k, v in _build.launches.items() if k.startswith("qmm")},
            "device_busy_ms": busy, "dequant_device_ms": dequant}
        del runner
        torch.cuda.empty_cache()
    return out


def child(root: str, cases_path: str, files: list[str]) -> dict:
    """One turn: the kernels and the prefills of checkout `root`."""
    cs = _chip_smoke()
    sys.path.insert(0, root)
    import torch

    import crabml_tpu_torch

    assert Path(crabml_tpu_torch.__file__).resolve().parents[1] == Path(root).resolve()
    timer = cs.Timer(torch)
    cases = torch.load(cases_path, weights_only=False)
    times, library, errors = {}, {}, {}
    # the first case twice: a process's first timing reads slow, the second counts
    for case in cases[:1] + cases:
        times[case["label"]], library[case["label"]], errors[case["label"]] = \
            _kernel_turn(cs, torch, case, timer)
    del cases, timer
    torch.cuda.empty_cache()
    prefill = {Path(p).stem: _prefill_turn(cs, torch, p) for p in files}
    return {"root": root, "ms": times, "library_ms": library, "rel_err": errors,
            "prefill": prefill}


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2], sys.argv[3], json.loads(sys.argv[4]))), flush=True)
        return 0
    forms = tuple(sys.argv[2:]) or tuple(FILES)
    if len(sys.argv) < 2 or not set(forms) <= set(FILES):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("ws_turns: needs a CUDA card", file=sys.stderr)
        return 1
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    cs = _chip_smoke()
    other = str(Path(sys.argv[1]).resolve())
    print(f"gpu: {cs.gpu_tag()}", flush=True)
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        cases_path = str(Path(tmp) / "cases.pt")
        cases = make_cases(cs, forms)
        torch.save(cases, cases_path)
        labels = [c["label"] for c in cases]
        del cases
        files = [build_synth_gguf(str(Path(tmp) / f"{what}.gguf"), "7b", seed=seed,
                                  layers=LAYERS, scheme=scheme, mix=mix)
                 for what, scheme, seed, mix in (FILES[f] for f in forms)]
        for root in (other, str(THIS_ROOT), str(THIS_ROOT), other):
            out = subprocess.run([sys.executable, __file__, "--child", root, cases_path,
                                  json.dumps(files)], capture_output=True, text=True, cwd=root)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                return 1
            turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
            print(json.dumps(turns[-1]), flush=True)
    worst = max(t["rel_err"][k] for t in turns for k in labels)
    for key in labels:
        o = [turns[0]["ms"][key], turns[3]["ms"][key]]
        t = [turns[1]["ms"][key], turns[2]["ms"][key]]
        print(json.dumps({"shape": key, "other_ms": o, "this_ms": t,
                          "this_over_other": statistics.mean(t) / statistics.mean(o),
                          "library_ms": statistics.mean(tt["library_ms"][key] for tt in turns),
                          "rel_err": {"other": turns[0]["rel_err"][key],
                                      "this": turns[1]["rel_err"][key]}}))
    for what in turns[0]["prefill"]:
        for route in ("w8", "no_w8"):
            rec = {key: [turns[i]["prefill"][what][route][key] for i in (0, 3, 1, 2)]
                   for key in ("ms", "device_busy_ms", "dequant_device_ms")}
            o, t = rec["ms"][:2], rec["ms"][2:]
            print(json.dumps({"prefill": f"{what} ({LAYERS} of 32 layers), {route}",
                              "tokens": turns[1]["prefill"][what][route]["tokens"],
                              "other_ms": o, "this_ms": t,
                              "this_over_other": statistics.mean(t) / statistics.mean(o),
                              "device_busy_ms": {"other": rec["device_busy_ms"][:2],
                                                 "this": rec["device_busy_ms"][2:]},
                              "dequant_device_ms": {"other": rec["dequant_device_ms"][:2],
                                                    "this": rec["dequant_device_ms"][2:]},
                              "launches": {"other": turns[0]["prefill"][what][route]["launches"],
                                           "this": turns[1]["prefill"][what][route]["launches"]}}))
    print(json.dumps({"worst_rel_err": worst, "tolerance": TOL}))
    return 0 if worst <= TOL else 1


if __name__ == "__main__":
    sys.exit(main())

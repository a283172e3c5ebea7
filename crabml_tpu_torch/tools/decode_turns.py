"""Time the 7B's decode and serving paths of two checkouts of the port in
turns, on one card.

    python -m crabml_tpu_torch.tools.decode_turns OTHER_ROOT    # needs one CUDA card

OTHER_ROOT is another checkout of the repository (for example an earlier
commit unpacked with `git archive` into a directory that git ignores). The
synthetic 7B Q4_K GGUF of `chip_smoke.py`'s main path (`tools/synth_gguf.py`
"7b", seed 0, all 32 layers) is written once; then the turns run in the
order other, this, this, other, each in a process of its own that imports
`crabml_tpu_torch` from that checkout and builds its kernels there. Each
turn, with `chip_smoke.py`'s own measures:
- `Runner(path)` in bfloat16 (the main path) and
  `Runner(path, compute_dtype=float32, kv_dtype=bfloat16, prefill_w8=False)`
  (the 7b-f32 path): the ~700-token prompt prefilled and 128 greedy tokens
  decoded twice, the second replaying the captured graph of the step
  (`_one_run`: prefill ms, decode ms a token), and a torch.profiler window
  of 16 graphed tokens (`_profile_decode`: device busy ms and device
  launches a token);
- the bfloat16 Runner's 8-slot PagedServingEngine with every slot decoding
  (`_profile_ticks`: ms a tick, device busy ms and launches a tick).

Prints the card and its power limit, one JSON line a turn, then one JSON
line a measure with each checkout's two values and the ratio of their means,
and whether the checkouts' greedy tokens agree.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

THIS_ROOT = Path(__file__).resolve().parents[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", THIS_ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root: str, path: str) -> dict:
    """One turn: checkout `root`'s Runner in both dtypes and its paged engine
    on the 7B file at `path`."""
    cs = _chip_smoke()
    sys.path.insert(0, root)
    import torch

    import crabml_tpu_torch
    from crabml_tpu_torch.ops.cuda import _build
    from crabml_tpu_torch.runtime.runner import Runner
    from crabml_tpu_torch.serving import PagedServingEngine

    assert Path(crabml_tpu_torch.__file__).resolve().parents[1] == Path(root).resolve()
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.TAG = cs.gpu_tag()
    prompt = cs.PROMPT_SENTENCE * cs.PROMPT_REPEATS
    out, tokens = {}, {}
    for what, kw in (("bf16", {}), ("f32", dict(compute_dtype=torch.float32,
                                                kv_dtype=torch.bfloat16, prefill_w8=False))):
        runner = Runner(path, **kw)
        cs._one_run(runner, prompt, _build.launches)  # captures the step's graph
        run = cs._one_run(runner, prompt, _build.launches)
        prof = cs._profile_decode(runner, prompt, run["decode_ms_per_token"])
        out[f"{what}_prefill_ms"] = run["prefill_s"] * 1e3
        out[f"{what}_decode_ms_per_token"] = run["decode_ms_per_token"]
        out[f"{what}_device_ms_per_token"] = prof.get("device_ms_per_token")
        out[f"{what}_device_launches_per_token"] = prof.get("device_launches_per_token")
        tokens[what] = run["tokens"]
        if what == "bf16":
            eng = PagedServingEngine(runner, n_slots=cs.SERVING_SLOTS, n_pages=cs.SERVING_PAGES,
                                     seq_len=cs.CTX, seed=7)
            tick = cs._profile_ticks(eng, seed=22)
            out["tick_ms"] = tick["ms_per_tick"]
            out["tick_device_ms"] = tick.get("device_ms_per_tick")
            out["tick_device_launches"] = tick.get("device_launches_per_tick")
            del eng
        del runner
        torch.cuda.empty_cache()
    return {"root": root, "measures": out, "tokens": tokens}


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    cs = _chip_smoke()
    sys.path.insert(0, str(THIS_ROOT))
    from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf

    other = str(Path(sys.argv[1]).resolve())
    print(f"gpu: {cs.gpu_tag()}", flush=True)
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        path = build_synth_gguf(str(Path(tmp) / "synth-7b.gguf"), "7b", seed=0)
        for root in (other, str(THIS_ROOT), str(THIS_ROOT), other):
            out = subprocess.run([sys.executable, __file__, "--child", root, path],
                                 capture_output=True, text=True, cwd=root)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                return 1
            turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
            print(json.dumps(turns[-1]["measures"]), flush=True)
    for key in turns[0]["measures"]:
        o = [turns[0]["measures"][key], turns[3]["measures"][key]]
        t = [turns[1]["measures"][key], turns[2]["measures"][key]]
        ratio = None if None in o + t else statistics.mean(t) / statistics.mean(o)
        print(json.dumps({"measure": key, "other": o, "this": t, "this_over_other": ratio}))
    same = {what: turns[0]["tokens"][what] == turns[1]["tokens"][what]
            for what in turns[0]["tokens"]}
    first_off = {what: next((i for i, (a, b) in enumerate(zip(turns[0]["tokens"][what],
                                                               turns[1]["tokens"][what]))
                             if a != b), None) for what in same}
    print(json.dumps({"greedy_tokens_agree": same, "first_differing_token": first_off}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

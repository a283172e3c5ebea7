"""CLI: generate text from a GGUF model with the port.

  python -m crabml_tpu_torch.cli model.gguf -p "Once upon a time" -n 64
  python -m crabml_tpu_torch.cli model.gguf -p "..." -n 16 --device cpu
  python -m crabml_tpu_torch.cli model.gguf -p "..." --dtype f32 --kv-dtype int8 -v
  python -m crabml_tpu_torch.cli model.gguf -p "..." --speculative 4 --device cpu
  python -m crabml_tpu_torch.cli model.gguf -p "..." --draft small.gguf

The flags of crabml_tpu/cli.py's generation: --dtype, --kv-dtype,
--probability (top-p), -v (the file's metadata before, the metrics table
after), --seq-len, --seed, --mlock, and speculative decoding's --speculative
K and --draft GGUF (greedy runs; the tokens are plain greedy decode's). --dtype defaults to bf16 on the card
and f32 on the CPU; the JAX package's CLI defaults to f32 everywhere.

Runs on `cuda` unless `--device` says otherwise; without a card it exits
with an error rather than falling back to the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="crabml-tpu-torch")
    ap.add_argument("model", help="path to GGUF model file")
    ap.add_argument("-p", "--prompt", default="Once upon a time")
    ap.add_argument("-n", "--steps", type=int, default=300)
    ap.add_argument("-t", "--temperature", type=float, default=0.0)
    ap.add_argument("--probability", type=float, default=0.9, help="top-p")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print the file's metadata before and the metrics table after")
    ap.add_argument("--dtype", default=None, choices=["f32", "bf16"],
                    help="compute dtype (default: bf16 on the card, f32 on the CPU)")
    ap.add_argument("--kv-dtype", default=None, choices=["f32", "bf16", "int8"],
                    help="KV cache dtype (default: the compute dtype)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="KV cache length (default and most: the model's context)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="prompt-lookup speculative decoding with draft length K (greedy "
                         "runs): drafts from the sequence's own history, K + 1 tokens "
                         "verified a step; the tokens are plain greedy decode's")
    ap.add_argument("--draft", metavar="GGUF", default=None,
                    help="two-model speculative decoding: a small draft GGUF of the same "
                         "vocabulary; implies --speculative 4 unless it is given")
    ap.add_argument("--seed", type=int, default=0, help="the sampler's seed")
    ap.add_argument("--mlock", action="store_true",
                    help="mlock(2) the weight mmap (best effort)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu to run on the CPU)")
    ap.add_argument("--prefill-w8", dest="prefill_w8", action="store_true", default=None,
                    help="attach the W8 prefill planes (int8 weights beside the quantized "
                         "planes: 8 more bits a weight of device memory). Default: "
                         "what fits the card's free memory; never on the CPU.")
    ap.add_argument("--no-prefill-w8", dest="prefill_w8", action="store_false",
                    help="leave the W8 prefill planes out")
    ap.add_argument("--kv-lane-pad", action="store_true",
                    help="accepted as the JAX package's CLI takes it, and changes nothing: "
                         "the attention kernels take head dims 80 and 96 as they are")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from .gguf.reader import GGUFFile
    from .runtime.runner import Runner
    from .runtime.sampler import Sampler
    from .utils import resolve_device

    device = resolve_device(args.device)  # raises before the file is opened
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8, None: None}
    dtype = dtypes[args.dtype] or (torch.float32 if device.type == "cpu" else torch.bfloat16)
    gf = GGUFFile(args.model, mlock=args.mlock)
    if args.verbose:
        print("== metadata ==", file=sys.stderr)
        for k, v in gf.metadata.as_dict().items():
            s = str(v)
            print(f"  {k}: {s[:80]}{'...' if len(s) > 80 else ''}", file=sys.stderr)
    runner = Runner(gf, seq_len=args.seq_len, compute_dtype=dtype,
                    kv_dtype=dtypes[args.kv_dtype],
                    sampler=Sampler(temperature=args.temperature, topp=args.probability),
                    seed=args.seed, device=device, prefill_w8=args.prefill_w8,
                    kv_lane_pad=args.kv_lane_pad, speculative=args.speculative,
                    draft_model=args.draft)
    t0 = time.perf_counter()
    print(args.prompt, end="", flush=True)
    for piece in runner.prefill_and_generate(args.prompt, args.steps):
        print(piece, end="", flush=True)
    wall = time.perf_counter() - t0
    print()
    m = runner.metrics
    where = (torch.cuda.get_device_name(runner.device) if runner.device.type == "cuda"
             else "cpu")
    print(f"\n{m.counts.get('tokens', 0)} tokens, {m.tokens_per_sec():.2f} tokens/s, "
          f"prefill {m.times_ns.get('prefill', 0) / 1e6:.0f} ms, total {wall:.2f} s "
          f"on {where}", file=sys.stderr)
    if args.verbose:
        print(m.table(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

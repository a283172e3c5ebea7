"""CLI: generate text from a GGUF model with the port.

  python -m crabml_tpu_torch.cli model.gguf -p "Once upon a time" -n 64
  python -m crabml_tpu_torch.cli model.gguf -p "..." -n 16 --device cpu
  python -m crabml_tpu_torch.cli model.gguf -p "..." --no-prefill-w8

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
    ap.add_argument("-n", "--steps", type=int, default=64)
    ap.add_argument("-t", "--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu to run on the CPU)")
    ap.add_argument("--prefill-w8", dest="prefill_w8", action="store_true", default=None,
                    help="attach the W8 prefill planes (int8 weights beside the Q4_K "
                         "planes: 8 more bits a weight of device memory). Default: "
                         "what fits the card's free memory; never on the CPU.")
    ap.add_argument("--no-prefill-w8", dest="prefill_w8", action="store_false",
                    help="leave the W8 prefill planes out")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from .runtime.runner import Runner
    from .runtime.sampler import Sampler

    dtype = torch.float32 if args.device == "cpu" else torch.bfloat16
    runner = Runner(args.model, compute_dtype=dtype,
                    sampler=Sampler(temperature=args.temperature), device=args.device,
                    prefill_w8=args.prefill_w8)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())

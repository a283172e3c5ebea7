"""Named wall-time counters — the analogue of TensorMetrics
(crabml-core/src/tensor/metrics.rs:5-30): context-manager guards accumulate
nanoseconds into named counters; `table()` renders the reference's
--verbose-style sorted cost table (crabml-cli/src/main.rs:188-205), as
crabml_tpu/utils/metrics.py does."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Metrics:
    def __init__(self):
        self.times_ns: dict[str, int] = defaultdict(int)
        self.counts: dict[str, int] = defaultdict(int)

    @contextmanager
    def track(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.times_ns[name] += time.perf_counter_ns() - t0
            self.counts[name + "_calls"] += 1

    def count(self, name: str, n: int = 1):
        self.counts[name] += n

    def reset(self):
        self.times_ns.clear()
        self.counts.clear()

    def table(self) -> str:
        """The timers by time, longest first, in ms; then the plain counts."""
        rows = sorted(self.times_ns.items(), key=lambda kv: -kv[1])
        lines = [f"{k:24s} {v / 1e6:10.3f} ms" for k, v in rows]
        for k, v in self.counts.items():
            if not k.endswith("_calls"):
                lines.append(f"{k:24s} {v:10d}")
        return "\n".join(lines)

    def tokens_per_sec(self) -> float:
        toks = self.counts.get("tokens", 0)
        ns = self.times_ns.get("decode", 0)
        return toks / (ns / 1e9) if ns else 0.0

"""Structured JSONL metrics + step timing (the JAX package's utils/metrics.py),
and the program's spans.

Every train/eval event is one JSON line with step, loss, accuracy, qa_pairs/sec
and p50 latency, mirrored as a short human-readable line on stderr.

`span(name)` marks a layer of the program (the loader, the train step's
forward, backward and optimizer, an evaluation's tables, cache and answers) as
a named range in a torch.profiler trace, beside the card's kernels and copies
on the same clock. It records only while a profiler runs (`cli train
--profile`, or any torch.profiler window around the program's calls);
otherwise it is one shared no-op context.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import torch

_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that records the range `name` on the calling thread while a
    torch profiler records, else the shared no-op context."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class Timer:
    """Tracks per-step wall time; reports throughput and p50 latency."""

    def __init__(self):
        self.samples: list[float] = []
        self._t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            raise RuntimeError("Timer.stop() without start()")
        self.samples.append(time.perf_counter() - self._t0)
        self._t0 = None

    @property
    def running(self) -> bool:
        return self._t0 is not None

    def p50(self) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        return s[len(s) // 2]

    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    def reset(self):
        """Clear samples AND any open window (a reset mid-window discards it)."""
        self.samples = []
        self._t0 = None


class MetricsLogger:
    """Append-only JSONL metrics file + mirrored human-readable stderr line."""

    def __init__(self, path: str | None, echo: bool = True):
        self.f = open(path, "a") if path else None
        self.echo = echo

    def log(self, event: str, **fields):
        rec = {"event": event, "time": time.time(), **fields}
        if self.f:
            self.f.write(json.dumps(rec) + "\n")
            self.f.flush()
        if self.echo:
            brief = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in fields.items()
            )
            print(f"[{event}] {brief}", file=sys.stderr, flush=True)

    def close(self):
        if self.f:
            self.f.close()
            self.f = None

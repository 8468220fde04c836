"""The traced stretch of a run: torch.profiler over a few units of work, read
back from its chrome trace.

`profile` runs `units` calls of `step` inside one record_function range
(WINDOW) that ends after a device synchronise, so the range holds every
device operation the units caused. `Trace` reads from the trace:

- the window: the host range, its length `window_s`;
- device operations (kernels, copies, sets) inside it, and `busy_s`, the
  length of their union;
- host launch calls (runtime and driver calls that enqueue work: kernel
  launches, async copies and sets);
- the breakdown: device time by operation name, and idle gaps (the window
  less the device's union) by what the host's main thread was doing at each
  gap's middle (its innermost range), both summed by name.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

import torch

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_RE = re.compile(r"Launch|Memcpy|Memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
NAME_CHARS = 120


def profile(step, units: int, sync, device) -> "Trace":
    """Trace `units` calls of step() (CPU and, on a card, CUDA activity)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            for _ in range(units):
                step()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    return Trace(events.get("traceEvents", events) if isinstance(events, dict) else events)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Trace:
    def __init__(self, events: list[dict]):
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in spans if e.get("name") == WINDOW
               and e.get("cat", "").lower() == "user_annotation"]
        if not win:
            raise RuntimeError(f"the trace holds no {WINDOW} range")
        w = max(win, key=lambda e: float(e["dur"]))
        self.w0, self.w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.main = (w.get("pid"), w.get("tid"))
        inside = lambda e: self.w0 <= float(e["ts"]) and float(e["ts"]) < self.w1
        cat = lambda e: e.get("cat", "").lower()
        self.device_ops = [(e["name"], float(e["ts"]), min(float(e["ts"]) + float(e["dur"]),
                                                           self.w1))
                           for e in spans if cat(e) in DEVICE_CATS and inside(e)]
        self.launches = sum(1 for e in spans if cat(e) in LAUNCH_CATS and inside(e)
                            and LAUNCH_RE.search(e["name"]))
        self.host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                            for e in spans if cat(e) in HOST_CATS and inside(e)
                            and (e.get("pid"), e.get("tid")) == self.main
                            and e["name"] != WINDOW), key=lambda x: x[0])
        self.busy = _union([(a, b) for _, a, b in self.device_ops])

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def kernel_s(self, names) -> float:
        """Device seconds of the operations whose name holds any of `names`."""
        return sum(b - a for n, a, b in self.device_ops if any(k in n for k in names)) * 1e-6

    def device_op_seconds(self, top: int = 10) -> list[list]:
        tot: dict[str, float] = {}
        for n, a, b in self.device_ops:
            key = n[:NAME_CHARS]
            tot[key] = tot.get(key, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        edges = [self.w0] + [x for iv in self.busy for x in iv] + [self.w1]
        mids = sorted(((a + b) / 2, b - a) for a, b in zip(edges[::2], edges[1::2]) if b > a)
        # the main thread's ranges nest: a sweep keeps the open ones on a stack,
        # whose top at a gap's middle is the innermost
        stack: list[tuple] = []
        tot: dict[str, float] = {}
        i = 0
        for t, length in mids:
            while i < len(self.host) and self.host[i][0] <= t:
                while stack and stack[-1][1] <= self.host[i][0]:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            key = stack[-1][2][:NAME_CHARS] if stack else "host outside any range"
            tot[key] = tot.get(key, 0.0) + length * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

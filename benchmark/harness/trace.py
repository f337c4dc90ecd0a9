"""The traced stretch of a --trace 1 run: torch.profiler over a few seconds
in the middle of the window, read back from its Chrome trace.

The profiler's first start on a process is slow (CUPTI comes up), so
`warm()` starts and stops it once during set-up.  Two annotations on the
host clock (`bench.mark`) tie the trace's timeline to time.perf_counter,
so that the benchmark's spans can be laid on the kernels.

The profiler starts and stops at a still point: the engine's device lock
held, so that no thread launches, and the card synchronized.  Started
while another thread launched kernels, it once recorded the copies of a
stretch and none of its kernels.  A stretch that holds no kernel is taken
again (`kernels()`, and the window's retry in harness/runner.py).

Stretch: the kernels and device copies/sets whose start lies in the
profiled interval; busy_s is the union of their intervals; idle gaps are
the holes in that union, each named by the innermost benchmark span that
covers its middle ("host" where none does).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Stretch:
    t0: float                        # host clock (perf_counter), seconds
    t1: float
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    # (name, start, end) in host-clock seconds, kernels only
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    busy_s: float = 0.0
    gaps: List[Tuple[float, float]] = field(default_factory=list)


def warm():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Tracer:
    """One traced stretch; start() again begins a new one in its place.
    lock: held while the profiler starts and stops (the engine's
    device_lock), so that no other thread launches meanwhile."""

    def __init__(self, lock=None):
        self.lock = contextlib.nullcontext() if lock is None else lock
        self.prof = None
        self.marks: List[float] = []
        self.tries = 0

    def _mark(self):
        with torch.profiler.record_function("bench.mark"):
            self.marks.append(time.perf_counter())

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.marks = []
        self.tries += 1
        with self.lock:
            torch.cuda.synchronize()
            self.prof.start()
            self._mark()

    def stop(self):
        with self.lock:
            self._mark()
            torch.cuda.synchronize()
            self.prof.stop()

    def kernels(self) -> int:
        """Kernels the stopped profiler recorded (device events that are
        not copies or sets)."""
        from torch.autograd import DeviceType
        return sum(1 for e in self.prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and not e.name().startswith(("Memcpy", "Memset")))

    def read(self) -> Stretch:
        tmp = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        marks = sorted(e["ts"] for e in events
                       if e.get("name") == "bench.mark"
                       and e.get("cat") == "user_annotation")
        if len(marks) < 2:
            raise RuntimeError("the trace lacks its bench.mark annotations")
        # trace microseconds -> host seconds, from the two marks
        off = sum(m / 1e6 - h for m, h in zip((marks[0], marks[-1]),
                                              (self.marks[0],
                                               self.marks[-1]))) / 2
        st = Stretch(self.marks[0], self.marks[-1])
        for e in events:
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            a = e["ts"] / 1e6 - off
            b = a + e["dur"] / 1e6
            if st.t0 <= a <= st.t1:
                st.device_ops.append((e["name"], a, b))
                if e["cat"] == "kernel":
                    st.kernels.append((e["name"], a, b))
        st.device_ops.sort(key=lambda k: k[1])
        st.kernels.sort(key=lambda k: k[1])
        busy, cur_a, cur_b = 0.0, None, None
        for _, a, b in st.device_ops:
            b = min(b, st.t1)
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                    st.gaps.append((cur_b, a))
                elif a > st.t0:
                    st.gaps.append((st.t0, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            busy += cur_b - cur_a
            if cur_b < st.t1:
                st.gaps.append((cur_b, st.t1))
        st.busy_s = busy
        return st


def breakdown(st: Stretch, spans) -> Dict:
    """The top 10 device operations by time, and the 10 longest idle gaps,
    each named by the innermost span covering its middle."""
    by_name: Dict[str, float] = {}
    for name, a, b in st.device_ops:
        key = name[:120]
        by_name[key] = by_name.get(key, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    for a, b in sorted(st.gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (a + b)
        cover = [s for s in spans if s[1] <= mid <= s[2]]
        label = (min(cover, key=lambda s: s[2] - s[1])[0] if cover
                 else "host")
        gaps.append([label, b - a])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}

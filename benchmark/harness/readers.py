"""Shared arithmetic of the metric readers (benchmark/metrics/*.py).

Percentiles are numpy's linear ones over every sample of the window.  A
reader that finds nothing to read returns None, and the run leaves its
metric out.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from roofline import counts

from .check import formats as check_formats

def percentile(values, q: float) -> Optional[float]:
    values = list(values)
    return float(np.percentile(values, q)) if values else None


def formats(run) -> Dict:
    return check_formats(run.config, run.extra["batch"])


def calls(run) -> List[tuple]:
    """The decode calls (online rounds, or stream chunk launches) whose
    spans end in the window."""
    return run.spans_named(run.round)


def stretch_calls(run) -> List[tuple]:
    """The decode calls that lie wholly in the traced stretch, in order."""
    st = run.stretch
    return [s for s in run.spans if s[0] == run.round
            and st.t0 <= s[1] and s[2] <= st.t1]


def kernels_by_call(run, pattern: str) -> List[Tuple[tuple, float]]:
    """(call span, device seconds) of the kernels whose name matches
    `pattern`, each given to the latest stretch call that started before
    it; only calls wholly in the stretch, and only kernels that ended
    before the stretch did."""
    st = run.stretch
    spans = stretch_calls(run)
    if st is None or not spans:
        return []
    rx = re.compile(pattern)
    starts = [s[1] for s in spans]
    total = [0.0] * len(spans)
    for name, a, b in st.kernels:
        if not rx.search(name) or b > st.t1:
            continue
        i = int(np.searchsorted(starts, a, side="right")) - 1
        if i >= 0:
            total[i] += b - a
    return [(s, t) for s, t in zip(spans, total) if t > 0]


def roofline(run, pattern: str, bound) -> Optional[float]:
    """100 * (least time of the calls' work) / (the matched kernels' device
    time); bound(span) -> (ops, bytes) of one call's kernels."""
    pairs = kernels_by_call(run, pattern)
    if not pairs:
        return None
    least = sum(counts.seconds(*bound(s)) for s, _ in pairs)
    return 100.0 * least / sum(t for _, t in pairs)


def launches_per_frame(run) -> Optional[float]:
    st = run.stretch
    spans = stretch_calls(run) if st is not None else []
    if not spans:
        return None
    a, b = spans[0][1], spans[-1][2]
    frames = sum(s[3]["frames"] for s in spans)
    n = sum(1 for _, ka, _ in st.kernels if a <= ka <= b)
    return n / frames if frames else None


def device_idle(run) -> Optional[float]:
    st = run.stretch
    if st is None or st.t1 <= st.t0:
        return None
    return 100.0 * (1.0 - st.busy_s / (st.t1 - st.t0))


def step_cursors(span) -> List[List[int]]:
    """The active lanes' KV lengths at each frame step of a decode call."""
    at = span[3]
    if "cursors" in at:
        return [[c + i for c in at["cursors"]] for i in range(at["n"])]
    return [[at["cursor"] + i] for i in range(at["frames"])]


def decode_mfu(run) -> Optional[float]:
    spans = calls(run)
    if not spans:
        return None
    fmt = formats(run)
    model = run.config["model"]
    least = sum(counts.seconds(*counts.frame_step(model, fmt, cur))
                for s in spans for cur in step_cursors(s) if cur)
    return 100.0 * least / run.seconds

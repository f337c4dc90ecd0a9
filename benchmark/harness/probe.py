"""What every kind of client (benchmark/clients/<kind>.py) shares: spans
from the benchmark's own wrappers around the program's calls (Probe), the
mix's sampler, and a request's copy for one submission.

Spans are (name, t0, t1, attrs) on the host clock of this process; nothing
in the program is changed.  A wrapper that finds the program's calls out
of the order it relies on records a fault instead of guessing; the run
then stops with that fault and prints no result (runner.execute).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from .traffic import Request


class Probe:
    """Spans of wrapped calls: (name, t0, t1, attrs) on the host clock."""

    def __init__(self):
        self.spans: List[tuple] = []
        self.fault: Optional[str] = None
        self._undo: List[tuple] = []

    def wrap(self, owner, attr: str, name: str, before=None, after=None):
        """Replace owner.attr by a wrapper that records a span; before(args,
        kwargs) -> attrs dict, after(result, attrs, args, kwargs)."""
        if not hasattr(owner, attr):
            raise RuntimeError(f"the benchmark wraps {owner!r}.{attr}, which "
                               "the program no longer has")
        orig = getattr(owner, attr)
        self._undo.append((owner, attr, owner.__dict__.get(attr, None),
                           attr in owner.__dict__))
        spans = self.spans

        def wrapper(*args, **kwargs):
            attrs = before(args, kwargs) if before else {}
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            t1 = time.perf_counter()
            if after:
                after(out, attrs, args, kwargs)
            spans.append((name, t0, t1, attrs))
            return out

        setattr(owner, attr, wrapper)

    def fail(self, why: str):
        """Record the first fault of the benchmark's view of the program."""
        if self.fault is None:
            self.fault = why

    def restore(self):
        for owner, attr, old, had in reversed(self._undo):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._undo.clear()


def sampler_config(mix: Dict, greedy: bool, seed: int):
    from qwen3_tts_tpu_torch.core.config import SamplerConfig
    s = mix["sampler"]
    return SamplerConfig(temperature=0.0 if greedy else s["temperature"],
                         top_k=s["top_k"], top_p=s["top_p"], seed=seed)


def fresh(tmpl: Request) -> Request:
    """A pool request's copy for one submission."""
    return Request(**{k: getattr(tmpl, k) for k in (
        "index", "text", "speaker", "instruct", "frames", "greedy", "rows",
        "gap_s")})

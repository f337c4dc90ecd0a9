"""Copy of qwen3_tts_tpu/utils/metrics.py: the port cannot import the JAX package,
whose __init__ imports jax.  Keep the two in step.

Per-stage timers and generation metrics.

The reference's only observability is two `Instant::now()` prints in the CLI
(bin/qwen3_tts.rs:79,144-161); here every generation records structured
metrics: prefill latency, first-chunk TTFT, per-chunk times, frames, audio
seconds, and RTF — queryable from the engine and printed by the CLI/bench.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class GenerationMetrics:
    prefill_ms: float = 0.0
    ttft_ms: Optional[float] = None       # time to first audible chunk
    chunk_ms: List[float] = field(default_factory=list)
    total_ms: float = 0.0
    frames: int = 0
    audio_seconds: float = 0.0
    eos: bool = False

    @property
    def rtf(self) -> float:
        if self.audio_seconds <= 0:
            return float("inf")
        return (self.total_ms / 1000.0) / self.audio_seconds

    def as_dict(self) -> Dict:
        return {
            "prefill_ms": round(self.prefill_ms, 2),
            "ttft_ms": round(self.ttft_ms, 2) if self.ttft_ms is not None else None,
            "total_ms": round(self.total_ms, 2),
            "frames": self.frames,
            "audio_seconds": round(self.audio_seconds, 3),
            "rtf": round(self.rtf, 4),
            "eos": self.eos,
        }


class Stopwatch:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap_ms(self) -> float:
        now = time.perf_counter()
        ms = (now - self.t0) * 1000.0
        self.t0 = now
        return ms

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1000.0

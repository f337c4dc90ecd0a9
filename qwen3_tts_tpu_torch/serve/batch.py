"""Request and result types of the batch schedulers.  Counterpart of
qwen3_tts_tpu/serve/batch.py (`BatchRequest`, `BatchResult`); its wave
scheduler, `BatchSynthesizer`, is not ported yet."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..io.audio import AudioSample
from ..io.voice_file import VoiceFile


@dataclass
class BatchRequest:
    text: str
    voice: VoiceFile
    instruct: Optional[str] = None
    max_frames: Optional[int] = None   # per-request frame budget (None = engine default)
    plan: object = None                # pre-built PromptPlan (skips the prompt build)


@dataclass
class BatchResult:
    audio: AudioSample
    frames: int
    eos: bool
    # Wall-clock ms from the scheduler's start to this request's FIRST
    # audio chunk (continuous batching fills it); None when the scheduler
    # does not track it.
    ttft_ms: Optional[float] = None

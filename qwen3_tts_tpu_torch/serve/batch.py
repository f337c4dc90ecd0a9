"""Wave batching and the request and result types of the batch schedulers.
Counterpart of qwen3_tts_tpu/serve/batch.py (`BatchRequest`, `BatchResult`,
`BatchSynthesizer`).

Requests are grouped into waves of `batch_size` streams; every stream of a
wave prefills together, right-padded to one prompt bucket (the longest
prompt's), so the whole wave decodes at one cursor.  On a chunk=True
engine a wave of 8 or 16 lanes (24 or 32 at the 4-frame serving chunk)
runs each chunk of frames as one chunk-kernel launch on the card; the
card's default engine runs its waves on the per-kernel step schedule,
which measured faster at 8-32 lanes (runtime/generate.gen_frames,
CHUNK_BATCHES).  A
stream finishes at EOS or its own frame budget; its lane keeps computing
until the wave drains (static batching; serve/continuous.py refills lanes
instead).  A short last wave is padded with copies of its first request,
each with that request's frame budget.

    synth = BatchSynthesizer(TtsEngine(device="cuda"), batch_size=8)
    results = synth.synthesize([BatchRequest(text, voice), ...])

Each wave runs through the engine's codec (runtime/codec: Generator.run_bulk,
or run_bulk_codes with the ONNX codec), with one host sync per chunk for
the early exit.  With the ONNX codec each lane's codes are then decoded
from a fresh decoder state, flushed: lanes with equal frame counts through
one decode_batch, a lane alone through decode (the JAX synthesizer's
rule).  Differences from the JAX synthesizer: no `mesh` (tensor and data
parallelism are not ported: ROADMAP Queue A item 15; it raises
NotImplementedError).  JAX's chunk-at-a-time
fallback (QTTS_BULK=0) is not ported: it gives the same audio, and the
streaming slice brings a chunked loop with a caller.  Pad lanes run to
their copied request's budget, not to the engine's max_steps as in JAX;
real lanes do not depend on it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import protocol as P_
from ..io.audio import AudioSample
from ..io.voice_file import VoiceFile
from ..runtime.generate import SamplerParams


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


def _result(samples: np.ndarray, frames: int, eos: bool) -> BatchResult:
    return BatchResult(audio=AudioSample(samples=samples.astype(np.float32),
                                         sample_rate=P_.SAMPLE_RATE,
                                         channels=1),
                       frames=int(frames), eos=bool(eos))


class BatchSynthesizer:
    """Synthesizes waves of `batch_size` streams on one engine's weights."""

    def __init__(self, engine, batch_size: int = 8, mesh=None):
        if mesh is not None:
            raise NotImplementedError("a device mesh (tensor and data "
                                      "parallelism) is not yet ported")
        self.engine = engine
        self.batch_size = int(batch_size)

    def synthesize(self, requests: Sequence[BatchRequest],
                   ) -> List[BatchResult]:
        out: List[BatchResult] = []
        with torch.no_grad():
            for lo in range(0, len(requests), self.batch_size):
                out.extend(self._run_wave(requests[lo:lo + self.batch_size]))
        return out

    # ------------------------------------------------------------------
    def _run_wave(self, wave: Sequence[BatchRequest]) -> List[BatchResult]:
        """One wave through Generator.run_bulk with per-lane budgets: a
        lane is done at EOS or its own budget, and the loop exits at the
        first chunk where every lane is."""
        eng = self.engine
        cfg = eng.config
        n_real = len(wave)
        b = self.batch_size

        plans = [r.plan if r.plan is not None
                 else eng._build_voice_prompt(r.text, r.voice, r.instruct)
                 for r in wave]
        plans = plans + [plans[0]] * (b - n_real)     # pad lanes
        bucket = eng._bucket(max(p.length for p in plans))
        seed = eng.sampler_config.seed
        if seed is None:
            seed = time.time_ns() & 0x7FFFFFFFFFFFFFFF
        state, _, bucket = eng.start_plans(
            plans, bucket, torch.Generator(device=eng.device).manual_seed(seed))
        sampler = SamplerParams.make(eng.sampler_config)
        budgets = [r.max_frames or eng.max_steps for r in wave]
        budgets = np.asarray(budgets + [budgets[0]] * (b - n_real), np.int64)
        # an over-budget request must not run past the KV capacity
        budgets = np.minimum(budgets,
                             min(eng.max_steps, cfg.runtime.max_steps))
        bt = torch.as_tensor(budgets.astype(np.int32), device=eng.device)
        codec = eng.codec
        state, cs, codes, valid, wav, saw_eos = codec.run_bulk(
            state, codec.new_state(b), sampler, prompt_cap=bucket,
            max_frames=int(budgets.max()), budgets=bt)
        valid_np = valid.cpu().numpy()
        eos_np = saw_eos.cpu().numpy()
        ks = [int(valid_np[i].sum()) if i < n_real else 0 for i in range(b)]
        wavs = codec.audio(wav.cpu().numpy(), codes.cpu().numpy(), ks, cs,
                           [True] * b)
        return [_result(wavs[i], ks[i], eos_np[i]) for i in range(n_real)]

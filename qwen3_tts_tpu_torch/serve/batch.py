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
rule).

On a mesh (parallel/mesh.py; `mesh=None` or a mesh of size 1 changes
nothing), every rank is called with the same requests and returns the
same list, as the single-controller JAX synthesizer does.  Each data rank
runs only its lanes `local_lane_slice(mesh, batch_size)` of every wave
(batch_size must split over the data ranks), with no collective on the
math: the wave's bucket and budgets are decided from the whole wave, its
sampled draws are the whole wave's (runtime/generate.LaneBlock, a shared
seed), its chunk loop exits when every rank's lanes are done, and the
finished results are gathered over the data group (all_gather_object).
With n_model > 1 the engine's weights are sharded once
(parallel/tp.shard_engine; the packed kernel layouts and full copies
dropped), and its own Generator then runs each wave on the JAX TP
schedule (models/transformer.decoder_forward on a rank's block: the exact
per-frame path; the fused step, predictor and chunk kernels pack
full-width layers and never run sharded), its codes decoded by the codec
on every rank of the model group.

JAX's chunk-at-a-time fallback (QTTS_BULK=0) is not ported: it gives the
same audio, and the streaming slice brings a chunked loop with a caller.
Pad lanes run to their copied request's budget, not to the engine's
max_steps as in JAX; real lanes do not depend on it.
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
from ..runtime.generate import LaneBlock, SamplerParams


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
    # the frames' codes, int32 [frames, 16] (the wave and continuous
    # schedulers fill it); None when the scheduler does not keep them
    codes: Optional[np.ndarray] = None


def _result(samples: np.ndarray, frames: int, eos: bool,
            codes: np.ndarray) -> BatchResult:
    return BatchResult(audio=AudioSample(samples=samples.astype(np.float32),
                                         sample_rate=P_.SAMPLE_RATE,
                                         channels=1),
                       frames=int(frames), eos=bool(eos),
                       codes=codes[:frames].copy())


def serving_mesh(engine, mesh, batch_size: int):
    """The mesh a serving class runs on: None for no mesh or a mesh of size
    1 (nothing changes).  batch_size must split over the data ranks; with
    n_model > 1 the engine's weights are sharded (parallel/tp.shard_engine)
    and its Generator and codec run on the blocks."""
    if mesh is None or mesh.size == 1:
        return None
    if batch_size % mesh.n_data:
        raise ValueError(f"batch_size {batch_size} does not split over "
                         f"{mesh.n_data} data ranks")
    if mesh.n_model > 1:
        from ..parallel.tp import shard_engine
        shard_engine(engine, mesh)
    return mesh


def lane_block(mesh, lanes: slice, total: int) -> Optional[LaneBlock]:
    """The LaneBlock of a data rank's lanes `lanes` of a batch of `total`
    (None without a mesh)."""
    if mesh is None:
        return None
    return LaneBlock(lanes.start, total, mesh.all_done)


class BatchSynthesizer:
    """Synthesizes waves of `batch_size` streams on one engine's weights,
    or on a mesh (module docstring)."""

    def __init__(self, engine, batch_size: int = 8, mesh=None):
        self.engine = engine
        self.batch_size = int(batch_size)
        self.mesh = serving_mesh(engine, mesh, self.batch_size)

    def synthesize(self, requests: Sequence[BatchRequest],
                   ) -> List[BatchResult]:
        out: List[BatchResult] = []
        with torch.no_grad():
            for lo in range(0, len(requests), self.batch_size):
                out.extend(self._run_wave(requests[lo:lo + self.batch_size]))
        return out

    def _start(self, plans, bucket: int, seed: int):
        """(state, lanes) of this rank's lanes of a wave of plans."""
        eng = self.engine
        gen = torch.Generator(device=eng.device).manual_seed(seed)
        if self.mesh is None:
            state, _, _ = eng.start_plans(plans, bucket, gen)
            return state, slice(0, len(plans))
        from ..parallel.distributed import local_lane_slice
        lanes = local_lane_slice(self.mesh, len(plans))
        embeds, lens = eng.prompt_to_device(plans[lanes], bucket)
        state = eng.generator.start(
            embeds, torch.from_numpy(lens).to(eng.device), gen)
        state.lanes = lane_block(self.mesh, lanes, len(plans))
        return state, lanes

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
        if self.mesh is not None:
            seed = self.mesh.shared_seed(seed)
        elif seed is None:
            seed = time.time_ns() & 0x7FFFFFFFFFFFFFFF
        state, lanes = self._start(plans, bucket, seed)
        sampler = SamplerParams.make(eng.sampler_config)
        budgets = [r.max_frames or eng.max_steps for r in wave]
        budgets = np.asarray(budgets + [budgets[0]] * (b - n_real), np.int64)
        # an over-budget request must not run past the KV capacity
        budgets = np.minimum(budgets,
                             min(eng.max_steps, cfg.runtime.max_steps))
        bt = torch.as_tensor(budgets[lanes].astype(np.int32),
                             device=eng.device)
        codec = eng.codec
        n = lanes.stop - lanes.start
        state, cs, codes, valid, wav, saw_eos = codec.run_bulk(
            state, codec.new_state(n), sampler, prompt_cap=bucket,
            max_frames=int(budgets.max()), budgets=bt)
        valid_np = valid.cpu().numpy()
        eos_np = saw_eos.cpu().numpy()
        real = range(lanes.start, min(lanes.stop, n_real))
        ks = [int(valid_np[i - lanes.start].sum()) if i in real else 0
              for i in range(lanes.start, lanes.stop)]
        codes_np = codes.cpu().numpy()
        wavs = codec.audio(wav.cpu().numpy(), codes_np, ks, cs, [True] * n)
        out = [_result(wavs[i - lanes.start], ks[i - lanes.start],
                       eos_np[i - lanes.start], codes_np[i - lanes.start])
               for i in real]
        if self.mesh is None:
            return out
        return [r for part in self.mesh.gather_data(out) for r in part]

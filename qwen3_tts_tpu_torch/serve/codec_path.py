"""The lane codec of the batch schedulers.  Counterpart of
qwen3_tts_tpu/serve/codec_path.py: a group of chunks of B lanes and the
lanes' audio, through the engine's codec (runtime/codec), whichever of the
two runs.

With the native codec each group of chunks runs through
Generator.run_bulk, which decodes every chunk to audio as it goes, and a
lane's samples are cut from the group's waveform.  With the published
ONNX decoder the group runs through Generator.run_bulk_codes, and each
lane keeps its own decoder state: lanes in lockstep (the same frame count
and state shapes) decode together through one decode_batch, a lane out of
step alone.

    codec = LaneCodec(engine, batch)
    state, codes_np, valid_np, saw_eos_np = codec.run_group(state, ...)
    state, codes_np, valid_np, saw_eos_np = codec.run_chunk(state, ...)
    samples = codec.chunk_audio(codes_np, ks, finals)    # per lane
    samples = codec.lane_audio(lane, codes_np[lane], k, final)  # one lane
    codec.reset_lanes(mask)                              # on refill

`run_chunk` (the online batcher's one chunk a round) is `run_group` of one
chunk: the lanes' remaining budgets mask `valid` and set `done` where a
lane reaches its budget, and `saw_eos` says which lanes sampled EOS (the
JAX online loop infers EOS from `valid.sum() < n_chunk` and clamps to the
budget on the host).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


class LaneCodec:
    def __init__(self, engine, batch: int):
        self.eng = engine
        self.codec = engine.codec
        self.b = int(batch)
        self.state = self.codec.new_state(self.b)
        self._wav_np: Optional[np.ndarray] = None

    def run_group(self, state, sampler, *, prompt_cap: int, n_frames: int,
                  max_frames: int, budgets, uniform_cursor: bool = False):
        """A group of up to max_frames // n_frames chunks of
        cfg.runtime.frames_per_chunk (= n_frames) frames, which stops
        early when every lane is done (EOS or its `budgets` entry, counted
        from the group's start).  Returns (state, codes_np [B, F, 16],
        valid_np [B, F], saw_eos_np [B])."""
        eng = self.eng
        if n_frames != eng.config.runtime.frames_per_chunk:
            raise ValueError(f"chunks of {n_frames} frames: the engine runs "
                             f"{eng.config.runtime.frames_per_chunk}")
        bt = torch.as_tensor(np.asarray(budgets, np.int32),
                             device=eng.device)
        with torch.no_grad():
            state, self.state, codes, valid, wav, saw_eos = \
                self.codec.run_bulk(state, self.state, sampler,
                                    prompt_cap=prompt_cap,
                                    max_frames=max_frames, budgets=bt,
                                    uniform_cursor=uniform_cursor)
        self._wav_np = wav.cpu().numpy()
        return (state, codes.cpu().numpy(), valid.cpu().numpy(),
                saw_eos.cpu().numpy())

    def run_chunk(self, state, sampler, *, prompt_cap: int, n_frames: int,
                  budgets):
        """One chunk of n_frames (= cfg.runtime.frames_per_chunk) frames at
        per-lane cursors: run_group with max_frames = n_frames.  budgets:
        [B] frames each lane may still emit (0 for an idle lane).  Returns
        (state, codes_np [B, n, 16], valid_np [B, n], saw_eos_np [B])."""
        return self.run_group(state, sampler, prompt_cap=prompt_cap,
                              n_frames=n_frames, max_frames=n_frames,
                              budgets=budgets)

    def chunk_audio(self, codes_np: np.ndarray, ks: np.ndarray,
                    finals: np.ndarray) -> List[np.ndarray]:
        """Waveforms of the last group: lane i's first ks[i] frames (none
        where ks[i] <= 0); with the ONNX codec lane i is flushed where
        finals[i] (the native codec needs no flush)."""
        return self.codec.audio(self._wav_np, codes_np, ks, self.state,
                                finals)

    def lane_audio(self, lane: int, lane_codes: np.ndarray, k: int,
                   is_final: bool) -> np.ndarray:
        """One lane's waveform of the last group: chunk_audio with every
        other lane at 0 frames.  lane_codes: [n, 16], the lane's row of
        run_group's codes_np."""
        ks = np.zeros(self.b, np.int64)
        ks[lane] = k
        finals = np.zeros(self.b, bool)
        finals[lane] = is_final
        codes = np.broadcast_to(lane_codes, (self.b,) + np.shape(lane_codes))
        return self.chunk_audio(codes, ks, finals)[lane]

    def reset_lanes(self, mask: np.ndarray) -> None:
        """A fresh codec state for the lanes in `mask` (bool [B])."""
        if mask.any():
            self.state = self.codec.reset_lanes(self.state, mask)

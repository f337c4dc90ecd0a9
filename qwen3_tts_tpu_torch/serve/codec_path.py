"""The lane codec of the batch schedulers.  Counterpart of
qwen3_tts_tpu/serve/codec_path.py with the native codec only: each group of
chunks runs through Generator.run_bulk, which decodes every chunk to audio
as it goes, and the scheduler takes each lane's samples from the group's
waveform.  The ONNX codec is not ported yet (ROADMAP Queue A item 12):

    codec = LaneCodec(engine, batch)
    state, codes_np, valid_np, saw_eos_np = codec.run_group(state, sampler, ...)
    samples = codec.chunk_audio(codes_np, ks, finals)    # per lane
    codec.reset_lanes(mask)                              # on refill
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models.codec import decoder as codec_decoder


class LaneCodec:
    def __init__(self, engine, batch: int):
        if getattr(engine, "onnx_decoder", None) is not None:
            raise NotImplementedError("the ONNX codec path is not yet ported")
        self.eng = engine
        self.b = int(batch)
        self.spf = engine.config.codec_decoder.samples_per_frame
        self._wav_np: Optional[np.ndarray] = None
        self.dec_state = codec_decoder.init_decoder_state(
            engine.config.codec_decoder, self.b, engine.device)

    def run_group(self, state, sampler, *, prompt_cap: int, n_frames: int,
                  max_frames: int, budgets, uniform_cursor: bool = False):
        """A group of up to max_frames // n_frames chunks of
        cfg.runtime.frames_per_chunk (= n_frames) frames through
        Generator.run_bulk, which stops early when every lane is done (EOS
        or its `budgets` entry, counted from the group's start).  Returns
        (state, codes_np [B, F, 16], valid_np [B, F], saw_eos_np [B])."""
        eng = self.eng
        if n_frames != eng.config.runtime.frames_per_chunk:
            raise ValueError(f"chunks of {n_frames} frames: the engine runs "
                             f"{eng.config.runtime.frames_per_chunk}")
        bt = torch.as_tensor(np.asarray(budgets, np.int32),
                             device=eng.device)
        with torch.no_grad():
            state, self.dec_state, codes, valid, wav, _, saw_eos = \
                eng.generator.run_bulk(
                    state, self.dec_state, sampler, prompt_cap=prompt_cap,
                    max_frames=max_frames, budgets=bt,
                    uniform_cursor=uniform_cursor)
        self._wav_np = wav.cpu().numpy()
        return (state, codes.cpu().numpy(), valid.cpu().numpy(),
                saw_eos.cpu().numpy())

    def chunk_audio(self, codes_np: np.ndarray, ks: np.ndarray,
                    finals: np.ndarray) -> List[np.ndarray]:
        """Waveforms of the last group: lane i's first ks[i] frames (none
        where ks[i] <= 0).  finals is taken for the JAX interface; the
        native codec needs no flush."""
        out: List[np.ndarray] = [np.zeros(0, np.float32)] * self.b
        for i in range(self.b):
            if int(ks[i]) > 0:
                out[i] = self._wav_np[i, : int(ks[i]) * self.spf]
        return out

    def reset_lanes(self, mask: np.ndarray) -> None:
        """Zero the codec state of the lanes in `mask` (bool [B])."""
        if mask.any():
            codec_decoder.reset_lanes(
                self.dec_state, torch.as_tensor(mask, device=self.eng.device))

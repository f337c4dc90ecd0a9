"""The generation loop.  Counterpart of qwen3_tts_tpu/runtime/generate.py.

Per frame: sample code_0 from the talker's codec logits (greedy, or
temperature/top-k/top-p with the caller's torch.Generator) -> EOS flags
-> project the talker hidden 2048->1024 (f32) -> predictor: 15 residual
codes -> feedback = sum of the 16 codec embeddings + tts_pad -> one talker
decode step.  `gen_frames` runs a chunk of frames; `_gen_bulk` loops over
chunks with the codec decode of each chunk and stops at the first chunk
boundary where every lane is done (EOS or its frame budget).  That check
reads `done` from the device once per chunk: the one host sync of the
loop.  The talker KV cache and the codec ring are updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..core import protocol as P
from ..core.config import EngineConfig
from ..models import predictor as predictor_lib
from ..models import talker as talker_lib
from ..models.codec import decoder as codec_decoder
from ..models.transformer import KVCache
from ..ops.sampling import sample_logits
from ..prompt import assemble


@dataclass
class GenState:
    cache: KVCache                # talker KV cache (written in place)
    logits: torch.Tensor          # [B, V_codec] f32 logits for the next code_0
    hidden: torch.Tensor          # [B, 2048] talker hidden at that position
    pos: torch.Tensor             # [B] int32 next logical position
    step: int                     # frames generated so far
    done: torch.Tensor            # [B] bool: lane hit EOS (or its budget)
    generator: torch.Generator    # draws for sampled code_0


@dataclass(frozen=True)
class SamplerParams:
    temperature: float
    top_k: int
    top_p: float

    @staticmethod
    def make(cfg) -> "SamplerParams":
        return SamplerParams(float(cfg.temperature), int(cfg.top_k),
                             float(cfg.top_p))


def cache_capacity(cfg: EngineConfig, s_max: int) -> int:
    """Talker KV capacity for a prompt bucket: the JAX package's formula,
    so that cache shapes match between the two packages."""
    need = s_max + cfg.runtime.max_steps + cfg.runtime.frames_per_chunk
    return ((need + 511) // 512) * 512


def prefill(cfg: EngineConfig, talker_params, embeds: torch.Tensor,
            lengths: torch.Tensor, generator: torch.Generator) -> GenState:
    """Initial GenState from a right-padded prompt batch.
    embeds: [B, S_max, 2048]; lengths: [B] int32 true lengths."""
    b, s_max, _ = embeds.shape
    cache = talker_lib.init_talker_cache(
        cfg.talker, b, cache_capacity(cfg, s_max), embeds.device)
    logits, hidden, cache = talker_lib.talker_prefill(
        cfg.talker, talker_params, embeds, lengths, cache)
    return GenState(cache=cache, logits=logits, hidden=hidden,
                    pos=lengths.to(torch.int32), step=0,
                    done=torch.zeros(b, dtype=torch.bool,
                                     device=embeds.device),
                    generator=generator)


def _frame_emb_sum(codec_tables: torch.Tensor,
                   codes: torch.Tensor) -> torch.Tensor:
    """sum_q codec_tables[q][codes[:, q]] for codes [B, 16] -> [B, 2048]
    f32."""
    n_q, rows = codec_tables.shape[0], codec_tables.shape[1]
    flat = codec_tables.reshape(n_q * rows, -1)
    idx = (torch.arange(n_q, device=codes.device)[None, :] * rows
           + codes.long().clamp(0, rows - 1))
    return flat[idx].float().sum(dim=1)


def gen_frames(cfg: EngineConfig, talker_params, predictor_params,
               assets_pack: Dict[str, Any], state: GenState,
               sampler: SamplerParams, n_frames: int, prompt_cap: int,
               ) -> Tuple[GenState, torch.Tensor, torch.Tensor]:
    """Generate `n_frames` frames.

    Returns (state, codes [B, n_frames, 16] int32, valid [B, n_frames]
    bool).  Frames after a lane's EOS are generated but flagged invalid;
    the EOS frame itself is invalid too.
    """
    tables_1024 = assets_pack["codec_tables_1024"]
    proj_w = assets_pack["proj_w"].float()
    proj_b = assets_pack["proj_b"].float()
    tts_pad = assets_pack["tts_pad"].float()
    codes_out, valid_out = [], []
    for _ in range(n_frames):
        code0 = sample_logits(state.logits, state.generator,
                              sampler.temperature, sampler.top_k,
                              sampler.top_p)
        done = state.done | (code0 == P.EOS)
        h1024 = state.hidden.float() @ proj_w.t() + proj_b
        codes = predictor_lib.predict_frame(cfg.predictor, predictor_params,
                                            h1024, code0, tables_1024)
        feedback = _frame_emb_sum(assets_pack["codec_tables"], codes) \
            + tts_pad
        logits, hidden, cache = talker_lib.talker_decode_step(
            cfg.talker, talker_params, feedback, state.pos, state.cache,
            prompt_cap=prompt_cap)
        state = GenState(cache=cache, logits=logits, hidden=hidden,
                         pos=state.pos + 1, step=state.step + 1, done=done,
                         generator=state.generator)
        codes_out.append(codes)
        valid_out.append(~done)
    return state, torch.stack(codes_out, 1), torch.stack(valid_out, 1)


def _gen_bulk(cfg: EngineConfig, talker_params, predictor_params,
              assets_pack, codec_params, state: GenState,
              dec_state: codec_decoder.DecoderState, sampler: SamplerParams,
              budgets=None, *, max_frames: int, chunk: int, prompt_cap: int):
    """Whole-request generation: a loop over `chunk`-frame groups, each
    followed by its codec decode, that exits at the first chunk boundary
    where every lane is done.

    budgets: optional [B] per-lane frame budgets <= max_frames (default
    max_frames); a lane is done when it samples EOS or reaches its
    budget.  Returns (state, dec_state, codes [B, F, 16], valid [B, F],
    wav [B, F*spf] f32, frames_done int, saw_eos [B] bool) with F =
    max_frames rounded up to whole chunks; columns past a lane's budget
    are invalid, so the budget is exact.  saw_eos[i] is True iff lane i
    sampled EOS (rather than running out of budget).
    """
    b = state.hidden.shape[0]
    dev = state.hidden.device
    if budgets is None:
        budgets = max_frames
    budgets = torch.as_tensor(budgets, dtype=torch.int32,
                              device=dev).expand(b)
    n_chunks = -(-max_frames // chunk)
    f_cap = n_chunks * chunk
    spf = cfg.codec_decoder.samples_per_frame
    codes_buf = torch.zeros(b, f_cap, P.NUM_CODEBOOKS, dtype=torch.int32,
                            device=dev)
    valid_buf = torch.zeros(b, f_cap, dtype=torch.bool, device=dev)
    wav_buf = torch.zeros(b, f_cap * spf, dtype=torch.float32, device=dev)
    saw_eos = torch.zeros(b, dtype=torch.bool, device=dev)

    ci = 0
    while ci < n_chunks:
        prev_done = state.done
        state, codes, valid = gen_frames(
            cfg, talker_params, predictor_params, assets_pack, state,
            sampler, chunk, prompt_cap)
        # gen_frames only flips `done` on a sampled EOS
        saw_eos = saw_eos | (state.done & ~prev_done)
        codes_buf[:, ci * chunk:(ci + 1) * chunk] = codes
        valid_buf[:, ci * chunk:(ci + 1) * chunk] = valid
        wav, dec_state = codec_decoder.decode_chunk(
            cfg.codec_decoder, codec_params, codes, dec_state)
        wav_buf[:, ci * chunk * spf:(ci + 1) * chunk * spf] = wav
        state.done = state.done | ((ci + 1) * chunk >= budgets)
        ci += 1
        if bool(state.done.all()):      # the loop's one host sync per chunk
            break
    valid_buf &= torch.arange(f_cap, device=dev)[None, :] < budgets[:, None]
    return (state, dec_state, codes_buf, valid_buf, wav_buf, ci * chunk,
            saw_eos)


class Generator:
    """Holds the weights of one engine and runs the generation steps."""

    def __init__(self, cfg: EngineConfig, talker_params, predictor_params,
                 assets_pack, codec_params=None):
        self.cfg = cfg
        self.talker_params = talker_params
        self.predictor_params = predictor_params
        self.assets_pack = assets_pack
        self.codec_params = codec_params

    def start(self, embeds: torch.Tensor, lengths: torch.Tensor,
              generator: torch.Generator) -> GenState:
        return prefill(self.cfg, self.talker_params, embeds, lengths,
                       generator)

    def start_from_plans(self, text_table, codec_tables, text_idx,
                         codec_idx, frame_slot, spk_flag, frames, spk_emb,
                         lengths, generator: torch.Generator) -> GenState:
        """Prompt assembly + prefill.  Args are the stacked padded plan
        arrays (tensors on the tables' device)."""
        embeds = assemble(text_table, codec_tables, text_idx, codec_idx,
                          frame_slot, spk_flag, frames, spk_emb, lengths)
        return self.start(embeds, lengths, generator)

    def run_bulk(self, state: GenState, dec_state, sampler: SamplerParams,
                 prompt_cap: int, max_frames: int, budgets=None):
        """Whole-request generation with the codec decode fused per chunk
        of cfg.runtime.frames_per_chunk frames (see _gen_bulk).  Returns
        (state, dec_state, codes, valid, wav, frames_done, saw_eos)."""
        if self.codec_params is None:
            raise ValueError("Generator built without codec_params")
        return _gen_bulk(self.cfg, self.talker_params, self.predictor_params,
                         self.assets_pack, self.codec_params, state,
                         dec_state, sampler, budgets, max_frames=max_frames,
                         chunk=self.cfg.runtime.frames_per_chunk,
                         prompt_cap=prompt_cap)

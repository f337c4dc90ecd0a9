"""Speculative multi-frame decoding: the verify step and its acceptance.
Counterpart of qwen3_tts_tpu/runtime/spec.py.  A library function, off by
default: no engine path calls it.

A draft proposes K COMPLETE frames (the talker's feedback embeds all 16
codes of a frame), from any source: a trained draft head through
`draft_frames`, or `repeat_draft`.  `gen_frames_spec` checks them with

  (a) ONE K-row talker forward over the drafted feedback
      (models/talker.talker_verify_frames: mid-decode rows that attend the
      whole live prefix, the prefill kernel at window = the cache's
      capacity and per-lane starts);
  (b) ONE predictor call over the B*K target frames (the predictor-frame
      kernel where the Generator packed it and B*K <= 32, else the exact
      predictor, as gen_frames dispatches);
  (c) ONE corrected talker step per lane at its own cursor (the talker-step
      kernel on a fused Generator, flash_gqa_decode_append on the exact
      path).

A drafted frame is accepted iff all 16 of its codes equal the target's;
each lane emits its accepted prefix plus one target frame (at most K), so
a call emits 1..K frames a lane.  Every emitted frame is the TARGET's, so
with greedy sampling the stream equals gen_frames' frame for frame where
the verify forward's logits equal the decode steps' (the exact path,
`fused=False`, multiplies the same weights at S = K and S = 1; the default
engine's decode step multiplies the packed w4a8 weights, its verify the
engine's layers, so there a draft equal to the sequential frames can be
rejected).  Sampled code_0 draws K uniforms from the state's generator per
call whatever the acceptance, so a sampled stream leaves the sequential
one after the first rejection.

Departures from the JAX function, both faults of the reference:

  * Cursors: the JAX function defaults to uniform_cursor=True, which after
    uneven acceptance writes every lane's verify rows at write_idx[0].
    Here the verify rows, the corrected step and the rollback are always
    per lane (lanes at one cursor get the same result), and there is no
    uniform form.
  * The step count: the JAX function advances GenState.step by
    min(n_emit), which undercounts the fastest lane.  Here step, a host
    int, advances by K, a bound on every lane's advance that needs no
    device-to-host read; prompt_cap + step then bounds every lane's cursor,
    and the call refuses a state without room for K verify rows and the
    corrected step (prompt_cap + step + K < capacity).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..core import protocol as P
from ..core.config import EngineConfig
from ..models import talker as talker_lib
from ..ops.sampling import sample_logits
from .generate import (GenState, SamplerParams, _frame_emb_sum,
                       _predict_frame_dispatch)


def gen_frames_spec(cfg: EngineConfig, talker_params, predictor_params,
                    assets_pack: Dict[str, Any], state: GenState,
                    draft_codes: torch.Tensor, sampler: SamplerParams,
                    prompt_cap: int,
                    ) -> Tuple[GenState, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Verify K drafted frames a lane against the target model; emit each
    lane's accepted prefix plus one target frame (module docstring).

    draft_codes: [B, K, 16] int32.  The cache is written in place.
    Returns (state, codes [B, K, 16] int32, valid [B, K] bool, n_emit [B]
    int32): codes are the target's frames at every position; lane b emits
    codes[b, :n_emit[b]] with 1 <= n_emit <= K, and valid also clears
    frames from a lane's EOS on (the EOS frame itself too, as gen_frames).
    """
    b, k, n_q = draft_codes.shape
    cache = state.cache
    if prompt_cap + state.step + k >= cache.capacity:
        raise ValueError(
            f"speculative step of {k} frames at step {state.step}: the "
            f"cursors may reach {prompt_cap + state.step + k} of a "
            f"{cache.capacity}-slot cache")
    dev = draft_codes.device
    tables = assets_pack["codec_tables"]
    proj_w = assets_pack["proj_w"].float()
    proj_b = assets_pack["proj_b"].float()
    tts_pad = assets_pack["tts_pad"].float()
    lanes = torch.arange(b, device=dev)
    old_cursor = cache.write_idx

    # 1. the drafted feedback, then ONE K-row verify forward
    fb_d = (_frame_emb_sum(tables, draft_codes.reshape(b * k, n_q))
            .reshape(b, k, -1) + tts_pad)
    logits_v, hidden_v, cache = talker_lib.talker_verify_frames(
        cfg.talker, talker_params, fb_d, state.pos, cache, prompt_cap)

    # 2. position i's target follows draft i - 1's feedback; position 0
    # follows the carried state, as a sequential step would
    logits_seq = torch.cat([state.logits[:, None].to(logits_v.dtype),
                            logits_v[:, :-1]], dim=1)           # [B, K, V]
    hidden_seq = torch.cat([state.hidden[:, None].to(hidden_v.dtype),
                            hidden_v[:, :-1]], dim=1)           # [B, K, D]

    # 3. the target's code_0 at each position, drawn in gen_frames' order
    c0 = torch.stack([sample_logits(logits_seq[:, i], state.generator,
                                    sampler.temperature, sampler.top_k,
                                    sampler.top_p) for i in range(k)], dim=1)

    # 4. the target's residual codes: ONE predictor call over B*K frames
    h1024 = hidden_seq.float().reshape(b * k, -1) @ proj_w.t() + proj_b
    codes_t = _predict_frame_dispatch(
        cfg, predictor_params, h1024, c0.reshape(b * k),
        assets_pack["codec_tables_1024"]).reshape(b, k, n_q)

    # 5. per-lane leading-match acceptance
    match = (codes_t == draft_codes).all(dim=-1)                # [B, K]
    n_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(1)  # [B] 0..K
    n_emit = torch.clamp(n_acc + 1, max=k).to(torch.int32)      # [B] 1..K

    # 6. the corrected step: position n_acc re-decodes with the target
    # frame's feedback at cursor old + n_acc, over the rejected draft's
    # row; a lane that accepted all K runs it at old + K and drops it
    fb_t = (_frame_emb_sum(tables, codes_t.reshape(b * k, n_q))
            .reshape(b, k, -1) + tts_pad)
    fb_corr = fb_t[lanes, torch.clamp(n_acc, max=k - 1)]
    cache.write_idx = (old_cursor + n_acc).to(torch.int32)
    logits_c, hidden_c, cache = talker_lib.talker_decode_step(
        cfg.talker, talker_params, fb_corr, state.pos + n_acc, cache,
        prompt_cap, uniform_cursor=False)

    # 7. each lane's carried state
    full = (n_acc == k)[:, None]
    logits_new = torch.where(full, logits_v[:, -1].to(logits_c.dtype),
                             logits_c)
    hidden_new = torch.where(full, hidden_v[:, -1].to(hidden_c.dtype),
                             hidden_c)
    cache.write_idx = (old_cursor + n_emit).to(torch.int32)

    # 8. EOS over the emitted frames, as gen_frames: the EOS frame is
    # invalid, and done sticks
    emit = torch.arange(k, device=dev)[None, :] < n_emit[:, None]
    eos = (c0 == P.EOS) & emit
    eos_incl = torch.cumsum(eos.to(torch.int32), dim=1) > 0
    valid = emit & ~(state.done[:, None] | eos_incl)
    new_state = GenState(
        cache=cache, logits=logits_new.to(state.logits.dtype),
        hidden=hidden_new.to(state.hidden.dtype),
        pos=(state.pos + n_emit).to(torch.int32), step=state.step + k,
        done=state.done | eos.any(dim=1), generator=state.generator)
    return new_state, codes_t, valid, n_emit


# ---------------------------------------------------------------- drafts
def repeat_draft(last_codes: torch.Tensor, k: int) -> torch.Tensor:
    """The last emitted frame K times: [B, 16] -> [B, K, 16] (a live
    exerciser of the verify path, and its 0 % acceptance worst case)."""
    return last_codes[:, None, :].expand(last_codes.shape[0], k,
                                         last_codes.shape[1]).contiguous()


def init_draft_params(cfg: EngineConfig, generator: torch.Generator,
                      d_hidden: int = 512) -> Dict[str, torch.Tensor]:
    """A random draft head (the JAX init's shapes and scales, other draws,
    from a seeded torch.Generator): a trunk over [talker hidden; frame
    embedding] and 16 output heads, code_0's over the sampled codec range
    [0, 2160), the 15 residual ones over their 2048-row codebooks.
    io/from_jax.draft_from_jax converts the JAX head's arrays."""
    d = cfg.talker.d_model
    dev = generator.device

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale

    return {"trunk": normal((2 * d, d_hidden), (2 * d) ** -0.5),
            "trunk_b": torch.zeros(d_hidden, device=dev),
            "head0": normal((d_hidden, P.CODE_SAMPLING_LIMIT),
                            d_hidden ** -0.5),
            "heads": normal((15, d_hidden, 2048), d_hidden ** -0.5)}


def draft_frames(cfg: EngineConfig, draft_params: Dict[str, torch.Tensor],
                 assets_pack: Dict[str, Any], hidden: torch.Tensor,
                 last_codes: torch.Tensor, k: int) -> torch.Tensor:
    """K complete frames drafted greedily from the carried talker hidden
    [B, D] and the last emitted frame [B, 16], one frame after the other:
    x = gelu([hidden; emb(previous frame)] @ trunk + trunk_b) (tanh form,
    as jax.nn.gelu), each head's argmax.  Returns [B, K, 16] int32."""
    tables = assets_pack["codec_tables"]
    h = hidden.float()
    prev = last_codes
    out = []
    for _ in range(k):
        x = torch.cat([h, _frame_emb_sum(tables, prev)], dim=-1)
        t = F.gelu(x @ draft_params["trunk"] + draft_params["trunk_b"],
                   approximate="tanh")
        c0 = torch.argmax(t @ draft_params["head0"], dim=-1)
        res = torch.argmax(torch.einsum("bh,qhv->bqv", t,
                                        draft_params["heads"]), dim=-1)
        prev = torch.cat([c0[:, None], res], dim=1).to(torch.int32)
        out.append(prev)
    return torch.stack(out, dim=1)

"""PromptBuilder: the talker prompt as an integer plan, and its assembly
into a [seq, 2048] embedding matrix.  Counterpart of qwen3_tts_tpu/prompt.py:
the plan code is copied (plans must match exactly); `assemble` is
torch.  Every position sums rows of the text and codec tables.

Section layout (exact parity with the reference's src/tts/prompt.rs):

  [instruct]   <|im_start|>user\\n <ids> <|im_end|>\\n          (text rows only)
  [assistant]  <|im_start|>assistant\\n                         (text rows only)
  [control]    marker + codec0{THINK, THINK_BOS, lang, THINK_EOS}   (lang mode)
               marker + codec0{NOTHINK, THINK_BOS, THINK_EOS}       (no lang)
  [speaker]    marker + codec0[spk_id]   |   marker + spk_emb
  [clone mid]  (voice cloning only; prompt.rs:28-118)
               text{BOS_TOKEN, ref_ids..., EOS_TOKEN} + codec0[PAD]
               marker + codec0[CODEC_BOS]
               per ref frame: marker + sum_q codec_q[code_q]
               marker + codec0[PAD]
  [task text]  text{BOS_TOKEN, ids..., EOS_TOKEN} + codec0[PAD]
  [activation] marker + codec0[BOS]

where `marker` = text_table[TEXT_AUDIO_MARKER].

Requests go through the plans (`plan_*`) and `assemble` on the device.
The `build_*` builders materialize a plan in numpy f32 on the host through
the assets' host lookups (Assets.text_emb_np and the rest), as the JAX
package's do: for tests and tools.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from .core import protocol as P
from .io.assets import Assets


@dataclass
class PromptData:
    embd: np.ndarray             # [seq, 2048] float32 (host)
    text_ids: List[int]
    spk_emb: np.ndarray          # [2048] float32


@dataclass
class PromptPlan:
    """Integer decomposition of a prompt: every position is
    text_table[text_idx] (+ codec0[codec_idx]) (+ frame_sums[frame_slot])
    (+ spk_emb if spk flag).  Built on host in microseconds; materialized to
    [seq, 2048] on device by `assemble` in one fused gather program — the
    embedding tables never leave the device.
    """
    text_idx: np.ndarray     # [S] int32 (always valid; marker for audio rows)
    codec_idx: np.ndarray    # [S] int32, -1 = none
    frame_slot: np.ndarray   # [S] int32 into frames, -1 = none
    spk_flag: np.ndarray     # [S] int32 0/1: add spk_emb at this position
    frames: np.ndarray       # [F, 16] int32 reference codec frames (F >= 1)
    spk_emb: np.ndarray      # [2048] float32
    text_ids: List[int]
    # rows before the task-text section (instruct/assistant/control/speaker/
    # clone blocks) — identical across requests with the same voice +
    # instruction, so their KV is reusable (engine prefix cache)
    prefix_len: int = 0

    @property
    def length(self) -> int:
        return int(self.text_idx.shape[0])

    def suffix_plan(self) -> "PromptPlan":
        """The task-text + activation rows only (positions prefix_len..).
        Suffix rows never reference frames or the speaker embedding, so
        those fields shrink to dummies."""
        p = self.prefix_len
        return PromptPlan(
            text_idx=self.text_idx[p:], codec_idx=self.codec_idx[p:],
            frame_slot=self.frame_slot[p:], spk_flag=self.spk_flag[p:],
            frames=np.zeros((1, self.frames.shape[1]), np.int32),
            spk_emb=np.zeros_like(self.spk_emb), text_ids=self.text_ids,
            prefix_len=0)

    def prefix_fingerprint(self) -> str:
        """Content hash of the prefix rows (voice identity + instruction +
        control blocks) for the engine's prefix-KV cache."""
        import hashlib
        p = self.prefix_len
        h = hashlib.sha1()
        for a in (self.text_idx[:p], self.codec_idx[:p],
                  self.frame_slot[:p], self.spk_flag[:p], self.frames):
            h.update(np.ascontiguousarray(a, np.int32).tobytes())
        h.update(np.ascontiguousarray(self.spk_emb, np.float32).tobytes())
        return h.hexdigest()

    def padded(self, seq_cap: int, frame_cap: int) -> "PromptPlan":
        """Right-pad index arrays to static capacities (for jit reuse)."""
        def pad1(a, fill):
            a = np.asarray(a, np.int32)[:seq_cap]
            return np.pad(a, (0, seq_cap - a.shape[0]),
                          constant_values=fill)
        frames = np.asarray(self.frames, np.int32)[:frame_cap]
        frames = np.pad(frames, ((0, frame_cap - frames.shape[0]), (0, 0)),
                        constant_values=0)
        return PromptPlan(
            text_idx=pad1(self.text_idx, 0),
            codec_idx=pad1(self.codec_idx, -1),
            frame_slot=pad1(self.frame_slot, -1),
            spk_flag=pad1(self.spk_flag, 0),
            frames=frames, spk_emb=self.spk_emb, text_ids=self.text_ids,
            prefix_len=self.prefix_len)


def assemble(text_table: torch.Tensor, codec_tables: torch.Tensor,
             text_idx: torch.Tensor, codec_idx: torch.Tensor,
             frame_slot: torch.Tensor, spk_flag: torch.Tensor,
             frames: torch.Tensor, spk_emb: torch.Tensor,
             length: torch.Tensor) -> torch.Tensor:
    """Materialize padded PromptPlan arrays to [..., S, 2048] float32 on the
    tables' device: gathers and adds; positions >= length are zeroed.
    Takes one plan (text_idx [S], frames [F, 16], spk_emb [2048], length
    scalar) or a batch with one leading dimension on every argument."""
    if text_idx.dim() == 1:
        return assemble(text_table, codec_tables, text_idx[None],
                        codec_idx[None], frame_slot[None], spk_flag[None],
                        frames[None], spk_emb[None],
                        torch.as_tensor(length).reshape(1))[0]
    b, s = text_idx.shape
    dev = text_table.device
    rows = text_table.shape[0]
    n_q, crows = codec_tables.shape[0], codec_tables.shape[1]
    text_idx, codec_idx = text_idx.long(), codec_idx.long()
    frame_slot, frames = frame_slot.long(), frames.long()

    t = text_table[text_idx % rows].float()
    c = codec_tables[0][codec_idx.clamp(0, crows - 1)].float()
    c = torch.where((codec_idx >= 0)[..., None], c, torch.zeros_like(c))

    flat = codec_tables.reshape(n_q * crows, -1)
    idx = (torch.arange(n_q, device=dev)[None, None, :] * crows
           + frames.clamp(0, crows - 1))                       # [B, F, 16]
    frame_sums = flat[idx].float().sum(dim=2)                  # [B, F, 2048]
    slot = frame_slot.clamp(0, frames.shape[1] - 1)
    f = frame_sums[torch.arange(b, device=dev)[:, None], slot]
    f = torch.where((frame_slot >= 0)[..., None], f, torch.zeros_like(f))

    spk = spk_flag[..., None].float() * spk_emb[:, None, :].float()
    emb = t + c + f + spk
    valid = (torch.arange(s, device=dev)[None, :]
             < torch.as_tensor(length, device=dev).reshape(b, 1))[..., None]
    return torch.where(valid, emb, torch.zeros_like(emb))


NO_CODEC = -1
MARKER = P.TEXT_AUDIO_MARKER


class PromptBuilder:
    """Stateless; mirrors the reference's three entry points.  Layout logic
    lives in the `plan_*` methods (integer plans); `build_*` materialize a
    plan through host numpy tables for the legacy/teaching API."""

    # ------------------------------------------------------------- plans
    @staticmethod
    def plan_clone(text: str, tokenizer, ref_codes,
                   ref_text_ids: Sequence[int], spk_emb,
                   lang_id: Optional[int] = P.DEFAULT_LANG_ID,
                   instruct: Optional[str] = None) -> PromptPlan:
        ref_codes = np.asarray(ref_codes, np.int32).reshape(-1)
        n_frames = len(ref_codes) // P.NUM_CODEBOOKS
        frames = ref_codes[: n_frames * P.NUM_CODEBOOKS].reshape(
            n_frames, P.NUM_CODEBOOKS)

        mid = []
        # Identity overlay text: BOS_TOKEN + ref ids + EOS_TOKEN, each + PAD.
        for tid in [P.BOS_TOKEN, *[int(t) for t in ref_text_ids], P.EOS_TOKEN]:
            mid.append((tid, P.PAD, -1, 0))
        # Codec stream start marker.
        mid.append((MARKER, P.CODEC_BOS, -1, 0))
        # Reference audio frames: marker + sum of the 16 codebook rows.
        for fi in range(n_frames):
            mid.append((MARKER, NO_CODEC, fi, 0))
        # Trailing pad.
        mid.append((MARKER, P.PAD, -1, 0))

        return PromptBuilder._plan_core(
            text, tokenizer, lang_id=lang_id, spk_id=None, has_spk_emb=True,
            spk_emb=spk_emb, instruct=instruct, mid_rows=mid, frames=frames)

    @staticmethod
    def plan_custom(text: str, tokenizer, spk_id: int,
                    lang_id: Optional[int] = P.DEFAULT_LANG_ID,
                    instruct: Optional[str] = None) -> PromptPlan:
        return PromptBuilder._plan_core(
            text, tokenizer, lang_id=lang_id, spk_id=spk_id,
            has_spk_emb=False, spk_emb=None, instruct=instruct)

    @staticmethod
    def plan_core(text: str, tokenizer,
                  lang_id: Optional[int] = P.DEFAULT_LANG_ID,
                  spk_id: Optional[int] = None, spk_emb=None,
                  instruct: Optional[str] = None) -> PromptPlan:
        return PromptBuilder._plan_core(
            text, tokenizer, lang_id=lang_id, spk_id=spk_id,
            has_spk_emb=spk_emb is not None, spk_emb=spk_emb,
            instruct=instruct)

    @staticmethod
    def _plan_core(text: str, tokenizer, lang_id, spk_id, has_spk_emb,
                   spk_emb, instruct, mid_rows=None,
                   frames=None) -> PromptPlan:
        rows = []  # (text_idx, codec_idx, frame_slot, spk_flag)

        # 1. Instruct block (user turn), text rows only.
        if instruct:
            for tid in [P.IM_START, P.USER, P.NEWLINE,
                        *[int(t) for t in tokenizer.encode(instruct)],
                        P.IM_END, P.NEWLINE]:
                rows.append((tid, NO_CODEC, -1, 0))

        # 2. Assistant header.
        for tid in (P.IM_START, P.ASSISTANT, P.NEWLINE):
            rows.append((tid, NO_CODEC, -1, 0))

        # 3. Think / language control block.
        ctl = ([P.THINK, P.THINK_BOS, int(lang_id), P.THINK_EOS]
               if lang_id is not None
               else [P.NOTHINK, P.THINK_BOS, P.THINK_EOS])
        for cid in ctl:
            rows.append((MARKER, cid, -1, 0))

        # 4. Speaker slot: preset id row or raw speaker embedding.
        if spk_id is not None:
            rows.append((MARKER, int(spk_id), -1, 0))
        elif has_spk_emb:
            rows.append((MARKER, NO_CODEC, -1, 1))

        # 5. Clone mid-block.
        if mid_rows:
            rows.extend(mid_rows)

        prefix_len = len(rows)   # sections 1-5: reusable across same-voice
        # 6. Task text: BOS_TOKEN + ids + EOS_TOKEN, each + codec PAD.
        ids = [int(t) for t in tokenizer.encode(text)]
        for tid in [P.BOS_TOKEN, *ids, P.EOS_TOKEN]:
            rows.append((tid, P.PAD, -1, 0))

        # 7. Activation: marker + codec BOS.
        rows.append((MARKER, P.BOS, -1, 0))

        arr = np.asarray(rows, np.int32)
        if frames is None or len(frames) == 0:
            frames = np.zeros((1, P.NUM_CODEBOOKS), np.int32)
        se = (np.asarray(spk_emb, np.float32).reshape(-1)
              if spk_emb is not None
              else np.zeros((P.SPEAKER_EMB_DIM,), np.float32))
        return PromptPlan(
            text_idx=arr[:, 0], codec_idx=arr[:, 1], frame_slot=arr[:, 2],
            spk_flag=arr[:, 3], frames=np.asarray(frames, np.int32),
            spk_emb=se, text_ids=ids, prefix_len=prefix_len)

    # ----------------------------------------- legacy/materialized builders
    @staticmethod
    def build_clone_prompt(text: str, tokenizer, assets: Assets,
                           ref_codes, ref_text_ids: Sequence[int],
                           spk_emb, lang_id: int = P.DEFAULT_LANG_ID,
                           instruct: Optional[str] = None) -> PromptData:
        plan = PromptBuilder.plan_clone(text, tokenizer, ref_codes,
                                        ref_text_ids, spk_emb, lang_id,
                                        instruct)
        return PromptBuilder._materialize(plan, assets)

    @staticmethod
    def build_custom_prompt(text: str, tokenizer, assets: Assets,
                            spk_id: int, lang_id: int = P.DEFAULT_LANG_ID,
                            instruct: Optional[str] = None) -> PromptData:
        plan = PromptBuilder.plan_custom(text, tokenizer, spk_id, lang_id,
                                         instruct)
        return PromptBuilder._materialize(plan, assets)

    @staticmethod
    def build_core(text: str, tokenizer, assets: Assets,
                   lang_id: Optional[int] = P.DEFAULT_LANG_ID,
                   spk_id: Optional[int] = None,
                   spk_emb=None,
                   instruct: Optional[str] = None,
                   mid_embeds=None) -> PromptData:
        if mid_embeds is not None:
            raise ValueError("use build_clone_prompt for mid-block prompts")
        plan = PromptBuilder.plan_core(text, tokenizer, lang_id, spk_id,
                                       spk_emb, instruct)
        return PromptBuilder._materialize(plan, assets)

    @staticmethod
    def _materialize(plan: PromptPlan, assets: Assets) -> PromptData:
        """Numpy materialization via host table mirrors (tests, tools)."""
        t = assets.text_emb_np(plan.text_idx)
        c = assets.codec_emb_np(0, np.where(plan.codec_idx < 0, -1,
                                            plan.codec_idx))
        frame_sums = assets.frame_emb_sum_np(plan.frames)
        f = np.where((plan.frame_slot >= 0)[:, None],
                     frame_sums[np.clip(plan.frame_slot, 0,
                                        len(plan.frames) - 1)], 0.0)
        spk = plan.spk_flag[:, None].astype(np.float32) * plan.spk_emb
        embd = (t + c + f + spk).astype(np.float32)
        return PromptData(embd=embd, text_ids=plan.text_ids,
                          spk_emb=plan.spk_emb)

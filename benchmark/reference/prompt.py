"""The talker prompt of a preset voice, built again from the request.

The published prompt protocol of Qwen3-TTS (its reference implementation's
prompt layout): every row sums a text-table row, optionally a codec-table-0
row, and optionally the speaker embedding.

  [instruct]   <|im_start|> user \\n <instruction ids> <|im_end|> \\n
  [assistant]  <|im_start|> assistant \\n
  [control]    marker + codec0 of THINK, THINK_BOS, lang id, THINK_EOS
  [speaker]    marker + speaker embedding
  [task text]  text of BOS_TOKEN, ids, EOS_TOKEN, each + codec0[PAD]
  [activation] marker + codec0[BOS]

`marker` is the text row TEXT_AUDIO_MARKER, also the feedback's tts_pad.
Without a tokenizer file the ids are the development tokenizer's: one id
per character, ord(c) * 2654435761 mod 50000.  Nothing here imports the
program.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

PAD, BOS, EOS = 2148, 2149, 2150
THINK, THINK_BOS, THINK_EOS = 2154, 2156, 2157
BOS_TOKEN, EOS_TOKEN, MARKER = 151672, 151673, 151671
IM_START, IM_END, NEWLINE, USER, ASSISTANT = 151644, 151645, 198, 872, 77091
LANG_ID = 2055
N_CODEBOOKS = 16


def token_ids(text: str) -> List[int]:
    return [(ord(c) * 2654435761) % 50_000 for c in text]


def rows(text: str, instruct: Optional[str]
         ) -> List[Tuple[int, int, int]]:
    """(text id, codec0 id or -1, speaker flag) of every prompt row."""
    out = []
    if instruct:
        for t in [IM_START, USER, NEWLINE, *token_ids(instruct), IM_END,
                  NEWLINE]:
            out.append((t, -1, 0))
    for t in (IM_START, ASSISTANT, NEWLINE):
        out.append((t, -1, 0))
    for c in (THINK, THINK_BOS, LANG_ID, THINK_EOS):
        out.append((MARKER, c, 0))
    out.append((MARKER, -1, 1))
    for t in [BOS_TOKEN, *token_ids(text), EOS_TOKEN]:
        out.append((t, PAD, 0))
    out.append((MARKER, BOS, 0))
    return out


def n_rows(text: str, instruct: Optional[str]) -> int:
    return len(rows(text, instruct))


def embeddings(text_table: torch.Tensor, codec_tables: torch.Tensor,
               spk_emb: np.ndarray, text: str,
               instruct: Optional[str]) -> torch.Tensor:
    """The prompt [S, 2048] in f32 on the tables' device."""
    r = torch.tensor(rows(text, instruct), dtype=torch.long,
                     device=text_table.device)
    t = text_table[r[:, 0] % text_table.shape[0]].float()
    c = codec_tables[0][r[:, 1].clamp(0, codec_tables.shape[1] - 1)].float()
    c = c * (r[:, 1] >= 0)[:, None]
    spk = torch.as_tensor(np.asarray(spk_emb, np.float32),
                          device=text_table.device)
    return t + c + r[:, 2, None].float() * spk[None, :]


def feedback(codec_tables: torch.Tensor, tts_pad: torch.Tensor,
             codes: torch.Tensor) -> torch.Tensor:
    """The talker input after frame codes [F, 16]: the f32 sum of the 16
    codebook rows plus tts_pad -> [F, 2048]."""
    rows_ = codec_tables.shape[1]
    c = codes.long().clamp(0, rows_ - 1)
    out = tts_pad.float()[None, :].expand(codes.shape[0], -1).clone()
    for q in range(N_CODEBOOKS):
        out += codec_tables[q][c[:, q]].float()
    return out

"""Copy of qwen3_tts_tpu/core/protocol.py: the port cannot import the JAX package,
whose __init__ imports jax.  Keep the two in step.

Qwen3-TTS prompt/codec protocol constants.

The talker LM communicates through a shared embedding space: prompts are built
by summing rows of a *text* embedding table (151936 x 2048, pre-projected to
talker space) and 16 *codec* codebook tables (each 2048+special x 2048).  The
constants below define the special rows of those tables and the framing tokens
of the prompt protocol.

Parity reference: the reference's src/tts/prompt.rs:5-16 and
the reference's src/tts/engine.rs:267,407,555,558 (lang id, sampling limit,
EOS set).  Values are part of the released model's contract and are copied as
protocol constants, not code.
"""

from __future__ import annotations

# --- Codec-table special rows (indices into codec codebook-0 table) ---
PAD = 2148
BOS = 2149
EOS = 2150
THINK = 2154
NOTHINK = 2155
THINK_BOS = 2156
THINK_EOS = 2157
CODEC_BOS = 2160  # "start of codec stream" marker row

# --- Text-table special rows (indices into the text embedding table) ---
BOS_TOKEN = 151672
EOS_TOKEN = 151673
TEXT_AUDIO_MARKER = 151671  # row added to every audio-side position; also tts_pad

# --- Chat-template token ids (Qwen tokenizer) ---
IM_START = 151644
IM_END = 151645
NEWLINE = 198
USER = 872
ASSISTANT = 77091

# --- Generation protocol ---
CODE_SAMPLING_LIMIT = 2160      # code_0 sampled from [0, CODE_SAMPLING_LIMIT)
EOS_CODES = (EOS, EOS_TOKEN)    # generation stops when code_0 is one of these
DEFAULT_LANG_ID = 2055          # Chinese; reference hardcodes this

# --- Codec geometry ---
NUM_CODEBOOKS = 16              # 1 talker codebook + 15 predictor codebooks
CODEBOOK_SIZE = 2048            # valid acoustic codes per codebook: [0, 2048)
SAMPLE_RATE = 24000
SAMPLES_PER_FRAME = 2000        # codec frame hop: 24 kHz / 2000 = 12 fps
FRAMES_PER_CHUNK = 4            # streaming chunk = 4 frames = 64 codes = ~333 ms

# Embedding-space dims
TALKER_DIM = 2048               # prompt/text/codec embedding width
PREDICTOR_DIM = 1024            # predictor input width (after projection)
SPEAKER_EMB_DIM = 2048

# Default speaker fallback chain (id -> name -> this -> any)
DEFAULT_SPEAKER = "vivian"

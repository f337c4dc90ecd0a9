"""qwen3_tts_tpu_torch: the synthesis paths of qwen3_tts_tpu (preset voices,
voice files, voice cloning from reference audio; streamed, in waves and
under continuous batching), ported to PyTorch, with hand-written CUDA
kernels on NVIDIA Hopper (H100):
prefill and decode attention, the talker decode step (w4a8, int8, w8a8,
bf16 weights), the int8 predictor frame, the chunk megakernel, the int4
matmul and the serving lane kernels; weights from GGUF model directories
as int8 device weights.  It imports torch and never jax or qwen3_tts_tpu.

    from qwen3_tts_tpu_torch import TtsEngine
    engine = TtsEngine("models", quant="q8_0", device="cuda")
    audio = engine.generate_with_voice("hello", engine.get_speaker("vivian"))
    audio = engine.generate("hello", "ref.wav", "the reference's words")
"""

from .core import protocol
from .core.config import EngineConfig, SamplerConfig
from .engine import PromptTooLongError, TtsEngine
from .io.audio import AudioSample
from .io.voice_file import VoiceFile
from .prompt import PromptBuilder
from .utils.tokenizer import Tokenizer

__version__ = "0.1.0"

__all__ = [
    "TtsEngine", "SamplerConfig", "PromptBuilder", "AudioSample",
    "Tokenizer", "VoiceFile", "EngineConfig", "protocol",
    "PromptTooLongError",
]

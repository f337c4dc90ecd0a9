"""qwen3_tts_tpu_torch: the preset-voice synthesis path of qwen3_tts_tpu,
ported to PyTorch, with hand-written CUDA kernels for attention on NVIDIA
Hopper (H100).  It imports torch and never jax or qwen3_tts_tpu.

    from qwen3_tts_tpu_torch import TtsEngine
    engine = TtsEngine(device="cuda")
    audio = engine.generate_with_voice("hello", engine.get_speaker("vivian"))
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

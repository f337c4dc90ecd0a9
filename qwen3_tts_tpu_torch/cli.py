"""Command line of the PyTorch port, with the JAX CLI's flags
(qwen3_tts_tpu/cli.py):

  python -m qwen3_tts_tpu_torch --text "..." [--speaker vivian]
      [--speakers-dir speakers] [--instruction "Happy"] [--max-steps 512]
      [--seed N] [--temperature 0.7] [--top-k 40] [--top-p 0.9]
      [--output output.wav] [--metrics] [--model-dir models] [--device cuda]
      [--quant none|q5_k_m|q8_0] [--talker-mode w4a8|int8|w8a8|bf16]
      [--voice-file voice.json] [--ref-audio ref.wav --ref-text "..."]
      [--save-voice voice.json] [--stream] [--long] [--config cfg.json]
      [--skip-download] [--audition-voice voice.json]

--model-dir is read in the published layout (TtsEngine): the GGUF files
under gguf/ (--quant none) or gguf_<quant>/, the codec decoder under
codec/decoder.npz, codec/encoder.npz and codec/speaker.npz; a component
without its file runs on random weights, with a warning.  --quant other than none gives int8 device weights.
--talker-mode other than w4a8 runs the per-kernel decode path with that
talker-step weight mode (the chunk kernel is w4a8).

--voice-file reads a voice (io/voice_file; one with reference codes
prompts as a clone) in place of --speaker.  --ref-audio (a 24 kHz WAV)
clones its voice instead (TtsEngine.create_voice_file, with --ref-text as
the reference's transcript), and --save-voice writes that voice as JSON.
--stream synthesizes through TtsEngine.generate_stream and prints one
line per chunk and the time to the first chunk; --long (without --stream)
synthesizes sentence by sentence (TtsEngine.generate_long).  --config
reads an EngineConfig from a json or toml file.

Without --skip-download the CLI first fetches the model manifest's
missing files into --model-dir (TtsEngine.download_models); where that
fails (no hub reachable) it warns and goes on in development mode, as the
JAX CLI does.  --audition-voice decodes a VoiceFile's reference codes to
--output through the codec (TtsEngine.decode_codes) and exits.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="qwen3_tts_tpu_torch",
                                description="Qwen3-TTS on PyTorch + CUDA")
    p.add_argument("--model-dir", type=Path, default=Path("models"))
    p.add_argument("--text", "-t", required=True)
    p.add_argument("--speaker", "-s")
    p.add_argument("--speakers-dir", type=Path, default=Path("speakers"))
    p.add_argument("--instruction")
    p.add_argument("--output", "-o", type=Path, default=Path("output.wav"))
    p.add_argument("--max-steps", type=int, default=512)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--top-p", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--metrics", action="store_true",
                   help="print JSON metrics after generation")
    p.add_argument("--quant", default="none",
                   choices=("none", "q5_k_m", "q8_0"),
                   help="weights dir gguf/ or gguf_<quant>/; not none: int8 "
                        "device weights")
    p.add_argument("--talker-mode", default="w4a8",
                   choices=("w4a8", "int8", "w8a8", "bf16"),
                   help="talker-step kernel weight mode (not w4a8: the "
                        "per-kernel decode path)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "attention instead of the CUDA kernels)")
    p.add_argument("--voice-file", "-v", type=Path,
                   help="voice JSON file (in place of --speaker)")
    p.add_argument("--ref-audio", type=Path,
                   help="24 kHz reference WAV whose voice is cloned")
    p.add_argument("--ref-text", help="transcript of --ref-audio")
    p.add_argument("--save-voice", type=Path,
                   help="write the voice cloned from --ref-audio as JSON")
    p.add_argument("--stream", action="store_true",
                   help="stream the audio chunk by chunk")
    p.add_argument("--long", action="store_true",
                   help="sentence-chunked synthesis of long text (ignored "
                        "with --stream)")
    p.add_argument("--config", type=Path, default=None,
                   help="EngineConfig json/toml file")
    p.add_argument("--skip-download", action="store_true",
                   help="do not try to fetch missing model files")
    p.add_argument("--audition-voice", type=Path,
                   help="decode a VoiceFile's reference codes to WAV and exit")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t_total = time.perf_counter()

    from .core.config import EngineConfig, SamplerConfig
    from .engine import TtsEngine
    from .io.voice_file import VoiceFile

    if not args.skip_download:
        try:
            TtsEngine.download_models(args.model_dir, args.quant)
        except RuntimeError as e:
            print(f"[warn] {e}", file=sys.stderr)
            print("[warn] continuing with random-init weights "
                  "(development mode)", file=sys.stderr)
    engine = TtsEngine(model_dir=args.model_dir,
                       config=(EngineConfig.from_file(args.config)
                               if args.config else None),
                       speakers_dir=(args.speakers_dir
                                     if args.speakers_dir.exists() else None),
                       device=args.device, quant=args.quant,
                       talker_mode=args.talker_mode)
    if args.audition_voice:
        vf = VoiceFile.load(args.audition_voice)
        audio = engine.decode_codes(vf.audio_codes)
        audio.save_wav(args.output)
        print(f"Auditioned {len(vf.audio_codes) // 16} reference frames "
              f"-> {args.output}")
        return 0
    engine.set_max_steps(args.max_steps)
    engine.set_sampler_config(SamplerConfig(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        seed=args.seed))
    print(f"Device: {engine.device}  sampler: temp={args.temperature} "
          f"top_k={args.top_k} top_p={args.top_p} seed={args.seed}")
    if args.ref_audio is not None:
        print(f"Creating voice from reference: {args.ref_audio}")
        voice = engine.create_voice_file(args.ref_audio, args.ref_text or "")
        if args.save_voice:
            voice.save(args.save_voice)
            print(f"Saved voice file to {args.save_voice}")
    elif args.voice_file is not None:
        voice = VoiceFile.load(args.voice_file)
    else:
        voice = engine.get_speaker(args.speaker or "vivian")
    print(f"Voice: {voice.name or 'Dynamic'}")

    t_gen = time.perf_counter()
    if args.stream:
        import numpy as np
        from .core import protocol as P
        from .io.audio import AudioSample
        parts = []
        for i, chunk in enumerate(engine.generate_stream(
                args.text, voice, args.instruction)):
            dt = (time.perf_counter() - t_gen) * 1000
            print(f"  chunk {i}: {len(chunk)} samples @ {dt:.0f} ms")
            parts.append(chunk)
        ttft = engine.last_metrics.ttft_ms
        print(f"TTFT: {'none' if ttft is None else f'{ttft:.1f} ms'}")
        audio = AudioSample(
            samples=(np.concatenate(parts) if parts
                     else np.zeros(0, np.float32)),
            sample_rate=P.SAMPLE_RATE, channels=1)
    elif args.long:
        audio = engine.generate_long(args.text, voice, args.instruction)
    else:
        audio = engine.generate_with_voice(args.text, voice, args.instruction)
    print(f"Generation took {time.perf_counter() - t_gen:.2f}s "
          f"for {audio.duration():.2f}s audio")
    audio.save_wav(args.output)
    print(f"Saved to {args.output}")
    if args.metrics and engine.last_metrics:
        print(json.dumps(engine.last_metrics.as_dict()))
    print(f"Total time: {time.perf_counter() - t_total:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

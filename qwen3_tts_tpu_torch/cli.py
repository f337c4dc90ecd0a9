"""Command line of the PyTorch port, with the JAX CLI's flags for the
preset-voice path (qwen3_tts_tpu/cli.py):

  python -m qwen3_tts_tpu_torch --text "..." [--speaker vivian]
      [--speakers-dir speakers] [--instruction "Happy"] [--max-steps 512]
      [--seed N] [--temperature 0.7] [--top-k 40] [--top-p 0.9]
      [--output output.wav] [--metrics] [--model-dir models] [--device cuda]

--stream, --ref-audio, --voice-file and --long are accepted and refused:
those paths are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

NOT_PORTED = ("stream", "ref_audio", "voice_file", "long")


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
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "attention instead of the CUDA kernels)")
    # accepted for compatibility with the JAX CLI, refused below
    p.add_argument("--stream", action="store_true", help="not yet ported")
    p.add_argument("--ref-audio", type=Path, help="not yet ported")
    p.add_argument("--voice-file", "-v", type=Path, help="not yet ported")
    p.add_argument("--long", action="store_true", help="not yet ported")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for name in NOT_PORTED:
        if getattr(args, name):
            parser.error(f"--{name.replace('_', '-')} is not yet ported to "
                         "qwen3_tts_tpu_torch")
    t_total = time.perf_counter()

    from .core.config import SamplerConfig
    from .engine import TtsEngine

    engine = TtsEngine(model_dir=args.model_dir,
                       speakers_dir=(args.speakers_dir
                                     if args.speakers_dir.exists() else None),
                       device=args.device)
    engine.set_max_steps(args.max_steps)
    engine.set_sampler_config(SamplerConfig(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        seed=args.seed))
    print(f"Device: {engine.device}  sampler: temp={args.temperature} "
          f"top_k={args.top_k} top_p={args.top_p} seed={args.seed}")
    voice = engine.get_speaker(args.speaker or "vivian")
    print(f"Voice: {voice.name or 'Dynamic'}")

    t_gen = time.perf_counter()
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

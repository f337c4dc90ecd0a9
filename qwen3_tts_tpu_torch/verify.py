"""Real-checkpoint readiness runbook: ONE command for the "files arrived"
day.  Counterpart of qwen3_tts_tpu/verify.py, on the port's loaders.

    python -m qwen3_tts_tpu_torch.verify --model-dir models [--quant none]
        [--device cuda] [--download] [--golden] [--record-golden]
        [--golden-path tests/golden/real_engine_torch_seed42.json]

Chains every real-checkpoint drill the framework ships (file manifest,
hub probe, tokenizer, assets GGUF, talker/predictor GGUF import, llama.cpp
logit parity, ONNX codec import into the native decoder, native-vs-ONNX
waveform validation, encoder/speaker import, end-to-end golden WAV) in
the JAX package's order, and prints one line per drill plus a
machine-readable JSON summary (the JAX runbook's keys).  Every drill
self-skips (with the reason and, where useful, the next action) when its
input files are absent, so the command is safe to run in any
environment; it only FAILs when a file exists but is wrong.

What differs from the JAX runbook:
  --device   where the loaders put the weights and the engine runs (the
             card by default; the CPU tests pass cpu);
  tokenizer  a tokenizer.json present where the `tokenizers` package is
             not (the card's machine) SKIPs, naming the package: a missing
             package is not a broken file;
  golden     the port records its own file (default
             tests/golden/real_engine_torch_seed42.json, --golden-path to
             choose another): port numerics are never held against the JAX
             package's golden.

The hub probe is bounded as in the JAX package: air-gapped, two HEAD
requests of 3 s each.  Exit code: 0 when no drill FAILs, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

PASS, FAIL, SKIP = "PASS", "FAIL", "SKIP"


@dataclass
class Drill:
    name: str
    status: str
    detail: str
    seconds: float = 0.0


class _Skip(Exception):
    """Raised inside a drill to mark it skipped (file not present etc.)."""


def _run_drill(name: str, fn: Callable[[], str], out: List[Drill]) -> Drill:
    t0 = time.perf_counter()
    try:
        detail = fn()
        d = Drill(name, PASS, detail or "", time.perf_counter() - t0)
    except _Skip as e:
        d = Drill(name, SKIP, str(e), time.perf_counter() - t0)
    except Exception as e:  # noqa: BLE001 — a drill failure must not stop the runbook
        d = Drill(name, FAIL, f"{type(e).__name__}: {e}",
                  time.perf_counter() - t0)
    out.append(d)
    mark = {PASS: "+", FAIL: "!", SKIP: "-"}[d.status]
    detail_1l = " ".join(d.detail.split())
    if len(detail_1l) > 300:
        detail_1l = detail_1l[:297] + "..."
    print(f"[{d.status}] {mark} {name} ({d.seconds:.1f}s) — {detail_1l}",
          flush=True)
    return d


GOLDEN = (Path(__file__).resolve().parent.parent / "tests" / "golden"
          / "real_engine_torch_seed42.json")


def run_drills(model_dir, quant: str = "none", download: bool = False,
               golden: bool = False, record_golden: bool = False,
               device="cuda", golden_path=None) -> List[Drill]:
    model_dir = Path(model_dir)
    golden_path = Path(golden_path) if golden_path else GOLDEN
    drills: List[Drill] = []

    from .io import download as dl

    # ---- 1. files ---------------------------------------------------------
    def files():
        if download:
            dl.check_and_download(model_dir, quant)
        missing = dl.missing_files(model_dir, quant)
        required = dl.manifest(quant)
        opt_present = [f for f in dl.OPTIONAL_FILES
                       if (model_dir / f).exists()]
        if missing:
            raise _Skip(
                f"{len(required) - len(missing)}/{len(required)} required "
                f"files present; missing: "
                f"{[str(p.relative_to(model_dir)) for p in missing]} "
                f"(re-run with --download to fetch)")
        return (f"all {len(required)} required files present; optional: "
                f"{opt_present or 'none'}")

    _run_drill("files", files, drills)
    sub = dl.QUANT_SUBDIR.get(quant, "gguf")

    # ---- 1b. hub probe ----------------------------------------------------
    def hub_probe():
        """Notice the day the checkpoint files appear on the hub.  Every
        real-checkpoint drill below is blocked on files, not code — this
        drill HEAD-probes the manifest so a CI run flips from SKIP to a
        loud 'files are published, run --download' the moment they exist
        (reference manifest: download.rs:55-101)."""
        res = dl.probe_manifest(quant)
        if res is None:
            raise _Skip("no hub reachable (air-gapped; set QTTS_HF_BASE "
                        "for a local mirror)")
        n_req = len(dl.manifest(quant))
        if not res["published"]:
            return (f"hub reachable at {res['base']}; 0/{n_req} manifest "
                    "files published yet")
        if res["absent"]:
            return (f"hub reachable; PUBLISHED: {res['published']} — "
                    f"still absent: {res['absent']}")
        return (f"ALL {n_req} required files (+optional) published at "
                f"{res['base']} — run `python -m qwen3_tts_tpu_torch.verify "
                "--download` to execute the full fidelity suite")

    _run_drill("hub-probe", hub_probe, drills)

    # ---- 2. tokenizer -----------------------------------------------------
    def tokenizer():
        from .utils.tokenizer import Tokenizer
        try:
            tok = Tokenizer.load(model_dir)
        except ImportError as e:
            raise _Skip(f"a tokenizer.json is present but the `tokenizers` "
                        f"package is not installed ({e})") from None
        if tok.is_fallback:
            raise _Skip("tokenizer/tokenizer.json not present "
                        "(hashing fallback active)")
        ids = tok.encode("Hello, world")
        if not ids:
            raise RuntimeError("real tokenizer returned no ids for "
                               "'Hello, world'")
        return f"real tokenizer loaded; 'Hello, world' -> {len(ids)} ids"

    _run_drill("tokenizer", tokenizer, drills)

    # ---- 3. assets GGUF ---------------------------------------------------
    def assets():
        path = model_dir / sub / "qwen3_assets.gguf"
        if not path.exists():
            raise _Skip(f"{path.relative_to(model_dir)} not present")
        from .io.assets import Assets
        a = Assets.from_gguf(path, device=device)
        pw = tuple(a.proj_w.shape)
        if pw != (1024, 2048):
            raise RuntimeError(f"proj.weight shape {pw} != (1024, 2048) "
                               "(assets_manager.rs:212-224)")
        n_tabs = a.codec_tables.shape[0]
        if n_tabs != 16:
            raise RuntimeError(f"{n_tabs} codec tables != 16")
        return (f"proj {pw}, text_embd rows={a.text_table.shape[0]}, "
                f"16 codec tables x {a.codec_tables.shape[1]} rows")

    _run_drill("assets-gguf", assets, drills)

    # ---- 4/5. talker / predictor GGUF ------------------------------------
    talker_state = {}

    def talker():
        path = model_dir / sub / "qwen3_tts_talker.gguf"
        if not path.exists():
            raise _Skip(f"{path.relative_to(model_dir)} not present")
        from .core.config import TalkerConfig
        from .io import weights as w
        cfg, params = w.load_talker_gguf(path, TalkerConfig(), device)
        talker_state["cfg"], talker_state["params"] = cfg, params
        talker_state["path"] = path
        return (f"layers={cfg.n_layers} d_model={cfg.d_model} "
                f"heads={cfg.n_heads}/{cfg.n_kv_heads} "
                f"head_dim={cfg.head_dim} mrope={cfg.mrope_sections}")

    def predictor():
        path = model_dir / sub / "qwen3_tts_predictor.gguf"
        if not path.exists():
            raise _Skip(f"{path.relative_to(model_dir)} not present")
        from .core.config import PredictorConfig
        from .io import weights as w
        cfg, _params = w.load_predictor_gguf(path, PredictorConfig(),
                                             device)
        return (f"layers={cfg.n_layers} d_model={cfg.d_model} "
                f"heads={cfg.n_heads}/{cfg.n_kv_heads}")

    _run_drill("talker-gguf", talker, drills)
    _run_drill("predictor-gguf", predictor, drills)

    # ---- 6. llama.cpp logit parity ----------------------------------------
    def llama_parity():
        if "cfg" not in talker_state:
            raise _Skip("needs the talker GGUF (drill above skipped)")
        from .io import llama_parity as lp
        pdir = model_dir / "parity"
        inputs = pdir / "inputs.npz"
        dump = pdir / "talker_dump.npz"
        if not dump.exists():
            pdir.mkdir(parents=True, exist_ok=True)
            if not inputs.exists():
                lp.make_inputs(inputs,
                               d_model=talker_state["cfg"].d_model)
            raise _Skip(
                f"wrote {inputs}; on a machine with the llama.cpp runtime "
                f"libs run: python scripts/dump_llama_logits.py "
                f"--gguf {talker_state['path']} --inputs {inputs} "
                f"--out {dump}, then re-run this command")
        stats = lp.compare_talker(talker_state["path"], inputs, dump,
                                  device=device)
        worst = max(v for k, v in stats.items() if k.endswith("_rel"))
        return f"logit/hidden parity vs llama.cpp OK (worst rel {worst:.3g})"

    _run_drill("llama-parity", llama_parity, drills)

    # ---- 7/8. ONNX decoder import + native validation ---------------------
    import_state = {}

    def decoder_import():
        path = model_dir / "onnx" / "qwen3_tts_decoder.onnx"
        if not path.exists():
            raise _Skip("onnx/qwen3_tts_decoder.onnx not present")
        import numpy as np
        from .core.config import CodecDecoderConfig
        from .io import codec_import as ci
        from .io.onnx_lite import read_onnx_initializers
        from .models.codec.decoder import init_decoder_params
        inits = {k: np.asarray(v)
                 for k, v in read_onnx_initializers(path).items()}
        cfg = CodecDecoderConfig()
        # Adopt the real export's conv-transpose geometry BEFORE converting:
        # a checkpoint with overlapping kernels (kernel = m*stride, m > 1)
        # imports into the native overlapping-upsample variant instead of
        # failing to the onnx_exec path (the r4 advisor found the default
        # upsample_kernel_mult=1 made the overlap variant unreachable here).
        import dataclasses
        try:
            m = ci.infer_upsample_mult(inits, cfg)
            if m != cfg.upsample_kernel_mult:
                cfg = dataclasses.replace(cfg, upsample_kernel_mult=m)
        except ci.CodecImportError:
            pass    # geometry the streaming path cannot carry -> the
            # convert below will surface it (or the name-map fallback runs)
        try:
            params = ci.convert_codec(inits, cfg,
                                      name_map=ci.decoder_name_map(cfg),
                                      init_fn=init_decoder_params)
        except ci.CodecImportError:
            # Exported names differ from the shipped map — fall back to the
            # shape-inference engine and report what a human must decide.
            spec = ci.param_spec(init_decoder_params, cfg)
            rep = ci.infer_name_map(inits, spec)
            if rep.unmatched_spec or rep.ambiguous:
                raise RuntimeError(
                    f"name map needs human attention: "
                    f"{len(rep.assigned)}/{len(spec)} auto-assigned, "
                    f"ambiguous={sorted(rep.ambiguous)[:8]}, "
                    f"unmatched={rep.unmatched_spec[:8]} — edit "
                    f"io/codec_import.decoder_name_map with these and "
                    f"re-run") from None
            params = ci.convert_codec(inits, cfg, name_map=rep.assigned,
                                      init_fn=init_decoder_params)
        import_state["cfg"], import_state["params"] = cfg, params
        import_state["onnx_path"] = path
        return (f"{len(inits)} initializers -> native decoder pytree "
                f"(all shapes/dtypes validated)")

    def decoder_validate():
        if "params" not in import_state:
            raise _Skip("needs a successful decoder import (drill above)")
        from .io import codec_import as ci
        from .models.codec.onnx_decoder import OnnxStreamingDecoder
        onnx_dec = OnnxStreamingDecoder.load(import_state["onnx_path"],
                                             device)
        stats = ci.validate_decoder_against_onnx(
            import_state["cfg"], import_state["params"], onnx_dec)
        return (f"native==ONNX within tolerance "
                f"(max_abs_err {stats['max_abs_err']:.2e} over "
                f"{stats['n_samples']} samples)")

    _run_drill("onnx-decoder-import", decoder_import, drills)
    _run_drill("native-decoder-validate", decoder_validate, drills)

    # ---- 9. encoder / speaker import (optional files) ----------------------
    def _import_optional(fname, cfg, name_map_fn, init_fn, infer_cfg=None):
        path = model_dir / "onnx" / fname
        if not path.exists():
            raise _Skip(f"onnx/{fname} not present (voice cloning only)")
        import numpy as np
        from .io import codec_import as ci
        from .io.onnx_lite import read_onnx_initializers
        inits = {k: np.asarray(v)
                 for k, v in read_onnx_initializers(path).items()}
        if infer_cfg is not None:
            # adopt the export's geometry/variant before mapping names, so
            # a non-default checkpoint lands on the native fast path
            # (decoder_import's infer_upsample_mult treatment, r4 advisor)
            cfg = infer_cfg(inits, cfg)
        try:
            ci.convert_codec(inits, cfg, name_map=name_map_fn(cfg),
                             init_fn=init_fn)
        except ci.CodecImportError:
            spec = ci.param_spec(init_fn, cfg)
            rep = ci.infer_name_map(inits, spec)
            if rep.unmatched_spec or rep.ambiguous:
                raise RuntimeError(
                    f"name map needs human attention: "
                    f"{len(rep.assigned)}/{len(spec)} auto-assigned, "
                    f"ambiguous={sorted(rep.ambiguous)[:8]}, "
                    f"unmatched={rep.unmatched_spec[:8]}") from None
            ci.convert_codec(inits, cfg, name_map=rep.assigned,
                             init_fn=init_fn)
        return f"{len(inits)} initializers import cleanly"

    def encoder_import():
        from .core.config import CodecEncoderConfig
        from .io import codec_import as ci
        from .models.codec.encoder import init_encoder_params
        cfg = CodecEncoderConfig()
        return _import_optional("qwen3_tts_codec_encoder.onnx", cfg,
                                ci.encoder_name_map,
                                init_encoder_params,
                                infer_cfg=ci.infer_encoder_geometry)

    def speaker_import():
        from .core.config import SpeakerEncoderConfig
        from .io import codec_import as ci
        from .models.codec.speaker import init_speaker_params
        cfg = SpeakerEncoderConfig()
        return _import_optional("qwen3_tts_speaker_encoder.onnx", cfg,
                                ci.speaker_name_map,
                                init_speaker_params,
                                infer_cfg=ci.infer_speaker_pooling)

    _run_drill("encoder-import", encoder_import, drills)
    _run_drill("speaker-import", speaker_import, drills)

    # ---- 10. golden WAV (opt-in: builds the full engine) -----------------
    def golden_wav():
        if not golden:
            raise _Skip("pass --golden to run end-to-end synthesis "
                        "(builds the full engine)")
        if dl.missing_files(model_dir, quant):
            raise _Skip("required files missing (see 'files' drill)")
        from .engine import TtsEngine
        eng = TtsEngine(model_dir=model_dir, quant=quant, device=device)
        if eng.dev_mode_components:
            raise RuntimeError(
                f"engine still in dev mode for: {eng.dev_mode_components}")
        return golden_run(eng, golden_path, record_golden)

    _run_drill("golden-wav", golden_wav, drills)
    return drills


def golden_run(eng, gpath: Path, record: bool = False) -> str:
    """The golden-wav drill's body on a built engine: 64 frames of a
    preset-voice request at seed 42, its sample count, RMS and peak
    recorded into `gpath` (record, or no file yet) or held within 2 % of
    the recorded ones (RuntimeError naming the first that is not)."""
    import numpy as np
    from .core.config import SamplerConfig
    eng.set_max_steps(64)
    eng.set_sampler_config(SamplerConfig(seed=42))
    t0 = time.perf_counter()
    audio = eng.generate_with_voice("Hello from the GPU port.",
                                    eng.get_speaker("vivian"))
    dt = time.perf_counter() - t0
    wav = np.asarray(audio.samples, np.float32)
    stats = {"n": int(wav.size), "rms": float(np.sqrt(np.mean(wav**2))),
             "peak": float(np.abs(wav).max())}
    if record or not gpath.exists():
        gpath.parent.mkdir(parents=True, exist_ok=True)
        gpath.write_text(json.dumps(stats, indent=1))
        return (f"synthesized {wav.size} samples in {dt:.1f}s; golden "
                f"RECORDED at {gpath} (re-run to verify)")
    ref = json.loads(gpath.read_text())
    for k in ("n", "rms", "peak"):
        a, b = stats[k], ref[k]
        if abs(a - b) > 0.02 * max(abs(b), 1e-6):
            raise RuntimeError(f"golden mismatch on {k}: {a} vs "
                               f"recorded {b} ({gpath})")
    return (f"synthesized {wav.size} samples in {dt:.1f}s; matches "
            f"recorded golden")


def summary(drills: List[Drill], model_dir, quant: str) -> dict:
    """The runbook's JSON summary line (the JAX runbook's keys)."""
    counts = {s: sum(1 for d in drills if d.status == s)
              for s in (PASS, FAIL, SKIP)}
    return {
        "metric": "verify", "model_dir": str(model_dir),
        "quant": quant, "pass": counts[PASS], "fail": counts[FAIL],
        "skip": counts[SKIP],
        "drills": {d.name: d.status for d in drills},
        "ready": counts[FAIL] == 0 and counts[SKIP] == 0,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m qwen3_tts_tpu_torch.verify",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-dir", default="models")
    ap.add_argument("--quant", default="none",
                    choices=["none", "q5_k_m", "q8_0"])
    ap.add_argument("--download", action="store_true",
                    help="fetch missing manifest files first")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the loaders and the engine "
                         "(default cuda)")
    ap.add_argument("--golden", action="store_true",
                    help="also run end-to-end synthesis vs the recorded "
                         "golden (builds the full engine)")
    ap.add_argument("--golden-path", type=Path, default=None,
                    help=f"the port's golden stats file (default {GOLDEN})")
    ap.add_argument("--record-golden", action="store_true",
                    help="with --golden: (re)record the golden stats")
    args = ap.parse_args(argv)

    drills = run_drills(args.model_dir, quant=args.quant,
                        download=args.download, golden=args.golden,
                        record_golden=args.record_golden,
                        device=args.device, golden_path=args.golden_path)
    out = summary(drills, args.model_dir, args.quant)
    print(json.dumps(out), flush=True)
    return 1 if out["fail"] else 0


if __name__ == "__main__":
    raise SystemExit(main())

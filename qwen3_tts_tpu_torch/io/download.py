"""Copy of qwen3_tts_tpu/io/download.py (standard library only): the port
cannot import the JAX package, whose __init__ imports jax.  Keep the two
in step.

Model provisioning (Hugging Face hub), network-gated.

The reference downloads both model files and native runtime libraries
(the reference's src/download.rs); the port needs only the model files —
PyTorch is the device runtime.  Parity with the reference manifest
(download.rs:55-101): the streaming codec decoder ONNX, the tokenizer, and
the three GGUFs per quant folder.  The codec encoder and speaker encoder
ONNX files are provisioned best-effort, matching the reference engine's
optional `.ok()` loads (engine.rs:107-121).

Connectivity mirrors download.rs:14-38: probe huggingface.co with a short
timeout, fall back to hf-mirror.com.  Files are fetched over plain HTTP
(`<base>/<repo>/resolve/main/<path>`) with byte-level progress reporting.
"""

from __future__ import annotations

import os
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Callable, List, Optional

DEFAULT_REPO = "cgisky/qwen3-tts-custom-gguf"
HF_BASE = "https://huggingface.co"
HF_MIRROR = "https://hf-mirror.com"

QUANT_SUBDIR = {"none": "gguf", "q5_k_m": "gguf_q5_k_m", "q8_0": "gguf_q8_0"}

# Best-effort files: the reference engine loads these with `.ok()` — absence
# only disables voice cloning, not synthesis (engine.rs:107-121).
OPTIONAL_FILES = [
    "onnx/qwen3_tts_codec_encoder.onnx",
    "onnx/qwen3_tts_speaker_encoder.onnx",
]


def manifest(quant: str = "none") -> List[str]:
    """Files required for synthesis, relative to the model dir (mirrors the
    reference manifest, download.rs:66-87, minus runtime libraries)."""
    sub = QUANT_SUBDIR.get(quant, "gguf")
    return [
        "onnx/qwen3_tts_decoder.onnx",
        "tokenizer/tokenizer.json",
        f"{sub}/qwen3_assets.gguf",
        f"{sub}/qwen3_tts_talker.gguf",
        f"{sub}/qwen3_tts_predictor.gguf",
    ]


def missing_files(model_dir, quant: str = "none") -> List[Path]:
    model_dir = Path(model_dir)
    return [model_dir / rel for rel in manifest(quant)
            if not (model_dir / rel).exists()]


def _probe(url: str, timeout: float = 3.0) -> bool:
    """HEAD-probe a base URL (download.rs:31-38)."""
    try:
        req = urllib.request.Request(url, method="HEAD")
        urllib.request.urlopen(req, timeout=timeout)
        return True
    except Exception:
        return False


def resolve_base(repo_id: str = DEFAULT_REPO) -> str:
    """Pick huggingface.co or the hf-mirror fallback (download.rs:14-29).
    Override with QTTS_HF_BASE for air-gapped mirrors."""
    override = os.environ.get("QTTS_HF_BASE")
    if override:
        return f"{override.rstrip('/')}/{repo_id}/resolve/main"
    base = HF_BASE if _probe(HF_BASE) else HF_MIRROR
    return f"{base}/{repo_id}/resolve/main"


def probe_manifest(quant: str = "none", repo_id: str = DEFAULT_REPO,
                   timeout: float = 3.0) -> Optional[dict]:
    """HEAD-probe every manifest file on the hub without downloading.

    Returns None when no hub is reachable (air-gapped box), otherwise
    ``{"base": <url>, "published": [rel...], "absent": [rel...]}``.
    Used by the verify runbook's hub-probe drill so "the files appeared
    on HF" is noticed the day it happens (the reference's manifest lives
    at download.rs:55-101; this framework's real-checkpoint drills are
    blocked on those files, VERDICT r4 #5)."""
    if not (_probe(HF_BASE, timeout) or _probe(HF_MIRROR, timeout)
            or os.environ.get("QTTS_HF_BASE")):
        return None
    base = resolve_base(repo_id)
    published: List[str] = []
    absent: List[str] = []
    for rel in manifest(quant) + OPTIONAL_FILES:
        (published if _probe(f"{base}/{rel}", timeout) else absent).append(rel)
    return {"base": base, "published": published, "absent": absent}


def _download_file(url: str, target: Path,
                   progress: Optional[Callable[[str, int, int], None]] = None,
                   chunk: int = 1 << 20) -> None:
    """Stream url -> target with progress callbacks; atomic via .part."""
    target.parent.mkdir(parents=True, exist_ok=True)
    part = target.with_suffix(target.suffix + ".part")
    with urllib.request.urlopen(url, timeout=30) as resp:
        total = int(resp.headers.get("Content-Length") or 0)
        done = 0
        with open(part, "wb") as f:
            while True:
                buf = resp.read(chunk)
                if not buf:
                    break
                f.write(buf)
                done += len(buf)
                if progress:
                    progress(target.name, done, total)
    part.replace(target)


def _print_progress(name: str, done: int, total: int) -> None:
    if total:
        pct = 100.0 * done / total
        sys.stderr.write(f"\r  {name}: {done >> 20} / {total >> 20} MiB "
                         f"({pct:5.1f}%)")
    else:
        sys.stderr.write(f"\r  {name}: {done >> 20} MiB")
    if total and done >= total:
        sys.stderr.write("\n")
    sys.stderr.flush()


def check_and_download(model_dir, quant: str = "none",
                       repo_id: str = DEFAULT_REPO,
                       quiet: bool = False) -> None:
    """Fetch any missing manifest files (and try the optional ONNX encoders).

    Raises RuntimeError listing the missing files if the network is
    unreachable, so an air-gapped user knows exactly what to place where.
    """
    model_dir = Path(model_dir)
    missing = missing_files(model_dir, quant)
    optional_missing = [rel for rel in OPTIONAL_FILES
                        if not (model_dir / rel).exists()]
    if not missing and not optional_missing:
        return
    base = resolve_base(repo_id)
    progress = None if quiet else _print_progress

    failed: List[str] = []
    for rel in manifest(quant):
        target = model_dir / rel
        if target.exists():
            continue
        url = f"{base}/{rel}"
        if not quiet:
            print(f"Downloading model file: {rel} ...", file=sys.stderr)
        try:
            _download_file(url, target, progress)
        except (urllib.error.URLError, OSError) as e:
            failed.append(f"{rel} ({e})")
    if failed:
        raise RuntimeError(
            "Could not download required model files. Place them under "
            f"{model_dir}: " + ", ".join(failed))

    for rel in optional_missing:
        target = model_dir / rel
        try:
            if not quiet:
                print(f"Downloading optional file: {rel} ...", file=sys.stderr)
            _download_file(f"{base}/{rel}", target, progress)
        except (urllib.error.URLError, OSError):
            if not quiet:
                print(f"  (optional {rel} unavailable — voice cloning from "
                      "raw WAV will be disabled)", file=sys.stderr)

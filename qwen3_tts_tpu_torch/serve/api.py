"""A minimal HTTP API over one engine (the standard library's http.server).
Counterpart of qwen3_tts_tpu/serve/api.py, with its endpoints:

  GET  /health            -> {"status": "ok", "speakers": [...]}
  POST /tts               -> audio/wav
        body: {"text": "...", "speaker": "vivian", "instruction": null,
               "max_steps": 512, "temperature": 0.7, "top_k": 40,
               "top_p": 0.9, "seed": null}
  POST /tts?stream=1      -> chunked audio/L16 (PCM16 pieces as the
                             engine's stream yields them)

Two modes, as in the JAX server:
  * direct (no batcher): requests take turns on a lock of the server's,
    under which each sets the engine's sampler and frame budget and
    synthesizes (engine.generate_with_voice or generate_stream);
  * batched: `TtsServer(..., batcher=OnlineBatcher(...) or OnlineRouter
    (...))`: non-streaming requests go to the online batcher with their
    max_steps as the request's frame budget and change nothing of the
    engine; streams still run direct.

A body that is not JSON, lacks "text", or gives max_steps (a positive
integer), temperature, top_k or top_p that does not parse as a number
answers 400, in either mode.

A direct stream beside a batcher shares the engine's kernels, whose
scratch is per weights, not per caller: the engine's `device_lock`
(engine.py, "Threads"), which the batcher's worker holds for each round
and the engine for each chunk of a stream and each request, keeps their
launches apart.

    python -m qwen3_tts_tpu_torch.serve.api --device cuda --batch 8
    qwen3-tts-torch-serve --buckets 64,128,256 --warmup
"""

from __future__ import annotations

import io
import json
import threading
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..core import protocol as P
from ..core.config import SamplerConfig
from ..utils.logging import get_logger


def _pcm16(samples: np.ndarray) -> bytes:
    return (np.clip(np.rint(samples * 32767.0), -32768, 32767)
            .astype(np.int16).tobytes())


def _wav_bytes(samples: np.ndarray, rate: int = P.SAMPLE_RATE) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(_pcm16(samples))
    return buf.getvalue()


def make_handler(engine, lock: threading.Lock, batcher=None):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            get_logger().info("http " + fmt % args)

        def _send(self, body: bytes, content_type: str, **headers):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for name, value in headers.items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") in ("", "/health"):
                self._send(json.dumps({
                    "status": "ok",
                    "speakers": sorted(engine.speakers)}).encode(),
                    "application/json")
            else:
                self.send_error(404)

        def do_POST(self):
            try:
                self._do_post()
            except BrokenPipeError:
                pass
            except Exception as e:   # a failed synthesis: 500, keep serving
                get_logger().exception("tts request failed")
                try:
                    self.send_error(500, f"synthesis failed: {e}")
                except Exception:
                    pass

        def _do_post(self):
            if not self.path.startswith("/tts"):
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                text = req["text"]
                max_steps = (None if req.get("max_steps") is None
                             else int(req["max_steps"]))
                if max_steps is not None and max_steps < 1:
                    raise ValueError(f"max_steps {max_steps} < 1")
                sampler = SamplerConfig(
                    temperature=float(req.get("temperature", 0.7)),
                    top_k=int(req.get("top_k", 40)),
                    top_p=float(req.get("top_p", 0.9)),
                    seed=req.get("seed"))
            except (KeyError, TypeError, ValueError, AttributeError) as e:
                # a malformed body, field or number (json's decode error
                # is a ValueError)
                self.send_error(400, f"bad request: {e!r}")
                return
            stream = "stream=1" in (self.path.split("?", 1) + [""])[1]
            voice = engine.get_speaker(req.get("speaker", P.DEFAULT_SPEAKER))
            instruct = req.get("instruction")
            if batcher is not None and not stream:
                from .batch import BatchRequest
                result = batcher.submit(BatchRequest(
                    text, voice, instruct, max_frames=max_steps)).result()
                self._send(_wav_bytes(result.audio.samples), "audio/wav",
                           **{"X-QTTS-Frames": str(result.frames)})
                return
            with lock:
                engine.set_sampler_config(sampler)
                if max_steps is not None:
                    engine.set_max_steps(max_steps)
                if stream:
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/L16;rate=24000")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    for chunk in engine.generate_stream(text, voice, instruct):
                        pcm = _pcm16(chunk)
                        self.wfile.write(f"{len(pcm):x}\r\n".encode())
                        self.wfile.write(pcm + b"\r\n")
                    self.wfile.write(b"0\r\n\r\n")
                    return
                audio = engine.generate_with_voice(text, voice, instruct)
                metrics = engine.last_metrics
            self._send(_wav_bytes(audio.samples), "audio/wav",
                       **{"X-QTTS-Frames": str(metrics.frames),
                          "X-QTTS-RTF": f"{metrics.rtf:.4f}"})

    return Handler


class TtsServer:
    """Threaded HTTP server over one engine (module docstring)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8777,
                 batcher=None):
        self.engine = engine
        self.batcher = batcher
        self._lock = threading.Lock()
        self.httpd = ThreadingHTTPServer(
            (host, port), make_handler(engine, self._lock, batcher))
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TtsServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="qwen3_tts_tpu_torch.serve.api")
    ap.add_argument("--model-dir", default="models")
    ap.add_argument("--quant", default="none",
                    choices=("none", "q5_k_m", "q8_0"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--batch", type=int, default=4,
                    help="online-batching lanes (0 = each request alone, "
                         "in turn)")
    ap.add_argument("--bucket", type=int, default=128,
                    help="prompt bucket of the online batcher")
    ap.add_argument("--buckets", default=None,
                    help="comma-separated prompt buckets, e.g. 64,128,256: "
                         "each request goes to the smallest that fits "
                         "(OnlineRouter; overrides --bucket)")
    ap.add_argument("--warmup", action="store_true",
                    help="build the kernels and run each bucket and batch "
                         "size once before listening (engine.warmup)")
    args = ap.parse_args(argv)
    from ..engine import TtsEngine
    engine = TtsEngine(model_dir=args.model_dir, quant=args.quant,
                       device=args.device)
    buckets = ([int(x) for x in args.buckets.split(",")]
               if args.buckets else None)
    if args.warmup:
        engine.warmup(buckets=tuple(buckets) if buckets
                      else (args.bucket or 128,),
                      batch_sizes=(max(args.batch, 1),))
    batcher = None
    if args.batch > 0:
        from .online import OnlineBatcher, OnlineRouter
        batcher = (OnlineRouter(engine, batch_size=args.batch,
                                buckets=buckets) if buckets else
                   OnlineBatcher(engine, batch_size=args.batch,
                                 bucket=args.bucket).start())
    server = TtsServer(engine, args.host, args.port, batcher=batcher)
    print(f"serving on {args.host}:{server.port}")
    server.start()
    try:
        server._thread.join()
    except KeyboardInterrupt:
        server.stop()
        if batcher is not None:
            batcher.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

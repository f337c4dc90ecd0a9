"""Batched serving.  Counterpart of qwen3_tts_tpu/serve/: wave batching and
the request/result types (batch.py), continuous batching (continuous.py)
and the lane codec (codec_path.py).  The online batcher and the HTTP API
are not ported yet."""

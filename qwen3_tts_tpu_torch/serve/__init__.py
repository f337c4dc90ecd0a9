"""Batched serving.  Counterpart of qwen3_tts_tpu/serve/: continuous
batching (continuous.py) with its request/result types (batch.py) and the
lane codec (codec_path.py).  Wave batching, the online batcher and the HTTP
API are not ported yet."""

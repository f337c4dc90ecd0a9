"""Batched and online serving.  Counterpart of qwen3_tts_tpu/serve/: wave
batching and the request/result types (batch.py), continuous batching
(continuous.py), the lane codec (codec_path.py), the online batcher and
router (online.py) and the HTTP API (api.py:
`python -m qwen3_tts_tpu_torch.serve.api`)."""

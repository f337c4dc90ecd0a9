"""Tensor and data parallelism over torch.distributed.  Counterpart of
qwen3_tts_tpu/parallel/: the (data, model) mesh, the parameter specs and
shard_params (mesh.py), the launch glue (distributed.py) and the explicit
row-parallel schedule of the decoder (tp.py)."""

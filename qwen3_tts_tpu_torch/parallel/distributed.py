"""Launch glue for a mesh of processes.  Counterpart of
qwen3_tts_tpu/parallel/distributed.py.

One process per card, started by torchrun, which sets MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK and LOCAL_WORLD_SIZE:

    torchrun --nproc-per-node 4 serve.py      # on a host with 4 cards

    init_distributed()                       # nccl on the cards
    mesh = make_serving_mesh(model_parallel=2)   # 2 x 2
    synth = BatchSynthesizer(TtsEngine(device=mesh.device), mesh=mesh)

Data parallelism needs no collective on the math, so the data axis may
span hosts; tensor parallelism all-reduces 4 times a layer, so
`make_serving_mesh` keeps a model group inside one host.  Started without
that environment, `init_distributed` does nothing and the mesh is the
single-process one.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, local_batch, make_mesh

LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def init_distributed(backend: Optional[str] = None) -> bool:
    """Join the default process group from torchrun's environment
    (LAUNCH_ENV and LOCAL_RANK).  With none of it set this is a no-op
    returning False; part of it set raises.  A second call is ignored
    (True).  backend: "nccl" where CUDA is available, else "gloo", unless
    named; each process takes the CUDA device LOCAL_RANK, and "nccl"
    without a GPU raises: there is no CPU fallback."""
    if dist.is_initialized():
        return True
    have = [k for k in LAUNCH_ENV if k in os.environ]
    if not have:
        return False
    if len(have) != len(LAUNCH_ENV):
        missing = [k for k in LAUNCH_ENV if k not in os.environ]
        raise RuntimeError(f"init_distributed: {missing} unset beside "
                           f"{have} (start the ranks with torchrun)")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: nccl needs a CUDA device, and "
                           "this process has none")
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        backend, init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                              f"{os.environ['MASTER_PORT']}"),
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]))
    return True


def make_serving_mesh(model_parallel: int = 1, device=None) -> Mesh:
    """The (data, model) mesh over every rank of the default group: data =
    world / model_parallel (the serving axis: no collective on the math),
    model = model_parallel ranks of tensor parallelism, which must lie on
    one host: model_parallel may not exceed LOCAL_WORLD_SIZE (torchrun's
    processes a host; the world size where it is unset)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} ranks not divisible by "
                         f"model_parallel={model_parallel}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if model_parallel > local:
        raise ValueError(
            f"model_parallel={model_parallel} exceeds the {local} ranks of "
            "one host: tensor-parallel all-reduces stay inside a host")
    return make_mesh(world // model_parallel, model_parallel, device)


def local_lane_slice(mesh: Mesh, total_lanes: int) -> slice:
    """The [lo, hi) lanes of a batch of total_lanes that this rank feeds:
    its DATA index's block, so every rank of a model group feeds the same
    lanes."""
    return local_batch(mesh, total_lanes)

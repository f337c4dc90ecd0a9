"""The (data, model) mesh of a group of processes, and the sharding of the
LMs' weights over it.  Counterpart of qwen3_tts_tpu/parallel/mesh.py.

The JAX package places the arrays of ONE program on the devices of a
jax.sharding mesh.  Here each process is one rank of a torch.distributed
group and holds only its own blocks:

  * axis "data": concurrent streams.  The ranks of a data index hold lanes
    `local_batch(mesh, B)` of every batch of B lanes; nothing crosses this
    axis in the math (the serving classes gather only the small lane state
    and the finished results over it).
  * axis "model": tensor parallelism.  Every projection weight shards its
    CONTRACTION axis over the ranks of a model group (row-parallel: the
    rank multiplies its block of the input features and one all-reduce sums
    the partial products, `row_parallel`; 4 all-reduces a layer); q/kv
    heads, attention and the KV cache are head-local, so a rank's cache is
    [L, B / n_data, Hkv / n_model, C, Dh] (`kv_cache_spec`).  The JAX
    package's reasons for this split over the Megatron column/row one (no
    reshard inside a layer) hold here too.

A rank's block of a parameter tree (`shard_params`) names its mesh under
the key "mesh", and the port's model functions read it there:
models/transformer.decoder_forward then projects through `row_parallel`
and attends over the rank's heads, so every caller of the decoder (the
talker, the predictor, runtime/generate's frame and bulk loops and its
Generator) runs the row-parallel schedule on such a tree (parallel/tp.py).

Ranks are laid out data-outermost: rank = data_index * n_model +
model_index, the order of the JAX `make_mesh`'s reshape(n_data, n_model).
A model group is the n_model ranks of one data index, a data group the
n_data ranks of one model index.

    init_distributed()                       # parallel/distributed.py
    mesh = make_mesh(n_data=2, n_model=1)    # world of 2 ranks
    talker_local = shard_params(strip_packs(talker), mesh,
                                talker_param_specs())

`make_mesh(1, 1)` in a process with no default group is the
single-process mesh: no groups, no collectives.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ..kernels.int4_matmul import matmul_int4
from ..ops.quant import _int8_mm, is_int4, is_quantized, matmul

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the contraction axis of a plain [.., in, out] weight: the axis every
# projection shards over MODEL_AXIS
CONTRACTION = -2


class Mesh:
    """One rank's view of an n_data x n_model mesh: its (data_index,
    model_index), the process groups of its model row and of its data
    column (None in a single-process mesh), and its device.
    `all_reduces` counts the model-axis all-reduces of the forward."""

    def __init__(self, n_data: int, n_model: int, data_index: int,
                 model_index: int, device, data_group=None,
                 model_group=None):
        self.n_data, self.n_model = int(n_data), int(n_model)
        self.data_index, self.model_index = int(data_index), int(model_index)
        if not (0 <= self.data_index < self.n_data
                and 0 <= self.model_index < self.n_model):
            raise ValueError(f"index ({data_index}, {model_index}) outside "
                             f"the mesh {n_data}x{n_model}")
        self.device = torch.device(device)
        self.data_group = data_group
        self.model_group = model_group
        self.all_reduces = 0

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def rank(self) -> int:
        return self.data_index * self.n_model + self.model_index

    def reduce_model(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                     ) -> torch.Tensor:
        """All-reduce t IN PLACE over this rank's model group (nothing in
        a single-process mesh); counted in `all_reduces`."""
        if self.model_group is not None:
            dist.all_reduce(t, op=op, group=self.model_group)
            self.all_reduces += 1
        return t

    def all_done(self, done: torch.Tensor) -> bool:
        """Whether every lane of every data rank is done: done [B_local]
        bool, ANDed over the data group (one int32 all-reduce; none where
        n_data == 1).  A loop that exits on it exits on every rank at the
        same step."""
        flag = done.all().to(torch.int32).reshape(1)
        if self.n_data > 1:
            dist.all_reduce(flag, op=dist.ReduceOp.MIN,
                            group=self.data_group)
        return bool(flag.item())

    def gather_data(self, obj) -> List[Any]:
        """[obj of data rank 0, ..., of data rank n_data - 1] on every rank
        (all_gather_object over the data group; [obj] where n_data == 1).
        For small host objects: lane state, finished results."""
        if self.n_data == 1:
            return [obj]
        out: List[Any] = [None] * self.n_data
        dist.all_gather_object(out, obj, group=self.data_group)
        return out

    def shared_seed(self, seed: Optional[int]) -> int:
        """`seed`, or where it is None one drawn from the clock on rank 0
        and broadcast to every rank: the ranks of a model group must draw
        the same code 0, and a data rank draws the whole batch's
        uniforms (mesh-independent sampling)."""
        if seed is not None:
            return int(seed)
        box = [time.time_ns() & 0x7FFFFFFFFFFFFFFF]
        if dist.is_initialized() and self.size > 1:
            dist.broadcast_object_list(box, src=0)
        return int(box[0])


def _groups(rows: List[List[int]], rank: int):
    """The process group of `rank` among `rows` (every rank calls this
    with the same rows: torch.distributed makes each group collectively)."""
    mine, _ = dist.new_subgroups_by_enumeration(rows)
    if mine is None:
        raise RuntimeError(f"rank {rank} is in none of the groups {rows}")
    return mine


def make_mesh(n_data: int = 1, n_model: int = 1, device=None) -> Mesh:
    """This rank's mesh of n_data x n_model ranks over the initialized
    default process group, whose world size must be n_data * n_model
    (ValueError naming both otherwise).  make_mesh(1, 1) in a process
    with no default group is the single-process mesh.  device: this
    rank's device (default: the current CUDA device)."""
    need = int(n_data) * int(n_model)
    if need < 1:
        raise ValueError(f"mesh {n_data}x{n_model} is empty")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {need} ranks, the default "
            f"process group has "
            f"{world if dist.is_initialized() else 'none (one process)'}"
            " (parallel/distributed.init_distributed)")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return Mesh(1, 1, 0, 0, device)
    rank = dist.get_rank()
    d, m = divmod(rank, n_model)
    model_group = _groups([[r * n_model + j for j in range(n_model)]
                           for r in range(n_data)], rank)
    data_group = _groups([[r * n_model + j for r in range(n_data)]
                          for j in range(n_model)], rank)
    return Mesh(n_data, n_model, d, m, device, data_group=data_group,
                model_group=model_group)


def decoder_param_specs() -> Dict[str, Any]:
    """The axis over which each leaf of a stacked decoder layer tree
    (talker, predictor) shards over MODEL_AXIS, or None for a replicated
    leaf: every projection shards its contraction axis (CONTRACTION, -2
    of a plain [L, in, out] weight; shard_params maps it onto the
    quantized layouts).  The JAX `decoder_param_specs` explains why the
    contraction and not the output axis."""
    return {"ln1": None, "ln2": None, "wqkv": CONTRACTION,
            "wo": CONTRACTION, "q_norm": None, "k_norm": None,
            "w_gate_up": CONTRACTION, "w_down": CONTRACTION}


def talker_param_specs() -> Dict[str, Any]:
    return {"layers": decoder_param_specs(), "final_norm": None,
            "codec_head": None}


def predictor_param_specs() -> Dict[str, Any]:
    return {"layers": decoder_param_specs(), "final_norm": None,
            "lm_head": None}


def assets_pack_specs() -> Dict[str, Any]:
    return {"codec_tables": None, "codec_tables_1024": None,
            "proj_w": None, "proj_b": None, "tts_pad": None}


def kv_cache_spec(cfg, mesh: Mesh, batch: int, capacity: int):
    """A rank's KV cache shape for a batch of `batch` lanes: batch over
    data, kv heads over model, [L, batch / n_data, Hkv / n_model, C,
    Dh]."""
    if batch % mesh.n_data or cfg.n_kv_heads % mesh.n_model:
        raise ValueError(f"batch {batch} / kv heads {cfg.n_kv_heads} do "
                         f"not split over the mesh {mesh.n_data}x"
                         f"{mesh.n_model}")
    return (cfg.n_layers, batch // mesh.n_data,
            cfg.n_kv_heads // mesh.n_model, capacity, cfg.head_dim)


def local_batch(mesh: Mesh, batch: int) -> slice:
    """The lanes [lo, hi) of a batch of `batch` lanes that this rank's data
    index holds (the same on every rank of a model group)."""
    if batch % mesh.n_data:
        raise ValueError(f"batch {batch} does not split over "
                         f"{mesh.n_data} data ranks")
    per = batch // mesh.n_data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def is_packed(key: str) -> bool:
    """A full-width kernel layout that runtime/generate.Generator adds to a
    weight dict ("fused_<mode>", "chunk", "talker_step_mode")."""
    return key.startswith("fused_") or key in ("chunk", "talker_step_mode")


def strip_packs(params: Dict[str, Any]) -> Dict[str, Any]:
    """params without the packed kernel layouts (is_packed): the fused
    step, predictor and chunk kernels pack full-width layers, and the
    row-parallel schedule never runs them sharded (neither does the JAX
    package's)."""
    return {k: v for k, v in params.items() if not is_packed(k)}


def _block(t: torch.Tensor, axis: int, mesh: Mesh, name: str
           ) -> torch.Tensor:
    n = mesh.n_model
    size = t.shape[axis]
    if size % n:
        raise ValueError(f"shard_params: {name} has {size} rows on axis "
                         f"{axis}, not a multiple of n_model={n}")
    per = size // n
    return t.narrow(axis, mesh.model_index * per, per).clone(
        memory_format=torch.contiguous_format)


def _shard_quantized(w: Dict[str, torch.Tensor], axis: int, mesh: Mesh,
                     name: str) -> Dict[str, torch.Tensor]:
    if not is_int4(w):
        # int8 {"q" [.., in, out], "s" [.., out]}: the scale is per output
        # column, so it stays whole
        return {"q": _block(w["q"], axis, mesh, name + ".q"), "s": w["s"]}
    # int4 is OUTPUT-major (ops/quant.py): q4 [.., out, in/2], s [.., out,
    # in/G]; a block of K rows is a run of the LAST axis of both
    n = mesh.n_model
    k = 2 * w["q4"].shape[-1]
    groups = w["s"].shape[-1]
    if k % n or (k // n) % 8:
        raise ValueError(f"shard_params: {name} has K={k}: a block of K / "
                         f"{n} rows must be a whole multiple of 8")
    if groups % n == 0:
        s = _block(w["s"], -1, mesh, name + ".s")
    elif groups == 1:
        s = w["s"]          # one group: every block's rows share its scale
    else:
        raise ValueError(f"shard_params: {name}'s block of K / {n} = "
                         f"{k // n} rows cuts a scale group of {k // groups}"
                         f" rows ({groups} groups)")
    return {"q4": _block(w["q4"], -1, mesh, name + ".q4"), "s": s}


def shard_params(params: Dict[str, Any], mesh: Mesh,
                 specs: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's block of a parameter tree, by a spec tree of
    decoder_param_specs' form (a missing key or None: replicated, the same
    tensor).  A plain weight is cut on its spec axis (the contraction
    axis); an int8 weight's q too, its per-column scale s stays whole; an
    int4 weight on the LAST axis of q4 and s (the port's output-major
    packing), where its block of K / n_model rows must be a multiple of 8
    and must not cut a scale group, except that a weight of ONE group keeps
    its scale whole.  The JAX `place_params` replicates any scale axis
    that does not split; here that would give a wrong product, so it
    raises.  Cut blocks are contiguous copies, so the full tensors can be
    freed.  The packed kernel layouts (is_packed) raise: strip them first
    (strip_packs); so does a tree that is already a block.  The result
    names its mesh under "mesh" (module docstring); at n_model == 1 its
    tensors are the tree's own."""
    packed = [k for k in params if is_packed(k)]
    if packed:
        raise ValueError(f"shard_params: strip the packed kernel layouts "
                         f"{packed} first (strip_packs): they are full-width")
    if "mesh" in params:
        raise ValueError("shard_params: the tree is already a rank's block")
    if mesh.n_model == 1:
        return dict(params, mesh=mesh)

    def walk(p, s, name):
        if is_quantized(p):
            return (p if s is None
                    else _shard_quantized(p, s, mesh, name))
        if isinstance(p, dict):
            return {k: walk(v, s.get(k) if isinstance(s, dict) else s,
                            f"{name}.{k}" if name else k)
                    for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v, s, name) for v in p)
        return p if s is None else _block(p, s, mesh, name)
    return dict(walk(params, specs, ""), mesh=mesh)


# ------------------------------------------------ the row-parallel product
def _k_local(w) -> int:
    """The rows of this rank's block of a weight's contraction axis."""
    if is_int4(w):
        return 2 * w["q4"].shape[-1]
    return (w["q"] if is_quantized(w) else w).shape[-2]


def _row_scale(amax: torch.Tensor) -> torch.Tensor:
    """ops.quant.matmul_a8's activation scale from a row absmax."""
    return torch.clamp(amax, min=1e-8) / 127.0


def _partial(xb: torch.Tensor, w, sx=None) -> torch.Tensor:
    """This rank's partial product xb [..., K_local] @ w_local: f32 for
    int4 (the kernel's output) and for a8 (int32 products times both
    scales, sx the whole row's scale), else xb's dtype."""
    if sx is not None:
        xq = torch.round(xb.float() / sx).to(torch.int8)
        lead, k = xq.shape[:-1], xq.shape[-1]
        y = _int8_mm(xq.reshape(-1, k).contiguous(), w["q"])
        return y.reshape(*lead, -1).float() * sx * w["s"].float()
    if is_int4(w):
        return matmul_int4(xb, w)
    return matmul(xb, w)


def _reduce(mesh: Mesh, part: torch.Tensor, dtype) -> torch.Tensor:
    """Sum the partial products over the model group in f32, then cast to
    dtype once (row_parallel)."""
    return mesh.reduce_model(part.float().contiguous()).to(dtype)


def row_parallel(mesh: Mesh, x: torch.Tensor, w, a8: bool = False,
                 local: bool = False) -> torch.Tensor:
    """x @ W for a weight W whose contraction axis is sharded over the
    model group, w this rank's block: the rank's partial product, then ONE
    all-reduce (Mesh.reduce_model) sums the group's.  x [..., D] is whole
    and the same on every rank of the group (the rank takes its block of
    the features), or with local=True already this rank's block (the
    head-local attention output before wo).

    The partial products are summed in f32 and cast once to x's dtype (bf16
    on the card): closer to the unsharded product, which rounds its f32
    accumulator once, than the JAX psum, which adds in the matmul's output
    dtype.  At n_model = 2 the two agree (two bf16 values sum exactly in
    f32; chip_smoke.py's parallel phase measures it); from 3 ranks on a
    bf16 sum rounds at every step.  With one rank in the model group this
    is the unsharded product bit for bit.

    a8 (int8 weights, ops.quant.matmul_a8) quantizes each activation row by
    its absmax over the WHOLE row: taken from the whole x before its block
    is sliced, or, for a local x, max-reduced over the model group first.
    A scale from the rank's slice would be a different function.  The
    int32 partial products times both scales then sum to the unsharded
    product up to f32 rounding.  Plain and int4 weights ignore a8."""
    k = _k_local(w)
    a8 = a8 and is_quantized(w) and not is_int4(w)
    sx = None
    if local:
        xb = x
        if a8:
            amax = xb.float().abs().amax(dim=-1, keepdim=True).contiguous()
            sx = _row_scale(mesh.reduce_model(amax, dist.ReduceOp.MAX))
    else:
        xb = x[..., mesh.model_index * k:(mesh.model_index + 1) * k]
        if a8:
            sx = _row_scale(x.float().abs().amax(dim=-1, keepdim=True))
    return _reduce(mesh, _partial(xb, w, sx), x.dtype)

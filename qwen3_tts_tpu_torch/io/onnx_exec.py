"""ONNX graph execution in PyTorch: the published codec graphs op by op on
the engine's device.  Counterpart of qwen3_tts_tpu/io/onnx_exec.py, which
traces the same graphs into one XLA program.

The graph is parsed once (io.onnx_lite).  `run` walks it node by node on
every call: each node maps to a few torch ops (F.conv1d, torch.matmul,
...), so a call is one kernel launch or a few per node, enqueued by Python.
`jitted()` is the counterpart of the JAX executor's jax.jit: one plan per
shape signature, and on a CUDA device one CUDA graph per signature.

  * Signature: the feed names, each feed's shape and dtype, and the
    device; under `vmap` (decode_batch) the batch size too, as the first
    dim of every feed.  No handler reads a device value on the host
    (below), so every HOST value of a walk depends on the signature alone.
  * Plan: the first call of a signature is one ordinary walk that records
    every HOST result as a constant, and each node that runs on the device
    as a step: the node (its handler, input names, attributes) with the
    host-to-device copies it made, which the plan keeps on the device.  A
    plan run starts from the constants and runs the steps alone: no host
    node and no per-call copy (a step's handler still reads its host
    operands as Python ints).  On the CPU `jitted` stops here.
  * Graph: on a CUDA device the second call of a signature captures the
    plan's steps as one torch.cuda.CUDAGraph on static input buffers (on a
    side stream ordered after the caller's current stream, in thread-local
    capture mode, after one plan run there that makes the libraries' lazy
    handles and workspaces outside the capture); that call and every later
    one copy the feeds into the static inputs, replay the graph on the
    current stream and return copies of its outputs (the next replay
    overwrites them, and a decoder carries its state into the next call).
    Each graph has a memory pool of its own, so no replay overwrites
    another graph's outputs.  Capture waits for a second call because a
    stream meets many signatures once: the carried state grows each call
    until the graph's windows saturate.
  * Bound: an executor keeps at most MAX_SIGNATURES plans with their
    graphs, least recently used first out, because each graph holds its
    own pool of device memory and a graph without windows (the test
    fixture's decoder: its KV grows by a chunk each call) meets a new
    signature every call.
  * Counters (`stats`): eager walks (`run` and plan builds), plans built,
    plan runs, graphs captured, graph replays, graphs held and the bytes
    they hold (the device memory reserved while capturing, plus the static
    inputs), and the host ms spent building plans and capturing graphs
    (enqueue time: the host does not wait for the device there).
  * A capture that fails raises OnnxCaptureError, a replay that fails
    OnnxRunError, each naming the graph's file and the signature; no path
    returns the eager walk's result in their place.

Values are HOST or DEVICE, as in the JAX executor:
  * HOST values are numpy arrays.  `Shape` and `Size` always yield HOST;
    the small integer ops of _HOST_OPS on HOST inputs (at most
    _HOST_ELEMS_CAP elements in all) stay HOST and run in numpy.  Reshape,
    Slice, Expand, Pad, Range, Tile, ConstantOfShape and Resize targets
    therefore fold to Python ints.
  * DEVICE values are torch tensors on the executor's device.  A HOST
    operand of a device op becomes a tensor of its own (ONNX) dtype:
    initializers once, at load; values computed on the host by a pinned,
    non-blocking copy on a CUDA device (under `jitted`: once, when the
    signature is planned).  Nothing relies on mixed
    numpy/torch arithmetic or on torch's type promotion.
  * A handler that needs Python ints and is given a DEVICE value raises
    OnnxHostValueError (the JAX executor's jit fails on the same graph);
    no handler calls `.item()` on a device tensor, so a call has no hidden
    device-to-host synchronisation.
  * Initializers of more than PARAM_THRESHOLD elements of a floating type
    become device tensors once, at load time (`params`); the rest stay
    HOST (`consts`), so that shape arithmetic can fold.
  * An op without a handler raises UnsupportedOnnxOp when the graph is
    loaded, naming the op and the node; an attribute a handler does not
    take raises it when the node runs.  A node that fails at run time
    raises OnnxRunError naming the graph's file and the node.

Where this executor departs from the JAX one, it follows the ONNX
definition: Gather and GatherElements wrap negative indices (then clamp,
as the JAX executor clamps every index); integer Div truncates toward zero
(the JAX executor floors); ArgMax / ArgMin honour select_last_index;
Resize honours nearest_mode.  The JAX executor runs without 64-bit types,
so its int64 values are int32 on the device; here they stay int64.  Its
float64 values are float32 on the device, and so they are here: a float64
initializer or host value becomes a float32 tensor (ONNX would refuse a
MatMul of float and double; both executors run it in float32).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import vmap

from ..core.device import set_cuda_precision
from .onnx_lite import _DTYPES, OnnxGraph, OnnxNode, read_onnx_graph

# initializers larger than this (elements) become device tensors
PARAM_THRESHOLD = 64

# plans (each with its CUDA graph, if captured) an executor keeps: module
# docstring, Bound
MAX_SIGNATURES = 32

# HOST ops: evaluated with numpy when every input is HOST and small
_HOST_ELEMS_CAP = 4096
_HOST_OPS = {
    "Add", "Sub", "Mul", "Div", "Neg", "Abs", "Min", "Max", "Mod",
    "Concat", "Gather", "Slice", "Unsqueeze", "Squeeze", "Reshape",
    "Cast", "Range", "Equal", "Greater", "Less", "Where", "Shape",
    "Size", "ReduceProd", "ReduceSum", "ReduceMax", "ReduceMin",
    "Floor", "Ceil", "Transpose", "Identity", "ConstantOfShape",
    "Expand", "Flatten", "Not", "And", "Or",
}

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float32,
    np.dtype(np.float16): torch.float16, np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32, np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}


class UnsupportedOnnxOp(RuntimeError):
    """An op, or an attribute of one, this executor does not run."""


class OnnxHostValueError(ValueError):
    """A handler needs a host value (Python ints) and got a device tensor."""


class OnnxRunError(RuntimeError):
    """A node, or a graph replay, failed at run time; the message names the
    graph and the node or the signature."""


class OnnxCaptureError(OnnxRunError):
    """Capturing a signature's CUDA graph failed; the message names the
    graph's file and the signature."""


class _WalkMode(threading.local):
    """What `_to_device` does in this thread: record its copies into the
    plan being built, or hand back the plan's copies in their order."""
    record: Optional[List[torch.Tensor]] = None
    tape: Optional[collections.deque] = None


def _is_host(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic, int, float, bool))


def _ints(x) -> List[int]:
    if isinstance(x, torch.Tensor):
        raise OnnxHostValueError(
            "needs a host value (Python ints) but the graph computes it on "
            "the device")
    return [int(v) for v in np.asarray(x).reshape(-1)]


def _floats(x) -> List[float]:
    if isinstance(x, torch.Tensor):
        raise OnnxHostValueError(
            "needs a host value (Python floats) but the graph computes it "
            "on the device")
    return [float(v) for v in np.asarray(x, np.float64).reshape(-1)]


def _axis_list(attrs, inputs, idx, default=None):
    """Axes come as an attr (opset < 13) or as an input tensor (>= 13)."""
    if len(inputs) > idx and inputs[idx] is not None:
        return _ints(inputs[idx])
    axes = attrs.get("axes")
    return list(axes) if axes is not None else default


def _torch_dtype(dt) -> torch.dtype:
    dt = np.dtype(dt)
    if dt not in _TORCH_DTYPES:
        raise UnsupportedOnnxOp(f"tensor type {dt} on the device")
    return _TORCH_DTYPES[dt]


def _pad_arg(pairs) -> List[int]:
    """[(lo, hi)] per spatial axis, first to last -> F.pad's flat list
    (last axis first)."""
    out: List[int] = []
    for lo, hi in reversed(pairs):
        out += [int(lo), int(hi)]
    return out


def _binary(np_fn, torch_fn):
    def op(self, node, ins, host):
        if host:
            return [np_fn(ins[0], ins[1])]
        return [torch_fn(self._t(ins[0]), self._t(ins[1]))]
    return op


def _unary(np_fn, torch_fn):
    def op(self, node, ins, host):
        if host:
            return [np_fn(ins[0])]
        return [torch_fn(self._t(ins[0]))]
    return op


def _device_unary(torch_fn):
    def op(self, node, ins, host):
        return [torch_fn(self._t(ins[0]))]
    return op


class OnnxExecutor:
    """Runs an OnnxGraph with torch on `device`:

        ex = OnnxExecutor.load(path, device="cuda")
        outs = ex.run({"x": array})           # {output name: value}
        fn = ex.jitted()                      # the same contract
        outs = fn({"x": array})               # planned / replayed

    A value of `outs` is a torch tensor on the device or, where the graph
    computed it on the host (shape arithmetic), a numpy array.  The
    device is the card unless the caller passes device="cpu"; on a CUDA
    device TF32 is turned off (core.device.set_cuda_precision), as the
    engine turns it off."""

    def __init__(self, graph: OnnxGraph, device="cuda",
                 source: Optional[str] = None):
        self.graph = graph
        self.device = torch.device(device)
        self.source = source or repr(graph.name)
        for node in graph.nodes:
            if not hasattr(self, f"_op_{node.op_type}"):
                raise UnsupportedOnnxOp(
                    f"{self.source}: ONNX op {node.op_type!r} (node "
                    f"{node.name!r}, inputs {node.inputs}) is not "
                    "implemented in io.onnx_exec")
        if self.device.type == "cuda":
            set_cuda_precision()
        self._mode = _WalkMode()
        self.params: Dict[str, torch.Tensor] = {}
        self.consts: Dict[str, np.ndarray] = {}
        for name, arr in graph.initializers.items():
            if arr.size > PARAM_THRESHOLD and arr.dtype.kind == "f":
                self.params[name] = self._to_device(arr)
            else:
                self.consts[name] = arr
        # device copies of the HOST initializers, for device ops that read
        # them (keyed by the array's id: self.consts keeps them alive)
        self._const_t = {id(a): self._to_device(a)
                         for a in self.consts.values()}
        self.input_names = [vi.name for vi in graph.inputs]
        self.output_names = [vi.name for vi in graph.outputs]
        self.device_nodes = 0     # nodes of the last walk or plan run that
        #                           ran on the device
        self.stats = dict(walks=0, plans=0, plan_runs=0, captures=0,
                          replays=0, graphs=0, graph_bytes=0, plan_ms=0.0,
                          capture_ms=0.0)
        self._jit = JittedWalk(self)

    @classmethod
    def load(cls, path, device="cuda") -> "OnnxExecutor":
        return cls(read_onnx_graph(path), device, source=str(path))

    # ------------------------------------------------------------------ run
    def run(self, feeds: Dict[str, Any]) -> Dict[str, Any]:
        """Every node once, in the graph's order.  feeds: {input name:
        numpy array or tensor}, moved to the device with their dtype."""
        env = self._env(feeds)
        self._walk(env)
        self.stats["walks"] += 1
        return {n: env[n] for n in self.output_names}

    def jitted(self, donate: bool = False) -> "JittedWalk":
        """The graph as `fn(feeds) -> {output name: value}`, with `run`'s
        contract and its values (device tensors, HOST outputs as numpy),
        planned once per shape signature and replayed as a CUDA graph on a
        CUDA device (module docstring); `fn.vmap(feeds)` maps it over the
        first dim of every feed.  Every call returns the executor's one
        JittedWalk, so its plans, graphs and bound are the executor's.
        `donate` is the JAX signature's, and as there has no effect: a
        replay copies the feeds into the graph's own inputs and never
        writes a feed."""
        del donate
        return self._jit

    def _env(self, feeds: Dict[str, Any]) -> Dict[str, Any]:
        env: Dict[str, Any] = dict(self.consts)
        env.update(self.params)
        env.update({k: self._feed(v) for k, v in feeds.items()})
        return env

    def _feed(self, v) -> torch.Tensor:
        return (v.to(self.device) if isinstance(v, torch.Tensor)
                else self._to_device(np.asarray(v)))

    def _walk(self, env: Dict[str, Any], steps: Optional[list] = None):
        """Every node once on `env`.  Where `steps` is a list, each node
        that made a device value or a host-to-device copy is appended to
        it as (node, its copies): the plan's steps."""
        self.device_nodes = 0
        for node in self.graph.nodes:
            ins = [env[n] if n else None for n in node.inputs]
            if steps is None:
                outs = self._node(node, ins)
            else:
                self._mode.record = copies = []
                try:
                    outs = self._node(node, ins)
                finally:
                    self._mode.record = None
                if copies or not all(_is_host(v) for v in outs):
                    steps.append((node, tuple(copies)))
            for name, val in zip(node.outputs, outs):
                if name:
                    env[name] = val

    def _node(self, node: OnnxNode, ins: List[Any]) -> Sequence[Any]:
        try:
            return self._exec(node, ins)
        except (UnsupportedOnnxOp, OnnxHostValueError) as e:
            raise type(e)(f"{self.source}: node {node.name!r} "
                          f"({node.op_type}): {e}") from None
        except (RuntimeError, ValueError, IndexError, TypeError) as e:
            raise OnnxRunError(f"{self.source}: node {node.name!r} "
                               f"({node.op_type}) failed: {e}") from e

    def _exec(self, node: OnnxNode, ins: List[Any]) -> Sequence[Any]:
        op = node.op_type
        handler = getattr(self, f"_op_{op}")
        if (op in _HOST_OPS
                and all(v is None or _is_host(v) for v in ins)
                and sum(np.size(v) for v in ins if v is not None)
                <= _HOST_ELEMS_CAP):
            outs = handler(node, [None if v is None else np.asarray(v)
                                  for v in ins], host=True)
            return [np.asarray(o) for o in outs]
        self.device_nodes += 1
        return handler(node, ins, host=False)

    # ---------------------------------------------------------------- plans
    def _plan(self, feeds: Dict[str, torch.Tensor]
              ) -> Tuple["_Plan", Dict[str, Any]]:
        """One walk on `feeds` (on the device) that records its plan:
        (the plan, the walk's outputs)."""
        env = self._env(feeds)
        steps: list = []
        self._walk(env, steps)
        out = {n: env[n] for n in self.output_names}
        start = {k: v for k, v in env.items() if _is_host(v)}
        start.update(self.params)
        return _Plan(steps, start, out), out

    def _run_plan(self, plan: "_Plan", feeds: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """The plan's steps on `feeds` (on the device), each handed its
        recorded copies: the graph's device outputs."""
        env = dict(plan.start)
        env.update(feeds)
        self.device_nodes = 0
        try:
            for node, copies in plan.steps:
                self._mode.tape = collections.deque(copies)
                outs = self._node(node, [env[n] if n else None
                                         for n in node.inputs])
                for name, val in zip(node.outputs, outs):
                    if name:
                        env[name] = val
        finally:
            self._mode.tape = None
        return {n: env[n] for n in plan.device_out}

    # -------------------------------------------------------------- helpers
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the device, float64 as float32.  In
        a plan run: the next of the step's recorded copies."""
        tape = self._mode.tape
        if tape is not None:
            return tape.popleft()
        t = torch.from_numpy(np.array(
            a, dtype=np.float32 if a.dtype == np.float64 else a.dtype,
            copy=True))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        else:
            t = t.to(self.device)
        if self._mode.record is not None:
            self._mode.record.append(t)
        return t

    def _t(self, v) -> torch.Tensor:
        """A value as a device tensor of its own dtype."""
        if isinstance(v, torch.Tensor):
            return v
        t = self._const_t.get(id(v))
        return t if t is not None else self._to_device(np.asarray(v))

    @staticmethod
    def _unsupported(what: str):
        raise UnsupportedOnnxOp(what)

    # ------------------------------------------------------------ basic ops
    def _op_Identity(self, node, ins, host):
        return [ins[0]]

    def _op_Constant(self, node, ins, host):
        a = node.attrs
        if "value" in a:
            return [np.asarray(a["value"])]
        for k, cast in (("value_float", np.float32), ("value_int", np.int64),
                        ("value_floats", np.float32),
                        ("value_ints", np.int64)):
            if k in a:
                return [np.asarray(a[k], cast)]
        self._unsupported("Constant without a value")

    def _op_Cast(self, node, ins, host):
        to = int(node.attrs["to"])
        if to not in _DTYPES:
            self._unsupported(f"Cast to ONNX type {to}")
        dt = np.dtype(_DTYPES[to])
        if host:
            return [np.asarray(ins[0]).astype(dt)]
        return [self._t(ins[0]).to(_torch_dtype(dt))]

    def _op_Shape(self, node, ins, host):
        shape = np.asarray(tuple(ins[0].shape) if isinstance(
            ins[0], torch.Tensor) else np.shape(ins[0]), np.int64)
        start = node.attrs.get("start", 0)
        end = node.attrs.get("end", len(shape))
        return [shape[start:end]]

    def _op_Size(self, node, ins, host):
        shape = (tuple(ins[0].shape) if isinstance(ins[0], torch.Tensor)
                 else np.shape(ins[0]))
        return [np.asarray(int(np.prod(shape, dtype=np.int64)), np.int64)]

    # elementwise -----------------------------------------------------------
    _op_Add = _binary(np.add, torch.add)
    _op_Sub = _binary(np.subtract, torch.sub)
    _op_Mul = _binary(np.multiply, torch.mul)
    _op_Pow = _binary(np.power, torch.pow)
    _op_Equal = _binary(np.equal, torch.eq)
    _op_Greater = _binary(np.greater, torch.gt)
    _op_GreaterOrEqual = _binary(np.greater_equal, torch.ge)
    _op_Less = _binary(np.less, torch.lt)
    _op_LessOrEqual = _binary(np.less_equal, torch.le)
    _op_And = _binary(np.logical_and, torch.logical_and)
    _op_Or = _binary(np.logical_or, torch.logical_or)

    def _op_Div(self, node, ins, host):
        a, b = ins
        if host:
            a, b = np.asarray(a), np.asarray(b)
            if np.issubdtype(a.dtype, np.integer):
                q = np.abs(a) // np.abs(b)
                return [(q * np.sign(a) * np.sign(b)).astype(a.dtype)]
            return [np.divide(a, b)]
        a, b = self._t(a), self._t(b)
        if not a.is_floating_point():
            return [torch.div(a, b, rounding_mode="trunc")]
        return [torch.div(a, b)]

    def _op_Min(self, node, ins, host):
        out = ins[0] if host else self._t(ins[0])
        for v in ins[1:]:
            out = np.minimum(out, v) if host else torch.minimum(out,
                                                                self._t(v))
        return [out]

    def _op_Max(self, node, ins, host):
        out = ins[0] if host else self._t(ins[0])
        for v in ins[1:]:
            out = np.maximum(out, v) if host else torch.maximum(out,
                                                                self._t(v))
        return [out]

    def _op_Mod(self, node, ins, host):
        fmod = bool(node.attrs.get("fmod", 0))
        if host:
            return [(np.fmod if fmod else np.mod)(ins[0], ins[1])]
        a, b = self._t(ins[0]), self._t(ins[1])
        return [torch.fmod(a, b) if fmod else torch.remainder(a, b)]

    _op_Neg = _unary(np.negative, torch.neg)
    _op_Abs = _unary(np.abs, torch.abs)
    _op_Floor = _unary(np.floor, torch.floor)
    _op_Ceil = _unary(np.ceil, torch.ceil)
    _op_Not = _unary(np.logical_not, torch.logical_not)
    _op_Exp = _device_unary(torch.exp)
    _op_Log = _device_unary(torch.log)
    _op_Sqrt = _device_unary(torch.sqrt)
    _op_Reciprocal = _device_unary(torch.reciprocal)
    _op_Round = _device_unary(torch.round)
    _op_Sin = _device_unary(torch.sin)
    _op_Cos = _device_unary(torch.cos)
    _op_Tanh = _device_unary(torch.tanh)
    _op_Erf = _device_unary(torch.erf)
    _op_Sigmoid = _device_unary(torch.sigmoid)
    _op_Relu = _device_unary(torch.relu)
    _op_Softplus = _device_unary(F.softplus)
    _op_Selu = _device_unary(F.selu)

    def _op_LeakyRelu(self, node, ins, host):
        return [F.leaky_relu(self._t(ins[0]),
                             float(node.attrs.get("alpha", 0.01)))]

    def _op_Elu(self, node, ins, host):
        return [F.elu(self._t(ins[0]), float(node.attrs.get("alpha", 1.0)))]

    def _op_HardSigmoid(self, node, ins, host):
        a = float(node.attrs.get("alpha", 0.2))
        b = float(node.attrs.get("beta", 0.5))
        return [torch.clamp(a * self._t(ins[0]) + b, 0.0, 1.0)]

    def _op_HardSwish(self, node, ins, host):
        x = self._t(ins[0])
        return [x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)]

    def _op_Mish(self, node, ins, host):
        x = self._t(ins[0])
        return [x * torch.tanh(F.softplus(x))]

    def _op_Gelu(self, node, ins, host):
        approx = node.attrs.get("approximate", "none")
        if approx not in ("none", "tanh"):
            self._unsupported(f"Gelu approximate={approx!r}")
        return [F.gelu(self._t(ins[0]), approximate=approx)]

    def _op_Clip(self, node, ins, host):
        lo = ins[1] if len(ins) > 1 and ins[1] is not None else \
            node.attrs.get("min")
        hi = ins[2] if len(ins) > 2 and ins[2] is not None else \
            node.attrs.get("max")
        out = self._t(ins[0])
        if lo is not None:
            out = (torch.clamp(out, min=lo) if isinstance(lo, float)
                   else torch.maximum(out, self._t(lo)))
        if hi is not None:
            out = (torch.clamp(out, max=hi) if isinstance(hi, float)
                   else torch.minimum(out, self._t(hi)))
        return [out]

    def _op_Where(self, node, ins, host):
        if host:
            return [np.where(ins[0], ins[1], ins[2])]
        return [torch.where(self._t(ins[0]), self._t(ins[1]),
                            self._t(ins[2]))]

    # reductions --------------------------------------------------------------
    def _reduce(self, np_name, torch_fn, node, ins, host):
        axes = _axis_list(node.attrs, ins, 1)
        keep = bool(node.attrs.get("keepdims", 1))
        if axes is None and node.attrs.get("noop_with_empty_axes", 0):
            return [ins[0]]
        if host:
            ax = None if axes is None else tuple(axes)
            return [getattr(np, np_name)(ins[0], axis=ax, keepdims=keep)]
        x = self._t(ins[0])
        if axes is not None and not axes:
            return [x]
        ax = tuple(range(x.dim())) if axes is None else tuple(
            a % x.dim() for a in axes)
        return [torch_fn(x, ax, keep)]

    @staticmethod
    def _prod(x, ax, keep):
        for a in sorted(ax, reverse=True):
            x = torch.prod(x, dim=a, keepdim=keep)
        return x

    def _op_ReduceSum(self, node, ins, host):
        return self._reduce("sum", lambda x, a, k: x.sum(dim=a, keepdim=k),
                            node, ins, host)

    def _op_ReduceMean(self, node, ins, host):
        return self._reduce("mean", lambda x, a, k: x.mean(dim=a, keepdim=k),
                            node, ins, host)

    def _op_ReduceMax(self, node, ins, host):
        return self._reduce("max", lambda x, a, k: x.amax(dim=a, keepdim=k),
                            node, ins, host)

    def _op_ReduceMin(self, node, ins, host):
        return self._reduce("min", lambda x, a, k: x.amin(dim=a, keepdim=k),
                            node, ins, host)

    def _op_ReduceProd(self, node, ins, host):
        return self._reduce("prod", self._prod, node, ins, host)

    def _op_ReduceL2(self, node, ins, host):
        return self._reduce(
            None, lambda x, a, k: torch.sqrt((x * x).sum(dim=a, keepdim=k)),
            node, ins, False)

    def _arg(self, node, ins, largest: bool):
        x = self._t(ins[0])
        ax = int(node.attrs.get("axis", 0)) % x.dim()
        keep = bool(node.attrs.get("keepdims", 1))
        fn = torch.argmax if largest else torch.argmin
        if node.attrs.get("select_last_index", 0):
            n = x.shape[ax]
            out = (n - 1) - fn(torch.flip(x, (ax,)), dim=ax, keepdim=keep)
        else:
            out = fn(x, dim=ax, keepdim=keep)
        return [out.to(torch.int64)]

    def _op_ArgMax(self, node, ins, host):
        return self._arg(node, ins, True)

    def _op_ArgMin(self, node, ins, host):
        return self._arg(node, ins, False)

    def _op_CumSum(self, node, ins, host):
        if node.attrs.get("exclusive", 0) or node.attrs.get("reverse", 0):
            self._unsupported("CumSum exclusive/reverse")
        return [torch.cumsum(self._t(ins[0]), dim=_ints(ins[1])[0])]

    def _op_TopK(self, node, ins, host):
        x = self._t(ins[0])
        k = _ints(ins[1])[0]
        ax = node.attrs.get("axis", -1)
        if ax not in (-1, x.dim() - 1):
            self._unsupported("TopK on a non-last axis")
        vals, idx = torch.topk(x, k, dim=-1,
                               largest=bool(node.attrs.get("largest", 1)),
                               sorted=True)
        return [vals, idx.to(torch.int64)]

    # movement ----------------------------------------------------------------
    def _op_Reshape(self, node, ins, host):
        target = _ints(ins[1])
        in_shape = list(ins[0].shape)
        out = [in_shape[i] if d == 0 and not node.attrs.get("allowzero", 0)
               else d for i, d in enumerate(target)]
        if host:
            return [np.reshape(ins[0], out)]
        return [self._t(ins[0]).reshape(out)]

    def _op_Transpose(self, node, ins, host):
        perm = node.attrs.get("perm")
        if host:
            return [np.transpose(ins[0], perm)]
        x = self._t(ins[0])
        perm = list(perm) if perm is not None else list(range(x.dim()))[::-1]
        return [x.permute(*perm)]

    def _op_Concat(self, node, ins, host):
        ax = node.attrs["axis"]
        vals = [v for v in ins if v is not None]
        if host:
            return [np.concatenate(vals, axis=ax)]
        return [torch.cat([self._t(v) for v in vals], dim=ax)]

    def _op_Split(self, node, ins, host):
        x = self._t(ins[0])
        ax = node.attrs.get("axis", 0) % x.dim()
        n_out = len(node.outputs)
        if len(ins) > 1 and ins[1] is not None:
            sizes = _ints(ins[1])
        elif "split" in node.attrs:
            sizes = list(node.attrs["split"])
        else:
            total = x.shape[ax]
            base = -(-total // n_out)
            sizes = [min(base, total - i * base) for i in range(n_out)]
        return list(torch.split(x, sizes, dim=ax))

    @staticmethod
    def _slices(node, ins, shape):
        """[(axis, slice)] of a Slice node, with the JAX executor's
        INT64_MAX / -INT64_MAX ends."""
        rank = len(shape)
        if len(ins) > 1 and ins[1] is not None:          # opset >= 10
            starts, ends = _ints(ins[1]), _ints(ins[2])
            axes = (_ints(ins[3]) if len(ins) > 3 and ins[3] is not None
                    else list(range(len(starts))))
            steps = (_ints(ins[4]) if len(ins) > 4 and ins[4] is not None
                     else [1] * len(starts))
        else:                                            # opset 1 attrs
            starts = list(node.attrs["starts"])
            ends = list(node.attrs["ends"])
            axes = list(node.attrs.get("axes", range(len(starts))))
            steps = [1] * len(starts)
        out = []
        big = 1 << 62
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            en_c: Optional[int] = en
            if en >= big:
                en_c = None
            elif en <= -big:
                en_c = None if sp < 0 else 0
            if sp < 0 and en_c == 0:
                en_c = None                     # to the very beginning
            out.append((ax % rank, slice(st, en_c, sp)))
        return out

    def _op_Slice(self, node, ins, host):
        x = ins[0] if host else self._t(ins[0])
        for ax, sl in self._slices(node, ins, tuple(x.shape)):
            if host or sl.step > 0:
                x = x[(slice(None),) * ax + (sl,)]
            else:                   # torch slices take no negative step
                idx = torch.arange(*sl.indices(x.shape[ax]),
                                   device=x.device)
                x = x.index_select(ax, idx)
        return [x]

    def _op_Gather(self, node, ins, host):
        ax = node.attrs.get("axis", 0)
        if host:
            return [np.take(ins[0], np.asarray(ins[1]).astype(np.int64),
                            axis=ax)]
        data, idx = self._t(ins[0]), self._t(ins[1]).to(torch.int64)
        ax %= data.dim()
        n = data.shape[ax]
        idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
        out = data.index_select(ax, idx.reshape(-1))
        return [out.reshape(tuple(data.shape[:ax]) + tuple(idx.shape)
                            + tuple(data.shape[ax + 1:]))]

    def _op_GatherElements(self, node, ins, host):
        data, idx = self._t(ins[0]), self._t(ins[1]).to(torch.int64)
        ax = node.attrs.get("axis", 0) % data.dim()
        n = data.shape[ax]
        idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
        return [torch.gather(data, ax, idx)]

    def _op_Unsqueeze(self, node, ins, host):
        axes = _axis_list(node.attrs, ins, 1)
        out = ins[0] if host else self._t(ins[0])
        rank = out.ndim + len(axes)
        for ax in sorted(a % rank for a in axes):
            out = np.expand_dims(out, ax) if host else out.unsqueeze(ax)
        return [out]

    def _op_Squeeze(self, node, ins, host):
        axes = _axis_list(node.attrs, ins, 1)
        if host:
            return [np.squeeze(ins[0], axis=None if axes is None
                               else tuple(axes))]
        x = self._t(ins[0])
        if axes is None:
            axes = [i for i, d in enumerate(x.shape) if d == 1]
        for ax in sorted((a % x.dim() for a in axes), reverse=True):
            x = x.squeeze(ax)
        return [x]

    def _op_Flatten(self, node, ins, host):
        shape = tuple(ins[0].shape)
        ax = node.attrs.get("axis", 1)
        ax = ax + len(shape) if ax < 0 else ax
        lead = int(np.prod(shape[:ax], dtype=np.int64)) if ax else 1
        if host:
            return [np.reshape(ins[0], (lead, -1))]
        return [self._t(ins[0]).reshape(lead, -1)]

    def _op_Expand(self, node, ins, host):
        target = _ints(ins[1])
        shape = list(ins[0].shape)
        pad = len(target) - len(shape)
        shape = [1] * pad + shape
        out_shape = [max(a, b) for a, b in zip(shape, target)]
        if host:
            return [np.broadcast_to(np.reshape(ins[0], shape), out_shape)]
        return [self._t(ins[0]).reshape(shape).expand(out_shape)]

    def _op_Tile(self, node, ins, host):
        return [self._t(ins[0]).repeat(*_ints(ins[1]))]

    def _op_Pad(self, node, ins, host):
        mode = node.attrs.get("mode", "constant")
        pads = (_ints(ins[1]) if len(ins) > 1 and ins[1] is not None
                else list(node.attrs["pads"]))
        x = self._t(ins[0])
        rank = x.dim()
        axes = (_ints(ins[3]) if len(ins) > 3 and ins[3] is not None
                else list(range(rank)))
        width = [(0, 0)] * rank
        half = len(pads) // 2
        for i, ax in enumerate(axes):
            width[ax % rank] = (pads[i], pads[half + i])
        if mode == "constant":
            cval = node.attrs.get("value", 0.0)
            if len(ins) > 2 and ins[2] is not None:
                cval = ins[2]
            if isinstance(cval, torch.Tensor):   # a device pad value
                one = F.pad(torch.zeros_like(x), _pad_arg(width), value=1.0)
                return [F.pad(x, _pad_arg(width)) + one * cval]
            return [F.pad(x, _pad_arg(width),
                          value=float(np.asarray(cval).reshape(-1)[0]))]
        np_mode = {"reflect": "reflect", "edge": "edge", "wrap": "wrap"}
        if mode not in np_mode:
            self._unsupported(f"Pad mode {mode!r}")
        for ax, (lo, hi) in enumerate(width):
            if lo or hi:       # numpy's pad of the positions = the indices
                idx = np.pad(np.arange(x.shape[ax]), (lo, hi),
                             mode=np_mode[mode])
                x = x.index_select(ax, self._to_device(idx))
        return [x]

    def _op_ConstantOfShape(self, node, ins, host):
        shape = _ints(ins[0])
        v = node.attrs.get("value")
        v = np.zeros(1, np.float32) if v is None else np.asarray(v)
        out = np.full(shape, v.reshape(-1)[0], v.dtype)
        return [out if out.size <= _HOST_ELEMS_CAP else self._t(out)]

    def _op_Range(self, node, ins, host):
        if any(isinstance(v, torch.Tensor) for v in ins):
            raise OnnxHostValueError("Range's start, limit and delta are "
                                     "computed on the device")
        s, l, d = (np.asarray(v).reshape(-1)[0] for v in ins)
        return [np.arange(s, l, d, dtype=np.asarray(ins[0]).dtype)]

    def _op_Trilu(self, node, ins, host):
        k = (_ints(ins[1])[0] if len(ins) > 1 and ins[1] is not None
             else 0)
        x = self._t(ins[0])
        return [torch.triu(x, k) if node.attrs.get("upper", 1)
                else torch.tril(x, k)]

    def _op_EyeLike(self, node, ins, host):
        n, m = tuple(ins[0].shape)
        dt = np.dtype(_DTYPES.get(int(node.attrs.get("dtype", 1)),
                                  np.float32))
        return [np.eye(n, m, node.attrs.get("k", 0), dtype=dt)]

    def _op_ScatterND(self, node, ins, host):
        if node.attrs.get("reduction", "none") != "none":
            self._unsupported("ScatterND with a reduction")
        data, idx, upd = (self._t(v) for v in ins)
        idx = idx.to(torch.int64)
        return [torch.index_put(data, tuple(idx.movedim(-1, 0)), upd)]

    # linear algebra ----------------------------------------------------------
    def _op_MatMul(self, node, ins, host):
        return [torch.matmul(self._t(ins[0]), self._t(ins[1]))]

    def _op_Gemm(self, node, ins, host):
        a, b = self._t(ins[0]), self._t(ins[1])
        if node.attrs.get("transA", 0):
            a = a.transpose(0, 1)
        if node.attrs.get("transB", 0):
            b = b.transpose(0, 1)
        out = float(node.attrs.get("alpha", 1.0)) * (a @ b)
        if len(ins) > 2 and ins[2] is not None:
            out = out + float(node.attrs.get("beta", 1.0)) * self._t(ins[2])
        return [out]

    def _op_Einsum(self, node, ins, host):
        return [torch.einsum(node.attrs["equation"],
                             *[self._t(v) for v in ins])]

    # normalization -----------------------------------------------------------
    def _op_Softmax(self, node, ins, host):
        return [torch.softmax(self._t(ins[0]), dim=node.attrs.get("axis", -1))]

    def _op_LogSoftmax(self, node, ins, host):
        return [torch.log_softmax(self._t(ins[0]),
                                  dim=node.attrs.get("axis", -1))]

    @staticmethod
    def _normalize(x, axes, eps):
        mean = x.mean(dim=axes, keepdim=True)
        var = x.var(dim=axes, correction=0, keepdim=True)
        return (x - mean) / torch.sqrt(var + eps)

    def _op_LayerNormalization(self, node, ins, host):
        x = self._t(ins[0])
        ax = node.attrs.get("axis", -1) % x.dim()
        out = self._normalize(x, tuple(range(ax, x.dim())),
                              node.attrs.get("epsilon", 1e-5))
        out = out * self._t(ins[1])
        if len(ins) > 2 and ins[2] is not None:
            out = out + self._t(ins[2])
        return [out]

    @staticmethod
    def _channel(v, rank):
        return v.reshape((1, -1) + (1,) * (rank - 2))

    def _op_InstanceNormalization(self, node, ins, host):
        x, scale, bias = (self._t(v) for v in ins)
        out = self._normalize(x, tuple(range(2, x.dim())),
                              node.attrs.get("epsilon", 1e-5))
        return [out * self._channel(scale, x.dim())
                + self._channel(bias, x.dim())]

    def _op_GroupNormalization(self, node, ins, host):
        x, scale, bias = (self._t(v) for v in ins)
        g = node.attrs["num_groups"]
        n, c = x.shape[0], x.shape[1]
        xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
        xn = self._normalize(xg, tuple(range(2, xg.dim())),
                             node.attrs.get("epsilon", 1e-5)).reshape(x.shape)
        return [xn * self._channel(scale, x.dim())
                + self._channel(bias, x.dim())]

    def _op_BatchNormalization(self, node, ins, host):
        x, scale, bias, mean, var = (self._t(v) for v in ins[:5])
        eps = node.attrs.get("epsilon", 1e-5)
        r = x.dim()
        return [(x - self._channel(mean, r))
                / torch.sqrt(self._channel(var, r) + eps)
                * self._channel(scale, r) + self._channel(bias, r)]

    def _op_LpNormalization(self, node, ins, host):
        x = self._t(ins[0])
        ax = node.attrs.get("axis", -1)
        if node.attrs.get("p", 2) == 2:
            n = torch.sqrt((x * x).sum(dim=ax, keepdim=True))
        else:
            n = x.abs().sum(dim=ax, keepdim=True)
        return [x / torch.clamp(n, min=1e-12)]

    # convolution ---------------------------------------------------------
    @staticmethod
    def _conv_pads(node, in_shape, k_shape, strides, dil, rank):
        """[(lo, hi)] per spatial axis (the JAX executor's rule)."""
        auto = node.attrs.get("auto_pad", "NOTSET")
        if auto in ("SAME_UPPER", "SAME_LOWER"):
            pads = []
            for i in range(rank):
                in_d = in_shape[2 + i]
                k = (k_shape[2 + i] - 1) * dil[i] + 1
                out_d = -(-in_d // strides[i])
                total = max((out_d - 1) * strides[i] + k - in_d, 0)
                lo = total // 2 if auto == "SAME_UPPER" else -(-total // 2)
                pads.append((lo, total - lo))
            return pads
        if auto == "VALID":
            return [(0, 0)] * rank
        p = list(node.attrs.get("pads", [0] * (2 * rank)))
        return list(zip(p[:rank], p[rank:]))

    def _op_Conv(self, node, ins, host):
        x, w = self._t(ins[0]), self._t(ins[1])
        b = self._t(ins[2]) if len(ins) > 2 and ins[2] is not None else None
        rank = x.dim() - 2
        if rank not in (1, 2, 3):
            self._unsupported(f"Conv of {rank} spatial dims")
        strides = list(node.attrs.get("strides", [1] * rank))
        dil = list(node.attrs.get("dilations", [1] * rank))
        pads = self._conv_pads(node, tuple(x.shape), tuple(w.shape),
                               strides, dil, rank)
        if all(lo == hi for lo, hi in pads):
            padding = [lo for lo, _ in pads]
        else:                           # torch's padding is symmetric
            x = F.pad(x, _pad_arg(pads))
            padding = [0] * rank
        conv = (F.conv1d, F.conv2d, F.conv3d)[rank - 1]
        return [conv(x, w, b, strides, padding, dil,
                     node.attrs.get("group", 1))]

    def _op_ConvTranspose(self, node, ins, host):
        x, w = self._t(ins[0]), self._t(ins[1])
        b = self._t(ins[2]) if len(ins) > 2 and ins[2] is not None else None
        rank = x.dim() - 2
        if rank not in (1, 2, 3):
            self._unsupported(f"ConvTranspose of {rank} spatial dims")
        if "output_shape" in node.attrs:
            self._unsupported("ConvTranspose with an output_shape attr")
        if node.attrs.get("auto_pad", "NOTSET") not in ("NOTSET", "VALID"):
            self._unsupported("ConvTranspose with auto_pad SAME_*")
        strides = list(node.attrs.get("strides", [1] * rank))
        dil = list(node.attrs.get("dilations", [1] * rank))
        group = node.attrs.get("group", 1)
        out_pad = list(node.attrs.get("output_padding", [0] * rank))
        p = list(node.attrs.get("pads", [0] * (2 * rank)))
        lo, hi = p[:rank], p[rank:]
        conv_t = (F.conv_transpose1d, F.conv_transpose2d,
                  F.conv_transpose3d)[rank - 1]
        if lo == hi and all(o < max(s, d) for o, s, d in
                            zip(out_pad, strides, dil)):
            return [conv_t(x, w, b, strides, lo, out_pad, group, dil)]
        # the full output, then the ONNX window: begin pads cut from the
        # front, end pads less output_padding from the back (zeros past
        # the full length, where no input reaches)
        y = conv_t(x, w, None, strides, 0, 0, group, dil)
        for i in range(rank):
            ax = 2 + i
            extra = out_pad[i] - hi[i]
            if extra > 0:
                width = [(0, 0)] * rank
                width[i] = (0, extra)
                y = F.pad(y, _pad_arg(width))
            n = y.shape[ax] - lo[i] - max(hi[i] - out_pad[i], 0)
            y = y.narrow(ax, lo[i], n)
        if b is not None:
            y = y + self._channel(b, y.dim())
        return [y]

    # pooling -----------------------------------------------------------------
    def _pool(self, node, ins, kind):
        x = self._t(ins[0])
        rank = x.dim() - 2
        if rank not in (1, 2, 3):
            self._unsupported(f"{node.op_type} of {rank} spatial dims")
        if node.attrs.get("ceil_mode", 0) or any(
                d != 1 for d in node.attrs.get("dilations", [1] * rank)):
            self._unsupported(f"{node.op_type} with ceil_mode or dilations")
        k = list(node.attrs["kernel_shape"])
        strides = list(node.attrs.get("strides", [1] * rank))
        p = list(node.attrs.get("pads", [0] * (2 * rank)))
        pads = list(zip(p[:rank], p[rank:]))
        if kind == "avg":
            if node.attrs.get("count_include_pad", 0) == 0 and any(p):
                self._unsupported("AveragePool pads without "
                                  "count_include_pad")
            if any(p):
                x = F.pad(x, _pad_arg(pads))
            pool = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[rank - 1]
            return [pool(x, k, strides)]
        if any(p):
            x = F.pad(x, _pad_arg(pads), value=float("-inf"))
        pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[rank - 1]
        return [pool(x, k, strides)]

    def _op_AveragePool(self, node, ins, host):
        return self._pool(node, ins, "avg")

    def _op_MaxPool(self, node, ins, host):
        if len(node.outputs) > 1 and node.outputs[1]:
            self._unsupported("MaxPool's Indices output")
        return self._pool(node, ins, "max")

    def _op_GlobalAveragePool(self, node, ins, host):
        x = self._t(ins[0])
        return [x.mean(dim=tuple(range(2, x.dim())), keepdim=True)]

    # resize ---------------------------------------------------------------
    _NEAREST = {
        "round_prefer_floor": lambda v: np.ceil(v - 0.5),
        "round_prefer_ceil": lambda v: np.floor(v + 0.5),
        "floor": np.floor,
        "ceil": np.ceil,
    }

    @staticmethod
    def _source_coords(ct, out_n, in_n, scale):
        """ONNX Resize: the input coordinate of each output index."""
        i = np.arange(out_n, dtype=np.float64)
        if ct == "asymmetric":
            return i / scale
        if ct == "half_pixel":
            return (i + 0.5) / scale - 0.5
        if ct == "pytorch_half_pixel":
            return (i + 0.5) / scale - 0.5 if out_n > 1 else 0.0 * i
        if ct == "tf_half_pixel_for_nn":
            return (i + 0.5) / scale
        if ct == "align_corners":
            return i * ((in_n - 1) / (out_n - 1)) if out_n > 1 else 0.0 * i
        raise UnsupportedOnnxOp(f"Resize coordinate_transformation_mode "
                                f"{ct!r}")

    def _op_Resize(self, node, ins, host):
        x = self._t(ins[0])
        mode = node.attrs.get("mode", "nearest")
        ct = node.attrs.get("coordinate_transformation_mode", "half_pixel")
        shape = tuple(x.shape)
        scales = None
        if len(ins) > 3 and ins[3] is not None:
            sizes = _ints(ins[3])
        elif len(ins) > 2 and ins[2] is not None and np.size(ins[2]):
            scales = _floats(ins[2])
            sizes = [int(np.floor(s * d)) for s, d in zip(scales, shape)]
        else:
            self._unsupported("Resize without sizes or scales")
        if scales is None:
            scales = [s / d for s, d in zip(sizes, shape)]
        if mode == "nearest":
            nm = node.attrs.get("nearest_mode", "round_prefer_floor")
            if nm not in self._NEAREST:
                self._unsupported(f"Resize nearest_mode {nm!r}")
            for ax in range(x.dim()):
                if sizes[ax] == shape[ax]:
                    continue
                src = self._source_coords(ct, sizes[ax], shape[ax],
                                          scales[ax])
                idx = np.clip(self._NEAREST[nm](src), 0,
                              shape[ax] - 1).astype(np.int64)
                x = x.index_select(ax, self._to_device(idx))
            return [x]
        if (mode == "linear" and tuple(sizes[:2]) == shape[:2]
                and 1 <= x.dim() - 2 <= 3
                and (ct in ("half_pixel", "align_corners")
                     or ct == "pytorch_half_pixel" and min(sizes[2:]) > 1)):
            interp = ("linear", "bilinear", "trilinear")[x.dim() - 3]
            corners = ct == "align_corners"
            if len(ins) > 3 and ins[3] is not None:
                return [F.interpolate(x, size=sizes[2:], mode=interp,
                                      align_corners=corners)]
            return [F.interpolate(x, scale_factor=scales[2:], mode=interp,
                                  align_corners=corners,
                                  recompute_scale_factor=False)]
        self._unsupported(f"Resize mode={mode} "
                          f"coordinate_transformation_mode={ct}")


class _Plan:
    """One signature's walk (OnnxExecutor._plan): `steps` [(node, its
    recorded host-to-device copies)] in the graph's order; `start`, the
    environment a plan run starts from (every HOST value of the walk, the
    device params); `host_out`, the graph's HOST outputs (constants of the
    signature); `device_out`, the names of its device outputs."""

    def __init__(self, steps, start, out):
        self.steps = steps
        self.start = start
        self.host_out = {k: v for k, v in out.items() if _is_host(v)}
        self.device_out = [k for k, v in out.items() if not _is_host(v)]


class _Entry:
    """A signature's plan and, once captured, its CUDA graph with the
    graph's static inputs and outputs and the bytes they hold."""

    def __init__(self, plan: _Plan):
        self.plan = plan
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_in: Dict[str, torch.Tensor] = {}
        self.static_out: Dict[str, torch.Tensor] = {}
        self.nbytes = 0


def _signature_text(key) -> str:
    batched, device, feeds = key
    return (("vmap, " if batched else "") + f"{device}, " + ", ".join(
        f"{name} {list(shape)} {str(dt).replace('torch.', '')}"
        for name, shape, dt in feeds))


class JittedWalk:
    """OnnxExecutor.jitted(): `fn(feeds)` and `fn.vmap(feeds)` (the walk
    mapped over the first dim of every feed, torch.func.vmap: each lane
    keeps its unbatched shapes, and HOST outputs come back unbatched),
    keyed by signature: a plan per signature, a CUDA graph per signature
    on a CUDA device, at most MAX_SIGNATURES of them, least recently used
    first out (module docstring).  Thread-safe: one call at a time."""

    def __init__(self, ex: OnnxExecutor):
        self.ex = ex
        self._entries: "collections.OrderedDict[Any, _Entry]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._side: Optional[torch.cuda.Stream] = None

    def __call__(self, feeds: Dict[str, Any]) -> Dict[str, Any]:
        return self._call(feeds, batched=False)

    def vmap(self, feeds: Dict[str, Any]) -> Dict[str, Any]:
        return self._call(feeds, batched=True)

    def __len__(self) -> int:
        return len(self._entries)

    def _call(self, feeds, batched: bool) -> Dict[str, Any]:
        ex = self.ex
        feeds = {k: ex._feed(v) for k, v in feeds.items()}
        key = (batched, str(ex.device), tuple(sorted(
            (k, tuple(v.shape), v.dtype) for k, v in feeds.items())))
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry, out = self._build(key, feeds, batched)
            elif ex.device.type != "cuda":
                self._entries.move_to_end(key)
                out = self._fn(entry.plan, batched)(feeds)
                ex.stats["plan_runs"] += 1
            else:
                self._entries.move_to_end(key)
                with torch.cuda.device(ex.device):
                    if entry.graph is None:
                        self._capture(entry, key, feeds, batched)
                    out = self._replay(entry, key, feeds)
        # HOST outputs as copies: the plan keeps the originals
        out.update((k, v.copy() if isinstance(v, np.ndarray) else v)
                   for k, v in entry.plan.host_out.items())
        return {n: out[n] for n in ex.output_names}

    def _fn(self, plan: _Plan, batched: bool):
        run = functools.partial(self.ex._run_plan, plan)
        return vmap(run) if batched else run

    def _build(self, key, feeds, batched: bool):
        """The signature's first call: its plan, by one walk; (its entry,
        the walk's device outputs)."""
        ex = self.ex
        made = []
        t0 = time.perf_counter()

        def walk(feeds):
            plan, out = ex._plan(feeds)
            made.append(plan)
            return {k: out[k] for k in plan.device_out}

        out = (vmap(walk) if batched else walk)(feeds)
        ex.stats["walks"] += 1
        ex.stats["plans"] += 1
        ex.stats["plan_ms"] += (time.perf_counter() - t0) * 1e3
        entry = self._entries[key] = _Entry(made[0])
        while len(self._entries) > MAX_SIGNATURES:
            # the graph's memory goes back to the allocator: later work on
            # the current stream is ordered after its last replay there
            old = self._entries.popitem(last=False)[1]
            if old.graph is not None:
                ex.stats["graphs"] -= 1
                ex.stats["graph_bytes"] -= old.nbytes
        return entry, out

    def _capture(self, entry: _Entry, key, feeds, batched: bool) -> None:
        """The signature's second call on a CUDA device: its plan captured
        as one CUDA graph on static inputs (module docstring, Graph)."""
        ex = self.ex
        fn = self._fn(entry.plan, batched)
        t0 = time.perf_counter()
        try:
            static_in = {k: torch.empty_like(
                v, memory_format=torch.contiguous_format).copy_(v)
                for k, v in feeds.items()}
            if self._side is None:
                self._side = torch.cuda.Stream(ex.device)
            current = torch.cuda.current_stream(ex.device)
            self._side.wait_stream(current)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self._side):
                fn(static_in)                    # lazy handles, workspaces
                ex.stats["plan_runs"] += 1
                reserved = torch.cuda.memory_reserved(ex.device)
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    static_out = fn(static_in)
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
                held = torch.cuda.memory_reserved(ex.device) - reserved
            current.wait_stream(self._side)
        except (RuntimeError, ValueError, IndexError, TypeError) as e:
            raise OnnxCaptureError(
                f"{ex.source}: capturing the CUDA graph of the signature "
                f"({_signature_text(key)}) failed: {e}") from e
        entry.graph, entry.static_in, entry.static_out = (graph, static_in,
                                                          static_out)
        entry.nbytes = held + sum(t.nbytes for t in static_in.values())
        ex.stats["captures"] += 1
        ex.stats["graphs"] += 1
        ex.stats["graph_bytes"] += entry.nbytes
        ex.stats["capture_ms"] += (time.perf_counter() - t0) * 1e3

    def _replay(self, entry: _Entry, key, feeds) -> Dict[str, Any]:
        """The feeds into the static inputs, the graph replayed on the
        current stream, copies of its outputs."""
        try:
            for k, v in feeds.items():
                entry.static_in[k].copy_(v)
            entry.graph.replay()
            out = {k: v.clone() for k, v in entry.static_out.items()}
        except RuntimeError as e:
            raise OnnxRunError(
                f"{self.ex.source}: replaying the CUDA graph of the "
                f"signature ({_signature_text(key)}) failed: {e}") from e
        self.ex.stats["replays"] += 1
        return out


def summarize(path) -> str:
    """Human-readable summary of an ONNX file: ops, inputs, outputs."""
    g = read_onnx_graph(path)
    lines = [f"graph {g.name!r}  opset {g.opset}  nodes {len(g.nodes)}  "
             f"initializers {len(g.initializers)}"]
    for vi in g.inputs:
        lines.append(f"  in  {vi.name}: {vi.dtype} {vi.shape}")
    for vi in g.outputs:
        lines.append(f"  out {vi.name}: {vi.dtype} {vi.shape}")
    for op, n in g.op_histogram().items():
        lines.append(f"  {op:<28s} x{n}")
    return "\n".join(lines)

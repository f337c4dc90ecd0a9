"""Minimal ONNX reader/writer: full graph access without the onnx package.
A copy of qwen3_tts_tpu/io/onnx_lite.py (numpy only), kept here so that
the port imports nothing of the JAX package.

ONNX models are protobuf; this module walks the wire format directly and
returns the complete graph — initializers, nodes with attributes, and
declared inputs/outputs — enough to *execute* the published codec
encoder, decoder and speaker-encoder graphs (the reference implementation
runs them as ONNX Runtime sessions) through io.onnx_exec, and to import
their weights into native parameter trees through an explicit name map
(io.codec_import).

A small writer (`write_onnx`) serializes graphs back to the wire format so
tests can build genuine .onnx fixtures offline (neither the onnx package
nor onnxruntime is needed).

Wire-format facts used (ONNX schema, stable since v1):
  ModelProto.ir_version       = field 1  (varint)
  ModelProto.opset_import     = field 8  (OperatorSetIdProto: domain=1, version=2)
  ModelProto.graph            = field 7  (GraphProto)
  GraphProto.node             = field 1  (repeated NodeProto)
  GraphProto.initializer      = field 5  (repeated TensorProto)
  GraphProto.input/output     = fields 11/12 (repeated ValueInfoProto)
  NodeProto.input/output      = fields 1/2 (repeated string)
  NodeProto.name/op_type      = fields 3/4 (string)
  NodeProto.attribute         = field 5  (repeated AttributeProto)
  AttributeProto: name=1 f=2 i=3 s=4 t=5 floats=7 ints=8 strings=9 type=20
  ValueInfoProto: name=1 type=2; TypeProto.tensor_type=1
    (elem_type=1, shape=2; TensorShapeProto.dim: dim_value=1 dim_param=2)
  TensorProto.dims            = field 1  (repeated int64, may be packed)
  TensorProto.data_type       = field 2  (varint; 1=f32 6=i32 7=i64 10=f16 11=f64)
  TensorProto.float_data      = field 4  (packed floats, alt encoding)
  TensorProto.int64_data      = field 7
  TensorProto.name            = field 8  (string)
  TensorProto.raw_data        = field 9  (bytes, little-endian)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _fields(buf: memoryview) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:                       # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:                     # 64-bit
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wire == 2:                     # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:                     # 32-bit
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")
        yield field, wire, val


def _parse_tensor(buf: memoryview) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = np.float32
    name = ""
    raw = None
    float_data: List[bytes] = []
    int64_data: List[int] = []
    for field, wire, val in _fields(buf):
        if field == 1:                      # dims
            if wire == 0:
                dims.append(int(val))
            else:                           # packed
                pos = 0
                mv = val
                while pos < len(mv):
                    v, pos = _read_varint(mv, pos)
                    dims.append(v)
        elif field == 2 and wire == 0:
            dtype = _DTYPES.get(int(val), np.float32)
        elif field == 4:                    # float_data (packed or single)
            float_data.append(bytes(val) if wire == 2 else val)
        elif field == 7:                    # int64_data
            if wire == 0:
                int64_data.append(int(val))
            else:
                pos = 0
                mv = val
                while pos < len(mv):
                    v, pos = _read_varint(mv, pos)
                    int64_data.append(v)
        elif field == 8 and wire == 2:
            name = bytes(val).decode("utf-8", "replace")
        elif field == 9 and wire == 2:
            raw = bytes(val)
    shape = tuple(dims)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif float_data:
        arr = np.frombuffer(b"".join(
            fd if isinstance(fd, bytes) else bytes(fd)
            for fd in float_data), dtype=np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64)
    else:
        arr = np.zeros(0, dtype)
    try:
        arr = arr.reshape(shape)
    except ValueError:
        pass
    return name, arr


def read_onnx_initializers(path) -> Dict[str, np.ndarray]:
    """Return {name: array} for every initializer in the model's graph."""
    return read_onnx_graph(path).initializers


# --------------------------------------------------------------------------
# Full-graph parsing
# --------------------------------------------------------------------------

# AttributeProto.type enum values
_ATTR_FLOAT, _ATTR_INT, _ATTR_STRING, _ATTR_TENSOR = 1, 2, 3, 4
_ATTR_FLOATS, _ATTR_INTS, _ATTR_STRINGS = 6, 7, 8


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TensorInfo:
    name: str
    dtype: Optional[np.dtype]            # None if undeclared
    shape: Tuple[Any, ...]               # ints or str dim_params


@dataclasses.dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[TensorInfo]             # graph inputs minus initializers
    outputs: List[TensorInfo]
    opset: int = 17
    name: str = ""

    def op_histogram(self) -> Dict[str, int]:
        hist: Dict[str, int] = {}
        for n in self.nodes:
            hist[n.op_type] = hist.get(n.op_type, 0) + 1
        return dict(sorted(hist.items(), key=lambda kv: -kv[1]))


def _parse_attr(buf: memoryview) -> Tuple[str, Any]:
    name = ""
    atype = 0
    f = i = s = t = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            name = bytes(val).decode("utf-8", "replace")
        elif field == 2 and wire == 5:
            f = np.frombuffer(val, "<f4")[0].item()
        elif field == 3 and wire == 0:
            i = _signed(int(val))
        elif field == 4 and wire == 2:
            s = bytes(val)
        elif field == 5 and wire == 2:
            t = _parse_tensor(val)[1]
        elif field == 7:
            if wire == 5:
                floats.append(np.frombuffer(val, "<f4")[0].item())
            elif wire == 2:
                floats.extend(np.frombuffer(bytes(val), "<f4").tolist())
        elif field == 8:
            if wire == 0:
                ints.append(_signed(int(val)))
            elif wire == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    ints.append(_signed(v))
        elif field == 9 and wire == 2:
            strings.append(bytes(val))
        elif field == 20 and wire == 0:
            atype = int(val)
    if atype == _ATTR_FLOAT:
        return name, f
    if atype == _ATTR_INT:
        return name, i
    if atype == _ATTR_STRING:
        return name, (s or b"").decode("utf-8", "replace")
    if atype == _ATTR_TENSOR:
        return name, t
    if atype == _ATTR_FLOATS:
        return name, list(floats)
    if atype == _ATTR_INTS:
        return name, list(ints)
    if atype == _ATTR_STRINGS:
        return name, [b.decode("utf-8", "replace") for b in strings]
    # untyped (old exporters): pick whichever field was set
    for v in (i, f, s, t):
        if v is not None:
            return name, v
    return name, ints or floats or strings


def _signed(v: int) -> int:
    """Protobuf int64 varints are two's-complement in 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_node(buf: memoryview) -> OnnxNode:
    node = OnnxNode("", [], [])
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            node.inputs.append(bytes(val).decode("utf-8", "replace"))
        elif field == 2 and wire == 2:
            node.outputs.append(bytes(val).decode("utf-8", "replace"))
        elif field == 3 and wire == 2:
            node.name = bytes(val).decode("utf-8", "replace")
        elif field == 4 and wire == 2:
            node.op_type = bytes(val).decode("utf-8", "replace")
        elif field == 5 and wire == 2:
            k, v = _parse_attr(val)
            node.attrs[k] = v
    return node


def _parse_value_info(buf: memoryview) -> TensorInfo:
    name = ""
    dtype = None
    shape: List[Any] = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            name = bytes(val).decode("utf-8", "replace")
        elif field == 2 and wire == 2:                      # TypeProto
            for tf, tw, tv in _fields(val):
                if tf == 1 and tw == 2:                     # tensor_type
                    for ef, ew, ev in _fields(tv):
                        if ef == 1 and ew == 0:
                            dtype = np.dtype(_DTYPES.get(int(ev), np.float32))
                        elif ef == 2 and ew == 2:           # shape
                            for df, dw, dv in _fields(ev):
                                if df == 1 and dw == 2:     # dim
                                    dval: Any = None
                                    for xf, xw, xv in _fields(dv):
                                        if xf == 1 and xw == 0:
                                            dval = int(xv)
                                        elif xf == 2 and xw == 2:
                                            dval = bytes(xv).decode()
                                    shape.append(dval)
    return TensorInfo(name, dtype, tuple(shape))


def read_onnx_graph(path_or_bytes) -> OnnxGraph:
    """Parse a .onnx file (or raw bytes) into an OnnxGraph."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = memoryview(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = memoryview(f.read())
    g = OnnxGraph([], {}, [], [])
    raw_inputs: List[TensorInfo] = []
    for field, wire, val in _fields(data):              # ModelProto
        if field == 8 and wire == 2:                    # opset_import
            for of, ow, ov in _fields(val):
                if of == 2 and ow == 0:
                    g.opset = int(ov)
        elif field == 7 and wire == 2:                  # graph
            for gfield, gwire, gval in _fields(val):    # GraphProto
                if gfield == 1 and gwire == 2:
                    g.nodes.append(_parse_node(gval))
                elif gfield == 2 and gwire == 2:
                    g.name = bytes(gval).decode("utf-8", "replace")
                elif gfield == 5 and gwire == 2:
                    name, arr = _parse_tensor(gval)
                    g.initializers[name] = arr
                elif gfield == 11 and gwire == 2:
                    raw_inputs.append(_parse_value_info(gval))
                elif gfield == 12 and gwire == 2:
                    g.outputs.append(_parse_value_info(gval))
    g.inputs = [vi for vi in raw_inputs if vi.name not in g.initializers]
    return g


# --------------------------------------------------------------------------
# Writer (test fixtures + offline tooling; no onnx package in this env)
# --------------------------------------------------------------------------

_NP_TO_ONNX = {
    np.dtype(np.float32): 1, np.dtype(np.uint8): 2, np.dtype(np.int8): 3,
    np.dtype(np.uint16): 4, np.dtype(np.int16): 5, np.dtype(np.int32): 6,
    np.dtype(np.int64): 7, np.dtype(np.bool_): 9, np.dtype(np.float16): 10,
    np.dtype(np.float64): 11, np.dtype(np.uint32): 12, np.dtype(np.uint64): 13,
}


def _w_varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _w_tag(field: int, wire: int) -> bytes:
    return _w_varint((field << 3) | wire)


def _w_len(field: int, payload: bytes) -> bytes:
    return _w_tag(field, 2) + _w_varint(len(payload)) + payload


def _w_str(field: int, s: str) -> bytes:
    return _w_len(field, s.encode("utf-8"))


def _w_int(field: int, v: int) -> bytes:
    return _w_tag(field, 0) + _w_varint(v)


def _w_f32(field: int, v: float) -> bytes:
    return _w_tag(field, 5) + np.float32(v).tobytes()


def _w_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    dt = _NP_TO_ONNX.get(arr.dtype)
    if dt is None:
        raise ValueError(f"unsupported dtype {arr.dtype} for {name!r}")
    out = b"".join(_w_int(1, int(d)) for d in arr.shape)
    out += _w_int(2, dt)
    out += _w_str(8, name)
    out += _w_len(9, np.ascontiguousarray(arr).tobytes())
    return out


def _w_attr(name: str, value: Any) -> bytes:
    out = _w_str(1, name)
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, float):
        out += _w_f32(2, value) + _w_int(20, _ATTR_FLOAT)
    elif isinstance(value, int):
        out += _w_int(3, value) + _w_int(20, _ATTR_INT)
    elif isinstance(value, str):
        out += _w_len(4, value.encode()) + _w_int(20, _ATTR_STRING)
    elif isinstance(value, np.ndarray):
        out += _w_len(5, _w_tensor("", value)) + _w_int(20, _ATTR_TENSOR)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            for v in value:
                out += _w_int(8, int(v))
            out += _w_int(20, _ATTR_INTS)
        elif all(isinstance(v, str) for v in value):
            for v in value:
                out += _w_len(9, v.encode())
            out += _w_int(20, _ATTR_STRINGS)
        else:
            for v in value:
                out += _w_f32(7, float(v))
            out += _w_int(20, _ATTR_FLOATS)
    else:
        raise ValueError(f"unsupported attr type {type(value)} for {name!r}")
    return out


def _w_node(node: OnnxNode) -> bytes:
    out = b"".join(_w_str(1, s) for s in node.inputs)
    out += b"".join(_w_str(2, s) for s in node.outputs)
    if node.name:
        out += _w_str(3, node.name)
    out += _w_str(4, node.op_type)
    for k, v in node.attrs.items():
        out += _w_len(5, _w_attr(k, v))
    return out


def _w_value_info(info: TensorInfo) -> bytes:
    shape_pb = b""
    for d in info.shape:
        if isinstance(d, (int, np.integer)):
            shape_pb += _w_len(1, _w_int(1, int(d)))
        else:
            shape_pb += _w_len(1, _w_str(2, str(d)))
    tensor_pb = _w_int(1, _NP_TO_ONNX[np.dtype(info.dtype or np.float32)])
    tensor_pb += _w_len(2, shape_pb)
    return _w_str(1, info.name) + _w_len(2, _w_len(1, tensor_pb))


def write_onnx(graph: OnnxGraph, path=None) -> bytes:
    """Serialize an OnnxGraph to ModelProto bytes (optionally to a file)."""
    gpb = b"".join(_w_len(1, _w_node(n)) for n in graph.nodes)
    gpb += _w_str(2, graph.name or "g")
    for name, arr in graph.initializers.items():
        gpb += _w_len(5, _w_tensor(name, arr))
    for vi in graph.inputs:
        gpb += _w_len(11, _w_value_info(vi))
    for vi in graph.outputs:
        gpb += _w_len(12, _w_value_info(vi))
    mpb = _w_int(1, 8)                                   # ir_version
    mpb += _w_len(7, gpb)
    mpb += _w_len(8, _w_str(1, "") + _w_int(2, graph.opset))
    if path is not None:
        with open(path, "wb") as f:
            f.write(mpb)
    return mpb

"""The port's ONNX codec path on the CPU, against the JAX package: the
copied wire-format reader and fixture writers, the executor op family by
op family (the graphs of tests/test_onnx_exec.py and more), the streaming
decoder and its batched form, the two encoder graphs, codec_import and
convert.  One torch thread; the engine cases are in
tests/test_torch_onnx_engine.py.

Tolerances.  Float outputs of the two executors within FLOAT_TOL = 1e-5
(rtol and atol): both run f32, and XLA and torch only sum in other orders
or evaluate a transcendental to another ulp.  Integer and bool outputs,
codes, shapes and valid_samples exactly equal (the JAX executor's int64 is
int32 on its device: compared as values).  Decoder waveforms against the
numpy reference within tests/test_onnx_codec.py's rtol 1e-4, atol 1e-5;
a batched or chunked decode against the sequential one within 1e-5;
speaker embeddings within 1e-6 (f32, a unit vector).  Imported weights
bit for bit.
"""

import dataclasses
import inspect
import io
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

import fixtures_onnx as jfx
import torch_onnx_fixtures as tfx
from qwen3_tts_tpu.core.config import CodecDecoderConfig as JDecCfg
from qwen3_tts_tpu.core.config import CodecEncoderConfig as JEncCfg
from qwen3_tts_tpu.core.config import SpeakerEncoderConfig as JSpkCfg
from qwen3_tts_tpu.io import codec_import as jci
from qwen3_tts_tpu.io import convert as jconv
from qwen3_tts_tpu.io import onnx_lite as jlite
from qwen3_tts_tpu.io.onnx_exec import OnnxExecutor as JEx
from qwen3_tts_tpu.models.codec import decoder as jdec
from qwen3_tts_tpu.models.codec import encoder as jenc
from qwen3_tts_tpu.models.codec import speaker as jspk
from qwen3_tts_tpu.models.codec.onnx_decoder import OnnxAudioEncoder as JAE
from qwen3_tts_tpu.models.codec.onnx_decoder import OnnxSpeakerEncoder as JSE
from qwen3_tts_tpu.models.codec.onnx_decoder import \
    OnnxStreamingDecoder as JDec
from qwen3_tts_tpu_torch.core.config import CodecDecoderConfig as TDecCfg
from qwen3_tts_tpu_torch.core.config import CodecEncoderConfig as TEncCfg
from qwen3_tts_tpu_torch.core.config import SpeakerEncoderConfig as TSpkCfg
from qwen3_tts_tpu_torch.io import codec_import as tci
from qwen3_tts_tpu_torch.io import convert as tconv
from qwen3_tts_tpu_torch.io import onnx_lite as tlite
from qwen3_tts_tpu_torch.io.onnx_exec import OnnxExecutor as TEx
from qwen3_tts_tpu_torch.io.onnx_exec import (OnnxHostValueError,
                                              UnsupportedOnnxOp)
from qwen3_tts_tpu_torch.models.codec import decoder as tdec
from qwen3_tts_tpu_torch.models.codec import encoder as tenc
from qwen3_tts_tpu_torch.models.codec import speaker as tspk
from qwen3_tts_tpu_torch.models.codec.onnx_decoder import (
    OnnxAudioEncoder, OnnxLoadError, OnnxSpeakerEncoder, OnnxStreamingDecoder,
    decode_lanes)
from test_codec_import import _torch_export

torch.set_num_threads(1)

FLOAT_TOL = 1e-5
REF_RTOL, REF_ATOL = 1e-4, 1e-5
LANE_TOL = 1e-5
EMB_TOL = 1e-6
# a two-layer decoder between MINI and FULL
MID = tfx.Dims(DL=32, DA=64, DC=48, H=4, DH=16, K0=5, K1=5, K2=3,
               VOCAB=256, LAYERS=2, up_factors=(4, 5), up_channels=(48, 16, 1))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _same(got, want, tol=FLOAT_TOL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=what)


def _graph(lite, nodes, inits, inputs, outputs):
    return lite.OnnxGraph(
        nodes=[lite.OnnxNode(*n[:3], attrs=n[3] if len(n) > 3 else {})
               for n in nodes],
        initializers=inits,
        inputs=[lite.TensorInfo(k, np.asarray(v).dtype, np.shape(v))
                for k, v in inputs.items()],
        outputs=[lite.TensorInfo(n, np.float32, ()) for n in outputs],
        opset=17)


def _both(nodes, inits, inputs, outputs, device="cpu"):
    """The graph written by the JAX writer, read by each package, run by
    each executor: ({out: jax value}, {out: port value})."""
    data = jlite.write_onnx(_graph(jlite, nodes, inits, inputs, outputs))
    jex = JEx(jlite.read_onnx_graph(data))
    tex = TEx(tlite.read_onnx_graph(data), device)
    want = jex.run(jex.params, {k: jax.numpy.asarray(v)
                                for k, v in inputs.items()})
    got = tex.run(dict(inputs))
    return want, got


# ------------------------------------------------------------------ copies
@pytest.mark.parametrize("dims", [tfx.MINI, MID], ids=["mini", "mid"])
def test_fixture_writers_and_readers_agree(dims):
    """The jax-free fixture copy writes the JAX fixture's bytes; each
    package reads the other's: nodes and initializers equal."""
    t_bytes, t_w = tfx.build_decoder(dims, seed=3)
    j_bytes, j_w = jfx.build_decoder(dims, seed=3)
    assert t_bytes == j_bytes
    for k in j_w:
        np.testing.assert_array_equal(t_w[k], j_w[k])
    for data in (t_bytes, tlite.write_onnx(tlite.read_onnx_graph(j_bytes))):
        tg, jg = tlite.read_onnx_graph(data), jlite.read_onnx_graph(data)
        assert [(n.op_type, n.inputs, n.outputs, n.name, n.attrs)
                for n in tg.nodes] == [(n.op_type, n.inputs, n.outputs,
                                        n.name, n.attrs) for n in jg.nodes]
        assert tg.initializers.keys() == jg.initializers.keys()
        for k, v in jg.initializers.items():
            np.testing.assert_array_equal(tg.initializers[k], v)
        assert [(i.name, i.dtype, i.shape) for i in tg.inputs] == \
            [(i.name, i.dtype, i.shape) for i in jg.inputs]


@pytest.mark.parametrize("dims", [tfx.MINI, MID], ids=["mini", "mid"])
def test_fixture_decoders_agree_through_both_executors(dims):
    codes = np.random.default_rng(4).integers(0, dims.VOCAB, (5, dims.NB))
    ref = tfx.decoder_reference(dims, codes)
    np.testing.assert_array_equal(ref, jfx.decoder_reference(dims, codes))
    data, _ = tfx.build_decoder(dims)
    jd = JDec(JEx(jlite.read_onnx_graph(data)))
    td = OnnxStreamingDecoder(TEx(tlite.read_onnx_graph(data), "cpu"))
    want, _ = jd.decode(codes, jd.create_state(), is_final=True)
    got, _ = td.decode(codes, td.create_state(), is_final=True)
    _same(got, want)
    np.testing.assert_allclose(got, ref, rtol=REF_RTOL, atol=REF_ATOL)


# ---------------------------------------------------------------- executor
def _rng(seed):
    return np.random.default_rng(seed)


def _f(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _case_conv1d(stride, pad, dil, group):
    r = _rng(0)
    return ([("Conv", ["x", "w", "b"], ["y"],
              {"strides": [stride], "pads": [pad, pad], "dilations": [dil],
               "group": group, "kernel_shape": [5]})],
            {"w": _f(r, 12, 8 // group, 5), "b": _f(r, 12)},
            {"x": _f(r, 2, 8, 31)}, ["y"])


def _case_conv2d():
    r = _rng(1)
    return ([("Conv", ["x", "w"], ["y"], {"strides": [2, 1],
                                          "pads": [1, 2, 1, 2],
                                          "kernel_shape": [3, 5]})],
            {"w": _f(r, 6, 3, 3, 5)}, {"x": _f(r, 1, 3, 14, 17)}, ["y"])


def _case_conv_pads(auto, pads):
    r = _rng(5)
    attrs = {"strides": [2], "kernel_shape": [4]}
    attrs.update({"auto_pad": auto} if auto else {"pads": pads})
    return ([("Conv", ["x", "w"], ["y"], attrs)], {"w": _f(r, 4, 4, 4)},
            {"x": _f(r, 1, 4, 20)}, ["y"])


def _case_conv_t(stride, pads, opad, group, dil):
    r = _rng(2)
    w = _f(r, 8, 6 // group if group > 1 else 6, 5)
    return ([("ConvTranspose", ["x", "w", "b"], ["y"],
              {"strides": [stride], "pads": pads, "output_padding": [opad],
               "group": group, "dilations": [dil], "kernel_shape": [5]})],
            {"w": w, "b": _f(r, w.shape[1] * group)},
            {"x": _f(r, 2, 8, 19)}, ["y"])


def _case_attention():
    r = _rng(4)
    b, t, d, h = 1, 6, 32, 4
    dh = d // h
    nodes = [
        ("LayerNormalization", ["x", "g", "bta"], ["xn"],
         {"axis": -1, "epsilon": 1e-5}),
        ("MatMul", ["xn", "wq"], ["q"]), ("MatMul", ["xn", "wk"], ["k"]),
        ("MatMul", ["xn", "wv"], ["v"]),
        ("Reshape", ["q", "hs"], ["q4"]), ("Reshape", ["k", "hs"], ["k4"]),
        ("Reshape", ["v", "hs"], ["v4"]),
        ("Transpose", ["q4"], ["qt"], {"perm": [0, 2, 1, 3]}),
        ("Transpose", ["k4"], ["kt"], {"perm": [0, 2, 3, 1]}),
        ("Transpose", ["v4"], ["vt"], {"perm": [0, 2, 1, 3]}),
        ("MatMul", ["qt", "kt"], ["scores"]),
        ("Mul", ["scores", "scale"], ["scaled"]),
        ("Softmax", ["scaled"], ["probs"], {"axis": -1}),
        ("MatMul", ["probs", "vt"], ["ctx"]),
        ("Transpose", ["ctx"], ["ctxt"], {"perm": [0, 2, 1, 3]}),
        ("Reshape", ["ctxt", "fs"], ["out"]),
    ]
    inits = {"wq": _f(r, d, d), "wk": _f(r, d, d), "wv": _f(r, d, d),
             "g": _f(r, d), "bta": _f(r, d),
             "hs": np.array([b, t, h, dh], np.int64),
             "fs": np.array([b, t, d], np.int64),
             "scale": np.array(1.0 / np.sqrt(dh), np.float32)}
    return nodes, inits, {"x": _f(r, b, t, d)}, ["out"]


def _case_shape_math():
    nodes = [("Shape", ["x"], ["s"]),
             ("Gather", ["s", "i0"], ["b"], {"axis": 0}),
             ("Concat", ["b", "minus1"], ["target"], {"axis": 0}),
             ("Reshape", ["x", "target"], ["y"]), ("Relu", ["y"], ["z"])]
    inits = {"i0": np.array([0], np.int64),
             "minus1": np.array([-1], np.int64)}
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4) - 12
    return nodes, inits, {"x": x}, ["z", "target"]


def _case_slice(st, en, ax, sp):
    imax = np.iinfo(np.int64).max
    en = {"max": imax, "-max": -imax}.get(en, en)
    return ([("Slice", ["x", "st", "en", "ax", "sp"], ["y"])],
            {"st": np.array([st], np.int64), "en": np.array([en], np.int64),
             "ax": np.array([ax], np.int64), "sp": np.array([sp], np.int64)},
            {"x": np.arange(20, dtype=np.float32).reshape(4, 5)}, ["y"])


def _case_pad(mode, pads):
    r = _rng(6)
    return ([("Pad", ["x", "p"], ["y"], {"mode": mode})],
            {"p": np.array(pads, np.int64)}, {"x": _f(r, 1, 2, 9)}, ["y"])


def _case_resize(mode, ct, nearest_mode):
    r = _rng(7)
    attrs = {"mode": mode, "coordinate_transformation_mode": ct}
    if nearest_mode:
        attrs["nearest_mode"] = nearest_mode
    return ([("Resize", ["x", "", "sc"], ["y"], attrs)],
            {"sc": np.array([1.0, 1.0, 2.0], np.float32)},
            {"x": _f(r, 1, 3, 10)}, ["y"])


def _case_norms():
    r = _rng(8)
    v = np.abs(_f(r, 6)) + 0.1
    return ([("BatchNormalization", ["x", "g", "b", "m", "v"], ["bn"],
              {"epsilon": 1e-5}),
             ("InstanceNormalization", ["x", "g", "b"], ["inn"],
              {"epsilon": 1e-5}),
             ("GroupNormalization", ["x", "g3", "b3"], ["gn"],
              {"num_groups": 3, "epsilon": 1e-5}),
             ("LpNormalization", ["x"], ["lp"], {"axis": -1, "p": 2}),
             ("LayerNormalization", ["x", "gl", "bl"], ["ln"],
              {"axis": 1, "epsilon": 1e-5})],
            {"g": _f(r, 6), "b": _f(r, 6), "m": _f(r, 6), "v": v,
             "g3": _f(r, 6), "b3": _f(r, 6), "gl": _f(r, 6, 11),
             "bl": _f(r, 6, 11)},
            {"x": _f(r, 2, 6, 11)}, ["bn", "inn", "gn", "lp", "ln"])


def _case_gemm_act():
    r = _rng(9)
    nodes = [("Gemm", ["a", "w", "c"], ["g1"],
              {"transB": 1, "alpha": 0.5, "beta": 2.0}),
             ("Erf", ["g1"], ["e"]), ("Sigmoid", ["g1"], ["s"]),
             ("Mul", ["g1", "s"], ["silu"]),
             ("ReduceMean", ["silu"], ["r"], {"axes": [1], "keepdims": 0})]
    return (nodes, {"w": _f(r, 5, 4), "c": _f(r, 5)}, {"a": _f(r, 3, 4)},
            ["e", "r"])


def _case_split_where():
    nodes = [("Split", ["x"], ["a", "b", "c"], {"axis": 1}),
             ("Expand", ["a", "es"], ["ae"]), ("Greater", ["b", "c"], ["m"]),
             ("Where", ["m", "b", "c"], ["w"]),
             ("GatherElements", ["x", "gi"], ["ge"], {"axis": 1})]
    inits = {"es": np.array([2, 2, 2], np.int64),
             "gi": np.array([[0, 5], [2, 3]], np.int64)}
    return (nodes, inits,
            {"x": np.arange(12, dtype=np.float32).reshape(2, 6)},
            ["ae", "m", "w", "ge"])


def _case_streaming_state():
    r = _rng(11)
    d, hist, t, k = 8, 4, 6, 5
    imax = np.iinfo(np.int64).max
    nodes = [("Concat", ["hist", "x"], ["cat"], {"axis": 2}),
             ("Conv", ["cat", "w"], ["y"], {"kernel_shape": [k]}),
             ("Slice", ["cat", "st", "en", "ax"], ["new_hist"])]
    inits = {"w": _f(r, d, d, k), "st": np.array([-hist], np.int64),
             "en": np.array([imax], np.int64), "ax": np.array([2], np.int64)}
    return (nodes, inits, {"x": _f(r, 1, d, t), "hist": _f(r, 1, d, hist)},
            ["y", "new_hist"])


def _case_unary():
    r = _rng(12)
    ops = [("Exp", {}), ("Tanh", {}), ("Sin", {}), ("Cos", {}),
           ("Abs", {}), ("Neg", {}), ("Floor", {}), ("Ceil", {}),
           ("Round", {}), ("Relu", {}), ("Softplus", {}), ("Selu", {}),
           ("Mish", {}), ("HardSwish", {}),
           ("LeakyRelu", {"alpha": 0.1}), ("Elu", {"alpha": 0.7}),
           ("HardSigmoid", {"alpha": 0.3, "beta": 0.4}),
           ("Gelu", {}), ("Gelu", {"approximate": "tanh"}),
           ("Softmax", {"axis": 1}), ("LogSoftmax", {"axis": 0})]
    nodes = [(op, ["x"], [f"y{i}"], attrs) for i, (op, attrs) in
             enumerate(ops)]
    nodes += [("Abs", ["x"], ["ax"]), ("Add", ["ax", "one"], ["pos"]),
              ("Log", ["pos"], ["log"]), ("Sqrt", ["pos"], ["sqrt"]),
              ("Reciprocal", ["pos"], ["rec"]),
              ("Pow", ["pos", "x"], ["pow"])]
    outs = [f"y{i}" for i in range(len(ops))] + ["log", "sqrt", "rec", "pow"]
    return (nodes, {"one": np.array(1.0, np.float32)},
            {"x": _f(r, 3, 7, scale=2.0)}, outs)


def _case_binary():
    r = _rng(13)
    nodes = [("Sub", ["a", "b"], ["sub"]), ("Div", ["a", "b"], ["div"]),
             ("Max", ["a", "b", "c"], ["max"]),
             ("Min", ["a", "b", "c"], ["min"]),
             ("Mod", ["a", "b"], ["fmod"], {"fmod": 1}),
             ("Equal", ["ia", "ib"], ["eq"]), ("Less", ["a", "b"], ["lt"]),
             ("LessOrEqual", ["a", "b"], ["le"]),
             ("GreaterOrEqual", ["a", "b"], ["ge"]),
             ("Not", ["lt"], ["nlt"]), ("And", ["lt", "le"], ["and"]),
             ("Or", ["lt", "ge"], ["or"]),
             ("Div", ["ia", "ib"], ["idiv"]), ("Mod", ["ia", "ib"], ["imod"]),
             ("Clip", ["a", "lo", "hi"], ["clip"]),
             ("Where", ["lt", "a", "zero"], ["where"])]
    return (nodes,
            {"lo": np.array(-0.5, np.float32), "hi": np.array(0.7, np.float32),
             "zero": np.array(0.0, np.float32)},
            {"a": _f(r, 4, 5), "b": _f(r, 4, 5) + 3.0, "c": _f(r, 1, 5),
             "ia": r.integers(0, 50, (4, 5)).astype(np.int64),
             "ib": r.integers(1, 7, (4, 5)).astype(np.int64)},
            ["sub", "div", "max", "min", "fmod", "eq", "lt", "le", "ge",
             "nlt", "and", "or", "idiv", "imod", "clip", "where"])


def _case_reduce():
    r = _rng(14)
    nodes = [("ReduceSum", ["x", "ax"], ["sum"], {"keepdims": 0}),
             ("ReduceMax", ["x"], ["max"], {"axes": [0, 2]}),
             ("ReduceMin", ["x"], ["min"], {"axes": [-1], "keepdims": 0}),
             ("ReduceProd", ["x"], ["prod"], {"axes": [1]}),
             ("ReduceL2", ["x"], ["l2"], {"axes": [2]}),
             ("ReduceMean", ["x"], ["mean"], {}),
             ("ArgMax", ["x"], ["amax"], {"axis": 1}),
             ("ArgMin", ["x"], ["amin"], {"axis": -1, "keepdims": 0}),
             ("CumSum", ["x", "one"], ["cum"]),
             ("TopK", ["x", "k"], ["tv", "ti"], {"axis": -1})]
    return (nodes, {"ax": np.array([1], np.int64),
                    "one": np.array(1, np.int64), "k": np.array([3], np.int64)},
            {"x": _f(r, 3, 4, 5)},
            ["sum", "max", "min", "prod", "l2", "mean", "amax", "amin", "cum",
             "tv", "ti"])


def _case_movement():
    r = _rng(15)
    nodes = [("Unsqueeze", ["x", "ax02"], ["u"]),
             ("Squeeze", ["u", "ax02"], ["sq"]),
             ("Flatten", ["x"], ["fl"], {"axis": 2}),
             ("Tile", ["x", "reps"], ["tile"]),
             ("Cast", ["x"], ["ci"], {"to": 7}),
             ("Transpose", ["x"], ["tr"]),
             ("Range", ["r0", "r1", "r2"], ["range"]),
             ("ConstantOfShape", ["cs"], ["cos"],
              {"value": np.array([2.5], np.float32)}),
             ("Gather", ["x", "gi"], ["ga"], {"axis": 1}),
             ("Einsum", ["x", "x"], ["ein"], {"equation": "abc,abd->acd"}),
             ("Trilu", ["m"], ["tri"], {"upper": 0}),
             ("EyeLike", ["m"], ["eye"], {"k": 1}),
             ("ScatterND", ["m", "si", "su"], ["sc"]),
             ("Constant", [], ["cst"], {"value_ints": [3, 1, 4]}),
             ("Size", ["x"], ["size"]),
             ("Identity", ["x"], ["id"])]
    return (nodes,
            {"ax02": np.array([0, 2], np.int64),
             "reps": np.array([1, 2, 1], np.int64),
             "r0": np.array(2, np.int64), "r1": np.array(11, np.int64),
             "r2": np.array(3, np.int64), "cs": np.array([2, 3], np.int64),
             "gi": np.array([[0, 2], [3, 1]], np.int64),
             "si": np.array([[0, 1], [2, 2]], np.int64),
             "su": np.array([9.0, -9.0], np.float32)},
            {"x": _f(r, 2, 4, 3, scale=3.0), "m": _f(r, 4, 4)},
            ["u", "sq", "fl", "tile", "ci", "tr", "range", "cos", "ga", "ein",
             "tri", "eye", "sc", "cst", "size", "id"])


def _case_pool():
    r = _rng(16)
    nodes = [("MaxPool", ["x"], ["mp"], {"kernel_shape": [3],
                                         "strides": [2], "pads": [1, 1]}),
             ("AveragePool", ["x"], ["ap"], {"kernel_shape": [2],
                                             "strides": [2]}),
             ("AveragePool", ["x"], ["app"],
              {"kernel_shape": [3], "pads": [1, 1], "count_include_pad": 1}),
             ("GlobalAveragePool", ["x"], ["gap"]),
             ("MaxPool", ["x2"], ["mp2"], {"kernel_shape": [2, 2],
                                           "strides": [2, 2]})]
    return (nodes, {}, {"x": _f(r, 2, 3, 11), "x2": _f(r, 1, 2, 6, 8)},
            ["mp", "ap", "app", "gap", "mp2"])


EXEC_CASES = {
    **{f"conv1d-{a}": (lambda a=a: _case_conv1d(*a)) for a in [
        (1, 0, 1, 1), (2, 1, 1, 1), (1, 2, 2, 1), (2, 3, 1, 4),
        (3, 1, 2, 2)]},
    "conv2d": _case_conv2d,
    "conv-same-upper": lambda: _case_conv_pads("SAME_UPPER", None),
    "conv-same-lower": lambda: _case_conv_pads("SAME_LOWER", None),
    "conv-asymmetric-pads": lambda: _case_conv_pads(None, [1, 2]),
    **{f"conv-transpose-{a}": (lambda a=a: _case_conv_t(*a)) for a in [
        (1, [0, 0], 0, 1, 1), (2, [1, 1], 1, 1, 1), (4, [2, 2], 0, 1, 1),
        (2, [1, 1], 0, 2, 1), (2, [2, 2], 1, 1, 2), (3, [0, 2], 2, 1, 1),
        (2, [2, 0], 1, 1, 1)]},
    "conv-transpose-upsampler": lambda: (
        [("ConvTranspose", ["x", "w"], ["y"],
          {"strides": [4], "kernel_shape": [4]})],
        {"w": _f(_rng(3), 16, 8, 4)}, {"x": _f(_rng(3), 1, 16, 12)}, ["y"]),
    "attention-block": _case_attention,
    "shape-math-folds": _case_shape_math,
    "slice-intmax": lambda: _case_slice(1, "max", 1, 2),
    "slice-negative-step": lambda: _case_slice(-1, "-max", 0, -1),
    "slice-negative-step-2": lambda: _case_slice(3, 0, 1, -2),
    "pad-reflect": lambda: _case_pad("reflect", [0, 0, 3, 0, 0, 2]),
    "pad-edge": lambda: _case_pad("edge", [0, 1, 2, 0, 0, 3]),
    "pad-wrap": lambda: _case_pad("wrap", [0, 0, 2, 0, 0, 4]),
    "pad-constant": lambda: _case_pad("constant", [0, 1, 2, 1, 0, 3]),
    "resize-nearest-asymmetric-floor":
        lambda: _case_resize("nearest", "asymmetric", "floor"),
    "resize-linear-half-pixel":
        lambda: _case_resize("linear", "half_pixel", None),
    "norms": _case_norms,
    "gemm-activations-reduce": _case_gemm_act,
    "split-expand-where-gatherelements": _case_split_where,
    "streaming-state-concat-slice": _case_streaming_state,
    "unary": _case_unary,
    "binary": _case_binary,
    "reductions": _case_reduce,
    "movement": _case_movement,
    "pooling": _case_pool,
}


@pytest.mark.parametrize("case", sorted(EXEC_CASES))
def test_executor_matches_jax(case):
    """Every output of the port's executor against the JAX executor's on
    the same graph and inputs: floats within FLOAT_TOL, integers and bools
    exactly."""
    nodes, inits, inputs, outputs = EXEC_CASES[case]()
    want, got = _both(nodes, inits, inputs, outputs)
    for name in outputs:
        _same(got[name], want[name], what=name)


def test_shape_math_stays_on_the_host():
    nodes, inits, inputs, outputs = _case_shape_math()
    _, got = _both(nodes, inits, inputs, outputs)
    assert isinstance(got["target"], np.ndarray)
    assert isinstance(got["z"], torch.Tensor)


def _tex(nodes, inits, inputs, outputs, device="cpu"):
    data = tlite.write_onnx(_graph(tlite, nodes, inits, inputs, outputs))
    return TEx(tlite.read_onnx_graph(data), device)


def test_unsupported_op_raises_at_load():
    with pytest.raises(UnsupportedOnnxOp, match="NonMaxSuppression"):
        _tex([("NonMaxSuppression", ["x"], ["y"])], {},
             {"x": np.zeros(1, np.float32)}, ["y"])
    ex = _tex([("CumSum", ["x", "a"], ["y"], {"reverse": 1})],
              {"a": np.array(0, np.int64)}, {"x": np.zeros(3, np.float32)},
              ["y"])
    with pytest.raises(UnsupportedOnnxOp, match="CumSum"):
        ex.run({"x": np.zeros(3, np.float32)})


def test_device_value_used_as_a_shape_raises():
    """A Reshape target computed on the device (a fed tensor) needs a
    device-to-host copy; the executor refuses it instead."""
    ex = _tex([("Reshape", ["x", "s"], ["y"])], {},
              {"x": np.zeros(6, np.float32), "s": np.array([2, 3], np.int64)},
              ["y"])
    with pytest.raises(OnnxHostValueError, match="Reshape"):
        ex.run({"x": np.zeros(6, np.float32),
                "s": np.array([2, 3], np.int64)})


def test_large_initializers_sit_on_the_executors_device():
    w = _f(_rng(10), 64, 64)
    ex = _tex([("MatMul", ["x", "w"], ["y"])],
              {"w": w, "i": np.array([1], np.int64),
               "small": _f(_rng(1), 4, 4)},
              {"x": np.zeros((2, 64), np.float32)}, ["y"], device="meta")
    assert set(ex.params) == {"w"} and set(ex.consts) == {"i", "small"}
    assert ex.params["w"].device.type == "meta"
    assert isinstance(ex.consts["small"], np.ndarray)


def test_onnx_semantics_where_the_jax_executor_departs():
    """select_last_index, integer Div of negative operands, negative
    Gather indices and Resize's nearest_mode follow the ONNX definition
    (numpy below).  The JAX executor ignores select_last_index and
    nearest_mode, floors integer Div and clamps a negative index to 0."""
    x = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 1.0, 1.0]], np.float32)
    a = np.array([7, -7, 7, -7], np.int64)
    b = np.array([2, 2, -2, -2], np.int64)
    ex = _tex([("ArgMax", ["x"], ["last"], {"axis": 1,
                                            "select_last_index": 1}),
               ("ArgMin", ["x"], ["first"], {"axis": 1, "keepdims": 0}),
               ("Div", ["a", "b"], ["q"]),
               ("Gather", ["x", "neg"], ["g"], {"axis": 1})],
              {"neg": np.array([-1, 0], np.int64)},
              {"x": x, "a": a, "b": b}, ["last", "first", "q", "g"])
    out = ex.run({"x": x, "a": a, "b": b})
    np.testing.assert_array_equal(_np(out["last"]), [[2], [1]])
    np.testing.assert_array_equal(_np(out["first"]), [3, 2])
    np.testing.assert_array_equal(_np(out["q"]), [3, -3, -3, 3])
    np.testing.assert_array_equal(_np(out["g"]), x[:, [3, 0]])
    xs = _f(_rng(17), 1, 2, 6)
    for ct, nm, src in [
            ("half_pixel", "round_prefer_floor",
             lambda i: np.ceil((i + 0.5) / 1.5 - 0.5 - 0.5)),
            ("half_pixel", "floor", lambda i: np.floor((i + 0.5) / 1.5 - .5)),
            ("align_corners", "ceil", lambda i: np.ceil(i * 5 / 8)),
            ("asymmetric", "round_prefer_ceil",
             lambda i: np.floor(i / 1.5 + 0.5))]:
        ex = _tex([("Resize", ["x", "", "", "sz"], ["y"],
                    {"mode": "nearest", "coordinate_transformation_mode": ct,
                     "nearest_mode": nm})],
                  {"sz": np.array([1, 2, 9], np.int64)}, {"x": xs}, ["y"])
        idx = np.clip(src(np.arange(9.0)), 0, 5).astype(int)
        np.testing.assert_array_equal(_np(ex.run({"x": xs})["y"]),
                                      xs[:, :, idx], err_msg=f"{ct} {nm}")


def test_failing_node_names_the_graph_and_node():
    ex = _tex([("MatMul", ["x", "w"], ["y"])], {"w": _f(_rng(0), 3, 2)},
              {"x": np.zeros((2, 4), np.float32)}, ["y"])
    ex.source = "model/onnx/x.onnx"
    with pytest.raises(RuntimeError, match="model/onnx/x.onnx.*MatMul"):
        ex.run({"x": np.zeros((2, 4), np.float32)})


# ----------------------------------------------------------------- decoder
@pytest.fixture(scope="module")
def mini_pair():
    data, _ = tfx.build_decoder(tfx.MINI, seed=0)
    return (JDec(JEx(jlite.read_onnx_graph(data))),
            OnnxStreamingDecoder(TEx(tlite.read_onnx_graph(data), "cpu")))


def _codes(n, seed=1):
    return np.random.default_rng(seed).integers(0, 20, size=(n, tfx.NB))


def test_decoder_state_contract(mini_pair):
    jd, td = mini_pair
    assert td.state_names == jd.state_names
    js, ts = jd.create_state(), td.create_state()
    assert {k: tuple(v.shape) for k, v in ts.items()} == \
        {k: tuple(v.shape) for k, v in js.items()}
    assert ts["pre_conv_history"].shape == (1, tfx.DL, 0)
    assert ts["past_key_1"].shape == (1, tfx.H, 0, tfx.DH)


def test_decoder_full_decode_matches_reference_and_jax(mini_pair):
    jd, td = mini_pair
    codes = _codes(6)
    want, jst = jd.decode(codes, jd.create_state())
    got, tst = td.decode(codes, td.create_state())
    np.testing.assert_allclose(got, tfx.mini_decoder_reference(codes),
                               rtol=REF_RTOL, atol=REF_ATOL)
    _same(got, want)
    for k in jst:
        _same(tst[k], jst[k], what=k)
    assert tst["conv_history"].shape == (1, tfx.DC, tfx.K2 - 1)
    assert tst["past_value_0"].shape == (1, tfx.H, 6, tfx.DH)


@pytest.mark.parametrize("step", [1, 2, 3])
def test_decoder_chunked_equals_full(mini_pair, step):
    _, td = mini_pair
    codes = _codes(6, seed=2)
    full, _ = td.decode(codes, td.create_state(), is_final=True)
    st, parts = td.create_state(), []
    for lo in range(0, 6, step):
        wav, st = td.decode(codes[lo:lo + step], st, is_final=lo + step >= 6)
        assert wav.shape == (min(step, 6 - lo) * tfx.SPF,)
        parts.append(wav)
    np.testing.assert_allclose(np.concatenate(parts), full, rtol=LANE_TOL,
                               atol=LANE_TOL)


def test_decoder_truncates_and_clamps_codes(mini_pair):
    """35 flat codes: 2 frames; codes past the codebook clamp; fewer than
    16 codes give no audio; a tensor of codes decodes as its array."""
    jd, td = mini_pair
    flat = np.full(35, 99999, np.int64)
    got, _ = td.decode(flat, td.create_state())
    want, _ = jd.decode(flat, jd.create_state())
    assert got.shape == (2 * tfx.SPF,)
    _same(got, want)
    assert td.decode(np.zeros(15, np.int64), td.create_state())[0].shape \
        == (0,)
    codes = _codes(3, seed=3)
    a, _ = td.decode(codes, td.create_state())
    b, _ = td.decode(torch.from_numpy(codes).int(), td.create_state())
    np.testing.assert_array_equal(a, b)


def test_decoder_respects_valid_samples():
    """A graph whose valid_samples is smaller than its waveform: the
    decoder keeps that many samples, as the JAX decoder does."""
    data, _ = tfx.build_decoder(tfx.MINI)
    g = tlite.read_onnx_graph(data)
    g.nodes[-1] = tlite.OnnxNode("Shape", ["final_wav"], ["n_all"])
    g.nodes.append(tlite.OnnxNode("Sub", ["n_all", "three"],
                                  ["valid_samples"]))
    g.initializers["three"] = np.array([3], np.int64)
    data = tlite.write_onnx(g)
    jd = JDec(JEx(jlite.read_onnx_graph(data)))
    td = OnnxStreamingDecoder(TEx(tlite.read_onnx_graph(data), "cpu"))
    codes = _codes(3, seed=3)
    got, _ = td.decode(codes, td.create_state())
    want, _ = jd.decode(codes, jd.create_state())
    assert got.shape == (3 * tfx.SPF - 3,)
    _same(got, want)


def test_decode_batch_matches_sequential(mini_pair):
    """vmap over the batch-1 graph equals each lane decoded alone, chunk
    after chunk, and the JAX decode_batch."""
    jd, td = mini_pair
    b, n = 3, 2
    codes = np.random.default_rng(12).integers(0, 20, size=(b, 6, tfx.NB))
    seq = [td.create_state() for _ in range(b)]
    bat = [td.create_state() for _ in range(b)]
    jbat = [jd.create_state() for _ in range(b)]
    for lo in range(0, 6, n):
        fin = lo == 4
        wavs, bat = td.decode_batch(codes[:, lo:lo + n], bat, is_final=fin)
        jwavs, jbat = jd.decode_batch(codes[:, lo:lo + n], jbat,
                                      is_final=fin)
        for i in range(b):
            w, seq[i] = td.decode(codes[i, lo:lo + n], seq[i], is_final=fin)
            np.testing.assert_allclose(wavs[i], w, rtol=LANE_TOL,
                                       atol=LANE_TOL)
            _same(wavs[i], jwavs[i])
    for i in range(b):
        for k in seq[i]:
            np.testing.assert_allclose(_np(bat[i][k]), _np(seq[i][k]),
                                       rtol=LANE_TOL, atol=LANE_TOL)


def test_decode_batch_states_of_different_shapes_go_lane_by_lane(mini_pair):
    _, td = mini_pair
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 20, size=(2, 2, tfx.NB))
    s0 = td.decode(rng.integers(0, 20, size=(2, tfx.NB)),
                   td.create_state())[1]
    s1 = td.create_state()
    wavs, states = td.decode_batch(codes, [s0, s1])
    for i, s in enumerate((s0, s1)):
        w, st = td.decode(codes[i], s)
        np.testing.assert_array_equal(wavs[i], w)
        for k in st:
            np.testing.assert_array_equal(_np(states[i][k]), _np(st[k]))


def test_decode_batch_per_lane_finals(mini_pair):
    _, td = mini_pair
    codes = np.random.default_rng(14).integers(0, 20, size=(2, 3, tfx.NB))
    wavs, _ = td.decode_batch(codes, [td.create_state(), td.create_state()],
                              is_final=np.asarray([True, False]))
    for i, fin in enumerate([True, False]):
        w, _ = td.decode(codes[i], td.create_state(), is_final=fin)
        np.testing.assert_allclose(wavs[i], w, rtol=LANE_TOL, atol=LANE_TOL)


def test_decode_lanes_groups_lockstep_lanes(mini_pair, monkeypatch):
    """Lanes with equal frame counts and state shapes share one
    decode_batch; a lane out of step decodes alone; k = 0: no audio."""
    _, td = mini_pair
    calls = []
    real = OnnxStreamingDecoder.decode_batch

    def spy(self, codes, states, is_final=False):
        calls.append(len(states))
        return real(self, codes, states, is_final)

    monkeypatch.setattr(OnnxStreamingDecoder, "decode_batch", spy)
    codes = np.random.default_rng(15).integers(0, 20, size=(4, 3, tfx.NB))
    states = [td.create_state() for _ in range(4)]
    out = decode_lanes(td, codes, [3, 0, 3, 2], states,
                       [True, False, False, True])
    assert calls == [2] and out[1].shape == (0,)
    for i, (k, fin) in enumerate([(3, True), (3, False), (2, True)]):
        lane = [0, 2, 3][i]
        w, st = td.decode(codes[lane, :k], td.create_state(), is_final=fin)
        np.testing.assert_allclose(out[lane], w, rtol=LANE_TOL, atol=LANE_TOL)
        assert states[lane]["past_key_0"].shape == st["past_key_0"].shape


# ---------------------------------------------------------------- encoders
ENC = tfx.EncDims(hop=16, d=8)


def test_audio_encoder_graph_matches_jax_and_reference():
    data, _ = tfx.build_encoder(ENC, seed=2)
    jenc_ = JAE(JEx(jlite.read_onnx_graph(data)))
    tenc_ = OnnxAudioEncoder(TEx(tlite.read_onnx_graph(data), "cpu"))
    wav = _f(_rng(21), 16 * 11 + 5)
    got = tenc_.encode(wav)
    assert got.shape == (11, 16) and got.dtype == np.int64
    np.testing.assert_array_equal(got, tfx.encoder_reference(ENC, wav, 2))
    np.testing.assert_array_equal(got, jenc_.encode(wav).astype(np.int64))
    np.testing.assert_array_equal(tenc_.encode(torch.from_numpy(wav)), got)


def test_speaker_encoder_graph_matches_jax_and_reference():
    dims = tfx.SpkDims()
    data, _ = tfx.build_speaker(dims, seed=4)
    jspk_ = JSE(JEx(jlite.read_onnx_graph(data)))
    tspk_ = OnnxSpeakerEncoder(TEx(tlite.read_onnx_graph(data), "cpu"))
    mels = _f(_rng(22), 37, 128)
    got = tspk_.encode_mels(mels)
    assert got.shape == (2048,)
    np.testing.assert_allclose(got, jspk_.encode_mels(mels), atol=EMB_TOL)
    np.testing.assert_allclose(got, tfx.speaker_reference(dims, mels, 4),
                               atol=EMB_TOL)


@pytest.mark.parametrize("kind,data,match", [
    ("decoder", b"", "not the expected codec graph"),
    ("decoder", b"\x0b", "cannot read"),
    ("encoder", None, "missing input 'input_values'"),
])
def test_unreadable_or_wrong_graphs_raise_naming_the_file(tmp_path, kind,
                                                          data, match):
    path = tmp_path / f"{kind}.onnx"
    if data is None:         # a speaker graph where the encoder belongs
        tfx.build_speaker(path=path)
    else:
        path.write_bytes(data)
    runner = {"decoder": OnnxStreamingDecoder,
              "encoder": OnnxAudioEncoder}[kind]
    with pytest.raises(OnnxLoadError, match=match) as e:
        runner.load(path, "cpu")
    assert str(path) in str(e.value)


@pytest.mark.parametrize("runner", [
    TEx, TEx.load, OnnxStreamingDecoder.load, OnnxAudioEncoder.load,
    OnnxSpeakerEncoder.load], ids=["executor", "executor.load", "decoder",
                                   "audio_encoder", "speaker_encoder"])
def test_runners_default_to_the_card(runner):
    assert inspect.signature(runner).parameters["device"].default == "cuda"


def test_decoder_without_a_device_runs_on_the_card_or_raises(tmp_path):
    """No quiet fall-back to the CPU: a decoder loaded without a device is
    on the card, and where there is none its load raises."""
    path = tmp_path / "decoder.onnx"
    tfx.build_decoder(tfx.MINI, path=path)
    if torch.cuda.is_available():
        assert OnnxStreamingDecoder.load(path).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            OnnxStreamingDecoder.load(path)


# -------------------------------------------------------- import, convert
def _flat_eq(got, want):
    got, want = tconv.flatten_pytree(got), jconv.flatten_pytree(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32)
                                      if want[k].dtype.kind == "V"
                                      else want[k], err_msg=k)


@pytest.mark.parametrize("part", ["decoder", "encoder", "speaker"])
@pytest.mark.parametrize("size", ["tiny", "full"])
def test_param_spec_equals_jax(part, size):
    cfgs = {"decoder": (JDecCfg, TDecCfg, jdec.init_decoder_params,
                        tdec.init_decoder_params),
            "encoder": (JEncCfg, TEncCfg, jenc.init_encoder_params,
                        tenc.init_encoder_params),
            "speaker": (JSpkCfg, TSpkCfg, jspk.init_speaker_params,
                        tspk.init_speaker_params)}
    jc, tc, jinit, tinit = cfgs[part]
    jcfg, tcfg = (jc.tiny(), tc.tiny()) if size == "tiny" else (jc(), tc())
    want = jci.param_spec(jinit, jcfg)
    got = tci.param_spec(tinit, tcfg)
    assert {k: v[0] for k, v in got.items()} == \
        {k: v[0] for k, v in want.items()}


def _tiny_jax(part):
    key = jax.random.PRNGKey(0)
    if part == "decoder":
        cfg = JDecCfg.tiny()
        return cfg, TDecCfg.tiny(), jdec.init_decoder_params(cfg, key), \
            jci.decoder_name_map(cfg), tci.decoder_name_map(TDecCfg.tiny()), \
            jdec.init_decoder_params, tdec.init_decoder_params
    if part == "encoder":
        cfg = JEncCfg.tiny()
        return cfg, TEncCfg.tiny(), jenc.init_encoder_params(cfg, key), \
            jci.encoder_name_map(cfg), tci.encoder_name_map(TEncCfg.tiny()), \
            jenc.init_encoder_params, tenc.init_encoder_params
    cfg = JSpkCfg.tiny()
    return cfg, TSpkCfg.tiny(), jspk.init_speaker_params(cfg, key), \
        jci.speaker_name_map(cfg), tci.speaker_name_map(TSpkCfg.tiny()), \
        jspk.init_speaker_params, tspk.init_speaker_params


@pytest.mark.parametrize("part", ["decoder", "encoder", "speaker"])
def test_convert_codec_equals_jax(part):
    """The same torch-style initializers through both importers: equal
    flattened trees (the npz either package writes), and equal name
    maps."""
    jcfg, tcfg, params, jmap, tmap, jinit, tinit = _tiny_jax(part)
    assert tmap == jmap
    inits = _torch_export(jcfg, params, nm=jmap)
    want = jci.convert_codec(inits, jcfg, name_map=jmap, init_fn=jinit)
    got = tci.convert_codec(inits, tcfg, name_map=tmap, init_fn=tinit)
    _flat_eq(got, want)


@pytest.mark.parametrize("fault", ["missing", "shape", "nonfinite", "many",
                                   "unknown-entry"])
def test_convert_codec_reports_what_jax_reports(fault):
    jcfg, tcfg, params, jmap, tmap, jinit, tinit = _tiny_jax("decoder")
    inits = _torch_export(jcfg, params, nm=jmap)
    if fault == "missing":
        del inits["transformer.layers.1.self_attn.q_proj.weight"]
    elif fault == "shape":
        inits["pre_conv.weight"] = inits["pre_conv.weight"][:, :, :1]
    elif fault == "nonfinite":
        inits["out_conv.weight"] = inits["out_conv.weight"].copy()
        inits["out_conv.weight"][0, 0, 0] = np.nan
    elif fault == "many":
        del inits["transformer.norm.weight"]
        inits["pre_conv.bias"] = inits["pre_conv.bias"][:-1]
    else:
        jmap = dict(jmap, bogus=("x", None))
        tmap = dict(tmap, bogus=("x", None))
    with pytest.raises(jci.CodecImportError) as je:
        jci.convert_codec(inits, jcfg, name_map=jmap)
    with pytest.raises(tci.CodecImportError) as te:
        tci.convert_codec(inits, tcfg, name_map=tmap)
    assert str(te.value) == str(je.value)


def test_infer_name_map_and_geometry_equal_jax():
    jcfg, tcfg, params, jmap, _, jinit, tinit = _tiny_jax("decoder")
    inits = _torch_export(jcfg, params, nm=jmap)
    renamed = {f"onnx::Init_{i}": t for i, t in enumerate(inits.values())}
    want = jci.infer_name_map(renamed, jci.param_spec(jinit, jcfg))
    got = tci.infer_name_map(renamed, tci.param_spec(tinit, tcfg))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg2 = dataclasses.replace(JDecCfg.tiny(), upsample_kernel_mult=2)
    inits2 = _torch_export(cfg2, jdec.init_decoder_params(
        cfg2, jax.random.PRNGKey(3)))
    assert tci.infer_upsample_mult(inits2, tcfg) == \
        jci.infer_upsample_mult(inits2, jcfg) == 2
    bad = {"upsample_stages.0.up.weight": np.zeros((16, 16, 3), np.float32),
           "upsample_stages.1.up.weight": np.zeros((16, 8, 2), np.float32)}
    with pytest.raises(tci.CodecImportError, match="not a multiple"):
        tci.infer_upsample_mult(bad, tcfg)
    ecfg3 = dataclasses.replace(JEncCfg.tiny(), stage_kernel_mult=3)
    einits = _torch_export(ecfg3, jenc.init_encoder_params(
        ecfg3, jax.random.PRNGKey(4)), nm=jci.encoder_name_map(ecfg3))
    assert tci.infer_encoder_geometry(einits, TEncCfg.tiny()) \
        .stage_kernel_mult == jci.infer_encoder_geometry(
            einits, JEncCfg.tiny()).stage_kernel_mult == 3


@pytest.mark.parametrize("variant,n_mels,want", [
    ("attentive", None, "attentive"), ("attentive-opaque", None, "attentive"),
    ("xvector", None, "xvector"), ("attentive", "d", "attentive"),
    ("xvector", "d", "xvector")])
def test_infer_speaker_pooling(variant, n_mels, want):
    """The pooling family read from an export.  An x-vector export whose
    n_mels equals d has one square [d, d] tensor, its in-projection: the
    JAX importer counts it as the attentive score head (a fault, not
    copied); the port needs a second square matrix or an attention.*
    name."""
    jcfg = JSpkCfg.tiny()
    if n_mels == "d":
        jcfg = dataclasses.replace(jcfg, n_mels=jcfg.d_model)
    pooling = variant.split("-")[0]
    jcfg = dataclasses.replace(jcfg, pooling=pooling)
    params = jspk.init_speaker_params(jcfg, jax.random.PRNGKey(6))
    inits = _torch_export(jcfg, params, nm=jci.speaker_name_map(jcfg))
    if variant.endswith("opaque"):
        inits = {f"onnx::MatMul_{i}": t for i, t in enumerate(inits.values())}
    tcfg = TSpkCfg(**{f.name: getattr(jcfg, f.name)
                      for f in dataclasses.fields(jcfg)})
    base = dataclasses.replace(tcfg, pooling="attentive" if want == "xvector"
                               else "xvector")
    assert tci.infer_speaker_pooling(inits, base).pooling == want
    jgot = jci.infer_speaker_pooling(inits, dataclasses.replace(
        jcfg, pooling=base.pooling)).pooling
    if variant == "xvector" and n_mels == "d":
        assert jgot == "attentive"          # the JAX importer's fault
    else:
        assert jgot == want


def test_validate_decoder_against_onnx():
    """The port's native decoder against a decoder object: passes on the
    same weights, raises on others."""
    cfg = TDecCfg.tiny()
    params = tdec.init_decoder_params(cfg, torch.Generator().manual_seed(0))
    other = tdec.init_decoder_params(cfg, torch.Generator().manual_seed(9))

    class Graph:
        device = torch.device("cpu")

        def __init__(self, p):
            self.p = p

        def create_state(self):
            return tdec.init_decoder_state(cfg, 1, "cpu")

        def decode(self, codes, state, is_final=False):
            wav, _ = tdec.decode_chunk(cfg, self.p, torch.from_numpy(
                np.asarray(codes)[None]), state)
            return wav[0].numpy(), state

    with torch.no_grad():
        stats = tci.validate_decoder_against_onnx(
            cfg, params, Graph(params),
            n_frames=4)
        assert stats["max_abs_err"] < 1e-6
        with pytest.raises(tci.CodecImportError, match="reproduce"):
            tci.validate_decoder_against_onnx(cfg, params, Graph(other),
                                              n_frames=4)


def test_convert_tools_equal_jax(tmp_path):
    """flatten / save / load round trip, onnx_to_npz and the CLI's
    --list and --summary output, against the JAX package's."""
    cfg = TDecCfg.tiny()
    params = tdec.init_decoder_params(cfg, torch.Generator().manual_seed(1))
    tconv.save_params_npz(tmp_path / "p.npz", params)
    back = tconv.load_params_npz(tmp_path / "p.npz")
    for k, v in tconv.flatten_pytree(params).items():
        np.testing.assert_array_equal(tconv.flatten_pytree(back)[k], v)
    jtree = jconv.load_params_npz(tmp_path / "p.npz")
    assert tconv.flatten_pytree(jtree).keys() == \
        tconv.flatten_pytree(back).keys()
    onnx = tmp_path / "dec.onnx"
    tfx.build_decoder(tfx.MINI, path=onnx)
    outs = []
    for mod in (jconv, tconv):
        for args in ([str(onnx), "--list"], [str(onnx), "--summary"],
                     [str(onnx), str(tmp_path / f"{mod.__name__}.npz")]):
            buf = io.StringIO()
            with redirect_stdout(buf):
                assert mod.main(args) == 0
            outs.append(buf.getvalue().replace(mod.__name__, "<mod>"))
    assert outs[:3] == outs[3:]
    with np.load(tmp_path / f"{jconv.__name__}.npz") as a, \
            np.load(tmp_path / f"{tconv.__name__}.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    sd = {"w": torch.ones(2, 3), "b": torch.zeros(3)}
    flat = tconv.convert_torch_codec(sd, {"w": "x/w", "b": "x/b"})
    want = jconv.convert_torch_codec(sd, {"w": "x/w", "b": "x/b"})
    assert flat.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])

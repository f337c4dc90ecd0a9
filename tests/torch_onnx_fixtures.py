"""ONNX fixture graphs for the PyTorch port, importing only numpy and
qwen3_tts_tpu_torch.io.onnx_lite: a copy of tests/fixtures_onnx.py's
decoder writer (which imports the JAX package) that chip_smoke.py can
import where JAX is absent, plus contract graphs of the two cloning
encoders.

The streaming codec decoder replicates the reference decoder's state
contract at parameterized dimensions:
  inputs   audio_codes [1,N,16] i64, is_last [1] f32,
           pre_conv_history [1,DL,t], latent_buffer [1,DA,t],
           conv_history [1,DC,t], past_key_i/past_value_i [1,H,t,dh]
  outputs  final_wav, valid_samples, next_pre_conv_history,
           next_latent_buffer, next_conv_history, next_key_i/next_value_i
Dataflow: code embedding (Gather+ReduceSum over 16 books) -> causal conv
(carried history) -> causal self-attention layers (carried KV) -> two more
causal convs (carried histories) -> ConvTranspose upsampler chain
(kernel==stride).  Every stage is strictly causal, so chunked decoding
equals full-sequence decoding.  MINI is a toy size; FULL the real graph's
declared contract (512-ch pre-conv history, 1024-d latents, 8 layers x 16
heads x d_head 64, 2000 samples a frame from a 5-stage upsampler).
`decoder_reference(dims, codes)` is an independent numpy implementation.

The audio-encoder contract graph (`build_encoder`): input_values [1, T]
f32 -> audio_codes [1, N, 16] i64, N = T // hop: the samples framed at
`hop`, projected to `d` dims, then 16 residual-VQ stages of `codebook`
codes, each chosen by ArgMin of the squared distance.  The speaker-encoder
contract graph (`build_speaker`): mels [1, F, n_mels] -> spk_emb [1, emb]
by ReduceMean over the frames, MatMul and LpNormalization.  Both have
numpy references (`encoder_reference`, `speaker_reference`).
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from qwen3_tts_tpu_torch.io.onnx_lite import (OnnxGraph, OnnxNode,
                                              TensorInfo, write_onnx)


@dataclass(frozen=True)
class Dims:
    DL: int            # embed / pre-conv input channels
    DA: int            # attention dim (H * DH)
    DC: int            # post-attention conv channels
    H: int
    DH: int
    K0: int            # pre-conv kernel
    K1: int            # mid-conv kernel
    K2: int            # post-conv kernel
    NB: int = 16       # codebooks per frame
    VOCAB: int = 32
    LAYERS: int = 2
    up_factors: Tuple[int, ...] = (5,)
    up_channels: Tuple[int, ...] = ()   # len(up_factors)+1, ends in 1

    @property
    def spf(self) -> int:
        out = 1
        for f in self.up_factors:
            out *= f
        return out

    def channels(self) -> Tuple[int, ...]:
        if self.up_channels:
            assert len(self.up_channels) == len(self.up_factors) + 1
            assert self.up_channels[0] == self.DC
            return self.up_channels
        return (self.DC, 1)


# toy dims (the original mini fixture)
MINI = Dims(DL=8, DA=8, DC=6, H=2, DH=4, K0=3, K1=3, K2=2, VOCAB=32,
            LAYERS=2, up_factors=(5,), up_channels=(6, 1))
# the real decoder's declared contract at production size
FULL = Dims(DL=512, DA=1024, DC=1024, H=16, DH=64, K0=7, K1=7, K2=7,
            VOCAB=2048, LAYERS=8, up_factors=(5, 5, 4, 4, 5),
            up_channels=(1024, 512, 256, 128, 64, 1))

# backwards-compatible module constants (op-level tests import these)
DL, DA, DC = MINI.DL, MINI.DA, MINI.DC
H, DH = MINI.H, MINI.DH
K0, K1, K2 = MINI.K0, MINI.K1, MINI.K2
SPF = MINI.spf
NB = MINI.NB
VOCAB = MINI.VOCAB
LAYERS = MINI.LAYERS


def _weights(dims: Dims, seed=0):
    rng = np.random.default_rng(seed)
    d = dims
    w = {
        "table": rng.standard_normal((d.VOCAB, d.DL)).astype(np.float32) * 0.3,
        "w0": rng.standard_normal((d.DA, d.DL, d.K0)).astype(np.float32)
        * (0.3 / np.sqrt(d.DL * d.K0) if d.DL > 16 else 0.3),
        "w1": rng.standard_normal((d.DC, d.DA, d.K1)).astype(np.float32)
        * (0.3 / np.sqrt(d.DA * d.K1) if d.DA > 16 else 0.3),
        "w2": rng.standard_normal((d.DC, d.DC, d.K2)).astype(np.float32)
        * (0.3 / np.sqrt(d.DC * d.K2) if d.DC > 16 else 0.3),
    }
    chans = d.channels()
    for i, r in enumerate(d.up_factors):
        c_in, c_out = chans[i], chans[i + 1]
        # ONNX ConvTranspose weight layout: [C_in, C_out, K]
        w[f"wup{i}"] = rng.standard_normal((c_in, c_out, r)).astype(
            np.float32) * (0.3 / np.sqrt(c_in) if c_in > 16 else 0.3)
    for l in range(d.LAYERS):
        for nm in ("wq", "wk", "wv", "wo"):
            w[f"{nm}{l}"] = rng.standard_normal((d.DA, d.DA)).astype(
                np.float32) * (0.3 / np.sqrt(d.DA))
    return w


def _causal_conv_nodes(dims, nodes, inits, x, hist, w_name, out, tag):
    """cat = concat(hist, x); padded = pad-left(K-1); take last K-1+N;
    conv VALID; next_hist = last K-1 of cat.  All shape math via Shape ops
    so the executor's host folding is exercised."""
    K = {"w0": dims.K0, "w1": dims.K1, "w2": dims.K2}[w_name]
    imax = np.iinfo(np.int64).max
    inits[f"pads_{tag}"] = np.array([0, 0, K - 1, 0, 0, 0], np.int64)
    inits[f"histstart_{tag}"] = np.array([-(K - 1)], np.int64)
    inits[f"imax_{tag}"] = np.array([imax], np.int64)
    inits[f"ax2_{tag}"] = np.array([2], np.int64)
    inits[f"i2_{tag}"] = np.array(2, np.int64)
    inits[f"km1_{tag}"] = np.array([K - 1], np.int64)
    nodes += [
        OnnxNode("Concat", [hist, x], [f"cat_{tag}"], attrs={"axis": 2}),
        OnnxNode("Pad", [f"cat_{tag}", f"pads_{tag}"], [f"padded_{tag}"],
                 attrs={"mode": "constant"}),
        # window = last (K-1+N) of padded, N read off Shape(x)
        OnnxNode("Shape", [x], [f"xs_{tag}"]),
        OnnxNode("Gather", [f"xs_{tag}", f"i2_{tag}"], [f"n_{tag}"],
                 attrs={"axis": 0}),
        OnnxNode("Unsqueeze", [f"n_{tag}", "zero_ax"], [f"n1_{tag}"]),
        OnnxNode("Add", [f"n1_{tag}", f"km1_{tag}"], [f"wlen_{tag}"]),
        OnnxNode("Neg", [f"wlen_{tag}"], [f"wstart_{tag}"]),
        OnnxNode("Slice", [f"padded_{tag}", f"wstart_{tag}", f"imax_{tag}",
                           f"ax2_{tag}"], [f"win_{tag}"]),
        OnnxNode("Conv", [f"win_{tag}", w_name], [out],
                 attrs={"kernel_shape": [K]}),
        OnnxNode("Slice", [f"cat_{tag}", f"histstart_{tag}", f"imax_{tag}",
                           f"ax2_{tag}"], [f"next_hist_{tag}"]),
    ]
    return f"next_hist_{tag}"


def _attn_nodes(dims, nodes, inits, x, layer):
    """Causal self-attention with carried KV (x: [1,N,DA])."""
    d = dims
    l = layer
    inits[f"hshape_{l}"] = np.array([1, -1, d.H, d.DH], np.int64)
    inits[f"fshape_{l}"] = np.array([1, -1, d.DA], np.int64)
    inits["scale"] = np.array(1.0 / np.sqrt(d.DH), np.float32)
    inits["neg_big"] = np.array(-1e9, np.float32)
    inits[f"i2a_{l}"] = np.array(2, np.int64)
    nodes += [
        OnnxNode("MatMul", [x, f"wq{l}"], [f"q_{l}"]),
        OnnxNode("MatMul", [x, f"wk{l}"], [f"k_{l}"]),
        OnnxNode("MatMul", [x, f"wv{l}"], [f"v_{l}"]),
        OnnxNode("Reshape", [f"q_{l}", f"hshape_{l}"], [f"q4_{l}"]),
        OnnxNode("Reshape", [f"k_{l}", f"hshape_{l}"], [f"k4_{l}"]),
        OnnxNode("Reshape", [f"v_{l}", f"hshape_{l}"], [f"v4_{l}"]),
        OnnxNode("Transpose", [f"q4_{l}"], [f"qt_{l}"],
                 attrs={"perm": [0, 2, 1, 3]}),
        OnnxNode("Transpose", [f"k4_{l}"], [f"kt_{l}"],
                 attrs={"perm": [0, 2, 1, 3]}),
        OnnxNode("Transpose", [f"v4_{l}"], [f"vt_{l}"],
                 attrs={"perm": [0, 2, 1, 3]}),
        OnnxNode("Concat", [f"past_key_{l}", f"kt_{l}"], [f"next_key_{l}"],
                 attrs={"axis": 2}),
        OnnxNode("Concat", [f"past_value_{l}", f"vt_{l}"],
                 [f"next_value_{l}"], attrs={"axis": 2}),
        OnnxNode("Transpose", [f"next_key_{l}"], [f"ktt_{l}"],
                 attrs={"perm": [0, 1, 3, 2]}),
        OnnxNode("MatMul", [f"qt_{l}", f"ktt_{l}"], [f"sc_{l}"]),
        OnnxNode("Mul", [f"sc_{l}", "scale"], [f"scs_{l}"]),
        # causal mask: key_pos <= t_past + query_pos  (all host-folded)
        OnnxNode("Shape", [f"next_key_{l}"], [f"nks_{l}"]),
        OnnxNode("Gather", [f"nks_{l}", f"i2a_{l}"], [f"t2_{l}"],
                 attrs={"axis": 0}),
        OnnxNode("Shape", [x], [f"xs_a{l}"]),
        OnnxNode("Gather", [f"xs_a{l}", "one_s"], [f"n_a{l}"],
                 attrs={"axis": 0}),
        OnnxNode("Sub", [f"t2_{l}", f"n_a{l}"], [f"tpast_{l}"]),
        OnnxNode("Range", ["zero_s", f"t2_{l}", "one_s"], [f"kpos_{l}"]),
        OnnxNode("Range", ["zero_s", f"n_a{l}", "one_s"], [f"qpos0_{l}"]),
        OnnxNode("Add", [f"qpos0_{l}", f"tpast_{l}"], [f"qpos_{l}"]),
        OnnxNode("Unsqueeze", [f"qpos_{l}", "one_ax"], [f"qpe_{l}"]),
        OnnxNode("Unsqueeze", [f"kpos_{l}", "zero_ax"], [f"kpe_{l}"]),
        OnnxNode("LessOrEqual", [f"kpe_{l}", f"qpe_{l}"], [f"mask_{l}"]),
        OnnxNode("Where", [f"mask_{l}", f"scs_{l}", "neg_big"],
                 [f"scm_{l}"]),
        OnnxNode("Softmax", [f"scm_{l}"], [f"pr_{l}"], attrs={"axis": -1}),
        OnnxNode("MatMul", [f"pr_{l}", f"next_value_{l}"], [f"ctx_{l}"]),
        OnnxNode("Transpose", [f"ctx_{l}"], [f"ctxt_{l}"],
                 attrs={"perm": [0, 2, 1, 3]}),
        OnnxNode("Reshape", [f"ctxt_{l}", f"fshape_{l}"], [f"ctxf_{l}"]),
        OnnxNode("MatMul", [f"ctxf_{l}", f"wo{l}"], [f"attno_{l}"]),
        OnnxNode("Add", [x, f"attno_{l}"], [f"y_{l}"]),
    ]
    return f"y_{l}"


def build_decoder(dims: Dims, seed=0, path=None):
    """Serialize a contract-faithful decoder at `dims`; returns
    (onnx_bytes, weights)."""
    d = dims
    w = _weights(d, seed)
    nodes = []
    inits = dict(w)
    inits["zero_ax"] = np.array([0], np.int64)
    inits["one_ax"] = np.array([1], np.int64)
    inits["zero_s"] = np.array(0, np.int64)
    inits["one_s"] = np.array(1, np.int64)

    # 1. embed: Gather over the summed 16 codebooks
    nodes += [
        OnnxNode("Gather", ["table", "audio_codes"], ["emb4"],
                 attrs={"axis": 0}),                      # [1,N,16,DL]
        OnnxNode("ReduceSum", ["emb4"], ["emb"],
                 attrs={"axes": [2], "keepdims": 0}),     # [1,N,DL]
        OnnxNode("Transpose", ["emb"], ["lat"],
                 attrs={"perm": [0, 2, 1]}),              # [1,DL,N]
    ]
    # 2. pre conv (carried pre_conv_history)
    nh0 = _causal_conv_nodes(d, nodes, inits, "lat", "pre_conv_history",
                             "w0", "a0", "pre")
    nodes += [OnnxNode("Identity", [nh0], ["next_pre_conv_history"]),
              OnnxNode("Transpose", ["a0"], ["x_attn"],
                       attrs={"perm": [0, 2, 1]})]        # [1,N,DA]
    # 3. attention layers (carried KV)
    y = "x_attn"
    for l in range(d.LAYERS):
        y = _attn_nodes(d, nodes, inits, y, l)
    nodes += [OnnxNode("Transpose", [y], ["lat2"],
                       attrs={"perm": [0, 2, 1]})]        # [1,DA,N]
    # 4. mid conv (carried latent_buffer)
    nh1 = _causal_conv_nodes(d, nodes, inits, "lat2", "latent_buffer",
                             "w1", "b1", "mid")
    nodes += [OnnxNode("Identity", [nh1], ["next_latent_buffer"])]
    # 5. post conv + tanh (carried conv_history)
    nh2 = _causal_conv_nodes(d, nodes, inits, "b1", "conv_history",
                             "w2", "b2r", "post")
    nodes += [OnnxNode("Identity", [nh2], ["next_conv_history"]),
              OnnxNode("Tanh", ["b2r"], ["b2"])]
    # 6. upsampler chain (kernel == stride per stage) + flatten
    cur = "b2"
    for i, r in enumerate(d.up_factors):
        nodes += [OnnxNode("ConvTranspose", [cur, f"wup{i}"], [f"up{i}"],
                           attrs={"strides": [r], "kernel_shape": [r]})]
        cur = f"up{i}"
    nodes += [
        OnnxNode("Reshape", [cur, "flatshape"], ["final_wav"]),
        OnnxNode("Shape", ["final_wav"], ["valid_samples"]),
    ]
    inits["flatshape"] = np.array([-1], np.int64)

    inputs = [
        TensorInfo("audio_codes", np.int64, (1, "N", d.NB)),
        TensorInfo("is_last", np.float32, (1,)),
        TensorInfo("pre_conv_history", np.float32, (1, d.DL, "t0")),
        TensorInfo("latent_buffer", np.float32, (1, d.DA, "t1")),
        TensorInfo("conv_history", np.float32, (1, d.DC, "t2")),
    ]
    outputs = [
        TensorInfo("final_wav", np.float32, ("S",)),
        TensorInfo("valid_samples", np.int64, (1,)),
        TensorInfo("next_pre_conv_history", np.float32, (1, d.DL, "u0")),
        TensorInfo("next_latent_buffer", np.float32, (1, d.DA, "u1")),
        TensorInfo("next_conv_history", np.float32, (1, d.DC, "u2")),
    ]
    for l in range(d.LAYERS):
        inputs += [TensorInfo(f"past_key_{l}", np.float32,
                              (1, d.H, "p", d.DH)),
                   TensorInfo(f"past_value_{l}", np.float32,
                              (1, d.H, "p", d.DH))]
        outputs += [TensorInfo(f"next_key_{l}", np.float32,
                               (1, d.H, "q", d.DH)),
                    TensorInfo(f"next_value_{l}", np.float32,
                               (1, d.H, "q", d.DH))]

    g = OnnxGraph(nodes=nodes, initializers=inits, inputs=inputs,
                  outputs=outputs, opset=17, name="codec_decoder_fixture")
    return write_onnx(g, path), w


def decoder_reference(dims: Dims, codes: np.ndarray, seed=0) -> np.ndarray:
    """Independent numpy ground truth: full-sequence, causal."""
    d = dims
    w = _weights(d, seed)
    codes = np.asarray(codes, np.int64).reshape(-1, d.NB)
    codes = np.clip(codes, 0, d.VOCAB - 1)
    n = codes.shape[0]
    emb = w["table"][codes].sum(1)                         # [N, DL]

    def causal_conv(x, k):                                 # x [T,Cin]
        K = k.shape[2]
        xp = np.concatenate([np.zeros((K - 1, x.shape[1]), x.dtype), x], 0)
        out = np.zeros((x.shape[0], k.shape[0]), np.float32)
        for t in range(x.shape[0]):
            win = xp[t: t + K]                             # [K, Cin]
            out[t] = np.einsum("kc,ock->o", win, k)
        return out

    a0 = causal_conv(emb, w["w0"])                         # [N, DA]
    y = a0
    for l in range(d.LAYERS):
        q = (y @ w[f"wq{l}"]).reshape(n, d.H, d.DH).transpose(1, 0, 2)
        k = (y @ w[f"wk{l}"]).reshape(n, d.H, d.DH).transpose(1, 0, 2)
        v = (y @ w[f"wv{l}"]).reshape(n, d.H, d.DH).transpose(1, 0, 2)
        sc = q @ k.transpose(0, 2, 1) / np.sqrt(d.DH)      # [H,N,N]
        mask = np.tril(np.ones((n, n), bool))
        sc = np.where(mask, sc, -1e9)
        pr = np.exp(sc - sc.max(-1, keepdims=True))
        pr = pr / pr.sum(-1, keepdims=True)
        ctx = (pr @ v).transpose(1, 0, 2).reshape(n, d.DA)
        y = y + ctx @ w[f"wo{l}"]
    b1 = causal_conv(y, w["w1"])                           # [N, DC]
    b2 = np.tanh(causal_conv(b1, w["w2"]))                 # [N, DC]
    # conv-transpose chain, kernel==stride: x [T, C] -> [T*r, C_out]
    x = b2
    for i, r in enumerate(d.up_factors):
        wi = w[f"wup{i}"]                                  # [Cin, Cout, r]
        y_up = np.einsum("tc,cor->tro", x, wi)             # [T, r, Cout]
        x = y_up.reshape(-1, wi.shape[1])
    return x.reshape(-1).astype(np.float32)


# ---- backwards-compatible toy wrappers (original fixture API) ----
def build_mini_decoder(seed=0, path=None):
    """Serialize the mini decoder; returns (onnx_bytes, weights)."""
    return build_decoder(MINI, seed=seed, path=path)


def mini_decoder_reference(codes: np.ndarray, seed=0) -> np.ndarray:
    return decoder_reference(MINI, codes, seed=seed)


# ---------------------------------------------------------------- encoders
@dataclass(frozen=True)
class EncDims:
    hop: int = 2000          # samples a codec frame (the engine's hop)
    d: int = 64              # latent dims
    NB: int = 16             # residual-VQ stages
    codebook: int = 2048     # codes a stage


def _encoder_weights(dims: EncDims, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "proj": rng.standard_normal((dims.hop, dims.d)).astype(np.float32)
        * (1.0 / np.sqrt(dims.hop)),
        "books": rng.standard_normal((dims.NB, dims.codebook, dims.d))
        .astype(np.float32) * 0.5,
    }


def build_encoder(dims: EncDims = EncDims(), seed=0, path=None):
    """Serialize the audio-encoder contract graph; returns (bytes,
    weights)."""
    w = _encoder_weights(dims, seed)
    inits = {
        "proj": w["proj"],
        "i1": np.array(1, np.int64),
        "hop": np.array(dims.hop, np.int64),
        "zero": np.array([0], np.int64),
        "ax1": np.array([1], np.int64),
        "frame_shape": np.array([1, -1, dims.hop], np.int64),
        "two": np.array(2.0, np.float32),
    }
    nodes = [
        # N = T // hop from Shape (host folding), the samples cut to N * hop
        OnnxNode("Shape", ["input_values"], ["ts"]),
        OnnxNode("Gather", ["ts", "i1"], ["t"], attrs={"axis": 0}),
        OnnxNode("Div", ["t", "hop"], ["n"]),
        OnnxNode("Mul", ["n", "hop"], ["nt"]),
        OnnxNode("Unsqueeze", ["nt", "zero"], ["nt1"]),
        OnnxNode("Slice", ["input_values", "zero", "nt1", "ax1"], ["cut"]),
        OnnxNode("Reshape", ["cut", "frame_shape"], ["frames"]),
        OnnxNode("MatMul", ["frames", "proj"], ["z0"]),     # [1, N, d]
    ]
    z, picks = "z0", []
    for q in range(dims.NB):
        book = w["books"][q]
        inits[f"book{q}"] = book
        inits[f"bookT{q}"] = np.ascontiguousarray(book.T)
        inits[f"bsq{q}"] = (book * book).sum(1).astype(np.float32)
        nodes += [
            OnnxNode("Mul", [z, z], [f"zz{q}"]),
            OnnxNode("ReduceSum", [f"zz{q}"], [f"zsq{q}"],
                     attrs={"axes": [-1], "keepdims": 1}),
            OnnxNode("MatMul", [z, f"bookT{q}"], [f"zb{q}"]),
            OnnxNode("Mul", [f"zb{q}", "two"], [f"zb2{q}"]),
            OnnxNode("Sub", [f"zsq{q}", f"zb2{q}"], [f"d0{q}"]),
            OnnxNode("Add", [f"d0{q}", f"bsq{q}"], [f"dist{q}"]),
            OnnxNode("ArgMin", [f"dist{q}"], [f"idx{q}"],
                     attrs={"axis": -1, "keepdims": 0}),    # [1, N]
            OnnxNode("Gather", [f"book{q}", f"idx{q}"], [f"sel{q}"],
                     attrs={"axis": 0}),                    # [1, N, d]
            OnnxNode("Sub", [z, f"sel{q}"], [f"z{q + 1}"]),
            OnnxNode("Unsqueeze", [f"idx{q}", "m1"], [f"code{q}"]),
        ]
        z = f"z{q + 1}"
        picks.append(f"code{q}")
    inits["m1"] = np.array([-1], np.int64)
    nodes.append(OnnxNode("Concat", picks, ["audio_codes"],
                          attrs={"axis": -1}))
    g = OnnxGraph(
        nodes=nodes, initializers=inits,
        inputs=[TensorInfo("input_values", np.float32, (1, "T"))],
        outputs=[TensorInfo("audio_codes", np.int64, (1, "N", dims.NB))],
        opset=17, name="codec_encoder_fixture")
    return write_onnx(g, path), w


def encoder_reference(dims: EncDims, wav, seed=0) -> np.ndarray:
    """Independent numpy ground truth: codes int64 [N, 16]."""
    w = _encoder_weights(dims, seed)
    wav = np.asarray(wav, np.float32).reshape(-1)
    n = len(wav) // dims.hop
    z = wav[: n * dims.hop].reshape(n, dims.hop) @ w["proj"]
    codes = np.zeros((n, dims.NB), np.int64)
    for q in range(dims.NB):
        book = w["books"][q]
        dist = ((z * z).sum(-1, keepdims=True) - 2.0 * (z @ book.T)
                + (book * book).sum(1))
        codes[:, q] = dist.argmin(-1)
        z = z - book[codes[:, q]]
    return codes


@dataclass(frozen=True)
class SpkDims:
    n_mels: int = 128
    emb: int = 2048


def _speaker_weights(dims: SpkDims, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((dims.n_mels, dims.emb)).astype(
        np.float32) * (1.0 / np.sqrt(dims.n_mels))}


def build_speaker(dims: SpkDims = SpkDims(), seed=0, path=None):
    """Serialize the speaker-encoder contract graph; returns (bytes,
    weights)."""
    w = _speaker_weights(dims, seed)
    nodes = [
        OnnxNode("ReduceMean", ["mels"], ["pooled"],
                 attrs={"axes": [1], "keepdims": 0}),       # [1, n_mels]
        OnnxNode("MatMul", ["pooled", "w"], ["emb"]),        # [1, emb]
        OnnxNode("LpNormalization", ["emb"], ["spk_emb"],
                 attrs={"axis": -1, "p": 2}),
    ]
    g = OnnxGraph(
        nodes=nodes, initializers=dict(w),
        inputs=[TensorInfo("mels", np.float32, (1, "F", dims.n_mels))],
        outputs=[TensorInfo("spk_emb", np.float32, (1, dims.emb))],
        opset=17, name="speaker_encoder_fixture")
    return write_onnx(g, path), w


def speaker_reference(dims: SpkDims, mels, seed=0) -> np.ndarray:
    """Independent numpy ground truth: f32 [emb]."""
    w = _speaker_weights(dims, seed)
    mels = np.asarray(mels, np.float32).reshape(-1, dims.n_mels)
    emb = mels.mean(0) @ w["w"]
    return (emb / max(float(np.sqrt((emb * emb).sum())), 1e-12)).astype(
        np.float32)

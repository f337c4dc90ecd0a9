"""Offline weight conversion.  Counterpart of qwen3_tts_tpu/io/convert.py.

1. `convert_checkpoint`: GGUF (any supported quant) -> one .npz of
   dequantized tensors.
2. `flatten_pytree` / `unflatten` / `save_params_npz` / `load_params_npz`:
   a nested dict / list of arrays or tensors <-> a flat npz with 'a/b/0/c'
   path keys (the format TtsEngine reads from model_dir/codec/*.npz).
3. `onnx_to_npz`: an ONNX model's initializers -> npz, with a listing
   (io.onnx_lite; no onnx package needed); `--summary` prints the graph's
   ops, inputs and outputs (io.onnx_exec.summarize).
4. `convert_torch_codec`: a PyTorch state_dict mapped by an explicit
   old -> new name table.

    python -m qwen3_tts_tpu_torch.io.convert model.onnx --list
    python -m qwen3_tts_tpu_torch.io.convert model.onnx --summary
    python -m qwen3_tts_tpu_torch.io.convert model.gguf out.npz
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch


def _to_numpy(v) -> np.ndarray:
    """An array or tensor as numpy (bfloat16, which numpy lacks, as
    float32)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()
    return np.asarray(v)


def flatten_pytree(tree, prefix="") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_pytree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(flatten_pytree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = _to_numpy(tree)
    return out


def unflatten(flat: Dict[str, object]):
    """{'a/b/0/c': leaf} -> nested dicts, with lists where every key of a
    level is a digit (the JAX engine's `_unflatten_npz`)."""
    tree: Dict = {}
    for key, leaf in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(tree)


def save_params_npz(path, params) -> None:
    np.savez(path, **flatten_pytree(params))


def load_params_npz(path, device="cpu", dtype=None):
    """A nested dict / list of tensors on `device` from an npz whose keys
    are 'a/b/0/c' paths (save_params_npz, unflatten); floating arrays in
    `dtype` when given (the codec decoder holds every parameter in its
    config's dtype)."""
    flat = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            t = torch.from_numpy(np.array(data[key])).to(device)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            flat[key] = t
    return unflatten(flat)


def convert_checkpoint(gguf_path, out_path, dtype=np.float32) -> None:
    """Dequantize every tensor of a GGUF file into one npz."""
    from .gguf import read_gguf
    g = read_gguf(gguf_path)
    tensors = {name: g.read_tensor(name).astype(dtype) for name in g.names()}
    np.savez(out_path, **tensors)


def onnx_to_npz(onnx_path, out_path, list_only: bool = False):
    """Dump an ONNX model's initializers to npz and print a shape listing:
    the first step of importing a codec graph's weights (io.codec_import)."""
    from .onnx_lite import read_onnx_initializers
    tensors = read_onnx_initializers(onnx_path)
    for name in sorted(tensors):
        print(f"{name}\t{tensors[name].dtype}\t{tensors[name].shape}")
    print(f"# {len(tensors)} initializers")
    if not list_only:
        np.savez(out_path, **tensors)
        print(f"wrote {out_path}")
    return tensors


def convert_torch_codec(state_dict, name_map: Dict[str, str]):
    """Map a torch state_dict into a flat {new name: numpy} by an explicit
    old -> new table; the caller reshapes or transposes per entry."""
    return {new: _to_numpy(state_dict[old]) for old, new in name_map.items()}


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="qwen3_tts_tpu_torch.io.convert")
    p.add_argument("src", type=Path, help=".gguf or .onnx input")
    p.add_argument("out", type=Path, nargs="?", default=Path("out.npz"))
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float16"])
    p.add_argument("--list", action="store_true",
                   help="only list tensors (onnx input)")
    p.add_argument("--summary", action="store_true",
                   help="print graph summary: ops, inputs, outputs (onnx)")
    args = p.parse_args(argv)
    if args.summary and args.src.suffix == ".onnx":
        from .onnx_exec import summarize
        print(summarize(args.src))
        return 0
    if args.src.suffix == ".onnx":
        onnx_to_npz(args.src, args.out, list_only=args.list)
    else:
        convert_checkpoint(args.src, args.out, np.dtype(args.dtype))
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Turn the JAX package's parameter trees into the port's tensors.

The inputs are nested dicts (and tuples/lists) of numpy arrays, e.g.
`jax.tree_util.tree_map(np.asarray, params)`; this module itself never
imports jax.  Layouts are the same in both packages, so the conversion is
one tensor per array, dtype kept (bfloat16 numpy arrays go through f32,
which is exact).  Tests use it to run both packages on the same weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .assets import Assets


def to_tensor(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                          torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)    # copy: writable


def tree_to_torch(tree, device="cpu"):
    """Nested dict / tuple / list of arrays -> same nesting of tensors
    (tuples become lists)."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [tree_to_torch(v, device) for v in tree]
    return to_tensor(tree, device)


def assets_from_arrays(a: Dict[str, Any], device="cpu") -> Assets:
    """Assets from the JAX Assets' arrays: a dict with text_table,
    codec_tables, codec_tables_1024, proj_w, proj_b, tts_pad (taken as
    they are, not recomputed)."""
    t = {k: to_tensor(a[k], device)
         for k in ("text_table", "codec_tables", "codec_tables_1024",
                   "proj_w", "proj_b", "tts_pad")}
    return Assets(text_rows=int(t["text_table"].shape[0]),
                  codec_rows=int(t["codec_tables"].shape[1]), **t)


def engine_weights(assets: Dict[str, Any], talker, predictor, codec_decoder,
                   device="cpu") -> Dict[str, Any]:
    """The `weights` argument of TtsEngine from the JAX package's arrays."""
    return {"assets": assets_from_arrays(assets, device),
            "talker": tree_to_torch(talker, device),
            "predictor": tree_to_torch(predictor, device),
            "codec_decoder": tree_to_torch(codec_decoder, device)}

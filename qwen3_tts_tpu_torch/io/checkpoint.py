"""Fast-start cache of converted LM weights.  Counterpart of
qwen3_tts_tpu/io/checkpoint.py, with `torch.save` in place of Orbax.

Converting a GGUF checkpoint (read, dequantize, stack on the device, int8
quantization) runs once; the resulting parameter dict is saved next to the
model files and read back on later engine starts, skipping the GGUF and
the quantization.

Layout (under `<model_dir>/cache/<name>/`):
  params.pt   torch.save of the converted nested dict of tensors, read
              back with torch.load(weights_only=True)
  meta.json   the source fingerprint (file name, size, mtime, int8 flag)
              and the derived model config (GGUF metadata overrides)

An entry is valid only while the fingerprint matches the source file, so
any change to the GGUF invalidates it.  The file is fingerprinted by path,
size and mtime, never hashed (a talker GGUF is gigabytes).  The JAX
package's switch is the environment variable QTTS_WEIGHT_CACHE; the port's
is `TtsEngine(weight_cache=...)`.  A save is written into a sibling
directory and renamed into place, so a failed save leaves no partial
entry.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import Any, Optional, Tuple

import torch

FORMAT_VERSION = 1


def fingerprint(src: Path, use_int8: bool) -> dict:
    st = Path(src).stat()
    return {"version": FORMAT_VERSION, "src": Path(src).name,
            "size": st.st_size, "mtime_ns": st.st_mtime_ns,
            "int8": bool(use_int8)}


def _coerce(cfg_cls, data: dict):
    """JSON gives tuples back as lists: coerce them per field, so that
    frozen-dataclass equality holds."""
    kw = {}
    for f in dataclasses.fields(cfg_cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return cfg_cls(**kw)


def save_lm(model_dir, name: str, params: Any, cfg, fp: dict) -> bool:
    """Save converted params + derived config.  Returns False (and leaves
    no partial entry) on any failure: the cache saves time, it is never
    needed for a correct result."""
    root = Path(model_dir) / "cache" / name
    tmp = root.with_name(name + ".partial")
    try:
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        torch.save(params, tmp / "params.pt")
        meta = {"fingerprint": fp, "config": dataclasses.asdict(cfg)}
        (tmp / "meta.json").write_text(json.dumps(meta, indent=1))
        shutil.rmtree(root, ignore_errors=True)
        tmp.rename(root)
        return True
    except Exception as e:
        from ..utils.logging import get_logger
        get_logger().warning(f"weight-cache save failed for {name}: {e!r}")
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(root, ignore_errors=True)
        return False


def load_lm(model_dir, name: str, fp: dict, cfg_cls, device="cpu"
            ) -> Optional[Tuple[Any, Any]]:
    """(params on `device`, config) if a cache entry matches `fp`, else
    None."""
    root = Path(model_dir) / "cache" / name
    meta_path = root / "meta.json"
    if not meta_path.exists():
        return None
    try:
        meta = json.loads(meta_path.read_text())
        if meta.get("fingerprint") != fp:
            return None
        params = torch.load(root / "params.pt", map_location=device,
                            weights_only=True)
        return params, _coerce(cfg_cls, meta["config"])
    except Exception as e:
        from ..utils.logging import get_logger
        get_logger().warning(f"weight-cache load failed for {name}: {e!r} "
                             "- converting from the source again")
        return None

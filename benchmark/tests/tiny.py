"""A tiny configuration and cells for the benchmark's CPU tests: the
port's exact path on the CPU at the protocol's fixed widths (talker 2048,
predictor 1024) and two-layer models, in float32."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

MODEL = {
    "dtype": "float32",
    "talker": {"d_model": 2048, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
               "head_dim": 16, "d_ff": 64, "rms_eps": 1e-6,
               "rope_theta": 1000000.0, "mrope_sections": [3, 3, 2, 0],
               "qk_norm": True, "n_codec_logits": 2160, "max_seq_len": 256,
               "dtype": "float32"},
    "predictor": {"d_model": 1024, "n_layers": 2, "n_heads": 4,
                  "n_kv_heads": 2, "head_dim": 16, "d_ff": 64,
                  "rms_eps": 1e-6, "rope_theta": 1000000.0, "qk_norm": True,
                  "n_residual_codebooks": 15, "codebook_size": 2048,
                  "max_seq_len": 16, "dtype": "float32"},
    "codec_decoder": {"d_model": 32, "n_layers": 2, "n_heads": 2,
                      "head_dim": 16, "d_ff": 64, "rms_eps": 1e-6,
                      "rope_theta": 10000.0, "n_codebooks": 16,
                      "codebook_size": 2048, "upsample_factors": [2, 2],
                      "channels": [16, 8], "conv_kernel": 3,
                      "upsample_kernel_mult": 1, "attn_window": 8,
                      "dtype": "float32"},
    "assets": {"text_rows": 4096, "codec_rows": 2176, "n_codebooks": 16,
               "talker_dim": 2048, "predictor_dim": 1024},
}
PLAIN = {"talker_prefill": "plain", "talker_decode": "plain",
         "codec_head_first": "plain", "codec_head": "plain",
         "predictor": "plain", "predictor_head": "plain"}
CONFIG = {"name": "tiny", "source": "tests", "reduced": [], "model": MODEL,
          "engine": {"quant": "none", "talker_mode": "w4a8"},
          "formats": {"default": PLAIN}}


def mix(kind: str) -> dict:
    with open(BENCH / "traffic" / f"{kind}_closed.json") as f:
        m = json.load(f)
    m.update(pool=64, warm_in_s=0.5, check_requests=2)
    if kind == "online":
        # 8-24 frames
        m.update(arrivals={"law": "closed", "clients": 4}, batch_size=4,
                 speech_s=[0.64, 1.92])
        m["sampler"] = dict(m["sampler"], temperature=0.0)
    else:
        # 4-16 frames
        m.update(speech_s=[0.32, 1.28], greedy_share=0.5)
    return m


LIMITS = {"gap_code0": {"limit": 1e-3}, "gap_residual": {"limit": 1e-3},
          "audio_err": {"limit": 1e-4}}


def make_root(tmp: Path) -> Path:
    """A checkout-like directory: BENCHMARK.json with the tiny cells, the
    tiny configuration, speakers/, and a benchmark dir with the real
    metric readers and client kinds, and the tiny mixes and limits."""
    root = tmp / "root"
    bench = root / "benchmark"
    (bench / "configs").mkdir(parents=True)
    (bench / "traffic").mkdir()
    (bench / "checks").mkdir()
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    shutil.copytree(BENCH / "clients", bench / "clients")
    (root / "speakers").symlink_to(ROOT / "speakers")
    with open(bench / "configs" / "tiny.json", "w") as f:
        json.dump(CONFIG, f)
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {"tiny.online": "online", "tiny.stream": "stream"}
    for name, kind in cells.items():
        with open(bench / "traffic" / f"{kind}_tiny.json", "w") as f:
            json.dump(mix(kind), f)
        with open(bench / "checks" / f"{name}.json", "w") as f:
            json.dump(LIMITS, f)
    bj = dict(real)
    bj["configs"] = [{"name": "tiny", "source": "tests",
                      "file": "benchmark/configs/tiny.json", "reduced": [],
                      "why": "tests"}]
    bj["workloads"] = [{"name": n, "config": "tiny",
                        "traffic": f"{d}_tiny", "chips": 1, "why": "tests"}
                       for n, d in cells.items()]
    on = ["tiny.online"]
    st = ["tiny.stream"]
    for m in bj["end_to_end"] + bj["per_layer"]:
        if "workloads" in m:
            m["workloads"] = on if any("online" in w for w in m["workloads"]) \
                else st
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bj, f)
    return root


def small_model() -> dict:
    """The talker and predictor at their published head and kv-head counts
    and head sizes, two layers and a narrow d_ff, in bf16: shapes the port's
    decode kernels take, so that its fused paths (their plain versions on
    the CPU) run the configurations' weight formats."""
    m = json.loads(json.dumps(MODEL))
    m["dtype"] = "bfloat16"
    m["talker"].update(n_heads=16, n_kv_heads=8, head_dim=128, d_ff=512,
                       mrope_sections=[24, 20, 20, 0], dtype="bfloat16")
    m["predictor"].update(n_heads=16, n_kv_heads=8, head_dim=64, d_ff=512,
                          dtype="bfloat16")
    m["codec_decoder"]["dtype"] = "bfloat16"
    return m


def small_config(name: str) -> dict:
    """A configuration file's formats and engine over small_model(), the
    engine on its fused decode path."""
    with open(BENCH / "configs" / f"qwen3-tts-1.7b-{name}.json") as f:
        real = json.load(f)
    return dict(real, model=small_model(),
                engine=dict(real["engine"], fused=True))

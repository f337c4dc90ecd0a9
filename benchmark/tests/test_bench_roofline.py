"""roofline/counts against figures worked by hand for both
configurations at one and 32 lanes."""

import json

import pytest

from roofline import counts
from tiny import BENCH


def cfg(name):
    return json.loads((BENCH / "configs" / f"qwen3-tts-1.7b-{name}.json")
                      .read_text())


W4 = cfg("w4a8")
Q8 = cfg("q8_0")
STEP = W4["formats"]["default"]
ONE = W4["formats"]["1"]
INT8 = Q8["formats"]["default"]

# talker layer, w4a8 with bf16 scales: K*N/2 + 2*N*K/128 per matrix
#   wqkv 2048 x 4096: 4,194,304 + 131,072 = 4,325,376
#   wo   2048 x 2048: 2,097,152 +  65,536 = 2,162,688
#   gu   2048 x 12288: 12,582,912 + 393,216 = 12,976,128
#   down 6144 x 2048: 6,291,456 + 196,608 = 6,488,064
#   -> 25,952,256 a layer, 726,663,168 for 28
W4_TALKER = 726_663_168
# int8 per column: K*N + 4*N -> 50,413,568 a layer, 1,411,579,904 for 28
Q8_TALKER = 1_411_579_904
KV_ROW = 28 * 2 * 8 * 128 * 2            # 114,688 bytes a token
TALKER_OPS = 2 * 1_409_286_144           # 2 x 50,331,648 x 28


def test_layer_bytes():
    t = W4["model"]["talker"]
    assert counts.layer_bytes(t, "w4a8_bf16s") == W4_TALKER
    assert counts.layer_bytes(t, "int8_col") == Q8_TALKER
    assert counts.kv_row_bytes(t) == KV_ROW
    assert 2 * counts.layer_params(t) == TALKER_OPS


@pytest.mark.parametrize("lanes", [1, 32])
def test_talker_step(lanes):
    attn = 4 * 28 * 16 * 128 * 100       # 100 rows attended
    ops, by = counts.talker_step(W4["model"], STEP, [99] * lanes)
    assert ops == lanes * (TALKER_OPS + attn)
    assert by == W4_TALKER + lanes * (KV_ROW * 100 + 4 * 2048)
    ops8, by8 = counts.talker_step(Q8["model"], INT8, [99] * lanes)
    assert by8 == Q8_TALKER + lanes * (KV_ROW * 100 + 4 * 2048)
    # 1 lane: 738,140,160 bytes (w4a8), 32 lanes: 1,093,926,912
    assert by == {1: 738_140_160, 32: 1_093_926_912}[lanes]


@pytest.mark.parametrize("lanes", [1, 32])
def test_predictor_frame(lanes):
    # int8 per column, a layer: 2,105,344 + 1,052,672 + 6,316,032 +
    # 3,149,824 = 12,623,872; x 6 = 75,743,232; the int8 head of 30,720
    # rows: 31,457,280 + 122,880 = 31,580,160; 4,160 bytes a lane
    _, by = counts.predictor_frame(W4["model"], STEP, lanes)
    assert by == 75_743_232 + 31_580_160 + lanes * 4_160
    _, by8 = counts.predictor_frame(Q8["model"], INT8, lanes)
    assert by8 == by


def test_frame_step_and_chunk_call():
    m = W4["model"]
    ops1, by1 = counts.frame_step(m, STEP, [99])
    ops32, by32 = counts.frame_step(m, STEP, [99] * 32)
    # weights once a step (less L2), KV per lane
    assert by32 - by1 == 31 * KV_ROW * 100
    assert ops32 == pytest.approx(32 * ops1)
    weights = (W4_TALKER + 75_743_232 + 31_580_160
               + 2 * 2160 * 2048 + 4 * 1024 * 2048)
    assert by1 == weights - counts.L2_BYTES + KV_ROW * 100
    # a 4-frame chunk launch reads every weight once: less than 4 steps
    _, byc = counts.chunk_call(m, ONE, 4, 99)
    assert byc < 4 * by1
    assert counts.seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert counts.seconds(1979e12, 0.0) == pytest.approx(1.0)

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qwen3_tts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py [--phases kernels,chunk,reference,engine,stream,
                                    clone,onnx,serving,online,spec,wave,
                                    weights,tools,parallel]

Phases, each of which must pass (exit code 1 otherwise; 2 without CUDA):
  1. build: compile the CUDA kernels from qwen3_tts_tpu_torch/csrc (nvcc,
     sm_90a, one process per source, all at once) and load them;
  2. kernels: each kernel against its plain PyTorch version at the shapes
     the main path gives it, max error against the stated tolerance, and
     both timed with CUDA events (order plain, kernel, kernel, plain):
     - attention (talker: B=1, H=16, Hkv=8, Dh=128, L=28, C=1024, prefill
       S=32 and 128, decode at cursors past prompt_cap; predictor: Dh=64,
       C=17; layers rotated, so the 117 MB talker cache does not sit in L2),
       each also beside one torch scaled_dot_product_attention call on the
       same inputs (library_ms; the port never calls it);
     - talker_step_fused (w4a8, full width, B=1, C=1024, prompt_cap 32 and
       128, the decode cursors above), as one layer and as the whole
       28-layer step;
     - predict_frame_fused (int8, full width, B=1): codes and window logits;
     - the one-layer flash_gqa_decode (the stacked entry's kernel on a
       layer's view; scalar write_idx at the path's cursors and across its
       64-slot chunk boundaries, per-lane write_idx at B = 4 and 32), timed
       at cursor 48 and 1023 (B = 1) and at B = 4 per-lane cursors, also in
       a CUDA graph beside SDPA's graph;
     - talker_step_fused in its int8, w8a8 and bf16 weight modes (full
       width, B = 1, 8 and 32): lanes bit-equal to the one-lane kernel,
       layer by layer against the plain talker in the kernel's orders;
     - matmul_int4 at the talker's four weight shapes, M = 1-129 held
       (both of its kernels), timed at M = 1, 32 and 128 beside
       torch.matmul on the dequantized bf16 weight (CUDA events and
       graphs); its tile kernel has an entry of its own in the kernels
       line (matmul_int4_tile, M = 32);
     - flash_gqa_decode_append (per-lane cursors, L=28, C=1024) bit-equal
       to its plain version in the kernel's sum orders and within the
       decode bound of the torch-order one, across the 64-slot split
       bounds, at cursors 0 and C - 1 and past C, B = 4, 6 and 8; timed at
       the exact queue's shape (B = 4, cursors 36-52), at B = 4 to cursor
       1023 and at B = 8 per-lane cursors 32-1023;
     - flash_gqa_prefill_stacked continuing a kept prompt prefix: B = 1,
       start 64 and 192, S 16 and 48, window 128 and 256, the stale rows
       of an earlier request past the suffix poisoned, two shapes timed
       beside SDPA; on whole clone prompts, S = 512 and 4096 (B = 1,
       window S), timed beside SDPA; and at the speculative verify
       forward's contract (B = 4 and 8, S = 4, window = C = 1024, per-lane
       starts over [32, C - 4], the stale rows past each lane poisoned),
       timed beside SDPA;
     Small kernels are also timed in a CUDA graph (device time without the
     wrapper's host enqueue): the attention kernels, matmul_int4 and the
     three lane kernels of continuous batching;
  3. chunk: gen_chunk_fused (one cooperative launch per chunk; full width,
     B=1, F=4, C=1024) against gen_chunk_plain on copies of one cache at
     (prompt_cap, length, start) = (32, 31, 32), (128, 117, 159) and
     (128, 90, 1020) and, on a 5120-slot cache (a clone prompt filling the
     4096-row bucket), (4096, 4070, 4100), greedy; one sampled chunk; the
     in-kernel sampler alone
     against ops.sampling.sample_threshold; the batched forms at B = 8, 16,
     24 and 32 (ragged lengths, one cursor), greedy and sampled: every lane
     bit-equal to the one-lane launch; lanes 0, B - 1 and the first of
     each row tile against the plain version, the talker layer by layer
     from the kernel's own state against the plain layer in the kernel's
     sum orders (chunk_step.KERNEL_ORDERS), each frame end to end against
     the plain frame in the kernel's frame orders run from the chunk's
     start (CHUNK_ORDER_TOL); each B timed;
  4. reference: a two-layer model at full width, same weights on the card
     and on the CPU (exact path): prefill logits and the codec's waveform
     agree within the stated tolerance;
  5. engine: a full-width TtsEngine(device="cuda") (28-layer talker,
     6-layer predictor, 8-layer codec, bf16, random weights) serves
     preset-voice requests at prompt buckets 32 and 128, greedy and
     sampled, max_steps 32 (12 on the exact path), on each decode path:
     the chunk path (the default on the card: one chunk-kernel launch per
     4 frames), the
     per-kernel path (chunk=False: talker-step and predictor-frame
     kernels) and the exact path (fused=False: the attention kernels).
     For each path the launch counters are reset just before its requests
     and read just after; every kernel of the path must have launched, and
     on the chunk path the per-kernel path's two kernels must not.  Greedy
     runs with one seed must give equal codes.  One more greedy request per
     path runs under torch.profiler for launches per frame and the
     device-busy share.
  6. stream: streaming and prompt-prefix KV reuse on the engine phase's
     model: greedy streams of one lane on the default engine (a first
     chunk of first_chunk_frames frames through the chunk kernel, then
     4-frame chunks) at buckets 32 and 128: chunk lengths, audio, the
     launch counts (the prefill and the chunk kernel only), TTFT, the
     intervals between chunks, ms/frame beside the same request in bulk,
     frame 0 equal to bulk (the first frame and token where the codes
     part printed), a greedy rerun equal; an exact-path stream equal to
     its bulk run code for code; one profiled stream (device-busy share,
     the device's idle time at each chunk boundary); stream_batch at 8
     lanes (the step schedule) and its rerun; a long-instruction
     preset-voice request twice (a prefix-KV miss, then a hit: prefill
     ms, greedy codes equal, the entry a copy of its slots, the continued
     prefill's logits against a full prefill's); generate_long on three
     sentences.
  7. clone: voice cloning from reference audio on the engine phase's
     model (codec encoder and speaker encoder on seeded random weights):
     seeded 10 s and 30 s reference WAVs through create_voice_file (codes
     [120, 16] and [360, 16], a unit-norm embedding) held against the port
     on the CPU with the same weights (codes equal, log-mel and embedding
     within stated tolerances), the mel, the encoder's convs, its RVQ and
     the speaker encoder timed alone; warmup at buckets 256 and 512;
     generate greedy twice per reference (a miss, then a hit: the .cache
     sidecar read and the encoder not run, the prefix KV reused, codes
     equal; prefill ms of each), launching the prefill and chunk kernels
     and not the step kernels; a cloned stream's TTFT; a clone voice whose
     prompt fills the 4096-row bucket for 8 frames on the chunk kernel;
     the 28-layer prefill of a 4096-row prompt (Generator.start).
  8. onnx: the ONNX codec, a model directory laid out as the reference
     ships it (onnx/qwen3_tts_decoder.onnx, ..._codec_encoder.onnx,
     ..._speaker_encoder.onnx: the graphs of tests/torch_onnx_fixtures.py
     at the published contract's widths, written from a seed under
     qwen3_tts_tpu_torch/build/ and removed at the end) beside the engine
     phase's LMs: the decoder graph alone (one 8-frame call against 4 + 4
     chunked calls, the port on the CPU and the numpy reference; an 8-lane
     decode_batch against each lane alone and, as a replayed CUDA graph,
     against vmap of the eager walk bit for bit; a 4-frame call as the
     eager walk, the plan run and the graph replay, each bit for bit
     against the eager walk and timed, with the plan's build, the graph's
     capture and its memory, beside the native decode_chunk), a greedy
     32-frame request whose codes equal a native-codec engine's (8
     chunk-kernel launches, one 28-layer prefill), four streams (planned,
     captured, replayed, and on the eager walk: the second must replay
     and walk nothing), stream_batch at 8 lanes, a wave of 8 and a
     continuous queue at batch 8 (each lane against a decode of its own
     codes), a clone from a 10 s reference through the encoder graphs,
     and the engine's executors' counters.
  9. serving: continuous batching (serve/continuous.py) at batch 8 and 32
     on the default engine (per-lane cursors: the step schedule) and at
     batch 4 on the exact path (flash_gqa_decode_append), each queue's
     audio digest printed.
  10. online: online serving (serve/online.py, serve/api.py) on the
     default engine (its per-lane frames take the step schedule): an
     OnlineBatcher at batch 8, bucket 32, 20 greedy requests (budgets 6 /
     12 / 24) from 4 client threads with staggered arrivals (every future
     resolves with frames x 2000 finite samples; the step schedule's
     kernels launch, the chunk kernel and flash_gqa_decode_append do not;
     requests/s and latency p50 / p90), the same requests one at a time
     twice (equal codes); an OnlineRouter over buckets 32 and 128 at batch
     4 with both buckets busy at once, each request's codes equal to the
     same per-bucket sequences run one bucket after the other (the two
     workers share the kernels' scratch: engine.device_lock); TtsServer on
     127.0.0.1 over that router: GET /health, 8 concurrent POST /tts (mono
     24 kHz WAVs of X-QTTS-Frames x 2000 samples) and one direct-mode POST
     /tts?stream=1 beside them (chunked PCM).
  11. spec: speculative decode (runtime/spec.gen_frames_spec) on the
     engine phase's weights on a fused=False engine, B = 4 lanes at four
     cursors (refills), bucket 128, K = 4: the verify forward's logits
     against 4 sequential steps'; (a) drafts equal to the sequential next 4
     frames, all accepted; (b) repeat_draft, frame 0 the sequential one;
     (c) mismatches at 4 / 2 / 0 / 1 by lane, n_emit = min(n_acc + 1, K),
     then 8 sequential frames equal to the all-sequential run (a lane may
     part only at a near tie of code 0, printed); the same drafts on the
     default engine, acceptance printed.
  12. wave: wave batching (serve/batch.py BatchSynthesizer) on the default
     engine at batch 8, 16 and 32 (the batched chunk kernel), a
     mixed-budget run with a padded last wave, and batch 8 on a chunk=False
     engine (the step schedule); launch counts, frames/s, per-stream RTF
     and one profiled wave per batch size.
  13. weights: the deployed weight path at full width: a synthetic model
     directory (F16 talker and predictor GGUFs under llama.cpp names,
     the assets GGUF, codec/decoder.npz, encoder.npz and speaker.npz;
     written from a seed, ~4.8 GB, removed at the end),
     TtsEngine(model_dir, quant="q8_0") built twice
     (the second from the weight cache, its tensors equal to the first's),
     a voice from a 2 s reference on the encoders read from the npz
     files, a greedy request and its rerun on the chunk path, the per-kernel
     path in each talker mode (w4a8, int8, w8a8, bf16), the exact path
     (int8 matmuls, a8w8 prefill) and the exact path on int4 layers
     (matmul_int4); launch counts per path and talker mode.  The
     directory stays for the tools phase and is removed after it.
  14. tools: the ported tools at full width on that directory (written
     here when the weights phase did not run): (a) the native host
     library built from native/qtts_native.cpp with the host's g++, its
     dequantizers against numpy for the six quant types (rtol 1e-5, atol
     1e-6), qtts_f16_to_f32 exact on every finite f16, the talker GGUF
     read through its multi-threaded loader and through numpy (equal,
     both timed); (b) the runbook (verify.run_drills, quant q8_0, on the
     card): the three GGUF drills PASS, the rest SKIP (the hub probe aimed
     at a closed local port: the machine has no network), none FAILs; (c)
     llama-parity: make_inputs (48 rows, 8 steps), a talker GGUF at full
     width cut to 2 layers, the "dump" from run_our_talker on the CPU,
     compare_talker on the card under the JAX rule (rel <= 5e-2, top-1 >=
     0.99; a miss excused only at a near tie, PARITY_TIE of max |logit|,
     each printed), the prefill and decode attention kernels launched;
     (d) the golden-wav body on the default engine of the directory,
     recorded then verified; (e) a greedy 8-frame request under
     QTTS_PROFILE_DIR (the trace names the chunk and prefill kernels,
     codes equal to an untraced run's), under QTTS_CHECKS (equal codes)
     and under QTTS_DEBUG_NANS (equal codes; a NaN planted in the talker's
     final norm raises FloatingPointError); (f) `python -m
     qwen3_tts_tpu_torch --skip-download` (one request) and
     --audition-voice of a voice cloned from a 2 s reference, each in a
     subprocess (WAVs of frames x 2000 samples).
  15. parallel: tensor and data parallelism (qwen3_tts_tpu_torch/parallel)
     at full width and depth, B = 4 preset-voice lanes of bucket 64, 8
     greedy frames: (a) one process on a one-rank NCCL group, mesh 1 x 1:
     tp_talker_prefill and tp_gen_bulk on the engine's bf16 and int8
     weights equal to the same weights' exact path (codes, logits within
     PARALLEL_ONE_RANK_TOL); the attention kernels and matmul_int4 at the
     1 x 2 mesh's rank-local heads (8 / 4) and K (1024, 3072) against their
     plain versions (the decode kernels at the TP path's cursors and at
     multi-split ones, flash_gqa_decode_append bit for bit against its
     kernel-order plain version), CUDA-graph time beside SDPA /
     torch.matmul; (b) two spawned processes on cuda:0 joined by gloo
     (through the host: not NCCL's figures), mesh 1 x 2: the same run, the
     ranks bit-equal, within PARALLEL_LOGIT_TOL of (a) and parting from it
     only at near ties (PARALLEL_TIE), then fed (a)'s codes frame by frame
     (every step's code-0 and predictor window logits within
     PARALLEL_LOGIT_TOL of (a)'s), the three attention kernels launched at
     8 / 4 heads, a refill and a step at per-lane cursors against the
     unsharded refill, int4 layers (matmul_int4 at K = 1024 and 3072) and
     an a8 prefill against the unsharded ones, the prefill summed in bf16
     beside f32; (c) two processes, mesh 2 x 1: ContinuousBatcher, 6
     requests on 4 lanes (2 a rank) with refills, greedy on the exact path
     and sampled on the default engine (its step and predictor kernels),
     each request against the one-process batcher up to near ties (a
     sampled code 0 on the same uniform, the logits of its frame within
     PARALLEL_LOGIT_TOL); sampled waves
     of 2 lanes on the default engine (the chunk kernel at one lane a
     rank) equal to each rank's lanes alone in one process.  ms a frame,
     all-reduces a frame.
It prints one JSON line with the kernels' numbers (each with bound_ms: the
larger of the bytes it must move over 3.35 TB/s and its operations over
the card's peak for their type, from this run's shapes), then the card's
name and power limit, then the result line.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys
import time

MAX_STEPS = 32
# the exact path's requests in the engine phase: it is host-bound (~9,000
# launches a frame, ~200 ms a frame), so its depth is cut to three chunks
EXACT_STEPS = 12
GREEDY = dict(temperature=0.0, top_k=40, top_p=0.9)
SAMPLED = dict(temperature=0.7, top_k=40, top_p=0.9)
# (label, text, instruction, sampler, seed); the hashing tokenizer gives one
# id per character, and a preset-voice prompt is 11 rows + the text
REQUESTS = [
    ("greedy-b32", "Hello from the H100.", None, GREEDY, 1),
    ("greedy-b128", "A longer sentence that fills the next prompt bucket "
     "of the talker prefill, one row per character.", None, GREEDY, 2),
    ("sampled-b32", "Sampled speech here.", None, SAMPLED, 3),
    ("sampled-b128", "Speak calmly: the preset voice path runs on the card "
     "with its own attention kernels.", "Calm", SAMPLED, 4),
    ("greedy-b32-again", "Hello from the H100.", None, GREEDY, 1),
]
PREFILL_TOL = 2e-2   # bf16 K/V and bf16 p in P.V against f32 attention
# The clone-length prefill cases are held row by row: at S = 4096 with
# these inputs (std 0.5, near-uniform softmax) a long row's values are
# about 0.01, below PREFILL_TOL.  For each (row, head) the largest
# |kernel - plain| over Dh, over the RMS of the plain row.  Both outputs
# are rounded to bf16 (one ulp, 2^-8 of a value up to ~5 RMS apart) and
# the kernel rounds p to bf16 (~2^-9 / sqrt(3) of the RMS): about 0.03
# at most.  One K/V tile (64 slots) left out of a 4000-key row moves it
# by several tenths (checked in the phase on its own inputs).
PREFILL_ROW_TOL = 2.0 ** -4
# The decode kernel computes in f32, as its plain version does, and rounds
# only its output to bf16: against the plain version's f32 result on the
# same inputs it is off by at most half a bf16 ulp (2^-8 of the value),
# plus f32 summation order.
DECODE_RTOL, DECODE_ATOL = 2.0 ** -8, 1e-5
REF_REL_TOL = 5e-2   # bf16 model on two devices: relative to max |ref|
# talker_step_fused against talker_step_plain, both w4a8 on the same int4
# weights with the same exact integer group dots and the same f32 group
# order, so most steps agree bit for bit.  What differs: the order of the
# RMSNorm sums and of the softmax (online, in tiles, against torch's one
# pass), and 1/sqrt against rsqrt.  One f32 ulp there can flip the bf16
# rounding of an activation and then its int8 quantization by one step
# (1/127 of the row's max) in the next matmul, and later layers carry the
# flip on.  Held as max |kernel - plain| over max |plain|: one layer 1e-2,
# the whole 28-layer step 1e-1 (first chip run: 0 in 7 of 8 cases, 4.5e-2
# at cursor 1023); the k/v rows the step writes, likewise; every other
# cache slot bit for bit.
STEP_TOL_LAYER, STEP_TOL_STEP = 1e-2, 1e-1
# predict_frame_fused against predict_frame_plain: the f32 sums of the
# bf16 x int8 dots run in another order (cuBLAS against the kernel's
# lanes), which flips the bf16 rounding of single activations; over 16
# tokens x 6 layers the window logits drift by a few hundredths (first chip
# run: 4.5e-2).  Held as max |kernel - plain| over max |plain logits| <=
# 5e-2 while the codes agree; a greedy code may flip only where the plain
# version's top-2 gap is below PRED_GAP, after which the frame follows
# another code and the comparison stops.
PRED_LOGIT_TOL, PRED_GAP = 5e-2, 1e-1
# a refilled lane's prefill logits against a solo prefill of its prompt
# (tests/test_continuous.py's bound): the same prompt through the same
# kernels at the same shapes (one row), so equal up to summation order
REFILL_RTOL, REFILL_ATOL = 2e-4, 2e-3
SERVING_TEXTS = ("On the card",                    # bucket 32
                 "A longer serving prompt that lands in the next bucket of "
                 "the talker prefill.")            # bucket 128
# gen_chunk_fused against gen_chunk_plain: the talker step's and the
# predictor's w4a8 numerics (exact integer group dots in the plain
# version's order), so the same drift classes as the talker step: RMSNorm,
# projection, feedback and softmax sums in another order (the prefix in
# 64-slot splits against the plain version's 512-slot tiles) flip single bf16
# roundings, which the next int8 quantization and later layers carry on.
# Carried from frame to frame, that drift grows (one H100: frame 1's
# window logits 5-10 % of max apart when it starts from the plain
# version's own frame 0), so every frame f of a 4-frame launch is held
# against the plain version run from the kernel's own state after frame
# f - 1 (the outputs and cache of the f-frame launch: the launch is
# deterministic, and the f + 1-frame launch repeats the f-frame one bit for
# bit, which is checked), with the kernel's codes forced on it
# (gen_chunk_plain's force_codes) so that a near tie does not end the
# comparison.  Per frame: code_0 exactly (the same logits on both sides);
# a later code may differ from the plain pick only where the plain top-2
# gap is <= CHUNK_GAP and the measured difference of those logits explains
# it (gap <= 2 max |kernel - plain|); layer 0's written k/v row (the
# feedback, norms, rope and slot: no attention drift yet) within
# STEP_TOL_LAYER; the 15 window logits, the carried logits and hidden
# state and the written k/v rows within max(CHUNK_TOL, 2 s) of max
# |plain|, where s is how far the plain version moves from itself with
# the prefix in tiles of the kernel's split (chunk_step.SPLIT = 64 slots)
# instead of 512 (an equally valid order; it depends on the plain version
# alone).  Over a long
# prefix one frame is that sensitive: at start 1020, frame 3, the plain
# version moved 1.05e-1 from itself and the kernel 1.66e-1, while 11 other
# frames stayed within 6.3e-2 (one H100).  Every other cache slot bit for
# bit; every output finite.
CHUNK_TOL, CHUNK_GAP = 1e-1, 1e-1
# check_chunk_batched traces each frame whose end-to-end error against the
# plain frame in the kernel's orders passes this (the rest sit at ~1e-6,
# the heads' order)
DRIFT_TRACE = 1e-4
# and holds every sampled frame there: frame f of the launch against the
# plain frame f run from the chunk's start with offset f (gen_chunk_plain's
# frame0: the chunk's own slots merged last, as the kernel merges them) in
# the kernel's frame orders (chunk_step.CHUNK_ORDERS), from the kernel's
# state after frame f - 1 with its codes forced: logits, hidden and the
# written k/v rows within this share of max |plain| (one H100: 120 of 120
# frames within 1.43e-6, the codec head's tensor-core order; a new chunk
# at start + f would fold the chunk's earlier slots into its 64-slot prefix
# splits and move a frame by up to 2.5e-1); DRIFT_TRACE <= this, so every
# frame beyond it is traced
CHUNK_ORDER_TOL = 1e-4
# The batched form's lanes against the plain version.  Each lane is
# bit-equal to the one-lane launch, so this holds the one-lane kernel on
# more frames than check_chunk's three greedy cases, and there frame by
# frame from the kernel's state is not tight enough: the talker's 28
# layers carry one flipped bf16 rounding on (one H100: 3 of 56
# sampled frames beyond max(CHUNK_TOL, 2 s), up to 1.96e-1, with every
# code equal or a near-tie flip).  So the talker is held layer by layer
# from the kernel's own state, as check_talker_batched holds the talker
# step: the kernel's residual entering each layer (gen_chunk_fused's
# layer_taps) through the plain layer in the kernel's orders
# (chunk_step.KERNEL_ORDERS: its RMSNorm and q/k-norm sums, its
# attention's split, combine and merge sums and its score dots, the prefix
# in 64-slot splits),
# against the kernel's next residual and its written k/v row.  In torch's
# orders a flipped rounding (one int8 unit of a GEMV input moves every
# output a little: 1,500-1,900 of 2,048 elements) moved a layer by up to
# 2.2e-2 of max; in the kernel's orders the two pairs that no tile order
# explained came out exact (ROADMAP Queue C #1).  So each (layer, lane)
# residual within STEP_TOL_LAYER, with no allowance; at least
# LAYER_EXACT_SHARE of them exact (a kernel wrong in any lane or layer
# would leave none exact; one H100: 3,136 of 3,136 pairs exact, against
# a share of 0.9 held in torch's orders before); every written k/v row
# within STEP_TOL_LAYER; the
# feedback of the kernel's codes against the kernel's layer-0 input, and
# the final norm and codec head of the kernel's last residual against its
# hidden and logits, within STEP_TOL_LAYER too; whether the feedback (in
# the kernel's q order) and the final norm (its 256-thread order) are
# exact is printed.  The torch-order error and
# s (the plain layer's own 128- vs 512-slot-tile difference), which tie
# the kernel to the JAX package's order, are printed.  The codes and the
# predictor's window logits keep check_chunk's policy; the frame's
# end-to-end difference from the plain version, in torch's orders and in
# the kernel's whole frame's (chunk_step.CHUNK_ORDERS: the talker's and the
# projection's, feedback's and norms' orders), is printed in torch's orders
# and held in the kernel's (CHUNK_ORDER_TOL).  The one-lane launch is held
# the same way (B = 1 in the list).
LAYER_EXACT_SHARE = 0.99
# the in-kernel sampler against sample_threshold on the same uniforms: f32
# sums in another order move a threshold across a logit now and then
SAMPLER_MIN_EQUAL = 0.99
# one H100 SXM (NVIDIA's data sheet): bytes/s of
# HBM, dense ops/s by input type
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound(nbytes: float, ops: float, kind: str):
    """(least ms, what bounds it): the larger of the bytes over the HBM
    rate and the operations over the peak rate for their input type."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_ms(fn, iters: int = 28, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn(0)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, n: int = 20, reps: int = 3) -> float:
    """Device time per call of fn: n calls captured in one CUDA graph and
    replayed, timed with CUDA events, so that the host's enqueue time
    (the wrapper's Python and ctypes, ~40 us, more than a small kernel
    takes) leaves no gaps between the kernels as it does in cuda_ms."""
    import torch
    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (reps * n)


def check_kernels(dev, failures):
    """Kernel vs plain at the main path's shapes; returns per-kernel
    results {name: {max_abs_err, ms, plain_ms}}."""
    import torch
    from qwen3_tts_tpu_torch.kernels import flash_decode as fd
    from qwen3_tts_tpu_torch.kernels.flash_decode import (
        decode_attention_plain, decode_layer_plain, flash_gqa_decode,
        flash_gqa_decode_stacked)
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked, prefill_attention_plain)
    from qwen3_tts_tpu_torch.ops.attention import history_mask
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.5).to(
            torch.bfloat16)

    def i32(*vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    out = {}
    # talker: L=28, B=1, Hkv=8, C=1024, Dh=128; predictor: L=6, C=17, Dh=64
    talker_kv = (rnd(28, 1, 8, 1024, 128), rnd(28, 1, 8, 1024, 128))
    pred_kv = (rnd(6, 1, 8, 17, 64), rnd(6, 1, 8, 17, 64))

    errs = []
    for s, length in ((128, 117), (32, 31)):          # talker buckets
        q = rnd(1, s, 16, 128)
        args = (q, *talker_kv, i32(length), i32(0))
        got = flash_gqa_prefill_stacked(*args, 5, s, s)
        torch.cuda.synchronize()
        want = prefill_attention_plain(*args, 5, s, s)
        err = (got.float() - want.float()).abs().max().item()
        errs.append(err)
        print(f"[kernel] flash_gqa_prefill_stacked S={s} window={s} "
              f"length={length} Dh=128 grid (CTAs, warps each) "
              f"{flash_gqa_prefill_stacked.grid}: max_abs_err={err:.3e} "
              f"tol={PREFILL_TOL}")
    q = rnd(1, 2, 16, 64)
    args = (q, *pred_kv, i32(0), i32(0))
    got = flash_gqa_prefill_stacked(*args, 3, 0, 2)
    want = prefill_attention_plain(*args, 3, 0, 2)
    err = (got.float() - want.float()).abs().max().item()
    errs.append(err)
    print(f"[kernel] flash_gqa_prefill_stacked S=2 window=2 Dh=64 "
          f"(predictor) grid {flash_gqa_prefill_stacked.grid}: "
          f"max_abs_err={err:.3e} tol={PREFILL_TOL}")
    # lane refill (serving): R prompts of one bucket prefill into a compact
    # cache of capacity S, window S, ragged lengths
    for b in (8, 32):
        for s in (32, 128):
            kv = (rnd(28, b, 8, s, 128), rnd(28, b, 8, s, 128))
            q = rnd(b, s, 16, 128)
            lens = i32(*[s - (13 * i) % s for i in range(b)])
            args = (q, *kv, lens, torch.zeros_like(lens))
            got = flash_gqa_prefill_stacked(*args, 5, s, s)
            torch.cuda.synchronize()
            want = prefill_attention_plain(*args, 5, s, s)
            err = (got.float() - want.float()).abs().max().item()
            errs.append(err)
            print(f"[kernel] flash_gqa_prefill_stacked B={b} S={s} compact "
                  f"C={s} window={s} lengths {min(lens.tolist())}-"
                  f"{max(lens.tolist())} Dh=128 grid "
                  f"{flash_gqa_prefill_stacked.grid}: max_abs_err={err:.3e} "
                  f"tol={PREFILL_TOL}")
            del kv
    # a long prompt: S = 1024, window 1024, B = 1, where the dot products
    # are most of the kernel's work
    s1k = 1024
    kv1k = (rnd(1, 1, 8, s1k, 128), rnd(1, 1, 8, s1k, 128))
    q1k = rnd(1, s1k, 16, 128)
    args1k = (q1k, *kv1k, i32(1000), i32(0))
    got = flash_gqa_prefill_stacked(*args1k, 0, s1k, s1k)
    torch.cuda.synchronize()
    grid1k = flash_gqa_prefill_stacked.grid
    want = prefill_attention_plain(*args1k, 0, s1k, s1k)
    err = (got.float() - want.float()).abs().max().item()
    errs.append(err)
    print(f"[kernel] flash_gqa_prefill_stacked S={s1k} window={s1k} "
          f"length=1000 Dh=128 grid {grid1k}: max_abs_err={err:.3e} "
          f"tol={PREFILL_TOL}")
    if max(errs) > PREFILL_TOL:
        failures.append("flash_gqa_prefill_stacked disagrees with plain")
    q128 = rnd(1, 128, 16, 128)
    lens, st = i32(117), i32(0)
    ms = plain = 0.0
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            ms += cuda_ms(lambda i: flash_gqa_prefill_stacked(
                q128, *talker_kv, lens, st, i % 28, 128, 128)) / 2
        else:
            plain += cuda_ms(lambda i: prefill_attention_plain(
                q128, *talker_kv, lens, st, i % 28, 128, 128)) / 2
    mask = history_mask(lens, 128, st, 128, 128)
    qt = q128.transpose(1, 2)
    kl, vl = (t[5, :, :, :128] for t in talker_kv)

    def prefill_lib(i):
        kl, vl = (t[i % 28, :, :, :128] for t in talker_kv)
        return sdpa(qt, kl, vl, attn_mask=mask[:, None], enable_gqa=True)

    lib = cuda_ms(prefill_lib)
    dev_k = graph_ms(lambda i: flash_gqa_prefill_stacked(
        q128, *talker_kv, lens, st, i % 28, 128, 128))
    dev_l = graph_ms(prefill_lib)
    pairs = int(mask.sum())
    b_ms, b_by = bound(nbytes((q128, kl, vl)) + q128.numel() * 2,
                       4 * pairs * 16 * 128, "bf16")
    flash_gqa_prefill_stacked(q128, *talker_kv, lens, st, 5, 128, 128)
    grid128 = flash_gqa_prefill_stacked.grid
    print(f"[kernel] flash_gqa_prefill_stacked S=128 per layer, grid "
          f"{grid128}: {ms:.4f} ms, plain {plain:.4f} ms, torch sdpa "
          f"{lib:.4f} ms, bound {b_ms:.5f} ms ({b_by}); device time (CUDA "
          f"graph of 20 calls) kernel {dev_k:.4f} ms, sdpa {dev_l:.4f} ms "
          f"({dev_k / dev_l:.2f}x)")
    # S = 1024: the same timings, one layer
    ms1k = plain1k = 0.0
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            ms1k += cuda_ms(lambda i: flash_gqa_prefill_stacked(
                *args1k, 0, s1k, s1k)) / 2
        else:
            plain1k += cuda_ms(lambda i: prefill_attention_plain(
                *args1k, 0, s1k, s1k), 4, 1) / 2
    mask1k = history_mask(args1k[3], s1k, args1k[4], s1k, s1k)
    qt1k = q1k.transpose(1, 2)
    kl1k, vl1k = (t[0, :, :, :s1k] for t in kv1k)

    def prefill_lib_1k(i):
        return sdpa(qt1k, kl1k, vl1k, attn_mask=mask1k[:, None],
                    enable_gqa=True)

    lib1k = cuda_ms(prefill_lib_1k)
    dev_k1k = graph_ms(lambda i: flash_gqa_prefill_stacked(
        *args1k, 0, s1k, s1k))
    dev_l1k = graph_ms(prefill_lib_1k)
    b1k, b1k_by = bound(nbytes((q1k, kl1k, vl1k)) + q1k.numel() * 2,
                        4 * int(mask1k.sum()) * 16 * 128, "bf16")
    print(f"[kernel] flash_gqa_prefill_stacked S={s1k} window={s1k} one "
          f"layer, grid {grid1k}: {ms1k:.4f} ms, plain {plain1k:.4f} ms, "
          f"torch sdpa {lib1k:.4f} ms, bound {b1k:.5f} ms ({b1k_by}); "
          f"device time (CUDA graph of 20 calls) kernel {dev_k1k:.4f} ms, "
          f"sdpa {dev_l1k:.4f} ms ({dev_k1k / dev_l1k:.2f}x)")
    out["flash_gqa_prefill_stacked"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, device_ms=dev_k,
        library_device_ms=dev_l, grid_s128=list(grid128),
        s1024=dict(ms=ms1k, plain_ms=plain1k, library_ms=lib1k,
                   device_ms=dev_k1k, library_device_ms=dev_l1k,
                   bound_ms=b1k, bound_by=b1k_by, grid=list(grid1k)))
    del kv1k, q1k, args1k, mask1k
    out["flash_gqa_prefill_stacked"]["start_ne_0"] = prefill_continued(
        dev, failures, rnd, i32)
    for s_ in PREFILL_CLONE_S:
        out["flash_gqa_prefill_stacked"][f"s{s_}"] = prefill_clone(
            dev, failures, rnd, i32, s_)
    out["flash_gqa_prefill_stacked"]["verify"] = [
        prefill_verify(dev, failures, rnd, i32, b) for b in VERIFY_BATCHES]

    errs = []
    tol = f"{DECODE_ATOL} + 2^-8*|plain f32|"

    def decode_vs_plain(q, kv, length, cursor, layer, prompt_cap):
        """Kernel against the plain version's f32 result on the same
        (bf16-exact) inputs; returns the max abs error, and records a
        failure where an element is off by more than the tolerance."""
        lw, wi = i32(length), i32(cursor)
        got = flash_gqa_decode_stacked(q, *kv, lw, wi, layer, prompt_cap)
        torch.cuda.synchronize()
        want = decode_attention_plain(
            q.float(), kv[0][layer:layer + 1].float(),
            kv[1][layer:layer + 1].float(), lw, wi, 0, prompt_cap)
        diff = (got.float() - want).abs()
        if not bool((diff <= DECODE_ATOL + DECODE_RTOL * want.abs()).all()):
            failures.append(f"flash_gqa_decode_stacked disagrees with plain "
                            f"at cursor {cursor}")
        errs.append(diff.max().item())
        return errs[-1]

    q = rnd(1, 16, 128)
    for prompt_cap, length, cursor in ((32, 31, 32), (32, 31, 47),
                                       (128, 117, 159), (128, 90, 1023)):
        err = decode_vs_plain(q, talker_kv, length, cursor, 7, prompt_cap)
        print(f"[kernel] flash_gqa_decode_stacked C=1024 prompt_cap="
              f"{prompt_cap} length={length} cursor={cursor} Dh=128: "
              f"max_abs_err={err:.3e} tol={tol}")
    qp = rnd(1, 16, 64)
    for cursor in (2, 9, 15):
        err = decode_vs_plain(qp, pred_kv, 0, cursor, 4, 0)
        print(f"[kernel] flash_gqa_decode_stacked C=17 cursor={cursor} "
              f"Dh=64 (predictor): max_abs_err={err:.3e} tol={tol}")
    lens, wi = i32(31), i32(48)     # bucket 32, 16 frames into a request
    ms = plain = 0.0
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            ms += cuda_ms(lambda i: flash_gqa_decode_stacked(
                q, *talker_kv, lens, wi, i % 28, 32)) / 2
        else:
            plain += cuda_ms(lambda i: decode_attention_plain(
                q, *talker_kv, lens, wi, i % 28, 32)) / 2
    mask = history_mask(lens, 32, wi, 1, 1024)
    qt = q[:, :, None]

    def decode_lib(i):
        return sdpa(qt, talker_kv[0][i % 28], talker_kv[1][i % 28],
                    attn_mask=mask[:, None], enable_gqa=True)

    lib = cuda_ms(decode_lib)
    dev_k = graph_ms(lambda i: flash_gqa_decode_stacked(
        q, *talker_kv, lens, wi, i % 28, 32))
    dev_l = graph_ms(decode_lib)
    slots = int(mask.sum())             # the visible slots are read
    b_ms, b_by = bound(2 * q.numel() * 2 + 2 * slots * 8 * 128 * 2,
                       4 * slots * 16 * 128, "bf16")
    print(f"[kernel] flash_gqa_decode_stacked C=1024 cursor=48 per layer: "
          f"{ms:.4f} ms, plain {plain:.4f} ms, torch sdpa {lib:.4f} ms, "
          f"bound {b_ms:.5f} ms ({b_by}); device time (CUDA graph of 20 "
          f"calls) kernel {dev_k:.4f} ms, sdpa {dev_l:.4f} ms")
    out["flash_gqa_decode_stacked"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, device_ms=dev_k,
        library_device_ms=dev_l)

    # the one-layer entry, flash_gqa_decode (the stacked wrapper's kernel on
    # the view k_all[layer]): scalar write_idx on layer 7's view at the
    # path's cursors and across the 64-slot chunk boundaries, per-lane
    # cursors on B = 4 and B = 32 layer caches
    errs1 = []
    split = fd.SPLIT

    def one_layer(q, kc, vc, lens, wi, prompt_cap, what):
        got = flash_gqa_decode(q, kc, vc, lens, wi, prompt_cap)
        torch.cuda.synchronize()
        wl = (wi if torch.is_tensor(wi) else
              torch.full((q.shape[0],), wi, dtype=torch.int32, device=dev))
        want = decode_layer_plain(q.float(), kc.float(), vc.float(), lens, wl,
                                  prompt_cap)
        diff = (got.float() - want).abs()
        if not bool((diff <= DECODE_ATOL + DECODE_RTOL * want.abs()).all()):
            failures.append(f"flash_gqa_decode disagrees with plain ({what})")
        errs1.append(diff.max().item())
        print(f"[kernel] flash_gqa_decode {what}: max_abs_err="
              f"{errs1[-1]:.3e} tol={tol}")

    for prompt_cap, length, cursor in (
            (32, 31, 48), (128, 90, 1023), (32, 31, 0), (32, 31, 1),
            (32, 31, split - 1), (32, 31, split), (32, 31, split + 1),
            (128, 117, 2 * split), (128, 117, 2 * split + 1)):
        one_layer(q, talker_kv[0][7], talker_kv[1][7], i32(length), cursor,
                  prompt_cap, f"C=1024 one layer, scalar write_idx={cursor} "
                  f"prompt_cap={prompt_cap} length={length}")
    kv4 = (rnd(28, 4, 8, 1024, 128), rnd(28, 4, 8, 1024, 128))
    lens4, wi4 = i32(31, 100, 117, 90), i32(128, 159, 600, 1023)
    q4 = rnd(4, 16, 128)
    one_layer(q4, kv4[0][3], kv4[1][3], lens4, wi4, 128,
              "B=4 C=1024 per-lane write_idx 128/159/600/1023")
    gq = torch.Generator().manual_seed(3)
    wi32 = torch.randint(0, 1024, (32,), generator=gq, dtype=torch.int32)
    kv32 = (rnd(32, 8, 1024, 128), rnd(32, 8, 1024, 128))
    one_layer(rnd(32, 16, 128), *kv32, i32(*[17 + 3 * i for i in range(32)]),
              wi32.to(dev), 128, f"B=32 C=1024 per-lane write_idx "
              f"{min(wi32.tolist())}-{max(wi32.tolist())}")
    del kv32

    def decode_timed(label, qd, kv, lens_, wi_, prompt_cap):
        """flash_gqa_decode on layer i % 28 of a stacked cache: CUDA events
        (plain, kernel, kernel, plain) and a CUDA graph of 20 calls (the
        device time without the wrapper's host enqueue), beside SDPA on
        the same inputs; the bound counts the visible slots."""
        ms = plain = 0.0
        for order in ("plain", "kernel", "kernel", "plain"):
            if order == "kernel":
                ms += cuda_ms(lambda i: flash_gqa_decode(
                    qd, kv[0][i % 28], kv[1][i % 28], lens_, wi_,
                    prompt_cap)) / 2
            else:
                plain += cuda_ms(lambda i: decode_layer_plain(
                    qd, kv[0][i % 28], kv[1][i % 28], lens_, wi_,
                    prompt_cap)) / 2
        mask = history_mask(lens_, prompt_cap, wi_, 1, kv[0].shape[3])

        def lib_call(i):
            return sdpa(qd[:, :, None], kv[0][i % 28], kv[1][i % 28],
                        attn_mask=mask[:, None], enable_gqa=True)

        lib = cuda_ms(lib_call)
        dev_k = graph_ms(lambda i: flash_gqa_decode(
            qd, kv[0][i % 28], kv[1][i % 28], lens_, wi_, prompt_cap))
        dev_l = graph_ms(lib_call)
        slots = int(mask.sum())             # the visible slots are read
        b_ms, b_by = bound(2 * qd.numel() * 2 + 2 * slots * 8 * 128 * 2,
                           4 * slots * 16 * 128, "bf16")
        print(f"[kernel] flash_gqa_decode {label} one layer: {ms:.4f} ms, "
              f"plain {plain:.4f} ms, torch sdpa {lib:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}); device time (CUDA graph of 20 calls) "
              f"kernel {dev_k:.4f} ms, sdpa {dev_l:.4f} ms "
              f"({dev_k / dev_l:.2f}x)")
        return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                    bound_by=b_by, device_ms=dev_k, library_device_ms=dev_l)

    shapes = {
        "b1_cursor48": decode_timed("C=1024 B=1 cursor=48", q, talker_kv,
                                    lens, wi, 32),
        "b1_cursor1023": decode_timed("C=1024 B=1 cursor=1023", q, talker_kv,
                                      i32(90), i32(1023), 128),
        "b4_per_lane": decode_timed("C=1024 B=4 cursors 128/159/600/1023",
                                    q4, kv4, lens4, wi4, 128)}
    del kv4
    head = shapes["b1_cursor48"]
    out["flash_gqa_decode"] = dict(max_abs_err=max(errs1), **head,
                                   shapes=shapes)
    return out


# the continued prefill's shapes (a prompt's suffix after a kept prefix):
# B = 1, (start, S, window); start is prefix_len, not a multiple of the
# kernel's 16-row query tile in general, S the suffix's 16-row cap, window
# the total bucket > S; the last is the stream phase's long-instruction
# request (prefix 95 rows, suffix cap 32, bucket 128)
PREFILL_CONTINUED = [(st, s, w) for st in (64, 192) for s in (16, 48)
                     for w in (128, 256) if st + s <= w] + [(95, 32, 128)]
PREFILL_CONTINUED_TIMED = ((64, 48, 128), (192, 48, 256))


def prefill_continued(dev, failures, rnd, i32):
    """flash_gqa_prefill_stacked at a start past 0 against
    prefill_attention_plain: one talker layer of a 1024-slot cache, the
    suffix's rows ragged (lengths = start + S - 5), and the stale rows of
    an earlier request in [start + S, window) poisoned with large values
    (they must stay masked: the kernel's output equals its output with
    the random rows there before, bit for bit).  Two shapes timed with CUDA events
    and in a CUDA graph beside SDPA.  Returns [{start, S, window, ...}]."""
    import torch
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked, prefill_attention_plain)
    from qwen3_tts_tpu_torch.ops.attention import history_mask
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    rows = []
    for start, s, window in PREFILL_CONTINUED:
        k, v = rnd(28, 1, 8, 1024, 128), rnd(28, 1, 8, 1024, 128)
        q = rnd(1, s, 16, 128)
        lens, st = i32(start + s - 5), i32(start)
        clean = flash_gqa_prefill_stacked(q, k, v, lens, st, 5, window,
                                          window)
        for t in (k, v):
            t[:, :, :, start + s:window] = 300.0
        got = flash_gqa_prefill_stacked(q, k, v, lens, st, 5, window, window)
        torch.cuda.synchronize()
        want = prefill_attention_plain(q, k, v, lens, st, 5, window, window)
        err = (got.float() - want.float()).abs().max().item()
        stale_hidden = bool(torch.equal(got, clean))
        row = dict(start=start, S=s, window=window, max_abs_err=err,
                   grid=list(flash_gqa_prefill_stacked.grid))
        timed = (start, s, window) in PREFILL_CONTINUED_TIMED
        if timed:
            ms = plain = 0.0
            for order in ("plain", "kernel", "kernel", "plain"):
                if order == "kernel":
                    ms += cuda_ms(lambda i: flash_gqa_prefill_stacked(
                        q, k, v, lens, st, i % 28, window, window)) / 2
                else:
                    plain += cuda_ms(lambda i: prefill_attention_plain(
                        q, k, v, lens, st, i % 28, window, window)) / 2
            mask = history_mask(lens, window, st, s, window)
            qt = q.transpose(1, 2)

            def lib(i):
                return sdpa(qt, k[i % 28, :, :, :window],
                            v[i % 28, :, :, :window],
                            attn_mask=mask[:, None], enable_gqa=True)

            lib_ms = cuda_ms(lib)
            dev_k = graph_ms(lambda i: flash_gqa_prefill_stacked(
                q, k, v, lens, st, i % 28, window, window))
            dev_l = graph_ms(lib)
            # bytes: q, the output, and each layer's k/v up to the last
            # row's causal end; operations: q.k and p.v over the live pairs
            live = start + s
            b_ms, b_by = bound(2 * q.numel() * 2 + 2 * 8 * live * 128 * 2,
                               4 * int(mask.sum()) * 16 * 128, "bf16")
            row.update(ms=ms, plain_ms=plain, library_ms=lib_ms,
                       device_ms=dev_k, library_device_ms=dev_l,
                       bound_ms=b_ms, bound_by=b_by)
        print(f"[kernel] flash_gqa_prefill_stacked continued: start={start} "
              f"S={s} window={window} length={start + s - 5} grid "
              f"{row['grid']}: max_abs_err={err:.3e} tol={PREFILL_TOL}; "
              f"stale rows [{start + s}, {window}) poisoned, output equal "
              f"to the clean cache's={stale_hidden}" + (
                  f"; {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                  f"torch sdpa {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.5f} ms ({row['bound_by']}); device "
                  f"time (CUDA graph of 20 calls) kernel "
                  f"{row['device_ms']:.4f} ms, sdpa "
                  f"{row['library_device_ms']:.4f} ms "
                  f"({row['device_ms'] / row['library_device_ms']:.2f}x)"
                  if timed else ""))
        if not err <= PREFILL_TOL:
            failures.append(f"flash_gqa_prefill_stacked disagrees with plain "
                            f"at start {start}, S {s}, window {window}")
        if not stale_hidden:
            failures.append(f"flash_gqa_prefill_stacked read stale rows at "
                            f"start {start}, S {s}, window {window}")
        rows.append(row)
        del k, v
    return rows


# the speculative verify forward's contract (runtime/spec.py): S = K draft
# rows a lane written mid-decode at the lane's own cursor, attending the
# whole live prefix (window = the cache's capacity C), B lanes of prompt
# bucket 32 (their cursors at or past it)
VERIFY_BATCHES, VERIFY_S, VERIFY_C, VERIFY_PROMPT = (4, 8), 4, 1024, 32


def prefill_verify(dev, failures, rnd, i32, b):
    """flash_gqa_prefill_stacked at the verify contract: B lanes, S =
    VERIFY_S rows each at its own start spread over [32, C - S], window
    C, prompt_cap VERIFY_PROMPT with ragged prompt lengths, one talker
    layer of a 28-layer cache; the stale rows past each lane's last row
    (an earlier request's, a rejected draft's) poisoned with large values:
    the output must equal the clean cache's bit for bit, and the plain
    version within PREFILL_TOL and PREFILL_ROW_TOL.  Timed with CUDA events
    and in a CUDA graph beside SDPA on the same inputs.  Returns {B, S,
    window, starts, max_abs_err, row_err, ms, plain_ms, library_ms,
    device_ms, library_device_ms, bound_ms, bound_by, grid}."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked, prefill_attention_plain)
    from qwen3_tts_tpu_torch.ops.attention import history_mask
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    s, c, pc = VERIFY_S, VERIFY_C, VERIFY_PROMPT
    rng = np.random.default_rng(b)
    starts = sorted(int(x) for x in rng.integers(32, c - s + 1, b))
    starts[0], starts[-1] = 32, c - s                   # both ends
    k, v = rnd(28, b, 8, c, 128), rnd(28, b, 8, c, 128)
    q = rnd(b, s, 16, 128)
    lens = i32(*[pc - int(rng.integers(0, 24)) for _ in starts])
    st = i32(*starts)
    args = (q, k, v, lens, st, 5, pc, c)
    clean = flash_gqa_prefill_stacked(*args)
    for lane, a in enumerate(starts):
        for t in (k, v):
            t[:, lane, :, a + s:] = 300.0
    got = flash_gqa_prefill_stacked(*args)
    torch.cuda.synchronize()
    grid = list(flash_gqa_prefill_stacked.grid)
    stale_hidden = bool(torch.equal(got, clean))
    want = prefill_attention_plain(*args)
    err = (got.float() - want.float()).abs().max().item()
    row_err = prefill_row_err(got, want)
    ms = plain = 0.0
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            ms += cuda_ms(lambda i: flash_gqa_prefill_stacked(
                q, k, v, lens, st, i % 28, pc, c)) / 2
        else:
            plain += cuda_ms(lambda i: prefill_attention_plain(
                q, k, v, lens, st, i % 28, pc, c), 8, 1) / 2
    mask = history_mask(lens, pc, st, s, c)
    qt = q.transpose(1, 2)

    def lib(i):
        return sdpa(qt, k[i % 28], v[i % 28], attn_mask=mask[:, None],
                    enable_gqa=True)

    lib_ms = cuda_ms(lib)
    dev_k = graph_ms(lambda i: flash_gqa_prefill_stacked(
        q, k, v, lens, st, i % 28, pc, c))
    dev_l = graph_ms(lib)
    # bytes: q, the output, and each lane's k/v up to its last row's
    # causal end (the live prefix); operations: q.k and p.v over the
    # visible pairs
    live = sum(a + s for a in starts)
    b_ms, b_by = bound(2 * q.numel() * 2 + 2 * 8 * live * 128 * 2,
                       4 * int(mask.sum()) * 16 * 128, "bf16")
    print(f"[kernel] flash_gqa_prefill_stacked verify: B={b} S={s} "
          f"window=C={c} prompt_cap={pc} starts {starts} lengths "
          f"{lens.tolist()} grid {grid}: max_abs_err={err:.3e} "
          f"tol={PREFILL_TOL}, row-scaled err {row_err:.3e} "
          f"tol={PREFILL_ROW_TOL:.4g}; stale rows past each lane poisoned, "
          f"output equal to the clean cache's={stale_hidden}; {ms:.4f} ms, "
          f"plain {plain:.4f} ms, torch sdpa {lib_ms:.4f} ms, bound "
          f"{b_ms:.5f} ms ({b_by}); device time (CUDA graph of 20 calls) "
          f"kernel {dev_k:.4f} ms, sdpa {dev_l:.4f} ms "
          f"({dev_k / dev_l:.2f}x), {dev_k / b_ms:.1f}x the bound")
    if not (err <= PREFILL_TOL and row_err <= PREFILL_ROW_TOL):
        failures.append(f"flash_gqa_prefill_stacked disagrees with plain at "
                        f"the verify contract, B {b}")
    if not stale_hidden:
        failures.append(f"flash_gqa_prefill_stacked read stale rows at the "
                        f"verify contract, B {b}")
    return dict(B=b, S=s, window=c, starts=starts, max_abs_err=err,
                row_err=row_err, ms=ms, plain_ms=plain, library_ms=lib_ms,
                device_ms=dev_k, library_device_ms=dev_l, bound_ms=b_ms,
                bound_by=b_by, grid=grid)


# the clone prompts' lengths: a 30 s reference gives bucket 512, and a
# prompt that fills the context RuntimeConfig.max_prompt_len = 4096
PREFILL_CLONE_S = (512, 4096)


def prefill_row_err(got, want):
    """max over (lane, row, head) of max_d |got - want| / RMS_d(want)."""
    got, want = got.float(), want.float()
    rms = want.square().mean(-1).sqrt().clamp_min(1e-12)
    return ((got - want).abs().amax(-1) / rms).max().item()


def prefill_dropped_tile_err(q, k, v, lens, s, row, want_row):
    """prefill_row_err of row `row` of the plain prefill against the same
    row with one K/V tile (64 slots, mid-history) left out of its mask:
    what a kernel that skipped that tile would show."""
    from qwen3_tts_tpu_torch.ops.attention import gqa_attend, history_mask
    mask = history_mask(lens, s, 0, s, s)[:, row:row + 1].clone()
    t0 = (row // 64 // 2) * 64
    mask[..., t0:t0 + 64] = False
    dropped = gqa_attend(q[:, row:row + 1], k[0], v[0], mask)
    return prefill_row_err(dropped, want_row)


def prefill_clone(dev, failures, rnd, i32, s):
    """flash_gqa_prefill_stacked on a whole clone prompt: B = 1, S rows,
    window S, length S - 7, one talker layer of an S-slot cache, against
    prefill_attention_plain (f32 scores: 1 GB at S = 4096); timed with
    CUDA events and in a CUDA graph beside SDPA on the same inputs.
    Returns {max_abs_err, ms, plain_ms, library_ms, device_ms,
    library_device_ms, bound_ms, bound_by, grid}."""
    import torch
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked, prefill_attention_plain)
    from qwen3_tts_tpu_torch.ops.attention import history_mask
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    k, v = rnd(1, 1, 8, s, 128), rnd(1, 1, 8, s, 128)
    q = rnd(1, s, 16, 128)
    lens, st = i32(s - 7), i32(0)
    args = (q, k, v, lens, st, 0, s, s)
    got = flash_gqa_prefill_stacked(*args)
    torch.cuda.synchronize()
    grid = list(flash_gqa_prefill_stacked.grid)
    want = prefill_attention_plain(*args)
    err = (got.float() - want.float()).abs().max().item()
    row_err = prefill_row_err(got, want)
    # the row-scaled check must see a K/V tile left out of a long row
    r = s - 96
    drop_err = prefill_dropped_tile_err(q, k, v, lens, s, r,
                                        want[:, r:r + 1])
    del got, want
    ms = plain = 0.0
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            ms += cuda_ms(lambda i: flash_gqa_prefill_stacked(*args)) / 2
        else:
            plain += cuda_ms(lambda i: prefill_attention_plain(*args),
                             2, 1) / 2
    mask = history_mask(lens, s, st, s, s)
    qt, kl, vl = q.transpose(1, 2), k[0], v[0]

    def lib(i):
        return sdpa(qt, kl, vl, attn_mask=mask[:, None], enable_gqa=True)

    lib_ms = cuda_ms(lib)
    dev_k = graph_ms(lambda i: flash_gqa_prefill_stacked(*args))
    dev_l = graph_ms(lib)
    b_ms, b_by = bound(nbytes((q, kl, vl)) + q.numel() * 2,
                       4 * int(mask.sum()) * 16 * 128, "bf16")
    print(f"[kernel] flash_gqa_prefill_stacked clone prompt S={s} window={s} "
          f"length={s - 7} one layer, grid (CTAs, warps each) {grid}: "
          f"max_abs_err={err:.3e}, row-scaled err (max |err| / row RMS, "
          f"per row and head) {row_err:.3e} tol={PREFILL_ROW_TOL:.4g}; "
          f"row {r} with one K/V tile left out gives {drop_err:.3e}; "
          f"{ms:.4f} ms, plain "
          f"{plain:.4f} ms, torch sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}); device time (CUDA graph of 20 calls) kernel "
          f"{dev_k:.4f} ms, sdpa {dev_l:.4f} ms ({dev_k / dev_l:.2f}x), "
          f"{dev_k / b_ms:.1f}x the bound")
    if not (err <= PREFILL_TOL and row_err <= PREFILL_ROW_TOL):
        failures.append(f"flash_gqa_prefill_stacked disagrees with plain at "
                        f"S {s}")
    if not drop_err > PREFILL_ROW_TOL:
        failures.append(f"the row-scaled prefill check cannot see a K/V "
                        f"tile left out at S {s}: {drop_err:.3e}")
    return dict(max_abs_err=err, row_err=row_err, dropped_tile_err=drop_err,
                ms=ms, plain_ms=plain, library_ms=lib_ms,
                device_ms=dev_k, library_device_ms=dev_l, bound_ms=b_ms,
                bound_by=b_by, grid=grid)


def check_talker_step(dev, failures):
    """talker_step_fused against talker_step_plain at full width."""
    import dataclasses

    import torch
    from qwen3_tts_tpu_torch import EngineConfig
    from qwen3_tts_tpu_torch.kernels.talker_step import (
        prep_layer_weights, talker_step_fused, talker_step_plain)
    from qwen3_tts_tpu_torch.models import talker as talker_lib
    from qwen3_tts_tpu_torch.models.transformer import init_decoder_params

    cfg = EngineConfig().talker
    g = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        w = prep_layer_weights(cfg, init_decoder_params(cfg, g))
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, 1024, cfg.head_dim)
    kv = [(torch.randn(shape, generator=g, device=dev) * 0.5).to(
        torch.bfloat16) for _ in range(2)]
    x = (torch.randn(1, cfg.d_model, generator=g, device=dev) * 0.5).to(
        torch.bfloat16)

    def i32(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    def rope(pos):
        cos, sin = talker_lib._rope_tables(
            cfg, talker_lib._pos4(torch.tensor([[pos]], device=dev)))
        return cos[:, 0].contiguous(), sin[:, 0].contiguous()

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item()

    errs = {}
    for prompt_cap, length, cursor in ((32, 31, 32), (32, 31, 47),
                                       (128, 117, 159), (128, 90, 1023)):
        cos, sin = rope(cursor)
        for depth, tol in ((1, STEP_TOL_LAYER), (cfg.n_layers, STEP_TOL_STEP)):
            cd = dataclasses.replace(cfg, n_layers=depth)
            wd = {k: v[:depth] for k, v in w.items()}
            caches = [[t[:depth].clone() for t in kv] for _ in range(2)]
            args = (cos, sin)
            got = talker_step_fused(cd, wd, x, *args, *caches[0], i32(length),
                                    i32(cursor), prompt_cap)
            torch.cuda.synchronize()
            want = talker_step_plain(cd, wd, x, *args, *caches[1],
                                     i32(length), i32(cursor), prompt_cap)
            e_h = rel(got, want)
            errs[(depth, cursor)] = (got.float() - want.float()).abs().max(
            ).item()
            e_kv = max(rel(a[:, :, :, cursor], b[:, :, :, cursor])
                       for a, b in zip(*caches))
            keep = torch.arange(1024, device=dev) != cursor
            same = all(torch.equal(a[:, :, :, keep], t[:depth][:, :, :, keep])
                       for a, t in zip(caches[0], kv))
            print(f"[kernel] talker_step_fused L={depth} C=1024 prompt_cap="
                  f"{prompt_cap} length={length} cursor={cursor}: hidden "
                  f"rel_err={e_h:.3e} written k/v rel_err={e_kv:.3e} "
                  f"tol={tol} other slots untouched={same} "
                  f"max|hidden|={want.float().abs().max().item():.3f}")
            if not (e_h <= tol and e_kv <= tol and same
                    and bool(torch.isfinite(got.float()).all())):
                failures.append(f"talker_step_fused disagrees with plain at "
                                f"L={depth} cursor={cursor}")
    cos, sin = rope(48)
    lens, wi = i32(31), i32(48)        # bucket 32, 16 frames into a request
    ms = plain = 0.0
    for order in ("plain", "kernel", "kernel", "plain"):
        fn = talker_step_fused if order == "kernel" else talker_step_plain
        # the plain step (~150 ms) once a turn: its time is no yardstick
        t = cuda_ms(lambda i: fn(cfg, w, x, cos, sin, *kv, lens, wi, 32),
                    *((10, 3) if order == "kernel" else (1, 1)))
        if order == "kernel":
            ms += t / 2
        else:
            plain += t / 2
    # weights, x in and out, rope rows, the 48 visible k/v slots of each
    # layer and the written row; 2 int8 ops per int4 weight
    n_w = sum(w[k].numel() * 2 for k in ("wqkv_q", "wo_q", "gu_q", "dn_q"))
    b_ms, b_by = bound(nbytes(w.values()) + 2 * x.numel() * 2
                       + nbytes((cos, sin))
                       + cfg.n_layers * 2 * 49 * 8 * 128 * 2,
                       2 * n_w, "int8")
    g_ms = graph_ms(lambda i: talker_step_fused(cfg, w, x, cos, sin, *kv,
                                                lens, wi, 32), n=10)
    print(f"[kernel] talker_step_fused 28 layers C=1024 cursor=48: "
          f"{ms:.4f} ms (events), {g_ms:.4f} ms (graph), one launch of "
          f"{talker_step_fused.grid} blocks; plain {plain:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}, {b_ms / g_ms:.1%} of it reached), no "
          f"single PyTorch call")
    return dict(max_abs_err=max(errs.values()), ms=ms, graph_ms=g_ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


INT4_SHAPES = ((2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048))
# matmul_int4 against matmul_int4_plain: the same bf16 dequantized weights
# and bf16 x, f32 sums in another order
INT4_TOL = 1e-4
# M held (both kernels: both sides of TILE_MIN_M, ragged row tiles) and
# timed (decode, the prompt bucket 32, the largest bucket)
INT4_MS = (1, 2, 3, 4, 8, 16, 17, 32, 64, 128, 129)
INT4_TIMED_MS = (1, 32, 128)


def check_int4(dev, failures):
    """matmul_int4 against matmul_int4_plain at the talker's four weight
    shapes, at M on both sides of the crossover and ragged (INT4_MS),
    within INT4_TOL of max |y|; timed at INT4_TIMED_MS beside torch.matmul
    on the pre-dequantized bf16 weight (library_ms), with CUDA events and
    in a CUDA graph, with enough weight copies in turn that they do not
    sit in the 50 MB L2 between launches.  Returns the kernels line's
    entries: matmul_int4 at M = 1 (the small-M kernel) and
    matmul_int4_tile at M = 32 (the tile kernel at the prompt bucket, the
    shape the int4 path's prefill gives it), both at 2048 x 12288, with
    every timed shape under `shapes`.  (scripts/torch_int4_sweep.py
    --crossover times the two kernels against each other.)"""
    import torch
    from qwen3_tts_tpu_torch.kernels import int4_matmul as ti
    from qwen3_tts_tpu_torch.kernels.int4_matmul import (
        _dequant_bf16, matmul_int4, matmul_int4_plain)
    from qwen3_tts_tpu_torch.ops.quant import quantize_weight_int4

    g = torch.Generator(device=dev).manual_seed(7)
    shapes, worst, worst_tile = {}, 0.0, 0.0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for k, n in INT4_SHAPES:
        w = quantize_weight_int4(torch.randn(k, n, generator=g, device=dev)
                                 * k ** -0.5)
        wb = nbytes(w.values())
        copies = [w] + [{key: t.clone() for key, t in w.items()}
                        for _ in range(max(0, math.ceil(64e6 / wb) - 1))]
        dense = [_dequant_bf16(c) for c in copies[:max(2, math.ceil(
            64e6 / (k * n * 2)))]]
        errs, row = {}, {}
        for m in INT4_MS:
            x = (torch.randn(m, k, generator=g, device=dev) * 0.5).to(
                torch.bfloat16)
            got = matmul_int4(x, w)
            torch.cuda.synchronize()
            want = matmul_int4_plain(x, w)
            err = ((got - want).abs().max() / want.abs().max()).item()
            errs[m] = err
            worst = max(worst, err)
            if m >= ti.TILE_MIN_M:
                worst_tile = max(worst_tile, err)
            if not (err <= INT4_TOL and bool(torch.isfinite(got).all())):
                failures.append(f"matmul_int4 disagrees with plain at "
                                f"{k}x{n} M={m}")
            if m not in INT4_TIMED_MS:
                continue
            ms = plain = 0.0
            for order in ("plain", "kernel", "kernel", "plain"):
                fn = matmul_int4 if order == "kernel" else matmul_int4_plain
                t = cuda_ms(lambda i: fn(x, copies[i % len(copies)]))
                if order == "kernel":
                    ms += t / 2
                else:
                    plain += t / 2
            lib = cuda_ms(lambda i: torch.matmul(x, dense[i % len(dense)]))
            dev_k = graph_ms(lambda i: matmul_int4(x, copies[i % len(copies)]))
            dev_l = graph_ms(lambda i: torch.matmul(x, dense[i % len(dense)]))
            b_ms, b_by = bound(wb + x.numel() * 2 + m * n * 4,
                               2 * m * k * n, "bf16")
            mi, splits = ti.plan(m, n, k, sms)
            row[m] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                          bound_ms=b_ms, bound_by=b_by, rel_err=err,
                          device_ms=dev_k, library_device_ms=dev_l,
                          kernel="small" if mi == 0 else
                          f"tile BM={32 * mi} splits={splits}")
            print(f"[kernel] matmul_int4 K={k} N={n} M={m} "
                  f"({row[m]['kernel']}): rel_err={err:.3e} tol={INT4_TOL}; "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, torch matmul on the "
                  f"bf16 dequantized weight {lib:.4f} ms, bound {b_ms:.5f} "
                  f"ms ({b_by}); device time (CUDA graph) kernel "
                  f"{dev_k:.4f} ms, torch matmul {dev_l:.4f} ms "
                  f"({dev_k / dev_l:.2f}x); {len(copies)} weight copies in "
                  f"turn")
        print(f"[kernel] matmul_int4 K={k} N={n}: rel_err by M {errs} "
              f"(tol {INT4_TOL})")
        shapes[f"{k}x{n}"] = row
        del copies, dense

    def entry(m, err):
        head = shapes["2048x12288"][m]
        return dict(max_abs_err=err, **{
            key: head[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "device_ms", "library_device_ms")})
    return {"matmul_int4": dict(entry(1, worst), shapes=shapes),
            "matmul_int4_tile": dict(entry(32, worst_tile),
                                     kernel=shapes["2048x12288"][32][
                                         "kernel"])}


# The talker step's int8, w8a8 and bf16 modes against chunk_step's plain
# talker in the kernel's orders (KERNEL_ORDERS: the norms' sums, the
# attention's 64-slot splits and its q . k dots; the int8 and bf16 f32
# dots in the kernel's lane order, qmm8_lanes_plain), layer by layer from
# the kernel's own state.  What is left to differ: sums the replay takes in
# f64 or in torch's order (an fma, a softmax's exp), which flip a bf16
# rounding now and then.  w8a8 quantizes
# each row as w4a8 does, so a flip moves an int8 unit (as in w4a8, PR 5:
# 94.6-98.2 % of pairs exact); int8 and bf16 carry a flip as a small
# bf16 difference into later GEMVs, whose products then all differ a
# little.  At least MODE_EXACT_SHARE of the (layer, lane) pairs exact,
# each within STEP_TOL_LAYER.
MODE_EXACT_SHARE = {"int8": 0.5, "bf16": 0.5, "w8a8": 0.9}


def check_talker_modes(dev, failures):
    """talker_step_fused in the int8, w8a8 and bf16 weight modes at full
    width (28 layers, C = 1024): B = 1 (uniform cursor 48, bucket 32) and
    B = 8 and 32 (ragged per-lane cursors, uniform_cursor=False).  Each
    lane of B > 1 bit-equal to the one-lane kernel; each lane alone against
    chunk_step._talker_plain in the kernel's orders (KERNEL_ORDERS, the
    int8 and bf16 dots in its lane order; MODE_EXACT_SHARE's comment) within
    STEP_TOL_LAYER at one layer and layer by layer over 28; the end-to-end
    difference printed.  Each B timed beside talker_step_plain (the JAX
    `_qmm` numerics) and the bound of the bytes it must move."""
    import dataclasses

    import torch
    from qwen3_tts_tpu_torch import EngineConfig
    from qwen3_tts_tpu_torch.kernels import chunk_step as cs
    from qwen3_tts_tpu_torch.kernels.talker_step import (
        prep_layer_weights, talker_step_fused, talker_step_plain)
    from qwen3_tts_tpu_torch.models import talker as talker_lib
    from qwen3_tts_tpu_torch.models.transformer import init_decoder_params

    cfg = EngineConfig().talker
    n_layers, cap = cfg.n_layers, 1024
    g = torch.Generator(device=dev).manual_seed(8)
    with torch.no_grad():
        params = init_decoder_params(cfg, g)

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.5).to(
            torch.bfloat16)

    def i32(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    def rope(positions):
        p = torch.tensor(positions, device=dev)[:, None]
        cos, sin = talker_lib._rope_tables(cfg, talker_lib._pos4(p))
        return cos[:, 0].contiguous(), sin[:, 0].contiguous()

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item()

    out = {}
    for mode in ("int8", "w8a8", "bf16"):
        with torch.no_grad():
            w = prep_layer_weights(cfg, params, mode)
        res = {}
        for b in (1, 8, 32):
            kv = [rnd(n_layers, b, cfg.n_kv_heads, cap, cfg.head_dim)
                  for _ in range(2)]
            x = rnd(b, cfg.d_model)
            if b == 1:
                pcap, cursors, lengths, uniform = 32, [48], [31], True
            else:
                pcap, uniform = 128, False
                pcaps = [32 if i % 2 else 128 for i in range(b)]
                cursors = [pc + (97 * i) % (cap - pc)
                           for i, pc in enumerate(pcaps)]
                lengths = [pc - 1 - (7 * i) % 20 for i, pc in enumerate(pcaps)]
            cos, sin = rope(cursors)
            lens, wi = i32(lengths), i32(cursors)
            lanes, st = torch.arange(b, device=dev), wi.long()

            def lane_args(i, src):
                return (tuple(t[i:i + 1].clone() for t in (src, cos, sin)),
                        lens[i:i + 1].clone(), wi[i:i + 1].clone())

            # one layer: each lane against the one-lane kernel and the plain
            # talker in the kernel's orders on that lane alone
            c1 = dataclasses.replace(cfg, n_layers=1)
            w1 = {k: t[:1] for k, t in w.items()}
            cache = [t[:1].clone() for t in kv]
            got = talker_step_fused(c1, w1, x, cos, sin, *cache, lens, wi,
                                    pcap, uniform_cursor=uniform, mode=mode)
            torch.cuda.synchronize()
            one_lane, e1 = True, []
            for i in range(b):
                (args, li, wl) = lane_args(i, x)
                mine, tiled = ([t[:1, i:i + 1].clone() for t in kv]
                               for _ in range(2))
                one = talker_step_fused(c1, w1, *args, *mine, li, wl, pcap,
                                        mode=mode)
                c = cursors[i]
                alt = cs._talker_plain(c1, w1, *args, *tiled, li, c, 0, pcap,
                                       128, mode=mode,
                                       orders=cs.KERNEL_ORDERS)
                one_lane = (one_lane and torch.equal(got[i], one[0])
                            and all(torch.equal(a[:, i, :, c], m_[:, 0, :, c])
                                    for a, m_ in zip(cache, mine)))
                e1.append(max(rel(got[i:i + 1], alt),
                              *(rel(a[:, i, :, c], p_[:, 0, :, c])
                                for a, p_ in zip(cache, tiled))))
            # layer by layer from the kernel's own state; the end to end
            # difference of the 28-layer step, printed
            cache, outs, rows = [t.clone() for t in kv], [x], []
            for d in range(1, n_layers + 1):
                outs.append(talker_step_fused(
                    dataclasses.replace(cfg, n_layers=d),
                    {k: t[:d] for k, t in w.items()}, x, cos, sin,
                    *(a[:d] for a in cache), lens, wi, pcap,
                    uniform_cursor=uniform, mode=mode))
                rows.append([a[d - 1][lanes, :, st].clone() for a in cache])
            del cache
            per_layer = []
            for layer in range(n_layers):
                wl_ = {k: t[layer:layer + 1] for k, t in w.items()}
                for i, c in enumerate(cursors):
                    tiled = [t[layer:layer + 1, i:i + 1].clone() for t in kv]
                    (args, li, _) = lane_args(i, outs[layer])
                    alt = cs._talker_plain(c1, wl_, *args, *tiled, li, c, 0,
                                           pcap, 128, mode=mode,
                                           orders=cs.KERNEL_ORDERS)
                    per_layer.append(max(
                        rel(outs[layer + 1][i:i + 1], alt),
                        *(rel(r[i], p_[0, 0, :, c])
                          for r, p_ in zip(rows[layer], tiled))))
            e2e = []
            for i, c in enumerate(cursors):
                tiled = [t[:, i:i + 1].clone() for t in kv]
                (args, li, _) = lane_args(i, x)
                # printed only: torch's orders (the replay of the kernel's
                # is held layer by layer above)
                alt = cs._talker_plain(cfg, w, *args, *tiled, li, c, 0, pcap,
                                       128, mode=mode)
                e2e.append(rel(outs[-1][i:i + 1], alt))
            n_pairs = len(per_layer)
            n_exact = sum(e == 0 for e in per_layer)
            ok = (one_lane and max(e1) <= STEP_TOL_LAYER
                  and max(per_layer) <= STEP_TOL_LAYER
                  and n_exact >= MODE_EXACT_SHARE[mode] * n_pairs
                  and all(bool(torch.isfinite(o.float()).all())
                          for o in outs))
            if not ok:
                failures.append(f"talker_step_fused ({mode}) B={b} disagrees "
                                "with the plain talker")
            # timing: the kernel and talker_step_plain in turns
            ms = pl = 0.0
            for order in ("plain", "kernel", "kernel", "plain"):
                if order == "kernel":
                    ms += cuda_ms(lambda i: talker_step_fused(
                        cfg, w, x, cos, sin, *kv, lens, wi, pcap,
                        uniform_cursor=uniform, mode=mode), iters=10) / 2
                else:
                    pl += cuda_ms(lambda i: talker_step_plain(
                        cfg, w, x, cos, sin, *kv, lens, wi, pcap, mode),
                        1, 1) / 2
            g_ms = graph_ms(lambda i: talker_step_fused(
                cfg, w, x, cos, sin, *kv, lens, wi, pcap,
                uniform_cursor=uniform, mode=mode), n=10)
            visible = sum(min(ln, c) + max(0, c - pcap) + 1
                          for ln, c in zip(lengths, cursors))
            n_w = sum(w[k].numel() for k in ("wqkv_q", "wo_q", "gu_q",
                                              "dn_q"))
            b_ms, b_by = bound(nbytes(w.values()) + 2 * x.numel() * 2
                               + nbytes((cos, sin)) + n_layers * 2 * visible
                               * cfg.n_kv_heads * cfg.head_dim * 2,
                               2 * n_w * b,
                               "int8" if mode == "w8a8" else "bf16")
            res[b] = dict(ms=ms, graph_ms=g_ms, plain_ms=pl, bound_ms=b_ms,
                          bound_by=b_by,
                          exact_pairs=f"{n_exact}/{n_pairs}",
                          max_layer_err=max(per_layer), end_to_end=max(e2e))
            print(f"[kernel] talker_step_fused mode={mode} B={b} "
                  f"{'uniform cursor' if uniform else 'per-lane'} C={cap} "
                  f"cursors {min(cursors)}-{max(cursors)}: each lane "
                  f"bit-equal to the 1-lane kernel={one_lane}; one layer, "
                  f"each lane alone against the plain talker in the kernel's "
                  f"orders: max {max(e1):.3e} (tol {STEP_TOL_LAYER}); "
                  f"{n_layers} layers one by one from the kernel's state: "
                  f"{n_exact} of {n_pairs} (layer, lane) exact (at least "
                  f"{MODE_EXACT_SHARE[mode]}), max {max(per_layer):.3e}, the "
                  f"others {sorted(f'{e:.1e}' for e in per_layer if e)[-6:]} "
                  f"(largest 6); end to end against torch's orders "
                  f"(printed) max {max(e2e):.3e}; "
                  f"{ms:.4f} ms per step (events), {g_ms:.4f} ms (graph), "
                  f"plain {pl:.2f} ms, bound {b_ms:.4f} ms ({b_by}, "
                  f"{b_ms / g_ms:.1%} of it reached)")
            del kv, outs, rows
        out[mode] = res
        del w
    return out


def check_predictor_frame(dev, failures):
    """predict_frame_fused against predict_frame_plain at full width, at
    B = 1 (three draws) and at the serving batches 8 and 32 (one launch
    for all lanes), lane by lane; timed at B = 1, 8 and 32."""
    import torch
    from qwen3_tts_tpu_torch import EngineConfig
    from qwen3_tts_tpu_torch.kernels.predictor_frame import (
        predict_frame_fused, predict_frame_plain, prep_predictor_weights)
    from qwen3_tts_tpu_torch.models.predictor import init_predictor_params

    cfg = EngineConfig().predictor
    g = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():
        w = prep_predictor_weights(cfg, init_predictor_params(cfg, g))
    tables = (torch.randn(16, 2048, cfg.d_model, generator=g, device=dev)
              * 0.3).to(torch.bfloat16)
    worst, equal, compared = 0.0, 0, 0
    for case, b in enumerate((1, 1, 1, 8, 32)):
        h = torch.randn(b, cfg.d_model, generator=g, device=dev)
        c0 = ((torch.arange(b, device=dev) * 977 + 5 + 311 * case)
              % 2048).to(torch.int32)
        tk, tp = [], []
        got = predict_frame_fused(cfg, w, h, c0, tables, taps=tk)
        torch.cuda.synchronize()
        want = predict_frame_plain(cfg, w, h, c0, tables, taps=tp)
        got, want = got.cpu(), want.cpu()
        tk, tp = [t.cpu() for t in tk], [t.cpu() for t in tp]
        # per lane: code 0 exact; window logits within PRED_LOGIT_TOL of
        # max |plain| while the codes agree; a code may flip only at a plain
        # top-2 gap <= PRED_GAP, after which the lane follows another code
        # and its comparison stops
        ok = torch.equal(got[:, 0], want[:, 0])
        flips, case_rel = [], 0.0
        for lane in range(b):
            for t in range(1, 16):
                ref = tp[t - 1][lane]
                err = (tk[t - 1][lane] - ref).abs().max().item()
                err_rel = err / ref.abs().max().item()
                worst, case_rel = max(worst, err), max(case_rel, err_rel)
                ok = ok and err_rel <= PRED_LOGIT_TOL
                compared += 1
                if got[lane, t] != want[lane, t]:
                    top2 = ref.topk(2).values
                    gap = (top2[0] - top2[1]).item()
                    flips.append((lane, t, round(gap, 5)))
                    ok = ok and gap <= PRED_GAP
                    break
                equal += 1
        print(f"[kernel] predict_frame_fused L={cfg.n_layers} D={cfg.d_model}"
              f" B={b} (case {case}): lane by lane, flips (lane, token, "
              f"plain top-2 gap) {flips} (gap tol {PRED_GAP}); window logits "
              f"while the codes agree: max over max|plain| {case_rel:.3e} "
              f"(tol {PRED_LOGIT_TOL}); max_abs_err so far {worst:.3e}")
        if not ok:
            failures.append(f"predict_frame_fused disagrees with plain at "
                            f"B={b} (case {case})")
    if equal < 2 * compared // 3:
        failures.append(f"predict_frame_fused: only {equal} of {compared} "
                        "codes compared equal")
    print(f"[kernel] predict_frame_fused: {equal} of {compared} codes "
          f"compared equal over B = 1, 1, 1, 8, 32")
    # one frame at B = 1 (events: the kernel and the plain version in
    # turns), and the kernel at B = 1, 8 and 32 in events and in a CUDA
    # graph, with its launches per frame (one for all B lanes)
    n_w = sum(w[k].numel() for k in ("wqkv_q", "wo_q", "gu_q", "dn_q"))
    w_bytes = nbytes(w.values())
    # the layers streamed once per token, 15 head windows: the floor of a
    # design that cannot keep 75.5 MB of layers in a 50 MB L2
    floor_ms = (16 * nbytes([w[k] for k in w if k.endswith(("_q", "_s"))
                             and not k.startswith("head")])
                + nbytes((w["head_q"], w["head_s"])) * 15 / 15) \
        / HBM_BPS * 1e3
    res = {}
    for b in (1, 8, 32):
        h = torch.randn(b, cfg.d_model, generator=g, device=dev)
        c0 = ((torch.arange(b, device=dev) * 131 + 7) % 2048).to(torch.int32)
        before = predict_frame_fused.launches
        ms = plain = 0.0
        for order in (("plain", "kernel", "kernel", "plain") if b == 1
                      else ("kernel",)):
            if order == "kernel":
                ms += cuda_ms(lambda i: predict_frame_fused(
                    cfg, w, h, c0, tables), iters=10) / (2 if b == 1 else 1)
            else:               # the plain frame (~170 ms) once a turn
                plain += cuda_ms(lambda i: predict_frame_plain(
                    cfg, w, h, c0, tables), 1, 1) / 2
        calls = predict_frame_fused.launches - before
        g_ms = graph_ms(lambda i: predict_frame_fused(cfg, w, h, c0, tables),
                        n=10)
        # weights and lm-head read once, 15 table rows, h in, codes out;
        # 16 tokens of bf16 x int8 products over the layers, 15 windows
        b_ms, b_by = bound(w_bytes + 15 * cfg.d_model * 2 * b
                           + h.numel() * 4 + 16 * 4 * b,
                           2 * b * (16 * n_w + 15 * 2048 * cfg.d_model),
                           "bf16")
        res[b] = dict(ms=ms, graph_ms=g_ms, plain_ms=plain if b == 1 else None,
                      bound_ms=b_ms, bound_by=b_by)
        print(f"[kernel] predict_frame_fused one frame (16 tokens x "
              f"{cfg.n_layers} layers) B={b}: {ms:.4f} ms (events), "
              f"{g_ms:.4f} ms (graph); {calls} calls, one launch each for "
              f"all {b} lanes ({predict_frame_fused.grid} blocks)"
              f"{f', plain {plain:.4f} ms' if b == 1 else ''}; bound "
              f"{b_ms:.4f} ms ({b_by}, the weights read once; "
              f"{b_ms / g_ms:.1%} of it reached), streamed floor "
              f"{floor_ms:.4f} ms ({floor_ms / g_ms:.1%}), no single "
              f"PyTorch call")
        frames = (10 + 3) * (2 if b == 1 else 1)   # cuda_ms: 3 + 10 each
        if calls != frames:
            failures.append(f"predict_frame_fused: {calls} launches for "
                            f"{frames} frames at B={b}")
    return dict(max_abs_err=worst, ms=res[1]["ms"], graph_ms=res[1]["graph_ms"],
                plain_ms=res[1]["plain_ms"], bound_ms=res[1]["bound_ms"],
                bound_by=res[1]["bound_by"], library_ms=None,
                streamed_floor_ms=floor_ms,
                batched={f"b{b}": r for b, r in res.items() if b > 1})


def check_chunk(dev, failures):
    """gen_chunk_fused against gen_chunk_plain at full width (B = 1, F = 4,
    C = 1024, and C = 5120 at prompt_cap 4096), and the in-kernel sampler
    alone against its plain version."""
    import torch
    from qwen3_tts_tpu_torch import EngineConfig
    from qwen3_tts_tpu_torch.io.assets import Assets
    from qwen3_tts_tpu_torch.kernels import chunk_step as cs
    from qwen3_tts_tpu_torch.kernels.talker_step import prep_layer_weights
    from qwen3_tts_tpu_torch.models import predictor as predictor_lib
    from qwen3_tts_tpu_torch.models import talker as talker_lib
    from qwen3_tts_tpu_torch.ops.sampling import sample_threshold

    cfg = EngineConfig()
    tcfg, pcfg = cfg.talker, cfg.predictor
    n_frames, cap = 4, 1024
    g = torch.Generator(device=dev).manual_seed(3)
    with torch.no_grad():
        tp = talker_lib.init_talker_params(tcfg, g)
        pp = predictor_lib.init_predictor_params(pcfg, g)
        pack = Assets.random_init(g, dtype=torch.bfloat16).pack()
        tw = prep_layer_weights(tcfg, tp)
        pw = cs.prep_predictor_w4(pcfg, pp)
        ex = cs.prep_chunk_extras(tcfg, pcfg, tp, pp, pack)
    del tp, pp
    shape = (tcfg.n_layers, 1, tcfg.n_kv_heads, cap, tcfg.head_dim)
    kv = [(torch.randn(shape, generator=g, device=dev) * 0.5).to(
        torch.bfloat16) for _ in range(2)]
    logits0 = torch.randn(1, cs.V_CODEC, generator=g, device=dev) * 2.0
    hidden0 = torch.randn(1, tcfg.d_model, generator=g, device=dev)
    greedy = (0.0, 40, 0.9)
    sampled = (SAMPLED["temperature"], SAMPLED["top_k"], SAMPLED["top_p"])

    def i32(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    def inputs(n, start):
        p = start + torch.arange(n, device=dev)[:, None]
        cos, sin = talker_lib._rope_tables(tcfg, talker_lib._pos4(p))
        return cos.float().contiguous(), sin.float().contiguous()

    def run(fn, n, prompt_cap, length, start, u, sampler, state=None,
            cache=None, **kw):
        lg, hd, k, v = ((logits0, hidden0, *(cache or kv)) if state is None
                        else state)
        k, v = k.clone(), v.clone()
        out = fn(tcfg, pcfg, tw, pw, ex, lg, hd, k, v, i32(length),
                 i32(start), *inputs(n, start), u, sampler, prompt_cap, **kw)
        torch.cuda.synchronize()
        return (*out, k, v)

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item()

    def errs_of(a, b, ta, tb, row):
        """rel err of a against b: window logits, logits, hidden, the
        written k/v rows of every layer."""
        return (max(rel(x, y) for x, y in zip(ta, tb)),
                rel(a[1], b[1]), rel(a[2], b[2]),
                max(rel(x[:, :, :, row], y[:, :, :, row])
                    for x, y in zip(a[3:], b[3:])))

    def all_but(rows, c=cap):
        keep = torch.ones(c, dtype=torch.bool, device=dev)
        keep[rows] = False
        return keep

    zeros = torch.zeros(n_frames, 1, device=dev)
    worst_abs = 0.0
    # a clone prompt that fills the 4096-row bucket: the engine's cache of
    # that bucket (cache_capacity: 4096 + 512 + 4 rounded up to 512 slots)
    cap_long = 5120
    kv_long = [(torch.randn((*shape[:3], cap_long, shape[4]), generator=g,
                            device=dev) * 0.5).to(torch.bfloat16)
               for _ in range(2)]
    for prompt_cap, length, start, cache in (
            (32, 31, 32, kv), (128, 117, 159, kv), (128, 90, 1020, kv),
            (4096, 4070, 4100, kv_long)):
        c_cap = cache[0].shape[3]
        # the kernel from the carried state over 1 .. F frames, one launch
        # each; the F-frame launch gives the window logits
        tk = []
        runs = [run(cs.gen_chunk_fused, n, prompt_cap, length, start,
                    zeros[:n], greedy, cache=cache,
                    taps=tk if n == n_frames else None)
                for n in range(1, n_frames + 1)]
        codes = runs[-1][0]
        # each launch repeats the shorter one: its codes, and every cache
        # row but the one its last frame wrote
        repeat = all(
            torch.equal(runs[f][0][:, :f], runs[f - 1][0])
            and all(torch.equal(a[:, :, :, all_but(start + f, c_cap)],
                                b[:, :, :, all_but(start + f, c_cap)])
                    for a, b in zip(runs[f][3:], runs[f - 1][3:]))
            for f in range(1, n_frames))
        keep = all_but(slice(start, start + n_frames), c_cap)
        same = all(torch.equal(a[:, :, :, keep], t_[:, :, :, keep])
                   for a, t_ in zip(runs[-1][3:], cache))
        finite = all(bool(torch.isfinite(x).all())
                     for r in runs for x in r[1:3])
        ok = repeat and same and finite
        errs, flips = [], []
        for f in range(n_frames):
            # frame f of the plain version from the kernel's state after
            # frame f - 1, on the kernel's codes; again with the prefix in
            # tiles of the kernel's split
            state = None if f == 0 else runs[f - 1][1:]
            tp_, t128 = [], []
            want = run(cs.gen_chunk_plain, 1, prompt_cap, length, start + f,
                       zeros[:1], greedy, state=state, cache=cache,
                       taps=tp_, force_codes=codes[:, f:f + 1])
            alt = run(cs.gen_chunk_plain, 1, prompt_cap, length, start + f,
                      zeros[:1], greedy, state=state, cache=cache,
                      taps=t128, force_codes=codes[:, f:f + 1],
                      prefix_tile=cs.SPLIT)
            got, kt = runs[f], tk[f * 15:(f + 1) * 15]
            picks, mine = want[0][0, 0].cpu(), codes[0, f].cpu()
            for t in range(16):
                if picks[t] == mine[t]:
                    continue
                if t == 0:               # sampled from the same logits
                    flips.append((f, 0))
                    ok = False
                    continue
                top2 = tp_[t - 1][0].topk(2).values
                gap = (top2[0] - top2[1]).item()
                seen = (kt[t - 1][0] - tp_[t - 1][0]).abs().max().item()
                flips.append((f, t, round(gap, 5), round(seen, 5)))
                ok = ok and gap <= CHUNK_GAP and gap <= 2 * seen
            row = slice(start + f, start + f + 1)
            e = errs_of(got, want, kt, tp_, row)
            sens = max(errs_of(alt, want, t128, tp_, row))
            tol = max(CHUNK_TOL, 2 * sens)
            e0 = max(rel(x[0, :, :, row], y[0, :, :, row])
                     for x, y in zip(got[3:], want[3:]))
            errs.append((*e, e0, sens))
            ok = ok and max(e) <= tol and e0 <= STEP_TOL_LAYER
            worst_abs = max(worst_abs, *((a - b).abs().max().item()
                                         for a, b in zip(got[1:3],
                                                         want[1:3])))
        n_eq = 16 * n_frames - len(flips)
        print(f"[kernel] gen_chunk_fused F={n_frames} C={c_cap} prompt_cap="
              f"{prompt_cap} length={length} start={start} grid="
              f"{cs.gen_chunk_fused.grid}, each frame against plain from "
              f"the kernel's state: codes equal to the plain picks "
              f"{n_eq}/{16 * n_frames} (flips (frame, token, plain top-2 "
              f"gap, max |kernel - plain| of those logits): {flips}, gap "
              f"tol {CHUNK_GAP}); rel err by frame (window logits, logits, "
              f"hidden, written k/v; layer 0's k/v row; the plain "
              f"version's own 128- vs 512-slot-tile difference s): "
              f"{[tuple(f'{x:.2e}' for x in e) for e in errs]} (tol "
              f"max({CHUNK_TOL}, 2 s); layer 0 {STEP_TOL_LAYER}); launches "
              f"repeat={repeat} other slots "
              f"untouched={same} finite={finite}")
        if not ok:
            failures.append(f"gen_chunk_fused disagrees with plain at "
                            f"start={start}")
    # the frames' largest rel err at prompt_cap 4096 (C = 5120)
    long_err = max(max(e[:4]) for e in errs)
    del kv_long, runs

    u = torch.tensor([[0.3], [0.7], [0.1], [0.9]], device=dev)
    codes = run(cs.gen_chunk_fused, n_frames, 32, 31, 32, u, sampled)[0]
    in_range = bool((codes >= 0).all() and (codes[..., 0] < cs.V_CODEC).all()
                    and (codes[..., 1:] < cs.WINDOW).all())
    n = 4000
    rows = logits0.expand(n, -1).contiguous()
    us = torch.rand(n, generator=g, device=dev)
    k_s = cs.sample_fused(rows, us, *sampled).cpu()
    p_s = sample_threshold(rows.cpu(), us.cpu(), *sampled)
    share = (k_s == p_s).float().mean().item()
    lg64 = torch.randn(64, cs.V_CODEC, generator=g, device=dev)
    zeros64 = torch.zeros(64, device=dev)
    greedy_same = torch.equal(cs.sample_fused(lg64, zeros64, *greedy).cpu(),
                              sample_threshold(lg64.cpu(), zeros64.cpu(),
                                               *greedy))
    print(f"[kernel] gen_chunk_fused sampled (t={sampled[0]}, top_k="
          f"{sampled[1]}, top_p={sampled[2]}, fixed u): codes in range="
          f"{in_range} {codes[0, :, 0].tolist()}; sampler alone vs "
          f"sample_threshold: greedy equal={greedy_same}, sampled equal on "
          f"{share:.4f} of {n} draws (min {SAMPLER_MIN_EQUAL})")
    if not (in_range and greedy_same and share >= SAMPLER_MIN_EQUAL):
        failures.append("chunk sampler disagrees with sample_threshold")

    # timing at the first case's cursor
    k, v = kv[0].clone(), kv[1].clone()
    cos, sin = inputs(n_frames, 32)
    args = (logits0, hidden0, k, v, i32(31), i32(32), cos, sin, zeros,
            greedy, 32)
    scratch = cs.chunk_scratch(tcfg, pcfg, dev, 1, cap)   # kept, as the
                                                           # engine does
    times = {"plain": 0.0, "kernel": 0.0}
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "plain":
            t = cuda_ms(lambda i: cs.gen_chunk_plain(tcfg, pcfg, tw, pw, ex,
                                                     *args), 1, 1)
        else:
            t = cuda_ms(lambda i: cs.gen_chunk_fused(
                tcfg, pcfg, tw, pw, ex, *args, scratch=scratch), 10, 2)
        times[order] += t / 2
    ms, plain = times["kernel"], times["plain"]
    # where the kernel's time goes: block 0's clock at each barrier, the
    # phases' cycles scaled to the timed ms per chunk
    labels = cs.phase_labels(tcfg, pcfg, n_frames)
    clocks = torch.zeros(len(labels) + 1, dtype=torch.int64, device=dev)
    cs.gen_chunk_fused(tcfg, pcfg, tw, pw, ex, *args, clocks=clocks,
                       scratch=scratch)
    if not bool((clocks.diff() > 0).all()):
        failures.append("gen_chunk_fused: a phase clock did not advance")
    cyc = clocks.diff().double().cpu()
    per_cycle = ms / cyc.sum().item()
    by_label = {}
    for lab, c in zip(labels, cyc.tolist()):
        n_, t_ = by_label.get(lab, (0, 0.0))
        by_label[lab] = (n_ + 1, t_ + c * per_cycle)
    print(f"[kernel] gen_chunk_fused phases (block 0's clock at each of "
          f"{len(labels)} barriers per chunk): " + "; ".join(
              f"{lab} {n_ // n_frames}/frame {t_ / n_frames:.3f} ms/frame "
              f"({t_ / n_ * 1e3:.1f} us each)"
              for lab, (n_, t_) in by_label.items()))
    # bytes: every weight once, the 16 + 15 table rows of each frame, the
    # visible prefix (31 prompt slots) and the chunk's rows of every layer,
    # inputs and outputs; ops: 2 per int4 weight for each frame (the
    # predictor's 16 times), int8 heads and the f32 projection
    w4 = sum(t.numel() * 2 for k_, t in tw.items() if k_.endswith("_q"))
    p4 = sum(t.numel() * 2 for k_, t in pw.items() if k_.endswith("_q"))
    static = [t for k_, t in ex.items() if k_ not in ("ctab_fb", "ctab_pred")]
    kv_bytes = tcfg.n_layers * 2 * (31 + n_frames) * 8 * 128 * 2
    rows_bytes = n_frames * (16 * tcfg.d_model + 15 * pcfg.d_model) * 2
    io = (nbytes((logits0, hidden0, cos, sin, zeros))
          + n_frames * 16 * 4 + logits0.numel() * 4 + hidden0.numel() * 4)
    ops = 2 * n_frames * (w4 + 16 * p4 + 15 * cs.WINDOW * pcfg.d_model
                          + cs.V_CODEC * tcfg.d_model)
    b_ms, b_by = bound(nbytes(tw.values()) + nbytes(pw.values())
                       + nbytes(static) + kv_bytes + rows_bytes + io,
                       ops, "int8")
    print(f"[kernel] gen_chunk_fused F={n_frames} C={cap} start=32: "
          f"{ms:.4f} ms per chunk ({ms / n_frames:.4f} ms per frame) on grid "
          f"{cs.gen_chunk_fused.grid} (blocks, warps a block); plain "
          f"{plain:.1f} ms per chunk; bound {b_ms:.4f} ms per chunk "
          f"({b_by}: each input read once); no single PyTorch call")
    out = dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain, bound_ms=b_ms,
               bound_by=b_by, library_ms=None,
               prompt_cap_4096_max_rel_err=long_err)
    out.update(check_chunk_batched(dev, failures, tcfg, pcfg, tw, pw, ex, g))
    return out


# A talker layer of the batched chunk kernel that moves beyond
# STEP_TOL_LAYER from the plain layer in the kernel's orders is replayed on
# that lane alone through replay_layer with one of the kernel's sum orders
# swapped in at a time (the diagnosis of ROADMAP Queue C #1): it names the
# sum whose order moves it.
REPLAY_ORDERS = ((), ("rms",), ("rms-sum",), ("rms-inv",), ("qk",),
                 ("qk-sum",), ("qk-inv",), ("softmax",), ("scores",),
                 ("softmax", "scores"), ("rms", "qk", "softmax", "scores"))


def replay_layer(cfg, w, layer, x, cos, sin, cache_k, cache_v, lengths,
                 start, f, prompt_cap, orders):
    """chunk_step._talker_layer_plain (w4a8; the prefix in 128-slot tiles,
    or with "softmax" in the kernel's 64-slot splits) with the kernel's
    order for the sums named in `orders` (chunk_step.ORDERS)."""
    from qwen3_tts_tpu_torch.kernels import chunk_step as cs
    return cs._talker_layer_plain(cfg, w, layer, x, cos, sin, cache_k,
                                  cache_v, lengths, start, f, prompt_cap, 128,
                                  orders=orders)


def check_chunk_batched(dev, failures, tcfg, pcfg, tw, pw, ex, g):
    """gen_chunk_fused at B = 1, 8, 16, 24 and 32 lanes (F = 4, C = 1024,
    ragged prompt lengths and positions, one cursor; at B = 8 the cursor
    starts at 1020), greedy and sampled.  B = 1 runs the one-lane kernel,
    B = 8-32 the batched body.  Every lane of a batched launch must be
    bit-equal to that lane's inputs and uniforms alone, copied into all 8
    lanes of a B = 8 launch (no sum mixes lanes, no order depends on B; the
    one-lane kernel's heads sum in another order, so it is the reference
    only for itself, launched again): codes, logits, hidden and the lane's
    whole cache block; the slots being written are poisoned first,
    every other slot must come back unchanged, and each F-frame launch must
    repeat the shorter ones.  Greedy on lanes 0, B - 1 and the first of
    every row tile at every frame, sampled on lanes 0 and B - 1 at the
    first and last frame, the frame is held against the plain version from
    the kernel's own state: the codes and window logits as in
    check_chunk (the plain frame on that lane alone after the kernel's
    frame before, the kernel's codes forced), the talker layer by layer
    (the note after CHUNK_TOL).  Timed per 4-frame chunk at
    each B > 1 (CUDA events, greedy; check_chunk times B = 1), beside its
    bound."""
    import torch
    from qwen3_tts_tpu_torch.kernels import chunk_step as cs
    from qwen3_tts_tpu_torch.models import talker as talker_lib

    n_frames, cap = 4, 1024
    greedy = (0.0, 40, 0.9)
    sampled = (SAMPLED["temperature"], SAMPLED["top_k"], SAMPLED["top_p"])
    i32 = lambda vals: torch.tensor(vals, dtype=torch.int32, device=dev)

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item()

    def run(fn, n, st, start, prompt_cap, u, sampler, **kw):
        """n frames from lane state st = (logits, hidden, k, v, lengths,
        positions); the caches are copied first."""
        lg, hd, k, v, lens, pos = st
        k, v = k.clone(), v.clone()
        p = pos.long()[None, :] + torch.arange(n, device=dev)[:, None]
        cos, sin = talker_lib._rope_tables(tcfg, talker_lib._pos4(p))
        out = fn(tcfg, pcfg, tw, pw, ex, lg, hd, k, v, lens,
                 torch.full_like(lens, start), cos.float().contiguous(),
                 sin.float().contiguous(), u.contiguous(), sampler,
                 prompt_cap, **kw)
        torch.cuda.synchronize()
        return (*out, k, v)

    def lane(st, i):
        """Lane i of a state alone (copies: 16-byte aligned)."""
        lg, hd, k, v, lens, pos = st
        return (lg[i:i + 1].clone(), hd[i:i + 1].clone(),
                k[:, i:i + 1].clone(), v[:, i:i + 1].clone(),
                lens[i:i + 1].clone(), pos[i:i + 1].clone())

    def lane8(st, i):
        """Lane i of a state copied into 8 lanes."""
        lg, hd, k, v, lens, pos = st
        return (lg[i:i + 1].repeat(8, 1), hd[i:i + 1].repeat(8, 1),
                k[:, i:i + 1].repeat(1, 8, 1, 1, 1),
                v[:, i:i + 1].repeat(1, 8, 1, 1, 1),
                lens[i:i + 1].repeat(8), pos[i:i + 1].repeat(8))

    def layer_by_layer(full, cur, xk, f, rows, lens, pos, start, prompt_cap,
                       codes):
        """Frame f of lanes `rows`, the talker layer by layer from the
        kernel's own state: the plain layer l in the kernel's orders
        (chunk_step.KERNEL_ORDERS, the prefix in its 64-slot splits) from
        the kernel's residual entering it (xk [B, L + 1, d], layer_taps)
        and the kernel's cache, against the kernel's next residual and its
        written k/v row; the same in torch's orders (128-slot tiles, and
        where that error passes STEP_TOL_LAYER 512-slot tiles as well:
        the torch-order error and its sensitivity s, printed); the
        feedback of the kernel's codes against xk[:, 0]; the final norm
        and codec head of xk[:, L] against the kernel's hidden and logits
        after frame f (cur).  Returns (ok, residual errs, k/v row errs,
        max of the feedback and head errs, exact residuals, pairs beyond
        STEP_TOL_LAYER, torch-order (errs, exact, pairs beyond max(
        STEP_TOL_LAYER, 2 s)))."""
        idx = torch.tensor(rows, device=dev)
        k, v = full[3][:, idx].clone(), full[4][:, idx].clone()
        x = xk[idx]
        p = pos[idx].long()[None, :] + f
        cos, sin = talker_lib._rope_tables(tcfg, talker_lib._pos4(p))
        cos, sin = cos[0].float(), sin[0].float()
        slot = start + f
        fb = cs._feedback(ex["ctab_fb"], codes[idx, f], ex["tts_pad"])
        e_x, e_kv, exact, wide = [], [], 0, []
        e_t, exact_t, beyond_t = [], 0, []
        for layer in range(tcfg.n_layers):
            args = (tcfg, tw, layer, x[:, layer], cos, sin, k, v, lens[idx],
                    start, f, prompt_cap)
            y_t = cs._talker_layer_plain(*args, 128)
            ets = [rel(x[j, layer + 1], y_t[j]) for j in range(len(rows))]
            # s only where the torch-order error passes STEP_TOL_LAYER
            alt = (cs._talker_layer_plain(*args, cs.PREFIX_TILE)
                   if max(ets) > STEP_TOL_LAYER else None)
            # last: the k/v rows this writes are the kernel-order layer's
            y = cs._talker_layer_plain(*args, 128, orders=cs.KERNEL_ORDERS)
            for j, i in enumerate(rows):
                e = rel(x[j, layer + 1], y[j])
                e_x.append(e)
                exact += e == 0.0
                et = ets[j]
                e_t.append(et)
                exact_t += et == 0.0
                sens = 0.0 if alt is None else rel(alt[j], y_t[j])
                if et > max(STEP_TOL_LAYER, 2 * sens):
                    beyond_t.append((f, i, layer, f"{et:.2e}",
                                     f"s={sens:.1e}"))
                if e > STEP_TOL_LAYER:
                    n_diff = int((x[j, layer + 1] != y[j]).sum())
                    wide.append((f, i, layer, f"{e:.2e}", n_diff))
                    rep = {}
                    for orders in REPLAY_ORDERS:
                        kr, vr = k[:, j:j + 1].clone(), v[:, j:j + 1].clone()
                        yr = replay_layer(
                            tcfg, tw, layer, x[j:j + 1, layer],
                            cos[j:j + 1], sin[j:j + 1], kr, vr,
                            lens[idx][j:j + 1].clone(), start, f,
                            prompt_cap, orders)
                        rep["+".join(orders) or "plain"] = (
                            rel(x[j, layer + 1], yr[0]),
                            int((x[j, layer + 1] != yr[0]).sum()))
                    print(f"[replay] {replay_case} (frame {f}, lane {i}, "
                          f"layer {layer}): the plain layer on this lane "
                          f"alone against the kernel's next residual with "
                          f"the kernel's order for the sums named (rel err, "
                          f"elements differing of {tcfg.d_model}): "
                          + "; ".join(f"{o}: {er:.2e}, {nd}"
                                      for o, (er, nd) in rep.items()))
                e_kv.append(max(rel(full[3][layer, i, :, slot],
                                    k[layer, j, :, slot]),
                                rel(full[4][layer, i, :, slot],
                                    v[layer, j, :, slot])))
        hid = cs._rms(x[:, -1], ex["tfn"], tcfg.rms_eps)
        lg = (hid.to(torch.bfloat16).float() @ ex["chead_q"].float().t()
              ) * ex["chead_s"]
        e_end = max(rel(x[:, 0], fb), rel(cur[2][idx], hid),
                    rel(cur[1][idx], lg))
        # the frame's other sums in the kernel's orders: the feedback's q
        # order, the final norm's 256 threads (exact or not, printed)
        fb_k = cs._feedback(ex["ctab_fb"], codes[idx, f], ex["tts_pad"],
                            kernel_order=True)
        hid_k = cs._rms_kernel_order(x[:, -1], ex["tfn"], tcfg.rms_eps, 256)
        stages = (bool(torch.equal(x[:, 0], fb_k)),
                  bool(torch.equal(cur[2][idx], hid_k)),
                  rel(cur[1][idx], (hid_k.to(torch.bfloat16).float()
                                    @ ex["chead_q"].float().t())
                      * ex["chead_s"]))
        ok = (max(e_x) <= STEP_TOL_LAYER and max(e_kv) <= STEP_TOL_LAYER
              and e_end <= STEP_TOL_LAYER)
        return (ok, e_x, e_kv, e_end, exact, wide, (e_t, exact_t, beyond_t),
                stages)

    res, worst = {}, 0.0
    plain_one_lane = None
    for b, prompt_cap, start in ((1, 32, 32), (8, 128, 1020),
                                 (16, 128, 159), (24, 32, 32),
                                 (32, 128, 600)):
        lengths = [prompt_cap - 1 - (7 * i) % (prompt_cap // 2)
                   for i in range(b)]
        lens = i32(lengths)
        pos = lens + (start - prompt_cap)     # a wave's positions
        shape = (tcfg.n_layers, b, tcfg.n_kv_heads, cap, tcfg.head_dim)
        kv = [(torch.randn(shape, generator=g, device=dev) * 0.5).to(
            torch.bfloat16) for _ in range(2)]
        for t_, poison in zip(kv, (1e3, -1e3)):   # the slots being written
            t_[:, :, :, start:start + n_frames] = poison
        st0 = (torch.randn(b, cs.V_CODEC, generator=g, device=dev) * 2.0,
               torch.randn(b, tcfg.d_model, generator=g, device=dev),
               *kv, lens, pos)
        keep = torch.ones(cap, dtype=torch.bool, device=dev)
        keep[start:start + n_frames] = False
        rows = sorted({0, b - 1, *range(0, b, 8)})
        for mode, sampler in (("greedy", greedy), ("sampled", sampled)):
            replay_case = f"B={b} start={start} {mode}"
            # against the plain version: greedy on the first lane of every
            # row tile and B - 1 at every frame; sampled, whose kernel path
            # differs from greedy's only in code 0's draw, on lanes 0 and
            # B - 1 at the first and last frame (the phase's time)
            held_rows = rows if mode == "greedy" else sorted({0, b - 1})
            held_frames = (list(range(n_frames)) if mode == "greedy"
                           else [0, n_frames - 1])
            u = (torch.zeros(n_frames, b, device=dev) if mode == "greedy"
                 else torch.rand(n_frames, b, generator=g, device=dev))
            taps, xt = [], []
            runs = [run(cs.gen_chunk_fused, n, st0, start, prompt_cap, u[:n],
                        sampler, taps=taps if n == n_frames else None,
                        layer_taps=xt if n == n_frames else None)
                    for n in range(1, n_frames + 1)]
            full = runs[-1]
            codes = full[0]
            repeat = all(
                torch.equal(runs[f][0][:, :f], runs[f - 1][0])
                and all(torch.equal(x[:, :, :, keep], y[:, :, :, keep])
                        for x, y in zip(runs[f][3:], runs[f - 1][3:]))
                for f in range(1, n_frames))
            same = all(torch.equal(x[:, :, :, keep], y[:, :, :, keep])
                       for x, y in zip(full[3:], kv))
            finite = all(bool(torch.isfinite(x).all())
                         for r in runs for x in r[1:3])
            in_range = bool((codes >= 0).all()
                            and (codes[..., 0] < cs.V_CODEC).all()
                            and (codes[..., 1:] < cs.WINDOW).all())
            # every lane against its inputs alone: at B > 1 in all 8 lanes
            # of a batched launch, at B = 1 the one-lane launch again
            bad = []
            for i in range(b):
                if b == 1:
                    one = run(cs.gen_chunk_fused, n_frames, lane(st0, i),
                              start, prompt_cap, u[:, i:i + 1], sampler)
                else:
                    one = run(cs.gen_chunk_fused, n_frames, lane8(st0, i),
                              start, prompt_cap,
                              u[:, i:i + 1].repeat(1, 8), sampler)
                if not (torch.equal(one[0][0], codes[i])
                        and torch.equal(one[1][0], full[1][i])
                        and torch.equal(one[2][0], full[2][i])
                        and torch.equal(one[3][:, 0], full[3][:, i])
                        and torch.equal(one[4][:, 0], full[4][:, i])):
                    bad.append(i)
            ok = repeat and same and finite and in_range and not bad
            flips, detail, beyond, e2e, drift, off = [], [], 0, 0.0, [], []
            beyond_k, e2e_k = 0, 0.0
            lx, lkv, lend, n_exact, wide = [], [], [], 0, []
            lx_t, n_exact_t, beyond_t = [], 0, []
            fb_exact = hid_exact = True
            head_k = 0.0
            for f in held_frames:
                x_ok, e_lx, e_lkv, e_end, exact, w_, torch_order, stg = \
                    layer_by_layer(full, runs[f], xt[f], f, held_rows, lens,
                                   pos, start, prompt_cap, codes)
                fb_exact = fb_exact and stg[0]
                hid_exact = hid_exact and stg[1]
                head_k = max(head_k, stg[2])
                ok = ok and x_ok
                wide += w_
                lx.append(max(e_lx))
                lkv.append(max(e_lkv))
                lend.append(e_end)
                n_exact += exact
                lx_t.append(max(torch_order[0]))
                n_exact_t += torch_order[1]
                beyond_t += torch_order[2]
                # codes and window logits: the plain frame on lane i alone
                # from the kernel's state after frame f - 1, run from the
                # chunk's start with offset f, its codes forced
                # (check_chunk's policy); the frame's end-to-end difference
                # printed against the plain frame in torch's orders and
                # held in the kernel's (CHUNK_ORDER_TOL)
                for i in held_rows:
                    src = st0 if f == 0 else (*runs[f - 1][1:], lens, pos + f)
                    st = lane(src, i)
                    tp_, t128 = [], []
                    kw = dict(force_codes=codes[i:i + 1, f:f + 1], frame0=f)
                    want = run(cs.gen_chunk_plain, 1, st, start,
                               prompt_cap, u[f:f + 1, i:i + 1], sampler,
                               taps=tp_, **kw)
                    lt = []
                    kord = run(cs.gen_chunk_plain, 1, st, start,
                               prompt_cap, u[f:f + 1, i:i + 1], sampler,
                               orders=cs.CHUNK_ORDERS, layer_taps=lt, **kw)
                    kt = [t_[i:i + 1] for t_ in taps[f * 15:(f + 1) * 15]]
                    picks, mine = want[0][0, 0].cpu(), codes[i, f].cpu()
                    for t in range(16):
                        if picks[t] == mine[t]:
                            continue
                        if t == 0:           # sampled from the same logits
                            flips.append((i, f, 0))
                            ok = False
                            continue
                        top2 = tp_[t - 1][0].topk(2).values
                        gap = (top2[0] - top2[1]).item()
                        seen = (kt[t - 1][0] - tp_[t - 1][0]).abs().max()
                        flips.append((i, f, t, round(gap, 5),
                                      round(seen.item(), 5)))
                        ok = ok and gap <= CHUNK_GAP and gap <= 2 * seen
                    e_win = max(rel(x, y) for x, y in zip(kt, tp_))
                    slot = slice(start + f, start + f + 1)
                    got = (runs[f][1][i:i + 1], runs[f][2][i:i + 1],
                           runs[f][3][:, i:i + 1], runs[f][4][:, i:i + 1])

                    def frame_errs(ref):
                        return [rel(got[0], ref[1]), rel(got[1], ref[2]),
                                *(rel(x[:, :, :, slot], y[:, :, :, slot])
                                  for x, y in zip(got[2:], ref[3:]))]

                    e, e_k = frame_errs(want), frame_errs(kord)
                    if max(e_k) > DRIFT_TRACE:
                        # where the kernel-order frame leaves the kernel:
                        # the first residual (0: the feedback, l: entering
                        # layer l, L: the last output) that differs from
                        # the kernel's own (layer_taps of the F-frame
                        # launch), and whether the (f + 1)-frame launch
                        # this frame starts from wrote the same rows
                        first = next(
                            (j for j in range(tcfg.n_layers + 1)
                             if not torch.equal(lt[0][0, j], xt[f][i, j])),
                            None)
                        drift.append((
                            i, f, f"{max(e_k):.2e}", first,
                            None if first is None else
                            f"{rel(lt[0][0, first], xt[f][i, first]):.2e}",
                            all(torch.equal(
                                x[:, i, :, start:start + f + 1],
                                y[:, i, :, start:start + f + 1])
                                for x, y in zip(runs[f][3:], full[3:]))))
                        if max(e_k) > CHUNK_ORDER_TOL:
                            off.append(drift[-1])
                    # s (the plain frame with its prefix in the kernel's
                    # 64-slot tiles against 512) only where an error passes
                    # CHUNK_TOL: below it no bound max(CHUNK_TOL, 2 s) can
                    # fail (the plain frame is a third of this check's time)
                    sens = s_e = 0.0
                    if max(e_win, *e, *e_k) > CHUNK_TOL:
                        alt = run(cs.gen_chunk_plain, 1, st, start,
                                  prompt_cap, u[f:f + 1, i:i + 1], sampler,
                                  taps=t128, prefix_tile=cs.SPLIT, **kw)
                        sens = max(rel(x, y) for x, y in zip(t128, tp_))
                        s_e = max(rel(x, y)
                                  for x, y in zip(alt[1:3], want[1:3]))
                    ok = ok and e_win <= max(CHUNK_TOL, 2 * sens)
                    beyond += max(e) > max(CHUNK_TOL, 2 * s_e)
                    beyond_k += max(e_k) > max(CHUNK_TOL, 2 * s_e)
                    e2e = max(e2e, *e)
                    e2e_k = max(e2e_k, *e_k)
                    detail.append((i, f, f"{e_win:.1e}", f"{max(e):.2e}",
                                   f"{max(e_k):.2e}",
                                   f"s={s_e:.1e}" if t128 else "s=-"))
                    worst = max(worst, *((x - y).abs().max().item()
                                         for x, y in zip(got[:2],
                                                         want[1:3])))
            n_pairs = len(held_frames) * len(held_rows) * tcfg.n_layers
            ok = ok and n_exact >= LAYER_EXACT_SHARE * n_pairs
            alone = ("the one-lane launch again" if b == 1
                     else "in 8 lanes of a batched launch")
            print(f"[kernel] gen_chunk_fused B={b} F={n_frames} C={cap} "
                  f"prompt_cap={prompt_cap} lengths {min(lengths)}-"
                  f"{max(lengths)} start={start} {mode} grid="
                  f"{cs.gen_chunk_fused.grid}: each lane bit-equal to it "
                  f"alone ({alone}; codes, logits, hidden, cache)="
                  f"{not bad}{f' (not: lanes {bad})' if bad else ''}; "
                  f"launches repeat={repeat} other slots untouched={same} "
                  f"finite={finite} codes in range={in_range}; lanes "
                  f"{held_rows} at frames {held_frames}, "
                  f"talker layer by layer from the kernel's state against "
                  f"the plain layer in the kernel's orders "
                  f"{'+'.join(cs.KERNEL_ORDERS)}, max rel err by frame: "
                  f"residual {[f'{x:.2e}' for x in lx]}, k/v row "
                  f"{[f'{x:.2e}' for x in lkv]} (tol {STEP_TOL_LAYER} each "
                  f"pair); {n_exact} of {n_pairs} (layer, lane) residuals "
                  f"exact (at least {LAYER_EXACT_SHARE}); beyond "
                  f"{STEP_TOL_LAYER} (frame, lane, layer, err, elements "
                  f"differing of {tcfg.d_model}): {wide}; in torch's orders "
                  f"(printed): max by frame {[f'{x:.2e}' for x in lx_t]}, "
                  f"{n_exact_t} of {n_pairs} exact, beyond max("
                  f"{STEP_TOL_LAYER}, 2 s) (frame, lane, layer, err, s): "
                  f"{beyond_t}; feedback, final norm and head "
                  f"{max(lend):.2e} (tol {STEP_TOL_LAYER}); in the kernel's "
                  f"orders feedback exact={fb_exact}, final norm exact="
                  f"{hid_exact}, codec head (tensor-core sums) max rel err "
                  f"{head_k:.2e}; codes equal to "
                  f"the plain picks but flips (lane, frame, token, gap, "
                  f"seen) {flips}; window logits within max({CHUNK_TOL}, 2 "
                  f"s); end to end from the kernel's frame before, the plain "
                  f"frame f run from the chunk's start with offset f: against "
                  f"the plain frame in torch's orders (printed) max "
                  f"{e2e:.2e}, {beyond} of {len(detail)} frames beyond "
                  f"max({CHUNK_TOL}, 2 s); in the kernel's frame orders "
                  f"{'+'.join(cs.CHUNK_ORDERS)} (held) max "
                  f"{e2e_k:.2e} (tol {CHUNK_ORDER_TOL}), {beyond_k} beyond "
                  f"max({CHUNK_TOL}, 2 s); by (lane, frame): window "
                  f"logits, end to end (torch's orders, kernel's), s (- "
                  f"where every error is within {CHUNK_TOL}): "
                  f"{detail}; frames off the kernel in its orders beyond "
                  f"{DRIFT_TRACE} (lane, frame, err, first residual that "
                  f"differs: 0 the feedback, l entering layer l, its rel "
                  f"err, the shorter launch wrote the same rows): {drift}")
            if off:
                failures.append(
                    f"gen_chunk_fused B={b} {mode}: frames off the plain "
                    f"frame in the kernel's orders beyond {CHUNK_ORDER_TOL} "
                    f"(lane, frame, err, first residual that differs, its "
                    f"rel err, the shorter launch wrote the same rows): "
                    f"{off}")
            if not ok:
                failures.append(f"gen_chunk_fused B={b} {mode} disagrees")
            del runs, full
        if b == 1:              # check_chunk times the one-lane launch
            del kv, st0
            continue
        # time per 4-frame chunk (greedy), the kernel's scratch kept
        scratch = cs.chunk_scratch(tcfg, pcfg, dev, b, cap)
        zeros = torch.zeros(n_frames, b, device=dev)
        p = pos.long()[None, :] + torch.arange(n_frames, device=dev)[:, None]
        cos, sin = (t_.float().contiguous() for t_ in talker_lib._rope_tables(
            tcfg, talker_lib._pos4(p)))
        wi = torch.full_like(lens, start)
        ms = cuda_ms(lambda i: cs.gen_chunk_fused(
            tcfg, pcfg, tw, pw, ex, st0[0], st0[1], *kv, lens, wi, cos, sin,
            zeros, greedy, prompt_cap, scratch=scratch), 10, 2)
        if plain_one_lane is None:          # one lane alone, once
            one = lane(st0, 0)
            plain_one_lane = cuda_ms(lambda i: run(
                cs.gen_chunk_plain, n_frames, one, start, prompt_cap,
                zeros[:, :1], greedy), 1, 1)
        # bytes: every weight once, each lane's table rows, visible prefix
        # (prompt slots < length, generated slots [prompt_cap, start)) and
        # chunk rows in every layer, inputs and outputs; ops: 2 per weight
        # per lane and frame (the predictor's 16 times), heads, projection
        w4 = sum(t.numel() * 2 for k_, t in tw.items() if k_.endswith("_q"))
        p4 = sum(t.numel() * 2 for k_, t in pw.items() if k_.endswith("_q"))
        static = [t for k_, t in ex.items()
                  if k_ not in ("ctab_fb", "ctab_pred")]
        visible = sum(min(ln, start) + max(0, start - prompt_cap) + n_frames
                      for ln in lengths)
        kv_bytes = (tcfg.n_layers * 2 * visible * tcfg.n_kv_heads
                    * tcfg.head_dim * 2)
        rows_bytes = b * n_frames * (16 * tcfg.d_model + 15 * pcfg.d_model) * 2
        io = (nbytes((st0[0], st0[1], cos, sin, zeros, lens, wi))
              + b * (n_frames * 16 * 4 + (cs.V_CODEC + tcfg.d_model) * 4))
        ops = 2 * n_frames * b * (w4 + 16 * p4 + 15 * cs.WINDOW * pcfg.d_model
                                  + cs.V_CODEC * tcfg.d_model)
        b_ms, b_by = bound(nbytes(tw.values()) + nbytes(pw.values())
                           + nbytes(static) + kv_bytes + rows_bytes + io,
                           ops, "int8")
        print(f"[kernel] gen_chunk_fused B={b} F={n_frames} C={cap} start="
              f"{start}: {ms:.4f} ms per chunk ({ms / n_frames:.4f} ms per "
              f"frame-step, {b * n_frames / ms * 1e3:.1f} frames/s) on grid "
              f"{cs.gen_chunk_fused.grid} (blocks, warps a block); plain "
              f"{plain_one_lane:.1f} ms per chunk for one lane alone; bound "
              f"{b_ms:.4f} ms per chunk ({b_by}: each input read once)")
        # where the time goes: block 0's clock at each barrier, scaled to
        # the timed ms per chunk
        labels = cs.phase_labels(tcfg, pcfg, n_frames)
        clocks = torch.zeros(len(labels) + 1, dtype=torch.int64, device=dev)
        cs.gen_chunk_fused(tcfg, pcfg, tw, pw, ex, st0[0], st0[1], *kv, lens,
                           wi, cos, sin, zeros, greedy, prompt_cap,
                           clocks=clocks, scratch=scratch)
        cyc = clocks.diff().double().cpu()
        if not bool((cyc > 0).all()):
            failures.append(f"gen_chunk_fused B={b}: a phase clock did not "
                            "advance")
        by_label = {}
        for lab, c in zip(labels, (cyc * ms / cyc.sum()).tolist()):
            n_, t_ = by_label.get(lab, (0, 0.0))
            by_label[lab] = (n_ + 1, t_ + c)
        print(f"[kernel] gen_chunk_fused B={b} phases (ms per frame-step, us "
              f"each): " + "; ".join(
                  f"{lab} {t_ / n_frames:.3f} ({t_ / n_ * 1e3:.1f})"
                  for lab, (n_, t_) in by_label.items()))
        res.update({f"ms_b{b}": ms, f"bound_ms_b{b}": b_ms,
                    f"bound_by_b{b}": b_by})
        del kv, st0, scratch
    res.update(max_abs_err_batched=worst, plain_ms_one_lane=plain_one_lane)
    return res


def check_lanes(dev, failures):
    """The per-lane cache kernels of continuous batching against their
    plain versions at full width: flash_gqa_decode_append (bit-equal to the
    plain version in its sum orders, within the decode bound of the
    torch-order one, the written row bit-exact, every other slot
    untouched; timed at the exact queue's shape, at B = 4 to cursor 1023
    and at B = 8 per-lane cursors), inject_prompt_lanes and append_kv_lanes
    (bit-exact)."""
    import torch
    from qwen3_tts_tpu_torch.kernels import flash_decode as fd
    from qwen3_tts_tpu_torch.ops.attention import history_mask
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    g = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.5).to(
            torch.bfloat16)

    def i32(*vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    def timed(kernel, plain, library, iters=28):
        """CUDA-event ms of the kernel, the plain version and the library
        call, and {device_ms, library_device_ms}: the kernel and the
        library call in a CUDA graph of 20 calls."""
        ms = pl = 0.0
        for order in ("plain", "kernel", "kernel", "plain"):
            if order == "kernel":
                ms += cuda_ms(kernel, iters) / 2
            else:
                pl += cuda_ms(plain, iters) / 2
        graphs = dict(device_ms=graph_ms(kernel),
                      library_device_ms=graph_ms(library))
        return ms, pl, cuda_ms(library, iters), graphs

    def graph_note(gr):
        return (f"; device time (CUDA graph of 20 calls) kernel "
                f"{gr['device_ms']:.4f} ms, library "
                f"{gr['library_device_ms']:.4f} ms")

    out = {}
    # ---- flash_gqa_decode_append: L=28, C=1024, H=16, Hkv=8, Dh=128, per
    # case bit-equal to the plain version in the kernel's orders, within the
    # decode bound of the torch-order one (cursors in [0, C): at a cursor
    # >= C that version drops the token, which the kernel attends), the
    # caches equal to the plain write, with a poisoned stale row (1e3 in k,
    # NaN in v) at each lane's write slot; then timed at three shapes
    n_layers, hkv, cap, dh, h = 28, 8, 1024, 128, 16
    layer = n_layers // 4
    cases = (   # (name, cursors, lengths, prompt_cap)
        ("B=4 cursors 0-1023", (0, 511, 512, 1023), (0, 100, 128, 37), 128),
        ("B=6 split bounds and >= C", (0, 63, 64, 65, 1023, 1030),
         (0, 31, 20, 64, 128, 7), 32),
        ("B=8 per-lane cursors 32-1023",
         (32, 47, 64, 200, 511, 600, 900, 1023),
         (31, 20, 25, 31, 28, 17, 30, 9), 32),
        ("B=4 the exact queue's", (36, 40, 44, 52), (20, 25, 31, 28), 32),
        ("B=4 cursors 128-1023", (128, 159, 600, 1023), (117, 90, 128, 31),
         128))
    errs, all_ok = [], True
    for name, cursors, lens_, pc in cases:
        b = len(cursors)
        k, v = rnd(n_layers, b, hkv, cap, dh), rnd(n_layers, b, hkv, cap, dh)
        q, kn, vn = rnd(b, h, dh), rnd(b, hkv, dh), rnd(b, hkv, dh)
        lengths, wi = i32(*lens_), i32(*cursors)
        for i, c in enumerate(cursors):
            if c < cap:
                k[layer, i, :, c] = 1e3
                v[layer, i, :, c] = float("nan")
        kk, vk = k.clone(), v.clone()
        ko, vo, kp, vp = k.clone(), v.clone(), k.clone(), v.clone()
        got = fd.flash_gqa_decode_append(q, kk, vk, kn, vn, lengths, wi,
                                         layer, pc)
        torch.cuda.synchronize()
        kord = fd.decode_append_kernel_order(q, ko, vo, kn, vn, lengths, wi,
                                             layer, pc)
        want = fd.decode_append_plain(q.float(), kp, vp, kn, vn, lengths, wi,
                                      layer, pc)
        inside = [i for i, c in enumerate(cursors) if c < cap]
        diff = (got[inside].float() - want[inside]).abs()
        within = bool((diff <= DECODE_ATOL + DECODE_RTOL
                       * want[inside].abs()).all())
        bit = torch.equal(got, kord)
        rows = (torch.equal(kk, kp) and torch.equal(vk, vp)
                and torch.equal(kk, ko) and torch.equal(vk, vo))
        errs.append(diff.max().item())
        print(f"[kernel] flash_gqa_decode_append L={n_layers} C={cap} {name} "
              f"{cursors} prompt_cap={pc} (poisoned self slots): equal to "
              f"the plain version in the kernel's orders={bit} (max abs diff "
              f"{(got.float() - kord.float()).abs().max().item():.3e}); "
              f"against the torch-order plain (cursors < C) max_abs_err="
              f"{diff.max().item():.3e} tol={DECODE_ATOL} + 2^-8*|plain f32| "
              f"within={within}; caches equal to the plain write={rows}")
        all_ok = all_ok and bit and within and rows
        del k, v, kk, vk, ko, vo, kp, vp
    if not all_ok:
        failures.append("flash_gqa_decode_append disagrees with plain")

    def time_append(cursors, lens_, pc):
        """(events ms, plain ms, library ms, graphs, bound ms, bound by) of
        one layer per call, the 28 layers in turn."""
        b = len(cursors)
        k, v = rnd(n_layers, b, hkv, cap, dh), rnd(n_layers, b, hkv, cap, dh)
        q, kn, vn = rnd(b, h, dh), rnd(b, hkv, dh), rnd(b, hkv, dh)
        lens, wi = i32(*lens_), i32(*cursors)
        flat = (torch.arange(b, device=dev)[:, None] * hkv * cap
                + torch.arange(hkv, device=dev)[None, :] * cap
                + wi.long()[:, None])
        mask = history_mask(lens, pc, wi, 1, cap)

        def library(i):
            layer = i % n_layers
            kl, vl = k[layer].view(-1, dh), v[layer].view(-1, dh)
            kl.index_copy_(0, flat.reshape(-1), kn.reshape(-1, dh))
            vl.index_copy_(0, flat.reshape(-1), vn.reshape(-1, dh))
            return sdpa(q[:, :, None], k[layer], v[layer],
                        attn_mask=mask[:, None], enable_gqa=True)

        ms, pl, lib, gr = timed(
            lambda i: fd.flash_gqa_decode_append(q, k, v, kn, vn, lens, wi,
                                                 i % n_layers, pc),
            lambda i: fd.decode_append_plain(q, k, v, kn, vn, lens, wi,
                                             i % n_layers, pc), library)
        slots = int(mask.sum())         # visible slots, the new one included
        b_ms, b_by = bound(2 * q.numel() * 2 + 2 * kn.numel() * 2 * 2
                           + 2 * (slots - b) * hkv * dh * 2,
                           4 * slots * h * dh, "bf16")
        return ms, pl, lib, gr, b_ms, b_by

    for name, cursors, lens_, pc in (cases[3], cases[4], cases[2]):
        ms, pl, lib, gr, b_ms, b_by = time_append(cursors, lens_, pc)
        print(f"[kernel] flash_gqa_decode_append {name} {cursors} C={cap} "
              f"prompt_cap={pc} per layer: {ms:.4f} ms, plain {pl:.4f} ms, "
              f"index_copy_ + torch sdpa {lib:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}){graph_note(gr)}")
        if name == cases[3][0]:         # the kernels line: the exact queue's
            out["flash_gqa_decode_append"] = dict(
                max_abs_err=max(errs), ms=ms, plain_ms=pl, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, **gr)

    # ---- inject_prompt_lanes: R=8 rows of S=128 into a B=32 cache, lane 5
    # twice with the same rows
    r, s_, b = 8, 128, 32
    kb, vb = rnd(n_layers, b, hkv, cap, dh), rnd(n_layers, b, hkv, cap, dh)
    ks, vs = rnd(n_layers, r, hkv, s_, dh), rnd(n_layers, r, hkv, s_, dh)
    ks[:, 7], vs[:, 7] = ks[:, 0], vs[:, 0]
    lanes = i32(5, 1, 30, 12, 0, 31, 17, 5)
    got = [kb.clone(), vb.clone()]
    want = [kb.clone(), vb.clone()]
    fd.inject_prompt_lanes(*got, ks, vs, lanes)
    torch.cuda.synchronize()
    fd.inject_prompt_lanes_plain(*want, ks, vs, lanes)
    same = all(torch.equal(a, w_) for a, w_ in zip(got, want))
    err = max((a.float() - w_.float()).abs().max().item()
              for a, w_ in zip(got, want))
    print(f"[kernel] inject_prompt_lanes L={n_layers} R={r} S={s_} B={b} "
          f"C={cap} lanes={lanes.tolist()}: bit-exact against plain (other "
          f"slots untouched)={same}")
    if not same:
        failures.append("inject_prompt_lanes disagrees with plain")
    idx = lanes.long()

    def inject_library(i):
        kb[:, idx, :, :s_] = ks
        vb[:, idx, :, :s_] = vs

    ms, pl, lib, gr = timed(
        lambda i: fd.inject_prompt_lanes(kb, vb, ks, vs, lanes),
        lambda i: fd.inject_prompt_lanes_plain(kb, vb, ks, vs, lanes),
        inject_library, iters=10)
    b_ms, b_by = bound(2 * 2 * ks.numel() * 2 + lanes.numel() * 4, 0, "bf16")
    print(f"[kernel] inject_prompt_lanes R={r} S={s_}: {ms:.4f} ms, plain "
          f"{pl:.4f} ms, indexed assignment k[:, lanes, :, :S] = ... (k and "
          f"v) {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}){graph_note(gr)}")
    out["inject_prompt_lanes"] = dict(max_abs_err=err, ms=ms, plain_ms=pl,
                                      bound_ms=b_ms, bound_by=b_by,
                                      library_ms=lib, **gr)

    # ---- append_kv_lanes: B=32, starts at window edges
    kt, vt = rnd(n_layers, b, hkv, dh), rnd(n_layers, b, hkv, dh)
    starts = i32(*[(0, 7, 8, 63, 64, 511, 512, 1016)[i % 8] + (i // 8) * 2
                   for i in range(b - 1)], cap - 1)
    got = [kb.clone(), vb.clone()]
    want = [kb.clone(), vb.clone()]
    fd.append_kv_lanes(*got, kt, vt, starts)
    torch.cuda.synchronize()
    fd.append_kv_lanes_plain(*want, kt, vt, starts)
    same = all(torch.equal(a, w_) for a, w_ in zip(got, want))
    err = max((a.float() - w_.float()).abs().max().item()
              for a, w_ in zip(got, want))
    print(f"[kernel] append_kv_lanes L={n_layers} B={b} C={cap} starts="
          f"{starts.tolist()}: bit-exact against plain (other slots "
          f"untouched)={same}")
    if not same:
        failures.append("append_kv_lanes disagrees with plain")
    del got, want
    all_lanes = torch.arange(b, device=dev)
    st = starts.long()
    kt_t, vt_t = kt.transpose(0, 1), vt.transpose(0, 1)

    def append_library(i):
        kb[:, all_lanes, :, st] = kt_t
        vb[:, all_lanes, :, st] = vt_t

    ms, pl, lib, gr = timed(
        lambda i: fd.append_kv_lanes(kb, vb, kt, vt, starts),
        lambda i: fd.append_kv_lanes_plain(kb, vb, kt, vt, starts),
        append_library)
    b_ms, b_by = bound(2 * 2 * kt.numel() * 2 + starts.numel() * 4, 0,
                       "bf16")
    print(f"[kernel] append_kv_lanes B={b}: {ms:.4f} ms, plain {pl:.4f} ms, "
          f"advanced-index assignment k[:, lanes, :, starts] = ... (k and "
          f"v) {lib:.4f} ms, bound {b_ms:.5f} ms ({b_by}){graph_note(gr)}")
    out["append_kv_lanes"] = dict(max_abs_err=err, ms=ms, plain_ms=pl,
                                  bound_ms=b_ms, bound_by=b_by,
                                  library_ms=lib, **gr)
    return out


def check_talker_batched(dev, failures):
    """talker_step_fused at B = 8 and 32 with ragged per-lane cursors
    (uniform_cursor=False: the rows staged and appended by
    append_kv_lanes), one layer and 28.  Each lane must equal the one-lane
    kernel on that lane's inputs bit for bit (its arithmetic is B = 1's),
    and the plain version in the kernel's orders
    (chunk_step._talker_plain(orders=KERNEL_ORDERS): the prefix in 64-slot
    splits combined in split order, then the current token; B = 8 also at
    cursors across the split bounds), run on that lane alone (on the card torch orders its
    sums by shape, so one batched plain call is not the B = 1 plain
    version lane for lane): hidden state and appended k/v rows within
    STEP_TOL_LAYER at one layer, and at each of the 28 layers from the
    kernel's own state at the layer before, at least half of the (layer,
    lane) pairs bit-equal.  End to end over 28 layers (printed, with
    talker_step_plain and s, how far the plain version moves from itself
    between the two softmax orders) a flipped rounding is carried on by
    every later layer.  Identical lanes against each other and the
    one-lane kernel."""
    import dataclasses

    import torch
    from qwen3_tts_tpu_torch import EngineConfig
    from qwen3_tts_tpu_torch.kernels import chunk_step as cs
    from qwen3_tts_tpu_torch.kernels.talker_step import (
        prep_layer_weights, talker_step_fused, talker_step_plain)
    from qwen3_tts_tpu_torch.models import talker as talker_lib
    from qwen3_tts_tpu_torch.models.transformer import init_decoder_params

    cfg = EngineConfig().talker
    g = torch.Generator(device=dev).manual_seed(6)
    with torch.no_grad():
        w = prep_layer_weights(cfg, init_decoder_params(cfg, g))
    cap = 1024

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.5).to(
            torch.bfloat16)

    def i32(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    def rope(positions):
        p = torch.tensor(positions, device=dev)[:, None]
        cos, sin = talker_lib._rope_tables(cfg, talker_lib._pos4(p))
        return cos[:, 0].contiguous(), sin[:, 0].contiguous()

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item()

    worst, timing = 0.0, {}
    # ragged: buckets 32 and 128, cursors from the bucket to the cap end;
    # then B = 8 in bucket 32 at cursors on both sides of the attention's
    # 64-slot split bounds
    cases = []
    for b in (8, 32):
        pcaps = [32 if i % 2 else 128 for i in range(b)]
        cases.append((b, 128, [pc + (97 * i) % (cap - pc)
                               for i, pc in enumerate(pcaps)],
                      [pc - 1 - (7 * i) % 20 for i, pc in enumerate(pcaps)]))
    cases.append((8, 32, [47, 48, 63, 64, 65, 1023, 33, 500],
                  [31 - (7 * i) % 20 for i in range(8)]))
    for case, (b, pcap, cursors, lengths) in enumerate(cases):
        kv = [rnd(cfg.n_layers, b, cfg.n_kv_heads, cap, cfg.head_dim)
              for _ in range(2)]
        x = rnd(b, cfg.d_model)
        cos, sin = rope(cursors)
        lens, wi = i32(lengths), i32(cursors)
        lanes, st = torch.arange(b, device=dev), wi.long()
        for depth, tol in ((1, STEP_TOL_LAYER), (cfg.n_layers, STEP_TOL_STEP)):
            cd = dataclasses.replace(cfg, n_layers=depth)
            wd = {n_: t[:depth] for n_, t in w.items()}
            cache = [t[:depth].clone() for t in kv]
            got = talker_step_fused(cd, wd, x, cos, sin, *cache, lens, wi,
                                    pcap, uniform_cursor=False)
            torch.cuda.synchronize()
            one_lane, ts, es, ss = True, [], [], []
            for i in range(b):
                # lane i alone, each on its own cache copy: the one-lane
                # kernel, the plain version, and the plain version in the
                # kernel's orders (KERNEL_ORDERS: 64-slot prefix splits
                # combined in split order, the current token merged last)
                mine, plain, tiled = ([t[:depth, i:i + 1].clone() for t in kv]
                                      for _ in range(3))
                # copies: the kernel takes 16-byte aligned tensors
                args = tuple(t[i:i + 1].clone() for t in (x, cos, sin))
                li, wl = lens[i:i + 1].clone(), wi[i:i + 1].clone()
                one = talker_step_fused(cd, wd, *args, *mine, li, wl, pcap)
                want = talker_step_plain(cd, wd, *args, *plain, li, wl, pcap)
                c = cursors[i]
                # one layer in the kernel's orders (held); 28 layers in
                # torch's (a diagnostic: held layer by layer below)
                alt = cs._talker_plain(cd, wd, *args, *tiled, li, c, 0, pcap,
                                       128, orders=(cs.KERNEL_ORDERS
                                                    if depth == 1 else ()))
                one_lane = (one_lane and torch.equal(got[i], one[0])
                            and all(torch.equal(a[:, i, :, c], m[:, 0, :, c])
                                    for a, m in zip(cache, mine)))
                ts.append(max(rel(got[i:i + 1], alt),
                              *(rel(a[:, i, :, c], p[:, 0, :, c])
                                for a, p in zip(cache, tiled))))
                es.append(max(rel(got[i:i + 1], want),
                              *(rel(a[:, i, :, c], p[:, 0, :, c])
                                for a, p in zip(cache, plain))))
                ss.append(max(rel(alt, want),
                              *(rel(a[:, 0, :, c], p[:, 0, :, c])
                                for a, p in zip(tiled, plain))))
                worst = max(worst,
                            (got[i].float() - alt[0].float()).abs().max()
                            .item())
            # end to end, one flipped rounding is carried on by every later
            # layer (up to 1.2e-1 at 28 layers): held layer by layer below
            lanes_ok = depth > 1 or max(ts) <= tol
            same = True
            for a, t in zip(cache, kv):
                a[:, lanes, :, st] = 0
                ref = t[:depth].clone()
                ref[:, lanes, :, st] = 0
                same = same and torch.equal(a, ref)
            print(f"[kernel] talker_step_fused B={b} per-lane L={depth} "
                  f"C={cap} prompt_cap={pcap} cursors {sorted(cursors)[:8]}"
                  f"{'...' if b > 8 else ''}: each lane "
                  f"bit-equal to the 1-lane kernel={one_lane}; against the "
                  f"plain version in the "
                  f"{'kernel' if depth == 1 else 'torch'}'s orders, each lane "
                  f"alone (hidden and appended k/v rel_err): max "
                  f"{max(ts):.3e}, {sum(e == 0 for e in ts)} of {b} exact "
                  f"(the others: {sorted(f'{e:.2e}' for e in ts if e)})"
                  f"{f', every lane within {tol}={lanes_ok}' if depth == 1 else ' (diagnostic)'}"
                  f"; (diagnostic) against "
                  f"talker_step_plain: max {max(es):.3e}, "
                  f"{sum(e == 0 for e in es)} exact; the plain version's "
                  f"own difference between the two orders: max s "
                  f"{max(ss):.3e}, {sum(s > 0 for s in ss)} lanes moved; "
                  f"other slots untouched={same}")
            if not (one_lane and lanes_ok and same
                    and bool(torch.isfinite(got.float()).all())):
                failures.append(f"talker_step_fused B={b} per-lane "
                                f"disagrees at L={depth}")
        # layer by layer: the kernel at depth d against layer d - 1 of the
        # plain version in the kernel's order, run on each lane alone from
        # the kernel's own hidden state at depth d - 1 (the chunk check's
        # policy).  One cache serves every depth: a run writes only slot
        # write_idx, which no attention reads.
        cache, outs, rows = [t.clone() for t in kv], [x], []
        for d in range(1, cfg.n_layers + 1):
            outs.append(talker_step_fused(
                dataclasses.replace(cfg, n_layers=d),
                {n_: t[:d] for n_, t in w.items()}, x, cos, sin,
                *(a[:d] for a in cache), lens, wi, pcap,
                uniform_cursor=False))
            rows.append([a[d - 1][lanes, :, st].clone() for a in cache])
        del cache
        c1 = dataclasses.replace(cfg, n_layers=1)
        per_layer = []
        for layer in range(cfg.n_layers):
            w1 = {n_: t[layer:layer + 1] for n_, t in w.items()}
            for i, c in enumerate(cursors):
                tiled = [t[layer:layer + 1, i:i + 1].clone() for t in kv]
                args = tuple(t[i:i + 1].clone() for t in (outs[layer], cos,
                                                          sin))
                alt = cs._talker_plain(c1, w1, *args, *tiled,
                                       lens[i:i + 1].clone(), c, 0, pcap,
                                       128, orders=cs.KERNEL_ORDERS)
                per_layer.append(max(
                    rel(outs[layer + 1][i:i + 1], alt),
                    *(rel(r[i], p_[0, 0, :, c])
                      for r, p_ in zip(rows[layer], tiled))))
        n_pairs, n_exact = len(per_layer), sum(e == 0 for e in per_layer)
        layers_ok = (max(per_layer) <= STEP_TOL_LAYER
                     and 2 * n_exact >= n_pairs
                     and all(bool(torch.isfinite(o.float()).all())
                             for o in outs))
        print(f"[kernel] talker_step_fused B={b} per-lane prompt_cap={pcap}"
              f", {cfg.n_layers} "
              f"layers held one by one (the kernel at depth d against layer "
              f"d - 1 of the plain version in the kernel's orders from the "
              f"kernel's state at depth d - 1, each lane alone; hidden and "
              f"appended k/v rel_err): {n_exact} of {n_pairs} (layer, lane) "
              f"exact, max {max(per_layer):.3e}, the others "
              f"{sorted(f'{e:.2e}' for e in per_layer if e)[-8:]} (largest "
              f"8); within {STEP_TOL_LAYER} with at least half exact="
              f"{layers_ok}")
        if not layers_ok:
            failures.append(f"talker_step_fused B={b} per-lane disagrees "
                            "layer by layer")
        timing.setdefault("exact_pairs", []).append(f"{n_exact}/{n_pairs}")
        if case == 2:                  # the split-bounds case: held only
            del kv
            continue
        ms = pl = 0.0
        for order in ("plain", "kernel", "kernel", "plain"):
            if order == "kernel":
                ms += cuda_ms(lambda i: talker_step_fused(
                    cfg, w, x, cos, sin, *kv, lens, wi, 128,
                    uniform_cursor=False), iters=10) / 2
            else:
                pl += cuda_ms(lambda i: talker_step_plain(
                    cfg, w, x, cos, sin, *kv, lens, wi, 128), 1, 1) / 2
        g_ms = graph_ms(lambda i: talker_step_fused(
            cfg, w, x, cos, sin, *kv, lens, wi, 128, uniform_cursor=False),
            n=10)
        # prompt slots < length, generated slots [128, cursor), the new one
        visible = sum(min(ln, c) + max(0, c - 128) + 1
                      for ln, c in zip(lengths, cursors))
        n_w = sum(w[k_].numel() * 2 for k_ in ("wqkv_q", "wo_q", "gu_q",
                                                "dn_q"))
        b_ms, b_by = bound(nbytes(w.values()) + 2 * x.numel() * 2
                           + nbytes((cos, sin)) + cfg.n_layers * 2 * visible
                           * cfg.n_kv_heads * cfg.head_dim * 2,
                           2 * n_w * b, "int8")
        timing[b] = (ms, pl, b_ms, b_by, g_ms)
        print(f"[kernel] talker_step_fused B={b} per-lane {cfg.n_layers} "
              f"layers C={cap}: {ms:.4f} ms per step (events; {ms / b:.4f} "
              f"ms per lane), {g_ms:.4f} ms (graph), one launch; plain "
              f"{pl:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {b_ms / g_ms:.1%} "
              f"of it reached), no single PyTorch call")
        # where the step's device time goes, by CUDA kernel (one profiled
        # step)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            talker_step_fused(cfg, w, x, cos, sin, *kv, lens, wi, 128,
                              uniform_cursor=False)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.key_averages()
                         if e.device_type.name == "CUDA"),
                        key=lambda e: -e.self_device_time_total)
        print(f"[kernel] talker_step_fused B={b} per-lane, device ms by "
              f"kernel (launches): " + "; ".join(
                  f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} "
                  f"({e.count})" for e in events[:6]))
        del kv
    # identical lanes: bit-equal to each other and to one lane
    k1, v1 = [rnd(cfg.n_layers, 1, cfg.n_kv_heads, cap, cfg.head_dim)
              for _ in range(2)]
    x1 = rnd(1, cfg.d_model)
    cos1, sin1 = rope([300])
    base = [k1.clone(), v1.clone()]          # before the one-lane write
    one = talker_step_fused(cfg, w, x1, cos1, sin1, k1, v1, i32([90]),
                            i32([300]), 128)
    for n in (8, 32):
        kn_, vn_ = (t.expand(-1, n, -1, -1, -1).contiguous() for t in base)
        many = talker_step_fused(
            cfg, w, x1.expand(n, -1).contiguous(),
            cos1.expand(n, -1).contiguous(), sin1.expand(n, -1).contiguous(),
            kn_, vn_, i32([90] * n), i32([300] * n), 128,
            uniform_cursor=False)
        torch.cuda.synchronize()
        equal = all(torch.equal(many[i], one[0])
                    and torch.equal(kn_[:, i], k1[:, 0])
                    and torch.equal(vn_[:, i], v1[:, 0]) for i in range(n))
        print(f"[kernel] talker_step_fused {n} identical lanes (per-lane "
              f"mode) vs the 1-lane kernel, {cfg.n_layers} layers: "
              f"bit-equal={equal}")
        if not equal:
            failures.append(f"talker_step_fused: {n} batched lanes differ "
                            "from the 1-lane kernel")
        del kn_, vn_
    return dict(max_abs_err_batched=worst, ms_b8=timing[8][0],
                graph_ms_b8=timing[8][4], plain_ms_b8=timing[8][1],
                bound_ms_b8=timing[8][2], ms_b32=timing[32][0],
                graph_ms_b32=timing[32][4], plain_ms_b32=timing[32][1],
                bound_ms_b32=timing[32][2],
                exact_pairs_b8_b32_split_bounds=timing["exact_pairs"])


def check_reference(dev, failures):
    """Two-layer, full-width model: the card against the CPU's plain path
    on the same weights."""
    import dataclasses

    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import EngineConfig, TtsEngine

    base = EngineConfig()
    cfg = base.replace(
        talker=dataclasses.replace(base.talker, n_layers=2),
        predictor=dataclasses.replace(base.predictor, n_layers=2),
        codec_decoder=dataclasses.replace(base.codec_decoder, n_layers=2))
    cpu = TtsEngine(config=cfg, device="cpu", init_seed=5)

    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [move(v) for v in tree]
        return tree.to(dev)

    assets = dataclasses.replace(
        cpu.assets, **{f: getattr(cpu.assets, f).to(dev) for f in (
            "text_table", "codec_tables", "codec_tables_1024", "proj_w",
            "proj_b", "tts_pad")})
    gpu = TtsEngine(config=cfg, device=dev, weights=dict(
        assets=assets, talker=move(cpu.talker_params),
        predictor=move(cpu.predictor_params),
        codec_decoder=move(cpu.codec_decoder_params)))
    voice = gpu.get_speaker("vivian")
    plan = gpu._build_voice_prompt(REQUESTS[0][1], voice, None)
    with torch.no_grad():
        logits = []
        for eng in (cpu, gpu):
            g = torch.Generator(device=eng.device).manual_seed(0)
            state, _ = eng._start_state(plan, g)
            logits.append(state.logits.float().cpu())
        ref = logits[0].abs().max().item()
        err = (logits[1] - logits[0]).abs().max().item()
        print(f"[reference] prefill logits, 2-layer full-width talker, card "
              f"vs CPU: max_abs_err={err:.3e} max|ref|={ref:.3e} "
              f"tol={REF_REL_TOL}*max|ref|")
        if not err <= REF_REL_TOL * ref:
            failures.append("card prefill logits disagree with the CPU")
        from qwen3_tts_tpu_torch.models.codec import decoder as cd
        codes = torch.from_numpy(np.random.default_rng(0).integers(
            0, 2048, (1, 8, 16))).to(torch.int32)
        wavs = []
        for eng in (cpu, gpu):
            st = cd.init_decoder_state(cfg.codec_decoder, 1, eng.device)
            w, _ = cd.decode_chunk(cfg.codec_decoder,
                                   eng.codec_decoder_params,
                                   codes.to(eng.device), st)
            wavs.append(w.float().cpu())
        ref = wavs[0].abs().max().item()
        err = (wavs[1] - wavs[0]).abs().max().item()
        print(f"[reference] codec decode of 8 frames, 2-layer full-width, "
              f"card vs CPU: max_abs_err={err:.3e} max|ref|={ref:.3e} "
              f"tol={REF_REL_TOL}*max|ref|")
        if not err <= REF_REL_TOL * ref:
            failures.append("card codec waveform disagrees with the CPU")


KERNELS = {   # name: (source, the TPU kernel it replaces)
    "flash_gqa_decode_append": (
        "qwen3_tts_tpu_torch/csrc/kv_lanes.cu",
        "qwen3_tts_tpu/kernels/flash_decode.py:354"),
    "inject_prompt_lanes": (
        "qwen3_tts_tpu_torch/csrc/kv_lanes.cu",
        "qwen3_tts_tpu/kernels/flash_decode.py:448"),
    "append_kv_lanes": (
        "qwen3_tts_tpu_torch/csrc/kv_lanes.cu",
        "qwen3_tts_tpu/kernels/flash_decode.py:539"),
    "flash_gqa_prefill_stacked": (
        "qwen3_tts_tpu_torch/csrc/flash_prefill.cu",
        "qwen3_tts_tpu/kernels/flash_prefill.py:137"),
    "flash_gqa_decode_stacked": (
        "qwen3_tts_tpu_torch/csrc/flash_decode.cu",
        "qwen3_tts_tpu/kernels/flash_decode.py:171"),
    "flash_gqa_decode": (
        "qwen3_tts_tpu_torch/csrc/flash_decode.cu",
        "qwen3_tts_tpu/kernels/flash_decode.py:606"),
    "matmul_int4": (
        "qwen3_tts_tpu_torch/csrc/int4_matmul.cu",
        "qwen3_tts_tpu/kernels/int4_matmul.py:60"),
    # the same wrapper's tensor-core tile kernel (M >= TILE_MIN_M), an
    # entry of its own: its launches are matmul_int4.tile_launches
    "matmul_int4_tile": (
        "qwen3_tts_tpu_torch/csrc/int4_matmul.cu",
        "qwen3_tts_tpu/kernels/int4_matmul.py:60"),
    "talker_step_fused": (
        "qwen3_tts_tpu_torch/csrc/talker_step.cu",
        "qwen3_tts_tpu/kernels/talker_step.py:953"),
    "predict_frame_fused": (
        "qwen3_tts_tpu_torch/csrc/predictor_frame.cu",
        "qwen3_tts_tpu/kernels/predictor_frame.py:460"),
    "gen_chunk_fused": (
        "qwen3_tts_tpu_torch/csrc/chunk_step.cu",
        "qwen3_tts_tpu/kernels/chunk_step.py:1226"),
}
# what a wrapper counts beside its `launches`, under the name a path's
# counts give it: matmul_int4's calls on the tile kernel and those whose
# split K adds the partials by a second kernel (int4_splitk_sum);
# flash_gqa_decode's calls whose capacity spans several chunks, which
# launch the combine kernel after the split kernel
SUB_COUNTS = {
    "matmul_int4": {"matmul_int4_tile": "tile_launches",
                    "int4_splitk_sum": "splitk_launches"},
    "flash_gqa_decode": {"flash_decode_combine": "combine_launches"},
}


def zero_counts(fns):
    """Every wrapper's launch counts (SUB_COUNTS too) set to 0."""
    for name, fn in fns.items():
        fn.launches = 0
        for attr in SUB_COUNTS.get(name, {}).values():
            setattr(fn, attr, 0)


def read_counts(fns):
    """{wrapper or SUB_COUNTS name: launches since zero_counts}."""
    c = {name: fn.launches for name, fn in fns.items()}
    for name, fn in fns.items():
        for sub, attr in SUB_COUNTS.get(name, {}).items():
            c[sub] = getattr(fn, attr)
    return c


# the kernels each decode path must launch (the first path that names a
# kernel gives its `launches`), and those it must not
PATH_KERNELS = {
    "chunk": ("flash_gqa_prefill_stacked", "gen_chunk_fused"),
    "step": ("flash_gqa_prefill_stacked", "talker_step_fused",
             "predict_frame_fused"),
    "exact": ("flash_gqa_prefill_stacked", "flash_gqa_decode_stacked",
              "flash_gqa_decode", "flash_decode_combine"),
}
PATH_FORBIDDEN = {"chunk": ("talker_step_fused", "predict_frame_fused")}
# the serving queues: on the default engine per-lane frames take the step
# schedule (never the chunk kernel); on the exact engine the decode
# attention appends at per-lane cursors
SERVING_PATH_KERNELS = {
    "step": ("flash_gqa_prefill_stacked", "talker_step_fused",
             "append_kv_lanes", "inject_prompt_lanes", "predict_frame_fused"),
    "exact": ("flash_gqa_prefill_stacked", "flash_gqa_decode_append",
              "inject_prompt_lanes"),
}
SERVING_FORBIDDEN = {"step": ("gen_chunk_fused", "flash_gqa_decode_append"),
                     "exact": ("gen_chunk_fused", "talker_step_fused")}


def profile_request(engine, voice):
    """One greedy request under torch.profiler: (frames, wall ms, device
    launches, device kernel ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from qwen3_tts_tpu_torch import SamplerConfig

    engine.set_sampler_config(SamplerConfig(seed=1, **GREEDY))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate_with_voice(REQUESTS[0][1], voice)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000.0
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    return (engine.last_metrics.frames, wall, sum(e.count for e in events),
            sum(e.self_device_time_total for e in events) / 1000.0)


def drive_engine(dev, failures):
    """The main path at full width on the three decode paths; returns
    {path: {kernel: launches}}."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
    from qwen3_tts_tpu_torch.kernels.chunk_step import gen_chunk_fused
    from qwen3_tts_tpu_torch.kernels.flash_decode import (
        flash_gqa_decode, flash_gqa_decode_stacked)
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked)
    from qwen3_tts_tpu_torch.kernels.predictor_frame import (
        predict_frame_fused)
    from qwen3_tts_tpu_torch.kernels.talker_step import talker_step_fused

    fns = {f.__name__: f for f in (
        flash_gqa_prefill_stacked, flash_gqa_decode_stacked,
        flash_gqa_decode, talker_step_fused, predict_frame_fused,
        gen_chunk_fused)}
    t0 = time.perf_counter()
    default = TtsEngine(device=dev, speakers_dir="speakers")
    torch.cuda.synchronize()
    print(f"[engine] full-width TtsEngine on {dev}: init "
          f"{time.perf_counter() - t0:.2f} s (weights packed for the "
          f"kernels), talker {default.config.talker.n_layers} layers d "
          f"{default.config.talker.d_model}, dtype "
          f"{default.config.talker.dtype}, fused={default.fused} "
          f"chunk={default.chunk}")
    if not (default.fused and default.chunk):
        failures.append("TtsEngine(device='cuda') did not resolve to the "
                        "chunk path")
    weights = dict(assets=default.assets, talker=default.talker_params,
                   predictor=default.predictor_params,
                   codec_decoder=default.codec_decoder_params)
    step = TtsEngine(device=dev, speakers_dir="speakers", fused=True,
                     chunk=False, weights=weights)
    exact = TtsEngine(device=dev, speakers_dir="speakers", fused=False,
                      weights=weights)
    spf = default.config.codec_decoder.samples_per_frame
    counts = {}
    for path, engine in (("chunk", default), ("step", step),
                         ("exact", exact)):
        engine.set_max_steps(EXACT_STEPS if path == "exact" else MAX_STEPS)
        voice = engine.get_speaker("vivian")
        codes_by_label = {}
        zero_counts(fns)
        for label, text, instruct, sampler, seed in REQUESTS:
            engine.set_sampler_config(SamplerConfig(seed=seed, **sampler))
            t0 = time.perf_counter()
            audio = engine.generate_with_voice(text, voice, instruct)
            wall_ms = (time.perf_counter() - t0) * 1000.0
            m = engine.last_metrics
            plan = engine._build_voice_prompt(text, voice, instruct)
            x = audio.samples
            frames = m.frames
            ok = (frames > 0 and len(x) == frames * spf
                  and bool(np.isfinite(x).all())
                  and float(np.abs(x).max()) > 1e-4)
            decode_ms = m.total_ms - m.prefill_ms
            print(f"[engine] {path} {label}: prompt_rows={plan.length} "
                  f"bucket={engine._bucket(plan.length)} frames={frames} "
                  f"samples={len(x)} (= frames x {spf}: "
                  f"{len(x) == frames * spf}) "
                  f"finite={bool(np.isfinite(x).all())} "
                  f"peak={float(np.abs(x).max()) if len(x) else 0.0:.4f} "
                  f"eos={m.eos} prefill_ms={m.prefill_ms:.2f} "
                  f"total_ms={m.total_ms:.2f} wall_ms={wall_ms:.2f} "
                  f"ms/frame={m.total_ms / max(frames, 1):.2f} "
                  f"decode ms/frame={decode_ms / max(frames, 1):.2f}")
            if not ok:
                failures.append(f"{path} request {label} gave bad audio")
            codes_by_label[label] = engine.last_codes
        counts[path] = read_counts(fns)
        print(f"[engine] {path} path launch counts over its requests: "
              f"{counts[path]}")
        for name in PATH_KERNELS[path]:
            if counts[path][name] <= 0:
                failures.append(f"{path} path never launched {name}")
        for name in PATH_FORBIDDEN.get(path, ()):
            if counts[path][name] != 0:
                failures.append(f"{path} path launched {name}")
        same = np.array_equal(codes_by_label["greedy-b32"],
                              codes_by_label["greedy-b32-again"])
        print(f"[engine] {path}: two greedy runs, same seed: codes "
              f"equal={same}")
        if not same:
            failures.append(f"{path}: greedy runs with one seed gave "
                            "different codes")
        frames, wall, launches, dev_ms = profile_request(engine, voice)
        print(f"[engine] {path} profiled greedy request: frames={frames} "
              f"launches/frame={launches / max(frames, 1):.1f} "
              f"device kernel ms/frame={dev_ms / max(frames, 1):.3f} "
              f"wall ms/frame (profiled)={wall / max(frames, 1):.2f} "
              f"device busy (profiled)={dev_ms / wall:.3f}")
    return counts


class _RoundLog:
    """Collects the batcher's `serve_round` events (utils.logging)."""

    def __init__(self):
        import logging
        self.rounds = []
        self.handler = logging.Handler(logging.DEBUG)
        self.handler.emit = self._emit

    def _emit(self, record):
        msg = record.getMessage()
        if msg.startswith("{") and '"serve_round"' in msg:
            self.rounds.append(json.loads(msg))

    def __enter__(self):
        import logging
        from qwen3_tts_tpu_torch.utils.logging import get_logger
        log = get_logger()
        self.level = log.level
        # keep the other handlers (stderr) at the logger's old threshold
        # while the logger passes DEBUG records; restored on exit
        self.others = [(h, h.level) for h in log.handlers]
        for h, lvl in self.others:
            if lvl == logging.NOTSET:
                h.setLevel(log.getEffectiveLevel())
        log.setLevel(logging.DEBUG)
        log.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        from qwen3_tts_tpu_torch.utils.logging import get_logger
        log = get_logger()
        log.removeHandler(self.handler)
        log.setLevel(self.level)
        for h, lvl in self.others:
            h.setLevel(lvl)


def serving_queue(n, budgets, long_every=3):
    """n requests over prompt buckets 32 and 128 (every long_every-th
    long)."""
    out = []
    for i in range(n):
        long_ = i % long_every == long_every - 1
        text = SERVING_TEXTS[1 if long_ else 0] + f" {i}."
        out.append((text, budgets[i % len(budgets)]))
    return out


def drive_serving(dev, failures):
    """Continuous batching at full width on the card's default engine
    (per-lane frames take the step schedule) and on the exact path;
    returns {queue: {kernel: launches}}."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
    from qwen3_tts_tpu_torch.kernels import flash_decode as fd
    from qwen3_tts_tpu_torch.kernels.chunk_step import gen_chunk_fused
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked)
    from qwen3_tts_tpu_torch.kernels.predictor_frame import (
        predict_frame_fused)
    from qwen3_tts_tpu_torch.kernels.talker_step import talker_step_fused
    from qwen3_tts_tpu_torch.runtime import generate as tg
    from qwen3_tts_tpu_torch.serve.batch import BatchRequest
    from qwen3_tts_tpu_torch.serve.codec_path import LaneCodec
    from qwen3_tts_tpu_torch.serve.continuous import ContinuousBatcher

    fns = {f.__name__: f for f in (
        flash_gqa_prefill_stacked, fd.flash_gqa_decode_stacked,
        fd.flash_gqa_decode_append, fd.inject_prompt_lanes,
        fd.append_kv_lanes, talker_step_fused, predict_frame_fused,
        gen_chunk_fused)}
    engine = TtsEngine(device=dev, speakers_dir="speakers")
    exact = TtsEngine(device=dev, speakers_dir="speakers", fused=False,
                      weights=dict(assets=engine.assets,
                                   talker=engine.talker_params,
                                   predictor=engine.predictor_params,
                                   codec_decoder=engine.codec_decoder_params))
    spf = engine.config.codec_decoder.samples_per_frame
    counts, audio_by_queue = {}, {}
    # each queue holds more requests of bucket 32 than it has lanes, so
    # freed lanes are refilled (inject_prompt_lanes) on every engine
    queues = (("serving-b8", engine, 8, serving_queue(20, (6, 12, 24))),
              ("serving-b32", engine, 32,
               serving_queue(48, (8, 10, 12, 14, 16), long_every=6)),
              ("serving-b8-again", engine, 8,
               serving_queue(20, (6, 12, 24))),
              ("serving-exact", exact, 4,
               serving_queue(6, (4, 6, 8), long_every=6)))
    for name, eng, batch, queue in queues:
        eng.set_sampler_config(SamplerConfig(seed=7, **GREEDY))
        voice = eng.get_speaker("vivian")
        reqs = [BatchRequest(t, voice, max_frames=m) for t, m in queue]
        batcher = ContinuousBatcher(eng, batch_size=batch,
                                    max_frames_per_stream=max(
                                        m for _, m in queue))
        zero_counts(fns)
        torch.cuda.synchronize()
        with _RoundLog() as log:
            t0 = time.perf_counter()
            results = batcher.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts[name] = read_counts(fns)
        ok = len(results) == len(reqs)
        for r, (_, m) in zip(results, queue):
            x = r.audio.samples
            ok = ok and (0 < r.frames <= m and len(x) == r.frames * spf
                         and bool(np.isfinite(x).all())
                         and float(np.abs(x).max()) > 1e-4)
        frames = sum(r.frames for r in results)
        ttft = sorted(r.ttft_ms for r in results)
        groups = [rd["group_ms"] for rd in log.rounds]
        steps = sum(rd["group_chunks"] for rd in log.rounds) \
            * engine.config.runtime.frames_per_chunk
        n_launch = sum(counts[name].values())
        print(f"[serving] {name}: batch {batch}, {len(reqs)} requests, "
              f"buckets {sorted({eng._bucket(eng._build_voice_prompt(t, voice, None).length) for t, _ in queue})}, "
              f"{frames} frames in {wall:.2f} s = {frames / wall:.1f} "
              f"frames/s; TTFT p50 {np.percentile(ttft, 50):.1f} ms p90 "
              f"{np.percentile(ttft, 90):.1f} ms; {len(groups)} groups, "
              f"{np.mean(groups):.1f} ms per group (median "
              f"{np.median(groups):.1f}); frame-steps <= {steps}; port "
              f"kernel launches per frame-step {n_launch / max(steps, 1):.2f}"
              f"; audio frames x {spf}, finite, non-silent, within budget="
              f"{ok}")
        digest = hashlib.sha256(b"".join(
            np.ascontiguousarray(r.audio.samples).tobytes()
            for r in results)).hexdigest()[:16]
        print(f"[serving] {name} launch counts: {counts[name]}; audio "
              f"sha256 {digest} (equal digests: equal greedy codes)")
        if not ok:
            failures.append(f"{name}: a result is not frames x {spf} "
                            "finite samples within its budget")
        audio_by_queue[name] = [r.audio.samples for r in results]
        for k_ in SERVING_PATH_KERNELS["exact" if eng is exact else "step"]:
            if counts[name][k_] <= 0:
                failures.append(f"{name} never launched {k_}")
        for k_ in SERVING_FORBIDDEN.get("exact" if eng is exact else "step",
                                        ()):
            if counts[name][k_] != 0:
                failures.append(f"{name} launched {k_}")
    same = all(np.array_equal(a, b) for a, b in zip(
        audio_by_queue["serving-b8"], audio_by_queue["serving-b8-again"]))
    print(f"[serving] batch-8 queue rerun (greedy, same seed): audio "
          f"identical={same}")
    if not same:
        failures.append("serving-b8: the rerun gave different audio")

    # a refilled lane's prefill logits against a solo prefill of its prompt
    voice = engine.get_speaker("vivian")
    plan_a = engine._build_voice_prompt(SERVING_TEXTS[0], voice, None)
    plan_b = engine._build_voice_prompt("Replacement", voice, None)
    bucket = engine._bucket(max(plan_a.length, plan_b.length))
    with torch.no_grad():
        gen = engine.generator
        embeds, lens = engine.prompt_to_device([plan_a] * 4, bucket)
        state = gen.start(embeds, torch.from_numpy(lens).to(dev),
                          torch.Generator(device=dev).manual_seed(0))
        state, _, _ = tg.gen_frames(
            engine.config, gen.talker_params, gen.predictor_params,
            gen.assets_pack, state, tg.SamplerParams(0.0, 40, 0.9), 4,
            bucket, uniform_cursor=False)
        eb, lb = engine.prompt_to_device([plan_b], bucket)
        state = gen.refill_lanes(state, eb, [int(lb[0])], [1])
        solo = gen.start(eb, torch.from_numpy(lb).to(dev),
                         torch.Generator(device=dev).manual_seed(0))
        err = (state.logits[1].float() - solo.logits[0].float()).abs()
        ok = bool((err <= REFILL_ATOL + REFILL_RTOL
                   * solo.logits[0].float().abs()).all())
        print(f"[serving] refilled lane 1 vs a solo prefill of its prompt: "
              f"logits max_abs_err={err.max().item():.3e} (tol "
              f"{REFILL_ATOL} + {REFILL_RTOL}*|solo|) within={ok}; lane "
              f"cursors {state.cache.write_idx.tolist()}")
        if not ok:
            failures.append("a refilled lane's logits differ from a solo "
                            "prefill")

        # one profiled group: batch 8, two chunks per lane
        from torch.profiler import ProfilerActivity, profile
        plans = [engine._build_voice_prompt(t, voice, None) for t, _ in
                 serving_queue(8, (8,))]
        bucket = engine._bucket(max(p.length for p in plans))
        embeds, lens = engine.prompt_to_device(plans, bucket)
        state = gen.start(embeds, torch.from_numpy(lens).to(dev),
                          torch.Generator(device=dev).manual_seed(0))
        codec = LaneCodec(engine, 8)
        sampler = tg.SamplerParams(0.0, 40, 0.9)
        n = engine.config.runtime.frames_per_chunk
        state, *_ = codec.run_group(state, sampler, prompt_cap=bucket,
                                    n_frames=n, max_frames=n,
                                    budgets=[n] * 8)        # warm
        state.done[:] = False
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            codec.run_group(state, sampler, prompt_cap=bucket, n_frames=n,
                            max_frames=2 * n, budgets=[2 * n] * 8)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    launches = sum(e.count for e in events)
    dev_ms = sum(e.self_device_time_total for e in events) / 1000.0
    print(f"[serving] profiled group: batch 8, {2 * n} frame-steps: wall "
          f"{wall:.2f} ms ({wall / (2 * n):.2f} ms per frame-step), device "
          f"launches per frame-step {launches / (2 * n):.1f}, device kernel "
          f"ms per frame-step {dev_ms / (2 * n):.3f}, device busy "
          f"(profiled) {dev_ms / wall:.3f}")
    return counts


# the online phase: OnlineBatcher at batch 8 (bucket 32) from client
# threads, an OnlineRouter over buckets 32 and 128 at batch 4 with both
# buckets busy, and the HTTP API over that router
ONLINE_BUDGETS = (6, 12, 24)
ONLINE_REQUESTS, ONLINE_CLIENTS = 20, 4
ONLINE_STAGGER_S = 0.02      # between one client's submissions
ROUTER_REQUESTS = 6          # a bucket


def _online_voice_requests(eng, n, budgets, long_=False):
    from qwen3_tts_tpu_torch.serve.batch import BatchRequest
    voice = eng.get_speaker("vivian")
    return [BatchRequest(SERVING_TEXTS[1 if long_ else 0] + f" {i}.", voice,
                         max_frames=budgets[i % len(budgets)])
            for i in range(n)]


def _audio_ok(r, budget, spf):
    import numpy as np
    x = r.audio.samples
    return (0 < r.frames <= budget and len(x) == r.frames * spf
            and bool(np.isfinite(x).all()) and float(np.abs(x).max()) > 1e-4)


def _one_at_a_time(batcher, reqs, timeout=600):
    """Each request submitted after the one before resolved."""
    return [batcher.submit(r).result(timeout=timeout) for r in reqs]


def drive_online(dev, failures):
    """Online serving at full width on the card's default engine (its
    per-lane frames take the step schedule): an OnlineBatcher, an
    OnlineRouter with two buckets busy at once, and the HTTP API over the
    router; returns {"online-b8": {kernel: launches}}."""
    import threading
    import urllib.request
    import wave
    import io
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
    from qwen3_tts_tpu_torch.kernels import flash_decode as fd
    from qwen3_tts_tpu_torch.kernels.chunk_step import gen_chunk_fused
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked)
    from qwen3_tts_tpu_torch.kernels.predictor_frame import (
        predict_frame_fused)
    from qwen3_tts_tpu_torch.kernels.talker_step import talker_step_fused
    from qwen3_tts_tpu_torch.serve.api import TtsServer
    from qwen3_tts_tpu_torch.serve.online import OnlineBatcher, OnlineRouter

    fns = {f.__name__: f for f in (
        flash_gqa_prefill_stacked, fd.flash_gqa_decode_stacked,
        fd.flash_gqa_decode_append, fd.inject_prompt_lanes,
        fd.append_kv_lanes, talker_step_fused, predict_frame_fused,
        gen_chunk_fused)}
    engine = TtsEngine(device=dev, speakers_dir="speakers")
    engine.set_sampler_config(SamplerConfig(seed=7, **GREEDY))
    spf = engine.config.codec_decoder.samples_per_frame
    n_budget = max(ONLINE_BUDGETS)

    # 1. OnlineBatcher, batch 8: client threads with staggered arrivals
    reqs = _online_voice_requests(engine, ONLINE_REQUESTS, ONLINE_BUDGETS)
    batcher = OnlineBatcher(engine, batch_size=8, bucket=32,
                            max_frames_per_stream=n_budget,
                            idle_poll_s=0.005)
    results, latency = [None] * len(reqs), [None] * len(reqs)

    def client(c):
        """This client's requests, each ONLINE_STAGGER_S after the one
        before (not after its result): the lanes fill, and free lanes are
        refilled from the queue."""
        futs = []
        for i in range(c, len(reqs), ONLINE_CLIENTS):
            time.sleep(ONLINE_STAGGER_S)
            t_sub = time.perf_counter()
            fut = batcher.submit(reqs[i])
            # run by the worker as it sets the result (stop() joins it)
            fut.add_done_callback(
                lambda f, i=i, t_sub=t_sub: latency.__setitem__(
                    i, (time.perf_counter() - t_sub) * 1e3))
            futs.append((i, fut))
        for i, fut in futs:
            results[i] = fut.result(timeout=600)

    zero_counts(fns)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(ONLINE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    batcher.stop()
    counts = {"online-b8": read_counts(fns)}
    ok = all(r is not None and _audio_ok(r, q.max_frames, spf)
             for r, q in zip(results, reqs))
    frames = sum(r.frames for r in results if r is not None)
    print(f"[online] OnlineBatcher batch 8 bucket 32: {len(reqs)} greedy "
          f"requests (budgets {ONLINE_BUDGETS}) from {ONLINE_CLIENTS} client "
          f"threads, each submitting every {ONLINE_STAGGER_S * 1e3:.0f} ms: "
          f"{len(reqs) / wall:.2f} requests/s, "
          f"{frames / wall:.1f} frames/s, latency p50 "
          f"{np.percentile(latency, 50):.1f} ms p90 "
          f"{np.percentile(latency, 90):.1f} ms (submit to result); every "
          f"future resolved with 0 < frames <= budget, frames x {spf} "
          f"finite non-silent samples={ok}")
    print(f"[online] online-b8 launch counts: {counts['online-b8']}")
    if not ok:
        failures.append("online-b8: a request did not resolve to frames x "
                        f"{spf} finite samples within its budget")
    for k_ in SERVING_PATH_KERNELS["step"]:
        if counts["online-b8"][k_] <= 0:
            failures.append(f"online-b8 never launched {k_}")
    for k_ in SERVING_FORBIDDEN["step"]:
        if counts["online-b8"][k_] != 0:
            failures.append(f"online-b8 launched {k_}")

    # the same requests one at a time, twice: equal codes (greedy; the
    # native codec's audio is a function of the codes)
    runs = []
    for _ in range(2):
        ob = OnlineBatcher(engine, batch_size=8, bucket=32,
                           max_frames_per_stream=n_budget,
                           idle_poll_s=0.005)
        t0 = time.perf_counter()
        runs.append(_one_at_a_time(ob, reqs))
        ob.stop()
    same = all(np.array_equal(a.audio.samples, b.audio.samples)
               and a.frames == b.frames for a, b in zip(*runs))
    print(f"[online] the same {len(reqs)} requests one at a time, twice: "
          f"audio (codes) equal={same}; the last run "
          f"{time.perf_counter() - t0:.2f} s")
    if not same:
        failures.append("online-b8: one-at-a-time reruns gave different "
                        "codes")

    # 2. OnlineRouter, buckets 32 and 128 at batch 4, both busy at once
    # (one client a bucket, each request after the one before: a fixed
    # schedule per bucket), against the same per-bucket sequences run one
    # bucket after the other: each worker's launches must not meet the
    # other's scratch (engine.device_lock)
    seqs = {32: _online_voice_requests(engine, ROUTER_REQUESTS, (8, 12, 4)),
            128: _online_voice_requests(engine, ROUTER_REQUESTS, (12, 4, 8),
                                        long_=True)}
    for bucket, rs in seqs.items():
        rows = {engine._bucket(engine._build_voice_prompt(
            r.text, r.voice, None).length) for r in rs}
        if rows != {bucket}:
            failures.append(f"router requests meant for bucket {bucket} "
                            f"land in {rows}")

    def router_run(together):
        router = OnlineRouter(engine, batch_size=4, buckets=(32, 128),
                              max_frames_per_stream=12, idle_poll_s=0.005)
        out = {}
        t0 = time.perf_counter()
        if together:
            threads = [threading.Thread(
                target=lambda b=b: out.__setitem__(
                    b, _one_at_a_time(router, seqs[b]))) for b in seqs]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            for b in seqs:
                out[b] = _one_at_a_time(router, seqs[b])
        wall = time.perf_counter() - t0
        router.stop()
        return out, wall

    apart, wall_a = router_run(False)
    together, wall_t = router_run(True)
    same = all(np.array_equal(a.audio.samples, b.audio.samples)
               and a.frames == b.frames for bk in seqs
               for a, b in zip(apart[bk], together[bk]))
    ok = all(_audio_ok(r, q.max_frames, spf) for bk in seqs
             for r, q in zip(together[bk], seqs[bk]))
    print(f"[online] OnlineRouter buckets (32, 128) batch 4, "
          f"{ROUTER_REQUESTS} requests a bucket: one bucket after the other "
          f"{wall_a:.2f} s, both at once {wall_t:.2f} s; each request's "
          f"audio (codes) equal across the two={same}; audio ok={ok}")
    if not (same and ok):
        failures.append("online router: two busy buckets gave other codes "
                        "than one bucket after the other, or bad audio")

    # 3. the HTTP API over a router: /health, 8 concurrent /tts, and one
    # direct-mode stream while the batcher serves
    router = OnlineRouter(engine, batch_size=4, buckets=(32, 128),
                          max_frames_per_stream=12, idle_poll_s=0.005)
    srv = TtsServer(engine, host="127.0.0.1", port=0, batcher=router).start()
    url = f"http://127.0.0.1:{srv.port}"
    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.loads(r.read())
        print(f"[online] GET /health: {health['status']}, "
              f"{len(health['speakers'])} speakers")
        if health["status"] != "ok" or "vivian" not in health["speakers"]:
            failures.append("GET /health did not answer ok with vivian")

        def post(path, body):
            req = urllib.request.Request(
                url + path, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                headers, data = dict(r.headers), r.read()
            return headers, data, (time.perf_counter() - t0) * 1e3

        answers = [None] * 8
        stream = {}

        def tts(i):
            answers[i] = post("/tts", {"text": SERVING_TEXTS[i % 2]
                                       + f" http {i}.",
                                       "max_steps": (4, 8, 12)[i % 3]})

        def streamer():
            time.sleep(0.05)           # the batcher is serving by then
            stream["out"] = post("/tts?stream=1", {
                "text": "A direct stream beside the batcher.", "seed": 1,
                "temperature": 0.0, "max_steps": 12})

        t0 = time.perf_counter()
        threads = ([threading.Thread(target=tts, args=(i,))
                    for i in range(8)] + [threading.Thread(target=streamer)])
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        ok = True
        for i, (headers, data, _) in enumerate(answers):
            frames = int(headers.get("X-QTTS-Frames", -1))
            with wave.open(io.BytesIO(data)) as w:
                good = (headers.get("Content-Type") == "audio/wav"
                        and w.getnchannels() == 1
                        and w.getframerate() == 24000
                        and 0 < frames <= (4, 8, 12)[i % 3]
                        and w.getnframes() == frames * spf)
            ok = ok and good
        lat = [a[2] for a in answers]
        s_headers, pcm, s_ms = stream["out"]
        n = len(pcm) // 2
        s_ok = (s_headers.get("Content-Type", "").startswith("audio/L16")
                and s_headers.get("Transfer-Encoding") == "chunked"
                and 0 < n and n % spf == 0 and n // spf <= 12)
        print(f"[online] HTTP: 8 concurrent POST /tts through the router in "
              f"{wall:.2f} s ({8 / wall:.2f} requests/s), latency p50 "
              f"{np.percentile(lat, 50):.1f} ms p90 "
              f"{np.percentile(lat, 90):.1f} ms; each a mono 24 kHz WAV of "
              f"X-QTTS-Frames x {spf} samples={ok}; one direct POST "
              f"/tts?stream=1 beside them: chunked audio/L16, {n} samples "
              f"({n // spf} frames) in {s_ms:.1f} ms, ok={s_ok}")
        if not ok:
            failures.append("HTTP /tts through the router gave a bad WAV")
        if not s_ok:
            failures.append("HTTP /tts?stream=1 beside the batcher gave no "
                            "chunked PCM of whole frames")
    finally:
        srv.stop()
        router.stop()
    return counts


# the spec phase: B lanes at bucket 128 and per-lane cursors, K drafted
# frames a call
SPEC_B, SPEC_K = 4, 4
SPEC_MISMATCH_AT = (4, 2, 0, 1)      # uneven acceptance, by lane
SPEC_CONTINUE = 8                    # sequential frames after it
# the verify forward's logits against K sequential steps' (the prefill
# kernel with bf16 p in P.V against the decode kernel's f32, through 28
# layers): relative to max |logit|, REF_REL_TOL's bf16-model class
SPEC_LOGIT_TOL = REF_REL_TOL


def clone_state(st):
    """A copy of a GenState that shares nothing with it (the cache is
    written in place)."""
    import dataclasses
    import torch
    g = torch.Generator(device=st.generator.device)
    g.set_state(st.generator.get_state())
    cache = dataclasses.replace(st.cache, k=st.cache.k.clone(),
                                v=st.cache.v.clone(),
                                write_idx=st.cache.write_idx.clone(),
                                lengths=st.cache.lengths.clone())
    return dataclasses.replace(st, cache=cache, logits=st.logits.clone(),
                               hidden=st.hidden.clone(), pos=st.pos.clone(),
                               done=st.done.clone(), generator=g)


def spec_base_state(eng, sampler):
    """SPEC_B lanes of bucket 128 at four cursors: 8 frames, lane 1
    refilled, 4 frames, lane 2 refilled, 4 frames (cursors 144 / 136 / 132
    / 144 past the bucket).  Returns (state, the frame emitted last a lane
    [B, 16])."""
    import torch
    from qwen3_tts_tpu_torch.runtime import generate as tg
    gen = eng.generator
    voice = eng.get_speaker("vivian")
    plans = [eng._build_voice_prompt(SERVING_TEXTS[1] + f" spec {i}.",
                                     voice, None) for i in range(SPEC_B + 2)]
    embeds, lens = eng.prompt_to_device(plans[:SPEC_B], 128)
    st = gen.start(embeds, torch.from_numpy(lens).to(eng.device),
                   torch.Generator(device=eng.device).manual_seed(0))
    for n, refill in ((8, 1), (4, 2), (4, None)):
        st, codes, _ = tg.gen_frames(eng.config, gen.talker_params,
                                     gen.predictor_params, gen.assets_pack,
                                     st, sampler, n, 128,
                                     uniform_cursor=False)
        if refill is not None:
            eb, lb = eng.prompt_to_device([plans[SPEC_B + refill - 1]], 128)
            st = gen.refill_lanes(st, eb, [int(lb[0])], [refill])
    return st, codes[:, -1].contiguous()


def run_frames(eng, st, sampler, n):
    """n frames at per-lane cursors from st (written in place), one at a
    time: (state, codes [B, n, 16], and for each frame the carried logits
    [B, n, V] and hidden [B, n, D] that picked it)."""
    import torch
    from qwen3_tts_tpu_torch.runtime import generate as tg
    gen = eng.generator
    codes, logits, hidden = [], [], []
    for _ in range(n):
        logits.append(st.logits.float())
        hidden.append(st.hidden)
        st, c, _ = tg.gen_frames(eng.config, gen.talker_params,
                                 gen.predictor_params, gen.assets_pack, st,
                                 sampler, 1, 128, uniform_cursor=False)
        codes.append(c[:, 0])
    return (st, torch.stack(codes, 1), torch.stack(logits, 1),
            torch.stack(hidden, 1))


def predictor_windows(eng, hidden, codes, h1024=None):
    """The exact predictor's 15 window logits [N, 15, 2048] (f32) on talker
    hidden [N, D] with each frame's own codes [N, 16] fed back:
    models/predictor.predict_frame's operations in its order and batch, so
    window q - 1 holds the logits that picked code q of a frame the
    predictor picked on that batch.  h1024: the predictor's input [N,
    1024] in place of hidden.  On a rank's block of the weights (a mesh)
    the row-parallel predictor."""
    import torch
    from qwen3_tts_tpu_torch.models import transformer
    from qwen3_tts_tpu_torch.ops.quant import head_matmul_slice
    from qwen3_tts_tpu_torch.ops.rope import inv_freq_tensor, rope_cos_sin
    cfg, params = eng.config.predictor, eng.generator.predictor_params
    pack = eng.generator.assets_pack
    tables = pack["codec_tables_1024"]
    if h1024 is None:
        h1024 = (hidden.float() @ pack["proj_w"].float().t()
                 + pack["proj_b"].float())
    n, dev = h1024.shape[0], h1024.device
    dtype = transformer.dtype_of(cfg.dtype)
    inv_freq = inv_freq_tensor(cfg.head_dim, cfg.rope_theta, dev)
    cache = transformer.init_kv_cache(cfg, n, 2 + cfg.n_residual_codebooks,
                                      dtype, dev, params)
    x = torch.stack([h1024, tables[0][codes[:, 0].long()].float()],
                    dim=1).to(dtype)
    cos, sin = rope_cos_sin(torch.arange(2, device=dev)[None, :]
                            .expand(n, 2), inv_freq)
    h, cache = transformer.decoder_forward(cfg, params, x, cos, sin, cache,
                                           prompt_cap=0)
    out = [head_matmul_slice(h[:, -1], params["lm_head"], 0,
                             cfg.codebook_size)]
    for q in range(1, cfg.n_residual_codebooks):
        emb = tables[q][codes[:, q].long()].to(dtype)
        cos, sin = rope_cos_sin(torch.full((n, 1), q + 1, device=dev),
                                inv_freq)
        h, cache = transformer.decoder_forward(cfg, params, emb[:, None, :],
                                               cos, sin, cache, prompt_cap=0)
        out.append(head_matmul_slice(h[:, 0], params["lm_head"],
                                     q * cfg.codebook_size,
                                     cfg.codebook_size))
    return torch.stack(out, 1).float()


def spec_tie(eng, sides, x, y):
    """Where frame x (the sequential run's) and frame y (another run's)
    first part: how far each side's pick leads the other's in its own
    logits (code 0: the talker's carried logits; a residual token: the
    predictor's window logits, which the tokens before it, equal on both
    sides, led to), over max |logit|, and how far the two sides' logits
    there lie apart.  A near tie: the two sides' logits within
    SPEC_LOGIT_TOL of max |logit| of each other, and each side's pick
    ahead of the other's by at most twice that distance.  sides: two
    dicts, {"logits": [V] the carried logits that picked code 0, "hidden":
    [N, D] and "codes": [N, 16] the predictor's rows as that run gave them
    (its batch), "row": this lane's row}.  Returns (near tie, text)."""
    tok = next(t for t in range(16) if int(x[t]) != int(y[t]))
    if tok == 0:
        ls, lv = (side["logits"] for side in sides)
    else:
        ls, lv = (predictor_windows(eng, side["hidden"], side["codes"])[
            side["row"], tok - 1] for side in sides)
    a, b = int(x[tok]), int(y[tok])
    scale = max(ls.abs().max().item(), lv.abs().max().item())
    lead_s = (ls[a] - ls[b]).item() / scale
    lead_v = (lv[b] - lv[a]).item() / scale
    apart = (ls - lv).abs().max().item() / scale
    tie = (apart <= SPEC_LOGIT_TOL and 0 <= lead_s <= 2 * apart
           and 0 <= lead_v <= 2 * apart)
    return tie, (f"token {tok}: sequential picks {a}, {lead_s:.3e} above "
                 f"{b}; the other picks {b}, {lead_v:.3e} above {a} (of max "
                 f"|logit| {scale:.3f}); the two sides' logits {apart:.3e} "
                 f"apart (at most {SPEC_LOGIT_TOL}): near tie={tie}")


def drive_spec(dev, failures):
    """Speculative decode (runtime/spec.gen_frames_spec) at full width: the
    engine phase's weights on a fused=False engine (the same weights at
    S = K and S = 1), B = 4 lanes at four cursors, bucket 128, K = 4; then
    the same drafts on the default engine, whose decode step multiplies
    the packed w4a8 weights (acceptance printed).

    Held exactly: every call's frames equal the targets computed apart
    (the verify forward on a copy of the state, the exact predictor on its
    B * K hidden rows); n_emit = min(n_acc + 1, K); the cursors advance by
    n_emit and the step by K; drafts fed back from the call's own targets
    (at most K times) reach a fixed point that every lane accepts whole
    (n_emit = K); uneven acceptance of that draft emits the fixed point's
    frames; and the frames after it do not depend on the rejected drafts.
    Held against K + SPEC_CONTINUE sequential steps: the verify forward's
    logits, and the logits that pick each frame of a lane's stream (the
    frames emitted, then SPEC_CONTINUE sequential ones), within
    SPEC_LOGIT_TOL up to the frame where the stream parts from the
    sequential one, which must be a near tie (spec_tie): the verify
    forward and the sequential steps sum in other orders (cuBLAS at B * K
    rows against B, the prefill kernel's bf16 p against the decode
    kernel's f32).  Returns {"spec-exact": {kernel: launches},
    "spec-default": ...}."""
    import torch
    from qwen3_tts_tpu_torch import TtsEngine
    from qwen3_tts_tpu_torch.kernels import flash_decode as fd
    from qwen3_tts_tpu_torch.kernels.chunk_step import gen_chunk_fused
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked)
    from qwen3_tts_tpu_torch.kernels.predictor_frame import (
        predict_frame_fused)
    from qwen3_tts_tpu_torch.kernels.talker_step import talker_step_fused
    from qwen3_tts_tpu_torch.models import predictor as predictor_lib
    from qwen3_tts_tpu_torch.models import talker as talker_lib
    from qwen3_tts_tpu_torch.ops.sampling import sample_logits
    from qwen3_tts_tpu_torch.runtime import generate as tg
    from qwen3_tts_tpu_torch.runtime import spec

    fns = {f.__name__: f for f in (
        flash_gqa_prefill_stacked, fd.flash_gqa_decode_stacked,
        fd.flash_gqa_decode_append, fd.append_kv_lanes,
        fd.inject_prompt_lanes, talker_step_fused, predict_frame_fused,
        gen_chunk_fused)}
    default = TtsEngine(device=dev, speakers_dir="speakers")
    exact = TtsEngine(device=dev, speakers_dir="speakers", fused=False,
                      weights=dict(assets=default.assets,
                                   talker=default.talker_params,
                                   predictor=default.predictor_params,
                                   codec_decoder=default.codec_decoder_params))
    sampler = tg.SamplerParams(0.0, 40, 0.9)
    k, b = SPEC_K, SPEC_B
    counts = {}
    with torch.no_grad():
        base, last = spec_base_state(exact, sampler)
        cursors = base.cache.write_idx.tolist()
        _, ref, ref_lb, ref_hb = run_frames(exact, clone_state(base),
                                            sampler, k + SPEC_CONTINUE)
        gen = exact.generator
        pack = gen.assets_pack

        def run(draft):
            return spec.gen_frames_spec(exact.config, gen.talker_params,
                                        gen.predictor_params, pack,
                                        clone_state(base), draft, sampler,
                                        128)

        def targets(draft):
            """The target frames of `draft` computed apart from
            gen_frames_spec, at full depth: the verify forward on a copy of
            base, code 0 the greedy pick of the carried logits (position 0)
            or of the verify row before, the residual codes the exact
            predictor on those B * K hidden rows.  Returns (codes [B, K,
            16], for each position the sides' dict of spec_tie but "row",
            the verify forward's logits [B, K, V])."""
            fb = (tg._frame_emb_sum(pack["codec_tables"],
                                    draft.reshape(-1, 16))
                  .reshape(b, k, -1) + pack["tts_pad"].float())
            v = clone_state(base)
            vl, vh, _ = talker_lib.talker_verify_frames(
                exact.config.talker, gen.talker_params, fb, v.pos, v.cache,
                128)
            lb = torch.cat([base.logits[:, None].to(vl.dtype),
                            vl[:, :-1]], 1)
            hb = torch.cat([base.hidden[:, None].to(vh.dtype),
                            vh[:, :-1]], 1).reshape(b * k, -1)
            g = torch.Generator(device=dev)         # greedy: no draws
            c0 = torch.stack([sample_logits(lb[:, p], g, 0.0, 40, 0.9)
                              for p in range(k)], 1)
            h1024 = (hb.float() @ pack["proj_w"].float().t()
                     + pack["proj_b"].float())
            codes = predictor_lib.predict_frame(
                exact.config.predictor, gen.predictor_params, h1024,
                c0.reshape(-1), pack["codec_tables_1024"]).reshape(b, k, 16)
            side = dict(logits=lb.float(), hidden=hb,
                        codes=codes.reshape(b * k, 16))
            return codes, side, vl.float()

        def ver_side(side, lane, p):
            return dict(side, logits=side["logits"][lane, p],
                        row=lane * k + p)

        def seq_side(lane, j):
            """The sequential run's frame j of `lane`."""
            return dict(logits=ref_lb[lane, j], hidden=ref_hb[:, j],
                        codes=ref[:, j], row=lane)

        def along(lane, frames, other_side):
            """Lane `lane`'s stream `frames` [n, 16] against the sequential
            run's first n frames: equal up to the first that parts, which
            must be a near tie; the logits that picked each frame up to it
            within SPEC_LOGIT_TOL of the sequential run's (of their max
            |logit|).  other_side(j): frame j's side.  Returns (held, the
            frame where it parts or None, text)."""
            for j in range(frames.shape[0]):
                seq, other = seq_side(lane, j), other_side(j)
                err = ((other["logits"] - seq["logits"]).abs().max()
                       / seq["logits"].abs().max()).item()
                if not err <= SPEC_LOGIT_TOL:
                    return False, j, (f"frame {j}'s logits {err:.3e} of max "
                                      f"|logit| from the sequential run's "
                                      f"(tol {SPEC_LOGIT_TOL})")
                if not torch.equal(frames[j], ref[lane, j]):
                    tie, text = spec_tie(exact, (seq, other), ref[lane, j],
                                         frames[j])
                    return tie, j, f"parts at frame {j} {text}"
            return True, None, ""

        def rule(codes, n_emit, draft):
            """n_emit = min(n_acc + 1, K) in every lane, n_acc the leading
            frames equal to the draft."""
            acc = torch.cumprod((codes == draft).all(-1).to(torch.int32),
                                1).sum(1)
            return torch.equal(n_emit.long(), torch.clamp(acc + 1,
                                                          max=k).long())

        # the verify forward on the sequential frames' feedback, alone
        t_a, side_a, ver_logits = targets(ref[:, :k])
        seq_after = ref_lb[:, 1:k + 1]        # the logits after frames 0..K-1
        scale = seq_after.abs().max().item()
        v_err = (ver_logits - seq_after).abs().max().item()
        print(f"[spec] B={b} lanes at cursors {cursors} (bucket 128), "
              f"K={k}: verify forward's logits against {k} sequential "
              f"steps' (exact path): max_abs_err {v_err:.4e} = "
              f"{v_err / scale:.3e} of max |logit| {scale:.3f} "
              f"(tol {SPEC_LOGIT_TOL})")
        if not v_err <= SPEC_LOGIT_TOL * scale:
            failures.append("spec: the verify forward's logits leave the "
                            "sequential steps'")

        # (a) drafts = the sequential next K frames
        draft_a = ref[:, :k].contiguous()
        zero_counts(fns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_a, codes_a, _, n_a = run(draft_a)
        torch.cuda.synchronize()
        ms_a = (time.perf_counter() - t0) * 1e3
        counts["spec-exact"] = read_counts(fns)
        ok_a = (torch.equal(codes_a, t_a) and rule(codes_a, n_a, draft_a)
                and st_a.cache.write_idx.tolist()
                == [c + n for c, n in zip(cursors, n_a.tolist())]
                and st_a.step == base.step + k)
        for lane in range(b):
            held, at, text = along(lane, codes_a[lane, :int(n_a[lane])],
                                   lambda j: ver_side(side_a, lane, j))
            ok_a = ok_a and held
            if at is not None:
                print(f"[spec] (a) lane {lane}: {text}")
        print(f"[spec] (a) drafts = the sequential next {k} frames: n_emit "
              f"{n_a.tolist()}; frames equal to the targets computed apart "
              f"(verify forward + exact predictor on its {b * k} hidden "
              f"rows)={torch.equal(codes_a, t_a)}, n_emit = min(n_acc + 1, "
              f"K)={rule(codes_a, n_a, draft_a)}; held={ok_a}; cursors "
              f"{st_a.cache.write_idx.tolist()}, step {st_a.step}; one call "
              f"{ms_a:.1f} ms; launches {counts['spec-exact']}")
        if not ok_a:
            failures.append("spec (a): the sequential drafts' call left its "
                            "targets, the acceptance rule, the cursors or "
                            "the sequential stream away from a near tie")

        # (a') full acceptance: the call's own targets fed back as drafts
        # until every lane accepts all K (n_emit = K already at K - 1
        # accepted: the K-th frame is the target's)
        draft_f = draft_a
        for calls in range(1, k + 2):
            st_f, codes_f, _, n_f = run(draft_f)
            if torch.equal(codes_f, draft_f):
                break
            draft_f = codes_f.contiguous()
        t_f, side_f, _ = targets(draft_f)
        ok_f = (bool((n_f == k).all()) and torch.equal(codes_f, draft_f)
                and torch.equal(codes_f, t_f)
                and st_f.cache.write_idx.tolist()
                == [c + k for c in cursors] and st_f.step == base.step + k)
        print(f"[spec] (a') drafts fed back from the call's own targets: "
              f"every lane accepts all {k} after {calls} calls (at most "
              f"{k + 1}): n_emit {n_f.tolist()}, frames = draft = targets "
              f"computed apart, cursors {st_f.cache.write_idx.tolist()} "
              f"(+{k}), step {st_f.step}; held={ok_f}")
        if not ok_f:
            failures.append(f"spec (a'): a fixed-point draft was not "
                            f"accepted whole in every lane (n_emit "
                            f"{n_f.tolist()})")

        # (b) repeat_draft of each lane's last frame: position 0 is
        # picked by the carried state, whatever the draft
        draft_b = spec.repeat_draft(last, k)
        _, codes_b, _, n_b = run(draft_b)
        ok_b = (bool((n_b >= 1).all()) and rule(codes_b, n_b, draft_b)
                and torch.equal(codes_b[:, 0], t_a[:, 0]))
        print(f"[spec] (b) repeat_draft: n_emit {n_b.tolist()}, frame 0 "
              f"equal to (a)'s targets'={torch.equal(codes_b[:, 0], t_a[:, 0])}"
              f"; held={ok_b}")
        if not ok_b:
            failures.append("spec (b): repeat_draft's emitted frame 0 is not "
                            "the target's, or the acceptance rule failed")

        # (c) uneven acceptance of the fixed-point draft, then sequential
        # frames; the same with other rejected drafts must continue alike
        expect = [min(a + 1, k) for a in SPEC_MISMATCH_AT]
        outs = []
        for flip in (1, 2):
            draft_c = draft_f.clone()
            for lane, at in enumerate(SPEC_MISMATCH_AT):
                draft_c[lane, at:] ^= flip
            st_c, codes_c, _, n_c = run(draft_c)
            emitted = [codes_c[lane, :n] for lane, n in
                       enumerate(n_c.tolist())]
            st_c, cont, cont_lb, cont_hb = run_frames(exact, st_c, sampler,
                                                      SPEC_CONTINUE)
            outs.append((n_c, emitted, st_c, cont, cont_lb, cont_hb))
        n_c, emitted, st_c, cont, cont_lb, cont_hb = outs[0]
        ok_c = (n_c.tolist() == expect
                and all(torch.equal(e, draft_f[lane, :e.shape[0]])
                        for lane, e in enumerate(emitted)))
        alike = (torch.equal(outs[1][3], cont)
                 and torch.equal(outs[1][4], cont_lb)
                 and outs[1][2].cache.write_idx.tolist()
                 == st_c.cache.write_idx.tolist())
        cont_ok, parted = True, []
        for lane, n in enumerate(n_c.tolist()):
            stream = torch.cat([emitted[lane], cont[lane]])

            def other(j, lane=lane, n=n):
                if j < n:
                    return ver_side(side_f, lane, j)
                return dict(logits=cont_lb[lane, j - n],
                            hidden=cont_hb[:, j - n], codes=cont[:, j - n],
                            row=lane)

            held, at, text = along(lane, stream, other)
            cont_ok = cont_ok and held
            if at is not None:
                parted.append(lane)
                print(f"[spec] (c) lane {lane}: the stream {text}")
        print(f"[spec] (c) the fixed-point draft with mismatches at "
              f"{SPEC_MISMATCH_AT}: n_emit {n_c.tolist()} (min(n_acc + 1, "
              f"K) = {expect}), emitted frames equal to the fixed point's="
              f"{ok_c}; then {SPEC_CONTINUE} sequential frames: equal, with "
              f"their logits, to the same after other rejected drafts="
              f"{alike}; each lane's stream against the all-sequential run "
              f"(logits within {SPEC_LOGIT_TOL}, parted at a near tie: "
              f"lanes {parted})={cont_ok}; cursors "
              f"{st_c.cache.write_idx.tolist()}, step {st_c.step}")
        if not ok_c:
            failures.append("spec (c): uneven acceptance did not emit "
                            "min(n_acc + 1, K) frames of the fixed point")
        if not alike:
            failures.append("spec (c): the frames after a speculative call "
                            "depend on its rejected drafts")
        if not cont_ok:
            failures.append("spec (c): the stream left the sequential run "
                            "away from a near tie")

        # the same drafts on the default engine: acceptance only
        dbase, _ = spec_base_state(default, sampler)
        dgen = default.generator
        zero_counts(fns)
        _, _, _, n_d = spec.gen_frames_spec(
            default.config, dgen.talker_params, dgen.predictor_params,
            dgen.assets_pack, dbase, draft_a, sampler, 128)
        counts["spec-default"] = read_counts(fns)
    print(f"[spec] default engine (w4a8 decode step, verify on the engine's "
          f"layers), the exact path's sequential drafts: n_emit "
          f"{n_d.tolist()} (acceptance {(n_d.sum().item() - b)}/"
          f"{b * (k - 1)} drafts past the first); launches "
          f"{counts['spec-default']}")
    for name, need, forbid in (
            ("spec-exact", ("flash_gqa_prefill_stacked",
                            "flash_gqa_decode_append"),
             ("talker_step_fused", "predict_frame_fused", "gen_chunk_fused")),
            ("spec-default", ("flash_gqa_prefill_stacked",
                              "talker_step_fused", "predict_frame_fused",
                              "append_kv_lanes"),
             ("gen_chunk_fused", "flash_gqa_decode_append"))):
        for k_ in need:
            if counts[name][k_] <= 0:
                failures.append(f"{name} never launched {k_}")
        for k_ in forbid:
            if counts[name][k_] != 0:
                failures.append(f"{name} launched {k_}")
    return counts


WAVE_FRAMES = 48    # bench.py's SFRAMES: a 4 s stream
# the wave phase's kernels by engine: a chunk=True engine's waves (B = 8-32,
# one cursor) decode through the batched chunk kernel and never the
# per-kernel step; the card's default engine routes only one lane to the
# chunk kernel (runtime/generate.CHUNK_BATCHES), so its waves take the step
# schedule
WAVE_PATH_KERNELS = {
    "chunk": ("flash_gqa_prefill_stacked", "gen_chunk_fused"),
    "step": ("flash_gqa_prefill_stacked", "talker_step_fused",
             "predict_frame_fused"),
}
WAVE_FORBIDDEN = {"chunk": ("talker_step_fused", "predict_frame_fused"),
                  "step": ("gen_chunk_fused",)}


def wave_requests(n, budgets):
    """n requests, every fourth in prompt bucket 128 and the rest in 32,
    budgets cycling."""
    return [(SERVING_TEXTS[1 if i % 4 == 3 else 0] + f" {i}.",
             budgets[i % len(budgets)]) for i in range(n)]


def drive_wave(dev, failures):
    """Wave batching (serve/batch.py BatchSynthesizer) at full width,
    greedy: on a chunk=True engine (the batched chunk kernel) waves of 8,
    16 and 32 streams of WAVE_FRAMES frames and a mixed-budget run of 11
    requests at batch 8 (the second wave padded); at batch 8 also on the
    card's default engine, whose waves take the step schedule.  Every result must have frames x spf finite, non-silent
    samples within its budget.  A short wave per engine warms up first.
    Then one profiled wave per batch size.  Returns {run: {kernel:
    launches}}."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
    from qwen3_tts_tpu_torch.kernels import flash_decode as fd
    from qwen3_tts_tpu_torch.kernels.chunk_step import gen_chunk_fused
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked)
    from qwen3_tts_tpu_torch.kernels.predictor_frame import (
        predict_frame_fused)
    from qwen3_tts_tpu_torch.kernels.talker_step import talker_step_fused
    from qwen3_tts_tpu_torch.serve.batch import (BatchRequest,
                                                 BatchSynthesizer)

    fns = {f.__name__: f for f in (
        flash_gqa_prefill_stacked, fd.flash_gqa_decode_stacked,
        fd.flash_gqa_decode_append, fd.inject_prompt_lanes,
        fd.append_kv_lanes, talker_step_fused, predict_frame_fused,
        gen_chunk_fused)}
    step = TtsEngine(device=dev, speakers_dir="speakers")
    engine = TtsEngine(device=dev, speakers_dir="speakers", chunk=True,
                       weights=dict(assets=step.assets,
                                    talker=step.talker_params,
                                    predictor=step.predictor_params,
                                    codec_decoder=step.codec_decoder_params))
    spf = engine.config.codec_decoder.samples_per_frame
    sec_per_frame = spf / 24000.0
    runs = (("wave-b8", engine, 8, wave_requests(8, (WAVE_FRAMES,))),
            ("wave-b16", engine, 16, wave_requests(16, (WAVE_FRAMES,))),
            ("wave-b32", engine, 32, wave_requests(32, (WAVE_FRAMES,))),
            ("wave-b8-mixed", engine, 8,
             wave_requests(11, (12, 24, 36, WAVE_FRAMES))),
            ("wave-b8-step", step, 8, wave_requests(8, (WAVE_FRAMES,))))
    # one short wave per engine first: the first wave of a process pays
    # the codec's and the allocator's first use
    for eng in (engine, step):
        eng.set_max_steps(8)
        voice = eng.get_speaker("vivian")
        BatchSynthesizer(eng, batch_size=8).synthesize(
            [BatchRequest(t, voice) for t, _ in wave_requests(8, (8,))])
    counts = {}
    for name, eng, b, queue in runs:
        path = "chunk" if eng is engine else "step"
        eng.set_max_steps(WAVE_FRAMES)
        voice = eng.get_speaker("vivian")
        reqs = [BatchRequest(t, voice, max_frames=m) for t, m in queue]
        eng.set_sampler_config(SamplerConfig(seed=9, **GREEDY))
        synth = BatchSynthesizer(eng, batch_size=b)
        zero_counts(fns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = synth.synthesize(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = read_counts(fns)
        ok = len(results) == len(reqs)
        for r, (_, m) in zip(results, queue):
            x = r.audio.samples
            ok = ok and (0 < r.frames <= m and len(x) == r.frames * spf
                         and bool(np.isfinite(x).all())
                         and float(np.abs(x).max()) > 1e-4)
        frames = sum(r.frames for r in results)
        waves = [results[i:i + b] for i in range(0, len(results), b)]
        # a wave runs at least one launch per chunk of its longest stream
        chunks = sum(-(-max(r.frames for r in w) // 4) for w in waves)
        longest = max(r.frames for r in results)
        print(f"[wave] {name}: batch {b}, {len(reqs)} requests in "
              f"{len(waves)} wave(s), {frames} frames in {wall:.3f} s = "
              f"{frames / wall:.1f} frames/s; per-stream RTF (wall per "
              f"wave over the audio of its longest stream) "
              f"{wall / len(waves) / (longest * sec_per_frame):.4f}; "
              f"port kernel launches {counts[name]} ({chunks} chunks); "
              f"audio frames x {spf}, finite, non-silent, within budget="
              f"{ok}")
        if not ok:
            failures.append(f"{name}: a result is not frames x {spf} "
                            "finite samples within its budget")
        for k_ in WAVE_PATH_KERNELS[path]:
            if counts[name][k_] <= 0:
                failures.append(f"{name} never launched {k_}")
        for k_ in WAVE_FORBIDDEN[path]:
            if counts[name][k_] != 0:
                failures.append(f"{name} launched {k_}")
        if path == "chunk" and counts[name]["gen_chunk_fused"] < chunks:
            failures.append(f"{name}: fewer chunk-kernel launches than "
                            "chunks")

    # one profiled wave per batch size: launches per frame-step and the
    # device's busy share
    for name, eng, b in (("wave-b8", engine, 8), ("wave-b16", engine, 16),
                         ("wave-b32", engine, 32), ("wave-b8-step", step, 8)):
        voice = eng.get_speaker("vivian")
        eng.set_sampler_config(SamplerConfig(seed=9, **GREEDY))
        reqs = [BatchRequest(t, voice, max_frames=m)
                for t, m in wave_requests(b, (WAVE_FRAMES,))]
        synth = BatchSynthesizer(eng, batch_size=b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            results = synth.synthesize(reqs)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"]
        launches = sum(e.count for e in events)
        dev_ms = sum(e.self_device_time_total for e in events) / 1000.0
        steps_ = max(r.frames for r in results)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
        print(f"[wave] profiled {name}: {steps_} frame-steps of {b} "
              f"streams, wall {wall:.1f} ms ({wall / steps_:.2f} ms per "
              f"frame-step), device launches per frame-step "
              f"{launches / steps_:.1f}, device kernel ms per frame-step "
              f"{dev_ms / steps_:.3f}, device busy (profiled) "
              f"{dev_ms / wall:.3f}; top kernels (ms, launches): " + "; ".join(
                  f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} "
                  f"({e.count})" for e in top))
    return counts


# The stream phase.  Its runs and the kernels each must launch (the stream
# of one lane: the prefill and the chunk kernel only; the exact stream:
# the attention kernels; stream_batch at 8 lanes: the step schedule, as a
# default wave), and those it must not
STREAM_PATH_KERNELS = {
    "stream": ("flash_gqa_prefill_stacked", "gen_chunk_fused"),
    "stream-exact": ("flash_gqa_prefill_stacked", "flash_gqa_decode_stacked",
                     "flash_gqa_decode"),
    "stream-batch-b8": ("flash_gqa_prefill_stacked", "talker_step_fused",
                        "predict_frame_fused"),
    "stream-prefix-hit": ("flash_gqa_prefill_stacked", "gen_chunk_fused"),
}
STREAM_FORBIDDEN = {
    "stream": ("talker_step_fused", "predict_frame_fused"),
    "stream-exact": ("gen_chunk_fused", "talker_step_fused",
                     "predict_frame_fused"),
    "stream-batch-b8": ("gen_chunk_fused",),
}
STREAM_EXACT_FRAMES = 9           # 1 + 4 + 4: the exact path is host-bound
# a preset voice with an instruction long enough for a prefix of 64 rows
# and more (13 rows + one a character): the prefix-KV route of _start_state
LONG_INSTRUCT = ("Speak slowly and warmly, like a narrator reading a quiet "
                 "bedtime story to a child.")
# the continued prefill (the suffix at start = prefix_len over the kept
# prefix) against a full prefill of the same prompt: one bf16 model whose
# suffix rows attend in other tiles (the prefill kernel's query tiles start
# at prefix_len), so single bf16 roundings flip and 28 layers carry them;
# held like the two-device comparison, relative to max |full logits|
PREFIX_LOGIT_TOL = REF_REL_TOL


def stream_timeline(prof, wall_ms):
    """From a profiled stream, on the device's clock: {busy share of the
    wall, prefill span and busy ms (the first device op to the first
    chunk-kernel launch), chunk-kernel launches, mean chunk-kernel ms,
    mean launch-to-launch period from the second chunk on, the device's
    idle ms before each chunk launch after the first}.  That idle time is
    the host's share of a chunk boundary: the enqueue of the next chunk
    not hidden by the chunk running ahead."""
    ev = sorted(((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type.name == "CUDA"),
                key=lambda t: t[0])
    busy, end, gaps, starts, durs = 0.0, None, [], [], []
    prefill_busy = None
    for t0, t1, name in ev:
        if "chunk_kernel" in name:
            if not starts:
                prefill_busy = busy
            if starts and end is not None:
                gaps.append(max(0.0, t0 - end) / 1e3)
            starts.append(t0)
            durs.append((t1 - t0) / 1e3)
        lo = t0 if end is None else max(t0, end)
        busy += max(0.0, t1 - lo)
        end = t1 if end is None else max(end, t1)
    periods = [(b - a) / 1e3 for a, b in zip(starts[1:], starts[2:])]
    return dict(
        busy=busy / 1e3 / max(wall_ms, 1e-9), chunks=len(starts), gaps=gaps,
        prefill_span_ms=(starts[0] - ev[0][0]) / 1e3 if starts else 0.0,
        prefill_busy_ms=(prefill_busy or 0.0) / 1e3,
        chunk_kernel_ms=sum(durs[1:]) / max(len(durs) - 1, 1),
        first_chunk_kernel_ms=durs[0] if durs else 0.0,
        period_ms=sum(periods) / max(len(periods), 1))


def first_difference(a, b):
    """(frame, token) of the first code where a and b differ, or None."""
    import numpy as np
    n = min(len(a), len(b))
    diff = np.argwhere(a[:n] != b[:n]) if n else []
    if len(diff):
        return tuple(int(x) for x in diff[0])
    return None if len(a) == len(b) else (n, 0)


def window_logits_by_frame(run):
    """run() with every chunk-kernel launch asked for the predictor's
    window logits (gen_chunk_fused's taps: 15 [B, 2048] f32 a frame);
    returns them as a list over the run's frames of 15 tensors each."""
    from qwen3_tts_tpu_torch.kernels import chunk_step
    real = chunk_step.gen_chunk_fused
    frames = []

    def tapped(*args, **kw):
        kw["taps"] = taps = []
        out = real(*args, **kw)
        n = args[13].shape[0]                     # u: [F, B]
        frames.extend(taps[f * 15:(f + 1) * 15] for f in range(n))
        return out

    tapped.launches = 0           # the kernel's wrapper counts on its name
    chunk_step.gen_chunk_fused = tapped
    try:
        run()
    finally:
        chunk_step.gen_chunk_fused = real
    return frames


def tie_report(eng, text, voice, diff, codes, b_codes):
    """The first (frame, token) where a stream's greedy codes part from
    the bulk run's: how far each side's pick leads the other's in its own
    window logits, over max |logit| (a near tie when both are small)."""
    from qwen3_tts_tpu_torch import SamplerConfig
    f, tok = diff
    if tok == 0 or f >= min(len(codes), len(b_codes)):
        return f"frame {f} token {tok}: code_0 or a length, no window logits"

    def run(fn):
        eng.set_sampler_config(SamplerConfig(seed=1, **GREEDY))
        return lambda: fn(text, voice)

    s_frames = window_logits_by_frame(
        run(lambda t, v: list(eng.generate_stream(t, v))))
    b_frames = window_logits_by_frame(run(eng.generate_with_voice))
    x, y = int(codes[f, tok]), int(b_codes[f, tok])
    ls = s_frames[f][tok - 1][0].float()
    lb = b_frames[f][tok - 1][0].float()
    scale = max(ls.abs().max().item(), lb.abs().max().item())
    lead_s = (ls[x] - ls[y]).item()
    lead_b = (lb[y] - lb[x]).item()
    return (f"frame {f} token {tok}: stream picks {x} (its argmax "
            f"{int(ls.argmax())}) {lead_s:.4e} above {y}; bulk picks {y} "
            f"(its argmax {int(lb.argmax())}) {lead_b:.4e} above {x}; max "
            f"|logit| {scale:.3f}: leads {lead_s / scale:.2e} and "
            f"{lead_b / scale:.2e} of it; the two frames' window logits "
            f"{(ls - lb).abs().max().item() / scale:.2e} apart")


def drive_stream(dev, failures):
    """Streaming and prompt-prefix KV reuse at full width (the engine
    phase's model, random weights from a seed): greedy streams of one lane
    on the default engine (the chunk kernel: a first chunk of
    first_chunk_frames frames at cursor = bucket, then 4-frame chunks) at
    buckets 32 and 128, each beside the same request in bulk and run
    twice; a stream on the exact path, code for code against its bulk
    run; one profiled stream (device-busy share, the device's idle gap at
    each chunk boundary); stream_batch at 8 lanes (the step schedule); a
    long-instruction preset-voice request twice (a prefix miss, then a
    hit); generate_long on three sentences.  Returns {run: {kernel:
    launches}}."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
    from qwen3_tts_tpu_torch.kernels import flash_decode as fd
    from qwen3_tts_tpu_torch.kernels.chunk_step import gen_chunk_fused
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked)
    from qwen3_tts_tpu_torch.kernels.predictor_frame import (
        predict_frame_fused)
    from qwen3_tts_tpu_torch.kernels.talker_step import talker_step_fused

    fns = {f.__name__: f for f in (
        flash_gqa_prefill_stacked, fd.flash_gqa_decode_stacked,
        fd.flash_gqa_decode, talker_step_fused, predict_frame_fused,
        gen_chunk_fused)}
    default = TtsEngine(device=dev, speakers_dir="speakers")
    weights = dict(assets=default.assets, talker=default.talker_params,
                   predictor=default.predictor_params,
                   codec_decoder=default.codec_decoder_params)
    exact = TtsEngine(device=dev, speakers_dir="speakers", fused=False,
                      weights=weights)
    spf = default.config.codec_decoder.samples_per_frame
    first_n = default.config.runtime.first_chunk_frames
    voice = default.get_speaker("vivian")
    counts = {}

    def check_launches(run):
        for k_ in STREAM_PATH_KERNELS.get(run, ()):
            if counts[run][k_] <= 0:
                failures.append(f"{run} never launched {k_}")
        for k_ in STREAM_FORBIDDEN.get(run, ()):
            if counts[run][k_] != 0:
                failures.append(f"{run} launched {k_}")

    def stream(eng, text, run=None, instruct=None):
        eng.set_sampler_config(SamplerConfig(seed=1, **GREEDY))
        if run:
            zero_counts(fns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks = list(eng.generate_stream(text, voice, instruct))
        wall = (time.perf_counter() - t0) * 1e3
        if run:
            counts[run] = read_counts(fns)
        return chunks, eng.last_codes, eng.last_metrics, wall

    def bulk(eng, text, instruct=None):
        eng.set_sampler_config(SamplerConfig(seed=1, **GREEDY))
        audio = eng.generate_with_voice(text, voice, instruct)
        return audio.samples, eng.last_codes, eng.last_metrics

    # the default engine: the chunk kernel at one lane
    default.set_max_steps(MAX_STEPS)
    stream(default, "Warm up.")
    for label, text in (("b32", REQUESTS[0][1]), ("b128", REQUESTS[1][1])):
        run = "stream" if label == "b32" else None
        bucket = default._bucket(
            default._build_voice_prompt(text, voice, None).length)
        chunks, codes, m, wall = stream(default, text, run)
        again = stream(default, text)
        x = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        lens = [len(c) // spf for c in chunks]
        ok = (m.frames > 0 and lens[0] == first_n and max(lens) <= 4
              and len(x) == m.frames * spf and bool(np.isfinite(x).all())
              and float(np.abs(x).max()) > 1e-4 and len(codes) == m.frames)
        b_x, b_codes, b_m = bulk(default, text)
        diff = first_difference(codes, b_codes)
        same = (np.array_equal(codes, again[1])
                and all(np.array_equal(a, b) for a, b in zip(chunks,
                                                             again[0])))
        print(f"[stream] default {label}: bucket {bucket}, frames "
              f"{m.frames}, chunks (frames) {lens}, samples = frames x "
              f"{spf}, finite, non-silent={ok}; TTFT {m.ttft_ms:.2f} ms "
              f"(rerun {again[2].ttft_ms:.2f}), prefill {m.prefill_ms:.2f} "
              f"ms, chunk intervals ms {[round(c, 2) for c in m.chunk_ms]}, "
              f"mean after the first "
              f"{np.mean(m.chunk_ms[1:]) if len(m.chunk_ms) > 1 else 0:.2f}"
              f"; stream {m.total_ms / max(m.frames, 1):.2f} ms/frame "
              f"(wall {wall:.1f} ms); bulk {b_m.total_ms / max(b_m.frames, 1):.2f}"
              f" ms/frame (prefill {b_m.prefill_ms:.2f} ms, frames "
              f"{b_m.frames}); frame 0 equal to bulk="
              f"{np.array_equal(codes[:1], b_codes[:1])}, first differing "
              f"(frame, token) against bulk {diff}; rerun equal={same}")
        if not ok:
            failures.append(f"stream {label}: bad chunks or audio")
        if not np.array_equal(codes[:1], b_codes[:1]):
            failures.append(f"stream {label}: frame 0 differs from bulk")
        if not same:
            failures.append(f"stream {label}: a greedy rerun differs")
        if diff is not None:
            # a later frame may part from bulk at a near tie: the chunk
            # kernel merges a chunk's own slots last, and the stream's
            # chunks start one frame later than the bulk loop's
            print(f"[stream] default {label}: tie-aware, where the codes "
                  f"part from bulk: "
                  f"{tie_report(default, text, voice, diff, codes, b_codes)}")
        if run:
            print(f"[stream] default {label} launch counts: {counts[run]}")
            check_launches(run)
            # one launch a chunk, and one more ahead where EOS ended it
            if not (len(chunks) <= counts[run]["gen_chunk_fused"]
                    <= len(chunks) + int(m.eos)):
                failures.append("stream: not one chunk-kernel launch a "
                                "chunk")

    # the host's time to enqueue one chunk (frames and codec, no sync):
    # with one chunk ahead, the first audio waits for chunk 0's and
    # chunk 1's enqueue
    gen, enq = default.generator, []
    real_chunk = gen.chunk_with_audio

    def timed_chunk(*args, **kw):
        t0 = time.perf_counter()
        out = real_chunk(*args, **kw)
        enq.append((kw.get("n_frames"), (time.perf_counter() - t0) * 1e3))
        return out

    gen.chunk_with_audio = timed_chunk
    try:
        stream(default, REQUESTS[0][1])
    finally:
        del gen.chunk_with_audio
    by_n = {n: [t for k, t in enq if k == n] for n in sorted({k for k, _ in enq})}
    print("[stream] host enqueue of one chunk (frames + codec, no sync), ms: "
          + "; ".join(f"{n} frame(s): mean {np.mean(t):.3f}, max "
                      f"{max(t):.3f} over {len(t)}" for n, t in by_n.items()))

    # the exact path: stream == bulk, code for code
    exact.set_max_steps(STREAM_EXACT_FRAMES)
    chunks, codes, m, wall = stream(exact, REQUESTS[0][1], "stream-exact")
    b_x, b_codes, b_m = bulk(exact, REQUESTS[0][1])
    x = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    eq = np.array_equal(codes, b_codes)
    err = float(np.abs(x - b_x).max()) if len(x) == len(b_x) else float("inf")
    print(f"[stream] exact: {m.frames} frames in chunks "
          f"{[len(c) // spf for c in chunks]}, TTFT {m.ttft_ms:.1f} ms, "
          f"stream == bulk codes={eq} (first difference "
          f"{first_difference(codes, b_codes)}), max |wav - bulk wav| "
          f"{err:.3e}; launch counts {counts['stream-exact']}")
    check_launches("stream-exact")
    if not eq:
        failures.append("exact path: stream codes differ from bulk")

    # one profiled stream: device busy share and the idle gap at each chunk
    # boundary (the host's enqueue not hidden by the chunk running ahead)
    default.set_sampler_config(SamplerConfig(seed=1, **GREEDY))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunks = list(default.generate_stream(REQUESTS[0][1], voice))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    tl = stream_timeline(prof, wall)
    gaps = tl["gaps"]
    m = default.last_metrics
    print(f"[stream] profiled default b32: {m.frames} frames, wall "
          f"{wall:.1f} ms, TTFT {m.ttft_ms:.2f} ms, prefill "
          f"{m.prefill_ms:.2f} ms; device: busy (profiled) {tl['busy']:.3f}, "
          f"first op to the first chunk launch {tl['prefill_span_ms']:.2f} ms "
          f"of which busy {tl['prefill_busy_ms']:.2f} ms, {tl['chunks']} "
          f"chunk-kernel launches, the first (1 frame) "
          f"{tl['first_chunk_kernel_ms']:.3f} ms, the others "
          f"{tl['chunk_kernel_ms']:.3f} ms each, launch to launch "
          f"{tl['period_ms']:.3f} ms; device idle before each chunk launch "
          f"after the first (ms) {[round(g, 3) for g in gaps]}, mean "
          f"{np.mean(gaps) if gaps else 0:.3f}, max "
          f"{max(gaps) if gaps else 0:.3f}")
    if tl["chunks"] != len(chunks):
        failures.append("profiled stream: chunk-kernel launches not seen "
                        "in the profile")
    # where the prefill's time goes: host ops and device kernels
    plan = default._build_voice_prompt(REQUESTS[0][1], voice, None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        default._start_state(plan, torch.Generator(device=dev))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    dev_ms = sum(e.self_device_time_total for e in avg
                 if e.device_type.name == "CUDA") / 1e3
    n_dev = sum(e.count for e in avg if e.device_type.name == "CUDA")
    top = sorted((e for e in avg if e.device_type.name == "CPU"),
                 key=lambda e: -e.self_cpu_time_total)[:8]
    print(f"[stream] profiled prefill b32: wall {wall:.2f} ms, device kernel "
          f"ms {dev_ms:.3f} in {n_dev} launches; top host ops by self time "
          f"(ms, calls): " + "; ".join(
              f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.2f} ({e.count})"
              for e in top))

    # stream_batch at 8 lanes: the step schedule; a short wave first (the
    # first wave of 8 lanes pays the allocator's and the step kernels'
    # first use at that batch)
    texts = [SERVING_TEXTS[0] + f" {i}." for i in range(8)]
    default.set_max_steps(5)
    list(default.stream_batch(texts, voice))
    default.set_max_steps(MAX_STEPS)
    for rep in ("", "-again"):
        default.set_sampler_config(SamplerConfig(seed=9, **GREEDY))
        zero_counts(fns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        waves, t_first = [], None
        for w in default.stream_batch(texts, voice):
            if t_first is None:
                t_first = (time.perf_counter() - t0) * 1e3
            waves.append(w)
        wall = time.perf_counter() - t0
        run = "stream-batch-b8" + rep
        counts[run] = read_counts(fns)
        lanes = [np.concatenate([w[i] for w in waves]) for i in range(8)]
        frames = sum(len(x) for x in lanes) // spf
        ok = (all(len(w) == 8 for w in waves)
              and all(len(p) == first_n * spf for p in waves[0])
              and all(len(x) % spf == 0 and len(x) > 0
                      and bool(np.isfinite(x).all()) for x in lanes))
        if rep:
            same = all(np.array_equal(a, b) for a, b in zip(lanes, prev))
            print(f"[stream] stream_batch b8 rerun: audio identical={same}")
            if not same:
                failures.append("stream_batch b8: the rerun differs")
        prev = lanes
        print(f"[stream] stream_batch b8{rep}: {len(waves)} chunk "
              f"boundaries, {frames} frames in {wall:.3f} s = "
              f"{frames / wall:.1f} frames/s, first audio (TTFT) "
              f"{t_first:.2f} ms; pieces per boundary 8, first pieces "
              f"{first_n} frame(s), lanes finite={ok}; launch counts "
              f"{counts[run]}")
        if not ok:
            failures.append("stream_batch b8: bad pieces")
        if not rep:
            check_launches(run)

    # prefix-KV reuse: a long-instruction preset-voice request twice
    default._prefix_kv.clear()
    default.set_max_steps(MAX_STEPS)
    text = REQUESTS[0][1]
    plan = default._build_voice_prompt(text, voice, LONG_INSTRUCT)
    p_cap = ((plan.prefix_len + 63) // 64) * 64
    res = []
    for run in ("stream-prefix-miss", "stream-prefix-hit"):
        zero_counts(fns)
        res.append(bulk(default, text, LONG_INSTRUCT))
        counts[run] = read_counts(fns)
    (_, miss_codes, miss_m), (_, hit_codes, hit_m) = res
    entry = next(iter(default._prefix_kv.values()), None)
    own = entry is not None and all(
        t.is_contiguous() and t.shape[3] == p_cap
        and t.untyped_storage().nbytes() == t.numel() * t.element_size()
        for t in entry)
    eq = np.array_equal(miss_codes, hit_codes)
    # the continued prefill against a full prefill of the same prompt
    suffix = plan.suffix_plan()
    s_cap = ((suffix.length + 15) // 16) * 16
    bucket = default._bucket(max(plan.length, p_cap, plan.prefix_len + s_cap))
    g = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        full, _, _ = default.start_plans(plan, bucket, g)
        embeds_s, lens_s = default.prompt_to_device(suffix, s_cap)
        cont = default.generator.start_with_prefix(
            entry[0], entry[1], plan.prefix_len, embeds_s,
            torch.from_numpy(lens_s).to(dev), g, total_bucket=bucket)
    rel = ((cont.logits.float() - full.logits.float()).abs().max()
           / full.logits.float().abs().max()).item()
    same_pick = bool((cont.logits.argmax(-1) == full.logits.argmax(-1)).all())
    print(f"[stream] prefix KV: instruction of {len(LONG_INSTRUCT)} "
          f"characters, prompt {plan.length} rows, prefix {plan.prefix_len} "
          f"(p_cap {p_cap}), suffix {suffix.length} (s_cap {s_cap}), bucket "
          f"{bucket}; miss prefill {miss_m.prefill_ms:.2f} ms (launches "
          f"{counts['stream-prefix-miss']['flash_gqa_prefill_stacked']} "
          f"prefill kernels: full + continued), hit prefill "
          f"{hit_m.prefill_ms:.2f} ms "
          f"({counts['stream-prefix-hit']['flash_gqa_prefill_stacked']}); "
          f"entries {len(default._prefix_kv)}, entry = a copy of p_cap slots="
          f"{own}; hit == miss greedy codes={eq}; continued vs full prefill "
          f"logits max |diff| / max |full| {rel:.3e} (tol "
          f"{PREFIX_LOGIT_TOL}), same argmax={same_pick}")
    check_launches("stream-prefix-hit")
    if not (own and len(default._prefix_kv) == 1):
        failures.append("prefix KV: the entry is not one copy of p_cap slots")
    if not eq:
        failures.append("prefix KV: the hit's greedy codes differ from the "
                        "miss's")
    if not rel <= PREFIX_LOGIT_TOL:
        failures.append("prefix KV: continued prefill logits off the full "
                        "prefill's")
    del full, cont

    # generate_long on three sentences
    default.set_max_steps(16)
    default.set_sampler_config(SamplerConfig(seed=1, **GREEDY))
    t0 = time.perf_counter()
    audio = default.generate_long("The first sentence. A second one! And "
                                  "the third?", voice)
    wall = time.perf_counter() - t0
    x = audio.samples
    ok = len(x) > 0 and len(x) % spf == 0 and bool(np.isfinite(x).all())
    print(f"[stream] generate_long, three sentences: {len(x) // spf} frames "
          f"in {wall:.3f} s, finite={ok}")
    if not ok:
        failures.append("generate_long: bad audio")
    return counts


# The clone phase: voice cloning from reference audio at full width (the
# engine phase's model; the codec encoder and speaker encoder on random
# weights from a seed).  Reference lengths in seconds: 120 and 360 codec
# frames, prompt buckets 256 and 512
CLONE_SECONDS = (10, 30)
CLONE_TEXT = "A cloned voice reads this sentence aloud."
CLONE_REF_TEXT = "These are the words the reference speaker said."
# The card against the port on the CPU, the same weights and WAV, f32 with
# TF32 off (set_cuda_precision): cuFFT, cuDNN and cuBLAS sum in other
# orders than the CPU's FFT, convolutions and products (measured on the CPU
# against the JAX package: ~1e-6).  The log-mel (natural log) within
# CLONE_MEL_TOL, absolute; the unit-norm speaker embedding within
# CLONE_EMB_TOL, absolute; the codes equal (a flip would need two codebook
# entries within ~1e-4 of each other in |c|^2 - 2 r.c, whose spread is
# ~45: on a mismatch the CPU's margin there is printed)
CLONE_MEL_TOL = 1e-3
CLONE_EMB_TOL = 1e-4
# each clone request launches the prefill and the chunk kernel, and never
# the step schedule's kernels
CLONE_PATH_KERNELS = {
    run: ("flash_gqa_prefill_stacked", "gen_chunk_fused")
    for run in ("clone-10s-miss", "clone-10s-hit", "clone-30s-miss",
                "clone-30s-hit", "clone-stream", "clone-4096")}
CLONE_FORBIDDEN = {run: ("talker_step_fused", "predict_frame_fused")
                   for run in CLONE_PATH_KERNELS}
CLONE_BUCKET_FRAMES = 8     # frames of the 4096-row request


def reference_wav(seconds: int, seed: int):
    """A seeded speech-like 24 kHz signal: eight harmonics of a pitch
    gliding around 120 Hz, syllable-rate amplitude, a little noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(seconds * 24000) / 24000.0
    f0 = 120.0 + 30.0 * np.sin(2 * np.pi * 0.5 * t + rng.uniform(0, 6))
    phase = 2 * np.pi * np.cumsum(f0) / 24000.0
    voiced = sum(np.sin(h * phase) / h for h in range(1, 9))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t + rng.uniform(0, 6))
    x = 0.2 * env * voiced + 0.01 * rng.standard_normal(t.shape)
    return (x / max(1.0, np.abs(x).max() / 0.9)).astype(np.float32)


def rvq_margin(codebooks, z, frame, stage):
    """On the CPU: how far the RVQ's pick at (frame, stage) leads the
    runner-up in |c|^2 - 2 r.c (codebooks [Q, K, D], z [N, D] f32), and
    the score's magnitude there."""
    import torch
    r = z[frame].clone()
    for q in range(stage + 1):
        cb = codebooks[q].float()
        scores = (cb ** 2).sum(-1) - 2.0 * (cb @ r)
        if q < stage:
            r = r - cb[int(scores.argmin())]
    top2 = torch.topk(scores, 2, largest=False).values
    return (top2[1] - top2[0]).item(), top2[0].abs().item()


def drive_clone(dev, failures):
    """Voice cloning at full width on the card (seeded random codec
    encoder and speaker encoder weights): seeded 10 s and 30 s reference
    WAVs; create_voice_file's codes, log-mel and embedding against the
    port on the CPU with the same weights; the mel, the encoder's conv
    stack and RVQ and the speaker encoder timed alone (CUDA events);
    generate greedy twice per reference (a miss: the encoder runs, the
    sidecar is written, the prefix KV filled; then a hit: the sidecar
    read, the encoder not run, the prefix reused, the codes equal);
    generate_stream with the cloned voice (TTFT); a clone voice of random
    codes that fills the 4096-row bucket, CLONE_BUCKET_FRAMES frames on the
    chunk kernel (cache 5120 slots); the 28-layer prefill of a 4096-row
    prompt through Generator.start (bench.py's clone_prefill_ms_4096).
    Returns {run: {kernel: launches}}."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine, VoiceFile
    from qwen3_tts_tpu_torch.core import protocol as P
    from qwen3_tts_tpu_torch.io.audio import AudioSample, load_reference_wav
    from qwen3_tts_tpu_torch.kernels import flash_decode as fd
    from qwen3_tts_tpu_torch.kernels.chunk_step import gen_chunk_fused
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked)
    from qwen3_tts_tpu_torch.kernels.predictor_frame import (
        predict_frame_fused)
    from qwen3_tts_tpu_torch.kernels.talker_step import talker_step_fused
    from qwen3_tts_tpu_torch.models.codec import encoder as enc_lib
    from qwen3_tts_tpu_torch.models.codec import speaker as spk_lib
    from qwen3_tts_tpu_torch.ops.mel import log_mel

    fns = {f.__name__: f for f in (
        flash_gqa_prefill_stacked, fd.flash_gqa_decode_stacked,
        fd.flash_gqa_decode, talker_step_fused, predict_frame_fused,
        gen_chunk_fused)}
    t0 = time.perf_counter()
    eng = TtsEngine(device=dev, speakers_dir="speakers")
    torch.cuda.synchronize()
    ecfg, scfg = eng.config.codec_encoder, eng.config.speaker_encoder
    spf = eng.config.codec_decoder.samples_per_frame
    print(f"[clone] full-width TtsEngine: init {time.perf_counter() - t0:.2f}"
          f" s; codec encoder channels {ecfg.channels} d {ecfg.d_model}, "
          f"speaker encoder {scfg.n_layers} x {scfg.d_model} "
          f"({scfg.pooling}); random components {eng.dev_mode_components}")

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        return tree.cpu()

    enc_cpu = to_cpu(eng.codec_encoder_params)
    spk_cpu = to_cpu(eng.speaker_params)
    counts = {}
    enc_calls = [0]
    real_encode = enc_lib.encode

    def counted_encode(*a, **k):
        enc_calls[0] += 1
        return real_encode(*a, **k)

    def check_launches(run):
        for k_ in CLONE_PATH_KERNELS[run]:
            if counts[run][k_] <= 0:
                failures.append(f"{run} never launched {k_}")
        for k_ in CLONE_FORBIDDEN[run]:
            if counts[run][k_] != 0:
                failures.append(f"{run} launched {k_}")

    def audio_ok(audio, frames):
        x = audio.samples
        return (frames > 0 and len(x) == frames * spf
                and bool(np.isfinite(x).all())
                and float(np.abs(x).max()) > 1e-4)

    tmp = tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR"))
    enc_lib.encode = counted_encode
    try:
        refs, voices = {}, {}
        for secs in CLONE_SECONDS:
            path = Path(tmp.name) / f"ref_{secs}s.wav"
            AudioSample(samples=reference_wav(secs, secs),
                        sample_rate=24000).save_wav(path)
            refs[secs] = path
            wav = load_reference_wav(path)
            # the port on the CPU, the same weights
            t_cpu = time.perf_counter()
            with torch.no_grad():
                xc = torch.from_numpy(wav)
                z_cpu = enc_lib.encode_latents(ecfg, enc_cpu, xc[None])[0]
                codes_cpu = enc_lib.rvq_encode(enc_cpu["codebooks"],
                                               z_cpu[None])[0]
                mel_cpu = log_mel(xc, scfg.sample_rate, scfg.n_fft,
                                  scfg.hop_length, scfg.n_mels, scfg.fmin,
                                  scfg.fmax)
                emb_cpu = spk_lib.speaker_embed_from_mel(
                    scfg, spk_cpu, mel_cpu[None])[0]
            t_cpu = time.perf_counter() - t_cpu
            # the card: each part alone, then create_voice_file
            x = torch.from_numpy(wav).to(dev)
            with torch.no_grad():
                def mel_fn(i):
                    return log_mel(x, scfg.sample_rate, scfg.n_fft,
                                   scfg.hop_length, scfg.n_mels, scfg.fmin,
                                   scfg.fmax)

                mel = mel_fn(0)
                z = enc_lib.encode_latents(ecfg, eng.codec_encoder_params,
                                           x[None])
                mel_ms = cuda_ms(mel_fn, 5, 1)
                conv_ms = cuda_ms(lambda i: enc_lib.encode_latents(
                    ecfg, eng.codec_encoder_params, x[None]), 5, 1)
                rvq_ms = cuda_ms(lambda i: enc_lib.rvq_encode(
                    eng.codec_encoder_params["codebooks"], z), 5, 1)
                spk_ms = cuda_ms(lambda i: spk_lib.speaker_embed_from_mel(
                    scfg, eng.speaker_params, mel[None]), 5, 1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            voice = eng.create_voice_file(path, CLONE_REF_TEXT)
            wall = (time.perf_counter() - t1) * 1e3
            voices[secs] = voice
            codes = voice.codes_array
            emb = voice.embedding_array
            n_frames = len(wav) // enc_lib.samples_per_frame(ecfg)
            same = np.array_equal(codes, codes_cpu.numpy())
            mel_err = (mel.cpu() - mel_cpu).abs().max().item()
            emb_err = float(np.abs(emb - emb_cpu.numpy()).max())
            norm = float(np.linalg.norm(emb))
            ok = (codes.shape == (n_frames, P.NUM_CODEBOOKS)
                  and emb.shape == (P.SPEAKER_EMB_DIM,)
                  and abs(norm - 1.0) < 1e-4 and bool(np.isfinite(emb).all()))
            print(f"[clone] create_voice_file {secs} s ({len(wav)} samples): "
                  f"codes {codes.shape} (expected ({n_frames}, 16)), "
                  f"embedding {emb.shape} norm {norm:.6f}; card vs CPU: "
                  f"codes equal={same}, log-mel {tuple(mel.shape)} max |diff| "
                  f"{mel_err:.3e} (tol {CLONE_MEL_TOL}), embedding max |diff| "
                  f"{emb_err:.3e} (tol {CLONE_EMB_TOL}); card ms (events): mel"
                  f" {mel_ms:.3f}, encoder convs + projection {conv_ms:.3f}, "
                  f"RVQ {rvq_ms:.3f}, speaker encoder {spk_ms:.3f}; "
                  f"create_voice_file wall {wall:.1f} ms (WAV read, copies, "
                  f"host sync included); the CPU's {t_cpu:.1f} s")
            if not same:
                diff = np.argwhere(codes != codes_cpu.numpy())
                f_, q_ = (int(v) for v in diff[0])
                margin, mag = rvq_margin(enc_cpu["codebooks"], z_cpu, f_, q_)
                print(f"[clone] {secs} s: {len(diff)} codes differ, the "
                      f"first at frame {f_}, stage {q_}: card "
                      f"{codes[f_, q_]} CPU {int(codes_cpu[f_, q_])}; the "
                      f"CPU's margin there {margin:.4e} (score {mag:.2f}); "
                      f"card vs CPU z max |diff| "
                      f"{(z[0].cpu() - z_cpu).abs().max().item():.3e}")
                failures.append(f"clone {secs} s: the card's codes differ "
                                f"from the CPU's")
            if not (ok and mel_err <= CLONE_MEL_TOL
                    and emb_err <= CLONE_EMB_TOL):
                failures.append(f"clone {secs} s: voice off the CPU's or "
                                f"malformed")

        # warmup at the clone buckets (a prefill and a chunk each, the
        # encoders on a second of silence), then generate: a miss (the
        # encoder runs, the sidecar is written, the prefix KV filled), then
        # a hit (the sidecar read, the prefix reused), greedy, MAX_STEPS
        # frames
        eng.set_max_steps(MAX_STEPS)
        eng._prefix_kv.clear()
        zero_counts(fns)
        t1 = time.perf_counter()
        eng.warmup(buckets=(256, 512), batch_sizes=(1,))
        print(f"[clone] warmup(buckets=(256, 512)): "
              f"{(time.perf_counter() - t1) * 1e3:.1f} ms, launches "
              f"{read_counts(fns)}")
        for secs, path in refs.items():
            plan = eng._build_voice_prompt(CLONE_TEXT, voices[secs], None)
            res = {}
            for kind in ("miss", "hit"):
                run = f"clone-{secs}s-{kind}"
                eng.set_sampler_config(SamplerConfig(seed=1, **GREEDY))
                zero_counts(fns)
                enc_calls[0] = 0
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                audio = eng.generate(CLONE_TEXT, path, CLONE_REF_TEXT)
                wall = (time.perf_counter() - t1) * 1e3
                counts[run] = read_counts(fns)
                m = eng.last_metrics
                res[kind] = (eng.last_codes, enc_calls[0], len(eng._prefix_kv))
                ok = audio_ok(audio, m.frames)
                print(f"[clone] generate {secs} s reference, {kind}: prompt "
                      f"{plan.length} rows (prefix {plan.prefix_len}), bucket "
                      f"{eng._bucket(plan.length)}, frames {m.frames}, "
                      f"finite and non-silent={ok}; prefill {m.prefill_ms:.2f}"
                      f" ms, total {m.total_ms:.2f} ms, wall {wall:.1f} ms, "
                      f"{(m.total_ms - m.prefill_ms) / max(m.frames, 1):.2f} "
                      f"decode ms/frame; encoder calls {enc_calls[0]}, "
                      f"sidecar {path.with_suffix('.cache').exists()}, prefix "
                      f"entries {len(eng._prefix_kv)}; launches "
                      f"{counts[run]}")
                if not ok:
                    failures.append(f"{run}: bad audio")
                check_launches(run)
            (c_miss, e_miss, n_miss), (c_hit, e_hit, n_hit) = (res["miss"],
                                                               res["hit"])
            eq = np.array_equal(c_miss, c_hit)
            print(f"[clone] {secs} s: hit == miss greedy codes={eq}; encoder "
                  f"calls miss {e_miss} / hit {e_hit}; prefill launches miss "
                  f"{counts[f'clone-{secs}s-miss']['flash_gqa_prefill_stacked']}"
                  f" / hit "
                  f"{counts[f'clone-{secs}s-hit']['flash_gqa_prefill_stacked']}")
            if not (eq and e_miss == 1 and e_hit == 0 and n_hit == n_miss):
                failures.append(f"clone {secs} s: the sidecar or prefix "
                                f"rerun differs")

        # generate_stream with the cloned 10 s voice, then its rerun
        ttfts = []
        for rep in range(2):
            eng.set_sampler_config(SamplerConfig(seed=1, **GREEDY))
            zero_counts(fns)
            got = list(eng.generate_stream(CLONE_TEXT, voices[10]))
            ttfts.append(eng.last_metrics.ttft_ms)
            if not rep:
                counts["clone-stream"] = read_counts(fns)
                chunks, m = got, eng.last_metrics
        x = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        ok = audio_ok(AudioSample(samples=x), m.frames)
        print(f"[clone] generate_stream, cloned 10 s voice: {m.frames} frames "
              f"in chunks {[len(c) // spf for c in chunks]}, finite and "
              f"non-silent={ok}; TTFT {m.ttft_ms:.2f} ms (rerun "
              f"{ttfts[1]:.2f}), prefill "
              f"{m.prefill_ms:.2f} ms, mean chunk interval after the first "
              f"{np.mean(m.chunk_ms[1:]) if len(m.chunk_ms) > 1 else 0:.2f} "
              f"ms; launches {counts['clone-stream']}")
        if not ok:
            failures.append("clone stream: bad audio")
        check_launches("clone-stream")

        # a clone voice whose prompt fills the 4096-row bucket: random
        # reference codes, the 10 s voice's embedding; the chunk kernel on
        # a 5120-slot cache
        rows = eng._build_voice_prompt(CLONE_TEXT, VoiceFile.new(
            CLONE_REF_TEXT, [0] * 16, voices[10].embedding_array),
            None).length - 1                      # the rows besides frames
        n_ref = eng.config.runtime.max_prompt_len - rows - 2
        rng = np.random.default_rng(4096)
        big = VoiceFile.new(CLONE_REF_TEXT,
                            rng.integers(0, P.CODEBOOK_SIZE, n_ref * 16),
                            voices[10].embedding_array)
        plan = eng._build_voice_prompt(CLONE_TEXT, big, None)
        eng.set_max_steps(CLONE_BUCKET_FRAMES)
        eng.set_sampler_config(SamplerConfig(seed=1, **GREEDY))
        zero_counts(fns)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        audio = eng.generate_with_voice(CLONE_TEXT, big)
        wall = (time.perf_counter() - t1) * 1e3
        counts["clone-4096"] = read_counts(fns)
        m = eng.last_metrics
        ok = audio_ok(audio, m.frames) and m.frames == CLONE_BUCKET_FRAMES
        print(f"[clone] 4096-row bucket: {n_ref} reference frames, prompt "
              f"{plan.length} rows (prefix {plan.prefix_len}), bucket "
              f"{eng._bucket(plan.length)}, {m.frames} frames, finite and "
              f"non-silent={ok}; prefill {m.prefill_ms:.2f} ms, total "
              f"{m.total_ms:.2f} ms, wall {wall:.1f} ms; launches "
              f"{counts['clone-4096']}")
        if not ok:
            failures.append("clone 4096: bad audio")
        check_launches("clone-4096")
        eng._prefix_kv.clear()

        # the 28-layer prefill of a 4096-row prompt (bench.py's
        # clone_prefill_ms_4096: Generator.start, the least of three)
        g = torch.Generator(device=dev).manual_seed(5)
        e4 = torch.randn(1, 4096, P.TALKER_DIM, generator=g,
                         device=dev) * 0.02
        l4 = torch.full((1,), 4096, dtype=torch.int32, device=dev)
        times = []
        for rep in range(4):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with torch.no_grad():
                st = eng.generator.start(e4, l4, g)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            ok = bool(torch.isfinite(st.logits).all())
            del st
        print(f"[clone] prefill of a 4096-row prompt (Generator.start, 28 "
              f"layers, host clock with a device sync): first "
              f"{times[0]:.2f} ms, then {[round(t, 2) for t in times[1:]]}; "
              f"clone_prefill_ms_4096 = {min(times[1:]):.2f}; logits "
              f"finite={ok}")
        if not ok:
            failures.append("clone prefill 4096: non-finite logits")
    finally:
        enc_lib.encode = real_encode
        tmp.cleanup()
    return counts


# the ONNX codec phase: a model directory laid out as the reference ships
# it (onnx/ graphs of tests/torch_onnx_fixtures.py at the published
# contract's widths) beside the engine phase's full-width LMs
ONNX_FRAMES = 32
ONNX_PATH_KERNELS = {"onnx": ("flash_gqa_prefill_stacked", "gen_chunk_fused")}
ONNX_FORBIDDEN = {"onnx": ("talker_step_fused", "predict_frame_fused")}
# a 32-frame greedy request at bucket 32: one 28-layer prefill, 8 chunks
ONNX_LAUNCHES = {"flash_gqa_prefill_stacked": 28, "gen_chunk_fused": 8}
# waveforms are held relative to the peak of what they are compared with
# (the fixture's waveform peaks near 2e-4, so an absolute bound would
# pass a decoder wrong by tens of percent): one decoder call against
# chunked calls, lanes of one decode_batch, a stream's pieces, the
# engine's audio and batching's lanes against whole decodes, and the card
# against the port on the CPU, within ONNX_REL of the peak (f32 with TF32
# off, cuDNN's and cuBLAS's sums in the orders their shapes pick: ~3e-6
# of it measured); against the numpy reference within ONNX_REF_REL of it
ONNX_REL = 1e-4
ONNX_REF_REL = 1e-3
ONNX_EMB_TOL = 1e-5


def card_name_and_limit() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip()


def onnx_bit_equal(got, want):
    """(each output of `got` bit for bit `want`'s, the largest |diff|);
    HOST outputs missing from `got` are skipped (a plan run returns the
    device outputs alone)."""
    import numpy as np
    import torch
    same, err = True, 0.0
    for k, w in want.items():
        if k not in got and not isinstance(w, torch.Tensor):
            continue
        g = got[k]
        if not isinstance(w, torch.Tensor):
            same &= (not isinstance(g, torch.Tensor)
                     and np.array_equal(np.asarray(g), np.asarray(w)))
        elif (not isinstance(g, torch.Tensor) or g.shape != w.shape
                or g.dtype != w.dtype):
            same, err = False, float("inf")
        else:
            if g.numel():
                err = max(err, (g.double() - w.double()).abs().max().item())
            same &= torch.equal(g, w)
    return same, err


def onnx_moved(stats, before):
    """What an executor's counters moved by since `before`."""
    return {k: round(stats[k] - before[k], 2) for k in (
        "walks", "plans", "captures", "replays", "plan_ms", "capture_ms")}


def onnx_eager_vmap(ex, feeds):
    """torch.func.vmap of an executor's eager walk (`run`), its HOST
    outputs unbatched: the reference of the jitted walk's vmap."""
    import torch
    host = {}

    def lane(lane_feeds):
        out = ex.run(lane_feeds)
        host.update((k, v) for k, v in out.items()
                    if not isinstance(v, torch.Tensor))
        return {k: v for k, v in out.items() if isinstance(v, torch.Tensor)}

    out = torch.func.vmap(lane)(feeds)
    out.update(host)
    return out


def onnx_call_timing(call, feeds, n):
    """One executor call's figures on the card: device ms (CUDA events
    around n calls in a row, over n), host wall (each call to a device
    sync) and enqueue (each call alone, the device idle before it), as
    medians of n; the device ops of one profiled call (kernels, copies,
    memsets) and their time, and its launching runtime calls by name."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        call(feeds)
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    for _ in range(n):
        call(feeds)
    ev1.record()
    torch.cuda.synchronize()
    walls, enqueues = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(feeds)
        enqueues.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call(feeds)
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev_events = [e for e in events if e.device_type.name == "CUDA"]
    launch_calls = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                    "cudaMemcpyAsync", "cudaMemsetAsync")
    return {"device_ms": ev0.elapsed_time(ev1) / n,
            "wall_ms": float(np.median(walls)),
            "enqueue_ms": float(np.median(enqueues)),
            "kernels": sum(e.count for e in dev_events),
            "kernel_ms": sum(e.self_device_time_total
                             for e in dev_events) / 1e3,
            "api": {e.key: e.count for e in events
                    if e.key in launch_calls}}


def drive_onnx(dev, failures):
    """The ONNX codec at the published contract's widths: the decoder graph
    (FULL: 512-channel pre-conv history, 1024-d latents, 8 x 16 heads of
    64, 2000 samples a frame), the audio-encoder graph (16 RVQ stages of
    2048 codes, 2000-sample hop) and the speaker-encoder graph (128 mels
    -> 2048), written from a seed under qwen3_tts_tpu_torch/build/ and
    removed at the end, beside the engine phase's full-width LMs on seeded
    development weights.  Every runner goes through
    OnnxExecutor.jitted() (a plan per signature, a CUDA graph from its
    second call).  The decoder alone: one call against 4 + 4 chunked
    calls, the port on the CPU and the numpy reference, an 8-lane
    decode_batch against each lane alone and its graph's replays against
    vmap of the eager walk bit for bit; a 4-frame call on a new executor
    as the eager walk (`run`), the plan run and the graph replay, each
    bit for bit against `run` and timed (CUDA events, host wall, enqueue,
    profiled device ops and launch calls), the plan's build and the
    graph's capture timed, the graph's bytes; beside it the native
    decode_chunk.  The engine (chunk path, greedy, bucket 32, 32 frames):
    codes equal a native-codec engine's on the same weights, audio a
    decode of them, the prefill and chunk kernels' launches; four streams
    against decodes of their own codes (TTFT, chunk intervals, ms/frame,
    the executor's counters: planned, captured and replayed, replayed,
    then on the eager walk; the second must walk nothing and replay);
    stream_batch at 8 lanes, a wave of 8 and a continuous-batching queue
    at batch 8, each lane against a decode of its own codes; clone from a
    10 s reference through the two encoder graphs against the port on the
    CPU; the three executors' counters (each must have replayed).
    Returns {"onnx": {kernel: launches}}."""
    import functools
    import shutil
    from pathlib import Path

    import numpy as np
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_onnx_fixtures as tfx
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
    from qwen3_tts_tpu_torch.core.config import EngineConfig
    from qwen3_tts_tpu_torch.io.audio import AudioSample, load_reference_wav
    from qwen3_tts_tpu_torch.io.onnx_exec import OnnxExecutor
    from qwen3_tts_tpu_torch.kernels.chunk_step import gen_chunk_fused
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked)
    from qwen3_tts_tpu_torch.kernels.predictor_frame import (
        predict_frame_fused)
    from qwen3_tts_tpu_torch.kernels.talker_step import talker_step_fused
    from qwen3_tts_tpu_torch.models.codec import decoder as codec_decoder
    from qwen3_tts_tpu_torch.models.codec.onnx_decoder import (
        OnnxAudioEncoder, OnnxSpeakerEncoder, OnnxStreamingDecoder)
    from qwen3_tts_tpu_torch.ops.mel import log_mel
    from qwen3_tts_tpu_torch.serve import codec_path
    from qwen3_tts_tpu_torch.serve.batch import (BatchRequest,
                                                 BatchSynthesizer)
    from qwen3_tts_tpu_torch.serve.continuous import ContinuousBatcher

    fns = {f.__name__: f for f in (
        flash_gqa_prefill_stacked, talker_step_fused, predict_frame_fused,
        gen_chunk_fused)}

    def peak(x):
        return float(np.abs(x).max()) if np.size(x) else 0.0

    def close(a, b, rel):
        """(a within rel * max |b| of b, max |a - b|, that over max |b|);
        an empty or all-zero b never passes."""
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or peak(b) == 0.0:
            return False, float("inf"), float("inf")
        err = float(np.abs(a - b).max())
        return err <= rel * peak(b), err, err / peak(b)

    root = (Path(__file__).resolve().parent / "qwen3_tts_tpu_torch" / "build"
            / f"onnx_model_{os.getpid()}")
    counts = {}
    try:
        t0 = time.perf_counter()
        (root / "onnx").mkdir(parents=True)
        dec_path = root / "onnx" / "qwen3_tts_decoder.onnx"
        enc_path = root / "onnx" / "qwen3_tts_codec_encoder.onnx"
        spk_path = root / "onnx" / "qwen3_tts_speaker_encoder.onnx"
        tfx.build_decoder(tfx.FULL, path=dec_path)
        t_dec = time.perf_counter() - t0
        enc_dims = tfx.EncDims()
        tfx.build_encoder(enc_dims, path=enc_path)
        tfx.build_speaker(tfx.SpkDims(), path=spk_path)
        print(f"[onnx] graphs written in {time.perf_counter() - t0:.2f} s "
              f"(FULL decoder {t_dec:.2f} s, "
              f"{dec_path.stat().st_size / 2**20:.1f} MiB; encoder "
              f"{enc_path.stat().st_size / 2**20:.1f} MiB; speaker "
              f"{spk_path.stat().st_size / 2**20:.1f} MiB)")

        # ------------------------------------------------ the decoder alone
        t0 = time.perf_counter()
        dec = OnnxStreamingDecoder.load(dec_path, dev)
        dec_cpu = OnnxStreamingDecoder.load(dec_path, "cpu")
        nodes = len(dec.ex.graph.nodes)
        print(f"[onnx] FULL decoder loaded on {dev} and the CPU in "
              f"{time.perf_counter() - t0:.2f} s: {nodes} nodes, "
              f"{len(dec.ex.params)} device tensors "
              f"({sum(t.numel() for t in dec.ex.params.values()) * 4 / 2**20:.0f}"
              f" MiB), ops {dec.ex.graph.op_histogram()}")
        rng = np.random.default_rng(3)
        codes = rng.integers(0, 2048, size=(8, 16))
        full, _ = dec.decode(codes, dec.create_state(), is_final=True)
        w1, st = dec.decode(codes[:4], dec.create_state())
        w2, st = dec.decode(codes[4:], st, is_final=True)
        cpu, _ = dec_cpu.decode(codes, dec_cpu.create_state(), is_final=True)
        ref = tfx.decoder_reference(tfx.FULL, codes)
        for what, want, rel, (ok, err, rerr) in (
                ("4 + 4 chunked calls vs one call", full, ONNX_REL,
                 close(np.concatenate([w1, w2]), full, ONNX_REL)),
                ("card vs the port on the CPU", cpu, ONNX_REL,
                 close(full, cpu, ONNX_REL)),
                ("card vs the numpy reference", ref, ONNX_REF_REL,
                 close(full, ref, ONNX_REF_REL))):
            print(f"[onnx] decoder {what}: max |diff| {err:.3e} (max |want| "
                  f"{peak(want):.3e}: {rerr:.2e} of it, bound {rel:g}) "
                  f"ok={ok}")
            if not ok:
                failures.append(f"onnx decoder: {what} max |diff| {err:.3e}"
                                f", {rerr:.2e} of the peak")
        if (full.shape != (8 * 2000,) or st["past_key_0"].shape
                != (1, 16, 8, 64) or st["past_key_0"].device.type != "cuda"):
            failures.append(f"onnx decoder: waveform {full.shape}, KV state "
                            f"{tuple(st['past_key_0'].shape)} on "
                            f"{st['past_key_0'].device}")
        lanes = rng.integers(0, 2048, size=(8, 4, 16))
        wavs, _ = dec.decode_batch(lanes, [dec.create_state()
                                           for _ in range(8)], is_final=True)
        errs = []
        for i in range(8):
            alone, _ = dec.decode(lanes[i], dec.create_state(), is_final=True)
            ok, err, rerr = close(wavs[i], alone, ONNX_REL)
            errs.append((rerr, err))
            if not ok:
                failures.append(f"onnx decode_batch lane {i}: max |diff| "
                                f"{err:.3e} against the lane alone, {rerr:.2e}"
                                " of its peak")
        print(f"[onnx] decode_batch of 8 lanes x 4 frames vs each lane "
              f"alone: max |diff| {max(errs)[1]:.3e}, {max(errs)[0]:.2e} of "
              f"the lane's peak (bound {ONNX_REL:g})")
        # the same signature's CUDA graph (decode_batch above planned it)
        # against vmap of the eager walk, per-lane finals
        bfeeds = {"audio_codes": torch.stack([dec._frames(c)[None]
                                              for c in lanes]),
                  "is_last": torch.stack([dec._is_last[i % 2 == 0]
                                          for i in range(8)])}
        bfeeds.update({k: torch.stack([v] * 8)
                       for k, v in dec.create_state().items()})
        replays = dec.ex.stats["replays"]
        for call in range(2):
            same, err = onnx_bit_equal(dec.ex.jitted().vmap(bfeeds),
                                       onnx_eager_vmap(dec.ex, bfeeds))
            print(f"[onnx] decode_batch's CUDA graph (8 lanes, call "
                  f"{call + 1} after its plan) vs vmap of the eager walk: "
                  f"bit-equal={same} (max |diff| {err:.3e})")
            if not same:
                failures.append(f"onnx decode_batch replay differs from "
                                f"vmap of run by {err:.3e}")
        if dec.ex.stats["replays"] != replays + 2:
            failures.append("onnx decode_batch did not replay its graph")

        # decode_batch against the same lanes decoded one by one: a
        # 4-frame chunk mid-stream (a stream_batch read) and 32 frames
        # from a fresh state, flushed (a wave's decode); host wall to the
        # waveforms on the host, order batch, lanes, lanes, batch
        mid = dec.decode_batch(lanes, [dec.create_state()
                                       for _ in range(8)])[1]
        lanes32 = rng.integers(0, 2048, size=(8, 32, 16))
        vs = {}
        for case, lane_codes, states, fin in (
                ("4 frames mid-stream", lanes, mid, False),
                ("32 frames fresh", lanes32,
                 [dec.create_state() for _ in range(8)], True)):
            def batch():
                return dec.decode_batch(lane_codes, list(states),
                                        is_final=fin)[0]

            def one_by_one():
                return [dec.decode(lane_codes[i], states[i], fin)[0]
                        for i in range(8)]

            t = {"batch": [], "lanes": []}
            for _ in range(2):                 # first calls of the shapes
                batch(), one_by_one()
            for _ in range(3):
                for name, fn in (("batch", batch), ("lanes", one_by_one),
                                 ("lanes", one_by_one), ("batch", batch)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    t[name].append((time.perf_counter() - t0) * 1e3)
            vs[case] = {k: float(np.median(v)) for k, v in t.items()}
            print(f"[onnx] 8 lanes, {case}: decode_batch {min(t['batch']):.2f}"
                  f"-{max(t['batch']):.2f} ms (median "
                  f"{vs[case]['batch']:.2f}), 8 decode calls "
                  f"{min(t['lanes']):.2f}-{max(t['lanes']):.2f} ms (median "
                  f"{vs[case]['lanes']:.2f}): decode_batch "
                  f"{vs[case]['lanes'] / vs[case]['batch']:.2f}x faster")

        # a 4-frame call mid-stream (a state after 4 frames), on a new
        # executor of the same graph, three ways: the eager walk (run),
        # the signature's plan run alone, its CUDA graph's replay
        # (jitted); the plan's build and the graph's capture timed
        st4 = dec.decode(codes[:4], dec.create_state())[1]
        chunk = codes[4:]
        feeds = {"audio_codes": dec._frames(chunk)[None],
                 "is_last": dec._is_last[False], **st4}
        ex = OnnxExecutor(dec.ex.graph, dev, source=str(dec_path))
        fn = ex.jitted()
        want = ex.run(feeds)
        built = {}
        for what in ("plan", "capture"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            built[what] = fn(feeds)
            torch.cuda.synchronize()
            built[what + "_ms"] = (time.perf_counter() - t0) * 1e3
        plan = next(iter(fn._entries.values())).plan
        # a second signature (3 frames after 4) planned, then captured
        # while the device is busy (two f32 8192^3 products enqueued, as a
        # stream's decoder call finds the next chunk kernel running): the
        # capture's host ms beside the idle one's
        feeds3 = dict(feeds, audio_codes=dec._frames(chunk[:3])[None])
        fn(feeds3)
        busy = torch.ones(8192, 8192, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            busy @ busy
        enqueued = (time.perf_counter() - t0) * 1e3
        ms0 = ex.stats["capture_ms"]
        fn(feeds3)
        busy_capture = ex.stats["capture_ms"] - ms0
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        busy_rest = (time.perf_counter() - t0) * 1e3
        del busy
        print(f"[onnx] a capture behind busy device work: "
              f"{busy_capture:.2f} ms of host (the products enqueued in "
              f"{enqueued:.2f} ms, then {busy_rest:.2f} ms of them left after "
              f"the capture); with the device idle "
              f"{ms0:.2f} ms (the capture alone, without its replay)")
        n_calls = 10
        modes = {"eager walk": ex.run,
                 "plan run": functools.partial(ex._run_plan, plan),
                 "graph replay": fn}
        timing = {}
        for mode, call in modes.items():
            same, err = onnx_bit_equal(call(feeds), want)
            timing[mode] = onnx_call_timing(call, feeds, n_calls)
            timing[mode].update(same=same, err=err)
            if not same:
                failures.append(f"onnx FULL decoder: the {mode} differs from "
                                f"run by {err:.3e}")
        same, err = onnx_bit_equal(built["capture"], want)
        if not same or ex.stats["plans"] != 2 or ex.stats["captures"] != 2:
            failures.append(f"onnx FULL decoder: the capture call's replay "
                            f"vs run {err:.3e}, stats {ex.stats}")
        print(f"[onnx] FULL decoder, one 4-frame call after 4 frames "
              f"({card_name_and_limit()}): plan built in "
              f"{built['plan_ms']:.2f} ms (one walk: {len(plan.steps)} "
              f"device steps of {nodes} nodes, "
              f"{sum(len(c) for _, c in plan.steps)} host copies held), "
              f"graph captured in {built['capture_ms']:.2f} ms (with a plan "
              f"run and the first replay), holding "
              f"{ex.stats['graph_bytes'] / 2**20:.2f} MiB; the capture "
              f"call's replay vs run bit-equal={same}")
        for mode, t in timing.items():
            print(f"[onnx]   {mode}: device (events) {t['device_ms']:.3f} ms, "
                  f"host wall {t['wall_ms']:.3f} ms (median of {n_calls}, "
                  f"each to a device sync), enqueue {t['enqueue_ms']:.3f} "
                  f"ms (median), kernels {t['kernels']} (profiled; "
                  f"{t['kernel_ms']:.3f} ms), API launches {t['api']}; vs "
                  f"run bit-equal={t['same']} (max |diff| {t['err']:.3e})")
        ex = fn = plan = modes = None
        for _ in range(2):                     # its plan is built: capture
            dec.decode(chunk, st4)
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        for _ in range(n_calls):
            dec.decode(chunk, st4)
        wall = (time.perf_counter() - t0) * 1e3 / n_calls
        # the native codec at full width (random weights), a 4-frame chunk
        ccfg = EngineConfig().codec_decoder
        cparams = codec_decoder.init_decoder_params(
            ccfg, torch.Generator(device=dev).manual_seed(3))
        ncodes = torch.from_numpy(chunk[None].astype(np.int32)).to(dev)
        nstate = codec_decoder.init_decoder_state(ccfg, 1, dev)
        with torch.no_grad():
            for _ in range(3):
                codec_decoder.decode_chunk(ccfg, cparams, ncodes, nstate)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev0.record()
            for _ in range(n_calls):
                nwav, _ = codec_decoder.decode_chunk(ccfg, cparams, ncodes,
                                                     nstate)
            ev1.record()
            nwav.cpu()
            nwall = (time.perf_counter() - t0) * 1e3 / n_calls
            torch.cuda.synchronize()
        ndev = ev0.elapsed_time(ev1) / n_calls
        print(f"[onnx]   OnnxStreamingDecoder.decode (the graph replay, the "
              f"waveform to the host) {wall:.3f} ms a call; the native "
              f"decode_chunk at full width, 4 frames: device {ndev:.3f} ms, "
              f"host wall {nwall:.3f} ms")

        # --------------------------------------------------------- engine
        t0 = time.perf_counter()
        native = TtsEngine(device=dev, speakers_dir="speakers")
        onnx = TtsEngine(model_dir=root, device=dev, speakers_dir="speakers",
                         weights=dict(assets=native.assets,
                                      talker=native.talker_params,
                                      predictor=native.predictor_params))
        torch.cuda.synchronize()
        print(f"[onnx] native and ONNX-codec engines in "
              f"{time.perf_counter() - t0:.2f} s; ONNX loads "
              f"{ {k: round(v, 2) for k, v in onnx.load_seconds.items()} }; "
              f"random components {onnx.dev_mode_components}; "
              f"chunk={onnx.chunk}")
        if (onnx.onnx_decoder is None or onnx.onnx_encoder is None
                or onnx.onnx_speaker is None or onnx.dev_mode_components):
            failures.append("onnx engine: a graph was not loaded")
        text = REQUESTS[0][1]
        for eng in (native, onnx):
            eng.set_max_steps(ONNX_FRAMES)
            eng.set_sampler_config(SamplerConfig(seed=1, **GREEDY))
        voice = onnx.get_speaker("vivian")
        native.generate_with_voice(text, voice)
        native_codes = native.last_codes
        onnx.generate_with_voice(text, voice)        # first use, untimed
        decode_ms = []
        real_decode = onnx.onnx_decoder.decode

        def timed_decode(*a, **k):
            t = time.perf_counter()
            out = real_decode(*a, **k)
            decode_ms.append((time.perf_counter() - t) * 1e3)
            return out

        onnx.onnx_decoder.decode = timed_decode
        before = dict(onnx.onnx_decoder.ex.stats)
        torch.cuda.synchronize()
        zero_counts(fns)
        t0 = time.perf_counter()
        audio = onnx.generate_with_voice(text, voice)
        wall = (time.perf_counter() - t0) * 1e3
        counts["onnx"] = read_counts(fns)
        moved = onnx_moved(onnx.onnx_decoder.ex.stats, before)
        del onnx.onnx_decoder.decode
        m = onnx.last_metrics
        same = np.array_equal(onnx.last_codes, native_codes)
        want, _ = onnx.onnx_decoder.decode(
            onnx.last_codes, onnx.onnx_decoder.create_state(), is_final=True)
        ok, err, rerr = close(audio.samples, want, ONNX_REL)
        print(f"[onnx] engine request: frames={m.frames} eos={m.eos} "
              f"samples={len(audio.samples)} codes equal the native-codec "
              f"engine's={same}; audio vs a decode of its codes max |diff| "
              f"{err:.3e} ({rerr:.2e} of the peak {peak(want):.3e}); "
              f"prefill_ms={m.prefill_ms:.2f} total_ms="
              f"{m.total_ms:.2f} wall_ms={wall:.2f} ms/frame="
              f"{m.total_ms / max(m.frames, 1):.2f}; the codec's decode "
              f"{sum(decode_ms):.2f} ms ({sum(decode_ms) / m.total_ms:.3f} "
              f"of the request; the decoder's executor {moved}); launches "
              f"{counts['onnx']}")
        if not same:
            failures.append("onnx engine: codes differ from the native-codec "
                            "engine's")
        if not ok or not np.isfinite(audio.samples).all() or m.frames == 0:
            failures.append(f"onnx engine: audio off a decode of its codes "
                            f"by {err:.3e}, {rerr:.2e} of the peak")
        for name in ONNX_PATH_KERNELS["onnx"]:
            want_n = (ONNX_LAUNCHES[name] if m.frames == ONNX_FRAMES
                      and not m.eos else 1)
            if (counts["onnx"][name] != want_n if m.frames == ONNX_FRAMES
                    and not m.eos else counts["onnx"][name] < want_n):
                failures.append(f"onnx engine: {name} launched "
                                f"{counts['onnx'][name]} times, not {want_n}")
        for name in ONNX_FORBIDDEN["onnx"]:
            if counts["onnx"][name]:
                failures.append(f"onnx engine launched {name}")

        # --------------------------------------------------------- stream
        # four: the first plans each of a stream's signatures (the
        # fixture's KV grows, so each call of a stream is one), the
        # second captures and replays their CUDA graphs, the third
        # replays alone; the last runs the eager walk (`run`) in their
        # place, for its chunk intervals
        dex = onnx.onnx_decoder.ex
        for rep in ("", " again", " a third time", " on the eager walk"):
            decode_ms.clear()
            onnx.onnx_decoder.decode = timed_decode
            if rep == " on the eager walk":
                onnx.onnx_decoder._run = dex.run
            before = dict(dex.stats)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chunks = list(onnx.generate_stream(text, voice))
            wall = (time.perf_counter() - t0) * 1e3
            del onnx.onnx_decoder.decode
            onnx.onnx_decoder._run = dex.jitted()
            moved = onnx_moved(dex.stats, before)
            m = onnx.last_metrics
            want, _ = onnx.onnx_decoder.decode(
                onnx.last_codes, onnx.onnx_decoder.create_state(),
                is_final=True)
            ok, err, rerr = close(np.concatenate(chunks), want, ONNX_REL)
            print(f"[onnx] stream{rep}: {len(chunks)} chunks of "
                  f"{[len(c) // 2000 for c in chunks]} frames; vs a decode "
                  f"of its own codes max |diff| {err:.3e} ({rerr:.2e} of "
                  f"the peak {peak(want):.3e}); TTFT {m.ttft_ms:.2f} ms; chunk "
                  f"intervals {[round(x, 2) for x in m.chunk_ms]} ms; the "
                  f"decoder's calls {[round(x, 2) for x in decode_ms]} ms; "
                  f"wall {wall:.2f} ms, "
                  f"{m.total_ms / max(m.frames, 1):.2f} ms/frame; the "
                  f"decoder's executor {moved}")
            if not ok:
                failures.append(f"onnx stream{rep}: off a decode of its "
                                f"codes by {err:.3e}, {rerr:.2e} of the peak")
            if rep == " again" and (moved["walks"] or moved["plans"]
                                    or not moved["replays"]):
                failures.append(f"onnx stream again: its signatures were "
                                f"seen, yet the executor moved {moved}")

        # -------------------------------------------------------- batching
        def lane_check(what, pairs):
            errs = []
            for i, (lane_codes, lane_audio) in enumerate(pairs):
                want, _ = onnx.onnx_decoder.decode(
                    lane_codes, onnx.onnx_decoder.create_state(),
                    is_final=True)
                ok, err, rerr = close(lane_audio, want, ONNX_REL)
                errs.append(rerr)
                if not ok or len(lane_codes) == 0:
                    failures.append(f"onnx {what} lane {i}: off a decode "
                                    f"of its codes by {err:.3e}, {rerr:.2e}"
                                    " of the peak")
            return max(errs)

        texts = [SERVING_TEXTS[0] + f" {i}." for i in range(8)]
        log = []
        real_chunk = onnx.generator.chunk

        def chunk_spy(*a, **k):
            out = real_chunk(*a, **k)
            log.append((out[1].cpu().numpy(), out[2].cpu().numpy()))
            return out

        onnx.generator.chunk = chunk_spy
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        waves = list(onnx.stream_batch(texts, voice))
        wall = (time.perf_counter() - t0) * 1e3
        del onnx.generator.chunk
        err = lane_check("stream_batch", [
            (np.concatenate([c[i][v[i]] for c, v in log]),
             np.concatenate([w[i] for w in waves])) for i in range(8)])
        print(f"[onnx] stream_batch 8 lanes: {len(waves)} chunks, wall "
              f"{wall:.2f} ms; lanes vs decodes of their codes: max |diff| "
              f"{err:.2e} of the lane's peak")

        bulk = []
        real_bulk = onnx.generator.run_bulk_codes

        def bulk_spy(*a, **k):
            out = real_bulk(*a, **k)
            bulk.append((out[1].cpu().numpy(), out[2].cpu().numpy()))
            return out

        onnx.generator.run_bulk_codes = bulk_spy
        reqs = [BatchRequest(t, voice) for t in texts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = BatchSynthesizer(onnx, batch_size=8).synthesize(reqs)
        wall = (time.perf_counter() - t0) * 1e3
        del onnx.generator.run_bulk_codes
        c, v = bulk[0]
        err = lane_check("wave", [(c[i][v[i]], r.audio.samples)
                                  for i, r in enumerate(results)])
        print(f"[onnx] wave of 8: frames {[r.frames for r in results]}, "
              f"wall {wall:.2f} ms; lanes vs decodes of their codes: max "
              f"|diff| {err:.2e} of the lane's peak")

        segments = {}
        real_audio = codec_path.LaneCodec.chunk_audio
        real_reset = codec_path.LaneCodec.reset_lanes

        def chunk_audio(self, codes_np, ks, finals):
            out = real_audio(self, codes_np, ks, finals)
            for lane in range(self.b):
                if int(ks[lane]) > 0:
                    seg = segments.setdefault(lane, [[[], []]])[-1]
                    seg[0].append(codes_np[lane][: int(ks[lane])])
                    seg[1].append(out[lane])
            return out

        def reset_lanes(self, mask):
            for lane in np.nonzero(mask)[0]:
                segments.setdefault(int(lane), [[[], []]]).append([[], []])
            return real_reset(self, mask)

        codec_path.LaneCodec.chunk_audio = chunk_audio
        codec_path.LaneCodec.reset_lanes = reset_lanes
        try:
            queue = [BatchRequest(SERVING_TEXTS[0] + f" {i}.", voice,
                                  max_frames=8 + 4 * (i % 3))
                     for i in range(12)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = ContinuousBatcher(onnx, batch_size=8).run(queue)
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            codec_path.LaneCodec.chunk_audio = real_audio
            codec_path.LaneCodec.reset_lanes = real_reset
        pairs = [(np.concatenate(cs), np.concatenate(au))
                 for segs in segments.values() for cs, au in segs if cs]
        err = lane_check("continuous", pairs)
        if len(pairs) != len(queue):
            failures.append(f"onnx continuous: {len(pairs)} streams for "
                            f"{len(queue)} requests")
        print(f"[onnx] continuous batching, batch 8, {len(queue)} requests: "
              f"frames {[r.frames for r in results]}, wall {wall:.2f} ms; "
              f"streams vs decodes of their codes: max |diff| {err:.2e} of "
              f"the stream's peak")

        # ---------------------------------------------------------- clone
        wav_path = root / "ref_10s.wav"
        AudioSample(samples=reference_wav(10, 10),
                    sample_rate=24000).save_wav(wav_path)
        clone_ms = []
        for _ in range(2):          # the first call of the encoder graphs
            t0 = time.perf_counter()
            vf = onnx.create_voice_file(wav_path, "A reference transcript.")
            torch.cuda.synchronize()
            clone_ms.append(round((time.perf_counter() - t0) * 1e3, 2))
        x = load_reference_wav(wav_path)
        cpu_codes = OnnxAudioEncoder.load(enc_path, "cpu").encode(x)
        cpu_emb = OnnxSpeakerEncoder.load(spk_path, "cpu").encode_mels(
            log_mel(torch.from_numpy(x)))
        got_codes = np.asarray(vf.audio_codes).reshape(-1, 16)
        same = np.array_equal(got_codes, cpu_codes)
        emb_err = float(np.abs(vf.embedding_array - cpu_emb).max())
        onnx.set_max_steps(8)
        audio = onnx.generate("Cloned on the card.", wav_path,
                              "A reference transcript.")
        print(f"[onnx] clone from a 10 s reference: codes {got_codes.shape} "
              f"equal the port on the CPU={same}; embedding max |diff| "
              f"{emb_err:.3e}; create_voice_file {clone_ms} ms; "
              f"generate: {onnx.last_metrics.frames} frames, "
              f"{len(audio.samples)} samples, finite="
              f"{bool(np.isfinite(audio.samples).all())}")
        if (not same or got_codes.shape != (120, 16)
                or emb_err > ONNX_EMB_TOL
                or not np.isfinite(audio.samples).all()
                or onnx.last_metrics.frames == 0):
            failures.append(f"onnx clone: codes equal={same} "
                            f"{got_codes.shape}, embedding {emb_err:.3e}")
        held = {name: dict(r.ex.stats) for name, r in (
            ("decoder", onnx.onnx_decoder), ("audio encoder",
                                             onnx.onnx_encoder),
            ("speaker encoder", onnx.onnx_speaker))}
        print(f"[onnx] the engine's executors ({card_name_and_limit()}): "
              f"{held}; their graphs hold "
              f"{sum(h['graph_bytes'] for h in held.values()) / 2**20:.2f} "
              f"MiB")
        if not all(h["replays"] for h in held.values()):
            failures.append(f"onnx: an executor never replayed a graph: "
                            f"{held}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


# The weights phase: a synthetic model directory in the published layout
# at full EngineConfig() widths and depths, read by
# TtsEngine(quant="q8_0"): int8 device weights.  Its paths and the kernels
# each must launch (the first path naming a kernel gives its `launches` in
# the kernels line when no earlier phase did); every per-kernel path
# launches its own talker-step mode and no other
WEIGHTS_PATH_KERNELS = {
    "weights-chunk": ("flash_gqa_prefill_stacked", "gen_chunk_fused"),
    "weights-step-w4a8": ("talker_step_fused", "predict_frame_fused"),
    "weights-step-int8": ("talker_step_fused", "predict_frame_fused"),
    "weights-step-w8a8": ("talker_step_fused", "predict_frame_fused"),
    "weights-step-bf16": ("talker_step_fused", "predict_frame_fused"),
    "weights-exact": ("flash_gqa_prefill_stacked", "flash_gqa_decode",
                      "flash_gqa_decode_stacked"),
    "weights-int4": ("matmul_int4", "matmul_int4_tile", "int4_splitk_sum",
                     "flash_gqa_decode"),
}
WEIGHTS_FORBIDDEN = {
    "weights-chunk": ("talker_step_fused", "predict_frame_fused",
                      "matmul_int4"),
    "weights-exact": ("talker_step_fused", "gen_chunk_fused", "matmul_int4"),
    "weights-int4": ("talker_step_fused", "gen_chunk_fused"),
}
WEIGHTS_TEXT = "Weights read from a GGUF model directory."   # bucket 32
TALKER_VOCAB = 3072        # the talker GGUF's LM head rows (>= 2160)


def seeded_f16(g, dev):
    """f16(*shape, scale): a seeded normal f16 numpy array, drawn on dev."""
    def f16(*shape, scale):
        import torch
        return (torch.randn(shape, generator=g, device=dev) * scale).half(
        ).cpu().numpy()
    return f16


def lm_gguf(c, vocab, f16):
    """(tensors, metadata) of a Qwen3 LM GGUF at config c under
    llama.cpp's tensor names, F16 weights from f16 (the random init's
    scales: d^-0.5, (h * dh)^-0.5, d_ff^-0.5; unit norms)."""
    import numpy as np
    d, f, dq, dkv = (c.d_model, c.d_ff, c.n_heads * c.head_dim,
                     c.n_kv_heads * c.head_dim)
    ones = np.ones(d, np.float32)
    t = {}
    for i in range(c.n_layers):
        p_ = f"blk.{i}."
        t.update({
            p_ + "attn_norm.weight": ones, p_ + "ffn_norm.weight": ones,
            p_ + "attn_q.weight": f16(dq, d, scale=d ** -0.5),
            p_ + "attn_k.weight": f16(dkv, d, scale=d ** -0.5),
            p_ + "attn_v.weight": f16(dkv, d, scale=d ** -0.5),
            p_ + "attn_output.weight": f16(d, dq, scale=dq ** -0.5),
            p_ + "attn_q_norm.weight": np.ones(c.head_dim, np.float32),
            p_ + "attn_k_norm.weight": np.ones(c.head_dim, np.float32),
            p_ + "ffn_gate.weight": f16(f, d, scale=d ** -0.5),
            p_ + "ffn_up.weight": f16(f, d, scale=d ** -0.5),
            p_ + "ffn_down.weight": f16(d, f, scale=f ** -0.5)})
    t["output_norm.weight"] = ones
    t["output.weight"] = f16(vocab, d, scale=d ** -0.5)
    meta = {"general.architecture": "qwen3",
            "qwen3.block_count": c.n_layers,
            "qwen3.attention.head_count": c.n_heads,
            "qwen3.attention.head_count_kv": c.n_kv_heads,
            "qwen3.embedding_length": d,
            "qwen3.feed_forward_length": f,
            "qwen3.attention.key_length": c.head_dim,
            "qwen3.rope.freq_base": float(c.rope_theta)}
    return t, meta


# the model directory of write_model_dir, written once a run and shared by
# the weights and tools phases: {"root": Path or None, "users": phases
# that still need it}; the last user removes it
MODEL_DIR = {"root": None, "users": set()}


def smoke_model_dir(dev):
    """(root, {file: (seconds, bytes)} if this call wrote it, else {})."""
    from qwen3_tts_tpu_torch.kernels.build import BUILD_ROOT
    import shutil
    if MODEL_DIR["root"] is not None:
        return MODEL_DIR["root"], {}
    root = BUILD_ROOT / f"smoke_model_{os.getpid()}"
    shutil.rmtree(root, ignore_errors=True)
    MODEL_DIR["root"] = root
    return root, write_model_dir(root, dev)


def release_model_dir(phase: str) -> None:
    """`phase` is done with the model directory; the last user removes it."""
    import shutil
    MODEL_DIR["users"].discard(phase)
    if not MODEL_DIR["users"] and MODEL_DIR["root"] is not None:
        shutil.rmtree(MODEL_DIR["root"], ignore_errors=True)
        MODEL_DIR["root"] = None


def write_model_dir(root, dev, seed: int = 11) -> dict:
    """A model directory in the published layout under `root`, made from a
    seed on the card: gguf_q8_0/ with the talker (28 x 2048) and
    predictor (6 x 1024) GGUFs in F16 under llama.cpp's tensor names (the
    random init's scales: d^-0.5, (h * dh)^-0.5, d_ff^-0.5; unit norms)
    and qwen3_assets.gguf (tests/test_engine_gguf.py's row counts: text
    rows up to EOS_TOKEN, 3,100 codec rows), and codec/decoder.npz from
    the codec's random init, and codec/encoder.npz and codec/speaker.npz
    from the cloning encoders'.  Returns {file: (seconds, bytes)}."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import EngineConfig
    from qwen3_tts_tpu_torch.core import protocol as P
    from qwen3_tts_tpu_torch.io.gguf import write_gguf
    from qwen3_tts_tpu_torch.models.codec import decoder as codec_decoder
    from qwen3_tts_tpu_torch.models.codec import encoder as codec_encoder
    from qwen3_tts_tpu_torch.models.codec import speaker as speaker_lib

    cfg = EngineConfig()
    gdir = root / "gguf_q8_0"
    gdir.mkdir(parents=True)
    g = torch.Generator(device=dev).manual_seed(seed)
    f16 = seeded_f16(g, dev)

    def lm(c, vocab):
        return lm_gguf(c, vocab, f16)

    written = {}
    for name, make in (
            ("qwen3_tts_talker.gguf", lambda: lm(cfg.talker, TALKER_VOCAB)),
            ("qwen3_tts_predictor.gguf",
             lambda: lm(cfg.predictor, cfg.predictor.vocab_size)),
            ("qwen3_assets.gguf", lambda: ({
                "proj.weight": f16(P.PREDICTOR_DIM, P.TALKER_DIM,
                                   scale=0.02).astype(np.float32),
                "proj.bias": f16(P.PREDICTOR_DIM, scale=0.02).astype(
                    np.float32),
                "text_embd": f16(P.EOS_TOKEN + 2, P.TALKER_DIM, scale=0.02),
                **{f"codec_embd.{i}": f16(3100, P.TALKER_DIM, scale=0.02)
                   for i in range(P.NUM_CODEBOOKS)}}, {}))):
        t0 = time.perf_counter()
        tensors, meta = make()
        write_gguf(gdir / name, tensors, meta)
        del tensors
        written[name] = (time.perf_counter() - t0,
                         (gdir / name).stat().st_size)
    t0 = time.perf_counter()
    (root / "codec").mkdir()
    with torch.no_grad():
        dec = codec_decoder.init_decoder_params(cfg.codec_decoder, g)
    flat = {}

    def walk(node, prefix):
        items = (node.items() if isinstance(node, dict)
                 else enumerate(node) if isinstance(node, (list, tuple))
                 else None)
        if items is None:
            flat[prefix[:-1]] = node.float().cpu().numpy()
            return
        for k, v in items:
            walk(v, f"{prefix}{k}/")

    walk(dec, "")
    np.savez(root / "codec" / "decoder.npz", **flat)
    written["codec/decoder.npz"] = (
        time.perf_counter() - t0, (root / "codec" / "decoder.npz").stat()
        .st_size)
    # the cloning encoders, in the JAX engine's flattened layout too
    for name, init, sub in (
            ("encoder.npz", codec_encoder.init_encoder_params,
             cfg.codec_encoder),
            ("speaker.npz", speaker_lib.init_speaker_params,
             cfg.speaker_encoder)):
        t0 = time.perf_counter()
        flat = {}
        with torch.no_grad():
            walk(init(sub, g), "")
        np.savez(root / "codec" / name, **flat)
        written[f"codec/{name}"] = (time.perf_counter() - t0,
                                    (root / "codec" / name).stat().st_size)
    return written


def drive_weights(dev, failures):
    """The deployed weight path at full width: write_model_dir, then
    TtsEngine(model_dir, quant="q8_0") twice (the second reads the weight
    cache; its tensors must equal the first's), then one greedy request
    (MAX_STEPS frames, bucket 32) and a rerun on each path: chunk (the
    default: w4a8 re-quantized from the int8 weights), per-kernel in each
    talker mode, exact (int8 matmuls, a8w8 prefill), and the exact path on
    quantize_decoder_layers_int4 layers (8 frames: matmul_int4).  Each
    request: frames x 2000 finite, non-silent samples, the rerun's codes
    equal, the path's kernels launched and no other talker mode's.
    Returns {path: {kernel: launches}} (and the talker's by mode)."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine
    from qwen3_tts_tpu_torch.kernels.chunk_step import gen_chunk_fused
    from qwen3_tts_tpu_torch.kernels.flash_decode import (
        flash_gqa_decode, flash_gqa_decode_stacked)
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked)
    from qwen3_tts_tpu_torch.kernels.int4_matmul import matmul_int4
    from qwen3_tts_tpu_torch.kernels.predictor_frame import (
        predict_frame_fused)
    from qwen3_tts_tpu_torch.kernels.talker_step import MODES, talker_step_fused
    from qwen3_tts_tpu_torch.ops import quant as Q

    fns = {f.__name__: f for f in (
        flash_gqa_prefill_stacked, flash_gqa_decode_stacked,
        flash_gqa_decode, talker_step_fused, predict_frame_fused,
        gen_chunk_fused, matmul_int4)}
    counts = {}
    try:
        root, written = smoke_model_dir(dev)
        for name, (sec, size) in written.items():
            print(f"[weights] wrote {name}: {size / 1e9:.3f} GB in "
                  f"{sec:.2f} s")
        builds = []
        for n in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng = TtsEngine(root, quant="q8_0", device=dev,
                            speakers_dir="speakers")
            torch.cuda.synchronize()
            builds.append((eng, time.perf_counter() - t0))
            print(f"[weights] TtsEngine(quant='q8_0') build {n + 1}: "
                  f"{builds[-1][1]:.2f} s (talker from "
                  f"{eng.weight_sources.get('talker')}, "
                  f"{eng.load_seconds['talker']:.2f} s; predictor from "
                  f"{eng.weight_sources.get('predictor')}, "
                  f"{eng.load_seconds['predictor']:.2f} s; assets "
                  f"{eng.load_seconds['assets']:.2f} s; kernel weights "
                  f"packed in {eng.load_seconds['kernel_pack']:.2f} s); "
                  f"random components {eng.dev_mode_components}; "
                  f"talker {eng.config.talker.n_layers} x "
                  f"{eng.config.talker.d_model}, fused={eng.fused} "
                  f"chunk={eng.chunk}")
        (e1, _), (e2, _) = builds
        leaves = lambda t: (
            [x for v in (t.values() if isinstance(t, dict) else t)
             for x in leaves(v)] if isinstance(t, (dict, list)) else [t])
        same = all(
            torch.equal(a, b) and a.dtype == b.dtype
            for p1, p2 in ((e1.talker_params, e2.talker_params),
                           (e1.predictor_params, e2.predictor_params))
            for a, b in zip(leaves(p1), leaves(p2)))
        int8 = (Q.is_quantized(e1.talker_params["layers"]["wqkv"])
                and Q.is_quantized(e1.predictor_params["lm_head"]))
        cached = e2.weight_sources == {"talker": "cache",
                                       "predictor": "cache"}
        print(f"[weights] int8 device weights={int8}; second build read the "
              f"weight cache={cached}, tensors equal to the first build's="
              f"{same}; random components {e1.dev_mode_components}")
        if not (int8 and cached and same and not e1.dev_mode_components
                and e1.fused and e1.chunk):
            failures.append("weights: the GGUF engine or its cache is wrong")
        # a voice from reference audio on the encoders read from the npz
        from qwen3_tts_tpu_torch.io.audio import AudioSample
        ref = root / "ref.wav"
        AudioSample(samples=reference_wav(2, 7),
                    sample_rate=24000).save_wav(ref)
        t0 = time.perf_counter()
        voice = e1.create_voice_file(ref, "A reference.")
        wall = (time.perf_counter() - t0) * 1e3
        emb = voice.embedding_array
        ok = (voice.codes_array.shape == (24, 16)
              and bool(np.isfinite(emb).all())
              and abs(float(np.linalg.norm(emb)) - 1.0) < 1e-4)
        print(f"[weights] create_voice_file on codec/encoder.npz and "
              f"codec/speaker.npz (neither random: "
              f"{not {'codec_encoder', 'speaker_encoder'} & set(e1.dev_mode_components)}"
              f"): 2 s reference, codes {voice.codes_array.shape}, embedding "
              f"norm {float(np.linalg.norm(emb)):.6f}, {wall:.1f} ms; "
              f"well-formed={ok}")
        if not ok:
            failures.append("weights: create_voice_file on the npz encoders "
                            "is malformed")
        del e2, builds
        weights = dict(assets=e1.assets, talker=e1.talker_params,
                       predictor=e1.predictor_params,
                       codec_decoder=e1.codec_decoder_params)
        spf = e1.config.codec_decoder.samples_per_frame

        def run(path, engine, frames):
            engine.set_max_steps(frames)
            voice = engine.get_speaker("vivian")
            zero_counts(fns)
            talker_step_fused.launches_by_mode = dict.fromkeys(MODES, 0)
            codes = []
            for rep in range(2):
                engine.set_sampler_config(SamplerConfig(seed=5, **GREEDY))
                t0 = time.perf_counter()
                audio = engine.generate_with_voice(WEIGHTS_TEXT, voice)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1000.0
                m, x = engine.last_metrics, audio.samples
                ok = (m.frames > 0 and len(x) == m.frames * spf
                      and bool(np.isfinite(x).all())
                      and float(np.abs(x).max()) > 1e-4)
                codes.append(engine.last_codes)
                print(f"[weights] {path} request {rep + 1}: frames="
                      f"{m.frames} samples={len(x)} (= frames x {spf}: "
                      f"{len(x) == m.frames * spf}) finite="
                      f"{bool(np.isfinite(x).all())} peak="
                      f"{float(np.abs(x).max()) if len(x) else 0.0:.4f} "
                      f"prefill_ms={m.prefill_ms:.2f} wall_ms={wall:.2f} "
                      f"ms/frame={wall / max(m.frames, 1):.2f}")
                if not ok:
                    failures.append(f"weights {path}: bad audio")
            same_codes = np.array_equal(codes[0], codes[1])
            c = read_counts(fns)
            by_mode = dict(talker_step_fused.launches_by_mode)
            c["talker_step_fused_by_mode"] = by_mode
            counts[path] = c
            print(f"[weights] {path}: rerun codes equal={same_codes}; "
                  f"launches {c}")
            if not same_codes:
                failures.append(f"weights {path}: a rerun gave other codes")
            for name in WEIGHTS_PATH_KERNELS[path]:
                if c[name] <= 0:
                    failures.append(f"weights {path} never launched {name}")
            for name in WEIGHTS_FORBIDDEN.get(path, ()):
                if c[name] != 0:
                    failures.append(f"weights {path} launched {name}")
            if path.startswith("weights-step-"):
                mode = path.rsplit("-", 1)[1]
                if (by_mode[mode] <= 0 or c["gen_chunk_fused"] != 0
                        or any(by_mode[m_] for m_ in MODES if m_ != mode)):
                    failures.append(f"weights {path}: talker modes launched "
                                    f"{by_mode}")

        run("weights-chunk", e1, MAX_STEPS)
        for mode in MODES:
            eng = TtsEngine(device=dev, speakers_dir="speakers", fused=True,
                            chunk=False, talker_mode=mode, weights=weights,
                            quant="q8_0")
            run(f"weights-step-{mode}", eng, MAX_STEPS)
            del eng
        eng = TtsEngine(device=dev, speakers_dir="speakers", fused=False,
                        weights=weights, quant="q8_0")
        run("weights-exact", eng, MAX_STEPS)
        del eng, e1
        # int4 layers (ops.quant.quantize_decoder_layers_int4 of the int8
        # weights' f32 values); heads stay int8
        with torch.no_grad():
            w4 = {}
            for key, src in (("talker", weights["talker"]),
                             ("predictor", weights["predictor"])):
                layers = {k: (Q.dequantize(v) if Q.is_quantized(v) else v)
                          for k, v in src["layers"].items()}
                w4[key] = dict(src, layers=Q.quantize_decoder_layers_int4(
                    layers))
                del layers
        eng = TtsEngine(device=dev, speakers_dir="speakers", fused=False,
                        weights=dict(weights, **w4), quant="q8_0")
        run("weights-int4", eng, 8)
        del eng, w4
    finally:
        release_model_dir("weights")
    return counts


# ---------------------------------------------------------------- tools
TOOLS_PATH_KERNELS = {"tools": ("flash_gqa_prefill_stacked",
                                "flash_gqa_decode_stacked",
                                "flash_gqa_decode", "gen_chunk_fused")}
# tests/test_native.py's tolerance of the native dequantizers against numpy
NATIVE_RTOL, NATIVE_ATOL = 1e-5, 1e-6
# llama-parity's talker at full width, its depth cut to two layers
PARITY_LAYERS = 2
# a top-1 miss of llama-parity is excused only where both sides' two picks
# lie within this share of max |logit| of each other (a near tie)
PARITY_TIE = 0.05
# the runbook's hub probe, aimed at a closed port of this host: the card's
# machine has no network, and the probe must not try an outside host
CLOSED_HUB = "http://127.0.0.1:9"
TOOLS_TEXT = "The tools of the port on the card."     # bucket 32


def tools_native(root, failures):
    """(a) The native host library: built from native/qtts_native.cpp; its
    dequantizers against the numpy path for the six quant types on seeded
    blocks; qtts_f16_to_f32 on every finite f16; the full-width talker
    GGUF read through the multi-threaded loader (one float32 arena) and
    through numpy, tensor by tensor.  Returns {"build_s", "native_s",
    "numpy_s", "gb"}."""
    import ctypes

    import numpy as np
    from qwen3_tts_tpu_torch.io import gguf
    from qwen3_tts_tpu_torch.utils import native

    def numpy_only(fn, *a):
        saved = native._LIB, native._TRIED
        native._LIB, native._TRIED = None, True
        try:
            return fn(*a)
        finally:
            native._LIB, native._TRIED = saved

    t0 = time.perf_counter()
    lib = native.get_lib()
    out = {"build_s": time.perf_counter() - t0}
    if lib is None:
        failures.append("tools: the native library did not build (no host "
                        "C++ compiler)")
        return out
    print(f"[tools] native library {native.build()} from {native.SOURCE} "
          f"({native.compiler()} {' '.join(native.CXX_FLAGS)}) in "
          f"{out['build_s']:.2f} s")
    worst = 0.0
    for gt, bb, eb in ((gguf.GGML_Q8_0, 34, 32), (gguf.GGML_Q4_0, 18, 32),
                       (gguf.GGML_Q5_0, 22, 32), (gguf.GGML_Q4_K, 144, 256),
                       (gguf.GGML_Q5_K, 176, 256), (gguf.GGML_Q6_K, 210, 256)):
        rng = np.random.default_rng(gt)
        nb = 1024
        raw = rng.integers(0, 256, bb * nb, dtype=np.uint8).reshape(nb, bb)
        raw[:, :2] = np.frombuffer(np.float16(0.5).tobytes(), np.uint8)
        if gt in (gguf.GGML_Q4_K, gguf.GGML_Q5_K):
            raw[:, 2:4] = np.frombuffer(np.float16(0.25).tobytes(), np.uint8)
        if gt == gguf.GGML_Q6_K:
            raw[:, 208:210] = np.frombuffer(np.float16(0.5).tobytes(),
                                            np.uint8)
        raw = raw.reshape(-1)
        fast = native.native_dequantize(raw, gt, eb * nb)
        ref = numpy_only(gguf.dequantize, raw, gt, eb * nb)
        err = float(np.abs(fast - ref).max())
        worst = max(worst, err)
        if not np.allclose(fast, ref, rtol=NATIVE_RTOL, atol=NATIVE_ATOL):
            failures.append(f"tools: native {gguf.TYPE_NAMES[gt]} disagrees "
                            f"with numpy (max abs {err:.3e})")
    bits = np.arange(65536, dtype=np.uint16)
    f32 = np.empty(65536, np.float32)
    lib.qtts_f16_to_f32(bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                        65536, f32.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_float)))
    ref = bits.view(np.float16).astype(np.float32)
    f16_ok = bool(np.array_equal(f32[np.isfinite(ref)],
                                 ref[np.isfinite(ref)]))
    print(f"[tools] native dequantize Q8_0/Q4_0/Q5_0/Q4_K/Q5_K/Q6_K (1,024 "
          f"seeded blocks each) against numpy: max abs {worst:.3e} (rtol "
          f"{NATIVE_RTOL}, atol {NATIVE_ATOL}); qtts_f16_to_f32 exact on "
          f"every finite f16: {f16_ok}")
    if not f16_ok:
        failures.append("tools: qtts_f16_to_f32 is not exact")

    g = gguf.read_gguf(root / "gguf_q8_0" / "qwen3_tts_talker.gguf")
    names = g.names()
    arenas = []
    real_load = native.native_load_tensors

    def load(*a, **k):
        arenas.append(1)
        return real_load(*a, **k)
    native.native_load_tensors = load
    try:
        t0 = time.perf_counter()
        fast = g.read_tensors(names)
        out["native_s"] = time.perf_counter() - t0
    finally:
        native.native_load_tensors = real_load
    out["numpy_s"], same = 0.0, True
    for name in names:
        t0 = time.perf_counter()
        slow = numpy_only(g.read_tensor, name)
        out["numpy_s"] += time.perf_counter() - t0
        same = same and np.array_equal(fast[name], slow)
    out["gb"] = sum(a.nbytes for a in fast.values()) / 1e9
    del fast
    print(f"[tools] talker GGUF ({len(names)} tensors, F16 -> "
          f"{out['gb']:.3f} GB f32): native loader (one arena, "
          f"{os.cpu_count()} host cores) {out['native_s']:.2f} s, numpy "
          f"tensor by tensor {out['numpy_s']:.2f} s; equal={same}; arena "
          f"path taken={arenas == [1]} (warm file cache)")
    if not (same and arenas == [1]):
        failures.append("tools: the native GGUF loader's tensors differ from "
                        "numpy's, or it did not run")
    return out


def tools_runbook(root, dev, failures):
    """(b) verify.run_drills on the smoke's model directory on the card:
    assets-gguf, talker-gguf and predictor-gguf PASS at full width, every
    other drill SKIPs (no .onnx graph, tokenizer, dump or --golden in the
    repository; the hub probe aimed at a closed local port), none FAILs.
    Returns its seconds."""
    from qwen3_tts_tpu_torch import verify
    from qwen3_tts_tpu_torch.io import download as dl
    saved = dl.HF_BASE, dl.HF_MIRROR, os.environ.pop("QTTS_HF_BASE", None)
    dl.HF_BASE = dl.HF_MIRROR = CLOSED_HUB
    try:
        t0 = time.perf_counter()
        drills = verify.run_drills(root, quant="q8_0", device=dev)
        seconds = time.perf_counter() - t0
    finally:
        dl.HF_BASE, dl.HF_MIRROR = saved[:2]
        if saved[2] is not None:
            os.environ["QTTS_HF_BASE"] = saved[2]
    summary = verify.summary(drills, root, "q8_0")
    print(json.dumps(summary))
    status = summary["drills"]
    probe_s = next(d.seconds for d in drills if d.name == "hub-probe")
    print(f"[tools] runbook on the card: {seconds:.2f} s (hub probe "
          f"{probe_s:.2f} s); " + ", ".join(
              f"{d.name} {d.seconds:.2f} s" for d in drills
              if d.status == "PASS"))
    want = {n: "PASS" for n in ("assets-gguf", "talker-gguf",
                                "predictor-gguf")}
    bad = [n for n, s in status.items() if s != want.get(n, "SKIP")]
    if summary["fail"] or bad or probe_s > 10.0:
        failures.append(f"tools: runbook drills {bad} (fail "
                        f"{summary['fail']}, hub probe {probe_s:.2f} s)")
    return seconds


def tools_parity(work, dev, failures):
    """(c) llama-parity on the card: make_inputs (48 rows, 8 steps, d
    2048), a talker GGUF at full width and PARITY_LAYERS layers, the
    "dump" from run_our_talker on the CPU (the plain path), then
    compare_talker on the card (the prefill kernel, then the decode
    attention kernel a layer a step) under the JAX rule (rel <= 5e-2,
    top-1 >= 0.99), a top-1 miss excused only at a near tie (PARITY_TIE),
    each miss printed with its leads."""
    import dataclasses

    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.core.config import TalkerConfig
    from qwen3_tts_tpu_torch.io import llama_parity as lp
    from qwen3_tts_tpu_torch.io import weights as weights_io
    from qwen3_tts_tpu_torch.io.gguf import write_gguf

    inputs = work / "parity_inputs.npz"
    data = lp.make_inputs(inputs, d_model=2048)
    cfg = dataclasses.replace(TalkerConfig(), n_layers=PARITY_LAYERS)
    tensors, meta = lm_gguf(cfg, TALKER_VOCAB, seeded_f16(
        torch.Generator(device=dev).manual_seed(13), dev))
    path = work / "talker_parity.gguf"
    write_gguf(path, tensors, meta)
    del tensors
    t0 = time.perf_counter()
    ccfg, cparams = weights_io.load_talker_gguf(path, TalkerConfig(), "cpu")
    dump = work / "parity_dump.npz"
    np.savez(dump, **lp.run_our_talker(ccfg, cparams, data, device="cpu"))
    cpu_s = time.perf_counter() - t0
    del cparams
    seen = {}
    real = lp.run_our_talker

    def spy(*a, **k):
        seen["ours"] = real(*a, **k)
        return seen["ours"]
    lp.run_our_talker = spy
    try:
        t0 = time.perf_counter()
        stats = lp.compare_talker(path, inputs, dump, device=dev,
                                  tie_tol=PARITY_TIE)
        ok = True
    except AssertionError as e:
        stats, ok = {"error": str(e)}, False
    finally:
        lp.run_our_talker = real
    card_s = time.perf_counter() - t0
    misses = (lp.top1_misses(seen["ours"], dict(np.load(dump)))
              if "ours" in seen else [])
    print(f"[tools] llama-parity: talker {ccfg.n_layers} x {ccfg.d_model} "
          f"(depth cut from 28), 48 prompt rows + 8 steps; the plain path "
          f"on the CPU {cpu_s:.2f} s, compare_talker on the card "
          f"{card_s:.2f} s; passed={ok} "
          + json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                        for k, v in stats.items()}))
    for tag, row, a, b, lead_a, lead_b in misses:
        print(f"[tools] llama-parity top-1 miss: {tag} row {row}: the card "
              f"picks {a}, {lead_a:.3e} above {b}; the CPU picks {b}, "
              f"{lead_b:.3e} above {a} (of max |logit|; near tie <= "
              f"{PARITY_TIE}: {max(lead_a, lead_b) <= PARITY_TIE})")
    if not ok:
        failures.append("tools: llama-parity on the card failed the JAX rule")


def tools_cli(root, work, vfile, failures):
    """(f) The CLI in two subprocesses at once, on the directory's weight
    cache: one request with --skip-download (a WAV of frames x 2000
    samples, no download warning) and --audition-voice of `vfile` (a WAV
    of its reference frames x 2000 samples)."""
    import wave
    env = {k: v for k, v in os.environ.items() if not k.startswith("QTTS_")}
    here = os.path.dirname(os.path.abspath(__file__))

    def cli(*args):
        return subprocess.Popen(
            [sys.executable, "-m", "qwen3_tts_tpu_torch", "--skip-download",
             "--model-dir", str(root), "--quant", "q8_0", "--speakers-dir",
             "speakers", *args], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=here, env=env)

    def samples(path):
        if not path.exists():
            return None
        with wave.open(str(path)) as w:
            return w.getnframes(), w.getframerate()

    out, aud = work / "cli.wav", work / "audition.wav"
    t0 = time.perf_counter()
    procs = [cli("--text", TOOLS_TEXT, "--max-steps", "8", "--seed", "1",
                 "--temperature", "0", "--metrics", "--output", str(out)),
             cli("--text", "unused", "--audition-voice", str(vfile),
                 "--output", str(aud))]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:            # stop what a timeout left running
            if p.poll() is None:
                p.kill()
                p.wait()
    sec = time.perf_counter() - t0
    (stdout, stderr), (a_out, a_err) = outs
    metrics = next((json.loads(x) for x in stdout.splitlines()
                    if x.startswith("{")), {})
    ok = (procs[0].returncode == 0 and "Device: cuda" in stdout
          and "[warn]" not in stderr and metrics.get("frames", 0) > 0
          and samples(out) == (metrics["frames"] * 2000, 24000))
    print(f"[tools] python -m qwen3_tts_tpu_torch --skip-download: rc "
          f"{procs[0].returncode}, frames {metrics.get('frames')}, wav "
          f"{samples(out)}; ok={ok}")
    if not ok:
        print(stdout[-2000:], stderr[-4000:], file=sys.stderr)
        failures.append("tools: the CLI request failed")
    n_frames = len(json.loads(vfile.read_text())["audio_codes"]) // 16
    ok = (procs[1].returncode == 0 and n_frames > 0
          and samples(aud) == (n_frames * 2000, 24000))
    print(f"[tools] --audition-voice ({n_frames} reference frames): rc "
          f"{procs[1].returncode}, wav {samples(aud)}; ok={ok}; both "
          f"processes, side by side, {sec:.2f} s")
    if not ok:
        print(a_out[-2000:], a_err[-4000:], file=sys.stderr)
        failures.append("tools: --audition-voice failed")


def drive_tools(dev, failures):
    """The ported tools on the card (module docstring, phase tools): (a)
    tools_native, (b) tools_runbook, (c) tools_parity, then on the default
    engine built from the smoke's model directory (quant q8_0): (d) the
    golden-wav body recorded and verified, (e) tracing: a request under
    QTTS_PROFILE_DIR (its trace names the chunk and prefill kernels, its
    codes equal an untraced run's), under QTTS_CHECKS (equal codes) and
    under QTTS_DEBUG_NANS (equal codes; with a NaN planted in the talker's
    final norm, FloatingPointError), (f) the CLI in a subprocess: one
    request with --skip-download and --audition-voice of a VoiceFile
    cloned from a 2 s reference.  Returns {"tools": {kernel: launches}}
    from (b)-(e) (the decode attention's one-layer kernel, and its combine
    kernel where a cache spans several 64-slot chunks, counted through
    flash_gqa_decode)."""
    import shutil

    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import SamplerConfig, TtsEngine, verify
    from qwen3_tts_tpu_torch.io.audio import AudioSample
    from qwen3_tts_tpu_torch.kernels.build import BUILD_ROOT
    from qwen3_tts_tpu_torch.kernels.chunk_step import gen_chunk_fused
    from qwen3_tts_tpu_torch.kernels.flash_decode import (
        flash_gqa_decode, flash_gqa_decode_stacked)
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked)
    from qwen3_tts_tpu_torch.utils import tracing

    fns = {f.__name__: f for f in (flash_gqa_prefill_stacked,
                                   flash_gqa_decode_stacked, flash_gqa_decode,
                                   gen_chunk_fused)}
    work = BUILD_ROOT / f"smoke_tools_{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    flags = ("QTTS_PROFILE_DIR", "QTTS_CHECKS", "QTTS_DEBUG_NANS")
    try:
        root, written = smoke_model_dir(dev)
        for name, (sec, size) in written.items():
            print(f"[tools] wrote {name}: {size / 1e9:.3f} GB in {sec:.2f} s")
        tools_native(root, failures)
        zero_counts(fns)
        tools_runbook(root, dev, failures)
        tools_parity(work, dev, failures)
        parity_counts = read_counts(fns)
        print(f"[tools] llama-parity launches {parity_counts}")
        if not (parity_counts["flash_gqa_prefill_stacked"] > 0
                and parity_counts["flash_gqa_decode_stacked"] > 0):
            failures.append("tools: llama-parity did not run the prefill and "
                            "decode attention kernels")

        t0 = time.perf_counter()
        eng = TtsEngine(root, quant="q8_0", device=dev,
                        speakers_dir="speakers")
        print(f"[tools] TtsEngine(quant='q8_0') from the smoke's directory: "
              f"{time.perf_counter() - t0:.2f} s (talker from "
              f"{eng.weight_sources.get('talker')}), chunk={eng.chunk}")
        gpath = work / "golden" / "real_engine_torch_seed42.json"
        for rep in range(2):
            detail = verify.golden_run(eng, gpath)
            print(f"[tools] golden-wav {rep + 1}: {detail}")
            if ("RECORDED" in detail) != (rep == 0):
                failures.append(f"tools: golden-wav run {rep + 1}: {detail}")

        voice = eng.get_speaker("vivian")

        def request():
            eng.set_max_steps(8)
            eng.set_sampler_config(SamplerConfig(seed=3, **GREEDY))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.generate_with_voice(TOOLS_TEXT, voice)
            torch.cuda.synchronize()
            return eng.last_codes.copy(), (time.perf_counter() - t0) * 1e3

        want, plain_ms = request()
        prof = work / "prof"
        os.environ["QTTS_PROFILE_DIR"] = str(prof)
        try:
            codes, traced_ms = request()
        finally:
            os.environ.pop("QTTS_PROFILE_DIR")
        traces = sorted(prof.glob("qtts_request-*.pt.trace.json"))
        kernels = set()
        for tr in traces:
            kernels |= {e.get("name", "") for e in json.loads(
                tr.read_text())["traceEvents"] if e.get("cat") == "kernel"}
        named = {k: any(k in n for n in kernels)
                 for k in ("chunk_kernel", "flash_prefill")}
        print(f"[tools] QTTS_PROFILE_DIR: {len(traces)} trace "
              f"({sum(t.stat().st_size for t in traces) / 1e6:.2f} MB, "
              f"{len(kernels)} kernel names), names {named}; codes equal to "
              f"the untraced run's={np.array_equal(codes, want)}; "
              f"{traced_ms:.1f} ms against {plain_ms:.1f} untraced")
        if len(traces) != 1 or not all(named.values()) \
                or not np.array_equal(codes, want):
            failures.append("tools: the QTTS_PROFILE_DIR trace is wrong")

        os.environ["QTTS_CHECKS"] = "1"
        tracing.apply_debug_flags()
        try:
            codes, checked_ms = request()
        finally:
            os.environ.pop("QTTS_CHECKS")
            tracing.apply_debug_flags()
        print(f"[tools] QTTS_CHECKS: codes equal={np.array_equal(codes, want)}"
              f", {checked_ms:.1f} ms")
        if not np.array_equal(codes, want):
            failures.append("tools: QTTS_CHECKS changed the codes")

        os.environ["QTTS_DEBUG_NANS"] = "1"
        tracing.apply_debug_flags()
        norm = eng.talker_params["final_norm"]
        kept = norm[0].clone()
        try:
            codes, nan_ms = request()
            norm[0] = float("nan")
            try:
                request()
                raised = "nothing"
            except FloatingPointError as e:
                raised = f"FloatingPointError: {e}"
        finally:
            norm[0] = kept
            os.environ.pop("QTTS_DEBUG_NANS")
            tracing.apply_debug_flags()
        print(f"[tools] QTTS_DEBUG_NANS: finite weights: codes equal="
              f"{np.array_equal(codes, want)}, {nan_ms:.1f} ms; a NaN in the "
              f"talker's final norm: {raised}")
        if not (np.array_equal(codes, want)
                and raised.startswith("FloatingPointError")):
            failures.append("tools: QTTS_DEBUG_NANS did not hold")

        ref = work / "ref.wav"
        AudioSample(samples=reference_wav(2, 7),
                    sample_rate=24000).save_wav(ref)
        vfile = work / "voice.json"
        eng.create_voice_file(ref, "A reference.").save(vfile)
        counts = read_counts(fns)
        del eng
        torch.cuda.empty_cache()
        tools_cli(root, work, vfile, failures)
    finally:
        for k in flags:
            os.environ.pop(k, None)
        tracing.apply_debug_flags()
        shutil.rmtree(work, ignore_errors=True)
        release_model_dir("tools")
    print(f"[tools] launches {counts}")
    for name in TOOLS_PATH_KERNELS["tools"]:
        if counts[name] <= 0:
            failures.append(f"tools never launched {name}")
    return {"tools": counts}


# ------------------------------------------------------------- parallel
PARALLEL_B = 4               # lanes of (a) and (b): one wave
PARALLEL_FRAMES = 8          # greedy frames after the prefill
# a preset-voice prompt; with its index, 33-34 rows: bucket 64
PARALLEL_BUCKET_TEXT = REQUESTS[0][1]
# A one-rank all-reduce adds nothing: (a) computes the unsharded forward,
# held within this share of max |logit| (in fact bit for bit).
PARALLEL_ONE_RANK_TOL = 1e-6
# (b) against (a): the same bf16 model with each projection's K split in
# two, the partial products summed in f32 and rounded once; through 28
# layers those roundings drift like another device's sums (REF_REL_TOL's
# class), relative to max |logit|.
PARALLEL_LOGIT_TOL = REF_REL_TOL
# where two runs' codes part, each side's pick may lead the other's pick
# by at most this share of max |logit| in its own logits (a near tie)
PARALLEL_TIE = 0.05
# (c): 6 requests of bucket 32 on 4 lanes; the budgets free lanes at
# different rounds, so freed lanes are refilled
PARALLEL_QUEUE_BUDGETS = (4, 8, 6, 4, 8, 6)
# (c) on the default engine: waves of 2 lanes, 1 a rank (the chunk kernel
# at B = 1), budgets that end the ranks' lanes at different chunks
PARALLEL_WAVE_BUDGETS = (8, 5, 6, 8)
PARALLEL_PATH_KERNELS = {
    "parallel-tp": ("flash_gqa_prefill_stacked", "flash_gqa_decode_stacked",
                    "flash_gqa_decode_append", "inject_prompt_lanes",
                    "matmul_int4"),
    "parallel-dp": ("flash_gqa_prefill_stacked", "flash_gqa_decode_append",
                    "inject_prompt_lanes"),
    "parallel-dp-default": ("talker_step_fused", "predict_frame_fused",
                            "gen_chunk_fused"),
}
PARALLEL_LABEL = "gloo through the host on one card, not NCCL"


def parallel_fns():
    from qwen3_tts_tpu_torch.kernels import flash_decode as fd
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked)
    from qwen3_tts_tpu_torch.kernels.int4_matmul import matmul_int4
    return {f.__name__: f for f in (
        flash_gqa_prefill_stacked, fd.flash_gqa_decode_stacked,
        fd.flash_gqa_decode_append, fd.inject_prompt_lanes, matmul_int4)}


def parallel_default_fns():
    """The decode kernels of the default engine's paths."""
    from qwen3_tts_tpu_torch.kernels.chunk_step import gen_chunk_fused
    from qwen3_tts_tpu_torch.kernels.predictor_frame import (
        predict_frame_fused)
    from qwen3_tts_tpu_torch.kernels.talker_step import talker_step_fused
    return {f.__name__: f for f in (talker_step_fused, predict_frame_fused,
                                    gen_chunk_fused)}


def parallel_prompts(eng, n, offset=0, bucket=None):
    """(embeds, lengths tensor, bucket) of n preset-voice prompts (bucket:
    the longest one's, unless given)."""
    import torch
    voice = eng.get_speaker("vivian")
    plans = [eng._build_voice_prompt(f"{PARALLEL_BUCKET_TEXT} {offset + i}",
                                     voice, None) for i in range(n)]
    bucket = bucket or eng._bucket(max(p.length for p in plans))
    embeds, lens = eng.prompt_to_device(plans, bucket)
    return embeds, torch.from_numpy(lens).to(eng.device), bucket


def _greedy_sampler():
    from qwen3_tts_tpu_torch.runtime.generate import SamplerParams
    return SamplerParams(**GREEDY)


def tp_run(eng, mesh, talker, predictor, embeds, lens, bucket, a8=True):
    """tp_talker_prefill, then tp_gen_bulk for PARALLEL_FRAMES greedy
    frames (the (a) / (b) path): (prefill logits, codes [B, F, 16], valid,
    final logits, ms a frame of the bulk call)."""
    import torch
    from qwen3_tts_tpu_torch.parallel import tp
    from qwen3_tts_tpu_torch.runtime.generate import cache_capacity
    cfg = eng.config
    b = embeds.shape[0]
    with torch.no_grad():
        lg, hd, k, v = tp.tp_talker_prefill(
            cfg, mesh, talker, embeds, lens, cache_capacity(cfg, bucket),
            a8=a8)
        lg0 = lg.clone()
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        t0 = time.perf_counter()
        codes, valid, _, carry, n = tp.tp_gen_bulk(
            cfg, mesh, talker, predictor, eng.generator.assets_pack, lg, hd,
            k, v, lens, lens, bucket, torch.zeros(b, dtype=torch.bool,
                                                  device=eng.device),
            torch.Generator(device=eng.device).manual_seed(0),
            _greedy_sampler(), PARALLEL_FRAMES, max_frames=PARALLEL_FRAMES,
            chunk=cfg.runtime.frames_per_chunk, prompt_cap=bucket)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        ms = (time.perf_counter() - t0) * 1e3 / max(1, n)
    return lg0, codes, valid, carry[0], ms


def _h1024(eng, hidden):
    """The predictor's input of a talker hidden (gen_frames' projection)."""
    pack = eng.generator.assets_pack
    return (hidden.float() @ pack["proj_w"].float().t()
            + pack["proj_b"].float())


def tp_frames_log(eng, mesh, talker, predictor, embeds, lens, bucket):
    """The same prefill and frames one at a time (tp_gen_frames, n = 1),
    keeping what picked each frame: ({"codes" [F, B, 16], "logits" [F, B,
    V] (code 0's), "h1024" [F, B, 1024] (the predictor's input)}, the
    model-axis all-reduces a frame)."""
    import torch
    from qwen3_tts_tpu_torch.parallel import tp
    from qwen3_tts_tpu_torch.runtime.generate import cache_capacity
    cfg = eng.config
    log = {"codes": [], "logits": [], "h1024": []}
    with torch.no_grad():
        lg, hd, k, v = tp.tp_talker_prefill(
            cfg, mesh, talker, embeds, lens, cache_capacity(cfg, bucket))
        g = torch.Generator(device=eng.device).manual_seed(0)
        n0 = mesh.all_reduces
        for f in range(PARALLEL_FRAMES):
            log["logits"].append(lg.float().cpu())
            log["h1024"].append(_h1024(eng, hd).cpu())
            c, _, (lg, hd, k, v) = tp.tp_gen_frames(
                cfg, mesh, talker, predictor, eng.generator.assets_pack, lg,
                hd, k, v, lens, lens + f, bucket + f, g, _greedy_sampler(), 1,
                bucket)
            log["codes"].append(c[:, 0].cpu())
    return ({k: torch.stack(v) for k, v in log.items()},
            (mesh.all_reduces - n0) / PARALLEL_FRAMES)


def tp_forced_log(eng, mesh, talker, embeds, lens, bucket, codes):
    """The prefill, then frame by frame the talker step fed back the
    frame's GIVEN codes [F, B, 16] (another run's: teacher forcing), each
    frame's code-0 logits and the predictor's 15 window logits on the
    given codes (predictor_windows on the engine's predictor weights, a
    rank's block on a mesh): {"logits" [F, B, V], "windows" [F, B, 15,
    2048]}, so that every frame's decode step is held, not only those
    before a first part."""
    import torch
    from qwen3_tts_tpu_torch.parallel import tp
    from qwen3_tts_tpu_torch.runtime.generate import (_frame_emb_sum,
                                                      cache_capacity)
    cfg = eng.config
    pack = eng.generator.assets_pack
    log = {"logits": [], "windows": []}
    with torch.no_grad():
        lg, hd, k, v = tp.tp_talker_prefill(
            cfg, mesh, talker, embeds, lens, cache_capacity(cfg, bucket))
        for f in range(codes.shape[0]):
            c = codes[f].to(eng.device)
            log["logits"].append(lg.float().cpu())
            log["windows"].append(predictor_windows(
                eng, None, c, h1024=_h1024(eng, hd)).cpu())
            fb = _frame_emb_sum(pack["codec_tables"], c) \
                + pack["tts_pad"].float()
            lg, hd, k, v = tp.tp_talker_step(cfg, mesh, talker, fb, lens + f,
                                             k, v, lens, bucket + f, bucket)
    return {k: torch.stack(v) for k, v in log.items()}


def refill_step_logits(eng, mesh, talker, embeds, lens, bucket):
    """The prefill, a refill of lanes 1 and 3 with two more prompts while
    lanes 0 and 2 sit 5 frames on (tp_prefill_lanes), then one step at the
    per-lane cursors (bucket + 5, bucket, bucket + 5, bucket): that step's
    logits (the continuous batcher's refill, on the row-parallel
    schedule)."""
    import torch
    from qwen3_tts_tpu_torch.parallel import tp
    from qwen3_tts_tpu_torch.runtime.generate import cache_capacity
    cfg = eng.config
    dev = eng.device
    with torch.no_grad():
        lg, hd, k, v = tp.tp_talker_prefill(
            cfg, mesh, talker, embeds, lens, cache_capacity(cfg, bucket))
        em2, ln2, _ = parallel_prompts(eng, 2, PARALLEL_B, bucket)
        lg, hd, k, v, ln, pos, widx, _ = tp.tp_prefill_lanes(
            cfg, mesh, talker, em2, ln2, [1, 3], lg, hd, k, v,
            lens, lens + 5, bucket + 5,
            torch.zeros(PARALLEL_B, dtype=torch.bool, device=dev))
        fb = torch.zeros(PARALLEL_B, 2048, device=dev)
        lg, _, _, _ = tp.tp_talker_step(cfg, mesh, talker, fb, pos, k, v, ln,
                                        widx, bucket)
    return lg.float().cpu()


def exact_frames_log(eng, gen, embeds, lens, bucket):
    """The unsharded exact path (Generator.start, then gen_frames one frame
    at a time) with what picked each frame, as tp_frames_log."""
    import torch
    from qwen3_tts_tpu_torch.runtime import generate as tg
    log = {"codes": [], "logits": [], "h1024": []}
    with torch.no_grad():
        st = gen.start(embeds, lens,
                       torch.Generator(device=eng.device).manual_seed(0))
        for _ in range(PARALLEL_FRAMES):
            log["logits"].append(st.logits.float().cpu())
            log["h1024"].append(_h1024(eng, st.hidden).cpu())
            st, c, _ = tg.gen_frames(eng.config, gen.talker_params,
                                     gen.predictor_params, gen.assets_pack,
                                     st, _greedy_sampler(), 1, bucket)
            log["codes"].append(c[:, 0].cpu())
    return {k: torch.stack(v) for k, v in log.items()}


def _rel_gap(got, want):
    """max |got - want| over max |want|, frame by frame: [F]."""
    n = got.shape[0]
    d = (got.float() - want.float()).abs().reshape(n, -1).amax(1)
    return d / want.float().abs().reshape(n, -1).amax(1)


def _mass_gap(logits, code, u, sampler):
    """How far (in probability mass) the uniform u lies from the draws
    that pick `code` in the distribution ops.sampling draws from on
    `logits` [V] (0 where u picks it; inf where it is filtered out)."""
    from qwen3_tts_tpu_torch.ops.sampling import filtered_distribution
    order, probs = filtered_distribution(logits[None].float(),
                                         sampler["temperature"],
                                         sampler["top_k"], sampler["top_p"])
    cdf = probs[0].cumsum(0)
    r = int((order[0] == code).nonzero()[0])
    if probs[0, r] <= 0:
        return float("inf")
    uu = float(u) * float(cdf[-1])
    lo = float(cdf[r - 1]) if r else 0.0
    return max(lo - uu, uu - float(cdf[r]), 0.0) / float(cdf[-1])


def parallel_part(eng, x, y, lane, sampler=None, signed=True):
    """The first part of two runs' frames of one lane (x, y: {"codes" [F,
    16], "logits" [F, V], "h1024" [F, 1024], with a sampler "u" [F]}):
    None where they agree, else (near tie, text).  A greedy code 0 is
    judged on each side's talker logits, a residual token on the predictor
    window logits that the exact predictor gives for each side's h1024 and
    codes (predictor_windows): each side's pick may lead the other's by at
    most PARALLEL_TIE of max |logit| in its own logits (signed=False: the
    two picks lie within PARALLEL_TIE of each other either way, where the
    picking predictor is not the exact one).  A sampled code 0 (sampler:
    its SAMPLED-style dict) parts where the uniform both runs drew (which
    must be the same) lies near an edge of the draw: once the draws are
    the same, the part is numerics when the two sides' code-0 logits of
    that frame (every code before it equal) agree within
    PARALLEL_LOGIT_TOL of max |logit|; how far in probability mass the
    uniform lies from the other side's pick is printed (_mass_gap)."""
    import torch
    cx, cy = x["codes"], y["codes"]
    parts = (cx != cy).nonzero()
    if len(parts) == 0:
        return None
    f, t = (int(v) for v in parts[0])
    a, b = int(cx[f, t]), int(cy[f, t])
    if t == 0 and sampler is not None and sampler["temperature"] > 0:
        u, uy = x["u"][f], y["u"][f]
        lx, ly = x["logits"][f], y["logits"][f]
        gx = _mass_gap(lx, b, u, sampler)
        gy = _mass_gap(ly, a, uy, sampler)
        gap = ((lx - ly).abs().max() / lx.abs().max()).item()
        tie = bool(torch.equal(u, uy)) and gap <= PARALLEL_LOGIT_TOL
        return tie, (f"lane {lane} frame {f} code 0 (sampled): one side draws "
                     f"{a}, the other {b}, on the uniforms {float(u):.6f} / "
                     f"{float(uy):.6f} ({gx:.3e} / {gy:.3e} of mass from the "
                     f"other side's draw); the frame's logits {gap:.3e} of "
                     f"max |logit| apart (tol {PARALLEL_LOGIT_TOL}): {tie}")
    if t == 0:
        lx, ly = x["logits"][f], y["logits"][f]
    else:
        lx, ly = (predictor_windows(
            eng, None, s["codes"][f:f + 1].to(eng.device),
            h1024=s["h1024"][f:f + 1].to(eng.device))[0, t - 1].cpu()
                  for s in (x, y))
    scale = max(lx.abs().max().item(), ly.abs().max().item())
    lead_x = (lx[a] - lx[b]).item() / scale
    lead_y = (ly[b] - ly[a]).item() / scale
    if signed:
        tie = 0 <= lead_x <= PARALLEL_TIE and 0 <= lead_y <= PARALLEL_TIE
    else:
        tie = max(abs(lead_x), abs(lead_y)) <= PARALLEL_TIE
    return tie, (f"lane {lane} frame {f} token {t}: one side picks {a}, "
                 f"{lead_x:.3e} above {b}; the other picks {b}, "
                 f"{lead_y:.3e} above {a} (of max |logit| {scale:.3f}; a "
                 f"near tie within {PARALLEL_TIE}"
                 f"{'' if signed else ' either way'}): {tie}")


def _spy(module, name, seen):
    """Wrap module.name (an attention kernel's wrapper where
    models/transformer calls it, or matmul_int4 where parallel/mesh calls
    it) so that each call records its (h, hkv) or K in `seen`, and
    flash_gqa_decode_append its cursors; the wrapper still counts its
    launches."""
    real = getattr(module, name)

    def spy(*a, **k):
        if name == "matmul_int4":
            seen.append(("K", 2 * a[1]["q4"].shape[-1]))
        else:                       # q [.., h, Dh], k_all [L, B, hkv, ..]
            seen.append(("h/hkv", a[0].shape[-2], a[1].shape[2]))
        if name == "flash_gqa_decode_append":
            seen.append(("cursors", tuple(a[6].tolist())))
        return real(*a, **k)
    setattr(module, name, spy)


def _parallel_tp_rank(dev, cfg, out_dir):
    """(b) on one rank of the 1 x 2 mesh: the engine's weights from the
    shared seed, int8 and int4 copies made, then sharded (the full copies
    dropped); the prefill and PARALLEL_FRAMES frames (tp_gen_bulk), the
    refill step (refill_step_logits), the same frames one at a time, then
    teacher-forced on (a)'s codes (out_dir/a_codes.pt); an int4 and an a8
    prefill against the unsharded ones; the prefill with the partial
    products summed in bf16, as the JAX psum does.  Returns numbers and
    tensors for the parent."""
    import torch
    from qwen3_tts_tpu_torch import TtsEngine
    from qwen3_tts_tpu_torch.models import talker as talker_lib
    from qwen3_tts_tpu_torch.models import transformer
    from qwen3_tts_tpu_torch.ops import quant as Q
    from qwen3_tts_tpu_torch.parallel import mesh as mesh_lib
    from qwen3_tts_tpu_torch.parallel import tp
    fns = parallel_fns()
    eng = TtsEngine(config=cfg, device=dev, speakers_dir="speakers",
                    fused=False)
    full = eng.talker_params
    with torch.no_grad():
        int8 = TtsEngine._int8_lm(full, "codec_head")
        int4 = dict(full, layers=Q.quantize_decoder_layers_int4(
            full["layers"]))
    mesh = mesh_lib.make_mesh(1, 2, device=dev)
    talker, predictor = tp.shard_engine(eng, mesh)
    embeds, lens, bucket = parallel_prompts(eng, PARALLEL_B)
    seen = []
    for name in fns:
        if name == "matmul_int4":
            _spy(mesh_lib, name, seen)
        elif name != "inject_prompt_lanes":
            _spy(transformer, name, seen)
    out = {"bucket": bucket}
    zero_counts(fns)
    lg0, codes, valid, lg_end, ms = tp_run(eng, mesh, talker, predictor,
                                           embeds, lens, bucket)
    out.update(prefill_logits=lg0.float().cpu(), codes=codes.cpu(),
               valid=valid.cpu(), final_logits=lg_end.float().cpu(),
               ms_frame=ms)
    out["refill_logits"] = refill_step_logits(eng, mesh, talker, embeds,
                                              lens, bucket)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["counts"] = read_counts(fns)
    # int4 and a8 prefills: matmul_int4 at K / 2, the a8 row scale whole
    for kind, whole, a8 in (("int4", int4, False), ("a8", int8, True)):
        local = mesh_lib.shard_params(whole, mesh,
                                      mesh_lib.talker_param_specs())
        n0 = fns["matmul_int4"].launches
        with torch.no_grad():
            got = tp.tp_talker_prefill(cfg, mesh, local, embeds, lens,
                                       bucket, a8=a8)[0]
            out[f"{kind}_tp_int4_launches"] = (fns["matmul_int4"].launches
                                               - n0)
            cache = talker_lib.init_talker_cache(cfg.talker, PARALLEL_B,
                                                 bucket, dev)
            n = len(seen)           # the unsharded reference's calls
            want = talker_lib.talker_prefill(cfg.talker, whole, embeds,
                                             lens, cache, a8=a8)[0]
            del seen[n:]
        out[kind] = ((got - want).abs().max().item(),
                     want.abs().max().item())
        del local
    # the path's matmul_int4 launches: the row-parallel int4 prefill's
    out["counts"]["matmul_int4"] = out["int4_tp_int4_launches"]
    out["seen"] = sorted(set(seen))
    del int8, int4, full
    # frames one at a time with what picked them, then on (a)'s codes
    out["log"], out["all_reduces_frame"] = tp_frames_log(
        eng, mesh, talker, predictor, embeds, lens, bucket)
    a_codes = torch.load(os.path.join(out_dir, "a_codes.pt"))
    out["forced"] = tp_forced_log(eng, mesh, talker, embeds, lens, bucket,
                                  a_codes)
    # the JAX psum's choice: the partial products summed in bf16
    real_reduce = mesh_lib._reduce
    mesh_lib._reduce = lambda m, part, dtype: m.reduce_model(
        part.to(dtype).contiguous())
    try:
        with torch.no_grad():
            lg_bf = tp.tp_talker_prefill(cfg, mesh, talker, embeds, lens,
                                         bucket)[0]
        out["bf16_reduce_prefill_gap"] = (
            lg_bf.float().cpu() - out["prefill_logits"]).abs().max().item()
    finally:
        mesh_lib._reduce = real_reduce
    return out


class _LoneRank:
    """Data rank `i` of a 2 x 1 mesh alone in one process, for a serving
    class's `mesh`: its lanes and the whole batch's draws as on the mesh,
    but its own early exit and only its own results (the one-process
    reference of a rank's lanes)."""
    n_data, n_model, size = 2, 1, 2

    def __init__(self, i):
        self.data_index = i

    def all_done(self, done):
        return bool(done.all())

    def gather_data(self, obj):
        return [obj]

    def shared_seed(self, seed):
        return int(seed)


def parallel_wave(eng, mesh):
    """BatchSynthesizer at batch 2 over PARALLEL_WAVE_BUDGETS sampled
    requests: [(frames, eos, codes)] of the requests it returns (on a
    _LoneRank, only that rank's)."""
    from qwen3_tts_tpu_torch import SamplerConfig
    from qwen3_tts_tpu_torch.serve.batch import (BatchRequest,
                                                 BatchSynthesizer)
    eng.set_sampler_config(SamplerConfig(seed=11, **SAMPLED))
    voice = eng.get_speaker("vivian")
    reqs = [BatchRequest(f"{SERVING_TEXTS[0]} wave {i}.", voice, max_frames=m)
            for i, m in enumerate(PARALLEL_WAVE_BUDGETS)]
    res = BatchSynthesizer(eng, batch_size=2, mesh=mesh).synthesize(reqs)
    return [(r.frames, r.eos, r.codes) for r in res]


def _parallel_dp_rank(dev, cfg, out_dir):
    """(c) on one rank of the 2 x 1 mesh: ContinuousBatcher on 4 lanes (2
    a rank) over the queue, greedy on an exact-path engine, then sampled
    on the default engine (its fused step and predictor kernels at 2
    lanes), with what picked each kept frame (parallel_queue_log); and
    sampled waves of 2 lanes on the default engine (the chunk kernel at
    one lane a rank, its uniforms the wave's)."""
    import torch
    from qwen3_tts_tpu_torch import TtsEngine
    from qwen3_tts_tpu_torch.parallel.mesh import make_mesh
    eng = TtsEngine(config=cfg, device=dev, speakers_dir="speakers",
                    fused=False)
    mesh = make_mesh(2, 1, device=dev)
    fns = parallel_fns()
    zero_counts(fns)
    out = parallel_queue_log(eng, mesh)
    out["counts"] = read_counts(fns)
    del eng
    torch.cuda.empty_cache()
    eng = TtsEngine(config=cfg, device=dev, speakers_dir="speakers")
    fns = parallel_default_fns()
    zero_counts(fns)
    out["sampled"] = parallel_queue_log(eng, mesh, SAMPLED)
    out["sampled_counts"] = read_counts(fns)
    zero_counts(fns)
    out["wave"] = parallel_wave(eng, mesh)
    out["wave_counts"] = read_counts(fns)
    return out


def parallel_queue_log(eng, mesh, sampling=GREEDY):
    """ContinuousBatcher at batch 4 over PARALLEL_QUEUE_BUDGETS requests
    (mesh None: one process), recording for every kept frame of every
    lane what picked it: {"results": [(frames, eos, codes)], "lanes":
    {global lane: {"codes" [N, 16], "logits" [N, V], "h1024" [N, 1024],
    "u" [N] (sampled: code 0's uniform)}}, "wall_s"}.  The records come
    from wrappers of the frame loop's sampler (which replays the
    generator's draw) and predictor (runtime/generate) and of
    LaneCodec.run_group, which keeps a group's frames where `valid`."""
    import torch
    from qwen3_tts_tpu_torch import SamplerConfig
    from qwen3_tts_tpu_torch.runtime import generate as tg
    from qwen3_tts_tpu_torch.serve import codec_path
    from qwen3_tts_tpu_torch.serve.batch import BatchRequest
    from qwen3_tts_tpu_torch.serve.continuous import ContinuousBatcher
    frames, lanes = [], {}
    real_sample, real_predict = tg.sample_logits, tg._predict_frame_dispatch
    real_group = codec_path.LaneCodec.run_group

    def sample(logits, generator, temperature, top_k, top_p, rows=None):
        rec = {"logits": logits.float().cpu()}
        if temperature > 0:         # the draw sample_logits makes
            replay = torch.Generator(device=generator.device)
            replay.set_state(generator.get_state())
            n = logits.shape[0]
            lo, total = rows or (0, n)
            rec["u"] = torch.rand((total, 1), generator=replay,
                                  device=logits.device)[lo:lo + n, 0].cpu()
        frames.append(rec)
        return real_sample(logits, generator, temperature, top_k, top_p,
                           rows=rows)

    def predict_h(cfg, params, h1024, code0, tables):
        frames[-1]["h1024"] = h1024.float().cpu()
        codes = real_predict(cfg, params, h1024, code0, tables)
        frames[-1]["codes"] = codes.cpu()
        return codes

    def group(self, state, *a, **k):
        frames.clear()
        out = real_group(self, state, *a, **k)
        valid = out[2]
        lo = 0 if state.lanes is None else state.lanes.lo
        for i in range(valid.shape[0]):
            rec = lanes.setdefault(lo + i, {"codes": [], "logits": [],
                                            "h1024": [], "u": []})
            for f, fr in enumerate(frames):
                if valid[i, f]:
                    for key in rec:
                        if key in fr:
                            rec[key].append(fr[key][i])
        return out

    tg.sample_logits, tg._predict_frame_dispatch = sample, predict_h
    codec_path.LaneCodec.run_group = group
    try:
        eng.set_sampler_config(SamplerConfig(seed=7, **sampling))
        voice = eng.get_speaker("vivian")
        reqs = [BatchRequest(f"{SERVING_TEXTS[0]} queue {i}.", voice,
                             max_frames=m)
                for i, m in enumerate(PARALLEL_QUEUE_BUDGETS)]
        batcher = ContinuousBatcher(eng, batch_size=PARALLEL_B, mesh=mesh,
                                    max_frames_per_stream=max(
                                        PARALLEL_QUEUE_BUDGETS))
        t0 = time.perf_counter()
        results = batcher.run(reqs)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        wall = time.perf_counter() - t0
    finally:
        tg.sample_logits, tg._predict_frame_dispatch = (real_sample,
                                                        real_predict)
        codec_path.LaneCodec.run_group = real_group
    return {"results": [(r.frames, r.eos, r.codes) for r in results],
            "lanes": {lane: {k: torch.stack(v) if v else None
                             for k, v in rec.items()}
                      for lane, rec in lanes.items()},
            "wall_s": wall}


def _parallel_rank(rank, world, store, out_dir, layout, cfg):
    """A spawned rank of (b) or (c): on cuda:0 (both ranks share the one
    card), joined by gloo through a file:// store; it loads the library the
    parent built and never builds.  Its results go to out_dir."""
    import pickle
    import torch
    import torch.distributed as dist
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    # the two ranks share the host's cores, and a rank's CPU work is its
    # launches and gloo's copies: spinning intra-op threads only slow them
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    if dev.type == "cuda":
        from qwen3_tts_tpu_torch.core.device import set_cuda_precision
        torch.cuda.set_device(dev)
        set_cuda_precision()
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        work = _parallel_tp_rank if layout == "1x2" else _parallel_dp_rank
        out = work(dev, cfg, out_dir)
        with open(os.path.join(out_dir, f"{layout}_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_parallel_ranks(layout, out_dir, cfg, timeout=600):
    """Two spawned ranks of `layout`; a rank's exception, a non-zero exit
    or the timeout raises (and the ranks still alive are stopped).
    Returns each rank's results."""
    import pickle
    import torch.multiprocessing as tmp
    store = os.path.join(out_dir, f"store_{layout}")
    ctx = tmp.start_processes(_parallel_rank, args=(2, store, out_dir, layout,
                                                    cfg),
                              nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"parallel {layout}: ranks still running "
                                   f"after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    out = []
    for r in range(2):
        with open(os.path.join(out_dir, f"{layout}_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def parallel_append_cursors(bucket):
    """The per-lane cursors at which the kernels' rows hold
    flash_gqa_decode_append at the rank-local heads: the TP path's refill
    step (refill_step_logits), a wave's first and last steps in one call,
    and cursors whose prefixes span 3-16 of the kernel's 64-slot
    splits."""
    return ((bucket + 5, bucket, bucket + 5, bucket),
            (bucket, bucket + 1, bucket + PARALLEL_FRAMES - 2,
             bucket + PARALLEL_FRAMES - 1),
            (128, 159, 600, 1023))


def parallel_kernel_rows(dev, cfg, failures, bucket):
    """The attention kernels and matmul_int4 at the rank-local shapes of
    the 1 x 2 mesh (h = H / 2, hkv = Hkv / 2; K / 2), each against its
    plain version, its device time in a CUDA graph beside SDPA (the
    attention) or torch.matmul on the dequantized shard, and its bound.
    The decode kernels are held at the TP path's cursors (bucket: its
    prompt bucket) and at multi-split ones, flash_gqa_decode_append also
    bit for bit against its plain version in the kernel's sum orders, and
    at the predictor's shapes (Dh 64, C 17)."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from qwen3_tts_tpu_torch.kernels import flash_decode as fd
    from qwen3_tts_tpu_torch.kernels.flash_prefill import (
        flash_gqa_prefill_stacked, prefill_attention_plain)
    from qwen3_tts_tpu_torch.kernels.int4_matmul import (
        _dequant_bf16, matmul_int4, matmul_int4_plain)
    from qwen3_tts_tpu_torch.ops.attention import history_mask
    from qwen3_tts_tpu_torch.ops.quant import quantize_weight_int4
    t, p = cfg.talker, cfg.predictor
    h, hkv, dh, n_layers = (t.n_heads // 2, t.n_kv_heads // 2, t.head_dim,
                            t.n_layers)
    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.5).to(
            torch.bfloat16)

    def i32(*vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    def within(got, want):
        d = (got.float() - want.float()).abs()
        return (d.max().item(), bool((d <= DECODE_ATOL + DECODE_RTOL
                                      * want.float().abs()).all()))

    rows = {}
    cap, s = 1024, 128
    kv = (rnd(n_layers, PARALLEL_B, hkv, cap, dh),
          rnd(n_layers, PARALLEL_B, hkv, cap, dh))
    one = tuple(x[:, :1].contiguous() for x in kv)
    # the prefill at bucket 128, one lane, one layer of the 28
    q = rnd(1, s, h, dh)
    lens, st = i32(117), i32(0)
    err = (flash_gqa_prefill_stacked(q, *one, lens, st, 5, s, s).float()
           - prefill_attention_plain(q, *one, lens, st, 5, s, s).float()
           ).abs().max().item()
    mask = history_mask(lens, s, st, s, s)
    qt = q.transpose(1, 2)
    kern = graph_ms(lambda i: flash_gqa_prefill_stacked(
        q, *one, lens, st, i % n_layers, s, s))
    lib = graph_ms(lambda i: sdpa(qt, one[0][i % n_layers, :, :, :s],
                                  one[1][i % n_layers, :, :, :s],
                                  attn_mask=mask[:, None], enable_gqa=True))
    b_ms, b_by = bound(nbytes((q, one[0][0, :, :, :s], one[1][0, :, :, :s]))
                       + q.numel() * 2, 4 * int(mask.sum()) * h * dh, "bf16")
    rows["flash_gqa_prefill_stacked"] = dict(
        shape=f"B=1 S={s} window={s} h={h} hkv={hkv} Dh={dh}",
        max_abs_err=err, graph_ms=kern, library_graph_ms=lib, bound_ms=b_ms,
        bound_by=b_by)
    if err > PREFILL_TOL:
        failures.append("flash_gqa_prefill_stacked at rank-local heads "
                        "disagrees with plain")
    # decode at one cursor: a wave's first and last steps, and prefixes of
    # 10 and 16 splits (each combined by the combine kernel)
    layer = 5
    lens4 = i32(34, 33, 30, 25)
    qd = rnd(PARALLEL_B, h, dh)
    ok = True
    for c in (bucket, bucket + PARALLEL_FRAMES - 1, 600, cap - 1):
        wi = i32(*[c] * PARALLEL_B)
        got = fd.flash_gqa_decode_stacked(qd, *kv, lens4, wi, layer, bucket)
        want = fd.decode_attention_plain(qd.float(), *kv, lens4, wi, layer,
                                         bucket)
        e, good = within(got, want)
        ok = ok and good
        print(f"[parallel] flash_gqa_decode_stacked rank-local h={h} hkv="
              f"{hkv} C={cap} cursor {c} prompt_cap={bucket}: max_abs_err="
              f"{e:.3e} within {DECODE_ATOL} + 2^-8*|plain f32|={good}")
    if not ok:
        failures.append("flash_gqa_decode_stacked at rank-local heads "
                        "disagrees with plain")
    # per-lane cursors: a poisoned stale row (1e3 in k, NaN in v) at each
    # lane's write slot, the output bit-equal to the kernel-order plain
    # version and within the decode bound of the torch-order one, the
    # caches equal to the plain write
    kn, vn = rnd(PARALLEL_B, hkv, dh), rnd(PARALLEL_B, hkv, dh)
    ok = True
    for cursors in parallel_append_cursors(bucket):
        wi = i32(*cursors)
        k, v = kv[0].clone(), kv[1].clone()
        for i, c in enumerate(cursors):
            k[layer, i, :, c] = 1e3
            v[layer, i, :, c] = float("nan")
        kk, vk, ko, vo, kp, vp = (x.clone() for x in (k, v) * 3)
        got = fd.flash_gqa_decode_append(qd, kk, vk, kn, vn, lens4, wi,
                                         layer, bucket)
        torch.cuda.synchronize()
        kord = fd.decode_append_kernel_order(qd, ko, vo, kn, vn, lens4, wi,
                                             layer, bucket)
        want = fd.decode_append_plain(qd.float(), kp, vp, kn, vn, lens4, wi,
                                      layer, bucket)
        e, good = within(got, want)
        bit = torch.equal(got, kord)
        caches = (torch.equal(kk, kp) and torch.equal(vk, vp)
                  and torch.equal(kk, ko) and torch.equal(vk, vo))
        ok = ok and good and bit and caches
        print(f"[parallel] flash_gqa_decode_append rank-local h={h} hkv="
              f"{hkv} C={cap} cursors {cursors} prompt_cap={bucket} "
              f"(poisoned self slots): equal to the plain version in the "
              f"kernel's orders={bit} (max abs diff "
              f"{(got.float() - kord.float()).abs().max().item():.3e}); "
              f"against the torch-order plain max_abs_err={e:.3e} "
              f"within={good}; caches equal to the plain write={caches}")
        del k, v, kk, vk, ko, vo, kp, vp
    if not ok:
        failures.append("flash_gqa_decode_append at rank-local heads "
                        "disagrees with plain")
    # the predictor's attention at rank-local heads: its S = 2 prefill and
    # its steps at cursors 2 and 16 of a 17-slot cache
    pc_ = 2 + p.n_residual_codebooks
    ph, phkv, pdh = p.n_heads // 2, p.n_kv_heads // 2, p.head_dim
    pk = (rnd(p.n_layers, PARALLEL_B, phkv, pc_, pdh),
          rnd(p.n_layers, PARALLEL_B, phkv, pc_, pdh))
    z = i32(*[0] * PARALLEL_B)
    q2 = rnd(PARALLEL_B, 2, ph, pdh)
    e = (flash_gqa_prefill_stacked(q2, *pk, z, z, 1, 0, 2).float()
         - prefill_attention_plain(q2, *pk, z, z, 1, 0, 2).float()
         ).abs().max().item()
    ok = e <= PREFILL_TOL
    errs = [e]
    for c in (2, pc_ - 1):
        q1 = rnd(PARALLEL_B, ph, pdh)
        wi = i32(*[c] * PARALLEL_B)
        e, good = within(fd.flash_gqa_decode_stacked(q1, *pk, z, wi, 1, 0),
                         fd.decode_attention_plain(q1.float(), *pk, z, wi, 1,
                                                   0))
        ok, errs = ok and good, errs + [e]
    print(f"[parallel] predictor attention rank-local h={ph} hkv={phkv} Dh="
          f"{pdh} C={pc_}: prefill S=2 max_abs_err {errs[0]:.3e}, steps at "
          f"cursors 2 / {pc_ - 1} {errs[1]:.3e} / {errs[2]:.3e}: {ok}")
    if not ok:
        failures.append("the predictor's attention at rank-local heads "
                        "disagrees with plain")
    del pk
    # device times at the TP path's shapes: a wave's first step, the
    # refill step
    for name, wi in (("flash_gqa_decode_stacked", i32(*[bucket] * PARALLEL_B)),
                     ("flash_gqa_decode_append",
                      i32(*parallel_append_cursors(bucket)[0]))):
        if name == "flash_gqa_decode_stacked":
            def kfn(i):
                return fd.flash_gqa_decode_stacked(qd, *kv, lens4, wi,
                                                   i % n_layers, bucket)
            got = kfn(layer)
            want = fd.decode_attention_plain(qd.float(), *kv, lens4, wi,
                                             layer, bucket)
        else:
            def kfn(i):
                return fd.flash_gqa_decode_append(qd, *kv, kn, vn, lens4, wi,
                                                  i % n_layers, bucket)
            kc, vc = (x.clone() for x in kv)
            want = fd.decode_append_plain(qd.float(), kc, vc, kn, vn, lens4,
                                          wi, layer, bucket)
            got = kfn(layer)
            del kc, vc
        mask = history_mask(lens4, bucket, wi, 1, cap)
        qs = qd[:, :, None]
        kern = graph_ms(kfn)
        lib = graph_ms(lambda i: sdpa(qs, kv[0][i % n_layers],
                                      kv[1][i % n_layers],
                                      attn_mask=mask[:, None],
                                      enable_gqa=True))
        live = int((wi.long() + 1).sum())
        b_ms, b_by = bound(2 * live * hkv * dh * 2 + 2 * qd.numel() * 2,
                           4 * live * h * dh, "bf16")
        rows[name] = dict(
            shape=f"B={PARALLEL_B} C={cap} cursors {wi.tolist()} h={h} "
                  f"hkv={hkv} Dh={dh}", max_abs_err=within(got, want)[0],
            graph_ms=kern, library_graph_ms=lib, bound_ms=b_ms, bound_by=b_by)
    del kv, one
    # matmul_int4 on the rank's K block of each talker weight, at the
    # decode (M = B) and the bucket-32 prefill (M = B * 32) rows
    d, f_, hq = t.d_model, t.d_ff, t.n_heads * dh
    qkv_n = (t.n_heads + 2 * t.n_kv_heads) * dh
    shapes = ((d // 2, qkv_n), (hq // 2, d), (d // 2, 2 * f_), (f_ // 2, d))
    rows["matmul_int4"] = {}
    for k, n in shapes:
        w = quantize_weight_int4(torch.randn(k, n, generator=g, device=dev)
                                 * k ** -0.5)
        wb = nbytes(w.values())
        copies = [w] + [{key: x.clone() for key, x in w.items()}
                        for _ in range(max(0, math.ceil(64e6 / wb) - 1))]
        dense = [_dequant_bf16(c) for c in copies[:max(2, math.ceil(
            64e6 / (k * n * 2)))]]
        for m in (PARALLEL_B, PARALLEL_B * 32):
            x = (torch.randn(m, k, generator=g, device=dev) * 0.5).to(
                torch.bfloat16)
            got, want = matmul_int4(x, w), matmul_int4_plain(x, w)
            err = ((got - want).abs().max() / want.abs().max()).item()
            if err > INT4_TOL:
                failures.append(f"matmul_int4 at K={k} N={n} M={m} "
                                "disagrees with plain")
            kern = graph_ms(lambda i: matmul_int4(x, copies[i % len(copies)]))
            lib = graph_ms(lambda i: torch.matmul(x, dense[i % len(dense)]))
            b_ms, b_by = bound(wb + x.numel() * 2 + m * n * 4, 2 * m * k * n,
                               "bf16")
            rows["matmul_int4"][f"K={k} N={n} M={m}"] = dict(
                rel_err=err, graph_ms=kern, library_graph_ms=lib,
                bound_ms=b_ms, bound_by=b_by)
        del copies, dense
    for name, row in rows.items():
        for shape, r in (row.items() if name == "matmul_int4"
                         else ((row.pop("shape"), row),)):
            print(f"[parallel] {name} rank-local {shape}: err="
                  f"{r.get('max_abs_err', r.get('rel_err')):.3e}; device "
                  f"time (CUDA graph) kernel {r['graph_ms']:.4f} ms, "
                  f"{'torch matmul' if name == 'matmul_int4' else 'sdpa'} "
                  f"{r['library_graph_ms']:.4f} ms "
                  f"({r['graph_ms'] / r['library_graph_ms']:.2f}x), bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
            if name != "matmul_int4":
                r["shape"] = shape
    return rows


def _same_queue(eng, name, ref, got, failures, sampler=None, signed=True):
    """(c): each request's frames, EOS flag and codes against the
    one-process batcher's; a part must be a near tie (parallel_part on the
    frame's records, found in the lane that ran the request)."""
    import torch

    def frames_of(side, codes):
        """The records of a request: the run of its codes in a lane."""
        n = codes.shape[0]
        for rec in side["lanes"].values():
            c = rec["codes"]
            if c is None:
                continue
            for j in range(c.shape[0] - n + 1):
                if torch.equal(c[j:j + n], codes):
                    return {k: v[j:j + n] for k, v in rec.items()
                            if v is not None}
        return None

    n_parts = 0
    for i, ((fa, ea, ca), (fb, eb, cb)) in enumerate(zip(ref["results"],
                                                         got["results"])):
        ca, cb = torch.as_tensor(ca), torch.as_tensor(cb)
        if (fa, ea) == (fb, eb) and torch.equal(ca, cb):
            continue
        n_parts += 1
        x, y = frames_of(ref, ca), frames_of(got, cb)
        n = min(len(ca), len(cb))
        if x is not None and y is not None:
            x, y = ({k: v[:n] for k, v in s.items()} for s in (x, y))
        part = (parallel_part(eng, x, y, i, sampler, signed)
                if x is not None and y is not None else None)
        print(f"[parallel] {name} request {i}: frames {fa} / {fb}, eos "
              f"{ea} / {eb}; {part[1] if part else 'no record of the part'}")
        if not (part and part[0]):
            failures.append(f"parallel {name}: request {i} parts from the "
                            "one-process batcher not at a near tie")
    return n_parts


def drive_parallel(dev, failures, cfg=None):
    """Tensor and data parallelism (parallel/) at full EngineConfig()
    width and depth.  (a) one process, a one-rank NCCL group, mesh 1 x 1:
    tp_talker_prefill and tp_gen_bulk (8 greedy frames, 4 lanes, bucket
    64) on the engine's bf16 and int8 weights against the same engine's
    exact path.  (b) two processes on cuda:0 joined by gloo, mesh 1 x 2:
    the same run, ranks equal bit for bit, against (a) up to near ties;
    teacher-forced on (a)'s codes, every frame's code-0 and predictor
    window logits within PARALLEL_LOGIT_TOL of (a)'s; the refill step's
    logits against the unsharded refill; the attention kernels launched
    at the rank-local heads (flash_gqa_decode_append at the cursors the
    kernel rows held), matmul_int4 at the rank-local K; int4 and a8
    prefills against the unsharded ones.  (c) two processes, mesh 2 x 1:
    ContinuousBatcher on 4 lanes (2 a rank) over 6 requests with refills,
    greedy on the exact path and sampled on the default engine, against
    the one-process batcher on 4 lanes up to near ties; sampled waves of 2
    lanes on the default engine (the chunk kernel at one lane a rank)
    against each rank's lanes alone in one process (_LoneRank), exactly.
    Returns {"counts": {path: launches}, "rows": rank-local kernel
    timings}."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from qwen3_tts_tpu_torch import EngineConfig, TtsEngine
    from qwen3_tts_tpu_torch.parallel.mesh import Mesh, make_mesh
    from qwen3_tts_tpu_torch.runtime.generate import Generator
    cfg = cfg or EngineConfig()
    tmp = tempfile.mkdtemp(prefix="qtts_parallel_")
    out = {"counts": {}, "rows": {}}
    try:
        eng = TtsEngine(config=cfg, device=dev, speakers_dir="speakers",
                        fused=False)
        embeds, lens, bucket = parallel_prompts(eng, PARALLEL_B)
        # (a) one rank
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{tmp}/store_a",
                                world_size=1, rank=0)
        a_ms = {}
        try:
            mesh = make_mesh(1, 1, device=dev)
            for kind in ("bf16", "int8"):
                talker, pred = eng.talker_params, eng.predictor_params
                if kind == "int8":
                    talker = TtsEngine._int8_lm(talker, "codec_head")
                    pred = TtsEngine._int8_lm(pred, "lm_head")
                gen = Generator(cfg, talker, pred, eng.generator.assets_pack)
                with torch.no_grad():
                    st = gen.start(embeds, lens, torch.Generator(
                        device=dev).manual_seed(0))
                    want0 = st.logits.float().clone()
                    t0 = time.perf_counter()
                    st, want_codes, want_valid, _, _ = gen.run_bulk_codes(
                        st, _greedy_sampler(), bucket, PARALLEL_FRAMES)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    exact_ms = (time.perf_counter() - t0) * 1e3 \
                        / PARALLEL_FRAMES
                mesh.all_reduces = 0
                got0, codes, valid, got_end, ms = tp_run(
                    eng, mesh, talker, pred, embeds, lens, bucket)
                n_ar = mesh.all_reduces
                scale = want0.abs().max().item()
                err = max((got0.float() - want0).abs().max().item(),
                          (got_end.float() - st.logits.float()).abs().max()
                          .item()) / scale
                same = (torch.equal(valid, want_valid)
                        and torch.equal(codes[valid], want_codes[want_valid]))
                a_ms[kind] = ms
                print(f"[parallel] (a) {kind}, one-rank NCCL mesh 1x1, B="
                      f"{PARALLEL_B} bucket {bucket}, {PARALLEL_FRAMES} "
                      f"greedy frames: codes equal to the exact path "
                      f"{same}, logits max |diff| / max |logit| {err:.3e} "
                      f"(tol {PARALLEL_ONE_RANK_TOL}); {ms:.2f} ms a frame "
                      f"(tp_gen_bulk; the exact path {exact_ms:.2f}); "
                      f"{n_ar} all-reduces on the one-rank group")
                if not (same and err <= PARALLEL_ONE_RANK_TOL):
                    failures.append(f"parallel (a) {kind}: the one-rank "
                                    "mesh is not the exact path")
                del gen, st, talker, pred
        finally:
            dist.destroy_process_group()
        a_log = exact_frames_log(eng, eng.generator, embeds, lens, bucket)
        torch.save(a_log["codes"], os.path.join(tmp, "a_codes.pt"))
        with torch.no_grad():
            a_windows = torch.stack([predictor_windows(
                eng, None, a_log["codes"][f].to(dev),
                h1024=a_log["h1024"][f].to(dev)).cpu()
                for f in range(PARALLEL_FRAMES)])
        # the unsharded refill (a mesh of one process: no collective)
        a_refill = refill_step_logits(eng, Mesh(1, 1, 0, 0, dev),
                                      eng.talker_params, embeds, lens,
                                      bucket)
        if dev.type == "cuda":
            out["rows"] = parallel_kernel_rows(dev, cfg, failures, bucket)
            torch.cuda.empty_cache()

        # (b) two ranks, mesh 1 x 2
        t0 = time.perf_counter()
        b = run_parallel_ranks("1x2", tmp, cfg)
        print(f"[parallel] (b) two ranks on one card, mesh 1x2: "
              f"{time.perf_counter() - t0:.1f} s with their start")
        r0 = b[0]
        held = set(parallel_append_cursors(bucket))
        for r, got in enumerate(b):
            same = all(torch.equal(got[k], r0[k]) for k in (
                "codes", "valid", "prefill_logits", "final_logits",
                "refill_logits")) and all(
                torch.equal(got["forced"][k], r0["forced"][k])
                for k in r0["forced"])
            h = cfg.talker.n_heads // 2, cfg.talker.n_kv_heads // 2
            heads = {x[1:] for x in got["seen"] if x[0] == "h/hkv"}
            cursors = {x[1] for x in got["seen"] if x[0] == "cursors"}
            ks = {x[1] for x in got["seen"] if x[0] == "K"}
            want_k = {cfg.talker.d_model // 2, cfg.talker.d_ff // 2}
            c = got["counts"]
            launched = all(c[k] > 0 for k in (
                "flash_gqa_prefill_stacked", "flash_gqa_decode_stacked",
                "flash_gqa_decode_append", "inject_prompt_lanes"))
            n_int4 = got["int4_tp_int4_launches"]
            int4_ok = n_int4 > 0 and want_k <= ks
            print(f"[parallel] (b) rank {r}: codes and logits equal to rank "
                  f"0 {same}; attention launches {c} at (h, hkv) {heads} "
                  f"(talker and predictor), flash_gqa_decode_append at "
                  f"cursors {sorted(cursors)} (held by the kernel rows: "
                  f"{cursors <= held}); the int4 prefill's {n_int4} "
                  f"matmul_int4 launches at K "
                  f"{sorted(ks)}; int4 prefill |diff| "
                  f"{got['int4'][0]:.3e} of max |logit| {got['int4'][1]:.3f};"
                  f" a8 prefill |diff| {got['a8'][0]:.3e} of "
                  f"{got['a8'][1]:.3f}")
            if not (same and launched and heads == {h} and int4_ok
                    and cursors and cursors <= held):
                failures.append(f"parallel (b) rank {r}: ranks disagree or "
                                "a kernel did not launch at rank-local "
                                "shapes the rows held")
            for kind in ("int4", "a8"):
                if not got[kind][0] <= PARALLEL_LOGIT_TOL * got[kind][1]:
                    failures.append(f"parallel (b) {kind} prefill off the "
                                    "unsharded one")
        scale = a_log["logits"][0].abs().max().item()
        err = (r0["prefill_logits"] - a_log["logits"][0]).abs().max().item()
        log_same = torch.equal(r0["log"]["codes"].transpose(0, 1),
                               r0["codes"][:, :PARALLEL_FRAMES])
        parts = [parallel_part(eng, {k: v[:, i] for k, v in a_log.items()},
                               {k: v[:, i] for k, v in r0["log"].items()}, i)
                 for i in range(PARALLEL_B)]
        for p in parts:
            if p is not None:
                print(f"[parallel] (b) against (a): {p[1]}")
        # teacher-forced: every frame's decode step against (a)'s
        g_logits = _rel_gap(r0["forced"]["logits"], a_log["logits"])
        g_windows = _rel_gap(r0["forced"]["windows"], a_windows)
        refill_err = ((r0["refill_logits"] - a_refill).abs().max()
                      / a_refill.abs().max()).item()
        print(f"[parallel] (b) prefill logits against (a): max |diff| "
              f"{err:.3e} of max |logit| {scale:.3f} (tol "
              f"{PARALLEL_LOGIT_TOL}); frames one at a time equal to "
              f"tp_gen_bulk's {log_same}; lanes equal to (a) "
              f"{sum(p is None for p in parts)} of {PARALLEL_B}")
        print(f"[parallel] (b) fed (a)'s codes, frame by frame, max |diff| / "
              f"max |logit| (tol {PARALLEL_LOGIT_TOL}): code-0 logits "
              f"{[round(x, 5) for x in g_logits.tolist()]}, predictor "
              f"windows {[round(x, 5) for x in g_windows.tolist()]}; the "
              f"refill step at per-lane cursors against the unsharded "
              f"refill {refill_err:.3e}")
        ms = [got["ms_frame"] for got in b]
        print(f"[parallel] ms a frame, B={PARALLEL_B}, 28-layer talker: (a) "
              f"bf16 {a_ms['bf16']:.2f}, int8 {a_ms['int8']:.2f} (one rank); "
              f"(b) ranks {ms[0]:.2f} / {ms[1]:.2f} ({PARALLEL_LABEL}); "
              f"{r0['all_reduces_frame']:.0f} all-reduces a frame; the "
              f"prefill summed in bf16 instead of f32: logits max |diff| "
              f"{r0['bf16_reduce_prefill_gap']}")
        if not (err <= PARALLEL_LOGIT_TOL * scale and log_same
                and all(p is None or p[0] for p in parts)):
            failures.append("parallel (b) parts from (a) beyond a near tie")
        if not (g_logits.max() <= PARALLEL_LOGIT_TOL
                and g_windows.max() <= PARALLEL_LOGIT_TOL
                and refill_err <= PARALLEL_LOGIT_TOL):
            failures.append("parallel (b) teacher-forced steps or the refill "
                            "step off (a)")
        out["counts"]["parallel-tp"] = r0["counts"]
        out["tp"] = dict(ms_frame=ms, a_ms=a_ms,
                         all_reduces_frame=r0["all_reduces_frame"],
                         bf16_reduce=r0["bf16_reduce_prefill_gap"],
                         prefill_err=err, forced_logits=g_logits.max().item(),
                         forced_windows=g_windows.max().item(),
                         refill_err=refill_err)
        del b, r0

        # (c) two ranks, mesh 2 x 1: continuous batching and waves; the
        # one-process references first
        ref = parallel_queue_log(eng, None)
        default = TtsEngine(config=cfg, device=dev, speakers_dir="speakers")
        ref_s = parallel_queue_log(default, None, SAMPLED)
        lone = [parallel_wave(default, _LoneRank(i)) for i in range(2)]
        ref_wave = [lone[i % 2][i // 2]
                    for i in range(len(PARALLEL_WAVE_BUDGETS))]
        del default
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        c = run_parallel_ranks("2x1", tmp, cfg)
        print(f"[parallel] (c) two ranks, mesh 2x1: {time.perf_counter() - t0:.1f}"
              f" s with their start; greedy queue wall one process "
              f"{ref['wall_s']:.2f} s, ranks {c[0]['wall_s']:.2f} / "
              f"{c[1]['wall_s']:.2f} s; sampled on the default engine "
              f"{ref_s['wall_s']:.2f} s, ranks {c[0]['sampled']['wall_s']:.2f}"
              f" / {c[1]['sampled']['wall_s']:.2f} s ({PARALLEL_LABEL})")

        def same_results(x, y):
            return all(a[:2] == b_[:2] and torch.equal(
                torch.as_tensor(a[2]), torch.as_tensor(b_[2]))
                for a, b_ in zip(x, y)) and len(x) == len(y)

        for r, got in enumerate(c):
            same = (same_results(got["results"], c[0]["results"])
                    and same_results(got["sampled"]["results"],
                                     c[0]["sampled"]["results"])
                    and same_results(got["wave"], c[0]["wave"]))
            launched = (all(got["counts"][k] > 0 for k in
                            PARALLEL_PATH_KERNELS["parallel-dp"])
                        and got["sampled_counts"]["talker_step_fused"] > 0
                        and got["sampled_counts"]["predict_frame_fused"] > 0
                        and got["wave_counts"]["gen_chunk_fused"] > 0)
            wave_same = same_results(got["wave"], ref_wave)
            print(f"[parallel] (c) rank {r}: results equal to rank 0's "
                  f"{same}; exact-path launches {got['counts']}; default "
                  f"engine: sampled queue {got['sampled_counts']}, sampled "
                  f"waves of 2 lanes {got['wave_counts']}, the waves equal "
                  f"to each rank's lanes alone in one process {wave_same}")
            if not (same and launched and wave_same
                    and len(got["results"]) == len(PARALLEL_QUEUE_BUDGETS)):
                failures.append(f"parallel (c) rank {r}: results or launches")
        merged = dict(c[0], lanes={**c[0]["lanes"], **c[1]["lanes"]})
        _same_queue(eng, "(c) greedy", ref, merged, failures)
        merged = dict(c[0]["sampled"], lanes={**c[0]["sampled"]["lanes"],
                                              **c[1]["sampled"]["lanes"]})
        n = _same_queue(eng, "(c) sampled, default engine", ref_s, merged,
                        failures, SAMPLED, signed=False)
        print(f"[parallel] (c) sampled, default engine: "
              f"{len(PARALLEL_QUEUE_BUDGETS) - n} of "
              f"{len(PARALLEL_QUEUE_BUDGETS)} requests equal to the "
              f"one-process batcher's")
        out["counts"]["parallel-dp"] = c[0]["counts"]
        out["counts"]["parallel-dp-default"] = {
            **c[0]["sampled_counts"],
            "gen_chunk_fused": c[0]["wave_counts"]["gen_chunk_fused"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="kernels,chunk,reference,engine,stream,clone,"
                    "onnx,serving,online,spec,wave,weights,tools,parallel",
                    help="comma-separated subset (all by default)")
    phases_wanted = ap.parse_args().phases.split(",")
    MODEL_DIR["users"] = {"weights", "tools"} & set(phases_wanted)
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device; the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from qwen3_tts_tpu_torch.core.device import set_cuda_precision
    from qwen3_tts_tpu_torch.kernels import build

    set_cuda_precision()
    print(f"[precision] allow_tf32: matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)
    failures = []

    cached = (build.BUILD_ROOT / build.source_hash()).exists()
    t0 = time.perf_counter()
    build.LIBRARY.get()
    print(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}, one process per "
          f"source: {build.LIBRARY.path} in {time.perf_counter() - t0:.2f} s"
          f"{' (library of these sources already built)' if cached else ''}")
    for line in build.LIBRARY.ptxas.splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            print(f"[build] {line.strip()}")

    def kernels(dev, failures):
        out = check_kernels(dev, failures)
        out["talker_step_fused"] = check_talker_step(dev, failures)
        out["talker_step_fused"].update(check_talker_batched(dev, failures))
        out["talker_step_fused"]["modes"] = check_talker_modes(dev, failures)
        out.update(check_int4(dev, failures))
        out["predict_frame_fused"] = check_predictor_frame(dev, failures)
        out.update(check_lanes(dev, failures))
        return out

    phases = (("kernels", kernels), ("chunk", check_chunk),
              ("reference", check_reference), ("engine", drive_engine),
              ("stream", drive_stream), ("clone", drive_clone),
              ("onnx", drive_onnx), ("serving", drive_serving),
              ("online", drive_online), ("spec", drive_spec),
              ("wave", drive_wave), ("weights", drive_weights),
              ("tools", drive_tools), ("parallel", drive_parallel))
    results = {}
    for name, fn in phases:
        if name not in phases_wanted:
            continue
        t_phase = time.perf_counter()
        try:
            results[name] = fn(dev, failures)
        except Exception as e:      # report every phase, then fail
            import traceback
            traceback.print_exc()
            failures.append(f"phase {name} raised {e!r}")
        print(f"[phase] {name}: {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.synchronize()

    kernels = []
    counts = {**(results.get("engine") or {}),
              **(results.get("stream") or {}),
              **(results.get("clone") or {}),
              **(results.get("onnx") or {}),
              **(results.get("serving") or {}),
              **(results.get("online") or {}),
              **(results.get("spec") or {}),
              **(results.get("wave") or {}),
              **(results.get("weights") or {}),
              **(results.get("tools") or {}),
              **((results.get("parallel") or {}).get("counts") or {})}
    measured = dict(results.get("kernels") or {})
    # the attention kernels and matmul_int4 at the 1 x 2 mesh's rank-local
    # heads and K (parallel phase)
    for name, row in ((results.get("parallel") or {}).get("rows")
                      or {}).items():
        measured[name] = dict(measured.get(name, {}), rank_local=row)
    if results.get("chunk"):
        measured["gen_chunk_fused"] = results["chunk"]
    # the path whose run gives a kernel's `launches`: the first that needs it
    paths = {**PATH_KERNELS, **STREAM_PATH_KERNELS,
             "serving-b8": SERVING_PATH_KERNELS["step"],
             "serving-exact": SERVING_PATH_KERNELS["exact"],
             **WEIGHTS_PATH_KERNELS, **CLONE_PATH_KERNELS,
             **ONNX_PATH_KERNELS, "online-b8": SERVING_PATH_KERNELS["step"],
             "spec-exact": ("flash_gqa_prefill_stacked",
                            "flash_gqa_decode_append"),
             **PARALLEL_PATH_KERNELS, **TOOLS_PATH_KERNELS}
    for name, (src, replaces) in KERNELS.items():
        k = dict(measured.get(name, {}))
        by_path = {p: c.get(name, 0) for p, c in counts.items()}
        if name == "talker_step_fused":
            k["launches_by_mode"] = {
                p: c["talker_step_fused_by_mode"] for p, c in counts.items()
                if "talker_step_fused_by_mode" in c}
        path = next((p for p in paths if name in paths[p] and p in counts),
                     "")
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": by_path.get(path, 0),
               "launches_by_path": by_path}
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            row[key] = k.pop(key, None)
        for sub in SUB_COUNTS.get(name, {}):
            if sub not in KERNELS:     # a second kernel the wrapper launches
                row.setdefault("second_kernel_launches_by_path", {})[sub] = {
                    p: c.get(sub, 0) for p, c in counts.items()}
        row.update(k)                  # extra shapes (the batched talker)
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(card_name_and_limit())
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

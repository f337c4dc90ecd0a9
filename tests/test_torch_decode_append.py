"""`flash_gqa_decode_append` in the CUDA kernel's sum orders
(qwen3_tts_tpu_torch/kernels/flash_decode.decode_append_kernel_order: the
prefix in 64-slot splits combined in split order, the current token merged
last) against the JAX package's Pallas kernel in interpret mode
(qwen3_tts_tpu/kernels/flash_decode.flash_gqa_decode_append), on the same
seeded numpy inputs, as tests/test_torch_serving.py runs the JAX side.

Cursors 0 (empty prefix: the token alone), 63, 64 and 65 (one split, full,
and a second split of one slot) and C - 1, with ragged prompt lengths and
a prompt_cap inside the prefix; with and without a poisoned stale row at
the slot being written; head dims 64 and 128; groups 1 and 2.

Tolerance.  Both sides compute in f32 from the same bf16 values; the
kernel-order version rounds its output to bf16 (as the kernel does), the
JAX one with f32 q returns f32.  So the bf16 output is held to half a bf16
ulp of the f32 result, at most 2^-8 of the value, plus 1e-5 for the f32
sums in another order: tests/test_torch_cuda.py's decode bound.  The
written caches bit for bit; a cursor >= C writes nothing and still attends
its own token.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from qwen3_tts_tpu.kernels import flash_decode as jfd
from qwen3_tts_tpu_torch.kernels import flash_decode as tfd

DECODE_RTOL, DECODE_ATOL = 2.0 ** -8, 1e-5
L, C, PCAP = 2, 512, 40
CURSORS = (0, 63, 64, 65, C - 1)
LENGTHS = (0, 30, 40, 17, 33)


def _bf16(rng, shape, scale=0.3):
    a = torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32))
    return a.bfloat16()


def _case(dh, group, poison, seed):
    rng = np.random.default_rng(seed)
    b, hkv = len(CURSORS), 2
    q = _bf16(rng, (b, hkv * group, dh), 1.0)
    k, v = _bf16(rng, (L, b, hkv, C, dh)), _bf16(rng, (L, b, hkv, C, dh))
    kn, vn = _bf16(rng, (b, hkv, dh)), _bf16(rng, (b, hkv, dh))
    if poison:                         # stale rows at the slot being written
        for i, c in enumerate(CURSORS):
            k[1, i, :, c] = 1e3
            v[1, i, :, c] = -1e3
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)
    return q, k, v, kn, vn, i32(LENGTHS), i32(CURSORS)


@pytest.mark.parametrize("dh,group,poison", [(128, 2, False),
                                              (128, 2, True), (64, 1, True)])
def test_kernel_order_matches_pallas(dh, group, poison):
    q, k, v, kn, vn, lengths, wi = _case(dh, group, poison, 30 + dh + group)
    jb = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    ja, jk, jv = jfd.flash_gqa_decode_append(
        jnp.asarray(q.float().numpy()), jb(k), jb(v), jb(kn), jb(vn),
        jnp.asarray(lengths.numpy()), jnp.asarray(wi.numpy()), jnp.int32(1),
        PCAP, interpret=True)
    tk, tv = k.clone(), v.clone()
    got = tfd.decode_append_kernel_order(q, tk, tv, kn, vn, lengths, wi, 1,
                                         PCAP)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = torch.from_numpy(np.array(ja, np.float32))
    torch.testing.assert_close(got.float(), want, rtol=DECODE_RTOL,
                               atol=DECODE_ATOL)
    np.testing.assert_array_equal(tk.float().numpy(),
                                  np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv, np.float32))


def test_kernel_order_matches_plain_and_attends_past_the_capacity():
    """Against decode_append_plain (torch's orders) within the same bound
    at cursors in [0, C); a lane at a cursor >= C writes nothing and gets
    the prefix [0, C) plus its own token: the same lane at the cursor C - 1
    of a cache one slot longer, the token written there."""
    q, k, v, kn, vn, lengths, wi = _case(128, 2, True, 41)
    kp, vp = k.clone(), v.clone()
    want = tfd.decode_append_plain(q.float(), kp, vp, kn, vn, lengths, wi,
                                   1, PCAP)
    got = tfd.decode_append_kernel_order(q, k, v, kn, vn, lengths, wi, 1,
                                         PCAP)
    torch.testing.assert_close(got.float(), want.float(), rtol=DECODE_RTOL,
                               atol=DECODE_ATOL)
    assert torch.equal(k, kp) and torch.equal(v, vp)
    far = torch.tensor([C + 5], dtype=torch.int32)
    k1, v1 = k[:, 4:5].clone(), v[:, 4:5].clone()
    out = tfd.decode_append_kernel_order(q[4:5], k1, v1, kn[4:5], vn[4:5],
                                         lengths[4:5], far, 1, PCAP)
    assert torch.equal(k1, k[:, 4:5]) and torch.equal(v1, v[:, 4:5])
    kx = torch.cat([k[:, 4:5], torch.zeros_like(k[:, 4:5, :, :1])], dim=3)
    vx = torch.cat([v[:, 4:5], torch.zeros_like(v[:, 4:5, :, :1])], dim=3)
    ref = tfd.decode_append_kernel_order(
        q[4:5], kx, vx, kn[4:5], vn[4:5], lengths[4:5],
        torch.tensor([C], dtype=torch.int32), 1, PCAP)
    assert torch.equal(out, ref)

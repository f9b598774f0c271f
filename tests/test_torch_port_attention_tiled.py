"""The attention kernel's algorithm (video_fingerprint_tpu_torch/csrc/attention.cu),
emulated in plain torch on the CPU, against the JAX package's attention.

The CUDA kernel cannot run here, so this emulation follows its order of work
and the CPU tests hold that algorithm against the reference: keys streamed in
tiles of 64 through an online softmax whose running max starts at -inf, the
finite mask bias added after the scale with two roundings, the ragged key
tail excluded (p = 0) rather than biased, and in bf16 the unnormalised
weights rounded to bf16 before P.V and divided by the running sum at the end.
The kernel itself is held against the port's plain version on the card
(tests/test_torch_port_kernels.py, chip_smoke.py).
"""

import math

import numpy as np
import pytest
import torch

from video_fingerprint_tpu.ops import attention as jattn
from video_fingerprint_tpu_torch.ops import attention as attn

BK = 64  # keys per tile, as in the kernel
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tiled_attention(q, k, v, mask=None):
    """(B, H, T, D) q/k/v and an optional (B, T) bool key mask -> (B, H, T, D)
    in q's dtype, computed tile by tile as the kernel does."""
    B, H, T, D = q.shape
    scale = 1.0 / math.sqrt(D)
    bias = attn._key_bias(mask, (B, T), q.device)
    m = torch.full((B, H, T), -math.inf)
    l = torch.zeros((B, H, T))
    acc = torch.zeros((B, H, T, D))
    for key0 in range(0, T, BK):
        n = min(BK, T - key0)
        # the tile's keys past T are zeros with a bias of -inf
        kt = torch.zeros((B, H, BK, D))
        vt = torch.zeros((B, H, BK, D))
        bt = torch.full((B, BK), -math.inf)
        kt[:, :, :n] = k[:, :, key0:key0 + n].float()
        vt[:, :, :n] = v[:, :, key0:key0 + n].float()
        bt[:, :n] = bias[:, key0:key0 + n]
        s = torch.matmul(q.float(), kt.transpose(-1, -2)) * scale  # first rounding
        s = s + bt[:, None, None, :]                               # second rounding
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)  # 0 while m is -inf, never NaN
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p.to(v.dtype).float(), vt)
        m = m_new
    return (acc / l[..., None]).to(q.dtype)


def _inputs(T, B=4, H=2, D=32):
    """Seeded q/k/v (B, H, T, D) and a (B, T) mask: batch 0 a ragged tail,
    batch 1 fully masked, batch 2 its first 64 keys masked and the rest
    valid (only the last key valid when T <= 64), batch 3 unmasked."""
    rng = np.random.default_rng(1000 + T)
    q, k, v = (rng.normal(size=(B, H, T, D)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, T), bool)
    mask[0, (2 * T) // 3:] = False
    mask[1] = False
    mask[2, :BK] = False
    mask[2, T - 1] = True
    return q, k, v, mask


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 65, 500, 1000])
def test_tiled_matches_jax(T, dtype):
    """The emulation against the JAX package's jnp path (masked and unmasked),
    its Pallas kernel in interpret mode (T <= 500, the TPU kernel's scan
    buckets), and the port's plain version."""
    import jax.numpy as jnp

    q, k, v, mask = _inputs(T)
    tq, tk, tv = (_torch(x, dtype) for x in (q, k, v))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    tol = TOL[dtype]

    def check(ours, ref):
        assert ours.dtype == dtype
        if isinstance(ref, torch.Tensor):
            ref = ref.float()
        np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                                   rtol=0, atol=tol)

    ours = tiled_attention(tq, tk, tv, torch.from_numpy(mask))
    assert torch.isfinite(ours.float()).all()
    check(ours, jattn.multihead_attention(jq, jk, jv, mask=mask, use_pallas=False))
    if T <= 500:
        check(ours, jattn.multihead_attention(jq, jk, jv, mask=mask, use_pallas=True,
                                              interpret=True))
    check(ours, attn.multihead_attention(tq, tk, tv, torch.from_numpy(mask)))
    check(tiled_attention(tq, tk, tv),
          jattn.multihead_attention(jq, jk, jv, use_pallas=False))


@pytest.mark.parametrize("T", [65, 1000])
def test_tiled_masked_rows(T):
    """A fully masked row averages v; a row whose leading tile is wholly
    masked forgets that tile when a valid key arrives (the rescale from a
    masked start) and equals attention over its valid keys alone, in f64."""
    q, k, v, mask = _inputs(T)
    ours = tiled_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(ours[1], np.broadcast_to(v[1].mean(axis=1, keepdims=True),
                                                        v[1].shape), rtol=0, atol=1e-5)
    valid = mask[2]
    s = q[2].astype(np.float64) @ k[2][:, valid].astype(np.float64).transpose(0, 2, 1)
    p = np.exp(s / math.sqrt(32) - (s / math.sqrt(32)).max(axis=-1, keepdims=True))
    ref = (p / p.sum(axis=-1, keepdims=True)) @ v[2][:, valid].astype(np.float64)
    np.testing.assert_allclose(ours[2], ref, rtol=0, atol=1e-5)

"""Two faults of the port, repaired: the positional encoding past the
reference's 10,000-row buffer, and the attention kernel's head widths.

- PositionalEncoding at T = 10,001 equals JAX `positional_encoding` (the
  port raised a shape error there).
- The attention wrapper zero-pads a head of D < 32 (or 32 < D < 64) to the
  kernel's width and drops the padded columns; on CPU tensors routed
  through that padding with the plain version as the launcher, the result
  equals the plain version at the true D (1e-6).
- Heads past 64 (which the port refused where JAX answers) go to the wide
  kernel unpadded, in ceil(D / 128) column chunks; routed the same way,
  they equal JAX `_attention_jnp` at that D in f32: within 1e-6 up to
  D = 128, 2e-6 above (the same f32 products and softmax; the two CPU
  matmuls sum 160-256 products in other orders, which moves outputs near 1
  by up to 12 ulps, 1.5e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_fingerprint_tpu.models.layers import positional_encoding
from video_fingerprint_tpu_torch.models.layers import PositionalEncoding
from video_fingerprint_tpu_torch.ops import attention as attn


def test_positional_encoding_past_the_buffer():
    T, C = 10_001, 32
    x = np.random.default_rng(0).normal(size=(1, T, C)).astype(np.float32)
    pe = PositionalEncoding(C)
    assert pe.pe.shape == (1, 10_000, C)  # the reference's buffer, for strict loads
    ours = pe(torch.from_numpy(x)).numpy()
    ref = np.asarray(positional_encoding(jnp.asarray(x)))
    np.testing.assert_array_equal(ours, ref)
    short = pe(torch.from_numpy(x[:, :500])).numpy()
    np.testing.assert_array_equal(short, ours[:, :500])


def _plain_launch(q, k, v, mask, scale):
    B, _, T, _ = q.shape
    bias = attn._key_bias(mask, (B, T), q.device)[:, None, :]
    return attn._attention_torch(q, k, v, bias, scale)


@pytest.mark.parametrize("D,width", [(4, 32), (16, 32), (32, 32), (48, 64), (64, 64)])
def test_head_padding_is_exact(D, width):
    assert attn.kernel_width(D) == width
    rng = np.random.default_rng(D)
    B, H, T = 3, 8, 21
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, T, D)).astype(np.float32))
               for _ in range(3))
    mask = torch.ones(B, T, dtype=torch.bool)
    mask[1, 13:] = False
    mask[2] = False
    widths = []

    def launch(*args):
        widths.append(args[0].shape[-1])
        return _plain_launch(*args)

    out = attn._at_kernel_width(launch, q, k, v, mask)
    assert widths == [width] and out.shape == q.shape
    ref = attn.multihead_attention(q, k, v, mask)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("D,chunks,atol", [(96, 1, 1e-6), (128, 1, 1e-6), (160, 2, 2e-6),
                                           (256, 2, 2e-6)])
def test_head_dim_past_64_matches_jax(D, chunks, atol):
    from video_fingerprint_tpu.ops.attention import _attention_jnp

    assert attn.kernel_width(D) == 128
    assert attn.kernel_plan(D) == (128, chunks, D)
    rng = np.random.default_rng(D)
    B, H, T = 2, 8, 21
    q, k, v = (rng.normal(size=(B, H, T, D)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, T), bool)
    mask[0, 13:] = False
    mask[1] = False
    widths = []

    def launch(*args):
        widths.append(args[0].shape[-1])
        return _plain_launch(*args)

    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = attn._at_kernel_width(launch, tq, tk, tv, torch.from_numpy(mask))
    assert widths == [D] and out.shape == (B, H, T, D)
    bias = np.where(np.repeat(mask, H, axis=0), 0.0,
                    np.finfo(np.float32).min / 2).astype(np.float32)
    flat = lambda x: jnp.asarray(x.reshape(B * H, T, D))
    ref = np.asarray(_attention_jnp(flat(q), flat(k), flat(v), jnp.asarray(bias)))
    np.testing.assert_allclose(out.numpy(), ref.reshape(B, H, T, D), rtol=0, atol=atol)

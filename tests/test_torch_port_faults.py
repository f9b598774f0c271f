"""Two faults of the port, repaired: the positional encoding past the
reference's 10,000-row buffer, and the attention kernel's head widths.

- PositionalEncoding at T = 10,001 equals JAX `positional_encoding` (the
  port raised a shape error there).
- The attention wrapper zero-pads a head of D < 32 (or 32 < D < 64) to the
  kernel's width and drops the padded columns; on CPU tensors routed
  through that padding with the plain version as the launcher, the result
  equals the plain version at the true D (1e-6). Heads past 64 raise.
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


def test_head_dim_past_64_raises():
    with pytest.raises(ValueError, match="head dims up to 64"):
        attn.kernel_width(96)

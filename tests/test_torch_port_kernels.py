"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Skipped without one.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py
"""

import numpy as np
import pytest
import torch

from video_fingerprint_tpu_torch.ops import attention as attn
from video_fingerprint_tpu_torch.utils.precision import full_fp32


def _inputs(T, dtype, B=8, H=8, D=32):
    """Seeded (B, H, T, D) q/k/v on the card and a (B, T) mask: batch 0
    unmasked, batch 1 a ragged tail, the last batch fully masked."""
    rng = np.random.default_rng(T)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, T, D)).astype(np.float32))
               .cuda().to(dtype) for _ in range(3))
    mask = np.ones((B, T), bool)
    mask[1, (2 * T) // 3:] = False
    mask[-1] = False
    return q, k, v, torch.from_numpy(mask).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_attention_kernel_matches_plain(dtype, tol):
    """At every scan bucket length: the kernel launches (its count moves),
    stays finite, matches the plain version, and gives a fully masked row
    the mean of v."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for T in (32, 48, 64, 128, 256, 500):
        q, k, v, mask = _inputs(T, dtype)
        before = attn.launches
        out = attn.multihead_attention(q, k, v, mask)
        torch.cuda.synchronize()
        assert attn.launches == before + 1
        bias = attn._key_bias(mask, mask.shape, mask.device)[:, None, :]
        with full_fp32():
            plain = attn._attention_torch(q, k, v, bias)
        assert torch.isfinite(out).all()
        assert (out.float() - plain.float()).abs().max().item() <= tol, T
        uniform = v[-1].float().mean(dim=1, keepdim=True)
        assert (out[-1].float() - uniform).abs().max().item() <= tol, T


@pytest.mark.gpu
def test_attention_kernel_flat_layout():
    """fused_attention's (BH, T, D) entry point with a (BH, T) mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    q, k, v, mask = _inputs(48, torch.float32, B=2)
    B, H, T, D = q.shape
    flat = lambda x: x.reshape(B * H, T, D)
    mflat = mask.repeat_interleave(H, dim=0)
    out = attn.fused_attention(flat(q), flat(k), flat(v), mflat)
    ref = attn.multihead_attention(q, k, v, mask).reshape(B * H, T, D)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)

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
from video_fingerprint_tpu_torch.ops import convblock as cb
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


def _conv_inputs(n, dtype=torch.bfloat16, frames=None):
    """Seeded x (64, 16, 16, n), w2d (128, 576) and b (128, 1) on the card;
    with `frames`, x is the first n frames of a (64, 16, 16, frames) tensor."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((64, 16, 16, frames or n)).astype(np.float32)
    w2d = (rng.standard_normal((128, 576)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((128, 1)) * 0.1).astype(np.float32)
    x, w2d, b = (torch.from_numpy(a).cuda().to(dtype) for a in (x, w2d, b))
    return x[..., :n], w2d, b


@pytest.mark.gpu
@pytest.mark.parametrize("n,frames", [(256, None), (200, None), (203, None), (203, 256)],
                         ids=["256", "200", "203_unaligned", "203_view"])
def test_conv_kernels_match_plain(n, frames):
    """Both entry points launch once each (their counts move by one), agree
    with each other bit for bit and with the plain version within one bf16
    ulp: a ragged frame count, rows not 16-byte aligned (203 frames), and a
    view whose last 16-byte copy is partly past the end (203 of 256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x, w2d, b = _conv_inputs(n, frames=frames)
    before = dict(cb.launches)
    parity = cb.conv_parity(*cb.split_parity(x), w2d, b)
    strided = cb.conv_strided(x, w2d, b)
    torch.cuda.synchronize()
    assert cb.launches == {k: c + 1 for k, c in before.items()}
    with full_fp32():
        plain = cb._conv_torch(x, w2d, b)
    assert torch.equal(parity, strided)
    err, ok = cb.compare(strided, plain, cb.ONE_ULP)
    assert ok, err


@pytest.mark.gpu
def test_conv_kernel_refuses_float32():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x, w2d, b = _conv_inputs(16, torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        cb.conv_strided(x, w2d, b)

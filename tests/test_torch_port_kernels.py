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


ATTENTION_T = (1, 17, 32, 48, 64, 65, 127, 128, 129, 256, 500, 513, 1000)
ATTENTION_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _mask(B, T):
    """(B, T) key mask on the card: batch 0 unmasked, batch 1 a ragged tail,
    batch 2 its first 64 keys masked and the rest valid (the online
    softmax's rescale from a masked start; for T <= 64 only the last key is
    valid), the last batch fully masked."""
    mask = np.ones((B, T), bool)
    mask[1, (2 * T) // 3:] = False
    mask[2, :64] = False
    mask[2, T - 1] = True
    mask[-1] = False
    return torch.from_numpy(mask).cuda()


def _inputs(T, dtype, B=8, H=8, D=32):
    """Seeded (B, H, T, D) q/k/v on the card and `_mask`'s (B, T) mask."""
    rng = np.random.default_rng(T)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, T, D)).astype(np.float32))
               .cuda().to(dtype) for _ in range(3))
    return q, k, v, _mask(B, T)


def _check_attention(q, k, v, mask, tol):
    """One launch (the count moves by one), finite, the plain version's
    values, and the mean of v for the fully masked last batch."""
    before = attn.launches
    out = attn.multihead_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert attn.launches == before + 1
    bias = attn._key_bias(mask, mask.shape, mask.device)[:, None, :]
    with full_fp32():
        plain = attn._attention_torch(q, k, v, bias)
    T = q.shape[2]
    assert out.shape == q.shape and out.dtype == q.dtype
    assert torch.isfinite(out).all(), T
    assert (out.float() - plain.float()).abs().max().item() <= tol, T
    uniform = v[-1].float().mean(dim=1, keepdim=True)
    assert (out[-1].float() - uniform).abs().max().item() <= tol, T
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain(dtype):
    """Every T from one frame past two key tiles of 64 (ragged tails, the
    scan's buckets, and T > 512): the kernel launches, stays finite, matches
    the plain version, and gives a fully masked row the mean of v."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for T in ATTENTION_T:
        _check_attention(*_inputs(T, dtype), ATTENTION_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_strided_views(dtype):
    """The model's own views of one fused qkv projection (no copies; o comes
    back in (B, T, H, D) order), and q/k/v at a storage offset of one
    element, whose rows are not 16-byte aligned (the element-wise loader)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    B, H, D = 8, 8, 32
    for T in (17, 128, 500, 1000):
        rng = np.random.default_rng(T)
        qkv = torch.from_numpy(rng.normal(size=(B, T, 3 * H * D)).astype(np.float32))
        qkv = qkv.cuda().to(dtype)
        q, k, v = qkv.view(B, T, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
        out = _check_attention(q, k, v, _mask(B, T), ATTENTION_TOL[dtype])
        assert out.transpose(1, 2).is_contiguous()

        n = B * H * T * D
        flat = torch.from_numpy(rng.normal(size=3 * n + 1).astype(np.float32))
        flat = flat.cuda().to(dtype)
        q, k, v = (flat[1 + i * n: 1 + (i + 1) * n].view(B, H, T, D) for i in range(3))
        assert q.data_ptr() % 16 != 0
        _check_attention(q, k, v, _mask(B, T), ATTENTION_TOL[dtype])


@pytest.mark.gpu
def test_attention_kernel_flat_layout():
    """fused_attention's (BH, T, D) entry point with a (BH, T) mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    q, k, v, mask = _inputs(48, torch.float32, B=4)
    B, H, T, D = q.shape
    flat = lambda x: x.reshape(B * H, T, D)
    mflat = mask.repeat_interleave(H, dim=0)
    out = attn.fused_attention(flat(q), flat(k), flat(v), mflat)
    ref = attn.multihead_attention(q, k, v, mask).reshape(B * H, T, D)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.fixture
def card():
    """Skips the test without an NVIDIA card (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [4, 16, 48, 64])
def test_attention_kernel_head_dims(card, D, dtype):
    """Head dims other than 32: zero-padded to the kernel's width 32 (D = 4,
    16) or 64 (D = 48, and D = 64 unpadded), against the plain version at
    the true D, at T from one frame past two key tiles."""
    for T in (1, 65, 128, 500):
        _check_attention(*_inputs(T, dtype, D=D), ATTENTION_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [96, 128, 160, 256])
def test_attention_kernel_wide_heads(card, D, dtype):
    """Heads past 64 columns (the wide kernel: one 128-column chunk for
    D = 96, zero-padded in shared memory, and D = 128; two for D = 160 and
    256): one launch each, against the plain version at T from one frame
    past two key tiles, and through the model's strided views of a fused
    qkv projection and rows that are not 16-byte aligned."""
    for T in (1, 65, 128, 500):
        _check_attention(*_inputs(T, dtype, D=D), ATTENTION_TOL[dtype])
    B, H, T = 8, 8, 65
    rng = np.random.default_rng(D)
    qkv = torch.from_numpy(rng.normal(size=(B, T, 3 * H * D)).astype(np.float32))
    q, k, v = qkv.cuda().to(dtype).view(B, T, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
    _check_attention(q, k, v, _mask(B, T), ATTENTION_TOL[dtype])
    n = B * H * T * D
    flat = torch.from_numpy(rng.normal(size=3 * n + 1).astype(np.float32)).cuda().to(dtype)
    q, k, v = (flat[1 + i * n: 1 + (i + 1) * n].view(B, H, T, D) for i in range(3))
    _check_attention(q, k, v, _mask(B, T), ATTENTION_TOL[dtype])


@pytest.mark.gpu
def test_attention_kernel_refuses_grad(card):
    """The kernel has no backward: a q that requires grad raises (a silent
    launch would cut attention out of the graph); under no_grad it runs."""
    q, k, v, mask = _inputs(32, torch.float32)
    q.requires_grad_(True)
    before = attn.launches
    with pytest.raises(RuntimeError, match="no backward"):
        attn.multihead_attention(q, k, v, mask)
    assert attn.launches == before
    with torch.no_grad():
        attn.multihead_attention(q, k, v, mask)
    assert attn.launches == before + 1


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
@pytest.mark.parametrize("n,frames", [(256, None), (200, None), (203, None), (203, 256),
                                      (1, None), (16 * 132 + 5, None), (16384, None)],
                         ids=["256", "200", "203_unaligned", "203_view", "1",
                              "partial_walk", "16384"])
def test_conv_kernels_match_plain(n, frames):
    """Both entry points launch once each (their counts move by one), agree
    with each other bit for bit and with the plain version within one bf16
    ulp: a ragged frame count, rows not 16-byte aligned (203 frames, and one
    frame), a view whose last 16-byte copy is partly past the end (203 of
    256), 133 tiles on 132 SMs (one block walks a second, partial tile), and
    the probe's 16,384 frames."""
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
def test_conv_kernel_one_tile_operand_layout():
    """One tile of 16 frames, w2d nonzero in one tap (dy, dx) at a time: each
    tap's wgmma operands (w2d's 128B-swizzled rows, the input's window of 8
    column slots) on their own, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x, w2d, b = _conv_inputs(16)
    for tap in range(9):
        w_tap = torch.zeros_like(w2d)
        w_tap[:, 64 * tap:64 * (tap + 1)] = w2d[:, 64 * tap:64 * (tap + 1)]
        parity = cb.conv_parity(*cb.split_parity(x), w_tap, b)
        strided = cb.conv_strided(x, w_tap, b)
        torch.cuda.synchronize()
        with full_fp32():
            plain = cb._conv_torch(x, w_tap, b)
        assert torch.equal(parity, strided), tap
        err, ok = cb.compare(strided, plain, cb.ONE_ULP)
        assert ok, (tap, err)


@pytest.mark.gpu
def test_conv_kernel_refuses_strided_frames():
    """Frames must be the contiguous (last) dimension: a view with a frame
    stride of 2 raises instead of launching."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x, w2d, b = _conv_inputs(64)
    before = dict(cb.launches)
    with pytest.raises(ValueError, match="stride 1"):
        cb.conv_strided(x[..., ::2], w2d, b)
    with pytest.raises(ValueError, match="stride 1"):
        cb.conv_parity(*cb.split_parity(x[..., ::2]), w2d, b)
    assert cb.launches == before


@pytest.mark.gpu
def test_conv_kernel_refuses_float32():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x, w2d, b = _conv_inputs(16, torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        cb.conv_strided(x, w2d, b)

"""The port's attention (video_fingerprint_tpu_torch/ops/attention.py) against
the JAX package's: the jnp path and the Pallas kernel in interpret mode.

On the CPU the port runs its plain version; the hand-written CUDA kernel is
held against that plain version on the card (tests/test_torch_port_kernels.py
and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from video_fingerprint_tpu.ops import attention as jattn
from video_fingerprint_tpu_torch.ops import attention as attn

ATOL = 1e-5  # f32 on the CPU; both sides compute in f32, in another order


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(T, B=3, H=8, D=32, seed=0):
    """q/k/v (B, H, T, D) and a (B, T) mask: batch 0 unmasked, batch 1 a
    ragged tail, batch 2 fully masked."""
    rng = np.random.default_rng(seed + T)
    q, k, v = (rng.normal(size=(B, H, T, D)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, T), bool)
    mask[1, (2 * T) // 3:] = False
    mask[2] = False
    return q, k, v, mask


@pytest.mark.parametrize("T", [32, 48, 500])
def test_plain_matches_jnp_and_pallas(T):
    q, k, v, mask = _inputs(T)
    ours = attn.multihead_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                    mask=torch.from_numpy(mask)).numpy()
    ref_jnp = np.asarray(jattn.multihead_attention(q, k, v, mask=mask, use_pallas=False))
    ref_pallas = np.asarray(jattn.multihead_attention(q, k, v, mask=mask,
                                                      use_pallas=True, interpret=True))
    np.testing.assert_allclose(ours, ref_jnp, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ours, ref_pallas, rtol=0, atol=ATOL)
    # every key masked: uniform weights, the mean of v, and no NaN
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours[2], np.broadcast_to(v[2].mean(axis=1, keepdims=True),
                                                        v[2].shape), rtol=0, atol=ATOL)


@pytest.mark.parametrize("T", [32, 500])
def test_plain_unmasked_and_flat_layout(T):
    """mask=None, and fused_attention's (BH, T, D) layout with a (BH, T) mask."""
    q, k, v, mask = _inputs(T)
    B, H, _, D = q.shape
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    ours = attn.multihead_attention(tq, tk, tv).numpy()
    ref = np.asarray(jattn.multihead_attention(q, k, v, use_pallas=False))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)

    flat = lambda x: x.reshape(B * H, T, D)
    mflat = np.repeat(mask, H, axis=0)
    ours = attn.fused_attention(flat(tq), flat(tk), flat(tv),
                                torch.from_numpy(mflat)).numpy()
    ref = np.asarray(jattn.fused_attention(flat(q), flat(k), flat(v), mflat,
                                           use_pallas=False))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


def test_plain_bf16_casts_p_to_v_dtype():
    """bf16 inputs: scores in f32, p rounded to bf16 before PV, output bf16 —
    the JAX kernel's arithmetic, so the two agree to bf16 output rounding."""
    import jax.numpy as jnp

    q, k, v, mask = _inputs(48)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    ours = attn.multihead_attention(bf(q), bf(k), bf(v), torch.from_numpy(mask))
    assert ours.dtype == torch.bfloat16
    jb = lambda x: jnp.asarray(x, jnp.bfloat16)
    ref = jattn.multihead_attention(jb(q), jb(k), jb(v), mask=mask, use_pallas=False)
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0, atol=2e-2)


def test_wrapper_raises_on_a_device_without_kernel():
    q = torch.zeros((1, 8, 4, 32), device="meta")
    with pytest.raises(RuntimeError, match="no attention kernel"):
        attn.multihead_attention(q, q, q)

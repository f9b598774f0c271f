"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Skipped without one.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py
"""

import numpy as np
import pytest
import torch

from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.ops import attention as attn
from video_fingerprint_tpu_torch.ops import convblock as cb
from video_fingerprint_tpu_torch.ops import stem
from video_fingerprint_tpu_torch.utils import trace
from video_fingerprint_tpu_torch.utils.precision import full_fp32


ATTENTION_T = (1, 17, 32, 48, 64, 65, 127, 128, 129, 256, 500, 513, 1000)
ATTENTION_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
CONV_ENTRIES = ("conv_parity", "conv_strided")
INT8_ENTRIES = ("conv_int8", "conv_int8_acc")


def _launches(prefix, entries):
    """The launch counters of a kernel's entry points (utils/trace.py)."""
    return {e: trace.counter(f"{prefix}.{e}") for e in entries}


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
    before = trace.counter("k1.launches")
    out = attn.multihead_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert trace.counter("k1.launches") == before + 1
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
    before = trace.counter("k1.launches")
    with pytest.raises(RuntimeError, match="no backward"):
        attn.multihead_attention(q, k, v, mask)
    assert trace.counter("k1.launches") == before
    with torch.no_grad():
        attn.multihead_attention(q, k, v, mask)
    assert trace.counter("k1.launches") == before + 1


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
    before = _launches("convblock", CONV_ENTRIES)
    parity = cb.conv_parity(*cb.split_parity(x), w2d, b)
    strided = cb.conv_strided(x, w2d, b)
    torch.cuda.synchronize()
    assert _launches("convblock", CONV_ENTRIES) == {k: c + 1 for k, c in before.items()}
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
    before = _launches("convblock", CONV_ENTRIES)
    with pytest.raises(ValueError, match="stride 1"):
        cb.conv_strided(x[..., ::2], w2d, b)
    with pytest.raises(ValueError, match="stride 1"):
        cb.conv_parity(*cb.split_parity(x[..., ::2]), w2d, b)
    assert _launches("convblock", CONV_ENTRIES) == before


@pytest.mark.gpu
def test_conv_kernel_refuses_float32():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x, w2d, b = _conv_inputs(16, torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        cb.conv_strided(x, w2d, b)


def _int8_layers():
    """The int8 probe's four layers (tools/exp_int8_conv.py's weights) on the card."""
    from video_fingerprint_tpu_torch.tools import exp_int8_conv as eic

    ws_f, bs_f, ws_q, w_scales, a_scales = eic.probe_weights(np.random.default_rng(0))
    return eic.SPECS, eic.int8_layers(ws_q, w_scales, bs_f, a_scales, torch.device("cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 5, 64])
def test_int8_conv_kernel_matches_plain(card, n):
    """K4 on each layer, fed the layer before (conv0 uint8 frames and the same
    frames shifted to int8): int32 sums, int8 and bf16 outputs bit for bit
    the plain version's, one launch per call."""
    from video_fingerprint_tpu_torch.ops import conv_int8 as ci

    specs, layers = _int8_layers()
    frames = torch.from_numpy(np.random.default_rng(n).integers(
        0, 256, (n, 64, 64, 3), dtype=np.uint8)).cuda()
    x = frames
    for i, (pw, w_scale, bias, requant) in enumerate(layers):
        inputs = (x, (frames.to(torch.int16) - 128).to(torch.int8)) if i == 0 else (x,)
        for xin in inputs:
            assert torch.equal(ci.conv_int8_acc(xin, pw), ci.conv_acc_plain(xin, pw)), i
            for rq in (requant, None):
                before = trace.counter("conv_int8.conv_int8")
                out = ci.conv_int8(xin, pw, w_scale, bias, rq)
                torch.cuda.synchronize()
                assert trace.counter("conv_int8.conv_int8") == before + 1
                assert torch.equal(out, ci.conv_int8_plain(xin, pw, w_scale, bias, rq)), (i, rq)
        x = ci.conv_int8(x, pw, w_scale, bias, requant)


@pytest.mark.gpu
def test_int8_conv_kernel_refuses_what_it_does_not_take(card):
    """A uint8 input past conv0, Cin not a multiple of 32, a strided input:
    ValueError or TypeError before any launch."""
    from video_fingerprint_tpu_torch.ops import conv_int8 as ci

    _, layers = _int8_layers()
    pw, w_scale, bias, requant = layers[1]
    before = _launches("conv_int8", INT8_ENTRIES)
    with pytest.raises(TypeError, match="int8"):
        ci.conv_int8(torch.zeros((2, 32, 32, 32), dtype=torch.uint8, device="cuda"), pw,
                     w_scale, bias, requant)
    with pytest.raises(ValueError, match="contiguous"):
        ci.conv_int8(torch.zeros((2, 32, 32, 64), dtype=torch.int8, device="cuda")[..., ::2],
                     pw, w_scale, bias, requant)
    w16 = ci.pack_weight(torch.zeros((3, 3, 16, 32), dtype=torch.int8, device="cuda"))
    with pytest.raises(ValueError, match="multiple of 32"):
        ci.conv_int8(torch.zeros((2, 8, 8, 16), dtype=torch.int8, device="cuda"), w16,
                     w_scale[:32], bias[:32], requant)
    assert _launches("conv_int8", INT8_ENTRIES) == before


# ------------------------------------------------------- exact top-k (K5)

# (M, N, D, k): every M, N, D and k of the kernel's range the search takes
# at least once, with query tiles, corpus tiles and chunks cut ragged; D = 37
# takes the loader that copies value by value (rows not 16-byte aligned)
TOPK_CASES = [(1, 20, 32, 20), (1, 20, 256, 1), (5, 1000, 256, 20), (5, 1000, 1000, 256),
              (256, 65537, 256, 20), (256, 65537, 32, 256), (256, 200003, 1000, 1),
              (1030, 200003, 256, 20), (1030, 65537, 1000, 20), (1030, 1000, 32, 256),
              (5, 1000, 37, 20)]
TOPK_STORAGE = (torch.float32, torch.bfloat16)


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _tied_rows(n, chunk_rows, size):
    """`size` distinct corpus rows on the edges of the kernel's 128-row tiles
    and of its chunks (the rows on either side of each), and the last row,
    then the lowest others."""
    edges = [e + s for e in range(128, n, 128) for s in (-1, 0)]
    edges = [e for e in range(chunk_rows, n, chunk_rows) for e in (e - 1, e)] + edges
    picked = list(dict.fromkeys([n - 1] + [e for e in edges if e < n]))[:size]
    taken = set(picked)
    rest = [r for r in range(n) if r not in taken][:size - len(picked)]
    return np.array(sorted(picked + rest))


def _topk_problem(M, N, D, k, storage):
    """Seeded unit queries and corpus on the card; a group of min(k + 3, N)
    byte-identical corpus rows on tile and chunk edges, which query rows 0
    and M - 1 equal; the search's problem and its tied group."""
    from video_fingerprint_tpu_torch.ops import topk

    rng = np.random.default_rng(M * 7 + N + D + k)
    corpus, queries = _unit_rows(rng, N, D), _unit_rows(rng, M, D)
    slots = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    group = _tied_rows(N, topk.kernel_plan(M, N, slots)[2], min(k + 3, N))
    corpus[group] = corpus[group[0]]
    queries[0] = queries[-1] = corpus[group[0]]
    c = torch.from_numpy(corpus).cuda().to(storage)
    return topk._Problem(torch.from_numpy(queries).cuda(), c), group


@pytest.mark.gpu
@pytest.mark.parametrize("storage", TOPK_STORAGE, ids=["f32", "bf16"])
@pytest.mark.parametrize("M,N,D,k", TOPK_CASES)
def test_topk_kernel_matches_plain(card, M, N, D, k, storage):
    """Two launches; scores within 2e-6 of the plain version's rank by rank,
    the same rows wherever the plain scores around a rank are 1e-5 apart,
    and on the query rows that equal the tied group its lowest rows first,
    in ascending order, at one score."""
    from video_fingerprint_tpu_torch.ops import topk

    p, group = _topk_problem(M, N, D, k, storage)
    before = trace.counter("topk.launches")
    scores, idx = topk._exact(p, k)
    torch.cuda.synchronize()
    assert trace.counter("topk.launches") == before + 2
    assert scores.shape == idx.shape == (M, k)
    assert scores.dtype == torch.float32 and idx.dtype == torch.int64
    with full_fp32():
        plain_s, plain_i = (t.cpu().numpy() for t in topk._exact_plain(p, min(k + 1, N)))
    scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
    assert np.abs(scores - plain_s[:, :k]).max() <= 2e-6
    gap = np.diff(plain_s, axis=1) * -1  # plain_s[:, j] - plain_s[:, j + 1]
    above = np.concatenate([np.full((M, 1), np.inf), gap[:, :k - 1]], axis=1)
    below = gap[:, :k] if plain_s.shape[1] > k else np.concatenate(
        [gap, np.full((M, 1), np.inf)], axis=1)
    apart = (above > 1e-5) & (below > 1e-5)
    assert np.array_equal(idx[apart], plain_i[:, :k][apart])
    tied = min(len(group), k)
    for row in (0, M - 1):
        assert np.array_equal(idx[row, :tied], group[:tied]), row
        assert np.all(scores[row, :tied] == scores[row, 0]), row
    assert np.all((idx >= 0) & (idx < N))


@pytest.mark.gpu
@pytest.mark.parametrize("storage", TOPK_STORAGE, ids=["f32", "bf16"])
def test_topk_search_on_the_card_has_no_host_wait(card, storage):
    """topk_search(method="exact") on the card: the kernel's two launches
    and no `topk.sync` span; the certified methods still wait on their
    certificate."""
    from torch.profiler import ProfilerActivity, profile

    from video_fingerprint_tpu_torch.ops import topk

    p, _ = _topk_problem(256, 65537, 256, 20, storage)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        before = trace.counter("topk.launches")
        topk.topk_search(p.queries, p.corpus, 20, exact_above=0.99, method="exact")
        assert trace.counter("topk.launches") == before + 2
        assert not [s for s in trace.recorded().spans if s.name == "topk.sync"]
        topk.topk_search(p.queries, p.corpus, 20, exact_above=0.95, method="certified")
    assert [s for s in trace.recorded().spans if s.name == "topk.sync"]
    trace.clear()


@pytest.mark.gpu
def test_topk_kernel_refuses_what_it_does_not_take(card):
    """k past 256, D past 1024, a strided input, a float16 corpus, float64
    queries, mismatched widths, one norm vector alone: ValueError or
    TypeError before any launch."""
    from video_fingerprint_tpu_torch.ops import topk

    q = torch.zeros((4, 64), device="cuda")
    c = torch.zeros((300, 64), device="cuda")
    before = trace.counter("topk.launches")
    with pytest.raises(ValueError, match="k <="):
        topk.topk_kernel(q, c, 257)
    with pytest.raises(ValueError, match="D <="):
        topk.topk_kernel(torch.zeros((4, 1025), device="cuda"),
                         torch.zeros((300, 1025), device="cuda"), 20)
    with pytest.raises(ValueError, match="contiguous"):
        topk.topk_kernel(torch.zeros((64, 4), device="cuda").t(), c, 20)
    with pytest.raises(ValueError, match="contiguous"):
        topk.topk_kernel(q, torch.zeros((300, 128), device="cuda")[:, ::2], 20)
    with pytest.raises(TypeError, match="corpus"):
        topk.topk_kernel(q, c.half(), 20)
    with pytest.raises(TypeError, match="queries"):
        topk.topk_kernel(q.double(), c, 20)
    with pytest.raises(ValueError, match="\\(M, D\\)"):
        topk.topk_kernel(q, torch.zeros((300, 32), device="cuda"), 20)
    with pytest.raises(ValueError, match="both"):
        topk.topk_kernel(q, c.bfloat16(), 20, query_rnorm=torch.ones(4, device="cuda"))
    assert trace.counter("topk.launches") == before


def _stem_inputs(n, h, w, seed=0):
    """Seeded frames on the card (starting with every byte value) and conv0
    weights whose channels 0-2 pass the centre tap's input channels through
    (weight 1, bias 0), so that K6's output there is its normalised input."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    frames = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, device="cuda", generator=g)
    flat = frames.view(-1)
    flat[:256] = torch.arange(min(256, flat.numel()), dtype=torch.uint8, device="cuda")
    wt = (torch.randn((32, 3, 5, 5), generator=g, device="cuda") / 8).to(torch.bfloat16)
    b = (torch.randn((32,), generator=g, device="cuda") / 8).to(torch.bfloat16)
    wt[:3] = 0
    for c in range(3):
        wt[c, c, 2, 2] = 1
    b[:3] = 0
    return frames, wt, b


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w", [(5, 64, 64), (64 * 32, 64, 64), (1061, 64, 64),
                                   (7, 37, 48), (3, 1, 16), (2, 96, 96)])
def test_stem_kernel_matches_plain(card, n, h, w):
    """K6: one launch (the counters move by one and by n frames), the model's
    own normalisation bit for bit in channels 0-2, every channel within one
    bf16 ulp of the plain version."""
    frames, wt, b = _stem_inputs(n, h, w)
    before = trace.counter("stem.launches"), trace.counter("stem.frames")
    blocks = trace.counter("stem.blocks")
    out = stem.stem_conv(frames, wt, b)
    torch.cuda.synchronize()
    assert (trace.counter("stem.launches"), trace.counter("stem.frames")) == (
        before[0] + 1, before[1] + n)
    assert 1 <= trace.counter("stem.blocks") - blocks <= n
    assert out.shape == (n, (h + 1) // 2, w // 2, 32) and out.dtype == torch.bfloat16
    x = frames.permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0
    assert torch.equal(out[..., :3].view(torch.int16),
                       x[:, :, ::2, ::2].permute(0, 2, 3, 1).view(torch.int16))
    with full_fp32():
        plain = stem.stem_conv_plain(frames, wt, b)
    err, ok = cb.compare(out, plain, cb.ONE_ULP)
    assert ok, err


@pytest.mark.gpu
@pytest.mark.parametrize("fill", [0, 255])
def test_stem_kernel_constant_frames(card, fill):
    frames, wt, b = _stem_inputs(64, 64, 64)
    frames.fill_(fill)
    out = stem.stem_conv(frames, wt, b)
    with full_fp32():
        plain = stem.stem_conv_plain(frames, wt, b)
    err, ok = cb.compare(out, plain, cb.ONE_ULP)
    assert ok, err


@pytest.mark.gpu
def test_stem_kernel_refuses_what_it_does_not_take(card):
    frames, wt, b = _stem_inputs(4, 64, 64)
    before = trace.counter("stem.launches")
    for bad, exc in ((frames.float(), TypeError), (frames[:, :, :40].contiguous(), ValueError),
                     (frames.transpose(1, 2), ValueError),
                     (frames.view(-1)[3:3 + 3 * 64 * 64 * 3].view(3, 64, 64, 3), ValueError)):
        with pytest.raises(exc):
            stem.stem_conv(bad, wt, b)
    with pytest.raises(ValueError):
        stem.stem_conv(frames, wt.float(), b)
    assert trace.counter("stem.launches") == before


@pytest.mark.gpu
def test_stem_card_frames_it_does_not_take_raise(card):
    """Under the fused bf16 eval model a card's uint8 batch goes to K6
    whatever its shape: 112 wide it raises, it does not go to cuDNN."""
    torch.manual_seed(0)
    model = create_model("attention", fused=True).to(torch.bfloat16).to("cuda").eval()
    frames = torch.zeros((2, 112, 112, 3), dtype=torch.uint8, device="cuda")
    before = trace.counter("stem.launches")
    with torch.inference_mode(), pytest.raises(ValueError, match="the stem kernel takes"):
        model._encode_flat(frames)
    assert trace.counter("stem.launches") == before

"""K6, the frame stem (video_fingerprint_tpu_torch/ops/stem.py), on the CPU:

- the normalisation table is the model's own u.to(bf16) / 255.0, bit for bit;
- the plain version is within one bf16 ulp of the function computed in
  float64 on the same bf16 inputs and rounded once, and within two of the
  unfused encoder[0:3] chain on input_from_frames (which rounds twice);
- the kernel's arithmetic, emulated here from its packed weight fragments
  and its tile addressing (csrc/stem.cu), is the plain version's;
- which encoders and frames engage K6, and which keep the cuDNN path; a
  card's frames K6 does not take raise rather than take another path;
- the wrapper's checks refuse what the kernel does not take, and it packs
  a weight once.

The kernel itself runs only on a card: tests/test_torch_port_kernels.py and
chip_smoke.py hold it to the plain version there.
"""

import numpy as np
import pytest
import torch

from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.ops import stem
from video_fingerprint_tpu_torch.ops.convblock import ONE_ULP, compare
from video_fingerprint_tpu_torch.utils import trace

TWO_ULPS = (2.0 ** -6, 2.0 ** -9)
SHAPES = ((64, 64), (37, 48), (1, 16))  # the scan's frames; odd H; the smallest


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two torch threads per test worker: the tier-1 run's six workers
    share the machine's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _frames(n, h, w, seed=0):
    """Seeded uint8 frames, which start with every byte value where they
    have room."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    flat = frames.reshape(-1)
    flat[:256] = np.arange(min(256, flat.size), dtype=np.uint8)
    return torch.from_numpy(frames)


def _fused_bf16_model(seed=0, **kwargs):
    torch.manual_seed(seed)
    return create_model("attention", fused=True, **kwargs).to(torch.bfloat16).eval()


def _weights(seed=0):
    """conv0's weight and bias of a seeded fused bf16 model."""
    conv0 = _fused_bf16_model(seed).spatial_encoder.encoder[0]
    return conv0.weight.detach(), conv0.bias.detach()


def _oracle(frames, w, b):
    """The stem in float64 on the same bf16 inputs and weights, rounded once."""
    x = stem.normalise_table("cpu")[frames.long()].permute(0, 3, 1, 2).double()
    y = torch.nn.functional.conv2d(x, w.double(), stride=2, padding=2)
    y = torch.relu(y + b.double().reshape(1, -1, 1, 1))
    return y.to(torch.bfloat16).permute(0, 2, 3, 1)


def test_table_is_the_models_division():
    u = torch.arange(256, dtype=torch.uint8)
    table = stem.normalise_table("cpu")
    assert table.dtype == torch.bfloat16 and table.shape == (256,)
    assert torch.equal(table.view(torch.int16), (u.to(torch.bfloat16) / 255.0).view(torch.int16))
    model = _fused_bf16_model()
    x = model.input_from_frames(u.reshape(1, 16, 16, 1).expand(1, 16, 16, 3).contiguous())
    assert torch.equal(x[0, 0].reshape(-1).view(torch.int16), table.view(torch.int16))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_within_one_ulp_of_the_f64_stem(shape):
    frames = _frames(3, *shape)
    w, b = _weights()
    out = stem.stem_conv(frames, w, b)
    ho, wo = stem.out_size(shape[0]), stem.out_size(shape[1])
    assert out.shape == (3, ho, wo, 32) and out.dtype == torch.bfloat16 and out.is_contiguous()
    ref = _oracle(frames, w, b)
    err, ok = compare(out, ref, ONE_ULP)
    assert ok, err
    live = float((ref > 0).float().mean())
    assert 0.2 < live < 0.9, live


def test_plain_within_two_ulps_of_the_unfused_chain():
    model = _fused_bf16_model(1)
    enc = model.spatial_encoder.encoder
    frames = _frames(4, 64, 64, seed=1)
    with torch.inference_mode():
        chain = enc[0:3](model.input_from_frames(frames))
        out = stem.stem_conv(frames, enc[0].weight, enc[0].bias)
    err, ok = compare(out.permute(0, 3, 1, 2), chain, TWO_ULPS)
    assert ok, err


def _emulate_kernel(frames, w, b):
    """csrc/stem.cu's arithmetic on the CPU: the zero-ringed tile it fills,
    the A fragments it loads from it (kernel row dy, taps j = 0..15 of
    pixel (oy, ox) at tile offset 2 + (2 oy + dy) rs + 6 ox + j), the B
    fragments of pack_weight's layout as mma.m16n8k16 defines them, f32
    sums, and the epilogue's channel of each accumulator."""
    n, h, wd, _ = frames.shape
    ho, wo = stem.out_size(h), stem.out_size(wd)
    rs = (wd + 4) * 3
    size = 2 + (h + 4) * rs
    tile = torch.zeros((n, size), dtype=torch.float64)
    table = stem.normalise_table("cpu").double()
    rows = table[frames.long()].reshape(n, h, wd * 3)
    for iy in range(h):
        tile[:, 2 + (iy + 2) * rs + 6: 2 + (iy + 2) * rs + 6 + wd * 3] = rows[:, iy]
    packed = stem.pack_weight(w).double()                 # (dy, nt, r, lane, h)
    B = torch.zeros((5, 16, 32), dtype=torch.float64)    # (dy, k, mma column)
    for lane in range(32):
        g, t4 = divmod(lane, 4)
        for nt in range(4):
            for r in range(2):
                for hh in range(2):
                    B[:, 8 * r + 2 * t4 + hh, 8 * nt + g] = packed[:, nt, r, lane, hh]
    oy, ox = torch.meshgrid(torch.arange(ho), torch.arange(wo), indexing="ij")
    base = (2 + 2 * oy * rs + 6 * ox).reshape(-1)
    acc = torch.zeros((n, ho * wo, 32), dtype=torch.float64)
    for dy in range(5):
        idx = base[:, None] + dy * rs + torch.arange(16)
        assert int(idx.max()) < size
        acc += tile[:, idx] @ B[dy]
    channel = [8 * ((c % 8) // 2) + 2 * (c // 8) + c % 2 for c in range(32)]
    out = torch.empty_like(acc)
    out[..., channel] = acc
    out = torch.relu(out.float() + b.float())
    return out.to(torch.bfloat16).reshape(n, ho, wo, 32)


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_emulation_matches_plain(shape):
    frames = _frames(2, *shape, seed=2)
    w, b = _weights(2)
    err, ok = compare(_emulate_kernel(frames, w, b), stem.stem_conv_plain(frames, w, b), ONE_ULP)
    assert ok, err


def test_pack_weight_takes_any_strides():
    w, _ = _weights(3)
    last = w.to(memory_format=torch.channels_last)
    assert not last.is_contiguous()
    packed = stem.pack_weight(last)
    assert packed.shape == (5, 4, 2, 32, 2) and packed.is_contiguous()
    assert torch.equal(packed, stem.pack_weight(w.contiguous()))
    # the zero tap of each kernel row: k = 15 is reg 1, lane % 4 = 3, h = 1
    assert not packed[:, :, 1, 3::4, 1].any()


class _OnCard(torch.Tensor):
    """CPU frames that say they are on a card: the engagement rule reads
    only the frames' dtype and device, so this tests it without a card."""

    @property
    def is_cuda(self):
        return True


def _on_card(frames):
    return frames.as_subclass(_OnCard)


def _variant(case):
    """(encoder, frames) of one engagement case."""
    frames = _on_card(_frames(2, 64, 64))
    if case == "f32":
        return _fused_bf16_model().float().spatial_encoder, frames
    if case == "s2d":
        return _fused_bf16_model(s2d=True).spatial_encoder, frames
    if case == "unfused":
        torch.manual_seed(0)
        return create_model("attention").to(torch.bfloat16).eval().spatial_encoder, frames
    model = _fused_bf16_model()
    if case == "train":
        model.train()
    if case == "float_frames":
        frames = _on_card(_frames(2, 64, 64).float() / 255.0)
    if case == "cpu_frames":
        frames = _frames(2, 64, 64)
    if case == "frames_112_wide":
        frames = _on_card(_frames(2, 112, 112))
    return model.spatial_encoder, frames


@pytest.mark.parametrize("case,engages", [("eval_bf16_fused_uint8", True),
                                          ("frames_112_wide", True), ("f32", False),
                                          ("s2d", False), ("unfused", False),
                                          ("train", False), ("float_frames", False),
                                          ("cpu_frames", False)])
def test_engagement(case, engages):
    """The module, the frames' dtype and their device decide; their shape
    and layout do not (K6 raises on what it does not take)."""
    enc, frames = _variant(case)
    with torch.inference_mode():
        assert enc.stem_engages(frames) == engages


def test_engagement_needs_no_gradient_to_keep():
    enc = _fused_bf16_model().spatial_encoder
    frames = _on_card(_frames(1, 64, 64))
    with torch.inference_mode():
        assert enc.stem_engages(frames)
    assert not enc.stem_engages(frames)  # grad on, conv0's weight requires it
    enc.encoder[0].weight.requires_grad_(False)
    assert enc.stem_engages(frames)


def test_cpu_frames_keep_the_unfused_path():
    model = _fused_bf16_model()
    frames = _frames(3, 64, 64)
    with torch.inference_mode():
        ours = model._encode_flat(frames)
        chain = model.spatial_encoder(model.input_from_frames(frames))
        # the encoder's uint8 route (K6's plain version on the CPU, then
        # encoder[3:]) gives the same features to within bf16 rounding
        stem_route = model.spatial_encoder(frames)
    assert torch.equal(ours, chain)
    cos = torch.nn.functional.cosine_similarity(stem_route.float(), chain.float(), dim=1)
    assert float(cos.min()) > 0.999, cos


def test_card_frames_k6_does_not_take_raise():
    """A card's uint8 batch 112 wide under the fused bf16 eval model goes to
    K6, which refuses it before any launch: it does not go quietly to cuDNN."""
    model = _fused_bf16_model()
    frames = _on_card(_frames(2, 112, 112))
    before = trace.counter("stem.launches")
    with torch.inference_mode(), pytest.raises(ValueError, match="the stem kernel takes"):
        model._encode_flat(frames)
    assert trace.counter("stem.launches") == before


def test_packed_weights_are_made_once_per_weight():
    """The frozen conv0 packs on its first call only; an in-place change of
    the weight or the bias packs again; the entry goes with its tensors."""
    w, b = (t.clone() for t in _weights(4))
    first = stem.packed(w, b)
    assert stem.packed(w, b)[0] is first[0] and stem.packed(w, b)[1] is first[1]
    assert torch.equal(first[0], stem.pack_weight(w)) and first[1].dtype == torch.float32
    w.mul_(2)
    again = stem.packed(w, b)
    assert again[0] is not first[0] and torch.equal(again[0], stem.pack_weight(w))
    b.add_(1)
    assert torch.equal(stem.packed(w, b)[1], b.float())
    key = (id(w), id(b))
    assert key in stem._packs
    del w
    assert key not in stem._packs
    with torch.inference_mode():
        wi, bi = (t.clone() for t in _weights(4))
    assert torch.equal(stem.packed(wi, bi)[0], stem.pack_weight(wi))
    assert (id(wi), id(bi)) not in stem._packs


def _bad(case):
    """(frames, w, b, exception) the kernel does not take."""
    frames, (w, b) = _frames(2, 64, 64), _weights()
    if case == "float_frames":
        return frames.float(), w, b, TypeError
    if case == "not_contiguous":
        return frames[:, :, ::2].contiguous().transpose(1, 2), w, b, ValueError
    if case == "width_not_multiple_of_16":
        return _frames(2, 64, 40), w, b, ValueError
    if case == "too_wide":
        return _frames(1, 16, 112), w, b, ValueError
    if case == "too_tall":
        return _frames(1, 97, 16), w, b, ValueError
    if case == "four_channels":
        return torch.zeros((2, 64, 64, 4), dtype=torch.uint8), w, b, ValueError
    if case == "no_frames":
        return frames[:0], w, b, ValueError
    if case == "f32_weight":
        return frames, w.float(), b, ValueError
    if case == "wrong_weight_shape":
        return frames, w[:16], b, ValueError
    if case == "wrong_bias_size":
        return frames, w, b[:16], ValueError
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["float_frames", "not_contiguous", "width_not_multiple_of_16",
                                  "too_wide", "too_tall", "four_channels", "no_frames",
                                  "f32_weight", "wrong_weight_shape", "wrong_bias_size"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    frames, w, b, exc = _bad(case)
    with pytest.raises(exc):
        stem._check_cuda_inputs(frames, w, b)


def test_no_kernel_for_another_device():
    frames = torch.zeros((1, 64, 64, 3), dtype=torch.uint8, device="meta")
    w, b = _weights()
    with pytest.raises(RuntimeError, match="no stem kernel"):
        stem.stem_conv(frames, w.to("meta"), b.to("meta"))

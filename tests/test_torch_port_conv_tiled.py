"""The conv-block kernel's order of work (video_fingerprint_tpu_torch/csrc/conv3x3s2.cu),
emulated in plain torch on the CPU, against the JAX probe's Pallas kernels
(tools/exp_pallas_convblock.py, interpret mode) and XLA's conv.

The CUDA kernel cannot run here, so this emulation follows its index
arithmetic and the CPU tests hold it to the reference: frame tiles of 16; per
input row and chunk of 32 channels a stage of 17 column slots [even columns |
zero | odd columns], built from xe and xo (parity mode) or from x viewed as
(64, 16, 8, 2, N) (full mode); tap dx read as the unit-stride window of 8
slots from slot 8, 0 or 9; f32 sums stage by stage in the kernel's (dy,
channel chunk, dx) order, the padding row at y' = 0 never staged; frames past
N staged as zeros and not stored; and the epilogue's quad transpose, whose
lanes must write every element of the tile once. Change it together with the
.cu file. The kernel itself is held against the port's plain version on the
card (tests/test_torch_port_kernels.py, chip_smoke.py).
"""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import REPO_ROOT
from video_fingerprint_tpu_torch.ops import convblock as cb

FRAMES = 256          # two of the Pallas grid's 128-frame steps
TILE = 16             # frames per tile
CHUNK = 32            # input channels per stage
ZERO_SLOT = 8
DX_SLOT = (ZERO_SLOT, 0, ZERO_SLOT + 1)  # first slot of tap dx = 0, 1, 2


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _stage(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """(32, 8, F) even and odd columns of one input row -> (17, 32, F) slots."""
    zero = torch.zeros((1,) + even.shape[:1] + even.shape[2:], dtype=even.dtype)
    return torch.cat([even.permute(1, 0, 2), zero, odd.permute(1, 0, 2)])


def parity_stages(xe: torch.Tensor, xo: torch.Tensor):
    """stage(iy, c, f0) from the even and odd columns, (64, 16, 8, N) each."""
    def stage(iy, c, f0):
        ch = slice(c * CHUNK, (c + 1) * CHUNK)
        return _stage(xe[ch, iy, :, f0:f0 + TILE], xo[ch, iy, :, f0:f0 + TILE])
    return stage


def full_stages(x: torch.Tensor):
    """stage(iy, c, f0) from x (64, 16, 16, N) through its (64, 16, 8, 2, N) view."""
    xv = x.view(x.shape[0], x.shape[1], 8, 2, x.shape[3])

    def stage(iy, c, f0):
        ch = slice(c * CHUNK, (c + 1) * CHUNK)
        return _stage(xv[ch, iy, :, 0, f0:f0 + TILE], xv[ch, iy, :, 1, f0:f0 + TILE])
    return stage


def _pad_frames(t: torch.Tensor) -> torch.Tensor:
    """Frames past N as zeros, up to a whole number of tiles."""
    n = t.shape[-1]
    return torch.nn.functional.pad(t, (0, -n % TILE))


def tiled_conv(stage, w2d: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """The kernel's work on stages from `stage`, frames already padded to
    whole tiles: (128, 8, 8, n) bf16."""
    w = w2d.float().reshape(cb.COUT, 9, cb.CIN)         # (co, tap, ci)
    bias = b.float().reshape(cb.COUT, 1, 1)
    tiles = -(-n // TILE)
    out = torch.empty((cb.COUT, 8, 8, tiles * TILE), dtype=torch.bfloat16)
    for tile in range(tiles):
        f0 = tile * TILE
        acc = {}
        for iy in range(16):                     # each input row staged once
            for c in range(cb.CIN // CHUNK):
                slots = stage(iy, c, f0).float()  # (17, 32, 16)
                # output rows y' this row feeds, as input row dy = iy - 2y' + 1
                fed = [(iy // 2, 1)] if iy % 2 == 0 else [((iy - 1) // 2, 2), ((iy + 1) // 2, 0)]
                for yo, dy in fed:
                    if yo >= 8:
                        continue
                    if yo not in acc:
                        acc[yo] = torch.zeros((cb.COUT, 8, TILE))
                    for dx in range(3):
                        window = slots[DX_SLOT[dx]:DX_SLOT[dx] + 8]      # (x', ci, f)
                        wk = w[:, 3 * dy + dx, c * CHUNK:(c + 1) * CHUNK]  # (co, ci)
                        acc[yo] += torch.einsum("oc,xcf->oxf", wk, window)
            if iy % 2 == 1:                      # output row (iy - 1) / 2 is done
                yo = (iy - 1) // 2
                out[:, yo, :, f0:f0 + TILE] = torch.relu(acc.pop(yo) + bias).to(torch.bfloat16)
    return out[..., :n]


def tiled_parity(xe, xo, w2d, b):
    n = xe.shape[-1]
    return tiled_conv(parity_stages(_pad_frames(xe), _pad_frames(xo)), w2d, b, n)


def tiled_full(x, w2d, b):
    n = x.shape[-1]
    return tiled_conv(full_stages(_pad_frames(x)), w2d, b, n)


@pytest.fixture(scope="module")
def inputs():
    """Seeded x (64, 16, 16, 256), its HWIO kernel and bias, as float32
    arrays holding bf16 values, handed to both frameworks."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((cb.CIN, 16, 16, FRAMES)).astype(np.float32)
    k_hwio = (rng.standard_normal((3, 3, cb.CIN, cb.COUT)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(cb.COUT) * 0.1).astype(np.float32)
    bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    return bf16(x), bf16(k_hwio), bf16(b)


@pytest.fixture(scope="module")
def references(inputs):
    """Both Pallas kernels in interpret mode and XLA's conv on all 256
    frames, as float32 (128, 8, 8, 256); frames are independent, so the
    first n frames answer for n."""
    spec = importlib.util.spec_from_file_location(
        "exp_pallas_convblock", REPO_ROOT / "tools" / "exp_pallas_convblock.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    x, k_hwio, b = inputs
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    w2d = jb(np.transpose(k_hwio, (3, 0, 1, 2)).reshape(cb.COUT, cb.K))
    bias = jb(b.reshape(cb.COUT, 1))
    refs = {
        "pallas_K2": probe.make_pallas_conv(interpret=True, strided=False)(
            jb(x[:, :, 0::2]), jb(x[:, :, 1::2]), w2d, bias),
        "pallas_K3": probe.make_pallas_conv(interpret=True, strided=True)(jb(x), None, w2d, bias),
    }
    xla = jax.lax.conv_general_dilated(
        jb(x.transpose(3, 1, 2, 0)), jb(k_hwio), (2, 2), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.float32)
    refs["xla"] = jnp.maximum(xla + b, 0.0).astype(jnp.bfloat16).transpose(3, 1, 2, 0)
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in refs.items()}


def _port_args(x, k_hwio, b, n):
    return (torch.from_numpy(np.ascontiguousarray(x[..., :n])).to(torch.bfloat16),
            cb.hwio_to_w2d(k_hwio), torch.from_numpy(b).reshape(cb.COUT, 1).to(torch.bfloat16))


@pytest.mark.parametrize("n", [FRAMES, 200])
def test_tiled_matches_pallas_and_xla(inputs, references, n):
    """Parity mode (from xe, xo) equals full mode (from the (64, 16, 8, 2, N)
    view) bit for bit, and both are within one bf16 ulp of both Pallas
    kernels, XLA and the port's plain version, and within half an ulp plus
    the f32 sum error of the f64 oracle; at 200 frames the last tile holds 8
    frames past N."""
    x, w2d, b = _port_args(*inputs, n)
    parity = tiled_parity(*cb.split_parity(x), w2d, b)
    full = tiled_full(x, w2d, b)
    assert parity.shape == (cb.COUT, 8, 8, n) and parity.dtype == torch.bfloat16
    assert torch.equal(parity, full)
    for name, ref in references.items():
        err, ok = cb.compare(full, ref[..., :n], cb.ONE_ULP)
        assert ok, (name, err)
    err, ok = cb.compare(full, cb.conv_strided(x, w2d, b), cb.ONE_ULP)
    assert ok, err
    err, ok = cb.compare(full, cb.f64_oracle(x, w2d, b), cb.VS_F64)
    assert ok, err


@pytest.mark.parametrize("mode", ["parity", "full"])
def test_tap_windows_read_the_strided_columns(mode):
    """Tap dx's window of 8 slots holds input column 2x' + dx - 1 at slot x',
    and zeros where that column is -1: the stride-2 subsampling and the
    padding column are the windows' starts, in both modes."""
    n = TILE
    col = torch.arange(16, dtype=torch.float32) + 1.0   # column c holds c + 1
    x = col.reshape(1, 1, 16, 1).expand(cb.CIN, 16, 16, n).contiguous()
    stage = (parity_stages(*cb.split_parity(x)) if mode == "parity" else full_stages(x))(3, 1, 0)
    assert stage.shape == (17, CHUNK, TILE)
    assert torch.equal(stage[ZERO_SLOT], torch.zeros(CHUNK, TILE))
    for dx in range(3):
        window = stage[DX_SLOT[dx]:DX_SLOT[dx] + 8]
        for xo in range(8):
            c = 2 * xo + dx - 1
            assert torch.equal(window[xo], torch.full((CHUNK, TILE), float(c + 1 if c >= 0 else 0)))


def _swizzled(slot, ci, f):
    """The kernel's slot_offset: byte of (slot, channel, frame), 32B swizzle."""
    off = slot * CHUNK * TILE * 2 + ci * 32 + f * 2
    return off ^ (((off >> 7) & 1) << 4)


def test_stage_offsets_are_a_32b_swizzle():
    """The loaders' byte offsets cover a stage's 17 slots once each, keep each
    channel row of 16 frames inside its own 32 bytes and each 8-frame half
    in one 16-byte copy, and swap the halves of rows 4..7 of every 8."""
    offs = np.array([[[_swizzled(s, ci, f) for f in range(TILE)] for ci in range(CHUNK)]
                     for s in range(17)])
    assert sorted(offs.ravel().tolist()) == list(range(0, 17 * CHUNK * TILE * 2, 2))
    rows = offs // 32
    assert (rows == np.arange(17)[:, None, None] * CHUNK + np.arange(CHUNK)[None, :, None]).all()
    halves = (offs % 32) // 16
    swapped = (np.arange(CHUNK) // 4) % 2
    assert (halves[:, :, :8] == swapped[None, :, None]).all()
    assert (halves[:, :, 8:] == 1 - swapped[None, :, None]).all()


def test_epilogue_lanes_write_the_tile_once():
    """The wgmma accumulator layout (element 4j + 2h + e of lane l in warp w
    is row 16w + l / 4 + 8h, column 8j + 2(l % 4) + e), the 4 x 4 quad
    transpose and the 16-byte store of 8 frames: over the 128 lanes of a
    warpgroup each (row, x', frame) of the 64 x 8 x 16 tile is written once,
    with the value the accumulators hold for it."""
    acc = {}  # (warp, lane, index) -> (row, column)
    for warp in range(4):
        for lane in range(32):
            for j in range(16):
                for h in range(2):
                    for e in range(2):
                        acc[warp, lane, 4 * j + 2 * h + e] = (
                            16 * warp + lane // 4 + 8 * h, 8 * j + 2 * (lane % 4) + e)
    written = {}
    for warp in range(4):
        for lane in range(32):
            t, quad = lane % 4, lane - lane % 4
            for h in range(2):
                for g in range(4):
                    # before: lane's word k holds column j = 4g + k, frames 2t, 2t + 1;
                    # after the transpose word i is lane (quad + i)'s word t
                    row = 16 * warp + lane // 4 + 8 * h
                    xo, f_first = 2 * g + t // 2, (t % 2) * 8
                    for i in range(4):
                        for e in range(2):
                            src = acc[warp, quad + i, 4 * (4 * g + t) + 2 * h + e]
                            key = (row, xo, f_first + 2 * i + e)
                            assert key not in written
                            written[key] = src
    assert len(written) == 64 * 8 * 16
    for (row, xo, f), (src_row, src_col) in written.items():
        assert (src_row, src_col // 16, src_col % 16) == (row, xo, f)

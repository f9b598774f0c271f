"""Clip augmentations on the device, over a whole (B, T, H, W, C) batch.

Port of video_fingerprint_tpu/ops/device_augment.py (reference
dataset.py:246-353): the same transforms, probabilities, parameter ranges
and sampling granularity, applied to f32 clips in [0, 1] inside the train
step (the train CLI's --device_augment), so the host loader ships clips
augmented only by resize and JPEG recompression (data/dataset.py,
augment_mode="device").

  color p=.7 (brightness/contrast/saturation U[0.5,1.5], hue U[-0.1,0.1]),
  hflip p=.5, gaussian noise p=.3 (sigma U[0.02,0.1]), blur p=.5
  (k in {3,5,7}, cv2's small-gaussian taps), letterbox p=.3 (bar 5-15px,
  per frame), white overlay p=.2 (alpha .3, per-frame box), rotation p=.2
  (+-5 deg bilinear, per-frame angle).

The gates and the color / noise / blur parameters are one draw per clip;
the letterbox bar and orientation, the overlay box and the rotation angle
one draw per frame, (B, T)-shaped.

Drawing is split from applying: `sample_params` draws from an explicit
torch.Generator (on the card in the trainer), `apply_augmentations` takes
the parameters and the Gaussian noise as tensors, so a test can feed in the
JAX package's draws. Every transform is computed for the whole batch and
blended per clip by its gate. Rotation samples the four bilinear taps by
index (the JAX package spells the same sum as a stencil of shifted slices,
whose extra taps are exact zeros).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch

Params = Dict[str, torch.Tensor]

# cv2.GaussianBlur(sigma=0) with ksize <= 7 uses OpenCV's fixed
# small-gaussian tables, not the computed gaussian
_BLUR_KS = (3, 5, 7)
_CV2_SMALL_GAUSSIAN = {
    0: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}
MAX_ANGLE_DEG = 5.0


def _gauss_kernel7(k: int) -> np.ndarray:
    """k-tap cv2 small-gaussian embedded centered in 7 taps (zeros outside)."""
    taps = np.zeros((7,), np.float32)
    g = np.asarray(_CV2_SMALL_GAUSSIAN[k], np.float32)
    r = (len(g) - 1) // 2
    taps[3 - r:3 + r + 1] = g
    return taps


def _kernel_table() -> np.ndarray:
    """(4, 7) float32, rows = [identity, k3, k5, k7]."""
    return np.stack([_gauss_kernel7(k) for k in (0, *_BLUR_KS)])


def sample_params(generator: torch.Generator, batch: int, frame_size: int,
                  num_frames: Optional[int] = None, device=None) -> Params:
    """Augmentation parameters on `device` (default: the generator's).
    Gates and color/noise/blur values are (B,)-shaped; letterbox bar and
    orientation, overlay box (oy, ox, oh, ow) and rotation angle are
    (B, T)-shaped when `num_frames` is given, else (B,) (one draw shared by
    a clip's frames). Gates are f32 in {0, 1}; integer parameters int64."""
    device = torch.device(device) if device is not None else generator.device
    fshape = (batch,) if num_frames is None else (batch, num_frames)

    def u(shape=(batch,), low=0.0, high=1.0):
        x = torch.rand(shape, generator=generator, device=device)
        return x if (low, high) == (0.0, 1.0) else low + (high - low) * x

    def randint(low, high, shape):
        """Uniform integers in [low, high); high may be a tensor."""
        span = (high - low) if torch.is_tensor(high) else torch.full(shape, high - low,
                                                                      device=device)
        x = torch.floor(u(shape) * span).to(torch.int64)
        return low + torch.minimum(x, span.to(torch.int64) - 1)

    gate = lambda p_off: (u() > p_off).to(torch.float32)  # noqa: E731
    do_color, do_flip, do_noise, do_blur = gate(0.3), gate(0.5), gate(0.7), gate(0.5)
    do_letterbox, do_overlay, do_rotation = gate(0.7), gate(0.8), gate(0.8)
    oh = randint(10, 21, fshape)
    ow = randint(30, 61, fshape)
    # the reference's randint(0, size - oh) includes its upper bound
    oy = randint(0, torch.clamp(frame_size - oh + 1, min=1), fshape)
    ox = randint(0, torch.clamp(frame_size - ow + 1, min=1), fshape)
    return {
        "do_color": do_color,
        "brightness": u(low=0.5, high=1.5),
        "contrast": u(low=0.5, high=1.5),
        "saturation": u(low=0.5, high=1.5),
        "hue_shift": u(low=-0.1, high=0.1),
        "do_flip": do_flip,
        # sigma 0 means no noise, as on the host path
        "noise_level": do_noise * u(low=0.02, high=0.1),
        # 0 = the identity row of the kernel table, 1..3 = k 3/5/7
        "blur_idx": torch.where(do_blur > 0, 1 + randint(0, 3, (batch,)), 0),
        "do_letterbox": do_letterbox,
        "letterbox_bar": randint(5, 16, fshape),
        "letterbox_vertical": (u(fshape) > 0.5).to(torch.float32),
        "do_overlay": do_overlay,
        "overlay_box": torch.stack([oy, ox, oh, ow], dim=-1),  # (B[, T], 4)
        "do_rotation": do_rotation,
        "rotation_angle": do_rotation.reshape((batch,) + (1,) * (len(fshape) - 1))
        * u(fshape, low=-MAX_ANGLE_DEG, high=MAX_ANGLE_DEG),
    }


def _rgb_to_hsv(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> HSV with H in [0, 1)."""
    r, g, b = x.unbind(-1)
    mx = x.amax(dim=-1)
    mn = x.amin(dim=-1)
    d = mx - mn
    safe_d = torch.where(d > 0, d, 1.0)
    h = torch.where(mx == r, (g - b) / safe_d,
                    torch.where(mx == g, 2.0 + (b - r) / safe_d, 4.0 + (r - g) / safe_d))
    h = torch.where(d > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, 1.0), 0.0)
    return torch.stack([h, s, mx], dim=-1)


# per sector i = floor(6h) % 6, which of (v, p, q, t) each channel takes
_SECTOR_PICK = torch.tensor([[0, 3, 1], [2, 0, 1], [1, 0, 3],
                             [1, 2, 0], [3, 1, 0], [0, 1, 2]])


@functools.lru_cache(maxsize=None)
def _device_table(name: str, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A constant table copied to `device` once: a copy per call would be a
    host-to-device transfer, which stalls the host, in every train step."""
    host = _SECTOR_PICK if name == "sector_pick" else torch.from_numpy(_kernel_table())
    return host.to(device=device, dtype=dtype)


def _hsv_to_rgb(x: torch.Tensor) -> torch.Tensor:
    h, s, v = x.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    sector = torch.remainder(i.to(torch.int64), 6)
    pick = _device_table("sector_pick", x.device, torch.int64)[sector]  # (..., 3)
    return torch.gather(torch.stack([v, p, q, t], dim=-1), -1, pick)


def _color(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Hue rotate -> brightness -> contrast -> saturation blend, the host
    path's op order (data/augment.py); parameters broadcast per clip."""
    bshape = (-1,) + (1,) * (x.ndim - 1)
    hsv = _rgb_to_hsv(x)
    h = torch.remainder(hsv[..., 0] + p["hue_shift"].reshape(bshape[:-1]), 1.0)
    y = _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))
    y = y * p["brightness"].reshape(bshape)
    y = (y - 0.5) * p["contrast"].reshape(bshape) + 0.5
    yc = torch.clamp(y, 0.0, 1.0)
    gray = 0.299 * yc[..., 0] + 0.587 * yc[..., 1] + 0.114 * yc[..., 2]
    s = p["saturation"].reshape(bshape)
    y = s * y + (1 - s) * gray[..., None]
    y = torch.clamp(y, 0.0, 1.0)
    return torch.where(p["do_color"].reshape(bshape) > 0, y, x)


def _reflect101(n: int, device) -> torch.Tensor:
    """Source indices of an axis of n padded by 3 on each side, reflected
    without repeating the edge (cv2 BORDER_DEFAULT)."""
    i = torch.arange(-3, n + 3, device=device).abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def _blur(x: torch.Tensor, blur_idx: torch.Tensor) -> torch.Tensor:
    """Separable 7-tap blur with one kernel row per clip (the identity row
    when off): 14 shifted multiply-adds, reflect-101 borders."""
    kb = _device_table("blur", x.device, x.dtype)[blur_idx]
    kb = kb.reshape((x.shape[0],) + (1,) * (x.ndim - 1) + (7,))

    def pass_axis(y, axis):
        n = y.shape[axis]
        yp = y.index_select(axis, _reflect101(n, y.device))
        acc = kb[..., 0] * yp.narrow(axis, 0, n)
        for d in range(1, 7):
            acc = acc + kb[..., d] * yp.narrow(axis, d, n)
        return acc

    y = pass_axis(x, x.ndim - 3)  # H
    return pass_axis(y, x.ndim - 2)  # W


def _rotate_bilinear(x: torch.Tensor, angle_deg: torch.Tensor) -> torch.Tensor:
    """Rotation about the frame center (W//2, H//2), bilinear, zero fill:
    cv2.warpAffine(getRotationMatrix2D(center, angle, 1.0)) semantics.
    x: (B, T, H, W, C); angle_deg (B,) or (B, T)."""
    B, T, H, W, C = x.shape
    cy, cx = H // 2, W // 2
    theta = angle_deg * (math.pi / 180.0)
    theta = theta.reshape(theta.shape + (1,) * (2 - theta.ndim)).expand(B, T)
    cos = torch.cos(theta)[..., None, None]
    sin = torch.sin(theta)[..., None, None]
    yy = torch.arange(H, dtype=x.dtype, device=x.device)[:, None]
    xx = torch.arange(W, dtype=x.dtype, device=x.device)[None, :]
    # source coordinates of each destination pixel (the inverse rotation)
    sx = cos * (xx - cx) - sin * (yy - cy) + cx
    sy = sin * (xx - cx) + cos * (yy - cy) + cy
    y0, x0 = torch.floor(sy), torch.floor(sx)
    flat = x.reshape(B * T, H * W, C)
    out = None
    # the four taps in the JAX stencil's order (dy, then dx, ascending)
    for dy in (0, 1):
        qy = y0 + dy
        wy = torch.clamp(1.0 - torch.abs(sy - qy), min=0.0)
        for dx in (0, 1):
            qx = x0 + dx
            wx = torch.clamp(1.0 - torch.abs(sx - qx), min=0.0)
            inside = (qy >= 0) & (qy <= H - 1) & (qx >= 0) & (qx <= W - 1)
            w = torch.where(inside, wy * wx, 0.0)
            src = (qy.clamp(0, H - 1) * W + qx.clamp(0, W - 1)).to(torch.int64)
            tap = torch.gather(flat, 1, src.reshape(B * T, H * W, 1).expand(-1, -1, C))
            term = w[..., None] * tap.reshape(B, T, H, W, C)
            out = term if out is None else out + term
    return out


def apply_augmentations(params: Params, clips: torch.Tensor,
                        noise: torch.Tensor) -> torch.Tensor:
    """Apply sampled params to (B, T, H, W, C) f32 clips in [0, 1], with
    `noise` a standard normal tensor of the clips' shape. Transform order:
    color, flip, noise, blur, [jpeg: host-only], letterbox, overlay,
    rotation (reference dataset.py:259-353)."""
    B, T, H, W, C = clips.shape
    g = lambda name: params[name].reshape((B, 1, 1, 1, 1))  # noqa: E731
    # frame-level broadcast: (B,) -> (B,1,1,1,1), (B,T) -> (B,T,1,1,1)
    fb = lambda p: p.reshape(p.shape + (1,) * (5 - p.ndim))  # noqa: E731

    x = _color(clips, params)
    x = torch.where(g("do_flip") > 0, x.flip(3), x)
    x = torch.clamp(x + noise * g("noise_level"), 0.0, 1.0)
    x = _blur(x, params["blur_idx"])

    # letterbox: vertical bars the rows (top and bottom), else the columns
    bar = fb(params["letterbox_bar"])
    rows = torch.arange(H, device=x.device).reshape((1, 1, H, 1, 1))
    cols = torch.arange(W, device=x.device).reshape((1, 1, 1, W, 1))
    row_bar = (rows < bar) | (rows >= H - bar)
    col_bar = (cols < bar) | (cols >= W - bar)
    vert = fb(params["letterbox_vertical"]) > 0
    barred = torch.where(vert, torch.where(row_bar, 0.0, x), torch.where(col_bar, 0.0, x))
    x = torch.where(g("do_letterbox") > 0, barred, x)

    # white overlay rectangle, alpha 0.3
    oy, ox, ohh, oww = (fb(params["overlay_box"][..., i]) for i in range(4))
    in_box = (rows >= oy) & (rows < oy + ohh) & (cols >= ox) & (cols < ox + oww)
    x = torch.where((g("do_overlay") * in_box) > 0, 0.7 * x + 0.3, x)

    rotated = _rotate_bilinear(x, params["rotation_angle"])
    return torch.where(g("do_rotation") > 0, rotated, x)


def draw(generator: torch.Generator, clips_shape, device=None) -> Dict:
    """One side's draws: per-frame params and the Gaussian noise."""
    B, T, H = clips_shape[0], clips_shape[1], clips_shape[2]
    device = torch.device(device) if device is not None else generator.device
    params = sample_params(generator, B, H, num_frames=T, device=device)
    noise = torch.randn(tuple(clips_shape), generator=generator, device=device)
    return {"params": params, "noise": noise}


def augment_clips(generator: torch.Generator, clips: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample params per frame and apply them; `mask` (B, T) re-zeroes
    padded frames afterwards (contrast, letterbox and overlay move zeros)."""
    d = draw(generator, clips.shape, clips.device)
    return apply_drawn(d, clips, mask)


def apply_drawn(drawn: Dict, clips: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`draw`'s output applied to clips, padded frames re-zeroed by `mask`."""
    out = apply_augmentations(drawn["params"], clips, drawn["noise"])
    if mask is not None:
        out = out * mask[:, :, None, None, None].to(out.dtype)
    return out

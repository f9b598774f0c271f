"""Augmentation pipeline and train-time resize, host side: a copy of
video_fingerprint_tpu/data/augment.py with cv2 imported inside the functions
that use it, so the port imports on a machine without OpenCV.

Same transforms, probabilities and parameter ranges as the reference
(dataset.py:197-244, :246-353), with one deliberate change: every draw comes
from an explicit np.random.Generator, so the pipeline is reproducible
(the reference uses unseeded global RNGs everywhere).

Sampling granularity matches the reference exactly: the eight gates and the
color / noise-sigma / blur-kernel / JPEG-quality parameters are drawn once
per clip (dataset.py:250-266, before the frame loop), while the letterbox
bar size AND orientation (dataset.py:319-320), the overlay rectangle
(dataset.py:328-331) and the rotation angle (dataset.py:344) are drawn
fresh INSIDE the per-frame loop — frames of one clip get different bars,
boxes and angles. The resize/crop path also samples per frame
(dataset.py:438 calls _resize_frame per frame).

JPEG recompression stays host-side (it's a codec); everything else is cheap
numpy/cv2 on uint8.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from video_fingerprint_tpu_torch.data.preprocess import resize_short_side_center_crop

_RESOLUTIONS = [(480, 640), (720, 1280), (1080, 1920), (360, 640)]


def train_resize_frame(
    frame: np.ndarray,
    size: int,
    rng: np.random.Generator,
    apply_resolution_change: bool = True,
    augment: bool = True,
) -> np.ndarray:
    """Random resolution degradation (p=.5) + random crop ratio [.8,1] (p=.7)
    + aspect-preserving resize/center-crop (reference dataset.py:197-244)."""
    import cv2

    h, w = frame.shape[:2]

    if apply_resolution_change and augment and rng.random() > 0.5:
        target_h, target_w = _RESOLUTIONS[rng.integers(len(_RESOLUTIONS))]
        if h > target_h or w > target_w:
            scale = min(target_h / h, target_w / w)
            new_h, new_w = int(h * scale), int(w * scale)
            frame = cv2.resize(frame, (new_w, new_h), interpolation=cv2.INTER_AREA)
            h, w = new_h, new_w

    if augment and rng.random() > 0.3:
        crop_ratio = rng.uniform(0.8, 1.0)
        crop_h, crop_w = int(h * crop_ratio), int(w * crop_ratio)
        start_h = rng.integers(0, h - crop_h + 1)
        start_w = rng.integers(0, w - crop_w + 1)
        frame = frame[start_h : start_h + crop_h, start_w : start_w + crop_w]

    return resize_short_side_center_crop(frame, size)


@dataclasses.dataclass
class ClipAugmentParams:
    """One draw of the CLIP-level augmentation parameters (gates + color /
    noise / blur / JPEG values). Letterbox bar+orientation, overlay box and
    rotation angle are drawn per FRAME inside apply_augmentations (reference
    dataset.py:319-320, :328-331, :344); the Optional fields below pin them
    to a fixed value for all frames — a test/debug hook, never sampled."""

    brightness: float = 1.0
    contrast: float = 1.0
    saturation: float = 1.0
    hue_shift: float = 0.0
    do_color: bool = False
    do_flip: bool = False
    noise_level: float = 0.0
    jpeg_quality: int = 100
    do_compression: bool = False
    blur_kernel: int = 0
    do_letterbox: bool = False
    letterbox_bar: Optional[int] = None
    letterbox_vertical: Optional[bool] = None
    do_overlay: bool = False
    overlay_box: Optional[tuple] = None  # y, x, h, w
    do_rotation: bool = False
    rotation_angle: Optional[float] = None

    @staticmethod
    def sample(rng: np.random.Generator, frame_size: int) -> "ClipAugmentParams":
        p = ClipAugmentParams()
        p.do_color = rng.random() > 0.3
        p.do_flip = rng.random() > 0.5
        do_noise = rng.random() > 0.7
        p.do_compression = rng.random() > 0.5
        do_blur = rng.random() > 0.5
        p.do_letterbox = rng.random() > 0.7
        p.do_overlay = rng.random() > 0.8
        p.do_rotation = rng.random() > 0.8

        if p.do_color:
            p.brightness = rng.uniform(0.5, 1.5)
            p.contrast = rng.uniform(0.5, 1.5)
            p.saturation = rng.uniform(0.5, 1.5)
            p.hue_shift = rng.uniform(-0.1, 0.1)
        p.noise_level = rng.uniform(0.02, 0.1) if do_noise else 0.0
        p.jpeg_quality = int(rng.integers(30, 91)) if p.do_compression else 100
        p.blur_kernel = int([3, 5, 7][rng.integers(3)]) if do_blur else 0
        return p


def apply_jpeg_only(
    frames: List[np.ndarray], rng: np.random.Generator
) -> List[np.ndarray]:
    """The host-side subset for device-augment mode (ops/device_augment.py):
    JPEG recompression is a codec and cannot move on-device; everything else
    runs inside the train step. Same p=.5 gate and quality range as the full
    pipeline (reference dataset.py:257, :313-319)."""
    p = ClipAugmentParams()
    p.do_compression = rng.random() > 0.5
    if p.do_compression:
        p.jpeg_quality = int(rng.integers(30, 91))
    return apply_augmentations(frames, rng, 0, params=p)


def apply_augmentations(
    frames: List[np.ndarray],
    rng: np.random.Generator,
    frame_size: int,
    params: Optional[ClipAugmentParams] = None,
) -> List[np.ndarray]:
    """Apply clip-level params to all frames, drawing the letterbox bar +
    orientation, overlay box and rotation angle per FRAME like the reference
    (dataset.py:246-353; per-frame draws at :319-320, :328-331, :344)."""
    import cv2

    p = params or ClipAugmentParams.sample(rng, frame_size)
    out = []
    for frame in frames:
        f = frame.copy()

        if p.do_color:
            x = f.astype(np.float32) / 255.0
            hsv = cv2.cvtColor((x * 255).astype(np.uint8), cv2.COLOR_RGB2HSV).astype(
                np.float32
            )
            hsv[:, :, 0] = (hsv[:, :, 0] + p.hue_shift * 180) % 180
            x = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB).astype(
                np.float32
            ) / 255.0
            x = x * p.brightness
            x = (x - 0.5) * p.contrast + 0.5
            # clip before the uint8 cast: brightness/contrast push values
            # outside [0,1] and an unclipped cast wraps modulo 256, feeding
            # garbage into the saturation blend below
            gray = cv2.cvtColor(
                (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY
            )
            gray = cv2.cvtColor(gray, cv2.COLOR_GRAY2RGB).astype(np.float32) / 255.0
            x = p.saturation * x + (1 - p.saturation) * gray
            f = np.clip(x * 255, 0, 255).astype(np.uint8)

        if p.do_flip:
            f = cv2.flip(f, 1)

        if p.noise_level > 0:
            noise = rng.standard_normal(f.shape) * p.noise_level * 255
            f = np.clip(f.astype(np.float32) + noise, 0, 255).astype(np.uint8)

        if p.blur_kernel:
            f = cv2.GaussianBlur(f, (p.blur_kernel, p.blur_kernel), 0)

        if p.do_compression:
            ok, enc = cv2.imencode(
                ".jpg",
                cv2.cvtColor(f, cv2.COLOR_RGB2BGR),
                [int(cv2.IMWRITE_JPEG_QUALITY), p.jpeg_quality],
            )
            if ok:
                f = cv2.cvtColor(cv2.imdecode(enc, 1), cv2.COLOR_BGR2RGB)

        if p.do_letterbox:
            # per-frame bar size AND orientation (reference dataset.py:319-320)
            b = (int(rng.integers(5, 16)) if p.letterbox_bar is None
                 else p.letterbox_bar)
            vertical = (rng.random() > 0.5 if p.letterbox_vertical is None
                        else p.letterbox_vertical)
            if vertical:
                f[:b, :] = 0
                f[-b:, :] = 0
            else:
                f[:, :b] = 0
                f[:, -b:] = 0

        if p.do_overlay:
            if p.overlay_box is None:
                # per-frame rectangle (reference dataset.py:328-331;
                # randint is inclusive on both ends)
                oh = int(rng.integers(10, 21))
                ow = int(rng.integers(30, 61))
                oy = int(rng.integers(0, max(1, frame_size - oh + 1)))
                ox = int(rng.integers(0, max(1, frame_size - ow + 1)))
            else:
                oy, ox, oh, ow = p.overlay_box
            region = f[oy : oy + oh, ox : ox + ow].astype(np.float32)
            f[oy : oy + oh, ox : ox + ow] = (
                0.7 * region + 0.3 * 255.0
            ).astype(np.uint8)

        if p.do_rotation:
            # per-frame angle (reference dataset.py:344)
            angle = (rng.uniform(-5, 5) if p.rotation_angle is None
                     else p.rotation_angle)
            center = (f.shape[1] // 2, f.shape[0] // 2)
            M = cv2.getRotationMatrix2D(center, angle, 1.0)
            f = cv2.warpAffine(f, M, (f.shape[1], f.shape[0]))

        out.append(f)
    return out

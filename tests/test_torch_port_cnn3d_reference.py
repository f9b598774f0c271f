"""The port's 3D scan path at the published widths against the benchmark's
plain float32 reference (benchmark/reference/models.py: plain torch, BatchNorm
unfused, every window at its own length, TF32 off), on seeded weights whose
BatchNorm statistics were measured on seeded clips.

The port's path is the scan CLI's: `FingerprintScanner` from a reference
`.pth` with BatchNorm folded, `embed_clips` over every window in one call,
then `reduce_windows` per video. At batch 2 the windows of 10, 33, 96 and
128 frames fall into the stride buckets 32, 64, 96 and 128, and every
bucket ends in a partial batch."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness.traffic import calibration_clips
from benchmark.reference import models, weights
from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner, reduce_windows

CPU = torch.device("cpu")
CONFIG = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs"
                     / "cnn3d-ref-full.json").read_text())
# The largest elementwise difference of the unit embeddings. The float32
# scanner differs from the reference only by the rounding of the folded
# BatchNorm and the convs' summation order: 3.2e-7 at most when this was
# written, 30 times below. bfloat16 keeps 8 bits of mantissa, which puts
# its embeddings 1.5e-3 to 3.1e-3 away, 150 times above: a scanner that
# computed in bfloat16 where float32 is asked for fails.
TOLERANCE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model_and_videos(tmp_path_factory):
    """A seeded `.pth` at the published widths, four videos (a long one of
    three 128-frame windows) and their reference embeddings."""
    sd = weights.seeded_state_dict(CONFIG, torch.Generator().manual_seed(11))
    clips = calibration_clips(CONFIG, 12, CPU, clips=6).numpy()
    weights.calibrate(sd, CONFIG, calibration_clips(CONFIG, 11, CPU, clips=4),
                      [torch.from_numpy(clips[0][:40]), torch.from_numpy(clips[1])])
    path = tmp_path_factory.mktemp("cnn3d") / "model.pth"
    weights.save_pth(sd, CONFIG, path)
    videos = {"v10": [clips[0][:10]], "v33": [clips[1][:33]], "v96": [clips[2][:96]],
              "v128x3": [clips[3], clips[4], clips[5]]}
    with torch.no_grad(), models.exact_float32():
        reference = {name: models.mean_of_windows(models.cnn3d_forward(
            torch.from_numpy(np.stack(windows)), sd, CONFIG["frame_stride"])).numpy()
            for name, windows in videos.items()}
    return str(path), videos, reference


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_3d_scan_path_matches_the_plain_reference(model_and_videos, precision):
    path, videos, reference = model_and_videos
    scanner = FingerprintScanner(path, device="cpu", batch_size=2,
                                 bf16=precision == "bfloat16", optimize=True)
    assert (scanner.clip_length, scanner.frame_stride) == (128, 32)
    assert sorted({scanner._3d_bucket(w.shape[0]) for v in videos.values() for w in v}) == [
        32, 64, 96, 128]
    windows = scanner.embed_clips(((name, i), w) for name, v in videos.items()
                                  for i, w in enumerate(v))
    assert len(windows) == 6
    ref = np.stack([reference[name] for name in videos]).astype(np.float64)
    cosines = ref @ ref.T
    np.fill_diagonal(cosines, -1.0)
    assert cosines.max() < 0.99  # the seeded weights keep distinct videos apart
    got = np.stack([reduce_windows([windows[(name, i)] for i in range(len(v))], len(v))
                    for name, v in videos.items()]).astype(np.float64)
    gap = float(np.max(np.abs(got - ref)))
    if precision == "float32":
        assert gap <= TOLERANCE
    else:
        assert gap > TOLERANCE

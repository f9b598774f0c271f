"""The port's per-core decode tool (video_fingerprint_tpu_torch/tools/
bench_decode_percore.py) on a tiny synthetic corpus: the JAX tool's JSON
keys, the frames each pass decodes, and where the native decoder is off,
its build error instead of a native rate."""

import json

import pytest

from video_fingerprint_tpu_torch.tools import bench_decode_percore as bd
from video_fingerprint_tpu_torch.utils import native_decode

JAX_KEYS = {"metric", "unit", "videos", "source_frames", "decoded_frames_per_video", "size",
            "cv2_fps", "native_fps", "native_over_cv2"}
ARGS = ["--videos", "2", "--frames", "30", "--max-frames", "8", "--reps", "1"]


def test_decode_percore_keys_and_frames(tmp_path, capsys):
    result = bd.run(bd.parse_args(ARGS + ["--out", str(tmp_path)]))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result
    assert JAX_KEYS <= set(result)
    assert result["unit"] == "frames/sec/core" and result["videos"] == 2
    assert result["frames_per_pass"] == 2 * 8  # 30 frames subsampled to 8 per video
    assert result["cv2_fps"] > 0
    assert len(list(tmp_path.glob("*.mp4"))) == 2
    if native_decode.available():
        assert result["native_fps"] > 0
        assert result["native_over_cv2"] == pytest.approx(result["native_fps"]
                                                          / result["cv2_fps"])
    else:
        assert result["native_fps"] is None and result["native_error"]


def test_decode_percore_without_native(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(native_decode, "available", lambda: False)
    monkeypatch.setattr(native_decode.LIBRARY, "error", "g++: libavformat/avformat.h missing")
    result = bd.run(bd.parse_args(ARGS + ["--out", str(tmp_path)]))
    assert result["native_fps"] is None and result["native_over_cv2"] is None
    assert "avformat" in result["native_error"]
    assert result["cv2_fps"] > 0 and result["frames_per_pass"] == 16

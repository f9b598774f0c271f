"""The port's trajectory corpus tool (video_fingerprint_tpu_torch/tools/
make_trajectory_corpus.py) against the JAX tool, on the CPU: with
--videos 6 --min-frames 8 --max-frames 12, plain and --hard, both write the
same file names and the same `.complete` stamp, and every decoded frame is
equal; a directory stamped with other parameters is refused, and one with
the same stamp is left as it is."""

import sys

import cv2
import numpy as np
import pytest

from tools import make_trajectory_corpus as jax_tool
from video_fingerprint_tpu_torch.tools import make_trajectory_corpus as port_tool

ARGS = ["--videos", "6", "--min-frames", "8", "--max-frames", "12"]


def _frames(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


@pytest.mark.parametrize("hard", [False, True], ids=["plain", "hard"])
def test_corpus_equals_the_jax_tools(tmp_path, monkeypatch, hard):
    extra = ["--hard"] if hard else []
    ours, ref = tmp_path / "port", tmp_path / "jax"
    assert port_tool.main(ARGS + extra + ["--out", str(ours)]) == 0
    monkeypatch.setattr(sys, "argv", ["make_trajectory_corpus.py", *ARGS, *extra,
                                      "--out", str(ref)])
    jax_tool.main()
    names = sorted(p.name for p in ours.iterdir())
    assert names == sorted(p.name for p in ref.iterdir())
    assert len(names) == 7  # six videos and the stamp
    assert (ours / ".complete").read_text() == (ref / ".complete").read_text()
    assert (ours / ".complete").read_text().endswith(":hard4x0.25") == hard
    for name in names[1:]:
        a, b = _frames(ours / name), _frames(ref / name)
        assert 8 <= len(a) <= 12 and np.array_equal(a, b), name


def test_other_stamp_is_refused(tmp_path, capsys):
    out = ["--out", str(tmp_path)]
    assert port_tool.main(ARGS + out) == 0
    assert port_tool.main(ARGS + out) == 0  # the same stamp: already complete
    assert "already complete" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="different parameters"):
        port_tool.main(ARGS + ["--hard"] + out)
    with pytest.raises(SystemExit, match="different parameters"):
        port_tool.main(["--videos", "5", "--min-frames", "8", "--max-frames", "12"] + out)

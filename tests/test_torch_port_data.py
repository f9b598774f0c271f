"""The port's copy of the training data pipeline (data/dataset.py,
augment.py, pairs.py, decode.py) gives the JAX pipeline's arrays bit for bit
for the same seed and epoch, for both model types, on a seeded synthetic mp4
corpus; decode_subsampled(skip_rate=) and black_fallback_frames equal JAX's."""

import numpy as np
import pytest

from video_fingerprint_tpu.data import dataset as jds
from video_fingerprint_tpu.data import decode as jdecode
from video_fingerprint_tpu_torch.data import dataset as tds
from video_fingerprint_tpu_torch.data import decode as tdecode
from video_fingerprint_tpu_torch.utils.synthetic import make_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    make_corpus(root, num_unique=4, num_frames=40, duplicates=1)
    return root


def _batches(module, root, mode, model_type, epoch):
    loader = module.create_dataloader(root, batch_size=2, num_workers=0, frame_size=32,
                                      max_frames=24, clip_length=16, frame_stride=4,
                                      mode=mode, model_type=model_type, seed=7)
    loader.set_epoch(epoch)
    return list(loader)


@pytest.mark.parametrize("model_type", ["attention", "3d"])
@pytest.mark.parametrize("mode", ["train", "val"])
def test_batches_equal_jax(corpus, model_type, mode):
    for epoch in (0, 1):
        ref = _batches(jds, corpus, mode, model_type, epoch)
        ours = _batches(tds, corpus, mode, model_type, epoch)
        assert len(ours) == len(ref) > 0
        for a, b in zip(ours, ref):
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{epoch} {key}")


def test_decode_subsampled_skip_rate(corpus):
    path = corpus / "video_0.mp4"
    for skip in (None, 1, 3):
        ours = tdecode.decode_subsampled(path, 10, skip_rate=skip)
        ref = jdecode.decode_subsampled(path, 10, skip_rate=skip)
        assert len(ours) == len(ref) == 10
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    assert tdecode.decode_subsampled(corpus / "missing.mp4", 10, skip_rate=2) == []


def test_black_fallback_frames():
    ours, ref = tdecode.black_fallback_frames(30), jdecode.black_fallback_frames(30)
    assert len(ours) == len(ref) == 30
    assert all(a.shape == b.shape == (480, 640, 3) and a.dtype == b.dtype == np.uint8
               and not a.any() for a, b in zip(ours, ref))


def test_native_decode_says_unavailable(corpus, capsys, monkeypatch):
    """Without the native decoder (no g++ or libav) the loader says so, as
    the JAX package's does, and decodes with cv2."""
    from video_fingerprint_tpu_torch.utils import native_decode

    monkeypatch.setattr(native_decode, "available", lambda: False)
    ds = tds.VideoFingerprintDataset(corpus, augment=False, mode="val",
                                     decode_backend="native")
    assert "native decode requested but unavailable; using cv2" in capsys.readouterr().out
    assert not ds._use_native

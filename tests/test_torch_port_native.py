"""The port's native preprocessing bindings (video_fingerprint_tpu_torch/
utils/native.py) against the JAX package's (video_fingerprint_tpu/utils/
native.py): the same source and flags, so the outputs are equal byte for
byte; the port's library lands under build/, never in native/; and the
port's scanner with native_preprocess (float32 staging) equals the JAX
scanner with the same flag (max abs 1e-4, cosine 0.9999). Skipped where g++
cannot build the library, as the JAX package's tests are."""

import numpy as np
import pytest

from video_fingerprint_tpu.utils import native as jax_native
from video_fingerprint_tpu_torch.ops import _build
from video_fingerprint_tpu_torch.utils import native


@pytest.fixture(scope="module")
def lib():
    if not (native.available() and jax_native.available()):
        pytest.skip(f"native toolchain unavailable: {native.LIBRARY.error}")
    return native.LIBRARY.load()


@pytest.mark.parametrize("shape", [(4, 96, 150, 3), (3, 150, 96, 3), (2, 40, 50, 3)],
                         ids=["landscape_down", "portrait_down", "upscale"])
def test_preprocess_frames_equals_jax(lib, shape):
    frames = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    ours = native.preprocess_frames(frames, 64)
    ref = jax_native.preprocess_frames(frames, 64)
    assert ours.shape == ref.shape == (shape[0], 64, 64, 3) and ours.dtype == np.float32
    assert ours.tobytes() == ref.tobytes()


def test_fill_batch_row_equals_jax(lib):
    rng = np.random.default_rng(2)
    clip = rng.random((5, 8, 8, 3)).astype(np.float32)
    ours = np.full((2, 9, 8, 8, 3), -1.0, np.float32)
    ref = ours.copy()
    native.fill_batch_row(clip, ours, row=1)
    jax_native.fill_batch_row(clip, ref, row=1)
    assert ours.tobytes() == ref.tobytes()
    np.testing.assert_array_equal(ours[1, 5:], 0.0)
    np.testing.assert_array_equal(ours[0], -1.0)
    with pytest.raises(ValueError):
        native.fill_batch_row(clip, ours, row=2)


def test_library_lands_under_build(lib):
    path = _build.library_path(_build.host_recipe("vfp_host", native.FLAGS))
    assert lib._name == str(path) and path.exists()
    assert path.parent == _build.REPO_ROOT / "build" / "vfp_torch_native"
    assert _build.NATIVE_SRC not in path.parents


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    """A narrow attention model's checkpoint, written by the JAX package."""
    import jax
    import jax.numpy as jnp

    from video_fingerprint_tpu.models import create_model as jax_create_model
    from video_fingerprint_tpu.training.checkpoint import save_checkpoint

    dims = dict(spatial_dim=32, temporal_dim=64, num_attention_blocks=1)
    v = jax_create_model("attention", **dims).init(jax.random.PRNGKey(4),
                                                   jnp.zeros((1, 4, 64, 64, 3)))
    path = tmp_path_factory.mktemp("native_ckpt") / "m.ckpt"
    save_checkpoint(path, v["params"], v["batch_stats"],
                    {"model_type": "attention", "frame_size": 64, "max_frames": 64,
                     "embedding_dim": 256, **dims})
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from video_fingerprint_tpu_torch.utils.synthetic import make_corpus

    root = tmp_path_factory.mktemp("native_videos")
    make_corpus(root, num_unique=3, num_frames=30, duplicates=1)
    return root


def test_scanner_native_preprocess_equals_jax(lib, small_ckpt, corpus):
    from video_fingerprint_tpu.inference.scanner import FingerprintScanner as JaxScanner
    from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner

    ours = FingerprintScanner(small_ckpt, device="cpu", batch_size=2, buckets=(32,),
                              native_preprocess=True)
    assert ours.native_preprocess and ours.stage_dtype == np.float32
    ref = JaxScanner(small_ckpt, device="cpu", batch_size=2, buckets=(32,),
                     native_preprocess=True).scan_directory(corpus, num_workers=2)
    got = ours.scan_directory(corpus, num_workers=2)
    assert set(got) == set(ref) and len(got) == 4
    for path in got:
        a, b = got[path]["embedding"], np.asarray(ref[path]["embedding"])
        assert np.abs(a - b).max() <= 1e-4, path
        assert float(np.dot(a, b)) >= 0.9999, path
    # float32 staging: the same dtype in the warmup, and uint8 refused
    ours.warmup(20)
    with pytest.raises(ValueError, match="float32"):
        ours.embed_clips([("x", np.zeros((12, 64, 64, 3), np.uint8))])


def test_scanner_says_preprocess_unavailable(small_ckpt, monkeypatch, capsys):
    from video_fingerprint_tpu_torch.inference import scanner as sc

    monkeypatch.setattr(sc.native, "available", lambda: False)
    s = sc.FingerprintScanner(small_ckpt, device="cpu", native_preprocess=True)
    assert "native preprocess requested but unavailable; using cv2" in capsys.readouterr().out
    assert not s.native_preprocess and s.stage_dtype == np.uint8

"""The port's native decode bindings (video_fingerprint_tpu_torch/utils/
native_decode.py) against the JAX package's: probe, decode_scan and
decode_clip equal byte for byte (the same source, flags and libav); the
library lands under build/; the eval loader with decode_backend="native"
gives the JAX loader's batches and train mode ignores the native backend;
the port's scanners (attention and 3D) with native_decode equal the JAX
scanners with the same flag (max abs 1e-4, cosine 0.9999); the scan CLI
runs --native_decode and --native_preprocess on the CPU and gives the JAX
CLI's groups. Skipped where g++ or libav cannot build the library, as the
JAX package's tests are."""

import json

import numpy as np
import pytest

from video_fingerprint_tpu.utils import native_decode as jax_nd
from video_fingerprint_tpu_torch.ops import _build
from video_fingerprint_tpu_torch.utils import native_decode as nd


@pytest.fixture(scope="module")
def lib():
    if not (nd.available() and jax_nd.available()):
        pytest.skip(f"libav toolchain unavailable: {nd.LIBRARY.error}")
    return nd.LIBRARY.load()


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    from video_fingerprint_tpu_torch.utils.synthetic import synthetic_frames, write_video

    p = tmp_path_factory.mktemp("nd") / "v.mp4"
    write_video(p, synthetic_frames(3, 50, height=96, width=150))
    return p


def test_probe_equals_jax(lib, video, tmp_path):
    assert nd.probe(video) == jax_nd.probe(video)
    assert nd.probe(video)[0] == 50
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"junk" * 100)
    assert nd.probe(bad) is None and nd.decode_scan(bad, 10, 64) is None


@pytest.mark.parametrize("max_frames,skip", [(40, None), (100, 1), (100, 5)])
def test_decode_scan_equals_jax(lib, video, max_frames, skip):
    ours = nd.decode_scan(video, max_frames, 64, skip_rate=skip)
    ref = jax_nd.decode_scan(video, max_frames, 64, skip_rate=skip)
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    assert ours.tobytes() == ref.tobytes()


def test_decode_scan_close_to_cv2(lib, video):
    """The JAX package's gate against the cv2 path: mean |diff| < 3 (same
    codec; swscale against cv2 rounding)."""
    from video_fingerprint_tpu_torch.data import decode, preprocess

    ours = nd.decode_scan(video, 40, 64)
    ref = preprocess.preprocess_frames(decode.decode_subsampled(video, 40), 64,
                                       normalize=False)
    assert ours.shape == ref.shape
    assert np.abs(ours.astype(np.int16) - ref.astype(np.int16)).mean() < 3.0


@pytest.mark.parametrize("start,count", [(10, 16), (45, 16)], ids=["inside", "past_end"])
def test_decode_clip_equals_jax(lib, video, start, count):
    ours = nd.decode_clip(video, start, count, 64)
    ref = jax_nd.decode_clip(video, start, count, 64)
    assert ours.shape == (count, 64, 64, 3) and ours.tobytes() == ref.tobytes()
    if start + count > 50:  # a short read repeats its last frame
        np.testing.assert_array_equal(ours[-1], ours[50 - start - 1])


def test_library_lands_under_build(lib):
    path = _build.library_path(_build.host_recipe("vfp_decode", nd.FLAGS, nd.LIBS))
    assert lib._name == str(path) and path.exists()
    assert path.parent == _build.HOST_BUILD_DIR
    assert _build.NATIVE_SRC not in path.parents


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from video_fingerprint_tpu_torch.utils.synthetic import make_corpus

    root = tmp_path_factory.mktemp("nd_videos")
    make_corpus(root, num_unique=3, num_frames=40, duplicates=1)
    return root


def test_eval_loader_native_equals_jax(lib, corpus):
    from video_fingerprint_tpu.data import dataset as jds
    from video_fingerprint_tpu_torch.data import dataset as tds

    def batches(module):
        return list(module.create_dataloader(
            corpus, batch_size=2, num_workers=0, max_frames=32, mode="val",
            model_type="attention", seed=0, decode_backend="native"))

    ours, ref = batches(tds), batches(jds)
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_train_mode_ignores_native_backend(lib, corpus):
    from video_fingerprint_tpu_torch.data.dataset import VideoFingerprintDataset

    ds = VideoFingerprintDataset(corpus, mode="train", model_type="attention",
                                 decode_backend="native")
    assert not ds._use_native
    val = VideoFingerprintDataset(corpus, mode="val", augment=False, model_type="attention",
                                  decode_backend="native")
    assert val._use_native


def _checkpoint(tmp_path_factory, model_type):
    import jax
    import jax.numpy as jnp

    from video_fingerprint_tpu.models import create_model as jax_create_model
    from video_fingerprint_tpu.training.checkpoint import save_checkpoint

    if model_type == "attention":
        dims = dict(spatial_dim=32, temporal_dim=64, num_attention_blocks=1)
        config = {"max_frames": 64, **dims}
    else:
        dims = dict(frame_stride=4)
        config = {"clip_length": 16, "frame_stride": 4}
    v = jax_create_model(model_type, **dims).init(jax.random.PRNGKey(6),
                                                  jnp.zeros((1, 16, 64, 64, 3)))
    path = tmp_path_factory.mktemp(f"nd_ckpt_{model_type}") / "m.ckpt"
    save_checkpoint(path, v["params"], v["batch_stats"],
                    {"model_type": model_type, "frame_size": 64, "embedding_dim": 256,
                     **config})
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    return {m: _checkpoint(tmp_path_factory, m) for m in ("attention", "3d")}


@pytest.mark.parametrize("model_type", ["attention", "3d"])
def test_scanner_native_decode_equals_jax(lib, checkpoints, corpus, model_type):
    from video_fingerprint_tpu.inference.scanner import FingerprintScanner as JaxScanner
    from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner

    kw = dict(device="cpu", batch_size=2, native_decode=True)
    if model_type == "attention":
        kw["buckets"] = (32,)
    ours = FingerprintScanner(checkpoints[model_type], **kw)
    assert ours.native_decode and ours.stage_dtype == np.uint8
    got = ours.scan_directory(corpus, num_workers=2)
    ref = JaxScanner(checkpoints[model_type], **kw).scan_directory(corpus, num_workers=2)
    assert set(got) == set(ref) and len(got) == 4
    for path in got:
        a, b = got[path]["embedding"], np.asarray(ref[path]["embedding"])
        assert np.abs(a - b).max() <= 1e-4, path
        assert float(np.dot(a, b)) >= 0.9999, path


@pytest.mark.parametrize("flag", ["--native_decode", "--native_preprocess"])
def test_scan_cli_native_flags_match_jax_cli(lib, checkpoints, corpus, tmp_path, flag):
    from video_fingerprint_tpu.cli.scan import main as jax_main
    from video_fingerprint_tpu_torch.cli.scan import main

    args = ["--model", checkpoints["attention"], "--scan", str(corpus), "--threshold",
            "0.999999", "--workers", "2", "--batch", "2", "--device", "cpu", flag]
    assert main(args + ["--output", str(tmp_path / "port.json")]) == 0
    assert jax_main(args + ["--output", str(tmp_path / "jax.json")]) == 0
    ours = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "jax.json").read_text())
    groups = [sorted(sorted(i["path"] for i in g) for g in r["duplicate_groups"])
              for r in (ours, ref)]
    assert groups[0] == groups[1]
    pair = {str(corpus / "video_0.mp4"), str(corpus / "video_0_copy.mp4")}
    assert any(pair <= set(g) for g in groups[0])
    for path, fp in ours["fingerprints"].items():
        cos = float(np.dot(fp["embedding"], ref["fingerprints"][path]["embedding"]))
        assert cos >= 0.9999, path

"""The port's data-parallel scan (FingerprintScanner(data_parallel=...),
cli/scan.py --data_parallel) and the scanner's sharded duplicate search, on
the CPU with a device list of 8 CPU entries, against the port's
single-device scan and the JAX package's data-parallel scan over its
8-device CPU mesh (tests/test_scanner.py:371-393,
tests/test_scanner_3d.py:96-112), for both model families, on one JAX
checkpoint each at small widths (attention: spatial 16, temporal 32, one
block). Gates: cosine > 0.9999 per video, the batch padded to 8, the
single-video path still on one device, equal duplicate groups from the
sharded and the single-device top-k."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_fingerprint_tpu.inference.scanner import FingerprintScanner as JaxScanner
from video_fingerprint_tpu.models import create_model as jax_create_model
from video_fingerprint_tpu.training.checkpoint import save_checkpoint
from video_fingerprint_tpu.utils.synthetic import make_corpus, synthetic_frames, write_video
from video_fingerprint_tpu_torch.cli.scan import main as scan_main
from video_fingerprint_tpu_torch.inference import scanner as scanner_mod
from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner

EIGHT = ["cpu"] * 8
ATTN_CONFIG = {"model_type": "attention", "frame_size": 64, "max_frames": 500,
               "embedding_dim": 256, "spatial_dim": 16, "temporal_dim": 32,
               "num_attention_blocks": 1}
CONFIG_3D = {"model_type": "3d", "frame_size": 64, "clip_length": 16, "frame_stride": 4,
             "embedding_dim": 256}


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _checkpoint(path, config, model, example, seed):
    """A JAX checkpoint with random BN running statistics (distinct clips
    then embed apart)."""
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros(example))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.5, a.shape).astype(np.float32) ** 2 + 0.5,
        v["batch_stats"])
    save_checkpoint(path, v["params"], stats, config)
    return str(path)


@pytest.fixture(scope="module")
def attn_ckpt(tmp_path_factory):
    model = jax_create_model("attention", spatial_dim=16, temporal_dim=32,
                             num_attention_blocks=1)
    return _checkpoint(tmp_path_factory.mktemp("ckpt") / "m.ckpt", ATTN_CONFIG, model,
                       (1, 4, 64, 64, 3), 42)


@pytest.fixture(scope="module")
def ckpt_3d(tmp_path_factory):
    return _checkpoint(tmp_path_factory.mktemp("ckpt3d") / "m.ckpt", CONFIG_3D,
                       jax_create_model("3d", frame_stride=4), (1, 16, 64, 64, 3), 5)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("videos")
    make_corpus(d, num_unique=4, num_frames=40, duplicates=2)
    return d


@pytest.fixture(scope="module")
def corpus3d(tmp_path_factory):
    d = tmp_path_factory.mktemp("videos3d")
    for i in range(3):
        write_video(d / f"long_{i}.mp4", synthetic_frames(i, 80))
    write_video(d / "short.mp4", synthetic_frames(9, 12))
    return d


def _quiet(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        return fn(*args, **kwargs), out.getvalue()


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def _check_equal_scans(a, b):
    assert set(a) == set(b) and a
    for p in a:
        cos = _cos(a[p]["embedding"], b[p]["embedding"])
        assert cos > 0.9999, (p, cos)


@pytest.mark.parametrize("family", ["attention", "3d"])
def test_data_parallel_scan_equals_single_and_jax(family, attn_ckpt, ckpt_3d, corpus,
                                                  corpus3d):
    ckpt, videos = (attn_ckpt, corpus) if family == "attention" else (ckpt_3d, corpus3d)
    kw = {"buckets": (32, 64)} if family == "attention" else {}
    dp, log = _quiet(FingerprintScanner, ckpt, device="cpu", batch_size=4,
                     data_parallel=EIGHT, **kw)
    assert "Data-parallel extraction over 8 devices (batch 8)" in log
    assert dp.batch_size == 8 and len(dp._shards) == 8
    assert all(s.batch_size == 1 for s in dp._shards)
    single = _quiet(FingerprintScanner, ckpt, device="cpu", batch_size=4, **kw)[0]
    jax_dp = _quiet(JaxScanner, ckpt, device="cpu", batch_size=4, data_parallel=True, **kw)[0]
    assert jax_dp.mesh is not None and jax_dp.batch_size == 8
    ours = _quiet(dp.scan_directory, videos, num_workers=2)[0]
    _check_equal_scans(ours, _quiet(single.scan_directory, videos, num_workers=2)[0])
    _check_equal_scans(ours, _quiet(jax_dp.scan_directory, videos, num_workers=2)[0])
    # the single-video path stays on `device`
    path = sorted(videos.glob("*.mp4"))[1]
    one = dp.extract_fingerprint(path)
    assert _cos(one, ours[str(path)]["embedding"]) > 0.9999


def test_data_parallel_on_one_device_says_so(attn_ckpt, corpus, tmp_path):
    dp, log = _quiet(FingerprintScanner, attn_ckpt, device="cpu", batch_size=3,
                     data_parallel=True)
    assert "one device on the platform, running on cpu" in log
    assert dp.batch_size == 3 and len(dp._shards) == 1
    out = tmp_path / "r.json"
    rc, log = _quiet(scan_main, ["--model", attn_ckpt, "--scan", str(corpus), "--device",
                                 "cpu", "--batch", "4", "--data_parallel", "--workers", "2",
                                 "--threshold", "0.999999", "--output", str(out)])
    assert rc == 0 and out.exists()
    assert "one device on the platform" in log


def test_sharded_duplicate_search_equals_single(attn_ckpt, monkeypatch):
    """80 videos >= 8 x 8: the top-k duplicate search runs the ring over the
    8 devices (JAX scanner.py:775-780) and groups as the single-device
    search does; 63 videos stay on one device."""
    rng = np.random.default_rng(4)
    e = rng.normal(size=(80, 256)).astype(np.float32)
    e[40:50] = e[:10] + 0.01 * rng.normal(size=(10, 256)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    fps = {f"v{i:02d}": {"embedding": e[i], "path": f"v{i:02d}", "file_hash": str(i)}
           for i in range(80)}
    calls = []
    real = scanner_mod.sharded_topk_cosine
    monkeypatch.setattr(scanner_mod, "sharded_topk_cosine",
                        lambda *a, **k: calls.append(k["devices"]) or real(*a, **k))
    dp = _quiet(FingerprintScanner, attn_ckpt, device="cpu", data_parallel=EIGHT)[0]
    single = _quiet(FingerprintScanner, attn_ckpt, device="cpu")[0]

    def groups(scanner, fingerprints):
        found = _quiet(scanner.find_duplicates, fingerprints, 0.99, topk_threshold=10)[0]
        return sorted(sorted(item["path"] for item in g) for g in found)

    ours = groups(dp, fps)
    assert len(calls) == 1 and len(calls[0]) == 8
    assert ours == groups(single, fps) == [[f"v{i:02d}", f"v{i + 40:02d}"] for i in range(10)]
    few = {k: v for k, v in list(fps.items())[:63]}
    groups(dp, few)
    assert len(calls) == 1

"""The port's 3D scan against the JAX package's: checkpoints in both
formats, the window plan and its two averaging rules, batched against
sequential extraction, short videos, and the decode and preprocessing the
3D path uses. Small size: frame_stride 4, clip_length 16
(tests/test_scanner_3d.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import video_fingerprint_tpu.data.decode as jax_decode
import video_fingerprint_tpu.data.preprocess as jax_preprocess
import video_fingerprint_tpu_torch.data.decode as port_decode
import video_fingerprint_tpu_torch.data.preprocess as port_preprocess
from video_fingerprint_tpu.inference.scanner import FingerprintScanner as JaxScanner
from video_fingerprint_tpu.models import create_model as jax_create_model
from video_fingerprint_tpu.training.checkpoint import load_any as jax_load_any
from video_fingerprint_tpu.training.checkpoint import save_checkpoint
from video_fingerprint_tpu.utils.synthetic import synthetic_frames, write_video
from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner, reduce_windows
from video_fingerprint_tpu_torch.training.checkpoint import load_any
from video_fingerprint_tpu_torch.utils.torch_compat import variables_to_state_dict

CONFIG = {"model_type": "3d", "frame_size": 64, "clip_length": 16, "frame_stride": 4,
          "embedding_dim": 256}


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One 3D model as a JAX trainer `.ckpt` and as a reference `.pth`,
    with random BN running statistics."""
    v = jax_create_model("3d", frame_stride=4).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 16, 64, 64, 3)))
    rng = np.random.default_rng(8)
    stats = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.5, a.shape).astype(np.float32) ** 2 + 0.5,
        v["batch_stats"])
    d = tmp_path_factory.mktemp("ckpt3d")
    ckpt = d / "m.ckpt"
    save_checkpoint(ckpt, v["params"], stats, CONFIG)
    variables = jax.tree_util.tree_map(np.asarray, {"params": v["params"],
                                                    "batch_stats": stats})
    sd = variables_to_state_dict(variables, "3d")
    pth = d / "m.pth"
    torch.save({"model_state_dict": {k: torch.from_numpy(np.array(x)) for k, x in sd.items()},
                "config": CONFIG}, pth)
    return str(ckpt), str(pth), variables


@pytest.fixture(scope="module")
def corpus3d(tmp_path_factory):
    """Three 80-frame videos (multi-window at clip_length 16) and a short one."""
    d = tmp_path_factory.mktemp("videos3d")
    for i in range(3):
        write_video(d / f"long_{i}.mp4", synthetic_frames(i, 80))
    write_video(d / "short.mp4", synthetic_frames(9, 12))
    return d


@pytest.fixture(scope="module")
def scanner3d(checkpoints):
    return FingerprintScanner(checkpoints[0], device="cpu", batch_size=4)


def test_checkpoints_give_the_jax_embeddings_and_identity(checkpoints):
    """A 3D `.ckpt` and a 3D `.pth` load to the same arrays, and both give
    the JAX scanner's embeddings and model identity."""
    ckpt, pth, variables = checkpoints
    (from_ckpt, config), (ref, _) = load_any(ckpt), jax_load_any(ckpt)
    from_pth, pth_config = load_any(pth)
    assert config == pth_config == CONFIG
    a, b, c = _flat(from_ckpt), _flat(ref), _flat(from_pth)
    assert a.keys() == b.keys() == c.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], key)
        np.testing.assert_array_equal(c[key], b[key], key)

    rng = np.random.default_rng(2)
    clip = rng.random((14, 64, 64, 3), dtype=np.float32)
    jax_scanner = JaxScanner(ckpt, device="cpu", batch_size=1)
    expected = jax_scanner._embed_clip(clip)
    for path in (ckpt, pth):
        scanner = FingerprintScanner(path, device="cpu", batch_size=1)
        assert (scanner.clip_length, scanner.frame_stride) == (16, 4)
        with torch.inference_mode():
            ours = scanner.model(torch.from_numpy(clip)[None]).numpy()[0]
        assert _cos(ours, expected) >= 0.9999
        np.testing.assert_allclose(ours, expected, rtol=0, atol=1e-4)
        assert scanner.model_identity == jax_scanner.model_identity, path


def test_batched_equals_sequential(scanner3d, corpus3d):
    seq = scanner3d.scan_directory(corpus3d, num_workers=1, batched=False)
    bat = scanner3d.scan_directory(corpus3d, num_workers=2, batched=True)
    assert set(seq) == set(bat) and len(seq) == 4
    for path in seq:
        assert _cos(seq[path]["embedding"], bat[path]["embedding"]) > 0.9999, path
        assert bat[path]["embedding_norm"] == pytest.approx(1.0, abs=1e-5)


def test_scan_matches_jax_scanner(checkpoints, scanner3d, corpus3d):
    ours = scanner3d.scan_directory(corpus3d, num_workers=2, batched=True)
    ref = JaxScanner(checkpoints[0], device="cpu", batch_size=4).scan_directory(
        corpus3d, num_workers=2, batched=True)
    assert set(ours) == set(ref) and len(ours) == 4
    for path in ref:
        assert _cos(ours[path]["embedding"], ref[path]["embedding"]) >= 0.9999, path
        assert ours[path]["file_hash"] == ref[path]["file_hash"]
        assert ours[path]["size"] == ref[path]["size"]


def test_short_videos_go_through_the_batched_path(checkpoints, tmp_path, monkeypatch):
    """Short videos (<= clip_length) batch into stride-multiple buckets
    {12, 12, 16} and match the sequential true-length forwards; warmup
    covers those buckets first (tests/test_scanner_3d.py:63-93)."""
    d = tmp_path / "shorts"
    for i, t in enumerate((12, 10, 14)):
        write_video(d / f"short_{i}.mp4", synthetic_frames(i, t))
    sc = FingerprintScanner(checkpoints[0], device="cpu", batch_size=2)
    assert [sc._3d_bucket(t) for t in (12, 10, 14, 16, 40)] == [12, 12, 16, 16, 16]
    seq = sc.scan_directory(d, num_workers=1, batched=False)
    sc.warmup(10)
    monkeypatch.setattr(sc, "_extract_3d", lambda p: pytest.fail(f"sequential: {p}"))
    bat = sc.scan_directory(d, num_workers=2, batched=True)
    assert set(bat) == set(seq) and len(bat) == 3
    for p in seq:
        assert _cos(seq[p]["embedding"], bat[p]["embedding"]) > 0.99999, p
        assert bat[p]["embedding_norm"] == pytest.approx(1.0, abs=1e-5)


def _fake_video(monkeypatch, total):
    """Both packages' decode sees one video of `total` frames whose frame i
    is seeded by i, and records the windows asked for."""
    frames = [np.random.default_rng(i).integers(0, 256, (48, 80, 3), dtype=np.uint8)
              for i in range(total)]
    calls = {"jax": [], "port": []}
    for name, module in (("jax", jax_decode), ("port", port_decode)):
        monkeypatch.setattr(module, "probe", lambda path, *a, _m=module, **k:
                            _m.VideoInfo(total, 25.0, total / 25))

        def clip(path, start, n, *a, _name=name, **k):
            calls[_name].append((start, n))
            return [frames[min(start + j, total - 1)] for j in range(n)]

        monkeypatch.setattr(module, "decode_clip", clip)
    return calls


@pytest.mark.parametrize("total", [12, 16, 40, 77, 200])
def test_window_plan_matches_jax(checkpoints, monkeypatch, total):
    """The windows JAX's _extract_3d decodes are the port's window_plan, and
    the embeddings agree, through the sequential and the batched stages."""
    ckpt = checkpoints[0]
    calls = _fake_video(monkeypatch, total)
    ours_scanner = FingerprintScanner(ckpt, device="cpu", batch_size=4)
    ours = ours_scanner.extract_fingerprint("v.mp4")
    ref = JaxScanner(ckpt, device="cpu", batch_size=4).extract_fingerprint("v.mp4")
    plan = ours_scanner.window_plan(total)
    assert calls["jax"] == calls["port"] == plan
    assert len(plan) == (1 if total <= 16 else min(5, max(3, total // 32)))
    assert _cos(ours, ref) >= 0.9999
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)

    plans = ours_scanner.plan_windows(["v.mp4"], num_workers=2)
    assert plans == [("v.mp4", plan)]
    embs = ours_scanner.embed_clips(ours_scanner.decode_windows(plans, num_workers=2))
    windows = [embs[("v.mp4", i)] for i in range(len(plan))]
    np.testing.assert_allclose(reduce_windows(windows, len(plan)), ours, rtol=0, atol=1e-5)


def _stand_in(clip):
    """A unit vector from a (T, H, W, 3) float clip's content: distinct
    windows give distinct vectors, which random weights do not."""
    v = np.asarray(clip, np.float64)[:, ::8, ::8, :].mean(axis=0).reshape(-1)[:256] - 0.5
    return (v / np.linalg.norm(v)).astype(np.float32)


def _stand_in_model(video):
    """The stand-in on a (B, T, H, W, 3) batch, uint8 or float, as the
    port's model is called."""
    x = video.float() / 255.0 if video.dtype == torch.uint8 else video.float()
    return torch.from_numpy(np.stack([_stand_in(c) for c in x.numpy()]))


@pytest.mark.parametrize("total", [16, 77])
def test_window_averaging_rule_matches_jax(checkpoints, monkeypatch, total):
    """With window embeddings that differ: one window gives its embedding as
    it is; several give their mean RENORMALIZED (the attention path's
    segments are not renormalized: test_torch_port_scan.py). Sequential and
    batched, against JAX's _extract_3d on the same stand-in model."""
    ckpt = checkpoints[0]
    _fake_video(monkeypatch, total)
    ours_scanner = FingerprintScanner(ckpt, device="cpu", batch_size=4)
    ours_scanner.model = _stand_in_model
    jax_scanner = JaxScanner(ckpt, device="cpu", batch_size=4)
    monkeypatch.setattr(jax_scanner, "_embed_clip", _stand_in)
    ours = ours_scanner.extract_fingerprint("v.mp4")
    np.testing.assert_allclose(ours, jax_scanner.extract_fingerprint("v.mp4"),
                               rtol=0, atol=1e-6)
    plan = ours_scanner.window_plan(total)
    embs = ours_scanner.embed_clips(ours_scanner.decode_windows([("v.mp4", plan)], 2))
    windows = np.stack([embs[("v.mp4", i)] for i in range(len(plan))])
    np.testing.assert_allclose(reduce_windows(list(windows), len(plan)), ours,
                               rtol=0, atol=1e-6)
    assert np.linalg.norm(ours) == pytest.approx(1.0, abs=1e-6)
    if len(plan) == 1:
        np.testing.assert_array_equal(ours, windows[0])
    else:
        mean = windows.mean(axis=0)
        assert np.linalg.norm(mean) < 0.99  # the plain mean is not a unit vector
        np.testing.assert_allclose(ours, mean / np.linalg.norm(mean), rtol=0, atol=1e-6)


def test_decode_and_preprocess_match_jax(tmp_path):
    """probe, decode_clip (a seek, padding past the end by repeating the last
    frame, black frames for an unreadable file) and the square crop-resize
    give the JAX package's frames."""
    path = write_video(tmp_path / "v.mp4", synthetic_frames(3, 30))
    assert (dataclasses.astuple(port_decode.probe(path))
            == dataclasses.astuple(jax_decode.probe(path)) == (30, 25.0, 1.2, 128, 96))
    assert port_decode.probe(tmp_path / "missing.mp4") is None
    for start, n in ((0, 16), (10, 16), (25, 16)):
        ours, ref = port_decode.decode_clip(path, start, n), jax_decode.decode_clip(path, start, n)
        assert len(ours) == len(ref) == n
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    black = port_decode.decode_clip(tmp_path / "missing.mp4", 0, 3)
    assert [f.shape for f in black] == [(480, 640, 3)] * 3 and not any(f.any() for f in black)

    rng = np.random.default_rng(0)
    for shape in ((96, 128, 3), (128, 96, 3), (64, 64, 3), (70, 70, 3)):
        frame = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(port_preprocess.square_center_crop_resize(frame, 64),
                                      jax_preprocess.square_center_crop_resize(frame, 64))
    frames = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(3)]
    np.testing.assert_array_equal(port_preprocess.frames_to_clip(frames),
                                  jax_preprocess.frames_to_clip(frames))
    np.testing.assert_array_equal(port_preprocess.frames_to_clip_u8(frames),
                                  jax_preprocess.frames_to_clip_u8(frames))


def test_3d_scanner_cuda_without_card_raises(checkpoints):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FingerprintScanner(checkpoints[1])  # device defaults to cuda

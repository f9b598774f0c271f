"""The port's scan as a whole against the JAX package's: the CLI on a
synthetic corpus, batched against sequential extraction, and the exact
top-k duplicate search."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_fingerprint_tpu.cli.scan import main as jax_main
from video_fingerprint_tpu.inference.scanner import FingerprintScanner as JaxScanner
from video_fingerprint_tpu.models import create_model as jax_create_model
from video_fingerprint_tpu.ops.topk import topk_cosine as jax_topk_cosine
from video_fingerprint_tpu.training.checkpoint import save_checkpoint
from video_fingerprint_tpu.utils.synthetic import make_corpus
from video_fingerprint_tpu_torch.cli.scan import main
from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner
from video_fingerprint_tpu_torch.ops.topk import topk_cosine

THRESHOLD = 0.999999  # random weights map distinct videos close together


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("videos")
    make_corpus(d, num_unique=4, num_frames=40, duplicates=2)
    return d


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    model = jax_create_model("attention")
    v = model.init(jax.random.PRNGKey(42), jnp.zeros((1, 4, 64, 64, 3)))
    config = {"model_type": "attention", "frame_size": 64, "max_frames": 500,
              "embedding_dim": 256, "spatial_dim": 128, "temporal_dim": 256,
              "num_attention_blocks": 4}
    path = tmp_path_factory.mktemp("ckpt") / "last.ckpt"
    save_checkpoint(path, v["params"], v["batch_stats"], config)
    return str(path)


@pytest.fixture(scope="module")
def ckpt_short_max(ckpt, tmp_path_factory):
    """The same weights with max_frames = 16, so a 40-frame video is long."""
    from video_fingerprint_tpu.training.checkpoint import load_any as jax_load_any

    variables, config = jax_load_any(ckpt)
    path = tmp_path_factory.mktemp("ckpt16") / "max16.ckpt"
    save_checkpoint(path, variables["params"], variables["batch_stats"],
                    {**config, "max_frames": 16})
    return str(path)


@pytest.fixture(scope="module")
def scanner(ckpt):
    return FingerprintScanner(ckpt, device="cpu", batch_size=4, buckets=(32, 64))


def _groups(groups):
    return sorted(sorted(item["path"] for item in g) for g in groups)


def _keys(results):
    fp = next(iter(results["fingerprints"].values()))
    item = results["duplicate_groups"][0][0]
    return (set(results), set(results["metadata"]), set(fp), set(item))


def test_cli_matches_jax_cli(ckpt, corpus, tmp_path):
    args = ["--model", ckpt, "--scan", str(corpus), "--threshold", str(THRESHOLD),
            "--workers", "2", "--batch", "4", "--device", "cpu"]
    assert jax_main(args + ["--output", str(tmp_path / "jax.json")]) == 0
    assert main(args + ["--output", str(tmp_path / "port.json")]) == 0
    ref = json.loads((tmp_path / "jax.json").read_text())
    ours = json.loads((tmp_path / "port.json").read_text())

    assert _keys(ours) == _keys(ref)
    assert ours["metadata"]["total_videos"] == ref["metadata"]["total_videos"] == 6
    assert _groups(ours["duplicate_groups"]) == _groups(ref["duplicate_groups"])
    for i in range(2):
        pair = {str(corpus / f"video_{i}.mp4"), str(corpus / f"video_{i}_copy.mp4")}
        assert any(pair <= set(g) for g in _groups(ours["duplicate_groups"])), i
    assert ours["fingerprints"].keys() == ref["fingerprints"].keys()
    for path, fp in ours["fingerprints"].items():
        a = np.asarray(fp["embedding"])
        b = np.asarray(ref["fingerprints"][path]["embedding"])
        assert float(np.dot(a, b)) >= 0.9999, path
        assert fp["file_hash"] == ref["fingerprints"][path]["file_hash"]


def test_batched_equals_sequential(scanner, corpus):
    seq = scanner.scan_directory(corpus, num_workers=1, batched=False)
    bat = scanner.scan_directory(corpus, num_workers=2, batched=True)
    assert set(seq) == set(bat) and len(seq) == 6
    for path in seq:
        cos = float(np.dot(seq[path]["embedding"], bat[path]["embedding"]))
        assert cos > 0.9999, (path, cos)
        assert bat[path]["embedding_norm"] == pytest.approx(1.0, abs=1e-5)


def test_partial_batch_rows_and_clip_checks(scanner):
    """A partial batch pads with all-False mask rows (finite results); the
    batching stage rejects clips it cannot stage."""
    rng = np.random.default_rng(0)
    clips = [(i, rng.integers(0, 256, (t, 64, 64, 3), dtype=np.uint8))
             for i, t in enumerate((10, 31, 40))]
    embs = scanner.embed_clips(clips)
    assert list(embs) == [0, 1, 2]
    for i, clip in clips:
        ref = scanner._embed_flat(clip, 1)[0]
        assert np.isfinite(embs[i]).all()
        np.testing.assert_allclose(embs[i], ref, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="uint8"):
        scanner.embed_clips([("f", np.zeros((12, 64, 64, 3), np.float32))])
    with pytest.raises(ValueError, match="frames"):
        scanner.embed_clips([("long", np.zeros((501, 64, 64, 3), np.uint8))])


def _embeddings(n=150, dim=16, seed=0):
    """Unit rows with planted exact duplicates (tied scores) and near ones."""
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(n, dim)).astype(np.float32)
    e[10] = e[3]
    e[11] = e[3]
    e[40] = e[20] + 0.01
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    return e


def test_topk_matches_jax_exact():
    e = _embeddings()
    s, i = topk_cosine(torch.from_numpy(e), 20)
    rs, ri = jax_topk_cosine(jnp.asarray(e), 20, method="exact")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=0, atol=2e-6)
    assert (i.numpy()[:, 0] == np.arange(len(e))).sum() >= len(e) - 3  # self-matches
    # three tied rows: each lists the three, lowest index first
    for row in (3, 10, 11):
        assert list(i.numpy()[row, :3]) == [3, 10, 11]


def test_topk_duplicate_groups_match_jax(ckpt, scanner):
    """n > 100 takes the top-k route in both packages; same groups."""
    e = _embeddings()
    fps = {f"v{j:03d}": {"embedding": e[j], "path": f"v{j:03d}", "size": 1,
                         "file_hash": str(j)} for j in range(len(e))}
    ours = scanner.find_duplicates(fps, similarity_threshold=0.999)
    ref = JaxScanner(ckpt, device="cpu").find_duplicates(fps, similarity_threshold=0.999)
    assert _groups(ours) == _groups(ref)
    assert ["v003", "v010", "v011"] in _groups(ours)


def test_long_video_segments_match_jax(ckpt_short_max, monkeypatch):
    """Past max_frames, three evenly spaced segments are embedded and
    averaged without renormalizing: a reference quirk both packages keep."""
    import video_fingerprint_tpu.data.decode as jax_decode
    import video_fingerprint_tpu_torch.data.decode as port_decode

    rng = np.random.default_rng(4)
    frames = list(rng.integers(0, 256, (40, 64, 64, 3), dtype=np.uint8))
    for module in (jax_decode, port_decode):
        monkeypatch.setattr(module, "decode_subsampled", lambda path, max_frames: frames)
    ours_scanner = FingerprintScanner(ckpt_short_max, device="cpu")
    ours = ours_scanner.extract_fingerprint("long.mp4")
    ref = JaxScanner(ckpt_short_max, device="cpu").extract_fingerprint("long.mp4")
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)

    from video_fingerprint_tpu_torch.data.preprocess import preprocess_frames

    # segment length min(16, 40 // 3) = 13, starts 0, 13, 27
    segments = [preprocess_frames(frames[s:s + 13], 64) for s in (0, 13, 27)]
    mean = np.mean([ours_scanner._embed_flat(c, 1)[0] for c in segments], axis=0)
    np.testing.assert_allclose(ours, mean, rtol=0, atol=1e-6)


def test_segment_mean_is_not_renormalized(ckpt_short_max, monkeypatch):
    """With segment embeddings that differ (a stand-in for the forward in
    both packages), the attention path returns their plain mean, which is
    not a unit vector; the 3D path renormalizes (test_torch_port_scan3d.py)."""
    import video_fingerprint_tpu.data.decode as jax_decode
    import video_fingerprint_tpu_torch.data.decode as port_decode

    rng = np.random.default_rng(6)
    frames = list(rng.integers(0, 256, (40, 64, 64, 3), dtype=np.uint8))
    for module in (jax_decode, port_decode):
        monkeypatch.setattr(module, "decode_subsampled", lambda path, max_frames: frames)

    def stand_in(flat, batch_size):  # a unit vector per segment, from its content
        x = np.asarray(flat, np.float64).reshape(batch_size, -1)[:, ::97][:, :256] - 0.5
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    ours_scanner = FingerprintScanner(ckpt_short_max, device="cpu")
    monkeypatch.setattr(ours_scanner, "_embed_flat", stand_in)
    jax_scanner = JaxScanner(ckpt_short_max, device="cpu")
    monkeypatch.setattr(jax_scanner, "_fwd_flat", lambda v, x, b: stand_in(x, b))
    ours = ours_scanner.extract_fingerprint("long.mp4")
    np.testing.assert_allclose(ours, jax_scanner.extract_fingerprint("long.mp4"),
                               rtol=0, atol=1e-6)
    assert np.linalg.norm(ours) < 0.99

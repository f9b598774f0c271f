"""The port's scan CLI with `--index`, `--against`, `--index_storage` and
`--no_prune`, mirroring the JAX package's tests (tests/test_scanner.py:
149-346), on a small 3D checkpoint (frame_stride 4, clip_length 16) that
both packages read: incremental re-scans, merged libraries, query against
a corpus (one the JAX CLI wrote among them), scoped pruning and the
refusal of a foreign index."""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import video_fingerprint_tpu_torch.data.decode as port_decode
from video_fingerprint_tpu.cli.scan import main as jax_main
from video_fingerprint_tpu.inference.index import FingerprintIndex as JaxIndex
from video_fingerprint_tpu.models import create_model as jax_create_model
from video_fingerprint_tpu.training.checkpoint import save_checkpoint
from video_fingerprint_tpu.utils.synthetic import make_corpus
from video_fingerprint_tpu_torch.cli.scan import main
from video_fingerprint_tpu_torch.inference.index import FingerprintIndex
from video_fingerprint_tpu_torch.inference.scan_cache import load_cache, save_cache
from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner

BASE = ["--device", "cpu", "--workers", "2", "--batch", "4"]


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    v = jax_create_model("3d", frame_stride=4).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 16, 64, 64, 3)))
    config = {"model_type": "3d", "frame_size": 64, "clip_length": 16,
              "frame_stride": 4, "embedding_dim": 256}
    path = tmp_path_factory.mktemp("ckpt") / "m.ckpt"
    save_checkpoint(path, v["params"], v["batch_stats"], config)
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four 40-frame videos (three windows each), two with byte copies."""
    d = tmp_path_factory.mktemp("videos")
    make_corpus(d, num_unique=4, num_frames=40, duplicates=2)
    return d


@pytest.fixture(scope="module")
def scanner(ckpt):
    return FingerprintScanner(ckpt, device="cpu", batch_size=4)


def _decoded_paths(monkeypatch):
    """Record the files whose windows the port decodes."""
    seen = set()
    real = port_decode.decode_clip
    monkeypatch.setattr(port_decode, "decode_clip",
                        lambda path, *a: (seen.add(str(path)), real(path, *a))[1])
    return seen


def test_incremental_scan_decodes_only_changed_files(scanner, corpus, tmp_path, monkeypatch):
    """Unchanged files are reused without decode; a file whose first MiB
    changed is decoded again; the round-tripped cache equals a fresh scan
    (tests/test_scanner.py:149-189)."""
    full = scanner.scan_directory(corpus, num_workers=2)
    idx = tmp_path / "scan_index.npz"
    save_cache(idx, full, model_identity=scanner.model_identity)
    cache = load_cache(idx, expect_identity=scanner.model_identity)
    assert set(cache) == set(full) and len(full) == 6

    seen = _decoded_paths(monkeypatch)
    again = scanner.scan_directory(corpus, num_workers=2, cache=cache)
    assert seen == set()
    assert set(again) == set(full)
    for p in full:
        np.testing.assert_array_equal(again[p]["embedding"], full[p]["embedding"])

    victim = sorted(full)[0]
    data = open(victim, "rb").read()
    try:
        with open(victim, "wb") as f:  # same size, new md5, still decodable
            f.write(data[:200] + bytes([data[200] ^ 0xFF]) + data[201:])
        third = scanner.scan_directory(corpus, num_workers=2, cache=cache)
        assert seen == {victim}
        assert set(third) == set(full)
    finally:
        with open(victim, "wb") as f:
            f.write(data)


def test_index_merge_query_against_and_prune(ckpt, corpus, tmp_path, capsys):
    """Library A into an index, library B into the same index (A's entries
    survive), a second scan of A that decodes nothing, B queried against the
    corpus (the byte-identical re-upload at 1.0, md5-flagged), then a
    deletion in B pruned (tests/test_scanner.py:228-288); in f32 storage,
    in bf16 storage, and against a corpus the JAX CLI wrote."""
    src = corpus / "video_3.mp4"
    for storage in ("f32", "bf16", "jax"):
        idx = tmp_path / f"library_{storage}.npz"
        store = ["--index_storage", storage] if storage != "jax" else []
        run = jax_main if storage == "jax" else main
        assert run(["--model", ckpt, "--scan", str(corpus), "--index", str(idx)]
                   + BASE + store) == 0
        assert len(FingerprintIndex.load(idx)) == 6
        assert FingerprintIndex.load(idx).storage == ("bf16" if storage == "bf16" else "f32")

        lib_b = tmp_path / f"library_b_{storage}"
        lib_b.mkdir()
        shutil.copy(src, lib_b / "reupload.mp4")
        assert main(["--model", ckpt, "--scan", str(lib_b), "--index", str(idx)]
                    + BASE + store) == 0
        merged = FingerprintIndex.load(idx)
        assert len(merged) == 7 and merged.model_identity["embedding_dim"] == 256
        assert len(JaxIndex.load(idx)) == 7

        capsys.readouterr()
        assert main(["--model", ckpt, "--scan", str(corpus), "--index", str(idx)]
                    + BASE + store) == 0
        out = capsys.readouterr().out
        assert "6 unchanged (index hit), 0 to scan" in out and "Processed" not in out

        result = tmp_path / f"cross_{storage}.json"
        assert main(["--model", ckpt, "--scan", str(lib_b), "--against", str(idx),
                     "--threshold", "0.9999", "--output", str(result)] + BASE) == 0
        groups = json.loads(result.read_text())["duplicate_groups"]
        assert len(groups) == 1
        by_path = {item["path"]: item for item in groups[0]}
        assert by_path[str(lib_b / "reupload.mp4")]["exact_duplicate"]
        assert by_path[str(src)]["exact_duplicate"]
        assert by_path[str(src)]["similarity"] == pytest.approx(1.0, abs=1e-5)
        assert "DUPLICATE REPORT" in capsys.readouterr().out

        (lib_b / "reupload.mp4").unlink()
        fresh = lib_b / "fresh.mp4"
        shutil.copy(corpus / "video_1.mp4", fresh)
        assert main(["--model", ckpt, "--scan", str(lib_b), "--index", str(idx)]
                    + BASE + store) == 0
        pruned = FingerprintIndex.load(idx).fingerprints()
        assert str(lib_b / "reupload.mp4") not in pruned
        assert str(fresh) in pruned and len(pruned) == 7


def test_prune_scoped_to_scan_root(ckpt, corpus, tmp_path):
    """A scan of B cannot attest deletions in A; --no_prune keeps even
    in-root deletions; a plain rescan of A prunes (tests/test_scanner.py:
    291-332)."""
    lib_a, lib_b = tmp_path / "lib_a", tmp_path / "lib_b"
    lib_a.mkdir()
    lib_b.mkdir()
    shutil.copy(corpus / "video_0.mp4", lib_a / "a0.mp4")
    shutil.copy(corpus / "video_1.mp4", lib_a / "a1.mp4")
    shutil.copy(corpus / "video_2.mp4", lib_b / "b0.mp4")
    idx = tmp_path / "shared.npz"
    base = ["--model", ckpt, "--index", str(idx)] + BASE
    assert main(base + ["--scan", str(lib_a)]) == 0
    (lib_a / "a1.mp4").unlink()

    assert main(base + ["--scan", str(lib_b)]) == 0
    fps = FingerprintIndex.load(idx).fingerprints()
    assert str(lib_a / "a1.mp4") in fps and len(fps) == 3

    assert main(base + ["--scan", str(lib_a), "--no_prune"]) == 0
    assert str(lib_a / "a1.mp4") in FingerprintIndex.load(idx).fingerprints()

    assert main(base + ["--scan", str(lib_a)]) == 0
    fps = FingerprintIndex.load(idx).fingerprints()
    assert str(lib_a / "a1.mp4") not in fps
    assert str(lib_b / "b0.mp4") in fps and len(fps) == 2


def test_query_against_rejects_foreign_index(ckpt, scanner, corpus, tmp_path, capsys):
    """An index of another model (or another dimension) is refused: by the
    scanner with ValueError, by the CLI with "Error: ..." and exit code 1
    (tests/test_scanner.py:335-346)."""
    fps = scanner.scan_directory(corpus, num_workers=2)
    index = FingerprintIndex(dim=256, device="cpu",
                             model_identity=dict(scanner.model_identity, param_hash="f" * 32))
    index.add_fingerprints(fps)
    with pytest.raises(ValueError, match="different model"):
        scanner.find_duplicates_against(fps, index)
    other_dim = FingerprintIndex(dim=8, device="cpu")
    other_dim.add(np.eye(8, dtype=np.float32))
    with pytest.raises(ValueError, match="embedding dim"):
        scanner.find_duplicates_against(fps, other_dim)

    index.save(tmp_path / "foreign.npz")
    capsys.readouterr()
    assert main(["--model", ckpt, "--scan", str(corpus),
                 "--against", str(tmp_path / "foreign.npz")] + BASE) == 1
    assert "Error: corpus index was built by a different model" in capsys.readouterr().out
    assert main(["--model", ckpt, "--scan", str(corpus),
                 "--against", str(tmp_path / "missing.npz")] + BASE) == 1


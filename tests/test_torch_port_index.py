"""The port's fingerprint index, scan cache and top-k search against the
JAX package's: `.npz` files written by either package load in the other
(f32 and bf16 storage, identical bf16 bits), searches agree, bf16 storage
scores identical rows 1.0, a rescan replaces an entry, and `load_cache`
degrades to {} for another model's, a legacy or an unreadable index."""

import ml_dtypes
import numpy as np
import pytest
import torch

from video_fingerprint_tpu.inference.index import FingerprintIndex as JaxIndex
from video_fingerprint_tpu.inference.scan_cache import save_cache as jax_save_cache
from video_fingerprint_tpu.ops.topk import topk_search as jax_topk_search
from video_fingerprint_tpu_torch.inference.index import (
    FingerprintIndex,
    bf16_bits,
    bf16_values,
    identity_mismatch,
)
from video_fingerprint_tpu_torch.inference.scan_cache import load_cache, save_cache
from video_fingerprint_tpu_torch.ops import topk as port_topk

IDENTITY = {"model_type": "attention", "embedding_dim": 32, "frame_size": 64,
            "max_frames": 500, "param_hash": "ab" * 16}


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _corpus(n=300, dim=32, seed=0):
    """Unit rows with planted near copies and byte-identical rows."""
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(n, dim)).astype(np.float32)
    e[10] = e[3]
    e[40] = e[20] + 0.02 * rng.normal(size=dim).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    e[11] = e[3]
    return e


def _meta(n):
    return [{"path": f"/lib/v{i:03d}.mp4", "size": 1000 + i, "file_hash": f"h{i}"}
            for i in range(n)]


def test_bf16_bits_equal_ml_dtypes():
    """Round to nearest even, as ml_dtypes rounds, including values exactly
    halfway between two bf16 numbers (both parities of the kept bit), the
    largest values below overflow, subnormals and signed zeros."""
    rng = np.random.default_rng(1)
    upper = np.concatenate([rng.integers(0, 1 << 16, 4096, dtype=np.uint32),
                            np.array([0x3F80, 0x3F81, 0x7F7F, 0x8000, 0x0001, 0x807F],
                                     np.uint32)])
    low = np.concatenate([rng.integers(0, 1 << 16, 4096, dtype=np.uint32),
                          np.array([0x8000, 0x8000, 0x8000, 0x0000, 0x8000, 0x7FFF],
                                   np.uint32)])
    halfway = (upper << 16) | 0x8000
    values = np.concatenate([((upper << 16) | low).view(np.float32),
                             halfway.view(np.float32)])
    values = values[np.isfinite(values)]
    expected = values.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(bf16_bits(values), expected)
    np.testing.assert_array_equal(bf16_values(expected),
                                  expected.view(ml_dtypes.bfloat16).astype(np.float32))


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_npz_loads_in_both_packages(tmp_path, storage):
    """An index saved by either package loads in the other with equal
    embeddings, meta and identity, and the bf16 files hold identical bits."""
    e, meta = _corpus(), _meta(300)
    jax_index = JaxIndex(dim=32, model_identity=IDENTITY, storage=storage)
    jax_index.add(e, meta)
    jax_index.save(tmp_path / "jax.npz")
    port_index = FingerprintIndex(dim=32, model_identity=IDENTITY, storage=storage)
    port_index.add(e, meta)
    port_index.save(tmp_path / "port.npz")

    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], key)
    for loaded in (FingerprintIndex.load(tmp_path / "jax.npz"),
                   JaxIndex.load(tmp_path / "port.npz")):
        ref = JaxIndex.load(tmp_path / "jax.npz")
        assert loaded.storage == storage and len(loaded) == 300
        assert loaded.model_identity == IDENTITY
        assert [loaded.meta(i) for i in range(300)] == meta
        np.testing.assert_array_equal(loaded._flat_embeddings(), ref._flat_embeddings())
    if storage == "bf16":  # a save/load round trip of bf16 storage is the identity
        again = FingerprintIndex.load(tmp_path / "jax.npz")
        again.save(tmp_path / "again.npz")
        with np.load(tmp_path / "again.npz") as a, np.load(tmp_path / "jax.npz") as b:
            np.testing.assert_array_equal(a["embeddings_bf16"], b["embeddings_bf16"])


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_search_matches_jax(tmp_path, storage):
    """The same indices and scores within 1e-5 as the JAX index, on the same
    saved corpus; every query finds itself, identical rows included."""
    e = _corpus()
    jax_index = JaxIndex(dim=32, storage=storage)
    jax_index.add(e, _meta(300))
    jax_index.save(tmp_path / "c.npz")
    ours = FingerprintIndex.load(tmp_path / "c.npz", device="cpu")
    ref = JaxIndex.load(tmp_path / "c.npz")
    rng = np.random.default_rng(4)
    queries = np.concatenate([e[:40], rng.normal(size=(25, 32)).astype(np.float32)])
    s, i = ours.search(queries, k=20, exact_above=0.99)
    rs, ri = ref.search(queries, k=20)
    assert s.dtype == np.float32 and s.shape == i.shape == (65, 20)
    np.testing.assert_array_equal(i, np.asarray(ri))
    np.testing.assert_allclose(s, np.asarray(rs), rtol=0, atol=1e-5)
    # k is capped at the corpus size
    small = FingerprintIndex(dim=32, device="cpu", storage=storage)
    small.add(e[:5])
    assert small.search(e[:2], k=20)[1].shape == (2, 5)


def test_bf16_identical_rows_score_one():
    """bf16 storage scores cosines of the stored rows: byte-identical rows
    score 1.0 to within one f32 rounding (raw bf16 inner products sit up to
    ~0.4 % below), and the copies group at a threshold of 0.999999."""
    e = _corpus()
    index = FingerprintIndex(dim=32, device="cpu", storage="bf16")
    index.add(e)
    s, i = index.search(e[[3, 10, 11]], k=3, exact_above=0.999999)
    for row in range(3):
        assert sorted(i[row].tolist()) == [3, 10, 11]
        np.testing.assert_allclose(s[row], 1.0, rtol=0, atol=1e-6)
    stored = bf16_values(bf16_bits(e[3]))
    assert abs(float(stored @ stored) - 1.0) > 1e-4  # what the rescale repairs


def test_chunked_search_matches_jax_exact(monkeypatch):
    """Small query tiles and corpus blocks (merged block by block) give the
    JAX exact search's indices, ties broken by the lower index (f32: integer
    rows, so the ties are exact). In bf16 storage the cosine rescale rounds
    tied scores apart by an ulp in either package, so there the scores agree
    within 1e-6 and each chosen index carries its rank's score."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    e = rng.integers(-3, 4, (203, 16)).astype(np.float32)  # many tied scores
    e[50] = e[7]
    e[120] = e[7]
    monkeypatch.setattr(port_topk, "QUERY_BLOCK", 32)
    monkeypatch.setattr(port_topk, "CORPUS_BLOCK", 48)
    q = torch.from_numpy(e)
    s, i = port_topk.topk_search(q, q, 20)
    rs, ri = jax_topk_search(jnp.asarray(e), jnp.asarray(e), 20, method="exact")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert list(i.numpy()[7, :3]) == [7, 50, 120]

    s, i = port_topk.topk_search(q, q.to(torch.bfloat16), 20)
    rs, _ = jax_topk_search(jnp.asarray(e), jnp.asarray(e, jnp.bfloat16), 20, method="exact")
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=0, atol=1e-6)
    unit = e / np.linalg.norm(e, axis=1, keepdims=True)
    chosen = np.take_along_axis(unit @ unit.T, i.numpy(), axis=1)
    np.testing.assert_allclose(chosen, np.asarray(rs), rtol=0, atol=1e-6)


def test_add_fingerprints_replaces_an_entry():
    """A rescanned path replaces its row; meta round-trips through the
    fingerprints view (tests/test_scanner.py:349-368)."""
    index = FingerprintIndex(dim=4)
    e1, e2 = np.eye(4, dtype=np.float32)[:2]
    index.add_fingerprints({"a.mp4": {"embedding": e1, "size": 10}})
    index.add_fingerprints({"a.mp4": {"embedding": e2, "size": 11},
                            "b.mp4": {"embedding": e1, "size": 20}})
    assert len(index) == 2
    fps = index.fingerprints()
    np.testing.assert_array_equal(fps["a.mp4"]["embedding"], e2)
    assert fps["a.mp4"]["size"] == 11 and fps["b.mp4"]["size"] == 20
    assert fps["b.mp4"]["path"] == "b.mp4"


def test_load_cache_cases(tmp_path, capsys):
    """Same model: every entry; another param hash or embedding dim: {};
    a legacy index without identity: only the dimension is checked; an
    unreadable file: {} with a warning (tests/test_scanner.py:192-225). A
    cache saved by the JAX package reads the same."""
    rng = np.random.default_rng(2)
    fps = {f"/lib/v{i}.mp4": {"embedding": rng.normal(size=32).astype(np.float32),
                              "size": i, "file_hash": f"h{i}", "name": f"v{i}.mp4"}
           for i in range(5)}
    idx = tmp_path / "scan_index.npz"
    save_cache(idx, fps, model_identity=IDENTITY)
    got = load_cache(idx, expect_identity=IDENTITY)
    assert set(got) == set(fps)
    for p in fps:
        np.testing.assert_array_equal(got[p]["embedding"], fps[p]["embedding"])
        assert got[p]["file_hash"] == fps[p]["file_hash"]

    capsys.readouterr()
    assert load_cache(idx, expect_identity=dict(IDENTITY, param_hash="0" * 32)) == {}
    assert "different model" in capsys.readouterr().out
    assert load_cache(idx, expect_identity=dict(IDENTITY, embedding_dim=128)) == {}

    save_cache(idx, fps, model_identity=None)
    assert set(load_cache(idx, expect_identity=IDENTITY)) == set(fps)
    assert load_cache(idx, expect_identity={"embedding_dim": 128}) == {}

    jax_save_cache(tmp_path / "jax.npz", fps, model_identity=IDENTITY, storage="bf16")
    assert set(load_cache(tmp_path / "jax.npz", expect_identity=IDENTITY)) == set(fps)

    assert load_cache(tmp_path / "missing.npz", expect_identity=IDENTITY) == {}
    idx.write_bytes(b"not an npz at all")
    capsys.readouterr()
    assert load_cache(idx, expect_identity=IDENTITY) == {}
    assert "unreadable" in capsys.readouterr().out

    assert identity_mismatch(None, IDENTITY) is None
    assert identity_mismatch({"embedding_dim": 32, "x": 1}, IDENTITY) is None
    assert "param_hash" in identity_mismatch(dict(IDENTITY, param_hash="f"), IDENTITY)


def test_index_searches_on_the_card_unless_asked(tmp_path):
    """load and save never touch CUDA; a search with no device runs on the
    card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    index = FingerprintIndex(dim=32)
    index.add(_corpus())
    index.save(tmp_path / "c.npz")
    loaded = FingerprintIndex.load(tmp_path / "c.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loaded.search(_corpus()[:2])
    with pytest.raises(ValueError, match="empty"):
        FingerprintIndex(dim=32, device="cpu").search(_corpus()[:2])

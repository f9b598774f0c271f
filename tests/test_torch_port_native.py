"""The port's native preprocessing bindings (video_fingerprint_tpu_torch/
utils/native.py) against the JAX package's (video_fingerprint_tpu/utils/
native.py): the same source and flags, so the outputs are equal byte for
byte; the port's library lands under build/, never in native/; and the
port's scanner with native_preprocess (float32 staging) equals the JAX
scanner with the same flag (max abs 1e-4, cosine 0.9999). Skipped only
where the port's own library cannot be built (g++ missing: the message
says so); where the port's built and the JAX package's did not load,
`load_jax_native` waits out the JAX build and loads it again, and the
fixture fails if it still does not load."""

import fcntl
import os
import time
from pathlib import Path

import numpy as np
import pytest

from video_fingerprint_tpu.utils import native as jax_native
from video_fingerprint_tpu_torch.ops import _build
from video_fingerprint_tpu_torch.utils import native

QUIET_S = 1.0       # a library written less than this long ago may be half-written
JAX_BUILD_WAIT_S = 300


def _compiling(path: Path) -> bool:
    """Whether a live process names `path` on its command line (a compiler
    writing it)."""
    target = str(path).encode()
    for cmdline in Path("/proc").glob("[0-9]*/cmdline"):
        try:
            if target in cmdline.read_bytes().split(b"\0"):
                return True
        except OSError:
            continue
    return False


def _wait_quiet(path: Path) -> None:
    """Until no compiler writes `path` and it is older than QUIET_S (or
    absent), JAX_BUILD_WAIT_S at most."""
    deadline = time.monotonic() + JAX_BUILD_WAIT_S
    while time.monotonic() < deadline:
        young = path.exists() and time.time() - path.stat().st_mtime < QUIET_S
        if not young and not _compiling(path):
            return
        time.sleep(0.2)


def load_jax_native(module) -> None:
    """Load the JAX package's native library (`module`: its utils.native or
    utils.native_decode) for a test whose port library loaded.

    That package builds with g++ straight into native/lib*.so, guarded by a
    thread lock only, and remembers a failed load for the whole process
    (`_tried`): under pytest-xdist one worker can dlopen a library another
    worker's compiler is still writing, and then never tries again. Here,
    under a file lock in build/ (so the port's test workers take turns),
    wait until no compiler writes the library and it has been quiet for
    QUIET_S, forget the failed load and load it again; fail the test if it
    still does not load."""
    if module.available():
        return
    lock = _build.REPO_ROOT / "build" / "jax_native.lock"
    lock.parent.mkdir(parents=True, exist_ok=True)
    with open(lock, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            for _ in range(3):
                _wait_quiet(module._SO)
                with module._lock:
                    module._tried = False
                    module._lib = None
                if module.available():
                    return
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    pytest.fail(f"the port's native library loaded but the JAX package's "
                f"{os.path.relpath(module._SO, _build.REPO_ROOT)} did not")


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip(f"the port's vfp_host did not build (g++ missing?): "
                    f"{native.LIBRARY.error[-300:]}")
    load_jax_native(jax_native)
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


def test_load_jax_native_retries_a_failed_load(lib, monkeypatch):
    """The JAX loader's remembered failure (`_tried` with no library, what
    a worker that dlopened a half-written library keeps) is forgotten and
    the library loads."""
    monkeypatch.setattr(jax_native, "_tried", True)
    monkeypatch.setattr(jax_native, "_lib", None)
    assert not jax_native.available()
    load_jax_native(jax_native)
    assert jax_native.available()


def test_load_jax_native_waits_for_a_quiet_library_then_fails(tmp_path):
    """A library written just now is waited on for QUIET_S before the load
    is tried again; a library that still does not load fails the test
    rather than skipping it."""
    import threading
    from types import SimpleNamespace

    so = tmp_path / "libfake.so"
    so.write_bytes(b"half-written")
    tries = []
    fake = SimpleNamespace(_SO=so, _lock=threading.Lock(), _tried=True, _lib=None)
    fake.available = lambda: tries.append(time.time() - so.stat().st_mtime) or False
    with pytest.raises(pytest.fail.Exception, match="did not"):
        load_jax_native(fake)
    assert len(tries) == 4  # the first look, then one per retry
    assert min(tries[1:]) >= QUIET_S

"""Checkpoints in the port: the `.ckpt` msgpack reader against flax's,
`.pth` loading, and both formats giving the JAX scanner's embeddings and
model identity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from video_fingerprint_tpu.inference.scanner import FingerprintScanner as JaxScanner
from video_fingerprint_tpu.models import create_model as jax_create_model
from video_fingerprint_tpu.training.checkpoint import load_any as jax_load_any
from video_fingerprint_tpu.training.checkpoint import save_checkpoint
from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner
from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.training.checkpoint import load_any, unpackb
from video_fingerprint_tpu_torch.utils.torch_compat import (
    attention_variables_to_state_dict,
)

CONFIG = {"model_type": "attention", "frame_size": 64, "max_frames": 500,
          "embedding_dim": 256, "spatial_dim": 128, "temporal_dim": 256,
          "num_attention_blocks": 4}


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The same weights as a JAX `.ckpt` and as a reference-layout `.pth`."""
    model = jax_create_model("attention")
    v = model.init(jax.random.PRNGKey(5), jnp.zeros((1, 4, 64, 64, 3)))
    rng = np.random.default_rng(8)
    stats = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.5, a.shape).astype(np.float32) ** 2 + 0.5,
        v["batch_stats"])
    d = tmp_path_factory.mktemp("ckpt")
    ckpt = d / "model.ckpt"
    save_checkpoint(ckpt, v["params"], stats, CONFIG, epoch=3, global_step=42,
                    bests={"auc_roc": 0.9}, metrics={"loss": 0.5})
    variables = jax.tree_util.tree_map(np.asarray, {"params": v["params"],
                                                    "batch_stats": stats})
    sd = attention_variables_to_state_dict(variables)
    pth = d / "model.pth"
    torch.save({"epoch": 3, "model_state_dict": {k: torch.from_numpy(np.array(x))
                                                 for k, x in sd.items()},
                "config": CONFIG, "best_auc_roc": 0.9}, pth)
    return ckpt, pth, variables


def test_msgpack_reader_matches_flax():
    """Every msgpack shape flax writes, including a chunked array."""
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    tree = {
        "ints": {"small": 5, "neg": -3, "neg8": -100, "u16": 40000, "i32": -70000,
                 "u64": 2 ** 40},
        "floats": {"f": 0.25, "big": 1e300},
        "strs": {"short": "ab", "long": "x" * 300, "bytes": b"\x00\x01" * 200},
        "misc": {"none": None, "t": True, "f": False, "list": [1, "two", 3.0]},
        "arrays": {"f32": arr, "i64": np.arange(5, dtype=np.int64),
                   "u8": np.zeros((2, 3, 4), np.uint8), "bool": np.array([True, False]),
                   "scalar": np.float32(1.5), "big": np.ones(70000, np.float32)},
        # the layout flax's _chunk writes for arrays above 1 GiB
        "chunked": {"__msgpack_chunked_array__": True, "shape": {"0": 3, "1": 4},
                    "chunks": {"0": arr.reshape(-1)[:5], "1": arr.reshape(-1)[5:]}},
    }
    data = serialization.msgpack_serialize(tree)
    ours, ref = unpackb(data), serialization.msgpack_restore(data)
    np.testing.assert_array_equal(ours["chunked"], arr)
    assert _flat(ours).keys() == _flat(ref).keys()
    for key, value in _flat(ref).items():
        assert type(_flat(ours)[key]) is type(value) or isinstance(value, np.ndarray)
        np.testing.assert_array_equal(_flat(ours)[key], value, key)
        assert np.asarray(_flat(ours)[key]).dtype == value.dtype, key


def test_ckpt_loads_to_the_same_arrays(checkpoints):
    ckpt, _, _ = checkpoints
    (ours, config), (ref, ref_config) = load_any(ckpt), jax_load_any(ckpt)
    assert config == ref_config == CONFIG
    a, b = _flat(ours), _flat(ref)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        np.testing.assert_array_equal(a[key], b[key], key)


def test_pth_loads_strictly(checkpoints):
    _, pth, variables = checkpoints
    sd = torch.load(pth, weights_only=False)["model_state_dict"]
    create_model("attention").load_state_dict(sd, strict=True)
    ours, config = load_any(pth)
    assert config == CONFIG
    a, b = _flat(ours), _flat(variables)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], key)


def test_both_formats_give_the_jax_embeddings_and_identity(checkpoints):
    ckpt, pth, _ = checkpoints
    rng = np.random.default_rng(2)
    clip = rng.random((14, 64, 64, 3), dtype=np.float32)
    jax_scanner = JaxScanner(str(ckpt), device="cpu", batch_size=1)
    ref = jax_scanner._embed_clip(clip)
    for path in (ckpt, pth):
        scanner = FingerprintScanner(str(path), device="cpu", batch_size=1)
        ours = scanner._embed_flat(clip, 1)[0]
        assert float(np.dot(ours, ref)) >= 0.9999
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
        assert scanner.model_identity == jax_scanner.model_identity, path
    assert JaxScanner(str(pth), device="cpu").model_identity == jax_scanner.model_identity


def test_cuda_without_card_raises(checkpoints):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FingerprintScanner(str(checkpoints[0]))  # device defaults to cuda

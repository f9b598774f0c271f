"""The port's graft entry points (video_fingerprint_tpu_torch/tools/graft_entry.py)
against the JAX package's (__graft_entry__.py), on the CPU:

- entry()'s forward equals the JAX entry() forward on the JAX entry's own
  variables, carried over by utils/torch_compat.py::variables_to_state_dict
  (cosine >= 0.9999, f32 allclose 1e-4: the parity gate of the port), on
  its zero video and on a seeded one; the port's own example arguments give
  a unit-norm (1, 256) embedding;
- dryrun_multichip(2) and dryrun_multichip(4) over ["cpu"] * n pass: every
  program against its one-device oracle (the data-parallel steps in n gloo
  ranks).
"""

import importlib
import sys

import numpy as np
import pytest
import torch

from tests.conftest import REPO_ROOT
from video_fingerprint_tpu_torch.tools import graft_entry


def _cosine(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_entry_matches_jax_entry_on_carried_weights():
    import jax

    sys.path.insert(0, str(REPO_ROOT))
    jax_fn, (jax_vars, jax_video) = importlib.import_module("__graft_entry__").entry()
    variables = jax.tree.map(np.asarray, jax_vars)
    fn, (own_vars, video) = graft_entry.entry(device="cpu")
    assert tuple(video.shape) == (1, 32, 64, 64, 3) and video.device.type == "cpu"
    rng = np.random.default_rng(0)
    for x in (np.asarray(jax_video), rng.random((1, 32, 64, 64, 3), dtype=np.float32)):
        ref = np.asarray(jax_fn(jax_vars, x))
        ours = fn(variables, torch.from_numpy(np.array(x))).numpy()
        assert ours.shape == ref.shape == (1, 256)
        assert _cosine(ours, ref).min() >= 0.9999
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    own = fn(own_vars, video).numpy()
    assert own.shape == (1, 256) and np.isfinite(own).all()
    np.testing.assert_allclose(np.linalg.norm(own), 1.0, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu(n, capsys):
    graft_entry.dryrun_multichip(n, ["cpu"] * n)
    out = capsys.readouterr().out
    for program in ("one DP train step OK", "with device_augment OK", "sharded top-k OK",
                    "certified-bf16 top-k OK", "bf16-RESIDENT sharded search OK",
                    "query-vs-corpus search OK", "DP extraction OK", "partial-batch eval OK"):
        assert f"dryrun_multichip({n}): " in out and program in out, program


def test_dryrun_multichip_refuses_one_device():
    with pytest.raises(ValueError, match="n_devices >= 2"):
        graft_entry.dryrun_multichip(1, ["cpu"])
    with pytest.raises(ValueError, match="need 3 devices"):
        graft_entry.dryrun_multichip(3, ["cpu"] * 2)

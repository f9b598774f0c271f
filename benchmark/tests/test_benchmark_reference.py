"""The plain reference against the program's models and search, at tiny
widths on the CPU, with the benchmark's seeded weights."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import TINY_CONFIGS
from benchmark.harness import traffic
from benchmark.reference import library, search, weights

from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.models.fuse import fuse_state_dict

CPU = torch.device("cpu")


def _weights(config, seed=3):
    sd = weights.seeded_state_dict(config, torch.Generator().manual_seed(seed))
    clips = traffic.calibration_clips(config, seed, CPU, clips=4)
    weights.calibrate(sd, config, clips, [clips[0], clips[1, :9]])
    return sd


def _program(config, sd, fused):
    kwargs = {k: config[k] for k in ("spatial_dim", "temporal_dim", "embedding_dim",
                                     "num_attention_blocks", "frame_stride") if k in config}
    model = create_model(config["model_type"], fused=fused, **kwargs)
    state = {k: v.numpy() for k, v in sd.items()}
    if fused:
        state = fuse_state_dict(state, config["model_type"])
    own = model.state_dict()
    model.load_state_dict({k: torch.from_numpy(np.asarray(state[k])) if k in state else own[k]
                           for k in own})
    return model.eval()


@pytest.mark.parametrize("fused", [False, True])
def test_benchmark_reference_attention_matches_the_program(fused):
    config = TINY_CONFIGS["tiny-attention"]
    sd = _weights(config)
    model = _program(config, sd, fused)
    clips = [torch.from_numpy(c) for c in traffic.calibration_clips(config, 9, CPU, 3).numpy()]
    clips[1] = clips[1][:13]
    with torch.no_grad():
        ref = library.attention_embeddings([c.numpy() for c in clips], sd, 8, CPU)
        got = np.stack([model.forward_flat(c, 1)[0].numpy() for c in clips])
    assert np.abs(ref - got).max() < 2e-5


@pytest.mark.parametrize("fused", [False, True])
def test_benchmark_reference_cnn3d_matches_the_program(fused):
    config = TINY_CONFIGS["tiny-cnn3d"]
    sd = _weights(config)
    model = _program(config, sd, fused)
    windows = traffic.calibration_clips(config, 9, CPU, 3).numpy()
    videos = [[windows[0]], [windows[1], windows[2][:7]]]
    with torch.no_grad():
        ref = library.cnn3d_embeddings(videos, sd, config["frame_stride"], CPU)
        per = [[model(torch.from_numpy(w)[None])[0].numpy() for w in v] for v in videos]
    from video_fingerprint_tpu_torch.inference.scanner import reduce_windows

    got = np.stack([reduce_windows(p, len(p)) for p in per])
    assert np.abs(ref - got).max() < 2e-5


def test_benchmark_calibration_centres_and_sets_statistics():
    config = TINY_CONFIGS["tiny-attention"]
    sd = _weights(config)
    assert not torch.equal(sd["spatial_encoder.encoder.1.running_var"],
                           torch.ones_like(sd["spatial_encoder.encoder.1.running_var"]))
    assert sd["final_projection.3.bias"].abs().sum() > 0


def test_benchmark_exact_topk_and_groups():
    from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner

    rng = np.random.default_rng(0)
    e = rng.standard_normal((300, 16)).astype(np.float32)
    e[7] = e[3]
    e[200] = e[3] + 1e-4
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    s, i = search.exact_topk(torch.from_numpy(e), torch.from_numpy(e), 5)
    brute = e @ e.T
    assert np.allclose(s.numpy(), -np.sort(-brute, axis=1)[:, :5], atol=1e-6)
    paths = [f"v{j}" for j in range(300)]
    fps = {p: {"embedding": e[j], "file_hash": p, "path": p} for j, p in enumerate(paths)}
    program = FingerprintScanner.__new__(FingerprintScanner)
    program.device, program.devices = CPU, [CPU]
    got = program._find_duplicates_topk(e, paths, fps, 0.99)
    want = next(search.groupings(e, 0.99, CPU))
    assert [sorted(item["path"] for item in g) for g in got] == \
        [sorted(paths[j] for j in g) for g in want]
    assert sorted(want[0]) == [3, 7, 200]


def test_benchmark_groupings_decide_near_pairs_both_ways():
    e = np.array([[1.0, 0.0], [0.99, np.sqrt(1 - 0.99 ** 2)]])
    got = list(search.groupings(e, 0.99, CPU))
    assert sorted(map(len, got)) == [0, 1]

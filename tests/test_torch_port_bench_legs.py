"""The port's benchmark legs (video_fingerprint_tpu_torch/tools/bench_*.py) on
the CPU at small sizes, against the JAX package on the same inputs and
weights: the headline's timed forward against the JAX fused forward, the
dedup search against JAX topk_cosine, the e2e scan's duplicate groups
against the JAX scanner's; the analytic operation count (utils/flops.py)
against FlopCounterMode; the train leg's keys; and the near-duplicate
synthetic corpus bit for bit against the JAX functions."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from video_fingerprint_tpu.models import create_model as jax_create_model
from video_fingerprint_tpu.models.fuse import fuse_variables
from video_fingerprint_tpu.ops.topk import topk_cosine as jax_topk_cosine
from video_fingerprint_tpu.utils import synthetic as jax_synthetic
from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.tools import (
    bench_dedup,
    bench_headline,
    bench_scan_e2e,
    bench_train,
)
from video_fingerprint_tpu_torch.tools import bench_torch_baseline
from video_fingerprint_tpu_torch.tools.bench_common import seeded_state_dict
from video_fingerprint_tpu_torch.training.optim import make_optimizer
from video_fingerprint_tpu_torch.training.train_step import draw_extracts, make_train_step
from video_fingerprint_tpu_torch.utils import flops
from video_fingerprint_tpu_torch.utils import synthetic
from video_fingerprint_tpu_torch.utils.torch_compat import attention_state_dict_to_variables

COS_F32, ATOL_F32 = 0.9999, 1e-4
FLOP_RTOL = 0.01
SMALL = {"spatial_dim": 16, "temporal_dim": 32, "embedding_dim": 32,
         "num_attention_blocks": 2}
SMALL_ARGS = ["--spatial_dim", "16", "--temporal_dim", "32", "--embedding_dim", "32",
              "--depth", "2"]


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_headline_forward_matches_jax(tmp_path):
    """The leg's timed forward (the pipelined one on the CPU, f32) against
    the JAX fused forward of the same seeded weights on the same frames."""
    path = tmp_path / "emb.npz"
    out, emb = bench_headline.run(bench_headline.parse_args(
        ["--device", "cpu", "--batch", "4", "--frames", "8", "--f32", "--windows", "1",
         "--pipeline_depth", "2", "--save_embeddings", str(path)] + SMALL_ARGS))
    assert out["graph_vps"] is None and out["pipelined_vps"] > 0
    assert out["sync_per_batch_vps"] > 0 and out["streaming_vps"] > 0
    saved = np.load(path)
    frames = saved["frames"]
    assert frames.shape == (4, 8, 64, 64, 3) and frames.dtype == np.uint8
    np.testing.assert_array_equal(saved["embeddings"], emb[:4])

    variables = attention_state_dict_to_variables(seeded_state_dict(0, **SMALL))
    fused = fuse_variables(variables, "attention")
    jax_model = jax_create_model("attention", fused=True, **SMALL)
    ref = np.asarray(jax_model.apply(fused, jnp.asarray(frames.reshape(-1, 64, 64, 3)), 4,
                                     method="forward_flat"))
    cos = np.sum(emb * ref, axis=1) / (np.linalg.norm(emb, axis=1)
                                       * np.linalg.norm(ref, axis=1))
    assert cos.min() >= COS_F32, cos
    np.testing.assert_allclose(emb, ref, rtol=0, atol=ATOL_F32)
    # distinct clips stay apart (the seeded BN statistics at work)
    sims = emb @ emb.T
    assert sims[~np.eye(4, dtype=bool)].max() < 0.9999


def test_forward_flops_match_flop_counter():
    torch.manual_seed(0)
    model = create_model("attention", **SMALL).eval()
    x = torch.randint(0, 256, (3 * 8, 64, 64, 3), dtype=torch.uint8)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.forward_flat(x, 3)
    want = counter.get_total_flops()
    assert flops.forward_flops(model, 3, 8) == pytest.approx(want, rel=FLOP_RTOL)
    # at full width too (one video): the count scales with the widths
    model = create_model("attention").eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.forward_flat(x[:8], 1)
    assert flops.forward_flops(model, 1, 8) == pytest.approx(counter.get_total_flops(),
                                                             rel=FLOP_RTOL)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("fast", [False, True])
def test_train_step_flops_match_flop_counter(remat, fast):
    """One train step (the full and the extract forwards, the loss, the
    backward; remat recomputes the forwards). FlopCounterMode counts a
    grouped conv's weight grad as a dense conv's, which the analytic count
    does not: within 0.1 % here."""
    B, T = 3, 8
    torch.manual_seed(0)
    model = create_model("attention", **SMALL)
    opt = make_optimizer("attention", model, 1e-4, total_steps=10)
    step = make_train_step(model, opt, "attention", remat=remat, reuse_extract_features=fast)
    rng = np.random.default_rng(0)
    batch = {"clip1": rng.integers(0, 256, (B, T, 64, 64, 3), dtype=np.uint8),
             "clip2": rng.integers(0, 256, (B, T, 64, 64, 3), dtype=np.uint8),
             "mask1": np.ones((B, T), bool), "mask2": np.ones((B, T), bool),
             "video_id": np.arange(B)}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with FlopCounterMode(display=False) as counter:
        step(batch, draw_extracts(torch.Generator().manual_seed(0), B, T, 0.5), 0)
    got = flops.train_step_flops(model, B, T, remat=remat, fast_extracts=fast)
    assert got == pytest.approx(counter.get_total_flops(), rel=FLOP_RTOL)


def test_baseline_runs_only_the_given_reference(tmp_path, capsys):
    """Without --reference_dir the baseline is -1 and nothing is run; with
    one, its model.py's create_model("attention") is timed."""
    assert bench_torch_baseline.main([]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["reference_torch_cpu_vps"] == -1.0
    (tmp_path / "model.py").write_text(
        "import torch\n"
        "def create_model(kind):\n"
        "    return torch.nn.Flatten()\n")
    assert bench_torch_baseline.main(["--reference_dir", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["reference_torch_cpu_vps"] > 0 and out["reference_videos_timed"] == 20


def test_dedup_matches_jax_topk():
    result, (scores, idx), e_host = bench_dedup.run(bench_dedup.parse_args(
        ["--device", "cpu", "--n", "2000", "--k", "20", "--method", "exact", "--reps", "1",
         "--baseline_n", "500", "--verify"]))
    assert result["unit"] == "queries/sec" and result["value"] > 0
    assert result["verified"] == "strict: score multisets bit-equal to exact"
    ref_s, ref_i = jax_topk_cosine(jnp.asarray(e_host), 20)
    np.testing.assert_array_equal(idx, np.asarray(ref_i))
    np.testing.assert_allclose(scores, np.asarray(ref_s), rtol=0, atol=1e-5)


@pytest.mark.parametrize("method,thr", [("certified", None), ("certified-bf16", 0.95)])
def test_dedup_planted_certified_verifies(method, thr):
    args = ["--device", "cpu", "--n", "2000", "--k", "20", "--method", method, "--reps",
            "1", "--baseline_n", "500", "--planted", "--verify"]
    if thr is not None:
        args += ["--exact_above", str(thr)]
    result, _, _ = bench_dedup.run(bench_dedup.parse_args(args))
    assert result["verified"].startswith("strict" if thr is None else "thresholded")


def test_scan_e2e_groups_match_jax_scanner(tmp_path):
    from video_fingerprint_tpu.inference.scanner import FingerprintScanner as JaxScanner

    result, groups = bench_scan_e2e.run(num_videos=6, num_frames=24, device="cpu",
                                        workers=2, batch=4, threshold=0.9999,
                                        cache_dir=tmp_path, bf16=False)
    assert result["e2e_videos"] == 6 and result["e2e_scan_vps_with_decode"] > 0
    assert (result["e2e_planted_pairs"], result["e2e_planted_pairs_found"]) == (1, 1)
    assert groups == [["video_0.mp4", "video_0_copy.mp4"]]

    ckpt = bench_scan_e2e.ensure_checkpoint(tmp_path)
    scanner = JaxScanner(str(ckpt), device="cpu", batch_size=4)
    fps = scanner.scan_directory(tmp_path / "corpus_v6_f24", num_workers=2)
    jax_groups = sorted(sorted(p.split("/")[-1] for p in (item["path"] for item in g))
                        for g in scanner.find_duplicates(fps, similarity_threshold=0.9999))
    assert groups == jax_groups


def test_train_leg_prints_its_keys(capsys):
    assert bench_train.main(["--device", "cpu", "--batch", "2", "--frames", "8",
                             "--long_batch", "2", "--long_frames", "8", "--steps", "2",
                             "--timings", "1", "--warm", "1"] + SMALL_ARGS) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for tag in ("b2_t8", "b2_t8_fast_extracts"):
        assert out[f"train_steps_per_sec_{tag}_bf16_dispatched"] > 0
        assert out[f"train_tflops_per_step_{tag}"] > 0
        assert out[f"train_mfu_{tag}_dispatched"] > 0
    for remat in ("off", "on"):
        assert out[f"train_steps_per_sec_b2_t8_devaug_remat_{remat}_dispatched"] > 0
    assert out["t512_fits_hbm_without_remat"] is True


@pytest.mark.parametrize("seed,base_seed,mix", [(0, 1000, 0.25), (7, 1003, 0.5)])
def test_synthetic_frames_near_match_jax(seed, base_seed, mix):
    np.testing.assert_array_equal(
        synthetic.synthetic_frames_near(seed, base_seed, 12, mix=mix),
        jax_synthetic.synthetic_frames_near(seed, base_seed, 12, mix=mix))


def test_make_hard_corpus_matches_jax(tmp_path):
    ours = synthetic.make_hard_corpus(tmp_path / "port", num_families=2, per_family=2,
                                      num_frames=12)
    ref = jax_synthetic.make_hard_corpus(tmp_path / "jax", num_families=2, per_family=2,
                                         num_frames=12)
    assert [p.name for p in ours] == [p.name for p in ref]
    for a, b in zip(ours, ref):
        assert a.read_bytes() == b.read_bytes()

"""TimeSformer (divided space-time attention) in the port, on the CPU at a small
size: the benchmark's plain float32 reference against `transformers`'
TimesformerModel, the port's model against the reference, the scan path
(`FingerprintScanner` from a saved `.pth`, `embed_clips`, `reduce_windows`)
against the reference's video embeddings, the frame sampler, and the spans
and counters the benchmark reads.

The small configuration keeps every mechanism of TimeSformer-Base: hidden
64 in 4 heads of D = 16, 2 layers, MLP 256, 32 px frames in patches of 8
(16 patches a frame), 4 frames a window sampled from windows of 16."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness.traffic import Scenes, render
from benchmark.reference import models
from benchmark.reference import timesformer as ref
from video_fingerprint_tpu_torch.inference.family import TimesformerFamily, family_for
from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner, reduce_windows
from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.models import timesformer as tsf
from video_fingerprint_tpu_torch.ops import attention
from video_fingerprint_tpu_torch.utils import trace

CPU = torch.device("cpu")
CONFIG = {"model_type": "timesformer", "hidden_size": 64, "num_hidden_layers": 2,
          "num_attention_heads": 4, "intermediate_size": 256, "patch_size": 8,
          "frame_size": 32, "num_frames": 4, "clip_length": 16, "layer_norm_eps": 1e-6,
          "qkv_bias": True, "embedding_dim": 32, "mean": [0.45, 0.4, 0.5],
          "std": [0.225, 0.25, 0.2], "precision": "float32"}
MODEL_KEYS = TimesformerFamily.KEYS  # the config's keys the model takes
# Float32 against float32 differs by summation order alone (the patch
# embedding as a GEMM over (kh, kw, c) rows against the strided conv, the
# normalisation folded into one multiply-add): 5.5e-7 at most when this was
# written. bfloat16 puts the unit embeddings 1.7e-2 apart at this size, so
# a path that rounds to bf16 fails.
TOLERANCE = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _clips(seed: int, n: int, frames: int) -> np.ndarray:
    """(n, frames, S, S, 3) uint8 clips of panning scenes."""
    rng = np.random.default_rng(seed)
    S = CONFIG["frame_size"]
    scenes = Scenes(rng, [frames] * n, S)
    out = render(torch.Generator().manual_seed(seed), scenes, list(range(n)),
                 [np.arange(frames)] * n, S, CPU)
    return out.reshape(n, frames, S, S, 3)


def _port(sd, dtype=torch.float32):
    model = create_model("timesformer", image_size=CONFIG["frame_size"],
                         **{k: CONFIG[k] for k in MODEL_KEYS})
    model.load_state_dict(sd, strict=True)
    return model.to(dtype).eval()


@pytest.fixture(scope="module")
def weights():
    sd = ref.seeded_state_dict(CONFIG, torch.Generator().manual_seed(5))
    ref.calibrate(sd, CONFIG, list(torch.from_numpy(_clips(6, 6, CONFIG["num_frames"]))))
    return sd


def test_timesformer_reference_equals_transformers(weights):
    transformers = pytest.importorskip("transformers")
    hf_config = transformers.TimesformerConfig(
        image_size=CONFIG["frame_size"], patch_size=CONFIG["patch_size"],
        num_frames=CONFIG["num_frames"], hidden_size=CONFIG["hidden_size"],
        num_hidden_layers=CONFIG["num_hidden_layers"],
        num_attention_heads=CONFIG["num_attention_heads"],
        intermediate_size=CONFIG["intermediate_size"], layer_norm_eps=CONFIG["layer_norm_eps"])
    hf = transformers.TimesformerModel(hf_config).eval()
    sd = {k: v for k, v in weights.items() if not k.startswith("fingerprint_head")}
    hf.load_state_dict(sd, strict=True)
    C = CONFIG["hidden_size"]
    # an identity head leaves the reference's output at the final CLS token
    identity = dict(weights, **{"fingerprint_head.weight": torch.eye(C),
                                "fingerprint_head.bias": torch.zeros(C)})
    clips = torch.from_numpy(_clips(7, 3, CONFIG["num_frames"]))
    mean, std = torch.tensor(CONFIG["mean"]), torch.tensor(CONFIG["std"])
    pixels = ((clips.float() / 255.0 - mean) / std).permute(0, 1, 4, 2, 3)
    with torch.no_grad(), models.exact_float32():
        want = hf(pixels).last_hidden_state[:, 0]
        got = ref.forward(clips, identity, dict(CONFIG, embedding_dim=C), normalize=False)
    assert torch.allclose(got, want, atol=TOLERANCE, rtol=0)


def test_timesformer_state_dict_of_transformers_loads_strictly():
    transformers = pytest.importorskip("transformers")
    hf = transformers.TimesformerModel(transformers.TimesformerConfig(
        image_size=32, patch_size=8, num_frames=4, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=256))
    ours = create_model("timesformer", image_size=32, patch_size=8, num_frames=4,
                        hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=256, embedding_dim=32)
    head = {k: v for k, v in ours.state_dict().items() if k.startswith("fingerprint_head")}
    assert set(ours.state_dict()) == set(hf.state_dict()) | set(head)
    ours.load_state_dict({**hf.state_dict(), **head}, strict=True)


@pytest.mark.parametrize("dtype", ["uint8", "float"])
def test_timesformer_port_equals_reference(weights, dtype):
    clips = torch.from_numpy(_clips(8, 5, CONFIG["num_frames"]))
    with torch.no_grad(), models.exact_float32():
        want = ref.forward(clips, weights, CONFIG)
        got = _port(weights)(clips if dtype == "uint8" else clips.float() / 255.0)
    assert got.dtype == torch.float32
    assert torch.allclose(got, want, atol=TOLERANCE, rtol=0)


def test_timesformer_bf16_falls_outside_the_tolerance(weights):
    clips = torch.from_numpy(_clips(8, 5, CONFIG["num_frames"]))
    with torch.no_grad():
        want = ref.forward(clips, weights, CONFIG)
        got = _port(weights, torch.bfloat16)(clips)
    assert (got - want).abs().max() > 10 * TOLERANCE


def test_timesformer_attentions_take_views_of_the_qkv(weights, monkeypatch):
    """Both attentions of every layer go through multihead_attention (K1 on a
    card) with (B, H, T, D) views of the qkv projection, no copies."""
    seen = []
    real = tsf.multihead_attention

    def spy(q, k, v, mask=None):
        seen.append((tuple(q.shape), q._base is not None and q._base is k._base is v._base))
        return real(q, k, v, mask)

    monkeypatch.setattr(tsf, "multihead_attention", spy)
    B, T, H = 3, CONFIG["num_frames"], CONFIG["num_attention_heads"]
    N, D = (CONFIG["frame_size"] // CONFIG["patch_size"]) ** 2, CONFIG["hidden_size"] // H
    with torch.no_grad():
        _port(weights)(torch.from_numpy(_clips(9, B, T)))
    assert seen == [((B * N, H, T, D), True), ((B * T, H, 1 + N, D), True)] * 2


def test_timesformer_sampler_and_window_plan():
    family = family_for("timesformer", {"clip_length": 256, "num_frames": 8})
    assert isinstance(family, TimesformerFamily) and family.windowed
    assert family.frames_of(256).tolist() == [32 * i for i in range(8)]
    assert family.frames_of(100).tolist() == [0, 12, 25, 37, 50, 62, 75, 87]
    assert family.frames_of(5).tolist() == [0, 0, 1, 1, 2, 3, 3, 4]  # repeats below 8
    for length in (5, 8, 100, 255, 256):
        assert family.frames_of(length).tolist() == ref.frames_of(length, 8).tolist()
    assert family.window_plan(200) == [(0, 200)]
    assert family.window_plan(1281) == [(0, 256), (512, 256), (1024, 256)]
    assert len(family.window_plan(6000)) == 5
    assert family.clip_range == (8, 8) and family.bucket(8) == 8
    assert family.warmup_lengths(None) == {8}


@pytest.mark.parametrize("model_type, frame_size, clip_length", [
    ("timesformer", 224, 256), ("3d", 64, 128), ("attention", 64, None)])
def test_family_sizes_default_per_family(model_type, frame_size, clip_length):
    """A config without sizes takes its family's: TimeSformer stages 224 px
    windows of 256 frames, the upstream models 64 px (and the 3D model 128
    frames a window); a config's own sizes win."""
    family = family_for(model_type, {}, (32, 500))
    assert family.frame_size == frame_size
    assert getattr(family, "clip_length", None) == clip_length
    assert family_for(model_type, {"frame_size": 96}, (32, 500)).frame_size == 96


def test_scanner_reads_the_family_sizes(tmp_path):
    """The scanner's sizes are its family's: a TimeSformer checkpoint whose
    config names no frame_size or clip_length is staged at 224 px in windows
    of 256 frames."""
    config = {k: v for k, v in CONFIG.items() if k not in ("frame_size", "clip_length")}
    sd = ref.seeded_state_dict({**CONFIG, "frame_size": 224}, torch.Generator().manual_seed(5))
    path = tmp_path / "model.pth"
    ref.save_pth(sd, config, path)
    scanner = FingerprintScanner(str(path), device="cpu", batch_size=2)
    assert (scanner.frame_size, scanner.clip_length) == (224, 256)
    assert scanner.window_plan(1000) == [(0, 256), (372, 256), (744, 256)]


@pytest.fixture(scope="module")
def scan_inputs(weights, tmp_path_factory):
    """A `.pth` of the seeded weights, and videos as the scan's windows
    leave them: num_frames sampled frames of each window of its plan."""
    path = tmp_path_factory.mktemp("timesformer") / "model.pth"
    ref.save_pth(weights, CONFIG, path)
    family = family_for("timesformer", CONFIG)
    sources = {"v12": 12, "v16": 16, "v40": 40, "v70": 70}
    videos = {}
    for j, (name, total) in enumerate(sources.items()):
        frames = _clips(20 + j, 1, total)[0]
        videos[name] = [frames[start + family.frames_of(length)]
                        for start, length in family.window_plan(total)]
    return str(path), videos


def test_timesformer_scan_path_equals_the_reference(weights, scan_inputs):
    path, videos = scan_inputs
    scanner = FingerprintScanner(path, device="cpu", batch_size=2)
    assert scanner.window_plan(70) == family_for("timesformer", CONFIG).window_plan(70)
    assert [len(w) for w in videos.values()] == [1, 1, 3, 3]
    embeddings = scanner.embed_clips(((name, i), clip) for name, windows in videos.items()
                                     for i, clip in enumerate(windows))
    got = np.stack([reduce_windows([embeddings[(name, i)] for i in range(len(windows))],
                                   len(windows)) for name, windows in videos.items()])
    want = ref.library_embeddings(CONFIG, list(videos.values()), weights, CPU)
    assert np.abs(got - want).max() < TOLERANCE


def test_timesformer_scan_takes_only_num_frames(scan_inputs):
    path, videos = scan_inputs
    scanner = FingerprintScanner(path, device="cpu", batch_size=2)
    short = videos["v40"][0][:3]
    with pytest.raises(ValueError, match="expected 4..4"):
        scanner.embed_clips([("short", short)])


def test_timesformer_spans_and_windows_counted(weights):
    model = _port(weights)
    clips = torch.from_numpy(_clips(9, 3, CONFIG["num_frames"]))
    before = trace.counter("tsf.windows")
    trace.clear()
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        model(clips)
    spans = [s.name for s in trace.recorded().spans]
    layers = CONFIG["num_hidden_layers"]
    assert spans.count("tsf.temporal") == spans.count("tsf.spatial") == layers
    assert trace.recorded().counts["tsf.windows"] == 3
    assert trace.counter("tsf.windows") - before == 3
    trace.clear()


@pytest.mark.parametrize("T, rows", [(8, 64), (64, 64), (197, 256), (500, 512)])
def test_k1_counts_its_query_rows(monkeypatch, T, rows):
    """Each launch counts QUERY_TILE rows a query tile of every (batch, head)
    instance, and the instances' own B * H * T (the wrapper's arithmetic,
    with the kernel's entry stubbed)."""
    lib = SimpleNamespace(vfp_attention_forward=lambda *args: 0)
    monkeypatch.setattr(attention, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: torch.no_grad())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(
        cuda_stream=0))
    B, H, D = 5, 12, 64
    q = torch.zeros(B, H, T, D)
    counts = {name: trace.counter(name) for name in
              ("k1.launches", "k1.rows_launched", "k1.rows_useful")}
    attention._launch(q, q, q, None, 0.125)
    assert trace.counter("k1.launches") - counts["k1.launches"] == 1
    assert trace.counter("k1.rows_launched") - counts["k1.rows_launched"] == B * H * rows
    assert trace.counter("k1.rows_useful") - counts["k1.rows_useful"] == B * H * T


def test_timesformer_tile_fill_as_reckoned():
    """TimeSformer-Base's launches (196 patches, 8 frames, 12 heads) fill
    21.5 % of K1's query rows: 8 of 64 in the temporal half, 197 of 256 in
    the spatial half."""
    N, T = 196, 8
    useful = N * T + T * (N + 1)
    launched = N * attention.QUERY_TILE + T * 4 * attention.QUERY_TILE
    assert round(100.0 * useful / launched, 1) == 21.5


def test_timesformer_directory_scan_decodes_the_sampled_frames(scan_inputs, tmp_path):
    """The scan of mp4 files: `decode_frames` gives the frames `decode_clip`
    gives at the sampled offsets, past the video's end too, and the batched
    scan (uint8 windows of the sampled frames through `embed_clips`) equals
    the sequential one (float windows, one at a time)."""
    from video_fingerprint_tpu_torch.data import decode
    from video_fingerprint_tpu_torch.utils.synthetic import synthetic_frames, write_video

    path, _ = scan_inputs
    videos = tmp_path / "videos"
    for i, total in enumerate((70, 12)):
        write_video(videos / f"v{i}.mp4", synthetic_frames(i, total))
    family = family_for("timesformer", CONFIG)
    whole = decode.decode_clip(videos / "v0.mp4", 27, 16)
    sampled = decode.decode_frames(videos / "v0.mp4", 27 + family.frames_of(16))
    assert all(np.array_equal(a, whole[i]) for a, i in zip(sampled, family.frames_of(16)))
    # v1 ends at frame 11, which is not asked for: what follows is frame 11,
    # the last that decoded, as decode_clip (and the native decode) pad
    past_end = decode.decode_frames(videos / "v1.mp4", [8, 10, 13, 14])
    span = decode.decode_clip(videos / "v1.mp4", 8, 7)
    assert all(np.array_equal(a, span[o]) for a, o in zip(past_end, [0, 2, 5, 6]))
    assert np.array_equal(past_end[2], span[3]) and not np.array_equal(past_end[2], span[2])
    scanner = FingerprintScanner(path, device="cpu", batch_size=2)
    batched = scanner.scan_directory(videos, num_workers=2)
    sequential = scanner.scan_directory(videos, num_workers=2, batched=False)
    assert sorted(batched) == sorted(sequential) and len(batched) == 2
    for key in batched:
        assert np.abs(batched[key]["embedding"] - sequential[key]["embedding"]).max() < TOLERANCE

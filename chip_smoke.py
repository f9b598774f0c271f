#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each of which raises (exit code 1) on any failure:

  1. print the card's name and power limit and the nvcc version; build every
     CUDA source of the port (one nvcc per source, all started together);
  2. hold the attention kernel (csrc/attention.cu) against its plain PyTorch
     version at the scan's shapes (64 videos x 8 heads, D = 32, every bucket
     length T and T = 1000, float32 and bfloat16, ragged rows, a row whose
     first 64 keys are masked, fully masked rows), and time it beside the
     plain version and F.scaled_dot_product_attention: device time from CUDA
     graph replay, and the time per call through the Python wrapper;
  3. the scan at full width: a seeded attention model written as a
     reference-layout .pth, FingerprintScanner(device="cuda", batch_size=64)
     fed ~200 seeded uint8 64x64 clips covering every bucket with planted
     byte-identical copies, duplicate search through the direct and the top-k
     path, all checked against the port's CPU path; the kernel's launch count
     shows the scan went through it; videos/s at bucket 128; then the same
     weights under max_frames = 1000 (a checkpoint's config may name any
     length), three clips of 600-1000 frames on the card against the CPU;
  4. the scan CLI on a synthetic mp4 corpus, on the card and on the CPU;
  5. the conv-block probe's kernel (csrc/conv3x3s2.cu, entry points
     conv_parity and conv_strided, the 3x3 stride-2 64->128 conv of the
     spatial encoder in bf16): held against its plain version and an f64
     oracle at 16,384, 8,192, 200, 203 (rows not 16-byte aligned), 203 of
     256, 1 and 16 * 132 + 5 frames, and at the scan model's own encoder[6]
     (BN folded) against cuDNN's encoder[6:9] on 8,192 frames; the probe
     (tools/convblock_probe.py) driven once with the launches counted;
     kernel, plain version and cuDNN timed at 8,192 and 16,384 frames
     (device time by CUDA-graph replay, and per call);
  6. the 3D-CNN scan at full width (frame_stride 32, clip_length 128,
     428,370 parameters): a seeded model written as a reference-layout
     .pth, FingerprintScanner(device="cuda", batch_size=64) fed ~200
     seeded uint8 windows (full 128-frame windows, short clips of 10-127
     frames, 3-window videos, planted byte-identical copies), checked
     against the port's CPU path (norms, cosine, direct and top-k groups);
     windows/s through the batching stage, the forward and each conv block
     at B = 64, GFLOP per window; then the scan CLI with that checkpoint on
     an mp4 corpus of 320-frame videos, on the card and on the CPU;
  7. the fingerprint index: the CLI's --index / --against flow (library A,
     library B merged in, a re-scan of A that decodes nothing, B against the
     corpus) on the card and on the CPU in f32 and bf16 storage;
     FingerprintIndex(device="cuda") over 1,000,000 x 256 seeded rows with
     256 planted near copies, 4,096 queries at k = 20 in f32 and bf16
     storage against a float64 oracle; topk_cosine self-search at
     100,000 x 256; their times beside the bound;
  8. training: the attention kernel at head dims 4, 16 and 64 (zero-padded
     to its widths 32 and 64) against its plain version, f32 and bf16; one
     train step of the seeded full-width attention model on the card held
     against the same step on the CPU (B = 8, T = 64, ragged masks, the
     same extract draws, dropout off, TF32 off), with K1 launched 0 times
     in the train forward and a nonzero grad on every in_proj weight;
     train steps/s at B = 64, T = 64 (attention f32 and bf16, with and
     without --fast_extracts) and for the 3D model at B = 128 x 128-frame
     windows, with peak memory and one torch.profiler window; the train
     CLI on a 16-video mp4 corpus for 2 epochs (artifacts, K1 launched in
     validation and not in the train steps), a resume from last.ckpt, and
     a scan of the corpus with its best.ckpt on the card.

Neither the 3D nor the index path has a hand-written kernel (cuDNN runs the
3D convs, cuBLAS the similarity matmuls, as XLA does in the JAX package);
their runs hold every kernel's launch count at zero. Train-mode attention
is plain torch math, as in the JAX package; K1 runs in validation.

The second-to-last line is {"kernels": [...]}, one entry per kernel of the
path; the last line is {"ok": true, "device": {...}}. Needs no network.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 0
BATCH = 64
HEADS = 8
HEAD_DIM = 32
BUCKETS = (32, 64, 128, 256, 500)
ATTENTION_T = BUCKETS + (1000,)  # and a length past 512 keys, where a checkpoint may go
# Published H100 SXM peaks (NVIDIA data sheet, dense) at a 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOLERANCE = {"float32": 2e-5, "bfloat16": 2e-2}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def attention_bound_ms(BH: int, T: int, dtype_name: str, mask_bytes: int,
                       head_dim: int = HEAD_DIM):
    """Least time for one attention call: q, k, v read once and o written
    once (+ the key mask) at HBM rate, vs 4*BH*T^2*D operations at the peak
    rate for the inputs' type (D the true head dim, before any padding)."""
    elt = 4 if dtype_name == "float32" else 2
    nbytes = 4 * BH * T * head_dim * elt + mask_bytes
    flops = 4 * BH * T * T * head_dim
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_info(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from video_fingerprint_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    emit({"phase": "info", "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc, "device": torch.cuda.get_device_name(0), "smi": smi})
    return smi


def phase_build():
    from video_fingerprint_tpu_torch.ops import _build

    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    logs = _build.build(sources)
    seconds = time.perf_counter() - t0
    for name, log in logs.items():
        registers = [int(w) for line in log.splitlines() if "registers" in line
                     for prev, w in zip(line.split(), line.split()[1:]) if prev == "Used"]
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        static_smem = [int(v) for v in re.findall(r"(\d+) bytes smem", log)]
        row = {"phase": "build", "source": f"csrc/{name}.cu", "seconds": seconds,
               "kernels": len(registers), "max_registers": max(registers, default=None),
               "spilling": spills, "max_static_smem_bytes": max(static_smem, default=0)}
        if name == "conv3x3s2":  # its shared memory is dynamic: ask the library
            from video_fingerprint_tpu_torch.ops import convblock as cb

            row["dynamic_smem_bytes"] = cb.smem_bytes()
        emit(row)


def _device_kernels(torch, fn):
    """Names of the CUDA kernels one call of fn launches, as torch.profiler
    sees them (diagnostic only: a profiler that fails is reported, not
    raised)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except Exception as exc:  # noqa: BLE001 - the names are informative, not a check
        return {"profiler_error": repr(exc)}
    return sorted({e.name for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")})


def phase_attention(torch):
    """Kernel vs plain version at every bucket T and T = 1000, f32 and bf16."""
    import torch.nn.functional as F

    from video_fingerprint_tpu_torch.ops import attention as attn
    from video_fingerprint_tpu_torch.utils.precision import full_fp32
    from video_fingerprint_tpu_torch.utils.timing import cuda_ms, graph_ms

    g = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for T in ATTENTION_T:
            shape = (BATCH, HEADS, T, HEAD_DIM)
            q, k, v = (torch.randn(shape, device="cuda", generator=g).to(dtype)
                       for _ in range(3))
            lengths = torch.randint(1, T + 1, (BATCH,), device="cuda", generator=g)
            lengths[0] = T
            mask = torch.arange(T, device="cuda")[None, :] < lengths[:, None]
            if T > 64:  # the first key tile wholly masked, later keys valid
                mask[1] = torch.arange(T, device="cuda") >= 64
            mask[-1] = False  # one instance with every key masked
            bias = attn._key_bias(mask, (BATCH, T), q.device)[:, None, :]

            out = attn.multihead_attention(q, k, v, mask)
            torch.cuda.synchronize()
            with full_fp32():
                plain = attn._attention_torch(q, k, v, bias)
            err = (out.float() - plain.float()).abs().max().item()
            require(bool(torch.isfinite(out).all()), f"{dname} T={T}: non-finite output")
            require(err <= TOLERANCE[dname], f"{dname} T={T}: max abs err {err}")
            # a fully masked row gets uniform weights: the mean of v
            uniform = v[-1].float().mean(dim=1, keepdim=True).expand(HEADS, T, HEAD_DIM)
            err_uniform = (out[-1].float() - uniform).abs().max().item()
            require(err_uniform <= TOLERANCE[dname],
                    f"{dname} T={T}: fully masked row err {err_uniform}")
            err_f64 = None
            if dtype == torch.float32:  # an oracle independent of both
                s = q.double() @ k.double().transpose(-1, -2) / HEAD_DIM ** 0.5
                s = s + bias.double()[:, :, None, :]
                ref = torch.softmax(s, dim=-1) @ v.double()
                err_f64 = (out.double() - ref).abs().max().item()
                require(err_f64 <= TOLERANCE[dname], f"T={T}: err vs f64 {err_f64}")
                del s, ref

            err_leading = (out[1].float() - plain[1].float()).abs().max().item()
            del plain

            kernel = lambda: attn.multihead_attention(q, k, v, mask)
            kernel_ms = graph_ms(kernel)
            kernel_call_ms = cuda_ms(kernel)
            lib_mask = bias[:, :, None, :].to(dtype)
            library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask)
            with full_fp32():
                plain_ms = graph_ms(lambda: attn._attention_torch(q, k, v, bias))
                library_ms = graph_ms(library)
                library_call_ms = cuda_ms(library)
            bound_ms, bound_by = attention_bound_ms(BATCH * HEADS, T, dname,
                                                    mask.numel())
            row = {"phase": "attention", "dtype": dname, "T": T, "BH": BATCH * HEADS,
                   "max_abs_err": err, "err_uniform_row": err_uniform,
                   "err_leading_masked_row": err_leading, "err_vs_f64": err_f64,
                   "kernel_ms": kernel_ms, "kernel_call_ms": kernel_call_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "library_call_ms": library_call_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            if T == 128:  # which kernels the yardstick runs (f32: tensor cores?)
                with full_fp32():
                    row["library_kernels"] = _device_kernels(torch, library)
            emit(row)
            results[(dname, T)] = row
    return results


def _write_model(torch, path: Path, rng) -> None:
    """A seeded full-width attention model saved as a reference-layout
    checkpoint. Its BatchNorm statistics are measured on seeded clips (a
    cumulative average in train mode, as training would leave them): with
    the init's mean 0 / var 1 every clip maps to nearly one embedding."""
    from video_fingerprint_tpu_torch.models import create_model

    torch.manual_seed(SEED)
    model = create_model("attention")
    for module in model.modules():
        if isinstance(module, torch.nn.modules.batchnorm._BatchNorm):
            module.reset_running_stats()
            module.momentum = None
    calib = torch.from_numpy(np.stack([_seeded_clip(rng, 40) for _ in range(8)]))
    with torch.no_grad():
        model.train()(calib)
    config = {"model_type": "attention", "frame_size": 64, "max_frames": 500,
              "embedding_dim": 256, "spatial_dim": 128, "temporal_dim": 256,
              "num_attention_blocks": 4}
    torch.save({"model_state_dict": model.state_dict(), "config": config}, path)


def _seeded_clip(rng, t: int) -> np.ndarray:
    """(t, 64, 64, 3) uint8: a random 8x8 colour-block image of its own,
    panning sideways. Clip-level structure keeps distinct clips apart in
    the embedding space of random weights, where i.i.d. pixel noise would
    average out to nearly one embedding."""
    image = np.repeat(np.repeat(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
                                8, axis=0), 8, axis=1)
    speed = int(rng.integers(1, 4))
    cols = (np.arange(64)[None, :] + speed * np.arange(t)[:, None]) % 64
    return np.ascontiguousarray(image[:, cols].transpose(1, 0, 2, 3))


def _ragged_mask(torch, T: int, rng_torch):
    """(BATCH, T) key mask on the card: ragged rows, row 0 full, row 1 with
    its first key tile masked (T > 64), the last row fully masked."""
    lengths = torch.randint(1, T + 1, (BATCH,), device="cuda", generator=rng_torch)
    lengths[0] = T
    mask = torch.arange(T, device="cuda")[None, :] < lengths[:, None]
    if T > 64:
        mask[1] = torch.arange(T, device="cuda") >= 64
    mask[-1] = False
    return mask


def _seeded_clips(rng, n_per_bucket: int = 40, copies: int = 4):
    """uint8 64x64 clips whose lengths cover every bucket (10..500 frames),
    with `copies` byte-identical copies planted among them."""
    items = []
    low = 10
    for bucket in BUCKETS:
        for _ in range(n_per_bucket):
            t = int(rng.integers(low, bucket + 1))
            items.append((f"clip_{len(items):03d}", _seeded_clip(rng, t)))
        low = bucket + 1
    originals = [items[int(i)] for i in rng.choice(len(items), copies, replace=False)]
    pairs = []
    for key, clip in originals:
        pos = int(rng.integers(0, len(items)))
        items.insert(pos, (f"{key}_copy", clip.copy()))
        pairs.append((key, f"{key}_copy"))
    return items, pairs


def _groups(groups):
    return sorted(sorted(item["path"] for item in g) for g in groups)


def _scan_long(torch, workdir: Path, model_path: Path, rng):
    """The seeded checkpoint with max_frames = 1000 in its config (the JAX
    train CLI takes any --max_frames and writes it there): the scanner's last
    bucket is then 1000 frames. Three clips of 600-1000 frames embedded on
    the card in one partial batch (a fully masked padding row beside them)
    and on the CPU; the kernel's launches are counted."""
    from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner
    from video_fingerprint_tpu_torch.ops import attention as attn

    ckpt = torch.load(model_path)
    ckpt["config"] = dict(ckpt["config"], max_frames=1000)
    path = workdir / "model_max1000.pth"
    torch.save(ckpt, path)
    clips = [(f"long_{t}", _seeded_clip(rng, t)) for t in (600, 817, 1000)]
    with contextlib.redirect_stdout(io.StringIO()):
        card = FingerprintScanner(str(path), device="cuda", batch_size=4)
        cpu = FingerprintScanner(str(path), device="cpu", batch_size=len(clips))
    require(card.buckets[-1] == 1000, f"buckets {card.buckets}")
    attn.launches = 0
    embs = card.embed_clips(clips)
    torch.cuda.synchronize()
    launches = attn.launches
    require(launches == 4, f"max_frames=1000: {launches} kernel launches, not 4")
    cpu_embs = cpu.embed_clips(clips)
    cos = min(float(np.dot(embs[k], cpu_embs[k])) for k, _ in clips)
    require(cos >= 0.9999, f"max_frames=1000: card vs CPU cosine {cos}")
    return {"buckets": list(card.buckets), "frames": [c.shape[0] for _, c in clips],
            "attention_launches": launches, "card_vs_cpu_min_cos": cos}


def phase_scan(torch, workdir: Path):
    from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner
    from video_fingerprint_tpu_torch.ops import attention as attn
    from torch.utils.flop_counter import FlopCounterMode

    from video_fingerprint_tpu_torch.utils.precision import full_fp32
    from video_fingerprint_tpu_torch.utils.timing import cuda_ms

    model_path = workdir / "model.pth"
    rng = np.random.default_rng(SEED)
    _write_model(torch, model_path, rng)
    items, pairs = _seeded_clips(rng)
    scanner = FingerprintScanner(str(model_path), device="cuda", batch_size=BATCH)
    t0 = time.perf_counter()
    scanner.warmup()
    warmup_s = time.perf_counter() - t0

    per_bucket = {}
    for _, clip in items:
        b = next(b for b in scanner.buckets if clip.shape[0] <= b)
        per_bucket[b] = per_bucket.get(b, 0) + 1
    forwards = sum(-(-n // BATCH) for n in per_bucket.values())

    attn.launches = 0
    t0 = time.perf_counter()
    embs = scanner.embed_clips(items)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    launches = attn.launches
    require(launches == 4 * forwards,
            f"attention kernel launches {launches} != 4 x {forwards} forwards")
    require(set(embs) == {k for k, _ in items}, "missing embeddings")
    E = np.stack([embs[k] for k, _ in items])
    norms = np.linalg.norm(E, axis=1)
    require(bool(np.isfinite(E).all()), "non-finite embeddings")
    require(bool(np.abs(norms - 1).max() < 1e-5), f"norms off: {np.abs(norms - 1).max()}")

    # threshold between the planted copies and every other pair, so the
    # grouping is decided by the copies and not by a random-weight tie
    keys = [k for k, _ in items]
    pos = {k: i for i, k in enumerate(keys)}
    sims = E.astype(np.float64) @ E.T.astype(np.float64)
    copy_sims = [sims[pos[a], pos[b]] for a, b in pairs]
    np.fill_diagonal(sims, -np.inf)
    for a, b in pairs:
        sims[pos[a], pos[b]] = sims[pos[b], pos[a]] = -np.inf
    other_max = float(sims.max())
    threshold = (min(copy_sims) + other_max) / 2
    require(min(copy_sims) - other_max > 1e-5,
            f"copies not separable: copy min {min(copy_sims)}, other max {other_max}")

    fps = {k: {"embedding": embs[k], "path": k, "name": k, "size": c.nbytes,
               "file_hash": hashlib.md5(c.tobytes()).hexdigest()} for k, c in items}
    cpu = FingerprintScanner(str(model_path), device="cpu", batch_size=4)
    results = {}
    for route, topk_threshold in (("direct", 10 ** 9), ("topk", 100)):
        with contextlib.redirect_stdout(io.StringIO()):
            card = _groups(scanner.find_duplicates(fps, threshold, topk_threshold))
            plain = _groups(cpu.find_duplicates(fps, threshold, topk_threshold))
        require(card == plain, f"{route}: card groups differ from CPU groups")
        require(sorted(sorted(p) for p in pairs) == card,
                f"{route}: groups {card} != planted copies")
        results[route] = len(card)

    few = [(k, c) for k, c in items if c.shape[0] <= 64][:4]
    cpu_embs = cpu.embed_clips(few)
    cos = min(float(np.dot(embs[k], cpu_embs[k])) for k, _ in few)
    require(cos >= 0.9999, f"card vs CPU forward cosine {cos}")
    long = _scan_long(torch, workdir, model_path, rng)

    # videos/s at bucket 128, B = 64: through the batching stage (host
    # staging, copies, forward, readback) and the forward alone on the card
    clips128 = [(i, rng.integers(0, 256, (128, 64, 64, 3), dtype=np.uint8))
                for i in range(4 * BATCH)]
    scanner.embed_clips(clips128[:BATCH])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scanner.embed_clips(clips128)
    torch.cuda.synchronize()
    stage_vps = len(clips128) / (time.perf_counter() - t0)
    # the forward alone on the card, per bucket: total and spatial encoder
    forward = {}
    for T in BUCKETS:
        frames = torch.from_numpy(rng.integers(0, 256, (BATCH * T, 64, 64, 3),
                                               dtype=np.uint8)).cuda()
        mask = torch.ones((BATCH, T), dtype=torch.bool, device="cuda")
        with torch.inference_mode(), full_fp32():
            total_ms = cuda_ms(lambda: scanner.model.forward_flat(frames, BATCH, mask))
            x = frames.permute(0, 3, 1, 2).float() / 255.0
            spatial_ms = cuda_ms(lambda: scanner.model.spatial_encoder(x))
        del frames, x
        # operations per video, counted by PyTorch on the CPU model (whose
        # attention is the plain version, so its matmuls are counted too)
        with FlopCounterMode(display=False) as counter, torch.inference_mode():
            cpu.model.forward_flat(torch.zeros((T, 64, 64, 3), dtype=torch.uint8), 1)
        flops = counter.get_total_flops()
        forward[str(T)] = {"forward_ms": total_ms, "spatial_encoder_ms": spatial_ms,
                           "videos_per_s": BATCH / total_ms * 1e3,
                           "gflop_per_video": flops / 1e9,
                           "tflop_per_s": BATCH * flops / total_ms / 1e9}
    emit({"phase": "scan", "videos": len(items), "forwards": forwards,
          "per_bucket": {str(b): n for b, n in sorted(per_bucket.items())},
          "attention_launches": launches, "warmup_s": warmup_s, "scan_s": scan_s,
          "threshold": threshold, "copy_min_sim": min(copy_sims),
          "other_max_sim": other_max, "groups": results, "card_vs_cpu_min_cos": cos,
          "b128_stage_videos_per_s": stage_vps, "forward_b64": forward,
          "max_frames_1000": long})
    return launches, model_path


def phase_cli(torch, workdir: Path, model_path: Path):
    """The scan CLI on a synthetic mp4 corpus, on the card and on the CPU."""
    from video_fingerprint_tpu_torch.cli.scan import main
    from video_fingerprint_tpu_torch.ops import attention as attn
    from video_fingerprint_tpu_torch.utils.synthetic import make_corpus

    videos = workdir / "videos"
    make_corpus(videos, num_unique=5, num_frames=60, duplicates=2)
    reports = {}
    for device in ("cuda", "cpu"):
        out = workdir / f"results_{device}.json"
        attn.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            rc = main(["--model", str(model_path), "--scan", str(videos),
                       "--threshold", "0.999999", "--output", str(out),
                       "--device", device, "--workers", "2", "--batch", "8"])
        require(rc == 0, f"CLI on {device} exited {rc}")
        reports[device] = (json.loads(out.read_text()), attn.launches)
    (card, card_launches), (cpu, cpu_launches) = reports["cuda"], reports["cpu"]
    require(card_launches > 0 and cpu_launches == 0, "CLI launch counts")
    require(set(card) == {"metadata", "fingerprints", "duplicate_groups"}, "JSON keys")
    require(card["metadata"]["total_videos"] == 7, "CLI did not embed all 7 videos")
    groups = {d: _groups(r["duplicate_groups"]) for d, (r, _) in reports.items()}
    require(groups["cuda"] == groups["cpu"], f"CLI groups differ: {groups}")
    for i in range(2):
        require(any({str(videos / f"video_{i}.mp4"), str(videos / f"video_{i}_copy.mp4")}
                    <= set(g) for g in groups["cuda"]), f"copy {i} not grouped")
    cos = min(float(np.dot(card["fingerprints"][p]["embedding"],
                           cpu["fingerprints"][p]["embedding"]))
              for p in card["fingerprints"])
    require(cos >= 0.9999, f"CLI card vs CPU cosine {cos}")
    emit({"phase": "cli", "videos": 7, "groups": len(groups["cuda"]),
          "attention_launches": card_launches, "card_vs_cpu_min_cos": cos})


def conv_bound_ms(n: int):
    """Least time for one conv-block call on n frames: x (64, 16, 16, n) read
    once, y (128, 8, 8, n) written once, w2d and b read once, all bf16, at
    HBM rate, vs 2 * 128 * 576 * 64 * n operations at the bf16 peak."""
    nbytes = 2 * (64 * 16 * 16 * n + 128 * 8 * 8 * n + 128 * 576 + 128)
    flops = 2 * 128 * 576 * 64 * n
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_convblock(torch, model_path: Path):
    """The conv-block probe's kernels (csrc/conv3x3s2.cu, both entry points):
    held against the plain version and an f64 oracle on seeded inputs, then
    at the scan model's own layer against cuDNN's encoder[6:9]; the probe
    driven once (its launches counted); kernel, plain version and cuDNN
    timed at 8,192 and 16,384 frames: device time (CUDA-graph replay) as
    `ms`, and `call_ms` per call through the wrapper."""
    import copy

    from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner
    from video_fingerprint_tpu_torch.ops import convblock as cb
    from video_fingerprint_tpu_torch.tools import convblock_probe
    from video_fingerprint_tpu_torch.utils.precision import full_fp32
    from video_fingerprint_tpu_torch.utils.timing import cuda_ms, graph_ms

    def entry_points(x, w2d, b):
        outs = {"conv_parity": cb.conv_parity(*cb.split_parity(x), w2d, b),
                "conv_strided": cb.conv_strided(x, w2d, b)}
        torch.cuda.synchronize()
        require(torch.equal(outs["conv_parity"], outs["conv_strided"]),
                "conv_parity and conv_strided differ")
        return outs

    # 1. seeded inputs: the probe's frame count, one bucket-128 batch's, a
    # ragged one, rows not 16-byte aligned (203 frames, one frame: the
    # kernel's element-wise loader), the first 203 frames of 256, and 133
    # tiles of 16 on 132 SMs (a partial second tile in the persistent walk);
    # tolerances (ops/convblock.py): one bf16 ulp vs the plain version, half
    # an ulp plus f32 summation error vs the f64 oracle
    errs = {}
    cases = ((16384, None), (8192, None), (200, None), (203, None), (203, 256), (1, None),
             (16 * 132 + 5, None))
    for n, of in cases:
        x, w2d, b = convblock_probe.random_inputs(torch.device("cuda"), of or n, seed=SEED)
        x = x[..., :n]
        with full_fp32():
            plain = cb._conv_torch(x, w2d, b)
        oracle = cb.f64_oracle(x, w2d, b)
        for name, out in entry_points(x, w2d, b).items():
            require(out.shape == (128, 8, 8, n) and bool(torch.isfinite(out).all()),
                    f"{name} N={n}: shape {tuple(out.shape)} or non-finite output")
            err, ok = cb.compare(out, plain, cb.ONE_ULP)
            require(ok, f"{name} N={n}: vs plain max abs {err}")
            err64, ok64 = cb.compare(out, oracle, cb.VS_F64)
            require(ok64, f"{name} N={n}: vs f64 max abs {err64}")
            errs[(name, n)] = err
            emit({"phase": "convblock", "check": "seeded", "kernel": name, "frames": n,
                  "of_frames": of or n, "max_abs_err": err, "err_vs_f64": err64})
        del x, plain, oracle

    # 2. the scan model's encoder[6] (BN folded) on encoder[:6]'s bf16
    # activations of 8,192 seeded frames; the reference is cuDNN running
    # encoder[6:9] on the same bf16 operands in f32 (TF32 off), rounded once
    with contextlib.redirect_stdout(io.StringIO()):
        scanner = FingerprintScanner(str(model_path), device="cuda", batch_size=BATCH)
    encoder = scanner.model.spatial_encoder.encoder
    g = torch.Generator(device="cuda").manual_seed(SEED)
    frames = torch.randint(0, 256, (8192, 64, 64, 3), dtype=torch.uint8, device="cuda",
                           generator=g)
    layer = copy.deepcopy(encoder[6:9])
    with torch.inference_mode(), full_fp32():
        act = encoder[:6](frames.permute(0, 3, 1, 2).float() / 255.0).to(torch.bfloat16)
        w2d = cb.hwio_to_w2d(encoder[6].weight)
        b = encoder[6].bias.to(torch.bfloat16).reshape(128, 1)
        layer[0].weight.copy_(layer[0].weight.to(torch.bfloat16).float())
        layer[0].bias.copy_(b.float().reshape(128))
        ref = layer(act.float()).to(torch.bfloat16).permute(1, 2, 3, 0)
        outs = entry_points(act.permute(1, 2, 3, 0).contiguous(), w2d, b)
    live = float((ref > 0).float().mean())
    require(live > 0.05, f"encoder[6:9] output is {live:.3f} nonzero")
    for name, out in outs.items():
        err, ok = cb.compare(out, ref, cb.ONE_ULP)
        require(ok, f"{name} at the scan's encoder[6]: vs cuDNN max abs {err}")
        emit({"phase": "convblock", "check": "scan_layer", "kernel": name, "frames": 8192,
              "max_abs_err_vs_cudnn": err, "nonzero_share": live})
    del scanner, frames, act, ref, outs, layer

    # 3. the probe, the path these kernels serve: its launches are counted
    cb.launches = dict.fromkeys(cb.launches, 0)
    convblock_probe.main(["--frames", "16384", "--window-ms", "50"])
    launches = dict(cb.launches)
    require(all(c > 0 for c in launches.values()), f"probe launches {launches}")

    # 4. times at one bucket-128 batch's layer (64 videos x 128 frames) and at
    # the probe's frame count: device time (CUDA-graph replay) and per call
    # through the wrapper, for the kernel and for cuDNN (the probe's leg)
    times = {}
    for n in (8192, 16384):
        x, w2d, b = convblock_probe.random_inputs(torch.device("cuda"), n, seed=SEED)
        xe, xo = (t.contiguous() for t in cb.split_parity(x))
        library = convblock_probe.cudnn_leg(x, w2d, b)
        with full_fp32():
            plain_ms = graph_ms(lambda: cb._conv_torch(x, w2d, b))
        library_ms, library_call_ms = graph_ms(library), cuda_ms(library)
        bound_ms, bound_by = conv_bound_ms(n)
        for name, fn in (("conv_parity", lambda: cb.conv_parity(xe, xo, w2d, b)),
                         ("conv_strided", lambda: cb.conv_strided(x, w2d, b))):
            times[(name, n)] = {"ms": graph_ms(fn), "call_ms": cuda_ms(fn),
                                "plain_ms": plain_ms, "library_ms": library_ms,
                                "library_call_ms": library_call_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by}
            emit({"phase": "convblock", "check": "time", "kernel": name, "frames": n,
                  **times[(name, n)]})
        del x, xe, xo
    return {name: {"launches": launches[name], "max_abs_err": errs[(name, 16384)],
                   **times[(name, 16384)]} for name in launches}


CLIP_LENGTH = 128
STRIDE_3D = 32
INDEX_ROWS = 1_000_000
INDEX_QUERIES = 4096
SELF_SEARCH_ROWS = 100_000
EMB_DIM = 256
CARD = "cuda"  # the device of the phases below


def _zero_launches():
    from video_fingerprint_tpu_torch.ops import attention as attn
    from video_fingerprint_tpu_torch.ops import convblock as cb

    attn.launches = 0
    cb.launches = dict.fromkeys(cb.launches, 0)


def _launches():
    from video_fingerprint_tpu_torch.ops import attention as attn
    from video_fingerprint_tpu_torch.ops import convblock as cb

    return {"attention": attn.launches, **cb.launches}


def _write_model_3d(torch, path: Path, rng) -> None:
    """A seeded full-width 3D model saved as a reference-layout checkpoint,
    its BatchNorm statistics measured on seeded 128-frame clips (as
    _write_model does for the attention model)."""
    from video_fingerprint_tpu_torch.models import create_model

    torch.manual_seed(SEED)
    model = create_model("3d", frame_stride=STRIDE_3D)
    params = sum(p.numel() for p in model.parameters())
    require(params == 428_370, f"3D model has {params} parameters, not 428,370")
    for module in model.modules():
        if isinstance(module, torch.nn.modules.batchnorm._BatchNorm):
            module.reset_running_stats()
            module.momentum = None
    calib = torch.from_numpy(np.stack([_seeded_clip(rng, CLIP_LENGTH) for _ in range(8)]))
    with torch.no_grad():
        model.train()(calib)
    config = {"model_type": "3d", "frame_size": 64, "clip_length": CLIP_LENGTH,
              "frame_stride": STRIDE_3D, "embedding_dim": EMB_DIM}
    torch.save({"model_state_dict": model.state_dict(), "config": config}, path)


def _seeded_videos_3d(rng, scanner):
    """Seeded 3D scan input: {video: [window clips]} of 64 full 128-frame
    videos, 64 short ones of 10-127 frames and 24 long ones of 260-519
    frames cut by the scanner's window plan (3 windows each), with one
    byte-identical copy each of two videos of every kind."""
    videos = {}
    for kind, lengths in (("full", [CLIP_LENGTH] * 64),
                          ("short", rng.integers(10, CLIP_LENGTH, 64)),
                          ("long", rng.integers(260, 520, 24))):
        for j, t in enumerate(lengths):
            clip = _seeded_clip(rng, int(t))
            videos[f"{kind}_{j:02d}"] = [clip[s:s + n] for s, n in scanner.window_plan(int(t))]
    pairs = []
    for kind in ("full", "short", "long"):
        for j in rng.choice(24, 2, replace=False):
            key = f"{kind}_{j:02d}"
            videos[f"{key}_copy"] = [w.copy() for w in videos[key]]
            pairs.append((key, f"{key}_copy"))
    return videos, pairs


def _video_embeddings(scanner, videos):
    from video_fingerprint_tpu_torch.inference.scanner import reduce_windows

    embs = scanner.embed_clips(((v, i), w) for v, ws in videos.items()
                               for i, w in enumerate(ws))
    return {v: reduce_windows([embs[(v, i)] for i in range(len(ws))], len(ws))
            for v, ws in videos.items()}


def _planted_threshold(E: np.ndarray, keys, pairs):
    """A threshold halfway between the planted copies' least similarity
    and every other pair's greatest; fails when they do not separate."""
    pos = {k: i for i, k in enumerate(keys)}
    sims = E.astype(np.float64) @ E.T.astype(np.float64)
    copy_sims = [sims[pos[a], pos[b]] for a, b in pairs]
    np.fill_diagonal(sims, -np.inf)
    for a, b in pairs:
        sims[pos[a], pos[b]] = sims[pos[b], pos[a]] = -np.inf
    other_max = float(sims.max())
    require(min(copy_sims) - other_max > 1e-5,
            f"copies not separable: copy min {min(copy_sims)}, other max {other_max}")
    return (min(copy_sims) + other_max) / 2, min(copy_sims), other_max


def phase_scan3d(torch, workdir: Path):
    from torch.utils.flop_counter import FlopCounterMode

    from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner
    from video_fingerprint_tpu_torch.utils.precision import full_fp32
    from video_fingerprint_tpu_torch.utils.timing import cuda_ms

    rng = np.random.default_rng(SEED + 3)
    model_path = workdir / "model3d.pth"
    _write_model_3d(torch, model_path, rng)
    with contextlib.redirect_stdout(io.StringIO()):
        scanner = FingerprintScanner(str(model_path), device=CARD, batch_size=BATCH)
        cpu = FingerprintScanner(str(model_path), device="cpu", batch_size=16)
    require((scanner.clip_length, scanner.frame_stride) == (CLIP_LENGTH, STRIDE_3D),
            "3D checkpoint config not read")
    videos, pairs = _seeded_videos_3d(rng, scanner)
    windows = sum(len(ws) for ws in videos.values())
    t0 = time.perf_counter()
    scanner.warmup(10)
    warmup_s = time.perf_counter() - t0

    _zero_launches()
    t0 = time.perf_counter()
    embs = _video_embeddings(scanner, videos)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    launches = _launches()
    require(not any(launches.values()), f"a hand kernel ran in the 3D scan: {launches}")
    keys = list(videos)
    E = np.stack([embs[k] for k in keys])
    norms = np.linalg.norm(E, axis=1)
    require(bool(np.isfinite(E).all()), "non-finite 3D embeddings")
    require(bool(np.abs(norms - 1).max() < 1e-5), f"3D norms off: {np.abs(norms - 1).max()}")
    cpu_embs = _video_embeddings(cpu, videos)
    cos = min(float(np.dot(embs[k], cpu_embs[k])) for k in keys)
    require(cos >= 0.9999, f"3D card vs CPU cosine {cos}")

    threshold, copy_min, other_max = _planted_threshold(E, keys, pairs)
    fps = {k: {"embedding": embs[k], "path": k, "name": k, "size": len(videos[k]),
               "file_hash": hashlib.md5(b"".join(w.tobytes() for w in videos[k])).hexdigest()}
           for k in keys}
    groups = {}
    for route, topk_threshold in (("direct", 10 ** 9), ("topk", 100)):
        with contextlib.redirect_stdout(io.StringIO()):
            card = _groups(scanner.find_duplicates(fps, threshold, topk_threshold))
            plain = _groups(cpu.find_duplicates(fps, threshold, topk_threshold))
        require(card == plain, f"3D {route}: card groups differ from CPU groups")
        require(sorted(sorted(p) for p in pairs) == card,
                f"3D {route}: groups {card} != planted copies")
        groups[route] = len(card)

    # the batching stage and the forward alone at B = 64 on 128-frame windows
    full = [(i, rng.integers(0, 256, (CLIP_LENGTH, 64, 64, 3), dtype=np.uint8))
            for i in range(4 * BATCH)]
    scanner.embed_clips(full[:BATCH])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scanner.embed_clips(full)
    torch.cuda.synchronize()
    stage_wps = len(full) / (time.perf_counter() - t0)
    frames = torch.from_numpy(np.stack([c for _, c in full[:BATCH]])).to(CARD)
    blocks_ms = []
    with torch.inference_mode(), full_fp32():
        forward_ms = cuda_ms(lambda: scanner.model(frames))
        forward_profile = _kernel_times(torch, lambda: scanner.model(frames))
        x = (frames.float() / 255.0).permute(0, 4, 1, 2, 3)
        for block in scanner.model.encoder:
            blocks_ms.append(cuda_ms(lambda: block(x)))
            x = block(x)
    del frames, x
    with FlopCounterMode(display=False) as counter, torch.inference_mode():
        cpu.model(torch.zeros((1, CLIP_LENGTH, 64, 64, 3), dtype=torch.uint8))
    gflop = counter.get_total_flops() / 1e9

    cli = _cli_3d(torch, workdir, model_path)
    emit({"phase": "scan3d", "parameters": 428_370, "videos": len(videos), "windows": windows,
          "launches": launches, "warmup_s": warmup_s, "scan_s": scan_s,
          "threshold": threshold, "copy_min_sim": copy_min, "other_max_sim": other_max,
          "groups": groups, "card_vs_cpu_min_cos": cos,
          "b64_stage_windows_per_s": stage_wps, "forward_b64_ms": forward_ms,
          "forward_windows_per_s": BATCH / forward_ms * 1e3,
          "block_ms": blocks_ms, "forward_profile": forward_profile, "gflop_per_window": gflop,
          "tflop_per_s": BATCH * gflop / forward_ms, "cli": cli})


def _cli_3d(torch, workdir: Path, model_path: Path):
    """The scan CLI with the 3D checkpoint on 320-frame mp4s (3 windows
    each), on the card and on the CPU."""
    from video_fingerprint_tpu_torch.cli.scan import main
    from video_fingerprint_tpu_torch.utils.synthetic import make_corpus

    videos = workdir / "videos3d"
    make_corpus(videos, num_unique=4, num_frames=320, duplicates=2)
    reports = {}
    for device in (CARD, "cpu"):
        out = workdir / f"results3d_{device}.json"
        with contextlib.redirect_stdout(io.StringIO()):
            rc = main(["--model", str(model_path), "--scan", str(videos),
                       "--threshold", "0.999999", "--output", str(out),
                       "--device", device, "--workers", "4", "--batch", "8"])
        require(rc == 0, f"3D CLI on {device} exited {rc}")
        reports[device] = json.loads(out.read_text())
    card, cpu = reports[CARD], reports["cpu"]
    require(card["metadata"]["total_videos"] == 6, "3D CLI did not embed all 6 videos")
    require(card["metadata"]["model_type"] == "3d", "3D CLI model type")
    groups = {d: _groups(r["duplicate_groups"]) for d, r in reports.items()}
    require(groups[CARD] == groups["cpu"], f"3D CLI groups differ: {groups}")
    for i in range(2):
        require(any({str(videos / f"video_{i}.mp4"), str(videos / f"video_{i}_copy.mp4")}
                    <= set(g) for g in groups[CARD]), f"3D CLI: copy {i} not grouped")
    cos = min(float(np.dot(card["fingerprints"][p]["embedding"],
                           cpu["fingerprints"][p]["embedding"]))
              for p in card["fingerprints"])
    require(cos >= 0.9999, f"3D CLI card vs CPU cosine {cos}")
    return {"videos": 6, "frames": 320, "groups": len(groups[CARD]),
            "card_vs_cpu_min_cos": cos}


@contextlib.contextmanager
def _counting_decodes():
    """Counts the files the attention scan decodes while the block runs."""
    from video_fingerprint_tpu_torch.data import decode

    real, calls = decode.decode_subsampled, []

    def counted(path, max_frames):
        calls.append(str(path))
        return real(path, max_frames)

    decode.decode_subsampled = counted
    try:
        yield calls
    finally:
        decode.decode_subsampled = real


def _index_cli(torch, workdir: Path, model_path: Path, device: str, storage: str):
    """Library A into an index, library B (a new file and a byte-identical
    re-upload from A) into the same index, a re-scan of A that decodes
    nothing, B against the corpus (tests/test_scanner.py:228-288)."""
    import shutil

    from video_fingerprint_tpu_torch.cli.scan import main
    from video_fingerprint_tpu_torch.inference.index import FingerprintIndex
    from video_fingerprint_tpu_torch.utils.synthetic import make_corpus

    root = Path(tempfile.mkdtemp(dir=workdir, prefix=f"index_{device}_{storage}_"))
    lib_a, lib_b = root / "lib_a", root / "lib_b"
    make_corpus(lib_a, num_unique=4, num_frames=40, duplicates=2)
    make_corpus(lib_b, num_unique=1, num_frames=45, duplicates=0, seed0=50)
    shutil.copy(lib_a / "video_3.mp4", lib_b / "reupload.mp4")
    idx = root / "library.npz"
    base = ["--model", str(model_path), "--device", device, "--workers", "2",
            "--batch", "8", "--index", str(idx), "--index_storage", storage]

    def run(args):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(args)
        require(rc == 0, f"index CLI {device}/{storage} {args[-4:]} exited {rc}")
        return out.getvalue()

    run(base + ["--scan", str(lib_a)])
    require(len(FingerprintIndex.load(idx)) == 6, "library A not indexed")
    run(base + ["--scan", str(lib_b)])
    merged = FingerprintIndex.load(idx)
    require(len(merged) == 8 and merged.storage == storage, f"merge: {len(merged)} entries")
    with _counting_decodes() as calls:
        out = run(base + ["--scan", str(lib_a)])
    require(not calls and "6 unchanged (index hit), 0 to scan" in out,
            f"re-scan of A decoded {calls}")
    result = root / "cross.json"
    run(["--model", str(model_path), "--device", device, "--workers", "2", "--batch", "8",
         "--scan", str(lib_b), "--against", str(idx), "--threshold", "0.999999",
         "--output", str(result)])
    groups = json.loads(result.read_text())["duplicate_groups"]
    src, reup = str(lib_a / "video_3.mp4"), str(lib_b / "reupload.mp4")
    hit = next(({i["path"]: i for i in g} for g in groups if g[0]["path"] == reup), {})
    require(src in hit, f"--against did not pair the re-upload: {groups}")
    require(hit[src]["exact_duplicate"] and hit[reup]["exact_duplicate"], "md5 flag")
    require(abs(hit[src]["similarity"] - 1.0) <= 1e-6,
            f"re-upload similarity {hit[src]['similarity']}")
    return {"groups": sorted(sorted(i["path"].replace(str(root), "") for i in g)
                             for g in groups),
            "reupload_similarity": hit[src]["similarity"]}


def _kernel_times(torch, fn, top: int = 6):
    """Device time by kernel name over one call of fn (torch.profiler), the
    `top` longest, and the share of the call's wall time the card was busy
    (diagnostic: a profiler that fails is reported, not raised)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, getattr(e, "device_time_total", 0.0) / 1e3, e.count)
                for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")]
    except Exception as exc:  # noqa: BLE001 - the breakdown is informative, not a check
        return {"profiler_error": repr(exc)}
    busy = sum(ms for _, ms, _ in rows)
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "busy_share": busy / wall_ms,
            "kernels": [{"name": n[:90], "ms": ms, "calls": c} for n, ms, c in rows[:top]]}


def _search_bound_ms(m: int, n: int, corpus_bytes: int):
    t_ops = 2 * m * n * EMB_DIM / PEAK_FLOPS["float32"] * 1e3
    t_bytes = corpus_bytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _unit_rows(rng, n):
    x = rng.standard_normal((n, EMB_DIM), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _oracle_topk(stored: np.ndarray, queries: np.ndarray, k: int, cosine: bool):
    """float64 top-k of `queries` against `stored` (cosines of both when
    `cosine`), by (score desc, index asc), the corpus read in blocks."""
    q = queries.astype(np.float64)
    if cosine:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    sims = np.empty((len(q), len(stored)))
    for lo in range(0, len(stored), 1 << 16):
        block = stored[lo:lo + (1 << 16)].astype(np.float64)
        if cosine:
            block /= np.linalg.norm(block, axis=1, keepdims=True)
        sims[:, lo:lo + len(block)] = q @ block.T
    idx = np.argsort(-sims, axis=1, kind="stable")[:, :k]
    return sims, idx


def _check_oracle(scores, idx, sims, oracle_idx, what):
    k = oracle_idx.shape[1]
    worst_score = 0.0
    for r in range(len(oracle_idx)):
        kth = sims[r, oracle_idx[r, -1]]
        for j in set(idx[r].tolist()) ^ set(oracle_idx[r].tolist()):
            require(abs(sims[r, j] - kth) <= 1e-6, f"{what}: row {r} differs at {j}")
        ref = sims[r, oracle_idx[r]]
        worst_score = max(worst_score, float(np.abs(scores[r] - ref).max()))
        worst_score = max(worst_score, float(np.abs(scores[r] - sims[r, idx[r]]).max()))
    require(worst_score <= 2e-5, f"{what}: scores off by {worst_score}")
    require(idx.shape[1] == k, what)
    return worst_score


def phase_index(torch, workdir: Path, model_path: Path):
    from video_fingerprint_tpu_torch.inference.index import (
        FingerprintIndex,
        bf16_bits,
        bf16_values,
    )
    from video_fingerprint_tpu_torch.ops.topk import topk_cosine, topk_search
    from video_fingerprint_tpu_torch.utils.timing import cuda_ms

    # (a) the CLI flow, on the card and on the CPU, f32 and bf16 storage
    flows = {}
    for storage in ("f32", "bf16"):
        _zero_launches()
        card = _index_cli(torch, workdir, model_path, CARD, storage)
        launches = _launches()
        cpu = _index_cli(torch, workdir, model_path, "cpu", storage)
        require(card["groups"] == cpu["groups"], f"index CLI {storage}: card {card} cpu {cpu}")
        require(launches["attention"] > 0, "the index CLI's scans did not run K1")
        flows[storage] = {**card, "attention_launches": launches["attention"]}

    # (b) 1,000,000 seeded unit rows with 256 planted near copies
    rng = np.random.default_rng(SEED + 5)
    corpus = _unit_rows(rng, INDEX_ROWS)
    src, dst = np.split(rng.choice(INDEX_ROWS, 512, replace=False), 2)
    noisy = corpus[src] + rng.standard_normal((256, EMB_DIM), dtype=np.float32) * 0.002
    corpus[dst] = noisy / np.linalg.norm(noisy, axis=1, keepdims=True)
    planted_cos = np.sum(corpus[src] * corpus[dst], axis=1)
    require(bool(planted_cos.min() >= 0.999), f"planted cosine {planted_cos.min()}")
    queries = np.concatenate([corpus[src], corpus[dst],
                              corpus[rng.choice(INDEX_ROWS, 2048, replace=False)],
                              _unit_rows(rng, INDEX_QUERIES - 2560)])
    checked = np.concatenate([np.arange(8), 256 + np.arange(4), 3000 + np.arange(4)])
    search = {}
    for storage in ("f32", "bf16"):
        index = FingerprintIndex(dim=EMB_DIM, device=CARD, storage=storage)
        index.add(corpus)
        _zero_launches()
        t0 = time.perf_counter()
        scores, idx = index.search(queries, k=20, exact_above=0.99)
        first_s = time.perf_counter() - t0  # the corpus upload included
        t0 = time.perf_counter()
        scores, idx = index.search(queries, k=20, exact_above=0.99)
        search_s = time.perf_counter() - t0
        require(not any(_launches().values()), "a hand kernel ran in the index search")
        for j in range(256):  # every planted copy, from both sides
            for row, other in ((j, dst[j]), (256 + j, src[j])):
                hits = dict(zip(idx[row].tolist(), scores[row].tolist()))
                require(hits.get(int(other), -1.0) >= 0.99,
                        f"{storage}: planted copy {j} not found ({row})")
        cosine = storage == "bf16"
        stored = bf16_values(bf16_bits(corpus)) if cosine else corpus
        q = bf16_values(bf16_bits(queries[checked])) if cosine else queries[checked]
        sims, oracle_idx = _oracle_topk(stored, q, 20, cosine)
        err = _check_oracle(scores[checked], idx[checked], sims, oracle_idx, storage)
        del sims, stored
        staged = index._corpus()
        q_dev = torch.from_numpy(queries).to(CARD)
        ms = cuda_ms(lambda: topk_search(q_dev, staged, 20, exact_above=0.99))
        bound_ms, bound_by = _search_bound_ms(INDEX_QUERIES, INDEX_ROWS,
                                              staged.numel() * staged.element_size())
        search[storage] = {"ms": ms, "queries_per_s": INDEX_QUERIES / ms * 1e3,
                           "bound_ms": bound_ms, "bound_by": bound_by,
                           "search_s": search_s, "first_search_s": first_s,
                           "oracle_rows": len(checked), "max_score_err": err,
                           "planted_min_cos": float(planted_cos.min()),
                           "profile": _kernel_times(torch, lambda: topk_search(
                               q_dev, staged, 20, exact_above=0.99))}
        del index, staged, q_dev
        torch.cuda.empty_cache()
    del corpus

    # (c) the scanner's top-k duplicate search at library size
    emb = _unit_rows(rng, SELF_SEARCH_ROWS)
    emb[1::1000] = emb[::1000][: len(emb[1::1000])]  # byte-identical copies
    e_dev = torch.from_numpy(emb).to(CARD)
    scores, idx = (t.cpu().numpy() for t in topk_cosine(e_dev, 20, exact_above=0.99))
    rows = np.arange(0, SELF_SEARCH_ROWS, SELF_SEARCH_ROWS // 16)
    sims, oracle_idx = _oracle_topk(emb, emb[rows], 20, cosine=False)
    err = _check_oracle(scores[rows], idx[rows], sims, oracle_idx, "self-search")
    for r in range(0, SELF_SEARCH_ROWS, 1000):
        require(set(idx[r, :2].tolist()) == {r, r + 1},
                f"self-search: row {r}'s first two are {idx[r, :2]}, not itself and its copy")
    ms = cuda_ms(lambda: topk_cosine(e_dev, 20, exact_above=0.99), window_ms=500)
    bound_ms, bound_by = _search_bound_ms(SELF_SEARCH_ROWS, SELF_SEARCH_ROWS, emb.nbytes)
    search["self_100k"] = {"ms": ms, "queries_per_s": SELF_SEARCH_ROWS / ms * 1e3,
                           "bound_ms": bound_ms, "bound_by": bound_by, "max_score_err": err,
                           "profile": _kernel_times(torch, lambda: topk_cosine(e_dev, 20))}
    emit({"phase": "index", "cli": flows, "rows": INDEX_ROWS, "queries": INDEX_QUERIES,
          "k": 20, "search": search})


# ---------------------------------------------------------------- training

TRAIN_HEAD_DIMS = (4, 16, 64)
TRAIN_B, TRAIN_T = 64, 64       # the timed train steps
CHECK_B, CHECK_T = 8, 64        # the card step held against the CPU step
TRAIN_LR, TRAIN_TOTAL_STEPS, TRAIN_CHECK_STEP = 1e-4, 10, 5
# the CPU's f32 BatchNorm backward sums 10^5-10^6 values per channel in an
# order that depends on its thread count, which moves the grads by up to a
# few 1e-3 of their norm; the loss and the running statistics are forward
# sums
STEP_TOL = {"loss": 1e-4, "grad_norm": 5e-3, "grads": 2e-2, "bn": 1e-4}
TIMED_STEPS, WARM_STEPS = 10, 3


def _train_head_dims(torch):
    """K1 at head dims 4, 16 and 64 (B = 64 videos x 8 heads, T = 128, f32
    and bf16, a ragged mask with a leading-masked and a fully masked row)
    against its plain version; device time beside the bound at the true D."""
    from video_fingerprint_tpu_torch.ops import attention as attn
    from video_fingerprint_tpu_torch.utils.precision import full_fp32
    from video_fingerprint_tpu_torch.utils.timing import graph_ms

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for D in TRAIN_HEAD_DIMS:
            T = 128
            q, k, v = (torch.randn((BATCH, HEADS, T, D), device="cuda", generator=g).to(dtype)
                       for _ in range(3))
            mask = _ragged_mask(torch, T, g)
            bias = attn._key_bias(mask, (BATCH, T), q.device)[:, None, :]
            before = attn.launches
            out = attn.multihead_attention(q, k, v, mask)
            torch.cuda.synchronize()
            require(attn.launches == before + 1, f"D={D}: no kernel launch")
            with full_fp32():
                plain = attn._attention_torch(q, k, v, bias)
            err = (out.float() - plain.float()).abs().max().item()
            require(out.shape == q.shape and bool(torch.isfinite(out).all()),
                    f"{dname} D={D}: bad output")
            require(err <= TOLERANCE[dname], f"{dname} D={D}: max abs err {err}")
            kernel_ms = graph_ms(lambda: attn.multihead_attention(q, k, v, mask))
            with full_fp32():
                plain_ms = graph_ms(lambda: attn._attention_torch(q, k, v, bias))
            bound_ms, bound_by = attention_bound_ms(BATCH * HEADS, T, dname, mask.numel(), D)
            rows.append({"dtype": dname, "D": D, "T": T, "kernel_width": attn.kernel_width(D),
                         "max_abs_err": err, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by})
            emit({"phase": "train", "check": "head_dim", **rows[-1]})
    return rows


def _train_batch(torch, rng, B: int, T: int, device):
    """Seeded uint8 64x64 clip pairs with ragged lengths (zero padding and
    masks), video ids with repeats (triplets have positives)."""
    clips = np.zeros((2, B, T, 64, 64, 3), np.uint8)
    masks = np.zeros((2, B, T), bool)
    for side in range(2):
        for i in range(B):
            t = T if i == 0 else int(rng.integers(T // 2, T + 1))
            clips[side, i, :t] = _seeded_clip(rng, t)
            masks[side, i, :t] = True
    ids = np.arange(B, dtype=np.int32) % max(1, B - B // 4)
    batch = {"clip1": clips[0], "clip2": clips[1], "mask1": masks[0], "mask2": masks[1],
             "video_id": ids}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _train_setup(torch, model_type: str, device, dropout: bool = True, **step_kwargs):
    """A seeded full-width model on `device`, its AdamW and train step."""
    from video_fingerprint_tpu_torch.models import create_model
    from video_fingerprint_tpu_torch.training.optim import make_optimizer
    from video_fingerprint_tpu_torch.training.train_step import make_train_step

    torch.manual_seed(SEED)
    model = create_model(model_type, frame_stride=STRIDE_3D).to(device)
    if not dropout:
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    opt = make_optimizer(model_type, model, TRAIN_LR, total_steps=TRAIN_TOTAL_STEPS,
                         epochs=2, steps_per_epoch=TRAIN_TOTAL_STEPS // 2)
    return model, opt, make_train_step(model, opt, model_type, **step_kwargs)


def _train_card_vs_cpu(torch):
    """One train step of the seeded full-width attention model on the card
    and on the CPU, from the same weights, batch (B = 8, T = 64, ragged
    masks) and extract draws, dropout off, f32 with TF32 off, at step 5 of
    a 10-step schedule (LR 1e-4 x group factor, the optimizer's first
    update). Loss within 1e-4 and grad norm within 5e-3 relative, the
    clipped grads within 2e-2 relative in global L2 norm, BN running
    statistics within 1e-4 relative; params: AdamW's first update is
    LR x g / (|g| + 1e-8), which turns a small grad's rounding into a
    step anywhere between -LR and LR, so every element within twice its
    group's LR (the count past 1e-3 LR is reported). The train forward
    launches K1 0 times, and every block's in_proj weight gets a nonzero
    grad."""
    from video_fingerprint_tpu_torch.ops import attention as attn
    from video_fingerprint_tpu_torch.training.optim import param_group_label
    from video_fingerprint_tpu_torch.training.train_step import draw_extracts

    rng = np.random.default_rng(SEED + 2)
    batch = _train_batch(torch, rng, CHECK_B, CHECK_T, "cpu")
    draws = draw_extracts(torch.Generator().manual_seed(SEED), CHECK_B, CHECK_T, 0.5)
    outs, models, grads = {}, {}, {}
    for device in ("cuda", "cpu"):
        model, opt, step = _train_setup(torch, "attention", device, dropout=False)
        before = attn.launches
        out = step({k: v.to(device) for k, v in batch.items()}, draws, TRAIN_CHECK_STEP)
        if device == "cuda":
            torch.cuda.synchronize()
            require(attn.launches == before, "the train forward launched the attention kernel")
            for i, block in enumerate(model.attention_blocks):
                grad = block.attn.in_proj_weight.grad
                require(grad is not None and bool((grad != 0).any()),
                        f"attention_blocks.{i}.attn.in_proj_weight has no grad")
        outs[device] = {k: float(v) for k, v in out.items()}
        params = {k for k, _ in model.named_parameters()}
        models[device] = {k: v.detach().cpu() for k, v in model.state_dict().items()
                          if k in params or "running_" in k}
        grads[device] = torch.cat([p.grad.detach().cpu().double().ravel()
                                   for p in model.parameters()])
        lrs = {g["label"]: g["lr"] for g in opt.param_groups}
    rel = {k: abs(outs["cuda"][k] - outs["cpu"][k]) / abs(outs["cpu"][k])
           for k in ("loss", "grad_norm")}
    worst, past, total, bn_worst = 0.0, 0, 0, 0.0  # param gaps in units of their LR
    for key, cpu in models["cpu"].items():
        diff = (models["cuda"][key] - cpu).abs()
        if "running_" in key:
            bn_worst = max(bn_worst, float((diff / cpu.abs().clamp_min(1.0)).max()))
            continue
        lr = lrs[param_group_label(key)]
        worst = max(worst, float(diff.max()) / lr)
        past += int((diff > 1e-3 * lr).sum())
        total += diff.numel()
    rel["grads"] = float(torch.linalg.vector_norm(grads["cuda"] - grads["cpu"])
                         / torch.linalg.vector_norm(grads["cpu"]))
    result = {"card": outs["cuda"], "cpu": outs["cpu"], "rel_gap": rel, "lrs": lrs,
              "param_max_gap_in_lr": worst, "params_past_1e-3_lr": past,
              "param_elements": total,
              "bn_rel_gap": bn_worst, "attention_launches_in_train": 0}
    emit({"phase": "train", "check": "card_vs_cpu", **result})
    for k, r in rel.items():
        require(r <= STEP_TOL[k], f"card vs CPU step: {k} relative gap {r}")
    require(bn_worst <= STEP_TOL["bn"], f"card vs CPU BN running statistics gap {bn_worst}")
    require(worst <= 2.001, f"card vs CPU params: max gap {worst} LR")
    return result


def _train_steps_per_s(torch, model_type: str, B: int, T: int, bf16: bool, fast: bool,
                       profile: bool = False):
    """Train steps per second at full width on seeded ragged clips: WARM_STEPS
    steps, then TIMED_STEPS on the host clock ending in a synchronize (the
    extract draws are made on the host and copied per step, as the trainer
    does); peak device memory; K1 launches (0 expected)."""
    from video_fingerprint_tpu_torch.ops import attention as attn
    from video_fingerprint_tpu_torch.training.train_step import draw_extracts

    rng = np.random.default_rng(SEED + 3)
    batch = _train_batch(torch, rng, B, T, "cuda")
    if model_type != "attention":
        batch = {k: v for k, v in batch.items() if not k.startswith("mask")}
    model, _, step = _train_setup(torch, model_type, "cuda", bf16=bf16,
                                  reuse_extract_features=fast)
    gen = torch.Generator().manual_seed(SEED)
    draws = (lambda: draw_extracts(gen, B, T, 0.5)) if model_type == "attention" else (
        lambda: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = attn.launches
    n = 0
    for _ in range(WARM_STEPS):
        out = step(batch, draws(), n)
        n += 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        out = step(batch, draws(), n)
        n += 1
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    loss = float(out["loss"])
    require(np.isfinite(loss), f"{model_type} bf16={bf16} fast={fast}: loss {loss}")
    require(attn.launches == before, "a train step launched the attention kernel")
    row = {"model": model_type, "B": B, "T": T, "dtype": "bfloat16" if bf16 else "float32",
           "fast_extracts": fast, "steps_per_s": TIMED_STEPS / seconds,
           "ms_per_step": seconds / TIMED_STEPS * 1e3,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "last_loss": loss}
    if profile:
        row["profile"] = _kernel_times(torch, lambda: step(batch, draws(), n), top=8)
    del model, step, batch
    torch.cuda.empty_cache()
    emit({"phase": "train", "check": "steps", **row})
    return row


def _train_cli(torch, workdir: Path):
    """The train CLI on the card on a seeded mp4 corpus (16 videos), 2 epochs:
    the run-dir artifacts, K1 launched in validation and not in the train
    steps, a resume from last.ckpt at the next epoch with the step counter
    carried, and a scan of the corpus on the card with best.ckpt."""
    import os

    from video_fingerprint_tpu_torch.cli.train import main
    from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner
    from video_fingerprint_tpu_torch.ops import attention as attn
    from video_fingerprint_tpu_torch.training import checkpoint as ckpt
    from video_fingerprint_tpu_torch.training.trainer import Trainer
    from video_fingerprint_tpu_torch.utils.synthetic import make_corpus

    videos = workdir / "train_videos"
    make_corpus(videos, num_unique=14, num_frames=40, duplicates=2)
    counts = {"train_epoch": 0, "validate": 0}
    originals = {name: getattr(Trainer, name) for name in counts}

    def counted(name):
        def run(self, *args, **kwargs):
            before = attn.launches
            out = originals[name](self, *args, **kwargs)
            counts[name] += attn.launches - before
            return out
        return run

    args = ["--data_dir", str(videos), "--batch_size", "4", "--num_workers", "4",
            "--max_frames", "64"]
    cwd = os.getcwd()
    try:
        os.chdir(workdir)
        for name in counts:
            setattr(Trainer, name, counted(name))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = main(args + ["--epochs", "2", "--run_name", "smoke"])
        first_s = time.perf_counter() - t0
        require(rc == 0, f"train CLI exited {rc}")
        run = workdir / "runs" / "smoke"
        for name in ("config.json", "training_info.txt", "training_log.txt",
                     "training_summary.txt", "checkpoints/last.ckpt", "checkpoints/best.ckpt",
                     "checkpoints/best_metrics.json", "checkpoints/epoch_0.ckpt"):
            require((run / name).exists(), f"train CLI left no {name}")
        require(counts["validate"] > 0, "validation did not launch the attention kernel")
        require(counts["train_epoch"] == 0, "the train steps launched the attention kernel")
        last = ckpt.load_checkpoint(run / "checkpoints/last.ckpt")["train"]
        steps_per_epoch = last["global_step"] // 2
        require(last["epoch"] == 1 and steps_per_epoch > 0, f"last.ckpt counters {last}")
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = main(args + ["--epochs", "3", "--run_name", "smoke_resume",
                              "--checkpoint", str(run / "checkpoints/last.ckpt")])
        require(rc == 0 and "Resumed from epoch 2" in out.getvalue(), "resume did not run")
        resumed = ckpt.load_checkpoint(workdir / "runs/smoke_resume/checkpoints/last.ckpt")
        require(resumed["train"]["epoch"] == 2
                and resumed["train"]["global_step"] == 3 * steps_per_epoch,
                f"resumed counters {resumed['train']}")
    finally:
        for name, fn in originals.items():
            setattr(Trainer, name, fn)
        os.chdir(cwd)
    before = attn.launches
    with contextlib.redirect_stdout(io.StringIO()):
        scanner = FingerprintScanner(str(run / "checkpoints/best.ckpt"), device="cuda",
                                     batch_size=8)
        fps = scanner.scan_directory(videos, num_workers=4)
    torch.cuda.synchronize()
    E = np.stack([fp["embedding"] for fp in fps.values()])
    require(len(fps) == 16 and bool(np.isfinite(E).all())
            and float(np.abs(np.linalg.norm(E, axis=1) - 1).max()) < 1e-5,
            "best.ckpt scan: bad fingerprints")
    require(attn.launches > before, "the scan of best.ckpt did not launch the kernel")
    val = json.loads((run / "checkpoints/best_metrics.json").read_text())["val"]
    return {"videos": 16, "epochs": 2, "steps_per_epoch": steps_per_epoch,
            "first_run_s": first_s, "attention_launches": dict(counts),
            "resumed_epoch": resumed["train"]["epoch"],
            "resumed_global_step": resumed["train"]["global_step"],
            "val_auc_roc": val.get("auc_roc"), "scan_videos": len(fps)}


def phase_train(torch, workdir: Path, smi: str):
    """Training on the card: K1 at the head dims training configs use, the
    card's train step against the CPU's, steps/s in five configurations,
    the train CLI with validation, resume and a scan of its best.ckpt."""
    t0 = time.perf_counter()
    head_dims = _train_head_dims(torch)
    check = _train_card_vs_cpu(torch)
    configs = [("attention", TRAIN_B, TRAIN_T, bf16, fast)
               for bf16 in (False, True) for fast in (False, True)]
    configs.append(("3d", 2 * TRAIN_B, CLIP_LENGTH, False, False))
    speed = [_train_steps_per_s(torch, *c, profile=(c == configs[0])) for c in configs]
    cli = _train_cli(torch, workdir)
    emit({"phase": "train", "smi": smi, "head_dims": head_dims, "card_vs_cpu": check,
          "steps": speed, "cli": cli, "seconds": time.perf_counter() - t0})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = phase_info(torch)
    phase_build()
    att = phase_attention(torch)
    with tempfile.TemporaryDirectory(prefix="vfp_chip_smoke_") as tmp:
        launches, model_path = phase_scan(torch, Path(tmp))
        phase_cli(torch, Path(tmp), model_path)
        conv = phase_convblock(torch, model_path)
        phase_scan3d(torch, Path(tmp))
        phase_index(torch, Path(tmp), model_path)
        phase_train(torch, Path(tmp), smi)
    main_case = att[("float32", 128)]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi)
    emit({"kernels": [{
        "name": "attention",
        "route": "cuda",
        "source": "video_fingerprint_tpu_torch/csrc/attention.cu",
        "replaces": "video_fingerprint_tpu/ops/attention.py:31",
        "launches": launches,
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "video_fingerprint_tpu_torch/csrc/conv3x3s2.cu",
        "replaces": replaces,
        **{key: conv[name][key] for key in ("launches", "max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by", "library_ms")},
    } for name, replaces in (("conv_parity", "tools/exp_pallas_convblock.py:97"),
                             ("conv_strided", "tools/exp_pallas_convblock.py:74"))]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

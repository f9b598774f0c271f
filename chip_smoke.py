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
     (device time by CUDA-graph replay, and per call).

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


def attention_bound_ms(BH: int, T: int, dtype_name: str, mask_bytes: int):
    """Least time for one attention call: q, k, v read once and o written
    once (+ the key mask) at HBM rate, vs 4*BH*T^2*D operations at the peak
    rate for the inputs' type."""
    elt = 4 if dtype_name == "float32" else 2
    nbytes = 4 * BH * T * HEAD_DIM * elt + mask_bytes
    flops = 4 * BH * T * T * HEAD_DIM
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

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root, one card
    python3 chip_smoke.py --phases index,train   # a subset, in the order below

Phases, each of which raises (exit code 1) on any failure:

  1. print the card's name and power limit and the nvcc version; build every
     CUDA source of the port (one nvcc per source, all started together);
  2. hold the attention kernel (csrc/attention.cu) against its plain PyTorch
     version at the scan's shapes (64 videos x 8 heads, D = 32, every bucket
     length T and T = 1000, float32 and bfloat16, ragged rows, a row whose
     first 64 keys are masked, fully masked rows; and the benchmark
     headline's 512 videos x 8 heads at T = 128 in bfloat16), and time it
     beside the plain version and F.scaled_dot_product_attention: device
     time from CUDA graph replay, and the time per call through the Python
     wrapper; then the wide kernel at head dims 96, 128, 160 and 256, f32
     and bf16, T = 1, 65, 128 and 500 (ragged rows, a first key tile
     masked, a fully masked row), each launched once and held against the
     plain version, timed at T = 128 beside SDPA and the bound;
  3. the scan at full width: a seeded attention model written as a
     reference-layout .pth, FingerprintScanner(device="cuda", batch_size=64)
     fed ~200 seeded uint8 64x64 clips covering every bucket with planted
     byte-identical copies, duplicate search through the direct and the top-k
     path, all checked against the port's CPU path; the kernel's launch count
     shows the scan went through it; videos/s at bucket 128 (every
     batching-stage leg of phases 3, 6, 10 and 11 also gives its fill's
     GB/s, its pooled fills and the fill pool's threads); then the same
     weights under max_frames = 1000 (a checkpoint's config may name any
     length), three clips of 600-1000 frames on the card against the CPU;
     the same clips in a bf16 scan (the benchmark's precision), whose frame
     stem is K6 (csrc/stem.cu, one launch a forward; the f32 scan launches
     none), against the f32 scan, and its frame features against the bf16
     model's unfused path; K6 against its plain version at 64 videos x
     every bucket length, a frame count that leaves the persistent grid's
     last round ragged, all-0 and all-255 frames, a batch 5 frames in and
     the other frame shapes it takes (channels 0-2 made the identity of
     the centre tap, so the normalised input is read bit for bit), and its
     device time at 64 x 500 frames beside the byte bound, the plain
     version, cuDNN's conv + bias + ReLU and the whole unfused chain;
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
     100,000 x 256; their times beside the bound; the exact search's
     kernel (csrc/topk.cu, K5) at the benchmark's 256 queries x 10^6 x
     256, k = 20, f32 and bf16 storage: its launches (also counted around
     the index's searches above), its rows against the plain version's, and its device time beside the bound, the plain
     version and the library yardstick (torch.matmul + torch.topk per
     block, which the port never calls);
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
     a scan of the corpus with its best.ckpt on the card;
  9. device augment (ops/device_augment.py): apply_augmentations on the
     card and on the CPU at B = 64, T = 64, 64x64 with the same params and
     noise, each transform alone (every gate forced on) and two whole
     pipelines (every gate on; a sampled draw, per-frame params): within
     1e-5, color by the share of elements within 1e-5 (>= 99.99 %); the
     augmented pair batch's ms on the card; train steps/s with
     device_augment for attention f32 and bf16 (B = 64, T = 64) and 3D f32
     (B = 128 x 128); loader clips/s at the train CLI's defaults on 8
     640x360 x 300-frame mp4s, host against device augment mode, 4
     workers; the train CLI with --device_augment for an epoch (artifacts,
     K1 launched in validation only);
 10. the native host paths (utils/native.py, utils/native_decode.py, g++
     builds of native/*.cc): whether each library built, and for one that
     did not, the scanner's message; one worker's decode frames/s
     (tools/bench_decode_percore.py: cv2, and vfp_decode where it built,
     on 96x128 mp4s); on the 34 mp4s phase 9 writes, host
     decode videos/s of the scan's producer (4 workers) with cv2 and with
     each native path that built, and the attention scan on the card in
     each mode (--native_decode stages uint8, --native_preprocess float32)
     against the cv2 scan (cosine >= 0.999, equal duplicate groups), with
     the decode scan's and the batching stage's videos/s per mode; where
     vfp_decode built, also decode_scan against the cv2 path (mean |diff| <
     3) and the 3D scan with --native_decode against the cv2 3D scan;
 11. multi-device, every path on the one card (a device list that repeats
     cuda:0, or ranks that share it): the data-parallel scan of phase 3's
     clips over 4 shards and phase 6's 3D scan over 2, held against
     the one-card scan (cosine >= 0.9999, equal groups through the direct
     and the sharded ring top-k), K1 launched 4 times per forward per
     shard, videos/s at bucket 128 per shard count; sharded_topk_search
     over 4 shards on phase 7's 10^6 index (f32 and bf16 storage) and the
     ring sharded_topk_cosine on its 10^5 self-search, held against the
     one-card exact search (indices equal, scores within 1e-5) and the
     float64 oracle, with the certified methods to phase 7's contracts and
     ms beside the one-card ms; two spawned gloo ranks on cuda:0, each with
     half of a global batch (attention B = 64, T = 64, 2 steps; 3D B = 128,
     one step), held against the same steps in one process (loss, grad
     norm, params, BN statistics); the train CLI for one epoch under
     `python -m torch.distributed.run --standalone --nproc_per_node 1`
     (NCCL, world 1), with its artifacts, K1 in validation only and its
     steps/s. Its times are k shards or ranks on one card: the cost of
     sharding, not a speed-up;
 12. multiple processes, on the one card: the fused space-to-depth model
     (conv0 a 3x3 stride-1 conv over 2x2 blocks) through the scan's
     batching stage on phase 3's weights and clips against the standard
     fused model (cosine >= 0.9999, K1 launched 4 times per forward), and
     conv0 in both layouts at 64 x 128 frames (CUDA-graph replay); two
     spawned gloo ranks sharing cuda:0, each reading phase 7's data from a
     file this process writes and staging its half: sharded_topk_search of the 4,096
     queries over the 10^6 x 256 index at k = 20 in f32 and bf16 storage
     and the ring sharded_topk_cosine on the 10^5 self-search, every method
     (exact, certified strict, certified and certified-bf16 at 0.95), held
     to the one-process search (both ranks' results identical; exact:
     indices equal, scores within 1e-5; strict: exact's scores; the
     threshold methods: phase 7's contracts against the float64 oracle),
     with each rank's ms, its ms in collectives, the one-process ms and the
     bound; FingerprintIndex.search across the ranks equal to one
     process's; tools/multiproc_dedup.py under `python -m
     torch.distributed.run --standalone` with 2 gloo ranks on cuda:0 and,
     at the same time, with 1 rank on NCCL. A rank that fails or hangs
     fails the phase;
 13. the benchmark program (`python -m video_fingerprint_tpu_torch.tools.bench`,
     a budget of BENCH_BUDGET seconds): its legs' subprocesses (the
     reference baseline, the headline at B = 512, T = 128 in bf16 by CUDA
     graph replay, pipelined, per batch and streaming, training steps/s,
     the e2e scan of 60 synthetic mp4s with decode, the 10^5 dedup search
     per top-k method with --planted --verify) and its last line, which
     must carry the headline's metric, unit, regime, a rate > 0, an MFU in
     (0, 1], K1 launched 4 times per forward and per captured graph, every
     later leg's keys or its name in skipped_legs, no failed leg, every
     planted e2e copy grouped with its original and every dedup method
     verified; then the headline's first 8 bf16 embeddings (saved by the
     leg with their frames) against the same seeded weights' f32 forward
     on the card (cosine >= 0.999, K1 launched 4 times);
 14. the stage profile (tools/profile_extraction.py) at the headline's
     shape: the full / spatial / temporal split per configuration, the
     cumulative legs of the bf16 forward (convert, each conv, spatial,
     full) with cudnn.benchmark off and on beside their byte and operation
     bounds, the conv0 probes (widened conv0, s2d in f32 and bf16), the top
     device kernels of one forward by name; the stages chain to
     forward_flat and the full leg lands within 10 % of
     headline_forward_ms timed in the same process;
 15. the graft entry points (tools/graft_entry.py): entry()'s forward on the card
     (K1 launched 4 times, against the CPU forward of the same variables),
     then dryrun_multichip(4) over cuda:0 four times (gloo ranks for the
     data-parallel steps), every program against its one-device oracle;
 16. the measurement tools (tools/*.py), each once on the card at the JAX
     tools' default sizes, one after another in one child process
     (`chip_smoke.py --tools-child`, torch's flags put back and the card
     settled between tools): device augment placement
     (loader samples/s per mode, steps/s with device augment off and on) and
     the augment hotspot (B = 16, T = 64, ms per stage by CUDA-graph
     replay); train steps/s with a sync every step and every 10 (B = 64,
     T = 64, f32 and bf16) and the train roofline's four legs; the streaming
     validation metrics at 10^5 embeddings; the trajectory corpus (24
     videos, its stamp); K1 against the plain version and SDPA at every scan
     bucket (B·H = 16 x 8; D = 32, 4, 16, 64; f32 and bf16) and at B = 64 x 8,
     T = 128, K1 launched once per captured call and equal to the plain
     version; the top-k probes at 10^5 rows (precision, blocked, certified,
     bf16 sims, production: every result verified against exact) and the
     wide probe at 10^6; the probes of the headline's input and conv stack
     at N = 16,384 frames: the uint8 convert by layout alone and feeding
     conv0 (exp_input_layout), one elementwise pass by layout and the
     transpose round trip (exp_layout_probe, B = 16, T = 64), the int8 conv
     stack on the hand-written int8 conv (csrc/conv_int8.cu, K4) against
     the bf16 cuDNN stack (exp_int8_conv, K4 launched by both int8 legs),
     and K forwards in one CUDA graph against K dispatched forwards
     (exp_ingraph_forward, B = 512, T = 128, K1 launched by every forward).
     Every key present, every rate > 0, no leg that printed an error. Then
     the in-graph forward's f32 sum against eager forwards, and K4 against
     its plain version on the probe's four layers (5x5 3 -> 32 on 64x64
     frames, then 3x3 32 -> 64 -> 128 -> 256) at 256 and 5 frames: the
     int32 sums and the int8 and bf16 outputs bit for bit; each layer timed
     at 16,384 frames beside the plain version, its bound, and for conv1
     torch._int_mm on its im2col matrix and cuDNN's bf16 conv;
 17. TimeSformer-Base (models/timesformer.py) at its published widths in
     bf16, 64 windows of 8 frames at 224 px: K1 at both of its shapes
     (temporal, 64·196 sequences x 12 heads of T = 8; spatial, 64·8 x 12
     of T = 197; D = 64, no mask), on strided views of a real qkv
     projection of layer 0, against the plain version, timed beside it, SDPA
     and the bound; then one forward with K1's counters read just before
     and after it: 24 launches, `k1.rows_launched` and `k1.rows_useful` as
     reckoned from QUERY_TILE, no softmax or library attention kernel
     among its kernels, and its device time by kernel.

Phases 7, 11 and 12 draw the 10^6 index and the self-search rows once and
compute their float64 oracles once (_index_data, _oracle).

Phase 7 also runs the certified top-k methods ("certified" strict and with
exact_above = 0.95, "certified-bf16") on the 10^6-row index in both
storages and on the 10^5 self-search, against the float64 oracle (strict:
exact's score multiset; threshold: complete above 0.95, scores within
2e-5), with the rows repaired and each method's ms beside exact's and the
bound.

Before each phase the script waits for the card, collects garbage and
empties the allocator's cache, so no phase inherits another's memory
state; each timed train-step row also reports the host CPU ms per step,
the card's busy share under torch.profiler, and the process's threads, the
allocator's cudaMalloc/cudaFree counts and the card's clocks, temperature
and power around the timed steps.

The 3D path has no hand-written kernel (cuDNN runs its convs, as XLA does
in the JAX package): its runs hold every hand kernel's launch count at
zero. The index path's exact search is K5 alone: the index's own searches,
the CLI's --against search and the sharded search (one search a shard)
hold K1, K2 and K3 at zero and K5 at two launches a search. Train-mode
attention is plain torch math, as in the JAX package; K1 runs in
validation.

The second-to-last line is {"kernels": [...]}, one entry per kernel of the
path; the last line is {"ok": true, "device": {...}}. Needs no network.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import hashlib
import io
import json
import os
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
HEADLINE_BATCH = 512  # the benchmark headline's batch (tools/bench_headline.py)
WIDE_HEAD_DIMS = (96, 128, 160, 256)  # K1's wide kernel: one and two 128-column chunks
WIDE_T = (1, 65, 128, 500)
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
    """Kernel vs plain version at every bucket T and T = 1000, f32 and bf16,
    at the scan's B = 64; and at the benchmark headline's B = 512, T = 128
    in bf16 (its 4,096 instances)."""
    import torch.nn.functional as F

    from video_fingerprint_tpu_torch.ops import attention as attn
    from video_fingerprint_tpu_torch.utils.precision import full_fp32
    from video_fingerprint_tpu_torch.utils.timing import cuda_ms, graph_ms

    g = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    cases = [(dtype, T, BATCH) for dtype in (torch.float32, torch.bfloat16)
             for T in ATTENTION_T] + [(torch.bfloat16, 128, HEADLINE_BATCH)]
    for dtype, T, batch in cases:
        dname = str(dtype).split(".")[-1]
        shape = (batch, HEADS, T, HEAD_DIM)
        q, k, v = (torch.randn(shape, device="cuda", generator=g).to(dtype)
                   for _ in range(3))
        lengths = torch.randint(1, T + 1, (batch,), device="cuda", generator=g)
        lengths[0] = T
        mask = torch.arange(T, device="cuda")[None, :] < lengths[:, None]
        if T > 64:  # the first key tile wholly masked, later keys valid
            mask[1] = torch.arange(T, device="cuda") >= 64
        mask[-1] = False  # one instance with every key masked
        bias = attn._key_bias(mask, (batch, T), q.device)[:, None, :]

        out = attn.multihead_attention(q, k, v, mask)
        torch.cuda.synchronize()
        with full_fp32():
            plain = attn._attention_torch(q, k, v, bias)
        err = (out.float() - plain.float()).abs().max().item()
        require(bool(torch.isfinite(out).all()), f"{dname} B={batch} T={T}: non-finite output")
        require(err <= TOLERANCE[dname], f"{dname} B={batch} T={T}: max abs err {err}")
        # a fully masked row gets uniform weights: the mean of v
        uniform = v[-1].float().mean(dim=1, keepdim=True).expand(HEADS, T, HEAD_DIM)
        err_uniform = (out[-1].float() - uniform).abs().max().item()
        require(err_uniform <= TOLERANCE[dname],
                f"{dname} B={batch} T={T}: fully masked row err {err_uniform}")
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
        bound_ms, bound_by = attention_bound_ms(batch * HEADS, T, dname,
                                                mask.numel())
        row = {"phase": "attention", "dtype": dname, "T": T, "BH": batch * HEADS,
               "max_abs_err": err, "err_uniform_row": err_uniform,
               "err_leading_masked_row": err_leading, "err_vs_f64": err_f64,
               "kernel_ms": kernel_ms, "kernel_call_ms": kernel_call_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_call_ms": library_call_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        if T == 128 and batch == BATCH:  # which kernels the yardstick runs
            with full_fp32():
                row["library_kernels"] = _device_kernels(torch, library)
        emit(row)
        results[(dname, T) if batch == BATCH else (dname, T, batch)] = row
    results["wide"] = _attention_wide_heads(torch, g)
    return results


def _attention_wide_heads(torch, g):
    """K1 at head dims past 64 (the wide kernel: 128-column chunks, D = 96
    zero-padded in shared memory), f32 and bf16, at T = 1, 65, 128 and 500
    with a ragged mask, a first key tile wholly masked and a fully masked
    row: one launch each, against the plain version; at T = 128 its device
    time beside the plain version, SDPA and the bound at the true D."""
    import torch.nn.functional as F

    from video_fingerprint_tpu_torch.ops import attention as attn
    from video_fingerprint_tpu_torch.utils import trace
    from video_fingerprint_tpu_torch.utils.precision import full_fp32
    from video_fingerprint_tpu_torch.utils.timing import graph_ms

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for D in WIDE_HEAD_DIMS:
            for T in WIDE_T:
                q, k, v = (torch.randn((BATCH, HEADS, T, D), device="cuda", generator=g)
                           .to(dtype) for _ in range(3))
                mask = _ragged_mask(torch, T, g)
                bias = attn._key_bias(mask, (BATCH, T), q.device)[:, None, :]
                before = trace.counter("k1.launches")
                out = attn.multihead_attention(q, k, v, mask)
                torch.cuda.synchronize()
                require(trace.counter("k1.launches") == before + 1,
                        f"{dname} D={D} T={T}: no K1 launch")
                with full_fp32():
                    plain = attn._attention_torch(q, k, v, bias)
                err = (out.float() - plain.float()).abs().max().item()
                require(out.shape == q.shape and bool(torch.isfinite(out).all()),
                        f"{dname} D={D} T={T}: bad output")
                require(err <= TOLERANCE[dname], f"{dname} D={D} T={T}: max abs err {err}")
                uniform = v[-1].float().mean(dim=1, keepdim=True).expand(HEADS, T, D)
                err_uniform = (out[-1].float() - uniform).abs().max().item()
                require(err_uniform <= TOLERANCE[dname],
                        f"{dname} D={D} T={T}: fully masked row err {err_uniform}")
                row = {"dtype": dname, "D": D, "T": T, "plan": attn.kernel_plan(D),
                       "max_abs_err": err, "err_uniform_row": err_uniform}
                if T == 128:
                    lib_mask = bias[:, :, None, :].to(dtype)
                    row["kernel_ms"] = graph_ms(lambda: attn.multihead_attention(q, k, v, mask))
                    with full_fp32():
                        row["plain_ms"] = graph_ms(lambda: attn._attention_torch(q, k, v, bias))
                        row["library_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=lib_mask))
                    row["bound_ms"], row["bound_by"] = attention_bound_ms(
                        BATCH * HEADS, T, dname, mask.numel(), D)
                emit({"phase": "attention", "check": "wide_head", **row})
                rows.append(row)
                del q, k, v, out, plain
    return rows


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
    from video_fingerprint_tpu_torch.utils import trace

    ckpt = torch.load(model_path)
    ckpt["config"] = dict(ckpt["config"], max_frames=1000)
    path = workdir / "model_max1000.pth"
    torch.save(ckpt, path)
    clips = [(f"long_{t}", _seeded_clip(rng, t)) for t in (600, 817, 1000)]
    with contextlib.redirect_stdout(io.StringIO()):
        card = FingerprintScanner(str(path), device="cuda", batch_size=4)
        cpu = FingerprintScanner(str(path), device="cpu", batch_size=len(clips))
    require(card.buckets[-1] == 1000, f"buckets {card.buckets}")
    before = trace.counter("k1.launches")
    embs = card.embed_clips(clips)
    torch.cuda.synchronize()
    launches = trace.counter("k1.launches") - before
    require(launches == 4, f"max_frames=1000: {launches} kernel launches, not 4")
    cpu_embs = cpu.embed_clips(clips)
    cos = min(float(np.dot(embs[k], cpu_embs[k])) for k, _ in clips)
    require(cos >= 0.9999, f"max_frames=1000: card vs CPU cosine {cos}")
    return {"buckets": list(card.buckets), "frames": [c.shape[0] for _, c in clips],
            "attention_launches": launches, "card_vs_cpu_min_cos": cos}


def _stage_rate(torch, scanner, items):
    """The batching stage on `items` after one warm batch: videos/s by the
    host clock; then one pass under a CPU profiler for the fill (read by
    difference): its GB/s (the staged bytes over `embed.fill`'s self time),
    the fills and those that ran on the pool (`embed.fill_pooled`), and the
    pool's threads."""
    from video_fingerprint_tpu_torch.inference.scanner import stage_pool_threads
    from video_fingerprint_tpu_torch.utils import trace

    scanner.embed_clips(items[:BATCH])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scanner.embed_clips(items)
    torch.cuda.synchronize()
    videos_per_s = len(items) / (time.perf_counter() - t0)

    def mark():
        record = trace.recorded()
        return (trace.counter("embed.frames_staged"), trace.counter("embed.fill_pooled"),
                sum(s.name == "embed.fill" for s in record.spans),
                record.self_seconds.get("embed.fill", 0.0))

    start = mark()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        scanner.embed_clips(items)
        torch.cuda.synchronize()
    frames, pooled, fills, fill_s = (b - a for a, b in zip(start, mark()))
    frame_bytes = scanner.frame_size ** 2 * 3 * np.dtype(scanner.stage_dtype).itemsize
    return {"videos_per_s": videos_per_s, "fill_gb_per_s": frames * frame_bytes / fill_s / 1e9,
            "fill_s": fill_s, "fills": fills, "fill_pooled": pooled,
            "pool_threads": stage_pool_threads()}


STEM_FRAME_BYTES = 64 * 64 * 3 + 32 * 32 * 32 * 2  # uint8 in, conv1's bf16 input out
STEM_SCAN_COS = 0.999  # the bf16 scan (K6) against the f32 scan, per video


def stem_bound_ms(n: int):
    """Least time for K6 on n 64x64 frames: the frames read once and conv0's
    bf16 output written once at HBM rate, vs 2 * 32 * 75 * 1,024 operations
    a frame at the bf16 peak."""
    t_bytes = n * STEM_FRAME_BYTES / PEAK_BYTES_PER_S * 1e3
    t_ops = n * 2 * 32 * 75 * 1024 / PEAK_FLOPS["bfloat16"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _stem_frames(torch, n: int, h: int = 64, w: int = 64, fill=None, seed: int = SEED):
    """(n, h, w, 3) uint8 frames on the card: seeded, starting with every byte
    value, or all `fill`."""
    if fill is not None:
        return torch.full((n, h, w, 3), fill, dtype=torch.uint8, device=CARD)
    g = torch.Generator(device=CARD).manual_seed(seed + n)
    frames = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, device=CARD, generator=g)
    frames.view(-1)[:256] = torch.arange(256, dtype=torch.uint8, device=CARD)
    return frames


def _stem_weights(torch, conv0):
    """conv0's weight and bias in bf16, channels 0-2 made the identity of the
    centre tap's input channels 0-2 (weight 1, bias 0): K6's output there is
    its normalised input at the even pixels, which the check reads bit for
    bit."""
    w = conv0.weight.detach().to(torch.bfloat16).contiguous().clone()
    b = conv0.bias.detach().to(torch.bfloat16).clone()
    w[:3] = 0
    for c in range(3):
        w[c, c, 2, 2] = 1
    b[:3] = 0
    return w, b


def _check_stem(torch, frames, w, b, what: str) -> dict:
    """One K6 launch (its counters move by one launch and N frames); channels
    0-2 the model's own uint8 -> bf16 / 255 bit for bit; every channel
    within one bf16 ulp of the plain version (f32, TF32 off)."""
    from video_fingerprint_tpu_torch.ops import stem
    from video_fingerprint_tpu_torch.ops.convblock import ONE_ULP, compare
    from video_fingerprint_tpu_torch.utils import trace
    from video_fingerprint_tpu_torch.utils.precision import full_fp32

    names = ("stem.launches", "stem.frames", "stem.blocks")
    before = [trace.counter(k) for k in names]
    out = stem.stem_conv(frames, w, b)
    torch.cuda.synchronize()
    launches, n, blocks = (trace.counter(k) - v for k, v in zip(names, before))
    require((launches, n) == (1, frames.shape[0]) and 1 <= blocks <= n,
            f"K6 {what}: counters moved by {(launches, n, blocks)}")
    x = frames.permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0  # input_from_frames' ops
    require(torch.equal(out[..., :3].view(torch.int16),
                        x[:, :, ::2, ::2].permute(0, 2, 3, 1).view(torch.int16)),
            f"K6 {what}: the normalised input is not the model's bit for bit")
    del x
    with full_fp32():
        plain = stem.stem_conv_plain(frames, w, b)
    err, ok = compare(out, plain, ONE_ULP)
    require(ok and bool(torch.isfinite(out).all()), f"K6 {what}: vs plain max abs {err}")
    row = {"blocks": blocks, "max_abs_err": err,
           "equal_share": float((out == plain).float().mean()),
           "nonzero_share": float((out[..., 3:] > 0).float().mean())}
    emit({"phase": "scan", "check": "k6", "case": what, "frames": frames.shape[0],
          "shape": list(frames.shape[1:3]), **row})
    return row


def _host_us(torch, fn, calls: int = 200) -> float:
    """Host time a call of fn, in microseconds: `calls` calls issued back to
    back with no synchronisation between them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _k6(torch, scanner, smi: str) -> dict:
    """K6 (csrc/stem.cu) against its plain version: 64 videos x every bucket
    length, a frame count that leaves the persistent grid's last round
    ragged, all-0 and all-255 frames, a batch starting 5 frames in, and
    the other frame shapes it takes; then at 64 x 500 frames its device time
    (CUDA-graph replay) beside the byte bound, the plain version, cuDNN's
    conv + bias + ReLU on the bf16 input (`library_ms`) and the whole
    unfused chain from the uint8 frames (`unfused_ms`), with the scan
    model's own weights; and the host's time a call through the wrapper
    (`host_us`) beside the unfused chain's (`unfused_host_us`), at 64 x 32
    frames."""
    import copy

    from video_fingerprint_tpu_torch.ops import stem
    from video_fingerprint_tpu_torch.utils.precision import full_fp32
    from video_fingerprint_tpu_torch.utils.timing import graph_ms

    conv0 = scanner.model.spatial_encoder.encoder[0]
    w, b = _stem_weights(torch, conv0)
    checks = {}
    for T in BUCKETS:
        checks[f"b64x{T}"] = _check_stem(torch, _stem_frames(torch, BATCH * T), w, b,
                                         f"64 x {T}")
    grid = max(c["blocks"] for c in checks.values())  # the launches' own persistent grid
    per_sm = grid / torch.cuda.get_device_properties(0).multi_processor_count
    ragged = 3 * grid + 5
    checks["ragged"] = _check_stem(torch, _stem_frames(torch, ragged), w, b,
                                   f"{ragged} frames on a grid of {grid}")
    for fill in (0, 255):
        checks[f"all_{fill}"] = _check_stem(torch, _stem_frames(torch, BATCH * 32, fill=fill),
                                            w, b, f"all {fill}")
    batch = _stem_frames(torch, BATCH * 32 + 5)
    checks["offset"] = _check_stem(torch, batch[5:], w, b, "a batch 5 frames in")
    for h, wd in ((37, 48), (96, 96), (1, 16)):
        checks[f"{h}x{wd}"] = _check_stem(torch, _stem_frames(torch, 257, h, wd), w, b,
                                          f"{h} x {wd} frames")
    del batch

    n = BATCH * BUCKETS[-1]
    frames = _stem_frames(torch, n)
    layer = copy.deepcopy(scanner.model.spatial_encoder.encoder[0:3]).to(torch.bfloat16)
    wt, bt = layer[0].weight.detach(), layer[0].bias.detach()
    with torch.inference_mode():
        x = frames.permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0
        times = {"ms": graph_ms(lambda: stem.stem_conv(frames, wt, bt)),
                 "library_ms": graph_ms(lambda: layer(x)),
                 "unfused_ms": graph_ms(
                     lambda: layer(frames.permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0))}
        with full_fp32():
            times["plain_ms"] = graph_ms(lambda: stem.stem_conv_plain(frames, wt, bt), calls=2)
        small = frames[:BATCH * BUCKETS[0]]
        times["host_us"] = _host_us(torch, lambda: stem.stem_conv(small, wt, bt))
        times["unfused_host_us"] = _host_us(
            torch, lambda: layer(small.permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0))
    bound_ms, bound_by = stem_bound_ms(n)
    row = {"frames": n, **times, "bound_ms": bound_ms, "bound_by": bound_by,
           "over_bound": times["ms"] / bound_ms, "blocks_per_sm": per_sm, "grid": grid,
           "smi": smi}
    emit({"phase": "scan", "check": "k6_time", **row})
    del frames, x
    return {"checks": checks, "time": row,
            "max_abs_err": max(c["max_abs_err"] for c in checks.values())}


def _scan_bf16(torch, model_path: Path, items, embs_f32, forwards: int) -> dict:
    """The bf16 scan (the benchmark's precision): K6 launched once a forward,
    each video's embedding against the f32 card scan's; then, on one 64 x 128
    batch of the clips, the frame CNN's features through K6 against the
    same bf16 model's unfused path (input_from_frames, cuDNN's conv0)."""
    from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner
    from video_fingerprint_tpu_torch.utils import trace

    with contextlib.redirect_stdout(io.StringIO()):
        scanner = FingerprintScanner(str(model_path), device=CARD, batch_size=BATCH, bf16=True)
    scanner.warmup()
    before = trace.counter("stem.launches")
    embs = scanner.embed_clips(items)
    torch.cuda.synchronize()
    launches = trace.counter("stem.launches") - before
    require(launches == forwards, f"bf16 scan: K6 launched {launches} times, not once a "
                                  f"forward ({forwards})")
    cos = min(float(np.dot(embs[k], embs_f32[k])) for k, _ in items)
    require(cos >= STEM_SCAN_COS, f"bf16 scan (K6) vs f32 scan: cosine {cos}")
    model = scanner.model
    clips = [c for _, c in items if c.shape[0] >= 128][:BATCH]
    frames = torch.from_numpy(np.concatenate([c[:128] for c in clips])).to(CARD)
    with torch.inference_mode():
        stem_feats = model._encode_flat(frames).float()
        unfused = model.spatial_encoder(model.input_from_frames(frames)).float()
    feat_cos = float(torch.nn.functional.cosine_similarity(stem_feats, unfused, dim=1).min())
    require(feat_cos >= 0.999, f"frame features, K6 vs unfused: cosine {feat_cos}")
    row = {"stem_launches": launches, "forwards": forwards, "min_cos_vs_f32": cos,
           "frames": frames.shape[0], "feature_min_cos_vs_unfused": feat_cos,
           "feature_max_abs_diff": float((stem_feats - unfused).abs().max())}
    emit({"phase": "scan", "check": "k6_scan_bf16", **row})
    return row


def phase_scan(torch, workdir: Path, smi: str):
    from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner
    from video_fingerprint_tpu_torch.utils import trace
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

    before = trace.counter("k1.launches"), trace.counter("stem.launches")
    t0 = time.perf_counter()
    embs = scanner.embed_clips(items)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    launches = trace.counter("k1.launches") - before[0]
    require(launches == 4 * forwards,
            f"attention kernel launches {launches} != 4 x {forwards} forwards")
    require(trace.counter("stem.launches") == before[1], "the f32 scan launched K6")
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
    scan_bf16 = _scan_bf16(torch, model_path, items, embs, forwards)
    k6 = _k6(torch, scanner, smi)
    k6["launches"] = scan_bf16["stem_launches"]

    # videos/s at bucket 128, B = 64: through the batching stage (host
    # staging, copies, forward, readback) and the forward alone on the card
    clips128 = [(i, rng.integers(0, 256, (128, 64, 64, 3), dtype=np.uint8))
                for i in range(4 * BATCH)]
    stage = _stage_rate(torch, scanner, clips128)
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
          "b128_stage_videos_per_s": stage.pop("videos_per_s"), "b128_stage_fill": stage,
          "forward_b64": forward,
          "max_frames_1000": long, "bf16_scan": scan_bf16, "k6": k6})
    return launches, model_path, k6


def phase_cli(torch, workdir: Path, model_path: Path):
    """The scan CLI on a synthetic mp4 corpus, on the card and on the CPU."""
    from video_fingerprint_tpu_torch.cli.scan import main
    from video_fingerprint_tpu_torch.utils import trace
    from video_fingerprint_tpu_torch.utils.synthetic import make_corpus

    videos = workdir / "videos"
    make_corpus(videos, num_unique=5, num_frames=60, duplicates=2)
    reports = {}
    for device in ("cuda", "cpu"):
        out = workdir / f"results_{device}.json"
        before = trace.counter("k1.launches")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = main(["--model", str(model_path), "--scan", str(videos),
                       "--threshold", "0.999999", "--output", str(out),
                       "--device", device, "--workers", "2", "--batch", "8"])
        require(rc == 0, f"CLI on {device} exited {rc}")
        reports[device] = (json.loads(out.read_text()),
                           trace.counter("k1.launches") - before)
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
    mark = _launch_counts("conv_parity", "conv_strided")
    convblock_probe.main(["--frames", "16384", "--window-ms", "50"])
    launches = _launches(mark)
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


LAUNCH_COUNTERS = {"attention": "k1.launches", "conv_parity": "convblock.conv_parity",
                   "conv_strided": "convblock.conv_strided", "topk": "topk.launches",
                   "stem": "stem.launches"}


def _launch_counts(*kernels):
    """The launch counters (utils/trace.py) of `kernels`, or of every hand
    kernel on the scan's side, by kernel."""
    from video_fingerprint_tpu_torch.utils import trace

    return {k: trace.counter(LAUNCH_COUNTERS[k]) for k in kernels or LAUNCH_COUNTERS}


def _launches(since):
    """Launches by kernel since `since`, a `_launch_counts()`."""
    return {k: n - since[k] for k, n in _launch_counts(*since).items()}


def _require_search_launches(launches: dict, searches: int, what: str) -> None:
    """A search on the card runs K5 (two launches a search) and no other
    hand kernel."""
    others = {k: n for k, n in launches.items() if k != "topk" and n}
    require(not others, f"{what}: another hand kernel ran: {others}")
    require(launches["topk"] == 2 * searches,
            f"{what}: K5 launched {launches['topk']} times, not 2 x {searches} searches")


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

    mark = _launch_counts()
    t0 = time.perf_counter()
    embs = _video_embeddings(scanner, videos)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    launches = _launches(mark)
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
    stage = _stage_rate(torch, scanner, full)
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
          "b64_stage_windows_per_s": stage.pop("videos_per_s"), "b64_stage_fill": stage,
          "forward_b64_ms": forward_ms,
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


def _search_bound_ms(m: int, n: int, corpus_bytes: int, dtype_name: str = "float32"):
    t_ops = 2 * m * n * EMB_DIM / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = corpus_bytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


K5_QUERIES, K5_K = 256, 20  # the search-against-1m cell's call


def _k5_library(torch, p, k: int):
    """The library yardstick of K5: torch.matmul and torch.topk per corpus
    block of the plain path's width, the blocks' picks merged by one
    torch.topk (no tie pass; the port never calls this)."""
    from video_fingerprint_tpu_torch.ops import topk

    cand_s, cand_i = [], []
    for lo in range(0, p.corpus.shape[0], topk.CORPUS_BLOCK):
        s, i = torch.topk(p.sims(0, lo), k, dim=1)
        cand_s.append(s)
        cand_i.append(i + lo)
    s, at = torch.topk(torch.cat(cand_s, dim=1), k, dim=1)
    return s, torch.cat(cand_i, dim=1).gather(1, at)


def _k5(torch, smi: str):
    """K5 at the benchmark's call, 256 of the index phase's queries (the
    planted pairs' sources) against its 10^6 rows, k = 20, f32 and bf16
    storage: two launches a search, the rows of the plain version wherever
    its scores around a rank lie 1e-5 apart and scores within 2e-6, every
    planted copy found; device time (CUDA events, back-to-back calls) beside
    the bound (2 M N D at the f32 FFMA peak, or the corpus once), the plain
    version and the library yardstick."""
    from video_fingerprint_tpu_torch.ops import topk
    from video_fingerprint_tpu_torch.utils import trace
    from video_fingerprint_tpu_torch.utils.precision import full_fp32
    from video_fingerprint_tpu_torch.utils.timing import cuda_ms

    corpus, src, dst, _, queries, _, _ = _index_data()
    q = torch.from_numpy(queries[:K5_QUERIES]).to(CARD)
    rows = {}
    for storage, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        staged = topk.stage_corpus(corpus, CARD, dtype)
        p = topk._Problem(q, staged)
        before = trace.counter("topk.launches")
        scores, idx = topk._exact(p, K5_K)
        torch.cuda.synchronize()
        launches = trace.counter("topk.launches") - before
        require(launches == 2, f"K5 {storage}: {launches} launches, not 2")
        with full_fp32():
            plain_s, plain_i = (t.cpu().numpy() for t in topk._exact_plain(p, K5_K + 1))
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        err = float(np.abs(scores - plain_s[:, :K5_K]).max())
        require(err <= 2e-6, f"K5 {storage}: scores {err} from the plain version's")
        gap = plain_s[:, :-1] - plain_s[:, 1:]
        above = np.concatenate([np.full((len(q), 1), np.inf), gap[:, :K5_K - 1]], axis=1)
        apart = (above > 1e-5) & (gap[:, :K5_K] > 1e-5)
        require(np.array_equal(idx[apart], plain_i[:, :K5_K][apart]),
                f"K5 {storage}: rows differ from the plain version's where scores are apart")
        for j in range(K5_QUERIES):
            require(idx[j, 0] == src[j] and int(dst[j]) in idx[j].tolist(),
                    f"K5 {storage}: query {j} misses its row or its planted copy")
        kernel_ms = cuda_ms(lambda: topk._exact(p, K5_K), window_ms=300)
        with full_fp32():
            plain_ms = cuda_ms(lambda: topk._exact_plain(p, K5_K), window_ms=300)
            library_ms = cuda_ms(lambda: _k5_library(torch, p, K5_K), window_ms=300)
        bound_ms, bound_by = _search_bound_ms(K5_QUERIES, INDEX_ROWS,
                                              staged.numel() * staged.element_size())
        rows[storage] = {"launches_per_search": launches, "max_score_err": err,
                         "rows_compared": int(apart.sum()), "ms": kernel_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "kernels": _device_kernels(torch, lambda: topk._exact(p, K5_K))}
        emit({"phase": "index", "check": "k5", "storage": storage, "smi": smi,
              **rows[storage]})
        del staged, p
        torch.cuda.empty_cache()
    return rows


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


CERTIFIED_METHODS = (("certified", None), ("certified", 0.95), ("certified-bf16", 0.95))


def _check_threshold(scores, idx, sims, thr: float, what: str):
    """The threshold contract on oracle rows: every corpus row with oracle
    similarity >= thr is returned (rows with k or more such: the oracle's
    top-k scores), and every returned score within 2e-5 of the oracle's
    similarity at its index; returns the worst score error."""
    k = idx.shape[1]
    worst = 0.0
    for r in range(len(idx)):
        want = set(np.flatnonzero(sims[r] >= thr).tolist())
        if len(want) >= k:
            top = np.sort(sims[r])[::-1][:k]
            worst = max(worst, float(np.abs(np.sort(scores[r])[::-1] - top).max()))
        else:
            missing = want - set(idx[r].tolist())
            require(not missing, f"{what}: row {r} misses {sorted(missing)} above {thr}")
        worst = max(worst, float(np.abs(scores[r] - sims[r, idx[r]]).max()))
    require(worst <= 2e-5, f"{what}: scores off by {worst}")
    return worst


def _certified_methods(torch, search, exact_scores, checked, sims, oracle_idx, planted,
                       exact_ms, bound, what, smi, phase="index"):
    """Each certified method on the search that exact answered: strict gives
    exact's score multiset (all rows) and the oracle's top-k on the oracle
    rows; the threshold methods are complete above 0.95 with scores within
    2e-5 on the oracle rows, and every planted pair (row, other) finds its
    copy at >= 0.95. The rows sent to repair, ms, exact's ms and the bound
    (the first pass's operations at its type's peak rate, or the bytes)."""
    from video_fingerprint_tpu_torch.utils import trace
    from video_fingerprint_tpu_torch.utils.timing import cuda_ms

    out = {}
    for method, thr in CERTIFIED_METHODS:
        name = method if thr is None else f"{method}@{thr}"
        before = trace.counter("topk.repaired_rows")
        scores, idx = (t.cpu().numpy() for t in search(method, thr))
        repaired = trace.counter("topk.repaired_rows") - before
        if thr is None:
            diff = np.abs(np.sort(scores, 1) - np.sort(exact_scores, 1))
            require(float(diff.max()) <= 1e-6, f"{what} {name}: not exact's scores "
                    f"({float(diff.max())})")
            err = _check_oracle(scores[checked], idx[checked], sims, oracle_idx,
                                f"{what} {name}")
            extra = {"max_diff_vs_exact": float(diff.max()),
                     "rows_bitwise_exact": int((diff.max(axis=1) == 0).sum())}
        else:
            err = _check_threshold(scores[checked], idx[checked], sims, thr, f"{what} {name}")
            for row, other in planted:
                hits = dict(zip(idx[row].tolist(), scores[row].tolist()))
                require(hits.get(int(other), -1.0) >= thr,
                        f"{what} {name}: planted copy of row {row} not found")
            extra = {}
        ms = cuda_ms(lambda: search(method, thr))
        first_pass = "bfloat16" if (method == "certified-bf16"
                                    and "bf16" not in what) else "float32"
        bound_ms, bound_by = bound(first_pass)
        out[name] = {"ms": ms, "exact_ms": exact_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "rows": len(exact_scores),
                     "repaired_rows": repaired, "max_score_err": err, **extra}
        emit({"phase": phase, "check": "certified", "search": what, "method": name,
              "smi": smi, **out[name]})
    return out


@functools.cache
def _index_data(path=None):
    """The index phase's seeded data, made once per process and shared by
    phases index, multigpu and multiproc: 1,000,000 unit rows with 256
    planted near copies (src -> dst), 4,096 queries (both sides of every
    pair, 2,048 corpus rows, fresh rows), the 16 oracle-checked query rows,
    and the 10^5 self-search rows, row 1000 j + 1 a byte-identical copy of
    row 1000 j. `path`: an .npz written by _save_index_data, read instead of
    drawing again (the spawned ranks)."""
    if path is not None:
        with np.load(path) as f:
            return tuple(f[k] for k in INDEX_FIELDS)
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
    emb = _unit_rows(rng, SELF_SEARCH_ROWS)
    emb[1::1000] = emb[::1000][: len(emb[1::1000])]
    return corpus, src, dst, planted_cos, queries, checked, emb


INDEX_FIELDS = ("corpus", "src", "dst", "planted_cos", "queries", "checked", "self_rows")


def _save_index_data(workdir: Path) -> Path:
    """_index_data() in an .npz under workdir (once), for spawned processes."""
    path = workdir / "index_data.npz"
    if not path.exists():
        np.savez(path, **dict(zip(INDEX_FIELDS, _index_data())))
    return path


@functools.cache
def _oracle(search: str):
    """The float64 top-20 (sims, indices) of the oracle-checked rows, made once
    per process: search "f32" or "bf16" (the 10^6 index in that storage,
    cosines of the bf16 values) or "self" (16 rows of the 10^5 self-search)."""
    from video_fingerprint_tpu_torch.inference.index import bf16_bits, bf16_values

    corpus, _, _, _, queries, checked, emb = _index_data()
    if search == "self":
        rows = np.arange(0, SELF_SEARCH_ROWS, SELF_SEARCH_ROWS // 16)
        return _oracle_topk(emb, emb[rows], 20, cosine=False)
    cosine = search == "bf16"
    stored = bf16_values(bf16_bits(corpus)) if cosine else corpus
    q = bf16_values(bf16_bits(queries[checked])) if cosine else queries[checked]
    return _oracle_topk(stored, q, 20, cosine)


def phase_index(torch, workdir: Path, model_path: Path, smi: str):
    from video_fingerprint_tpu_torch.inference.index import FingerprintIndex
    from video_fingerprint_tpu_torch.ops.topk import topk_cosine, topk_search
    from video_fingerprint_tpu_torch.utils.timing import cuda_ms

    # (a) the CLI flow, on the card and on the CPU, f32 and bf16 storage
    flows = {}
    for storage in ("f32", "bf16"):
        mark = _launch_counts()
        card = _index_cli(torch, workdir, model_path, CARD, storage)
        launches = _launches(mark)
        cpu = _index_cli(torch, workdir, model_path, "cpu", storage)
        require(card["groups"] == cpu["groups"], f"index CLI {storage}: card {card} cpu {cpu}")
        require(launches["attention"] > 0, "the index CLI's scans did not run K1")
        require(launches["topk"] == 2, f"the index CLI's --against search launched K5 "
                                       f"{launches['topk']} times, not 2")
        flows[storage] = {**card, "attention_launches": launches["attention"],
                          "topk_launches": launches["topk"]}

    # (b) 1,000,000 seeded unit rows with 256 planted near copies
    k5 = _k5(torch, smi)
    corpus, src, dst, planted_cos, queries, checked, emb = _index_data()
    search = {}
    for storage in ("f32", "bf16"):
        index = FingerprintIndex(dim=EMB_DIM, device=CARD, storage=storage)
        index.add(corpus)
        mark = _launch_counts()
        t0 = time.perf_counter()
        scores, idx = index.search(queries, k=20, exact_above=0.99)
        first_s = time.perf_counter() - t0  # the corpus upload included
        t0 = time.perf_counter()
        scores, idx = index.search(queries, k=20, exact_above=0.99)
        search_s = time.perf_counter() - t0
        launches = _launches(mark)
        _require_search_launches(launches, 2, f"index search {storage}")
        k5[storage]["main_path_launches_per_search"] = launches["topk"] // 2
        for j in range(256):  # every planted copy, from both sides
            for row, other in ((j, dst[j]), (256 + j, src[j])):
                hits = dict(zip(idx[row].tolist(), scores[row].tolist()))
                require(hits.get(int(other), -1.0) >= 0.99,
                        f"{storage}: planted copy {j} not found ({row})")
        sims, oracle_idx = _oracle(storage)
        err = _check_oracle(scores[checked], idx[checked], sims, oracle_idx, storage)
        staged = index._corpus()
        q_dev = torch.from_numpy(queries).to(CARD)
        ms = cuda_ms(lambda: topk_search(q_dev, staged, 20, exact_above=0.99))
        bound_ms, bound_by = _search_bound_ms(INDEX_QUERIES, INDEX_ROWS,
                                              staged.numel() * staged.element_size())
        search[storage] = {"ms": ms, "queries_per_s": INDEX_QUERIES / ms * 1e3,
                           "bound_ms": bound_ms, "bound_by": bound_by,
                           "search_s": search_s, "first_search_s": first_s,
                           "k5_launches_per_search": launches["topk"] // 2,
                           "oracle_rows": len(checked), "max_score_err": err,
                           "planted_min_cos": float(planted_cos.min()),
                           "profile": _kernel_times(torch, lambda: topk_search(
                               q_dev, staged, 20, exact_above=0.99))}
        exact = topk_search(q_dev, staged, 20)[0].cpu().numpy()
        planted = [(j, dst[j]) for j in range(256)] + [(256 + j, src[j]) for j in range(256)]
        search[storage]["methods"] = _certified_methods(
            torch, lambda m, thr: topk_search(q_dev, staged, 20, exact_above=thr, method=m),
            exact, checked, sims, oracle_idx, planted, ms,
            lambda dtype: _search_bound_ms(INDEX_QUERIES, INDEX_ROWS,
                                           staged.numel() * staged.element_size(), dtype),
            f"{storage} 10^6", smi)
        del index, staged, q_dev, sims, exact
        torch.cuda.empty_cache()
    del corpus

    # (c) the scanner's top-k duplicate search at library size
    e_dev = torch.from_numpy(emb).to(CARD)
    scores, idx = (t.cpu().numpy() for t in topk_cosine(e_dev, 20, exact_above=0.99))
    rows = np.arange(0, SELF_SEARCH_ROWS, SELF_SEARCH_ROWS // 16)
    sims, oracle_idx = _oracle("self")
    err = _check_oracle(scores[rows], idx[rows], sims, oracle_idx, "self-search")
    for r in range(0, SELF_SEARCH_ROWS, 1000):
        require(set(idx[r, :2].tolist()) == {r, r + 1},
                f"self-search: row {r}'s first two are {idx[r, :2]}, not itself and its copy")
    ms = cuda_ms(lambda: topk_cosine(e_dev, 20, exact_above=0.99), window_ms=500)
    bound_ms, bound_by = _search_bound_ms(SELF_SEARCH_ROWS, SELF_SEARCH_ROWS, emb.nbytes)
    search["self_100k"] = {"ms": ms, "queries_per_s": SELF_SEARCH_ROWS / ms * 1e3,
                           "bound_ms": bound_ms, "bound_by": bound_by, "max_score_err": err,
                           "profile": _kernel_times(torch, lambda: topk_cosine(e_dev, 20))}
    search["self_100k"]["methods"] = _certified_methods(
        torch, lambda m, thr: topk_cosine(e_dev, 20, exact_above=thr, method=m),
        scores, rows, sims, oracle_idx,
        [(r, r + 1) for r in range(0, SELF_SEARCH_ROWS, 1000)], ms,
        lambda dtype: _search_bound_ms(SELF_SEARCH_ROWS, SELF_SEARCH_ROWS, emb.nbytes, dtype),
        "self-search", smi)
    emit({"phase": "index", "cli": flows, "rows": INDEX_ROWS, "queries": INDEX_QUERIES,
          "k": 20, "search": search})
    return k5


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
    from video_fingerprint_tpu_torch.utils import trace
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
            before = trace.counter("k1.launches")
            out = attn.multihead_attention(q, k, v, mask)
            torch.cuda.synchronize()
            require(trace.counter("k1.launches") == before + 1,
                    f"D={D}: no kernel launch")
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
    from video_fingerprint_tpu_torch.utils import trace
    from video_fingerprint_tpu_torch.training.optim import param_group_label
    from video_fingerprint_tpu_torch.training.train_step import draw_extracts

    rng = np.random.default_rng(SEED + 2)
    batch = _train_batch(torch, rng, CHECK_B, CHECK_T, "cpu")
    draws = draw_extracts(torch.Generator().manual_seed(SEED), CHECK_B, CHECK_T, 0.5)
    outs, models, grads = {}, {}, {}
    for device in ("cuda", "cpu"):
        model, opt, step = _train_setup(torch, "attention", device, dropout=False)
        before = trace.counter("k1.launches")
        out = step({k: v.to(device) for k, v in batch.items()}, draws, TRAIN_CHECK_STEP)
        if device == "cuda":
            torch.cuda.synchronize()
            require(trace.counter("k1.launches") == before,
                    "the train forward launched the attention kernel")
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


def _host_and_card_state(torch):
    """What a step's time may depend on beyond its own code: the process's
    threads and the host's load, the allocator's cache and its cudaMalloc /
    cudaFree calls (each frees or synchronizes), the card's clocks,
    temperature and power."""
    stats = torch.cuda.memory_stats()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    return {"threads": len(os.listdir("/proc/self/task")),
            "torch_threads": torch.get_num_threads(), "loadavg_1m": os.getloadavg()[0],
            "reserved_gb": torch.cuda.memory_reserved() / 1e9,
            "alloc_retries": stats.get("num_alloc_retries", 0),
            "device_mallocs": stats.get("num_device_alloc", 0),
            "device_frees": stats.get("num_device_free", 0), "smi": smi}


def _train_steps_per_s(torch, model_type: str, B: int, T: int, bf16: bool, fast: bool,
                       augment: bool = False):
    """Train steps per second at full width on seeded ragged clips: WARM_STEPS
    steps, then TIMED_STEPS on the host clock ending in a synchronize (the
    extract draws are made on the host and copied per step, as the trainer
    does; with `augment` the device-augment draws are made on the card per
    step, as the trainer does); the host CPU seconds per step, peak device
    memory, the host's and the card's state before and after, one step under
    torch.profiler (its busy share); K1 launches (0 expected)."""
    from video_fingerprint_tpu_torch.utils import trace
    from video_fingerprint_tpu_torch.training.train_step import (
        draw_augmentations,
        draw_extracts,
    )

    rng = np.random.default_rng(SEED + 3)
    batch = _train_batch(torch, rng, B, T, "cuda")
    if model_type != "attention":
        batch = {k: v for k, v in batch.items() if not k.startswith("mask")}
    model, _, step = _train_setup(torch, model_type, "cuda", bf16=bf16,
                                  reuse_extract_features=fast, device_augment=augment)
    gen = torch.Generator().manual_seed(SEED)
    card_gen = torch.Generator(device="cuda").manual_seed(SEED)

    def draws():
        out = draw_extracts(gen, B, T, 0.5) if model_type == "attention" else {}
        if augment:
            out.update(draw_augmentations(card_gen, batch))
        return out or None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = trace.counter("k1.launches")
    n = 0
    for _ in range(WARM_STEPS):
        out = step(batch, draws(), n)
        n += 1
    torch.cuda.synchronize()
    state_before = _host_and_card_state(torch)
    t0, cpu0 = time.perf_counter(), time.process_time()
    for _ in range(TIMED_STEPS):
        out = step(batch, draws(), n)
        n += 1
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    cpu_s = time.process_time() - cpu0
    state_after = _host_and_card_state(torch)
    loss = float(out["loss"])
    require(np.isfinite(loss), f"{model_type} bf16={bf16} fast={fast}: loss {loss}")
    require(trace.counter("k1.launches") == before, "a train step launched the attention kernel")
    row = {"model": model_type, "B": B, "T": T, "dtype": "bfloat16" if bf16 else "float32",
           "fast_extracts": fast, "device_augment": augment,
           "steps_per_s": TIMED_STEPS / seconds,
           "ms_per_step": seconds / TIMED_STEPS * 1e3,
           "host_cpu_ms_per_step": cpu_s / TIMED_STEPS * 1e3,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "last_loss": loss,
           "state_before": state_before, "state_after": state_after,
           "profile": _kernel_times(torch, lambda: step(batch, draws(), n), top=8)}
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
    from video_fingerprint_tpu_torch.utils import trace
    from video_fingerprint_tpu_torch.training import checkpoint as ckpt
    from video_fingerprint_tpu_torch.training.trainer import Trainer
    from video_fingerprint_tpu_torch.utils.synthetic import make_corpus

    videos = workdir / "train_videos"
    make_corpus(videos, num_unique=14, num_frames=40, duplicates=2)
    counts = {"train_epoch": 0, "validate": 0}
    originals = {name: getattr(Trainer, name) for name in counts}

    def counted(name):
        def run(self, *args, **kwargs):
            before = trace.counter("k1.launches")
            out = originals[name](self, *args, **kwargs)
            counts[name] += trace.counter("k1.launches") - before
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
    before = trace.counter("k1.launches")
    with contextlib.redirect_stdout(io.StringIO()):
        scanner = FingerprintScanner(str(run / "checkpoints/best.ckpt"), device="cuda",
                                     batch_size=8)
        fps = scanner.scan_directory(videos, num_workers=4)
    torch.cuda.synchronize()
    E = np.stack([fp["embedding"] for fp in fps.values()])
    require(len(fps) == 16 and bool(np.isfinite(E).all())
            and float(np.abs(np.linalg.norm(E, axis=1) - 1).max()) < 1e-5,
            "best.ckpt scan: bad fingerprints")
    require(trace.counter("k1.launches") > before,
            "the scan of best.ckpt did not launch the kernel")
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
    speed = [_train_steps_per_s(torch, *c) for c in configs]
    cli = _train_cli(torch, workdir)
    emit({"phase": "train", "smi": smi, "head_dims": head_dims, "card_vs_cpu": check,
          "steps": speed, "cli": cli, "seconds": time.perf_counter() - t0})


# ----------------------------------------------------------- device augment

AUG_B, AUG_T = 64, 64
AUG_SHARE = 0.9999  # color: share of elements within 1e-5 of the CPU's
AUG_ATOL = 1e-5
AUG_GATES = ("do_color", "do_flip", "do_letterbox", "do_overlay", "do_rotation")
AUG_TRANSFORMS = ("color", "flip", "noise", "blur", "letterbox", "overlay", "rotation")


def _aug_params_alone(torch, params, transform):
    """`params` with every transform off but `transform`."""
    p = dict(params)
    for gate in AUG_GATES:
        if gate != "do_" + transform:
            p[gate] = torch.zeros_like(p[gate])
    if transform != "noise":
        p["noise_level"] = torch.zeros_like(p["noise_level"])
    if transform != "blur":
        p["blur_idx"] = torch.zeros_like(p["blur_idx"])
    return p


def _aug_forced(torch, rng):
    """Per-frame params with every gate on, blur k cycling over 3/5/7."""
    from video_fingerprint_tpu_torch.ops.device_augment import sample_params

    p = sample_params(torch.Generator().manual_seed(int(rng.integers(1 << 30))), AUG_B, 64,
                      num_frames=AUG_T, device="cpu")
    for gate in AUG_GATES:
        p[gate] = torch.ones_like(p[gate])
    p["noise_level"] = torch.from_numpy(rng.uniform(0.02, 0.1, AUG_B).astype(np.float32))
    p["blur_idx"] = torch.arange(AUG_B) % 3 + 1
    p["rotation_angle"] = torch.from_numpy(
        rng.uniform(-5, 5, (AUG_B, AUG_T)).astype(np.float32))
    return p


def _aug_card_vs_cpu(torch, params, clips, noise, what):
    from video_fingerprint_tpu_torch.ops.device_augment import apply_augmentations

    cpu = apply_augmentations(params, clips, noise)
    card = apply_augmentations({k: v.cuda() for k, v in params.items()}, clips.cuda(),
                               noise.cuda()).cpu()
    err = (card - cpu).abs()
    share = float((err <= AUG_ATOL).double().mean())
    require(bool(torch.isfinite(card).all()), f"augment {what}: non-finite output")
    return float(err.max()), share


def _augment_correctness(torch):
    """Each transform alone and two whole pipelines, card against CPU."""
    from video_fingerprint_tpu_torch.ops.device_augment import sample_params

    rng = np.random.default_rng(SEED + 7)
    clips = torch.from_numpy(np.stack([_seeded_clip(rng, AUG_T) for _ in range(AUG_B)])
                             ).float() / 255.0
    noise = torch.randn(clips.shape, generator=torch.Generator().manual_seed(SEED))
    forced = _aug_forced(torch, rng)
    sampled = sample_params(torch.Generator().manual_seed(SEED + 1), AUG_B, 64,
                            num_frames=AUG_T, device="cpu")
    rows = []
    cases = [(t, _aug_params_alone(torch, forced, t)) for t in AUG_TRANSFORMS]
    cases += [("all_forced", forced), ("sampled", sampled)]
    for what, params in cases:
        max_err, share = _aug_card_vs_cpu(torch, params, clips, noise, what)
        held_by_share = what in ("color", "all_forced", "sampled")
        if held_by_share:
            require(share >= AUG_SHARE, f"augment {what}: {share} of elements within "
                    f"{AUG_ATOL} (max err {max_err})")
        else:
            require(max_err <= AUG_ATOL, f"augment {what}: max abs err {max_err}")
        rows.append({"transform": what, "max_abs_err": max_err, "share_within_1e-5": share,
                     "held_by": "share" if held_by_share else "max_abs"})
    return rows


def _augment_ms(torch, smi):
    """The augmented pair batch on the card: the draws (params and noise of
    both sides) and the transforms, B = 64, T = 64, 64x64, beside the bytes
    bound of the transforms (each side reads its clip and noise once and
    writes its output once, f32)."""
    from video_fingerprint_tpu_torch.ops import device_augment as daug
    from video_fingerprint_tpu_torch.ops.device_augment import apply_drawn
    from video_fingerprint_tpu_torch.training.train_step import (
        draw_augmentations,
        normalize_clip,
    )
    from video_fingerprint_tpu_torch.utils.timing import cuda_ms

    batch = _train_batch(torch, np.random.default_rng(SEED + 8), AUG_B, AUG_T, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    drawn = draw_augmentations(gen, batch)

    def apply():
        return [apply_drawn(drawn[f"aug{s}"], normalize_clip(batch[f"clip{s}"]),
                            batch[f"mask{s}"]) for s in (1, 2)]

    draw_ms = cuda_ms(lambda: draw_augmentations(gen, batch))
    apply_ms = cuda_ms(apply)
    nbytes = 2 * batch["clip1"].numel() * (1 + 4 + 4)  # u8 clip, f32 noise, f32 out
    # where one side's time goes: the costly transforms alone (every
    # transform runs on the whole batch, its gate only blends)
    x, p = normalize_clip(batch["clip1"]), drawn["aug1"]["params"]
    stages = {"color": lambda: daug._color(x, p),
              "blur": lambda: daug._blur(x, p["blur_idx"]),
              "rotation": lambda: daug._rotate_bilinear(x, p["rotation_angle"]),
              "one_side": lambda: daug.apply_augmentations(p, x, drawn["aug1"]["noise"])}
    row = {"B": AUG_B, "T": AUG_T, "draw_ms": draw_ms, "apply_ms": apply_ms,
           "pair_ms": draw_ms + apply_ms, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "stage_ms": {k: cuda_ms(f) for k, f in stages.items()},
           "smi": smi}
    emit({"phase": "augment", "check": "time", **row})
    return row


def _loader_rates(torch, workdir: Path, smi):
    """Train-loader clips/s from create_dataloader at the train CLI's
    defaults (batch 8, 4 workers, max_frames 500, 64x64 clips) on the first
    LOADER_VIDEOS of the native phase's 640x360 x 300-frame mp4s, host
    against device augment mode: the first epoch (full-resolution decode,
    resize and augmentation) and the second (decoded frames cached)."""
    from video_fingerprint_tpu_torch.data.dataset import create_dataloader

    _, corpus = _hd_corpus(workdir)
    videos = workdir / "hd_loader_videos"  # the first LOADER_VIDEOS, hard-linked
    paths = corpus[:LOADER_VIDEOS]
    if not videos.exists():
        videos.mkdir()
        for p in paths:
            os.link(p, videos / p.name)
    rows = {}
    for mode in ("host", "device"):
        with contextlib.redirect_stdout(io.StringIO()):
            loader = create_dataloader(videos, batch_size=8, num_workers=4, mode="train",
                                       seed=SEED, augment_mode=mode)
        row = {}
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            clips = sum(2 * len(b["video_id"]) for b in loader)
            seconds = time.perf_counter() - t0
            row[f"epoch{epoch}_clips_per_s"] = clips / seconds
            row[f"epoch{epoch}_s"] = seconds
        row["clips_per_epoch"] = clips
        rows[mode] = row
        del loader  # and its cache of full-resolution frames (~7 GB)
        gc.collect()
    emit({"phase": "augment", "check": "loader", "workers": 4, "videos": len(paths),
          "size": f"{HD_W}x{HD_H}", "frames": HD_FRAMES, "smi": smi, **rows})
    return rows


def _augment_cli(torch, workdir: Path):
    """The train CLI with --device_augment, one epoch on the 16-video
    corpus of the train phase: artifacts, config, K1 launched in
    validation and not in the train steps."""
    import os

    from video_fingerprint_tpu_torch.cli.train import main
    from video_fingerprint_tpu_torch.utils import trace
    from video_fingerprint_tpu_torch.training.trainer import Trainer
    from video_fingerprint_tpu_torch.utils.synthetic import make_corpus

    videos = workdir / "train_videos"
    if not videos.exists():
        make_corpus(videos, num_unique=14, num_frames=40, duplicates=2)
    counts = {"train_epoch": 0, "validate": 0}
    originals = {name: getattr(Trainer, name) for name in counts}

    def counted(name):
        def run(self, *args, **kwargs):
            before = trace.counter("k1.launches")
            out = originals[name](self, *args, **kwargs)
            counts[name] += trace.counter("k1.launches") - before
            return out
        return run

    cwd = os.getcwd()
    try:
        os.chdir(workdir)
        for name in counts:
            setattr(Trainer, name, counted(name))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = main(["--data_dir", str(videos), "--batch_size", "4", "--num_workers", "4",
                       "--max_frames", "64", "--epochs", "1", "--run_name", "augment",
                       "--device_augment"])
        seconds = time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(Trainer, name, fn)
        os.chdir(cwd)
    require(rc == 0, f"train CLI --device_augment exited {rc}")
    run = workdir / "runs" / "augment"
    for name in ("config.json", "training_log.txt", "training_summary.txt",
                 "checkpoints/last.ckpt", "checkpoints/best.ckpt"):
        require((run / name).exists(), f"train CLI --device_augment left no {name}")
    require(json.loads((run / "config.json").read_text())["device_augment"] is True,
            "config.json does not record device_augment")
    require(counts["validate"] > 0, "--device_augment: validation did not launch K1")
    require(counts["train_epoch"] == 0, "--device_augment: a train step launched K1")
    return {"epochs": 1, "seconds": seconds, "attention_launches": counts}


def phase_augment(torch, workdir: Path, smi: str):
    t0 = time.perf_counter()
    checks = _augment_correctness(torch)
    for row in checks:
        emit({"phase": "augment", "check": "card_vs_cpu", **row})
    times = _augment_ms(torch, smi)
    steps = [_train_steps_per_s(torch, *c, augment=True)
             for c in (("attention", TRAIN_B, TRAIN_T, False, False),
                       ("attention", TRAIN_B, TRAIN_T, True, False),
                       ("3d", 2 * TRAIN_B, CLIP_LENGTH, False, False))]
    loader = _loader_rates(torch, workdir, smi)
    cli = _augment_cli(torch, workdir)
    emit({"phase": "augment", "smi": smi, "card_vs_cpu": checks, "time": times,
          "steps": steps, "loader": loader, "cli": cli,
          "seconds": time.perf_counter() - t0})


# ------------------------------------------------------------- native paths

HD_VIDEOS, HD_FRAMES, HD_H, HD_W = 32, 300, 360, 640
LOADER_VIDEOS = 8  # the augment phase's loader epochs run on these of the 34


def _hd_frames(seed: int) -> np.ndarray:
    """(300, 360, 640, 3) uint8: a seeded image of its own (6 x 10 random
    colours upscaled bilinearly, features ~64 px wide) panning sideways.
    Fast to make; distinct videos stay apart in a random model's embedding
    space; smooth enough that cv2's bilinear decimation and swscale's
    filtered scaling see the same picture."""
    import cv2

    rng = np.random.default_rng(seed)
    image = cv2.resize(rng.integers(0, 256, (6, 10, 3), dtype=np.uint8),
                       (HD_W, HD_H), interpolation=cv2.INTER_LINEAR)
    speed = int(rng.integers(1, 4))
    return np.stack([np.roll(image, speed * t, axis=1) for t in range(HD_FRAMES)])


def _hd_corpus(workdir: Path):
    """32 seeded 640x360 x 300-frame mp4s and byte-identical copies of two,
    written at the first call (the loader's and the native phase's input)."""
    from concurrent.futures import ThreadPoolExecutor

    from video_fingerprint_tpu_torch.utils.synthetic import write_video

    videos = workdir / "hd_videos"
    originals = [videos / f"video_{i:02d}.mp4" for i in range(HD_VIDEOS)]
    copies = [videos / f"video_{i:02d}_copy.mp4" for i in range(2)]
    if not videos.exists():
        videos.mkdir()

        def write(i):
            return write_video(originals[i], _hd_frames(SEED + 100 + i))

        with ThreadPoolExecutor(max_workers=8) as pool:
            list(pool.map(write, range(HD_VIDEOS)))
        for i, copy in enumerate(copies):
            copy.write_bytes(originals[i].read_bytes())
    return videos, originals + copies


def _scanner(torch, model_path, **flags):
    from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        scanner = FingerprintScanner(str(model_path), device="cuda", batch_size=BATCH, **flags)
    return scanner, out.getvalue()


def _decode_rate(scanner, paths):
    """Host decode videos/s of the scanner's producer, 4 workers, and the
    clips it gave."""
    t0 = time.perf_counter()
    clips = dict(scanner.decode_clips(paths, 4))
    seconds = time.perf_counter() - t0
    require(all(c is not None for c in clips.values()), "a video failed to decode")
    return len(paths) / seconds, clips


def _require_pairs(groups, paths, what):
    """Each planted copy shares a group with its original."""
    for i in range(2):
        pair = {str(paths[i]), str(paths[HD_VIDEOS + i])}
        require(any(pair <= set(g) for g in groups), f"{what}: copy {i} not grouped")


def _scan_and_group(torch, scanner, videos):
    from video_fingerprint_tpu_torch.utils import trace

    before = trace.counter("k1.launches")
    with contextlib.redirect_stdout(io.StringIO()):
        fps = scanner.scan_directory(videos, num_workers=4)
        groups = _groups(scanner.find_duplicates(fps, 0.999999))
    torch.cuda.synchronize()
    return fps, groups, trace.counter("k1.launches") - before


def _decode_percore(workdir: Path, native_built: bool, smi: str):
    """tools/bench_decode_percore.py at its defaults (8 seeded 96x128 mp4s
    of 240 frames, the e2e leg's frame size, 64 frames each to 64x64): one
    worker's frames/s with cv2, and with vfp_decode where it built, else
    its build error and no native rate."""
    from video_fingerprint_tpu_torch.tools import bench_decode_percore as bd

    with contextlib.redirect_stdout(io.StringIO()):
        row = bd.run(bd.parse_args(["--out", str(workdir / "percore_videos")]))
    require(row["cv2_fps"] > 0 and row["frames_per_pass"] == 8 * 64,
            f"per-core decode: {row}")
    if native_built:
        require(row["native_fps"] > 0, f"per-core decode: no native rate {row}")
    else:
        require(row["native_fps"] is None and bool(row["native_error"]),
                f"per-core decode without vfp_decode: {row}")
    emit({"phase": "native", "check": "percore", "smi": smi, **row})
    return row


def phase_native(torch, workdir: Path, model_path: Path, model3d_path: Path, smi: str):
    from video_fingerprint_tpu_torch.data import decode, preprocess
    from video_fingerprint_tpu_torch.utils import native, native_decode

    t0 = time.perf_counter()
    built = {"vfp_host": native.available(), "vfp_decode": native_decode.available()}
    report = {"built": built,
              "build_errors": {"vfp_host": native.LIBRARY.error[-400:],
                               "vfp_decode": native_decode.LIBRARY.error[-400:]}}
    emit({"phase": "native", "check": "build", **report})
    report["percore"] = _decode_percore(workdir, built["vfp_decode"], smi)
    if not built["vfp_decode"]:
        _, out = _scanner(torch, model_path, native_decode=True)
        require("native decode requested but unavailable; using cv2" in out,
                f"no unavailable-decoder message: {out!r}")
        report["scanner_message"] = "native decode requested but unavailable; using cv2"
    if not built["vfp_host"]:
        _, out = _scanner(torch, model_path, native_preprocess=True)
        require("native preprocess requested but unavailable; using cv2" in out,
                f"no unavailable-preprocess message: {out!r}")
        report["scanner_message_preprocess"] = (
            "native preprocess requested but unavailable; using cv2")
    if not any(built.values()):
        emit({"phase": "native", "smi": smi, **report,
              "seconds": time.perf_counter() - t0})
        return report

    videos, paths = _hd_corpus(workdir)
    mean_diff = None
    if built["vfp_decode"]:
        ours = native_decode.decode_scan(paths[2], 500, 64)
        ref = preprocess.preprocess_frames(decode.decode_subsampled(paths[2], 500), 64,
                                           normalize=False)
        require(ours.shape == ref.shape, f"decode_scan {ours.shape} vs cv2 {ref.shape}")
        mean_diff = float(np.abs(ours.astype(np.int16) - ref.astype(np.int16)).mean())
        require(mean_diff < 3.0, f"decode_scan vs cv2 mean |diff| {mean_diff}")

    modes = {"cv2": {}}
    if built["vfp_decode"]:
        modes["native_decode"] = {"native_decode": True}
    if built["vfp_host"]:
        modes["native_preprocess"] = {"native_preprocess": True}
    rows, base = {}, None
    for mode, flags in modes.items():
        scanner, _ = _scanner(torch, model_path, **flags)
        require(all(getattr(scanner, f) for f in flags), f"{mode}: flag not taken")
        decode_vps, clips = _decode_rate(scanner, paths)
        decoded = [clips[p] for p in paths]  # the corpus's clips, repeated
        stage = _stage_rate(torch, scanner,
                            [(i, decoded[i % len(decoded)]) for i in range(4 * BATCH)])
        t1 = time.perf_counter()
        fps, groups, launches = _scan_and_group(torch, scanner, videos)
        scan_vps = len(fps) / (time.perf_counter() - t1)
        require(len(fps) == len(paths), f"{mode}: {len(fps)} of {len(paths)} videos")
        require(launches > 0, f"{mode}: the scan did not launch K1")
        row = {"decode_videos_per_s": decode_vps, "scan_videos_per_s": scan_vps,
               "stage_videos_per_s": stage.pop("videos_per_s"), "stage_fill": stage,
               "stage_dtype": np.dtype(scanner.stage_dtype).name, "groups": len(groups),
               "attention_launches": launches}
        _require_pairs(groups, paths, mode)
        if base is None:
            base = (fps, groups)
        else:
            cos = min(float(np.dot(fps[p]["embedding"], base[0][p]["embedding"]))
                      for p in fps)
            require(cos >= 0.999, f"{mode} vs cv2 scan cosine {cos}")
            require(groups == base[1], f"{mode} groups {groups} != cv2 groups {base[1]}")
            row["min_cos_vs_cv2"] = cos
        rows[mode] = row
        emit({"phase": "native", "check": "attention", "mode": mode, "smi": smi, **row})
        del scanner, clips

    rows3d, base = {}, None
    modes3d = {"cv2": {}}
    if built["vfp_decode"]:
        modes3d["native_decode"] = {"native_decode": True}
    for mode, flags in modes3d.items():
        scanner, _ = _scanner(torch, model3d_path, **flags)
        t1 = time.perf_counter()
        fps, groups, launches = _scan_and_group(torch, scanner, videos)
        row = {"scan_videos_per_s": len(fps) / (time.perf_counter() - t1),
               "groups": len(groups), "attention_launches": launches}
        require(len(fps) == len(paths), f"3D {mode}: {len(fps)} of {len(paths)} videos")
        _require_pairs(groups, paths, f"3D {mode}")
        if base is None:
            base = (fps, groups)
        else:
            cos = min(float(np.dot(fps[p]["embedding"], base[0][p]["embedding"]))
                      for p in fps)
            require(cos >= 0.999, f"3D {mode} vs cv2 scan cosine {cos}")
            require(groups == base[1], f"3D {mode} groups {groups} != cv2 {base[1]}")
            row["min_cos_vs_cv2"] = cos
        rows3d[mode] = row
        emit({"phase": "native", "check": "3d", "mode": mode, "smi": smi, **row})
        del scanner
    emit({"phase": "native", "smi": smi, **report, "videos": len(paths),
          "frames": HD_FRAMES, "size": f"{HD_W}x{HD_H}",
          "decode_scan_vs_cv2_mean_abs_diff": mean_diff, "attention": rows, "3d": rows3d,
          "seconds": time.perf_counter() - t0})
    return report


# ---------------------------------------------------------------- multigpu
#
# The script needs one card: every multi-device path runs there with
# its shards or ranks on that card (a device list that repeats cuda:0, or
# two gloo ranks on cuda:0; NCCL refuses two ranks on one GPU). The phase
# shows that k shards or ranks compute what one device does; its times are
# those of k shards on one H100, the cost of sharding, not a gain.

MULTI_SHARDS = (4,)  # the DP scan's shard count besides one card
DP_TRAIN_B = 64          # the global batch of the two-rank train step
DP_TRAIN_B3D = 128
DP_STEPS = 2


def _dp_scan(torch, workdir: Path, smi: str):
    """Phase 3's 204 seeded clips through the attention scan at B = 64 on
    one card and over [cuda:0] x 4: cosine >= 0.9999 per clip, equal
    duplicate groups (direct, and top-k: the ring over the shards), K1
    launched 4 times per forward per shard; videos/s at bucket 128 for each,
    k shards on one card. Then phase 6's 3D scan over [cuda:0] x 2."""
    from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner

    rng = np.random.default_rng(SEED)
    model_path = workdir / "model_multigpu.pth"
    _write_model(torch, model_path, rng)  # phase 3's draws: its clips come next
    items, pairs = _seeded_clips(rng)
    per_bucket = {}
    for _, clip in items:
        b = next(b for b in BUCKETS if clip.shape[0] <= b)
        per_bucket[b] = per_bucket.get(b, 0) + 1
    forwards = sum(-(-n // BATCH) for n in per_bucket.values())

    def fps_of(embs):
        return {k: {"embedding": embs[k], "path": k, "name": k, "size": c.nbytes,
                    "file_hash": hashlib.md5(c.tobytes()).hexdigest()} for k, c in items}

    clips128 = [(i, rng.integers(0, 256, (128, 64, 64, 3), dtype=np.uint8))
                for i in range(2 * BATCH)]
    rows, single = {}, None
    for shards in (1,) + MULTI_SHARDS:
        dp = [CARD] * shards if shards > 1 else False
        with contextlib.redirect_stdout(io.StringIO()):
            scanner = FingerprintScanner(str(model_path), device=CARD, batch_size=BATCH,
                                         data_parallel=dp)
        scanner.warmup()
        mark = _launch_counts()
        embs = scanner.embed_clips(items)
        torch.cuda.synchronize()
        launches = _launches(mark)
        require(launches["attention"] == 4 * forwards * shards,
                f"{shards} shards: K1 launched {launches['attention']} times, "
                f"not 4 x {forwards} forwards x {shards}")
        E = np.stack([embs[k] for k, _ in items])
        require(bool(np.isfinite(E).all()), f"{shards} shards: non-finite embeddings")
        if single is None:
            single, threshold = embs, _planted_threshold(E, [k for k, _ in items], pairs)[0]
        cos = min(float(np.dot(embs[k], single[k])) for k, _ in items)
        require(cos >= 0.9999, f"{shards} shards vs one card: cosine {cos}")
        groups = {}
        for route, topk_threshold in (("direct", 10 ** 9), ("topk", 100)):
            with contextlib.redirect_stdout(io.StringIO()):
                groups[route] = _groups(scanner.find_duplicates(fps_of(embs), threshold,
                                                                topk_threshold))
            require(groups[route] == sorted(sorted(p) for p in pairs),
                     f"{shards} shards {route}: groups {groups[route]} != planted copies")
        stage = _stage_rate(torch, scanner, clips128)
        rows[shards] = {"batch": scanner.batch_size, "attention_launches": launches["attention"],
                        "forwards": forwards, "min_cos_vs_one_card": cos,
                        "groups": {r: len(g) for r, g in groups.items()},
                        "b128_stage_videos_per_s": stage.pop("videos_per_s"),
                        "b128_stage_fill": stage}
        emit({"phase": "multigpu", "check": "dp_scan", "shards_on_one_card": shards,
              "smi": smi, **rows[shards]})
        del scanner

    rng3 = np.random.default_rng(SEED + 3)
    model3d = workdir / "model3d_multigpu.pth"
    _write_model_3d(torch, model3d, rng3)
    out3d = {}
    for shards in (1, 2):
        dp = [CARD] * shards if shards > 1 else False
        with contextlib.redirect_stdout(io.StringIO()):
            scanner = FingerprintScanner(str(model3d), device=CARD, batch_size=BATCH,
                                         data_parallel=dp)
        if shards == 1:
            videos, pairs3d = _seeded_videos_3d(rng3, scanner)
        mark = _launch_counts()
        out3d[shards] = _video_embeddings(scanner, videos)
        torch.cuda.synchronize()
        require(not any(_launches(mark).values()), "a hand kernel ran in the 3D scan")
        keys = list(videos)
        fps = {k: {"embedding": out3d[shards][k], "path": k, "name": k, "size": 0,
                   "file_hash": hashlib.md5(b"".join(w.tobytes() for w in videos[k])).hexdigest()}
               for k in keys}
        if shards == 1:
            threshold3d = _planted_threshold(np.stack([out3d[1][k] for k in keys]), keys,
                                             pairs3d)[0]
        with contextlib.redirect_stdout(io.StringIO()):
            g = _groups(scanner.find_duplicates(fps, threshold3d, 100))
        require(g == sorted(sorted(p) for p in pairs3d), f"3D {shards} shards: groups {g}")
        del scanner
    cos3d = min(float(np.dot(out3d[2][k], out3d[1][k])) for k in out3d[1])
    require(cos3d >= 0.9999, f"3D over 2 shards vs one card: cosine {cos3d}")
    return {"attention": rows, "3d": {"videos": len(out3d[1]), "min_cos_vs_one_card": cos3d,
                                      "groups": len(pairs3d)}}


def _dp_search(torch, smi: str):
    """Phase 7's seeded index (10^6 x 256, 4,096 queries, k = 20) through
    sharded_topk_search over [cuda:0] x 4 in f32 and bf16 storage, and the
    ring sharded_topk_cosine on the 10^5 self-search: exact equal to the
    single-device exact search (indices, scores within 1e-5) and the float64
    oracle; the certified methods to phase 7's contracts; ms beside the
    single-device exact ms and the bound (the same work: 4 shards on one
    card)."""
    from video_fingerprint_tpu_torch.ops import topk
    from video_fingerprint_tpu_torch.utils.timing import cuda_ms

    devices = [CARD] * 4
    corpus, src, dst, _, queries, checked, emb = _index_data()
    planted = [(j, dst[j]) for j in range(256)] + [(256 + j, src[j]) for j in range(256)]
    out = {}
    for storage in ("f32", "bf16"):
        dtype = torch.bfloat16 if storage == "bf16" else torch.float32
        staged = topk.stage_sharded_corpus(corpus, devices, dtype)
        single = topk.stage_corpus(corpus, CARD, dtype)
        q_dev = torch.from_numpy(queries).to(CARD)
        mark = _launch_counts()
        scores, idx = (t.cpu().numpy() for t in topk.sharded_topk_search(q_dev, staged, 20))
        _require_search_launches(_launches(mark), len(devices),
                                 f"sharded search {storage} (a search a shard)")
        ref_s, ref_i = (t.cpu().numpy() for t in topk.topk_search(q_dev, single, 20))
        require(bool((idx == ref_i).all()), f"sharded {storage}: indices differ from one card")
        diff = float(np.abs(scores - ref_s).max())
        require(diff <= 1e-5, f"sharded {storage}: scores off one card's by {diff}")
        cosine = storage == "bf16"
        sims, oracle_idx = _oracle(storage)
        err = _check_oracle(scores[checked], idx[checked], sims, oracle_idx, f"sharded {storage}")
        ms = cuda_ms(lambda: topk.sharded_topk_search(q_dev, staged, 20))
        single_ms = cuda_ms(lambda: topk.topk_search(q_dev, single, 20))
        del single
        bound = lambda dt: _search_bound_ms(INDEX_QUERIES, INDEX_ROWS,  # noqa: E731
                                            corpus.shape[0] * EMB_DIM * (2 if cosine else 4), dt)
        out[storage] = {"ms": ms, "single_card_ms": single_ms, "bound_ms": bound("float32")[0],
                        "max_diff_vs_one_card": diff, "max_score_err": err}
        out[storage]["methods"] = _certified_methods(
            torch, lambda m, thr: topk.sharded_topk_search(q_dev, staged, 20, exact_above=thr,
                                                           method=m),
            scores, checked, sims, oracle_idx, planted, ms, bound,
            f"sharded x4 {storage} 10^6", smi, phase="multigpu")
        emit({"phase": "multigpu", "check": "sharded_search", "storage": storage,
              "shards_on_one_card": 4, "smi": smi,
              **{k: v for k, v in out[storage].items() if k != "methods"}})
        del staged, q_dev, sims
        torch.cuda.empty_cache()
    del corpus

    e_dev = torch.from_numpy(emb).to(CARD)
    scores, idx = (t.cpu().numpy() for t in topk.sharded_topk_cosine(e_dev, 20,
                                                                      devices=devices))
    ref_s, ref_i = (t.cpu().numpy() for t in topk.topk_cosine(e_dev, 20))
    require(bool((idx == ref_i).all()), "ring: indices differ from one card")
    diff = float(np.abs(scores - ref_s).max())
    require(diff <= 1e-5, f"ring: scores off one card's by {diff}")
    rows = np.arange(0, SELF_SEARCH_ROWS, SELF_SEARCH_ROWS // 16)
    sims, oracle_idx = _oracle("self")
    err = _check_oracle(scores[rows], idx[rows], sims, oracle_idx, "ring")
    staged = topk.stage_sharded_corpus(emb, devices)
    ms = cuda_ms(lambda: topk.sharded_topk_cosine(staged, 20), window_ms=500)
    single_ms = cuda_ms(lambda: topk.topk_cosine(e_dev, 20), window_ms=500)
    bound = lambda dt: _search_bound_ms(SELF_SEARCH_ROWS, SELF_SEARCH_ROWS,  # noqa: E731
                                        emb.nbytes, dt)
    out["ring_100k"] = {"ms": ms, "single_card_ms": single_ms, "bound_ms": bound("float32")[0],
                        "max_diff_vs_one_card": diff, "max_score_err": err}
    out["ring_100k"]["methods"] = _certified_methods(
        torch, lambda m, thr: topk.sharded_topk_cosine(staged, 20, exact_above=thr, method=m),
        scores, rows, sims, oracle_idx, [(r, r + 1) for r in range(0, SELF_SEARCH_ROWS, 1000)],
        ms, bound, "ring x4 10^5", smi, phase="multigpu")
    emit({"phase": "multigpu", "check": "ring", "shards_on_one_card": 4, "smi": smi,
          **{k: v for k, v in out["ring_100k"].items() if k != "methods"}})
    return out


def _dp_train_setup(torch, model_type: str):
    """The two-rank check's global batch and per-step draws, from seeds."""
    from video_fingerprint_tpu_torch.training.train_step import draw_extracts

    B, T = (DP_TRAIN_B, TRAIN_T) if model_type == "attention" else (DP_TRAIN_B3D, CLIP_LENGTH)
    batch = _train_batch(torch, np.random.default_rng(SEED + 7), B, T, "cpu")
    if model_type != "attention":
        batch = {k: v for k, v in batch.items() if not k.startswith("mask")}
        return batch, [None]
    gen = torch.Generator().manual_seed(SEED)
    return batch, [draw_extracts(gen, B, T, 0.5) for _ in range(DP_STEPS)]


def _dp_train_run(torch, model_type: str, shard):
    """Train steps of the seeded full-width model (dropout off, f32, TF32
    off) from step TRAIN_CHECK_STEP: shard(tree) gives this process's rows.
    Returns per-step metrics (with each group's LR) and the params and BN
    running statistics."""
    batch, draws = _dp_train_setup(torch, model_type)
    model, opt, step = _train_setup(torch, model_type, CARD, dropout=False)
    batch = {k: v.to(CARD) for k, v in shard(batch).items()}
    metrics = []
    for i, d in enumerate(draws):
        out = step(batch, shard(d) if d is not None else None, TRAIN_CHECK_STEP + i)
        metrics.append({k: float(v) for k, v in out.items()})
        metrics[-1]["lrs"] = {g["label"]: g["lr"] for g in opt.param_groups}
    params = {k for k, _ in model.named_parameters()}
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()
             if k in params or "running_" in k}
    return metrics, state


def _dp_train_rank(rank: int, world: int, port: int, out_path: str) -> None:
    """One rank of the two-rank check (a spawned process): joins a gloo
    group through the launcher's environment, both ranks on cuda:0, runs
    the attention steps and the 3D step on its rows, saves its results."""
    import torch

    from video_fingerprint_tpu_torch.parallel.distributed import (
        DataParallel,
        maybe_initialize_distributed,
    )

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    maybe_initialize_distributed(CARD, backend="gloo")
    dp = DataParallel()
    result = {"backend": torch.distributed.get_backend()}
    try:  # which gloo collectives take CUDA tensors in this torch (diagnostic)
        x = torch.ones(4, device=CARD)
        torch.distributed.all_gather([torch.empty_like(x) for _ in range(world)], x)
        result["gloo_cuda_all_gather"] = True
    except RuntimeError as exc:
        result["gloo_cuda_all_gather"] = repr(exc)[:200]
    for model_type in ("attention", "3d"):
        result[model_type] = _dp_train_run(torch, model_type, dp.shard_batch)
    torch.distributed.destroy_process_group()
    torch.save(result, out_path)


def _dp_compare(torch, ref, got, model_type):
    """Two-rank results against the one-process steps: STEP_TOL's loss and
    grad norm gaps and BN running statistics; params within twice the sum
    of their group's LRs over the steps (AdamW's early steps turn a
    near-zero grad's rounding into a step of either sign)."""
    from video_fingerprint_tpu_torch.training.optim import param_group_label

    (ref_metrics, ref_state), (metrics, state) = ref, got
    out = {"loss": [], "grad_norm": []}
    for r, g in zip(ref_metrics, metrics):
        for key in out:
            gap = abs(g[key] - r[key]) / abs(r[key])
            require(gap <= STEP_TOL[key], f"{model_type} two ranks: {key} gap {gap}")
            out[key].append(gap)
    lr_sum = {}
    for m in ref_metrics:
        for label, lr in m["lrs"].items():
            lr_sum[label] = lr_sum.get(label, 0.0) + lr
    worst, bn_worst = 0.0, 0.0
    for key, r in ref_state.items():
        diff = (state[key] - r).abs()
        if "running_" in key:
            bn_worst = max(bn_worst, float((diff / r.abs().clamp_min(1.0)).max()))
        else:
            label = "all" if "all" in lr_sum else param_group_label(key)
            worst = max(worst, float(diff.max()) / lr_sum[label])
    require(bn_worst <= STEP_TOL["bn"], f"{model_type} two ranks: BN gap {bn_worst}")
    require(worst <= 2.001, f"{model_type} two ranks: params off by {worst} LR")
    return {"rel_gap": out, "bn_rel_gap": bn_worst, "param_max_gap_in_lr": worst,
            "loss": [m["loss"] for m in metrics]}


def _dp_train(torch, workdir: Path, smi: str):
    """Two gloo ranks on cuda:0 (spawned), each with half of a global batch
    of 64 (attention, T = 64, ragged masks, the same extract draws, 2 steps)
    and of 128 windows (3D, one step), against the same steps in this
    process on the global batch."""
    import multiprocessing

    from video_fingerprint_tpu_torch.parallel.distributed import world_size

    require(world_size() == 1, "this process must not be in a process group")
    refs = {m: _dp_train_run(torch, m, lambda tree: tree) for m in ("attention", "3d")}
    gc.collect()
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    outs = [workdir / f"dp_rank{r}.pt" for r in range(2)]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_dp_train_rank, args=(r, 2, port, str(outs[r])))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    seconds = time.perf_counter() - t0
    require(all(p.exitcode == 0 for p in procs),
            f"two-rank train: exit codes {[p.exitcode for p in procs]}")
    ranks = [torch.load(o, weights_only=False) for o in outs]
    result = {"backend": ranks[0]["backend"], "seconds": seconds,
              "gloo_cuda_all_gather": ranks[0]["gloo_cuda_all_gather"]}
    for model_type in ("attention", "3d"):
        for key, v in ranks[0][model_type][1].items():
            require(torch.equal(v, ranks[1][model_type][1][key]),
                    f"{model_type}: the ranks' {key} differ")
        result[model_type] = _dp_compare(torch, refs[model_type], ranks[0][model_type],
                                         model_type)
    emit({"phase": "multigpu", "check": "dp_train", "ranks_on_one_card": 2, "smi": smi,
          **result})
    return result


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_CLI_SHIM = """
import json, sys, time
import torch
from video_fingerprint_tpu_torch.cli.train import main
from video_fingerprint_tpu_torch.parallel import distributed
from video_fingerprint_tpu_torch.training.trainer import Trainer
from video_fingerprint_tpu_torch.utils import trace

stats = {"launches": {}, "seconds": {}, "steps": 0}

def counted(name):
    real = getattr(Trainer, name)
    def run(self, *args, **kwargs):
        before, t0, step0 = trace.counter("k1.launches"), time.perf_counter(), self.global_step
        out = real(self, *args, **kwargs)
        torch.cuda.synchronize()
        launched = trace.counter("k1.launches") - before
        stats["launches"][name] = stats["launches"].get(name, 0) + launched
        stats["seconds"][name] = stats["seconds"].get(name, 0.0) + time.perf_counter() - t0
        if name == "train_epoch":
            stats["steps"] += self.global_step - step0
        return out
    return run

for name in ("train_epoch", "validate"):
    setattr(Trainer, name, counted(name))
rc = main(sys.argv[2:])
stats.update(rc=rc, world=distributed.world_size(),
             backend=torch.distributed.get_backend()
             if torch.distributed.is_initialized() else None)
with open(sys.argv[1], "w") as f:
    json.dump(stats, f)
sys.exit(rc)
"""


def _nccl_cli(torch, workdir: Path, smi: str):
    """The train CLI for one epoch of phase 8's 16-video corpus under
    `python -m torch.distributed.run --standalone --nproc_per_node 1` (NCCL,
    world 1), through a shim that counts K1's launches and times the train
    epoch: the artifacts (rank 0's), K1 in validation only, steps/s. (The
    CLI without the launcher runs in phases train and augment.)"""
    from video_fingerprint_tpu_torch.utils.synthetic import make_corpus

    videos = workdir / "train_videos"
    if not videos.exists():
        make_corpus(videos, num_unique=14, num_frames=40, duplicates=2)
    shim = workdir / "train_cli_shim.py"
    shim.write_text(_CLI_SHIM)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    mode = "nccl_world1"
    stats = workdir / f"{mode}.json"
    args = [str(shim), str(stats), "--data_dir", str(videos), "--batch_size", "4",
            "--num_workers", "4", "--max_frames", "64", "--epochs", "1", "--run_name", mode]
    launcher = ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *launcher, *args], cwd=workdir, env=env,
                          capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0,
            f"train CLI ({mode}) exited {proc.returncode}: {proc.stderr[-2000:]}")
    s = json.loads(stats.read_text())
    run = workdir / "runs" / mode
    for name in ("config.json", "training_info.txt", "training_log.txt",
                 "training_summary.txt", "checkpoints/last.ckpt", "checkpoints/best.ckpt"):
        require((run / name).exists(), f"train CLI ({mode}) left no {name}")
    require(s["launches"].get("validate", 0) > 0, f"{mode}: validation did not run K1")
    require(s["launches"].get("train_epoch", 0) == 0, f"{mode}: a train step ran K1")
    require(s["backend"] == "nccl" and s["world"] == 1,
            f"the launched CLI did not join an NCCL group: {s}")
    runs = {mode: {"backend": s["backend"], "world": s["world"], "steps": s["steps"],
                   "train_epoch_s": s["seconds"]["train_epoch"],
                   "steps_per_s": s["steps"] / s["seconds"]["train_epoch"],
                   "attention_launches": s["launches"], "process_s": time.perf_counter() - t0}}
    emit({"phase": "multigpu", "check": "nccl_cli", "smi": smi, **runs})
    return runs


def phase_multigpu(torch, workdir: Path, smi: str):
    """Every multi-device path on the one card: the data-parallel scan over 4
    shards and the 3D scan over 2, the sharded and ring searches over
    4, data-parallel training in 2 gloo ranks, the train CLI under the
    launcher on NCCL. Times are k shards or ranks on one card."""
    t0 = time.perf_counter()
    parts, seconds = {}, {}
    for name, run in (("scan", lambda: _dp_scan(torch, workdir, smi)),
                      ("search", lambda: _dp_search(torch, smi)),
                      ("train", lambda: _dp_train(torch, workdir, smi)),
                      ("cli", lambda: _nccl_cli(torch, workdir, smi))):
        t_part = time.perf_counter()
        parts[name] = run()
        seconds[name] = time.perf_counter() - t_part
    emit({"phase": "multigpu", "smi": smi, "scan": parts["scan"], "train": parts["train"],
          "cli": parts["cli"],
          "search_ms": {k: {"ms": v["ms"], "single_card_ms": v["single_card_ms"]}
                        for k, v in parts["search"].items()},
          "part_seconds": seconds, "seconds": time.perf_counter() - t0})


MP_RANKS = 2
MP_REPEATS = 3  # timed calls per cross-rank search: a fixed count, the same on every rank
MP_METHODS = (("exact", None),) + CERTIFIED_METHODS
S2D_FRAMES = BATCH * 128  # conv0 timed at 64 videos x 128 frames


def _method_name(method, thr):
    return method if thr is None else f"{method}@{thr}"


def _wall_ms(torch, fn, repeats: int = MP_REPEATS):
    """Host-clock ms per call over `repeats` calls ending in a synchronize,
    after one call, and the ms per call spent in the port's collectives
    (their `collective` spans, recorded over `repeats` more calls under the
    profiler, so the timed calls run untraced). A call across ranks waits
    for every rank, so its time is the host's, and every rank makes the
    same count of calls."""
    from video_fingerprint_tpu_torch.parallel import distributed
    from video_fingerprint_tpu_torch.utils import trace

    fn()
    torch.cuda.synchronize()
    if distributed.world_size() > 1:
        torch.distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / repeats
    trace.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    return ms, trace.recorded().self_seconds.get("collective", 0.0) * 1e3 / repeats


def _mp_rank(rank: int, world: int, port: int, out_path: str, data_path: str) -> None:
    """One rank of the cross-process search (a spawned process): joins a
    gloo group through the launcher's environment, both ranks on cuda:0,
    reads phase 7's data from the parent's file, stages its block, and runs
    every search of the phase with its results and times."""
    import torch

    from video_fingerprint_tpu_torch.inference.index import FingerprintIndex
    from video_fingerprint_tpu_torch.ops import topk
    from video_fingerprint_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from video_fingerprint_tpu_torch.utils import trace

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    maybe_initialize_distributed(CARD, backend="gloo")
    corpus, _, _, _, queries, _, emb = _index_data(data_path)
    q_dev = torch.from_numpy(queries).to(CARD)
    out = {"backend": torch.distributed.get_backend(), "searches": {}, "held": {}}

    def run(what, staged, search):
        for method, thr in MP_METHODS:
            before = trace.counter("topk.repaired_rows")
            launches = trace.counter("k1.launches")
            scores, idx = (t.cpu().numpy() for t in search(staged, method, thr))
            repaired = trace.counter("topk.repaired_rows") - before
            ms, coll_ms = _wall_ms(torch, lambda: search(staged, method, thr))
            out["searches"][f"{what} {_method_name(method, thr)}"] = {
                "scores": scores, "idx": idx, "ms": ms, "collective_ms": coll_ms,
                "repaired_rows": repaired,
                "attention_launches": trace.counter("k1.launches") - launches}
        out["held"][what] = [(staged.offset(i), len(staged.valid(i)))
                             for i in range(len(staged.shards))]

    for storage in ("f32", "bf16"):
        dtype = torch.bfloat16 if storage == "bf16" else torch.float32
        staged = topk.stage_sharded_corpus(corpus, [CARD], dtype)
        run(storage, staged, lambda c, m, thr: topk.sharded_topk_search(
            q_dev, c, 20, exact_above=thr, method=m))
        del staged
        index = FingerprintIndex(dim=EMB_DIM, device=CARD, storage=storage)
        index.add(corpus)
        scores, idx = index.search(queries, k=20, exact_above=0.99)
        out["index " + storage] = {"scores": scores, "idx": idx,
                                   "sharded": index._staged_sharded is not None}
        del index
        torch.cuda.empty_cache()
    del corpus
    staged = topk.stage_sharded_corpus(emb, [CARD])
    run("ring", staged, lambda c, m, thr: topk.sharded_topk_cosine(
        c, 20, exact_above=thr, method=m))
    torch.distributed.destroy_process_group()
    torch.save(out, out_path)


def _mp_spawn(torch, workdir: Path):
    """MP_RANKS gloo ranks of _mp_rank on cuda:0; each must exit 0 within
    its limit, or the phase fails."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    outs = [workdir / f"mp_rank{r}.pt" for r in range(MP_RANKS)]
    data = str(_save_index_data(workdir))
    procs = [ctx.Process(target=_mp_rank, args=(r, MP_RANKS, port, str(outs[r]), data))
             for r in range(MP_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    require(all(p.exitcode == 0 for p in procs),
            f"cross-rank search: exit codes {[p.exitcode for p in procs]}")
    return [torch.load(o, weights_only=False) for o in outs], time.perf_counter() - t0


def _mp_references(torch):
    """The one-process searches on the card that the ranks are held to:
    for each storage and method the result and its ms, exact's float64
    oracle on the checked rows, and the one-process index's answer."""
    from video_fingerprint_tpu_torch.inference.index import FingerprintIndex
    from video_fingerprint_tpu_torch.ops import topk
    from video_fingerprint_tpu_torch.utils import trace

    corpus, src, dst, _, queries, checked, emb = _index_data()
    planted = [(j, dst[j]) for j in range(256)] + [(256 + j, src[j]) for j in range(256)]
    q_dev = torch.from_numpy(queries).to(CARD)
    refs = {}

    def run(what, search, rows, sims, oracle_idx, planted, bound):
        for method, thr in MP_METHODS:
            before = trace.counter("topk.repaired_rows")
            scores, idx = (t.cpu().numpy() for t in search(method, thr))
            repaired = trace.counter("topk.repaired_rows") - before
            ms, _ = _wall_ms(torch, lambda: search(method, thr))
            refs[f"{what} {_method_name(method, thr)}"] = {
                "scores": scores, "idx": idx, "ms": ms, "repaired_rows": repaired,
                "rows": rows, "sims": sims,
                "oracle_idx": oracle_idx, "planted": planted, "thr": thr,
                "method": method, "bound_ms": bound[0], "bound_by": bound[1]}

    for storage in ("f32", "bf16"):
        dtype = torch.bfloat16 if storage == "bf16" else torch.float32
        single = topk.stage_corpus(corpus, CARD, dtype)
        sims, oracle_idx = _oracle(storage)
        run(storage, lambda m, thr: topk.topk_search(q_dev, single, 20, exact_above=thr,
                                                     method=m),
            checked, sims, oracle_idx, planted,
            _search_bound_ms(INDEX_QUERIES, INDEX_ROWS, single.numel() * single.element_size()))
        del single
        index = FingerprintIndex(dim=EMB_DIM, device=CARD, storage=storage)
        index.add(corpus)
        scores, idx = index.search(queries, k=20, exact_above=0.99)
        refs["index " + storage] = {"scores": scores, "idx": idx}
        del index
        torch.cuda.empty_cache()
    del corpus
    e_dev = torch.from_numpy(emb).to(CARD)
    rows = np.arange(0, SELF_SEARCH_ROWS, SELF_SEARCH_ROWS // 16)
    sims, oracle_idx = _oracle("self")
    run("ring", lambda m, thr: topk.topk_cosine(e_dev, 20, exact_above=thr, method=m),
        rows, sims, oracle_idx, [(r, r + 1) for r in range(0, SELF_SEARCH_ROWS, 1000)],
        _search_bound_ms(SELF_SEARCH_ROWS, SELF_SEARCH_ROWS, emb.nbytes))
    return refs


def _mp_search(torch, workdir: Path, smi: str):
    """Phase 7's 10^6 x 256 index (4,096 queries, k = 20) in f32 and bf16
    storage, and its 10^5 self-search, across two gloo ranks on cuda:0,
    each rank holding half of the corpus: every method, every rank's result
    identical, exact equal to the one-process exact search (indices, scores
    within 1e-5) and the float64 oracle, the certified methods to phase 7's
    contracts; FingerprintIndex.search across the ranks equal to one
    process's. ms per rank (host clock, each call waits for both ranks),
    the collectives' ms, the one-process ms and the bound."""
    refs = _mp_references(torch)
    gc.collect()
    torch.cuda.empty_cache()
    ranks, seconds = _mp_spawn(torch, workdir)
    half = INDEX_ROWS // MP_RANKS
    for r, out in enumerate(ranks):
        require(out["held"]["f32"] == [(r * half, half)], f"rank {r} held {out['held']}")
        require(out["backend"] == "gloo", f"rank {r}: backend {out['backend']}")
    rows = {}
    for name, ref in ((n, v) for n, v in refs.items() if not n.startswith("index")):
        got = [out["searches"][name] for out in ranks]
        for r in range(1, MP_RANKS):
            require(np.array_equal(got[r]["idx"], got[0]["idx"])
                    and np.array_equal(got[r]["scores"], got[0]["scores"]),
                    f"{name}: rank {r}'s result differs from rank 0's")
        scores, idx = got[0]["scores"], got[0]["idx"]
        exact = refs[name.split(" ")[0] + " exact"]
        rows_ = ref["rows"]
        if ref["method"] == "exact":
            require(bool((idx == ref["idx"]).all()), f"{name}: indices differ from one process")
            diff = float(np.abs(scores - ref["scores"]).max())
            require(diff <= 1e-5, f"{name}: scores off one process's by {diff}")
            err = _check_oracle(scores[rows_], idx[rows_], ref["sims"], ref["oracle_idx"], name)
        elif ref["thr"] is None:
            diff = float(np.abs(np.sort(scores, 1) - np.sort(exact["scores"], 1)).max())
            require(diff <= 1e-6, f"{name}: not exact's scores ({diff})")
            err = _check_oracle(scores[rows_], idx[rows_], ref["sims"], ref["oracle_idx"], name)
        else:
            err = _check_threshold(scores[rows_], idx[rows_], ref["sims"], ref["thr"], name)
            for row, other in ref["planted"]:
                hits = dict(zip(idx[row].tolist(), scores[row].tolist()))
                require(hits.get(int(other), -1.0) >= ref["thr"],
                        f"{name}: planted copy of row {row} not found")
            diff = None
        require(all(g["attention_launches"] == 0 for g in got),
                f"{name}: a hand kernel ran in the search")
        require(len({g["repaired_rows"] for g in got}) == 1,
                f"{name}: the ranks repaired different rows")
        rows[name] = {"ms_per_rank": [g["ms"] for g in got],
                      "collective_ms_per_rank": [g["collective_ms"] for g in got],
                      "one_process_ms": ref["ms"], "bound_ms": ref["bound_ms"],
                      "bound_by": ref["bound_by"],
                      "repaired_rows_per_rank": [g["repaired_rows"] for g in got],
                      "one_process_repaired_rows": ref["repaired_rows"],
                      "max_diff_vs_one_process": diff, "max_score_err": err}
        emit({"phase": "multiproc", "check": "search", "search": name,
              "ranks_on_one_card": MP_RANKS, "smi": smi, **rows[name]})
    for storage in ("f32", "bf16"):
        ref = refs["index " + storage]
        for r, out in enumerate(ranks):
            got = out["index " + storage]
            require(got["sharded"], f"index {storage}: rank {r} did not shard")
            require(bool((got["idx"] == ref["idx"]).all()),
                    f"index {storage}: rank {r}'s indices differ from one process")
            diff = float(np.abs(got["scores"] - ref["scores"]).max())
            require(diff <= 1e-5, f"index {storage}: rank {r} off by {diff}")
    return {"searches": rows, "ranks_seconds": seconds}


def _mp_worker(torch, smi: str):
    """tools/multiproc_dedup.py under torch.distributed.run: two gloo ranks
    sharing cuda:0, and one rank on NCCL, the two launches at once (each
    launcher picks its own free port); each rank must print its OK line."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    t0 = time.perf_counter()
    procs = {name: (nproc, subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(nproc), "-m", "video_fingerprint_tpu_torch.tools.multiproc_dedup", *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name, nproc, extra in (("gloo_2_ranks_one_card", 2,
                                    ["--device", "cuda:0", "--backend", "gloo"]),
                                   ("nccl_1_rank", 1, []))}
    runs = {}
    try:
        for name, (nproc, proc) in procs.items():
            out, err = proc.communicate(timeout=300)
            ok = out.count(f"sharded dedup over {nproc} processes OK")
            require(proc.returncode == 0 and ok == nproc,
                    f"multiproc_dedup ({name}) exited {proc.returncode}, {ok} OK lines: "
                    f"{out[-1500:]} {err[-1500:]}")
            runs[name] = {"ranks": nproc, "seconds": time.perf_counter() - t0}
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    emit({"phase": "multiproc", "check": "worker", "smi": smi, **runs})
    return runs


def _s2d(torch, workdir: Path, smi: str):
    """The space-to-depth first conv on the card: phase 3's weights and clips
    through the scan's batching stage with the fused s2d model against the
    standard fused model (cosine >= 0.9999 per clip, K1 launched 4 times
    per forward), and conv0 in both layouts at 64 x 128 frames by CUDA-graph
    replay (the s2d conv alone and with its relayout of the input)."""
    from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner
    from video_fingerprint_tpu_torch.models import create_model
    from video_fingerprint_tpu_torch.models.fuse import fuse_state_dict
    from video_fingerprint_tpu_torch.models.layers import space_to_depth
    from video_fingerprint_tpu_torch.ops import attention as attn
    from video_fingerprint_tpu_torch.utils.precision import full_fp32
    from video_fingerprint_tpu_torch.utils.timing import graph_ms
    from video_fingerprint_tpu_torch.utils.torch_compat import variables_to_state_dict

    rng = np.random.default_rng(SEED)
    model_path = workdir / "model_s2d.pth"
    _write_model(torch, model_path, rng)  # phase 3's draws: its clips come next
    items, _ = _seeded_clips(rng)
    per_bucket = {}
    for _, clip in items:
        b = next(b for b in BUCKETS if clip.shape[0] <= b)
        per_bucket[b] = per_bucket.get(b, 0) + 1
    forwards = sum(-(-n // BATCH) for n in per_bucket.values())
    embs = {}
    for layout in ("standard", "s2d"):
        with contextlib.redirect_stdout(io.StringIO()):
            scanner = FingerprintScanner(str(model_path), device=CARD, batch_size=BATCH)
        if layout == "s2d":
            standard_conv0 = scanner.model.spatial_encoder.encoder[0]
            sd = fuse_state_dict(variables_to_state_dict(scanner.variables, "attention"),
                                 s2d=True)
            model = create_model("attention", fused=True, s2d=True)
            model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                                  strict=True)
            model.to(CARD).eval().spatial_encoder.to(memory_format=torch.channels_last)
            scanner.model = model
        scanner.warmup()
        mark = _launch_counts()
        embs[layout] = scanner.embed_clips(items)
        torch.cuda.synchronize()
        launches = _launches(mark)["attention"]
        require(launches == 4 * forwards,
                f"s2d {layout}: K1 launched {launches} times, not 4 x {forwards} forwards")
    cos = min(float(np.dot(embs["s2d"][k], embs["standard"][k])) for k, _ in items)
    require(cos >= 0.9999, f"s2d vs standard fused: cosine {cos}")
    frames = torch.from_numpy(rng.integers(0, 256, (S2D_FRAMES, 64, 64, 3),
                                           dtype=np.uint8)).to(CARD)
    x = frames.permute(0, 3, 1, 2).float() / 255.0  # the encoder's channels-last input
    conv0 = model.spatial_encoder.encoder[0]
    blocks = space_to_depth(x)
    with torch.inference_mode(), full_fp32():
        ms = {"standard_5x5_s2": graph_ms(lambda: standard_conv0(x), calls=3),
              "s2d_3x3_s1": graph_ms(lambda: conv0(blocks), calls=3),
              "s2d_with_relayout": graph_ms(lambda: conv0(space_to_depth(x)), calls=3),
              "relayout": graph_ms(lambda: space_to_depth(x), calls=3)}
    row = {"videos": len(items), "forwards": forwards, "attention_launches": launches,
           "min_cos_vs_standard": cos, "conv0_frames": S2D_FRAMES, "conv0_ms": ms}
    emit({"phase": "multiproc", "check": "s2d", "smi": smi, **row})
    return row


def phase_multiproc(torch, workdir: Path, smi: str):
    """The corpus-sharded search across processes (two gloo ranks sharing
    the one card), the multi-process dedup worker under the launcher, and
    the s2d conv0 fold. Times are two ranks on one card: the cost of the
    process layer, not a speed-up."""
    from video_fingerprint_tpu_torch.parallel.distributed import world_size

    require(world_size() == 1, "this process must not be in a process group")
    t0 = time.perf_counter()
    s2d = _s2d(torch, workdir, smi)
    _settle(torch)
    search = _mp_search(torch, workdir, smi)
    worker = _mp_worker(torch, smi)
    emit({"phase": "multiproc", "smi": smi, "s2d": s2d, "worker": worker,
          "ranks_seconds": search["ranks_seconds"],
          "search_ms": {k: {"ms_per_rank": v["ms_per_rank"],
                            "one_process_ms": v["one_process_ms"]}
                        for k, v in search["searches"].items()},
          "seconds": time.perf_counter() - t0})


BENCH_BUDGET = 330  # seconds for the benchmark program's legs in phase `bench`
BENCH_COS = 0.999   # bf16 headline embeddings against the f32 forward
HEADLINE_KEYS = ("graph_vps", "pipelined_vps", "sync_per_batch_vps", "streaming_vps")


def phase_bench(torch, workdir: Path, smi: str):
    """The benchmark program (tools/bench.py) end to end: its last line
    carries the headline (graph replay, MFU in (0, 1]) and every later
    leg's keys; no leg failed and none was skipped. The headline's first
    bf16 embeddings against the same seeded weights' f32 forward on the
    card (K1 launched 4 times per forward, counted in this process and by
    the leg), every dedup method verified, every planted e2e copy found
    and no other videos grouped."""
    from video_fingerprint_tpu_torch.ops import attention as attn
    from video_fingerprint_tpu_torch.tools import bench, bench_headline
    from video_fingerprint_tpu_torch.utils.precision import full_fp32

    npz = workdir / "headline_embeddings.npz"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "video_fingerprint_tpu_torch.tools.bench",
         "--budget", str(BENCH_BUDGET), "--save_embeddings", str(npz)],
        capture_output=True, text=True, timeout=BENCH_BUDGET + 60,
        cwd=Path(__file__).resolve().parent)
    seconds = time.perf_counter() - t0
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    require(bool(lines), f"bench printed no line (rc {proc.returncode}): "
                         f"{proc.stderr[-2000:]}")
    line = json.loads(lines[-1])
    require(proc.returncode == 0 and not line["failed_legs"],
            f"bench rc {proc.returncode}, failed legs {line['failed_legs']}: "
            f"{proc.stderr[-2000:]}")
    require(line["metric"] == bench.METRIC and line["unit"] == "videos/sec/chip"
            and line["regime"] == "cuda graph replay" and line["value"] > 0,
            f"headline line {line}")
    require(0 < line["mfu_vs_h100_bf16_peak"] <= 1, f"MFU {line['mfu_vs_h100_bf16_peak']}")
    require(line["k1_launches_per_forward"] == 4
            and line["k1_launches_in_capture"] == 4 * bench_headline.N_BATCHES,
            f"K1 launches in the headline: {line['k1_launches_per_forward']} per forward, "
            f"{line['k1_launches_in_capture']} in the graphs")
    require(line["skipped_legs"] == [], f"legs skipped: {line['skipped_legs']}")
    for key in ("train_steps_per_sec_b64_t64_bf16_dispatched", "e2e_scan_vps_with_decode"):
        require(key in line, f"no {key} in the line")
    require(line["e2e_planted_pairs"] > 0
            and line["e2e_planted_pairs_found"] == line["e2e_planted_pairs"],
            f"e2e found {line['e2e_planted_pairs_found']} of "
            f"{line['e2e_planted_pairs']} planted copies")
    require(line["e2e_duplicate_groups"] == line["e2e_planted_pairs"]
            and set(line["e2e_group_sizes"]) == {2},
            f"e2e groups {line['e2e_group_sizes']}: distinct videos grouped")
    for name, _, _ in bench.DEDUP_METHODS:
        require(bool(line.get(f"dedup_verified_{name}")), f"dedup {name} not verified")

    saved = np.load(npz)
    frames = torch.from_numpy(saved["frames"]).to(CARD)
    n, T = frames.shape[:2]
    model = bench_headline.fused_model(int(saved["seed"]), torch.device(CARD), torch.float32)
    mark = _launch_counts()
    with torch.no_grad(), full_fp32():
        ref = model.forward_flat(frames.reshape((n * T,) + tuple(frames.shape[2:])), n)
    torch.cuda.synchronize()
    launches = _launches(mark)
    require(launches["attention"] == 4, f"f32 forward launched K1 {launches} times")
    ref = ref.cpu().numpy()
    emb = saved["embeddings"]
    cos = np.sum(emb * ref, axis=1) / (np.linalg.norm(emb, axis=1) * np.linalg.norm(ref, axis=1))
    require(float(cos.min()) >= BENCH_COS, f"bf16 headline vs f32: cosine {cos}")
    sims = ref @ ref.T
    distinct = float(sims[~np.eye(n, dtype=bool)].max())
    require(distinct < BENCH_COS, f"the headline's clips are not distinct: {distinct}")
    row = {"phase": "bench", "smi": smi, "seconds": seconds, "rc": proc.returncode,
           "bf16_vs_f32_cos_min": float(cos.min()), "distinct_max_cos": distinct,
           "f32_check_launches": launches, "line": line}
    emit(row)
    return row


TOOL_TIMEOUT_S = 600


def _tool(name: str, *args: str) -> tuple[list, float]:
    """`python -m video_fingerprint_tpu_torch.tools.<name> args` on the card in
    a process of its own: (its JSON lines, seconds). A non-zero exit fails
    the phase."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"video_fingerprint_tpu_torch.tools.{name}",
                           *args], capture_output=True, text=True, timeout=TOOL_TIMEOUT_S,
                          cwd=Path(__file__).resolve().parent)
    require(proc.returncode == 0, f"tool {name} {args} exited {proc.returncode}: "
                                  f"{proc.stdout[-1500:]} {proc.stderr[-2500:]}")
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    require(bool(lines), f"tool {name} printed no JSON line")
    return lines, time.perf_counter() - t0


PROFILE_FULL_TOL = 0.10  # the profile's full leg against headline_forward_ms


def phase_profile(torch, smi: str):
    """tools/profile_extraction.py at the headline's shape (B = 512, T =
    128, the seeded fused bf16 model), in a process of its own: the top
    device kernels of one forward and of each stage, the JAX split, every
    cumulative stack leg with cudnn.benchmark off and on beside its byte
    and operation bounds, and the conv0 probes.
    The stages chain to forward_flat; K1 runs 4 times per forward; the full
    leg lands within PROFILE_FULL_TOL of headline_forward_ms, timed in the
    tool's process."""
    t0 = time.perf_counter()
    # its own process: torch.profiler, which names the kernels, recorded only
    # part of them in a process that had captured CUDA graphs before
    res = _tool("profile_extraction")[0][-1]
    require(res["chained_vs_forward_flat_maxerr"] <= TOLERANCE["bfloat16"],
            f"profile: the stages do not chain to forward_flat "
            f"({res['chained_vs_forward_flat_maxerr']})")
    require(res["k1_launches_per_forward"] == 4,
            f"profile: K1 launched {res['k1_launches_per_forward']} times per forward")
    stack = res["stack"]
    for leg, row in stack.items():
        require(row["benchmark_off"] > 0 and row["benchmark_on"] > 0 and row["bound_ms"] > 0,
                f"profile: stack leg {leg} {row}")
    for cfg, row in res["split"].items():
        require(all(row[k] > 0 for k in ("full_ms", "spatial_ms", "temporal_ms")),
                f"profile: split {cfg} {row}")
    conv0 = res["conv0"]
    require(conv0["wide4_vs_ref_maxerr"] <= 1e-4 and conv0["s2d_f32_vs_k5s2_maxerr"] <= 1e-4,
            f"profile: conv0 rewrites disagree with conv0: {conv0['wide4_vs_ref_maxerr']}, "
            f"{conv0['s2d_f32_vs_k5s2_maxerr']}")
    kernels = res["kernels"]
    require(bool(kernels["kernels"]) and kernels["k1_ms"] > 0,
            f"profile: no device kernels or no K1 in the trace: {kernels['kernels']}")
    full, headline = stack["full"]["benchmark_off"], res["headline_forward_ms"]
    gap = abs(full - headline) / headline
    require(gap <= PROFILE_FULL_TOL,
            f"profile: full leg {full} ms against headline_forward_ms {headline} ms")
    own = {leg: row["own_ms"] for leg, row in stack.items() if "own_ms" in row}
    legs = {leg: {k: row[k] for k in ("benchmark_off", "benchmark_on", "bytes", "flops",
                                      "byte_bound_ms", "flop_bound_ms", "bound_ms", "bound_by")}
            for leg, row in stack.items()}
    convs = sum(own[leg]["benchmark_off"] for leg in ("conv0", "conv0_1", "conv0_2", "conv0_3"))
    row = {"phase": "profile", "smi": smi, "batch": res["batch"], "frames": res["frames"],
           "parameters": res["parameters"], "stack": legs, "own_ms": own,
           "conv_own_ms_sum": convs,
           "stage_own_ms_sum": stack["convert"]["benchmark_off"] + sum(
               v["benchmark_off"] for v in own.values()),
           "full_leg_ms": full, "headline_forward_ms": headline, "full_vs_headline": gap,
           "split": res["split"], "conv0": conv0, "kernels": kernels,
           "seconds": time.perf_counter() - t0}
    emit(row)
    return row


GRAFT_DEVICES = 4  # dryrun_multichip's devices: cuda:0 four times


def phase_graft(torch, smi: str):
    """tools/graft_entry.py: entry()'s forward on the card (K1 launched 4
    times, a unit embedding, cosine >= 0.9999 with the same variables'
    forward on the CPU), then dryrun_multichip(GRAFT_DEVICES) over cuda:0
    repeated, every program against its one-device oracle."""
    from video_fingerprint_tpu_torch.tools import graft_entry

    t0 = time.perf_counter()
    fn, (variables, video) = graft_entry.entry()
    mark = _launch_counts()
    out = fn(variables, video)
    torch.cuda.synchronize()
    launches = _launches(mark)["attention"]
    require(launches == 4, f"graft entry: K1 launched {launches} times")
    emb = out.cpu().numpy()
    require(emb.shape == (1, 256) and bool(np.isfinite(emb).all())
            and abs(float(np.linalg.norm(emb)) - 1.0) <= 1e-4, f"graft entry: {emb}")
    cpu_fn, _ = graft_entry.entry(device="cpu")
    ref = cpu_fn(variables, video.cpu()).numpy()
    cos = float(np.dot(emb[0], ref[0]) / (np.linalg.norm(emb) * np.linalg.norm(ref)))
    require(cos >= 0.9999, f"graft entry: card vs CPU cosine {cos}")
    entry_s = time.perf_counter() - t0
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        graft_entry.dryrun_multichip(GRAFT_DEVICES, ["cuda:0"] * GRAFT_DEVICES)
    lines = [line for line in log.getvalue().splitlines() if line.startswith("dryrun_multichip")]
    require(len(lines) == 8, f"graft dry run printed {lines}")
    row = {"phase": "graft", "smi": smi, "k1_launches": launches, "card_vs_cpu_cos": cos,
           "entry_seconds": entry_s, "devices": ["cuda:0"] * GRAFT_DEVICES,
           "programs": lines, "seconds": time.perf_counter() - t0}
    emit(row)
    return row


BUCKET_REPS = 24  # K1 calls per captured graph in exp_attention_buckets
TRAJECTORY_VIDEOS = 24


def _require_keys(what: str, row: dict, keys, positive=()) -> None:
    missing = [k for k in keys if k not in row]
    require(not missing, f"{what}: keys {missing} missing from {sorted(row)}")
    bad = [k for k in positive if not row[k] > 0]
    require(not bad, f"{what}: {[(k, row[k]) for k in bad]} not > 0")


BUCKET_RUNS = (("buckets", ["--dim", "32", "4", "16", "64"]),
               ("b64_t128", ["--batch", "64", "--buckets", "128", "--dim", "4", "16", "64"]))


def _tools_buckets(tools: dict) -> dict:
    """exp_attention_buckets at every scan bucket (B·H = 16 x 8) and D = 32,
    4, 16, 64, f32 and bf16; and at the attention phase's B = 64 x 8, T =
    128 for D = 4, 16, 64 (the §6 K1 row's shape). Every row: K1 launched
    BUCKET_REPS times per replay, K1 within 1e-5 (f32) or 2e-2 (bf16) of the
    plain version, three device times > 0."""
    out = {}
    for tag, _ in BUCKET_RUNS:
        lines = tools[f"exp_attention_buckets_{tag}"]["lines"]
        table = lines[-1]["table"]
        require(len(table) == len(lines) - 1 and "decision" in lines[-1],
                f"buckets {tag}: {lines[-1]}")
        for row in table:
            what = f"buckets {tag} D={row['D']} {row['dtype']} T={row['T']}"
            _require_keys(what, row, ("T", "BH", "plain_us_per_call", "k1_us_per_call",
                                      "sdpa_us_per_call", "k1_speedup", "k1_vs_sdpa"),
                          ("plain_us_per_call", "k1_us_per_call", "sdpa_us_per_call"))
            require(row["k1_launches_per_replay"] == BUCKET_REPS,
                    f"{what}: K1 launched {row['k1_launches_per_replay']} times per replay")
            tol = 1e-5 if row["dtype"] == "float32" else 2e-2
            require(row["k1_vs_plain_max_abs_err"] <= tol,
                    f"{what}: K1 off the plain version by {row['k1_vs_plain_max_abs_err']}")
        out[tag] = {"decision": lines[-1]["decision"], "table": table}
    return out


K4_CHECK_FRAMES = (256, 5)  # K4 held bit for bit against the plain version (5: ragged tiles)
K4_FRAMES = 16_384          # K4 timed at exp_int8_conv's N
INT8_PEAK_OPS = 1979e12     # dense int8, H100 SXM data sheet, 700 W


def _k4_bound_ms(n: int, h: int, k: int, cin: int, cout: int, out_bytes: int):
    """Least time for one K4 layer on n frames: the input, the weights,
    scales and bias read once and the output written once, against its
    int8 products at the peak rate."""
    ho = (h + 2 * (k // 2) - k) // 2 + 1
    nbytes = n * h * h * cin + k * k * cin * cout + 8 * cout + n * ho * ho * cout * out_bytes
    ops = 2 * n * ho * ho * cout * k * k * cin
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / INT8_PEAK_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _k4(torch, smi: str) -> dict:
    """K4 (csrc/conv_int8.cu) on the probe's four layers and weights: its
    int32 sums and its int8 and bf16 outputs equal to the plain version's
    bit for bit at K4_CHECK_FRAMES frames (each layer fed the one before,
    conv0 fed uint8 frames and the same frames shifted to int8); then each
    layer of the int8 stack timed at K4_FRAMES by CUDA-graph replay beside
    the plain version and its bound, and, for conv1, torch._int_mm on its
    im2col matrix alone and cuDNN's bf16 conv of the same shape."""
    from video_fingerprint_tpu_torch.ops import conv_int8 as ci
    from video_fingerprint_tpu_torch.tools import exp_int8_conv as eic
    from video_fingerprint_tpu_torch.utils.timing import graph_ms

    card = torch.device(CARD)
    rng = np.random.default_rng(SEED)
    ws_f, bs_f, ws_q, w_scales, a_scales = eic.probe_weights(rng)
    layers = eic.int8_layers(ws_q, w_scales, bs_f, a_scales, card)
    worst, checked = 0.0, []
    for n in K4_CHECK_FRAMES:
        frames = torch.from_numpy(rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)).to(card)
        shifted = (frames.to(torch.int16) - 128).to(torch.int8)
        x = frames
        for i, ((k, cin, cout), (pw, w_scale, bias, requant)) in enumerate(
                zip(eic.SPECS, layers)):
            inputs = (x, shifted) if i == 0 else (x,)
            for xin in inputs:
                what = f"K4 conv{i} ({k}x{k}, {cin} -> {cout}) N={n} {xin.dtype}"
                got = ci.conv_int8_acc(xin, pw)
                ref = ci.conv_acc_plain(xin, pw)
                require(torch.equal(got, ref), f"{what}: int32 sums differ from the plain "
                        f"version by {(got - ref).abs().max().item()}")
                outs = {}
                for rq in (requant, None):
                    got = ci.conv_int8(xin, pw, w_scale, bias, rq)
                    ref = ci.conv_int8_plain(xin, pw, w_scale, bias, rq)
                    err = (got.float() - ref.float()).abs().max().item()
                    worst = max(worst, err)
                    require(got.dtype == ref.dtype and torch.equal(got, ref),
                            f"{what}: {got.dtype} output off the plain version by {err}")
                    outs[rq is None] = got
                checked.append(what)
            x = outs[False]  # the int8 output feeds the next layer
    torch.cuda.synchronize()

    x = torch.from_numpy(rng.integers(0, 256, (K4_FRAMES, 64, 64, 3), dtype=np.uint8)).to(card)
    rows, library = [], {}
    for i, ((k, cin, cout), (pw, w_scale, bias, requant)) in enumerate(zip(eic.SPECS, layers)):
        rq = None if i == len(layers) - 1 else requant
        h = x.shape[1]
        ms = graph_ms(lambda: ci.conv_int8(x, pw, w_scale, bias, rq))
        plain_ms = graph_ms(lambda: ci.conv_int8_plain(x, pw, w_scale, bias, rq), calls=3)
        bound_ms, bound_by = _k4_bound_ms(K4_FRAMES, h, k, cin, cout, 2 if rq is None else 1)
        rows.append({"layer": f"conv{i}", "k": k, "cin": cin, "cout": cout, "in": h,
                     "out_dtype": "bfloat16" if rq is None else "int8", "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "x_bound": ms / bound_ms})
        if i == 1:
            cols = ci.im2col(x, k).contiguous()
            wmat = pw.matrix[:, :k * k * cin].t().contiguous()
            library["int_mm_conv1_im2col_ms"] = graph_ms(lambda: torch._int_mm(cols, wmat))
            del cols
            xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)
            wb = torch.from_numpy(ws_f[1]).permute(3, 2, 0, 1).to(card, torch.bfloat16)
            wb = wb.contiguous(memory_format=torch.channels_last)
            bb = torch.from_numpy(bs_f[1]).to(card, torch.bfloat16)
            library["cudnn_bf16_conv1_ms"] = graph_ms(
                lambda: torch.relu(torch.nn.functional.conv2d(xb, wb, bb, stride=2, padding=1)))
            del xb
        x = ci.conv_int8(x, pw, w_scale, bias, rq)
        torch.cuda.synchronize()
    row = {"frames_checked": list(K4_CHECK_FRAMES), "checked": checked, "max_abs_err": worst,
           "frames": K4_FRAMES, "layers": rows, "ms": sum(r["ms"] for r in rows),
           "plain_ms": sum(r["plain_ms"] for r in rows),
           "bound_ms": sum(r["bound_ms"] for r in rows),
           "bound_by": "+".join(sorted({r["bound_by"] for r in rows})),
           "library_ms": library["int_mm_conv1_im2col_ms"],
           "library": "torch._int_mm on conv1's im2col matrix alone (conv1 only, no im2col, "
                      "no epilogue)",
           "library_cudnn_bf16_conv1_ms": library["cudnn_bf16_conv1_ms"],
           "library_cudnn_note": "cuDNN bf16 conv1 + bias + ReLU, channels-last, same shape"}
    emit({"phase": "tools", "check": "k4", "smi": smi, **row})
    return row


TOOLS_CHILD_TIMEOUT_S = 1500
INT8_K = 20     # exp_int8_conv's iterations per graph (EXP_K)
INGRAPH_K = 12  # exp_ingraph_forward's forwards per graph (EXP_K)
INGRAPH_REPS = 3


def _tool_runs(workdir: Path) -> list:
    """The card tools of phase `tools` in their order, each as [key, module
    of video_fingerprint_tpu_torch.tools, argv, environment]: the JAX tools'
    default sizes."""
    runs = [["exp_augment_hotspot", "exp_augment_hotspot", [], {}],
            ["bench_device_augment", "bench_device_augment",
             ["--cache-dir", str(workdir / "augbench")], {}],
            ["bench_train_step_float32", "bench_train_step", [], {}],
            ["bench_train_step_bfloat16", "bench_train_step", ["--bf16"], {}],
            ["exp_train_roofline", "exp_train_roofline", [], {}],
            ["bench_streaming_metrics", "bench_streaming_metrics", [], {}]]
    runs += [[f"exp_attention_buckets_{tag}", "exp_attention_buckets",
              [*args, "--dtype", "float32", "bfloat16", "--reps", str(BUCKET_REPS)], {}]
             for tag, args in BUCKET_RUNS]
    runs += [[name, name, [], {}] for name in (
        "exp_topk_precision", "exp_topk_blocked", "exp_topk_cert", "exp_topk_bf16sims",
        "exp_topk_production", "exp_wide_topk", "exp_int8_conv", "exp_input_layout",
        "exp_layout_probe", "exp_ingraph_forward")]
    return runs


def _torch_flags(torch, flags=None):
    """torch's global flags that a tool may set (TF32 for matmuls and convs,
    cudnn.benchmark, the default dtype): their values, after setting them
    to `flags` when given."""
    if flags is not None:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark, dtype) = flags
        torch.set_default_dtype(dtype)
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.benchmark, torch.get_default_dtype())


def _tools_child(spec_path: str, out_path: str) -> int:
    """The child process of phase `tools`: each run of the spec file (see
    _tool_runs) in turn, in this one process, as main(argv) of its module
    with its environment set and its standard output captured; K1's and
    K4's launch counters read before it and after it; torch's flags
    put back and the card settled after it. Each run's output, seconds,
    counts and error (a traceback, or None) go to out_path, rewritten after
    every run."""
    import importlib
    import traceback

    import torch

    from video_fingerprint_tpu_torch.utils import trace

    results = []
    for key, module, argv, env in json.loads(Path(spec_path).read_text()):
        flags = _torch_flags(torch)
        saved_env = {name: os.environ.get(name) for name in env}
        os.environ.update(env)
        k1_before = trace.counter("k1.launches")
        int8_before = trace.counter("conv_int8.conv_int8")
        out, error, t0 = io.StringIO(), None, time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                rc = importlib.import_module(
                    f"video_fingerprint_tpu_torch.tools.{module}").main(argv)
            torch.cuda.synchronize()
            if rc:
                error = f"main returned {rc}"
        except (Exception, SystemExit):  # noqa: BLE001 - the parent fails the phase on it
            error = traceback.format_exc()[-4000:]
        seconds = time.perf_counter() - t0
        launches = {"attention": trace.counter("k1.launches") - k1_before,
                    "conv_int8": trace.counter("conv_int8.conv_int8") - int8_before}
        for name, value in saved_env.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
        _torch_flags(torch, flags)
        _settle(torch)
        results.append({"key": key, "stdout": out.getvalue(), "seconds": seconds,
                        "launches": launches, "error": error})
        Path(out_path).write_text(json.dumps(results))
    return 0


def _run_tools(workdir: Path, runs: list) -> tuple[dict, float]:
    """The runs in one child process (`chip_smoke.py --tools-child`): {key:
    {"lines": its JSON lines, "seconds", "launches"}} and the child's
    seconds. A run that raised, or a child that failed, fails the phase."""
    spec, out_path = workdir / "tools_spec.json", workdir / "tools_out.json"
    spec.write_text(json.dumps(runs))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tools-child",
                           str(spec), str(out_path)], capture_output=True, text=True,
                          timeout=TOOLS_CHILD_TIMEOUT_S, cwd=Path(__file__).resolve().parent)
    results = json.loads(out_path.read_text()) if out_path.exists() else []
    failed = {r["key"]: r["error"] for r in results if r["error"]}
    require(proc.returncode == 0 and not failed and len(results) == len(runs),
            f"tools child exited {proc.returncode} after {len(results)} of {len(runs)} runs; "
            f"failed: {failed}; {proc.stderr[-2500:]}")
    tools = {}
    for r in results:
        lines = [json.loads(line) for line in r["stdout"].splitlines() if line.startswith("{")]
        require(bool(lines), f"tool {r['key']} printed no JSON line")
        tools[r["key"]] = {"lines": lines, "seconds": r["seconds"], "launches": r["launches"]}
    return tools, time.perf_counter() - t0


def _ingraph_f32(torch) -> dict:
    """exp_ingraph_forward's in-graph sum on the card in f32 (TF32 off, the
    seeded fused model, 2 batches of 8 videos x 16 frames, 4 forwards)
    against the same 4 forwards run eagerly: within 1e-4 (relative past 1)."""
    from video_fingerprint_tpu_torch.tools import exp_ingraph_forward as eif
    from video_fingerprint_tpu_torch.tools.bench_headline import fused_model
    from video_fingerprint_tpu_torch.utils.precision import full_fp32

    card = torch.device(CARD)
    model = fused_model(SEED, card, torch.float32)
    staged = eif.staged_batches(SEED, 8, 16, card)
    with torch.no_grad(), full_fp32():
        got = eif.ingraph_sum(model, staged, 8, 4)
        ref = sum(float(model.forward_flat(staged[i % eif.N_STAGED], 8).sum(dtype=torch.float32))
                  for i in range(4))
    require(abs(got - ref) <= 1e-4 * max(1.0, abs(ref)),
            f"exp_ingraph_forward: in-graph sum {got} against eager {ref}")
    return {"ingraph_sum_f32": got, "eager_sum_f32": ref}


def phase_tools(torch, workdir: Path, smi: str):
    """The measurement tools of tools/ at the JAX tools' default sizes: the
    card tools one after another in one child process (_tool_runs), the
    trajectory corpus (no card, 24 videos) in a process beside it; each
    JSON checked: every key there, every rate > 0, no leg that printed an
    error, the top-k probes' results verified against exact, K1 in the
    bucket probe launched once per captured call and equal to the plain
    version, K1 and K4 launched by the forward and int8 probes as many
    times as their legs make, the corpus stamped. Then the in-graph
    forward's f32 sum against eager forwards (_ingraph_f32), and K4 against
    its plain version and timed (_k4)."""
    from video_fingerprint_tpu_torch.tools import exp_int8_conv as eic

    t0 = time.perf_counter()
    res = {}
    traj = workdir / "trajectory"
    corpus = subprocess.Popen(
        [sys.executable, "-m", "video_fingerprint_tpu_torch.tools.make_trajectory_corpus",
         "--out", str(traj), "--videos", str(TRAJECTORY_VIDEOS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=Path(__file__).resolve().parent)
    try:
        tools, child_s = _run_tools(workdir, _tool_runs(workdir))
        _, err = corpus.communicate(timeout=TOOL_TIMEOUT_S)
    finally:
        if corpus.poll() is None:
            corpus.kill()
            corpus.wait()
    require(corpus.returncode == 0, f"trajectory corpus exited {corpus.returncode}: {err[-2000:]}")
    stamp = (traj / ".complete").read_text() if (traj / ".complete").exists() else None
    videos = sorted(p.name for p in traj.glob("traj_*.mp4"))
    require(stamp == f"{TRAJECTORY_VIDEOS}:48:160:100" and len(videos) == TRAJECTORY_VIDEOS,
            f"trajectory corpus: stamp {stamp!r}, {len(videos)} videos")
    res["make_trajectory_corpus"] = {"stamp": stamp, "videos": len(videos)}
    seconds = {key: t["seconds"] for key, t in tools.items()}
    seconds["tools_child"] = child_s

    def last(key):
        return tools[key]["lines"][-1]

    row = res["exp_augment_hotspot"] = last("exp_augment_hotspot")
    stages = ("color", "flip", "noise", "blur", "letterbox_overlay", "rotation",
              "full_pipeline")
    keys = [f"{s}_ms_per_iter" for s in stages]
    _require_keys("augment hotspot", row, keys + ["batch", "frames", "k"], keys)
    require((row["batch"], row["frames"]) == (16, 64), f"augment hotspot: {row}")

    row = res["bench_device_augment"] = last("bench_device_augment")
    rates = ("loader_samples_per_sec_host_augment", "loader_samples_per_sec_device_mode",
             "train_steps_per_sec_augment_off", "train_steps_per_sec_device_augment")
    _require_keys("device augment", row, rates + ("loader_speedup",
                                                  "device_augment_step_overhead_pct",
                                                  "step_batch", "step_frames"), rates)

    for dtype in ("float32", "bfloat16"):
        row = res[f"bench_train_step_{dtype}"] = last(f"bench_train_step_{dtype}")
        rates = ("steps_per_sec_sync_every_step", "steps_per_sec_sync_every_10")
        _require_keys(f"train step {dtype}", row, rates + ("speedup", "device"), rates)
        require((row["batch"], row["frames"], row["dtype"]) == (64, 64, dtype),
                f"train step: {row}")

    row = res["exp_train_roofline"] = last("exp_train_roofline")
    rates = ("step_base_steps_per_sec_dispatched", "step_reuse_steps_per_sec_dispatched",
             "fwd_base_per_sec_dispatched", "fwd_reuse_per_sec_dispatched")
    _require_keys("train roofline", row, rates + (
        "bwd_opt_ms_base", "bwd_opt_ms_reuse", "reuse_step_speedup", "reuse_fwd_speedup",
        "step_base_mfu_dispatched", "step_base_tflops", "flops_source"), rates)

    row = res["bench_streaming_metrics"] = last("bench_streaming_metrics")
    _require_keys("streaming metrics", row, (
        "streaming_metrics_n", "streaming_metrics_s", "auc_roc", "R@1", "mAP",
        "separation_gap", "block_rows", "device_mem_per_block_mb", "dense_equivalent_mb"),
        ("streaming_metrics_s", "auc_roc", "R@1", "mAP", "separation_gap"))
    require(row["streaming_metrics_n"] == 100_000 and row["auc_roc"] <= 1.0,
            f"streaming metrics: {row}")

    res["exp_attention_buckets"] = _tools_buckets(tools)

    row = res["exp_topk_precision"] = last("exp_topk_precision")
    for name in ("HIGHEST", "HIGH", "DEFAULT"):
        _require_keys(f"precision {name}", row[name], ("qps", "median_s"), ("qps",))
    for name in ("HIGH", "DEFAULT"):
        _require_keys(f"precision {name}", row[name], (
            "max_abs_score_delta", "topk_index_agreement", "decision_mismatch@0.95",
            "decision_mismatch@0.99"))

    row = res["exp_topk_blocked"] = last("exp_topk_blocked")
    for name in ("maxonly", "single_topk", "blocked_exact", "approx_0.95"):
        _require_keys(f"blocked {name}", row[name], ("qps", "median_s"), ("qps",))
    require(row["blocked_equals_exact"] and row["blocked_max_score_delta"] == 0.0,
            f"blocked two-stage differs from exact: {row}")
    require(0 < row["approx_recall_measured"] <= 1, f"blocked: {row}")

    row = res["exp_topk_cert"] = last("exp_topk_cert")
    for recall in (0.95, 0.99, 0.999):
        r = row[f"certified@{recall}"]
        _require_keys(f"cert {recall}", r, ("qps", "cert_fail_frac", "blocks_failed",
                                             "effective_qps_with_rerun"), ("qps",))
        require(r["cert_rows_exact"], f"certified@{recall}: certified rows not exact: {r}")

    row = res["exp_topk_bf16sims"] = last("exp_topk_bf16sims")
    for variant in ("max", "approx", "counts"):
        for store in ("f32", "bf16"):
            _require_keys(f"bf16sims {variant}_{store}", row["results"][f"{variant}_{store}"],
                          ("s", "qps", "bytes_per_block", "bound_s_per_block"), ("qps",))
    for store in ("f32", "bf16"):
        require(row["results"][f"counts_{store}"]["certificate_holds"],
                f"bf16sims: the {store} certificate missed an element above the threshold")
    require(row["results"]["production_certified_bf16"]["qps"] > 0, f"bf16sims: {row}")

    row = res["exp_topk_production"] = last("exp_topk_production")
    for recall in (0.95, 0.99):
        require(row[f"certified_strict@r{recall}"]["strict_exact"],
                f"production strict@{recall}: {row[f'certified_strict@r{recall}']}")
        require(row[f"certified_thr@r{recall}"]["thr_complete"],
                f"production thr@{recall}: {row[f'certified_thr@r{recall}']}")
    require(row["exact"]["qps"] > 0, f"production: {row}")

    row = res["exp_wide_topk"] = last("exp_wide_topk")
    legs = [f"block{qb}_{stage}" for qb in (256, 1024) for stage in ("sims", "chunked")]
    legs += [f"exact_search_qb{qb}_64k" for qb in (256, 1024)]
    for name in legs:
        _require_keys(f"wide {name}", row[name], ("ms", "peak_mem_gb"), ("ms", "peak_mem_gb"))


    # the probes of the headline's input and conv stack
    row = res["exp_int8_conv"] = last("exp_int8_conv")
    require(sorted(row) == sorted(eic.LEGS), f"int8 conv: keys {sorted(row)}")
    _require_keys("int8 conv", row, eic.LEGS, eic.LEGS)
    k4_launches = tools["exp_int8_conv"]["launches"]["conv_int8"]
    require(k4_launches == 2 * INT8_K * (1 + len(eic.SPECS)),
            f"int8 conv: K4 launched {k4_launches} times, not 2 x {INT8_K} per layer and leg")
    row = res["exp_input_layout"] = last("exp_input_layout")
    legs = ("c3_convert_ms", "flat_convert_ms", "flat_reshape_ms", "c3_conv0_ms",
            "flat_conv0_ms")
    require(sorted(row) == sorted(legs), f"input layout: keys {sorted(row)}")
    _require_keys("input layout", row, legs, legs)
    row = res["exp_layout_probe"] = last("exp_layout_probe")
    legs = ("mult_nhwc_ms", "mult_nchw_ms", "transpose_roundtrip_ms")
    require(sorted(row) == sorted(("batch", "frames", "k") + legs)
            and (row["batch"], row["frames"], row["k"]) == (16, 64, 16),
            f"layout probe: {row}")
    _require_keys("layout probe", row, legs, legs)
    first, row = tools["exp_ingraph_forward"]["lines"][0], last("exp_ingraph_forward")
    rates = ("ingraph_ms_per_batch", "ingraph_vps", "pipelined_ms_per_batch", "pipelined_vps",
             "ingraph_over_pipelined")
    require(sorted(row) == sorted(rates) and len(first["reps_s"]) == INGRAPH_REPS
            and first["ingraph"] == row["ingraph_vps"], f"ingraph forward: {first} {row}")
    _require_keys("ingraph forward", row, rates, rates)
    k1 = tools["exp_ingraph_forward"]["launches"]["attention"]
    forwards = 2 * INGRAPH_K + 1 + INGRAPH_REPS * INGRAPH_K  # warm-up, capture, pipelined
    require(k1 == 4 * forwards, f"ingraph forward: K1 launched {k1} times, not 4 x {forwards}")
    res["exp_ingraph_forward"] = {"first_line": first, **row, "k1_launches": k1}

    t_checks = time.perf_counter()
    res["ingraph_f32"] = _ingraph_f32(torch)
    _settle(torch)
    k4 = _k4(torch, smi)
    k4["launches"] = k4_launches
    res["k4"] = k4
    seconds["ingraph_f32_and_k4"] = time.perf_counter() - t_checks
    row = {"phase": "tools", "smi": smi, "results": res, "tool_seconds": seconds,
           "seconds": time.perf_counter() - t0}
    emit(row)
    return row


TSF_WINDOWS = 64  # the timesformer-library-long cell's batch
# names of kernels that would mean an attention ran off K1
ATTENTION_FALLBACK = re.compile(r"softmax|fmha|flash|efficient_attention|sdpa", re.I)


def _timesformer_bf16(torch):
    """TimeSformer-Base at its published widths in bf16 on the card, its
    linear and patch weights drawn at the variance-keeping scale (normal,
    std 1 / sqrt(fan_in)) so that attention scores spread as a trained
    model's do, and a seeded uint8 batch of TSF_WINDOWS windows."""
    from torch import nn

    from video_fingerprint_tpu_torch.models import create_model

    model = create_model("timesformer")
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                std = m.weight[0].numel() ** -0.5
                m.weight.normal_(0.0, std, generator=g)
                m.bias.normal_(0.0, std, generator=g)
        emb = model.embeddings
        for p in (emb.cls_token, emb.position_embeddings, emb.time_embeddings):
            p.normal_(0.0, 0.02, generator=g)
    model = model.to(CARD, torch.bfloat16).eval()
    frames = torch.randint(0, 256, (TSF_WINDOWS, model.num_frames, 224, 224, 3),
                           dtype=torch.uint8, device=CARD,
                           generator=torch.Generator(device=CARD).manual_seed(SEED))
    return model, frames


def _timesformer_attention(torch, model, frames) -> dict:
    """K1 at TimeSformer's two shapes, given (S, H, T, D) strided views of
    layer 0's qkv projections of the batch, as the model gives them: against
    the plain version (bf16 tolerance), timed beside it, SDPA and the bound."""
    import torch.nn.functional as F

    from video_fingerprint_tpu_torch.ops import attention as attn
    from video_fingerprint_tpu_torch.utils.precision import full_fp32
    from video_fingerprint_tpu_torch.utils.timing import graph_ms

    layer = model.encoder.layer[0]
    cls, patches = model.embed(frames)
    B, N, T, C = patches.shape
    frame_major = torch.cat([cls[:, None, None].expand(B, T, 1, C), patches.transpose(1, 2)],
                            dim=2)
    inputs = {"temporal": (layer.temporal_attention,
                           layer.temporal_layernorm(patches).view(B * N, T, C)),
              "spatial": (layer.attention,
                          layer.layernorm_before(frame_major).view(B * T, 1 + N, C))}
    del frame_major
    rows = {}
    for kind, (att, h) in inputs.items():
        S, L, _ = h.shape
        H = att.attention.num_heads
        qkv = att.attention.qkv(h).view(S, L, 3, H, C // H)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        require(not q.is_contiguous(), f"{kind}: q is not a strided view of the qkv")
        bias = attn._key_bias(None, (S, L), q.device)[:, None, :]
        out = attn.multihead_attention(q, k, v)
        torch.cuda.synchronize()
        with full_fp32():
            plain = attn._attention_torch(q, k, v, bias)
        require(bool(torch.isfinite(out).all()), f"{kind}: non-finite output")
        err = (out.float() - plain.float()).abs().max().item()
        require(err <= TOLERANCE["bfloat16"], f"timesformer {kind}: max abs err {err}")
        scale = plain.float().abs().max().item()
        del out, plain
        kernel_ms = graph_ms(lambda: attn.multihead_attention(q, k, v))
        with full_fp32():
            plain_ms = graph_ms(lambda: attn._attention_torch(q, k, v, bias))
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms, bound_by = attention_bound_ms(S * H, L, "bfloat16", 0, head_dim=C // H)
        rows[kind] = {"phase": "timesformer", "check": "k1", "kind": kind, "instances": S * H,
                      "T": L, "D": C // H, "max_abs_err": err, "max_abs_out": scale,
                      "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "share_of_bound": bound_ms / kernel_ms}
        emit(rows[kind])
        del qkv, q, k, v
    return rows


def phase_timesformer(torch, smi: str) -> dict:
    """TimeSformer-Base in bf16 at the cell's batch: K1 at both of its shapes
    on views of a real qkv projection, then one forward with K1's counters
    read just before and after it (24 launches, the query rows as
    reckoned), its kernels (no attention off K1) and its device time."""
    from video_fingerprint_tpu_torch.ops import attention as attn
    from video_fingerprint_tpu_torch.utils import trace
    from video_fingerprint_tpu_torch.utils.timing import cuda_ms

    with torch.no_grad():
        model, frames = _timesformer_bf16(torch)
        rows = _timesformer_attention(torch, model, frames)
        forward = lambda: model(frames)
        forward()  # builds K1 at D = 64 once, outside the count
        torch.cuda.synchronize()
        names = ("k1.launches", "k1.rows_launched", "k1.rows_useful", "tsf.windows")
        before = {n: trace.counter(n) for n in names}
        emb = model(frames)
        torch.cuda.synchronize()
        counted = {n: trace.counter(n) - before[n] for n in names}
        B, T = frames.shape[:2]
        N = (frames.shape[2] // model.patch_size) ** 2
        layers = len(model.encoder.layer)
        H = model.encoder.layer[0].attention.attention.num_heads
        tile = lambda t: -(-t // attn.QUERY_TILE) * attn.QUERY_TILE
        want = {"k1.launches": 2 * layers,
                "k1.rows_launched": layers * H * (B * N * tile(T) + B * T * tile(N + 1)),
                "k1.rows_useful": layers * H * (B * N * T + B * T * (N + 1)),
                "tsf.windows": B}
        require(counted == want, f"timesformer forward counted {counted}, reckoned {want}")
        require(bool(torch.isfinite(emb).all()), "timesformer forward: non-finite embedding")
        norms = torch.linalg.vector_norm(emb, dim=1)
        require(bool(((norms - 1).abs() < 1e-3).all()), "timesformer forward: not unit norm")
        kernels = _device_kernels(torch, forward)
        require(isinstance(kernels, list), f"timesformer forward: profiler failed {kernels}")
        fallback = [k for k in kernels if ATTENTION_FALLBACK.search(k)]
        require(not fallback, f"timesformer forward: attention off K1 {fallback}")
        require(any("attention_bf16" in k for k in kernels), "timesformer forward: no K1")
        forward_ms = cuda_ms(forward)
        times = _kernel_times(torch, forward, top=12)
    row = {"phase": "timesformer", "check": "forward", "smi": smi, "windows": B,
           "counted": counted, "tile_fill_pct": 100.0 * counted["k1.rows_useful"]
           / counted["k1.rows_launched"], "forward_ms": forward_ms,
           "k1_forward_ms": sum(r["kernel_ms"] for r in rows.values()) * layers,
           "kernels": times}
    emit(row)
    return {"k1": rows, "forward": row}


PHASES = ("attention", "scan", "cli", "convblock", "scan3d", "index", "train", "augment",
          "native", "multigpu", "multiproc", "bench", "profile", "graft", "tools",
          "timesformer")


def _settle(torch) -> None:
    """Between phases: wait for the card, collect the last phase's garbage
    and hand the allocator's cached blocks back, so that no phase inherits
    the memory state of the one before it."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated phases to run (default: all); the kernels "
                             "and ok lines are printed only when all run")
    parser.add_argument("--tools-child", nargs=2, metavar=("SPEC", "OUT"),
                        help=argparse.SUPPRESS)  # phase tools' child process (_tools_child)
    args = parser.parse_args(argv)
    if args.tools_child:
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device available", file=sys.stderr)
            return 1
        return _tools_child(*args.tools_child)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}; choose from {PHASES}")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = phase_info(torch)
    phase_build()
    run = [p for p in PHASES if p in phases]
    phase_seconds = {}
    with tempfile.TemporaryDirectory(prefix="vfp_chip_smoke_") as tmp:
        work = Path(tmp)
        model_path, model3d_path = work / "model.pth", work / "model3d.pth"
        for name in run:
            _settle(torch)
            t_phase = time.perf_counter()
            if name in ("cli", "convblock", "index", "native") and not model_path.exists():
                _write_model(torch, model_path, np.random.default_rng(SEED))  # as phase_scan
            if name == "native" and not model3d_path.exists():
                _write_model_3d(torch, model3d_path, np.random.default_rng(SEED + 3))
            if name == "attention":
                att = phase_attention(torch)
            elif name == "scan":
                launches, _, k6 = phase_scan(torch, work, smi)
            elif name == "cli":
                phase_cli(torch, work, model_path)
            elif name == "convblock":
                conv = phase_convblock(torch, model_path)
            elif name == "scan3d":
                phase_scan3d(torch, work)
            elif name == "index":
                k5 = phase_index(torch, work, model_path, smi)
            elif name == "train":
                phase_train(torch, work, smi)
            elif name == "augment":
                phase_augment(torch, work, smi)
            elif name == "native":
                phase_native(torch, work, model_path, model3d_path, smi)
            elif name == "multigpu":
                phase_multigpu(torch, work, smi)
            elif name == "multiproc":
                phase_multiproc(torch, work, smi)
            elif name == "bench":
                phase_bench(torch, work, smi)
            elif name == "profile":
                phase_profile(torch, smi)
            elif name == "graft":
                phase_graft(torch, smi)
            elif name == "tools":
                k4 = phase_tools(torch, work, smi)["results"]["k4"]
            elif name == "timesformer":
                phase_timesformer(torch, smi)
            phase_seconds[name] = time.perf_counter() - t_phase
    emit({"phase": "done", "phases": run, "phase_seconds": phase_seconds,
          "seconds": time.perf_counter() - t_start})
    if run != list(PHASES):
        return 0
    main_case = att[("float32", 128)]
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
                             ("conv_strided", "tools/exp_pallas_convblock.py:74"))] + [{
        "name": "conv_int8",
        "route": "cuda",
        "source": "video_fingerprint_tpu_torch/csrc/conv_int8.cu",
        "replaces": "tools/exp_int8_conv.py:79",
        "replaces_what": "an XLA int8 conv and its fused epilogue, not a Pallas kernel",
        **{key: k4[key] for key in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "library",
                                    "library_cudnn_bf16_conv1_ms", "layers")},
    }, {
        "name": "stem",
        "route": "cuda",
        "source": "video_fingerprint_tpu_torch/csrc/stem.cu",
        "replaces": "models/attention.py::input_from_frames + cuDNN conv0, its bias and ReLU",
        "replaces_what": "the uint8 convert, /255, conv0, bias and ReLU passes of the bf16 "
                         "scan; not a Pallas kernel (XLA's conv)",
        "launches": k6["launches"],
        "launches_counted": "per forward of phase 3's bf16 scan",
        "max_abs_err": k6["max_abs_err"],
        **{key: k6["time"][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms", "unfused_ms", "host_us",
                                            "unfused_host_us")},
    }, {
        "name": "topk",
        "route": "cuda",
        "source": "video_fingerprint_tpu_torch/csrc/topk.cu",
        "replaces": "ops/topk.py::_exact_plain",
        "replaces_what": "matmul, torch.topk and the tie pass of the exact search; "
                         "not a Pallas kernel (XLA's matmul and lax.top_k)",
        "launches": k5["f32"]["main_path_launches_per_search"],
        "launches_counted": "per FingerprintIndex.search at the index phase's 4,096 x 10^6",
        "max_abs_err": k5["f32"]["max_score_err"],
        **{key: k5["f32"][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")},
        "bf16": {key: k5["bf16"][key] for key in ("max_score_err", "ms", "plain_ms",
                                                  "bound_ms", "library_ms")},
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

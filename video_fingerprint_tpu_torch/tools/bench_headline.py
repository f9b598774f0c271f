"""Headline measurement: fingerprint extraction videos/sec on one card.

Port of tools/bench_headline.py. Run by tools/bench.py in a subprocess;
prints a cumulative JSON line after each stage.

Workload: the attention model's extraction of 128-frame 64x64 clips at
B = 512, the scan's configuration: BatchNorm folded into the convs
(models/fuse.py), bfloat16 compute, frames staged pre-flattened as uint8
(`forward_flat`), the spatial encoder in channels-last. The weights are
seeded (tools/bench_common.py); the clips are seeded panning block
patterns made on the card, N_BATCHES batches staged once.

Regimes, each the median over timing windows:

  graph_vps           the number of record: one CUDA graph captured per
                      staged batch, replayed in alternation PIPELINE_DEPTH
                      times per window, timed with CUDA events (the port of
                      the JAX leg's in-graph `lax.fori_loop`, which keeps
                      host dispatch out of the measurement)
  pipelined_vps       eager forwards queued back to back, one synchronize
                      per window (host clock)
  sync_per_batch_vps  one forward, then its embeddings read back
  streaming_vps       a pinned host batch copied to the card for each
                      forward, then its embeddings read back

and, on a card, where the time goes: headline_encoder_ms (the per-frame
CNN on the batch's B x T frames) beside headline_forward_ms (the whole
eager forward), CUDA events.

MFU is the analytic operation count of utils/flops.py (products and convs;
not XLA's count, so not comparable to a TPU MFU) over the graph-replay time
and the H100's dense bf16 peak. With --device cpu (for the tests) the
eager regimes run on the plain path and graph replay is not measured: a
CUDA graph needs a card.

    python -m video_fingerprint_tpu_torch.tools.bench_headline
    python -m video_fingerprint_tpu_torch.tools.bench_headline --device cpu \\
        --batch 4 --frames 8 --depth 2 --spatial_dim 16 --temporal_dim 32 \\
        --embedding_dim 32 --f32
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import sys
import time
from typing import List

import numpy as np
import torch

from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.models.fuse import fuse_state_dict
from video_fingerprint_tpu_torch.ops import attention as attn
from video_fingerprint_tpu_torch.tools.bench_common import (
    H100_BF16_PEAK_FLOPS,
    describe_card,
    emit,
    model_kwargs,
    panning_clips,
    seeded_state_dict,
    widths_args,
)
from video_fingerprint_tpu_torch.utils.device import resolve_device
from video_fingerprint_tpu_torch.utils.flops import forward_flops
from video_fingerprint_tpu_torch.utils.precision import full_fp32

B = 512        # videos per batch
T = 128        # frames per video
HW = 64        # frame height and width
N_BATCHES = 2
PIPELINE_DEPTH = 12  # forwards per timing window
WINDOWS = 3
SAVED_VIDEOS = 8     # videos whose frames and embeddings --save_embeddings keeps


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--frames", type=int, default=T)
    ap.add_argument("--pipeline_depth", type=int, default=PIPELINE_DEPTH)
    ap.add_argument("--windows", type=int, default=WINDOWS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--f32", action="store_true",
                    help="float32 compute with TF32 off (default bf16, the scan's "
                         "production setting)")
    ap.add_argument("--save_embeddings", default=None,
                    help=f".npz path: the first {SAVED_VIDEOS} videos of batch 0 (frames "
                         "and the timed forward's embeddings) and the seed")
    widths_args(ap)
    return ap.parse_args(argv)


def fused_model(seed: int, device: torch.device, dtype: torch.dtype, **widths: int):
    """The seeded model (`widths`: create_model's keywords) with BatchNorm
    folded, on `device` in `dtype`, in eval mode, the spatial encoder
    channels-last on a card."""
    model = create_model("attention", fused=True, **widths)
    sd = fuse_state_dict(seeded_state_dict(seed, **widths))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    model.to(device=device, dtype=dtype).eval()
    if device.type == "cuda":
        model.spatial_encoder.to(memory_format=torch.channels_last)
    return model


def _median_vps(batch: int, seconds: List[float]) -> float:
    return batch / statistics.median(seconds)


def _event_ms(fn, runs: int = 3) -> float:
    """Median device time of fn() on the card (CUDA events), after one
    untimed call."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _capture(forward, staged: List[torch.Tensor]):
    """One CUDA graph per staged batch, sharing one memory pool (the graphs
    replay one after another on one stream). Returns (graphs, outputs, K1
    launches recorded into the graphs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as CUDA graphs need
        for x in staged:
            forward(x)
    torch.cuda.current_stream().wait_stream(side)
    graphs, outputs, pool = [], [], None
    before = attn.launches
    for x in staged:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=pool):
            outputs.append(forward(x))
        pool = g.pool()
        graphs.append(g)
    torch.cuda.synchronize()
    return graphs, outputs, attn.launches - before


def run(args) -> tuple[dict, np.ndarray]:
    """Measure every regime; returns (the result, the embeddings of batch 0
    from the number of record's forward: graph replay on a card, the
    pipelined forward on the CPU)."""
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    dtype = torch.float32 if args.f32 else torch.bfloat16
    Bn, Tn, depth = args.batch, args.frames, args.pipeline_depth
    out = {"headline_batch": Bn, "headline_frames": Tn,
           "headline_dtype": str(dtype).split(".")[-1], **describe_card(device)}

    model = fused_model(args.seed, device, dtype, **model_kwargs(args))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    staged = [panning_clips(gen, Bn, Tn, HW) for _ in range(N_BATCHES)]
    precision = full_fp32() if dtype == torch.float32 else contextlib.nullcontext()

    def forward(x):
        return model.forward_flat(x, Bn)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    with torch.no_grad(), precision:
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        forward(staged[0])  # kernel build, cuDNN plans
        sync()
        out["headline_warmup_s"] = time.perf_counter() - t0
        attn.launches = 0
        emb = forward(staged[0])
        sync()
        out["k1_launches_per_forward"] = attn.launches

        # pipelined dispatch: forwards queued back to back, one wait per window
        pipe = []
        for _ in range(args.windows):
            t0 = time.perf_counter()
            outs = [forward(staged[i % N_BATCHES]) for i in range(depth)]
            sync()
            pipe.append((time.perf_counter() - t0) / depth)
        del outs
        out["pipelined_vps"] = _median_vps(Bn, pipe)
        emit(out)

        if cuda:
            graphs, outputs, out["k1_launches_in_capture"] = _capture(forward, staged)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            for g in graphs:  # first replays, untimed
                g.replay()
            windows = []
            for _ in range(args.windows):
                start.record()
                for i in range(depth):
                    graphs[i % N_BATCHES].replay()
                end.record()
                end.synchronize()
                windows.append(start.elapsed_time(end) / 1e3 / depth)
            emb = outputs[0].float().cpu().numpy()
            if not np.isfinite(emb).all():
                raise FloatingPointError("graph replay gave non-finite embeddings")
            graph_t = statistics.median(windows)
            out["graph_vps"] = Bn / graph_t
            out["graph_vps_windows"] = [Bn / t for t in windows]
            flops = forward_flops(model, Bn, Tn, HW)
            out["tflops_per_batch"] = flops / 1e12
            out["mfu_vs_h100_bf16_peak"] = flops / graph_t / H100_BF16_PEAK_FLOPS
            out["headline_reserved_gb"] = torch.cuda.memory_reserved(device) / 1e9
            del graphs, outputs
            # where the time goes: the per-frame CNN against the whole forward
            out["headline_encoder_ms"] = _event_ms(lambda: model._encode_flat(staged[0]))
            out["headline_forward_ms"] = _event_ms(lambda: forward(staged[0]))
            emit(out)
        else:
            emb = emb.float().numpy()
            out["graph_vps"] = None
            out["graph_note"] = "not measured: a CUDA graph needs a card"

        # one forward, then its embeddings read back
        sync_t = []
        for x in staged * 3:
            t0 = time.perf_counter()
            forward(x).cpu()
            sync_t.append(time.perf_counter() - t0)
        out["sync_per_batch_vps"] = _median_vps(Bn, sync_t)
        emit(out)

        # streaming: the uint8 batch crosses from pinned host memory per forward
        host = staged[0].cpu()
        if cuda:
            host = host.pin_memory()
        stream_t = []
        for _ in range(2 * N_BATCHES):
            t0 = time.perf_counter()
            forward(host.to(device, non_blocking=True)).cpu()
            stream_t.append(time.perf_counter() - t0)
        out["streaming_vps"] = _median_vps(Bn, stream_t)
        out["streaming_batch_bytes"] = host.numel()
        if cuda:
            out["headline_peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    if args.save_embeddings:
        n = min(SAVED_VIDEOS, Bn)
        np.savez(args.save_embeddings,
                 frames=staged[0][:n * Tn].cpu().numpy().reshape(n, Tn, HW, HW, 3),
                 embeddings=emb[:n], seed=args.seed)
    emit(out)
    return out, emb


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

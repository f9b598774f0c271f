"""Process groups and data-parallel placement for training.

The port's counterpart of video_fingerprint_tpu/parallel/distributed.py.
JAX trains data-parallel under GSPMD: the global batch is sharded over a
'data' mesh and XLA makes every batch-wide reduction global. The port runs
one process (rank) per device under torch.distributed and makes the same
reductions global by hand, with these collectives:

  - train-mode BatchNorm: one all_reduce of (sum x, sum x^2, n) per layer
    (models/layers.py), so its statistics are those of the global batch;
  - the loss and the accuracy: the embeddings all-gathered before them
    (`all_gather_rows`), so InfoNCE and the triplet mining span the global
    batch, as JAX computes them on the whole sharded array;
  - the grads: one all_reduce of the flattened grads after the backward,
    divided by the world size (`average_gradients`); the clip then sees the
    synchronised grads.

With these a W-rank step computes what one device computes on the global
batch. Rank r holds rows [r*b, (r+1)*b) of the global batch of W*b rows.

Collectives by backend: every one above is an all_reduce (the gather too:
each rank writes its rows into a zeroed buffer that is then summed), plus
broadcasts of the run-dir name and of the initial weights. NCCL runs them
on CUDA tensors and gloo on CPU tensors; gloo also takes CUDA tensors for
all_reduce and broadcast (staged through the host), which is how two ranks
share one card in chip_smoke.py: NCCL refuses two ranks on one GPU.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist


def maybe_initialize_distributed(device: str | torch.device = "cuda",
                                 backend: Optional[str] = None) -> Tuple[int, int]:
    """Join the process group a launcher describes and return (rank, world).

    The launcher is torch.distributed.run (or anything that sets its
    environment): WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT.
    Without WORLD_SIZE this is a no-op that returns (0, 1). The backend is
    nccl for cuda and gloo for cpu unless `backend` names one; on cuda the
    process binds cuda:LOCAL_RANK first. A group already joined is kept.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "WORLD_SIZE" not in os.environ:
        return 0, 1
    kind = torch.device(device).type
    if kind == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend or ("nccl" if kind == "cuda" else "gloo"),
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_rank(), dist.get_world_size()


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    """Single-writer rule: the run-dir files, TensorBoard and the .ckpt
    files are written by rank 0 only."""
    return rank() == 0


def broadcast_string(s: str) -> str:
    """Rank 0's `s` on every rank (the timestamped run-dir name)."""
    if world_size() == 1:
        return s
    box = [s]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank, in place."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for tensor in module.state_dict().values():
            dist.broadcast(tensor, src=0)


class _AllReduceSum(torch.autograd.Function):
    """torch.distributed.nn.functional.all_reduce's autograd rule (that
    function is deprecated from torch 2.13): the forward sums a copy of x
    over the ranks, the backward sums the ranks' grads."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks; differentiable (the backward sums the
    ranks' grads)."""
    if world_size() == 1:
        return x
    return _AllReduceSum.apply(x)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """(b, ...) on every rank -> (world * b, ...), rank r's rows at
    [r*b, (r+1)*b), the same on every rank. Floating tensors go through one
    differentiable all_reduce in f32 of a zeroed buffer that holds x in this
    rank's block (exact: every other term is zero): its backward hands each
    rank the sum of every rank's grad for its own rows. Integer tensors are
    gathered the same way in f64, without grad. Every rank must pass the
    same b."""
    w = world_size()
    if w == 1:
        return x
    r, b = rank(), x.shape[0]
    tail = x.shape[1:]
    if x.is_floating_point():
        xf = x.float()
        buf = torch.cat([xf.new_zeros((r * b,) + tail), xf,
                         xf.new_zeros(((w - r - 1) * b,) + tail)])
        return all_reduce_sum(buf).to(x.dtype)
    buf = x.new_zeros((w * b,) + tail, dtype=torch.float64)  # exact below 2^53
    buf[r * b:(r + 1) * b] = x
    dist.all_reduce(buf)
    return buf.to(x.dtype)


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Every rank's grads replaced by their mean over the ranks, in one
    all_reduce of the flattened grads (a parameter without a grad counts
    as zero)."""
    w = world_size()
    if w == 1:
        return
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= w
    offset = 0
    for p, g in zip(params, grads):
        p.grad = flat[offset:offset + g.numel()].view_as(g)
        offset += g.numel()


class DataParallel:
    """Placement of data-parallel training: each rank drives one device and
    holds rows [rank * b, (rank + 1) * b) of a global batch of world * b."""

    def __init__(self):
        self.rank = rank()
        self.n = world_size()

    def shard_batch(self, batch: Dict) -> Dict:
        """This rank's rows of a global batch (tensors or arrays with the
        global batch on axis 0, in nested dicts too). Draws made for the
        global batch on every rank (extract and augment draws) are sliced
        the same way, so a W-rank run uses the draws of the one-rank run."""
        out = {}
        for key, value in batch.items():
            if isinstance(value, dict):
                out[key] = self.shard_batch(value)
                continue
            rows = value.shape[0]
            if rows % self.n:
                raise ValueError(f"{key}: global batch of {rows} rows does not divide "
                                 f"over {self.n} ranks")
            b = rows // self.n
            out[key] = value[self.rank * b:(self.rank + 1) * b]
        return out

    def pad_batch_size(self, b: int) -> int:
        """A rank's batch padded so the global batch divides the devices.
        JAX pads a host's rows to a multiple of its local devices (:74-81);
        a rank drives one device, so every b divides and b is returned."""
        return b

"""Device lists: the port's counterpart of video_fingerprint_tpu/parallel/mesh.py.

Where a JAX function takes a 1-D `Mesh`, the port's takes an explicit list
of torch devices, one shard per entry. The list may repeat a device: two or
four shards on one card, or eight on the CPU, run the same code as one
shard per card (the CPU tests and chip_smoke.py use that). Every "all
devices of the platform" in the port reads `platform_devices`.

Under a process group of several ranks a list is one rank's devices: the
rank's own card by default (`as_devices`), never another rank's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from video_fingerprint_tpu_torch.parallel.distributed import world_size


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def platform_devices(device: str | torch.device = "cuda") -> List[torch.device]:
    """Every device of `device`'s platform: cuda:0 .. cuda:N-1 for cuda (none
    without a card), [cpu] for cpu."""
    kind = torch.device(device).type
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"device must be cuda or cpu, got {device!r}")


def as_devices(devices: Optional[Sequence], default: str | torch.device = "cuda"
               ) -> List[torch.device]:
    """The devices this process shards over: `devices` as torch devices when
    given; else, under a process group of more than one rank, the rank's own
    device (`default`, a bare "cuda" naming the card the rank is bound to,
    which maybe_initialize_distributed sets); else every device of
    `default`'s platform (which raises for cuda without a card). "cuda"
    names the current card."""
    if devices is None and world_size() > 1:
        return [_indexed(torch.device(default))]
    out = (platform_devices(default) if devices is None
           else [_indexed(torch.device(d)) for d in devices])
    if not out:
        raise RuntimeError(f"no device in {devices!r} (platform of {default!r})")
    return out


def _indexed(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev

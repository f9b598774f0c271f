"""video_fingerprint_tpu_torch — the fingerprint scan in PyTorch on an NVIDIA H100.

A port of `video_fingerprint_tpu` (JAX/Flax/Pallas), which stays the
reference it is tested against. Layout mirrors the JAX package:

  - data/        decode + preprocess (host side, cv2 imported lazily)
  - models/      the attention and 3D-CNN models as nn.Modules, BN folding
  - ops/         the hand-written CUDA kernels (attention, the conv-block
                 probe's stride-2 conv) and exact top-k
  - training/    checkpoint loading (.ckpt msgpack reader, .pth)
  - inference/   scanner, duplicate grouping, fingerprint index and scan
                 cache (.npz, the JAX package's format), JSON report
  - parallel/    device lists and torch.distributed: the data-parallel scan,
                 the corpus-sharded search, data-parallel training
  - utils/       reference state_dict <-> flax-layout key tables, device
  - cli/         `python -m video_fingerprint_tpu_torch.cli.scan`
  - tools/       the conv-block probe
  - csrc/        CUDA C++ sources, built with nvcc at first use

Importing the package imports nothing heavy; entry points default to
device="cuda" and raise when no card is present.
"""

__version__ = "0.1.0"

"""Train CLI: the JAX package's flag surface (video_fingerprint_tpu/cli/train.py,
reference train.py:722-770) on one card, on the CPU with --device cpu, or
data-parallel over several ranks started by torch.distributed.run:

    python -m video_fingerprint_tpu_torch.cli.train --data_dir videos/ --epochs 50
    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m video_fingerprint_tpu_torch.cli.train --data_dir videos/ --batch_size 32

Under the launcher each rank joins the group first (nccl on cuda, gloo on
cpu; parallel/distributed.py), loads `batch_size // world` rows per step
from its shard of the data, and rank 0 names the run dir and alone writes
into it. --batch_size is the global batch and must divide by the world
size (after the 3D model's doubling).

Derived-config rules as there: the 3D model doubles the batch and triples
the LR (reference train.py:779-781), the attention val loader takes twice
the batch (train.py:834-837), and no arguments run the quick-test mode
(train.py:871-875). --bf16 keeps the parameters in f32 and computes in
bf16. --device_augment runs the clip augmentations on the card inside the
train step (the loaders then apply only resize and JPEG); --native_decode
decodes eval-mode attention loads with the native libav worker. --orbax is
not ported and cannot be (orbax.checkpoint imports jax): it exits with an
error rather than run something else.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from video_fingerprint_tpu_torch.training.checkpoint import ORBAX_REFUSAL

NOT_PORTED = {"orbax": ORBAX_REFUSAL + "; the port writes .ckpt files"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train Video Fingerprint Model (Attention or 3D CNN) with PyTorch")
    p.add_argument("--data_dir", type=str, required=True, help="Path to video dataset")
    p.add_argument("--batch_size", type=int, default=8, help="Batch size")
    p.add_argument("--epochs", type=int, default=50, help="Number of epochs")
    p.add_argument("--lr", type=float, default=1e-4, help="Learning rate")
    p.add_argument("--num_workers", type=int, default=4, help="Decode workers")
    p.add_argument("--checkpoint", type=str,
                   help="Resume from a .ckpt (this package's or the JAX package's) "
                        "or warm-start from a reference .pth")
    p.add_argument("--no_amp", action="store_true",
                   help="Accepted for compatibility (f32 unless --bf16)")
    p.add_argument("--run_name", type=str, help="Custom run name (default: timestamp)")
    p.add_argument("--patience", type=int, default=10, help="Early stopping patience")
    p.add_argument("--model", type=str, default="attention",
                   choices=["attention", "3d"], help="Model type")
    p.add_argument("--clip_length", type=int, default=128, help="3D clip length")
    p.add_argument("--frame_stride", type=int, default=32, help="3D frame stride")
    p.add_argument("--triplet_weight", type=float, default=0.3)
    p.add_argument("--triplet_margin", type=float, default=0.3)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=0, help="Global RNG seed")
    p.add_argument("--max_frames", type=int, default=500,
                   help="Max frames per video (attention)")
    p.add_argument("--no_mask_padding", action="store_true",
                   help="Reproduce the reference's unmasked padded batches")
    p.add_argument("--profile", action="store_true",
                   help="Write a torch.profiler trace of early steps to "
                        "<run_dir>/profile/trace.json")
    p.add_argument("--debug_nans", action="store_true",
                   help="Fail on the first non-finite loss or grad norm "
                        "(reads both back every step)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (autocast), parameters and optimizer in f32")
    p.add_argument("--orbax", action="store_true", help="Not ported: exits with an error")
    p.add_argument("--remat", action="store_true",
                   help="Recompute forward activations in the backward pass "
                        "(torch.utils.checkpoint): less memory, one extra forward")
    p.add_argument("--device_augment", action="store_true",
                   help="Run the clip augmentations on the device inside the train "
                        "step (same transforms and probabilities as the host "
                        "pipeline); the loader then applies only resize + JPEG "
                        "recompression")
    p.add_argument("--fast_extracts", action="store_true",
                   help="Attention only: embed the extracts from gathered rows of the "
                        "full forward's per-frame features instead of re-running the "
                        "CNN on gathered pixels (extract frames then see the full "
                        "batch's BN statistics)")
    p.add_argument("--native_decode", action="store_true",
                   help="C++ libav fused decode for eval-mode attention loads "
                        "(cv2 when the library cannot be built; train "
                        "augmentation always uses cv2 full-res frames)")
    p.add_argument("--auc_flat_eps", type=float, default=1e-3,
                   help="AUC flatness band for the separation-gap tiebreak in "
                        "best-checkpoint selection")
    p.add_argument("--streaming_metrics_threshold", type=int, default=8192,
                   help="Validation switches from dense O(N^2) metrics to the "
                        "streaming O(block*N) path above this many val embeddings "
                        "(2 per video); both are exact")
    return p


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if not argv:  # quick-test mode (reference train.py:871-875)
        print("Quick test mode...")
        argv = ["--data_dir", "./test_videos", "--batch_size", "2", "--epochs", "2"]
    args = build_parser().parse_args(argv)
    for flag, message in NOT_PORTED.items():
        if getattr(args, flag):
            print(f"Error: {message}")
            return 2

    import torch

    from video_fingerprint_tpu_torch.config import Config
    from video_fingerprint_tpu_torch.data.dataset import create_dataloader
    from video_fingerprint_tpu_torch.models import create_model
    from video_fingerprint_tpu_torch.training.trainer import Trainer, setup_run_directory
    from video_fingerprint_tpu_torch.utils.device import resolve_device

    from video_fingerprint_tpu_torch.parallel.distributed import (
        broadcast_string,
        maybe_initialize_distributed,
    )

    resolve_device(args.device)  # no card for --device cuda: raise before any work
    rank, world = maybe_initialize_distributed(args.device)

    # derived-config rules from the reference: 3D doubles batch, triples LR
    batch_size = args.batch_size if args.model == "attention" else args.batch_size * 2
    lr = args.lr if args.model == "attention" else args.lr * 3
    if world > 1:
        print(f"Data parallel: rank {rank}/{world}")
        if batch_size % world:
            print(f"Error: batch_size {batch_size} must be divisible by the world "
                  f"size ({world})")
            return 1

    # single writer: rank 0 creates the run dir and broadcasts a timestamped
    # name; the other ranks never write into it
    if args.run_name:
        run_dir = Path("./runs") / args.run_name
        if rank == 0:
            run_dir.mkdir(parents=True, exist_ok=True)
    elif rank == 0:
        run_dir = setup_run_directory(prefix="3d_" if args.model == "3d" else "")
        broadcast_string(run_dir.name)
    else:
        run_dir = Path("./runs") / broadcast_string("")

    config = Config(
        batch_size=batch_size,
        epochs=args.epochs,
        learning_rate=lr,
        max_frames=args.max_frames,
        clip_length=args.clip_length,
        frame_stride=args.frame_stride,
        patience=args.patience,
        data_dir=str(args.data_dir),
        num_workers=args.num_workers,
        model_type=args.model,
        command_line=" ".join(sys.argv),
        triplet_weight=args.triplet_weight,
        triplet_margin=args.triplet_margin,
        device=args.device,
        seed=args.seed,
        mask_padding=not args.no_mask_padding,
        profile=args.profile,
        extras={"remat": args.remat, "bf16": args.bf16,
                "device_augment": args.device_augment,
                "fast_extracts": args.fast_extracts,
                "debug_nans": args.debug_nans,
                "checkpoint_backend": "msgpack",
                "streaming_metrics_threshold": args.streaming_metrics_threshold,
                "auc_flat_eps": args.auc_flat_eps},
    ).to_dict()

    torch.manual_seed(args.seed)
    model = create_model(
        args.model,
        spatial_dim=config["spatial_dim"],
        temporal_dim=config["temporal_dim"],
        embedding_dim=config["embedding_dim"],
        num_attention_blocks=config["num_attention_blocks"],
        frame_stride=config["frame_stride"],
    )

    loader_args = dict(
        num_workers=args.num_workers,
        frame_size=config["frame_size"],
        max_frames=config["max_frames"],
        clip_length=config["clip_length"],
        frame_stride=config["frame_stride"],
        model_type=args.model,
        seed=args.seed,
        decode_backend="native" if args.native_decode else "cv2",
        augment_mode="device" if args.device_augment else "host",
        shard_index=rank,
        shard_count=world,
    )
    per_rank = config["batch_size"] // world
    train_loader = create_dataloader(args.data_dir, batch_size=per_rank,
                                     mode="train", **loader_args)
    val_loader = create_dataloader(
        args.data_dir, batch_size=per_rank * 2 if args.model == "attention" else per_rank,
        mode="val", **loader_args)

    if len(train_loader) == 0:
        print(f"No usable training batches found in {args.data_dir}")
        return 1
    if args.checkpoint and not Path(args.checkpoint).exists():
        print(f"Error: Checkpoint {args.checkpoint} does not exist")
        return 1

    trainer = Trainer(model, train_loader, val_loader, config, run_dir)
    if args.checkpoint:
        trainer.resume(args.checkpoint)
    trainer.train()
    return 0


if __name__ == "__main__":
    sys.exit(main())

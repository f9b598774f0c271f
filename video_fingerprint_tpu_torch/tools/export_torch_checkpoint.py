"""Export a .ckpt to a reference-compatible PyTorch .pth checkpoint.

The port of tools/export_torch_checkpoint.py: the same arguments and the
same payload, which the reference scanner and both packages load: the
reference state_dict (`model_state_dict`), the config, epoch and
global_step, and best_val_loss, best_val_acc and best_auc_roc (0 where the
.ckpt has none). Either package's .ckpt, for both model families.

    python -m video_fingerprint_tpu_torch.tools.export_torch_checkpoint input.ckpt output.pth
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("input", help=".ckpt checkpoint")
    parser.add_argument("output", help="output .pth path")
    args = parser.parse_args(argv)

    if not Path(args.input).exists():
        print(f"Error: {args.input} does not exist")
        return 1

    import torch

    from video_fingerprint_tpu_torch.training.checkpoint import load_checkpoint
    from video_fingerprint_tpu_torch.utils.torch_compat import variables_to_state_dict

    payload = load_checkpoint(args.input)
    config = payload["config"]
    sd_np = variables_to_state_dict(payload["model"], config.get("model_type", "attention"))
    train = payload.get("train", {})
    bests = train.get("bests", {})
    torch.save({
        "epoch": int(train.get("epoch", 0)),
        "global_step": int(train.get("global_step", 0)),
        "model_state_dict": {k: torch.from_numpy(v.copy()) for k, v in sd_np.items()},
        "config": config,
        "best_val_loss": float(bests.get("best_val_loss", 0.0)),
        "best_val_acc": float(bests.get("best_val_acc", 0.0)),
        "best_auc_roc": float(bests.get("best_auc_roc", 0.0)),
    }, args.output)
    print(f"Exported {args.input} -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

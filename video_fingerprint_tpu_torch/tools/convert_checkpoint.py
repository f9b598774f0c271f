"""Convert a reference PyTorch checkpoint (.pth) to the .ckpt format.

The port of tools/convert_checkpoint.py: the same arguments and the same
payload (the JAX package's msgpack .ckpt, which both packages read): the
weights and BatchNorm statistics in the flax layout, the checkpoint's
config, and the training counters and bests where the .pth carries them
(epoch, global_step, best_val_loss, best_val_acc, best_auc_roc; defaults
0, 0, inf, 0, 0).

    python -m video_fingerprint_tpu_torch.tools.convert_checkpoint input.pth output.ckpt
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("input", help="reference .pth checkpoint")
    parser.add_argument("output", help="output .ckpt path")
    args = parser.parse_args(argv)

    if not Path(args.input).exists():
        print(f"Error: {args.input} does not exist")
        return 1

    import torch

    from video_fingerprint_tpu_torch.training.checkpoint import (
        load_torch_checkpoint,
        save_checkpoint,
    )

    variables, config = load_torch_checkpoint(args.input)
    raw = torch.load(args.input, map_location="cpu", weights_only=False)
    save_checkpoint(
        args.output,
        variables["params"],
        variables["batch_stats"],
        config,
        epoch=int(raw.get("epoch", 0)),
        global_step=int(raw.get("global_step", 0)),
        bests={
            "best_val_loss": float(raw.get("best_val_loss", float("inf"))),
            "best_val_acc": float(raw.get("best_val_acc", 0.0)),
            "best_auc_roc": float(raw.get("best_auc_roc", 0.0)),
        },
    )
    print(f"Converted {args.input} -> {args.output} "
          f"(model_type={config.get('model_type', 'attention')})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

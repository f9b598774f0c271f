"""Training runtime on one device: epoch loop, validation, checkpoints, artifacts.

Port of video_fingerprint_tpu/training/trainer.py (reference Trainer,
train.py:17-703) for one card (or the CPU when the config says so):

  - the run-dir artifacts of the reference: config.json, training_info.txt,
    the fixed-width training_log.txt, TensorBoard scalars when the
    tensorboard package is there, training_summary.txt;
  - checkpoints in the JAX package's `.ckpt` format: last every epoch, best
    on an AUC-ROC improvement (+ best_metrics.json), epoch_N every 5;
    resume restores the weights, BatchNorm statistics, AdamW moments,
    schedule position and counters from the port's or the JAX package's
    `.ckpt`, or warm-starts the weights from a reference `.pth`;
  - validation through the eval forward (the attention kernel on the card),
    dense metrics below `streaming_metrics_threshold` embeddings and the
    streaming path above it, and the extract-robustness cosines;
  - early stopping on AUC-ROC with patience, with the separation-gap
    tiebreak of `is_new_best`.

The host reads the train metrics back only every `metrics_every` steps.
Multi-device training (the JAX package's wraparound padding and replicated
blocks) waits for the port's multi-GPU slice.
"""

from __future__ import annotations

import json
import sys
import time
from datetime import datetime
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from video_fingerprint_tpu_torch.ops.metrics import (
    discrimination_metrics,
    retrieval_metrics,
    streaming_validation_metrics,
)
from video_fingerprint_tpu_torch.training import checkpoint as ckpt
from video_fingerprint_tpu_torch.training.optim import current_lr, make_optimizer
from video_fingerprint_tpu_torch.training.train_step import (
    compute_context,
    draw_extracts,
    make_eval_step,
    make_train_step,
)
from video_fingerprint_tpu_torch.utils.device import resolve_device
from video_fingerprint_tpu_torch.utils.torch_compat import (
    adamw_to_opt_state,
    opt_state_to_adamw,
    state_dict_to_variables,
    variables_to_state_dict,
)


class _NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def close(self):
        pass


def _make_tb_writer(logdir):
    try:  # TensorBoard scalars when the tensorboard package is installed
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(str(logdir))
    except Exception:  # noqa: BLE001 - logging only, as in the JAX package
        return _NullWriter()


def is_new_best(auc: float, gap: float, best_auc: float,
                best_gap: float, flat_eps: float = 1e-3) -> bool:
    """Model selection (JAX trainer.py:82-99): `auc > best_auc` as the
    reference, plus a tiebreak: when AUC is within `flat_eps` of the best
    (saturated, or epoch-to-epoch noise), an improving separation gap
    still marks a new best and resets patience."""
    if auc > best_auc:
        return True
    return auc >= best_auc - flat_eps and gap > best_gap


def setup_run_directory(base_dir="./runs", prefix="") -> Path:
    """Timestamped run dir + `latest` symlink (reference train.py:706-718)."""
    run_dir = Path(base_dir) / f"{prefix}run_{datetime.now().strftime('%Y%m%d_%H%M%S')}"
    run_dir.mkdir(parents=True, exist_ok=True)
    latest = Path(base_dir) / "latest"
    if latest.exists() or latest.is_symlink():
        latest.unlink()
    latest.symlink_to(run_dir.name)
    return run_dir


def _to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


class Trainer:
    def __init__(self, model: torch.nn.Module, train_loader, val_loader, config: Dict,
                 run_dir):
        self.device = resolve_device(config.get("device", "cuda"))
        self.model = model.to(self.device)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.config = config
        self.run_dir = Path(run_dir)
        self.model_type = config.get("model_type", "attention")
        self.bf16 = bool(config.get("bf16", False))

        total_steps = max(1, len(train_loader) * config["epochs"])
        self.total_steps = total_steps
        self.optimizer = make_optimizer(
            self.model_type, self.model,
            learning_rate=config["learning_rate"],
            weight_decay=config.get("weight_decay", 1e-4),
            total_steps=total_steps,
            epochs=config["epochs"],
            steps_per_epoch=max(1, len(train_loader)),
        )
        self.train_step = make_train_step(
            self.model, self.optimizer, self.model_type,
            bf16=self.bf16,
            debug_nans=bool(config.get("debug_nans", False)),
            triplet_weight=config.get("triplet_weight", 0.3),
            triplet_margin=config.get("triplet_margin", 0.3),
            mask_padding=config.get("mask_padding", True),
            remat=config.get("remat", False),
            device_augment=config.get("device_augment", False),
            reuse_extract_features=config.get("fast_extracts", False),
        )
        self.eval_step = make_eval_step(self.model, self.model_type,
                                        mask_padding=config.get("mask_padding", True),
                                        bf16=self.bf16)
        self.extract_ratio = config.get("min_extract_ratio", 0.5)
        self.step_generator = torch.Generator().manual_seed(config.get("seed", 0) + 1)

        self.checkpoint_dir = self.run_dir / "checkpoints"
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.writer = _make_tb_writer(self.run_dir / "tensorboard")

        self.best_val_loss = float("inf")
        self.best_val_acc = 0.0
        self.best_auc_roc = 0.0
        self.best_sep_gap = 0.0  # gap AT the best checkpoint (tiebreak)
        self.epoch = 0
        self.global_step = 0

        self._save_training_info()

    # ------------------------------------------------------------------
    def _param_count(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

    def _save_training_info(self):
        (self.run_dir / "config.json").write_text(
            json.dumps(self.config, indent=2, default=str))
        lines = [
            f"Training started: {datetime.now().strftime('%Y-%m-%d %H:%M:%S')}",
            f"Device: {self.device}",
            f"Model type: {self.model_type}",
            f"Model parameters: {self._param_count():,}",
            "",
            "Model Architecture:",
        ]
        if self.model_type == "attention":
            lines += [
                f"  - Spatial dimension: {self.config.get('spatial_dim', 128)}",
                f"  - Temporal dimension: {self.config.get('temporal_dim', 256)}",
                f"  - Attention blocks: {self.config.get('num_attention_blocks', 4)}",
            ]
        else:
            lines += [
                f"  - Frame stride: {self.config.get('frame_stride', 16)}",
                f"  - Clip length: {self.config.get('clip_length', 128)}",
            ]
        lines += [
            f"  - Embedding dimension: {self.config['embedding_dim']}",
            "",
            "Data Configuration:",
            f"  - Frame size: {self.config['frame_size']}",
            f"  - Batch size: {self.config['batch_size']}",
            f"  - Training batches: {len(self.train_loader)}",
            f"  - Validation batches: {len(self.val_loader)}",
            "",
            "Command line arguments:",
            f"  {' '.join(sys.argv)}",
        ]
        (self.run_dir / "training_info.txt").write_text("\n".join(lines) + "\n")

    def _draws(self, batch: Dict[str, torch.Tensor], generator, ratio: float):
        if self.model_type != "attention":
            return None
        B, T = batch["clip1"].shape[:2]
        return draw_extracts(generator, B, T, ratio)

    # ------------------------------------------------------------------
    def train_epoch(self) -> Dict[str, float]:
        """One epoch of train steps. Step metrics are summed on the device
        and read back every `metrics_every` steps and at the epoch's end."""
        num_batches = 0
        sums = None
        self.train_loader.set_epoch(self.epoch)
        metrics_every = int(self.config.get("metrics_every", 10))
        epoch_t0 = time.time()
        # --profile: a torch.profiler trace of steps 2-5 of the first epoch
        profile_window = (2, 6) if (self.config.get("profile") and self.epoch == 0) else None
        profiler = None

        loader = self.train_loader
        try:
            from tqdm import tqdm

            loader = tqdm(self.train_loader, desc=f"Epoch {self.epoch}",
                          total=len(self.train_loader))
        except ImportError:
            pass

        last_t = time.time()
        last_sync_batches = 0
        for batch in loader:
            if profile_window and num_batches == profile_window[0]:
                profiler = self._start_profiler()
            dev = _to_device(batch, self.device)
            metrics = self.train_step(dev, self._draws(dev, self.step_generator,
                                                       self.extract_ratio),
                                      self.global_step)
            sums = metrics if sums is None else {k: sums[k] + v for k, v in metrics.items()}
            num_batches += 1

            if self.global_step % metrics_every == 0:
                # one deliberate sync point per window
                loss = float(metrics["loss"])
                acc = float(metrics["acc"])
                dt = time.time() - last_t
                window = max(1, num_batches - last_sync_batches)
                lr = current_lr(self.model_type, self.config["learning_rate"],
                                self.global_step, self.total_steps, self.config["epochs"],
                                max(1, len(self.train_loader)))
                if hasattr(loader, "set_postfix"):
                    loader.set_postfix({
                        "loss": f"{loss:.4f}", "acc": f"{acc:.3f}",
                        "triplet": f"{float(metrics.get('loss_triplet', 0)):.3f}",
                        "lr": f"{lr:.2e}", "time": f"{dt / window:.2f}s",
                    })
                self.writer.add_scalar("Train/loss_step", loss, self.global_step)
                self.writer.add_scalar("Train/acc_step", acc, self.global_step)
                self.writer.add_scalar("Train/lr", lr, self.global_step)
                last_t = time.time()
                last_sync_batches = num_batches
            self.global_step += 1
            if profiler is not None and num_batches >= profile_window[1]:
                self._stop_profiler(profiler)
                profiler = None
        if profiler is not None:
            self._stop_profiler(profiler)

        epoch_time = time.time() - epoch_t0
        out: Dict[str, float] = {}
        if sums is not None:
            for k, v in sums.items():
                if k in ("loss", "acc", "num_triplets") or k.startswith("loss_"):
                    out[k] = float(v) / num_batches
        out["time_per_batch"] = epoch_time / max(1, num_batches)
        return out

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        out = self.run_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(out / "trace.json"))
        print(f"profiler trace written to {out}")

    # ------------------------------------------------------------------
    def validate(self) -> Dict[str, float]:
        sums: Dict[str, float] = {}
        num_batches = 0
        all_embeddings = []
        all_video_ids = []
        generator = torch.Generator().manual_seed(1234)
        robustness_batches = []  # up to ~50 samples (reference train.py:483-491)
        robustness_budget = 50
        for batch in self.val_loader:
            dev = _to_device(batch, self.device)
            out, emb1, emb2 = self.eval_step(
                {k: v for k, v in dev.items() if k != "video_id"},
                self._draws(dev, generator, 0.5))
            for k, v in out.items():
                if k.startswith("loss") or k == "acc":
                    sums[k] = sums.get(k, 0.0) + float(v)
            num_batches += 1
            all_embeddings += [emb1.float().cpu().numpy(), emb2.float().cpu().numpy()]
            all_video_ids.extend(batch["video_id"].tolist() * 2)
            if robustness_budget > 0 and self.model_type == "attention":
                robustness_batches.append((dev["clip1"], dev.get("mask1")))
                robustness_budget -= dev["clip1"].shape[0]

        metrics = {k: v / max(1, num_batches) for k, v in sums.items()}
        if not all_embeddings:
            return metrics

        embeddings = np.concatenate(all_embeddings, axis=0)
        ids = np.asarray(all_video_ids, np.int32)
        n_videos = len(set(ids.tolist()))
        # Above the threshold the dense N x N similarities of the reference's
        # validation (train.py:439-481) stop fitting: the streaming path
        # computes the same metrics in O(block * N) memory.
        threshold = self.config.get("streaming_metrics_threshold", 8192)
        emb_dev = torch.from_numpy(embeddings).to(self.device)
        ids_dev = torch.from_numpy(ids).to(self.device)
        if embeddings.shape[0] > threshold:
            s = streaming_validation_metrics(emb_dev, ids_dev)
            print(f"  [val metrics: streaming path, "
                  f"N={embeddings.shape[0]} > threshold {threshold}]")
            for k in (1, 5, 10):  # the reference skips k > n_videos-1 (train.py:449)
                if k > n_videos - 1:
                    s.pop(f"R@{k}", None)
            metrics.update(s)
        else:
            r = retrieval_metrics(emb_dev, ids_dev)
            for k in (1, 5, 10):
                if k <= n_videos - 1:
                    metrics[f"R@{k}"] = r[f"R@{k}"]
            metrics["mAP"] = r["mAP"]
            metrics.update(discrimination_metrics(emb_dev, ids_dev))

        if self.model_type == "attention" and robustness_batches:
            metrics.update(self._extract_robustness(robustness_batches))
        return metrics

    @torch.no_grad()
    def _extract_robustness(self, batches) -> Dict[str, float]:
        """Centered extracts at ratios 0.5..0.9 of each video's true length,
        cosine to the full-video embedding, averaged over up to ~50 val
        samples (reference train.py:483-518)."""
        self.model.eval()
        sums: Dict[str, list] = {}
        for clip, mask in batches:
            B, T = clip.shape[0], clip.shape[1]
            with compute_context(self.device, self.bf16):
                emb_full = self.model(clip, mask)
            t_true = (mask.sum(dim=1).to(torch.int32) if mask is not None
                      else torch.full((B,), T, dtype=torch.int32, device=clip.device))
            pos = torch.arange(T, device=clip.device)
            for ratio in (0.5, 0.6, 0.7, 0.8, 0.9):
                ext_len = torch.clamp((t_true.to(torch.float32) * ratio).to(torch.int32), min=1)
                start = torch.div(t_true - ext_len, 2, rounding_mode="floor")
                idx = torch.clamp(start[:, None] + pos[None, :], 0, T - 1)
                sub = clip[torch.arange(B, device=clip.device)[:, None], idx]
                submask = pos[None, :] < ext_len[:, None]
                with compute_context(self.device, self.bf16):
                    emb_ext = self.model(sub, submask)
                cos = float(torch.sum(emb_full * emb_ext, dim=1).mean())
                sums.setdefault(f"extract_sim_{int(ratio * 100)}", []).append(cos)
        return {k: float(np.mean(v)) for k, v in sums.items()}

    # ------------------------------------------------------------------
    def variables(self) -> Dict:
        """The model's weights and BN statistics as flax-layout numpy trees."""
        sd = {k: v.detach().cpu().numpy() for k, v in self.model.state_dict().items()}
        return state_dict_to_variables(sd, self.model_type)

    def save_checkpoint(self, is_best: bool = False, metrics: Optional[Dict] = None):
        variables = self.variables()
        opt_sd = adamw_to_opt_state(self.optimizer, self.model, self.model_type)
        bests = {
            "best_val_loss": self.best_val_loss,
            "best_val_acc": self.best_val_acc,
            "best_auc_roc": self.best_auc_roc,
            "best_sep_gap": self.best_sep_gap,
        }

        def save(path):
            ckpt.save_checkpoint(path, variables["params"], variables["batch_stats"],
                                 self.config, opt_state_sd=opt_sd, epoch=self.epoch,
                                 global_step=self.global_step, bests=bests, metrics=metrics)

        save(self.checkpoint_dir / "last.ckpt")
        if is_best:
            save(self.checkpoint_dir / "best.ckpt")
            if metrics:
                (self.checkpoint_dir / "best_metrics.json").write_text(
                    json.dumps(metrics, indent=2, default=float))
        if self.epoch % 5 == 0:
            save(self.checkpoint_dir / f"epoch_{self.epoch}.ckpt")
            if metrics:
                (self.checkpoint_dir / f"epoch_{self.epoch}_metrics.json").write_text(
                    json.dumps(metrics, indent=2, default=float))

    def _check_ckpt_model_type(self, ckpt_config, path):
        """Fail at resume time on an architecture mismatch."""
        ckpt_type = (ckpt_config or {}).get("model_type")
        norm = {"cnn3d": "3d"}
        mine = self.model_type
        if ckpt_type is not None and norm.get(ckpt_type, ckpt_type) != norm.get(mine, mine):
            raise ValueError(f"checkpoint {path} was trained with model_type="
                             f"{ckpt_type!r} but this run uses --model {mine!r}")

    def _load_variables(self, variables) -> None:
        sd = variables_to_state_dict(variables, self.model_type)
        self.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                                   strict=True)

    def resume(self, checkpoint_path):
        p = Path(checkpoint_path)
        ckpt.refuse_orbax(p)
        if p.suffix == ".pth" or ckpt._looks_like_torch(p):
            # a reference torch checkpoint: the weights only; the optimizer,
            # schedule and counters start fresh, as in the JAX package
            variables, ckpt_config = ckpt.load_any(p)
            self._check_ckpt_model_type(ckpt_config, p)
            self._load_variables(variables)
            self.optimizer.state.clear()
            print(f"Warm start from reference checkpoint {p} "
                  "(weights only; fresh optimizer state and schedule)")
            with open(self.run_dir / "training_info.txt", "a") as f:
                f.write(f"\n\nWarm start (weights only) from torch "
                        f"checkpoint: {checkpoint_path}\n")
            return
        payload = ckpt.load_checkpoint(p)
        self._check_ckpt_model_type(payload.get("config"), p)
        self._load_variables(payload["model"])
        train = payload["train"]
        if train.get("opt_state"):
            opt_state_to_adamw(train["opt_state"], self.optimizer, self.model, self.model_type)
        self.epoch = int(train["epoch"]) + 1
        self.global_step = int(train["global_step"])
        bests = train.get("bests", {})
        self.best_val_loss = float(bests.get("best_val_loss", float("inf")))
        self.best_val_acc = float(bests.get("best_val_acc", 0.0))
        self.best_auc_roc = float(bests.get("best_auc_roc", 0.0))
        self.best_sep_gap = float(bests.get("best_sep_gap", 0.0))
        print(f"Resumed from epoch {self.epoch}")
        with open(self.run_dir / "training_info.txt", "a") as f:
            f.write(f"\n\nResumed from checkpoint: {checkpoint_path}\n")

    def _update_training_log(self, train_metrics, val_metrics, is_best):
        with open(self.run_dir / "training_log.txt", "a") as f:
            if self.epoch == 0:
                f.write("\n" + "=" * 130 + "\n")
                f.write("Epoch | Train Loss | Train Acc | Val Loss | Val Acc | AUC-ROC"
                        " | Intra Sim | Inter Sim | F1@0.7 | F1@0.8 | Best\n")
                f.write("-" * 130 + "\n")
            f.write(
                f"{self.epoch:5d} | {train_metrics['loss']:10.4f} | "
                f"{train_metrics['acc']:9.3f} | {val_metrics.get('loss', 0):8.4f} | "
                f"{val_metrics.get('acc', 0):7.3f} | {val_metrics.get('auc_roc', 0):7.3f} | "
                f"{val_metrics.get('intra_sim_mean', 0):9.3f} | "
                f"{val_metrics.get('inter_sim_mean', 0):9.3f} | "
                f"{val_metrics.get('f1@0.70', 0):6.3f} | "
                f"{val_metrics.get('f1@0.80', 0):6.3f} | "
                f"{'V' if is_best else 'X'}\n"
            )

    # ------------------------------------------------------------------
    def train(self):
        if len(self.train_loader) == 0:
            raise ValueError("train loader yields no batches (too few videos for the "
                             "batch size with drop_last) — nothing to train on")
        print(f"Training on {self.device}")
        print(f"Model type: {self.model_type}")
        print(f"Model parameters: {self._param_count():,}")
        print(f"\nRun directory: {self.run_dir}")

        patience = self.config.get("patience", 10)
        patience_counter = 0

        for epoch in range(self.epoch, self.config["epochs"]):
            self.epoch = epoch
            train_metrics = self.train_epoch()
            val_metrics = self.validate()

            print(f"\n{'=' * 80}")
            print(f"Epoch {epoch}/{self.config['epochs']}")
            print(f"Train - Loss: {train_metrics['loss']:.4f}, "
                  f"Acc: {train_metrics['acc']:.3f}")
            print(f"Val   - Loss: {val_metrics.get('loss', 0):.4f}, "
                  f"Acc: {val_metrics.get('acc', 0):.3f}")
            print(f"  AUC-ROC: {val_metrics.get('auc_roc', 0):.3f}")
            print(f"  Separation gap: {val_metrics.get('separation_gap', 0):.3f} "
                  f"(intra {val_metrics.get('intra_sim_mean', 0):.3f} / "
                  f"inter {val_metrics.get('inter_sim_mean', 0):.3f})")

            for key, value in train_metrics.items():
                self.writer.add_scalar(f"Train/{key}", value, epoch)
            for key, value in val_metrics.items():
                self.writer.add_scalar(f"Val/{key}", value, epoch)

            auc = val_metrics.get("auc_roc", 0.0)
            gap = val_metrics.get("separation_gap", 0.0)
            is_best = is_new_best(auc, gap, self.best_auc_roc, self.best_sep_gap,
                                  flat_eps=float(self.config.get("auc_flat_eps", 1e-3)))
            if is_best:
                via_gap = not (auc > self.best_auc_roc)
                # max, not overwrite: a near-flat gap-tiebreak best must not
                # lower the AUC bar for later epochs
                self.best_auc_roc = max(auc, self.best_auc_roc)
                self.best_sep_gap = gap
                self.best_val_acc = val_metrics.get("acc", 0.0)
                self.best_val_loss = val_metrics.get("loss", float("inf"))
                print(f"\nNew best AUC-ROC: {auc:.3f}"
                      + (f" (flat AUC, separation gap improved to {gap:.3f})"
                         if via_gap else ""))
                patience_counter = 0
            else:
                patience_counter += 1
                print(f"\nEarly stopping patience: {patience_counter}/{patience}")

            self.save_checkpoint(is_best, metrics={"train": train_metrics, "val": val_metrics,
                                                   "epoch": epoch})
            self._update_training_log(train_metrics, val_metrics, is_best)

            if val_metrics.get("separation_gap", 0) < 0.1:
                print("\nWARNING: Poor separation between same and different videos!")

            if patience_counter >= patience:
                print(f"\nEarly stopping after {patience} epochs without improvement.")
                break

        self.writer.close()
        summary = [
            f"Training completed: {datetime.now().strftime('%Y-%m-%d %H:%M:%S')}",
            f"Model type: {self.model_type}",
            f"Total epochs: {self.epoch + 1}",
            f"Best AUC-ROC: {self.best_auc_roc:.4f}",
            f"Best validation accuracy: {self.best_val_acc:.4f}",
            f"Best validation loss: {self.best_val_loss:.4f}",
            f"Final checkpoint: {self.checkpoint_dir / 'last.ckpt'}",
            f"Best checkpoint: {self.checkpoint_dir / 'best.ckpt'}",
        ]
        (self.run_dir / "training_summary.txt").write_text("\n".join(summary) + "\n")
        print("\nTraining completed!")
        print(f"Results saved to: {self.run_dir}")

"""The port's train CLI (python -m video_fingerprint_tpu_torch.cli.train) on
the CPU: a 2-epoch run of the full-width attention model on a seeded
corpus of 4 short mp4s (plus one copy) leaves the reference's run-dir
artifacts, a resume continues at the next epoch with the step counter
carried, patience 0 stops after the first epoch, the best-checkpoint rule
keeps its gap tiebreak, and the flags that are not ported exit with an
error instead of running something else."""

import json

import pytest
import torch

from video_fingerprint_tpu.training.trainer import is_new_best as jax_is_new_best
from video_fingerprint_tpu_torch.cli.train import main
from video_fingerprint_tpu_torch.training import trainer as port_trainer
from video_fingerprint_tpu_torch.training.checkpoint import load_checkpoint
from video_fingerprint_tpu_torch.training.trainer import is_new_best
from video_fingerprint_tpu_torch.utils.synthetic import make_corpus


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _no_tensorboard():
    """TensorBoard logging is left out of these runs: importing it costs
    seconds (it pulls in TensorFlow where that is installed)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_trainer, "_make_tb_writer", lambda logdir: port_trainer._NullWriter())
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    make_corpus(root, num_unique=4, num_frames=20, duplicates=1)
    return root


def _run(corpus, *extra):
    return main(["--data_dir", str(corpus), "--batch_size", "2", "--num_workers", "0",
                 "--device", "cpu", "--max_frames", "16", *extra])


def test_two_epochs_artifacts_and_resume(corpus, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert _run(corpus, "--epochs", "2", "--run_name", "a") == 0
    run = tmp_path / "runs" / "a"
    for name in ("config.json", "training_info.txt", "training_log.txt",
                 "training_summary.txt", "checkpoints/last.ckpt", "checkpoints/best.ckpt",
                 "checkpoints/best_metrics.json", "checkpoints/epoch_0.ckpt",
                 "checkpoints/epoch_0_metrics.json"):
        assert (run / name).exists(), name
    config = json.loads((run / "config.json").read_text())
    assert config["device"] == "cpu" and config["model_type"] == "attention"
    log = (run / "training_log.txt").read_text().splitlines()
    assert sum(line.strip().startswith(("0 |", "1 |")) for line in log) == 2
    last = load_checkpoint(run / "checkpoints/last.ckpt")
    assert (last["train"]["epoch"], last["train"]["global_step"]) == (1, 4)
    assert set(last["metrics"]["val"]) >= {"auc_roc", "mAP", "separation_gap",
                                           "extract_sim_50", "loss", "acc"}

    capsys.readouterr()
    assert _run(corpus, "--epochs", "3", "--run_name", "b",
                "--checkpoint", str(run / "checkpoints/last.ckpt")) == 0
    assert "Resumed from epoch 2" in capsys.readouterr().out
    resumed = load_checkpoint(tmp_path / "runs/b/checkpoints/last.ckpt")
    assert (resumed["train"]["epoch"], resumed["train"]["global_step"]) == (2, 6)


def test_patience_zero_stops_after_one_epoch(corpus, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert _run(corpus, "--epochs", "3", "--patience", "0", "--model", "3d",
                "--clip_length", "16", "--frame_stride", "4", "--batch_size", "1") == 0
    out = capsys.readouterr().out
    assert "Early stopping after 0 epochs without improvement." in out
    runs = [p for p in (tmp_path / "runs").iterdir() if p.name.startswith("3d_run_")]
    assert len(runs) == 1 and (tmp_path / "runs/latest").is_symlink()
    assert "Total epochs: 1" in (runs[0] / "training_summary.txt").read_text()


@pytest.mark.parametrize("auc,gap,best_auc,best_gap", [
    (0.9, 0.1, 0.8, 0.5), (0.9995, 0.4, 1.0, 0.3), (0.9995, 0.2, 1.0, 0.3),
    (0.99, 0.9, 1.0, 0.3), (1.0, 0.3, 1.0, 0.3)])
def test_is_new_best_matches_jax(auc, gap, best_auc, best_gap):
    assert is_new_best(auc, gap, best_auc, best_gap) == jax_is_new_best(auc, gap, best_auc,
                                                                        best_gap)


@pytest.mark.parametrize("flag", ["--orbax", "--device_augment", "--native_decode"])
def test_unported_flags_exit_with_an_error(corpus, tmp_path, monkeypatch, capsys, flag):
    monkeypatch.chdir(tmp_path)
    assert _run(corpus, flag) == 2
    assert "not ported" in capsys.readouterr().out
    assert not (tmp_path / "runs").exists()

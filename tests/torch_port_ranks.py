"""Rank processes for the port's multi-process tests
(tests/test_torch_port_dp_train.py, tests/test_torch_port_multiproc_topk.py).

    python -m tests.torch_port_ranks <task> <rank> <world> <workdir>

Each rank reads <workdir>/inputs.pt (written by `run_ranks` in the test
process), joins a gloo group of `world` ranks on the CPU (through a file in
<workdir>, or for the `cli` task through the launcher's environment, which
the port's own `maybe_initialize_distributed` reads), runs its task and
writes <workdir>/rank<r>.pt. The ranks import torch and the port only,
never JAX; each runs one torch thread.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO_ROOT = Path(__file__).resolve().parent.parent


def run_ranks(task: str, world: int, workdir: Path, inputs: dict, timeout: float = 240,
              env: dict | None = None) -> list:
    """Spawn `world` ranks of `task`, wait for all (each within `timeout`
    seconds) and return their outputs in rank order."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, workdir / "inputs.pt")
    procs = []
    for r in range(world):
        penv = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_port_ranks", task, str(r), str(world),
             str(workdir)], cwd=REPO_ROOT, env=penv, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {task} exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) | {"log": logs[r]}
            for r in range(world)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --------------------------------------------------------------- the tasks


def _task_bn(inputs, rank, world):
    """Each BatchNorm kind on this rank's rows of a global batch, train
    mode: the output, the input's grad of sum(y * g) and the affine
    params' grads, and the running statistics after the step."""
    from video_fingerprint_tpu_torch.models import layers

    out = {}
    for name, cls in (("1d", layers.BatchNorm1d), ("2d", layers.BatchNorm2d),
                      ("3d", layers.BatchNorm3d)):
        x_all, g_all, state = inputs[name]["x"], inputs[name]["g"], inputs[name]["state"]
        b = x_all.shape[0] // world
        bn = cls(x_all.shape[1])
        bn.load_state_dict(state)
        bn.train()
        x = x_all[rank * b:(rank + 1) * b].clone().requires_grad_(True)
        y = bn(x)
        (y * g_all[rank * b:(rank + 1) * b]).sum().backward()
        out[name] = {"y": y.detach(), "x_grad": x.grad, "w_grad": bn.weight.grad,
                     "b_grad": bn.bias.grad,
                     "state": {k: v.clone() for k, v in bn.state_dict().items()}}
    return out


def _port_model(model_type, dims, state):
    from video_fingerprint_tpu_torch.models import create_model

    model = create_model(model_type, **dims)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                          strict=True)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def _task_step(inputs, rank, world):
    """Train steps of every case on this rank's rows of the global batch
    and draws: per-step metrics and the final state_dict."""
    from video_fingerprint_tpu_torch.parallel.distributed import DataParallel
    from video_fingerprint_tpu_torch.training import optim, train_step

    dp = DataParallel()
    out = {}
    for name, case in inputs["cases"].items():
        model = _port_model(case["model_type"], case["dims"], case["state"])
        opt = optim.make_optimizer(case["model_type"], model, case["lr"], **case["opt"])
        step = train_step.make_train_step(model, opt, case["model_type"],
                                          reuse_extract_features=case["reuse"],
                                          remat=case["remat"])
        batch = dp.shard_batch({k: torch.from_numpy(np.array(v))
                                for k, v in case["batch"].items()})
        metrics = []
        for i, draws in enumerate(case["draws"]):
            m = step(batch, dp.shard_batch(draws) if draws is not None else None, i)
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = {"metrics": metrics,
                     "state": {k: v.detach().numpy() for k, v in model.state_dict().items()}}
    return out


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def set_epoch(self, epoch):
        pass


def _task_equiv(inputs, rank, world):
    """The Trainer's own train steps over this rank's rows of each global
    train batch, then validate() on global val batches (the last one
    partial), dropout off; the per-step losses and the val metrics."""
    from video_fingerprint_tpu_torch.models import create_model
    from video_fingerprint_tpu_torch.parallel.distributed import DataParallel
    from video_fingerprint_tpu_torch.training import trainer as port_trainer

    dp = DataParallel()
    train = _Loader([dp.shard_batch(b) for b in inputs["train"]])
    val = _Loader([dp.shard_batch(b) for b in inputs["val"]])
    port_trainer._make_tb_writer = lambda logdir: port_trainer._NullWriter()
    torch.manual_seed(0)
    model = create_model("attention", **inputs["dims"])
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    run_dir = Path(inputs["run_base"]) / f"world{world}_rank{rank}"
    trainer = port_trainer.Trainer(model, train, val, inputs["config"], run_dir)
    losses = []
    for batch in train:
        dev = port_trainer._to_device(batch, trainer.device)
        draws = trainer._draws(dev, trainer.step_generator, trainer.extract_ratio)
        losses.append(float(trainer.train_step(dev, draws, trainer.global_step)["loss"]))
        trainer.global_step += 1
    return {"losses": losses, "val": trainer.validate()}


def _task_cli(inputs, rank, world):
    """The train CLI in this rank's own working directory (TensorBoard
    stubbed: importing it costs seconds on the CPU)."""
    from video_fingerprint_tpu_torch.cli.train import main
    from video_fingerprint_tpu_torch.training import trainer as port_trainer

    port_trainer._make_tb_writer = lambda logdir: port_trainer._NullWriter()
    cwd = Path(inputs["cwd"]) / f"rank{rank}"
    cwd.mkdir(parents=True, exist_ok=True)
    os.chdir(cwd)
    return {"rc": main(inputs["argv"])}


def _task_search(inputs, rank, world):
    """The corpus-sharded searches across the ranks: every case of
    inputs["cases"] (a ring or a query search of one corpus, staged on this
    rank over `local` CPU devices) with the rows this rank staged and the
    rows sent to repair; the index's search and the scanner's duplicate
    groups; the collectives alone."""
    from video_fingerprint_tpu_torch.inference import scanner as scanner_mod
    from video_fingerprint_tpu_torch.inference.index import FingerprintIndex
    from video_fingerprint_tpu_torch.ops import topk
    from video_fingerprint_tpu_torch.parallel import distributed

    arrays = inputs["arrays"]
    out = {"cases": {}}
    for case in inputs["cases"]:
        dtype = torch.bfloat16 if case["storage"] == "bf16" else torch.float32
        staged = topk.stage_sharded_corpus(arrays[case["corpus"]], ["cpu"] * case["local"],
                                           dtype)
        kwargs = dict(method=case["method"], exact_above=case["thr"],
                      recall_target=case["recall"])
        before = topk.repaired_rows
        if case["kind"] == "ring":
            s, i = topk.sharded_topk_cosine(staged, case["k"], **kwargs)
        else:
            s, i = topk.sharded_topk_search(arrays[case["queries"]], staged, case["k"],
                                            **kwargs)
        out["cases"][case["name"]] = {
            "scores": s.numpy(), "idx": i.numpy(), "repaired": topk.repaired_rows - before,
            "held": [(staged.offset(j), len(staged.valid(j)))
                     for j in range(len(staged.shards))]}

    out["index"] = {}
    for storage in ("f32", "bf16"):
        index = FingerprintIndex(dim=arrays["embeddings"].shape[1], device="cpu",
                                 storage=storage)
        index.add(arrays["embeddings"])
        s, i = index.search(arrays["queries"], k=10)
        out["index"][storage] = {"scores": s, "idx": i,
                                 "sharded": index._staged_sharded is not None}

    calls = []
    real = scanner_mod.sharded_topk_cosine
    scanner_mod.sharded_topk_cosine = lambda *a, **k: calls.append(1) or real(*a, **k)
    scanner = scanner_mod.FingerprintScanner(inputs["checkpoint"], device="cpu")
    groups = scanner.find_duplicates(inputs["fingerprints"], 0.99, topk_threshold=10)
    out["scanner"] = {"groups": sorted(sorted(item["path"] for item in g) for g in groups),
                      "ring_calls": len(calls)}

    out["collectives"] = {
        "gather": distributed.all_gather_stack(torch.arange(5) + 10 * rank),
        "and": distributed.all_ranks_true(torch.tensor([True, rank != 1, True])),
        "sum": distributed.all_reduce_sum(torch.tensor([float(rank), 1.0])),
        "shift": distributed.ring_shift(torch.full((3,), float(rank))),
    }
    return out


TASKS = {"bn": _task_bn, "step": _task_step, "equiv": _task_equiv, "cli": _task_cli,
         "search": _task_search}


def main(argv) -> int:
    task, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    torch.set_num_threads(1)
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    if task == "cli":  # the launcher's environment, read by the CLI itself
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    else:
        torch.distributed.init_process_group(
            "gloo", init_method=f"file://{workdir / 'rendezvous'}", rank=rank,
            world_size=world)
    try:
        out = TASKS[task](inputs, rank, world)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    torch.save(out, workdir / f"rank{rank}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

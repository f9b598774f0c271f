"""Graft entry points of the port (port of __graft_entry__.py).

entry(device="cuda")  -> (fn, example_args): the flagship attention
                         fingerprint model's eval forward in f32 at the
                         reference widths, on a (1, 32, 64, 64, 3) video.
                         `fn(variables, video)` takes the variables in the
                         JAX package's layout ({"params", "batch_stats"}
                         trees of arrays, what a .ckpt holds), carries them
                         into the port's model through
                         utils/torch_compat.py::variables_to_state_dict and
                         runs the forward under torch.no_grad(): on a card
                         K1 runs 4 times per call.
dryrun_multichip(n, devices=None)
                      -> the JAX body's multi-device programs over n
                         devices, each held to its one-device oracle:
  1. one data-parallel train step with global-batch BatchNorm: n gloo
     ranks, each with its rows of the global batch and draws, against the
     same step on the whole batch on one device (loss within LOSS_RTOL, the
     grad norm within GRAD_NORM_RTOL, both finite, every rank the same
     loss);
  2. the same step with device augment (the train CLI's --device_augment);
  3. the corpus-sharded dedup top-k (the ring `sharded_topk_cosine`) for
     exact and strict certified (recall 0.7, so the repair runs: the
     oracle's scores within 1e-5), certified-bf16 at 0.95 on planted near
     copies (every pair above the threshold found, scores within 1e-5),
     and the bf16-resident corpus (the ring over a bf16 corpus and a
     query-vs-corpus search of off-grid f32 queries against a bf16-staged
     corpus: complete above the threshold in the quantized-query cosine
     domain, scores within 2e-5);
  4. the sharded query-vs-corpus search (`sharded_topk_search`, the
     --against workload), the oracle's scores within 1e-5;
  5. data-parallel batched extraction (`forward_flat` on each device's rows
     of the batch) equal to one device within rtol / atol 1e-5;
  6. the validation path with a partial batch: max(1, n - 2) rows (JAX
     takes n - 2, which is empty at n = 2) padded by wraparound to a
     multiple of n, evaluated as each device's rows, the padding sliced
     back out (`slice_replicated_blocks`): embeddings equal to one device's
     eval of the true rows within rtol / atol 1e-5, the block layout exact
     for 1, 2 and 4 processes, the eval loss and the retrieval and
     discrimination metrics finite.

The JAX version re-executes itself on a virtual n-device CPU mesh when its
backend has fewer devices. The port has no counterpart to that: its n
devices are a device list (parallel/mesh.py::as_devices), which may name
one device n times (cuda:0 four times on one card, ["cpu"] * n in the
tests). The programs that JAX runs under GSPMD as one data-parallel step
(1, 2) run as n torch.distributed gloo ranks, one process per entry of the
list, as the port's data-parallel training does; the others run in this
process over the device list. No program is skipped: one that raises fails
the run.

    python -m video_fingerprint_tpu_torch.tools.graft_entry [--device cpu]

runs entry()'s forward, then dryrun_multichip(4) over cuda:0 (or the CPU)
four times (the JAX __main__ runs 8 devices; 4 keeps a one-card run
short).
"""

from __future__ import annotations

import argparse
import copy
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.ops.metrics import discrimination_metrics, retrieval_metrics
from video_fingerprint_tpu_torch.ops.topk import (
    sharded_topk_cosine,
    sharded_topk_search,
    stage_sharded_corpus,
)
from video_fingerprint_tpu_torch.parallel.distributed import (
    DataParallel,
    maybe_initialize_distributed,
)
from video_fingerprint_tpu_torch.parallel.mesh import as_devices, pad_to_multiple
from video_fingerprint_tpu_torch.training import optim, train_step
from video_fingerprint_tpu_torch.training.trainer import (
    slice_replicated_blocks,
    wraparound_pad_batch,
)
from video_fingerprint_tpu_torch.utils.device import resolve_device
from video_fingerprint_tpu_torch.utils.precision import full_fp32
from video_fingerprint_tpu_torch.utils.torch_compat import (
    state_dict_to_variables,
    variables_to_state_dict,
)

SEED = 0
T, HW = 8, 32          # the dry run's clips: T frames of HW x HW (JAX's shapes)
EXTRACT_RATIO = 0.5
LOSS_RTOL = 1e-4       # the ranks' step against one device (BN sums in another order)
GRAD_NORM_RTOL = 5e-3  # the CPU's BN backward sums move the grads by a few 1e-3
RANK_TIMEOUT_S = 600
MAIN_DEVICES = 4       # __main__'s dry run (JAX's runs 8; 4 keeps a one-card run short)
REPO_ROOT = Path(__file__).resolve().parents[2]


def _seeded_model(device, dropout: bool = True) -> torch.nn.Module:
    """The full-width attention model from SEED on the CPU (the same bits in
    every process), on `device`; dropout off for steps held to an oracle."""
    torch.manual_seed(SEED)
    model = create_model("attention")
    if not dropout:
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    return model.to(device)


def entry(device: str = "cuda"):
    """(fn, (variables, video)): fn(variables, video) -> (1, 256) embedding."""
    dev = resolve_device(device)
    model = _seeded_model(dev).eval()
    variables = state_dict_to_variables(
        {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}, "attention")
    video = torch.zeros((1, 32, 64, 64, 3), dtype=torch.float32, device=dev)

    def fn(variables, video):
        sd = variables_to_state_dict(variables, "attention")
        params = {k: torch.from_numpy(np.array(v)).to(video.device) for k, v in sd.items()}
        with torch.no_grad(), full_fp32():
            return torch.func.functional_call(model, params, (video,))

    return fn, (variables, video)


def _to(tree, device):
    """Tensors of a nested dict moved to `device`."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _train_inputs(n: int) -> Dict:
    """The dry run's global batch (2 n clip pairs of T frames, JAX's shapes:
    uniform pixels, video ids 0 .. n - 1 twice, full masks) and the draws of
    one step, extracts and device augment, made on the CPU from SEED."""
    B = 2 * n
    rng = np.random.default_rng(SEED + 1)
    batch = {"clip1": torch.from_numpy(rng.random((B, T, HW, HW, 3), dtype=np.float32)),
             "clip2": torch.from_numpy(rng.random((B, T, HW, HW, 3), dtype=np.float32)),
             "video_id": torch.arange(B) % (B // 2),
             "mask1": torch.ones((B, T), dtype=torch.bool),
             "mask2": torch.ones((B, T), dtype=torch.bool)}
    g = torch.Generator().manual_seed(SEED + 2)
    draws = train_step.draw_extracts(g, B, T, EXTRACT_RATIO)
    return {"batch": batch, "draws": draws,
            "aug_draws": {**draws, **train_step.draw_augmentations(g, batch)}}


def _one_step(device, inputs: Dict, device_augment: bool) -> Dict[str, float]:
    """One train step from SEED's initial state on `device`: on the whole
    batch in one process, or on this rank's rows under a process group."""
    model = _seeded_model(device, dropout=False)
    opt = optim.make_optimizer("attention", model, 1e-4, total_steps=100, epochs=2,
                               steps_per_epoch=10)
    step = train_step.make_train_step(model, opt, "attention", device_augment=device_augment)
    dp = DataParallel()
    batch = dp.shard_batch(_to(inputs["batch"], device))
    draws = dp.shard_batch(_to(inputs["aug_draws" if device_augment else "draws"], device))
    with full_fp32():
        metrics = step(batch, draws, 0)
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, workdir: Path) -> int:
    """One rank of programs 1 and 2 (a spawned process): joins the gloo
    group, runs both steps on its device and rows, writes its metrics."""
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    device = inputs["devices"][rank]
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(inputs["port"]))
    maybe_initialize_distributed(device, backend="gloo")
    try:
        out = {"plain": _one_step(device, inputs, False),
               "device_augment": _one_step(device, inputs, True)}
    finally:
        torch.distributed.destroy_process_group()
    torch.save(out, workdir / f"rank{rank}.pt")
    return 0


def _spawn_ranks(devices: List[torch.device], inputs: Dict) -> List[Dict]:
    """One gloo rank per device of the list (each a process of this module);
    every rank must exit 0 within RANK_TIMEOUT_S."""
    world = len(devices)
    with tempfile.TemporaryDirectory(prefix="vfp_graft_") as tmp:
        workdir = Path(tmp)
        torch.save({**inputs, "devices": [str(d) for d in devices], "port": _free_port()},
                   workdir / "inputs.pt")
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(REPO_ROOT), os.environ.get("PYTHONPATH", "")]))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "video_fingerprint_tpu_torch.tools.graft_entry", "--rank",
             str(r), "--world", str(world), "--workdir", str(workdir)],
            cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n{log[-3000:]}")
        return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _check_step(name: str, ranks: List[Dict], oracle: Dict[str, float]) -> float:
    losses = [r[name]["loss"] for r in ranks]
    if not all(np.isfinite(v) for v in losses + [r[name]["grad_norm"] for r in ranks]):
        raise AssertionError(f"{name}: non-finite loss or grad norm {ranks}")
    if max(losses) - min(losses) > 1e-6 * max(1.0, abs(losses[0])):
        raise AssertionError(f"{name}: the ranks' losses differ: {losses}")
    np.testing.assert_allclose(losses[0], oracle["loss"], rtol=LOSS_RTOL,
                               err_msg=f"{name}: loss against one device")
    for r in ranks:
        np.testing.assert_allclose(r[name]["grad_norm"], oracle["grad_norm"],
                                   rtol=GRAD_NORM_RTOL,
                                   err_msg=f"{name}: grad norm against one device")
    return losses[0]


def _unit_rows(rng, n: int, dim: int) -> np.ndarray:
    x = rng.normal(size=(n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _complete_above(scores, idx, sims, thr: float, tol: float, what: str) -> None:
    """Every row's items at or above `thr` in `sims` are among its hits, and
    each live hit's score is its similarity within `tol`."""
    for row in range(len(scores)):
        want = set(np.flatnonzero(sims[row] >= thr).tolist())
        got = {int(j) for s, j in zip(scores[row], idx[row]) if s >= thr - tol}
        if not want <= got:
            raise AssertionError(f"{what}: row {row} misses {sorted(want - got)}")
    live = np.isfinite(scores)
    np.testing.assert_allclose(scores[live], np.take_along_axis(sims, idx, axis=1)[live],
                               atol=tol, err_msg=what)


def _topk_programs(devices: List[torch.device], n: int) -> None:
    """Programs 3 and 4: the sharded searches against float64-free numpy
    oracles, as the JAX body holds them."""
    rng = np.random.default_rng(SEED + 7)
    n_emb, dim, k, thr = 64, 32, 5, 0.95
    emb = _unit_rows(rng, n_emb, dim)
    sims = emb @ emb.T
    oracle = np.take_along_axis(sims, np.argsort(-sims, axis=1)[:, :k], axis=1)
    for method, recall in (("exact", None), ("certified", 0.7)):
        scores, _ = sharded_topk_cosine(emb, k, devices, method=method, recall_target=recall)
        np.testing.assert_allclose(np.sort(scores.cpu().numpy(), axis=1),
                                   np.sort(oracle, axis=1), atol=1e-5, err_msg=method)
    print(f"dryrun_multichip({n}): sharded top-k OK ({n_emb}x{dim} corpus over {n} shards, "
          f"k={k}); sharded CERTIFIED top-k OK (certificate + exact repair == oracle)")

    dup = emb.copy()
    for a, b in ((0, 1), (16, 17), (33, 34)):
        dup[b] = 0.98 * dup[a] + np.float32(np.sqrt(1 - 0.98 ** 2)) * dup[b]
        dup[b] /= np.linalg.norm(dup[b])
    scores, idx = sharded_topk_cosine(dup, k, devices, method="certified-bf16",
                                      exact_above=thr, recall_target=0.7)
    _complete_above(scores.cpu().numpy(), idx.cpu().numpy(), dup @ dup.T, thr, 1e-5,
                    "certified-bf16")
    print(f"dryrun_multichip({n}): sharded certified-bf16 top-k OK (complete above {thr})")

    e16 = torch.from_numpy(dup).to(torch.bfloat16)
    stored = e16.float().numpy()
    stored /= np.linalg.norm(stored, axis=1, keepdims=True)  # the stored directions
    scores, idx = sharded_topk_cosine(e16, k, devices, method="certified-bf16",
                                      exact_above=thr, recall_target=0.7)
    _complete_above(scores.cpu().numpy(), idx.cpu().numpy(), stored @ stored.T, thr, 2e-5,
                    "bf16-resident ring")
    staged16 = stage_sharded_corpus(dup, devices, torch.bfloat16)
    q_off = dup[:7] + np.float32(1e-3) * rng.normal(size=(7, dim)).astype(np.float32)
    q_off /= np.linalg.norm(q_off, axis=1, keepdims=True)
    qq = torch.from_numpy(q_off).to(torch.bfloat16).float().numpy()
    qq /= np.linalg.norm(qq, axis=1, keepdims=True)
    scores, idx = sharded_topk_search(q_off, staged16, k, method="certified-bf16",
                                      exact_above=thr, recall_target=0.7)
    _complete_above(scores.cpu().numpy(), idx.cpu().numpy(), qq @ stored.T, thr, 2e-5,
                    "bf16-resident query-vs-corpus")
    print(f"dryrun_multichip({n}): bf16-RESIDENT sharded search OK (ring + staged "
          f"query-vs-corpus == cosine-domain oracle, repairs forced)")

    q = _unit_rows(rng, 9, dim)
    scores, _ = sharded_topk_search(q, emb, k, devices)
    q_sims = q @ emb.T
    np.testing.assert_allclose(scores.cpu().numpy(),
                               np.take_along_axis(q_sims, np.argsort(-q_sims, axis=1)[:, :k],
                                                  axis=1), atol=1e-5)
    print(f"dryrun_multichip({n}): sharded query-vs-corpus search OK "
          f"(9 queries x {n_emb}-corpus over {n} shards)")


def _replicas(model: torch.nn.Module, devices: List[torch.device]) -> Dict:
    """The model on each distinct device of the list."""
    home = next(model.parameters()).device
    return {d: model if d == home else copy.deepcopy(model).to(d) for d in set(devices)}


def _split(n_rows: int, devices: List[torch.device]):
    """(device, rows) of each device's equal share of n_rows."""
    per = n_rows // len(devices)
    return [(d, slice(i * per, (i + 1) * per)) for i, d in enumerate(devices)]


def _extraction_program(model, devices: List[torch.device], n: int) -> None:
    """Program 5: forward_flat of 2 n videos, each device's rows on it."""
    eb = 2 * n
    rng = np.random.default_rng(SEED + 9)
    flat = torch.from_numpy(rng.random((eb * T, HW, HW, 3), dtype=np.float32))
    mask = torch.ones((eb, T), dtype=torch.bool)
    models = _replicas(model, devices)
    with torch.no_grad(), full_fp32():
        parts = [models[d].forward_flat(flat[rows.start * T:rows.stop * T].to(d),
                                        rows.stop - rows.start, mask[rows].to(d)).cpu()
                 for d, rows in _split(eb, devices)]
        one = model.forward_flat(flat.to(devices[0]), eb, mask.to(devices[0])).cpu()
    np.testing.assert_allclose(torch.cat(parts).numpy(), one.numpy(), rtol=1e-5, atol=1e-5)
    print(f"dryrun_multichip({n}): DP extraction OK ({eb} videos sharded over {n} devices "
          f"== single-device)")


def _validation_program(model, devices: List[torch.device], n: int) -> None:
    """Program 6: a partial validation batch padded by wraparound, each
    device's rows evaluated, the padding sliced back out."""
    true_b = max(1, n - 2)
    padded_b = pad_to_multiple(true_b, n)
    if padded_b == true_b:
        raise AssertionError("the partial batch must pad")
    rng = np.random.default_rng(SEED + 11)
    val = {"clip1": rng.random((true_b, T, HW, HW, 3), dtype=np.float32),
           "clip2": rng.random((true_b, T, HW, HW, 3), dtype=np.float32),
           "video_id": np.arange(true_b, dtype=np.int64),
           "mask1": np.ones((true_b, T), bool), "mask2": np.ones((true_b, T), bool)}
    padded = wraparound_pad_batch(val, padded_b)
    draws = train_step.draw_extracts(torch.Generator().manual_seed(SEED + 12), padded_b, T,
                                     EXTRACT_RATIO)
    models = _replicas(model, devices)
    emb1, emb2, losses = [], [], []
    for d, rows in _split(padded_b, devices):
        batch = {k: torch.from_numpy(v[rows]).to(d) for k, v in padded.items()
                 if k != "video_id"}
        with full_fp32():
            metrics, e1, e2 = train_step.make_eval_step(models[d], "attention")(
                batch, _to({k: v[rows] for k, v in draws.items()}, d))
        emb1.append(e1.cpu().numpy())
        emb2.append(e2.cpu().numpy())
        losses.append(float(metrics["loss"]))
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite eval loss {losses}")
    e1 = slice_replicated_blocks(np.concatenate(emb1), 1, padded_b, true_b)
    e2 = slice_replicated_blocks(np.concatenate(emb2), 1, padded_b, true_b)
    ids = slice_replicated_blocks(padded["video_id"], 1, padded_b, true_b)
    one = {k: torch.from_numpy(v).to(devices[0]) for k, v in val.items() if k != "video_id"}
    with full_fp32():
        _, o1, o2 = train_step.make_eval_step(model, "attention")(
            one, _to({k: v[:true_b] for k, v in draws.items()}, devices[0]))
    np.testing.assert_allclose(e1, o1.cpu().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(e2, o2.cpu().numpy(), rtol=1e-5, atol=1e-5)

    chk = np.random.default_rng(5)  # the block layout of a multi-process run
    for nprocs in (1, 2, 4):
        tb, pb = 3, 4
        rows = chk.normal(size=(nprocs * tb, 16)).astype(np.float32)
        blocks = [wraparound_pad_batch({"e": rows[p * tb:(p + 1) * tb]}, pb)["e"]
                  for p in range(nprocs)]
        np.testing.assert_array_equal(
            slice_replicated_blocks(np.concatenate(blocks), nprocs, pb, tb), rows)

    emb_all = torch.from_numpy(np.concatenate([e1, e2]))
    ids_all = torch.from_numpy(np.concatenate([ids, ids]))
    metrics = {**retrieval_metrics(emb_all, ids_all), **discrimination_metrics(emb_all, ids_all)}
    if not (np.isfinite(metrics["auc_roc"]) and np.isfinite(metrics["mAP"])):
        raise AssertionError(f"non-finite validation metrics {metrics}")
    print(f"dryrun_multichip({n}): partial-batch eval OK (true_b={true_b} wraparound-padded "
          f"to {padded_b}: sliced embeddings == single-device, block layout exact for "
          f"nprocs=1/2/4, metrics finite: auc_roc={metrics['auc_roc']:.3f})")


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> None:
    """The JAX body's programs over `n_devices` devices: `devices` (a list
    of n_devices, which may repeat one device), or cuda:0 repeated. Raises
    on the first program that fails its oracle."""
    if n_devices < 2:
        raise ValueError(f"a multi-device dry run needs n_devices >= 2, got {n_devices}")
    devs = as_devices(devices if devices is not None else ["cuda:0"] * n_devices)
    if len(devs) != n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(devs)}")

    inputs = _train_inputs(n_devices)
    oracle = {"plain": _one_step(devs[0], inputs, False),
              "device_augment": _one_step(devs[0], inputs, True)}
    ranks = _spawn_ranks(devs, inputs)
    loss = _check_step("plain", ranks, oracle["plain"])
    print(f"dryrun_multichip({n_devices}): one DP train step OK, loss={loss:.4f} "
          f"(one device {oracle['plain']['loss']:.4f})")
    loss = _check_step("device_augment", ranks, oracle["device_augment"])
    print(f"dryrun_multichip({n_devices}): DP train step with device_augment OK, "
          f"loss={loss:.4f}")

    _topk_programs(devs, n_devices)
    model = _seeded_model(devs[0]).eval()
    _extraction_program(model, devs, n_devices)
    _validation_program(model, devs, n_devices)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args.rank, args.world, Path(args.workdir))
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry forward:", tuple(out.shape), float(out[0, 0]))
    dev = "cuda:0" if resolve_device(args.device).type == "cuda" else "cpu"
    dryrun_multichip(MAIN_DEVICES, [dev] * MAIN_DEVICES)
    return 0


if __name__ == "__main__":
    sys.exit(main())

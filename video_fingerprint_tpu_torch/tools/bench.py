"""The benchmark program of the port: fingerprint extraction videos/sec on
one card, then training, the end-to-end scan and the duplicate search.

Port of bench.py. Every leg runs as a subprocess with its own timeout and
prints a cumulative JSON line after each of its stages; the orchestrator
reads the last line it can parse, and on a timeout still reads what the leg
printed (`_run_leg`). It prints its own cumulative line after each leg, the
headline first:

  1. the reference baseline (tools/bench_torch_baseline.py, run from the
     checkout --reference_dir names; cached in .bench_cache/ once measured;
     without the flag it is -1, and then vs_baseline is -1);
  2. the headline (tools/bench_headline.py): "fingerprint extraction
     throughput (attention, T=128, 64x64)" in videos/sec/chip, whose value
     is the CUDA-graph replay rate. There is no fallback: if graph replay
     fails, the headline fails and the orchestrator exits 1;
  3. training steps/s (tools/bench_train.py), dispatched regime;
  4. the end-to-end scan with decode (tools/bench_scan_e2e.py): with the
     native decoder where utils/native_decode.py builds, and with cv2. Where
     the native decoder does not build, its reason is written to
     e2e_native_decode_error (the native leg is not run, and not counted as
     skipped) and the cv2 leg is the number of record (the line says which);
  5. the duplicate search at N = 10^5, k = 20 on a planted corpus, per
     top-k method, each verified (tools/bench_dedup.py --planted --verify).

A leg that ran and failed (exit code, timeout, no line) is named in
`failed_legs` and makes the exit code 1; a leg the budget no longer covers
is named in `skipped_legs`. The budget is --budget seconds (default 840),
kept by the legs' timeouts and an alarm.

    python -m video_fingerprint_tpu_torch.tools.bench [--budget S]
        [--reference_dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CACHE_FILE = REPO / ".bench_cache" / "torch_baseline.json"
E2E_CACHE_DIR = REPO / ".bench_cache" / "torch_e2e"
LEG = "video_fingerprint_tpu_torch.tools."
METRIC = "fingerprint extraction throughput (attention, T=128, 64x64)"
REGIME = "cuda graph replay"
E2E_ARGS = ["--videos", "60", "--frames", "96", "--workers", "8",
            # random weights put distinct synthetic videos at cosine
            # 0.95-0.9995; only a threshold above that isolates the copies
            "--threshold", "0.9999", "--cache-dir", str(E2E_CACHE_DIR)]
DEDUP_N = 100_000
DEDUP_METHODS = (("exact", "exact", None), ("certified", "certified", None),
                 ("certified_thr", "certified", 0.95),
                 ("certified_bf16_thr", "certified-bf16", 0.95))
TRAIN_PREFIXES = ("train_", "t512_", "b8_t512", "b64_", "card_memory_gb")


def _text(x) -> str:
    return (x or b"").decode() if isinstance(x, bytes) else (x or "")


def _run_leg(cmd, timeout: float) -> tuple[dict, str | None]:
    """Run one leg; return (its last parseable stdout JSON line, or {}; None
    when it ran to exit code 0, else what went wrong). A timeout of 10 s or
    less runs nothing and returns ({}, "skipped")."""
    if timeout <= 10:
        return {}, "skipped"
    try:
        out = subprocess.run([sys.executable, *cmd], capture_output=True, text=True,
                             timeout=timeout, cwd=REPO)
        stdout, stderr = out.stdout or "", out.stderr or ""
        fault = None if out.returncode == 0 else f"rc={out.returncode}"
    except subprocess.TimeoutExpired as e:
        # what the leg printed before its timeout: its cumulative lines
        stdout, stderr = _text(e.stdout), _text(e.stderr)
        fault = f"timeout after {timeout:.0f}s"
    except OSError as e:
        return {}, f"failed to start: {e}"
    tail = stderr.strip().splitlines()[-1:]
    if fault:
        print(f"# leg {cmd[-1] if cmd[0] == '-m' else cmd[0]} {fault}: {tail}",
              file=sys.stderr, flush=True)
    for line in reversed(stdout.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line), fault
            except json.JSONDecodeError:
                continue  # cut mid-write at the timeout
    return {}, fault or "no JSON line"


def _e2e_projection(headline_vps: float, e2e: dict, cores: int) -> dict:
    """Decode-bound context: the host's cores, the decode rate per core the
    e2e scan implies (workers capped at the cores), and the decode cores it
    would take to feed the card at the headline rate."""
    e2e_vps = float(e2e.get("e2e_scan_vps_with_decode", 0.0) or 0.0)
    eff_cores = max(1, min(cores, int(e2e.get("e2e_decode_workers", cores))))
    if e2e_vps <= 0 or headline_vps <= 0:
        return {}
    per_core = e2e_vps / eff_cores
    return {
        "e2e_host_cores": cores,
        "e2e_projected_vps_per_core": round(per_core, 2),
        "e2e_cores_to_saturate_chip": round(headline_vps / per_core),
    }


class Orchestrator:
    """One run of the legs under a budget, and the cumulative line."""

    def __init__(self, budget: float):
        self.budget = budget
        self.start = time.monotonic()
        self.result: dict = {}
        self.failed: list[str] = []
        self.skipped: list[str] = []
        self.seconds: dict[str, float] = {}

    def remaining(self) -> float:
        return self.budget - (time.monotonic() - self.start)

    def emit(self) -> None:
        self.result["failed_legs"] = list(self.failed)
        self.result["skipped_legs"] = list(self.skipped)
        self.result["leg_seconds"] = dict(self.seconds)
        print(json.dumps(self.result), flush=True)

    def leg(self, name: str, module: str, args, cap: float, need: float,
            reserve: float = 0.0) -> dict:
        """Run a leg with timeout min(cap, what the budget leaves after
        `reserve`); a leg left less than `need` seconds is skipped."""
        timeout = min(cap, self.remaining() - reserve)
        if timeout < need:
            timeout = 0.0
        t0 = time.monotonic()
        res, fault = _run_leg(["-m", LEG + module, *args], timeout)
        if fault != "skipped":
            self.seconds[name] = time.monotonic() - t0
        if fault == "skipped":
            self.skipped.append(name)
        elif fault:
            self.failed.append(f"{name}: {fault}")
        return res

    def on_alarm(self, signum, frame):
        self.result["error"] = "budget exhausted"
        self.failed.append("budget exhausted")
        self.emit()
        sys.exit(1)

    def baseline(self, reference_dir: str | None) -> dict:
        """The cached reference rate once measured (its weights and workload
        are fixed), else the leg's answer (-1 without the reference)."""
        if CACHE_FILE.exists():
            try:
                cached = json.loads(CACHE_FILE.read_text())
                if cached.get("reference_torch_cpu_vps", 0) > 0:
                    return cached
            except (OSError, json.JSONDecodeError):
                pass
        args = ["--reference_dir", reference_dir] if reference_dir else []
        res = self.leg("baseline", "bench_torch_baseline", args, cap=240.0, need=20.0)
        if res.get("reference_torch_cpu_vps", 0) > 0:
            CACHE_FILE.parent.mkdir(parents=True, exist_ok=True)
            CACHE_FILE.write_text(json.dumps(res))
        return res

    def headline(self, baseline: dict, extra) -> float:
        head = self.leg("headline", "bench_headline", extra, cap=900.0, need=60.0,
                        reserve=60.0)
        vps = float(head.pop("graph_vps", None) or -1.0)
        ref_vps = float(baseline.get("reference_torch_cpu_vps", -1.0) or -1.0)
        self.result.update({
            "metric": METRIC,
            "value": vps,
            "unit": "videos/sec/chip",
            "vs_baseline": vps / ref_vps if ref_vps > 0 and vps > 0 else -1.0,
            "regime": REGIME,
            "config": ("fused BN-folded bf16, pre-flattened uint8 staging, B=512, "
                       f"{REGIME}; MFU from an analytic count of products and convs "
                       "(utils/flops.py), not XLA's, so not comparable to a TPU MFU; "
                       "baseline = reference torch-CPU batch=1"),
            **head,
            **baseline,
        })
        if vps <= 0:
            self.result["error"] = "graph replay gave no rate: the headline failed"
            if not any(f.startswith("headline") for f in self.failed):
                self.failed.append("headline: no graph_vps")
        self.emit()
        return vps

    def train(self) -> None:
        train = self.leg("train", "bench_train", [], cap=480.0, need=60.0, reserve=160.0)
        self.result.update({k: v for k, v in train.items() if k.startswith(TRAIN_PREFIXES)})
        self.emit()

    def e2e(self, vps: float) -> None:
        from video_fingerprint_tpu_torch.utils import native_decode

        native = native_decode.available()
        if native:
            e2e = self.leg("e2e_native", "bench_scan_e2e", E2E_ARGS + ["--native-decode"],
                           cap=420.0, need=40.0, reserve=120.0)
            record = "native decode"
        else:
            self.result["e2e_native_decode_error"] = native_decode.LIBRARY.error
            e2e = self.leg("e2e_cv2", "bench_scan_e2e", E2E_ARGS, cap=420.0, need=40.0,
                           reserve=100.0)
            record = "cv2 decode (the native decoder did not build)"
        if e2e:
            self.result.update(e2e)
            self.result["e2e_number_of_record"] = record
            self.result.update(_e2e_projection(vps, e2e, os.cpu_count() or 1))
        self.emit()
        if native:
            cv2 = self.leg("e2e_cv2", "bench_scan_e2e", E2E_ARGS, cap=420.0, need=40.0,
                           reserve=100.0)
            if cv2.get("e2e_scan_vps_with_decode"):
                self.result["e2e_cv2_scan_vps_with_decode"] = cv2["e2e_scan_vps_with_decode"]
                self.result["e2e_cv2_planted_pairs_found"] = cv2["e2e_planted_pairs_found"]
            self.emit()

    def dedup(self) -> None:
        self.result.update({"dedup_n": DEDUP_N, "dedup_k": 20, "dedup_exact_above": 0.95})
        for name, method, thr in DEDUP_METHODS:
            args = ["--n", str(DEDUP_N), "--k", "20", "--planted", "--verify",
                    "--method", method]
            if thr is not None:
                args += ["--exact_above", str(thr)]
            res = self.leg(f"dedup_{name}", "bench_dedup", args, cap=180.0, need=20.0,
                           reserve=10.0)
            if res:
                self.result.update({f"dedup_qps_{name}": res["value"],
                                    f"dedup_search_ms_{name}": res["search_ms"],
                                    f"dedup_vs_baseline_{name}": res["vs_baseline"],
                                    f"dedup_verified_{name}": res["verified"],
                                    f"dedup_repaired_rows_{name}":
                                        res["repaired_rows_per_search"]})
            self.emit()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--budget", type=float, default=840.0, help="seconds for all legs")
    ap.add_argument("--reference_dir", default=None,
                    help="the reference checkout for the baseline leg (without it "
                         "vs_baseline is -1)")
    ap.add_argument("--save_embeddings", default=None,
                    help="passed to the headline leg: an .npz of its first videos' "
                         "frames and bf16 embeddings")
    args = ap.parse_args(argv)
    run = Orchestrator(args.budget)
    previous = signal.signal(signal.SIGALRM, run.on_alarm)
    signal.alarm(max(int(args.budget) - 5, 30))
    try:
        baseline = run.baseline(args.reference_dir)
        extra = ["--save_embeddings", args.save_embeddings] if args.save_embeddings else []
        vps = run.headline(baseline, extra)
        run.train()
        run.e2e(vps)
        run.dedup()
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
    return 0 if vps > 0 and not run.failed else 1

if __name__ == "__main__":
    sys.exit(main())

"""The port's benchmark orchestrator (video_fingerprint_tpu_torch/tools/bench.py):
the number-of-record protocol of tests/test_bench_orchestrator.py (legs print
cumulative JSON lines, the last parseable one wins, a leg past its timeout
still gives what it printed), and the port's own rules, with stub legs run
as real subprocesses: a leg that fails makes the exit code nonzero, a
failed graph replay fails the headline with no fallback, and a leg the
budget does not cover is named in skipped_legs."""

import json
import textwrap

import pytest

from video_fingerprint_tpu_torch.tools import bench
from video_fingerprint_tpu_torch.utils import native_decode


def _leg(tmp_path, body: str) -> str:
    p = tmp_path / "leg.py"
    p.write_text(textwrap.dedent(body))
    return str(p)


def test_run_leg_parses_last_json_line(tmp_path):
    leg = _leg(tmp_path, """
        import json
        print("# progress noise")
        print(json.dumps({"pipelined_vps": 1.0}))
        print(json.dumps({"pipelined_vps": 1.0, "graph_vps": 2.0}))
    """)
    assert bench._run_leg([leg], timeout=30) == ({"pipelined_vps": 1.0, "graph_vps": 2.0},
                                                 None)


def test_run_leg_salvages_stdout_on_timeout(tmp_path):
    leg = _leg(tmp_path, """
        import json, sys, time
        print(json.dumps({"pipelined_vps": 123.0}), flush=True)
        sys.stdout.flush()
        time.sleep(60)
    """)
    out, fault = bench._run_leg([leg], timeout=12)
    assert out == {"pipelined_vps": 123.0}
    assert fault.startswith("timeout")


def test_run_leg_skips_truncated_json_tail(tmp_path):
    leg = _leg(tmp_path, """
        import json, sys, time
        print(json.dumps({"pipelined_vps": 5.0}), flush=True)
        sys.stdout.write('{"graph_vps": 9')  # truncated, no newline
        sys.stdout.flush()
        time.sleep(60)
    """)
    out, fault = bench._run_leg([leg], timeout=12)
    assert out == {"pipelined_vps": 5.0} and fault.startswith("timeout")


def test_run_leg_no_json_returns_empty(tmp_path):
    leg = _leg(tmp_path, "print('no json here')")
    assert bench._run_leg([leg], timeout=30) == ({}, "no JSON line")


def test_run_leg_tiny_timeout_skips(tmp_path):
    leg = _leg(tmp_path, "print('{}')")
    assert bench._run_leg([leg], timeout=5) == ({}, "skipped")


def test_e2e_projection_fields():
    e2e = {"e2e_scan_vps_with_decode": 20.0, "e2e_decode_workers": 8}
    out = bench._e2e_projection(11000.0, e2e, cores=1)
    assert out["e2e_host_cores"] == 1
    assert out["e2e_projected_vps_per_core"] == 20.0  # 8 workers, 1 core
    assert out["e2e_cores_to_saturate_chip"] == 550
    out = bench._e2e_projection(11000.0, e2e, cores=16)
    assert out["e2e_projected_vps_per_core"] == 2.5  # 8 workers really run
    assert bench._e2e_projection(0.0, e2e, 4) == {}
    assert bench._e2e_projection(100.0, {}, 4) == {}


# Stub legs: each prints what the real leg prints (a few keys), then exits
# with the code the case gives it.
_STUBS = {
    "bench_torch_baseline": {"reference_torch_cpu_vps": -1.0},
    "bench_headline": {"pipelined_vps": 90.0, "graph_vps": 100.0,
                       "mfu_vs_h100_bf16_peak": 0.25, "k1_launches_per_forward": 4},
    "bench_train": {"train_steps_per_sec_b64_t64_bf16_dispatched": 12.0,
                    "t512_fits_hbm_without_remat": True, "device": "stub"},
    "bench_scan_e2e": {"e2e_scan_vps_with_decode": 20.0, "e2e_decode_workers": 8,
                       "e2e_planted_pairs": 12, "e2e_planted_pairs_found": 12},
    "bench_dedup": {"value": 1000.0, "search_ms": 100.0, "vs_baseline": 50.0,
                    "verified": "strict", "repaired_rows_per_search": 0.0},
}


@pytest.fixture()
def stub_legs(tmp_path, monkeypatch):
    """The orchestrator pointed at a package of stub legs under tmp_path;
    returns a function that writes them (rcs: leg -> exit code; drop: legs
    whose line leaves out these keys)."""
    pkg = tmp_path / "stub_legs"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    monkeypatch.setattr(bench, "REPO", tmp_path)
    monkeypatch.setattr(bench, "LEG", "stub_legs.")
    monkeypatch.setattr(bench, "CACHE_FILE", tmp_path / "cache" / "baseline.json")
    monkeypatch.setattr(native_decode, "available", lambda: False)

    def write(rcs=None, drop=None):
        for name, line in _STUBS.items():
            line = {k: v for k, v in line.items() if k not in (drop or {}).get(name, ())}
            (pkg / f"{name}.py").write_text(
                f"import json, sys\nprint(json.dumps({line!r}))\n"
                f"sys.exit({(rcs or {}).get(name, 0)})\n")
    return write


def _last_line(capsys) -> dict:
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    return json.loads(lines[-1])


def test_all_legs_pass(stub_legs, capsys):
    stub_legs()
    assert bench.main(["--budget", "600"]) == 0
    out = _last_line(capsys)
    assert out["metric"] == bench.METRIC and out["unit"] == "videos/sec/chip"
    assert out["regime"] == "cuda graph replay" and out["value"] == 100.0
    assert out["vs_baseline"] == -1.0
    assert out["failed_legs"] == []
    # the native decoder is unavailable: said so, and cv2 is the record;
    # a leg that cannot run is not one the budget skipped
    assert out["skipped_legs"] == []
    assert "e2e_native_decode_error" in out
    assert out["e2e_number_of_record"].startswith("cv2")
    assert out["e2e_cores_to_saturate_chip"] > 0
    assert out["train_steps_per_sec_b64_t64_bf16_dispatched"] == 12.0
    assert "device" not in out  # only the train leg's own keys are taken
    for name, _, _ in bench.DEDUP_METHODS:
        assert out[f"dedup_qps_{name}"] == 1000.0


def test_failing_leg_gives_nonzero_exit(stub_legs, capsys):
    stub_legs(rcs={"bench_train": 1})
    assert bench.main(["--budget", "600"]) == 1
    out = _last_line(capsys)
    assert out["failed_legs"] == ["train: rc=1"]
    assert out["value"] == 100.0  # the headline stands; the run still fails


def test_graph_replay_failure_fails_the_headline(stub_legs, capsys):
    """No fallback to pipelined dispatch: the headline's value is -1 and the
    exit code nonzero when graph replay gave no rate."""
    stub_legs(rcs={"bench_headline": 1}, drop={"bench_headline": ("graph_vps",)})
    assert bench.main(["--budget", "600"]) == 1
    out = _last_line(capsys)
    assert out["value"] == -1.0 and out["regime"] == "cuda graph replay"
    assert out["pipelined_vps"] == 90.0
    assert out["failed_legs"][0] == "headline: rc=1"


def test_skipped_leg_is_named(stub_legs, capsys):
    """A budget that covers the headline but not the train leg's reserve:
    the train leg is skipped and named; a skip is not a failure."""
    stub_legs()
    assert bench.main(["--budget", "150"]) == 0
    out = _last_line(capsys)
    assert "train" in out["skipped_legs"]
    assert out["failed_legs"] == []
    assert "train_steps_per_sec_b64_t64_bf16_dispatched" not in out


def test_reference_dir_reaches_the_baseline_leg(stub_legs, tmp_path, capsys):
    """The baseline leg runs only the reference checkout it is given; its
    measured rate gives vs_baseline and is cached."""
    stub_legs()
    (tmp_path / "stub_legs" / "bench_torch_baseline.py").write_text(
        "import json, sys\n"
        "rate = 50.0 if sys.argv[1:] == ['--reference_dir', 'REF'] else -1.0\n"
        "print(json.dumps({'reference_torch_cpu_vps': rate}))\n")
    assert bench.main(["--budget", "600", "--reference_dir", "REF"]) == 0
    assert _last_line(capsys)["vs_baseline"] == 2.0
    assert json.loads(bench.CACHE_FILE.read_text())["reference_torch_cpu_vps"] == 50.0

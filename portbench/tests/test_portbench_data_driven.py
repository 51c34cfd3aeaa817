"""A configuration, a traffic mix, a cell and a per-layer metric are new
files and entries, found by name without editing a file; and the result
line holds exactly the contract's keys."""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny


def test_new_config_traffic_cell_and_metric_are_found_by_name(tmp_path):
    bench = tiny.make(tmp_path)
    pdir = tmp_path / "portbench"
    (pdir / "configs" / "tiny_store_two.json").write_text(json.dumps({**tiny.STORE, "splitter_max_tokens": 30}))
    (pdir / "traffic" / "tiny_backlog_short.json").write_text(json.dumps({**tiny.BACKLOG, "words_median": 30}))
    (pdir / "limits" / "tiny_new_cell.json").write_text(json.dumps(tiny.INGEST_LIMITS))
    (pdir / "metrics" / "encode_calls.new.py").write_text(
        "def read(obs):\n    return float(len(obs['probe'].of('encode', obs['window'])))\n")
    bench["configs"].append({"name": "tiny_store_two", "source": "test", "file": "portbench/configs/tiny_store_two.json",
                             "reduced": [], "why": "test"})
    cell = {"name": "tiny_new_cell", "config": "tiny_store_two", "traffic": "tiny_backlog_short", "chips": 1, "why": "t"}
    bench["workloads"].append(cell)
    bench["per_layer"].append({"name": "encode_calls.new", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "encoder step", "moves": "ingest_chunks_per_s",
                               "workloads": ["tiny_new_cell"]})
    bench["end_to_end"][0]["workloads"].append("tiny_new_cell")
    res = harness.run_cell(bench, cell, 11, 1.5, True, device="cpu", reference_device="cpu", root=tmp_path)
    assert res["correct"], res["checks"]
    assert res["metrics"]["encode_calls.new"]["value"] > 0
    untraced = harness.run_cell(bench, cell, 12, 1.0, False, device="cpu", reference_device="cpu", root=tmp_path)
    assert set(untraced["metrics"]) == {"ingest_chunks_per_s", "setup_s"}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(harness, "power_limit", lambda: "700.00 W")
    res = {"correct": True, "attempted": 3, "failed": 0, "metrics": {"setup_s": {"value": 1.0, "unit": "s"}},
           "memory_peak_bytes": 10, "checks": [{"name": "x", "value": 0.0, "limit": 1.0}],
           "trace": {"busy_s": 1.0, "window_s": 2.0, "device_ops": [["k", 1.0]], "idle_gaps": [["h", 0.5]],
                     "ambiguous_kernel_s": 0.0, "range_threads": 1, "range_kernel_s": {}, "launches": 1}}
    assert harness.emit(res, {"chips": 1}, trace) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert ("busy_s" in line["device"]) == trace
    assert line["checks"] == {"x": {"value": 0.0, "limit": 1.0}}
    assert out.err.strip().splitlines()[-1].startswith("check x:")


def test_without_a_card_no_result_and_a_failing_code(tmp_path):
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "bge_ingest_backlog", "--seed",
                          str(2**31 + 3), "--seconds", "1", "--trace", "0"], cwd=harness.HERE.parent,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert not res.stdout.strip()


def test_a_checkout_of_only_the_benchmark_fails(tmp_path):
    import shutil

    shutil.copytree(harness.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "bge_ingest_backlog", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert not res.stdout.strip()


def test_the_limits_file_says_what_is_compared(tiny_root, tmp_path):
    import shutil

    root, bench = tiny_root
    copy = tmp_path / "copy"
    shutil.copytree(root, copy)
    limits = copy / "portbench" / "limits" / "tiny_ingest.json"
    data = json.loads(limits.read_text())
    data["embedding_l2_max"] = 1.0
    limits.write_text(json.dumps(data))
    res = harness.run_cell(bench, tiny.workload(bench, "tiny_ingest"), 13, 1.0, False, device="cpu",
                           reference_device="cpu", root=copy)
    assert [c["name"] for c in res["checks"]] == list(data)
    assert "embedding_l2_max" not in res["readings"] and "embedding_l2_mean" in res["readings"]
    data["no_such_number"] = 0
    limits.write_text(json.dumps(data))
    with pytest.raises(KeyError):
        harness.run_cell(bench, tiny.workload(bench, "tiny_ingest"), 13, 1.0, False, device="cpu",
                         reference_device="cpu", root=copy)

"""The benchmark is driven by data: every cell resolves to its files by
name, names and units keep to their characters, each per-layer metric's
`moves` is reported where the metric is, and a new metric file and a new
cell are found without editing a file that exists. A file with a key the
harness would not read, a loop it does not run, or a width the port does
not build is refused. Without a card, or without the program beside it,
run.py prints no result and exits non-zero."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import registry

SPEC = registry.load_spec()
NAMES = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("workload", NAMES)
def test_cell_resolves_to_its_files(workload):
    cell = registry.cell(SPEC, workload)
    w = cell["workload"]
    assert cell["config"]["name"] == w["config"]
    assert registry.traffic_file(w["traffic"]).exists()
    assert (registry.BENCH / "limits" / f"{workload}.json").exists()
    for m in cell["per_layer"]:
        reader = registry.load_metric(m["name"])
        assert reader.UNIT == m["unit"] and callable(reader.read)
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s", "frames_per_s"}
    assert cell["per_layer"]


def test_names_and_units_keep_to_their_characters():
    names = ([c["name"] for c in SPEC["configs"]] + NAMES
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
             + [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    assert all(registry.NAME.match(n) for n in names), names
    assert all(registry.UNIT.match(m["unit"]) for m in SPEC["end_to_end"] + SPEC["per_layer"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_where_the_metric_is(metric):
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    moved = e2e[metric["moves"]]
    for workload in metric["workloads"]:
        assert workload in moved.get("workloads", NAMES)


def test_a_new_metric_and_cell_are_found_without_edits(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(registry.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    (root / "benchmark" / "metrics" / "calls_seen.py").write_text(
        'UNIT = "calls"\n\n\ndef read(ctx):\n    return float(ctx.calls)\n')
    (root / "benchmark" / "traffic" / "cvo6-batch4.json").write_text(
        json.dumps(dict(json.loads(registry.traffic_file("cvo6").read_text()), batch=4)))
    spec["workloads"].append({"name": "accgma-cvo6-b4", "config": "accgma",
                              "traffic": "cvo6-batch4", "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "calls_seen", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "graphs",
                              "moves": "frames_per_s", "workloads": ["accgma-cvo6-b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    cell = registry.cell(registry.load_spec(root), "accgma-cvo6-b4", root)
    assert cell["traffic"]["batch"] == 4 and cell["config"]["name"] == "accgma"
    assert [m["name"] for m in cell["per_layer"]] == ["calls_seen"]
    assert registry.load_metric("calls_seen", root).read(type("C", (), {"calls": 3})()) == 3.0
    for path, data in before.items():
        assert path.read_bytes() == data


REFUSED = {
    "an unread traffic key": ("traffic", None, {"arrival_rate": 10}),
    "an open loop": ("traffic", None, {"loop": "open"}),
    "two clients": ("traffic", None, {"clients": 2}),
    "an unread configuration key": ("config", None, {"dropout": 0.1}),
    "an unread estimator key": ("config", "estimator", {"mixed_precision": True}),
    "a bfloat16 flow state": ("config", None, {"flow_dtype": "bfloat16"}),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_a_file_the_harness_would_not_read_whole_is_refused(case, tmp_path):
    kind, group, change = REFUSED[case]
    root = tmp_path / "checkout"
    shutil.copytree(registry.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(registry.ROOT / "BENCHMARK.json", root)
    path = (registry.traffic_file("cvo6", root) if kind == "traffic"
            else root / "benchmark" / "configs" / "accraft.json")
    data = json.loads(path.read_text())
    (data[group] if group else data).update(change)
    path.write_text(json.dumps(data))
    with pytest.raises((KeyError, ValueError)):
        registry.cell(registry.load_spec(root), "accraft-cvo6", root)


@pytest.mark.parametrize("key", ["feature_dim", "hidden_dim", "context_dim"])
def test_a_width_the_port_does_not_build_is_refused(key):
    import torch

    from benchmark.harness import system

    config = registry.cell(SPEC, "accraft-cvo6")["config"]
    config["estimator"][key] //= 2
    with pytest.raises(ValueError, match=key):
        system.build(config, 1, torch.device("cpu"))


def _run(cwd: Path, env_extra: dict):
    import os

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **env_extra}
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "accraft-cvo6",
                           "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_refuses_without_a_card():
    proc = _run(registry.ROOT, {})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_run_fails_with_only_the_benchmark(tmp_path):
    shutil.copytree(registry.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path)
    proc = _run(tmp_path, {"PYTHONPATH": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""

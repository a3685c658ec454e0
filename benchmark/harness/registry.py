"""The benchmark's registry: BENCHMARK.json at the root of the checkout, and
the files it names, found by name:

- a configuration: the `file` of its `configs` entry (benchmark/configs/);
- a traffic mix: benchmark/traffic/<traffic>.json, read by the one general
  generator (harness/traffic.py) that its `generator` key names;
- a per-layer metric: benchmark/metrics/<name>.py, a reader with `UNIT`
  and `read(ctx)` (harness/profile.py gives it the traced run);
- a cell: a `workloads` entry naming one configuration, one traffic mix
  and its `chips` (N > 1 splits the frame height over N cards), with its
  limit on `correct` in benchmark/limits/<workload>.json
  (harness/compare.py).

Adding any of them is adding a file and an entry; nothing here changes.
A configuration or traffic file with a key the harness does not read, or
a loop it does not run, is refused by name (`check_files`); the widths
are held to the port's build in harness/system.py.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
GENERATORS = ("moving_clips",)
# Every key a file may hold: the harness reads each one, or refuses the
# file (a key it would pass over silently would run the port's default).
CONFIG_KEYS = {"name", "source", "model", "compute_dtype", "flow_dtype", "estimator",
               "accumulator", "widened", "reduced", "assumed"}
ESTIMATOR_KEYS = {"family", "feature_dim", "hidden_dim", "context_dim", "corr_levels",
                  "corr_radius", "iters", "attention_heads", "dim_head", "attention",
                  "attn_chunk", "corr_lookup"}
ACCUMULATOR_KEYS = {"hidden", "direction", "path"}
TRAFFIC_KEYS = {"generator", "frames", "batch", "height", "width", "max_velocity",
                "velocity_period", "pool", "loop", "clients", "warmup_calls", "compared_clips"}


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def traffic_file(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "traffic" / f"{name}.json"


def metric_file(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "metrics" / f"{name}.py"


def cell(spec: dict, workload: str, root: Path = ROOT) -> dict:
    """Everything one run of `workload` needs: the workload entry, its
    configuration and traffic (parsed), and the metrics it reports, each
    end-to-end and per-layer entry whose `workloads` (if any) name it.
    KeyError names what is missing."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(traffic_file(w["traffic"], root).read_text())
    if traffic.get("generator") not in GENERATORS:
        raise KeyError(f"traffic {w['traffic']!r} names generator {traffic.get('generator')!r}; "
                       f"the harness has {GENERATORS}")
    check_files(w, config, traffic)

    def mine(m):
        return workload in m.get("workloads", [workload])

    return dict(workload=w, config=config, traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"] if mine(m)],
                per_layer=[m for m in spec["per_layer"] if mine(m)])


def _unread(what: str, found: dict, known: set) -> None:
    extra = sorted(set(found) - known)
    if extra:
        raise KeyError(f"{what} holds {extra}, which the harness does not read")


def check_files(w: dict, config: dict, traffic: dict) -> None:
    """Refuse a configuration or traffic file with a key the harness would
    not read, or a value it cannot serve: the loop is closed with one
    client, and the flow state float32 as the port keeps it."""
    _unread(f"configuration {w['config']!r}", config, CONFIG_KEYS)
    _unread(f"configuration {w['config']!r}'s estimator", config["estimator"], ESTIMATOR_KEYS)
    _unread(f"configuration {w['config']!r}'s accumulator", config["accumulator"],
            ACCUMULATOR_KEYS)
    _unread(f"traffic {w['traffic']!r}", traffic, TRAFFIC_KEYS)
    if config["model"] != "accflow" or config["flow_dtype"] != "float32":
        raise ValueError(f"configuration {w['config']!r}: the harness serves model 'accflow' "
                         f"with a float32 flow state, not {config['model']!r} with "
                         f"{config['flow_dtype']!r}")
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError(f"traffic {w['traffic']!r}: the harness runs a closed loop with one "
                         f"client, not {traffic['loop']!r} with {traffic['clients']!r}")


def load_metric(name: str, root: Path = ROOT):
    """The reader module of per-layer metric `name`."""
    path = metric_file(name, root)
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

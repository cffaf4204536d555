"""What a run reads from the files: ``BENCHMARK.json`` at the checkout's
root, and the files of a cell's configuration, traffic mix, per-layer
metrics and pipeline stages, each found by its name.

* a configuration: ``BENCHMARK.json``'s ``configs[].file`` (JSON: the
  ``MusicaConfig`` fields under ``fields``);
* a traffic mix: ``benchmark/traffic/<traffic>.json``, read by the one
  generator in ``harness/traffic.py``;
* a per-layer metric: ``benchmark/metrics/<name>.py``, a module with
  ``read(trace) -> float or None``;
* a stage: ``benchmark/stages/<stage>.json`` (the kernel labels it owns,
  as regular expressions) and ``benchmark/stages/<stage>.py``
  (``bytes_per_image(cfg)``, the bytes its work must move).

Nothing here names a cell, a configuration or a metric: a later change
adds one by adding its files and its entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(has: {', '.join(w['name'] for w in spec['workloads'])})")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration file's contents (``fields``, ``source``, ...)."""
    for c in spec["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "traffic" / f"{name}.json")


def metrics_of(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    ``--trace``, the per-layer ones with it; a metric with a ``workloads``
    key only in the cells it lists."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def _module(path: Path, name: str) -> ModuleType:
    mod_spec = importlib.util.spec_from_file_location(name, path)
    if mod_spec is None or mod_spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return _module(bench_dir / "metrics" / f"{name}.py", f"benchmark_metric_{name}")


def stage_bytes(stage: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return _module(bench_dir / "stages" / f"{stage}.py", f"benchmark_stage_{stage}")


def stage_table(bench_dir: Path = BENCH_DIR) -> Dict[str, List[re.Pattern]]:
    """{stage: [kernel label patterns]} from every ``stages/*.json``."""
    table = {}
    for path in sorted((bench_dir / "stages").glob("*.json")):
        table[path.stem] = [re.compile(p) for p in load_json(path)["kernels"]]
    return table


def peaks(bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "peaks.json")

"""The benchmark's files against its contract: ``BENCHMARK.json``'s keys,
names, units and lengths, every cell's files found by name, and a
configuration, a traffic mix, a per-layer metric and a stage added as new
files only, found and run without an edit to any existing file."""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import spec, trace as trace_mod  # noqa: E402
from benchmark.harness.traffic import Mix, requests  # noqa: E402
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import (  # noqa: E402
    MusicaConfig)

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
FILE = re.compile(r"^[A-Za-z0-9_.-]+$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    assert BENCH["command"][1] == "benchmark/run.py"
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    cells = len(BENCH["workloads"])
    n_runs = 2 + 14 * 24
    assert n_runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    assert len(names) == len(set(names))
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"]) and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_keys_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m["name"] for m in spec.metrics_of(BENCH, cell, trace=False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics_of(BENCH, cell, trace=True)


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        conf = spec.config(BENCH, w["config"])
        MusicaConfig(**conf["fields"])
        Mix.from_json(spec.traffic(w["traffic"]))
        assert (spec.BENCH_DIR / "limits" / f"{w['name']}.json").is_file()
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)
    for stage in spec.stage_table():
        assert spec.stage_bytes(stage).bytes_per_image(MusicaConfig()) > 0


def test_configs_hold_every_field_as_run():
    names = {f.name for f in dataclasses.fields(MusicaConfig)}
    for c in BENCH["configs"]:
        conf = spec.load_json(ROOT / c["file"])
        assert set(conf["fields"]) == names
        assert conf["source"] == c["source"]
    default = spec.config(BENCH, "cli-default")["fields"]
    assert MusicaConfig(**default) == MusicaConfig()
    variant = spec.config(BENCH, "clahe-linear")["fields"]
    assert MusicaConfig(**variant) == MusicaConfig(enable_clahe=True, grad_with_linear_image=True)


def test_file_names_use_name_characters():
    for dirpath, _, files in os.walk(spec.BENCH_DIR):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            assert FILE.match(f), f


def test_traffic_cycles_are_the_same_work_in_another_order():
    mix = Mix.from_json(spec.traffic("study"))
    per_cycle = sum(mix.cycle.values())
    a = [r for _, r in zip(range(3 * per_cycle), requests(mix, 1))]
    b = [r for _, r in zip(range(3 * per_cycle), requests(mix, 1))]
    c = [r for _, r in zip(range(3 * per_cycle), requests(mix, 2))]
    assert a == b and a != c
    for i in range(3):
        cyc = lambda rs: sorted(k for _, k in rs[i * per_cycle:(i + 1) * per_cycle])  # noqa: E731
        assert cyc(a) == cyc(c) == sorted(k for k, n in mix.cycle.items() for _ in range(n))
    assert all(0 <= s <= mix.pool_images - k for s, k in a + c)


NEW_METRIC = '''"""A metric added as a file: the share of the device's busy time in kernels."""


def read(trace):
    busy = sum(trace.busy_s(d) for d in trace.devices)
    return 100.0 * trace.kernel_s() / busy if busy else None
'''

NEW_STAGE_BYTES = '''def bytes_per_image(cfg):
    return 8 * cfg.image_size ** 2
'''


def _add_cell_as_files(tree: Path) -> None:
    """A configuration, a traffic mix, a metric and a stage added to the
    copy ``tree`` as new files and new entries in its BENCHMARK.json."""
    b = tree / "benchmark"
    fields = spec.config(BENCH, "cli-default")["fields"]
    (b / "configs" / "no-quirks.json").write_text(json.dumps(
        {"source": "test", "fields": dict(fields, quirks=False), "reduced": []}))
    (b / "traffic" / "pairs.json").write_text(json.dumps(
        {"entry": "resident", "pool": "device", "pool_images": 4, "cycle": {"2": 1, "1": 2},
         "dose": [20000.0, 30000.0], "sample_requests": 1, "trace_requests": 2}))
    (b / "metrics" / "kernel_share_pct.py").write_text(NEW_METRIC)
    (b / "stages" / "tonemap.json").write_text(json.dumps({"kernels": ["\\btone_map_kernel<"]}))
    (b / "stages" / "tonemap.py").write_text(NEW_STAGE_BYTES)
    (b / "limits" / "no-quirks.pairs.json").write_text(json.dumps(
        {"u8_diff_share": 0.0001, "u8_max_diff": 1, "missing": 0}))
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "no-quirks", "source": "test",
                             "file": "benchmark/configs/no-quirks.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "no-quirks.pairs", "config": "no-quirks",
                               "traffic": "pairs", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "kernel_share_pct", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "img_per_s", "workloads": ["no-quirks.pairs"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_cell_metric_and_stage_as_files_only(tmp_path):
    tree = tmp_path / "checkout"
    tree.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", tree)
    shutil.copytree(spec.BENCH_DIR, tree / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tree / "benchmark").rglob("*") if p.is_file()}
    _add_cell_as_files(tree)
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
    b = tree / "benchmark"
    bench = spec.benchmark(tree)
    assert "kernel_share_pct" in [m["name"] for m in spec.metrics_of(bench, "no-quirks.pairs", True)]
    tr = trace_mod.Trace(images=2, window_s=1.0, devices=[0],
                         kernels=[("tone_map_kernel<true, true>", 0.0, 0.25, 0)],
                         copies=[("Memcpy DtoD (Device -> Device)", 0.5, 0.75, 0)])
    assert spec.metric_reader("kernel_share_pct", b).read(tr) == pytest.approx(50.0)
    assert "tonemap" in spec.stage_table(b)
    tr.stages, tr.cfg, tr.peak_bytes_per_s = spec.stage_table(b), MusicaConfig(image_size=64), 1e6
    tr.stage_bytes = lambda s: spec.stage_bytes(s, b)
    assert tr.roofline_pct("tonemap") == pytest.approx(100.0 * 8 * 64 ** 2 * 2 / 1e6 / 0.25)
    # the copy's own harness runs the new cell on the CPU, the port from this checkout
    code = ("import sys, time, json, torch; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from benchmark.harness import cell; "
            "r = cell.run('no-quirks.pairs', 11, 0.2, False, time.perf_counter(), "
            "devices=[torch.device('cpu')], size=96, log=lambda m: None); "
            "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code, str(tree), str(ROOT)], capture_output=True,
                         text=True, timeout=300, cwd=tree)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in spec.metrics_of(bench, "no-quirks.pairs",
                                                                         False)}
    assert {"img_per_s", "setup_s"} <= set(result["metrics"])

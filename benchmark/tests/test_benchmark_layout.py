"""The benchmark's files against its contract: ``BENCHMARK.json``'s keys,
names, units and lengths, every cell's files found by name, and a
configuration (with ``options``), a traffic mix, an entry, a per-layer
metric and a stage added as new files only, found and run without an edit
to any existing file."""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import cell, spec, trace as trace_mod  # noqa: E402
from benchmark.harness.traffic import Mix, requests  # noqa: E402
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import (  # noqa: E402
    MusicaConfig)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import (  # noqa: E402
    fused_hist)

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
        mix = Mix.from_json(spec.traffic(w["traffic"]))
        assert mix.pool in spec.entry(mix.entry).Entry.pools
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
        assert not set(conf.get("options", {})) & names
    default = spec.config(BENCH, "cli-default")["fields"]
    assert MusicaConfig(**default) == MusicaConfig()
    variant = spec.config(BENCH, "clahe-linear")["fields"]
    assert MusicaConfig(**variant) == MusicaConfig(enable_clahe=True, grad_with_linear_image=True)
    assert "options" not in spec.config(BENCH, "cli-default")
    assert "options" not in spec.config(BENCH, "clahe-linear")


def test_every_entry_loads():
    paths = sorted((spec.BENCH_DIR / "entries").glob("*.py"))
    assert {p.stem for p in paths} >= {"resident", "host", "mesh"}
    for path in paths:
        mod = spec.entry(path.stem)
        assert callable(mod.expected), path
        for attr in ("pools", "keys", "submit", "wait"):
            assert hasattr(mod.Entry, attr), (path, attr)
        assert set(mod.Entry.pools) <= {"device", "host"}
    with pytest.raises(KeyError, match="resident.py"):
        spec.entry("no-such-entry")


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


def _checkout(tmp_path: Path) -> Path:
    """A copy of BENCHMARK.json and benchmark/ (the port stays in ROOT)."""
    tree = tmp_path / "checkout"
    tree.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", tree)
    shutil.copytree(spec.BENCH_DIR, tree / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tree


def _run_in_copy(tree: Path, cell: str) -> dict:
    """The result of a run of ``cell`` by the copy's own harness on the CPU,
    the port from this checkout."""
    code = ("import sys, time, json, torch; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from benchmark.harness import cell; "
            f"r = cell.run({cell!r}, 11, 0.2, False, time.perf_counter(), "
            "devices=[torch.device('cpu')], size=96, log=lambda m: None); "
            "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code, str(tree), str(ROOT)], capture_output=True,
                         text=True, timeout=300, cwd=tree)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _unedited(tree: Path, add) -> None:
    """``add(tree)``, then every file that the copy had is as it was."""
    before = {p: p.read_bytes() for p in (tree / "benchmark").rglob("*") if p.is_file()}
    add(tree)
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_new_cell_metric_and_stage_as_files_only(tmp_path):
    tree = _checkout(tmp_path)
    _unedited(tree, _add_cell_as_files)
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
    result = _run_in_copy(tree, "no-quirks.pairs")
    assert result["correct"] and result["attempted"] > 0 and "options" not in result
    assert set(result["metrics"]) == {m["name"] for m in spec.metrics_of(bench, "no-quirks.pairs",
                                                                         False)}
    assert {"img_per_s", "setup_s"} <= set(result["metrics"])


NEW_ENTRY = '''"""An entry added as a file: each image of a request transposed, or not,
by a draw from the seed before the program sees it; the draws are the
request's note, from which ``expected`` transposes the raw again."""

import random

import torch

from benchmark.harness import entries
from benchmark.reference import musica_plain


def _turn(img, case):
    return img.t() if case else img


def expected(item, raw, fields):
    pcfg = musica_plain.PlainConfig(fields)
    for i, case in zip(range(item.start, item.start + item.count), item.note[0]):
        yield musica_plain.forward(_turn(raw(i), case), pcfg)


class Entry:
    pools = ("device",)
    keys = {"out_u8": "u8"}

    def __init__(self, prog, cfg, pool, devices, options, seed):
        self.prog, self.cfg, self.pool, self.devices = prog, cfg, pool, list(devices)
        self.options, self.products = options, ("out_u8",)
        self.rng = random.Random(f"turns:{seed}")

    def submit(self, start, count):
        cases = [self.rng.randrange(2) for _ in range(count)]
        batch = torch.stack([_turn(im, c) for im, c in zip(self.pool[start:start + count], cases)])
        return self.prog.musica.process_batch_jit(batch, self.cfg, **self.options), cases

    def wait(self):
        entries.synchronize(self.devices[:1])
'''


def _add_entry_as_files(tree: Path) -> None:
    """An entry, a configuration with ``options``, a traffic mix and the
    cell's limits added to the copy ``tree`` as new files and new entries in
    its BENCHMARK.json."""
    b = tree / "benchmark"
    conf = dict(spec.config(BENCH, "cli-default"), options={"fused_sdev": True})
    (b / "configs" / "fused-sdev.json").write_text(json.dumps(conf))
    (b / "entries" / "turned.py").write_text(NEW_ENTRY)
    (b / "traffic" / "turns.json").write_text(json.dumps(
        {"entry": "turned", "pool": "device", "pool_images": 3, "cycle": {"2": 1, "1": 1},
         "dose": [30000.0, 50000.0], "sample_requests": 2, "trace_requests": 2}))
    (b / "limits" / "fused-sdev.turns.json").write_text(json.dumps(
        {"u8_diff_share": 0, "u8_max_diff": 0, "missing": 0}))
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "fused-sdev", "source": "test",
                             "file": "benchmark/configs/fused-sdev.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "fused-sdev.turns", "config": "fused-sdev",
                               "traffic": "turns", "chips": 1, "why": "test"})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_entry_and_options_as_files_only(tmp_path):
    tree = _checkout(tmp_path)
    _unedited(tree, _add_entry_as_files)
    result = _run_in_copy(tree, "fused-sdev.turns")
    assert result["correct"] and result["attempted"] > 0, result
    assert result["options"] == {"fused_sdev": True} and list(result)[-1] == "checks"
    assert set(result["checks"]) == {"u8_diff_share", "u8_max_diff", "missing"}
    # the note is what the reference needs: a reference blind to it fails
    entry = tree / "benchmark" / "entries" / "turned.py"
    entry.write_text(entry.read_text().replace("_turn(raw(i), case)", "raw(i)"))
    assert not _run_in_copy(tree, "fused-sdev.turns")["correct"]


def test_options_reach_the_ports_call(tmp_path, monkeypatch):
    """A configuration's ``fused_sdev`` option runs K7's plain path (the
    fused sdev and noise histograms) on every image the window sends."""
    path = tmp_path / "cli-default-fused.json"
    path.write_text(json.dumps(dict(spec.config(BENCH, "cli-default"),
                                    options={"fused_sdev": True})))
    bench = json.loads(json.dumps(BENCH))
    next(c for c in bench["configs"] if c["name"] == "cli-default")["file"] = str(path)
    calls, real = [], fused_hist.sdev_noise_hists_plain

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(fused_hist, "sdev_noise_hists_plain", counted)
    r = cell.run("cli-default.resident", 2**31 + 41, 0.3, False, time.perf_counter(),
                 devices=[torch.device("cpu")], size=96, log=lambda m: None, bench=bench)
    assert r["correct"] and r["options"] == {"fused_sdev": True}
    warm = cell.WARM_ROUNDS * sum(Mix.from_json(spec.traffic("resident")).sizes)
    assert len(calls) == warm + 8 * r["attempted"]

"""``scripts/bench_torch.py`` on the CPU: ``--device cpu --size 256`` (one
window of one call, ``--windows 1 --calls 1``, so the run stays light)
prints one JSON line with the bench's keys (the production entries' legs
and the eager ones beside them); without ``--device cpu`` and
without a card it exits non-zero and prints no result."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "scripts", "bench_torch.py")
KEYS = {"metric", "value", "unit", "single_image_gpix", "batch_gpix", "single_image_eager_gpix",
        "batch_eager_gpix", "batch_size", "mesh_gpix", "devices", "size", "spatial", "platform",
        "device", "power_limit"}


def _run(*args):
    return subprocess.run([sys.executable, BENCH, *args], capture_output=True, text=True,
                          cwd=REPO, timeout=300)


def test_bench_cpu_prints_one_json_line():
    p = _run("--device", "cpu", "--size", "256", "--windows", "1", "--calls", "1")
    assert p.returncode == 0, p.stderr[-2000:]
    lines = p.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == KEYS
    assert rec["metric"] == "musica_3072_gpix_per_s" and rec["unit"] == "GPix/s"
    assert rec["platform"] == "cpu" and rec["device"] == "cpu" and rec["power_limit"] is None
    assert rec["size"] == 256 and rec["batch_size"] == 4 and rec["devices"] == 1
    for k in ("single_image_gpix", "batch_gpix", "single_image_eager_gpix", "batch_eager_gpix",
              "mesh_gpix"):
        assert rec[k] > 0, k
    assert rec["value"] == max(rec["single_image_gpix"], rec["batch_gpix"])
    assert rec["spatial"] == []


def test_bench_cpu_spatial_configs():
    """``--configs 1x2,2x2``: one entry per spatial mesh shape, each image's
    rows split over its mesh row (CPU entries here)."""
    p = _run("--device", "cpu", "--size", "128", "--configs", "1x2,2x2", "--windows", "1",
             "--calls", "1")
    assert p.returncode == 0, p.stderr[-2000:]
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    assert [(e["data"], e["space"]) for e in rec["spatial"]] == [(1, 2), (2, 2)]
    for e in rec["spatial"]:
        assert e["ms_per_img"] > 0 and e["gpix"] > 0 and len(e["steps_ms"]) == 5
        assert e["devices"] == ["cpu"] * (e["data"] * e["space"])


def test_bench_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run("--size", "256")
    assert p.returncode != 0 and not p.stdout.strip()
    assert "CUDA" in p.stderr

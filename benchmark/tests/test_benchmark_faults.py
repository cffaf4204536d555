"""Whole runs on the CPU (the harness's look for a card skipped) at a small
size, with the timed path broken underneath: ``correct`` comes out false
for each fault that a cell can have, and for the control, the program in a
lower precision (bf16 band storage).  A sound run comes out true.

The faults, where they are produced:

* an answer altered: one pixel of the u8 image (or of the CLAHE image);
* half of the batch left out: the program computes the first half of a
  request and returns it twice;
* a state returned unchanged: every request gets the first request's
  outputs again;
* the exchange between cards left out: the mesh's gather returns the first
  card's part in place of every other card's.

On the card, ``test_benchmark_card.py`` runs the control at the cells'
own size."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import calibrate  # noqa: E402
from benchmark.harness import cell, spec  # noqa: E402
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import (  # noqa: E402
    graphs, musica)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import (  # noqa: E402
    sharding)

CPU = torch.device("cpu")
SIZE = 128
CHIPS = {"cli-default.resident": 1, "clahe-linear.resident": 1, "cli-default.study": 1,
         "cli-default.mesh4": 4}


def with_unheld_cells() -> dict:
    """BENCHMARK.json with the two cells that the benchmark measured but
    does not hold (their runs spread too widely for a bound; PERF.md), whose
    traffic and limits files it keeps: the host API and the mesh."""
    bench = spec.benchmark()
    bench["workloads"] = bench["workloads"] + [
        {"name": "cli-default.study", "config": "cli-default", "traffic": "study", "chips": 1},
        {"name": "cli-default.mesh4", "config": "cli-default", "traffic": "mesh4", "chips": 4}]
    return bench


def run(name, seed=2**31 + 17, **kw):
    return cell.run(name, seed, 1.0, False, time.perf_counter(), devices=[CPU] * CHIPS[name],
                    size=SIZE, log=lambda m: None, bench=with_unheld_cells(), **kw)


@pytest.mark.parametrize("name", sorted(CHIPS))
def test_a_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks" and all(c["value"] <= c["limit"] for c in r["checks"].values())


def _altered(fn, pos):
    def broken(*a, **k):
        out = fn(*a, **k)
        first = out[0] if isinstance(out, tuple) else out
        first[(0, *pos)] ^= 1
        return out
    return broken


def _half(fn):
    def broken(imgs, *a, **k):
        h = max(1, len(imgs) // 2)
        out = fn(imgs[:h], *a, **k)
        reps = -(-len(imgs) // h)
        cat = (lambda t: torch.cat([t] * reps)[:len(imgs)]) if isinstance(out, torch.Tensor) \
            else (lambda t: __import__("numpy").concatenate([t] * reps)[:len(imgs)])
        return tuple(cat(t) for t in out) if isinstance(out, tuple) else cat(out)
    return broken


def _stale(fn):
    first = {}

    def broken(imgs, *a, **k):
        out = fn(imgs, *a, **k)
        key = len(imgs)
        first.setdefault(key, out)
        return first[key]
    return broken


# where each cell's timed path returns its outputs
TARGETS = {"cli-default.resident": (musica, "process_batch_jit"),
           "clahe-linear.resident": (graphs, "run_batch"),
           "cli-default.study": (musica, "process_batch"),
           "cli-default.mesh4": (sharding, "process_sharded")}


@pytest.mark.parametrize("name", sorted(CHIPS))
def test_an_altered_answer_is_not_correct(name, monkeypatch):
    mod, attr = TARGETS[name]
    monkeypatch.setattr(mod, attr, _altered(getattr(mod, attr), (SIZE // 3, SIZE // 3)))
    assert not run(name)["correct"]


def test_an_altered_clahe_image_is_not_correct(monkeypatch):
    real = graphs.run_batch

    def broken(*a, **k):
        u8, clahe = real(*a, **k)
        y, x = torch.nonzero(torch.isfinite(clahe[0]))[0]
        clahe[0, y, x] += 0.01
        return u8, clahe
    monkeypatch.setattr(graphs, "run_batch", broken)
    r = run("clahe-linear.resident")
    assert not r["correct"] and r["checks"]["u8_max_diff"]["value"] == 0


@pytest.mark.parametrize("name", sorted(CHIPS))
def test_half_of_the_batch_left_out_is_not_correct(name, monkeypatch):
    mod, attr = TARGETS[name]
    fn = getattr(mod, attr)
    if attr == "run_batch":
        monkeypatch.setattr(mod, attr, lambda fwd, imgs, *a, **k: _half(
            lambda im, *b, **c: fn(fwd, im, *b, **c))(imgs, *a, **k))
    else:
        monkeypatch.setattr(mod, attr, _half(fn))
    assert not run(name, seed=2**31 + 19)["correct"]


@pytest.mark.parametrize("name", sorted(CHIPS))
def test_a_state_returned_unchanged_is_not_correct(name, monkeypatch):
    mod, attr = TARGETS[name]
    fn = getattr(mod, attr)
    if attr == "run_batch":
        stale = _stale(lambda imgs, fwd, *a, **k: fn(fwd, imgs, *a, **k))
        monkeypatch.setattr(mod, attr, lambda fwd, imgs, *a, **k: stale(imgs, fwd, *a, **k))
    else:
        monkeypatch.setattr(mod, attr, _stale(fn))
    assert not run(name, seed=2**31 + 23)["correct"]


def test_the_exchange_between_cards_left_out_is_not_correct(monkeypatch):
    real = sharding._gather
    monkeypatch.setattr(sharding, "_gather", lambda parts, dev: real([parts[0]] * len(parts), dev))
    r = run("cli-default.mesh4")
    assert not r["correct"] and r["checks"]["u8_diff_share"]["value"] > 0


@pytest.mark.parametrize("name", ["cli-default.resident", "clahe-linear.resident"])
def test_the_control_is_not_correct(name):
    """The program with bf16 band storage, held to the float32 reference."""
    sound, ctrl = calibrate.readings(name, [2**31 + 29], [2**31 + 31], 0.3, devices=[CPU],
                                     size=256, log=lambda m: None)
    assert sound[0]["correct"] and not ctrl[0]["correct"]
    summary = calibrate.summary(sound, ctrl)
    assert summary["u8_diff_share"]["lower_max_sound"] == 0.0
    assert summary["u8_diff_share"]["upper_min_control"] > 1e-3


def test_requests_that_fail_make_the_run_not_correct(monkeypatch):
    """Every request of the window raises (set-up's warm-up passes): the run
    still gives its result, counts the failures and is not correct."""
    real, calls = musica.process_batch_jit, []

    def broken(*a, **k):
        calls.append(1)
        if len(calls) > cell.WARM_ROUNDS:
            raise RuntimeError("the program failed")
        return real(*a, **k)
    monkeypatch.setattr(musica, "process_batch_jit", broken)
    r = run("cli-default.resident")
    assert not r["correct"] and r["failed"] == r["attempted"] > 0
    assert "request_p95_ms" not in r["metrics"] and r["metrics"]["img_per_s"]["value"] == 0

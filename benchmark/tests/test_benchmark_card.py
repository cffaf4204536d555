"""On the card, at the cells' own size: a sound run is correct, and the
control (the program with bf16 band storage, held to the float32
reference) is not, on three seeds.  Skips without a CUDA device; run on the
card with ``python -m pytest --noconftest -p no:cacheprovider
benchmark/tests/test_benchmark_card.py``."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import calibrate  # noqa: E402
from benchmark.harness import spec  # noqa: E402

SEEDS = [2**31 + 101, 3_000_000_103, 4_000_000_107]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cli-default.resident", "clahe-linear.resident"])
def test_the_control_fails_and_the_program_passes_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sound, ctrl = calibrate.readings(name, SEEDS[:1], SEEDS, 2.0)
    assert all(r["correct"] for r in sound), sound
    assert not any(r["correct"] for r in ctrl), ctrl
    limits = spec.load_json(spec.BENCH_DIR / "limits" / f"{name}.json")
    for r in ctrl:
        assert any(r["checks"][k] > limits[k] for k in limits), r

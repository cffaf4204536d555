"""The yardstick's parts on the CPU: the seeded phantoms, the stages' byte
counts, the plain reference against the port's CPU path, the comparison
that decides ``correct``, and the trace's reduction to metrics."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import compare, phantoms, spec, trace as trace_mod  # noqa: E402
from benchmark.harness.traffic import Sample  # noqa: E402
from benchmark.reference import musica_plain  # noqa: E402
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import (  # noqa: E402
    MusicaConfig)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import (  # noqa: E402
    musica)

CPU = torch.device("cpu")
BENCH = spec.benchmark()


def test_phantoms_are_seeded_and_deterministic():
    a = phantoms.pool(2**31 + 5, 3, 96, (30000.0, 50000.0), CPU)
    b = phantoms.pool(2**31 + 5, 3, 96, (30000.0, 50000.0), CPU)
    c = phantoms.pool(2**31 + 6, 3, 96, (30000.0, 50000.0), CPU)
    assert a.dtype == torch.uint16 and tuple(a.shape) == (3, 96, 96)
    assert torch.equal(a.int(), b.int()) and not torch.equal(a.int(), c.int())
    # distinct images, a collimated border darker than the field
    x = a.int().numpy()
    assert not np.array_equal(x[0], x[1])
    assert x[:, :2].mean() < 0.1 * x[:, 40:56, 40:56].mean()
    assert x.min() >= 0 and x.max() <= 65535


def test_stage_bytes_match_the_shapes():
    cfg = MusicaConfig()
    sizes = [3072, 1536, 768, 384, 192, 96, 48, 24, 12, 6, 3, 2, 1]
    band_px = sum(s * s for s in sizes[:12])
    full = 3072 ** 2
    pyramid = spec.stage_bytes("pyramid").bytes_per_image(cfg)
    assert pyramid == 2 * (4 * full + 4 * band_px + 4 * 1)
    contrast = spec.stage_bytes("contrast").bytes_per_image(cfg)
    sdev_px = sum(s * s for s in sizes[:4])
    assert contrast == 2 * 4 * band_px + 4 * sdev_px + 4 * 384 ** 2
    assert contrast == pytest.approx(151.4e6, rel=1e-3)  # KA's bound in the port's records
    bf16 = spec.stage_bytes("contrast").bytes_per_image(cfg.with_(storage="bfloat16"))
    assert bf16 == 2 * 2 * band_px + 4 * sdev_px + 4 * 384 ** 2
    luts = 16 * 256
    clahe = spec.stage_bytes("clahe").bytes_per_image(
        cfg.with_(enable_clahe=True, grad_with_linear_image=True))
    assert clahe == (4 * 384 ** 2 + 4 * luts + 2 * 4 * (luts + 256) + 2 * 4 * full
                     + 2 * 4 * full)
    assert spec.stage_bytes("clahe").bytes_per_image(cfg.with_(enable_clahe=True)) \
        == clahe - 2 * 4 * full


@pytest.mark.parametrize("size", [144, 600])
@pytest.mark.parametrize("config", ["cli-default", "clahe-linear"])
def test_reference_equals_the_ports_cpu_path(config, size):
    fields = dict(spec.config(BENCH, config)["fields"], image_size=size)
    pcfg = musica_plain.PlainConfig(fields)
    cfg = MusicaConfig(**fields)
    assert pcfg.contrast_factors == cfg.contrast_factors
    assert pcfg.noise_reduction_params == cfg.noise_reduction_params
    assert pcfg.analysis_levels == cfg.analysis_levels
    assert pcfg.hist_coverage == cfg.hist_coverage and pcfg.level_sizes == cfg.level_sizes
    for img in phantoms.pool(size + 1, 2, size, (30000.0, 50000.0), CPU):
        want = musica.musica_forward(img, cfg)
        got = musica_plain.forward(img, pcfg)
        assert torch.equal(got["out_u8"], want["out_u8"])
        if cfg.enable_clahe:
            a, b = got["clahe_graded"], want["clahe_graded"]
            assert bool(((a == b) | (a.isnan() & b.isnan())).all())


def test_the_comparison_fails_on_a_perturbed_output():
    size = 144
    fields = dict(spec.config(BENCH, "clahe-linear")["fields"], image_size=size)
    pcfg = musica_plain.PlainConfig(fields)
    pool = phantoms.pool(3, 2, size, (30000.0, 50000.0), CPU)
    ref = [musica_plain.forward(im, pcfg) for im in pool]
    outs = (torch.stack([r["out_u8"] for r in ref]), torch.stack([r["clahe_graded"] for r in ref]))
    limits = spec.load_json(spec.BENCH_DIR / "limits" / "clahe-linear.resident.json")

    def judged(outs):
        nums = compare.compare([(0, 2, outs)], lambda i: pool[i],
                               lambda im: musica_plain.forward(im, pcfg),
                               ("out_u8", "clahe_graded"), CPU)
        return nums, compare.judge(nums, limits)

    nums, checks = judged(outs)
    assert all(c["ok"] for c in checks.values()) and nums["u8_max_diff"] == 0
    bad = outs[0].clone()
    bad[1, 70, 70] ^= 4
    nums, checks = judged((bad, outs[1]))
    assert nums["u8_max_diff"] == 4 and not checks["u8_max_diff"]["ok"]
    bad = outs[1].clone()
    finite = torch.nonzero(torch.isfinite(bad[0]))[0]
    bad[0, finite[0], finite[1]] += 1e-3
    nums, checks = judged((outs[0], bad))
    assert nums["clahe_max_diff"] == pytest.approx(1e-3, rel=1e-2) and not checks["clahe_max_diff"]["ok"]
    nums, checks = judged((outs[0][:1], outs[1]))  # one image's output missing
    assert nums["missing"] == 2 and not checks["missing"]["ok"]


def test_sample_keeps_the_largest_and_a_seeded_uniform_sample():
    def kept(seed):
        s = Sample(3, seed, largest=4)
        for i in range(100):
            s.offer((i, 4 if i in (7, 50) else 1, None), 4 if i in (7, 50) else 1)
        return [it[0] for it in s.items()]

    a = kept(1)
    assert a[0] == 7 and len(a) == 4 and a == kept(1) and a != kept(2)


def _events(spec_list):
    """Fake profiler events: (name, device_type, start_us, end_us, device)."""
    return [SimpleNamespace(name=n, device_type=t, device_index=d,
                            time_range=SimpleNamespace(start=a, end=b))
            for n, t, a, b, d in spec_list]


def test_trace_reduction():
    cuda, cpu = "cuda", "cpu"
    evs = _events([
        ("spin_kernel", cuda, 0, 10, 0),
        ("bench.window", cpu, 20, 120, -1),
        ("bench.submit", cpu, 20, 60, -1),
        ("bench.wait", cpu, 60, 120, -1),
        ("bench.request", cuda, 20, 120, 0),  # a span's device-side range: not an operation
        ("void reduce_step_kernel<true>(float const*, int)", cuda, 30, 50, 0),
        ("Memcpy HtoD (Pageable -> Device)", cuda, 50, 70, 0),
        ("void contrast_apply_kernel<false>(Args)", cuda, 90, 110, 0),
    ])
    tr = trace_mod.reduce_events(evs, 2, cuda, cpu)
    assert tr.window_s == pytest.approx(100e-6) and tr.devices == [0]
    assert [k[0] for k in tr.kernels] == ["reduce_step_kernel<true>", "contrast_apply_kernel<false>"]
    assert tr.busy_s(0) == pytest.approx(60e-6) and tr.kernel_s() == pytest.approx(40e-6)
    assert tr.copy_s(("HtoD",)) == pytest.approx(20e-6)
    tr.stages, tr.stage_bytes = spec.stage_table(), spec.stage_bytes
    tr.cfg, tr.peak_bytes_per_s = MusicaConfig(image_size=64), 3.35e12
    pyr = spec.stage_bytes("pyramid").bytes_per_image(tr.cfg) * 2
    assert tr.roofline_pct("pyramid") == pytest.approx(100 * pyr / 3.35e12 / 20e-6)
    assert tr.roofline_pct("clahe") is None
    b = tr.breakdown()
    assert b["device_ops"][0][0] in ("reduce_step_kernel<true>", "contrast_apply_kernel<false>",
                                     "Memcpy HtoD (Pageable -> Device)")
    gaps = dict(b["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(40e-6)
    assert any(k.startswith("bench.submit") for k in gaps)  # 20-30 us
    assert any(k.startswith("bench.wait") for k in gaps)    # 70-90, 110-120 us
    names = [m["name"] for m in BENCH["per_layer"]] + ["copy_ms_per_img", "mesh_busy_min_pct"]
    readers = {n: spec.metric_reader(n).read for n in names}
    assert readers["launches_per_img"](tr) == 1.0
    assert readers["busy_ms_per_img"](tr) == pytest.approx(0.02)
    assert readers["device_idle_pct"](tr) == pytest.approx(40.0)
    assert readers["copy_ms_per_img"](tr) == pytest.approx(0.01)
    assert readers["mesh_busy_min_pct"](tr) is None
    # a record that kept no spin kernel is not counted
    assert trace_mod.reduce_events(evs[1:], 2, cuda, cpu) is None

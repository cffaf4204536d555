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

from benchmark.harness import compare, entries, phantoms, spec, trace as trace_mod  # noqa: E402
from benchmark.harness.traffic import Done, Sample  # noqa: E402
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
        nums = compare.compare([Done(0, 2, outs, ())],
                               lambda item: entries.plain_expected(item, lambda i: pool[i], fields),
                               {"out_u8": "u8", "clahe_graded": "clahe"}, CPU)
        return nums, compare.judge(nums, limits)

    nums, checks = judged(outs)
    assert all(c["ok"] for c in checks.values()) and nums["u8_max_diff"] == 0
    assert set(nums) == set(limits)
    assert type(nums["u8_max_diff"]) is int and type(nums["clahe_max_diff"]) is float
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
    """Fake profiler events: (name, device_type, start_us, end_us, device[,
    thread, id])."""
    return [SimpleNamespace(name=n, device_type=t, device_index=d,
                            time_range=SimpleNamespace(start=a, end=b),
                            thread=rest[0] if rest else 0, id=rest[1] if rest else -1)
            for n, t, a, b, d, *rest in spec_list]


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
    # no musica.request span: the idle split has nothing to read
    assert tr.program == [] and tr.idle_split(0) is None
    for name in ("request_gap_pct", "image_gap_pct", "graph_gap_pct"):
        assert readers[name](tr) is None
    # a record that kept no spin kernel is not counted
    assert trace_mod.reduce_events(evs[1:], 2, cuda, cpu) is None


# two requests of a port's traced window (us): the first of two images, the
# second of one; each image a replay (copy in, copies out) around a graph
_HARNESS = [
    ("spin_kernel", "cuda", 0, 10, 0),
    ("bench.window", "cpu", 20, 200, -1),
    ("bench.submit", "cpu", 22, 120, -1),
    ("bench.wait", "cpu", 120, 128, -1),
    ("bench.submit", "cpu", 128, 190, -1),
    ("bench.wait", "cpu", 190, 200, -1),
    ("Memcpy DtoD (Device -> Device)", "cuda", 40, 45, 0),
    ("void reduce_step_kernel<true>(float const*, int)", "cuda", 48, 60, 0),
    ("void contrast_apply_kernel<false>(Args)", "cuda", 62, 70, 0),
    ("Memcpy DtoD (Device -> Device)", "cuda", 72, 75, 0),
    ("Memcpy DtoD (Device -> Device)", "cuda", 80, 82, 0),
    ("void reduce_step_kernel<true>(float const*, int)", "cuda", 85, 95, 0),
    ("Memcpy DtoD (Device -> Device)", "cuda", 98, 100, 0),
    ("Memcpy DtoD (Device -> Device)", "cuda", 150, 152, 0),
    ("void reduce_step_kernel<true>(float const*, int)", "cuda", 155, 170, 0),
    ("Memcpy DtoD (Device -> Device)", "cuda", 172, 175, 0),
]
_PORT = [  # (name, device_type, start, end, card, thread, id)
    ("musica.normalize", "cpu", 2, 8, -1, 1, 90),   # before the window: dropped
    ("musica.phase", "cpu", 10, 30, -1, 1, 91),     # clipped to the window
    ("musica.request", "cpu", 25, 120, -1, 1, 1),
    ("musica.replay", "cpu", 30, 60, -1, 1, 2),
    ("musica.graph", "cpu", 35, 55, -1, 1, 3),
    ("musica.replay", "cpu", 70, 110, -1, 1, 4),
    ("musica.graph", "cpu", 75, 100, -1, 1, 5),
    ("musica.replay", "cuda", 40, 75, 0, 7, 2),
    ("musica.graph", "cuda", 48, 70, 0, 7, 3),
    ("musica.replay", "cuda", 80, 100, 0, 7, 4),
    ("musica.graph", "cuda", 85, 95, 0, 7, 5),
    ("musica.request", "cpu", 130, 190, -1, 1, 6),
    ("musica.replay", "cpu", 135, 150, -1, 1, 7),
    ("musica.graph", "cpu", 137, 148, -1, 1, 8),
    ("musica.replay", "cuda", 150, 175, 0, 7, 7),
    ("musica.graph", "cuda", 155, 170, 0, 7, 8),
    ("musica.replay", "cpu", 210, 220, -1, 1, 9),   # after the window: dropped
]


def test_trace_keeps_the_ports_spans_apart():
    """``reduce_events`` fills ``Trace.program`` with the port's spans
    clipped to the window, and keeps kernels, copies and the breakdown as
    a record without them gives."""
    with_port = trace_mod.reduce_events(_events(_HARNESS + _PORT), 3, "cuda", "cpu")
    without = trace_mod.reduce_events(_events(_HARNESS), 3, "cuda", "cpu")
    assert with_port.kernels == without.kernels and with_port.copies == without.copies
    assert with_port.spans == without.spans and with_port.breakdown() == without.breakdown()
    assert without.program == []
    prog = with_port.program
    assert len(prog) == len(_PORT) - 2
    assert prog[0] == ("musica.phase", 20e-6, 30e-6, -1, 1, 91)
    assert ("musica.graph", 48e-6, 70e-6, 0, 7, 3) in prog
    assert ("musica.request", 130e-6, 190e-6, -1, 1, 6) in prog


def test_the_idle_split_sums_to_the_idle_share():
    tr = trace_mod.reduce_events(_events(_HARNESS + _PORT), 3, "cuda", "cpu")
    # gaps: before and between the requests and after the last, 20 + 50 + 25;
    # in graphs, 60-62; at image edges, 45-48, 70-72, 75-80, 82-85, 95-98,
    # 152-155, 170-172
    split = tr.idle_split(0)
    assert split == pytest.approx({"request": 95e-6, "graph": 2e-6, "image": 21e-6})
    assert sum(b - a for a, b in tr.idle_gaps(0)) == pytest.approx(118e-6)
    read = {n: spec.metric_reader(n).read(tr)
            for n in ("request_gap_pct", "image_gap_pct", "graph_gap_pct", "device_idle_pct")}
    assert read["request_gap_pct"] == pytest.approx(100 * 95 / 180)
    assert read["image_gap_pct"] == pytest.approx(100 * 21 / 180)
    assert read["graph_gap_pct"] == pytest.approx(100 * 2 / 180)
    assert read["request_gap_pct"] + read["image_gap_pct"] + read["graph_gap_pct"] \
        == pytest.approx(read["device_idle_pct"], abs=1e-9)

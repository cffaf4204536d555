"""The port's profiler spans (``utils/spans.py``) on the CPU, through the
fake capture backend of ``test_torch_graphs.py``: one ``musica.request`` a
``graphs.run_batch`` call, one ``musica.replay`` and one ``musica.graph``
an image, nested request > replay > graph on one thread (also in the mesh's
worker threads), ``musica_forward``'s phases in eager runs, ``cli batch
--profile``'s trace, no ``record_function`` entered while no profiler
records; and ``scripts/idle_split.py``'s split of a card's idle time by
those spans, on synthetic spans."""

import contextlib
import importlib.util
import json
import re
import threading
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import (
    MusicaConfig, cli)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import graphs, musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
    synthetic_radiograph)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.utils import io as uio
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.utils import spans

from test_torch_graphs import FakeGraphs

torch.set_num_threads(2)

SIZE = 64
PKG = Path(spans.__file__).resolve().parents[1]
PHASES = ("normalize", "reduce", "analysis", "apply", "expand", "gradation", "clahe", "tonemap")
ENTRY_SPANS = ("musica.request", "musica.replay", "musica.graph")


@pytest.fixture
def fake(monkeypatch):
    backend = FakeGraphs()
    monkeypatch.setattr(graphs, "_GRAPHS", graphs.GraphCache(backends={"cpu": backend}))
    launch.reset_launch_counts()
    yield backend
    launch.reset_launch_counts()


def _imgs(n):
    return torch.stack([torch.from_numpy(synthetic_radiograph(SIZE, a))
                        for a in ("thorax", "hand", "knee", "foot")[:n]])


def _spans(prof, names=ENTRY_SPANS):
    """{name: [(start, end, thread)]} of the host spans ``names``."""
    out = {n: [] for n in names}
    for e in prof.events():
        if e.name in out and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.name].append((e.time_range.start, e.time_range.end, e.thread))
    return out


def _holder(inner, outers):
    """The one span of ``outers`` that holds ``inner`` on its thread."""
    held = [o for o in outers if o[2] == inner[2] and o[0] <= inner[0] and inner[1] <= o[1]]
    assert len(held) == 1, (inner, outers)
    return held[0]


def _images_per_request(s):
    """Each request's number of replays, after checking the nesting
    request > replay > graph, one graph a replay."""
    for rep in s["musica.replay"]:
        _holder(rep, s["musica.request"])
    for g in s["musica.graph"]:
        _holder(g, s["musica.replay"])
    assert len(s["musica.graph"]) == len(s["musica.replay"])
    return sorted(sum(_holder(rep, s["musica.request"]) == r for rep in s["musica.replay"])
                  for r in s["musica.request"])


def test_run_batch_spans_nest_request_replay_graph(fake):
    cfg = MusicaConfig(image_size=SIZE)
    xs = _imgs(3)
    musica.process_jit(xs[0], cfg)  # the capture, before the record
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = musica.process_batch_jit(xs, cfg)
        graphs.run_batch(musica.musica_forward, xs[:2], cfg, outputs=("out_u8", "cnr"))
    assert torch.equal(out, musica.forward_batch(xs, cfg))
    s = _spans(prof)
    assert len(s["musica.request"]) == 2 and len(s["musica.replay"]) == 5
    assert _images_per_request(s) == [2, 3]
    user = {e.name for e in prof.events() if e.is_user_annotation}
    assert set(ENTRY_SPANS) <= user and all(n.startswith("musica.") for n in user), user


def test_no_record_function_without_a_profiler(fake, monkeypatch):
    calls = []
    monkeypatch.setattr(spans, "record_function",
                        lambda *a: calls.append(a) or contextlib.nullcontext())
    cfg = MusicaConfig(image_size=SIZE, enable_clahe=True)
    xs = _imgs(2)
    musica.process_batch_jit(xs, cfg)  # capture and replays
    musica.process_batch_jit(xs, cfg)
    musica.musica_forward(xs[0], cfg)
    musica.timed_process(xs[0].numpy(), cfg, "cpu")
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        musica.process_batch_jit(xs, cfg)
    names = [a[0] for a in calls]
    assert [names.count(n) for n in ENTRY_SPANS] == [1, 2, 2]


def test_span_is_one_shared_null_context_without_a_profiler():
    off = spans.span("musica.a")
    assert off is spans.span("musica.b")
    assert isinstance(off, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("musica.a"):
            pass
    assert [e.name for e in prof.events() if e.is_user_annotation] == ["musica.a"]


def test_span_follows_the_profilers_own_state():
    """A profiler whose start left the Python flag off still gets the spans
    of the thread it records."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        flag, spans._profiler._is_profiler_enabled = spans._profiler._is_profiler_enabled, False
        try:
            ctx = spans.span("musica.a")
            with ctx:
                pass
        finally:
            spans._profiler._is_profiler_enabled = flag
    assert ctx is not spans.span("musica.a")
    assert [e.name for e in prof.events() if e.is_user_annotation] == ["musica.a"]


@pytest.mark.parametrize("clahe", [False, True])
def test_forward_phases_in_eager_runs(clahe):
    cfg = MusicaConfig(image_size=SIZE, enable_clahe=clahe)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        musica.musica_forward(_imgs(1)[0], cfg)
    names = [e.name for e in prof.events() if e.is_user_annotation]
    assert names == ["musica." + p for p in PHASES if clahe or p != "clahe"]


def test_mesh_workers_spans_nest_per_thread(fake, monkeypatch):
    """process_sharded calls run_batch in a worker thread an entry: each
    worker's request holds its own replays on its thread."""
    from torch._C._profiler import _ExperimentalConfig

    monkeypatch.setattr(fake, "stream", lambda dev: threading.get_ident())
    cfg = MusicaConfig(image_size=SIZE)
    imgs = _imgs(4).numpy()
    mesh = sharding.make_mesh(devices=[torch.device("cpu")] * 2)
    sharding.process_sharded(imgs, cfg, mesh)  # captures
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        out = sharding.process_sharded(imgs, cfg, mesh)
    assert torch.equal(out, musica.forward_batch(torch.from_numpy(imgs), cfg))
    s = _spans(prof)
    assert len({r[2] for r in s["musica.request"]}) == 2
    assert _images_per_request(s) == [2, 2]


def test_cli_batch_profile_writes_the_spans(tmp_path):
    for a in ("hand", "knee", "foot"):
        uio.save_raw(tmp_path / f"{a}.raw", synthetic_radiograph(SIZE, a))
    prof = tmp_path / "prof"
    assert cli.main(["batch", "--size", str(SIZE), "--device", "cpu", "--batch", "2",
                     "--no-transpose", "--profile", str(prof), str(tmp_path / "*.raw"),
                     str(tmp_path / "out")]) == 0
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    names = [e.get("name") for e in events if e.get("cat") == "user_annotation"]
    assert names.count("musica.request") == 2 and names.count("musica.normalize") == 3
    assert all(n.startswith("musica.") for n in names)
    assert len(list((tmp_path / "out").glob("*.bmp"))) == 3


def test_every_span_goes_through_the_one_helper():
    """record_function appears only in utils/spans.py, and every span the
    port names starts with ``musica.``."""
    named = []
    for path in PKG.rglob("*.py"):
        src = path.read_text()
        if path.name != "spans.py":
            assert "record_function" not in src, path
        named += re.findall(r"\bspan\(\s*[\"']([^\"']*)[\"']", src)
        named += ["musica." + p for p in re.findall(r"\bphase\(\s*[\"']([^\"']*)[\"']", src)]
    assert set(ENTRY_SPANS) <= set(named) and all(n.startswith("musica.") for n in named)
    assert {"musica." + p for p in PHASES} <= set(named)
    assert all(n.count(".") == 1 for n in named)


def _script():
    path = PKG.parent / "scripts" / "idle_split.py"
    mod_spec = importlib.util.spec_from_file_location("idle_split", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


# One card, times in us.  Two requests on one thread: the first of two
# images, the second of one.  A replay's device-side range runs from its
# copy in to its last copy out, a graph's over its kernels; a request has
# none.  Gaps: 20-30, 84-140, 163-220 between requests (123); 40-42, 70-71,
# 150-152 inside a graph (5); 32-33, 50-52, 54-56, 58-60, 80-82, 142-143,
# 160-161 at an image's edges (11).
ONE_THREAD = (
    [(30, 32), (33, 40), (42, 50), (52, 54), (56, 58), (60, 70), (71, 80), (82, 84),
     (140, 142), (143, 150), (152, 160), (161, 163)],
    [("musica.request", 22, 58, False, 1, 1),
     ("musica.replay", 24, 40, False, 1, 2), ("musica.graph", 28, 36, False, 1, 3),
     ("musica.replay", 42, 56, False, 1, 4), ("musica.graph", 46, 54, False, 1, 5),
     ("musica.request", 132, 160, False, 1, 6),
     ("musica.replay", 134, 150, False, 1, 7), ("musica.graph", 138, 146, False, 1, 8),
     ("musica.replay", 30, 54, True, 1, 2), ("musica.graph", 33, 50, True, 1, 3),
     ("musica.replay", 56, 84, True, 1, 4), ("musica.graph", 60, 80, True, 1, 5),
     ("musica.replay", 140, 163, True, 1, 7), ("musica.graph", 143, 160, True, 1, 8)],
    {"graph": 5, "image": 11, "request": 123})
# Two threads' requests, their host spans interleaved in time: each device
# range belongs to the request that holds its host span on its thread (held
# by the other thread's request, 50-55 would count as an image's edge).
TWO_THREADS = (
    [(30, 32), (32, 40), (41, 48), (48, 50), (55, 57), (57, 68), (68, 70)],
    [("musica.request", 21, 60, False, 2, 1), ("musica.request", 22, 61, False, 3, 2),
     ("musica.replay", 23, 40, False, 2, 3), ("musica.replay", 24, 41, False, 3, 4),
     ("musica.graph", 25, 30, False, 2, 5), ("musica.graph", 26, 31, False, 3, 6),
     ("musica.replay", 30, 50, True, 2, 3), ("musica.graph", 32, 48, True, 2, 5),
     ("musica.replay", 55, 70, True, 3, 4), ("musica.graph", 57, 68, True, 3, 6)],
    {"graph": 1, "image": 0, "request": 65})


@pytest.mark.parametrize("case", [ONE_THREAD, TWO_THREADS], ids=["one_thread", "two_threads"])
def test_idle_split_by_the_spans(case):
    ops, named, want = case
    window = (20, 220) if case is ONE_THREAD else (20, 120)
    got = _script().idle_split(window, ops, named)
    assert got == pytest.approx(want)
    busy = sum(b - a for a, b in ops)
    assert sum(got.values()) == pytest.approx(window[1] - window[0] - busy)


def test_idle_split_without_the_spans_is_all_between_requests():
    ops, _, want = ONE_THREAD
    got = _script().idle_split((20, 220), ops, [])
    assert got == pytest.approx({"graph": 0, "image": 0, "request": sum(want.values())})

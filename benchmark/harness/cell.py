"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the reference, and the result line's contents.

``run`` takes the devices to use, so the tests drive a whole run on the CPU
at a small size; ``benchmark/run.py`` checks for the cards first and hands
it the cell's CUDA devices.
"""

from __future__ import annotations

import importlib
import sys
import time
import traceback
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..reference import musica_plain
from . import compare, entries, phantoms, spec, trace as trace_mod
from .traffic import Mix, Sample, requests

PACKAGE = "metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch"
# top-level module names that no run may load (the port's name begins
# with the JAX package's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", PACKAGE[:-len("_torch")])
WARM_ROUNDS = 2  # calls of each request size in set-up: the capture, then a replay


class Program:
    """The system under test: the port's modules that a request reaches."""

    def __init__(self):
        self.MusicaConfig = importlib.import_module(PACKAGE).MusicaConfig
        self.musica = importlib.import_module(PACKAGE + ".models.musica")
        self.graphs = importlib.import_module(PACKAGE + ".models.graphs")
        self.sharding = importlib.import_module(PACKAGE + ".parallel.sharding")


def forbidden_modules() -> List[str]:
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(cell: str, seed: int, seconds: float, trace: bool, t0: float,
        devices: Optional[Sequence[torch.device]] = None, size: Optional[int] = None,
        program_fields: Optional[dict] = None, log: Callable[[str], None] = _log,
        bench: Optional[dict] = None) -> dict:
    """The result of one run of ``cell`` (the keys of the result line).
    ``t0``: the process's start on ``time.perf_counter``'s clock.
    ``size`` replaces the configuration's image size (the CPU tests);
    ``program_fields`` replaces fields of the program's configuration only
    (the control: the program in a lower precision, held to the
    reference at the configuration's).  ``bench`` replaces the contents of
    ``BENCHMARK.json`` (the tests' cells that the file does not hold)."""
    bench = bench or spec.benchmark()
    w = spec.workload(bench, cell)
    fields = dict(spec.config(bench, w["config"])["fields"])
    if size is not None:
        fields["image_size"] = size
    mix = Mix.from_json(spec.traffic(w["traffic"]))
    limits = spec.load_json(spec.BENCH_DIR / "limits" / f"{cell}.json")
    prog = Program()
    cfg = prog.MusicaConfig(**{**fields, **(program_fields or {})})
    devices = list(devices) if devices else [torch.device("cuda", i) for i in range(w["chips"])]
    cuda = [d for d in devices if d.type == "cuda"]

    # ---- set-up: the pool, the program's kernels and graphs -------------
    marks = [("imports", time.perf_counter())]
    pool = phantoms.pool(seed, mix.pool_images, cfg.image_size, mix.dose, devices[0])
    entry_cls = entries.ENTRIES[mix.entry]
    if mix.pool not in entry_cls.pools:
        raise ValueError(f"entry {mix.entry!r} takes a pool on {entry_cls.pools}, "
                         f"not {mix.pool!r}")
    if mix.pool == "host":
        pool = pool.cpu().numpy()
    entry = entry_cls(prog, cfg, pool, devices)
    entries.synchronize(devices)
    marks.append(("pool", time.perf_counter()))
    for r in range(WARM_ROUNDS):
        for k in mix.sizes:
            entry.submit(0, k)
            entry.wait()
        entries.synchronize(devices)
        marks.append((f"warm-up round {r + 1}", time.perf_counter()))
    for d in cuda:
        torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t0
    log(f"{cell}: seed {seed}, set-up {setup_s:.3f} s (" + ", ".join(
        f"{name} {t - prev:.3f}" for (name, t), prev in zip(marks, [t0] + [t for _, t in marks]))
        + ")")

    sample = Sample(mix.sample_requests, seed, max(mix.sizes))
    gen = requests(mix, seed)
    if trace:
        win = _traced(entry, mix, gen, sample, devices, cfg, log)
    else:
        win = _timed(entry, gen, sample, seconds, log)
    peak = max((torch.cuda.max_memory_allocated(d) for d in cuda), default=0)

    # ---- after the window: free the program's state, then the reference -
    names, entry = entry.products, None
    prog.graphs.release_graphs()
    if cuda:
        torch.cuda.empty_cache()
    pcfg = musica_plain.PlainConfig(fields)
    ref_dev = devices[0]
    t_ref = time.perf_counter()
    nums = compare.compare(
        sample.items(), lambda i: torch.as_tensor(pool[i]).to(ref_dev),
        lambda img: musica_plain.forward(img, pcfg), names, ref_dev)
    checks = compare.judge(nums, limits)
    log(f"compared {sum(c for _, c, _ in sample.items())} images of "
        f"{len(sample.items())} requests with the reference in "
        f"{time.perf_counter() - t_ref:.3f} s")
    correct = (win["failed"] == 0 and win["attempted"] > 0 and bool(sample.items())
               and all(c["ok"] for c in checks.values()))

    device = {"platform": "gpu" if cuda else devices[0].type,
              "kind": torch.cuda.get_device_name(cuda[0]) if cuda else devices[0].type,
              "count": len(devices), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"]}
    if trace:
        tr = win["trace"]
        device.update(busy_s=sum(tr.busy_s(d) for d in tr.devices) / len(tr.devices),
                      window_s=tr.window_s)
        metrics = {}
        for m in spec.metrics_of(bench, cell, trace=True):
            value = spec.metric_reader(m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result.update(metrics=metrics, device=device, breakdown=tr.breakdown())
        other = tr.unstaged()
        if other:
            log(f"kernels in no stage ('other'): {other}")
    else:
        lat = win["latency_s"]
        values = {"img_per_s": win["images"] / win["window_s"], "setup_s": setup_s}
        if lat:  # no tail where no request completed (the run is not correct)
            values["request_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.metrics_of(bench, cell, trace=False) if m["name"] in values}
        result.update(metrics=metrics, device=device)
        log(f"window {win['window_s']:.3f} s: {win['attempted']} requests, {win['images']} "
            f"images" + (f", latency median {np.median(lat) * 1e3:.4f} ms" if lat else ""))
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result


def _request(entry, start: int, count: int, state: dict, log, span=None):
    """One request; its outputs, or None where it raised."""
    state["attempted"] += 1
    try:
        if span is None:
            outs = entry.submit(start, count)
            entry.wait()
        else:
            with span("bench.submit"):
                outs = entry.submit(start, count)
            with span("bench.wait"):
                entry.wait()
        return outs
    except Exception:  # a request that fails counts as failed; the run goes on
        state["failed"] += 1
        if state["failed"] == 1:
            log("a request failed:\n" + traceback.format_exc())
        return None


def _timed(entry, gen, sample: Sample, seconds: float, log) -> dict:
    """The closed loop for ``seconds``: one request outstanding, each timed
    from its submission to its outputs being ready; the window ends at the
    completion of the last request submitted before its end."""
    state = {"attempted": 0, "failed": 0}
    latency: List[float] = []
    images = 0
    t_start = time.perf_counter()
    t_last, deadline = t_start, t_start + seconds
    for start, count in gen:
        t = time.perf_counter()
        if t >= deadline:
            break
        outs = _request(entry, start, count, state, log)
        t_last = time.perf_counter()
        if outs is not None:
            latency.append(t_last - t)
            images += count
            sample.offer((start, count, outs), count)
    return {**state, "images": images, "latency_s": latency, "window_s": t_last - t_start}


def _traced(entry, mix: Mix, gen, sample: Sample, devices, cfg, log) -> dict:
    """``mix.trace_requests`` requests under ``torch.profiler``, reduced to
    a ``trace.Trace`` (made again where a card kept no spin kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    state = {"attempted": 0, "failed": 0}
    cuda = [d for d in devices if d.type == "cuda"]
    for attempt in range(trace_mod.ATTEMPTS):
        images = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for d in cuda:
                with torch.cuda.device(d):
                    for _ in range(trace_mod.PAD_KERNELS):
                        torch.cuda._sleep(20_000)
            entries.synchronize(devices)
            latency = []
            with record_function("bench.window"):
                for _ in range(mix.trace_requests):
                    start, count = next(gen)
                    t = time.perf_counter()
                    with record_function("bench.request"):
                        outs = _request(entry, start, count, state, log, record_function)
                    with record_function("bench.next"):
                        if outs is not None:
                            latency.append(time.perf_counter() - t)
                            images += count
                            sample.offer((start, count, outs), count)
        t_reduce = time.perf_counter()
        tr = trace_mod.reduce_events(prof.events(), images, DeviceType.CUDA, DeviceType.CPU)
        log(f"trace attempt {attempt + 1}: reduced in {time.perf_counter() - t_reduce:.3f} s"
            + ("" if tr else "; a card kept no spin kernel, the record is not counted"))
        if tr is not None:
            break
    else:
        raise RuntimeError(f"no record of {trace_mod.ATTEMPTS} kept a spin kernel on every card")
    tr.cfg, tr.latency_s = cfg, latency
    tr.peak_bytes_per_s = spec.peaks()["hbm_bytes_per_s"]
    tr.stages = spec.stage_table()
    tr.stage_bytes = spec.stage_bytes
    return {**state, "trace": tr}

#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main path, on one CUDA GPU.

    python3 scripts/profile_torch.py [--size 3072] [--reps 5] [--out DIR]
    python3 scripts/profile_torch.py --clahe --linear-gradation   # the variants
    python3 scripts/profile_torch.py --fused-sdev    # sdev + noise histograms in one kernel
    python3 scripts/profile_torch.py --bf16          # bf16 band storage
    python3 scripts/profile_torch.py --graph         # also the graph replays
    python3 scripts/profile_torch.py --spatial 1x4   # the spatial path on this card (eager, graphs)
    python3 scripts/profile_torch.py --graph --root DIR   # another checkout's package

Runs ``musica_forward`` on a device-resident synthetic radiograph under
``torch.profiler`` and prints, with the card's name and power limit:

* the wall time per image (CUDA events), the kernel launches per image and
  the device's busy share (sum of kernel times over wall time);
* per ``musica.<phase>`` span, the host time spent issuing its ops and its
  span on the device timeline;
* the device time and launches of each hand-written kernel (K1-K7, KP1,
  KP2, the pyramid's tails, KS, KT, KA, KN's two passes, KG, KH, KC);
* the kernels with the most device time, each by a label (its kernel
  template with the vector width, its functor or lambda with the types,
  without namespaces, argument lists and iterator plumbing; never cut),
  with the ``musica.<phase>`` spans its launches fall in: a kernel belongs
  to the span whose device-side range holds its start.

With ``--graph`` it then profiles ``process_jit``, the replay of
``musica_forward``'s captured CUDA graph (``models/graphs.py``; captured
before the profiler starts), and prints the same wall time, kernels,
device busy ms and share, hand-written kernels and top kernels for the
replays beside the eager run's (a replay has no ``musica.<phase>`` spans:
they are host spans of the capture; its top kernels name the phases of the
same labels in the eager run).  Before the profiler starts, it times 5
windows of ``--reps`` replays between CUDA events and prints their median
ms/img: the replay's time without the profiler's cost.

``--root DIR`` imports the package of another checkout of this repository
(e.g. the parent commit, unpacked with ``git archive`` into a directory
that ``.gitignore`` lists), which builds its own kernels.  Run on both
checkouts in turn, in the order parent, this, this, parent, it
gives a change's before and after on the same card.

With ``--spatial DxS`` the profiled call is ``process_sharded_eager`` of D
images over a D x S mesh whose entries are all this card, each on a stream
of its own (``parallel/spatial.py``, its schedule issued op by op; its ops
carry no ``musica.<phase>`` spans), then, as with ``--graph``,
``process_sharded``, whose images are replays of each mesh row's captured
graph (``models/graphs.py::SpatialGraph``); the times are per image.

A Chrome trace of the run goes to ``DIR/trace.json`` (default
``build/profile_torch``), the replays' to ``DIR/trace_graph.json``, and
the top kernels with their full names to ``DIR/top_kernels.json``.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the hand-written kernels by their names in the trace (csrc/*.cu)
HAND_WRITTEN = {
    "K1 noise_hist_kernel (with K2's argmax)": r"(?<![A-Za-z_])noise_hist(_serial)?_kernel\b",
    "K3 grad_hist_kernel<tile, true>": r"grad_hist(_serial)?_kernel<(\d+, )?true>",
    "K4 grad_hist_kernel<tile, false>": r"grad_hist(_serial)?_kernel<(\d+, )?false>",
    "K5 clahe_apply_kernel": r"clahe_apply_kernel\b",
    "K6 histogram_kernel": r"(?<![A-Za-z_])histogram_kernel\b",
    "K7 sdev_noise_hist_kernel": r"sdev_noise_hist_kernel\b",
    "KP1 reduce_step_kernel<band>": r"reduce_step_kernel<(true|false)>",
    "KP2 upsample_smooth_kernel<mode>": r"upsample_smooth_kernel<\d>",
    "pyramid_tail_kernel<expand>": r"pyramid_tail_kernel<(true|false)>",
    "KS sdev_kernel": r"(?<![A-Za-z_])sdev_kernel\b",
    "KT tone_map_kernel<vec, words>": r"tone_map_kernel<(true|false)(, (true|false))?>",
    "KA contrast_apply_kernel<bf16>": r"contrast_apply_kernel<(true|false)>",
    "KN normalize_extrema_kernel<T, vec>": r"normalize_extrema_kernel<",
    "KN normalize_apply_kernel<T, vec>": r"normalize_apply_kernel<",
    "KG gradation_curve_kernel": r"gradation_curve_kernel\b",
    "KH clahe_hist_kernel": r"clahe_hist_kernel\b",
    "KC clahe_curves_kernel": r"clahe_curves_kernel\b",
    # KP1 in checkouts from before the fused step (--root)
    "KP1 smooth_downsample_kernel": r"smooth_downsample_kernel\b",
}
TOP = 15  # rows of the top-kernel tables

# the iterator plumbing of PyTorch's elementwise kernels, dropped from labels
_PLUMBING = (r"array<char\*, \d+ul>", r"(Trivial)?OffsetCalculator<[^<>]*>",
             r"LoadWithoutCast", r"StoreWithoutCast")


def _strip_call(name: str) -> str:
    """``name`` without its trailing argument list."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i]
    return name


def label(name: str) -> str:
    """A kernel's short identity from its demangled name: the kernel and its
    template arguments (vector width, functor or lambda with its types),
    without ``void``, the argument list, namespaces and iterator plumbing.
    ``void at::native::vectorized_elementwise_kernel<4,
    at::native::CUDAFunctor_add<double>, std::array<char*, 3ul> >(int, ...)``
    gives ``vectorized_elementwise_kernel<4, CUDAFunctor_add<double>>``."""
    s = _strip_call(name.removeprefix("void "))
    s = s.replace("::operator()() const", "").replace("(anonymous namespace)::", "")
    while ")::" in s:  # a lambda's enclosing function's parameters
        end = s.index(")::")
        s = _strip_call(s[:end + 1]) + s[end + 1:]
    s = re.sub(r"::\{lambda\(\)#\d+\}", "", s)          # lambdas without parameters
    s = re.sub(r"::\{lambda\(([^()]*)\)#\d+\}", r" lambda(\1)", s)
    s = re.sub(r"\b[A-Za-z_]\w*::", "", s)
    for p in _PLUMBING:
        s = re.sub(rf",\s*{p}", "", s)
    return re.sub(r">\s+>", ">>", re.sub(r">\s+>", ">>", s)).strip()


def phase_of(events, DeviceType):
    """For each CUDA kernel event of ``events``, the ``musica.<phase>`` span
    whose device-side range holds its start (``-`` for none)."""
    spans = [(e.time_range.start, e.time_range.end, e.name[len("musica."):]) for e in events
             if e.device_type == DeviceType.CUDA and e.name.startswith("musica.")]
    out = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.name.startswith("musica."):
            t = e.time_range.start
            out[id(e)] = next((p for a, b, p in spans if a <= t <= b), "-")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=3072)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--anatomy", default="thorax")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile_torch"))
    ap.add_argument("--clahe", action="store_true",
                    help="the CLAHE gradation variant (ENABLE_CLAHE)")
    ap.add_argument("--linear-gradation", action="store_true",
                    help="grade the squared image (GRAD_WITH_LINEAR_IMAGE)")
    ap.add_argument("--fused-sdev", action="store_true",
                    help="the fused-sdev analysis (musica_forward(fused_sdev=True))")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 storage for the pyramid band streams")
    ap.add_argument("--graph", action="store_true",
                    help="also profile the replays of the captured graph (process_jit)")
    ap.add_argument("--spatial", default="",
                    help="DxS: profile process_sharded of D images, each image's rows over S "
                         "mesh entries on this card")
    ap.add_argument("--root", default=REPO,
                    help="the checkout whose package to profile (default: this one)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch: needs a CUDA GPU", file=sys.stderr)
        return 1
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
        synthetic_radiograph)
    # musica.py lies in <root>/<package>/models
    assert os.path.abspath(musica.__file__).rsplit(os.sep, 3)[0] == os.path.abspath(args.root), \
        musica.__file__

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    cfg = MusicaConfig(image_size=args.size, enable_clahe=args.clahe,
                       grad_with_linear_image=args.linear_gradation,
                       storage="bfloat16" if args.bf16 else "float32")
    x = torch.from_numpy(synthetic_radiograph(args.size, args.anatomy)).cuda()
    per_call = 1  # images a profiled call processes
    if args.spatial:
        d, s = (int(v) for v in args.spatial.split("x"))
        mesh = sharding.make_mesh(n_data=d, n_space=s, devices=[x.device] * (d * s))
        xs, per_call = x.expand(d, -1, -1), d

        def forward():
            return sharding.process_sharded_eager(xs, cfg, mesh, fused_sdev=args.fused_sdev)

        def replay():
            return sharding.process_sharded(xs, cfg, mesh, fused_sdev=args.fused_sdev)
    else:
        def forward():
            return musica.musica_forward(x, cfg, fused_sdev=args.fused_sdev)["out_u8"]

        def replay():
            return musica.process_jit(x, cfg, args.fused_sdev)
    for _ in range(3):  # warm-up: kernel build, allocator, cuBLAS-free path
        forward()
    torch.cuda.synchronize()

    def profiled(fn, imgs=1):
        """(profiler, wall ms/img by CUDA events, kernel events, device busy
        ms/img, kernels/img) of ``args.reps`` calls of ``fn``, each of
        ``imgs`` images."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(args.reps):
                fn()
            end.record()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events
                   if e.device_type == DeviceType.CUDA and not e.key.startswith("musica.")]
        return (prof, start.elapsed_time(end) / args.reps / imgs, kernels,
                sum(e.self_device_time_total for e in kernels) / 1e3 / args.reps / imgs,
                sum(e.count for e in kernels) / args.reps / imgs)

    def by_label(prof, imgs=1):
        """Every kernel label of ``prof``'s run: {label: {ms, launches (per
        image), phases {phase: [ms, launches] per image}, names}}."""
        events = prof.events()
        phase = phase_of(events, DeviceType)
        scale = 1.0 / args.reps / imgs
        rows = collections.defaultdict(lambda: {"ms": 0.0, "launches": 0.0, "phases": {},
                                                "names": set()})
        for e in events:
            if id(e) not in phase:
                continue
            r = rows[label(e.name)]
            ms = e.time_range.elapsed_us() / 1e3 * scale
            r["ms"] += ms
            r["launches"] += scale
            p = r["phases"].setdefault(phase[id(e)], [0.0, 0.0])
            p[0] += ms
            p[1] += scale
            r["names"].add(e.name)
        return rows

    def print_top(rows, phases_from=None):
        """The TOP labels by device time; each with the phases its launches
        fall in (``phases_from``: the eager run's, for a replay)."""
        top = sorted(rows.items(), key=lambda kv: -kv[1]["ms"])[:TOP]
        for name, r in top:
            ph = (phases_from or rows).get(name, {}).get("phases", {})
            where = ", ".join(f"{p} {v[0]:.3f}/{v[1]:.0f}" for p, v in
                              sorted(ph.items(), key=lambda kv: -kv[1][0]))
            print(f"  {r['ms']:9.3f} {r['launches']:7.1f}  {name}  [{where}]")
        return [{"label": name, "ms_per_img": r["ms"], "launches_per_img": r["launches"],
                 "phases": (phases_from or rows).get(name, {}).get("phases", {}),
                 "names": sorted(r["names"])} for name, r in top]

    def hand_written(kernels, imgs=1):
        for label, pattern in HAND_WRITTEN.items():
            hits = [e for e in kernels if re.search(pattern, e.key)]
            ms = sum(e.self_device_time_total for e in hits) / 1e3 / args.reps / imgs
            print(f"  {ms:9.3f} {sum(e.count for e in hits) / args.reps / imgs:7.1f}  {label}")

    prof, wall, kernels, busy, launches = profiled(forward, per_call)
    events = prof.key_averages()
    on_gpu = [e for e in events if e.device_type == DeviceType.CUDA]

    print(f"card: {card}")
    variant = " + ".join(v for v, on in (("CLAHE", args.clahe),
                                         ("linear gradation", args.linear_gradation),
                                         ("fused sdev", args.fused_sdev),
                                         ("bf16 bands", args.bf16)) if on)
    if args.spatial:
        variant = f"{variant or 'main path'}; spatial path over {args.spatial} entries on one card"
    print(f"{args.size}^2 {args.anatomy} ({variant or 'main path'}), "
          f"{args.reps} reps under the profiler: "
          f"{wall:.3f} ms/img wall (CUDA events), {launches:.0f} kernels/img, "
          f"device busy {busy:.3f} ms/img = {100 * busy / wall:.1f} %")
    # a span has a host row (time spent issuing its ops) and a device row
    # (first to last kernel of the span on the GPU timeline)
    host = {e.key: e.cpu_time_total for e in events
            if e.key.startswith("musica.") and e.device_type == DeviceType.CPU}
    span = {e.key: e.device_time_total for e in on_gpu if e.key.startswith("musica.")}
    print("per phase, ms/img:       host issue   device span")
    for k in sorted(host, key=lambda k: -host[k]):
        print(f"  {k:20s} {host[k] / 1e3 / args.reps:12.3f} "
              f"{span.get(k, 0.0) / 1e3 / args.reps:13.3f}")
    print("hand-written kernels (ms/img, launches/img):")
    hand_written(kernels, per_call)
    print("top kernels by device time (ms/img, launches/img, label [phase ms/img/launches "
          "per img, ...]):")
    eager_rows = by_label(prof, per_call)
    tops = {"eager": print_top(eager_rows)}
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    if args.graph or args.spatial:
        for _ in range(3):  # the capture, then replays
            replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        windows = []
        for _ in range(5):
            start.record()
            for _ in range(args.reps):
                replay()
            end.record()
            torch.cuda.synchronize()
            windows.append(start.elapsed_time(end) / args.reps / per_call)
        print(f"graph replays without the profiler: {sorted(windows)[2]} ms/img (median of 5 "
              f"windows of {args.reps}; ms/img: {windows}); package {args.root}")
        g_prof, g_wall, g_kernels, g_busy, g_launches = profiled(replay, per_call)
        what = "process_sharded" if args.spatial else "process_jit"
        print(f"graph replays ({what}), {args.reps} reps under the profiler: "
              f"{g_wall:.3f} ms/img wall (CUDA events), {g_launches:.0f} kernels/img, "
              f"device busy {g_busy:.3f} ms/img = {100 * g_busy / g_wall:.1f} % "
              f"(eager: {wall:.3f} ms/img wall, {launches:.0f} kernels/img, "
              f"busy {busy:.3f} ms/img = {100 * busy / wall:.1f} %)")
        print("hand-written kernels in the replays (ms/img, launches/img):")
        hand_written(g_kernels, per_call)
        print("top kernels in the replays (ms/img, launches/img, label [the eager run's phases "
              "of the label]):")
        tops["replay"] = print_top(by_label(g_prof, per_call), eager_rows)
        g_prof.export_chrome_trace(os.path.join(args.out, "trace_graph.json"))
    with open(os.path.join(args.out, "top_kernels.json"), "w") as f:
        json.dump({"card": card, **tops}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

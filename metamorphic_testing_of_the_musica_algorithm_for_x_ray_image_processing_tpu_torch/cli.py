"""Command-line interface of the PyTorch port: ``process`` and ``batch``,
the HTML ``report`` and the HTTP viewer ``view``, the metamorphic
``campaign`` and its analysis tools ``slope-analysis`` and ``mean-cnr``.

The formats are those of the JAX package's CLI (and of the reference
standalone CLI): a raw radiograph with a 256-byte header, loaded transposed,
in; a margin-10-cropped 8-bit BMP out; the campaign's CSVs.

Usage:
    python -m metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.cli process in.raw out.bmp
    python -m ...cli process --size 3072 --device cpu --debug-dump dbg/ in.raw out.bmp
    python -m ...cli process --clahe --linear-gradation --timing in.raw out.bmp
    python -m ...cli process --bf16 in.raw out.bmp
    python -m ...cli process --save-last-raw last.raw --cnr-out cnr.bmp --profile prof/ in.raw out.bmp
    python -m ...cli report in.raw report_dir/
    python -m ...cli view --port 8000 in.raw
    python -m ...cli batch --size 3072 'raws/*.raw' outdir/
    python -m ...cli batch --profile prof/ 'raws/*.raw' outdir/
    python -m ...cli campaign --size 3072 --out-dir mt_out/
    python -m ...cli slope-analysis mt_out/deltas.csv
    python -m ...cli mean-cnr cnr_bmps/
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time


def _add_common(p):
    p.add_argument("--size", type=int, default=3072,
                   help="square image size (reference standalone: 3072)")
    p.add_argument("--no-transpose", action="store_true",
                   help="skip the reference CLI's transposed raw load")
    p.add_argument("--no-quirks", action="store_true",
                   help="clean math instead of bit-faithful GPU quirks")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")


def _start_profile(out_dir, device):
    """A started ``torch.profiler`` for ``--profile DIR`` (None without the
    flag): the deep-profiling analogue of the reference's MSVC /PROFILE
    link flag (CMakeLists.txt:14-16), a Chrome trace of the host and, on a
    CUDA device, of the device timeline with the port's ``musica.*`` spans
    (``utils/spans.py``).  Only starting the profiler may fail, with a
    warning."""
    if not out_dir:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=activities)
        prof.start()
    except Exception as e:  # noqa: BLE001 - profiling must never break processing
        print(f"profiler unavailable ({type(e).__name__}: {e})", file=sys.stderr)
        return None
    return prof


def _stop_profile(prof, out_dir) -> None:
    """Stop ``_start_profile``'s profiler and write ``out_dir/trace.json``."""
    if prof is None:
        return
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    print(f"profile trace -> {os.path.join(out_dir, 'trace.json')}")


def cmd_process(args) -> int:
    from . import MusicaConfig
    from .models import musica
    from .utils import io as uio
    from .utils.debug import cnr_u8, dump_intermediates, numpy_tree

    cfg = MusicaConfig(image_size=args.size, quirks=not args.no_quirks,
                       enable_clahe=args.clahe,
                       grad_with_linear_image=args.linear_gradation,
                       storage="bfloat16" if args.bf16 else "float32")
    raw = uio.load_raw(args.input, args.size, transpose=not args.no_transpose)
    if args.save_last_raw:
        # saveLastRawImage analogue (src/vk_processing.cpp:2811-2815)
        uio.save_raw(args.save_last_raw, raw)
    prof = _start_profile(args.profile, args.device)
    t0 = time.perf_counter()
    res = None
    if args.timing:
        # MEASURE_PROCESS analogue: per-phase fenced timing
        out, times = musica.timed_process(raw, cfg, args.device)
        print(" \t ".join(f"{k}: {v:.2f}" for k, v in times.items()))
    else:
        # eager, not musica.process_jit as in the JAX package's CLI: one
        # image per process, so a graph's warm-up and capture would cost
        # more than its replay saves, and --debug-dump, --cnr-out and
        # --profile read the eager run's intermediates, CNR map and spans
        res = musica.musica_forward(musica.to_device(raw, args.device), cfg,
                                    want_intermediates=bool(args.debug_dump))
        out = numpy_tree(res["out_u8"])  # waits for the device
        if args.debug_dump:
            dump_intermediates({k: numpy_tree(v) for k, v in res["intermediates"].items()},
                               args.debug_dump)
    if args.cnr_out:
        # CNR_DEBUG analogue (shaders/cnr_debug.comp): the CNR map as a
        # grayscale BMP, the input format of `mean-cnr`; the timed run
        # returns no CNR map, so it takes a run of its own
        if res is None:
            res = musica.musica_forward(musica.to_device(raw, args.device), cfg)
        uio.save_bmp8(args.cnr_out, cnr_u8(numpy_tree(res["cnr"])))
    dt = time.perf_counter() - t0
    _stop_profile(prof, args.profile)
    uio.save_bmp8(args.output, out)
    print(f"processed {args.input} ({args.size}^2) on {args.device} in "
          f"{dt * 1e3:.1f} ms (incl. kernel build on first use) -> {args.output}")
    return 0


def cmd_batch(args) -> int:
    import numpy as np

    from . import MusicaConfig
    from .models import musica
    from .utils import io as uio

    files = sorted(glob.glob(args.pattern))
    if not files:
        print(f"no files match {args.pattern}", file=sys.stderr)
        return 1
    cfg = MusicaConfig(image_size=args.size, quirks=not args.no_quirks,
                       storage="bfloat16" if args.bf16 else "float32")
    os.makedirs(args.out_dir, exist_ok=True)
    B = max(1, args.batch)
    prof = _start_profile(args.profile, args.device)
    t0 = time.perf_counter()
    for start in range(0, len(files), B):
        chunk = files[start:start + B]
        raws = np.stack([uio.load_raw(f, args.size, transpose=not args.no_transpose)
                         for f in chunk])
        for f, out in zip(chunk, musica.process_batch(raws, cfg, args.device)):
            name = os.path.splitext(os.path.basename(f))[0] + ".bmp"
            uio.save_bmp8(os.path.join(args.out_dir, name), out)
    dt = time.perf_counter() - t0
    _stop_profile(prof, args.profile)
    print(f"{len(files)} images on {args.device} in {dt:.2f}s "
          f"({len(files) * args.size ** 2 / dt / 1e9:.3f} GPix/s incl. IO)")
    return 0


def cmd_report(args) -> int:
    from . import MusicaConfig
    from .utils import io as uio
    from .utils.report import write_report

    cfg = MusicaConfig(image_size=args.size, quirks=not args.no_quirks)
    raw = uio.load_raw(args.input, args.size, transpose=not args.no_transpose)
    index = write_report(raw, args.out_dir, cfg, title=args.input, device=args.device)
    print(f"report -> {index}")
    return 0


def cmd_view(args) -> int:
    from . import MusicaConfig
    from .utils.viewer import serve

    cfg = MusicaConfig(image_size=args.size, quirks=not args.no_quirks)
    serve(args.input, cfg, transpose=not args.no_transpose, host=args.host,
          port=args.port, report_dir=args.report_dir, device=args.device)
    return 0


def cmd_campaign(args) -> int:
    from .testing.campaign import run_campaign
    run_campaign(out_dir=args.out_dir, image_size=args.size,
                 anatomies=args.anatomies.split(",") if args.anatomies else None,
                 input_dir=args.input_dir,
                 seed=args.seed,
                 save_images=args.save_images,
                 quirks=not args.no_quirks,
                 transpose=not args.no_transpose,
                 storage="bfloat16" if args.bf16 else "float32",
                 device=args.device)
    return 0


def cmd_slope(args) -> int:
    from .testing.analysis import slope_analysis_file
    for line in slope_analysis_file(args.csv, out_file=args.out,
                                    wilcoxon=args.wilcoxon):
        print(line)
    return 0


def cmd_mean_cnr(args) -> int:
    from .testing.analysis import mean_cnr_dir
    for name, val in mean_cnr_dir(args.in_dir, out_file=args.out):
        print(f"{name} \t {val}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="musica-torch", description="MUSICA pipeline on PyTorch/CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("process", help="raw in -> processed BMP out")
    _add_common(p)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--debug-dump", default=None,
                   help="directory for intermediate-image BMPs (debugProcess)")
    p.add_argument("--timing", action="store_true",
                   help="per-phase fenced timing (MEASURE_PROCESS analogue)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run to "
                        "DIR/trace.json (host, and the device on CUDA; "
                        "/PROFILE analogue)")
    p.add_argument("--save-last-raw", default=None,
                   help="re-save the loaded raw (saveLastRawImage analogue)")
    p.add_argument("--cnr-out", default=None,
                   help="write the CNR map as BMP (CNR_DEBUG analogue; "
                        "feeds the mean-cnr subcommand)")
    p.add_argument("--clahe", action="store_true",
                   help="enable the CLAHE gradation variant (ENABLE_CLAHE)")
    p.add_argument("--linear-gradation", action="store_true",
                   help="grade the squared image (GRAD_WITH_LINEAR_IMAGE)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 storage for the pyramid band streams (fast "
                        "mode, config.py storage=\"bfloat16\"; level inputs "
                        "and the analysis path stay f32 -- output tracks "
                        "the parity mode within ~1 LSB on most pixels, up "
                        "to ~a dozen LSB where the data-dependent tone "
                        "curve's knots shift a bin; intended for images "
                        ">= 512 px, see tests/test_bf16.py)")
    p.set_defaults(fn=cmd_process)

    p = sub.add_parser("batch", help="process a glob of raw files")
    _add_common(p)
    p.add_argument("pattern")
    p.add_argument("out_dir")
    p.add_argument("--batch", type=int, default=4,
                   help="images per process_batch call")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run to "
                        "DIR/trace.json, with the spans musica.request (a "
                        "process_batch call), musica.replay and musica.graph "
                        "(each image's graph replay; see `process --profile`)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 storage for the pyramid band streams (fast "
                        "mode; see `process --bf16`)")
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser("report", help="HTML gallery of all pipeline stages "
                                      "(the GUI viewer's headless analogue)")
    _add_common(p)
    p.add_argument("input")
    p.add_argument("out_dir")
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser("view", help="interactive HTTP viewer (the GLFW/"
                                    "ImGui app shell's live analogue: "
                                    "double-buffered out image, render "
                                    "panels, execute/debugProcess buttons)")
    _add_common(p)
    p.add_argument("input", help="raw input image (re-read on each execute)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--report-dir", default="viewer_report",
                   help="debugProcess() output directory")
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("campaign", help="run the metamorphic-testing campaign")
    _add_common(p)
    p.add_argument("--out-dir", default="mt_out")
    p.add_argument("--anatomies", default=None,
                   help="comma-separated subset of foot,hand,head,knee,pelvis,thorax")
    p.add_argument("--input-dir", default=None,
                   help="directory of real anatomy data (<anatomy>/image.raw "
                        "+ optional <anatomy>/proc vendor DICOM ground "
                        "truth, the reference harness's INPUT_PATH layout); "
                        "default: synthetic phantoms")
    p.add_argument("--save-images", action="store_true",
                   help="save every altered input raw and processed BMP per "
                        "case (script.py:417-421 save_image behavior)")
    p.add_argument("--seed", type=int, default=0,
                   help="RNG seed for the noise/collimator perturbations")
    p.add_argument("--bf16", action="store_true",
                   help="run the campaign against the bf16 fast mode "
                        "(storage=\"bfloat16\") -- measures whether the "
                        "fast mode preserves the metamorphic robustness "
                        "profile (see `process --bf16`)")
    p.set_defaults(fn=cmd_campaign)

    p = sub.add_parser("slope-analysis",
                       help="per-alteration linear-regression slope test")
    p.add_argument("csv")
    p.add_argument("--out", default=None)
    p.add_argument("--wilcoxon", action="store_true",
                   help="also run the Wilcoxon signed-rank test per group "
                        "(the reference's commented-out branch, "
                        "test/reg_vs_dir_delta/script.py:30-33)")
    p.set_defaults(fn=cmd_slope)

    p = sub.add_parser("mean-cnr", help="mean CNR of debug BMPs in a directory")
    p.add_argument("in_dir")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_mean_cnr)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""Command-line interface of the PyTorch port: ``process`` and ``batch``.

The formats are those of the JAX package's CLI (and of the reference
standalone CLI): a raw radiograph with a 256-byte header, loaded transposed,
in; a margin-10-cropped 8-bit BMP out.

Usage:
    python -m metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.cli process in.raw out.bmp
    python -m ...cli process --size 3072 --device cpu --debug-dump dbg/ in.raw out.bmp
    python -m ...cli batch --size 3072 'raws/*.raw' outdir/
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


def _numpy_tree(v):
    """Intermediates as numpy arrays (tuples kept as tuples)."""
    if isinstance(v, tuple):
        return tuple(_numpy_tree(x) for x in v)
    return v.cpu().numpy()


def cmd_process(args) -> int:
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import io as uio
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils.debug import dump_intermediates

    from . import MusicaConfig
    from .models import musica

    cfg = MusicaConfig(image_size=args.size, quirks=not args.no_quirks)
    raw = uio.load_raw(args.input, args.size, transpose=not args.no_transpose)
    t0 = time.perf_counter()
    if args.debug_dump:
        img = musica.to_device(raw, args.device)
        res = musica.musica_forward(img, cfg, want_intermediates=True)
        out = res["out_u8"].cpu().numpy()
        dump_intermediates({k: _numpy_tree(v) for k, v in res["intermediates"].items()},
                           args.debug_dump)
    else:
        out = musica.process(raw, cfg, args.device)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    uio.save_bmp8(args.output, out)
    print(f"processed {args.input} ({args.size}^2) on {args.device} in "
          f"{dt * 1e3:.1f} ms (incl. kernel build on first use) -> {args.output}")
    return 0


def cmd_batch(args) -> int:
    import numpy as np
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import io as uio

    from . import MusicaConfig
    from .models import musica

    files = sorted(glob.glob(args.pattern))
    if not files:
        print(f"no files match {args.pattern}", file=sys.stderr)
        return 1
    cfg = MusicaConfig(image_size=args.size, quirks=not args.no_quirks)
    os.makedirs(args.out_dir, exist_ok=True)
    B = max(1, args.batch)
    t0 = time.perf_counter()
    for start in range(0, len(files), B):
        chunk = files[start:start + B]
        raws = np.stack([uio.load_raw(f, args.size, transpose=not args.no_transpose)
                         for f in chunk])
        for f, out in zip(chunk, musica.process_batch(raws, cfg, args.device)):
            name = os.path.splitext(os.path.basename(f))[0] + ".bmp"
            uio.save_bmp8(os.path.join(args.out_dir, name), out)
    dt = time.perf_counter() - t0
    print(f"{len(files)} images on {args.device} in {dt:.2f}s "
          f"({len(files) * args.size ** 2 / dt / 1e9:.3f} GPix/s incl. IO)")
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
    p.set_defaults(fn=cmd_process)

    p = sub.add_parser("batch", help="process a glob of raw files")
    _add_common(p)
    p.add_argument("pattern")
    p.add_argument("out_dir")
    p.add_argument("--batch", type=int, default=4,
                   help="images per process_batch call")
    p.set_defaults(fn=cmd_batch)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

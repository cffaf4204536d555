"""HTML report of the PyTorch port -- the headless analogue of the
reference's GLFW/ImGui viewer (``maverick-app``, include/app.h +
src/app.cpp), after the JAX package's ``utils/report.py``.

The GUI displayed the processed output images plus the GPU-rendered noise-
histogram and gradation-curve panels (src/app.cpp:64-144).  Here
``write_report`` runs the pipeline with intermediates on a device and writes
a self-contained directory: stage BMPs, histogram/curve renders, and an
``index.html`` gallery with the JAX package's sections and stats rows.
"""

from __future__ import annotations

import html
from pathlib import Path

import numpy as np

from ..config import MusicaConfig
from ..models import musica
from .debug import cnr_u8, dump_intermediates, numpy_tree
from .io import save_bmp8

_SECTIONS = [
    ("Output", ["out"]),
    ("Input domain", ["normalized", "relevant", "cnr"]),
    ("Histograms & curves", ["noise_hist", "grad_hist"]),
    ("Reduce pyramid (bandpass)", ["red_bandpass_0", "red_bandpass_1",
                                   "red_bandpass_2", "red_bandpass_3"]),
    ("Analysis", ["sdev_0", "sdev_3"]),
    ("Noise reduction", ["nr_bandpass_0", "nr_bandpass_1", "nr_bandpass_2"]),
]


def write_report(raw_u16: np.ndarray, out_dir: str,
                 cfg: MusicaConfig | None = None,
                 title: str = "MUSICA report", device="cuda") -> Path:
    """Process ``raw_u16`` with intermediates on ``device`` (one
    ``musica_forward``) and write the gallery.  Returns the path of
    index.html."""
    cfg = cfg or MusicaConfig(image_size=raw_u16.shape[-1])
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    res = musica.musica_forward(musica.to_device(raw_u16, device), cfg,
                                want_intermediates=True)
    inter = {k: numpy_tree(v) for k, v in res["intermediates"].items()}
    dump_intermediates(inter, str(out))
    save_bmp8(out / "out.bmp", numpy_tree(res["out_u8"]))
    save_bmp8(out / "cnr.bmp", cnr_u8(numpy_tree(res["cnr"])))

    _, _, tvals = inter["grad_curve"]
    stats_rows = [
        ("image size", f"{cfg.image_size} x {cfg.image_size}"),
        ("pyramid levels", str(cfg.pyramid_levels)),
        ("sqrt max / min", f"{float(inter['sqrt_max']):.1f} / "
                           f"{float(inter['sqrt_min']):.1f}"),
        ("gradation window t0/ta/t1",
         " / ".join(f"{float(t):.4f}" for t in tvals)),
    ] + [(f"noise peak bin, level {i}", str(int(inter[f'noise_max_bin_{i}'])))
         for i in cfg.analysis_levels]

    parts = [f"<html><head><title>{html.escape(title)}</title>",
             "<style>body{font-family:sans-serif;background:#111;color:#eee}"
             "img{image-rendering:pixelated;max-width:480px;margin:4px;"
             "border:1px solid #444}td{padding:2px 12px}</style></head><body>",
             f"<h1>{html.escape(title)}</h1><table>"]
    for k, v in stats_rows:
        parts.append(f"<tr><td>{html.escape(k)}</td><td>{html.escape(v)}</td></tr>")
    parts.append("</table>")
    for section, names in _SECTIONS:
        imgs = [n for n in names if (out / f"{n}.bmp").exists()]
        if not imgs:
            continue
        parts.append(f"<h2>{html.escape(section)}</h2>")
        for n in imgs:
            parts.append(f"<figure style='display:inline-block'>"
                         f"<img src='{n}.bmp'/><figcaption>{n}</figcaption>"
                         f"</figure>")
    parts.append("</body></html>")
    index = out / "index.html"
    index.write_text("\n".join(parts))
    return index

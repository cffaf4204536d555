"""The metamorphic-testing campaign on PyTorch.

The port of the JAX package's ``testing/campaign.py``
(``test/metamorphic_test/script.py``, module body :216-664): for each
anatomy, process the unaltered raw, then every perturbation of every MR
family, and measure similarity (a) against the pipeline's own unaltered
output -- robustness, (b) against a reference image -- fidelity, (c) after
registration normalization (cropping/aligning both to the altered region,
accounting for the margin-10 processing crop).  Writes the same three CSVs:

  direct_robustness.csv / reg_based_robustness.csv / ref_similarities.csv

and ``deltas.csv``, the table the slope analysis reads.

The system under test is ``models.musica.process`` on the campaign's
device (a ``runner`` hook substitutes any other implementation).  The
perturbations run on the host in NumPy and draw from one generator in the
JAX package's order, so the altered raws are byte-equal to its.  Every
row's six similarity numbers come from ``metrics.measure_row`` on the
campaign's device, against the unaltered output and the reference, which
are uploaded once per anatomy; the registration rows' rotated references
are rotated on the host (``perturb.rotate_nearest_u8``) and uploaded.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import MusicaConfig
from ..utils import io as uio
from . import metrics, perturb
from .phantoms import ANATOMIES, synthetic_radiograph

PROCESSING_MARGIN = 10

R_CSV = "direct_robustness.csv"
NR_CSV = "reg_based_robustness.csv"
S_CSV = "ref_similarities.csv"

_ROBUSTNESS_HEADER = [
    "raw file", "alteration",
    "altered vs unaltered mse", "altered vs unaltered ssim",
    "altered vs unaltered histogram distance",
    "altered vs reference mse", "altered vs reference ssim",
    "altered vs reference histogram distance",
    "normalized altered vs reference mse",
    "normalized altered vs reference ssim",
    "normalized altered vs reference histogram distance",
]


def _measure_row(alt, unalt_t, ref_t, ovd):
    """Six similarity numbers (``metrics.measure_row``: ``unalt_t`` and
    ``ref_t`` are uint8 tensors on the campaign's device) + the three
    reference-normalized ratios."""
    (own_mse, own_ssim, own_hist, ref_mse, ref_ssim,
     ref_hist) = metrics.measure_row(alt, unalt_t, ref_t)
    ovd_mse, ovd_ssim, ovd_hist = ovd
    return [own_mse, own_ssim, own_hist, ref_mse, ref_ssim, ref_hist,
            ref_mse / ovd_mse, ref_ssim / ovd_ssim,
            (ref_hist - ovd_hist) / (1.0 - ovd_hist) if ovd_hist != 1.0 else 0.0]


def default_runner(image_size: int, quirks: bool = True,
                   transpose: bool = True,
                   storage: str = "float32",
                   device="cuda") -> Callable:
    """In-process system under test: raw array (file layout) -> output u8,
    ``models.musica.process`` on ``device``.

    Applies the standalone CLI's transpose on load
    (test/standalone/main.cpp:67-75) so results match `cli process`;
    ``transpose=False`` mirrors `cli process --no-transpose`.

    ``storage="bfloat16"`` runs the campaign against the bf16 fast mode
    (cli: ``campaign --bf16``) -- the MT harness then measures whether the
    fast mode preserves the metamorphic robustness profile.
    """
    from ..models import musica
    cfg = MusicaConfig(image_size=image_size, quirks=quirks, storage=storage)

    def run(raw_u16: np.ndarray) -> np.ndarray:
        return musica.process(raw_u16.T if transpose else raw_u16, cfg, device)

    return run


def dicom_to_reference(arr: np.ndarray) -> np.ndarray:
    """DICOM pixel array -> 8-bit inverted ground-truth image
    (test/metamorphic_test/script.py:396-405): the reference's PIL chain is
    a truncating v // 256, then 255 - v."""
    if arr.dtype != np.uint8:
        arr = (arr / 256).astype(np.uint8)
    return (255 - arr).astype(np.uint8)


def load_reference_image(path: str, size: int) -> Optional[np.ndarray]:
    """Vendor-processed DICOM ground truth, 16->8 bit + inverted
    (script.py:396-405).  Returns None when pydicom is unavailable."""
    try:
        import pydicom
    except ImportError:
        return None
    ds = pydicom.dcmread(path)
    return dicom_to_reference(ds.pixel_array)


def advance_rng(rng: np.random.Generator, image_size: int,
                anatomies: Sequence[str]) -> np.random.Generator:
    """Draw from ``rng`` what ``run_campaign`` draws for the synthetic
    ``anatomies`` (the collimator, gaussian and quantum perturbations of
    their raws, in its order), processing nothing: a campaign of the
    anatomies that follow, given this generator, perturbs its raws as the
    whole campaign does.  The numbers of values NumPy's Poisson and normal
    samplers consume depend on the data, so the draws are made in full."""
    shutters = perturb._scaled(perturb.COLLIMATOR_SHUTTERS, image_size)
    for anat in anatomies:
        raw = synthetic_radiograph(image_size, anat)
        for shutter in shutters:
            perturb.apply_collimator(raw, shutter, shutter, rng)
        for sd in perturb.GAUSSIAN_SIGMAS:
            perturb.add_gaussian_noise(raw, 0.0, sd, rng)
        for fac in perturb.QUANTUM_FACTORS:
            perturb.apply_quantum_noise(raw, fac, rng)
    return rng


def run_campaign(out_dir: str = "mt_out", image_size: int = 3072,
                 anatomies: Optional[Sequence[str]] = None,
                 input_dir: Optional[str] = None,
                 runner: Optional[Callable] = None,
                 seed: int = 0,
                 save_images: bool = False,
                 quirks: bool = True,
                 transpose: bool = True,
                 storage: str = "float32",
                 device="cuda",
                 rng: Optional[np.random.Generator] = None) -> dict:
    """Run the full campaign; returns {csv_name: rows} and writes the CSVs.

    ``quirks``/``transpose``/``storage`` configure the default in-process
    runner (they are ignored when an explicit ``runner`` is passed);
    ``device`` is where the default runner processes and where every row is
    measured; ``save_images`` mirrors the reference harness, which saves
    every altered input raw and processed BMP per case (script.py:417-421).
    ``rng`` replaces ``np.random.default_rng(seed)``: a caller that runs the
    last anatomies of a campaign alone passes one that ``advance_rng`` took
    past the others."""
    t_start = time.time()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False")
    anatomies = list(anatomies or ANATOMIES)
    runner = runner or default_runner(image_size, quirks=quirks,
                                      transpose=transpose,
                                      storage=storage, device=dev)
    rng = rng if rng is not None else np.random.default_rng(seed)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    trans = perturb._scaled(perturb.TRANSLATIONS, image_size)
    shutters = perturb._scaled(perturb.COLLIMATOR_SHUTTERS, image_size)

    results = {R_CSV: [_ROBUSTNESS_HEADER],
               NR_CSV: [_ROBUSTNESS_HEADER],
               S_CSV: [["raw file", "mse similarity", "ssim similarity",
                        "histogram distance"]]}

    def save_case(name, img_u8, raw_u16=None):
        """Mirror the reference's per-case artifacts: the altered input raw
        (save_image, script.py:417-421 -- zero-filled 256-byte header) plus
        the processed BMP output."""
        if save_images:
            uio.save_bmp8(out / f"{name}.bmp", img_u8)
            if raw_u16 is not None:
                uio.save_raw(out / f"{name}.raw", raw_u16)

    def upload(img_u8):
        return torch.from_numpy(np.array(img_u8, np.uint8)).to(dev)  # a writable copy

    # seconds spent on the host's perturbations, in the runner and on the
    # rows' metrics (the registration crops and rotations included)
    spent = {"perturbation": 0.0, "process": 0.0, "metrics": 0.0}

    def timed(part, fn, *args):
        t0 = time.perf_counter()
        value = fn(*args)
        spent[part] += time.perf_counter() - t0
        return value

    def measure(alt, unalt_t, ref_t, ovd):
        return timed("metrics", _measure_row, alt, unalt_t, ref_t, ovd)

    for anat in anatomies:
        if input_dir:
            raw = uio.load_raw(Path(input_dir) / anat / "image.raw",
                               image_size, transpose=False)
            ref_path = Path(input_dir) / anat / "proc"
            reference = (load_reference_image(str(ref_path), image_size)
                         if ref_path.exists() else None)
        else:
            raw = synthetic_radiograph(image_size, anat)
            reference = None

        unalt = runner(raw)
        save_case(f"{anat}_unaltered", unalt)
        if reference is None:
            # no vendor ground truth: the unaltered output is the reference
            reference = unalt
        else:
            m = PROCESSING_MARGIN
            reference = reference[m:image_size - m, m:image_size - m]

        # device-resident copies (uploaded once per anatomy; every row then
        # ships only the altered image)
        unalt_t = upload(unalt)
        reference_t = unalt_t if reference is unalt else upload(reference)
        vals = metrics.measure_row(unalt, unalt_t, reference_t)
        ovd = (vals[3], vals[4], vals[5])
        results[S_CSV].append([anat, *ovd])

        def direct(name, perturbation, *args):
            alt_img = timed("perturbation", perturbation, raw, *args)
            alt_out = timed("process", runner, alt_img)
            save_case(f"{anat}_{name}", alt_out, raw_u16=alt_img)
            results[R_CSV].append(
                [anat, name, *measure(alt_out, unalt_t, reference_t, ovd)])
            return alt_out

        # collimator (+ registration-normalized: crop to the open window)
        for shutter in shutters:
            name = f"c_sh_{shutter}"
            alt_out = direct(name, perturb.apply_collimator, shutter, shutter, rng)
            x = shutter + PROCESSING_MARGIN
            wdt = alt_out.shape[1] - (2 * shutter + 2 * PROCESSING_MARGIN)
            if wdt > 32:
                sl = (slice(x, x + wdt), slice(x, x + wdt))
                results[NR_CSV].append(
                    [anat, name, *measure(alt_out[sl], unalt_t[sl], reference_t[sl], ovd)])

        # translation x / y (normalized: overlap region)
        for t, axis in [(tx, "x") for tx in trans] + [(ty, "y") for ty in trans]:
            name = f"t_{axis}_{t}"
            shift = (t, 0) if axis == "x" else (0, t)  # (x_shift, y_shift)
            alt_out = direct(name, perturb.clamp_translation, *shift)
            n = alt_out.shape[0]
            if axis == "x":
                a_sl = (slice(0, n), slice(t, n))
                u_sl = (slice(0, n), slice(PROCESSING_MARGIN, n - t + PROCESSING_MARGIN))
            else:
                a_sl = (slice(t, n), slice(0, n))
                u_sl = (slice(PROCESSING_MARGIN, n - t + PROCESSING_MARGIN), slice(0, n))
            if n - t > 32:
                results[NR_CSV].append(
                    [anat, name, *measure(alt_out[a_sl], unalt_t[u_sl],
                                          reference_t[u_sl], ovd)])

        # rotation (normalized: largest inner rect of the back-rotated pair)
        for deg in perturb.ROTATIONS:
            name = f"r_{deg}"
            alt_out = direct(name, perturb.clamp_rotate, deg)
            h, w = alt_out.shape
            l, tp, r, btm = perturb.inner_rect_after_rotation(w, h, deg)
            sl = (slice(tp, btm), slice(l, r))

            def rotated(img):
                return upload(perturb.rotate_nearest_u8(img, deg)[sl])

            rot_u_t = timed("metrics", rotated, unalt)
            rot_r_t = rot_u_t if reference is unalt else timed("metrics", rotated, reference)
            results[NR_CSV].append(
                [anat, name, *measure(alt_out[sl], rot_u_t, rot_r_t, ovd)])

        # gaussian noise (direct only, as in the reference)
        for sd in perturb.GAUSSIAN_SIGMAS:
            direct(f"gn_{sd}", perturb.add_gaussian_noise, 0.0, sd, rng)

        # quantum noise (direct only)
        for fac in perturb.QUANTUM_FACTORS:
            direct(f"pn_{fac}", perturb.apply_quantum_noise, fac, rng)

    for name, rows in results.items():
        with open(out / name, "w", newline="") as f:
            csv.writer(f).writerows(rows)

    # the delta table (reference: test/reg_vs_dir_delta/results.csv) feeding
    # the slope analysis
    from .analysis import build_delta_table
    deltas = build_delta_table(results[R_CSV])
    with open(out / "deltas.csv", "w", newline="") as f:
        csv.writer(f, delimiter=";").writerows(deltas)
    results["deltas.csv"] = deltas

    print(f"campaign: {len(anatomies)} anatomies, "
          f"{len(results[R_CSV]) - 1} cases, "
          f"{(time.time() - t_start) / 60:.1f} min on {dev} ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()) + ")")
    return results

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port of MUSICA on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``..._tpu_torch/csrc`` with nvcc, holds every
kernel against its plain PyTorch version at the main path's shapes (integer
histograms and argmaxes must be exactly equal), drives the port's main path
(``process`` on a 3072^2 uint16 radiograph, then the intermediates path of
``process --debug-dump``) and checks that it went through the kernels, runs
a batch of 4 through ``process_batch``, and times the pipeline and each
kernel beside its plain version with CUDA events.

Every phase prints one line; any failure raises and exits non-zero.  The
line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SIZE = 3072
BATCH = 4
PKG = "metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch"
SOURCE = f"{PKG}/csrc/fused_hist.cu"
PALLAS = ("metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_"
          "processing_tpu/ops/pallas/fused_hist.py")
REPLACES = {
    "noise_hist": f"{PALLAS}:139 (_noise_kernel of noise_hist_fused; also the "
                  f"histogram of _noise_multi_kernel, :181)",
    "hist_argmax": f"{PALLAS}:181 (first-max argmax of _noise_multi_kernel, "
                   f":202-211)",
    "grad_hist_relevant": f"{PALLAS}:397 (_grad_relevant_kernel of "
                          f"grad_hist_relevant_fused)",
    "grad_hist": f"{PALLAS}:381 (_grad_kernel of grad_hist_fused)",
}
# u8 parity bar against the port's own CPU path (docs/PARITY.md)
MIN_PSNR, MIN_EXACT, MAX_DIFF = 90.0, 0.9999, 1


def log(msg: str) -> None:
    print(msg, flush=True)


def u8_agreement(a: np.ndarray, b: np.ndarray):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    mse = float(np.mean(d.astype(np.float64) ** 2))
    psnr = float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    return psnr, float(np.mean(d == 0)), int(d.max())


def check_parity(name: str, got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape, (name, got.shape, want.shape)
    psnr, exact, dmax = u8_agreement(got, want)
    log(f"  {name}: PSNR {psnr:.2f} dB, bit-exact {exact * 100:.5f} %, "
        f"max |du8| {dmax}")
    assert psnr >= MIN_PSNR and exact > MIN_EXACT and dmax <= MAX_DIFF, name


class KernelRecord:
    """max |kernel - plain| over every comparison, per kernel."""

    def __init__(self):
        self.err = {k: None for k in REPLACES}

    def equal(self, kernel: str, case: str, got, want) -> None:
        import torch
        assert got.shape == want.shape and got.dtype == want.dtype, \
            (kernel, case, got.shape, want.shape, got.dtype, want.dtype)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        prev = self.err[kernel]
        self.err[kernel] = err if prev is None else max(prev, err)
        log(f"  {kernel} [{case}]: max |kernel - plain| = {err}")
        assert err == 0, f"{kernel} [{case}] differs from its plain version"


def random_levels(rng, sizes, dev):
    """Noise-hist inputs with every break kind: zeros, values above 0.1 and
    values mapping to bin 0."""
    import torch
    out = []
    for n in sizes:
        sd = rng.uniform(0.0, 0.12, (n, n)).astype(np.float32)
        sd[rng.uniform(size=(n, n)) < 0.05] = 0.0
        sd[rng.uniform(size=(n, n)) < 0.01] = 1e-6
        out.append(torch.from_numpy(sd).to(dev))
    return out


def analysis_levels(img, cfg, dev):
    """The sdev images of the analysis levels, as the main path makes them."""
    import torch
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import (
        normalize, pyramid, stats)
    x = torch.from_numpy(img).to(dev)
    nrm, _, _ = normalize.normalize_from_u16(x, cfg.quirks)
    bands, _ = pyramid.reduce_ladder(nrm, cfg.pyramid_levels)
    return [stats.img_sdev(bands[i]) for i in cfg.analysis_levels]


def check_noise(rec, cfg, levels, case):
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh
    h = fh.noise_hists(levels, cfg)
    rec.equal("noise_hist", case, h, fh.noise_hists_plain(levels, cfg))
    rec.equal("hist_argmax", case, fh.hist_argmax(h), fh.hist_argmax_plain(h))


def cuda_ms(fn, reps: int, warmup: int = 1, device_only: bool = False) -> float:
    """ms per call of ``fn`` between two CUDA events.  With ``device_only``
    the GPU sleeps while the host queues every call, so the events bracket
    the device's work alone and not the host's issue rate."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if device_only:
        torch.cuda._sleep(200_000_000)  # ~0.1 s at H100 clocks
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 1

    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.testing.phantoms import (
        synthetic_radiograph)
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import noise
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import build
    from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import fused_hist as fh

    # ---- 1. device -------------------------------------------------------
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0].strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[1] device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible")
    log(card)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library()
    log(f"[2] build: {time.perf_counter() - t0:.2f} s -> {build.library_path().name}")
    for line in build.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 3. kernels against their plain versions -------------------------
    rec = KernelRecord()
    rng = np.random.default_rng(2024)
    cfg = MusicaConfig(image_size=SIZE)
    img = synthetic_radiograph(SIZE, "thorax")
    log("[3] kernels vs plain versions on the card (exact equality)")
    lv3072 = analysis_levels(img, cfg, dev)
    check_noise(rec, cfg, lv3072, "3072 thorax, levels 0-3")
    check_noise(rec, cfg, random_levels(rng, [v.shape[-1] for v in lv3072], dev),
                "3072 random levels")
    cfg512 = MusicaConfig(image_size=512)
    lv512 = analysis_levels(synthetic_radiograph(512, "thorax"), cfg512, dev)
    check_noise(rec, cfg512, lv512, "512 thorax stack")
    check_noise(rec, cfg512, random_levels(rng, [512, 256, 128, 64], dev),
                "512 random stack")

    x_dev = torch.from_numpy(img).to(dev)
    inter = musica.musica_forward(x_dev, cfg, want_intermediates=True)
    recon, nrm, cnr = inter["recon"], inter["intermediates"]["normalized"], inter["cnr"]
    relevant = inter["intermediates"]["relevant"]
    assert cnr.shape == (384, 384), cnr.shape
    rec.equal("grad_hist_relevant", "3072 thorax, 384^2 CNR",
              fh.grad_hist_relevant(recon, nrm, cnr, cfg),
              fh.grad_hist_relevant_plain(recon, nrm, cnr, cfg))
    r_recon = torch.from_numpy(rng.uniform(-0.1, 1.2, (SIZE, SIZE)).astype(np.float32)).to(dev)
    r_recon[torch.from_numpy(rng.uniform(size=(SIZE, SIZE)) < 0.002).to(dev)] = 0.0
    r_nrm = torch.from_numpy(rng.uniform(0.0, 1.01, (SIZE, SIZE)).astype(np.float32)).to(dev)
    r_cnr = torch.from_numpy(rng.uniform(0.0, 0.1, (384, 384)).astype(np.float32)).to(dev)
    rec.equal("grad_hist_relevant", "3072 random",
              fh.grad_hist_relevant(r_recon, r_nrm, r_cnr, cfg),
              fh.grad_hist_relevant_plain(r_recon, r_nrm, r_cnr, cfg))
    rec.equal("grad_hist", "3072 thorax (debug-dump path)",
              fh.grad_hist(recon, relevant, cfg), fh.grad_hist_plain(recon, relevant, cfg))
    cfg600 = MusicaConfig(image_size=600)
    inter600 = musica.musica_forward(
        torch.from_numpy(synthetic_radiograph(600, "pelvis")).to(dev), cfg600,
        want_intermediates=True)
    rec600, rel600 = inter600["recon"], inter600["intermediates"]["relevant"]
    rec.equal("grad_hist", "600 pelvis", fh.grad_hist(rec600, rel600, cfg600),
              fh.grad_hist_plain(rec600, rel600, cfg600))
    r_rel = noise.img_relevant(r_nrm, r_cnr, cfg)
    rec.equal("grad_hist", "3072 random", fh.grad_hist(r_recon, r_rel, cfg),
              fh.grad_hist_plain(r_recon, r_rel, cfg))

    # ---- 4. the main path at 3072^2 ----------------------------------------
    log(f"[4] main path: process() on a {SIZE}^2 thorax phantom")
    fh.reset_launch_counts()
    out_gpu = musica.process(img, cfg, "cuda")
    torch.cuda.synchronize()
    launches = dict(fh.LAUNCHES)
    log(f"  launches: {launches}")
    for k in ("noise_hist", "hist_argmax", "grad_hist_relevant"):
        assert launches[k] > 0, f"the main path did not launch {k}"
    m = cfg.out_margin
    assert out_gpu.shape == (SIZE - 2 * m, SIZE - 2 * m) and out_gpu.dtype == np.uint8
    assert 0 < int(out_gpu.max()) and int(out_gpu.min()) < 255, "degenerate output"
    t0 = time.perf_counter()
    out_cpu = musica.process(img, cfg, "cpu")
    log(f"  CPU path: {time.perf_counter() - t0:.1f} s")
    check_parity("GPU vs the port's CPU path", out_gpu, out_cpu)
    assert np.array_equal(inter["out_u8"].cpu().numpy(), out_gpu)

    log("[4b] intermediates path (process --debug-dump)")
    fh.reset_launch_counts()
    dbg = musica.musica_forward(x_dev, cfg, want_intermediates=True)
    torch.cuda.synchronize()
    launches_dbg = dict(fh.LAUNCHES)
    log(f"  launches: {launches_dbg}")
    for k in ("noise_hist", "hist_argmax", "grad_hist"):
        assert launches_dbg[k] > 0, f"the intermediates path did not launch {k}"
    assert np.array_equal(dbg["out_u8"].cpu().numpy(), out_gpu)
    assert all(bool(torch.isfinite(v).all()) for v in dbg["intermediates"].values()
               if isinstance(v, torch.Tensor) and v.is_floating_point())

    # ---- 5. a batch of 4 ---------------------------------------------------
    anatomies = ["thorax", "pelvis", "hand", "knee"][:BATCH]
    imgs = np.stack([synthetic_radiograph(SIZE, a) for a in anatomies])
    outs = musica.process_batch(imgs, cfg, "cuda")
    assert outs.shape == (BATCH,) + out_gpu.shape
    for a, im, o in zip(anatomies, imgs, outs):
        assert np.array_equal(o, musica.process(im, cfg, "cuda")), a
    log(f"[5] process_batch: {BATCH} x {SIZE}^2 ({', '.join(anatomies)}) "
        f"equal to single-image runs")

    # ---- 6. timings ----------------------------------------------------------
    xb_dev = torch.from_numpy(imgs).to(dev)
    for _ in range(3):
        musica.musica_forward(x_dev, cfg)["out_u8"]
    singles = sorted(cuda_ms(lambda: musica.musica_forward(x_dev, cfg)["out_u8"], 10, 0)
                     for _ in range(5))
    batches = sorted(cuda_ms(lambda: musica.forward_batch(xb_dev, cfg), 2, 1) / BATCH
                     for _ in range(3))
    single, batch = singles[2], batches[1]
    mpix = SIZE * SIZE / 1e6
    log(f"[6] timings on {card} (CUDA events, device-resident u16 input; "
        f"pipeline: host issue included; kernels: device time)")
    log(f"  single: median {single} ms/img = {mpix / single} GPix/s "
        f"(5 windows of 10: {singles})")
    log(f"  batch of {BATCH}: median {batch} ms/img = {mpix / batch} GPix/s "
        f"(3 windows of 2 batches: {batches})")
    cases = {
        "noise_hist": (lambda: fh.noise_hists(lv3072, cfg),
                       lambda: fh.noise_hists_plain(lv3072, cfg)),
        "hist_argmax": (lambda h=fh.noise_hists(lv3072, cfg): fh.hist_argmax(h),
                        lambda h=fh.noise_hists(lv3072, cfg): fh.hist_argmax_plain(h)),
        "grad_hist_relevant": (lambda: fh.grad_hist_relevant(recon, nrm, cnr, cfg),
                               lambda: fh.grad_hist_relevant_plain(recon, nrm, cnr, cfg)),
        "grad_hist": (lambda: fh.grad_hist(recon, relevant, cfg),
                      lambda: fh.grad_hist_plain(recon, relevant, cfg)),
    }
    kernels = []
    for name, (kern, plain) in cases.items():
        k_ms = cuda_ms(kern, 20, 2, device_only=True)
        p_ms = cuda_ms(plain, 5, 1, device_only=True)
        log(f"  {name}: kernel {k_ms} ms, plain {p_ms} ms")
        from_run = launches_dbg if name == "grad_hist" else launches
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": from_run[name],
            "launched_by": ("process --debug-dump (musica_forward, "
                            "want_intermediates=True)" if name == "grad_hist"
                            else "process"),
            "max_abs_err": rec.err[name], "ms": k_ms,
            "plain_ms": p_ms})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

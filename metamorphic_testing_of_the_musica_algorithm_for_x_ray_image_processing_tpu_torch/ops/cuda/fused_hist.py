"""Wrappers of the histogram kernels in ``csrc/fused_hist.cu``, each beside
its plain PyTorch version and its launch counter.

=========================  ==================================================
wrapper                    replaces (JAX package, ops/pallas/fused_hist.py)
=========================  ==================================================
``noise_hists``            ``noise_hist_fused`` (``_noise_kernel``) and the
                           histogram of ``noise_hist_argmax_multi``
                           (``_noise_multi_kernel``): one launch over all
                           analysis levels, at every size
``hist_argmax``            the in-kernel first-max argmax of
                           ``_noise_multi_kernel``
``grad_hist_relevant``     ``grad_hist_relevant_fused``
                           (``_grad_relevant_kernel``)
``grad_hist``              ``grad_hist_fused`` (``_grad_kernel``)
=========================  ==================================================

Each kernel is bound by one read of its images (4 bytes/px for the noise
histogram; 8 for the gradation histograms: recon + the relevance image, or
recon + normalized with the relevance computed in the kernel) and by
shared-memory atomic contention on the peak bins.  The histograms are
privatised per block in shared memory for now, with one global atomic per
non-zero bin at the end of the block.

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor runs
the plain version.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import f32, gradation, noise, stats

# launches of each CUDA kernel since the last reset (plain versions and CPU
# calls do not count)
LAUNCHES = {"noise_hist": 0, "hist_argmax": 0, "grad_hist_relevant": 0,
            "grad_hist": 0}

_MAX_LEVELS = 16          # MUSICA_MAX_LEVELS in fused_hist.cu
_MAX_SHARED_BINS = 12288  # static 48 KB of shared memory per block


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _device_of(tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_cuda(t: torch.Tensor, name: str, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != 2 or t.shape[0] != t.shape[1]:
        raise ValueError(f"{name}: expected a square [n, n] image, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_bins(n_bins: int):
    if not 1 <= n_bins <= _MAX_SHARED_BINS:
        raise ValueError(f"n_bins={n_bins} outside [1, {_MAX_SHARED_BINS}]")


def _launch(lib, fn_name: str, counter: str, *args) -> None:
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        msg = lib.musica_error_string(rc).decode()
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc} ({msg})")
    LAUNCHES[counter] += 1


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _histogram_plain(bins: torch.Tensor, w: torch.Tensor, n_bins: int,
                     device) -> torch.Tensor:
    """Exact int32 counts of int64 weights ``w`` at ``bins`` (weights of
    out-of-range bins are already 0)."""
    h = torch.zeros(n_bins, dtype=torch.int64, device=device)
    h.scatter_add_(0, bins.clamp(0, n_bins - 1).to(torch.int64), w)
    return h.to(torch.int32)


def _lib():
    from .build import load_library
    return load_library()


# ----------------------------------------------------------------------
# noise histogram + argmax (kernels 1 and 2 of the JAX package)
# ----------------------------------------------------------------------

def noise_hists_plain(levels, cfg) -> torch.Tensor:
    """Plain version: per level, ``stats.noise_bins`` + an int64
    ``scatter_add_``."""
    nb = cfg.noise_histogram_bins
    hists = []
    for sd in levels:
        bins, w = stats.noise_bins(sd, cfg)
        hists.append(_histogram_plain(bins, w, nb, sd.device))
    return torch.stack(hists)


def noise_hists(levels, cfg) -> torch.Tensor:
    """Noise histograms (int32 [L, n_bins]) of a list of [n_i, n_i] float32
    level images, each scanned over its coverage (``stats.coverage``), in
    one launch."""
    dev = _device_of(levels)
    if dev.type == "cpu":
        return noise_hists_plain(levels, cfg)
    nb, tile = cfg.noise_histogram_bins, cfg.histogram_area_size
    _check_bins(nb)
    if not 1 <= len(levels) <= _MAX_LEVELS:
        raise ValueError(f"{len(levels)} levels, at most {_MAX_LEVELS}")
    for i, sd in enumerate(levels):
        _check_cuda(sd, f"level {i}")
    L = len(levels)
    lib = _lib()
    hists = torch.zeros((L, nb), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * L)(*[sd.data_ptr() for sd in levels])
    ns = (ctypes.c_int * L)(*[sd.shape[-1] for sd in levels])
    covs = (ctypes.c_int * L)(*[stats.coverage(sd.shape[-1], cfg) for sd in levels])
    strides = (ctypes.c_int * L)(*[sd.stride(0) for sd in levels])
    with torch.cuda.device(dev):
        _launch(lib, "musica_noise_hist", "noise_hist", ptrs, ns, covs,
                strides, L, hists.data_ptr(), nb, tile,
                float(cfg.max_noise_value), _stream(dev))
    return hists


def hist_argmax_plain(hists: torch.Tensor) -> torch.Tensor:
    """Plain version: ``torch.argmax`` (first maximum) per row."""
    return stats.histogram_max(hists)[1]


def hist_argmax(hists: torch.Tensor) -> torch.Tensor:
    """First-max bin (int32 [L]) of each row of int32 [L, n_bins]."""
    dev = _device_of([hists])
    if dev.type == "cpu":
        return hist_argmax_plain(hists)
    if hists.dtype != torch.int32 or hists.ndim != 2 or not hists.is_contiguous():
        raise ValueError(f"hists: expected contiguous int32 [L, n_bins], got "
                         f"{hists.dtype} {tuple(hists.shape)}")
    L, nb = hists.shape
    lib = _lib()
    out = torch.empty(L, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(lib, "musica_hist_argmax", "hist_argmax", hists.data_ptr(),
                L, nb, out.data_ptr(), _stream(dev))
    return out


def noise_hist_levels(levels, cfg):
    """(noise histograms int32 [L, n_bins], first-max bins int32 [L]) of the
    analysis levels: two launches on a CUDA device, whatever the sizes."""
    hists = noise_hists(levels, cfg)
    return hists, hist_argmax(hists)


# ----------------------------------------------------------------------
# gradation histograms (kernels 3 and 4 of the JAX package)
# ----------------------------------------------------------------------

def grad_hist_plain(recon, relevant, cfg):
    """Plain version: ``gradation.gradation_bins`` + an int64 scatter-add."""
    bins, w = gradation.gradation_bins(recon, relevant, cfg)
    return _histogram_plain(bins, w, cfg.grad_histogram_bins, recon.device)


def grad_hist(recon: torch.Tensor, relevant: torch.Tensor, cfg) -> torch.Tensor:
    """Gradation histogram (int32 [n_bins]) of recon [n, n] weighted by
    trunc(relevant * 100), with the whole-tile return at the first 0.0."""
    dev = _device_of([recon, relevant])
    if dev.type == "cpu":
        return grad_hist_plain(recon, relevant, cfg)
    nb, tile = cfg.grad_histogram_bins, cfg.histogram_area_size
    _check_bins(nb)
    _check_cuda(recon, "recon")
    _check_cuda(relevant, "relevant")
    if relevant.shape != recon.shape:
        raise ValueError(f"relevant {tuple(relevant.shape)} != recon {tuple(recon.shape)}")
    lib = _lib()
    n = recon.shape[-1]
    hist = torch.zeros(nb, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(lib, "musica_grad_hist", "grad_hist", recon.data_ptr(),
                relevant.data_ptr(), n, n, hist.data_ptr(), nb, tile,
                _stream(dev))
    return hist


def relevance_weight_plane(cnr: torch.Tensor, cfg) -> torch.Tensor:
    """Block weights on the CNR grid (int32): the ramp's trunc((c/6)^5 * 100)
    where 1 <= c <= 6, -1 for a solid block (6 <= c <= 256: the weight is
    100 where the pixel's normalized value is <= 0.9), else 0; the ramp wins
    at c == 6 (img_relevant.comp:27-63).  Nearest upsampling copies, so this
    equals the per-pixel evaluation."""
    c = cnr * cfg.max_cnr_value
    top = cfg.relevant_cnr_low + cfg.relevant_cnr_ramp
    ramp = (c >= cfg.relevant_cnr_low) & (c <= top)
    solid = (c >= top) & (c <= cfg.max_cnr_value) & ~ramp
    w_ramp = (noise._pow_maybe_int(c / f32(top, c), cfg.relevant_k)
              * 100.0).to(torch.int32)
    return torch.where(solid, -1, torch.where(ramp, w_ramp, 0)).to(torch.int32)


def grad_hist_relevant_plain(recon, normalized, cnr, cfg):
    """Plain version: the relevance image (``noise.img_relevant``), then
    ``grad_hist_plain``."""
    return grad_hist_plain(recon, noise.img_relevant(normalized, cnr, cfg), cfg)


def grad_hist_relevant(recon: torch.Tensor, normalized: torch.Tensor,
                       cnr: torch.Tensor, cfg) -> torch.Tensor:
    """Gradation histogram (int32 [n_bins]) with the relevance weight
    computed in the kernel from the small CNR map and the normalized image
    (no full-size relevance image)."""
    dev = _device_of([recon, normalized, cnr])
    if dev.type == "cpu":
        return grad_hist_relevant_plain(recon, normalized, cnr, cfg)
    nb, tile = cfg.grad_histogram_bins, cfg.histogram_area_size
    _check_bins(nb)
    _check_cuda(recon, "recon")
    _check_cuda(normalized, "normalized")
    _check_cuda(cnr, "cnr")
    if normalized.shape != recon.shape:
        raise ValueError(f"normalized {tuple(normalized.shape)} != recon {tuple(recon.shape)}")
    n = recon.shape[-1]
    scale = int(math.ceil(n / cnr.shape[-1]))
    wplane = relevance_weight_plane(cnr, cfg).contiguous()
    lib = _lib()
    hist = torch.zeros(nb, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(lib, "musica_grad_hist_relevant", "grad_hist_relevant",
                recon.data_ptr(), normalized.data_ptr(), n, n,
                wplane.data_ptr(), cnr.shape[-1], scale, cfg.relevant_border,
                float(cfg.relevant_max_pixel), hist.data_ptr(), nb, tile,
                _stream(dev))
    return hist

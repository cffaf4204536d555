"""What every kernel wrapper of ``ops.cuda`` shares: the launch counters,
device and input checks, the current stream, and the launch itself.

Dispatch rule of every wrapper: a CPU tensor runs the plain PyTorch version,
a CUDA tensor launches the kernel or raises.  There is no fallback from one
to the other.

The C entry points work on the calling thread's current CUDA device: they
read its SM count, opt its kernels into large shared memory and launch there
(``csrc/grid.cuh``).  PyTorch leaves the current device at ``cuda:0`` in every
thread that does not set it, so ``launch`` makes the tensors' device current
around the call; a kernel on ``cuda:1`` or in a worker thread of the
data-parallel path (``parallel/sharding.py``) then runs where its tensors lie.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional

import torch

# launches of each CUDA kernel that ran since the last reset (plain versions
# and CPU calls do not count); the data-parallel workers launch from several
# threads, so every update holds _COUNT_LOCK.  A launch recorded while a
# thread captures a CUDA graph does not run then: it goes to that capture's
# tally (``recorded_launches``), and each replay of the graph adds the tally
# (``add_launches``), so the counts mean kernels that ran on either path.
LAUNCHES = {"noise_hist": 0, "hist_argmax": 0, "grad_hist_relevant": 0, "grad_hist": 0,
            "histogram": 0, "clahe_apply": 0, "sdev_noise_hist": 0,
            "pyramid_down": 0, "pyramid_up": 0, "pyramid_tail": 0, "sdev": 0, "tone_map": 0,
            "sdev_tail": 0, "contrast_apply": 0, "normalize": 0, "gradation_curve": 0,
            "clahe_hist": 0, "clahe_curves": 0}
# launches by the geometry a wrapper chose for them, {(kernel, geometry):
# launches} (``pyramid.reduce_step``: ("reduce_step", the strip height));
# kept out of LAUNCHES, whose keys and counts keep their meaning, and reset,
# recorded under a capture and added by a replay as LAUNCHES is
GEOMETRY: Dict[tuple, int] = {}
_COUNT_LOCK = threading.Lock()
_CAPTURING = threading.local()  # .tally: this thread's capture tally, if any

# shared memory a block may use on the H100 after the kernels' opt-in
# (csrc/grid.cuh: 227 KB); a histogram kernel holds its bins there
MAX_SHARED_BYTES = 232448
MAX_SHARED_BINS = MAX_SHARED_BYTES // 4


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        GEOMETRY.clear()


def add_launches(counts: Dict[str, int], geometry: Optional[Dict[tuple, int]] = None) -> None:
    """Count ``counts[k]`` more launches of each kernel ``k`` (and
    ``geometry[g]`` more of each geometry ``g``)."""
    with _COUNT_LOCK:
        for k, n in counts.items():
            LAUNCHES[k] += n
        for g, n in (geometry or {}).items():
            GEOMETRY[g] = GEOMETRY.get(g, 0) + n


class Tally(dict):
    """A capture's launches by kernel, and by geometry in ``.geometry``."""

    def __init__(self):
        super().__init__((k, 0) for k in LAUNCHES)
        self.geometry: Dict[tuple, int] = {}


@contextlib.contextmanager
def recorded_launches() -> Iterator[Tally]:
    """Within the block, this thread's launches go to the tally it yields
    instead of ``LAUNCHES`` and ``GEOMETRY``: the block captures a CUDA
    graph, whose kernels run only when it is replayed.  Other threads count
    as before."""
    tally = Tally()
    _CAPTURING.tally = tally
    try:
        yield tally
    finally:
        _CAPTURING.tally = None


def _count(counter: str) -> None:
    tally = getattr(_CAPTURING, "tally", None)
    if tally is not None:
        tally[counter] += 1
        return
    with _COUNT_LOCK:
        LAUNCHES[counter] += 1


def count_geometry(kernel: str, geometry) -> None:
    """Count a launch of ``kernel`` that took ``geometry``, beside the
    launch's own count (under a capture, in its tally)."""
    tally = getattr(_CAPTURING, "tally", None)
    counts = GEOMETRY if tally is None else tally.geometry
    with _COUNT_LOCK:
        counts[(kernel, geometry)] = counts.get((kernel, geometry), 0) + 1


def device_of(tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_image(t: torch.Tensor, name: str, dtype=torch.float32) -> None:
    """A contiguous square [n, n] image of ``dtype``."""
    check_rows(t, name, dtype)
    if t.shape[0] != t.shape[1]:
        raise ValueError(f"{name}: expected a square [n, n] image, got {tuple(t.shape)}")


def check_rows(t: torch.Tensor, name: str, dtype=torch.float32) -> None:
    """A contiguous [rows, n] window of rows of an [n, n] image, of ``dtype``
    (a dtype or a tuple of them)."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.ndim != 2 or t.shape[0] > t.shape[1]:
        raise ValueError(f"{name}: expected [rows, n] rows of an [n, n] image, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_bins(n_bins: int) -> None:
    if not 1 <= n_bins <= MAX_SHARED_BINS:
        raise ValueError(f"n_bins={n_bins} outside [1, {MAX_SHARED_BINS}]")


def check_shared(n_bytes: int, what: str) -> None:
    """Raise where a kernel's shared memory exceeds what a block may use."""
    if n_bytes > MAX_SHARED_BYTES:
        raise ValueError(f"{what}: {n_bytes} bytes of shared memory, more than the "
                         f"{MAX_SHARED_BYTES} a block may use")


def launch(lib, fn_name: str, counter: str, dev: torch.device, *args) -> None:
    """Call a C entry point with ``args`` and the current stream of ``dev``
    (its last argument), with ``dev`` the current CUDA device, and count the
    launch only if it was accepted (the entry point returns a cudaError_t);
    under ``recorded_launches`` it counts in that block's tally."""
    with torch.cuda.device(dev):
        rc = getattr(lib, fn_name)(*args, stream(dev))
    if rc != 0:
        msg = lib.musica_error_string(rc).decode()
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc} ({msg})")
    _count(counter)


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def lib():
    """The kernel library, built on first use."""
    from .build import load_library
    return load_library()

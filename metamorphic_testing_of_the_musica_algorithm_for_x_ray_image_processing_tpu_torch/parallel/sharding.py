"""Data parallelism over several devices, the port of the JAX package's
``parallel/sharding.py`` on its ``space == 1`` path.

The reference has no distribution at all (a single Vulkan compute queue,
SURVEY.md section 2.5).  The JAX package splits the image batch over the
mesh's ``data`` axis with ``shard_map`` and runs the single-image program on
each device with ``lax.map``.  Here a mesh is a tuple of ``torch.device``\\ s:
device i takes the contiguous images ``[i B/n, (i+1) B/n)``, as
``P("data")`` splits the batch, and one worker thread per device runs
``musica_forward`` on one image after another with that device current and
on a CUDA stream of its own.  On a CUDA device each image is a replay of
that stream's captured graph of ``musica_forward`` (``models/graphs.py``,
keyed by the stream, so two entries on one card never share static
buffers), a few Python calls an image instead of ~2,300 op issues that the
threads would contend for under the interpreter lock; the first call of
each entry captures, one thread at a time (``graphs._CAPTURE_LOCK``).  No
image crosses devices, so no collective is needed; the results are
gathered onto the mesh's first device.

The JAX package's spatial path (``space > 1``: GSPMD row sharding with conv
halos and histogram all-reduces) is not ported.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import MusicaConfig
from ..models import graphs, musica
from ..ops.cuda import launch

Mesh = Tuple[torch.device, ...]


def make_mesh(n_data: Optional[int] = None, n_space: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """The first ``n_data`` of ``devices`` (default: every visible CUDA
    device) as a data-parallel mesh."""
    if n_space != 1:
        raise NotImplementedError(
            f"n_space={n_space}: the spatial (row-sharded) path of the JAX package "
            "is not ported; the mesh is data-parallel only")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device visible; pass devices= "
                               "to build a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n_data = len(devices) if n_data is None else n_data
    if not 1 <= n_data <= len(devices):
        raise ValueError(f"n_data={n_data}: between 1 and the {len(devices)} devices given")
    return tuple(devices[:n_data])


@functools.lru_cache(maxsize=None)
def _worker_stream(dev: torch.device, slot: int) -> "torch.cuda.Stream":
    """The CUDA stream of mesh entry ``slot`` on ``dev``, the same in every
    call: PyTorch's caching allocator keeps freed blocks per stream, so a
    new stream in each call would allocate every intermediate anew."""
    return torch.cuda.Stream(device=dev)


def _on_mesh(mesh: Mesh, fn: Callable[[int, torch.device], object]) -> list:
    """``fn(i, mesh[i])`` for every entry, each in a worker thread of its
    own; on a CUDA device with that device current and a stream of its own
    (``_worker_stream``), which first waits for the caller's current stream
    there (the inputs were made on it) and which the worker waits for before
    it returns.  Returns the results in mesh order; the first worker's
    exception, in mesh order, is raised here once every worker has ended."""
    callers = {d: torch.cuda.current_stream(d) for d in mesh if d.type == "cuda"}
    if callers:
        launch.lib()  # build the kernels once, before any worker launches
    streams = [_worker_stream(d, i) if d.type == "cuda" else None for i, d in enumerate(mesh)]

    def work(i: int, dev: torch.device):
        if dev.type != "cuda":
            return fn(i, dev)
        stream = streams[i]
        stream.wait_stream(callers[dev])
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            out = fn(i, dev)
        stream.synchronize()
        return out

    with ThreadPoolExecutor(max_workers=len(mesh)) as pool:
        futures = [pool.submit(work, i, d) for i, d in enumerate(mesh)]
    return [f.result() for f in futures]


def _gather(parts, dev: torch.device) -> torch.Tensor:
    """Concatenate the workers' tensors on ``dev``.  Each worker's block is
    marked as used by the current stream of its device, where the copy is
    queued, so the allocator does not hand it out again before the copy."""
    for t in parts:
        if t.device.type == "cuda":
            t.record_stream(torch.cuda.current_stream(t.device))
    return torch.cat([t.to(dev) for t in parts])


def process_sharded(imgs_u16, cfg: MusicaConfig, mesh: Mesh,
                    outputs: Sequence[str] = ("out_u8",), fused_sdev: bool = False):
    """Batched pipeline with the batch split over the mesh.  Input [B, n, n]
    uint16 (a numpy array or a tensor on any device), ``B`` a multiple of
    the mesh size; output [B, ...] per name in ``outputs`` (``musica_forward``'s
    results), on ``mesh[0]``: one tensor for one name, else a tuple in
    order.  ``fused_sdev`` as in ``musica_forward``."""
    imgs = imgs_u16 if isinstance(imgs_u16, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(imgs_u16))
    outputs = tuple(outputs)
    n, b = len(mesh), imgs.shape[0]
    if b % n:
        raise ValueError(f"batch of {b} images does not split evenly over {n} devices")
    per = b // n

    def shard(i: int, dev: torch.device):
        return graphs.run_batch(musica.musica_forward, imgs[i * per:(i + 1) * per].to(dev), cfg,
                                fused_sdev, outputs)

    parts = _on_mesh(mesh, shard)
    out = tuple(_gather([p[j] for p in parts], mesh[0]) for j in range(len(outputs)))
    return out[0] if len(outputs) == 1 else out


def throughput_step(cfg: MusicaConfig, mesh: Mesh, batch_per_device: int = 1):
    """A steady-state throughput step: ``(step, example)``.  ``example`` is
    each device's share (a tuple in mesh order) of the JAX package's example
    batch, ``default_rng(0)`` uint16 of ``[batch_per_device * len(mesh), n,
    n]``; ``step(example)`` returns a 0-d int64 tensor on ``mesh[0]``, the
    sum over devices of each ``out_u8``'s sum (the JAX package's uint32
    ``psum`` equals it modulo 2**32).  The scalar forces the whole batch to
    run and needs no large copy back."""
    n = cfg.image_size
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 65535, (batch_per_device * len(mesh), n, n), dtype=np.uint16)
    example = tuple(torch.from_numpy(batch[i * batch_per_device:(i + 1) * batch_per_device]).to(d)
                    for i, d in enumerate(mesh))

    def step(shares) -> torch.Tensor:
        def local(i: int, dev: torch.device):
            total = torch.zeros((), dtype=torch.int64, device=dev)
            for im in shares[i]:
                total += musica.process_jit(im, cfg).sum(dtype=torch.int64)
            return total

        sums = _on_mesh(mesh, local)
        return _gather([s.reshape(1) for s in sums], mesh[0]).sum()

    return step, example

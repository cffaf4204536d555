"""Data and spatial parallelism over several devices, the port of the JAX
package's ``parallel/sharding.py``.

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

With ``n_space > 1`` (``make_mesh``: ``n_data`` rows of ``n_space``
devices, the JAX package's ``(data, space)`` mesh) each image's rows are
split over its mesh row's entries (``parallel/spatial.py``: halo exchanges
and histogram all-reduces written out), in every variant (CLAHE, linear
gradation, fused-sdev, bf16); one worker thread per mesh row drives its
entries, each on a CUDA stream of its own.  On CUDA entries each image is a
replay of the row's ``SpatialGraph`` (``models/graphs.py``: one graph for a
row on one card, segments cut at the exchanges between cards), the
counterpart of the JAX package's jitted ``shard_map``; CPU entries, which a
caller gets only by asking for the CPU, run ``spatial.forward`` eagerly.
``process_sharded_eager`` runs the eager schedule on any entries: the
reference that the replays are held to.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import MusicaConfig
from ..models import graphs, musica
from ..ops.cuda import launch
from . import spatial

# a data-parallel mesh: one device an entry; a spatial mesh: n_data rows of
# n_space devices
Mesh = Union[Tuple[torch.device, ...], Tuple[Tuple[torch.device, ...], ...]]


def make_mesh(n_data: Optional[int] = None, n_space: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """The first ``n_data`` of ``devices`` (default: every visible CUDA
    device) as a data-parallel mesh; with ``n_space > 1`` the first
    ``n_data * n_space`` as ``n_data`` rows of ``n_space`` (the order of
    ``np.array(devices).reshape(n_data, n_space)``; ``n_data`` defaults to
    ``len(devices) // n_space``).  A device may repeat: several entries on
    one card each run on a stream of their own."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device visible; pass devices= "
                               "to build a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_space < 1:
        raise ValueError(f"n_space={n_space}: at least 1")
    n_data = len(devices) // n_space if n_data is None else n_data
    if not 1 <= n_data * n_space <= len(devices) or n_data < 1:
        raise ValueError(f"n_data={n_data} x n_space={n_space}: between 1 and the "
                         f"{len(devices)} devices given")
    if n_space == 1:
        return tuple(devices[:n_data])
    return tuple(tuple(devices[d * n_space:(d + 1) * n_space]) for d in range(n_data))


def is_spatial(mesh: Mesh) -> bool:
    return isinstance(mesh[0], tuple)


@functools.lru_cache(maxsize=None)
def _worker_stream(dev: torch.device, slot: int) -> "torch.cuda.Stream":
    """The CUDA stream of mesh entry ``slot`` on ``dev``, the same in every
    call: PyTorch's caching allocator keeps freed blocks per stream, so a
    new stream in each call would allocate every intermediate anew."""
    return torch.cuda.Stream(device=dev)


def _on_rows(rows, fn: Callable[[int, list], object]) -> list:
    """``fn(i, entries)`` for every mesh row ``rows[i]`` (a tuple of
    devices), each in a worker thread of its own; ``entries`` are the row's
    ``spatial.Entry``\\ s, on a CUDA device each with a stream of its own
    (``_worker_stream``), which first waits for the caller's current stream
    there (the inputs were made on it) and which the worker waits for before
    it returns.  A spatial graph replays on each device's first entry
    stream of the row, so its copy-in follows the caller's work and the
    worker's wait covers its copy-out.  Returns the results in mesh order;
    the first worker's exception, in mesh order, is raised here once every
    worker has ended."""
    devs = {d for row in rows for d in row}
    callers = {d: torch.cuda.current_stream(d) for d in devs if d.type == "cuda"}
    if callers:
        launch.lib()  # build the kernels once, before any worker launches
    width = len(rows[0])
    entries = [[spatial.Entry(d, _worker_stream(d, i * width + s) if d.type == "cuda" else None)
                for s, d in enumerate(row)] for i, row in enumerate(rows)]

    def work(i: int):
        for e in entries[i]:
            if e.stream is not None:
                e.stream.wait_stream(callers[e.device])
        out = fn(i, entries[i])
        for e in entries[i]:
            if e.stream is not None:
                e.stream.synchronize()
        return out

    with ThreadPoolExecutor(max_workers=len(rows)) as pool:
        futures = [pool.submit(work, i) for i in range(len(rows))]
    return [f.result() for f in futures]


def _on_mesh(mesh: Mesh, fn: Callable[[int, torch.device], object]) -> list:
    """``fn(i, mesh[i])`` for every entry of a data-parallel mesh, each in a
    worker thread of its own (``_on_rows``), with that device current and,
    on a CUDA device, the entry's stream."""
    def one(i: int, entries):
        with entries[0].on():
            return fn(i, entries[0].device)

    return _on_rows([(d,) for d in mesh], one)


def _gather(parts, dev: torch.device) -> torch.Tensor:
    """Concatenate the workers' tensors on ``dev``.  Each worker's block is
    marked as used by the current stream of its device, where the copy is
    queued, so the allocator does not hand it out again before the copy."""
    for t in parts:
        if t.device.type == "cuda":
            t.record_stream(torch.cuda.current_stream(t.device))
    return torch.cat([t.to(dev) for t in parts])


def _spatial_rows(imgs: torch.Tensor, cfg: MusicaConfig, entries, outputs, fused_sdev: bool,
                  eager: bool) -> Tuple[torch.Tensor, ...]:
    """``spatial.forward`` of each image of ``imgs`` over one mesh row's
    ``entries``: replays of its graph (``graphs.run_spatial``; eagerly on
    CPU entries), or with ``eager`` the eager schedule."""
    if not eager:
        bounds = spatial.row_plan(cfg.image_size, len(entries), cfg).bounds[0]
        return graphs.run_spatial(spatial.forward, imgs, cfg, entries, bounds, fused_sdev,
                                  outputs)
    res = [spatial.forward(im, cfg, entries, outputs, fused_sdev) for im in imgs]
    with entries[0].on():
        return tuple(torch.stack([r[k] for r in res]) for k in outputs)


def process_sharded(imgs_u16, cfg: MusicaConfig, mesh: Mesh,
                    outputs: Sequence[str] = ("out_u8",), fused_sdev: bool = False):
    """Batched pipeline with the batch split over the mesh.  Input [B, n, n]
    uint16 (a numpy array or a tensor on any device), ``B`` a multiple of
    the mesh's ``data`` size; output [B, ...] per name in ``outputs``
    (``musica_forward``'s results), on the mesh's first device: one tensor
    for one name, else a tuple in order.  ``fused_sdev`` as in
    ``musica_forward``.  On a spatial mesh each image's rows are split over
    its mesh row (``spatial.forward``, replayed as its graph on CUDA
    entries; ``outputs`` among ``spatial.OUTPUTS``, each gathered whole)."""
    return _process_sharded(imgs_u16, cfg, mesh, tuple(outputs), fused_sdev, eager=False)


def process_sharded_eager(imgs_u16, cfg: MusicaConfig, mesh: Mesh,
                          outputs: Sequence[str] = ("out_u8",), fused_sdev: bool = False):
    """``process_sharded`` on a spatial mesh with each image's schedule
    issued eagerly op by op, also on CUDA entries: the reference that the
    graph replays are held to (tests, ``chip_smoke.py``,
    ``scripts/profile_torch.py --spatial``)."""
    if not is_spatial(mesh):
        raise ValueError("process_sharded_eager: a spatial mesh (n_space > 1)")
    return _process_sharded(imgs_u16, cfg, mesh, tuple(outputs), fused_sdev, eager=True)


def _process_sharded(imgs_u16, cfg: MusicaConfig, mesh: Mesh, outputs: tuple, fused_sdev: bool,
                     eager: bool):
    imgs = imgs_u16 if isinstance(imgs_u16, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(imgs_u16))
    n, b = len(mesh), imgs.shape[0]
    if b % n:
        raise ValueError(f"batch of {b} images does not split evenly over {n} devices")
    per = b // n
    if is_spatial(mesh):
        spatial.check_outputs(cfg, outputs)
        parts = _on_rows(mesh, lambda i, entries: _spatial_rows(
            imgs[i * per:(i + 1) * per], cfg, entries, outputs, fused_sdev, eager))
        first = mesh[0][0]
    else:
        def shard(i: int, dev: torch.device):
            return graphs.run_batch(musica.musica_forward, imgs[i * per:(i + 1) * per].to(dev),
                                    cfg, fused_sdev, outputs)

        parts = _on_mesh(mesh, shard)
        first = mesh[0]
    out = tuple(_gather([p[j] for p in parts], first) for j in range(len(outputs)))
    return out[0] if len(outputs) == 1 else out


def throughput_step(cfg: MusicaConfig, mesh: Mesh, batch_per_device: int = 1):
    """A steady-state throughput step: ``(step, example)``.  ``example`` is
    each data entry's share (a tuple in mesh order; on a spatial mesh on its
    row's first device) of the JAX package's example batch,
    ``default_rng(0)`` uint16 of ``[batch_per_device * n_data, n, n]``;
    ``step(example)`` returns a 0-d int64 tensor on the mesh's first
    device, the sum over images of each ``out_u8``'s sum (the JAX package's
    uint32 ``psum`` equals it modulo 2**32).  The scalar forces the whole
    batch to run and needs no large copy back."""
    n = cfg.image_size
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 65535, (batch_per_device * len(mesh), n, n), dtype=np.uint16)
    heads = [row[0] for row in mesh] if is_spatial(mesh) else list(mesh)
    example = tuple(torch.from_numpy(batch[i * batch_per_device:(i + 1) * batch_per_device]).to(d)
                    for i, d in enumerate(heads))

    def step(shares) -> torch.Tensor:
        if is_spatial(mesh):
            def rows(i: int, entries):
                (outs,) = _spatial_rows(shares[i], cfg, entries, ("out_u8",), False, eager=False)
                with entries[0].on():
                    return outs.sum(dtype=torch.int64).reshape(1)
            sums = _on_rows(mesh, rows)
        else:
            def local(i: int, dev: torch.device):
                total = torch.zeros((), dtype=torch.int64, device=dev)
                for im in shares[i]:
                    total += musica.process_jit(im, cfg).sum(dtype=torch.int64)
                return total.reshape(1)
            sums = _on_mesh(mesh, local)
        return _gather(sums, heads[0]).sum()

    return step, example

"""``musica_forward`` as captured CUDA graphs: what the port has in place of
the JAX package's compiled entries ``process_jit`` and ``process_batch_jit``
(``models/musica.py`` there).

``jax.jit`` makes the whole forward one program that a call dispatches
once.  PyTorch runs eagerly, so ``musica_forward`` issues ~2,300 small
kernels an image from Python, and the host's issue rate, not the card, sets
its wall time.  A ``ForwardGraph`` issues them once into a CUDA graph and
then launches them all with one call:

* warm-up: one eager run of the forward on the caller's device and stream.
  It builds the kernel library, makes the kernels' shared-memory opt-ins,
  reads the SM count (``csrc/grid.cuh``) and fills the allocator's cache.
* capture: the forward of a static input buffer, on a side stream, into
  the graph's private memory pool.  Its result tensors (``out_u8``,
  ``graded``, ``recon``, ``cnr`` and, with CLAHE, ``clahe_graded``) are the
  static outputs.  ``musica_forward`` never waits for the host, every
  kernel wrapper launches on the current stream with its arguments passed
  by value, and the argmax tickets of K1 and K7 lie in an allocation that a
  captured fill clears, so the graph replays the eager schedule as it is.
* replay: copy the image into the static input (``copy_`` takes a strided
  image, as ``musica_forward`` takes ``.contiguous()``), replay on the
  caller's current stream, and copy the requested outputs out before the
  next replay can overwrite them.

The forward is passed in (``models/musica.py`` passes ``musica_forward``),
so this module sits on top of the pipeline and imports nothing of it.

A graph's static buffers must never be used from two streams at once, and
the data-parallel mesh puts several entries, each with its stream, on one
card: so graphs are cached per (forward, cfg, fused_sdev, device, stream,
input dtype), at most ``MAX_GRAPHS_PER_DEVICE`` on each device, the least
recently used there dropped first (``release_graphs`` drops them all).

Captures are serialised under ``_CAPTURE_LOCK`` and made with
``capture_error_mode="thread_local"``: the default, "global", forbids
unsafe CUDA calls (a ``cudaMalloc`` of the caching allocator) in every
other thread while one captures, and the mesh's workers, the viewer's
request threads or any caller's threads may run eagerly or replay their
graphs meanwhile.  Capturing every graph before the threads start would
serve the mesh alone.

There is no fallback: a failed warm-up, capture or replay raises.  Only a
device with a capture backend (``GraphCache.backends``: CUDA) replays
graphs; a CPU tensor, which a caller gets only by asking for the CPU, runs
the forward eagerly, the dispatch by device of every kernel wrapper in
``ops/cuda``.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..config import MusicaConfig
from ..ops.cuda import launch

Forward = Callable[..., Dict[str, torch.Tensor]]

# graphs kept on one device.  What holds several on a card at once: the
# data-parallel mesh, one graph per worker stream (make_mesh over a node
# puts one entry on each card; a mesh that repeats a card, as the one-card
# mesh leg of scripts/bench_torch.py does, one per entry), and the entries
# process, process_batch and the campaign's runner on the caller's stream,
# one per variant and image size (default, fused-sdev, bf16, CLAHE +
# linear).  A 3072^2 graph's pool holds 556-700 MB on an H100 (PERF.md,
# chip_smoke.py [4m]), so 16 hold at most ~11 GB of its 80 GB.
MAX_GRAPHS_PER_DEVICE = 16

# serialises warm-up and capture across threads (see the module docstring)
_CAPTURE_LOCK = threading.Lock()


class CudaGraphs:
    """Capture and replay through ``torch.cuda.CUDAGraph``."""

    def __init__(self):
        self._side: Dict[torch.device, torch.cuda.Stream] = {}

    @staticmethod
    def stream(dev: torch.device) -> int:
        """The caller's current stream on ``dev``, where a replay runs."""
        return torch.cuda.current_stream(dev).cuda_stream

    def capture(self, forward: Callable[[], Dict[str, torch.Tensor]],
                dev: torch.device) -> Tuple[Dict[str, torch.Tensor], Callable[[], None]]:
        """``(outputs, replay)``: ``forward()`` captured on a side stream of
        ``dev`` (a capture may not use the default stream) after the
        caller's pending work there; ``replay()`` launches the graph on the
        then current stream of ``dev``."""
        side = self._side.get(dev)
        if side is None:
            side = self._side[dev] = torch.cuda.Stream(device=dev)
        caller = torch.cuda.current_stream(dev)
        side.wait_stream(caller)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = forward()
            except BaseException:
                # end the capture so that the stream is usable again; the
                # forward's error is the one to report
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
        caller.wait_stream(side)
        return out, graph.replay


class ForwardGraph:
    """``forward(x, cfg, fused_sdev=fused_sdev)`` captured for images of
    ``x``'s shape and dtype on ``x``'s device, replayed on one stream.
    ``tally`` is the kernel launches a replay runs (``ops.cuda``'s counter
    names), which each replay adds to ``launch.LAUNCHES``."""

    def __init__(self, forward: Forward, x: torch.Tensor, cfg: MusicaConfig,
                 fused_sdev: bool, backend):
        self.static_in = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        self.static_in.copy_(x)
        forward(self.static_in, cfg, fused_sdev=fused_sdev)  # warm-up
        with launch.recorded_launches() as tally:
            self.outputs, self._replay = backend.capture(
                lambda: forward(self.static_in, cfg, fused_sdev=fused_sdev), x.device)
        self.tally = {k: n for k, n in tally.items() if n}
        self._lock = threading.Lock()

    def run(self, x: torch.Tensor, into: Dict[str, torch.Tensor]) -> None:
        """Replay on ``x``; copy output ``k`` into ``into[k]``.  Copy in,
        replay and copy out are queued under one lock, so two threads on the
        graph's stream cannot interleave them."""
        if tuple(x.shape) != tuple(self.static_in.shape) or x.dtype != self.static_in.dtype:
            raise ValueError(f"image {tuple(x.shape)} {x.dtype}: the graph was captured for "
                             f"{tuple(self.static_in.shape)} {self.static_in.dtype}")
        with self._lock:
            self.static_in.copy_(x)
            self._replay()
            launch.add_launches(self.tally)
            for k, dst in into.items():
                dst.copy_(self.outputs[k])


def graph_key(forward: Forward, cfg: MusicaConfig, fused_sdev: bool, dev: torch.device,
              stream: int, dtype: torch.dtype) -> tuple:
    return (forward, cfg, bool(fused_sdev), dev, stream, dtype)


class GraphCache:
    """``ForwardGraph``\\ s by ``graph_key``, at most ``per_device`` on each
    device, the least recently used there dropped first.  ``backends`` maps
    a device type to its capture backend; a device type without one runs
    eagerly."""

    def __init__(self, per_device: int = MAX_GRAPHS_PER_DEVICE,
                 backends: Optional[dict] = None):
        self.per_device = per_device
        self.backends = {"cuda": CudaGraphs()} if backends is None else backends
        self.captures = 0
        self._graphs: "collections.OrderedDict[tuple, ForwardGraph]" = collections.OrderedDict()
        self._lock = threading.Lock()

    def graph(self, forward: Forward, x: torch.Tensor, cfg: MusicaConfig,
              fused_sdev: bool = False) -> Optional[ForwardGraph]:
        """The graph for images like ``x`` on the calling thread's current
        stream, captured if it is not cached; None where ``x``'s device has
        no backend."""
        backend = self.backends.get(x.device.type)
        if backend is None:
            return None
        key = graph_key(forward, cfg, fused_sdev, x.device, backend.stream(x.device), x.dtype)
        with self._lock:
            g = self._graphs.get(key)
            if g is not None:
                self._graphs.move_to_end(key)
                return g
        with _CAPTURE_LOCK:
            with self._lock:  # another thread may have captured it meanwhile
                g = self._graphs.get(key)
            if g is None:
                g = ForwardGraph(forward, x, cfg, fused_sdev, backend)
                self.captures += 1
                self.keep(key, g)
        return g

    def keep(self, key: tuple, g) -> None:
        """Cache ``g`` under ``key`` as the most recently used, and drop the
        least recently used graphs of the key's device over the bound."""
        dev = key[3]
        with self._lock:
            self._graphs[key] = g
            on_dev = [k for k in self._graphs if k[3] == dev]
            for k in on_dev[:max(0, len(on_dev) - self.per_device)]:
                del self._graphs[k]

    def cached(self) -> list:
        """The cached graphs, least recently used first."""
        with self._lock:
            return list(self._graphs.values())

    def release(self) -> None:
        with self._lock:
            self._graphs.clear()


_GRAPHS = GraphCache()


def release_graphs() -> None:
    """Drop every cached graph (their pools return to the caching
    allocator; ``torch.cuda.empty_cache()`` then gives them back to the
    device)."""
    _GRAPHS.release()


def cached_graphs() -> list:
    return _GRAPHS.cached()


def capture_count() -> int:
    """Graphs captured in this process so far."""
    return _GRAPHS.captures


def run_batch(forward: Forward, imgs: torch.Tensor, cfg: MusicaConfig,
              fused_sdev: bool = False,
              outputs: Sequence[str] = ("out_u8",)) -> Tuple[torch.Tensor, ...]:
    """``forward`` of each [n, n] image of ``imgs`` [B, n, n], one after
    another, through its graph on a CUDA device (eagerly on the CPU): one
    [B, ...] tensor per name in ``outputs``, on ``imgs``' device."""
    n = cfg.image_size
    if imgs.ndim != 3 or tuple(imgs.shape[1:]) != (n, n):
        raise ValueError(f"images {tuple(imgs.shape)}: expected [B, {n}, {n}]")
    g = _GRAPHS.graph(forward, imgs[0], cfg, fused_sdev) if len(imgs) else None
    if g is None:
        res = [forward(im, cfg, fused_sdev=fused_sdev) for im in imgs]
        return tuple(torch.stack([r[k] for r in res]) for k in outputs)
    out = tuple(torch.empty((len(imgs), *g.outputs[k].shape), dtype=g.outputs[k].dtype,
                            device=imgs.device) for k in outputs)
    for i, im in enumerate(imgs):
        g.run(im, {k: o[i] for k, o in zip(outputs, out)})
    return out

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
  next replay can overwrite them.  A ``run_batch`` call is the profiler
  span ``musica.request``, each image's copy in, launch and copies out
  ``musica.replay``, the launch ``musica.graph`` (``utils/spans.py``).

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

The spatial path (``parallel/spatial.py``, one image's rows over a mesh
row's entries) is the counterpart of the JAX package's jitted ``shard_map``
at ``space > 1``.  A ``SpatialGraph`` captures ``spatial.forward`` through
a transport of its own (``_Segmenter``) that runs the same schedule:

* the entries on one device share one capture at a time: it begins on a
  side stream of the device, the entries' streams fork from it (each waits
  on it) and join it again (it waits on each) before it ends, so their
  events and same-device exchanges are edges of one graph.  A mesh row on
  one card is one graph.
* a CUDA graph belongs to one device, and a thread may not instantiate
  one graph while it captures another, so across devices the capture is
  cut into segments, one open at a time: making an entry of another
  device current ends the open segment and begins one on that device, and
  an exchange between devices (a halo ``fetch``, ``to_first``,
  ``broadcast``, ``all_reduce``, ``gather``) ends it too, gives the
  receiver a static buffer and makes the copy a step of the replay between
  the segments.  Segments of one device share one memory pool and replay
  in the order of their capture.
* replay: every device's replay stream (its first entry's stream) current,
  copy the image's rows into each entry's static input, then each step in
  order (a segment's replay, or a copy between devices on both devices'
  current streams, which PyTorch orders both ways), then copy the outputs
  out, all under one lock.

A ``SpatialGraph`` is cached under (forward, cfg, fused_sdev, outputs, the
row's (device, stream) pairs, dtype): the outputs' gathers are work inside
the graph.  It counts against ``MAX_GRAPHS_PER_DEVICE`` on every device it
holds segments on.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..config import MusicaConfig
from ..ops.cuda import launch
from ..utils.spans import span

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

    # ---- segments of the spatial path ------------------------------------
    @staticmethod
    def pool():
        """A memory pool that a graph's segments on one device share."""
        return torch.cuda.graph_pool_handle()

    def begin(self, dev: torch.device, streams: Sequence, pool):
        """Begin capturing a segment on a side stream of ``dev``; the
        ``streams`` fork from it."""
        side = self._side.get(dev)
        if side is None:
            side = self._side[dev] = torch.cuda.Stream(device=dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.stream(side):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        for st in streams:
            st.wait_stream(side)
        return graph, side, list(streams), dev

    def end(self, seg) -> Callable[[], None]:
        """Join the streams and end the segment's capture; its replay."""
        graph, side, streams, dev = seg
        for st in streams:
            side.wait_stream(st)
        with torch.cuda.device(dev), torch.cuda.stream(side), warnings.catch_warnings():
            # a segment may hold no node (an entry made current for a view)
            warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
            graph.capture_end()
        return graph.replay

    def abort(self, seg) -> None:
        """End a segment whose capture failed, so that its streams are
        usable again; the capture's own error is the one to report."""
        graph, side, streams, dev = seg
        for st in streams:
            with contextlib.suppress(RuntimeError):
                side.wait_stream(st)
        with torch.cuda.device(dev), torch.cuda.stream(side), \
                contextlib.suppress(RuntimeError), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            graph.capture_end()

    @staticmethod
    def exchange(src: torch.Tensor, dst: torch.Tensor) -> None:
        """A cut's copy at capture: nothing runs while capturing; the copy is
        a step of the replay."""


class ForwardGraph:
    """``forward(x, cfg, fused_sdev=fused_sdev)`` captured for images of
    ``x``'s shape and dtype on ``x``'s device, replayed on one stream.
    ``tally`` is the kernel launches a replay runs (``ops.cuda``'s counter
    names), which each replay adds to ``launch.LAUNCHES`` (and ``geometry``
    to ``launch.GEOMETRY``); ``devices``: where it lies."""

    def __init__(self, forward: Forward, x: torch.Tensor, cfg: MusicaConfig,
                 fused_sdev: bool, backend):
        self.devices = (x.device,)
        self.static_in = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        self.static_in.copy_(x)
        forward(self.static_in, cfg, fused_sdev=fused_sdev)  # warm-up
        with launch.recorded_launches() as tally:
            self.outputs, self._replay = backend.capture(
                lambda: forward(self.static_in, cfg, fused_sdev=fused_sdev), x.device)
        self.tally = {k: n for k, n in tally.items() if n}
        self.geometry = dict(tally.geometry)
        self._lock = threading.Lock()

    def run(self, x: torch.Tensor, into: Dict[str, torch.Tensor]) -> None:
        """Replay on ``x``; copy output ``k`` into ``into[k]``.  Copy in,
        replay and copy out are queued under one lock, so two threads on the
        graph's stream cannot interleave them; they are the span
        ``musica.replay``, the replay alone ``musica.graph``."""
        if tuple(x.shape) != tuple(self.static_in.shape) or x.dtype != self.static_in.dtype:
            raise ValueError(f"image {tuple(x.shape)} {x.dtype}: the graph was captured for "
                             f"{tuple(self.static_in.shape)} {self.static_in.dtype}")
        with self._lock, span("musica.replay"):
            self.static_in.copy_(x)
            with span("musica.graph"):
                self._replay()
            launch.add_launches(self.tally, self.geometry)
            for k, dst in into.items():
                dst.copy_(self.outputs[k])


def graph_key(forward: Forward, cfg: MusicaConfig, fused_sdev: bool, dev: torch.device,
              stream: int, dtype: torch.dtype) -> tuple:
    return (forward, cfg, bool(fused_sdev), dev, stream, dtype)


class _Segmenter:
    """The transport of ``spatial.forward`` while a ``SpatialGraph``
    captures it (``spatial.Transport``'s interface).  The entries of a
    device (a group) share its capture.  One capture is open at a time: a
    thread may not instantiate a graph while it captures another, so making
    an entry of another device current ends the open segment and begins
    one there.  An exchange between groups, or with ``cut_every`` any
    exchange between two entries, ends the open segment and becomes a copy
    step of the replay."""

    def __init__(self, entries, backend, cut_every: bool):
        self.e = list(entries)
        self.backend = backend
        self.cut_every = cut_every
        self.devices = list(dict.fromkeys(e.device for e in self.e))
        self.group = [self.devices.index(e.device) for e in self.e]
        self.pools = {g: backend.pool() for g in range(len(self.devices))}
        self.open: Optional[Tuple[int, object]] = None  # (group, segment)
        self.active: List[int] = []  # groups of the entries made current, innermost last
        self.steps: List[tuple] = []  # ("replay", group, fn) or ("copy", src, dst)

    def _end(self) -> None:
        if self.open is not None:
            g, seg = self.open
            self.open = None
            self.steps.append(("replay", g, self.backend.end(seg)))

    def _capture(self, g: int) -> None:
        """Group ``g``'s segment open, and no other."""
        if self.open is not None and self.open[0] == g:
            return
        self._end()
        streams = [e.stream for e, h in zip(self.e, self.group) if h == g and e.stream is not None]
        self.open = (g, self.backend.begin(self.devices[g], streams, self.pools[g]))

    @contextlib.contextmanager
    def on(self, i: int):
        self._capture(self.group[i])
        self.active.append(self.group[i])
        try:
            with self.e[i].on():
                yield
        finally:
            self.active.pop()
        if self.active:  # back in an outer entry: its work goes on
            self._capture(self.active[-1])

    def send(self, t: torch.Tensor, i: int, j: int) -> torch.Tensor:
        if self.group[i] == self.group[j] and not self.cut_every:
            return self.e[i].send(t, self.e[j])
        self._end()
        # made while no segment is open: a static buffer of the graph
        dst = torch.empty(t.shape, dtype=t.dtype, device=self.e[j].device)
        self.backend.exchange(t, dst)
        self.steps.append(("copy", t, dst))
        if self.active:
            self._capture(self.active[-1])
        return dst

    def finish(self) -> None:
        self._end()

    def abort(self) -> None:
        if self.open is not None:
            self.backend.abort(self.open[1])
            self.open = None


class SpatialGraph:
    """``forward(parts, cfg, entries, outputs, fused_sdev, transport)``
    (``spatial.forward``) captured for images of ``x``'s shape and dtype
    over the mesh row ``entries``, its rows split at ``bounds`` (level 0 of
    the row plan).  ``tally``: the kernel launches a replay runs, which
    each replay adds to ``launch.LAUNCHES`` (``geometry``: to
    ``launch.GEOMETRY``); ``segments``: the graphs it
    holds; ``devices``: where they lie.  ``cut_every`` cuts at every
    exchange, also between entries of one device (the tests' check of the
    segmented replay)."""

    def __init__(self, forward, x: torch.Tensor, cfg: MusicaConfig, fused_sdev: bool,
                 outputs: Sequence[str], entries, bounds: Sequence[int], backend,
                 cut_every: bool = False):
        self.entries = list(entries)
        self.rows = list(zip(bounds[:-1], bounds[1:]))
        self.replay_streams = {}
        for e in self.entries:
            self.replay_streams.setdefault(e.device, e.stream)
        self.static_in = [torch.empty((b - a, x.shape[-1]), dtype=x.dtype, device=e.device)
                          for (a, b), e in zip(self.rows, self.entries)]
        with self._streams():
            self._copy_in(x)
        self._wait(lambda e: (e.stream, self.replay_streams[e.device]))
        run = lambda transport=None: forward(  # noqa: E731
            self.static_in, cfg, self.entries, outputs, fused_sdev, transport=transport)
        run()  # warm-up, on the entries' streams
        # the replays' copy-in must not overwrite a static input the
        # warm-up still reads
        self._wait(lambda e: (self.replay_streams[e.device], e.stream))
        seg = _Segmenter(self.entries, backend, cut_every)
        with launch.recorded_launches() as tally:
            try:
                self.outputs = run(seg)
                seg.finish()
            except BaseException:
                seg.abort()
                raise
        self.steps = seg.steps
        self.tally = {k: n for k, n in tally.items() if n}
        self.geometry = dict(tally.geometry)
        self.segments = sum(s[0] == "replay" for s in self.steps)
        self.devices = tuple(seg.devices)
        self.shape, self.dtype = tuple(x.shape), x.dtype
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def _streams(self):
        """Each device's replay stream (its first entry's) current."""
        with contextlib.ExitStack() as stack:
            for st in self.replay_streams.values():
                if st is not None:
                    stack.enter_context(torch.cuda.stream(st))
            yield

    def _wait(self, pair) -> None:
        """``a.wait_stream(b)`` for ``(a, b) = pair(entry)`` of every CUDA entry."""
        for e in self.entries:
            a, b = pair(e)
            if a is not None and a is not b:
                a.wait_stream(b)

    def _copy_in(self, x: torch.Tensor) -> None:
        for (a, b), t in zip(self.rows, self.static_in):
            t.copy_(x[a:b], non_blocking=True)

    def run(self, x: torch.Tensor, into: Dict[str, torch.Tensor]) -> None:
        """Replay on ``x``; copy output ``k`` into ``into[k]``, all under
        one lock."""
        if tuple(x.shape) != self.shape or x.dtype != self.dtype:
            raise ValueError(f"image {tuple(x.shape)} {x.dtype}: the graph was captured for "
                             f"{self.shape} {self.dtype}")
        with self._lock, self._streams():
            self._copy_in(x)
            for step in self.steps:
                if step[0] == "replay":
                    step[2]()
                else:
                    step[2].copy_(step[1], non_blocking=True)
            launch.add_launches(self.tally, self.geometry)
            for k, dst in into.items():
                dst.copy_(self.outputs[k], non_blocking=True)


def spatial_key(forward, cfg: MusicaConfig, fused_sdev: bool, outputs: Sequence[str], entries,
                dtype: torch.dtype, cut_every: bool = False) -> tuple:
    return ("spatial", forward, cfg, bool(fused_sdev), tuple(outputs),
            tuple((e.device, getattr(e.stream, "cuda_stream", e.stream)) for e in entries),
            dtype, bool(cut_every))


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
        self._devices: Dict[tuple, tuple] = {}
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
        return self._get(key, lambda: ForwardGraph(forward, x, cfg, fused_sdev, backend))

    def spatial_graph(self, forward, x: torch.Tensor, cfg: MusicaConfig, fused_sdev: bool,
                      outputs: Sequence[str], entries, bounds: Sequence[int],
                      cut_every: bool = False) -> Optional[SpatialGraph]:
        """The ``SpatialGraph`` of ``forward`` over the mesh row ``entries``
        for images like ``x``, captured if it is not cached; None where the
        entries' devices have no backend."""
        backend = self.backends.get(entries[0].device.type)
        if backend is None:
            return None
        key = spatial_key(forward, cfg, fused_sdev, outputs, entries, x.dtype, cut_every)
        return self._get(key, lambda: SpatialGraph(forward, x, cfg, fused_sdev, outputs, entries,
                                                   bounds, backend, cut_every))

    def _get(self, key: tuple, make):
        with self._lock:
            g = self._graphs.get(key)
            if g is not None:
                self._graphs.move_to_end(key)
                return g
        with _CAPTURE_LOCK:
            with self._lock:  # another thread may have captured it meanwhile
                g = self._graphs.get(key)
            if g is None:
                g = make()
                self.captures += 1
                self.keep(key, g, g.devices)
        return g

    def keep(self, key: tuple, g, devices: Optional[Sequence[torch.device]] = None) -> None:
        """Cache ``g`` under ``key`` as the most recently used, and drop the
        least recently used graphs of each of ``devices`` (default: the
        key's device) over the bound."""
        devices = (key[3],) if devices is None else tuple(devices)
        with self._lock:
            self._graphs[key] = g
            self._devices[key] = devices
            for dev in devices:
                on_dev = [k for k in self._graphs if dev in self._devices[k]]
                for k in on_dev[:max(0, len(on_dev) - self.per_device)]:
                    del self._graphs[k], self._devices[k]

    def cached(self) -> list:
        """The cached graphs, least recently used first."""
        with self._lock:
            return list(self._graphs.values())

    def release(self) -> None:
        with self._lock:
            self._graphs.clear()
            self._devices.clear()


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
    [B, ...] tensor per name in ``outputs``, on ``imgs``' device.  The call
    is the span ``musica.request``, each image's replay ``musica.replay``."""
    n = cfg.image_size
    if imgs.ndim != 3 or tuple(imgs.shape[1:]) != (n, n):
        raise ValueError(f"images {tuple(imgs.shape)}: expected [B, {n}, {n}]")
    with span("musica.request"):
        g = _GRAPHS.graph(forward, imgs[0], cfg, fused_sdev) if len(imgs) else None
        if g is None:
            res = [forward(im, cfg, fused_sdev=fused_sdev) for im in imgs]
            return tuple(torch.stack([r[k] for r in res]) for k in outputs)
        out = tuple(torch.empty((len(imgs), *g.outputs[k].shape), dtype=g.outputs[k].dtype,
                                device=imgs.device) for k in outputs)
        for i, im in enumerate(imgs):
            g.run(im, {k: o[i] for k, o in zip(outputs, out)})
        return out


def run_spatial(forward, imgs: torch.Tensor, cfg: MusicaConfig, entries, bounds: Sequence[int],
                fused_sdev: bool = False, outputs: Sequence[str] = ("out_u8",),
                cut_every: bool = False) -> Tuple[torch.Tensor, ...]:
    """``forward`` (``spatial.forward``) of each [n, n] image of ``imgs``
    over the mesh row ``entries``, one after another, through its
    ``SpatialGraph`` on CUDA entries (eagerly on CPU entries): one [B, ...]
    tensor per name in ``outputs``, on the first entry's device."""
    g = (_GRAPHS.spatial_graph(forward, imgs[0], cfg, fused_sdev, outputs, entries, bounds,
                               cut_every) if len(imgs) else None)
    if g is None:
        res = [forward(im, cfg, entries, outputs, fused_sdev) for im in imgs]
        with entries[0].on():
            return tuple(torch.stack([r[k] for r in res]) for k in outputs)
    with entries[0].on():
        out = tuple(torch.empty((len(imgs), *g.outputs[k].shape), dtype=g.outputs[k].dtype,
                                device=entries[0].device) for k in outputs)
    for i, im in enumerate(imgs):
        g.run(im, {k: o[i] for k, o in zip(outputs, out)})
    return out

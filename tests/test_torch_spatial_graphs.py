"""The spatial path as captured graphs (``models/graphs.py::SpatialGraph``)
on the CPU, through a fake capture backend for CPU entries.

``FakeSegments`` records, while a segment is open, every aten op that runs
(a ``TorchDispatchMode``), and its replay runs the recorded ops again on the
same tensors: a functional op's result is copied into the tensor the capture
made, an in-place op runs in place again, a view is left as it is (it sees
its base).  So a replay, as a CUDA graph's, reads only the static input and
the tensors the capture made, and a read of anything else shows as a wrong
result.  A read of a value on the host while capturing raises, as it does
under a CUDA capture.  The real graphs are held to eager on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` [4n])."""

import functools
import types

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import graphs, musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding, spatial
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
    synthetic_radiograph)

torch.set_num_threads(2)

SIZE = 128
CPU = torch.device("cpu")
# cfg overrides, fused_sdev, the outputs asked for
VARIANTS = {"main": ({}, False, ("out_u8",)),
            "clahe_linear": (dict(enable_clahe=True, grad_with_linear_image=True), False,
                             ("out_u8", "clahe_graded")),
            "fused_sdev": ({}, True, ("out_u8", "cnr")),
            "bf16": (dict(storage="bfloat16"), False, ("out_u8", "recon"))}
ANATOMIES = ("thorax", "hand", "knee", "pelvis")


def _replay_op(func, args, kwargs, out) -> None:
    schema = func._schema
    if any(r.alias_info is not None for r in schema.returns):
        if any(a.alias_info is not None and a.alias_info.is_write for a in schema.arguments):
            func(*args, **kwargs)  # in place (or out=): again on the same tensors
        return  # a view sees its base's new values
    res = func(*args, **kwargs)
    for o, r in zip(tree_flatten(out)[0], tree_flatten(res)[0]):
        if isinstance(o, torch.Tensor):
            o.copy_(r)


class _Segment(TorchDispatchMode):
    """The ops that run while the segment is open, for its replay."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default:
            raise RuntimeError("a value read on the host while capturing")
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out

    def replay(self) -> None:
        for op in self.ops:
            _replay_op(*op)


class FakeSegments:
    """A segment capture backend for CPU entries (``graphs.CudaGraphs``'s
    segment interface).  ``launches`` are counted through ``ops.cuda.launch``
    at each segment's begin, as a kernel wrapper counts a launch that a
    capture records; ``fail_at`` makes that begin (1 = the first) raise.
    A begin while a segment is open raises, as ending one capture while
    another is open does under CUDA's thread-local capture mode."""

    def __init__(self):
        self.launches = {}
        self.fail_at = None
        self.begins = 0
        self.open = 0
        self.replays = 0

    def pool(self):
        return None

    def begin(self, dev, streams, pool):
        self.begins += 1
        if self.fail_at == self.begins:
            raise RuntimeError("capture refused")
        if self.open:
            raise RuntimeError("a capture is open in this thread already")
        for k, n in self.launches.items():
            for _ in range(n):
                launch._count(k)
        seg = _Segment()
        seg.__enter__()
        self.open += 1
        return seg

    def end(self, seg):
        seg.__exit__(None, None, None)
        self.open -= 1

        def replay():
            self.replays += 1
            seg.replay()
        return replay

    def abort(self, seg):
        seg.__exit__(None, None, None)
        self.open -= 1

    @staticmethod
    def exchange(src, dst):
        dst.copy_(src)  # the CPU capture computes, so the receiver's ops see values


@pytest.fixture
def fake(monkeypatch):
    """A FakeSegments, installed for the CPU in a cache of the module's own."""
    backend = FakeSegments()
    monkeypatch.setattr(graphs, "_GRAPHS", graphs.GraphCache(backends={"cpu": backend}))
    launch.reset_launch_counts()
    yield backend
    launch.reset_launch_counts()


def _cfg(variant, n=SIZE):
    return MusicaConfig(image_size=n, **VARIANTS[variant][0])


@functools.lru_cache(maxsize=None)
def _imgs(b: int, n: int = SIZE) -> torch.Tensor:
    return torch.stack([torch.from_numpy(synthetic_radiograph(n, a)) for a in ANATOMIES[:b]])


@functools.lru_cache(maxsize=None)
def _eager(variant: str, s: int, b: int = 2):
    """The eager spatial path's outputs over 1 x ``s`` CPU entries."""
    _, fused, names = VARIANTS[variant]
    out = sharding.process_sharded_eager(_imgs(b), _cfg(variant),
                                         sharding.make_mesh(1, s, [CPU] * s), names, fused)
    return out if isinstance(out, tuple) else (out,)


@functools.lru_cache(maxsize=None)
def _unsharded(variant: str, b: int = 2):
    _, fused, names = VARIANTS[variant]
    res = [musica.musica_forward(x, _cfg(variant), fused_sdev=fused) for x in _imgs(b)]
    return tuple(torch.stack([r[k] for r in res]) for k in names)


def _assert_equal(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True, msg=f"{what}: output {k}")


def _entries(s):
    return [spatial.Entry(CPU) for _ in range(s)]


def _bounds(cfg, s):
    return spatial.row_plan(cfg.image_size, s, cfg).bounds[0]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_replays_equal_eager_and_the_unsharded_forward(fake, variant, shape):
    """``process_sharded`` on a spatial mesh of CPU entries with a backend:
    one capture (the row on one device is one graph), then a replay an
    image; every output bit-equal to the eager spatial path and to the
    unsharded forward."""
    d, s = shape
    _, fused, names = VARIANTS[variant]
    cfg = _cfg(variant)
    got = sharding.process_sharded(_imgs(2), cfg, sharding.make_mesh(d, s, [CPU] * (d * s)),
                                   names, fused)
    got = got if isinstance(got, tuple) else (got,)
    _assert_equal(got, _eager(variant, s), f"{variant} {d}x{s} against eager")
    _assert_equal(got, _unsharded(variant), f"{variant} {d}x{s} against musica_forward")
    (g,) = graphs.cached_graphs()  # the CPU entries of both rows have one key
    assert isinstance(g, graphs.SpatialGraph) and g.segments == 1 and fake.begins == 1
    assert graphs.capture_count() == 1 and fake.replays == 2
    assert set(g.outputs) == set(names)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("s", [2, 4])
def test_the_segmented_replay_equals_eager(fake, variant, s):
    """A cut at every exchange between entries (``cut_every``), as between
    cards: the segments and the copies between them, replayed in order,
    bit-equal to the eager spatial path, image after image."""
    _, fused, names = VARIANTS[variant]
    cfg = _cfg(variant)
    got = graphs.run_spatial(spatial.forward, _imgs(2), cfg, _entries(s), _bounds(cfg, s),
                             fused, names, cut_every=True)
    _assert_equal(got, _eager(variant, s), f"{variant} over {s}, cut at every exchange")
    (g,) = graphs.cached_graphs()
    copies = sum(step[0] == "copy" for step in g.steps)
    assert g.segments == fake.begins > s and copies >= 2 * (s - 1)
    assert fake.replays == 2 * g.segments and fake.open == 0


@pytest.mark.parametrize("variant", ["main", "clahe_linear"])
def test_entries_on_several_devices_replay_in_segments(fake, variant):
    """Entries on four devices (CPU device indices stand for cards): the
    capture is cut into segments, one open at a time, at each change of
    device and each exchange between devices; the replay equals eager.  A
    2 x 2 mesh over two devices through ``process_sharded`` too."""
    _, fused, names = VARIANTS[variant]
    cfg = _cfg(variant)
    devs = [torch.device("cpu", k) for k in range(4)]
    entries = [spatial.Entry(d) for d in devs]
    got = graphs.run_spatial(spatial.forward, _imgs(2), cfg, entries, _bounds(cfg, 4), fused,
                             names)
    _assert_equal(got, _eager(variant, 4), f"{variant} over four devices")
    (g,) = graphs.cached_graphs()
    assert g.devices == tuple(devs) and g.segments == fake.begins > 4 and fake.open == 0
    assert {step[1] for step in g.steps if step[0] == "replay"} == {0, 1, 2, 3}
    assert any(step[0] == "copy" for step in g.steps)
    mesh = sharding.make_mesh(2, 2, devs[:2] * 2)
    got = sharding.process_sharded(_imgs(2), cfg, mesh, names, fused)
    _assert_equal(got if isinstance(got, tuple) else (got,), _eager(variant, 2),
                  f"{variant}, 2 x 2 over two devices")


def test_the_cache_keys_on_outputs_entries_and_cuts(fake):
    cfg = _cfg("main")
    x = _imgs(2)

    def run(names=("out_u8",), s=2, fused=False, cut=False, imgs=x):
        return graphs.run_spatial(spatial.forward, imgs, cfg, _entries(s), _bounds(cfg, s),
                                  fused, names, cut)

    run()
    run(imgs=x.flip(0))
    assert graphs.capture_count() == 1
    run(("out_u8", "graded"))
    assert graphs.capture_count() == 2
    run(fused=True)
    assert graphs.capture_count() == 3
    run(s=4)
    assert graphs.capture_count() == 4
    run(cut=True)
    assert graphs.capture_count() == 5 and len(graphs.cached_graphs()) == 5
    run()
    run(("out_u8", "graded"))
    assert graphs.capture_count() == 5
    def e(dev, stream):
        return types.SimpleNamespace(device=torch.device(dev), stream=stream)
    fwd = spatial.forward
    row = [e("cuda:0", 1), e("cuda:0", 2)]
    key = graphs.spatial_key(fwd, cfg, False, ("out_u8",), row, torch.uint16)
    assert key == graphs.spatial_key(fwd, MusicaConfig(image_size=SIZE), False, ["out_u8"],
                                     [e("cuda:0", 1), e("cuda:0", 2)], torch.uint16)
    for other in ([e("cuda:0", 1), e("cuda:0", 3)], [e("cuda:0", 1), e("cuda:1", 2)],
                  [e("cuda:0", 2), e("cuda:0", 1)]):
        assert key != graphs.spatial_key(fwd, cfg, False, ("out_u8",), other, torch.uint16)
    assert key != graphs.spatial_key(fwd, cfg, False, ("out_u8", "cnr"), row, torch.uint16)
    assert key != graphs.spatial_key(fwd, cfg, False, ("out_u8",), row, torch.int32)
    assert key != graphs.spatial_key(fwd, cfg, False, ("out_u8",), row, torch.uint16, True)


def test_a_spatial_graph_counts_on_every_device_it_holds():
    """The bound is per device: a graph with segments on two cards counts
    on both; a third graph on either card drops that card's least recently
    used."""
    cache = graphs.GraphCache(per_device=2, backends={})
    d0, d1, d2 = (torch.device("cuda", i) for i in range(3))
    cache.keep(("a",), "spatial over 0 and 1", devices=(d0, d1))
    cache.keep(("b",), "spatial over 1 and 2", devices=(d1, d2))
    cache.keep(("c",), "spatial over 2", devices=(d2,))
    assert cache.cached() == ["spatial over 0 and 1", "spatial over 1 and 2", "spatial over 2"]
    cache.keep(("d",), "spatial over 1", devices=(d1,))
    assert cache.cached() == ["spatial over 1 and 2", "spatial over 2", "spatial over 1"]
    cache.keep(graphs.graph_key(musica.musica_forward, _cfg("main"), False, d2, 0, torch.uint16),
               "forward on 2")
    assert cache.cached() == ["spatial over 2", "spatial over 1", "forward on 2"]


def test_the_launch_tally_is_added_once_per_replay(fake):
    """The launches the capture recorded are not counted (they did not
    run); each replay adds the graph's tally, whatever its segments."""
    fake.launches = {"noise_hist": 1, "hist_argmax": 1}
    cfg = _cfg("main")
    graphs.run_spatial(spatial.forward, _imgs(3), cfg, _entries(2), _bounds(cfg, 2),
                       cut_every=True)
    (g,) = graphs.cached_graphs()
    assert g.tally == {"noise_hist": g.segments, "hist_argmax": g.segments}
    assert launch.LAUNCHES["noise_hist"] == launch.LAUNCHES["hist_argmax"] == 3 * g.segments
    assert sum(launch.LAUNCHES.values()) == 6 * g.segments


@pytest.mark.parametrize("fail_at", [1, 5])
def test_a_failed_capture_raises_and_runs_nothing_eagerly(fake, monkeypatch, fail_at):
    """A capture that fails at its first segment or in the middle (the open
    segments are ended) raises; nothing is cached and no image runs
    eagerly: the warm-up and the capture are the only runs of the schedule."""
    fake.fail_at = fail_at
    rows = []
    monkeypatch.setattr(spatial, "_Row", lambda *a: rows.append(1) or _Row(*a))
    cfg = _cfg("main")
    with pytest.raises(RuntimeError, match="capture refused"):
        if fail_at == 1:
            sharding.process_sharded(_imgs(2), cfg, sharding.make_mesh(1, 2, [CPU] * 2))
        else:
            graphs.run_spatial(spatial.forward, _imgs(2), cfg, _entries(2), _bounds(cfg, 2),
                               cut_every=True)
    assert len(rows) == 2 and fake.open == 0
    assert graphs.cached_graphs() == [] and graphs.capture_count() == 0
    assert torch._C._len_torch_dispatch_stack() == 0


_Row = spatial._Row


def test_a_failed_replay_raises(fake):
    cfg = _cfg("main")
    graphs.run_spatial(spatial.forward, _imgs(1), cfg, _entries(2), _bounds(cfg, 2),
                       cut_every=True)
    (g,) = graphs.cached_graphs()

    def broken():
        raise RuntimeError("replay failed")

    i = next(k for k, step in enumerate(g.steps) if step[0] == "replay")
    g.steps[i] = ("replay", g.steps[i][1], broken)
    with pytest.raises(RuntimeError, match="replay failed"):
        graphs.run_spatial(spatial.forward, _imgs(1), cfg, _entries(2), _bounds(cfg, 2),
                           cut_every=True)
    with pytest.raises(ValueError, match="captured for"):
        g.run(_imgs(1)[0, :64], {})


def test_process_sharded_and_throughput_step_replay_the_cached_graph(fake, monkeypatch):
    """On a spatial mesh with a backend the second calls capture nothing
    and run the schedule no more (no ``spatial.forward`` per image); the
    step's checksum equals the unsharded forward's."""
    cfg = _cfg("main")
    mesh = sharding.make_mesh(2, 2, [CPU] * 4)
    imgs = _imgs(4)
    want = musica.forward_batch(imgs, cfg)
    assert torch.equal(sharding.process_sharded(imgs, cfg, mesh), want)
    step, example = sharding.throughput_step(cfg, mesh, batch_per_device=2)
    total = int(step(example))
    captured = graphs.capture_count()
    rows = []
    monkeypatch.setattr(spatial, "_Row", lambda *a: rows.append(1) or _Row(*a))
    assert torch.equal(sharding.process_sharded(imgs, cfg, mesh), want)
    assert int(step(example)) == total == int(
        musica.forward_batch(torch.cat(example), cfg).sum(dtype=torch.int64))
    assert graphs.capture_count() == captured and rows == []


def test_cpu_entries_without_a_backend_run_eagerly():
    """No capture backend for the CPU: the caller who asks for the CPU gets
    the eager schedule, and no graph."""
    graphs.release_graphs()
    cfg = _cfg("main")
    mesh = sharding.make_mesh(1, 2, [CPU] * 2)
    assert torch.equal(sharding.process_sharded(_imgs(2), cfg, mesh), _eager("main", 2)[0])
    assert graphs.cached_graphs() == []
    with pytest.raises(ValueError, match="spatial mesh"):
        sharding.process_sharded_eager(_imgs(2), cfg, sharding.make_mesh(devices=[CPU] * 2))


class _Checked(spatial.Transport):
    """Counts how deep ``on`` is; ``_OnlyInside`` fails an op outside it."""

    depth = 0

    def on(self, i):
        outer = super().on(i)
        transport = self

        class _Ctx:
            def __enter__(self):
                transport.depth += 1
                return outer.__enter__()

            def __exit__(self, *exc):
                transport.depth -= 1
                return outer.__exit__(*exc)
        return _Ctx()


class _OnlyInside(TorchDispatchMode):
    def __init__(self, transport):
        super().__init__()
        self.t = transport
        self.outside = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        view = any(r.alias_info is not None for r in func._schema.returns) and not any(
            a.alias_info is not None and a.alias_info.is_write for a in func._schema.arguments)
        if self.t.depth == 0 and not view:
            self.outside.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_every_op_of_the_schedule_runs_inside_an_entry(variant):
    """Every op that computes runs with an entry current (``Transport.on``),
    so a capture records it on that entry's stream; only views are taken
    outside (the halo rows ``fetch`` cuts before it sends them)."""
    _, fused, names = VARIANTS[variant]
    cfg = _cfg(variant)
    entries = _entries(2)
    t = _Checked(entries)
    img = _imgs(1)[0]  # made (or taken from the cache) before the mode watches
    with _OnlyInside(t) as mode:
        out = spatial.forward(img, cfg, entries, names, fused, transport=t)
    assert mode.outside == []
    _assert_equal([out[k][None] for k in names], [o[:1] for o in _eager(variant, 2)], variant)

"""The port's compiled entries on the CPU: ``process_jit`` and
``process_batch_jit`` (``models/musica.py``) against the port's eager
``musica_forward`` (bit for bit) and the JAX package's ``process_jit`` and
``process_batch_jit`` (docs/PARITY.md's bar), and ``models/graphs.py``'s
``ForwardGraph`` and cache through its capture seam: a fake backend for the
CPU whose capture runs the forward once and keeps its tensors as the static
outputs, and whose replay runs the forward again eagerly into them.

On the CPU the entries run ``musica_forward`` eagerly (no backend for the
CPU); the real CUDA graphs are held against eager on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` [4m])."""

import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig as JConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.models import musica as j_musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import graphs, musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
    synthetic_radiograph)

from test_torch_pipeline import assert_u8_parity

torch.set_num_threads(2)

SIZE = 128
CPU = torch.device("cpu")
VARIANTS = {"main": {}, "clahe_linear": dict(enable_clahe=True, grad_with_linear_image=True),
            "bf16": dict(storage="bfloat16"), "tile8": dict(histogram_area_size=8)}


class FakeGraphs:
    """A capture backend for the CPU.  ``stream`` is the key's stream;
    ``launches`` (and ``geometry``, launches by their geometry) are counted
    through ``ops.cuda.launch`` during the capture, as a kernel wrapper
    counts a launch that a capture records; ``fail`` makes the capture
    raise."""

    def __init__(self):
        self.stream_id = 0
        self.launches = {}
        self.geometry = {}
        self.fail = False
        self.captures = 0
        self.replays = 0

    def stream(self, dev):
        return self.stream_id

    def capture(self, forward, dev):
        if self.fail:
            raise RuntimeError("capture refused")
        self.captures += 1
        for k, n in self.launches.items():
            for _ in range(n):
                launch._count(k)
        for (k, g), n in self.geometry.items():
            for _ in range(n):
                launch.count_geometry(k, g)
        out = forward()

        def replay():
            self.replays += 1
            for k, v in forward().items():
                out[k].copy_(v)

        return out, replay


@pytest.fixture
def fake(monkeypatch):
    """A FakeGraphs, installed for the CPU in a cache of the module's own."""
    backend = FakeGraphs()
    monkeypatch.setattr(graphs, "_GRAPHS", graphs.GraphCache(backends={"cpu": backend}))
    launch.reset_launch_counts()
    yield backend
    launch.reset_launch_counts()


def _img(anatomy="thorax", n=SIZE):
    return torch.from_numpy(synthetic_radiograph(n, anatomy))


def _eager(x, cfg, fused_sdev=False):
    return musica.musica_forward(x, cfg, fused_sdev=fused_sdev)["out_u8"]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("fused_sdev", [False, True])
def test_entries_equal_eager_on_the_cpu(variant, fused_sdev):
    """No backend for the CPU: the entries run musica_forward, bit for bit."""
    cfg = MusicaConfig(image_size=SIZE, **VARIANTS[variant])
    xs = torch.stack([_img(a) for a in ("thorax", "hand", "knee")])
    out = musica.process_jit(xs[0], cfg, fused_sdev)
    assert out.dtype == torch.uint8 and torch.equal(out, _eager(xs[0], cfg, fused_sdev))
    assert torch.equal(musica.process_batch_jit(xs, cfg, fused_sdev),
                       musica.forward_batch(xs, cfg, fused_sdev))
    assert graphs.cached_graphs() == []


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("fused_sdev", [False, True])
def test_replays_equal_eager(fake, variant, fused_sdev):
    """Through ForwardGraph: one capture, then a replay an image; every
    image's output equals its eager run."""
    cfg = MusicaConfig(image_size=SIZE, **VARIANTS[variant])
    xs = torch.stack([_img(a) for a in ("thorax", "hand", "knee")])
    assert torch.equal(musica.process_jit(xs[0], cfg, fused_sdev), _eager(xs[0], cfg, fused_sdev))
    assert torch.equal(musica.process_batch_jit(xs, cfg, fused_sdev),
                       musica.forward_batch(xs, cfg, fused_sdev))
    assert fake.captures == 1 and fake.replays == 4
    (g,) = graphs.cached_graphs()
    want = {"out_u8", "graded", "recon", "cnr"} | ({"clahe_graded"} if cfg.enable_clahe else set())
    assert set(g.outputs) == want


def test_process_and_process_batch_replay(fake):
    cfg = MusicaConfig(image_size=SIZE)
    imgs = np.stack([synthetic_radiograph(SIZE, a) for a in ("pelvis", "foot")])
    np.testing.assert_array_equal(musica.process(imgs[0], cfg, "cpu"),
                                  _eager(torch.from_numpy(imgs[0]), cfg).numpy())
    np.testing.assert_array_equal(musica.process_batch(imgs, cfg, "cpu"),
                                  musica.forward_batch(torch.from_numpy(imgs), cfg).numpy())
    assert fake.captures == 1 and fake.replays == 3


def test_transposed_input_is_copied(fake):
    """The campaign's runner passes the raw transposed: a strided view."""
    cfg = MusicaConfig(image_size=SIZE)
    x = _img("head")
    xt = x.T
    assert not xt.is_contiguous()
    musica.process_jit(x, cfg)  # capture on a contiguous image
    assert torch.equal(musica.process_jit(xt, cfg), _eager(xt.contiguous(), cfg))
    assert not torch.equal(musica.process_jit(xt, cfg), musica.process_jit(x, cfg))


def test_an_earlier_result_survives_a_later_replay(fake):
    cfg = MusicaConfig(image_size=SIZE)
    a_img, b_img = _img("thorax"), _img("hand")
    a = musica.process_jit(a_img, cfg)
    kept = a.clone()
    b = musica.process_jit(b_img, cfg)
    assert not torch.equal(a, b)
    assert torch.equal(a, kept) and torch.equal(b, _eager(b_img, cfg))
    (g,) = graphs.cached_graphs()
    assert a.data_ptr() != g.outputs["out_u8"].data_ptr()


def test_the_cache_keys_on_cfg_fused_sdev_stream_and_dtype(fake):
    cfg = MusicaConfig(image_size=SIZE)
    x = _img()
    musica.process_jit(x, cfg)
    musica.process_jit(_img("knee"), cfg)
    assert fake.captures == 1
    musica.process_jit(x, cfg.with_(enable_clahe=True))
    assert fake.captures == 2
    musica.process_jit(x, cfg, fused_sdev=True)
    assert fake.captures == 3
    fake.stream_id = 7
    musica.process_jit(x, cfg)
    assert fake.captures == 4
    out = musica.process_jit(x.to(torch.int32), cfg)
    assert fake.captures == 5 and torch.equal(out, _eager(x, cfg))
    assert graphs.capture_count() == 5 and len(graphs.cached_graphs()) == 5
    fake.stream_id = 0
    musica.process_jit(x, cfg)
    assert fake.captures == 5
    fwd = musica.musica_forward
    key = graphs.graph_key(fwd, cfg, False, torch.device("cuda", 0), 0, torch.uint16)
    assert key != graphs.graph_key(fwd, cfg, False, torch.device("cuda", 1), 0, torch.uint16)
    assert key == graphs.graph_key(fwd, MusicaConfig(image_size=SIZE), False,
                                   torch.device("cuda:0"), 0, torch.uint16)
    assert key != graphs.graph_key(lambda *a, **kw: fwd(*a, **kw), cfg, False,
                                   torch.device("cuda", 0), 0, torch.uint16)


def test_lru_bound_and_release(monkeypatch):
    backend = FakeGraphs()
    cache = graphs.GraphCache(per_device=2, backends={"cpu": backend})
    monkeypatch.setattr(graphs, "_GRAPHS", cache)
    cfgs = [MusicaConfig(image_size=SIZE, out_margin=m) for m in (10, 11, 12)]
    x = _img()
    fwd = musica.musica_forward
    g0 = cache.graph(fwd, x, cfgs[0])
    g1 = cache.graph(fwd, x, cfgs[1])
    assert cache.graph(fwd, x, cfgs[0]) is g0  # now the most recently used
    g2 = cache.graph(fwd, x, cfgs[2])
    assert cache.cached() == [g0, g2]  # g1, the least recently used, dropped
    assert cache.graph(fwd, x, cfgs[1]) is not g1 and backend.captures == 4
    graphs.release_graphs()
    assert cache.cached() == []
    assert torch.equal(musica.process_jit(x, cfgs[2]), _eager(x, cfgs[2]))
    assert backend.captures == 5


def test_the_bound_holds_per_device():
    """Graphs on other devices do not count against a device's bound: on a
    node of 8 cards, a mesh's graph on each and a second graph on the first
    card all stay; a third there drops that card's least recently used."""
    cache = graphs.GraphCache(per_device=2, backends={})
    cfg = MusicaConfig(image_size=SIZE)
    key = {(d, s): graphs.graph_key(musica.musica_forward, cfg, False, torch.device("cuda", d),
                                    s, torch.uint16)
           for d in range(8) for s in (1, 2, 3)}
    for d in range(8):
        cache.keep(key[d, 1], f"mesh {d}")
    cache.keep(key[0, 2], "process on cuda:0")
    assert cache.cached() == [f"mesh {d}" for d in range(8)] + ["process on cuda:0"]
    cache.keep(key[0, 3], "another on cuda:0")
    assert cache.cached() == ([f"mesh {d}" for d in range(1, 8)]
                              + ["process on cuda:0", "another on cuda:0"])


def test_a_mesh_of_eight_and_a_process_key_replay_without_recapture(fake, monkeypatch):
    """Eight mesh entries on one device (a stream each, as on the card) and
    a process_jit graph on the caller's stream fit under the bound: the next
    mesh calls and process_jit replay and capture nothing."""
    slot = threading.local()
    on_mesh = sharding._on_mesh

    def on_mesh_with_slots(mesh, fn):
        def in_slot(i, dev):
            slot.i = i
            try:
                return fn(i, dev)
            finally:
                slot.i = None
        return on_mesh(mesh, in_slot)

    monkeypatch.setattr(sharding, "_on_mesh", on_mesh_with_slots)
    monkeypatch.setattr(fake, "stream", lambda dev: getattr(slot, "i", None))
    cfg = MusicaConfig(image_size=SIZE)
    mesh = sharding.make_mesh(devices=[CPU] * 8)
    assert graphs.MAX_GRAPHS_PER_DEVICE >= len(mesh) + 1
    imgs = torch.stack([_img(a) for a in ("foot", "hand", "head", "knee",
                                          "pelvis", "thorax", "foot", "hand")])
    want = musica.forward_batch(imgs, cfg)
    assert torch.equal(sharding.process_sharded(imgs, cfg, mesh), want)
    assert torch.equal(musica.process_jit(imgs[0], cfg), want[0])
    assert fake.captures == 9
    assert torch.equal(sharding.process_sharded(imgs, cfg, mesh), want)
    step, example = sharding.throughput_step(cfg, mesh)
    assert int(step(example)) == int(musica.forward_batch(torch.cat(example), cfg)
                                     .sum(dtype=torch.int64))
    assert torch.equal(musica.process_jit(imgs[1], cfg), want[1])
    assert fake.captures == 9 and fake.replays == 8 + 1 + 8 + 8 + 1


def test_the_launch_tally_is_added_once_per_replay(fake):
    """Launches recorded by the capture are not counted (they did not run);
    each replay adds the graph's tally."""
    fake.launches = {"noise_hist": 1, "grad_hist_relevant": 1}
    cfg = MusicaConfig(image_size=SIZE)
    xs = torch.stack([_img(a) for a in ("thorax", "hand", "knee", "foot")])
    musica.process_batch_jit(xs, cfg)
    (g,) = graphs.cached_graphs()
    assert g.tally == {"noise_hist": 1, "grad_hist_relevant": 1}
    assert launch.LAUNCHES["noise_hist"] == launch.LAUNCHES["grad_hist_relevant"] == 4
    assert sum(launch.LAUNCHES.values()) == 8
    musica.process_jit(xs[0], cfg)
    assert launch.LAUNCHES["noise_hist"] == 5


def test_the_geometry_tally_is_added_once_per_replay(fake):
    """Launches counted by their geometry (the fused pyramid step's strip
    height) during the capture go to the graph, not to ``GEOMETRY``; each
    replay adds them, and ``LAUNCHES`` keeps only its own keys."""
    fake.launches = {"pyramid_down": 2}
    fake.geometry = {("reduce_step", 19): 1, ("reduce_step", 5): 1}
    cfg = MusicaConfig(image_size=SIZE)
    xs = torch.stack([_img(a) for a in ("thorax", "hand", "knee", "foot")])
    musica.process_batch_jit(xs, cfg)
    (g,) = graphs.cached_graphs()
    assert g.tally == {"pyramid_down": 2}
    assert g.geometry == {("reduce_step", 19): 1, ("reduce_step", 5): 1}
    assert launch.GEOMETRY == {("reduce_step", 19): 4, ("reduce_step", 5): 4}
    musica.process_jit(xs[0], cfg)
    assert launch.GEOMETRY == {("reduce_step", 19): 5, ("reduce_step", 5): 5}
    assert set(launch.LAUNCHES) == set(launch.Tally())
    launch.reset_launch_counts()
    assert launch.GEOMETRY == {}


def test_recorded_launches_leave_other_threads_counting():
    launch.reset_launch_counts()
    seen = {}

    def other():
        launch._count("grad_hist")

    with launch.recorded_launches() as tally:
        launch._count("noise_hist")
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        seen.update(tally)
    assert not t.is_alive()
    assert seen["noise_hist"] == 1 and seen["grad_hist"] == 0
    assert launch.LAUNCHES["noise_hist"] == 0 and launch.LAUNCHES["grad_hist"] == 1
    launch._count("noise_hist")
    assert launch.LAUNCHES["noise_hist"] == 1
    launch.reset_launch_counts()


def test_a_failed_capture_raises_and_runs_nothing_eagerly(fake, monkeypatch):
    fake.fail = True
    cfg = MusicaConfig(image_size=SIZE)
    x = _img()
    with pytest.raises(RuntimeError, match="capture refused"):
        musica.process_jit(x, cfg)
    with pytest.raises(RuntimeError, match="capture refused"):
        musica.process(x.numpy(), cfg, "cpu")
    with pytest.raises(RuntimeError, match="capture refused"):
        sharding.process_sharded(torch.stack([x, x]), cfg, sharding.make_mesh(devices=[CPU] * 2))
    assert graphs.cached_graphs() == [] and graphs.capture_count() == 0
    # the warm-up ran; nothing after the failed capture did
    calls = []
    forward = musica.musica_forward
    monkeypatch.setattr(musica, "musica_forward",
                        lambda *a, **kw: calls.append(1) or forward(*a, **kw))
    with pytest.raises(RuntimeError, match="capture refused"):
        musica.process_jit(x, cfg)
    assert len(calls) == 1


def test_a_failed_replay_raises(fake):
    cfg = MusicaConfig(image_size=SIZE)
    musica.process_jit(_img(), cfg)
    (g,) = graphs.cached_graphs()

    def broken():
        raise RuntimeError("replay failed")

    g._replay = broken
    with pytest.raises(RuntimeError, match="replay failed"):
        musica.process_jit(_img("knee"), cfg)


def test_a_wrong_shape_raises(fake):
    cfg = MusicaConfig(image_size=SIZE)
    x = _img()
    with pytest.raises(ValueError, match=r"expected \[B, 128, 128\]"):
        musica.process_jit(x[:64, :64], cfg)
    with pytest.raises(ValueError):
        musica.process_batch_jit(x, cfg)
    musica.process_jit(x, cfg)
    (g,) = graphs.cached_graphs()
    with pytest.raises(ValueError, match="captured for"):
        g.run(x[:, :64], {})
    with pytest.raises(ValueError, match="captured for"):
        g.run(x.to(torch.int32), {})
    assert graphs.capture_count() == 1


@pytest.mark.parametrize("stream", ["per_thread", "shared"])
@pytest.mark.parametrize("n", [1, 4])
def test_mesh_through_graphs_equals_forward_batch(fake, monkeypatch, stream, n):
    """process_sharded and throughput_step replay graphs in the mesh's
    worker threads: one graph per worker (a stream each), or one graph that
    all workers share (its lock keeps copy in, replay and copy out
    together), with the interpreter switching threads every microsecond."""
    if stream == "per_thread":
        monkeypatch.setattr(fake, "stream", lambda dev: threading.get_ident())
    cfg = MusicaConfig(image_size=SIZE)
    imgs = np.stack([synthetic_radiograph(SIZE, a) for a in
                     ("foot", "hand", "head", "knee", "pelvis", "thorax", "foot", "hand")])
    want = musica.forward_batch(torch.from_numpy(imgs), cfg)
    mesh = sharding.make_mesh(devices=[CPU] * n)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out, cnr = sharding.process_sharded(imgs, cfg, mesh, outputs=("out_u8", "cnr"))
        step, example = sharding.throughput_step(cfg, mesh, batch_per_device=2)
        total = int(step(example))
    finally:
        sys.setswitchinterval(interval)
    assert torch.equal(out, want)
    for i, im in enumerate(imgs):
        assert torch.equal(cnr[i], musica.musica_forward(torch.from_numpy(im), cfg)["cnr"])
    assert total == int(musica.forward_batch(torch.cat(example), cfg).sum(dtype=torch.int64))
    assert fake.replays == 8 + 2 * n and fake.captures >= 1


@pytest.mark.parametrize("fused_sdev", [False, True])
def test_entries_meet_the_parity_bar_against_jax(fused_sdev):
    """256 thorax (and a batch of three anatomies): the port's process_jit
    and process_batch_jit against the JAX package's on the CPU."""
    n = 256
    imgs = np.stack([synthetic_radiograph(n, a) for a in ("thorax", "hand", "pelvis")])
    cfg, jcfg = MusicaConfig(image_size=n), JConfig(image_size=n)
    hm = "fused_sdev_interpret" if fused_sdev else "auto"
    got = musica.process_jit(torch.from_numpy(imgs[0]), cfg, fused_sdev).numpy()
    assert_u8_parity(got, np.asarray(j_musica.process_jit(jnp.asarray(imgs[0]), jcfg, hm)),
                     "process_jit, 256 thorax")
    got_b = musica.process_batch_jit(torch.from_numpy(imgs), cfg, fused_sdev).numpy()
    want_b = np.asarray(j_musica.process_batch_jit(jnp.asarray(imgs), jcfg, hm))
    assert got_b.shape == want_b.shape == (3, n - 20, n - 20)
    for i in range(3):
        assert_u8_parity(got_b[i], want_b[i], f"process_batch_jit, image {i}")

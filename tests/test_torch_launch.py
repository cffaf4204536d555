"""``ops/cuda/launch.py::launch`` on the CPU, through a fake kernel library:
every C entry point is called with its tensors' device current and that
device's stream as its last argument, and the launch counters lose no
update when several threads launch at once (the data-parallel workers of
``parallel/sharding.py`` do)."""

import ast
import contextlib
import pathlib
import sys
import threading

import pytest
import torch

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch

CUDA_DIR = pathlib.Path(launch.__file__).parent


class FakeLib:
    """A kernel library whose entry point records the current device (as
    the recording guard below sets it) and its arguments."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []
        self.current = threading.local()

    def musica_grad_hist(self, *args):
        self.calls.append((getattr(self.current, "dev", None), args))
        return self.rc

    @staticmethod
    def musica_error_string(code):
        return b"an illegal memory access was encountered"


@pytest.fixture
def fake(monkeypatch):
    """A FakeLib, ``torch.cuda.device`` replaced by a guard that sets the
    fake's current device for the calling thread, and a stream per device
    index (1000 + index)."""
    lib = FakeLib()

    @contextlib.contextmanager
    def guard(dev):
        prev = getattr(lib.current, "dev", None)
        lib.current.dev = torch.device(dev)
        try:
            yield
        finally:
            lib.current.dev = prev

    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(launch, "stream", lambda dev: 1000 + dev.index)
    launch.reset_launch_counts()
    yield lib
    launch.reset_launch_counts()


@pytest.mark.parametrize("index", [0, 1, 3])
def test_launch_calls_the_entry_point_on_the_tensors_device(fake, index):
    dev = torch.device("cuda", index)
    launch.launch(fake, "musica_grad_hist", "grad_hist", dev, 11, 22)
    assert fake.calls == [(dev, (11, 22, 1000 + index))]
    assert getattr(fake.current, "dev", None) is None  # the guard is left
    assert launch.LAUNCHES["grad_hist"] == 1


def test_failed_launch_leaves_the_guard_and_counts_nothing(fake):
    fake.rc = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        launch.launch(fake, "musica_grad_hist", "grad_hist", torch.device("cuda:1"))
    assert fake.calls[0][0] == torch.device("cuda:1")
    assert getattr(fake.current, "dev", None) is None
    assert launch.LAUNCHES["grad_hist"] == 0


def test_threads_lose_no_launch_count(fake):
    """8 threads x 1,000 launches, each thread on a device of its own and
    with a short switch interval: the count is 8,000, and every call saw
    its own thread's device."""
    n_threads, n_launches = 8, 1000
    errors = []

    def worker(i):
        dev = torch.device("cuda", i)
        try:
            for _ in range(n_launches):
                launch.launch(fake, "musica_grad_hist", "grad_hist", dev, i)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert launch.LAUNCHES["grad_hist"] == n_threads * n_launches
    assert all(dev.index == args[0] and args[1] == 1000 + args[0] for dev, args in fake.calls)


def _launch_calls(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "launch" and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "launch"):
            yield node


@pytest.mark.parametrize("module", ["fused_hist.py", "histogram.py", "clahe_apply.py",
                                    "tonemap.py", "normalize.py", "gradation.py",
                                    "clahe_hist.py", "clahe_curves.py"])
def test_every_wrapper_passes_its_tensors_device(module):
    """Each ``launch.launch`` call of a wrapper passes ``dev`` (the device
    its tensors lie on) and no stream of its own: ``launch`` appends that
    device's stream."""
    src = (CUDA_DIR / module).read_text()
    calls = list(_launch_calls(CUDA_DIR / module))
    assert calls
    for call in calls:
        assert isinstance(call.args[3], ast.Name) and call.args[3].id == "dev", ast.dump(call)
    assert "launch.stream(" not in src and "torch.cuda.device(" not in src

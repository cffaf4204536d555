"""The PyTorch port's interactive viewer (``utils/viewer.py``) on the CPU:
the three checks of tests/test_viewer.py on the port, run with Pillow
blocked in ``sys.modules`` (the machines with the card have none), and its
render panels against the JAX package's viewer, decoded pixel for pixel."""

import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig as JConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.utils import viewer as j_viewer
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.utils import io as uio
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.utils.viewer import serve

torch.set_num_threads(2)


def _block_pillow(mp):
    for name in ("PIL", "PIL.Image"):
        mp.setitem(sys.modules, name, None)


@pytest.fixture
def no_pillow(monkeypatch):
    _block_pillow(monkeypatch)


@pytest.fixture(scope="module")
def viewer(tmp_path_factory):
    d = tmp_path_factory.mktemp("viewer")
    rng = np.random.default_rng(3)
    raw = (rng.random((256, 256)) * 40000).astype(np.uint16)
    uio.save_raw(str(d / "in.raw"), raw)
    cfg = MusicaConfig(image_size=256)
    with pytest.MonkeyPatch.context() as mp:
        _block_pillow(mp)
        server, state = serve(str(d / "in.raw"), cfg, transpose=True, port=0,
                              report_dir=str(d / "report"), block=False, device="cpu")
    base = f"http://127.0.0.1:{server.server_address[1]}"
    yield base, state, d
    server.shutdown()
    server.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read()


def _post(url):
    req = urllib.request.Request(url, method="POST", data=b"")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def _decode(blob, path):
    path.write_bytes(blob)
    return uio.load_bmp_rgb(path)


def test_viewer_page_and_panels(viewer, no_pillow):
    base, state, d = viewer
    status, body = _get(base + "/")
    assert status == 200
    html = body.decode()
    for frag in ("execute()", "flip buffer", "debugProcess()",
                 "/img/out", "noise peak bin L0"):
        assert frag in html, frag
    # out image + every render panel must be a decodable BMP
    for name in ["out"] + list(state.panels):
        s, blob = _get(f"{base}/img/{name}")
        assert s == 200 and blob[:2] == b"BM", name
        want = {"out": state.outputs[state.current].shape, "cnr": (32, 32)}.get(name, (128, 512))
        assert _decode(blob, d / "panel.bmp").shape[:2] == want, name
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(base + "/img/nope")
    assert exc.value.code == 404


def test_viewer_execute_flips_double_buffer(viewer, no_pillow):
    base, state, _ = viewer
    n0 = state.n_executes
    _post(base + "/execute")
    assert state.n_executes == n0 + 1
    assert len(state.outputs) == 2  # double buffer filled
    # same input -> both buffers identical (the reference reprocesses the
    # same raw too); flip must change currentIndex
    np.testing.assert_array_equal(state.outputs[0], state.outputs[1])
    cur = state.current
    _post(base + "/flip")
    assert state.current == 1 - cur


def test_viewer_debug_dump(viewer, no_pillow):
    base, _, d = viewer
    s, body = _post(base + "/debug")
    assert s == 200 and b"index.html" in body
    assert (d / "report" / "index.html").exists()
    assert (d / "report" / "out.bmp").exists()


def test_viewer_failing_execute_answers_500(tmp_path, no_pillow):
    """A raw replaced by a truncated file: execute answers 500 with the
    message, as the JAX package's viewer does, and the server keeps
    serving."""
    raw = np.random.default_rng(4).integers(0, 40000, (128, 128)).astype(np.uint16)
    uio.save_raw(tmp_path / "in.raw", raw)
    server, state = serve(str(tmp_path / "in.raw"), MusicaConfig(image_size=128), port=0,
                          report_dir=str(tmp_path / "rep"), block=False, device="cpu")
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        (tmp_path / "in.raw").write_bytes(b"\x00" * 300)
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "/execute")
        assert exc.value.code == 500 and b"ValueError" in exc.value.read()
        assert state.n_executes == 1 and _get(base + "/")[0] == 200
    finally:
        server.shutdown()
        server.server_close()


def test_viewer_panels_equal_jax(viewer, tmp_path):
    """The out image, every panel and the stats rows other than the input
    path and the counters against the JAX package's viewer on the same raw:
    the panels decoded pixel for pixel (the JAX viewer encodes with Pillow);
    the out image within the parity bar."""
    from test_torch_pipeline import assert_u8_parity
    _, state, d = viewer
    ref = j_viewer.ViewerState(str(d / "in.raw"), JConfig(image_size=256), True)
    ref.execute()
    assert list(ref.panels) == list(state.panels)
    for name, blob in ref.panels.items():
        np.testing.assert_array_equal(_decode(state.panels[name], tmp_path / "a.bmp"),
                                      _decode(blob, tmp_path / "b.bmp"), err_msg=name)
    assert_u8_parity(state.outputs[-1], ref.outputs[-1], "viewer out")
    keep = ("image size", "sqrt max / min", "gradation t0/ta/t1")
    assert ([r for r in state.stats if r[0] in keep or r[0].startswith("noise")]
            == [r for r in ref.stats if r[0] in keep or r[0].startswith("noise")])

"""Input normalization of the PyTorch port (``ops/normalize.py``:
``normalize_from_u16``, its plain version ``normalize_from_u16_plain`` and
``extrema_partials``) on the CPU.

The plain version is held bit for bit (the image, vmax and vmin; NaN masks
where 0/0 gives NaN) to the JAX package's ``normalize_from_u16`` on images
that hold all 65,536 uint16 values, at 512 (the quirks' reduce chain
aligned, vmin = trunc(sqrt(min))) and at 600 (misaligned, vmin = 0), with
quirks on and off, on a phantom, and on constant and all-zero images.  A
window of rows normalized with the whole image's extrema equals the whole
image's rows.  On a CUDA tensor ``normalize_from_u16`` launches the kernel
KN's two passes (here through a recording ``launch``), one with given
extrema, and the wrapper refuses what the kernel does not take."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.ops import (
    normalize as j_normalize)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops import normalize
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import launch
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.ops.cuda import (
    normalize as kn)
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
    synthetic_radiograph)

torch.set_num_threads(2)


def _image(kind: str, n: int) -> np.ndarray:
    """uint16 [n, n]: "all values" holds every uint16 value (shuffled, the
    rest random), "phantom" a pelvis, "constant" 5000 everywhere, "zero"
    zeros."""
    if kind == "all values":
        rng = np.random.default_rng(n)
        v = np.concatenate([np.arange(65536), rng.integers(0, 65536, n * n - 65536)])
        return rng.permutation(v).astype(np.uint16).reshape(n, n)
    if kind == "phantom":
        return synthetic_radiograph(n, "pelvis")
    return np.full((n, n), 5000 if kind == "constant" else 0, np.uint16)


@functools.lru_cache(maxsize=None)
def _jax(kind: str, n: int, quirks: bool):
    out, vmax, vmin = j_normalize.normalize_from_u16(jnp.asarray(_image(kind, n)), quirks)
    return np.asarray(out), np.float32(vmax), np.float32(vmin)


def _same(got: np.ndarray, want: np.ndarray) -> None:
    """Bit for bit where the values are numbers, NaN where they are NaN."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


@pytest.mark.parametrize("quirks", [True, False])
@pytest.mark.parametrize("kind,n", [("all values", 512), ("all values", 600), ("phantom", 512),
                                    ("constant", 512), ("constant", 600), ("zero", 512)])
def test_plain_equals_jax(kind, n, quirks):
    got = normalize.normalize_from_u16_plain(torch.from_numpy(_image(kind, n)), quirks)
    want = _jax(kind, n, quirks)
    for g, w in zip(got, want):
        _same(g.numpy(), w)
    if quirks and kind == "phantom":  # aligned chain: vmin is trunc(sqrt(min)) > 0
        assert want[2] == np.trunc(np.sqrt(np.float32(_image(kind, n).min()))) > 0
    if kind == "zero" or (kind == "constant" and not quirks):
        assert np.isnan(want[0]).all()  # vmax == vmin and every root is vmin: 0 / 0


@pytest.mark.parametrize("quirks", [True, False])
@pytest.mark.parametrize("n,rows", [(512, (128, 320)), (600, (150, 300)), (600, (0, 600))])
def test_window_with_the_whole_extrema_equals_the_whole(n, rows, quirks):
    img = torch.from_numpy(_image("all values", n))
    whole = normalize.normalize_from_u16(img, quirks)[0]
    part = normalize.extrema_partials(img)
    assert part.shape == (1, 2) and part.dtype == torch.float32
    a, b = rows
    got = normalize.normalize_from_u16(img[a:b], quirks, extrema=(part[0, 0], part[0, 1]))[0]
    _same(got.numpy(), whole[a:b].numpy())


def test_cpu_images_take_the_plain_version():
    img = torch.from_numpy(_image("phantom", 512))
    launch.reset_launch_counts()
    got = normalize.normalize_from_u16(img, True)
    want = normalize.normalize_from_u16_plain(img, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert launch.LAUNCHES == {k: 0 for k in launch.LAUNCHES}


@pytest.fixture
def card(monkeypatch):
    """The wrapper's CUDA path on CPU inputs: tensors report a device that
    is not the CPU (outputs are allocated on ``meta``), and ``launch``
    records each call instead of calling the library."""
    calls = []
    monkeypatch.setattr(launch, "device_of", lambda ts: torch.device("meta"))
    monkeypatch.setattr(launch, "lib", lambda: None)
    monkeypatch.setattr(launch, "launch",
                        lambda lib, fn, counter, dev, *args: calls.append((fn, counter, args)))
    return calls


def test_cuda_images_launch_both_passes(card):
    x = torch.zeros((600, 600), dtype=torch.uint16)
    out, vmax, vmin = normalize.normalize_from_u16(x, True)
    assert out.shape == (600, 600) and out.dtype == torch.float32
    assert vmax.shape == vmin.shape == ()
    names = [(fn, counter) for fn, counter, _ in card]
    assert names == [("musica_normalize_extrema", "normalize"),
                     ("musica_normalize_apply", "normalize")]
    ext, app = card[0][2], card[1][2]
    # x, dtype, count, partials, k
    assert ext[:3] == (x.data_ptr(), 0, 360000) and ext[4] == 88  # 360000 / 4096 blocks
    # x, dtype, count, out, his, los, n_ext, stride, quirks, zero_min, scalars
    assert app[:3] == (x.data_ptr(), 0, 360000) and app[6:10] == (88, 2, 1, 1)
    card.clear()
    # 512 aligns the quirks' chain; without quirks vmin is never pinned
    normalize.normalize_from_u16(torch.zeros((512, 512), dtype=torch.int32), True)
    normalize.normalize_from_u16(torch.zeros((600, 600), dtype=torch.uint16), False)
    assert card[1][2][1] == 1 and card[1][2][6:10] == (64, 2, 1, 0)
    assert card[3][2][6:10] == (88, 2, 0, 0)
    card.clear()
    # a window with given extrema (the spatial path): the apply pass alone;
    # 3072 x 3072 takes the most extrema blocks
    hi, lo = torch.tensor(9.0), torch.tensor(4.0)
    w = torch.zeros((150, 600), dtype=torch.uint16)
    normalize.normalize_from_u16(w, True, extrema=(hi, lo))
    (fn, _, args), = card
    assert fn == "musica_normalize_apply"
    assert args[4:10] == (hi.data_ptr(), lo.data_ptr(), 1, 1, 1, 1)
    assert normalize.extrema_partials(torch.zeros((3072, 3072), dtype=torch.uint16)).shape == \
        (kn.MAX_PARTIALS, 2)


def test_the_wrapper_rejects_what_the_kernel_does_not_take(card):
    x = torch.zeros((64, 64), dtype=torch.uint16)
    for bad in (x.to(torch.int64), x.to(torch.float32), x.to(torch.uint8)):
        with pytest.raises(TypeError):
            normalize.normalize_from_u16(bad, True)
    for bad in (x[None], x.T, x[:0]):
        with pytest.raises(ValueError):
            normalize.normalize_from_u16(bad, True)
    with pytest.raises(ValueError):
        normalize.normalize_from_u16(x, True, extrema=(torch.zeros(2), torch.zeros(2)))
    assert card == []

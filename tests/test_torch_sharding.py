"""The PyTorch port's data-parallel path (``parallel/sharding.py``) on the
CPU, with mesh entries that are all the CPU device (there is only one;
what is held here is the split, the per-device workers and the gather),
against the port's ``forward_batch`` (bit for bit) and the JAX package's
``process_sharded`` and ``throughput_step`` on the 8-device virtual CPU
mesh (the parity bar)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import MusicaConfig as JConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.parallel import sharding as j_sharding
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch import MusicaConfig
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.models import musica
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.parallel import sharding
from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu_torch.testing.phantoms import (
    synthetic_radiograph)

from test_torch_pipeline import assert_u8_parity

torch.set_num_threads(2)

SIZE = 128
CPU = torch.device("cpu")
ANATOMIES = ("foot", "hand", "head", "knee", "pelvis", "thorax", "foot", "hand")


@pytest.fixture(scope="module")
def imgs():
    return np.stack([synthetic_radiograph(SIZE, a) for a in ANATOMIES])


@pytest.fixture(scope="module")
def batch_ref(imgs):
    return musica.forward_batch(torch.from_numpy(imgs), MusicaConfig(image_size=SIZE))


@pytest.fixture(scope="module")
def jax_ref(imgs):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = j_sharding.make_mesh(n_data=8, n_space=1)
    return np.asarray(j_sharding.process_sharded(jnp.asarray(imgs), JConfig(image_size=SIZE), mesh))


@pytest.mark.parametrize("n", [1, 4, 8])
def test_process_sharded_equals_forward_batch_and_jax(imgs, batch_ref, jax_ref, n):
    mesh = sharding.make_mesh(devices=[CPU] * n)
    out = sharding.process_sharded(imgs, MusicaConfig(image_size=SIZE), mesh)
    assert out.device == CPU and out.dtype == torch.uint8
    assert torch.equal(out, batch_ref)
    assert_u8_parity(out.numpy(), jax_ref, f"mesh of {n} vs the JAX package's 8-device mesh")


def test_multiple_outputs_and_fused_sdev(imgs, batch_ref):
    cfg = MusicaConfig(image_size=SIZE)
    mesh = sharding.make_mesh(devices=[CPU] * 4)
    out, cnr = sharding.process_sharded(torch.from_numpy(imgs), cfg, mesh,
                                        outputs=("out_u8", "cnr"), fused_sdev=True)
    assert torch.equal(out, batch_ref)
    assert cnr.shape == (8, SIZE // 8, SIZE // 8) and cnr.dtype == torch.float32
    for i, im in enumerate(imgs):
        assert torch.equal(cnr[i], musica.musica_forward(torch.from_numpy(im), cfg)["cnr"])


def test_batch_must_split_evenly(imgs):
    mesh = sharding.make_mesh(devices=[CPU] * 3)
    with pytest.raises(ValueError, match="does not split evenly"):
        sharding.process_sharded(imgs, MusicaConfig(image_size=SIZE), mesh)


def test_a_workers_exception_reaches_the_caller(imgs, monkeypatch):
    """Image 5 (device 2's second on a mesh of 4) fails: the caller gets its
    exception once every worker has ended; no partial output is returned."""
    forward = musica.musica_forward
    seen = []

    def failing(im, cfg, **kw):
        seen.append(int(im[0, 0]))
        if int(im[0, 0]) == 12345:
            raise RuntimeError("image 5 failed")
        return forward(im, cfg, **kw)

    bad = imgs.copy()
    bad[5, 0, 0] = 12345
    monkeypatch.setattr(sharding.musica, "musica_forward", failing)
    with pytest.raises(RuntimeError, match="image 5 failed"):
        sharding.process_sharded(bad, MusicaConfig(image_size=SIZE),
                                 sharding.make_mesh(devices=[CPU] * 4))
    assert sorted(seen) == sorted(int(v) for v in bad[:, 0, 0])


def test_make_mesh():
    assert sharding.make_mesh(devices=["cpu", "cpu", "cpu"]) == (CPU,) * 3
    assert sharding.make_mesh(n_data=2, devices=[CPU] * 3) == (CPU,) * 2
    # n_space > 1: n_data rows of n_space devices, in the order of
    # np.array(devices).reshape(n_data, n_space)
    devs = [torch.device("cpu", i) for i in range(8)]
    assert sharding.make_mesh(n_data=2, n_space=4, devices=devs) == (tuple(devs[:4]),
                                                                     tuple(devs[4:]))
    assert sharding.make_mesh(n_space=2, devices=devs[:6]) == tuple(
        tuple(devs[i:i + 2]) for i in (0, 2, 4))
    with pytest.raises(ValueError):
        sharding.make_mesh(n_data=3, n_space=4, devices=devs)
    with pytest.raises(ValueError):
        sharding.make_mesh(n_data=4, devices=[CPU] * 3)
    if torch.cuda.is_available():
        assert sharding.make_mesh() == tuple(torch.device("cuda", i)
                                             for i in range(torch.cuda.device_count()))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.make_mesh()


def test_throughput_step_checksum():
    """The checksum equals the port's forward_batch sum over the same
    example, and the JAX package's uint32 psum on a 4x1 mesh modulo 2**32
    where the two pipelines' outputs are bit-equal."""
    cfg = MusicaConfig(image_size=SIZE)
    mesh = sharding.make_mesh(devices=[CPU] * 4)
    step, example = sharding.throughput_step(cfg, mesh, batch_per_device=2)
    assert len(example) == 4 and all(e.shape == (2, SIZE, SIZE) for e in example)
    batch = np.random.default_rng(0).integers(0, 65535, (8, SIZE, SIZE), dtype=np.uint16)
    np.testing.assert_array_equal(torch.cat(example).numpy(), batch)
    total = step(example)
    assert total.shape == () and total.dtype == torch.int64 and total.device == CPU
    outs = musica.forward_batch(torch.from_numpy(batch), cfg)
    assert int(total) == int(outs.sum(dtype=torch.int64))

    j_mesh = j_sharding.make_mesh(n_data=4, n_space=1)
    j_step, j_example = j_sharding.throughput_step(JConfig(image_size=SIZE), j_mesh, 2)
    np.testing.assert_array_equal(np.asarray(j_example), batch)
    j_outs = np.asarray(j_sharding.process_sharded(j_example, JConfig(image_size=SIZE), j_mesh))
    assert_u8_parity(outs.numpy(), j_outs, "throughput example")
    if np.array_equal(outs.numpy(), j_outs):
        assert int(total) % 2 ** 32 == int(j_step(j_example))
    else:
        assert int(j_step(j_example)) == int(j_outs.astype(np.int64).sum()) % 2 ** 32

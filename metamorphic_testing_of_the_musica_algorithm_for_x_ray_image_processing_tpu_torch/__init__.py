"""MUSICA on PyTorch and CUDA: the port of the JAX/Pallas package
``metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu``
to an NVIDIA Hopper GPU.

The module layout mirrors the JAX package so that each counterpart is easy
to find:

- ``ops``     : plain PyTorch ops (normalize, pyramid, stats, curves, noise,
                gradation, clahe) and ``ops.cuda``, the hand-written CUDA
                kernels with their wrappers, plain versions and launch
                counters;
- ``models``  : ``musica_forward``, ``process``, ``process_batch`` and
                ``timed_process``, with the CLAHE and linear-gradation
                variants;
- ``csrc``    : the CUDA C++ sources, built with ``nvcc`` at first use;
- ``parallel``: data parallelism over several devices (``sharding``:
                ``make_mesh``, ``process_sharded``, ``throughput_step``);
- ``cli``     : ``process``, ``batch``, ``report``, ``view``, ``campaign``,
                ``slope-analysis`` and ``mean-cnr``;
- ``config``  : ``MusicaConfig``;
- ``utils``   : raw/BMP IO (``io``), the debug dump with its renders and
                ``StageTimer`` (``debug``, ``render``), the HTML report
                (``report``) and the HTTP viewer (``viewer``);
- ``testing`` : synthetic radiographs and the metamorphic-testing harness.

Every entry point takes an explicit device.  A kernel runs when its input
lies on a CUDA device, on that device, from any thread; on the CPU its plain
PyTorch version runs instead.

The port imports nothing of the JAX package: ``config``, ``utils`` and
``testing`` are its own copies of that package's NumPy modules, held equal
to them by the tests.  Every function reads ``cfg`` by attribute, so the
JAX package's ``MusicaConfig`` drives the port as well.
"""

from .config import MusicaConfig  # noqa: F401

__version__ = "0.1.0"

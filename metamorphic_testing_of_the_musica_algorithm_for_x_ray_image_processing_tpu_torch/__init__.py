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
- ``cli``     : ``process`` and ``batch``.

Every entry point takes an explicit device.  A kernel runs when its input
lies on a CUDA device; on the CPU its plain PyTorch version runs instead.

The configuration is the JAX package's frozen ``MusicaConfig`` itself (a
pure-Python module), so one ``cfg`` object drives both packages.
"""

from metamorphic_testing_of_the_musica_algorithm_for_x_ray_image_processing_tpu.config import (  # noqa: F401
    MusicaConfig,
)

__version__ = "0.1.0"

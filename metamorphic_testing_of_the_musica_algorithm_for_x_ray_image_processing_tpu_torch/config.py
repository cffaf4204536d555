"""Runtime configuration for the MUSICA pipeline of the PyTorch port.

The port's own copy of the JAX package's ``config.py``: the same frozen
dataclass with the same fields, defaults and derived schedules, so that the
port imports nothing of that package.  The tests hold the two equal field by
field and in every derived property (``tests/test_torch_standalone.py``).
The port's functions read a configuration by attribute only, so either
package's ``MusicaConfig`` drives them.

The reference hardcodes every algorithm constant as ``static const`` members
and compile-time ``#define``s (``include/vk_processing.h:13-49``); this module
replaces that with a single immutable, hashable dataclass.

Derived per-level schedules (contrast factors, noise-reduction ramps, pyramid
level sizes) are exposed as cached properties; they reproduce the arithmetic
in ``src/vk_processing.cpp:259-331`` exactly (including the reversed
noise-reduction buffer wiring at ``src/vk_processing.cpp:1518-1520``, which in
effect aligns params index with pyramid level).
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property
from typing import Tuple


def pyramid_level_sizes(image_size: int) -> Tuple[int, ...]:
    """Sizes of the pyramid level *inputs*: ``s_0 = n``, ``s_{i+1} = ceil(s_i/2)``.

    ``pyramid_levels = ceil(log2(n))`` levels are built
    (``src/vk_processing.cpp:1989``); the input of level i has size
    ``sizes[i]`` and its downsampled output has size ``sizes[i+1]`` (the last
    one being 1x1 for power-of-two-adjacent sizes).
    """
    levels = num_pyramid_levels(image_size)
    sizes = [image_size]
    for _ in range(levels):
        sizes.append(-(-sizes[-1] // 2))  # ceil div
    return tuple(sizes)


def num_pyramid_levels(image_size: int) -> int:
    """``ceil(log2(imageSize))`` -> 12 for 3072 (``src/vk_processing.cpp:1989``)."""
    return int(math.ceil(math.log2(image_size)))


@dataclasses.dataclass(frozen=True)
class MusicaConfig:
    """All knobs of the MUSICA pipeline.

    Defaults reproduce the reference standalone CLI configuration
    (``test/standalone/main.cpp:31``: 3072x3072, margin-10 crop).
    """

    image_size: int = 3072

    # --- pyramid / analysis structure (include/vk_processing.h:28-41) ---
    coarser_levels_start: int = 3     # first "coarse" level (inclusive)
    cnr_level: int = 3                # level whose sdev defines the CNR map
    noise_histogram_bins: int = 2048
    grad_histogram_bins: int = 1024
    histogram_area_size: int = 16     # per-thread tile in the hist shaders
    hist_workgroup_coverage: int = 512  # 32 threads * 16 px tile
    reduce_area_size: int = 8         # max/min reduce block
    max_noise_value: float = 0.1      # noise-hist domain [0, 0.1]
    max_cnr_value: float = 256.0

    # --- contrast enhancement (include/vk_processing.h:48-49) ---
    high_contrast_max_reduction: float = 0.2
    low_contrast_max_enhancement: float = 3.0
    linear_low_contrast: bool = False   # LINEAR_LOW_CONTRAST_LEVELS_REDUCTION
    linear_high_contrast: bool = False  # LINEAR_HIGH_CONTRAST_LEVELS_REDUCTION

    # --- noise reduction (include/vk_processing.h:43-46) ---
    nr_high_cnr: float = 9.0
    nr_max_high_factor: float = 1.2
    nr_low_cnr: float = 3.0
    nr_min_low_factor: float = 0.6

    # --- relevance mask (shaders/img_relevant.comp:22-27) ---
    relevant_border: int = 100
    relevant_cnr_low: float = 1.0
    relevant_cnr_ramp: float = 5.0
    relevant_k: float = 5.0
    relevant_max_pixel: float = 0.90

    # --- gradation curve (shaders/gradation_curve_generate.comp:49-60) ---
    grad_lowest_relevant_bin: int = 10
    grad_slope: float = 3.0
    grad_y_mid: float = 0.5
    grad_t0_backoff: float = 0.01
    grad_low_threshold_frac: float = 0.05

    # --- output (src/vk_processing.cpp:2603-2645) ---
    out_margin: int = 10

    # --- variants (compile-time #defines in the reference) ---
    enable_clahe: bool = False        # ENABLE_CLAHE
    grad_with_linear_image: bool = False  # GRAD_WITH_LINEAR_IMAGE
    clahe_tiles: int = 4
    clahe_bins: int = 256
    clahe_clip_limit: float = 1.0 / 32.0

    # --- storage precision (TPU-native fast mode; no reference analogue) ---
    # "float32" (default) is the reference-parity mode: every stage image is
    # f32 and the output is bit-exact vs the golden model.  "bfloat16" stores
    # the BAND streams -- pyramid bandpasses, contrast-applied bandpasses and
    # noise-reduced bandpasses -- as bf16, halving their HBM traffic; the
    # casts fuse into producers/consumers so no extra full-image passes are
    # materialized.  The level inputs (normalized, downs) and the recon
    # accumulation deliberately stay f32: a band is `in - low`, a
    # near-cancelling difference, so quantizing the INPUTS passes high-
    # frequency quantization noise (~bf16 ulp of 0.5 = 2e-3) straight into
    # fine-level bands of magnitude ~1e-2, inflating the noise analysis
    # (level-3 sdev +20%, CNR across the relevance cliff, tone curve shifted
    # by tens of u8 LSB on some anatomies -- the measured failure of the
    # round-4 full-bf16-ladder design, docs/ROUND5.md).  Rounding the
    # computed band instead is relative to the band (~0.4%), benign for the
    # analysis and the reconstruction.  Accuracy vs the f32 parity mode is
    # measured in tests/test_bf16.py (all six anatomies) and on chip in
    # artifacts/exp_bf16.json + docs/PERFORMANCE.md "bf16 storage".
    storage: str = "float32"

    # --- fidelity mode ---
    # quirks=True reproduces the reference's GPU artifacts exactly:
    #   * max/min reduce truncate to integers each step (uvec4 store,
    #     shaders/img_max_reduce.comp:52) and the min chain absorbs
    #     out-of-bounds zeros (robust-access imageLoad), so min == 0 for
    #     any size whose ceil/8 chain misaligns (3072 does);
    #   * noise-hist per-tile-column `break` semantics
    #     (shaders/noise_hist.comp:30-40);
    #   * grad-hist whole-tile `return` on the first zero pixel
    #     (shaders/gradation_histogram.comp:25);
    #   * uint32 wrap-around + integer division in the gradation mean
    #     (shaders/gradation_curve_generate.comp:67-76);
    #   * histogram coverage limited to (image_size // 512) * 512 pixels
    #     (integer-division dispatch, src/vk_processing.cpp:2292).
    # quirks=False computes the clean equivalents.
    quirks: bool = True

    def __post_init__(self):
        assert self.image_size >= 4, "image_size too small"
        assert self.cnr_level >= 1
        assert self.storage in ("float32", "bfloat16"), self.storage

    # ------------------------------------------------------------------
    # derived schedules
    # ------------------------------------------------------------------

    @cached_property
    def pyramid_levels(self) -> int:
        return num_pyramid_levels(self.image_size)

    @cached_property
    def level_sizes(self) -> Tuple[int, ...]:
        return pyramid_level_sizes(self.image_size)

    @cached_property
    def contrast_factors(self) -> Tuple[Tuple[float, float], ...]:
        """Per level i: (low_contrast_factor, high_contrast_factor).

        src/vk_processing.cpp:259-293.  low factor boosts weak detail on fine
        levels; high factor compresses latitude on coarse levels.
        """
        out = []
        levels = self.pyramid_levels
        coarser = self.coarser_levels_start
        coarser_count = levels - coarser
        for i in range(levels):
            if self.linear_high_contrast:
                hcf = (1.0 if i < coarser else
                       1.0 - (i - coarser) * (1.0 - self.high_contrast_max_reduction)
                       / (levels - coarser - 1))
            else:
                hcf = (1.0 if i < coarser else
                       self.high_contrast_max_reduction
                       ** ((i - coarser) / (coarser_count - 1)))
            if self.linear_low_contrast:
                lcf = (self.low_contrast_max_enhancement
                       - i * ((self.low_contrast_max_enhancement - 1.0) / coarser)
                       if i < coarser else 1.0)
            else:
                lcf = (self.low_contrast_max_enhancement ** (1.0 - i / coarser)
                       if i < coarser else 1.0)
            out.append((float(lcf), float(hcf)))
        return tuple(out)

    @cached_property
    def noise_reduction_params(self) -> Tuple[Tuple[float, float, float, float], ...]:
        """Per level L in [0, cnr_level): (low_cnr, low_factor, high_cnr, high_factor).

        Params buffer index == pyramid level: the reference allocates the
        schedule at src/vk_processing.cpp:321-325 and binds buffer
        ``[cnrLevel - i - 1]`` to shader i (src/vk_processing.cpp:1518-1520),
        where shader i processes level ``cnrLevel - 1 - i`` -- so level L uses
        schedule entry L.  Finest level gets the strongest ramp (0.6 -> 1.2).
        """
        out = []
        for level in range(self.cnr_level):
            high_f = (self.nr_max_high_factor
                      - (self.nr_max_high_factor - 1.0) * (level / self.cnr_level))
            low_f = (self.nr_min_low_factor
                     + (1.0 - self.nr_min_low_factor) * (level / self.cnr_level))
            out.append((self.nr_low_cnr, float(low_f), self.nr_high_cnr, float(high_f)))
        return tuple(out)

    @cached_property
    def analysis_levels(self) -> Tuple[int, ...]:
        """Levels for which sdev + noise histogram + hist-max run.

        ``i < coarserLevelsStart || i <= cnrLevel`` (src/vk_processing.cpp:2284).
        """
        return tuple(i for i in range(self.pyramid_levels)
                     if i < self.coarser_levels_start or i <= self.cnr_level)

    @cached_property
    def hist_coverage(self) -> int:
        """Pixels (per axis) actually scanned by the noise histograms.

        The reference dispatches ``imageSize / histWorkgroupCoverage`` integer
        workgroups (src/vk_processing.cpp:2292), i.e. coverage is rounded
        *down* to a multiple of 512 for the noise hist.  Exact for 3072.
        """
        if not self.quirks:
            return self.image_size
        return (self.image_size // self.hist_workgroup_coverage) * self.hist_workgroup_coverage

    def with_(self, **kw) -> "MusicaConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = MusicaConfig()

"""Plain PyTorch ops of the MUSICA pipeline (``ops.cuda`` holds the kernels)."""

import torch


def f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 constant on ``like``'s device, made by a fill kernel
    (no host-to-device copy, so no host sync).

    Divide by this rather than by a Python float: for a CPU-scalar divisor,
    PyTorch's CUDA division multiplies by the reciprocal, which moves results
    by an ulp (``x / 0.1`` must be correctly rounded, QUIRKS #7)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)

"""Device: the sum of the kernels' device time an image (ms)."""


def read(trace):
    t = trace.kernel_s()
    return 1e3 * t / trace.images if t > 0 else None

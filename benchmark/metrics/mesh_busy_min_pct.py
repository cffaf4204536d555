"""Data parallelism: the busy share (a kernel or a copy running) of the
least busy card over the traced window (%); nothing on one card."""


def read(trace):
    if len(trace.devices) < 2:
        return None
    return 100.0 * min(trace.busy_s(d) for d in trace.devices) / trace.window_s

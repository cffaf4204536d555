"""Device: the share of the traced window in which a card runs neither a
kernel nor a copy (%), the mean over the cards."""


def read(trace):
    busy = sum(trace.busy_s(d) for d in trace.devices) / len(trace.devices)
    return 100.0 * (1.0 - busy / trace.window_s)

"""Host API: the share of the traced window in which the card is idle
between the port's requests, outside every request's device extent: the
caller's turnaround (%), the mean over the cards; nothing where the port
emits no ``musica.request`` span (``Trace.idle_split``)."""


def read(trace):
    return trace.gap_pct("request")

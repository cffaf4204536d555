"""Compiled entries: the share of the traced window in which the card is
idle inside a request's device extent but in no graph: an image's copies'
edges, the graph launch's latency, the host's issue between images (%), the
mean over the cards; nothing where the port emits no ``musica.request``
span (``Trace.idle_split``)."""


def read(trace):
    return trace.gap_pct("image")

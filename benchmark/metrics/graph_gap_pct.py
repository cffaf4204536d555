"""Compiled entries: the share of the traced window in which the card is
idle inside a ``musica.graph`` range, between the captured graph's nodes
(%), the mean over the cards; nothing where the port emits no
``musica.request`` span (``Trace.idle_split``)."""


def read(trace):
    return trace.gap_pct("graph")

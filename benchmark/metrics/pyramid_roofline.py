"""Pipeline stages: the pyramid stage's least time (its bytes at the cell's
shapes, ``stages/pyramid.py``, over the card's peak bandwidth) over the device
time of the kernels that ``stages/pyramid.json`` assigns to it (%)."""


def read(trace):
    return trace.roofline_pct("pyramid")

"""Pipeline stages: the contrast stage's least time (its bytes at the cell's
shapes, ``stages/contrast.py``, over the card's peak bandwidth) over the device
time of the kernels that ``stages/contrast.json`` assigns to it (%)."""


def read(trace):
    return trace.roofline_pct("contrast")

"""Pipeline stages: the clahe stage's least time (its bytes at the cell's
shapes, ``stages/clahe.py``, over the card's peak bandwidth) over the device
time of the kernels that ``stages/clahe.json`` assigns to it (%)."""


def read(trace):
    return trace.roofline_pct("clahe")

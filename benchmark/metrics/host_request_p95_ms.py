"""Host API: the 95th percentile of the traced requests' latencies, each
from its submission to its outputs being ready on the host clock (ms): the
study cell's tail, which swings too much from run to run to be held to an
end-to-end bound there."""

import numpy as np


def read(trace):
    return float(np.percentile(trace.latency_s, 95)) * 1e3 if trace.latency_s else None

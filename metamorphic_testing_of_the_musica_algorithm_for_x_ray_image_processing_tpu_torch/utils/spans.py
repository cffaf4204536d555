"""The port's profiler spans: one helper, ``span``, through which every
span of the port goes.

``span(name)`` enters ``torch.profiler.record_function(name)`` while a
profiler records, and returns one shared ``contextlib.nullcontext()``
otherwise.  ``record_function`` is not free without a profiler (it enters
the dispatcher's profiler op either way): unguarded it costs 8-12 µs,
behind this check 0.6 µs (the mean of 100,000 calls on an H100 machine's
host; 5.0 and 0.28 µs on a CPU-only host).

The check finds a profiler recording where ``torch.profiler`` (or the
autograd profiler) was started from Python, which sets a process-wide flag
that worker threads see too, or where the profiler's own state is on for
the calling thread, however it was started.  A profiler started outside
Python that leaves both off (an on-demand Kineto trace) records none of
these spans.

Every span is named ``musica.<what>``, so a reader of a profiler record
tells the program's spans, and the device-side ranges the profiler draws
for them (from the first to the last device operation issued inside a span
and no inner one), from kernels and copies by that prefix:

* ``musica.<phase>``: each phase of ``musica_forward``
  (``models/musica.py``), in eager calls (``cli process --profile``,
  ``timed_process``) and at a graph's warm-up and capture;
* ``musica.request``: one ``graphs.run_batch`` call (a request);
* ``musica.replay``: one image of it in ``ForwardGraph.run``, its copy in,
  graph launch and copies out;
* ``musica.graph``: the graph's launch alone; its device-side range holds
  the captured graph's kernels.

A request's images are the ``musica.replay`` spans nested in its
``musica.request`` on its host thread (``scripts/idle_split.py``).
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """The context of the span ``name`` (which starts with ``musica.``)."""
    if _profiler._is_profiler_enabled or torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF

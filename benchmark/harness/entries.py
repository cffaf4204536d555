"""What every entry shares.  An entry is how a request enters the program:
``benchmark/entries/<entry>.py``, named by a traffic mix's ``entry`` and
found by that name (``spec.entry``).  The module gives

* ``Entry``, the class built at set-up as ``Entry(prog, cfg, pool,
  devices, options, seed)``: the program's modules, its configuration, the
  pool, the cell's devices, the configuration file's ``options`` (keyword
  arguments of the port's call that are not ``MusicaConfig`` fields, passed
  on to that call) and the run's seed.  It has ``pools`` (where it takes
  the pool: ``device`` and/or ``host``), ``products`` (the names of its
  outputs), ``keys`` ({product: the key its compared numbers are named
  under}, ``compare.py``), ``submit(start, count)`` (the program's call on
  the pool's images ``[start, start + count)``, returning one output per
  product, then whatever the entry records for the reference: the
  request's note) and ``wait()`` (until those outputs are ready).  It calls
  the program through its modules' attributes at every request, so a test
  can break the timed path underneath;
* ``expected(item, raw, fields)``, a module-level function: for a sampled
  request ``item`` (``traffic.Done``), the outputs the reference expects of
  each of its images, a dict by product name, from ``raw(i)`` (pool image
  ``i`` on the reference's device) and the configuration's ``fields``
  alone.  It runs after the program's state is freed, so it needs none of
  it: an entry whose requests alter their inputs records in the note what
  ``expected`` needs to rebuild them.  ``plain_expected`` is the default.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Sequence

import torch

from ..reference import musica_plain

# the key of each product's compared numbers (``compare.py``)
KEYS = {"out_u8": "u8", "clahe_graded": "clahe"}


def products(cfg) -> tuple:
    """The outputs a deployment of ``cfg`` takes from a request."""
    return ("out_u8", "clahe_graded") if cfg.enable_clahe else ("out_u8",)


def synchronize(devices: Sequence[torch.device]) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def plain_expected(item, raw: Callable[[int], torch.Tensor],
                   fields: dict) -> Iterator[Dict[str, torch.Tensor]]:
    """The reference's outputs of each pool image the request sent as it
    is: ``musica_plain.forward`` of images ``[start, start + count)``."""
    pcfg = musica_plain.PlainConfig(fields)
    for i in range(item.start, item.start + item.count):
        yield musica_plain.forward(raw(i), pcfg)

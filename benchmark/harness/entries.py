"""How a request enters the program: one class per ``entry`` of a traffic
mix.  Each is built at set-up with the program, its configuration, the
pool and the cell's devices, and is called as ``submit(start, count)``
(the program's call on the pool's images ``[start, start + count)``,
returning its outputs, one per name in ``products``) then ``wait()``
(until those outputs are ready).  They call the program through its
modules' attributes at every request, so a test can break the timed path
underneath.

* ``Resident``: ``process_batch_jit`` on images on the card, the replay
  of the forward's CUDA graph an image.  With CLAHE on, ``process_batch_jit``
  drops the CLAHE image, so the request asks its graphs for both outputs
  through ``graphs.run_batch``, the function it wraps.
* ``Host``: ``process_batch`` on images in pageable host memory; it copies
  a request to the card and returns host uint8 arrays.
* ``Mesh``: ``process_sharded`` over a data-parallel mesh of the cell's
  cards, each card's share copied to it from where the pool lies, the
  outputs gathered on the first card.
"""

from __future__ import annotations

from typing import Sequence

import torch


def products(cfg) -> tuple:
    """The outputs a deployment of ``cfg`` takes from a request."""
    return ("out_u8", "clahe_graded") if cfg.enable_clahe else ("out_u8",)


def synchronize(devices: Sequence[torch.device]) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Resident:
    pools = ("device",)

    def __init__(self, prog, cfg, pool, devices):
        self.prog, self.cfg, self.pool, self.devices = prog, cfg, pool, list(devices)
        self.products = products(cfg)

    def submit(self, start: int, count: int) -> tuple:
        batch = self.pool[start:start + count]
        if self.products == ("out_u8",):
            return (self.prog.musica.process_batch_jit(batch, self.cfg),)
        return self.prog.graphs.run_batch(self.prog.musica.musica_forward, batch, self.cfg,
                                          False, self.products)

    def wait(self) -> None:
        synchronize(self.devices[:1])


class Host:
    pools = ("host",)

    def __init__(self, prog, cfg, pool, devices):
        if cfg.enable_clahe:
            raise ValueError("the host API (process_batch) returns no CLAHE image")
        self.prog, self.cfg, self.pool, self.devices = prog, cfg, pool, list(devices)
        self.products = ("out_u8",)

    def submit(self, start: int, count: int) -> tuple:
        return (self.prog.musica.process_batch(self.pool[start:start + count], self.cfg,
                                               self.devices[0]),)

    def wait(self) -> None:
        """``process_batch`` returns host arrays: nothing is left to wait for."""


class Mesh:
    pools = ("device", "host")

    def __init__(self, prog, cfg, pool, devices):
        self.prog, self.cfg, self.pool, self.devices = prog, cfg, pool, list(devices)
        self.products = products(cfg)
        self.mesh = prog.sharding.make_mesh(len(self.devices), devices=self.devices)

    def submit(self, start: int, count: int) -> tuple:
        out = self.prog.sharding.process_sharded(self.pool[start:start + count], self.cfg,
                                                 self.mesh, outputs=self.products)
        return out if isinstance(out, tuple) else (out,)

    def wait(self) -> None:
        synchronize(self.devices)


ENTRIES = {"resident": Resident, "host": Host, "mesh": Mesh}

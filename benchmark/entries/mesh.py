"""Requests over a data-parallel mesh of the cell's cards:
``process_sharded``, each card's share copied to it from where the pool
lies, the outputs gathered on the first card."""

from benchmark.harness import entries

expected = entries.plain_expected


class Entry:
    pools = ("device", "host")
    keys = entries.KEYS

    def __init__(self, prog, cfg, pool, devices, options, seed):
        self.prog, self.cfg, self.pool, self.devices = prog, cfg, pool, list(devices)
        self.options = options
        self.products = entries.products(cfg)
        self.mesh = prog.sharding.make_mesh(len(self.devices), devices=self.devices)

    def submit(self, start: int, count: int) -> tuple:
        out = self.prog.sharding.process_sharded(self.pool[start:start + count], self.cfg,
                                                 self.mesh, outputs=self.products,
                                                 **self.options)
        return out if isinstance(out, tuple) else (out,)

    def wait(self) -> None:
        entries.synchronize(self.devices)

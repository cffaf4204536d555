"""Requests from pageable host memory: ``process_batch`` copies a request
to the card and returns host uint8 arrays."""

from benchmark.harness import entries

expected = entries.plain_expected


class Entry:
    pools = ("host",)
    keys = entries.KEYS

    def __init__(self, prog, cfg, pool, devices, options, seed):
        if cfg.enable_clahe:
            raise ValueError("the host API (process_batch) returns no CLAHE image")
        self.prog, self.cfg, self.pool, self.devices = prog, cfg, pool, list(devices)
        self.options = options
        self.products = ("out_u8",)

    def submit(self, start: int, count: int) -> tuple:
        return (self.prog.musica.process_batch(self.pool[start:start + count], self.cfg,
                                               self.devices[0], **self.options),)

    def wait(self) -> None:
        """``process_batch`` returns host arrays: nothing is left to wait for."""
